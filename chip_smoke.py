#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsue_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one GPU, nvcc

Phases, each of which fails the run:
  1. environment: card, power limit, torch/CUDA versions; builds the CUDA
     kernels from srsue_tpu_torch/csrc/ (nvcc, sm_90a) into build/kernels/;
  2. the BCJR half-iteration kernel against its plain PyTorch twin at the
     shapes the main path gives it, with random window boundaries; times
     both with CUDA events;
  3. the main path, entry(): 20 MHz MCS 28 (TBS 75376, 13 blocks of
     K=5824), B=256 subframes at 26 dB, CRC early exit and all 8
     iterations masked (converged blocks frozen); every TB passes its CRC
     with the payload bit-exact, and the kernel's launch count proves the
     decoder ran on it; decoded Mbps, per-stage ms, and the two early-exit
     forms (synced stop vs all iterations masked) are timed;
  4. a corrupted waveform fails its CRC without a crash;
  5. the other kernel instances (v2v3, v4, v5: kernels/bcjr.py) and the
     fused forced half against their plain twins at the path shapes, and
     their times beside the twins';
  6. the chain once per kernel instance with CRC early exit, and once in
     the forced form (8 iterations, no per-iteration CRC, the fused half):
     every TB passes bit-exact, the launch counters show 2 x iterations
     for the chosen instance and 0 for every other; ms/batch and Mbps;
  7. the kernel microbenchmark (srsue_tpu_torch/bench_kernel_variants.py).

Prints the kernels' JSON record, the nvidia-smi name/power-limit line and,
last, {"ok": true, "device": ...}. Exits non-zero with no result when CUDA
is unavailable or a phase fails. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BATCH = 256
SNR_DB = 26.0
RTOL, ATOL = 1e-5, 1e-3
KERNEL_SHAPES = (  # (label, K, lw, blocks)
    ("flagship K=5824 lw=64", 5824, 64, BATCH * 13),
    ("K=512 lw=64", 512, 64, BATCH),
    ("K=432 lw=48 (odd W=9)", 432, 48, BATCH),
    ("K=256 W=1", 256, 256, BATCH),
)
# the radix-4 instances also at the TPU's block-minor window for K=5824
R4_SHAPES = KERNEL_SHAPES + (("flagship K=5824 lw=104", 5824, 104, BATCH * 13),)
TURBO = "srsue_tpu/phy/turbo_pallas.py"
NEW_KERNELS = {  # instance: (source, the TPU kernel it replaces)
    "v2v3": ("srsue_tpu_torch/csrc/bcjr_half.cu", f"{TURBO}:148"),
    "v4": ("srsue_tpu_torch/csrc/bcjr_half_r4.cu", f"{TURBO}:372"),
    "v5": ("srsue_tpu_torch/csrc/bcjr_half_r4.cu", f"{TURBO}:487"),
    "fused": ("srsue_tpu_torch/csrc/bcjr_half_fused.cu", f"{TURBO}:1341"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call between CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def zero_counts(bcjr) -> None:
    for name in bcjr.launches:
        bcjr.launches[name] = 0


def half_args(torch, dev, k, lw, blocks):
    """Random [B, K] half-iteration inputs with random window boundaries:
    (sys, par, apriori, tail_sys, tail_par, alpha_b, beta_b, lw)."""
    g = torch.Generator(device=dev).manual_seed(k + lw)

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=g, device=dev) * scale

    w = k // lw
    return (rnd(blocks, k, scale=6.0), rnd(blocks, k, scale=6.0),
            rnd(blocks, k, scale=3.0), rnd(blocks, 3, scale=6.0),
            rnd(blocks, 3, scale=6.0), rnd(blocks, w, 8, scale=5.0),
            rnd(blocks, w, 8, scale=5.0), lw)


def phase_kernel(torch, bcjr, dev):
    """Kernel vs plain twin at the main path's shapes."""
    rows = []
    for label, k, lw, blocks in KERNEL_SHAPES:
        w = k // lw
        args = half_args(torch, dev, k, lw, blocks)
        got = bcjr.bcjr_half_windowed(*args)
        ref = bcjr.bcjr_half_windowed_plain(*args)
        torch.cuda.synchronize()
        err = float((got[0] - ref[0]).abs().max())
        torch.testing.assert_close(got[0], ref[0], rtol=RTOL, atol=ATOL)
        for a, b in zip(got[1:], ref[1:]):  # boundaries: offset-free
            a = a - a.amax(-1, keepdim=True)
            b = b - b.amax(-1, keepdim=True)
            err = max(err, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        # the kernel alone ([n, lw] contract) and the whole [B, K] half
        # (boundary injection, tail beta, NII shift around it)
        n = blocks * w
        core = ((args[0] + args[2]).reshape(n, lw), args[1].reshape(n, lw),
                args[5].reshape(n, 8), args[6].reshape(n, 8))
        ms = cuda_ms(torch, lambda: bcjr.half_windowed(*core), reps=50)
        plain_ms = cuda_ms(torch, lambda: bcjr.half_windowed_plain(*core), reps=3)
        half_ms = cuda_ms(torch, lambda: bcjr.bcjr_half_windowed(*args), reps=20)
        half_plain_ms = cuda_ms(torch, lambda: bcjr.bcjr_half_windowed_plain(*args), reps=3)
        rows.append({"shape": label, "windows": n, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
        print(f"phase 2: {label} B={blocks} windows={n}: max|diff| {err:.3g} "
              f"(rtol {RTOL:g}, atol {ATOL:g}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; whole half {half_ms:.4f} ms, "
              f"plain {half_plain_ms:.4f} ms", flush=True)
    return rows


def phase_chain(torch, entry, bcjr, dev):
    """The main path at full width, early exit and all 8 iterations masked."""
    t0 = time.perf_counter()
    fn, (iq,), payloads = entry.entry(dev, batch=BATCH, snr_db=SNR_DB,
                                      early_exit=True, seed=0, n_distinct=4)
    print(f"phase 3: test vectors B={BATCH} built on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    want = torch.as_tensor(payloads, device=dev)
    fn(iq)  # first call: cuFFT plans, cuBLAS handles
    torch.cuda.synchronize()

    zero_counts(bcjr)
    pay, ok, iters = fn(iq)
    torch.cuda.synchronize()
    launches = bcjr.launches["r2max"]
    check(sum(bcjr.launches.values()) == launches, f"early exit: {bcjr.launches}")
    check(bool(ok.all()), f"early exit: {int((~ok).sum())} TBs failed CRC")
    check(bool((pay == want).all()), "early exit: payload not bit-exact")
    loops = int(iters.max())  # one K-group: the loop ran until all passed
    check(launches == 2 * loops and launches > 0,
          f"early exit: {launches} kernel launches, expected {2 * loops}")
    print(f"phase 3: early exit ok: all {BATCH} TBs pass, bit-exact, {loops} "
          f"iterations run, {launches} kernel launches, mean iters/block "
          f"{float(iters.float().mean()):.3f}", flush=True)

    cell, codec_f = entry.flagship(dev, early_exit=False)
    fn_f = entry.chain(cell, codec_f, entry.SUBFRAME)
    fn_f(iq)
    torch.cuda.synchronize()
    zero_counts(bcjr)
    pay_f, ok_f, iters_f = fn_f(iq)
    torch.cuda.synchronize()
    launches_f = bcjr.launches["r2max"]
    check(bool(ok_f.all()), "masked: TBs failed CRC")
    check(bool((pay_f == want).all()), "masked: payload not bit-exact")
    check(bool((iters_f == iters).all()), "masked and early exit disagree on iterations")
    check(launches_f == 2 * 8, f"masked: {launches_f} kernel launches, expected 16")
    print(f"phase 3: masked 8 iterations ok: all pass, bit-exact, {launches_f} launches",
          flush=True)

    tbs = codec_f.grant.tbs
    t_e = cuda_ms(torch, lambda: fn(iq), reps=5)
    t_f = cuda_ms(torch, lambda: fn_f(iq), reps=5)
    mbps = {"early_exit": int(ok.sum()) * tbs / t_e / 1e3,
            "masked8": int(ok_f.sum()) * tbs / t_f / 1e3}
    print(f"phase 3: B={BATCH} early exit {t_e:.3f} ms/batch = {mbps['early_exit']:.1f} "
          f"Mbps decoded; masked 8 {t_f:.3f} ms/batch = {mbps['masked8']:.1f} Mbps decoded",
          flush=True)

    _, codec_e = entry.flagship(dev, early_exit=True)
    front, dd, turbo_f, tb_crc = entry.stages(cell, codec_f, entry.SUBFRAME)
    turbo_e = entry.stages(cell, codec_e, entry.SUBFRAME)[2]
    x, nv = front(iq)
    groups = dd(x, nv)
    hard, blk_ok, _ = turbo_f(groups)
    stage_ms = {
        "frontend": cuda_ms(torch, lambda: front(iq), reps=5),
        "demap_dematch": cuda_ms(torch, lambda: dd(x, nv), reps=5),
        "turbo_synced_early_exit": cuda_ms(torch, lambda: turbo_e(groups), reps=5),
        "turbo_masked_8": cuda_ms(torch, lambda: turbo_f(groups), reps=5),
        "tb_crc": cuda_ms(torch, lambda: tb_crc(hard, blk_ok), reps=5),
    }
    print(f"phase 3: per-stage ms/batch (B={BATCH}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()), flush=True)
    return fn, iq, want, launches


def max_diff(torch, got, ref, tol) -> float:
    """Max |got - ref| over the extrinsic and the offset-free boundaries
    (only differences between states matter); fails where a difference
    is outside tol(ref) = (rtol, atol)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        if i:
            a = a - a.amax(-1, keepdim=True)
            b = b - b.amax(-1, keepdim=True)
        err = max(err, float((a - b).abs().max()))
        rtol, atol = tol(b)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
    return err


def f32_tol(ref):
    return RTOL, ATOL


def bf16_tol(ref):
    """One bf16 unit in the last place of the largest value: the kernel and
    its bf16 twin round the same operations, each correctly."""
    return 0.0, 2.0 ** -7 * float(ref.abs().max())


def phase_new_kernels(torch, bcjr, turbo, dev):
    """The other half-iteration instances and the fused half against their
    plain twins at the path shapes; their times beside the twins'. Returns
    {instance: {max_abs_err, ms, plain_ms}} at the flagship lw=64 shape,
    with the error over every shape."""
    out = {}
    for kernel in ("v2v3", "v4", "v5"):
        tol = bf16_tol if kernel == "v5" else f32_tol
        errs = []
        for label, k, lw, blocks in (KERNEL_SHAPES if kernel == "v2v3" else R4_SHAPES):
            args = half_args(torch, dev, k, lw, blocks)
            got = bcjr.bcjr_half_windowed(*args, kernel=kernel)
            ref = bcjr.bcjr_half_windowed_plain(*args, kernel=kernel)
            torch.cuda.synchronize()
            errs.append(max_diff(torch, got, ref, tol))
            n = blocks * (k // lw)
            core = ((args[0] + args[2]).reshape(n, lw), args[1].reshape(n, lw),
                    args[5].reshape(n, 8), args[6].reshape(n, 8))
            ms = cuda_ms(torch, lambda: bcjr.half_windowed(*core, kernel), reps=50)
            plain_ms = cuda_ms(torch, lambda: bcjr.half_windowed_plain(*core, kernel), reps=3)
            print(f"phase 5: {kernel} {label} windows={n}: max|diff| {errs[-1]:.3g}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            if label.startswith("flagship K=5824 lw=64"):
                out[kernel] = {"ms": ms, "plain_ms": plain_ms}
        out[kernel]["max_abs_err"] = max(errs)
    errs = []
    for label, k, lw, blocks in KERNEL_SHAPES:
        sys_h, par_h, other, ts, tp, al, bf, _ = half_args(torch, dev, k, lw, blocks)
        inv = turbo.qpp_tensors(k, dev)[1]
        fused = (sys_h, par_h, other, inv.to(torch.int32), al, bf, turbo.tail_beta(ts, tp), lw)
        got = bcjr.bcjr_half_fused(*fused)
        ref = bcjr.bcjr_half_fused_plain(*fused)
        torch.cuda.synchronize()
        errs.append(max_diff(torch, got, ref, f32_tol))
        # the unfused form of the same half: gather, injection and NII shift in torch
        unfused = (sys_h, par_h, other[:, inv], ts, tp, al, bf, lw)
        ms = cuda_ms(torch, lambda: bcjr.bcjr_half_fused(*fused), reps=50)
        plain_ms = cuda_ms(torch, lambda: bcjr.bcjr_half_fused_plain(*fused), reps=3)
        unfused_ms = cuda_ms(torch, lambda: bcjr.bcjr_half_windowed(*unfused), reps=20)
        print(f"phase 5: fused {label}: max|diff| {errs[-1]:.3g}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; r2max half with torch glue {unfused_ms:.4f} ms", flush=True)
        if label.startswith("flagship"):
            out["fused"] = {"ms": ms, "plain_ms": plain_ms}
    out["fused"]["max_abs_err"] = max(errs)
    return out


def phase_variant_chains(torch, entry, bcjr, dev, iq, want):
    """entry()'s chain with each other kernel instance (CRC early exit) and
    in the forced form (the fused half); returns each instance's launches."""
    launches = {}
    groups = None
    for name, kw in (("v2v3", {"kernel": "v2v3"}), ("v4", {"kernel": "v4"}),
                     ("v5", {"kernel": "v5"}), ("fused", {"forced": True})):
        cell, codec = entry.flagship(dev, **kw)
        fn = entry.chain(cell, codec, entry.SUBFRAME)
        front, dd, turbo_stage, _ = entry.stages(cell, codec, entry.SUBFRAME)
        if groups is None:
            groups = dd(*front(iq))
        fn(iq)
        torch.cuda.synchronize()
        zero_counts(bcjr)
        pay, ok, iters = fn(iq)
        torch.cuda.synchronize()
        counts = dict(bcjr.launches)
        check(bool(ok.all()), f"{name}: {int((~ok).sum())} TBs failed CRC")
        check(bool((pay == want).all()), f"{name}: payload not bit-exact")
        if codec.forced:
            check(bool((iters == 8).all()), f"{name}: forced decode reported {iters.unique()}")
        expect = 2 * int(iters.max())  # one K-group: iterations the loop ran
        check(counts == {n: expect if n == name else 0 for n in counts},
              f"{name}: launches {counts}, expected {expect} of {name} only")
        launches[name] = counts[name]
        t = cuda_ms(torch, lambda: fn(iq), reps=5)
        t_turbo = cuda_ms(torch, lambda: turbo_stage(groups), reps=5)
        form = "forced 8" if codec.forced else "early exit"
        print(f"phase 6: {name} {form}: all {BATCH} TBs pass, bit-exact, launches {counts}, "
              f"mean iters/block {float(iters.float().mean()):.3f}; {t:.3f} ms/batch = "
              f"{int(ok.sum()) * codec.grant.tbs / t / 1e3:.1f} Mbps decoded; turbo stage "
              f"{t_turbo:.3f} ms", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA GPU", file=sys.stderr)
        return 2
    from srsue_tpu_torch import bench_kernel_variants, entry
    from srsue_tpu_torch.kernels import bcjr, build
    from srsue_tpu_torch.phy import turbo
    from srsue_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    check(len(smi) >= 1, "nvidia-smi listed no GPU")
    print(f"phase 1: {torch.cuda.get_device_name(0)} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}", flush=True)
    lib = build.load()
    print(f"phase 1: built {lib.path.name} in {lib.build_seconds:.2f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or line.startswith("=="):
            print(f"phase 1: ptxas {line.strip()}", flush=True)

    rows = phase_kernel(torch, bcjr, dev)
    fn, iq, want, launches = phase_chain(torch, entry, bcjr, dev)

    bad = iq[:8].clone()
    bad[:, 1000:3000] = 0
    _, ok_bad, _ = fn(bad)
    torch.cuda.synchronize()
    check(not bool(ok_bad.any()), "corrupted waveform passed its CRC")
    print("phase 4: corrupted waveform: every CRC fails, no crash", flush=True)

    new = phase_new_kernels(torch, bcjr, turbo, dev)
    new_launches = phase_variant_chains(torch, entry, bcjr, dev, iq, want)
    for line in bench_kernel_variants.report(bench_kernel_variants.run(dev, reps=20)):
        print(f"phase 7: {line}", flush=True)

    flag = rows[0]
    kernels = [{
        "name": "bcjr_half", "route": "cuda",
        "source": "srsue_tpu_torch/csrc/bcjr_half.cu",
        "replaces": f"{TURBO}:372",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": flag["ms"], "plain_ms": flag["plain_ms"]}]
    for name, (source, replaces) in NEW_KERNELS.items():
        kernels.append({"name": f"bcjr_half_{name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": new_launches[name], **new[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
