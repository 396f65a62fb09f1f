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
     K=5824), B=256 subframes at 26 dB, CRC early exit and forced 8
     iterations; every TB passes its CRC with the payload bit-exact, and
     the kernel's launch count proves the decoder ran on it; decoded Mbps,
     per-stage ms, and the two early-exit forms (synced stop vs all
     iterations masked) are timed;
  4. a corrupted waveform fails its CRC without a crash.

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


def phase_kernel(torch, bcjr, dev):
    """Kernel vs plain twin at the main path's shapes."""
    rows = []
    for label, k, lw, blocks in KERNEL_SHAPES:
        g = torch.Generator(device=dev).manual_seed(k + lw)

        def rnd(*shape, scale):
            return torch.randn(*shape, generator=g, device=dev) * scale

        w = k // lw
        args = (rnd(blocks, k, scale=6.0), rnd(blocks, k, scale=6.0),
                rnd(blocks, k, scale=3.0), rnd(blocks, 3, scale=6.0),
                rnd(blocks, 3, scale=6.0), rnd(blocks, w, 8, scale=5.0),
                rnd(blocks, w, 8, scale=5.0), lw)
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
    """The main path at full width, early exit and forced 8 iterations."""
    t0 = time.perf_counter()
    fn, (iq,), payloads = entry.entry(dev, batch=BATCH, snr_db=SNR_DB,
                                      early_exit=True, seed=0, n_distinct=4)
    print(f"phase 3: test vectors B={BATCH} built on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    want = torch.as_tensor(payloads, device=dev)
    fn(iq)  # first call: cuFFT plans, cuBLAS handles
    torch.cuda.synchronize()

    bcjr.bcjr_half_windowed.launches = 0
    pay, ok, iters = fn(iq)
    torch.cuda.synchronize()
    launches = bcjr.bcjr_half_windowed.launches
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
    bcjr.bcjr_half_windowed.launches = 0
    pay_f, ok_f, iters_f = fn_f(iq)
    torch.cuda.synchronize()
    launches_f = bcjr.bcjr_half_windowed.launches
    check(bool(ok_f.all()), "forced: TBs failed CRC")
    check(bool((pay_f == want).all()), "forced: payload not bit-exact")
    check(bool((iters_f == iters).all()), "forced and early exit disagree on iterations")
    check(launches_f == 2 * 8, f"forced: {launches_f} kernel launches, expected 16")
    print(f"phase 3: forced 8 iterations ok: all pass, bit-exact, {launches_f} launches",
          flush=True)

    tbs = codec_f.grant.tbs
    t_e = cuda_ms(torch, lambda: fn(iq), reps=5)
    t_f = cuda_ms(torch, lambda: fn_f(iq), reps=5)
    mbps = {"early_exit": int(ok.sum()) * tbs / t_e / 1e3,
            "forced8": int(ok_f.sum()) * tbs / t_f / 1e3}
    print(f"phase 3: B={BATCH} early exit {t_e:.3f} ms/batch = {mbps['early_exit']:.1f} "
          f"Mbps decoded; forced 8 {t_f:.3f} ms/batch = {mbps['forced8']:.1f} Mbps decoded",
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
    return fn, iq, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA GPU", file=sys.stderr)
        return 2
    from srsue_tpu_torch import entry
    from srsue_tpu_torch.kernels import bcjr, build
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
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"phase 1: ptxas {line.strip()}", flush=True)

    rows = phase_kernel(torch, bcjr, dev)
    fn, iq, launches = phase_chain(torch, entry, bcjr, dev)

    bad = iq[:8].clone()
    bad[:, 1000:3000] = 0
    _, ok_bad, _ = fn(bad)
    torch.cuda.synchronize()
    check(not bool(ok_bad.any()), "corrupted waveform passed its CRC")
    print("phase 4: corrupted waveform: every CRC fails, no crash", flush=True)

    flag = rows[0]
    print(json.dumps({"kernels": [{
        "name": "bcjr_half", "route": "cuda",
        "source": "srsue_tpu_torch/csrc/bcjr_half.cu",
        "replaces": "srsue_tpu/phy/turbo_pallas.py:372",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": flag["ms"], "plain_ms": flag["plain_ms"]}]}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
