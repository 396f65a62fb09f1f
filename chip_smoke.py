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
  7. the kernel microbenchmark (srsue_tpu_torch/bench_kernel_variants.py);
  8. the circular Viterbi kernel (csrc/viterbi.cu) against its plain twin
     (phy/convcode.py::decode_plain) at the blind search's shapes (B=4,608
     hypotheses of n=44 and 54, 1,536 of 31, PBCH's 4 of 40, an odd n=33):
     equal hard bits on noisy codewords at 0/3/10 dB and random LLRs, the
     sent bits at 10 dB; both timed;
  9. the blind control + data chain (rx.make_rx, bench.py's make_rx) at
     B=256, 26 dB, with ZF, MMSE and scalar-noise ZF (early exit) and ZF
     forced: every CFI, DCI and TB found, bit-exact, one Viterbi launch per
     call and 2 x iterations of the chosen BCJR instance only; ms/batch,
     Mbps, the control stage alone; BLER at 20 dB with MMSE; a corrupted
     control region finds no DCI;
 10. the UE DL facade (UeDl.process) on those subframes: CFI, the one grant
     (TBS 75376), every payload bit-exact; a wrong RNTI gets no grant; DL
     HARQ: rv0 alone fails, rv0 + rv2 soft-combined passes and delivers.

Prints the kernels' JSON record, the nvidia-smi name/power-limit line and,
last, {"ok": true, "device": ...}. Exits non-zero with no result when CUDA
is unavailable or a phase fails. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

BATCH = 256
SNR_DB = 26.0
HARQ_SNR_DB = 15.0  # MCS 28: rv0 alone fails, rv0 + rv2 passes
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
VITERBI_SHAPES = (  # (label, hypotheses, n): the first is the flagship's
    ("DCI 1A, 100 PRB", 4608, 44),
    ("DCI 1, 100 PRB", 4608, 54),
    ("DCI 1C, common space", 1536, 31),
    ("PBCH", 4, 40),
    ("odd n", 256, 33),
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


def viterbi_inputs(np, convcode, batch, n, snr_db, seed):
    """(llrs [batch, n, 3] float32, bits [batch, n]): noisy codewords of
    random bits at `snr_db` per coded bit, or random LLRs when it is None."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n)).astype(np.uint8)
    if snr_db is None:
        return (rng.standard_normal((batch, n, 3)) * 4.0).astype(np.float32), bits
    x = 1.0 - 2.0 * np.swapaxes(convcode.encode(bits), -1, -2)
    var = 10.0 ** (-snr_db / 10.0)
    y = x + np.sqrt(var) * rng.standard_normal(x.shape)
    return np.ascontiguousarray(2.0 * y / var, dtype=np.float32), bits


def phase_viterbi(torch, np, viterbi, convcode, dev):
    """The Viterbi kernel against decode_plain at the path's shapes: equal
    hard bits (exact), and the transmitted bits at 10 dB; both timed at
    every shape. Returns the flagship row (B=4,608, n=44) with the largest
    bit difference over every shape and input."""
    row, err = None, 0
    for label, batch, n in VITERBI_SHAPES:
        for j, snr in enumerate((0.0, 3.0, 10.0, None)):
            llr_np, bits = viterbi_inputs(np, convcode, batch, n, snr, 1000 * n + j)
            llr = torch.as_tensor(llr_np, device=dev)
            before = viterbi.launches
            got = convcode.decode(llr)
            check(viterbi.launches == before + 1, f"viterbi {label}: the kernel did not launch")
            ref = convcode.decode_plain(llr)
            err = max(err, int((got.int() - ref.int()).abs().max()))
            check(bool((got == ref).all()), f"viterbi {label} {snr} dB: "
                  f"{int((got != ref).sum())} bits differ from decode_plain")
            if snr == 10.0:
                check(bool((got.cpu().numpy() == bits).all()),
                      f"viterbi {label} at 10 dB: decoded bits differ from the sent ones")
        ms = cuda_ms(torch, lambda: convcode.decode(llr), reps=50)
        plain_ms = cuda_ms(torch, lambda: convcode.decode_plain(llr), reps=3)
        print(f"phase 8: viterbi {label} B={batch} n={n}: kernel = decode_plain bit for bit "
              f"at 0/3/10 dB and random LLRs, 10 dB = sent bits; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        if row is None:
            row = {"ms": ms, "plain_ms": plain_ms}
    return {"max_abs_err": float(err), **row}


def zero_all(bcjr, viterbi) -> None:
    zero_counts(bcjr)
    viterbi.launches = 0


def phase_blind_chain(torch, rx, ofdm, chest, dci, bcjr, viterbi, dev):
    """The blind control + data chain (rx.make_rx) at B=256 and 26 dB with
    each equalizer (CRC early exit, r2max) and in the forced form: every
    CFI, DCI and TB found, bit-exact, with one Viterbi launch per call and
    2 x iterations of the chosen BCJR instance only; ms/batch, decoded
    Mbps and the control stage alone; BLER at 20 dB (MMSE); a corrupted
    control region finds no DCI. Returns (clean vectors, noisy IQ, the
    Viterbi launches of the zf early-exit run)."""
    t0 = time.perf_counter()
    clean = rx.build_clean(BATCH, n_distinct=4)
    noisy = rx.add_noise(clean.rng, clean.td, clean.p_sig, SNR_DB)
    iq = torch.as_tensor(noisy, device=dev)
    print(f"phase 9: test vectors B={BATCH} (CRS, PCFICH, DCI 1A, PDSCH) built on the host "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    args = (clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
            clean.dci_bits, clean.payloads)
    tbs = clean.grant.tbs
    vit_launches, chain_ms = None, {}
    for label, eq, kw in (("zf", "zf", {}), ("mmse", "mmse", {}),
                          ("zf_scalar", "zf_scalar", {}), ("zf forced", "zf", {"forced": True})):
        fn = rx.make_rx(*args, early_exit=True, eq=eq, device=dev, **kw)
        fn(iq)
        torch.cuda.synchronize()
        zero_all(bcjr, viterbi)
        stats = {k: float(v) for k, v in fn(iq).items()}
        torch.cuda.synchronize()
        counts, vit = dict(bcjr.launches), viterbi.launches
        check(stats["n_dci"] == stats["cfi_ok"] == stats["n_ok"] == BATCH
              and stats["bit_match"] == 1.0, f"blind chain {label}: {stats}")
        check(vit == 1, f"blind chain {label}: {vit} Viterbi launches, expected 1")
        inst = "fused" if kw else "r2max"
        expect = 2 * int(stats["max_iters"])
        check(counts == {n: expect if n == inst else 0 for n in counts},
              f"blind chain {label}: BCJR launches {counts}, expected {expect} of {inst} only")
        if kw:
            check(stats["mean_iters"] == 8.0, f"forced chain: {stats['mean_iters']} iterations")
        if vit_launches is None:
            vit_launches = vit
        t = chain_ms[label] = cuda_ms(torch, lambda: fn(iq), reps=5)
        print(f"phase 9: blind chain {label}: {BATCH}/{BATCH} CFI, DCI and TB, bit-exact; "
              f"1 Viterbi launch, BCJR {inst} x{expect}; mean iters/block "
              f"{stats['mean_iters']:.3f}; {t:.3f} ms/batch = "
              f"{stats['n_ok'] * tbs / t / 1e3:.1f} Mbps decoded", flush=True)

    grid = ofdm.demodulate(clean.cell, iq)
    h, nvar, _ = chest.estimate(clean.cell, grid, clean.subframe)
    n = dci.size_0_1a(clean.cell.n_prb)
    ctrl_ms = {}
    for eq in ("zf", "mmse"):
        ctrl = rx.control_stage(clean.cell, clean.subframe, clean.cfi, clean.rnti, n, eq)
        n_cand = ctrl(grid, h, nvar)[1].shape[1]
        ms = ctrl_ms[eq] = cuda_ms(torch, lambda: ctrl(grid, h, nvar), reps=10)
        print(f"phase 9: control stage alone ({eq}: full-grid eq, PCFICH, blind search of "
              f"{BATCH} x {n_cand} candidates): {ms:.3f} ms/batch", flush=True)
    front_ms = cuda_ms(torch, lambda: chest.estimate(
        clean.cell, ofdm.demodulate(clean.cell, iq), clean.subframe), reps=10)
    print(f"phase 9: blind chain zf stages, ms/batch: OFDM + chest {front_ms:.3f}, control "
          f"{ctrl_ms['zf']:.3f}, PDSCH (extract, eq, demap, dematch, turbo, TB CRC; the "
          f"rest of the chain) {chain_ms['zf'] - front_ms - ctrl_ms['zf']:.3f}", flush=True)

    fn = rx.make_rx(*args, early_exit=True, eq="mmse", device=dev)
    iq20 = torch.as_tensor(rx.add_noise(clean.rng, clean.td, clean.p_sig, 20.0), device=dev)
    stats = {k: float(v) for k, v in fn(iq20).items()}
    bler = 1.0 - stats["n_ok"] / BATCH
    check(bler < 0.6 and stats["n_dci"] == stats["cfi_ok"] == BATCH
          and stats["bit_match"] == 1.0, f"waterfall 20 dB mmse: {stats}")
    t = cuda_ms(torch, lambda: fn(iq20), reps=5)
    print(f"phase 9: waterfall 20 dB mmse: BLER {100 * bler:.2f}% "
          f"({int(stats['n_ok'])}/{BATCH} TBs pass, all bit-exact), all CFIs and DCIs found; "
          f"{t:.3f} ms/batch = {stats['n_ok'] * tbs / t / 1e3:.1f} Mbps decoded", flush=True)

    bad = iq.clone()
    bad[:, : bad.shape[1] // 7] = 0  # the first two OFDM symbols: the control region
    stats = {k: float(v) for k, v in rx.make_rx(*args, early_exit=True, device=dev)(bad).items()}
    check(stats["n_dci"] == 0, f"corrupted control region: {stats['n_dci']} DCIs found")
    print(f"phase 9: corrupted control region: no DCI found, no crash "
          f"(CFI found in {int(stats['cfi_ok'])}/{BATCH})", flush=True)
    return clean, noisy, vit_launches


def phase_ue_dl(torch, np, entry, UeDl, DlHarq, PdschCodec, enb_tx, bcjr, viterbi, dev,
                clean, noisy):
    """UeDl.process on the blind chain's B=256 subframes: the CFI and the one
    grant (TBS 75376), every payload bit-exact; a wrong RNTI gives no
    grant; DlHarq: rv0 alone fails at 15 dB, rv0 + rv2 passes and delivers
    the payload bytes."""
    ue = UeDl(clean.cell, device=dev)
    ue.process(noisy, clean.subframe, clean.rnti)
    torch.cuda.synchronize()
    zero_all(bcjr, viterbi)
    t0 = time.perf_counter()
    res = ue.process(noisy, clean.subframe, clean.rnti)
    wall = (time.perf_counter() - t0) * 1e3
    check(res.cfi == clean.cfi and len(res.grants) == 1
          and res.grants[0].tbs == clean.grant.tbs == 75376, f"UeDl: cfi {res.cfi}, "
          f"grants {res.grants}")
    check(all(len(e) == 1 for e in res.hits_per_elem), "UeDl: a subframe without its DCI")
    check(bool(res.tb_ok.all()) and bool((res.payload == clean.payloads).all()),
          "UeDl: payloads not bit-exact")
    check(viterbi.launches == 1, f"UeDl: {viterbi.launches} Viterbi launches")
    print(f"phase 10: UeDl.process B={BATCH}: CFI {res.cfi}, one grant (TBS "
          f"{res.grants[0].tbs}) in every subframe, {BATCH}/{BATCH} TBs bit-exact; "
          f"{wall:.3f} ms host wall per call (CFI and hits read back)", flush=True)
    none = ue.process(noisy, clean.subframe, clean.rnti ^ 0x0F0F)
    check(none.grants == [] and none.payload is None, "UeDl: a grant for a wrong RNTI")
    print("phase 10: wrong RNTI: no grant", flush=True)

    cell, sf, cfi = clean.cell, clean.subframe, clean.cfi
    g0 = clean.grant
    g2 = dataclasses.replace(g0, rv=2)
    codecs = [PdschCodec(cell, g, clean.rnti, sf, cfi, device=dev) for g in (g0, g2)]
    rng = np.random.default_rng(7)
    payload = clean.payloads[0]
    bufs = []
    for codec in codecs:
        td = enb_tx.to_waveform(cell, enb_tx.build_pdsch_subframe(cell, codec, payload))[0]
        p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
        iq = torch.as_tensor(enb_tx.awgn(rng, td[None], HARQ_SNR_DB, p_sig)[0], device=dev)
        front, dd, _, _ = entry.stages(cell, codec, sf)
        bufs.append(dd(*front(iq)))
    got = []
    harq = DlHarq(lambda pid, data: got.append(data))
    acks = [harq.new_grant_dl(0, g0), harq.tb_decoded(0, codecs[0], bufs[0]),
            harq.new_grant_dl(0, g2), harq.tb_decoded(0, codecs[0], bufs[1])]
    check(acks == [True, False, False, True], f"DlHarq: new/ACK sequence {acks}")
    check(got == [np.packbits(payload).tobytes()], "DlHarq: delivered bytes differ")
    print(f"phase 10: DlHarq at {HARQ_SNR_DB} dB: rv0 alone NACK, rv0 + rv2 combined ACK, "
          f"{len(got[0])} payload bytes delivered exact", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from srsue_tpu_torch import bench_kernel_variants, entry, rx
    from srsue_tpu_torch.kernels import bcjr, build, viterbi
    from srsue_tpu_torch.mac.dl_harq import DlHarq
    from srsue_tpu_torch.phy import chest, convcode, dci, enb_tx, ofdm, turbo
    from srsue_tpu_torch.phy.pdsch import PdschCodec
    from srsue_tpu_torch.phy.ue_dl import UeDl
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
    vit_row = phase_viterbi(torch, np, viterbi, convcode, dev)
    clean, noisy, vit_launches = phase_blind_chain(torch, rx, ofdm, chest, dci, bcjr,
                                                   viterbi, dev)
    phase_ue_dl(torch, np, entry, UeDl, DlHarq, PdschCodec, enb_tx, bcjr, viterbi, dev,
                clean, noisy)

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
    kernels.append({"name": "viterbi", "route": "cuda",
                    "source": "srsue_tpu_torch/csrc/viterbi.cu",
                    "replaces": "srsue_tpu/phy/convcode.py:85", "launches": vit_launches,
                    **vit_row})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
