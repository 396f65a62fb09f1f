#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsue_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one GPU, nvcc

Phases, each of which fails the run:
  1. environment: card, power limit, torch/CUDA versions; builds the CUDA
     kernels from srsue_tpu_torch/csrc/ (nvcc, sm_90a) into build/kernels/
     and prints ptxas's registers and spills and every kernel's resident
     warps per SM (the CUDA occupancy calculator); the radix-4 instances
     must not spill and must hold at least 12 warps per SM;
  2. the BCJR half-iteration kernel against its plain PyTorch twin at the
     shapes the main path gives it (and K=6144, lw=104 and a window of 36,
     whose last checkpoint segment is short, the cold-start paths' B=1
     shapes: 1 block of K=5760 and 4 of K=4992, under one wave, and the
     uplink's B=1 full-width decode: 13 blocks of K=5824), with random
     window boundaries; times both with CUDA events;
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
     hypotheses of n=44 and 54, 1,536 of 31, PBCH's 4 of 40, an odd n=33,
     and the cold-start paths' B=1 searches: 6 and 18 candidates of n=44):
     equal hard bits on noisy codewords at 0/3/10 dB, random LLRs and the
     tie inputs (all zero, one constant per hypothesis), the sent bits at
     10 dB; both timed;
  9. the blind control + data chain (rx.make_rx, bench.py's make_rx) at
     B=256, 26 dB, with ZF, MMSE and scalar-noise ZF (early exit) and ZF
     forced: every CFI, DCI and TB found, bit-exact, one Viterbi launch per
     call and 2 x iterations of the chosen BCJR instance only; ms/batch,
     Mbps, the control stage alone; BLER at 20 dB with MMSE; a corrupted
     control region finds no DCI;
 10. the UE DL facade (UeDl.process) on those subframes: CFI, the one grant
     (TBS 75376), every payload bit-exact; a wrong RNTI gets no grant; DL
     HARQ: rv0 alone fails, rv0 + rv2 soft-combined passes and delivers;
 11. cold start at full width: 4 frames of a 20 MHz 1-port cell at 30.72
     Msps from rx.build_cell_stream behind 1234 zero samples, with a CFO of
     0.22 subcarriers at 14 dB; Receiver(ArrayRadio) on the card finds the
     cell, decodes the MIB (one Viterbi launch at B=4, n=40) and yields
     aligned subframes; UeDl.process finds the SI-RNTI grant and decodes the
     SIB bytes, with the kernels at the shapes phases 2 and 8 held against
     the twins; the same search and MIB on the CPU give the same decisions;
     ms for the search, the MIB, a steady-state subframe, decimate and
     pss_correlate;
 12. the same on a 2-port cell: the PBCH is found by the Alamouti hypothesis
     (port 0 sent 8 dB under port 1, so the single-port hypothesis fails: 2
     Viterbi launches), UeDl.process reads CFI and DCI through the SFBC
     control region and decodes a C-RNTI TB bit-exactly; a noise-only stream
     finds no cell and stream() ends;
 13. TM2 at the flagship (rx.build_tm2, rx.make_tm2_rx: 100 PRB, 2 ports,
     MCS 28, B=256, 26 dB), early exit and forced 8: 256/256 TBs bit-exact;
     ms/batch and Mbps beside the SISO forced chain's;
 14. the uplink (phy/pusch.py, PHICH, mac/ul_harq.py) on the 100 PRB cell 42:
     the UE's host encode (encode_sf) of the full-width grant (100 PRB, MCS
     28, TBS 75376, 13 blocks of K=5824) and of bench.py's UL grant (50 PRB,
     MCS 20, TBS 19848, 4 blocks of K=4992), ms per subframe over 5 passes
     of 20; the eNB decode (PuschCodec.decode_sf, CRC early exit) of B=256
     full-width subframes at 26 dB, 256/256 bit-exact, ms/batch, Mbps,
     dematch_sf and decode_softbuffers apart, and the B=1 latency; a
     corrupted subframe fails its CRC; UCI on bench.py's grant (the ACK bit
     and UlCtrl's 4 CQI bits) found on the card and equal to the CPU's; the
     UL HARQ loop (UlHarq, PHICH): rv0 NACK, then rv0 + rv2 combined ACK;
     PHICH ACK and NACK on every group and sequence on 1 and 2 ports, card =
     CPU; every r2max launch at a shape phase 2 held against the twin.

Prints the kernels' JSON record (time between CUDA events around repeated
calls, the kernel's own device time by torch.profiler, plain twin's time,
launches on the path, warps per SM, and the least time the card could take
for the same work: bytes over 3.35 TB/s or float32 operations over 67
TFLOP/s, the H100 SXM's published peaks, whichever is larger), the
nvidia-smi name/power-limit line and, last, {"ok": true, "device": ...}.
Exits non-zero with no result when CUDA is unavailable or a phase fails.
Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
    ("K=6144 lw=64", 6144, 64, BATCH * 13),
    ("flagship K=5824 lw=104", 5824, 104, BATCH * 13),  # the TPU's block-minor window
)
# r2max takes any window: 36 ends in a short checkpoint segment
R2MAX_SHAPES = KERNEL_SHAPES + (("K=432 lw=36 (short last segment)", 432, 36, BATCH),)
# Peaks of an H100 SXM at its 700 W limit (NVIDIA's H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# Float32 operations per trellis step that the algorithm needs, counted from
# the kernels' arithmetic (bcjr_core.cuh, bcjr_half_r4.cu): a radix-2 step is
# 4 for the branch metrics, 16 adds and 8 maxima forward, 15 to normalise,
# then 4 + 32 adds + 24 maxima + 2 backward with the extrinsic, and 15 to
# normalise (120); the fused half adds the gathered a-priori (121); radix-4
# does two steps in 8 bases, 64 adds and 48 maxima forward and 64 adds, 56
# maxima and 6 backward, normalised every 8 steps (~104 per step). The
# checkpointed kernels' recomputation is not counted: it is not needed work.
R2_OPS_PER_STEP, FUSED_OPS_PER_STEP, R4_OPS_PER_STEP = 120, 121, 104
# Viterbi: per state and trellis step 2 adds, a compare and a select of the
# path metric and a shift and an or of the survivor word, and one operation
# of the max-normalisation every 2 steps (7); two passes of n steps
VITERBI_OPS_PER_STATE_STEP = 7
TURBO = "srsue_tpu/phy/turbo_pallas.py"
NEW_KERNELS = {  # instance: (source, the TPU kernel it replaces)
    "v2v3": ("srsue_tpu_torch/csrc/bcjr_half.cu", f"{TURBO}:148"),
    "v4": ("srsue_tpu_torch/csrc/bcjr_half_r4.cu", f"{TURBO}:372"),
    "v5": ("srsue_tpu_torch/csrc/bcjr_half_r4.cu", f"{TURBO}:487"),
    "fused": ("srsue_tpu_torch/csrc/bcjr_half_fused.cu", f"{TURBO}:1341"),
}
UL_HARQ_SNR_DB = 11.0  # bench.py's UL grant: rv0 alone fails, rv0 + rv2 passes
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


def device_ms(fn, reps: int, kernel: str) -> dict:
    """{device_ms: the kernel's own mean time per launch, one per call of fn,
    device_ms_by: how it was timed} (bench_kernel_variants.device_ms:
    torch.profiler, or CUDA events behind a spin kernel where no trace held
    the launches; `kernel` names its instance)."""
    from srsue_tpu_torch import bench_kernel_variants

    ms, by = bench_kernel_variants.device_ms(fn, reps, kernel)
    if by != "profiler":
        print(f"chip_smoke: device time of {kernel} by {by}", flush=True)
    return {"device_ms": ms, "device_ms_by": by}


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: (registers, spill bytes stored + loaded)} from
    nvcc's -Xptxas -v output."""
    usage, cur, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            usage[cur] = (int(m.group(1)), spill)
    return usage


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves `nbytes` of
    device memory and does `ops` float32 operations, and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def half_bound(n: int, lw: int, ops_per_step: int) -> dict:
    """[n, lw] half: lin, par, a0, b0 read once; ext, alast, bfirst
    written once (float32)."""
    return bound(4 * n * (3 * lw + 4 * 8), ops_per_step * n * lw)


def fused_bound(blocks: int, k: int, lw: int) -> dict:
    """Fused half: sys, par, ext_other, idx, alast_prev, bfirst_prev,
    tail_b read once; ext, alast, bfirst written once."""
    w = k // lw
    nbytes = 4 * (4 * blocks * k + k + 4 * blocks * w * 8 + blocks * 8)
    return bound(nbytes, FUSED_OPS_PER_STEP * blocks * k)


def zero_counts(bcjr) -> None:
    for name in bcjr.launches:
        bcjr.launches[name] = 0
        bcjr.shapes[name].clear()


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


def phase_kernel(torch, bcjr, dev, cold):
    """Kernel vs plain twin at the main paths' shapes; `cold` holds the
    cold-start paths' and the uplink's (B=1: grids far under one wave)."""
    rows = []
    for label, k, lw, blocks in R2MAX_SHAPES + cold:
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
        b = half_bound(n, lw, R2_OPS_PER_STEP)
        rows.append({"shape": label, "windows": n, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, **b})
        if label.startswith("flagship K=5824 lw=64"):
            rows[-1].update(device_ms(lambda: bcjr.half_windowed(*core), 50, "r2max"))
        print(f"phase 2: {label} B={blocks} windows={n}: max|diff| {err:.3g} "
              f"(rtol {RTOL:g}, atol {ATOL:g}); kernel "
              f"{ms:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_by']}), plain "
              f"{plain_ms:.4f} ms; whole half {half_ms:.4f} ms, "
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
    """The other half-iteration instances and the fused half (with both
    index maps, qpp_inv and qpp_perm) against their plain twins at the path
    shapes; their times beside the twins'. Returns {instance: {max_abs_err,
    ms, plain_ms, bound_ms, bound_by}} at the flagship lw=64 shape, with the
    error over every shape."""
    out = {}
    for kernel in ("v2v3", "v4", "v5"):
        tol = bf16_tol if kernel == "v5" else f32_tol
        errs = []
        ops = R2_OPS_PER_STEP if kernel == "v2v3" else R4_OPS_PER_STEP
        for label, k, lw, blocks in KERNEL_SHAPES:
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
            b = half_bound(n, lw, ops)
            print(f"phase 5: {kernel} {label} windows={n}: max|diff| {errs[-1]:.3g}; kernel "
                  f"{ms:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_by']}), plain "
                  f"{plain_ms:.4f} ms", flush=True)
            if label.startswith("flagship K=5824 lw=64"):
                out[kernel] = {"ms": ms, "plain_ms": plain_ms, **b, **device_ms(
                    lambda: bcjr.half_windowed(*core, kernel), 50, kernel)}
        out[kernel]["max_abs_err"] = max(errs)
    errs = []
    for label, k, lw, blocks in KERNEL_SHAPES:
        sys_h, par_h, other, ts, tp, al, bf, _ = half_args(torch, dev, k, lw, blocks)
        perm, inv = turbo.qpp_tensors(k, dev)
        for idx in (perm, inv):  # the second half's map, then the first's
            fused = (sys_h, par_h, other, idx.to(torch.int32), al, bf,
                     turbo.tail_beta(ts, tp), lw)
            got = bcjr.bcjr_half_fused(*fused)
            ref = bcjr.bcjr_half_fused_plain(*fused)
            torch.cuda.synchronize()
            errs.append(max_diff(torch, got, ref, f32_tol))
        # the unfused form of the same half: gather, injection and NII shift in torch
        unfused = (sys_h, par_h, other[:, inv], ts, tp, al, bf, lw)
        ms = cuda_ms(torch, lambda: bcjr.bcjr_half_fused(*fused), reps=50)
        plain_ms = cuda_ms(torch, lambda: bcjr.bcjr_half_fused_plain(*fused), reps=3)
        unfused_ms = cuda_ms(torch, lambda: bcjr.bcjr_half_windowed(*unfused), reps=20)
        b = fused_bound(blocks, k, lw)
        print(f"phase 5: fused {label}: max|diff| {max(errs[-2:]):.3g} (qpp_perm and "
              f"qpp_inv); kernel {ms:.4f} ms (bound {b['bound_ms']:.4f}, {b['bound_by']}), "
              f"plain {plain_ms:.4f} ms; r2max half with torch glue {unfused_ms:.4f} ms",
              flush=True)
        if label.startswith("flagship K=5824 lw=64"):
            out["fused"] = {"ms": ms, "plain_ms": plain_ms, **b, **device_ms(
                lambda: bcjr.bcjr_half_fused(*fused), 50, "fused")}
    out["fused"]["max_abs_err"] = max(errs)
    return out


def phase_variant_chains(torch, entry, bcjr, dev, iq, want):
    """entry()'s chain with each other kernel instance (CRC early exit) and
    in the forced form (the fused half); returns each instance's launches
    and its chain's ms/batch."""
    launches, chain_ms = {}, {}
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
        t = chain_ms[name] = cuda_ms(torch, lambda: fn(iq), reps=5)
        t_turbo = cuda_ms(torch, lambda: turbo_stage(groups), reps=5)
        form = "forced 8" if codec.forced else "early exit"
        print(f"phase 6: {name} {form}: all {BATCH} TBs pass, bit-exact, launches {counts}, "
              f"mean iters/block {float(iters.float().mean()):.3f}; {t:.3f} ms/batch = "
              f"{int(ok.sum()) * codec.grant.tbs / t / 1e3:.1f} Mbps decoded; turbo stage "
              f"{t_turbo:.3f} ms", flush=True)
    return launches, chain_ms


def viterbi_inputs(np, convcode, batch, n, kind, seed):
    """(llrs [batch, n, 3] float32, bits [batch, n]): noisy codewords of
    random bits at `kind` dB per coded bit, or random LLRs, all-zero LLRs,
    or one constant LLR per hypothesis (a multiple of 1/4, so that every
    sum is exact and path metrics tie everywhere)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n)).astype(np.uint8)
    if kind == "random":
        return (rng.standard_normal((batch, n, 3)) * 4.0).astype(np.float32), bits
    if kind == "zeros":
        return np.zeros((batch, n, 3), np.float32), bits
    if kind == "constant":
        c = np.round(rng.uniform(-4.0, 4.0, batch) * 4.0) / 4.0
        return np.ascontiguousarray(np.broadcast_to(c[:, None, None], (batch, n, 3)),
                                    dtype=np.float32), bits
    snr_db = kind
    x = 1.0 - 2.0 * np.swapaxes(convcode.encode(bits), -1, -2)
    var = 10.0 ** (-snr_db / 10.0)
    y = x + np.sqrt(var) * rng.standard_normal(x.shape)
    return np.ascontiguousarray(2.0 * y / var, dtype=np.float32), bits


def phase_viterbi(torch, np, viterbi, convcode, dev, cold):
    """The Viterbi kernel against decode_plain at the paths' shapes (`cold`:
    the cold-start paths' B=1 blind searches, a partly filled CTA): equal
    hard bits (exact) on noisy codewords, random LLRs and tie inputs (all
    zero, constant), and the transmitted bits at 10 dB; both timed at every
    shape. Returns the flagship row (B=4,608, n=44) with the largest bit
    difference over every shape and input."""
    row, err = None, 0
    for label, batch, n in VITERBI_SHAPES + cold:
        for j, snr in enumerate((0.0, 3.0, 10.0, "zeros", "constant", "random")):
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
        timing = device_ms(lambda: convcode.decode(llr), 50, "viterbi")
        print(f"phase 8: viterbi {label} B={batch} n={n}: kernel = decode_plain bit for bit "
              f"at 0/3/10 dB, all-zero, constant and random LLRs, 10 dB = sent bits; kernel "
              f"{ms:.4f} ms (device {timing['device_ms']:.4f}), plain {plain_ms:.4f} ms",
              flush=True)
        if row is None:  # llr [B, n, 3] float32 in, [B, n] bytes out; 64 states, 2n steps
            row = {"ms": ms, **timing, "plain_ms": plain_ms,
                   **bound(batch * n * 13, VITERBI_OPS_PER_STATE_STEP * 64 * 2 * n * batch)}
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


COLD_SNR_DB = 14.0
COLD_LEAD, COLD_CFO = 1234, 0.22
COLD_FRAMES, COLD_SFN0 = 4, 6
CRNTI, COLD_MCS = 0x4601, 12
# phase 12's cell: port 0 8 dB under port 1, so that the single-port PBCH
# hypothesis fails and the Alamouti hypothesis has to find the MIB (with
# this seed: at 8 dB some noise draws still let the single port through)
PORT_GAINS = (0.4, 1.0)
COLD_SEED = {1: 11, 2: 13}


def cold_shapes(rx, n_ports: int):
    """The shapes at which the cold-start path's one processed subframe
    (B=1) launches the kernels, from the stream's own settings: ((label, K,
    lw, blocks) of its r2max halves, (label, candidates, n) of its blind
    search's Viterbi call). Phases 2 and 8 hold the kernels against their
    twins at these shapes, and the cold-start phase checks that they are the
    ones it ran."""
    from srsue_tpu_torch.mac.rnti import SI_RNTI
    from srsue_tpu_torch.phy import control, dci, ra, segmentation, turbo
    from srsue_tpu_torch.phy.cell import Cell

    cell = Cell(n_prb=100, n_ports=n_ports)
    rnti, sf, mcs, ue_specific, what = ((SI_RNTI, 5, rx.SI_MCS, False, "SIB") if n_ports == 1
                                        else (CRNTI, rx.DATA_SF, COLD_MCS, True, "C-RNTI TB"))
    plan = segmentation.plan(ra.dl_grant(cell.n_prb, mcs).tbs)
    check(plan.c_minus == 0, f"cold start: the {what} has blocks of two sizes")
    k = plan.k_plus
    lw = turbo.pick_window(k) or k
    n_cce, _ = control.pdcch_geometry(cell, 2)
    n_cand = len(control.search_space_candidates(n_cce, rnti, sf, ue_specific))
    n = dci.size_0_1a(cell.n_prb) + 16
    return ((f"cold start, {what} K={k} lw={lw}", k, lw, plan.c),
            (f"cold start, blind search for the {what}", n_cand, n))


def wall_readings(torch, fn, reps: int = 3) -> list:
    """Host wall ms of each of `reps` calls of fn, each ended by a device
    synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def wall_ms(torch, fn, reps: int = 3) -> float:
    """The least of wall_readings."""
    return min(wall_readings(torch, fn, reps))


def phase_cold_start(torch, np, rx, bcjr, viterbi, dev, n_ports: int, phase: int, shapes):
    """Raw IQ of a 20 MHz cell -> cell search -> MIB -> aligned subframes ->
    UeDl.process, on the card; the search and the MIB again on the CPU.
    1 port: the SIB on the SI-RNTI. 2 ports: a C-RNTI TB through the SFBC
    control region and Alamouti. `shapes` is cold_shapes(rx, n_ports), held
    against the twins in phases 2 and 8. Returns the path's launches."""
    from srsue_tpu_torch.mac.rnti import SI_RNTI
    from srsue_tpu_torch.phy import control, segmentation, sync
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.phy.receiver import Receiver
    from srsue_tpu_torch.phy.ue_dl import UeDl
    from srsue_tpu_torch.radio import ArrayRadio

    tag = f"phase {phase}"
    cell = Cell(n_prb=100, cell_id=301 if n_ports == 1 else 150, n_ports=n_ports)
    sib = np.random.default_rng(phase).bytes(96) if n_ports == 1 else None
    t0 = time.perf_counter()
    stream = rx.build_cell_stream(cell, COLD_FRAMES, sib=sib, snr_db=COLD_SNR_DB,
                                  seed=COLD_SEED[n_ports],
                                  sfn0=COLD_SFN0, crnti=0 if n_ports == 1 else CRNTI,
                                  mcs_data=COLD_MCS, lead=COLD_LEAD, cfo=COLD_CFO,
                                  port_gains=PORT_GAINS)
    print(f"{tag}: {COLD_FRAMES} frames of a 20 MHz {n_ports}-port cell (id {cell.cell_id}" +
          (f", port gains {PORT_GAINS}" if n_ports == 2 else "") + "): "
          f"{len(stream.iq)} samples at {cell.srate / 1e6:.2f} Msps, {stream.iq.nbytes / 1e6:.1f} "
          f"MB, lead {COLD_LEAD}, CFO {COLD_CFO}, {COLD_SNR_DB} dB; built on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def acquire(device):
        r = Receiver(ArrayRadio(stream.iq, cell.srate), device=device)
        found = r.cell_search()
        check(found is not None, f"{tag}: cell search on {device} found nothing")
        before = viterbi.launches
        got = r.decode_mib_stream(found[0], found[2], found[3], found[1])
        check(got is not None, f"{tag}: no MIB on {device}")
        return r, found, got, viterbi.launches - before

    acquire(dev)  # first calls: cuFFT plans, cuDNN, cuBLAS
    zero_all(bcjr, viterbi)
    r, found, (got_cell, mib, t_sf0), mib_launches = acquire(dev)
    cell_id, is_sf5, t_off, cfo = found
    check(viterbi.launches == mib_launches == n_ports, f"{tag}: {mib_launches} Viterbi "
          f"launches for the MIB, expected {n_ports} (single-port hypothesis" +
          (", then the Alamouti one)" if n_ports == 2 else ")"))
    check((got_cell.cell_id, got_cell.n_prb, got_cell.n_ports) == (cell.cell_id, 100, n_ports),
          f"{tag}: acquired {got_cell}")
    check(abs(cfo - COLD_CFO) < 0.02, f"{tag}: CFO {cfo}")
    check(COLD_SFN0 <= mib.sfn < COLD_SFN0 + COLD_FRAMES and mib.n_prb == 100,
          f"{tag}: MIB {mib}")
    # the boundary found is that of frame (mib.sfn - COLD_SFN0) of the stream
    want_off = COLD_LEAD + (mib.sfn - COLD_SFN0) * 10 * cell.sf_len
    check(abs(t_sf0 - want_off) <= 32, f"{tag}: subframe 0 at {t_sf0}, built at {want_off}")

    r_c, found_c, (cell_c, mib_c, t_c), _ = acquire("cpu")
    check(found_c[:3] == found[:3] and (cell_c, mib_c, t_c) == (got_cell, mib, t_sf0),
          f"{tag}: card {found} {mib} differs from the CPU {found_c} {mib_c}")
    peak = r.metrics["peak"]
    check(abs(found_c[3] - cfo) < 1e-3 and abs(r_c.metrics["peak"] - peak) < 1e-3 * peak,
          f"{tag}: CFO card {cfo}, CPU {found_c[3]}; peak {peak}, {r_c.metrics['peak']}")
    print(f"{tag}: cell {cell_id}, is_sf5 {is_sf5}, offset {t_off}, CFO {cfo:.4f} (CPU "
          f"{found_c[3]:.4f}), peak {peak:.3f}; MIB sfn {mib.sfn} (quarter {mib.sfn % 4}), "
          f"{got_cell.n_prb} PRB, {got_cell.n_ports} port(s), {mib_launches} Viterbi "
          f"launch(es) at B=4 n=40; card = CPU on every decision", flush=True)

    # steady state to the subframe that carries the grant
    rnti, target, ue_specific = ((SI_RNTI, 5, False) if n_ports == 1
                                 else (CRNTI, rx.DATA_SF, True))
    ue = UeDl(got_cell, device=dev)
    res = tti_hit = None
    for tti, iq in r.subframes(got_cell, t_sf0, cfo, mib.sfn, 0, n=26):
        if tti % 10 == target and (n_ports == 2 or (tti // 10) % 2 == 0):
            before = viterbi.launches
            res = ue.process(iq, target, rnti, ue_specific=ue_specific)
            blind_launches = viterbi.launches - before
            tti_hit = tti
            break
    torch.cuda.synchronize()
    counts, vit = dict(bcjr.launches), viterbi.launches
    check(res is not None, f"{tag}: the stream ended before subframe {target}")
    check(r.state == "SYNC_DONE" and abs(r.metrics["cfo_hz"] - COLD_CFO * 15e3) < 300,
          f"{tag}: state {r.state}, {r.metrics}")
    check(res.cfi == stream.cfi and len(res.grants) == 1 and bool(res.tb_ok.all()),
          f"{tag}: CFI {res.cfi}, grants {res.grants}, tb_ok {res.tb_ok}")
    bits = res.payload.reshape(-1)
    if n_ports == 1:
        check(res.grants[0].tbs == stream.si_grant.tbs
              and np.packbits(bits).tobytes()[: len(sib)] == sib, f"{tag}: SIB bytes differ")
        what = f"SIB ({len(sib)} bytes in TBS {res.grants[0].tbs}) exact"
    else:
        frame = tti_hit // 10 - COLD_SFN0
        check(bool((bits == stream.data[(frame, target)]).all()), f"{tag}: C-RNTI TB differs")
        what = f"C-RNTI TB (TBS {res.grants[0].tbs}) bit-exact through SFBC control + Alamouti"
    # the kernels ran at the shapes that phases 2 and 8 held against the twins
    (_, k, lw, blocks), (_, n_cand, _) = shapes
    plan = segmentation.plan(res.grants[0].tbs)
    n_cce, _ = control.pdcch_geometry(got_cell, res.cfi)
    searched = len(control.search_space_candidates(n_cce, rnti, target, ue_specific))
    check((plan.k_plus, plan.c, plan.c_minus) == (k, blocks, 0) and searched == n_cand,
          f"{tag}: ran {plan.c} blocks of K={plan.k_plus} and {searched} candidates, the "
          f"twins were held at {shapes}")
    check(bcjr.shapes["r2max"] == {(blocks * (k // lw), lw)},
          f"{tag}: r2max launched at (windows, lw) {bcjr.shapes['r2max']}, held at {shapes}")
    iters = int(res.turbo_iters.max())
    check(blind_launches == 1 and vit == mib_launches + 1, f"{tag}: {vit} Viterbi launches")
    check(counts == {n: 2 * iters if n == "r2max" else 0 for n in counts} and iters > 0,
          f"{tag}: BCJR launches {counts} for {iters} iterations")
    print(f"{tag}: tti {tti_hit}: CFI {res.cfi}, one grant, {what}; launches: Viterbi "
          f"{vit} (MIB {mib_launches} + blind search 1 at B={n_cand}), BCJR r2max "
          f"{counts['r2max']} at {blocks} x K={k}",
          flush=True)

    # times: host wall with a synchronise, the least of 3 (the radio rewound first)
    def search():
        r.radio.seek(0)
        return r.cell_search()

    search_ms = wall_ms(torch, search)
    mib_ms = wall_ms(torch, lambda: r.decode_mib_stream(cell_id, t_off, cfo, is_sf5))
    # whether a live stream keeps up is read off the slowest pass, not the least
    sub_ms = [t / 20 for t in wall_readings(torch, lambda: sum(1 for _ in r.subframes(
        got_cell, t_sf0, cfo, mib.sfn, 0, n=20)), reps=5)]
    iq_hit = next(iq for tti, iq in r.subframes(got_cell, t_sf0, cfo, mib.sfn, 0, n=26)
                  if tti == tti_hit)
    ue_ms = wall_ms(torch, lambda: ue.process(iq_hit, target, rnti, ue_specific=ue_specific))
    r.radio.seek(0)
    raw = torch.as_tensor(r.radio.rx_now(int(0.03 * cell.srate))[0], device=dev)
    low = sync.decimate(raw, 16)
    segs = low[: 6 * 9600].reshape(6, 9600)
    dec_ms = cuda_ms(torch, lambda: sync.decimate(raw, 16), reps=20)
    pss_ms = cuda_ms(torch, lambda: sync.pss_correlate(segs), reps=20)
    h2d_ms = wall_ms(torch, lambda: torch.as_tensor(stream.iq[: raw.shape[0]], device=dev))

    def read():
        r.radio.seek(0)
        return r.radio.rx_now(raw.shape[0])

    read_ms = wall_ms(torch, read)
    print(f"{tag}: ms (host wall, synchronised): cell search over 3 frames {search_ms:.3f} "
          f"(of it: the radio's read of {raw.shape[0]} samples on the host {read_ms:.3f}, their "
          f"copy to the card {h2d_ms:.3f}; CUDA events: decimate 16x "
          f"{dec_ms:.4f}, pss_correlate [6, 9600] {pss_ms:.4f}), MIB {mib_ms:.3f}, steady "
          f"state per subframe, 5 passes of 20 (one read of the residual CFO each): least "
          f"{min(sub_ms):.4f}, mean {sum(sub_ms) / len(sub_ms):.4f}, largest {max(sub_ms):.4f} "
          f"(a subframe lasts 1 ms on air), "
          f"UeDl.process of the grant's subframe {ue_ms:.3f}", flush=True)
    return {"r2max": counts["r2max"], "viterbi": vit}


def phase_silence(np, dev):
    """Noise only, 4 frames at 30.72 Msps: no cell, and stream() ends."""
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.phy.receiver import Receiver
    from srsue_tpu_torch.radio import ArrayRadio

    cell = Cell(n_prb=100)
    rng = np.random.default_rng(12)
    n = 4 * 10 * cell.sf_len
    noise = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    r = Receiver(ArrayRadio(noise, cell.srate), device=dev)
    check(r.cell_search() is None, "phase 12: a cell found in noise")
    r = Receiver(ArrayRadio(noise, cell.srate), device=dev)
    status = []
    r.on_sync_status = status.append
    check(list(r.stream(10)) == [], "phase 12: stream() yielded subframes from noise")
    check(r.radio.exhausted and not any(status) and len(status) == 60,
          f"phase 12: silent stream: {len(status)} indications")
    print(f"phase 12: noise only: cell_search() is None (peak {r.metrics['peak']:.3f}), "
          f"stream() ended after {len(status)} out-of-sync indications", flush=True)


def phase_tm2(torch, rx, bcjr, viterbi, dev, siso_forced_ms):
    """rx.make_tm2_rx on rx.build_tm2's B=256 subframes at 26 dB, early exit
    and forced 8. Returns {form: launches of its BCJR instance}."""
    t0 = time.perf_counter()
    clean = rx.build_tm2(BATCH, n_distinct=4)
    iq = torch.as_tensor(rx.add_noise(clean.rng, clean.td, clean.p_sig, SNR_DB), device=dev)
    print(f"phase 13: TM2 test vectors B={BATCH} (2 ports, CRS, SFBC PDSCH, MCS 28) built on "
          f"the host in {time.perf_counter() - t0:.2f} s", flush=True)
    tbs = clean.grant.tbs
    out = {}
    for label, inst, kw in (("early exit", "r2max", {}), ("forced 8", "fused", {"forced": True})):
        fn = rx.make_tm2_rx(clean.cell, clean.grant, clean.subframe, clean.rnti, clean.payloads,
                            early_exit=True, device=dev, **kw)
        fn(iq)
        torch.cuda.synchronize()
        zero_all(bcjr, viterbi)
        stats = {k: float(v) for k, v in fn(iq).items()}
        torch.cuda.synchronize()
        counts = dict(bcjr.launches)
        check(stats["n_ok"] == BATCH and stats["bit_match"] == 1.0, f"TM2 {label}: {stats}")
        expect = 2 * int(stats["max_iters"])
        check(counts == {n: expect if n == inst else 0 for n in counts} and viterbi.launches == 0,
              f"TM2 {label}: BCJR launches {counts}, expected {expect} of {inst} only; "
              f"Viterbi {viterbi.launches}")
        if kw:
            check(stats["mean_iters"] == 8.0, f"TM2 forced: {stats['mean_iters']} iterations")
        out[inst] = counts[inst]
        t = cuda_ms(torch, lambda: fn(iq), reps=5)
        print(f"phase 13: TM2 {label}: {BATCH}/{BATCH} TBs pass, bit-exact; BCJR {inst} "
              f"x{expect}, mean iters/block {stats['mean_iters']:.3f}; {t:.3f} ms/batch = "
              f"{stats['n_ok'] * tbs / t / 1e3:.1f} Mbps decoded" + (
                  f" (SISO forced 8 chain of phase 6: {siso_forced_ms:.3f} ms/batch)"
                  if kw else ""), flush=True)
    return out


def ul_grants(rx):
    """The uplink's cell (the flagship's, 100 PRB cell 42) and grants, built
    as bench.py builds its UL grant (rx.ul_grant): {"full": 100 PRB MCS 28,
    "bench": 50 PRB MCS 20}."""
    from srsue_tpu_torch.phy.cell import Cell

    return (Cell(n_prb=rx.N_PRB, cell_id=rx.CELL_ID),
            {"full": rx.ul_grant(100, 28), "bench": rx.ul_grant(50, 20)})


def ul_shapes(rx):
    """(label, K, lw, blocks) of every r2max decode phase 14 runs: the
    full-width grant at B=256 and B=1, bench.py's grant at B=1."""
    from srsue_tpu_torch.phy import segmentation, turbo

    _, grants = ul_grants(rx)
    out = []
    for name, batch in (("full", BATCH), ("full", 1), ("bench", 1)):
        plan = segmentation.plan(grants[name].tbs)
        check(plan.c_minus == 0, f"uplink: the {name} grant has blocks of two sizes")
        k = plan.k_plus
        out.append((f"uplink {name} grant B={batch} K={k}", k, turbo.pick_window(k) or k,
                    plan.c * batch))
    return tuple(out)


def phase_uplink(torch, np, rx, bcjr, viterbi, dev, held):
    """Phase 14: the UE's host encode, the eNB's PUSCH decode at B=256 and
    B=1, a corrupted subframe, UCI, the UL HARQ loop through PHICH, and
    PHICH on 1 and 2 ports. `held` is the set of (K, lw, blocks) at which
    phase 2 held r2max against its twin; every r2max launch here must have
    run at one of them, as the wrapper records it (bcjr.shapes). Returns the
    r2max launches of the B=256 decode."""
    from srsue_tpu_torch.mac.ul_harq import UlHarq
    from srsue_tpu_torch.phy import control, equalize
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.phy.pusch import PuschCodec
    from srsue_tpu_torch.phy.ue_ul_ctrl import UlCtrl, UlCtrlConfig

    cell, grants = ul_grants(rx)
    full, bench_g = grants["full"], grants["bench"]
    rng = np.random.default_rng(14)

    def codec_of(grant, device=dev, **kw):
        return PuschCodec(cell, grant, rx.RNTI, rx.UL_SUBFRAME, device=device, **kw)

    held_n = {(b * (k // lw), lw) for k, lw, b in held}  # as [windows, lw]

    def ran_held(what):
        """Every r2max launch since the last call ran at a shape phase 2 held."""
        got = set(bcjr.shapes["r2max"])
        bcjr.shapes["r2max"].clear()
        check(bool(got) and got <= held_n, f"uplink {what}: r2max launched at (windows, lw) "
              f"{sorted(got)}; phase 2 held {sorted(held_n)}")

    def noisy(codec, wave, snr_db):
        """One subframe [1, sf_len] with AWGN at snr_db per allocated subcarrier."""
        p_sig = float(np.mean(np.abs(wave) ** 2)) * cell.nfft / codec.m_sc
        return rx.add_noise(rng, wave[None], p_sig, snr_db)

    # the UE's host encode, one subframe per TTI
    enc_ms = {}
    for name, grant in grants.items():
        codec = codec_of(grant)
        pays = [rng.integers(0, 2, grant.tbs).astype(np.uint8) for _ in range(8)]
        codec.encode_sf(pays[0])
        per = []
        for _ in range(5):
            t0 = time.perf_counter()
            for i in range(20):
                codec.encode_sf(pays[i % 8])
            per.append((time.perf_counter() - t0) * 1e3 / 20)
        enc_ms[name] = per
        print(f"phase 14: UE host encode_sf, {grant.n_prb} PRB MCS {grant.mcs} (TBS "
              f"{grant.tbs}, {codec.plan.c} x K={codec.plan.k_plus}), ms per subframe over 5 "
              f"passes of 20: least {min(per):.4f}, mean {sum(per) / len(per):.4f}, largest "
              f"{max(per):.4f} (a subframe lasts 1 ms on air)", flush=True)

    # the eNB's decode at full width, B=256 at 26 dB: 4 distinct TBs tiled
    codec = codec_of(full)
    t0 = time.perf_counter()
    ul = rx.build_pusch(BATCH, n_distinct=4, seed=14)
    check(ul.grant == full and (ul.subframe, ul.rnti) == (codec.subframe, codec.rnti),
          "uplink: rx.build_pusch's grant differs")
    iq = torch.as_tensor(rx.add_noise(ul.rng, ul.td, ul.p_sig, SNR_DB), device=dev)
    want = torch.as_tensor(ul.payloads, device=dev)
    print(f"phase 14: test vectors B={BATCH} (full-width PUSCH, 4 distinct TBs, {SNR_DB} dB) "
          f"built on the host in {time.perf_counter() - t0:.2f} s", flush=True)
    zero_all(bcjr, viterbi)
    codec.decode_sf(iq)  # first call: cuFFT plans
    torch.cuda.synchronize()
    ran_held(f"B={BATCH}")
    zero_all(bcjr, viterbi)
    pay, ok, iters = codec.decode_sf(iq)
    torch.cuda.synchronize()
    counts = dict(bcjr.launches)
    loops = int(iters.max())
    check(bool(ok.all()), f"uplink B={BATCH}: {int((~ok).sum())} TBs failed CRC")
    check(bool((pay == want).all()), f"uplink B={BATCH}: payload not bit-exact")
    check(counts == {n: 2 * loops if n == "r2max" else 0 for n in counts}
          and viterbi.launches == 0 and loops > 0,
          f"uplink B={BATCH}: launches {counts}, Viterbi {viterbi.launches}, {loops} iterations")
    launches = counts["r2max"]
    t = cuda_ms(torch, lambda: codec.decode_sf(iq), reps=5)
    bufs = codec.dematch_sf(iq)
    t_dm = cuda_ms(torch, lambda: codec.dematch_sf(iq), reps=5)
    t_dec = cuda_ms(torch, lambda: codec.decode_softbuffers(bufs), reps=5)
    ran_held(f"B={BATCH}")
    print(f"phase 14: eNB decode_sf B={BATCH}: {BATCH}/{BATCH} TBs pass, bit-exact; r2max "
          f"x{launches} ({loops} iterations, 13 x {BATCH} blocks of K=5824), mean iters/block "
          f"{float(iters.float().mean()):.3f}; {t:.3f} ms/batch = "
          f"{int(ok.sum()) * full.tbs / t / 1e3:.1f} Mbps decoded; dematch_sf {t_dm:.3f} ms, "
          f"decode_softbuffers {t_dec:.3f} ms", flush=True)
    del bufs

    one = iq[:1].contiguous()
    pay1, ok1, _ = codec.decode_sf(one)
    check(bool(ok1.all()) and bool((pay1 == want[:1]).all()), "uplink B=1: not bit-exact")
    lat = wall_readings(torch, lambda: codec.decode_sf(one), reps=10)
    print(f"phase 14: eNB decode_sf B=1 latency (host wall, synchronised, 10 calls): least "
          f"{min(lat):.3f}, mean {sum(lat) / len(lat):.3f}, largest {max(lat):.3f} ms", flush=True)
    bad = one.clone()
    bad[:, 2000:12000] = 0  # symbols 1-5, the first DMRS among them
    _, ok_bad, it_bad = codec.decode_sf(bad)
    check(not bool(ok_bad.any()), "uplink: a corrupted subframe passed its CRC")
    ran_held("B=1")
    print(f"phase 14: corrupted subframe: CRC fails, {int(it_bad.max())} iterations, no crash",
          flush=True)
    del iq, want, one, bad

    # UCI on bench.py's grant: the ACK bit and UlCtrl's wideband CQI, B=1
    ctl = UlCtrl(UlCtrlConfig(cqi_config_index=2, n_prb=cell.n_prb))  # period 5, offset 0
    for _ in range(30):
        ctl.update_snr(SNR_DB)
    cqi = ctl.cqi_for_tti(0)
    check(cqi is not None and len(cqi) == 4, f"UlCtrl: CQI report {cqi}")
    pay_u = rng.integers(0, 2, bench_g.tbs).astype(np.uint8)
    for ack in (True, False):
        codec_u = codec_of(bench_g, n_cqi_bits=len(cqi), with_ack=True)
        iq_u = noisy(codec_u, codec_u.encode_sf_uci(pay_u, cqi_bits=cqi, ack=ack), SNR_DB)
        card = [v.cpu().numpy() for v in codec_u.decode_sf(torch.as_tensor(iq_u, device=dev))]
        uci_card = codec_u.decode_uci()
        ran_held("UCI")
        check(bool(card[1].all()) and bool((card[0] == pay_u).all()), f"UCI ack={ack}: TB")
        check(uci_card[1] is ack and bool((uci_card[0] == cqi).all()),
              f"UCI: sent ACK {ack}, CQI {cqi}; found {uci_card}")
    codec_c = codec_of(bench_g, "cpu", n_cqi_bits=len(cqi), with_ack=True)
    cpu = [v.numpy() for v in codec_c.decode_sf(torch.as_tensor(iq_u))]
    uci_cpu = codec_c.decode_uci()
    check(all((a == b).all() for a, b in zip(card, cpu)) and uci_cpu[1] is uci_card[1]
          and bool((uci_cpu[0] == uci_card[0]).all()), "UCI: card and CPU disagree")
    iq_t = torch.as_tensor(iq_u, device=dev)
    lat_u = wall_readings(torch, lambda: (codec_u.decode_sf(iq_t), codec_u.decode_uci()), reps=10)
    ran_held("UCI")
    print(f"phase 14: UCI on PUSCH ({bench_g.n_prb} PRB MCS {bench_g.mcs}, TBS {bench_g.tbs}, "
          f"{codec_u.plan.c} x K={codec_u.plan.k_plus}): ACK and NACK and CQI {cqi.tolist()} "
          f"(UlCtrl at {SNR_DB} dB) found, TB bit-exact; card = CPU (payload, CRC, iterations "
          f"{card[2].tolist()}, ACK, CQI); B=1 decode_sf + decode_uci host wall least "
          f"{min(lat_u):.3f}, mean {sum(lat_u) / len(lat_u):.3f}, largest {max(lat_u):.3f} ms",
          flush=True)

    # the UL HARQ loop: UlHarq, eNB-side combining, PHICH to the UE
    harq = UlHarq()
    data = rng.bytes(bench_g.tbs // 8)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    tti, rv = rx.UL_SUBFRAME, harq.new_tx(rx.UL_SUBFRAME, data)
    n_groups = control.n_phich_groups(cell)
    group, nseq = control.phich_group_seq(bench_g.prb_start, 0, n_groups)
    soft, seen = None, []
    for _ in range(2):
        codec_h = PuschCodec(cell, dataclasses.replace(bench_g, rv=rv), rx.RNTI, tti % 10,
                             device=dev)
        bufs = codec_h.dematch_sf(noisy(codec_h, codec_h.encode_sf(bits), UL_HARQ_SNR_DB))
        soft = bufs if soft is None else [a + b for a, b in zip(soft, bufs)]
        pay_h, ok_h, _ = codec_h.decode_softbuffers(soft)
        ran_held("HARQ")
        good = bool(ok_h.all())
        check(not good or bool((pay_h.cpu().numpy() == bits).all()), "UL HARQ: payload differs")
        # the eNB answers 4 subframes later on the allocation's PHICH
        sf_phich = (tti + 4) % 10
        grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
        control.phich_map(cell, grid, sf_phich, group, nseq, good)
        ack = float(control.phich_decode(cell, grid, sf_phich, group, nseq, device=dev)) > 0
        seen.append((rv, good, ack))
        harq.harq_feedback(tti, ack)
        if ack:
            break
        tti += 8
        data_r, rv = harq.retx(tti)
        check(data_r == data, "UL HARQ: the retransmission's payload differs")
    check(seen == [(0, False, False), (2, True, True)] and not harq.has_pending(tti)
          and harq.metrics["tx_ok"] == 1, f"UL HARQ: {seen}, {harq.metrics}")
    print(f"phase 14: UL HARQ at {UL_HARQ_SNR_DB} dB ({bench_g.n_prb} PRB MCS {bench_g.mcs}): "
          f"rv0 alone CRC fail -> PHICH NACK (group {group}, seq {nseq}) -> UlHarq.retx rv 2 -> "
          f"rv0 + rv2 combined pass, payload bit-exact -> PHICH ACK -> process freed", flush=True)

    # PHICH on 1 and 2 ports: every group and sequence, card = CPU
    for n_ports in (1, 2):
        c = Cell(n_prb=100, cell_id=42, n_ports=n_ports)
        sf = 6
        sent = {(g, q): bool(rng.integers(2)) for g in range(n_groups) for q in range(8)}
        tx = [np.zeros((c.n_sym_sf, c.n_sc), np.complex64) for _ in range(n_ports)]
        for (g, q), a in sent.items():
            if n_ports == 1:
                control.phich_map(c, tx[0], sf, g, q, a)
            else:
                control.phich_map_tm2(c, tx, sf, g, q, a)
        k = np.arange(c.n_sc)
        hs = [((0.9 + 0.3j) * (0.7 if p else 1.0) + 0.2 * np.exp(2j * np.pi * k * (p + 1) / c.n_sc)
               ).astype(np.complex64) * np.ones((c.n_sym_sf, 1), np.complex64)
              for p in range(n_ports)]
        y = sum(h * g for h, g in zip(hs, tx)) + (0.07 * (
            rng.standard_normal(tx[0].shape) + 1j * rng.standard_normal(tx[0].shape)))
        metrics = {}
        for device in (dev, "cpu"):
            yt, ht = (torch.as_tensor(np.asarray(a, np.complex64), device=device)
                      for a in (y, np.stack(hs)))
            if n_ports == 1:
                g_eq, _ = equalize.zf(yt, ht[0], 0.01)
            else:
                g_eq, _ = control.sfbc_equalize_control(c, yt, ht[0], ht[1], 0.01)
            metrics[str(device)] = torch.stack(
                [control.phich_decode(c, g_eq, sf, g, q, device=device) for g, q in sent]).cpu()
        m_card, m_cpu = metrics[str(dev)], metrics["cpu"]
        want_sign = torch.tensor(list(sent.values()))
        check(bool(((m_card > 0) == want_sign).all()) and bool(((m_cpu > 0) == want_sign).all()),
              f"PHICH {n_ports} port(s): a wrong ACK/NACK")
        torch.testing.assert_close(m_card, m_cpu, rtol=1e-5, atol=1e-5 * float(m_cpu.abs().max()))
        print(f"phase 14: PHICH on {n_ports} port(s): {len(sent)} PHICHs ({n_groups} groups x 8 "
              f"sequences, {int(want_sign.sum())} ACK), every decision right on the card, card "
              f"= CPU (metric within rtol 1e-5)", flush=True)
    return launches


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
    # resident warps per SM at the flagship shapes (3,328 blocks of K=5824; the
    # blind search's n=44), by the CUDA occupancy calculator
    warps = {name: build.warps_per_sm(name, 64) for name in build.HALF_KERNELS}
    warps["fused"] = build.warps_per_sm("fused", BATCH * 13, 5824, 64)
    warps["viterbi"] = build.warps_per_sm("viterbi", 44)
    usage = ptxas_usage(lib.log)
    for name, inst in (("v4", "F32"), ("v5", "BF2")):
        regs = [u for k, u in usage.items() if "bcjr_half_r4_kernel" in k and inst in k]
        check(len(regs) == 1 or not lib.log, f"ptxas output lists {len(regs)} {name} kernels")
        if regs:
            check(regs[0][1] == 0, f"radix-4 {name} spills {regs[0][1]} B")
        check(warps[name] >= 12, f"radix-4 {name}: {warps[name]} warps/SM at lw=64")
        print(f"phase 1: radix-4 {name}: " + (f"{regs[0][0]} registers, {regs[0][1]} B "
              f"spilled, " if regs else "library reused, ") + f"{warps[name]} warps/SM at "
              f"lw=64", flush=True)
    print("phase 1: warps per SM at lw=64: " + ", ".join(
        f"{k} {v}" for k, v in warps.items()) + "; at lw=104: " + ", ".join(
        f"{k} {build.warps_per_sm(k, 104)}" for k in build.HALF_KERNELS) +
        f", fused {build.warps_per_sm('fused', BATCH * 13, 5824, 104)}", flush=True)

    cold = {p: cold_shapes(rx, p) for p in (1, 2)}
    extra = tuple(cold[p][0] for p in (1, 2))
    held = {(k, lw, b) for _, k, lw, b in R2MAX_SHAPES + extra}
    extra += tuple(sh for sh in ul_shapes(rx) if sh[1:] not in held)
    held |= {sh[1:] for sh in extra}
    rows = phase_kernel(torch, bcjr, dev, extra)
    fn, iq, want, launches = phase_chain(torch, entry, bcjr, dev)

    bad = iq[:8].clone()
    bad[:, 1000:3000] = 0
    _, ok_bad, _ = fn(bad)
    torch.cuda.synchronize()
    check(not bool(ok_bad.any()), "corrupted waveform passed its CRC")
    print("phase 4: corrupted waveform: every CRC fails, no crash", flush=True)

    new = phase_new_kernels(torch, bcjr, turbo, dev)
    new_launches, variant_ms = phase_variant_chains(torch, entry, bcjr, dev, iq, want)
    for line in bench_kernel_variants.report(bench_kernel_variants.run(dev, reps=20)):
        print(f"phase 7: {line}", flush=True)
    vit_row = phase_viterbi(torch, np, viterbi, convcode, dev,
                            tuple(cold[p][1] for p in (1, 2)))
    clean, noisy, vit_launches = phase_blind_chain(torch, rx, ofdm, chest, dci, bcjr,
                                                   viterbi, dev)
    phase_ue_dl(torch, np, entry, UeDl, DlHarq, PdschCodec, enb_tx, bcjr, viterbi, dev,
                clean, noisy)
    del clean, noisy, iq, want, fn
    cold1 = phase_cold_start(torch, np, rx, bcjr, viterbi, dev, n_ports=1, phase=11,
                             shapes=cold[1])
    cold2 = phase_cold_start(torch, np, rx, bcjr, viterbi, dev, n_ports=2, phase=12,
                             shapes=cold[2])
    phase_silence(np, dev)
    tm2 = phase_tm2(torch, rx, bcjr, viterbi, dev, variant_ms["fused"])
    ul_launches = phase_uplink(torch, np, rx, bcjr, viterbi, dev, held)

    flag = rows[0]
    kernels = [{
        "name": "bcjr_half", "route": "cuda",
        "source": "srsue_tpu_torch/csrc/bcjr_half.cu",
        "replaces": f"{TURBO}:372",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": flag["ms"], "device_ms": flag["device_ms"],
        "device_ms_by": flag["device_ms_by"], "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "warps_per_sm": warps["r2max"],
        "launches_by_path": {"entry early exit": launches, "cold start 1 port": cold1["r2max"],
                             "cold start 2 ports": cold2["r2max"],
                             "tm2 early exit": tm2["r2max"],
                             "pusch early exit": ul_launches}}]
    for name, (source, replaces) in NEW_KERNELS.items():
        kernels.append({"name": f"bcjr_half_{name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": new_launches[name], **new[name],
                        "warps_per_sm": warps[name],
                        "launches_by_path": {"entry": new_launches[name], **(
                            {"tm2 forced": tm2["fused"]} if name == "fused" else {})}})
    kernels.append({"name": "viterbi", "route": "cuda",
                    "source": "srsue_tpu_torch/csrc/viterbi.cu",
                    "replaces": "srsue_tpu/phy/convcode.py:85", "launches": vit_launches,
                    **vit_row, "warps_per_sm": warps["viterbi"],
                    "launches_by_path": {"blind chain": vit_launches,
                                         "cold start 1 port": cold1["viterbi"],
                                         "cold start 2 ports": cold2["viterbi"]}})
    for k in kernels:  # no single PyTorch call computes a max-log BCJR or a Viterbi
        k["library_ms"] = None
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
