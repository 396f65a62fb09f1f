#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srsue_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout; one GPU, nvcc
    python3 chip_smoke.py --world N    # phase 2 at the sharded shapes, phase 16's
                                       # sharded paths on N GPUs over NCCL and,
                                       # N even, phase 18 (b) as 2 nodes of N/2

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
     CPU; every r2max launch at a shape phase 2 held against the twin;
     then a loaded subframe (PuschCell over the seven UEs of perfbench's
     lte20_pusch_7ue_mixed: 25/25/15/15/6/6/4 PRB, 16QAM and QPSK, each
     with its own DMRS cyclic shift, TB, ACK, two with CQI) at B=256 and 26
     dB: every UE's TB bit-exact, its CQI and ACK found, one demap launch a
     UE, one turbo.decode a K across the UEs (r2max at the four K-groups'
     shapes, each held in phase 2), card = CPU on 4 subframes (payload,
     CRC, iterations, CQI, ACK), ms/batch;
 15. the whole UE over the air (Ue, Phy, the MAC and the upper layers against
     the port's eNB emulator EnbPhy, on a 20 MHz cell 123 with complex AWGN
     of amplitude 0.01 while attaching): (a) RACH -> RAR -> Msg3 -> Msg4 ->
     Milenage AKA -> security mode -> reconfiguration with attach accept
     within 220 TTIs, then one UL and one DL user packet byte-exact; (b) DL
     HARQ (rotating symbol erasures: a NACK, retransmissions, the packet
     recovered only by combining) and UL HARQ (PHICH NACKs, the UE's
     autonomous retransmissions combined at the eNB); (c) the attach on a
     2-port (TM2) cell; (d) (a) again on the CPU: the same eNB events, attach
     TTI and bytes; (e) TTIs to attach, host wall ms per TTI of Phy.work and
     EnbPhy.receive_ul (least, median, largest), the path's launches and
     Phy.get_metrics(). Every r2max and Viterbi launch of the path ran at a
     shape that phases 2 and 8 held against the twins (the emulator's grant
     profile: DL MCS 6 over 4/10/25/100 PRB, UL 4 PRB at MCS 4);
 16. the sharded paths (srsue_tpu_torch/parallel: one process per rank,
     spawned by mesh.launch, NCCL on the card) and the tools: (a)
     entry.dryrun_multichip(1); (b) shard_decode at the flagship, B=256 at
     26 dB: 256/256 bit-exact, n_ok 256 from the all_reduce, payload, tb_ok
     and iters = entry's chain; (c) the window-sharded turbo decoder on the
     flagship's blocks (3,328 x K=5824, W=91) and on 256 blocks of K=6144 at
     tests/test_distributed_dsp.py's noise: hard, iters, ok =
     turbo.decode(early_exit=False, window=64) exactly, 16 r2max launches;
     (d) the time-sharded front end on 10 subframes of 20 MHz, with a CFO
     and with decimation to 6 PRB, against the unsharded front end; (e)
     (b) and (c) at world 2 on the one card over gloo with CUDA tensors; (f)
     sweep_pdsch at 6 PRB MCS 5 (card = CPU, at most one borderline TB) and
     at full width around MCS 28's waterfall; (g) one entry call under
     utils.trace.ProfilerTrace with an annotate span (the Chrome trace
     names the r2max kernel and the span, no errors) and a LayerLog line;
     (h) utils.native built into build/native/, NativeFileRadio = FileRadio
     and the txq's in-order commit, native/ unchanged. The ranks return
     their kernel counters; every r2max launch ran at a shape phase 2 held;
 17. the UE's mobility and measurement loop over the air on 20 MHz cells
     (tests/test_ota_handover.py's constants: source PCI 123, target 77,
     C-RNTI 0x5E11, dedicated preamble 7, noise 0.01): (a) attach on the
     source, A3 armed (offset 3 dB, hysteresis 1 dB, TTT ms40), the
     neighbour raised from 0.1 to 2.0: the MeasurementReport, the handover
     command over the source's PDSCH, the dedicated PRACH detected by the
     target (a second EnbPhy on the card), its RAR, the Complete on the
     target's SRB1 and a packet each way there; (b) a page at the UE's
     paging occasion (P-RNTI searched there only, DCI 1A and 1C sizes); (c)
     periodic CQI on PUCCH format 2, SRS detected, the pathloss and the
     PUSCH power tracking a 6 dB channel loss; (d) the subband CQI labels on
     a two-tap channel; each of (a)-(d) again on the CPU with every event's
     TTI, PCI, C-RNTI, report and label equal; (e) the slice's new tensor
     functions (modulate, demodulate_hard, ofdm.modulate, ratematch.match,
     convcode.encode_torch) card = CPU. Prints the TTIs to the report and to
     the Complete, Phy.work's host wall ms per TTI with and without a
     neighbour armed, and the path's r2max and Viterbi launches and shapes,
     each at a shape phases 2 and 8 held;
 18. (a) ROADMAP fault 7: the softbuffers of every caller whose positions
     repeat 3 times or more (the PDCCH blind search at 100 PRB with its L=4
     and L=8 candidates, a 2 PRB MCS 0 PDSCH grant on a 6 PRB cell, a 1 PRB
     MCS 0 PUSCH grant), B=256 seeded LLRs through each caller's own
     inverse table on the card and on the CPU: equal bit for bit (and how
     many values a zero-fill + index_add_ on the card gets wrong); the
     flagship's dematch timed against that scatter; phase 9's blind-chain
     runs again with the same decisions and BCJR and Viterbi launches; (b)
     the multi-host launch: two node processes (python -m
     srsue_tpu_torch.parallel.multihost) of one gloo rank each on this card
     over tcp://127.0.0.1 run the reference worker's carrier-sharded decode
     and window-sharded turbo decoder: both print MULTIHOST_OK, their
     decisions equal the unsharded decode and turbo decoder on the card and
     on the CPU, every r2max launch at a shape phase 2 held; prints the
     launch's seconds and each rank's r2max launches;
 19. the demap kernel (csrc/demap.cu: max-log soft demap, descramble and
     rate dematch in one pass; the softbuffer form tiled by code block, its
     bits staged in shared memory) against its plain version at atol 0, bit
     for bit, on every caller's shapes: the flagship PDSCH (64QAM, B=256, 13
     x K=5824) in both forms, with scalar noise and with the whole row as
     one segment (a range over the shared budget, staged in chunks), a
     16QAM grant, the TM2 flagship's combined symbols, the PDCCH blind
     search at 100 PRB (L=1-8, up to 5 repeats) at B=256 and B=1, PCFICH's
     32 and PBCH's 480 LLRs, the 2 PRB MCS 0 PDSCH and 1 PRB MCS 0 PUSCH
     grants (4 and 3 repeats), the UE over the air's 100 PRB MCS 6 grant at
     B=1 (its blocks split over a cluster of CTAs), phase 14's full-width
     PUSCH at B=256, the 50 PRB MCS 20 grant with ACK + 4 CQI bits
     (erasures), phase 14's loaded subframe at B=256 (its 4 and 6 PRB QPSK
     and 15 and 25 PRB 16QAM allocations, the 25 PRB's CQI LLRs), and a
     seeded table for any other (form, qm, R) that phases
     3-18 launched at; each compared call one launch, every launch of
     phases 3-18 at a (form, qm, R) held (kernels.demap.shapes), and none
     of the gather variant; the tiled kernel and the gather variant timed
     in turns (CUDA events, device time) at the flagship, the uplink B=256
     and the B=1 grant, beside the plain composition and the bounds, the
     LLR form at the flagship beside its own; phase 3's demap + dematch
     stage and the forced 8 chain with the kernel and with the torch
     composition in one call; phase 3's chain, phase 9's blind run, phase
     14's B=256 decode and the UCI again with the same decisions.

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

import contextlib
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


def host_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of `reps` calls after one more, on the host's clock
    around work ended by a synchronise: the clock ``parallel.ranks.wall_ms``
    times the sharded paths with, so that the unsharded path beside them is
    read on the same clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


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
    """Zero the BCJR counters (and the demap kernel's: every path that
    decodes a turbo block demaps first)."""
    from srsue_tpu_torch.kernels import demap

    for name in bcjr.launches:
        bcjr.launches[name] = 0
        bcjr.shapes[name].clear()
    demap.launches = demap.llr_launches = demap.gather_launches = 0


# launches of the demap kernel's softbuffer form and of its LLR form on each
# path since its counters were zeroed (phase 19 reads them; demap.shapes
# keeps every launch's shape from phase 3 on)
DEMAP_BY_PATH: dict = {}
DEMAP_LLR_BY_PATH: dict = {}


def note_demap(path: str) -> int:
    """Record the demap kernel's launches on `path` since the counters were
    zeroed, in each form; fails where the path launched no softbuffer form,
    or the gather variant. Returns the softbuffer form's count."""
    from srsue_tpu_torch.kernels import demap

    DEMAP_LLR_BY_PATH[path] = demap.llr_launches
    n = DEMAP_BY_PATH[path] = demap.launches - demap.llr_launches
    check(n > 0, f"{path}: the demap kernel did not launch")
    check(demap.gather_launches == 0, f"{path}: the gather variant launched "
          f"{demap.gather_launches} times")
    return n


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


def phase_kernel(torch, bcjr, dev, cold, base=R2MAX_SHAPES):
    """Kernel vs plain twin at the main paths' shapes (`base`); `cold` holds
    the other paths' (B=1 and small grids far under one wave, the sharded
    paths' per-rank shapes)."""
    rows = []
    for label, k, lw, blocks in base + cold:
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
    check(note_demap("entry early exit") == 1, "early exit: one demap launch per K-group")
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
    return fn, iq, want, launches, iters


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


# (label, equalizer, make_rx options) of phase 9's blind-chain runs
BLIND_RUNS = (("zf", "zf", {}), ("mmse", "mmse", {}), ("zf_scalar", "zf_scalar", {}),
              ("zf forced", "zf", {"forced": True}))


def zero_all(bcjr, viterbi) -> None:
    zero_counts(bcjr)
    viterbi.launches = 0
    viterbi.shapes.clear()


def blind_stats(rx, out: dict, clean) -> dict:
    """bench.py's statistics of one blind-chain call's outputs, as floats."""
    return {k: float(v) for k, v in rx.tb_stats(out, clean.payloads, clean.cfi).items()}


def phase_blind_chain(torch, rx, ofdm, chest, dci, bcjr, viterbi, dev):
    """The blind control + data chain (rx.make_rx) at B=256 and 26 dB with
    each equalizer (CRC early exit, r2max) and in the forced form: every
    CFI, DCI and TB found, bit-exact, with one Viterbi launch per call and
    2 x iterations of the chosen BCJR instance only; ms/batch, decoded
    Mbps and the control stage alone; BLER at 20 dB (MMSE); a corrupted
    control region finds no DCI. Returns (clean vectors, noisy IQ,
    {label: (stats, BCJR launches, Viterbi launches)} of each run)."""
    t0 = time.perf_counter()
    clean = rx.build_clean(BATCH, n_distinct=4)
    noisy = rx.add_noise(clean.rng, clean.td, clean.p_sig, SNR_DB)
    iq = torch.as_tensor(noisy, device=dev)
    print(f"phase 9: test vectors B={BATCH} (CRS, PCFICH, DCI 1A, PDSCH) built on the host "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    args = (clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti, clean.dci_bits)
    tbs = clean.grant.tbs
    chain_ms, runs = {}, {}
    for label, eq, kw in BLIND_RUNS:
        fn = rx.make_rx(*args, early_exit=True, eq=eq, device=dev, **kw)
        fn(iq)
        torch.cuda.synchronize()
        zero_all(bcjr, viterbi)
        stats = blind_stats(rx, fn(iq), clean)
        torch.cuda.synchronize()
        counts, vit = dict(bcjr.launches), viterbi.launches
        note_demap(f"blind chain {label}")
        check(stats["n_dci"] == stats["cfi_ok"] == stats["n_ok"] == BATCH
              and stats["bit_match"] == 1.0, f"blind chain {label}: {stats}")
        check(vit == 1, f"blind chain {label}: {vit} Viterbi launches, expected 1")
        inst = "fused" if kw else "r2max"
        expect = 2 * int(stats["max_iters"])
        check(counts == {n: expect if n == inst else 0 for n in counts},
              f"blind chain {label}: BCJR launches {counts}, expected {expect} of {inst} only")
        if kw:
            check(stats["mean_iters"] == 8.0, f"forced chain: {stats['mean_iters']} iterations")
        runs[label] = (stats, counts, vit)
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
    stats = blind_stats(rx, fn(iq20), clean)
    bler = 1.0 - stats["n_ok"] / BATCH
    check(bler < 0.6 and stats["n_dci"] == stats["cfi_ok"] == BATCH
          and stats["bit_match"] == 1.0, f"waterfall 20 dB mmse: {stats}")
    t = cuda_ms(torch, lambda: fn(iq20), reps=5)
    print(f"phase 9: waterfall 20 dB mmse: BLER {100 * bler:.2f}% "
          f"({int(stats['n_ok'])}/{BATCH} TBs pass, all bit-exact), all CFIs and DCIs found; "
          f"{t:.3f} ms/batch = {stats['n_ok'] * tbs / t / 1e3:.1f} Mbps decoded", flush=True)

    bad = iq.clone()
    bad[:, : bad.shape[1] // 7] = 0  # the first two OFDM symbols: the control region
    stats = blind_stats(rx, rx.make_rx(*args, early_exit=True, device=dev)(bad), clean)
    check(stats["n_dci"] == 0, f"corrupted control region: {stats['n_dci']} DCIs found")
    print(f"phase 9: corrupted control region: no DCI found, no crash "
          f"(CFI found in {int(stats['cfi_ok'])}/{BATCH})", flush=True)
    return clean, noisy, runs


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
    note_demap("UeDl.process")
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
    note_demap(f"cold start {n_ports} port(s)")
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
    and forced 8. Returns ({form: launches of its BCJR instance}, (the test
    vectors, the noisy IQ on the card))."""
    t0 = time.perf_counter()
    clean = rx.build_tm2(BATCH, n_distinct=4)
    iq = torch.as_tensor(rx.add_noise(clean.rng, clean.td, clean.p_sig, SNR_DB), device=dev)
    print(f"phase 13: TM2 test vectors B={BATCH} (2 ports, CRS, SFBC PDSCH, MCS 28) built on "
          f"the host in {time.perf_counter() - t0:.2f} s", flush=True)
    tbs = clean.grant.tbs
    out = {}
    for label, inst, kw in (("early exit", "r2max", {}), ("forced 8", "fused", {"forced": True})):
        fn = rx.make_tm2_rx(clean.cell, clean.grant, clean.subframe, clean.rnti,
                            early_exit=True, device=dev, **kw)
        fn(iq)
        torch.cuda.synchronize()
        zero_all(bcjr, viterbi)
        stats = {k: float(v) for k, v in rx.tb_stats(fn(iq), clean.payloads).items()}
        torch.cuda.synchronize()
        counts = dict(bcjr.launches)
        note_demap(f"tm2 {label}")
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
    return out, (clean, iq)


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


def ul_cell(device):
    """The loaded uplink subframe of perfbench's configuration
    lte20_pusch_7ue_mixed (the cell pusch_enb_7ue_b256): (configuration,
    PuschCell over one codec per UE on `device`)."""
    from pathlib import Path

    from srsue_tpu_torch.phy.cell import Cell, UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCell, PuschCodec

    cfg = json.loads((Path(__file__).resolve().parent / "perfbench" / "configs" /
                      "lte20_pusch_7ue_mixed.json").read_text())
    cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
    codecs = [PuschCodec(cell, UlGrant(n_prb=ue["n_prb"], prb_start=ue["prb_start"],
                                       mcs=ue["mcs"], mod_order=ue["qm"], tbs=ue["tbs"],
                                       rv=cfg["rv"]),
                         ue["rnti"], cfg["subframe"], n_turbo_iters=cfg["turbo_iters"],
                         n_cqi_bits=ue["cqi_bits"], with_ack=ue["ack_symbols"] > 0,
                         cqi_rep=ue["cqi_repetition"], ack_syms=ue["ack_symbols"],
                         device=device)
              for ue in cfg["ues"]]
    return cfg, PuschCell(cell, codecs, [ue["cyclic_shift"] for ue in cfg["ues"]])


def ul_cell_shapes():
    """(label, K, lw, blocks) of every r2max decode of phase 14's loaded
    subframe at B=256: one turbo.decode a K, its blocks of every UE."""
    from srsue_tpu_torch.phy import turbo

    _, cell_rx = ul_cell("cpu")
    return tuple((f"uplink cell B={BATCH} K={k} of {len(members)} UE(s)", k,
                  turbo.pick_window(k) or k, BATCH * sum(count for _, _, count in members))
                 for k, _, members in cell_rx._k_plan)


def phase_uplink(torch, np, rx, bcjr, viterbi, dev, held):
    """Phase 14: the UE's host encode, the eNB's PUSCH decode at B=256 and
    B=1, a corrupted subframe, UCI, the UL HARQ loop through PHICH, and
    PHICH on 1 and 2 ports. `held` is the set of (K, lw, blocks) at which
    phase 2 held r2max against its twin; every r2max launch here must have
    run at one of them, as the wrapper records it (bcjr.shapes). Returns the
    r2max launches of the B=256 decode and (its IQ, payloads, iterations)."""
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
    check(note_demap("pusch B=256") == 1, "uplink: one demap launch per K-group")
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
    kept = (iq, want, iters)  # phase 19 decodes them again
    del one, bad

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
    return launches, kept


def phase_uplink_cell(torch, np, bcjr, viterbi, dev, held):
    """Phase 14, the loaded subframe: PuschCell over the seven UEs of
    ul_cell at B=256 and 26 dB (4 distinct subframes tiled), every r2max
    launch at a shape phase 2 held (ul_cell_shapes). Returns the r2max
    launches of one decode and (IQ, the receiver) for phase 19."""
    from srsue_tpu_torch.phy import enb_tx, turbo

    tag = "phase 14: loaded subframe"
    cfg, cell_rx = ul_cell(dev)
    codecs = cell_rx.codecs
    rng = np.random.default_rng(141)
    held_n = {(b * (k // lw), lw) for k, lw, b in held}
    n_distinct = 4
    sent = [[(rng.integers(0, 2, c.grant.tbs).astype(np.uint8),
              rng.integers(0, 2, c.n_cqi_bits).astype(np.uint8) if c.n_cqi_bits else None,
              bool(rng.integers(2))) for c in codecs] for _ in range(n_distinct)]
    td = np.stack([sum(c.encode_sf_uci(pay, cqi_bits=cqi, ack=ack, cyclic_shift=cs)
                       for c, cs, (pay, cqi, ack) in zip(codecs, cell_rx.cyclic_shifts, sf))
                   for sf in sent])
    # every UE sends the same power per allocated subcarrier
    one = codecs[0].encode_sf_uci(*sent[0][0], cyclic_shift=cell_rx.cyclic_shifts[0])
    p_sig = float(np.mean(np.abs(one) ** 2)) * cell_rx.cell.nfft / codecs[0].m_sc
    rows = np.arange(BATCH) % n_distinct
    iq = torch.as_tensor(enb_tx.awgn(rng, td[rows], SNR_DB, signal_power=p_sig)[0],
                         device=dev)

    def run(x):
        out = cell_rx.decode(cell_rx.dematch(x))
        return out, cell_rx.decode_uci_sf()

    def shapes_held(what):
        got = set(bcjr.shapes["r2max"])
        bcjr.shapes["r2max"].clear()
        check(bool(got) and got <= held_n, f"{tag} {what}: r2max launched at (windows, lw) "
              f"{sorted(got - held_n)}, not held in phase 2")

    zero_all(bcjr, viterbi)
    run(iq)  # first call: cuFFT plans, the turbo loop's graphs
    torch.cuda.synchronize()
    shapes_held("first call")
    zero_all(bcjr, viterbi)
    turbo_calls = []
    decode = turbo.decode

    def counted(buf, k, *args, **kw):
        turbo_calls.append((k, buf.shape[0]))
        return decode(buf, k, *args, **kw)

    turbo.decode = counted
    try:
        out, uci = run(iq)
    finally:
        turbo.decode = decode
    torch.cuda.synchronize()
    counts = dict(bcjr.launches)
    demaps = note_demap(f"pusch cell B={BATCH}")
    check(demaps == sum(len(c.groups) for c in codecs),
          f"{tag}: {demaps} demap launches, one per UE's K-group expected")
    plan = [(k, BATCH * sum(count for _, _, count in m)) for k, _, m in cell_rx._k_plan]
    check(turbo_calls == plan and len(plan) == 4,
          f"{tag}: turbo.decode calls (K, blocks) {turbo_calls}, planned {plan}")
    want_r2 = 0
    for k, _, members in cell_rx._k_plan:
        want_r2 += 2 * max(int(out[u][2][..., first:first + count].max())
                           for u, first, count in members)
    check(counts == {n: want_r2 if n == "r2max" else 0 for n in counts}
          and viterbi.launches == 0, f"{tag}: launches {counts}, Viterbi {viterbi.launches}, "
          f"{want_r2} r2max expected from the K-groups' iterations")
    shapes_held(f"B={BATCH}")
    for u, (c, (pay, ok, iters), (cqi, ack)) in enumerate(zip(codecs, out, uci)):
        check(bool(ok.all()), f"{tag}: UE {u}: {int((~ok).sum())} TBs failed CRC")
        want_pay = np.stack([sent[r][u][0] for r in rows])
        check(bool((pay.cpu().numpy() == want_pay).all()), f"{tag}: UE {u}: payload differs")
        want_ack = np.array([sent[r][u][2] for r in rows])
        check(bool((ack.cpu().numpy() == want_ack).all()), f"{tag}: UE {u}: an ACK differs")
        if c.n_cqi_bits:
            want_cqi = np.stack([sent[r][u][1] for r in rows])
            check(bool((cqi.cpu().numpy() == want_cqi).all()), f"{tag}: UE {u}: a CQI differs")

    # card = CPU on 4 subframes: every decision
    _, cpu_rx = ul_cell("cpu")
    cpu_out = cpu_rx.decode(cpu_rx.dematch(iq[:4].cpu()))
    cpu_uci = cpu_rx.decode_uci_sf()
    for u, (card, cpu, cu, cc) in enumerate(zip(out, cpu_out, uci, cpu_uci)):
        for name, a, b in zip(("payload", "tb_ok", "iters", "cqi", "ack"),
                              (*card, *cu), (*cpu, *cc)):
            check((a is None) == (b is None) and (a is None or bool(
                (a[:4].cpu() == b).all())), f"{tag}: UE {u}: card and CPU {name} differ")
    t = cuda_ms(torch, lambda: run(iq), reps=5)
    shapes_held("timed")
    iters_all = torch.cat([o[2].reshape(-1) for o in out]).float()
    print(f"{tag}: {len(codecs)} UEs ({', '.join(f'{c.grant.n_prb} PRB qm {c.qm}' for c in codecs)}"
          f") at B={BATCH}, {SNR_DB} dB: every TB passes, bit-exact, CQI and ACK found; "
          f"{demaps} demap launches, turbo.decode at (K, blocks) {turbo_calls}, r2max x"
          f"{want_r2}, mean iters/block {float(iters_all.mean()):.3f}; card = CPU on 4 "
          f"subframes (payload, CRC, iterations, CQI, ACK); {t:.3f} ms/batch = "
          f"{BATCH * cfg['tbs'] / t / 1e3:.1f} Mbps decoded", flush=True)
    return want_r2, (iq, cell_rx)


# phase 15: the whole UE over the air, the port's Ue + Phy against its EnbPhy
OTA_PRB, OTA_CELL_ID = 100, 123
OTA_NOISE = 0.01  # complex AWGN amplitude of the OTA tests (test_harq_ota.py)
OTA_SEED = 0  # the noise draws of the attach; the UE and eNB identities' stream
OTA_MAX_TTI = 220
OTA_PKT_TTIS = 60
OTA_HARQ_TTIS = 120
# OFDM symbols erasable without touching control (0-1) or CRS (0, 4, 7, 11);
# on the uplink every SC-FDMA symbol but the two DMRS symbols (3, 10)
ERASABLE = (2, 3, 5, 6, 8, 9, 10, 12, 13)
UL_ERASABLE = (0, 1, 2, 4, 5, 6, 7, 8, 9, 11, 12, 13)


def ota_shapes(n_ports: int, cell_id: int = OTA_CELL_ID, crnti: int | None = None):
    """The shapes at which the OTA path launches the kernels, from the
    emulator's own grant profile (DL MCS 6 over its allocation buckets, UL 4
    PRB at MCS 4, CFI 2) and the UE's searches: ((label, K, lw, blocks) of
    every r2max decode, one TB per call, of each K-group; (label,
    candidates, n) of every blind search: the common space for SI-, RA- and
    P-RNTI at DCI 1A and 1C sizes, the C-RNTI's UE-specific space of each
    subframe at DCI 1A and 1 sizes; the C-RNTI is the emulator's unless
    `crnti` names another, as a handover's target gives). Phases 2 and 8
    hold the kernels against their twins at these shapes; phases 15 and 17
    check that they ran no other."""
    from srsue_tpu_torch.enb import phy as enb_phy
    from srsue_tpu_torch.enb.stack import EnbStack
    from srsue_tpu_torch.mac import pdu as pdu_mod
    from srsue_tpu_torch.phy import control, dci, ra, segmentation, turbo
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.usim.usim import UsimConfig

    cell = Cell(n_prb=OTA_PRB, cell_id=cell_id, n_ports=n_ports)
    enb = enb_phy.EnbPhy(cell, EnbStack(UsimConfig()), device="cpu")
    crnti = enb.crnti if crnti is None else crnti
    ul = dci.Dci0(riv=dci.riv_encode(cell.n_prb, 0, 4), mcs=enb._ul_mcs, ndi=True, tpc=1)
    rar = pdu_mod.RarGrant(False, dci.riv_encode(cell.n_prb, 0, 4), enb._ul_mcs, 0, False,
                           False)
    tbs = {f"DL {n} PRB MCS {enb._mcs_data}": ra.dl_grant(
        cell.n_prb, enb._mcs_data, n_prb_alloc=n).tbs for n in enb._alloc_buckets}
    tbs[f"UL 4 PRB MCS {enb._ul_mcs}"] = dci.dci0_to_grant(cell, ul).tbs
    tbs["Msg3"] = dci.rar_to_ul_grant(cell, rar).tbs
    r2 = {}
    for what, n in tbs.items():
        plan = segmentation.plan(n)
        for k in dict.fromkeys(plan.block_ks):
            lw = turbo.pick_window(k) or k
            r2.setdefault((k, lw, plan.block_ks.count(k)),
                          f"ue ota {what} (TBS {n}) K={k} lw={lw}")
    n_cce, _ = control.pdcch_geometry(cell, enb_phy.CFI)
    vit = {}
    sizes = {"1A": dci.size_0_1a(cell.n_prb), "1": dci.size_1(cell.n_prb),
             "1C": dci.size_1c(cell.n_prb)}
    for fmt in ("1A", "1C"):
        n_cand = len(control.search_space_candidates(n_cce, 0xFFFF, 0, False))
        vit.setdefault((n_cand, sizes[fmt] + 16), f"ue ota common space DCI {fmt}")
    for sf in range(10):
        n_cand = len(control.search_space_candidates(n_cce, crnti, sf, True))
        for fmt in ("1A", "1"):
            vit.setdefault((n_cand, sizes[fmt] + 16), f"ue ota C-RNTI space DCI {fmt}")
    return (tuple((label, *sh) for sh, label in r2.items()),
            tuple((label, *sh) for sh, label in vit.items()))


class _SeededUrandom:
    """Stands in for ``os`` in the UE's RRC and the eNB stack, whose only use
    of it is ``os.urandom`` (the UE identity, RAND, the GUTI): a seeded
    stream, so that two runs draw the same identities."""

    def __init__(self, seed: int):
        import random

        self._rng = random.Random(seed)

    def urandom(self, n: int) -> bytes:
        return bytes(self._rng.getrandbits(8) for _ in range(n))


class OtaLink:
    """The port's Ue + Phy and EnbPhy on one cell, stepped one TTI at a time
    over the air: the eNB's DL waveform (plus noise while attaching) into
    Phy.work, the UE's UL waveform into EnbPhy.receive_ul. Keeps the host
    wall ms of each call (synchronised when on the card)."""

    def __init__(self, torch, np, dev, n_ports: int, seed: int = OTA_SEED):
        from srsue_tpu_torch.enb.phy import EnbPhy
        from srsue_tpu_torch.enb.stack import EnbStack
        from srsue_tpu_torch.phy.cell import Cell
        from srsue_tpu_torch.phy.phy import Phy
        from srsue_tpu_torch.ue import Ue

        self.torch, self.np = torch, np
        self.sync = torch.device(dev).type == "cuda"
        self._ids = _SeededUrandom(seed)
        with self._seeded():
            self.cell = Cell(n_prb=OTA_PRB, cell_id=OTA_CELL_ID, n_ports=n_ports)
            self.phy = Phy(self.cell, device=dev)
            self.ue = Ue(phy=self.phy)
            self.phy.mac, self.phy.rrc = self.ue.mac, self.ue.rrc
            self.stack = EnbStack(self.ue.usim.cfg)
            self.enb = EnbPhy(self.cell, self.stack, device=dev)
        self.rng = np.random.default_rng(seed)
        self.tti = 0
        self.work_ms, self.ul_ms = [], []

    @contextlib.contextmanager
    def _seeded(self):
        """This link's identity stream in place of ``os`` in the RRC and the
        eNB stack while it runs."""
        from srsue_tpu_torch.enb import stack as stack_mod
        from srsue_tpu_torch.rrc import rrc as rrc_mod

        saved = rrc_mod.os, stack_mod.os
        rrc_mod.os = stack_mod.os = self._ids
        try:
            yield
        finally:
            rrc_mod.os, stack_mod.os = saved

    def _timed(self, fn, out: list):
        if self.sync:
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if self.sync:
            self.torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return r

    def step(self, noise: bool = False, dl_hook=None, ul_hook=None):
        np, tti = self.np, self.tti
        with self._seeded():
            dl = self.enb.build_dl_subframe(tti)
            if noise:
                dl = dl + OTA_NOISE * (self.rng.standard_normal(dl.shape) + 1j *
                                       self.rng.standard_normal(dl.shape)).astype(np.complex64)
            if dl_hook is not None:
                dl = dl_hook(tti, dl)
            ul = self._timed(lambda: self.phy.work(tti, dl), self.work_ms)
            self.ue.run_tti(tti)
            if ul_hook is not None:
                ul = ul_hook(tti, ul)
            self._timed(lambda: self.enb.receive_ul(tti, ul), self.ul_ms)
        self.tti += 1

    def attach(self) -> int:
        self.ue.attach()
        self.ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
        while self.tti < OTA_MAX_TTI:
            self.step(noise=True)
            if self.ue.is_attached and self.stack.state == "attached":
                return self.tti - 1
        raise RuntimeError(f"chip_smoke: phase 15: no attach in {OTA_MAX_TTI} TTIs on "
                           f"{self.cell}: rrc {self.ue.rrc.state}, events {self.enb.events[:30]}")

    def until(self, cond, n: int, **kw) -> bool:
        for _ in range(n):
            self.step(**kw)
            if cond():
                return True
        return False

    def packets(self, tag: str, n: int = OTA_PKT_TTIS):
        """One UL and one DL user packet, each delivered byte-exact within n
        TTIs."""
        pkt, dpkt = b"\x45\x00over-the-air!", b"\x45\x00downlink-data"
        n0 = len(self.stack.rx_packets)
        self.ue.gw.backend.inject_ul(pkt)
        self.until(lambda: len(self.stack.rx_packets) > n0, n)
        check(self.stack.rx_packets[n0:] == [pkt], f"{tag}: UL packet {self.stack.rx_packets}")
        m0 = len(self.ue.gw.backend.to_net)
        self.stack.send_user_packet(dpkt)
        self.until(lambda: len(self.ue.gw.backend.to_net) > m0, n)
        check(list(self.ue.gw.backend.to_net)[m0:] == [dpkt], f"{tag}: DL packet "
              f"{list(self.ue.gw.backend.to_net)}")
        return pkt, dpkt


def symbol_bounds(cell):
    """(start, end) sample of each OFDM symbol of a subframe."""
    out, pos = [], 0
    for s in range(cell.n_sym_sf):
        cp = cell.cp_lengths[0] if s % cell.n_sym_slot == 0 else cell.cp_lengths[1]
        out.append((pos, pos + cp + cell.nfft))
        pos += cp + cell.nfft
    return out


def erase_symbols(cell, wf, n_round, erasable=ERASABLE, n_erase=7, step=4):
    """Zero n_erase of the erasable symbols, the set rotating with the round:
    one transmission alone is undecodable, two combined are not."""
    out = wf.copy()
    bounds = symbol_bounds(cell)
    for i in range(n_erase):
        lo, hi = bounds[erasable[(step * n_round + i) % len(erasable)]]
        out[lo:hi] = 0
    return out


def spread(xs) -> str:
    s = sorted(xs)
    return f"least {s[0]:.3f}, median {s[len(s) // 2]:.3f}, largest {s[-1]:.3f}"


def phase_ota(torch, np, bcjr, viterbi, dev, held_r2, held_vit, smi):
    """Phase 15: the port's Ue + Phy attach to its EnbPhy over the air on a
    20 MHz cell and move a packet each way (a); DL and UL HARQ recover
    through combining (b); a 2-port cell attaches (c); the same attach on
    the CPU gives the same eNB events, attach TTI and bytes (d); readings
    (e). Every r2max and Viterbi launch must run at a shape that phases 2
    and 8 held against the twins. Returns the path's launches."""
    tag = "phase 15"
    held_n = {(b * (k // lw), lw) for k, lw, b in held_r2}
    zero_all(bcjr, viterbi)

    # (a) attach, then a packet each way
    t0 = time.perf_counter()
    link = OtaLink(torch, np, dev, n_ports=1)
    t_att = link.attach()
    attach_s = time.perf_counter() - t0
    check(link.ue.is_attached and link.stack.state == "attached", f"{tag}: not attached")
    check(link.ue.mac.crnti == link.enb.crnti and link.ue.gw.ip_addr == link.stack.ue_ip,
          f"{tag}: C-RNTI {link.ue.mac.crnti} / IP {link.ue.gw.ip_addr}")
    ladder = ("rar_sent", "msg3", "auth_ok", "nas_smc_ok")
    have = link.enb.events + link.stack.events
    check(any(e.startswith("prach_") for e in link.enb.events) and all(e in have for e in ladder),
          f"{tag}: the attach ladder is incomplete: {link.enb.events[:12]} {link.stack.events}")
    work_att, ul_att = list(link.work_ms), list(link.ul_ms)
    snap = link.phy.get_metrics()
    pkt, dpkt = link.packets(f"{tag} (a)")
    run_a = {"events": list(link.enb.events), "attach_tti": t_att,
             "ul": list(link.stack.rx_packets), "dl": list(link.ue.gw.backend.to_net)}
    print(f"{tag}: (a) 100 PRB 1-port cell {OTA_CELL_ID}, noise {OTA_NOISE}: attached at TTI "
          f"{t_att} (RACH -> RAR -> Msg3 -> Msg4 -> Milenage AKA -> security mode -> "
          f"reconfiguration with attach accept; stack events {link.stack.events}) in "
          f"{attach_s:.2f} s; UL packet {pkt!r} and DL packet {dpkt!r} delivered byte-exact",
          flush=True)

    # (b) HARQ: DL through a NACK and retransmissions, then UL through PHICH NACKs
    e0 = len(link.enb.events)
    link.stack.send_user_packet(b"\x45\x00harq-combining-payload")
    m0 = len(link.ue.gw.backend.to_net)
    rounds = [0]

    def dl_erase(tti, dl):
        if tti % 10 in (3, 7):  # the emulator's DL data subframes
            dl = erase_symbols(link.cell, dl, rounds[0])
            rounds[0] += 1
        return dl

    link.until(lambda: len(link.ue.gw.backend.to_net) > m0, OTA_HARQ_TTIS, dl_hook=dl_erase)
    ev = link.enb.events[e0:]
    retx = [e for e in ev if e.startswith("dl_retx_rv")]
    check("dl_nack" in ev and retx and "dl_ack" in ev and list(link.ue.gw.backend.to_net)[m0:]
          == [b"\x45\x00harq-combining-payload"], f"{tag}: DL HARQ events {ev}")
    e1 = len(link.enb.events)
    n0 = len(link.stack.rx_packets)
    retx0 = link.ue.mac.ul_harq.metrics["retx"]
    link.ue.gw.backend.inject_ul(b"\x45\x00uplink-harq-payload")
    rounds[0] = 0

    def ul_erase(tti, ul):
        if ul is not None and link.phy._phich_wait.get(tti + 4) == tti:  # a PUSCH
            ul = erase_symbols(link.cell, ul, rounds[0], UL_ERASABLE, n_erase=9, step=6)
            rounds[0] += 1
        return ul

    link.until(lambda: len(link.stack.rx_packets) > n0, OTA_HARQ_TTIS, ul_hook=ul_erase)
    ul_ev = link.enb.events[e1:]
    check(link.stack.rx_packets[n0:] == [b"\x45\x00uplink-harq-payload"]
          and any(e.startswith("ul_nack_rv0") for e in ul_ev)
          and any(e.startswith("ul_retx_ok_rv") for e in ul_ev)
          and link.ue.mac.ul_harq.metrics["retx"] > retx0, f"{tag}: UL HARQ events {ul_ev}")
    print(f"{tag}: (b) HARQ over the air: DL events {[e for e in ev if e.startswith('dl_')]}: "
          f"the packet recovered only by combining; UL events "
          f"{[e for e in ul_ev if e.startswith('ul_')]}: the packet received", flush=True)

    # (c) a 2-port cell (TM2: SFBC control region, Alamouti PDSCH)
    link2 = OtaLink(torch, np, dev, n_ports=2)
    t_att2 = link2.attach()
    link2.packets(f"{tag} (c)")
    print(f"{tag}: (c) 100 PRB 2-port cell: attached at TTI {t_att2}, a packet each way "
          f"byte-exact", flush=True)
    torch.cuda.synchronize()
    launches = {"r2max": bcjr.launches["r2max"], "viterbi": viterbi.launches,
                "demap": note_demap("ue_ota")}
    others = {k: v for k, v in bcjr.launches.items() if k != "r2max" and v}
    check(launches["r2max"] > 0 and launches["viterbi"] > 0 and not others,
          f"{tag}: launches {launches}, other BCJR instances {others}")
    got_r2, got_vit = set(bcjr.shapes["r2max"]), set(viterbi.shapes)
    check(got_r2 <= held_n, f"{tag}: r2max launched at (windows, lw) {sorted(got_r2 - held_n)}"
          f", not held in phase 2 ({sorted(held_n)})")
    check(got_vit <= set(held_vit), f"{tag}: Viterbi launched at (hypotheses, n) "
          f"{sorted(got_vit - set(held_vit))}, not held in phase 8 ({sorted(held_vit)})")

    # (d) the same attach on the CPU
    t0 = time.perf_counter()
    cpu = OtaLink(torch, np, "cpu", n_ports=1)
    t_cpu = cpu.attach()
    cpu.packets(f"{tag} (d)")
    run_d = {"events": list(cpu.enb.events), "attach_tti": t_cpu,
             "ul": list(cpu.stack.rx_packets), "dl": list(cpu.ue.gw.backend.to_net)}
    check(run_d == run_a, f"{tag}: the CPU run differs from the card's: {run_d} vs {run_a}")
    print(f"{tag}: (d) card = CPU at 100 PRB: the same {len(run_a['events'])} eNB events, "
          f"attach TTI {t_att} and delivered bytes ({time.perf_counter() - t0:.2f} s on the "
          f"CPU)", flush=True)

    # (e) readings
    print(f"{tag}: (e) {smi}: TTIs to attach {t_att} (1 port), {t_att2} (2 ports)", flush=True)
    print(f"{tag}: (e) {smi}: Phy.work host wall ms per TTI while attaching ({len(work_att)} "
          f"TTIs): {spread(work_att)}; over the whole 1-port run ({len(link.work_ms)} TTIs): "
          f"{spread(link.work_ms)}; 2 ports: {spread(link2.work_ms)} (a TTI lasts 1 ms)",
          flush=True)
    print(f"{tag}: (e) {smi}: EnbPhy.receive_ul host wall ms per TTI while attaching: "
          f"{spread(ul_att)}; whole 1-port run: {spread(link.ul_ms)}; 2 ports: "
          f"{spread(link2.ul_ms)}", flush=True)
    print(f"{tag}: (e) {smi}: launches on the path (a-c): r2max {launches['r2max']} at (windows,"
          f" lw) {sorted(got_r2)}, Viterbi {launches['viterbi']} at (hypotheses, n) "
          f"{sorted(got_vit)}", flush=True)
    print(f"{tag}: (e) {smi}: Phy.get_metrics() over the attach: SNR {snap.dl_snr_db:.2f} dB, "
          f"RSRP {snap.rsrp_dbm:.2f} dBm, pathloss {snap.pathloss_db:.2f} dB, CFO "
          f"{snap.cfo_hz:.2f} Hz, turbo iterations {snap.turbo_iters:.3f}, DL MCS "
          f"{snap.dl_mcs:.2f}, UL MCS {snap.ul_mcs:.2f}, PUSCH {snap.ul_power_dbm:.2f} dBm",
          flush=True)
    return launches


# phase 16: the sharded paths over torch.distributed, the BLER sweep, the
# profiler wrapper, the layer logger and the native IQ runtime
SHARD_TURBO_ITERS = 8
SHARD_K = 6144  # tests/test_distributed_dsp.py's block, B=256: W=96 windows of 64
SHARD_SIGMA = 10 ** (-1.0 / 20)
TIMESHARD_SF = 10  # subframes per rank of the 20 MHz stream
TIMESHARD_CFO = 0.11
BLER_SMALL_SNRS = (-4.0, 0.0, 4.0, 10.0)  # tests/test_bler.py's grid, 6 subframes a point
BLER_SMALL_SF = 6
BLER_FULL_SNRS = (17.0, 17.5, 18.0, 18.5, 19.0)  # MCS 28's waterfall, ~18 dB with ZF
BLER_FULL_SF = 64
# (world size, backend) of phase 16's sharded runs with no arguments: world 1
# over NCCL, then (e) two ranks on the one card over gloo (NCCL refuses two
# ranks on one GPU); `--world N` runs world N over NCCL on N cards instead
WORLDS = ((1, "nccl"), (2, "gloo"))


def decode_shapes(label, n_prb, mcs, batch):
    """(label, K, lw, blocks) of each K-group that turbo.decode runs for
    `batch` TBs of an n_prb, MCS `mcs` grant."""
    from srsue_tpu_torch.phy import ra, segmentation, turbo

    plan = segmentation.plan(ra.dl_grant(n_prb, mcs).tbs)
    return tuple((f"{label} K={k}", k, turbo.pick_window(k) or k,
                  plan.block_ks.count(k) * batch) for k in dict.fromkeys(plan.block_ks))


def shard_shapes(worlds):
    """(label, K, lw, blocks) of every r2max launch phase 16 makes on one
    rank: dryrun_multichip (per rank 6 PRB MCS 5 at B=2, K=128n in 2
    windows, one flagship carrier), shard_decode at the flagship (B/n per
    rank), the sharded turbo decoder at K=5824 (all 3,328 blocks: W=91
    splits over 1, 7, 13 or 91 ranks only) and K=6144 (W/n of 96 windows
    per rank), and the sweeps. Phase 2 holds r2max against its twin at
    these shapes."""
    out = (decode_shapes("dryrun 6 PRB MCS 5", 6, 5, 2)
           + (("dryrun sharded turbo K=128n, per rank", 128, 64, 1),)
           + decode_shapes("dryrun flagship carrier", 100, 28, 1)
           + decode_shapes("sweep 6 PRB MCS 5", 6, 5, BLER_SMALL_SF)
           + decode_shapes("sweep 100 PRB MCS 28", 100, 28, BLER_FULL_SF))
    for n, _ in worlds:
        out += (decode_shapes(f"shard_decode world {n}, per rank", 100, 28, BATCH // n)
                + ((f"sharded turbo K={SHARD_K} world {n}, per rank", SHARD_K, 64,
                    BATCH // n),))
    return out


def turbo_blocks(np, turbo, crcmod, k, b, seed):
    """b CRC24A blocks of K bits at tests/test_distributed_dsp.py's noise:
    (LLRs [b, 3, K+4] float32, CRC matrix [K, 24])."""
    rng = np.random.default_rng(seed)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    msgs = np.stack([crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
                     for _ in range(b)])
    x = 1.0 - 2.0 * np.stack([turbo.encode(msg) for msg in msgs]).astype(np.float32)
    x = x + rng.standard_normal(x.shape).astype(np.float32) * SHARD_SIGMA
    return (2 * x / SHARD_SIGMA ** 2).astype(np.float32), m


def tree_state(path) -> dict:
    """{name: (mtime_ns, size, sha256)} of every file under `path`."""
    import hashlib
    from pathlib import Path

    return {str(p.relative_to(path)): (p.stat().st_mtime_ns, p.stat().st_size,
                                       hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(Path(path).rglob("*")) if p.is_file()}


def phase_shard(torch, np, entry, bcjr, dev, held, worlds):
    """Phase 16 (a)-(e), at each (world size, backend) of `worlds`:
    dryrun_multichip(n) (NCCL worlds); then, in one launch of n rank
    processes, shard_decode, the sharded turbo decoder and the time-sharded
    front end, each against the port's unsharded path on this process's
    card. Every r2max launch ran at a shape phase 2 held (the ranks return
    their kernels' counters and shapes). Returns launches by path."""
    from srsue_tpu_torch.parallel import mesh, ranks
    from srsue_tpu_torch.phy import crc as crcmod
    from srsue_tpu_torch.phy import ofdm, sync, turbo
    from srsue_tpu_torch.phy.cell import Cell

    tag = "phase 16"
    held_n = {(b * (k // lw), lw) for k, lw, b in held}
    by_path = {}

    def ranks_ran(what, outs, want=None):
        """The ranks' r2max launches, all at shapes phase 2 held; r2max only."""
        n = [o["launches"]["r2max"] for o in outs]
        got = {tuple(s) for o in outs for s in o["shapes"]["r2max"]}
        others = {k: v for o in outs for k, v in o["launches"].items() if k != "r2max" and v}
        check(all(n) and not others, f"{tag}: {what}: launches {n}, other kernels {others}")
        check(got <= held_n, f"{tag}: {what}: r2max at (windows, lw) {sorted(got - held_n)}, "
              f"not held in phase 2")
        if want is not None:
            check(n == [want] * len(outs), f"{tag}: {what}: r2max launches {n}, want {want}")
        by_path[what] = sum(n)
        return n

    # the inputs and the port's unsharded results on the card
    cell, codec = entry.flagship(dev)
    noisy, payloads, _ = entry.make_waveforms(cell, codec, np.random.default_rng(16), BATCH,
                                              SNR_DB, n_distinct=4)
    iq = torch.as_tensor(noisy, device=dev)
    chain = entry.chain(cell, codec, entry.SUBFRAME)
    want = [x.cpu().numpy() for x in chain(iq)]
    chain_ms = host_ms(torch, lambda: chain(iq), reps=5)
    frontend, demap_dematch, _, _ = entry.stages(cell, codec, entry.SUBFRAME)
    groups = demap_dematch(*frontend(iq))
    k_flag = codec.block_ks[0]
    d6, crc6 = turbo_blocks(np, turbo, crcmod, SHARD_K, BATCH, seed=2)
    blocks = {"flagship": (groups[0].reshape(-1, 3, k_flag + 4), k_flag, codec.blk_crc[k_flag]),
              f"K={SHARD_K}": (torch.as_tensor(d6, device=dev), SHARD_K, crc6)}
    del groups
    unsharded, unsharded_ms = {}, {}
    for name, (d, k, m) in blocks.items():
        def dec(d=d, k=k, m=m):
            return turbo.decode(d, k, SHARD_TURBO_ITERS, m, early_exit=False, window=64)
        unsharded[name] = [x.cpu().numpy() for x in dec()]
        unsharded_ms[name] = host_ms(torch, dec, reps=3)
        check(unsharded[name][2].all(), f"{tag}: the unsharded {name} decode failed a CRC")
        blocks[name] = (d.cpu().numpy(), k, m)

    def frontend_want(n):
        """The unsharded front end of n ranks' blocks: CFO with the global
        index and demod; decimation by 16 to 6 PRB and demod."""
        x = torch.as_tensor(noisy[:n * TIMESHARD_SF].reshape(-1), device=dev)
        t = torch.arange(len(x), dtype=torch.float64, device=dev)
        rot = torch.polar(torch.ones_like(t), -2.0 * np.pi * TIMESHARD_CFO / cell.nfft * t)
        return {"cfo": ofdm.demodulate(cell, (x * rot.to(torch.complex64))
                                       .reshape(-1, cell.sf_len)).cpu().numpy(),
                "decim": ofdm.demodulate(Cell(n_prb=6, cell_id=cell.cell_id), sync.decimate(
                    x, 16).reshape(-1, 1920)).cpu().numpy()}

    def check_decode(what, outs):
        got = [np.concatenate([o[key] for o in outs]) for key in ("payload", "tb_ok", "iters")]
        check(all(o["n_ok"] == BATCH for o in outs), f"{tag}: {what}: n_ok "
              f"{[o['n_ok'] for o in outs]}, want {BATCH}")
        check(bool(got[1].all()) and (got[0] == payloads).all(),
              f"{tag}: {what}: a TB failed or a payload differs")
        for g, w, name in zip(got, want, ("payload", "tb_ok", "iters")):
            check(np.array_equal(g, w), f"{tag}: {what}: {name} differs from entry's chain")

    def check_turbo(what, outs, ref):
        got = (np.concatenate([o["hard"] for o in outs], 1), outs[0]["iters"], outs[0]["ok"])
        for o in outs:
            check(np.array_equal(o["iters"], got[1]) and np.array_equal(o["ok"], got[2]),
                  f"{tag}: {what}: iters or ok differ between ranks")
        for g, w, name in zip(got, ref, ("hard", "iters", "ok")):
            check(np.array_equal(g, w), f"{tag}: {what}: {name} differs from turbo.decode")

    for n, backend in worlds:
        torch.cuda.empty_cache()
        w = f"world {n}"
        step = {1: "(a)-(d)", 2: "(e)"}.get(n, f"--world {n}")
        if backend == "nccl":  # the dryrun, as a user calls it
            t0 = time.perf_counter()
            dry = entry.dryrun_multichip(n)
            r = ranks_ran(f"dryrun_multichip {w}", dry)
            print(f"{tag}: {step} dryrun_multichip({n}) over NCCL: {dry[0]['carriers']} "
                  f"carriers, n_ok {dry[0]['n_ok']}, the time shard, the window-sharded turbo "
                  f"and {n} flagship carrier(s) ok; r2max launches {r} at "
                  f"{sorted({tuple(x) for o in dry for x in o['shapes']['r2max']})}; "
                  f"{time.perf_counter() - t0:.2f} s (spawn, NCCL, host vectors)", flush=True)
        turbos = [name for name, (_, k, _) in blocks.items() if (k // 64) % n == 0]
        calls = [(ranks.decode, (cell, codec.grant, entry.RNTI, entry.SUBFRAME, 8, noisy),
                  {"reps": 5})]
        calls += [(ranks.turbo, (blocks[name][0], blocks[name][1], SHARD_TURBO_ITERS,
                                 blocks[name][2]), {"reps": 3}) for name in turbos]
        stream = noisy[:n * TIMESHARD_SF].reshape(-1)
        calls += [(ranks.frontend, (cell, stream, TIMESHARD_SF, 1, TIMESHARD_CFO), {"reps": 5}),
                  (ranks.frontend, (cell, stream, TIMESHARD_SF, 16, 0.0), {"reps": 5})]
        t0 = time.perf_counter()
        outs = mesh.launch(ranks.steps, n, "cuda", *calls, backend=backend)
        secs = time.perf_counter() - t0
        per = list(zip(*outs))  # per step, each rank's result
        dec_o = per[0]
        check_decode(f"shard_decode {w}", dec_o)
        r = ranks_ran(f"shard_decode {w}", dec_o)
        print(f"{tag}: {step} shard_decode {w} ({backend}), 100 PRB MCS 28, B={BATCH} at "
              f"{SNR_DB} dB: {BATCH}/{BATCH} TBs bit-exact, n_ok {dec_o[0]['n_ok']} "
              f"(all_reduce), SNR {dec_o[0]['snr']:.3f} dB; payload, tb_ok and iters = "
              f"entry's chain; {max(o['ms'] for o in dec_o):.3f} ms/batch against the "
              f"unsharded chain's {chain_ms:.3f} ms, both on the host's clock around "
              f"synchronised calls; r2max launches {r}", flush=True)
        for name, o in zip(turbos, per[1:1 + len(turbos)]):
            what = f"sharded turbo {name} {w}"
            check_turbo(what, o, unsharded[name])
            r = ranks_ran(what, o, want=2 * SHARD_TURBO_ITERS)
            print(f"{tag}: {step} {what} ({backend}): {len(o[0]['ok'])} blocks, W="
                  f"{blocks[name][1] // 64} ({blocks[name][1] // 64 // n} per rank), "
                  f"{SHARD_TURBO_ITERS} masked iterations: hard, iters, ok = turbo.decode("
                  f"early_exit=False, window=64) exactly; {max(x['ms'] for x in o):.3f} ms "
                  f"against {unsharded_ms[name]:.3f} ms unsharded, both on the host's clock; "
                  f"r2max launches {r}", flush=True)
        fe_want = frontend_want(n)
        for (what, key, n_prb), o in zip((("decim 1, CFO 0.11", "cfo", 100),
                                          ("decim 16 (100 -> 6 PRB)", "decim", 6)), per[-2:]):
            got = np.concatenate([x["grids"] for x in o])
            ref = fe_want[key]
            check({x["n_prb"] for x in o} == {n_prb} and got.shape == ref.shape,
                  f"{tag}: {what}: shape {got.shape}, PRB {[x['n_prb'] for x in o]}")
            err = float(np.abs(got - ref).max())
            check(err <= 1e-5 * float(np.abs(ref).max()) + 1e-5,
                  f"{tag}: sharded_frontend {w} {what}: max|diff| {err:.3g} against the "
                  f"unsharded front end")
            print(f"{tag}: {step} sharded_frontend {w} ({backend}), {TIMESHARD_SF} subframes of "
                  f"20 MHz per rank, {what}: max|diff| {err:.3g} against the unsharded front "
                  f"end; {max(x['ms'] for x in o):.3f} ms", flush=True)
        print(f"{tag}: {step} {w}: {len(calls)} paths in one launch of {n} rank process(es): "
              f"{secs:.2f} s with the spawn and the group's set-up", flush=True)
    return by_path


def phase_tools(torch, np, entry, bcjr, dev, held):
    """Phase 16 (f)-(h): the BLER sweep on the card (6 PRB = CPU; full width
    around MCS 28's waterfall), the profiler wrapper around one entry call,
    a LayerLog line, the native IQ runtime. Returns launches by path."""
    import contextlib
    import io
    import os
    import tempfile
    from pathlib import Path

    from srsue_tpu_torch.phy import bler
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.radio import FileRadio
    from srsue_tpu_torch.radio import native_io
    from srsue_tpu_torch.utils import logger, native, trace

    tag = "phase 16"
    held_n = {(b * (k // lw), lw) for k, lw, b in held}
    by_path = {}

    def sweep(what, cell, mcs, snrs, n_sf, device):
        zero_counts(bcjr)
        t0 = time.perf_counter()
        pts = bler.sweep_pdsch(cell, mcs, list(snrs), n_sf_per_point=n_sf, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if device != "cpu":
            got = set(bcjr.shapes["r2max"])
            check(bcjr.launches["r2max"] > 0, f"{tag}: {what}: r2max launches [0]")
            check(got <= held_n, f"{tag}: {what}: r2max at {sorted(got - held_n)}, not held "
                  f"in phase 2")
            by_path[what] = bcjr.launches["r2max"]
        return pts, secs

    # (f) the sweep: 6 PRB on the card and on the CPU, then full width
    small = Cell(n_prb=6, cell_id=3)
    card, secs = sweep("sweep_pdsch 6 PRB", small, 5, BLER_SMALL_SNRS, BLER_SMALL_SF, dev)
    cpu, _ = sweep("sweep_pdsch 6 PRB on the CPU", small, 5, BLER_SMALL_SNRS, BLER_SMALL_SF,
                   "cpu")
    borderline = 0
    for a, b in zip(card, cpu):
        if (a.bler, a.mean_iters) == (b.bler, b.mean_iters):
            continue
        borderline += 1  # one TB whose CRC outcome turns on a float32 margin
        check(abs(a.bler - b.bler) * BLER_SMALL_SF <= 1, f"{tag}: (f) {a.snr_db} dB: card "
              f"{a} against CPU {b}: more than one TB apart")
        print(f"{tag}: (f) borderline point: card {a}, CPU {b}", flush=True)
    check(borderline <= 1, f"{tag}: (f) {borderline} points differ between card and CPU")
    print(f"{tag}: (f) sweep_pdsch 6 PRB MCS 5, {BLER_SMALL_SF} subframes a point: card = CPU "
          f"on {len(card) - borderline}/{len(card)} points (bler, mean_iters): "
          + ", ".join(f"{p.snr_db:g} dB {p.bler:.3f}/{p.mean_iters:.3f}" for p in card)
          + f"; waterfall {bler.waterfall_snr(card)} dB (CPU {bler.waterfall_snr(cpu)}); "
          f"{secs:.2f} s", flush=True)
    full, secs = sweep("sweep_pdsch 100 PRB", Cell(n_prb=100, cell_id=entry.CELL_ID), 28,
                       BLER_FULL_SNRS, BLER_FULL_SF, dev)
    check(full[0].bler > full[-1].bler, f"{tag}: (f) no waterfall in {full}")
    print(f"{tag}: (f) sweep_pdsch 100 PRB MCS 28, {BLER_FULL_SF} subframes a point: "
          + ", ".join(f"{p.snr_db:g} dB BLER {p.bler:.4f} ({p.mean_iters:.3f} it)" for p in full)
          + f"; waterfall_snr {bler.waterfall_snr(full)} dB; {secs:.2f} s (host TX, noise, "
          f"card RX)", flush=True)

    # (g) one entry call under the profiler wrapper, with an annotate span
    fn, (iq,), payloads = entry.entry(dev, batch=8, snr_db=SNR_DB)
    fn(iq)
    torch.cuda.synchronize()
    logdir = Path("build") / "chip_smoke_trace"
    zero_counts(bcjr)
    with trace.ProfilerTrace(str(logdir)) as tr:
        with trace.annotate("chip_smoke.entry"):
            out = fn(iq)
            torch.cuda.synchronize()
    check(tr.errors == [], f"{tag}: (g) profiler errors {tr.errors}")
    check(bool(out[1].all()), f"{tag}: (g) a TB failed under the profiler")
    names = {e.get("name", "") for e in json.loads(Path(tr.path).read_text())["traceEvents"]}
    kern = sorted(n for n in names if "bcjr_half_kernel" in n)
    check(bool(kern) and "chip_smoke.entry" in names and Path(tr.path).parent == logdir,
          f"{tag}: (g) {tr.path} names no r2max kernel or no span")
    by_path["entry under the profiler"] = bcjr.launches["r2max"]
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        log = logger.get_logger("chip_smoke", level="info")
        logger.step_tti(4321)
        log.info("phase %d", 16)
    check("[ 4321] phase 16" in buf.getvalue(), f"{tag}: (g) LayerLog wrote {buf.getvalue()!r}")
    print(f"{tag}: (g) ProfilerTrace: {tr.path} ({Path(tr.path).stat().st_size} B) "
          f"names {kern} and the span chip_smoke.entry, errors {tr.errors}; "
          f"LayerLog: {buf.getvalue().strip()!r}", flush=True)

    # (h) the native IQ runtime: built into build/native/, native/ untouched
    before = tree_state("native")
    t0 = time.perf_counter()
    check(native_io.available(), f"{tag}: (h) native build failed: {native.build_error}")
    secs = time.perf_counter() - t0
    check(native.BUILD_DIR.resolve() == (Path("build") / "native").resolve(),
          f"{tag}: (h) built into {native.BUILD_DIR}")
    rng = np.random.default_rng(16)
    srate = Cell(n_prb=entry.N_PRB, cell_id=entry.CELL_ID).srate
    n_cap = 150_000
    data = (rng.standard_normal(n_cap) + 1j * rng.standard_normal(n_cap)).astype(np.complex64)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        path = os.path.join(tmp, "cap.iq")
        data.tofile(path)
        nat = native_io.NativeFileRadio(path, srate=srate, ring_samples=1 << 16,
                                        block=8192)
        ref = FileRadio(path, srate=srate)
        try:
            for n in (30_720, 30_720, 100_000):  # the last read runs past the end
                a, ta = nat.rx_now(n)
                b, tb = ref.rx_now(n)
                check(np.array_equal(a, b) and ta == tb, f"{tag}: (h) NativeFileRadio read "
                      f"differs from FileRadio")
            underflows = nat.underflows
            check(underflows >= 1, f"{tag}: (h) no underflow past the end")
            bursts = [np.full(100, v + 0j, np.complex64) for v in (1, 2, 3)]
            nat.tx_seq(1, bursts[1], tx_time=250 / nat.srate)
            held_back = nat.tx_committed
            nat.tx_seq(0, bursts[0], tx_time=100 / nat.srate)
            nat.tx_seq(2, bursts[2], tx_time=200 / nat.srate)
            stream, t0s = nat.tx_stream()
            check(held_back == 0 and nat.tx_committed == 3 and nat.tx_late == 1 and t0s == 100
                  and np.array_equal(stream[150:250], bursts[1]),
                  f"{tag}: (h) the txq did not commit in order")
        finally:
            nat.close()
    check(tree_state("native") == before, f"{tag}: (h) native/ changed")
    print(f"{tag}: (h) native: built {native._LIB_PATH} in {secs:.2f} s; NativeFileRadio = "
          f"FileRadio over a {n_cap}-sample capture and past its end, underflows "
          f"{underflows}; txq committed 3 in "
          f"order, 1 late; native/ unchanged", flush=True)
    return by_path


# phase 17: the UE's mobility and measurement loop over the air at 100 PRB:
# the A3-triggered handover, a page, periodic CQI / SRS / power control and
# the subband CQI labels, each on the card and on the CPU
MOB_SRC_PCI, MOB_NEW_PCI = OTA_CELL_ID, 77  # tests/test_ota_handover.py:20-23
MOB_NEW_CRNTI, MOB_DED_PREAMBLE = 0x5E11, 7
MOB_A3 = {"a3_offset_db": 3.0, "hysteresis_db": 1.0, "ttt": "ms40"}
MOB_GAINS = (0.1, 2.0)  # the neighbour's amplitude before and after the ramp
MOB_HO_TTIS = 600
# TTIs for each packet on the target: the emulator's DCI 1A carries TPC 0
# (-1 dB) on every DL assignment, as the reference's does (ROADMAP fault 6),
# so by then the UE's PUCCH ACKs fall under the eNB's threshold and a DL
# packet needs HARQ drops and RLC retransmissions to get through
MOB_PKT_TTIS = 240
MOB_PAGE_T_DRX = 32
MOB_CQI = (3, 5)  # cqi-pmi-ConfigIndex (period 5, offset 1), PUCCH resource
MOB_SRS = (11, 4)  # I_SRS (period 10, subframe 4), SRS bandwidth in PRB
MOB_PATHLOSS_DB = 6.0
MOB_CTRL_TTIS = 60  # per power phase (tests/test_ulctrl_ota.py)
MOB_SB_TTIS = 120  # tests/test_subband_cqi.py
MOB_TAPS = (1.0, 0.0, 0.85)  # the two-tap channel of tests/test_subband_cqi.py
MOB_CTRL_SEED = 9


def mobility_shapes():
    """phase 17's kernel shapes: phase 15's (the same emulator grant profile
    on every cell) and the Viterbi at the target's C-RNTI space on cell 77."""
    r2, vit = ota_shapes(1)
    r2t, vitt = ota_shapes(1, cell_id=MOB_NEW_PCI, crnti=MOB_NEW_CRNTI)
    return r2 + r2t, vit + tuple(sh for sh in vitt if sh[1:] not in {v[1:] for v in vit})


class MobilityLink(OtaLink):
    """An OtaLink on the source cell 123 with the neighbour cell 77 beside
    it: a broadcast-only EnbPhy with its own stack, added to the source's
    downlink at `gain`, until the handover starts; then the target EnbPhy on
    the source's stack (a second eNB on `dev`) serves the UE once it has
    retuned. Logs every eNB and stack event with its TTI, and every change
    of the UE's PCI and C-RNTI."""

    def __init__(self, torch, np, dev, seed: int = OTA_SEED, cqi_format_k=None):
        from srsue_tpu_torch.enb.phy import EnbPhy
        from srsue_tpu_torch.enb.stack import EnbStack

        super().__init__(torch, np, dev, n_ports=1, seed=seed)
        self.dev, self._enb_cls = dev, EnbPhy
        self.stack.cqi_format_k = cqi_format_k
        with self._seeded():
            self.cell2 = dataclasses.replace(self.cell, cell_id=MOB_NEW_PCI)
            self.neigh = EnbPhy(self.cell2, EnbStack(self.ue.usim.cfg), device=dev)
        self.source, self.target = self.enb, None
        self.gain = 0.0
        self.armed = []  # per TTI: whether the Phy measured a neighbour
        self.log = []  # (tti, source, event)
        self._seen, self._ue_ids = {}, None

    def _record(self, tti):
        for name, events in (("source", self.source.events), ("stack", self.stack.events),
                             ("target", self.target.events if self.target else [])):
            n = self._seen.get(name, 0)
            self.log += [(tti, name, e) for e in events[n:]]
            self._seen[name] = len(events)
        ids = (self.ue.rrc.pci, self.ue.mac.crnti)
        if ids != self._ue_ids:
            self.log.append((tti, "ue", ids))
            self._ue_ids = ids

    def step(self, noise: bool = True, dl_hook=None, ul_hook=None):
        tti = self.tti
        if self.target is None and "ho_initiated" in self.stack.events:
            with self._seeded():
                self.target = self._enb_cls(self.cell2, self.stack, device=self.dev)
        if self.target is not None and self.ue.rrc.pci == MOB_NEW_PCI:
            self.enb = self.target  # the UE has retuned: the target serves it

        def with_neighbour(t, dl):
            if self.gain and self.enb is not self.target:
                dl = dl + self.gain * self.neigh.build_dl_subframe(t)
            return dl if dl_hook is None else dl_hook(t, dl)

        self.armed.append(bool(getattr(self.phy, "_meas_pcis", ())))
        super().step(noise=noise, dl_hook=with_neighbour, ul_hook=ul_hook)
        self._record(tti)

    def first(self, event: str):
        return next((t for t, _, e in self.log if e == event), None)


def mobility_handover(torch, np, dev):
    """(a): attach on the source, arm A3, raise the neighbour from 0.1 to
    2.0, then the report, the command, the dedicated PRACH, the target's RAR,
    the Complete and a packet each way on the target. Returns the link."""
    tag = "phase 17 (a)"
    link = MobilityLink(torch, np, dev)
    link.attach()
    link.gain = MOB_GAINS[0]
    armed_at = link.tti
    link.stack.configure_measurements([MOB_NEW_PCI], ho_crnti=MOB_NEW_CRNTI,
                                      dedicated_preamble=MOB_DED_PREAMBLE, **MOB_A3)

    def done():
        if link.gain < MOB_GAINS[1] and link.ue.rrc.meas_ids:
            link.gain = MOB_GAINS[1]  # 6 dB over the serving cell
        return (link.enb is link.target and link.stack.state == "attached"
                and link.ue.mac.crnti == MOB_NEW_CRNTI)

    check(link.until(done, MOB_HO_TTIS, noise=True), f"{tag}: no handover in {MOB_HO_TTIS} "
          f"TTIs on {dev}: {link.log[-20:]}")
    link.armed_at = armed_at
    src, tgt = link.source.events, link.target.events
    check(f"a3_report_pci{MOB_NEW_PCI}" in link.stack.events and link.stack.meas_reports,
          f"{tag}: no MeasurementReport decoded: {link.stack.events}")
    check("ho_cmd_dl" in src, f"{tag}: the command did not cross the source: {src[-15:]}")
    check(f"prach_{MOB_DED_PREAMBLE}" in tgt and "rar_sent" in tgt and "msg3" not in tgt,
          f"{tag}: the target's RACH: {tgt[:15]}")
    check("ho_complete" in link.stack.events, f"{tag}: no Complete: {link.stack.events}")
    check(link.ue.rrc.pci == MOB_NEW_PCI and link.ue.mac.crnti == MOB_NEW_CRNTI
          and link.ue.rrc.state.name == "CONNECTED" and link.ue.is_attached,
          f"{tag}: UE on PCI {link.ue.rrc.pci}, C-RNTI {link.ue.mac.crnti:#x}, "
          f"{link.ue.rrc.state}")
    link.packets(tag, MOB_PKT_TTIS)
    return link


def mobility_page(torch, np, dev):
    """(b): the eNB pages the UE's IMSI; the Phy searches P-RNTI (DCI 1A and
    1C sizes) at the paging occasion only. Returns (the P-RNTI searches, the
    occasion, the eNB's events)."""
    from srsue_tpu_torch.mac.rnti import P_RNTI
    from srsue_tpu_torch.phy import dci
    from srsue_tpu_torch.phy.ue_dl import UeDl
    from srsue_tpu_torch.rrc.si_sched import paging_occasion

    link = OtaLink(torch, np, dev, n_ports=1, seed=1)
    imsi = link.ue.usim.get_imsi()
    ue_id = int(imsi) % 1024
    link.phy.configure_paging(ue_id, t_drx=MOB_PAGE_T_DRX, n_b_t=1.0)
    link.enb.page(imsi, t_drx=MOB_PAGE_T_DRX)
    occ = [t for t in range(MOB_PAGE_T_DRX * 10)
           if paging_occasion(t, ue_id, n_b_t=1.0, t_drx=MOB_PAGE_T_DRX)]
    check(len(occ) == 1, f"phase 17 (b): paging occasions {occ}")
    searches = []
    orig = UeDl.search

    def logged(ue_dl, *a, **kw):  # Phy.work searches one format a call
        hits = orig(ue_dl, *a, **kw)
        if a[4] == P_RNTI:
            searches.append((link.tti, dci.size(ue_dl.cell.n_prb, *a[6]),
                             [(int(s), int(lv)) for _, s, lv, _ in hits[0]]))
        return hits

    UeDl.search = logged
    try:
        link.tti = max(0, occ[0] - 2)
        link.until(lambda: link.tti > occ[0] + 1, 4, noise=True)
    finally:
        UeDl.search = orig
    check("paging_sent" in link.enb.events and link.ue.rrc.paged
          and link.ue.nas.paging_pending, f"phase 17 (b): not paged on {dev}: "
          f"{link.enb.events}")
    check({t for t, _, _ in searches} == {occ[0]}, f"phase 17 (b): P-RNTI searched at "
          f"{searches}, the occasion is TTI {occ[0]}")
    return searches, occ[0], list(link.enb.events)


def mobility_ul_ctrl(torch, np, dev):
    """(c) and (d) on one link (the ConnectionSetup carries subbandCQI(k=1)):
    (c) after the attach, CQI every 5 ms on PUCCH format 2 and SRS every 10
    ms at subframe 4 on both ends, 60 TTIs clear, then 60 TTIs 6 dB down
    both ways; (d) CQI with the subband format on a two-tap channel for 120
    TTIs. Returns the readings of both."""
    from srsue_tpu_torch.phy import ra, srs as srsmod, ue_ul_ctrl

    tag = "phase 17"
    link = MobilityLink(torch, np, dev, seed=MOB_CTRL_SEED, cqi_format_k=1)
    link.attach()
    phy, enb = link.phy, link.enb
    check(phy.ul_ctrl.cfg.cqi_subband_k == 1 and enb.cqi_cfg is not None
          and enb.cqi_cfg[2] == 1, f"{tag} (d): the subband format did not reach the UE: "
          f"{phy.ul_ctrl.cfg}, {enb.cqi_cfg}")
    phy.configure_cqi(*MOB_CQI)
    phy.configure_srs(*MOB_SRS)
    enb.cqi_cfg, enb.srs_cfg = (*MOB_CQI, None), MOB_SRS
    enb.cqi_reports.clear()
    g = 10 ** (-MOB_PATHLOSS_DB / 20)
    phr_before = phy.get_headroom_db()
    pusch_p = {"clear": [], "atten": []}
    for phase, atten in (("clear", 1.0), ("atten", g)):
        def ul_hook(tti, ul, _phase=phase, _atten=atten):
            if ul is not None and phy._phich_wait.get(tti + 4) == tti:
                pusch_p[_phase].append(float(np.mean(np.abs(ul) ** 2)))
            return None if ul is None else ul * _atten

        link.until(lambda: False, MOB_CTRL_TTIS, noise=False,
                   dl_hook=lambda t, dl, _atten=atten: dl * _atten, ul_hook=ul_hook)
    period, offset = ue_ul_ctrl.cqi_period_offset(MOB_CQI[0])
    reports = list(enb.cqi_reports)
    expect = ra.cqi_from_snr(phy.ul_ctrl.last_snr_db)
    check(len(reports) > 3 and phy.metrics["cqi_tx"] >= len(reports)
          and all(t % period == offset and abs(c - expect) <= 3 for t, c in reports),
          f"{tag} (c): CQI reports {reports} (expected about {expect} at TTIs {offset} mod "
          f"{period})")
    srs = list(enb.srs_detects)
    check(srs and phy.metrics["srs_tx"] >= 1 and all(
        srsmod.ue_srs_subframe(MOB_SRS[0], t) for t, _ in srs), f"{tag} (c): SRS {srs}")
    alpha = phy.ul_power.cfg.alpha
    drop = phr_before - phy.get_headroom_db()
    gain_db = (10 * np.log10(np.mean(pusch_p["atten"][-2:]) / np.mean(pusch_p["clear"][-2:]))
               if min(len(v) for v in pusch_p.values()) >= 2 else None)
    check(abs(phy.pathloss_db - MOB_PATHLOSS_DB) < 1.5
          and alpha * MOB_PATHLOSS_DB - 1.5 < drop < MOB_PATHLOSS_DB + 1.5
          and (gain_db is None or alpha * MOB_PATHLOSS_DB - 1.5 < gain_db
               < MOB_PATHLOSS_DB + 1.5), f"{tag} (c): pathloss {phy.pathloss_db:.2f} dB, "
          f"headroom drop {drop:.2f} dB, PUSCH power up {gain_db} dB (alpha {alpha})")
    ctrl = {"cqi": reports, "srs": srs, "pathloss_db": phy.pathloss_db, "phr_drop_db": drop,
            "pusch_gain_db": gain_db, "alpha": alpha}

    # (d) subband CQI on the two-tap channel
    phy.configure_cqi(*MOB_CQI, subband_k=1)
    enb.cqi_cfg = (*MOB_CQI, 1)
    enb.cqi_reports.clear()
    taps = np.asarray(MOB_TAPS, np.complex64)
    nfft, half = link.cell.nfft, link.cell.n_sc // 2
    gain_sc = np.abs(np.fft.fft(taps, nfft)[np.r_[nfft - half:nfft, 1:half + 1]]) ** 2
    k_sc = 12 * ue_ul_ctrl.subband_geometry(link.cell.n_prb)[0]
    n_sb = ue_ul_ctrl.subband_count(link.cell.n_prb)
    exp_sb = [float(gain_sc[s * k_sc:(s + 1) * k_sc].mean()) for s in range(n_sb)]
    exp_label = {}
    for j in range(ue_ul_ctrl.subband_geometry(link.cell.n_prb)[1]):
        lo, hi = ue_ul_ctrl.part_subbands(link.cell.n_prb, j)
        exp_label[j] = int(np.argmax(exp_sb[lo:hi]))
    link.until(lambda: False, MOB_SB_TTIS, noise=False, dl_hook=lambda t, dl: np.convolve(
        dl, taps)[:len(dl)].astype(np.complex64))
    sb = [r for r in enb.cqi_reports if len(r) == 5 and r[1] == "sb"]
    wb = [r for r in enb.cqi_reports if len(r) == 2]
    check(wb and {r[2] for r in sb} == set(exp_label), f"{tag} (d): reports "
          f"{enb.cqi_reports}")
    check(all(lab == exp_label[j] for _, _, j, lab, _ in sb), f"{tag} (d): labels "
          f"{[(r[2], r[3]) for r in sb]}, the channel's strong subbands {exp_label}")
    check(max(r[4] for r in sb) >= max(c for _, c in wb), f"{tag} (d): subband CQI "
          f"{[r[4] for r in sb]} under the wideband {[c for _, c in wb]}")
    sub = {"reports": list(enb.cqi_reports), "labels": exp_label,
           "snr_db": [float(v) for v in phy.ul_ctrl.subband_snr_db]}
    return ctrl, sub, link


def device_functions(torch, np, dev):
    """(e): the slice's new functions on tensors, on the card and on the
    CPU, at the full-width cell's shapes: the mapper and the hard demapper
    at every order, the OFDM modulator, the rate matcher's gather and the
    batched tail-biting encoder. Returns {name: max|card - CPU|}."""
    from srsue_tpu_torch.phy import convcode, modulation, ofdm, ratematch, turbo
    from srsue_tpu_torch.phy.cell import Cell

    cell = Cell(n_prb=OTA_PRB, cell_id=OTA_CELL_ID)
    rng = np.random.default_rng(17)
    out = {}
    for m in (1, 2, 4, 6):
        bits = torch.as_tensor(rng.integers(0, 2, (4, 1200 * m), dtype=np.uint8))
        sym_c = modulation.modulate(bits, m)
        check(torch.equal(modulation.modulate(bits.to(dev), m).cpu(), sym_c),
              f"phase 17 (e): modulate Qm={m} card != CPU")
        out[f"modulate Qm={m}"] = 0.0
        if m > 1:
            noisy = sym_c + 0.3 * torch.randn(sym_c.shape, dtype=torch.complex64)
            hard_d = modulation.demodulate_hard(noisy.to(dev), m).cpu()
            check(torch.equal(hard_d, modulation.demodulate_hard(noisy, m)),
                  f"phase 17 (e): demodulate_hard Qm={m} card != CPU")
            out[f"demodulate_hard Qm={m}"] = 0.0
    grid = torch.as_tensor((rng.standard_normal((2, cell.n_sym_sf, cell.n_sc)) + 1j *
                            rng.standard_normal((2, cell.n_sym_sf, cell.n_sc))).astype(
        np.complex64))
    td_d, td_c = ofdm.modulate(cell, grid.to(dev)).cpu(), ofdm.modulate(cell, grid)
    check(float((td_d - td_c).abs().max()) <= 1e-5 * float(td_c.abs().max()),
          "phase 17 (e): ofdm.modulate card != CPU within 1e-5 of the peak")
    out["ofdm.modulate (relative to the peak)"] = float(
        (td_d - td_c).abs().max() / td_c.abs().max())
    k = 5824
    d = torch.as_tensor(turbo.encode(rng.integers(0, 2, k).astype(np.uint8)).reshape(-1)
                        .astype(np.float32))
    idx = ratematch.turbo_rm_indices(k + 4, 3 * 5824 // 2, 2)
    check(torch.equal(ratematch.match(d.to(dev), idx).cpu(), ratematch.match(d, idx)),
          "phase 17 (e): ratematch.match card != CPU")
    out["ratematch.match"] = 0.0
    msgs = torch.as_tensor(rng.integers(0, 2, (4608, 44), dtype=np.uint8))
    check(torch.equal(convcode.encode_torch(msgs.to(dev)).cpu(), convcode.encode_torch(msgs)),
          "phase 17 (e): convcode.encode_torch card != CPU")
    out["convcode.encode_torch"] = 0.0
    return out


def phase_mobility(torch, np, bcjr, viterbi, dev, held_r2, held_vit, smi):
    """Phase 17: (a) the A3-triggered handover onto PCI 77 and a packet each
    way on the target; (b) a page at the paging occasion; (c) periodic CQI,
    SRS and the power tracking the pathloss; (d) the subband CQI labels on a
    two-tap channel; each on the card and again on the CPU, every decision
    equal; (e) the new device functions on the card = on the CPU. Every
    r2max and Viterbi launch at a shape phases 2 and 8 held. Returns the
    path's launches."""
    tag = "phase 17"
    held_n = {(b * (k // lw), lw) for k, lw, b in held_r2}
    zero_all(bcjr, viterbi)

    def shapes_held(what):
        got_r2, got_vit = set(bcjr.shapes["r2max"]), set(viterbi.shapes)
        check(got_r2 <= held_n, f"{tag} {what}: r2max at (windows, lw) "
              f"{sorted(got_r2 - held_n)}, not held in phase 2")
        check(got_vit <= set(held_vit), f"{tag} {what}: Viterbi at (hypotheses, n) "
              f"{sorted(got_vit - set(held_vit))}, not held in phase 8")
        return got_r2, got_vit

    t0 = time.perf_counter()
    ho = mobility_handover(torch, np, dev)
    ho_s = time.perf_counter() - t0
    page = mobility_page(torch, np, dev)
    ctrl, sub, ctrl_link = mobility_ul_ctrl(torch, np, dev)
    torch.cuda.synchronize()
    launches = {"r2max": bcjr.launches["r2max"], "viterbi": viterbi.launches,
                "demap": note_demap("ue_mobility")}
    others = {k: v for k, v in bcjr.launches.items() if k != "r2max" and v}
    check(launches["r2max"] > 0 and launches["viterbi"] > 0 and not others,
          f"{tag}: launches {launches}, other BCJR instances {others}")
    got_r2, got_vit = shapes_held("(a-d)")

    t0 = time.perf_counter()
    ho_cpu = mobility_handover(torch, np, "cpu")
    check(ho_cpu.log == ho.log, f"{tag} (a): the CPU's events differ from the card's: "
          f"{[e for e in ho_cpu.log if e not in ho.log][:8]} vs "
          f"{[e for e in ho.log if e not in ho_cpu.log][:8]}")
    page_cpu = mobility_page(torch, np, "cpu")
    check(page_cpu == page, f"{tag} (b): CPU {page_cpu} vs card {page}")
    ctrl_cpu, sub_cpu, _ = mobility_ul_ctrl(torch, np, "cpu")
    # the decisions exactly (CQI values, SRS detected at which TTIs); the SRS
    # correlation metric within float32 rounding
    check(ctrl_cpu["cqi"] == ctrl["cqi"], f"{tag} (c): CQI CPU {ctrl_cpu['cqi']} vs card "
          f"{ctrl['cqi']}")
    check([t for t, _ in ctrl_cpu["srs"]] == [t for t, _ in ctrl["srs"]] and np.allclose(
        [m for _, m in ctrl_cpu["srs"]], [m for _, m in ctrl["srs"]], atol=1e-5),
        f"{tag} (c): SRS CPU {ctrl_cpu['srs']} vs card {ctrl['srs']}")
    check(abs(ctrl_cpu["pathloss_db"] - ctrl["pathloss_db"]) < 1e-3,
          f"{tag} (c): pathloss CPU {ctrl_cpu['pathloss_db']} vs card {ctrl['pathloss_db']}")
    check(sub_cpu["reports"] == sub["reports"] and np.allclose(
        sub_cpu["snr_db"], sub["snr_db"], atol=1e-3), f"{tag} (d): CPU {sub_cpu} vs card {sub}")
    cpu_s = time.perf_counter() - t0
    new = device_functions(torch, np, dev)

    rep, comp = ho.first(f"a3_report_pci{MOB_NEW_PCI}"), ho.first("ho_complete")
    print(f"{tag}: (a) 100 PRB source cell {MOB_SRC_PCI} + neighbour {MOB_NEW_PCI}, noise "
          f"{OTA_NOISE}: attached, A3 armed at TTI {ho.armed_at} (offset 3 dB, hysteresis "
          f"1 dB, TTT ms40; the neighbour raised from {MOB_GAINS[0]} to {MOB_GAINS[1]}), the "
          f"MeasurementReport at TTI {rep} ({rep - ho.armed_at} TTIs after arming), the "
          f"command over the source's PDSCH, PRACH preamble {MOB_DED_PREAMBLE} detected by the "
          f"target, its RAR, the Complete at TTI {comp} ({comp - ho.armed_at} TTIs after "
          f"arming) on C-RNTI {MOB_NEW_CRNTI:#x}; a packet each way on the target; "
          f"{ho.tti} TTIs in {ho_s:.2f} s", flush=True)
    print(f"{tag}: (b) paged at the occasion TTI {page[1]} (T=32): P-RNTI searched "
          f"there only, (DCI bits, hits) {[s[1:] for s in page[0]]}; eNB events {page[2]}",
          flush=True)
    print(f"{tag}: (c) CQI {ctrl['cqi']}, SRS detected at TTIs "
          f"{[t for t, _ in ctrl['srs']]}; pathloss {ctrl['pathloss_db']:.3f} dB (6 dB "
          f"channel), headroom down {ctrl['phr_drop_db']:.3f} dB, PUSCH power up "
          f"{ctrl['pusch_gain_db']} dB (alpha {ctrl['alpha']})", flush=True)
    print(f"{tag}: (d) subband reports {sub['reports']}; labels {sub['labels']} = the "
          f"channel's strong subbands; subband SNR {[round(v, 3) for v in sub['snr_db']]} dB",
          flush=True)
    print(f"{tag}: (a-d) card = CPU: {len(ho.log)} handover events with their TTIs, PCIs "
          f"and C-RNTIs, the page, {len(ctrl['cqi'])} CQI and {len(ctrl['srs'])} SRS reports, "
          f"the pathloss, {len(sub['reports'])} subband reports ({cpu_s:.2f} s on the CPU)",
          flush=True)
    print(f"{tag}: (e) card = CPU: " + ", ".join(f"{k} {v:.3g}" for k, v in new.items()),
          flush=True)
    on = [ms for ms, a in zip(ho.work_ms, ho.armed) if a]
    off = [ms for ms, a in zip(ho.work_ms, ho.armed) if not a]
    print(f"{tag}: {smi}: Phy.work host wall ms per TTI with a neighbour armed ({len(on)} "
          f"TTIs): {spread(on)}; without ({len(off)} TTIs): {spread(off)}; subband CQI "
          f"link: {spread(ctrl_link.work_ms)}", flush=True)
    print(f"{tag}: {smi}: launches on the path (a-d): r2max {launches['r2max']} at (windows, "
          f"lw) {sorted(got_r2)}, Viterbi {launches['viterbi']} at (hypotheses, n) "
          f"{sorted(got_vit)}", flush=True)
    return launches


# phase 18: (a) ROADMAP fault 7, the repeats of a rate-matching position
# summed in one order on the card; (b) the multi-host launch
FAULT7_SEED = 18
MULTIHOST_TIMEOUT_S = 300.0  # a node's wait for its peer and each collective


def multihost_shapes(worlds):
    """(label, K, lw, blocks) of every r2max launch one rank of phase 18 (b)
    makes at each world size: the decode of 2 subframes of 6 PRB MCS 5 and
    the turbo decoder's K/world bits (4 codewords, windows of 64)."""
    from srsue_tpu_torch.parallel import multihost

    out = ()
    for n in worlds:
        out += (decode_shapes(f"multihost decode world {n}, per rank", 6, multihost.MCS, 2)
                + ((f"multihost turbo K={multihost.TURBO_K} world {n}, per rank",
                    multihost.TURBO_K // n, multihost.WINDOW, multihost.TURBO_CODEWORDS),))
    return out


def phase_fault7(torch, np, rx, bcjr, viterbi, dev, clean, noisy, blind):
    """Phase 18 (a): the softbuffers of every caller whose positions repeat 3
    times or more, card = CPU bit for bit from the same LLRs through the
    caller's own tables (the PDCCH blind search at 100 PRB with candidates
    at L=4 and L=8, a 2 PRB MCS 0 PDSCH grant, a 1 PRB MCS 0 PUSCH grant),
    with the count of positions where a zero-fill + index_add_ on the card
    (the scatter the gather replaced) differs; the flagship's dematch (one
    repeat) timed against that scatter; then phase 9's blind-chain runs
    again: the same decisions and launch counts. Returns launches by path."""
    from srsue_tpu_torch import entry
    from srsue_tpu_torch.phy import control, dci, ra, ratematch
    from srsue_tpu_torch.phy.cell import Cell, UlGrant
    from srsue_tpu_torch.phy.pdsch import PdschCodec
    from srsue_tpu_torch.phy.pusch import PuschCodec

    tag = "phase 18"
    cpu = torch.device("cpu")
    rng = np.random.default_rng(FAULT7_SEED)

    def bits(x):
        return x.cpu().contiguous().view(torch.int32)

    def forward(inv, e):
        """The index map [e] whose inverse is `inv`."""
        inv = inv.cpu().numpy()
        rows, cols = np.nonzero(inv < e)
        idx = np.empty(e, np.int64)
        idx[inv[rows, cols]] = rows
        return idx

    small = Cell(n_prb=6, cell_id=7)
    g = ra.dl_grant(6, 0, n_prb_alloc=1)
    ul = UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order,
                 tbs=g.tbs)
    n_1a = dci.size_0_1a(clean.cell.n_prb)

    def callers(d):
        """(what, E, the caller's inverse table, its fill: LLRs -> softbuffers) on d."""
        _, _, scr, inv_b, _, _ = control._blind_tables(clean.cell, clean.subframe, clean.cfi,
                                                       clean.rnti, n_1a, True, d)
        pd = PdschCodec(small, ra.dl_grant(6, 0, n_prb_alloc=2), 0x42, 1, device=d)
        pu = PuschCodec(small, ul, 0x42, 2, device=d)
        return (("PDCCH blind search, 100 PRB, DCI 1A, L=4 and 8", scr.shape[0], inv_b,
                 lambda x: [ratematch.dematch(x, inv_b)]),
                ("PDSCH 6 PRB cell, 2 PRB MCS 0", pd.G, pd.groups[0][5], pd.dematch),
                ("PUSCH 1 PRB MCS 0", pu.G, pu.groups[0][5],
                 lambda x: [ratematch.dematch(x, pu.groups[0][5])]))

    for (what, e, inv, fill), (_, _, inv_c, fill_c) in zip(callers(dev), callers(cpu)):
        llr = (rng.standard_normal((BATCH, e)) * 4).astype(np.float32)
        card = fill(torch.as_tensor(llr, device=dev))
        host = fill_c(torch.as_tensor(llr))
        torch.cuda.synchronize()
        n_diff = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(card, host))
        check(n_diff == 0, f"{tag}: (a) {what}: {n_diff} softbuffer values differ from the CPU")
        d_len = inv.shape[0]
        old = torch.zeros(BATCH, d_len, device=dev).index_add_(
            -1, torch.as_tensor(forward(inv, e), device=dev), torch.as_tensor(llr, device=dev))
        n_old = int((bits(old) != bits(ratematch.dematch(torch.as_tensor(llr), inv_c))).sum())
        print(f"{tag}: (a) {what}: B={BATCH}, E={e} into {d_len} positions, up to "
              f"{inv.shape[1]} repeats: card = CPU bit for bit; a zero-fill + index_add_ on "
              f"the card differs from the CPU at {n_old} of {BATCH * d_len} values", flush=True)

    _, codec = entry.flagship(dev)
    (k, _, count, lo, hi, inv), = codec.groups
    llr = torch.as_tensor((rng.standard_normal((BATCH, codec.G)) * 4).astype(np.float32),
                          device=dev)
    idx = torch.as_tensor(forward(inv, hi - lo), device=dev)
    d_len = count * 3 * (k + 4)
    gather = ratematch.dematch(llr, inv)
    scatter = torch.zeros(BATCH, d_len, device=dev).index_add_(-1, idx, llr)
    check(torch.equal(bits(gather), bits(scatter)), f"{tag}: (a) flagship: gather != scatter")
    t_gather = cuda_ms(torch, lambda: ratematch.dematch(llr, inv), reps=20)
    t_scatter = cuda_ms(torch, lambda: torch.zeros(BATCH, d_len, device=dev).index_add_(
        -1, idx, llr), reps=20)
    b = bound(4 * BATCH * (codec.G + d_len) + 8 * inv.numel(), 0)
    print(f"{tag}: (a) flagship dematch, B={BATCH}, E={codec.G} into {d_len}, 1 repeat: "
          f"the gather {t_gather:.4f} ms, the zero-fill + index_add_ it replaced "
          f"{t_scatter:.4f} ms (bound {b['bound_ms']:.4f} ms, bytes); equal bits", flush=True)
    del llr, idx, gather, scatter

    iq = torch.as_tensor(noisy, device=dev)
    args = (clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti, clean.dci_bits)
    by_path = {}
    for label, eq, kw in BLIND_RUNS:
        fn = rx.make_rx(*args, early_exit=True, eq=eq, device=dev, **kw)
        fn(iq)
        torch.cuda.synchronize()
        zero_all(bcjr, viterbi)
        stats = blind_stats(rx, fn(iq), clean)
        torch.cuda.synchronize()
        got = (stats, dict(bcjr.launches), viterbi.launches)
        note_demap(f"fault 7 blind chain {label}")
        check(got == blind[label], f"{tag}: (a) blind chain {label}: {got}, phase 9 "
              f"{blind[label]}")
        by_path[label] = got[1:]
        print(f"{tag}: (a) blind chain {label}, B={BATCH}: decisions ({int(stats['n_dci'])} "
              f"DCI, {int(stats['cfi_ok'])} CFI, {int(stats['n_ok'])} TBs, bit_match "
              f"{stats['bit_match']:.0f}, mean iters {stats['mean_iters']:.3f}) and launches "
              f"(BCJR {({n: c for n, c in got[1].items() if c})}, Viterbi {got[2]}) = phase "
              f"9's", flush=True)
    return by_path


def phase_multihost(torch, np, dev, held, n_nodes, local, backend, step):
    """Phase 18 (b): `n_nodes` node processes (``python -m
    srsue_tpu_torch.parallel.multihost``) of `local` ranks each over
    tcp://127.0.0.1 (NCCL: each node sees its own cards; gloo: every rank on
    this card). Both print MULTIHOST_OK; their decisions equal the unsharded
    decode and turbo decoder on the card and on the CPU; every r2max launch
    ran at a shape phase 2 held. Returns launches by path."""
    import os
    import socket
    import tempfile
    from pathlib import Path

    from srsue_tpu_torch.parallel import multihost
    from srsue_tpu_torch.phy import turbo
    from srsue_tpu_torch.phy.pdsch import PdschCodec, equalized

    tag = "phase 18"
    world = n_nodes * local
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(i) for i in range(torch.cuda.device_count())])
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="srsue_multihost_") as tmp:
        procs, res = [], []
        t0 = time.perf_counter()
        try:
            for node in range(n_nodes):
                env = dict(os.environ)
                if backend == "nccl":  # a host's own cards
                    env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[node * local:(node + 1) * local])
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "srsue_tpu_torch.parallel.multihost", str(node),
                     str(n_nodes), address, str(local), "--device", dev.type, "--backend",
                     backend, "--out", os.path.join(tmp, f"node{node}.npz"), "--timeout",
                     str(MULTIHOST_TIMEOUT_S)], cwd=root, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            res = [p.communicate(timeout=MULTIHOST_TIMEOUT_S + 120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        secs = time.perf_counter() - t0
        for node, (p, (out, err)) in enumerate(zip(procs, res)):
            check(p.returncode == 0 and "MULTIHOST_OK" in out,
                  f"{tag}: (b) node {node} exited {p.returncode}:\n{out[-2000:]}\n{err[-6000:]}")
            print(f"{tag}: (b) node {node}: {out.strip().splitlines()[-1]}", flush=True)
        nodes = [dict(np.load(os.path.join(tmp, f"node{i}.npz"))) for i in range(n_nodes)]

    got = {key: np.concatenate([n[key] for n in nodes], 1 if key == "turbo_hard" else 0)
           for key in ("payload", "tb_ok", "iters", "turbo_hard", "ranks", "r2max_launches",
                       "r2max_shapes")}
    check(np.array_equal(got["ranks"], np.arange(world)), f"{tag}: (b) ranks {got['ranks']}")
    for n in nodes:
        check(np.array_equal(n["turbo_iters"], nodes[0]["turbo_iters"])
              and np.array_equal(n["turbo_ok"], nodes[0]["turbo_ok"])
              and int(n["n_ok"]) == 2 * world, f"{tag}: (b) the nodes disagree")
    ins = multihost.inputs(world)
    for d in (dev, torch.device("cpu")):
        codec = PdschCodec(multihost.CELL, ins["grant"], multihost.RNTI, multihost.SUBFRAME,
                           cfi=1, n_turbo_iters=multihost.DECODE_ITERS, device=d)
        x_eq, nv_eff, _, _ = equalized(multihost.CELL, codec, codec.subframe,
                                       torch.as_tensor(ins["noisy"], device=d))
        payload, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
        hard, t_iters, t_ok = turbo.decode(torch.as_tensor(ins["llrs"], device=d),
                                           multihost.TURBO_K, multihost.TURBO_ITERS,
                                           ins["crc"], early_exit=False,
                                           window=multihost.WINDOW)
        for name, a, w in (("payload", got["payload"], payload), ("tb_ok", got["tb_ok"], tb_ok),
                           ("iters", got["iters"], iters),
                           ("turbo hard", got["turbo_hard"], hard),
                           ("turbo iters", nodes[0]["turbo_iters"], t_iters),
                           ("turbo ok", nodes[0]["turbo_ok"], t_ok)):
            check(np.array_equal(a, w.cpu().numpy()),
                  f"{tag}: (b) {name} differs from the unsharded path on {d}")
    held_n = {(b * (k // lw), lw) for k, lw, b in held}
    shapes = {tuple(int(v) for v in row[1:]) for row in got["r2max_shapes"]}
    launches = got["r2max_launches"].tolist()
    check(all(launches), f"{tag}: (b) r2max launches per rank {launches}")
    check(shapes <= held_n, f"{tag}: (b) r2max at (windows, lw) {sorted(shapes - held_n)}, "
          f"not held in phase 2")
    what = f"multihost {n_nodes} nodes x {local} {backend}"
    print(f"{tag}: (b) {step} {what} over {address}: {2 * world}/{2 * world} carriers "
          f"decoded, {multihost.TURBO_CODEWORDS} codewords of K={multihost.TURBO_K} CRC-ok "
          f"with no bit error; payload, tb_ok, iters and the turbo's hard bits, iters and ok = "
          f"the unsharded path on the card and on the CPU; launch {secs:.2f} s (the node "
          f"processes, spawn and group set-up included); r2max launches per rank {launches} "
          f"at (windows, lw) {sorted(shapes)}, each held in phase 2", flush=True)
    return {what: int(sum(launches))}


# phase 19: the demap kernel (csrc/demap.cu) against its plain version
DEMAP_SEED = 19
# float32 operations per bit of a row that the max-log demap needs: a
# subtract, a square and a minimum per level of the bit's axis, then the
# difference of the minima, the divide by the noise, the descramble and the
# add into the softbuffer (the LLR form: the first two of those four)
DEMAP_OPS_PER_LEVEL, DEMAP_OPS_PER_BIT, DEMAP_LLR_OPS_PER_BIT = 3, 4, 2
DEMAP_REPLACES = ("srsue_tpu/phy/modulation.py:109", "srsue_tpu/phy/ratematch.py:144")


def demap_bound(n, m, nv_elems, qm, e, d=0, r=0, mapped=False) -> dict:
    """The least time of one demap call on n rows: the m symbols each row
    needs (complex64) and nv_elems noise values read once, scr [e], the map
    [m] and inv [d, r] read once, the output written once (softbuffer
    [n, d], or the LLRs [n, m qm] when d = 0); each of the n e bits costs
    3 operations per level of its axis and 4 more (2 in the LLR form)."""
    out = 4 * n * (d if d else m * qm)
    nbytes = 8 * n * m + 4 * nv_elems + out + (4 * e + 4 * d * r + 4 * m * mapped if d else 0)
    per_bit = DEMAP_OPS_PER_LEVEL * (1 << (qm // 2)) + (
        DEMAP_OPS_PER_BIT if d else DEMAP_LLR_OPS_PER_BIT)
    return bound(nbytes, n * e * per_bit)


def demap_chunks(torch, inv, lo, n_e, qm, p) -> int:
    """The most chunks any tile of plan p stages: from the true range of the
    tile's inv entries up to the pad."""
    live = torch.cumprod(((inv >= 0) & (inv < n_e)).to(torch.int32), 1).bool()
    most = 1
    for t0 in range(0, inv.shape[0], p.tile):
        ent = inv[t0:t0 + p.tile][live[t0:t0 + p.tile]]
        if ent.numel():
            nsym = (lo + int(ent.max())) // qm - (lo + int(ent.min())) // qm + 1
            most = max(most, -(-nsym // (p.csize * p.bs)))
    return most


def tm2_symbols(torch, rx, clean, iq, dev):
    """The Alamouti-combined PDSCH symbols and noise of phase 13's subframes,
    as rx.make_tm2_rx computes them."""
    from srsue_tpu_torch.phy import chest, equalize, ofdm
    from srsue_tpu_torch.phy.pdsch import PdschCodec

    codec = PdschCodec(clean.cell, clean.grant, rnti=clean.rnti, subframe=clean.subframe,
                       cfi=rx.CFI, device=dev)
    grid = ofdm.demodulate(clean.cell, iq)
    h0, nvar, _ = chest.estimate(clean.cell, grid, clean.subframe, port=0)
    h1, _, _ = chest.estimate(clean.cell, grid, clean.subframe, port=1)
    return codec, equalize.alamouti_combine(codec.extract_re(grid), codec.extract_re(h0),
                                            codec.extract_re(h1), nvar)


def phase_demap(torch, np, entry, rx, bcjr, viterbi, dev, kept):
    """Phase 19: (a) the demap kernel against its plain version on the card at
    atol 0 (bit for bit), each compared call one launch, on every caller's
    shapes, a chunked range and a B=1 cluster among them; (b) every (form,
    qm, R) that phases 3-18 launched at was held in (a), and no path launched
    the gather variant; (c) the tiled kernel and the gather variant at the
    flagship, the uplink B=256 and the B=1 grant, in turns, by CUDA events
    and by device time against the plain composition, beside their bounds,
    the LLR form beside its own, and the stage and chains around them,
    kernel and plain in one call; (d) phase 3's chain, phase 9's blind run
    and phase 14's B=256 decode again with the same decisions, and the UCI
    decisions. Returns the kernels-line entries of the softbuffer form and
    of the LLR form."""
    from srsue_tpu_torch import bench_kernel_variants
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy import (chest, control, dci, equalize, modulation, ofdm, pusch, ra,
                                     ratematch)
    from srsue_tpu_torch.phy.cell import Cell, UlGrant
    from srsue_tpu_torch.phy.pdsch import PdschCodec
    from srsue_tpu_torch.phy.pusch import PuschCodec
    from srsue_tpu_torch.phy.ue_ul_ctrl import UlCtrl, UlCtrlConfig

    tag = "phase 19"
    rng = np.random.default_rng(DEMAP_SEED)
    prior = {sh[:3] for sh in demap.shapes}  # (form, qm, R) of phases 3-18
    rows, held, launched = [], set(), 0

    def case(label, sym, nv, qm, scr=None, inv=None, sym_map=None, lo=0, hi=None, ranges=None):
        """Kernel and plain version on the same inputs, bit for bit; the
        softbuffer form's plan and the chunks its tiles' true ranges need."""
        nonlocal launched
        before, before_llr = demap.launches, demap.llr_launches
        if inv is None:
            got = modulation.demodulate_soft(sym, qm, nv)
            ref = modulation.demodulate_soft_plain(sym, qm, nv)
            form, r, how = "llr", 0, ""
        else:
            got = ratematch.demap_dematch(sym, nv, qm, scr, inv, sym_map, lo, hi, ranges)
            hi = qm * (sym.shape[-1] if sym_map is None else sym_map.numel()) if hi is None else hi
            ref = ratematch.demap_dematch_plain(sym, nv, qm, scr, inv, sym_map, lo, hi)
            form, r = "softbuffer", inv.shape[1]
            d = inv.shape[0]
            p = demap.plan(got.numel() // got.shape[-1], d,
                           d if ranges is None else d // ranges.shape[0], hi - lo, qm)
            chunks = demap_chunks(torch, inv, lo, hi - lo, qm, p)
            how = (f"; tiles {p.tiles} x {p.tile}, cluster {p.csize}, {p.rows} row(s) of "
                   f"{p.bs} symbols and {p.smem} B a CTA, {p.threads} threads, "
                   f"{chunks} chunk(s)")
        torch.cuda.synchronize()
        check(demap.launches == before + 1 and demap.llr_launches == before_llr + (r == 0),
              f"{tag}: (a) {label}: {demap.launches - before} demap launches, expected 1")
        launched += 1
        n_diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        check(n_diff == 0, f"{tag}: (a) {label}: {n_diff} values differ from the plain version "
              f"(max |diff| {float((got - ref).abs().nan_to_num(0.0).max()):.3g})")
        err = 0.0  # bit for bit, NaNs included
        n = got.numel() // got.shape[-1]
        noise = ("scalar" if not isinstance(nv, torch.Tensor) else
                 "per row" if nv.shape[-1] == 1 or nv.stride(-1) == 0 else "per RE")
        rows.append({"case": label, "form": form, "qm": qm, "R": r, "N": n, "D": got.shape[-1],
                     "noise": noise, "max_abs_err": err})
        held.add((form, qm, r))
        print(f"{tag}: (a) {label}: {form} form, qm {qm}, R {r}, N {n}, width "
              f"{got.shape[-1]}, {noise} noise: kernel = plain bit for bit (atol 0){how}",
              flush=True)
        return (p, chunks) if r else None

    def noisy_syms(n, m, qm, sigma=0.2):
        bits = rng.integers(0, 2, (n, m * qm)).astype(np.uint8)
        x = modulation.modulate_np(bits, qm)
        x = x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        return torch.as_tensor(x.astype(np.complex64), device=dev)

    def per_re(n, m):
        return torch.as_tensor((0.005 + 0.05 * rng.random((n, m))).astype(np.float32),
                               device=dev)

    def pdsch_case(label, codec, x, nv):
        return [case(f"{label}, K={k} x {count}", x, nv, codec.qm, codec._scr, inv32, lo=lo,
                     hi=hi, ranges=ranges)
                for (k, first, count, lo, hi, _), inv32, ranges
                in zip(codec.groups, codec._inv32, codec._ranges)]

    # (a) the callers' shapes
    iq3, want3, iters3 = kept["entry"]
    cell, codec = entry.flagship(dev)
    front, dd, _, _ = entry.stages(cell, codec, entry.SUBFRAME)
    x3, nv3 = front(iq3)
    (_, _, _, lo0, hi0, _), = codec.groups
    inv0_32 = codec._inv32[0]
    ranges0 = codec._ranges[0]
    case(f"flagship PDSCH 64QAM B={BATCH} (entry's symbols)", x3, nv3, 6, codec._scr, inv0_32,
         lo=lo0, hi=hi0, ranges=ranges0)
    case(f"flagship PDSCH 64QAM B={BATCH}, LLR form", x3, nv3, 6)
    case(f"flagship PDSCH 64QAM B={BATCH}, scalar noise", x3, 0.01, 6, codec._scr, inv0_32, lo=lo0,
         hi=hi0, ranges=ranges0)
    p_over, chunks_over = case(
        f"flagship PDSCH 64QAM B={BATCH}, the whole row as one segment (a range over the "
        f"shared budget)", x3, nv3, 6, codec._scr, inv0_32, lo=lo0, hi=hi0)
    check(chunks_over > 1, f"{tag}: (a) the over-budget range was staged in {chunks_over} chunk")
    g16 = PdschCodec(Cell(n_prb=100, cell_id=rx.CELL_ID), ra.dl_grant(100, 16), rx.RNTI,
                     entry.SUBFRAME, device=dev)
    pdsch_case(f"PDSCH 100 PRB MCS 16 (16QAM) B={BATCH}, per-row noise", g16,
               noisy_syms(BATCH, g16.n_re, 4), per_re(BATCH, 1))
    tm2_clean, tm2_iq = kept["tm2"]
    tm2_codec, (x13, nv13) = tm2_symbols(torch, rx, tm2_clean, tm2_iq, dev)
    pdsch_case(f"TM2 flagship's combined symbols B={BATCH}", tm2_codec, x13, nv13)
    clean, noisy, blind = kept["blind"]
    iq9 = torch.as_tensor(noisy, device=dev)
    grid = ofdm.demodulate(clean.cell, iq9)
    h, nvar, _ = chest.estimate(clean.cell, grid, clean.subframe)
    g_eq, nv_grid = equalize.zf(grid, h, nvar)
    n_1a = dci.size_0_1a(clean.cell.n_prb)
    targs = (clean.cell, clean.subframe, clean.cfi, clean.rnti, n_1a, True, dev)
    _, _, scr_b, _, _, _ = control._blind_tables(*targs)
    res32, buf32, ranges_b = control._blind_tables32(*targs)
    y9, nv9 = control._flat_grid(g_eq, nv_grid)
    case("PDCCH blind search 100 PRB, DCI 1A, L=1-8 (phase 9's grid)", y9, nv9, 2, scr_b,
         buf32, sym_map=res32, ranges=ranges_b)
    case("PDCCH blind search 100 PRB, DCI 1A, L=1-8, B=1 (a UE's search)", y9[:1], nv9[:1], 2,
         scr_b, buf32, sym_map=res32, ranges=ranges_b)
    idx, _, _ = control._pcfich_tensors(clean.cell, clean.subframe, dev)
    y_p, nv_p = control._gather_re(g_eq, nv_grid, idx)
    case("PCFICH's 32 LLRs (phase 9's grid)", y_p, nv_p, 2)
    case("PBCH's 480 LLRs (240 symbols)", noisy_syms(1, 240, 2)[0], per_re(1, 240)[0], 2)
    small = Cell(n_prb=6, cell_id=7)
    g_small = ra.dl_grant(6, 0, n_prb_alloc=2)
    pd2 = PdschCodec(small, g_small, 0x42, 1, device=dev)
    pdsch_case("PDSCH 6 PRB cell, 2 PRB MCS 0", pd2, noisy_syms(BATCH, pd2.n_re, 2, 0.6),
               per_re(BATCH, pd2.n_re))
    ota = bench_kernel_variants.demap_case("OTA grant B=1", dev)
    p_ota, _ = case("PDSCH 100 PRB MCS 6, B=1 (the UE over the air's most frequent grant), "
                    "seeded symbols", **ota)
    check(p_ota.csize > 1, f"{tag}: (a) the B=1 grant's segments were not split over a cluster")
    g1 = ra.dl_grant(6, 0, n_prb_alloc=1)
    pu1 = PuschCodec(small, UlGrant(n_prb=1, prb_start=g1.prb_start, mcs=g1.mcs,
                                    mod_order=g1.mod_order, tbs=g1.tbs), 0x42, 2, device=dev)
    case("PUSCH 1 PRB MCS 0", noisy_syms(BATCH, pu1.n_re, 2, 0.6), per_re(BATCH, pu1.n_re), 2,
         pu1._scr_erase, pu1._inv32[0], sym_map=pu1._data_pos, lo=0, hi=pu1.G,
         ranges=pu1._ranges[0])
    iq14, want14, iters14 = kept["pusch"]
    cell_ul, grants = ul_grants(rx)
    pu = PuschCodec(cell_ul, grants["full"], rx.RNTI, rx.UL_SUBFRAME, device=dev)
    x14, nv14 = pu.equalize_sf(iq14)
    (_, _, _, lo14, hi14, _), = pu.groups
    case(f"PUSCH 100 PRB MCS 28 B={BATCH} (phase 14's symbols)", x14, nv14, 6, pu._scr_erase,
         pu._inv32[0], sym_map=pu._data_pos, lo=lo14, hi=hi14, ranges=pu._ranges[0])
    ctl = UlCtrl(UlCtrlConfig(cqi_config_index=2, n_prb=cell_ul.n_prb))
    for _ in range(30):
        ctl.update_snr(SNR_DB)
    cqi = ctl.cqi_for_tti(0)
    pay_u = rng.integers(0, 2, grants["bench"].tbs).astype(np.uint8)
    uci = {}
    for ack in (True, False):
        pu_u = PuschCodec(cell_ul, grants["bench"], rx.RNTI, rx.UL_SUBFRAME, n_cqi_bits=len(cqi),
                          with_ack=True, device=dev)
        wave = pu_u.encode_sf_uci(pay_u, cqi_bits=cqi, ack=ack)
        p_sig = float(np.mean(np.abs(wave) ** 2)) * cell_ul.nfft / pu_u.m_sc
        iq_u = torch.as_tensor(rx.add_noise(rng, wave[None], p_sig, SNR_DB), device=dev)
        xu, nvu = pu_u.equalize_sf(iq_u)
        for (k, _, count, lo, hi, _), inv32, ranges in zip(pu_u.groups, pu_u._inv32,
                                                            pu_u._ranges):
            case(f"PUSCH 50 PRB MCS 20, ACK={ack} + {len(cqi)} CQI bits (erasures), B=1, "
                 f"K={k} x {count}", xu, nvu, pu_u.qm, pu_u._scr_erase, inv32,
                 sym_map=pu_u._data_pos, lo=lo, hi=hi, ranges=ranges)
        case(f"PUSCH 50 PRB MCS 20 CQI symbols' LLRs, ACK={ack}", xu[:, pu_u._cqi_pos],
             nvu[:, pu_u._cqi_pos], pu_u.qm)
        pay, ok, _ = pu_u.decode_sf(iq_u)
        uci[ack] = pu_u.decode_uci()
        check(bool(ok.all()) and bool((pay == torch.as_tensor(pay_u, device=dev)).all())
              and uci[ack][1] is ack and bool((uci[ack][0] == cqi).all()),
              f"{tag}: (d) UCI ACK={ack}: found {uci[ack]}, CQI sent {cqi}")
        pc = PuschCodec(cell_ul, grants["bench"], rx.RNTI, rx.UL_SUBFRAME, n_cqi_bits=len(cqi),
                        with_ack=True, device="cpu")
        pc.dematch_sf(iq_u.cpu())
        u_cpu = pc.decode_uci()
        check(u_cpu[1] is uci[ack][1] and bool((u_cpu[0] == uci[ack][0]).all()),
              f"{tag}: (d) UCI ACK={ack}: card {uci[ack]}, CPU {u_cpu}")

    # phase 14's loaded subframe: each allocation size and modulation once
    iq_c, cell_rx = kept["pusch_cell"]
    eq_c = pusch._equalize(cell_rx.codecs, ofdm.demodulate(cell_rx.cell, iq_c), 1e-4,
                           cell_rx.cyclic_shifts)
    sizes = set()
    for c, (xc, nvc) in zip(cell_rx.codecs, eq_c):
        if (c.grant.n_prb, c.qm) in sizes:
            continue
        sizes.add((c.grant.n_prb, c.qm))
        what = (f"PUSCH {c.grant.n_prb} PRB {'QPSK' if c.qm == 2 else '16QAM'} of phase 14's "
                f"loaded subframe, B={BATCH}")
        for (k, _, count, lo, hi, _), inv32, ranges in zip(c.groups, c._inv32, c._ranges):
            case(f"{what}, K={k} x {count}", xc, nvc, c.qm, c._scr_erase, inv32,
                 sym_map=c._data_pos, lo=lo, hi=hi, ranges=ranges)
        if c.n_cqi_bits:
            case(f"{what}, CQI symbols' LLRs", xc[:, c._cqi_pos], nvc[:, c._cqi_pos], c.qm)
    check(sizes == {(4, 2), (6, 2), (15, 4), (25, 4)},
          f"{tag}: (a) the loaded subframe's allocations {sorted(sizes)}")

    # (a) special values: ties between levels, +-0, huge values, +-inf and NaN
    # among the symbols, tiny and NaN noise, 3 repeats with erasures
    x_sp, nv_sp, scr_sp, inv_sp = bench_kernel_variants.demap_special_case(6, 64, dev, DEMAP_SEED)
    case("seeded special values (ties, +-0, +-inf, NaN), 64QAM, 3 repeats", x_sp, nv_sp, 6,
         scr_sp, inv_sp)
    case("seeded special values, 64QAM, LLR form", x_sp, nv_sp, 6)

    # (a) the rest of what phases 3-18 launched at: a synthetic repeat table of
    # each (form, qm, R) no caller above held
    for form, qm, r in sorted(prior - held):
        m = 97
        x_s, nv_s = noisy_syms(64, m, qm, 0.4), per_re(64, m)
        if form == "llr":
            case(f"LLR form qm {qm}, seeded symbols", x_s, nv_s, qm)
            continue
        e = m * qm
        d = -(-e // r)  # the most repeated of d sent positions: r times
        idx_m = rng.permutation(np.tile(rng.permutation(d + 5)[:d], r)[:e])
        inv_s = torch.as_tensor(ratematch.inverse_index(idx_m, d + 5).astype(np.int32),
                                device=dev)
        scr_s = torch.as_tensor((1.0 - 2.0 * rng.integers(0, 2, e)).astype(np.float32),
                                device=dev)
        case(f"seeded repeat table, qm {qm}, R {r}", x_s, nv_s, qm, scr_s, inv_s)
    # (b)
    check(prior <= held, f"{tag}: (b) phases 3-18 launched at (form, qm, R) "
          f"{sorted(prior - held)}, not held in (a)")
    print(f"{tag}: (b) every launch of phases 3-18 ran at a (form, qm, R) held in (a): "
          f"{sorted(prior)}; {launched} compared calls, each one launch; no path launched the "
          f"gather variant ({len(DEMAP_BY_PATH)} paths read)", flush=True)

    # (c) times of the tiled kernel and the gather variant in turns (gather,
    # tiled, tiled, gather), by CUDA events (wrapper included) and device
    # time, beside the plain composition and the bound
    timed = {}
    for label, sym, nv in (("flagship PDSCH B=256", x3, nv3), ("uplink PUSCH B=256", x14, nv14),
                           ("OTA grant B=1", None, None)):
        c = bench_kernel_variants.demap_case(label, dev, sym, nv)
        fns = bench_kernel_variants.demap_variants(c)
        n, m = c["sym"].shape
        d, r = c["inv"].shape
        b = demap_bound(n, m, c["nv"].numel(), c["qm"], c["hi"] - c["lo"], d, r,
                        mapped=c["sym_map"] is not None)
        got = {}
        for kernel in ("demap_gather", "demap", "demap", "demap_gather"):
            got.setdefault(kernel, []).append(
                {"ms": cuda_ms(torch, fns[kernel], reps=20), **device_ms(fns[kernel], 20, kernel)})
        plain = {k: v for k, v in c.items() if k != "ranges"}
        plain_ms = cuda_ms(torch, lambda: ratematch.demap_dematch_plain(**plain), reps=3)
        timed[label] = {
            "ms": [g["ms"] for g in got["demap"]],
            "device_ms": [g["device_ms"] for g in got["demap"]],
            "device_ms_by": got["demap"][0]["device_ms_by"],
            "gather_ms": [g["ms"] for g in got["demap_gather"]],
            "gather_device_ms": [g["device_ms"] for g in got["demap_gather"]],
            "plain_ms": plain_ms, **b}
        t = timed[label]
        print(f"{tag}: (c) {label}: tiled kernel {t['ms'][0]:.4f} / {t['ms'][1]:.4f} ms (CUDA "
              f"events, wrapper included), device {t['device_ms'][0]:.4f} / "
              f"{t['device_ms'][1]:.4f} ms ({t['device_ms_by']}); gather variant "
              f"{t['gather_ms'][0]:.4f} / {t['gather_ms'][1]:.4f} ms, device "
              f"{t['gather_device_ms'][0]:.4f} / {t['gather_device_ms'][1]:.4f} ms; plain "
              f"composition {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
    llr_fn = (lambda: modulation.demodulate_soft(x3, 6, nv3))
    llr_t = {"ms": cuda_ms(torch, llr_fn, reps=20), **device_ms(llr_fn, 20, "demap_llr"),
             "plain_ms": cuda_ms(torch, lambda: modulation.demodulate_soft_plain(x3, 6, nv3),
                                 reps=3),
             **demap_bound(BATCH, codec.n_re, nv3.numel(), 6, 6 * codec.n_re)}
    print(f"{tag}: (c) LLR form, flagship B={BATCH} (64QAM, {codec.n_re} symbols a row): "
          f"{llr_t['ms']:.4f} ms, device {llr_t['device_ms']:.4f} ms ({llr_t['device_ms_by']}); "
          f"plain {llr_t['plain_ms']:.4f} ms; bound {llr_t['bound_ms']:.4f} ms "
          f"({llr_t['bound_by']})", flush=True)

    def dd_plain(x, nv):
        return codec.dematch(modulation.demodulate_soft_plain(x, 6, nv) * codec._scr)

    stage = {"kernel": cuda_ms(torch, lambda: dd(x3, nv3), reps=5),
             "plain": cuda_ms(torch, lambda: dd_plain(x3, nv3), reps=5)}
    stage["kernel again"] = cuda_ms(torch, lambda: dd(x3, nv3), reps=5)
    _, codec_f8 = entry.flagship(dev, forced=True)
    front8, dd8, turbo8, crc8 = entry.stages(cell, codec_f8, entry.SUBFRAME)

    def forced(demap_stage):
        def run():
            hard, blk_ok, _ = turbo8(demap_stage(*front8(iq3)))
            return crc8(hard, blk_ok)
        return run

    pay8, ok8 = forced(dd8)()
    check(bool(ok8.all()) and bool((pay8 == want3).all()), f"{tag}: (c) forced 8: not 256/256")
    chain = {"kernel": cuda_ms(torch, forced(dd8), reps=5),
             "plain": cuda_ms(torch, forced(dd_plain), reps=5)}
    chain["kernel again"] = cuda_ms(torch, forced(dd8), reps=5)
    mbps = {k: int(ok8.sum()) * codec.grant.tbs / v / 1e3 for k, v in chain.items()}
    print(f"{tag}: (c) phase 3's demap + dematch stage B={BATCH}: kernel {stage['kernel']:.3f} / "
          f"{stage['kernel again']:.3f} ms, the torch composition it replaced "
          f"{stage['plain']:.3f} ms; forced 8 chain: kernel {chain['kernel']:.3f} / "
          f"{chain['kernel again']:.3f} ms/batch = {mbps['kernel']:.1f} / "
          f"{mbps['kernel again']:.1f} Mbps, with the torch composition {chain['plain']:.3f} "
          f"ms/batch = {mbps['plain']:.1f} Mbps", flush=True)

    # (d) the same decisions as before
    fn3 = entry.chain(cell, codec, entry.SUBFRAME)
    zero_counts(bcjr)
    pay, ok, iters = fn3(iq3)
    torch.cuda.synchronize()
    check(bool(ok.all()) and bool((pay == want3).all()) and bool((iters == iters3).all()),
          f"{tag}: (d) entry early exit: decisions differ from phase 3's")
    note_demap("phase 19 entry early exit")
    fn9 = rx.make_rx(clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
                     clean.dci_bits, early_exit=True, eq="zf", device=dev)
    zero_all(bcjr, viterbi)
    stats = blind_stats(rx, fn9(iq9), clean)
    torch.cuda.synchronize()
    check(stats == blind["zf"][0], f"{tag}: (d) blind chain zf: {stats}, phase 9 "
          f"{blind['zf'][0]}")
    note_demap("phase 19 blind chain zf")
    pay, ok, iters = pu.decode_sf(iq14)
    torch.cuda.synchronize()
    check(bool(ok.all()) and bool((pay == want14).all()) and bool((iters == iters14).all()),
          f"{tag}: (d) uplink B={BATCH}: decisions differ from phase 14's")
    t_ul = [cuda_ms(torch, lambda: pu.decode_sf(iq14), reps=5) for _ in range(2)]
    print(f"{tag}: (d) again: entry early exit {BATCH}/{BATCH} TBs bit-exact, iterations = "
          f"phase 3's; blind chain zf {int(stats['n_dci'])} DCI, {int(stats['cfi_ok'])} CFI, "
          f"{int(stats['n_ok'])} TBs = phase 9's; uplink decode_sf {BATCH}/{BATCH} bit-exact, "
          f"iterations = phase 14's, {t_ul[0]:.3f} / {t_ul[1]:.3f} ms/batch; UCI ACK and NACK "
          f"with CQI {cqi.tolist()} found, card = CPU", flush=True)

    flag_t = timed["flagship PDSCH B=256"]
    keys = ("ms", "device_ms", "gather_ms", "gather_device_ms", "plain_ms", "bound_ms", "bound_by")
    softbuffer = {
        "name": "demap", "route": "cuda", "source": "srsue_tpu_torch/csrc/demap.cu",
        "replaces": " and ".join(DEMAP_REPLACES),
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["form"] == "softbuffer"),
        "ms": flag_t["ms"][0], "device_ms": flag_t["device_ms"][0],
        "device_ms_by": flag_t["device_ms_by"], "plain_ms": flag_t["plain_ms"],
        "bound_ms": flag_t["bound_ms"], "bound_by": flag_t["bound_by"],
        **{f"{label}": {k: t[k] for k in keys} for label, t in timed.items()},
        "over_budget_chunks": chunks_over, "stage_ms": stage, "forced8_ms": chain,
        "uplink_decode_ms": t_ul, "cases": len(rows)}
    llr = {"name": "demap_llr", "route": "cuda", "source": "srsue_tpu_torch/csrc/demap.cu",
           "replaces": DEMAP_REPLACES[0],
           "max_abs_err": max(r["max_abs_err"] for r in rows if r["form"] == "llr"),
           **{k: llr_t[k] for k in ("ms", "device_ms", "device_ms_by", "plain_ms", "bound_ms",
                                    "bound_by")}}
    return softbuffer, llr


def main_world(torch, np, entry, bcjr, dev, n: int, smi) -> int:
    """`--world N`: phase 2 at the sharded paths' shapes, then phase 16's
    sharded paths at world N over NCCL, one rank per card, and (N even)
    phase 18 (b) as two nodes of N/2 NCCL ranks, each node on its own cards."""
    check(torch.cuda.device_count() >= n, f"--world {n}: {torch.cuda.device_count()} cards")
    worlds = ((n, "nccl"),)
    shapes = tuple({sh[1:]: sh for sh in shard_shapes(worlds) + multihost_shapes(
        (n,) if n % 2 == 0 else ())}.values())
    phase_kernel(torch, bcjr, dev, shapes, base=())
    held = {sh[1:] for sh in shapes}
    launches = phase_shard(torch, np, entry, bcjr, dev, held, worlds)
    if n % 2 == 0:
        launches.update(phase_multihost(torch, np, dev, held, 2, n // 2, "nccl",
                                        f"--world {n}:"))
    print(json.dumps({"launches_by_path": launches}), flush=True)
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    world = 0
    if sys.argv[1:2] == ["--world"]:
        world = int(sys.argv[2])
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--world N]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from srsue_tpu_torch import bench_kernel_variants, entry, rx
    from srsue_tpu_torch.kernels import bcjr, build, demap, viterbi
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
    if world:
        return main_world(torch, np, entry, bcjr, dev, world, smi)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or line.startswith("=="):
            print(f"phase 1: ptxas {line.strip()}", flush=True)
    # resident warps per SM at the flagship shapes (3,328 blocks of K=5824; the
    # blind search's n=44), by the CUDA occupancy calculator
    warps = {name: build.warps_per_sm(name, 64) for name in build.HALF_KERNELS}
    warps["fused"] = build.warps_per_sm("fused", BATCH * 13, 5824, 64)
    warps["viterbi"] = build.warps_per_sm("viterbi", 44)
    # the demap kernel at the flagship: the softbuffer form at its plan, the LLR form
    p_fl = demap.plan(BATCH, 13 * 3 * (5824 + 4), 3 * (5824 + 4), 90000, 6)
    warps["demap"] = build.warps_per_sm("demap", 0, 6, p_fl.threads, p_fl.smem)
    warps["demap_llr"] = build.warps_per_sm("demap", 1, 6, 0, 0)
    warps["demap_gather"] = build.warps_per_sm("demap", 2, 6, 0, 0)
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
    extra += tuple(sh for sh in ul_shapes(rx) + ul_cell_shapes() if sh[1:] not in held)
    held |= {sh[1:] for sh in extra}
    ota = {p: ota_shapes(p) for p in (1, 2)}
    mob = mobility_shapes()
    for sh in ota[1][0] + ota[2][0] + mob[0] + shard_shapes(WORLDS) + multihost_shapes((2,)):
        if sh[1:] not in held:
            extra += (sh,)
            held.add(sh[1:])
    rows = phase_kernel(torch, bcjr, dev, extra)
    fn, iq, want, launches, iters = phase_chain(torch, entry, bcjr, dev)

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
    vit_cold = tuple(cold[p][1] for p in (1, 2))
    held_vit = {sh[1:] for sh in VITERBI_SHAPES + vit_cold}
    for sh in ota[1][1] + ota[2][1] + mob[1]:
        if sh[1:] not in held_vit:
            vit_cold += (sh,)
            held_vit.add(sh[1:])
    vit_row = phase_viterbi(torch, np, viterbi, convcode, dev, vit_cold)
    clean, noisy, blind = phase_blind_chain(torch, rx, ofdm, chest, dci, bcjr, viterbi, dev)
    vit_launches = blind["zf"][2]
    phase_ue_dl(torch, np, entry, UeDl, DlHarq, PdschCodec, enb_tx, bcjr, viterbi, dev,
                clean, noisy)
    del fn
    cold1 = phase_cold_start(torch, np, rx, bcjr, viterbi, dev, n_ports=1, phase=11,
                             shapes=cold[1])
    cold2 = phase_cold_start(torch, np, rx, bcjr, viterbi, dev, n_ports=2, phase=12,
                             shapes=cold[2])
    phase_silence(np, dev)
    tm2, tm2_kept = phase_tm2(torch, rx, bcjr, viterbi, dev, variant_ms["fused"])
    ul_launches, ul_kept = phase_uplink(torch, np, rx, bcjr, viterbi, dev, held)
    ulc_launches, ulc_kept = phase_uplink_cell(torch, np, bcjr, viterbi, dev, held)
    ota_launches = phase_ota(torch, np, bcjr, viterbi, dev, held, held_vit, smi[0])
    shard_launches = phase_shard(torch, np, entry, bcjr, dev, held, WORLDS)
    shard_launches.update(phase_tools(torch, np, entry, bcjr, dev, held))
    mob_launches = phase_mobility(torch, np, bcjr, viterbi, dev, held, held_vit, smi[0])
    f7 = phase_fault7(torch, np, rx, bcjr, viterbi, dev, clean, noisy, blind)
    mh_launches = phase_multihost(torch, np, dev, held, 2, 1, "gloo", "two nodes on one card:")
    demap_by_path = dict(DEMAP_BY_PATH)  # phases 3-18
    llr_by_path = {k: v for k, v in DEMAP_LLR_BY_PATH.items() if v}
    demap_row, llr_row = phase_demap(torch, np, entry, rx, bcjr, viterbi, dev, {
        "entry": (iq, want, iters), "tm2": tm2_kept, "blind": (clean, noisy, blind),
        "pusch": ul_kept, "pusch_cell": ulc_kept})
    del clean, noisy, iq, want, tm2_kept, ul_kept, ulc_kept

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
                             "pusch early exit": ul_launches,
                             "pusch cell early exit": ulc_launches,
                             "ue_ota": ota_launches["r2max"],
                             "ue_mobility": mob_launches["r2max"], **shard_launches,
                             **{f"fault 7 blind chain {k}": v[0]["r2max"]
                                for k, v in f7.items() if v[0]["r2max"]},
                             **mh_launches}}]
    for name, (source, replaces) in NEW_KERNELS.items():
        kernels.append({"name": f"bcjr_half_{name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": new_launches[name], **new[name],
                        "warps_per_sm": warps[name],
                        "launches_by_path": {"entry": new_launches[name], **(
                            {"tm2 forced": tm2["fused"],
                             "fault 7 blind chain zf forced": f7["zf forced"][0]["fused"]}
                            if name == "fused" else {})}})
    kernels.append({"name": "viterbi", "route": "cuda",
                    "source": "srsue_tpu_torch/csrc/viterbi.cu",
                    "replaces": "srsue_tpu/phy/convcode.py:85", "launches": vit_launches,
                    **vit_row, "warps_per_sm": warps["viterbi"],
                    "launches_by_path": {"blind chain": vit_launches,
                                         "cold start 1 port": cold1["viterbi"],
                                         "cold start 2 ports": cold2["viterbi"],
                                         "ue_ota": ota_launches["viterbi"],
                                         "ue_mobility": mob_launches["viterbi"],
                                         **{f"fault 7 blind chain {k}": v[1]
                                            for k, v in f7.items()}}})
    kernels.append({**demap_row, "launches": demap_by_path["entry early exit"],
                    "warps_per_sm": warps["demap"],
                    "launches_by_path": demap_by_path})
    kernels.append({**llr_row, "launches": llr_by_path["blind chain zf"],
                    "warps_per_sm": warps["demap_llr"], "launches_by_path": llr_by_path})
    for k in kernels:  # no single PyTorch call computes a max-log BCJR, a Viterbi or a demap
        k["library_ms"] = None
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
