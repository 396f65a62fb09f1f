"""Microbenchmark of the port's hand-written kernels on one CUDA GPU, the
counterpart of ``tools/bench_kernel_variants.py``.

    python -m srsue_tpu_torch.bench_kernel_variants [reps]

Times one half-iteration of every kernel instance at three window batches:
  * the reference tool's own: 256 x 13 blocks of K=6144 in 96 windows of 64;
  * the flagship: 3,328 blocks of K=5824 in 91 windows of 64;
  * the TPU's block-minor window for K=5824: 56 windows of 104
    (``turbo_pallas._bm_window``);
the circular Viterbi (``convcode.decode``) at the blind search's shape,
4,608 hypotheses of n=44, and the demap kernel's softbuffer form in both
designs (the tiled one every path launches, and the gather variant) at the
flagship PDSCH and the full-width PUSCH (B=256) and the UE's most frequent
grant (100 PRB MCS 6, B=1), on seeded symbols (``demap_case``;
``demap_special_case`` makes the special values the card tests and
chip_smoke hold the kernel to). The [n, lw] instances
(``kernels.bcjr.KERNELS``) take random LLRs and boundaries; the fused half
takes the [B, K] contract of the same windows with the QPP deinterleaver
of K. Each row has two times:
``ms``, the mean over `reps` back-to-back calls between CUDA events after a
warm-up (the wrapper's host work included where it is longer than the
kernel), and ``device_ms``, the kernel's own mean time by ``torch.profiler``
(or, where its traces hold no launch, by CUDA events behind a spin kernel:
``device_ms_by`` says which).
Prints them, each half instance's ratio to v2v3 (the reference's v2, the
tool's base), as the tool does, and its resident warps per SM by the CUDA
occupancy calculator.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .kernels import bcjr, build, demap
from .phy import convcode, modulation, ra, ratematch, turbo
from .utils.device import require_cuda

SHAPES = (  # (label, K, lw, blocks)
    ("tool K=6144 lw=64", 6144, 64, 256 * 13),
    ("flagship K=5824 lw=64", 5824, 64, 3328),
    ("TPU window K=5824 lw=104", 5824, 104, 3328),
)
VITERBI_SHAPE = ("blind search B=4608 n=44", 4608, 44)
# the name of each instance's __global__ function in csrc/, as the profiler shows it
KERNEL_NAMES = {"r2max": "bcjr_half_kernel", "v2v3": "bcjr_half_kernel",
                "v4": "bcjr_half_r4_kernel", "v5": "bcjr_half_r4_kernel",
                "fused": "bcjr_half_fused_kernel", "viterbi": "viterbi_kernel",
                "demap": "demap_dematch_tile_kernel",
                "demap_gather": "demap_dematch_gather_kernel", "demap_llr": "demap_llr_kernel"}
DEMAP_SHAPES = ("flagship PDSCH B=256", "uplink PUSCH B=256", "OTA grant B=1")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
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


PROFILE_PAD_S = 0.05  # idle host time at each end of a profiled window
PROFILE_TRIES = 3


def profiled_launches(fn, reps: int, name: str) -> tuple[int, float]:
    """(launches of the __global__ function `name` that torch.profiler's
    trace holds, their summed device ms) over `reps` calls of fn. The calls
    sit inside PROFILE_PAD_S of idle time at each end of the window, so a
    launch near an edge is not lost to a skew between the host's clock and
    the card's."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return sum(e.count for e in hits), sum(e.self_device_time_total for e in hits) / 1e3


def gated_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn with the host's gaps taken out: a spin
    kernel holds the stream while the host queues `reps` calls between two
    CUDA events, so the events time the calls' device work back to back.
    The spin doubles until the host has queued everything before the card
    reaches the first event."""
    cycles = 10_000_000
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
        cycles *= 2


def device_ms(fn, reps: int, kernel: str) -> tuple[float, str]:
    """(mean device ms of one launch of the kernel `kernel`, a key of
    KERNEL_NAMES; how it was timed) over `reps` calls of fn, one launch
    each, after a warm-up. torch.profiler first: the trace may miss a
    launch, so the mean is over the launches it holds, and a trace that
    holds none, or more than reps, is taken again up to PROFILE_TRIES
    times. Where no trace held them, gated_ms times the same calls (each
    wrapper launches its kernel and nothing else on the card)."""
    name = KERNEL_NAMES[kernel]
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        count, total_ms = profiled_launches(fn, reps, name)
        if 0 < count <= reps:
            return total_ms / count, "profiler"
    return gated_ms(fn, reps), f"events behind a spin kernel ({PROFILE_TRIES} traces held no launch)"


def viterbi_llrs(batch: int, n: int, device: torch.device) -> torch.Tensor:
    """Noisy codewords of random bits at 3 dB per coded bit, [batch, n, 3]."""
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (batch, n)).astype(np.uint8)
    x = 1.0 - 2.0 * np.swapaxes(convcode.encode(bits), -1, -2)
    var = 10.0 ** -0.3
    y = 2.0 * (x + np.sqrt(var) * rng.standard_normal(x.shape)) / var
    return torch.as_tensor(np.ascontiguousarray(y, dtype=np.float32), device=device)


def demap_case(label: str, device: torch.device, sym=None, nv=None) -> dict:
    """The softbuffer form's arguments at one of DEMAP_SHAPES: the caller's
    own tables (its first K-group) and, unless given, seeded noisy symbols
    with per-RE noise; {sym, nv, qm, scr, inv, sym_map, lo, hi, ranges}, the
    keywords of ``ratematch.demap_dematch``."""
    from . import entry, rx
    from .phy.cell import Cell
    from .phy.pdsch import PdschCodec
    from .phy.pusch import PuschCodec

    rows = 1 if label.endswith("B=1") else 256
    if label.startswith("flagship"):
        codec = entry.flagship(device)[1]
        scr, sym_map = codec._scr, None
    elif label.startswith("uplink"):
        codec = PuschCodec(Cell(n_prb=100, cell_id=rx.CELL_ID), rx.ul_grant(100, 28), rx.RNTI,
                           rx.UL_SUBFRAME, device=device)
        scr, sym_map = codec._scr_erase, codec._data_pos
    else:
        codec = PdschCodec(Cell(n_prb=100, cell_id=123), ra.dl_grant(100, 6), 0x46, 1,
                           device=device)
        scr, sym_map = codec._scr, None
    k, _, _, lo, hi, _ = codec.groups[0]
    if sym is None:
        rng = np.random.default_rng(rows + k)
        x = modulation.modulate_np(rng.integers(0, 2, (rows, codec.n_re * codec.qm)).astype(
            np.uint8), codec.qm)
        x = x + 0.1 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        sym = torch.as_tensor(x.astype(np.complex64), device=device)
        nv = torch.as_tensor((0.005 + 0.05 * rng.random(x.shape)).astype(np.float32),
                             device=device)
    return {"sym": sym, "nv": nv, "qm": codec.qm, "scr": scr, "inv": codec._inv32[0],
            "sym_map": sym_map, "lo": lo, "hi": hi, "ranges": codec._ranges[0]}


def demap_special_case(qm: int, rows: int, device, seed: int, s: int = 300):
    """(sym [rows, s], nv, scr, inv int32) on `device`: noisy symbols with
    ties between levels, zeros, huge values, infinities and NaNs, per-RE
    noise with tiny values and a NaN, a seeded table of up to 3 repeats,
    scrambling with erasures."""
    rng = np.random.default_rng(seed)
    x = modulation.modulate_np(rng.integers(0, 2, (rows, s * qm)).astype(np.uint8), qm)
    x = x + 0.6 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    flat = x.reshape(-1)
    vals = [0.0, 1e20, -1e20, np.inf, -np.inf, np.nan, 2 / np.sqrt(42), 1 / np.sqrt(10), -0.0,
            4 / np.sqrt(42)]
    for i, j in enumerate(rng.permutation(flat.size)[:4 * len(vals)]):
        flat[j] = complex(vals[i % len(vals)], vals[(i + 3) % len(vals)])
    nv = (0.01 + rng.random((rows, s))).astype(np.float32)
    nv[0, :7] = 1e-12
    nv[1, 3] = np.nan
    e, r = s * qm, 3
    d = -(-e // r) + 5
    idx = rng.permutation(np.tile(rng.permutation(d)[:-(-e // r)], r)[:e])
    scr = (1.0 - 2.0 * rng.integers(0, 2, e)).astype(np.float32)
    scr[rng.random(e) < 0.1] = 0.0
    inv = ratematch.inverse_index(idx, d).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (x.astype(np.complex64), nv, scr, inv))


def demap_variants(case: dict) -> dict:
    """{"demap": the tiled kernel's call, "demap_gather": the gather
    variant's} on one demap_case, each one launch."""
    lv = modulation.levels(case["qm"], case["sym"].device)
    args = (case["sym"], modulation.kernel_noise(case["nv"], case["sym"].device), case["qm"], lv,
            case["scr"], case["inv"], case["sym_map"], case["lo"], case["hi"])
    return {"demap": lambda: ratematch.demap_dematch(**case),
            "demap_gather": lambda: demap.demap_dematch_gather_cuda(*args)}


def run(device: torch.device, reps: int = 20) -> list[dict]:
    """One row {shape, kernel, windows, ms, device_ms, device_ms_by, warps}
    per shape and kernel instance, then the Viterbi's (windows:
    hypotheses)."""
    rows = []

    def row(label, kernel, windows, fn, warps):
        ms = cuda_ms(fn, reps)
        dev_ms, by = device_ms(fn, reps, kernel)
        rows.append({"shape": label, "kernel": kernel, "windows": windows, "ms": ms,
                     "device_ms": dev_ms, "device_ms_by": by, "warps": warps})

    for label, k, lw, blocks in SHAPES:
        g = torch.Generator(device=device).manual_seed(k + lw)

        def rnd(*shape, scale):
            return torch.randn(*shape, generator=g, device=device) * scale

        w = k // lw
        n = blocks * w
        lin, par = rnd(n, lw, scale=6.0), rnd(n, lw, scale=6.0)
        a0, b0 = rnd(n, 8, scale=5.0), rnd(n, 8, scale=5.0)
        for kernel in bcjr.KERNELS:
            row(label, kernel, n, lambda: bcjr.half_windowed(lin, par, a0, b0, kernel),
                build.warps_per_sm(kernel, lw))
        idx = turbo.qpp_tensors(k, device)[1].to(torch.int32)
        fused = (lin.reshape(blocks, k), par.reshape(blocks, k), rnd(blocks, k, scale=3.0), idx,
                 a0.reshape(blocks, w, 8), b0.reshape(blocks, w, 8), rnd(blocks, 8, scale=5.0), lw)
        row(label, "fused", n, lambda: bcjr.bcjr_half_fused(*fused),
            build.warps_per_sm("fused", blocks, k, lw))
    label, batch, n = VITERBI_SHAPE
    llr = viterbi_llrs(batch, n, device)
    row(label, "viterbi", batch, lambda: convcode.decode(llr), build.warps_per_sm("viterbi", n))
    for label in DEMAP_SHAPES:
        case = demap_case(label, device)
        n, d = case["sym"].shape[0], case["inv"].shape[0]
        p = demap.plan(n, d, d // case["ranges"].shape[0], case["hi"] - case["lo"], case["qm"])
        warps = {"demap": build.warps_per_sm("demap", 0, case["qm"], p.threads, p.smem),
                 "demap_gather": build.warps_per_sm("demap", 2, case["qm"], 0, 0)}
        for kernel, fn in demap_variants(case).items():
            row(label, kernel, n, fn, warps[kernel])
    return rows


def report(rows: list[dict]) -> list[str]:
    """Lines of ms per call and, for the halves, the ratio to v2v3 at the
    same shape."""
    base = {r["shape"]: r["ms"] for r in rows if r["kernel"] == "v2v3"}
    return [f"{r['shape']:26s} {r['kernel']:7s} {r['windows']:7d} windows: "
            f"{r['ms']:8.4f} ms, device {r['device_ms']:8.4f} ms"
            + (f", v2v3/this {base[r['shape']] / r['ms']:.3f}x" if r["shape"] in base else "")
            + f", {r['warps']} warps/SM"
            + ("" if r["device_ms_by"] == "profiler" else f"; device ms by {r['device_ms_by']}")
            for r in rows]


def main(reps: int = 20) -> None:
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    for line in report(run(dev, reps)):
        print(line)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
