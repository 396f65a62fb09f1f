"""Max-log soft demap + descramble + rate dematch: the launch of the Hopper
kernel ``csrc/demap.cu``. ``phy/ratematch.py::demap_dematch`` (the
softbuffer form) and ``phy/modulation.py::demodulate_soft`` (the LLR form)
check their device and call it for CUDA tensors;
``ratematch.demap_dematch_plain`` and ``modulation.demodulate_soft_plain``
are its plain PyTorch versions. ``launches`` counts the kernel's launches
in both forms, ``llr_launches`` those of the LLR form alone, and ``shapes``
holds the (form, qm, R, N, D) of each: form "softbuffer" or "llr", R the
inverse table's width (0 for the LLR form), N the rows and D the output
width; a CUDA graph's replay counts the launches its capture made
(``utils.graphs.count_launch``). ``plan`` sizes a softbuffer launch: its
tiles, clusters, shared memory and threads. ``demap_dematch_gather_cuda``
launches the softbuffer form's earlier design, one thread per output value
gathering through L2, kept for the benchmark alone (``gather_launches``);
no path calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..utils import graphs
from . import build

QMS = (2, 4, 6)
launches = 0
llr_launches = 0
gather_launches = 0
shapes: set = set()

# The launch plan of the softbuffer form (csrc/demap.cu's tile kernel).
H100_SMS = 132
TILE_BITS = 8192           # a tile joins whole segments up to about this many bits
STAGE_BYTES = 224 * 1024   # the most shared memory a CTA stages into (the H100 gives 227 KB)
SM_SHARED = 227 * 1024     # the shared memory of one SM, for the threads per CTA
MAX_CLUSTER = 8            # the portable cluster size
MIN_SHARE = 64             # symbols: a cluster grows while each CTA stages at least twice this
MAX_ROWS = 4               # rows a CTA stages and fills together (csrc/demap.cu kMaxRowsCta)
CTAS_PER_SM = 4            # rows join while the grid keeps at least this many CTAs per SM
WARPS_PER_SM = 32          # threads per CTA are sized to keep about this many warps resident


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the softbuffer form: tiles of `tile` consecutive
    positions, each staged by a cluster of `csize` CTAs of `threads` threads
    for `rows` rows at once, each CTA holding the t of `bs` symbols of a
    chunk in each row (bs = 1 << shift when csize > 1) in `smem` bytes of
    shared memory; a range of more than csize * bs symbols is staged in
    chunks."""

    tile: int
    tiles: int
    csize: int
    bs: int
    shift: int
    rows: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(n: int, d: int, seg: int | None, n_e: int, qm: int, n_sm: int = H100_SMS,
         stage_bytes: int = STAGE_BYTES) -> Plan:
    """The launch of the softbuffer form on n rows of d positions whose bits
    [lo, lo + n_e) fall into segments of `seg` positions (a code block's
    3(K+4), the blind search's candidate buffer; None: the whole row), each
    segment drawing on its own contiguous share of the bits. A tile is the
    most whole segments whose expected range stays near TILE_BITS; where n
    rows of tiles leave some of the n_sm SMs idle, each tile's range is
    split over a cluster of up to MAX_CLUSTER CTAs; where they leave many
    CTAs for each SM, a CTA takes up to MAX_ROWS rows of its tile, reading
    each inv entry and scrambling factor once for all of them. The range a
    tile is expected to draw on (its segments' share of n_e, plus two
    symbols where blocks differ) sizes the shared memory, at most
    stage_bytes a row; a tile whose range is larger is staged in chunks.
    The plan changes only the speed, never the bits."""
    if n < 1 or d < 1 or n_e < 0 or qm not in QMS:
        raise ValueError(f"demap plan: n={n}, d={d}, n_e={n_e}, qm={qm}")
    seg = d if seg is None else min(max(int(seg), 1), d)
    n_seg = -(-d // seg)
    per_seg = -(-n_e // n_seg)
    k = max(1, min(n_seg, TILE_BITS // max(per_seg, 1)))
    tile = k * seg
    tiles = -(-d // tile)
    symbols = -(-min(n_e, k * per_seg + 2 * qm) // qm) + 1  # +1: a range starting mid-symbol
    csize = 1
    while (csize < MAX_CLUSTER and n * tiles * csize < n_sm
           and symbols >= 2 * csize * MIN_SHARE):
        csize *= 2
    bs = -(-symbols // csize)
    most = stage_bytes // (4 * qm)
    if csize > 1:  # a power of two: the owner of a staged symbol is a shift away
        bs, most = 1 << (bs - 1).bit_length(), 1 << (most.bit_length() - 1)
    bs = min(bs, most)
    rows = 1
    while (rows < MAX_ROWS and -(-n // (2 * rows)) * tiles >= CTAS_PER_SM * n_sm
           and 2 * rows * 4 * qm * bs <= SM_SHARED // 2):
        rows *= 2
    smem = 4 * qm * bs * rows
    if csize > 1:  # a thread for each staged symbol or filled position, where that is fewer
        want = max(bs, -(-tile // csize))
    else:  # enough threads for WARPS_PER_SM warps beside the CTAs the shared memory admits
        want = -(-32 * WARPS_PER_SM // max(1, SM_SHARED // smem))
    threads = min(1024, max(256, 1 << (want - 1).bit_length()))
    return Plan(tile, tiles, csize, bs, bs.bit_length() - 1 if csize > 1 else 0, rows, threads,
                smem)


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(sym: torch.Tensor, qm: int, levels: torch.Tensor) -> None:
    if qm not in QMS:
        raise ValueError(f"demap kernel: qm={qm} outside {QMS}")
    if sym.dtype != torch.complex64:
        raise TypeError(f"demap kernel: symbols must be complex64, got {sym.dtype}")
    if sym.device.type != "cuda":
        raise ValueError(f"demap kernel: symbols on {sym.device}, not a CUDA device")
    if not sym.is_contiguous():
        raise ValueError("demap kernel: symbols must be contiguous")
    _same(levels, sym, torch.float32, "levels")
    if levels.shape != (1 << (qm // 2),):
        raise ValueError(f"demap kernel: {tuple(levels.shape)} levels for qm={qm}")


def _same(t: torch.Tensor, sym: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"demap kernel: {what} must be {dtype}, got {t.dtype}")
    if t.device != sym.device:
        raise ValueError(f"demap kernel: {what} on {t.device}, symbols on {sym.device}")
    if not t.is_contiguous():
        raise ValueError(f"demap kernel: {what} must be contiguous")


def _noise(nv, sym: torch.Tensor, n: int, s: int):
    """(pointer, row stride, symbol stride, value) of the noise: one value
    for a Python number; a float32 tensor on the symbols' device that
    broadcasts against them, by its strides over [N, S] (a broadcast axis
    has stride 0)."""
    if not isinstance(nv, torch.Tensor):
        return None, 0, 0, float(nv)
    if nv.dtype != torch.float32:
        raise TypeError(f"demap kernel: noise must be float32, got {nv.dtype}")
    if nv.device != sym.device:
        raise ValueError(f"demap kernel: noise on {nv.device}, symbols on {sym.device}")
    grid = nv.expand(sym.shape).reshape(n, s)  # a view unless the broadcast folds rows
    return grid, grid.stride(0), grid.stride(1), 0.0


def _tally(shape: tuple) -> None:
    """Count one launch at `shape` (form, qm, R, N, D)."""
    global launches, llr_launches
    launches += 1
    llr_launches += shape[0] == "llr"
    shapes.add(shape)


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"demap kernel launch failed: CUDA error {rc}")


def _stream(sym: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(sym.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _softbuffer(sym, qm, levels, scr, inv, sym_map, lo, hi):
    """Check the softbuffer form's inputs; (rows, symbols per row, D, R, the
    empty output)."""
    _check(sym, qm, levels)
    _same(scr, sym, torch.float32, "scr")
    _same(inv, sym, torch.int32, "inv")
    if inv.ndim != 2 or inv.shape[1] < 1:
        raise ValueError(f"demap kernel: inv must be [D, R >= 1], got {tuple(inv.shape)}")
    if not 0 <= lo <= hi <= scr.numel():
        raise ValueError(f"demap kernel: slice [{lo}, {hi}) outside scr [{scr.numel()}]")
    lead, s = sym.shape[:-1], sym.shape[-1]
    if sym_map is not None:
        _same(sym_map, sym, torch.int32, "sym_map")
        if sym_map.numel() * qm < hi:
            raise ValueError(f"demap kernel: a map of {sym_map.numel()} symbols for E={hi}")
    elif s * qm < hi:
        raise ValueError(f"demap kernel: {s} symbols for E={hi}")
    d, r = inv.shape
    out = torch.empty(lead + (d,), dtype=torch.float32, device=sym.device)
    return math.prod(lead), s, d, r, out


def demap_dematch_cuda(sym: torch.Tensor, nv, qm: int, levels: torch.Tensor,
                       scr: torch.Tensor, inv: torch.Tensor, sym_map: torch.Tensor | None,
                       lo: int, hi: int, ranges: torch.Tensor | None = None) -> torch.Tensor:
    """The softbuffer form: symbols [..., S] complex64 -> [..., D] float32,
    position p = 0.0 + llr(lo + inv[p, 0]) + ... up to the pad (hi - lo).
    scr [>= hi] float32, inv [D, R] int32 (rows ascending, as
    ``ratematch.inverse_index`` makes them), sym_map [>= ceil(hi / qm)] int32
    or None, levels [2^(qm/2)] float32, ranges [n_seg, 2] int32
    (``ratematch.segment_ranges`` of inv's rows in n_seg equal segments;
    None: the whole row as one segment), all contiguous on the symbols' CUDA
    device; nv a number or a float32 tensor that broadcasts against sym. One
    launch on the current stream, tiled by ``plan``; raises on any other
    input or CUDA error."""
    n, s, d, r, out = _softbuffer(sym, qm, levels, scr, inv, sym_map, lo, hi)
    if ranges is None:
        from ..phy.ratematch import segment_ranges  # imports this module

        ranges = segment_ranges(inv, 1, hi - lo)
    _same(ranges, sym, torch.int32, "ranges")
    if ranges.ndim != 2 or ranges.shape[1] != 2 or d % max(ranges.shape[0], 1):
        raise ValueError(f"demap kernel: ranges {tuple(ranges.shape)} for {d} positions")
    if n * d == 0:
        return out
    seg = d // ranges.shape[0]
    p = plan(n, d, seg, hi - lo, qm, _sms(sym.device.index or 0))
    grid, sn, ss, value = _noise(nv, sym, n, s)
    with torch.cuda.device(sym.device):
        _launch(build.load().lib.srsue_demap_dematch, _ptr(sym), s, _ptr(grid), sn, ss, value,
                _ptr(levels), qm, _ptr(scr), _ptr(sym_map), lo, hi - lo, _ptr(inv), r,
                _ptr(ranges), seg, d, n, _ptr(out), p.tile, p.csize, p.bs, p.shift, p.rows,
                p.threads, _stream(sym))
    graphs.count_launch(_tally, ("softbuffer", qm, r, n, d))
    return out


def demap_dematch_gather_cuda(sym: torch.Tensor, nv, qm: int, levels: torch.Tensor,
                              scr: torch.Tensor, inv: torch.Tensor,
                              sym_map: torch.Tensor | None, lo: int, hi: int) -> torch.Tensor:
    """The softbuffer form by its earlier design (one thread per output
    value, ``demap_dematch_gather_kernel``), for the benchmark: the same
    arguments and result as ``demap_dematch_cuda``. One launch, counted in
    ``gather_launches``."""
    global gather_launches
    n, s, d, r, out = _softbuffer(sym, qm, levels, scr, inv, sym_map, lo, hi)
    if n * d == 0:
        return out
    grid, sn, ss, value = _noise(nv, sym, n, s)
    with torch.cuda.device(sym.device):
        _launch(build.load().lib.srsue_demap_dematch_gather, _ptr(sym), s, _ptr(grid), sn, ss,
                value, _ptr(levels), qm, _ptr(scr), _ptr(sym_map), lo, hi - lo, _ptr(inv), r,
                d, n, _ptr(out), _stream(sym))
    gather_launches += 1
    return out


def demap_llr_cuda(sym: torch.Tensor, nv, qm: int, levels: torch.Tensor) -> torch.Tensor:
    """The LLR form: symbols [..., S] complex64 -> [..., S * qm] float32
    max-log LLRs in transmit bit order; the same arguments as
    ``demap_dematch_cuda``. One launch; raises on any other input or CUDA
    error."""
    _check(sym, qm, levels)
    lead, s = sym.shape[:-1], sym.shape[-1]
    n = math.prod(lead)
    out = torch.empty(lead + (s * qm,), dtype=torch.float32, device=sym.device)
    if n * s == 0:
        return out
    grid, sn, ss, value = _noise(nv, sym, n, s)
    with torch.cuda.device(sym.device):
        _launch(build.load().lib.srsue_demap_llr, _ptr(sym), s, _ptr(grid), sn, ss, value,
                _ptr(levels), qm, n, _ptr(out), _stream(sym))
    graphs.count_launch(_tally, ("llr", qm, 0, n, s * qm))
    return out
