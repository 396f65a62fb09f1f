"""Max-log soft demap + descramble + rate dematch: the launch of the Hopper
kernel ``csrc/demap.cu``. ``phy/ratematch.py::demap_dematch`` (the
softbuffer form) and ``phy/modulation.py::demodulate_soft`` (the LLR form)
check their device and call it for CUDA tensors;
``ratematch.demap_dematch_plain`` and ``modulation.demodulate_soft_plain``
are its plain PyTorch versions. ``launches`` counts the kernel's launches
and ``shapes`` holds the (form, qm, R, N, D) of each: form "softbuffer"
or "llr", R the inverse table's width (0 for the LLR form), N the rows and
D the output width.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

QMS = (2, 4, 6)
launches = 0
shapes: set = set()


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


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"demap kernel launch failed: CUDA error {rc}")


def _stream(sym: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(sym.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def demap_dematch_cuda(sym: torch.Tensor, nv, qm: int, levels: torch.Tensor,
                       scr: torch.Tensor, inv: torch.Tensor, sym_map: torch.Tensor | None,
                       lo: int, hi: int) -> torch.Tensor:
    """The softbuffer form: symbols [..., S] complex64 -> [..., D] float32,
    position p = 0.0 + llr(lo + inv[p, 0]) + ... up to the pad (hi - lo).
    scr [>= hi] float32, inv [D, R] int32, sym_map [>= ceil(hi / qm)] int32
    or None, levels [2^(qm/2)] float32, all contiguous on the symbols' CUDA
    device; nv a number or a float32 tensor that broadcasts against sym. One
    launch on the current stream; raises on any other input or CUDA error."""
    global launches
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
    n = math.prod(lead)
    d, r = inv.shape
    out = torch.empty(lead + (d,), dtype=torch.float32, device=sym.device)
    if n * d == 0:
        return out
    grid, sn, ss, value = _noise(nv, sym, n, s)
    with torch.cuda.device(sym.device):
        _launch(build.load().lib.srsue_demap_dematch, _ptr(sym), s, _ptr(grid), sn, ss, value,
                _ptr(levels), qm, _ptr(scr), _ptr(sym_map), lo, hi - lo, _ptr(inv), r, d, n,
                _ptr(out), _stream(sym))
    launches += 1
    shapes.add(("softbuffer", qm, r, n, d))
    return out


def demap_llr_cuda(sym: torch.Tensor, nv, qm: int, levels: torch.Tensor) -> torch.Tensor:
    """The LLR form: symbols [..., S] complex64 -> [..., S * qm] float32
    max-log LLRs in transmit bit order; the same arguments as
    ``demap_dematch_cuda``. One launch; raises on any other input or CUDA
    error."""
    global launches
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
    launches += 1
    shapes.add(("llr", qm, 0, n, s * qm))
    return out
