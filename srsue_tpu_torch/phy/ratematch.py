"""Turbo and convolutional rate matching / dematching (36.212 5.1.4.1,
5.1.4.2).

Counterpart of ``srsue_tpu/phy/ratematch.py``. The sub-block interleaver
and circular-buffer selection are host-precomputed index maps (numpy); on
the device, matching is one gather ``e[i] = d[idx[i]]``. Dematching sums
``w[idx[e]] += llr[e]`` (HARQ soft-combining is ``+`` of the buffers) as a
gather over the map's inverse (``inverse_index``): each position adds its
repeats in ascending e from 0.0, the order of the CPU's ``index_add_`` and
of the reference's scatter-add on XLA:CPU, on every device. NULL
(dummy/filler) positions never appear in an index map.

``demap_dematch`` is the receivers' whole step from equalized symbols to
softbuffers: max-log demap, descramble and dematch, one launch of the
kernel ``csrc/demap.cu`` on the card (``demap_dematch_plain`` is its plain
version).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import demap as demap_kernel
from . import modulation

C_SB = 32  # sub-block interleaver columns

# 36.212 Table 5.1.4-1 (turbo) inter-column permutation
PERM_TURBO = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)
# 36.212 Table 5.1.4-2 (convolutional) inter-column permutation
PERM_CONV = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64,
)

NULL = -1


def _subblock_rows(d: int) -> tuple[int, int]:
    r = -(-d // C_SB)
    return r, r * C_SB - d


def _interleave_idx(d: int, perm: np.ndarray) -> np.ndarray:
    """Indices into the original stream (length d) in interleaved order,
    NULL where the dummy padding sits (streams d0 and d1)."""
    r, nd = _subblock_rows(d)
    y = np.full(r * C_SB, NULL, dtype=np.int64)
    y[nd:] = np.arange(d)
    return y.reshape(r, C_SB)[:, perm].T.reshape(-1)


def _interleave_idx_d2(d: int) -> np.ndarray:
    """Stream d2: pi(k) = (P(floor(k/R)) + 32*(k mod R) + 1) mod Kp."""
    r, nd = _subblock_rows(d)
    kp = r * C_SB
    y = np.full(kp, NULL, dtype=np.int64)
    y[nd:] = np.arange(d)
    k = np.arange(kp)
    return y[(PERM_TURBO[k // r] + C_SB * (k % r) + 1) % kp]


@functools.lru_cache(maxsize=512)
def turbo_w_indices(k_stream: int, n_filler: int = 0) -> np.ndarray:
    """Circular buffer w[3*Kp] as indices into the concatenated d streams
    (stream j element i -> j*k_stream + i), NULL where dummy. Filler bits
    occupy d0[0:F] and d1[0:F] and are never transmitted."""
    base = _interleave_idx(k_stream, PERM_TURBO)
    filler = (base >= 0) & (base < n_filler)
    v0 = np.where(filler, NULL, base)
    v1 = np.where((base == NULL) | filler, NULL, base + k_stream)
    v2 = _interleave_idx_d2(k_stream)
    v2 = np.where(v2 == NULL, NULL, v2 + 2 * k_stream)
    kp = len(v0)
    w = np.empty(3 * kp, dtype=np.int64)
    w[:kp] = v0
    w[kp::2] = v1
    w[kp + 1::2] = v2
    return w


def turbo_k0(k_stream: int, rv: int, n_cb: int | None = None) -> int:
    r, _ = _subblock_rows(k_stream)
    ncb = 3 * r * C_SB if n_cb is None else n_cb
    return r * (2 * -(-ncb // (8 * r)) * rv + 2)


@functools.lru_cache(maxsize=4096)
def turbo_rm_indices(k_stream: int, e: int, rv: int, n_cb: int | None = None,
                     n_filler: int = 0) -> np.ndarray:
    """out[e] = d_flat[idx[e]] over the [3*k_stream] streams: the walk of
    the circular buffer from k0, skipping NULLs, repeating when E exceeds
    the buffer."""
    w = turbo_w_indices(k_stream, n_filler)
    ncb = len(w) if n_cb is None else n_cb
    w = w[:ncb]
    k0 = turbo_k0(k_stream, rv, None if n_cb is None else ncb)
    rolled = np.roll(w, -(k0 % len(w)))
    vals = rolled[rolled != NULL]
    return np.tile(vals, -(-e // len(vals)))[:e]


@functools.lru_cache(maxsize=512)
def conv_rm_indices(k_stream: int, e: int) -> np.ndarray:
    """Convolutional rate matching (PDCCH, PBCH): the three streams, each
    sub-block interleaved with PERM_CONV, read from k0 = 0 skipping NULLs
    and repeated when E exceeds the 3*k_stream coded bits (then dematch
    sums the repeats)."""
    base = _interleave_idx(k_stream, PERM_CONV)
    w = np.concatenate([np.where(base == NULL, NULL, base + j * k_stream)
                        for j in range(3)])
    vals = w[w != NULL]
    return np.tile(vals, -(-e // len(vals)))[:e]


def match(d_flat: torch.Tensor, idx: np.ndarray | torch.Tensor) -> torch.Tensor:
    """[..., 3*k_stream] -> [..., E]: the transmit side's gather by a host
    index table (``turbo_rm_indices``, ``conv_rm_indices``), on the
    tensor's device."""
    return d_flat[..., torch.as_tensor(idx, dtype=torch.int64, device=d_flat.device)]


def inverse_index(idx: np.ndarray, d_len: int) -> np.ndarray:
    """The inverse of an index map ``idx`` [E] into [d_len] positions, for
    ``dematch``: [d_len, R] int64, R the most repeats of any position, row p
    the e with ``idx[e] == p`` in ascending order, padded with E (the
    appended zero column of ``dematch``)."""
    idx = np.asarray(idx, np.int64)
    if idx.size and not 0 <= int(idx.min()) <= int(idx.max()) < d_len:
        raise ValueError(f"index map outside [0, {d_len})")
    counts = np.bincount(idx, minlength=d_len)
    order = np.argsort(idx, kind="stable")  # ascending e within each position
    rank = np.arange(len(idx)) - (np.cumsum(counts) - counts)[idx[order]]
    table = np.full((d_len, max(int(counts.max(initial=0)), 1)), len(idx), np.int64)
    table[idx[order], rank] = order
    return table


def dematch(llrs: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """[..., E] LLRs -> [..., d_len] softbuffer through the inverse map
    ``inv`` [d_len, R] (``inverse_index``, on the LLRs' device). Position p
    sums its repeats as 0.0 + llr[inv[p, 0]] + llr[inv[p, 1]] + ..., one
    rounding per step in that order (never a reduction over R), so every
    device gives the CPU ``index_add_``'s bits; positions never sent are
    +0.0. Adding 0.0 to the LLRs once (-0.0 becomes +0.0) is the sum's first
    step, which leaves the first gathered term as the running sum."""
    e = llrs.shape[-1]
    padded = llrs.new_empty(llrs.shape[:-1] + (e + 1,))
    torch.add(llrs, 0.0, out=padded[..., :e])
    padded[..., e] = 0.0
    g = padded[..., inv]  # [..., d_len, R]
    acc = g[..., 0]
    for j in range(1, inv.shape[-1]):
        acc = acc + g[..., j]
    return acc


def demap_dematch_plain(sym: torch.Tensor, nv, qm: int, scr: torch.Tensor,
                        inv: torch.Tensor, sym_map: torch.Tensor | None = None,
                        lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """The plain version of ``demap_dematch``: the composition the receivers
    ran in torch ops. The symbols (and the noise, broadcast against them)
    are taken through the map first: demapping is per symbol, so that is
    ``demodulate_soft_plain`` followed by the map on the LLRs, as the
    PUSCH decode applied its data positions. Then the slice [lo, hi) times
    scr[lo:hi], then ``dematch`` through ``inv``."""
    if sym_map is not None:
        idx = sym_map.to(torch.int64)
        nv = torch.as_tensor(nv, dtype=torch.float32, device=sym.device)
        sym, nv = sym[..., idx], nv.expand(sym.shape)[..., idx]
    llr = modulation.demodulate_soft_plain(sym, qm, nv)
    hi = llr.shape[-1] if hi is None else hi
    return dematch(llr[..., lo:hi] * scr[lo:hi], inv.to(torch.int64))


def segment_ranges(inv: torch.Tensor, n_seg: int, n_e: int) -> torch.Tensor:
    """[n_seg, 2] int32 on inv's device: the least and the largest entry
    below the pad n_e of each of n_seg equal segments of the rows of the
    inverse index inv [D, R] (int32 max and -1 for a segment with none):
    the run of bits each segment draws on, for ``demap_dematch``."""
    d = inv.shape[0]
    if n_seg < 1 or d % n_seg:
        raise ValueError(f"segment_ranges: {d} positions in {n_seg} equal segments")
    v = inv.reshape(n_seg, -1).to(torch.int64)
    live = (v >= 0) & (v < n_e)
    least = torch.where(live, v, torch.iinfo(torch.int32).max).amin(1)
    most = torch.where(live, v, -1).amax(1)
    return torch.stack([least, most], 1).to(torch.int32)


def demap_dematch(sym: torch.Tensor, nv, qm: int, scr: torch.Tensor, inv: torch.Tensor,
                  sym_map: torch.Tensor | None = None, lo: int = 0,
                  hi: int | None = None, ranges: torch.Tensor | None = None) -> torch.Tensor:
    """Equalized symbols [..., S] complex64 and their noise (a number, or a
    tensor that broadcasts against them) -> softbuffer [..., D] float32.

    Bit e of the codeword is bit e % qm of symbol e // qm, the symbol
    ``sym[..., sym_map[e // qm]]`` when a map is given; its max-log LLR
    (``modulation.demodulate_soft``) is multiplied by scr[e] (+-1, 0 for
    an erased bit). The bits [lo, hi) (hi defaults to every bit of the map
    or of the symbols) fill position p as 0.0 + llr(lo + inv[p, 0]) + ...,
    one rounding per add in that order up to the pad, as ``dematch`` sums:
    ``inv`` [D, R] is ``inverse_index`` of the slice's index map.
    ``ranges`` is ``segment_ranges`` of inv in the segments its positions
    fall into, each drawing on its own run of bits (a code block's 3(K+4)
    positions, a PDCCH candidate's buffer); the callers build it beside inv,
    and None takes the whole row as one segment. It tiles the kernel and
    changes no value. CPU tensors take ``demap_dematch_plain``; CUDA tensors
    launch the kernel ``csrc/demap.cu`` once (``kernels/demap.py``: int32
    ``inv`` and map, contiguous inputs on the symbols' card, or it raises);
    any other device raises."""
    if sym.device.type == "cuda":
        if hi is None:
            hi = qm * (sym.shape[-1] if sym_map is None else sym_map.numel())
        return demap_kernel.demap_dematch_cuda(
            sym.contiguous(), modulation.kernel_noise(nv, sym.device), qm,
            modulation.levels(qm, sym.device), scr, inv, sym_map, lo, hi, ranges)
    if sym.device.type == "cpu":
        return demap_dematch_plain(sym, nv, qm, scr, inv, sym_map, lo, hi)
    raise ValueError(f"demap_dematch: unsupported device {sym.device}")
