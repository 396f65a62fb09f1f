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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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
