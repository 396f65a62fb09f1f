"""Turbo and convolutional rate-matching index maps (36.212 5.1.4.1,
5.1.4.2): the sub-block interleavers and the circular-buffer walk as host
numpy tables, ``out[e] = d_flat[idx[e]]``. NULL (dummy/filler) positions
never appear in a map. The transmitter gathers through them; the receiver
sums each position's repeats through the same maps."""

from __future__ import annotations

import functools

import numpy as np

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
