"""Constellation mapping on the host (36.211 7.1), for the transmitter."""

from __future__ import annotations

import functools

import numpy as np

from .cell import MOD_16QAM, MOD_64QAM, MOD_BPSK, MOD_QPSK

_A16 = 1.0 / np.sqrt(10.0)
_A64 = 1.0 / np.sqrt(42.0)
_A2 = 1.0 / np.sqrt(2.0)


@functools.lru_cache(maxsize=8)
def constellation(mod_order: int) -> np.ndarray:
    """complex64 table of size 2**mod_order indexed by the bit word
    (b0 b1 ... b_{Qm-1}, b0 = MSB)."""
    m = mod_order
    words = np.arange(1 << m)
    bits = (words[:, None] >> np.arange(m - 1, -1, -1)[None, :]) & 1
    s = 1 - 2 * bits
    if m == MOD_BPSK:
        sym = s[:, 0] * (_A2 + 1j * _A2)
    elif m == MOD_QPSK:
        sym = _A2 * (s[:, 0] + 1j * s[:, 1])
    elif m == MOD_16QAM:
        sym = _A16 * (s[:, 0] * (2 - s[:, 2]) + 1j * s[:, 1] * (2 - s[:, 3]))
    elif m == MOD_64QAM:
        i = s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
        q = s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5]))
        sym = _A64 * (i + 1j * q)
    else:
        raise ValueError(f"unsupported mod_order={m}")
    return sym.astype(np.complex64)


def modulate_np(bits: np.ndarray, mod_order: int) -> np.ndarray:
    """Host mapper: [..., n*Qm] {0,1} -> [..., n] complex64."""
    m = mod_order
    b = np.asarray(bits, dtype=np.int64).reshape(bits.shape[:-1] + (-1, m))
    pw = (1 << np.arange(m - 1, -1, -1)).astype(np.int64)
    return constellation(m)[(b * pw).sum(-1)]
