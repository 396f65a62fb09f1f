"""Pseudo-random (Gold) sequences, 36.211 7.2.

Host numpy, computed once per (c_init, length) and cached. The generator
is vectorized: the recurrences have a minimum tap distance of 3, so one
numpy slice-XOR step emits 28 new bits.
"""

from __future__ import annotations

import functools

import numpy as np

NC = 1600  # 36.211 §7.2 fast-forward offset

_X1_CACHE: np.ndarray | None = None


def _advance_mseq(x: np.ndarray, taps: tuple[int, ...], n_total: int) -> np.ndarray:
    """Extend a length-31-register m-sequence to n_total bits.

    x[i+31] = XOR of x[i+t] for t in taps. min(taps)=0, max(taps)=3 for both
    LTE generators -> can emit 28 bits per vector step.
    """
    out = np.empty(n_total, dtype=np.uint8)
    out[:31] = x[:31]
    filled = 31
    while filled < n_total:
        step = min(28, n_total - filled)
        base = filled - 31
        acc = out[base : base + step].copy()
        for t in taps:
            if t:
                acc ^= out[base + t : base + t + step]
        out[filled : filled + step] = acc
        filled += step
    return out


def _x1(n: int) -> np.ndarray:
    """x1 is cell-independent: compute once, grow cache on demand."""
    global _X1_CACHE
    if _X1_CACHE is None or len(_X1_CACHE) < n:
        init = np.zeros(31, dtype=np.uint8)
        init[0] = 1
        _X1_CACHE = _advance_mseq(init, (0, 3), max(n, 1 << 17))
    return _X1_CACHE[:n]


@functools.lru_cache(maxsize=4096)
def prs(c_init: int, length: int) -> np.ndarray:
    """Gold sequence c(n), n in [0, length). Returns uint8 {0,1}.

    c(n) = (x1(n+Nc) + x2(n+Nc)) mod 2 with x2 seeded from c_init.
    """
    total = NC + length
    x2_init = np.array([(c_init >> i) & 1 for i in range(31)], dtype=np.uint8)
    x2 = _advance_mseq(x2_init, (0, 1, 2, 3), total)
    x1 = _x1(total)
    return (x1[NC:] ^ x2[NC:]).astype(np.uint8)
