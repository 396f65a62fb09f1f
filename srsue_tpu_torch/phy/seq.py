"""Pseudo-random (Gold) sequences, the PSS Zadoff-Chu and SSS
m-sequences, 36.211 7.2, 6.11.1 and 6.11.2. The port's own copy of the
functions of ``srsue_tpu/phy/seq.py`` (its reference) that the port reads,
in numpy only (the reference also has a native generator of the same bits).

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


# ---------------------------------------------------------------------------
# PSS — 36.211 §6.11.1: length-63 Zadoff-Chu, root u in {25, 29, 34}
# ---------------------------------------------------------------------------

PSS_ROOTS = (25, 29, 34)  # N_id_2 = 0, 1, 2


@functools.lru_cache(maxsize=8)
def pss_freq(n_id_2: int) -> np.ndarray:
    """PSS d_u(n), n=0..61 (the punctured middle element n=31 removed),
    complex64, as mapped onto the 62 central subcarriers."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(63)
    d = np.where(
        n <= 30,
        np.exp(-1j * np.pi * u * n * (n + 1) / 63.0),
        np.exp(-1j * np.pi * u * (n + 1) * (n + 2) / 63.0),
    )
    return np.delete(d, 31).astype(np.complex64)


# ---------------------------------------------------------------------------
# SSS — 36.211 §6.11.2: interleaved concatenation of two length-31 m-sequences
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _sss_base() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """s~, c~, z~ base m-sequences (each length 31, +-1)."""

    def mseq31(taps: tuple[int, ...]) -> np.ndarray:
        x = np.zeros(31, dtype=np.int8)
        x[4] = 1
        for i in range(26):
            v = 0
            for t in taps:
                v ^= x[i + t]
            x[i + 5] = v
        return (1 - 2 * x).astype(np.float32)

    s = mseq31((0, 2))        # x(i+5) = x(i+2) + x(i)
    c = mseq31((0, 3))        # x(i+5) = x(i+3) + x(i)
    z = mseq31((0, 1, 2, 4))  # x(i+5) = x(i+4)+x(i+2)+x(i+1)+x(i)
    return s, c, z


@functools.lru_cache(maxsize=1024)
def sss_freq(n_id_1: int, n_id_2: int, subframe5: bool) -> np.ndarray:
    """SSS d(n), n=0..61, float32 (+-1), for subframe 0 or subframe 5.

    m0/m1 derivation per 36.211 Table 6.11.2.1-1 closed form.
    """
    s_base, c_base, z_base = _sss_base()
    q_prime = n_id_1 // 30
    q = (n_id_1 + q_prime * (q_prime + 1) // 2) // 30
    m_prime = n_id_1 + q * (q + 1) // 2
    m0 = m_prime % 31
    m1 = (m0 + m_prime // 31 + 1) % 31

    def s_seq(m):
        return np.roll(s_base, -m)

    def c_seq(m):
        return np.roll(c_base, -m)

    def z_seq(m):
        return np.roll(z_base, -m)

    s0 = s_seq(m0)
    s1 = s_seq(m1)
    c0 = c_seq(n_id_2)
    c1 = c_seq(n_id_2 + 3)
    z1_m0 = z_seq(m0 % 8)
    z1_m1 = z_seq(m1 % 8)

    d = np.empty(62, dtype=np.float32)
    if not subframe5:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d
