"""CRC attachment and the CRC matrix, 36.212 5.1.1 (gCRC24A/24B/16/8).
The port's own copy of the functions of ``srsue_tpu/phy/crc.py`` (its
reference) that the port reads.

A CRC over GF(2) with zero init is linear in the message, so crc(m) is the
XOR of x^(n-1-i+L) mod g over the set bits i: one growing table of x^k mod
g serves both the host CRC and M[n, L] with parity = (bits @ M) mod 2,
which the port's batched CRC checks apply as one matrix product.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = {
    "24A": (24, 0x864CFB),
    "24B": (24, 0x800063),
    "16": (16, 0x1021),
    "8": (8, 0x9B),
}


class _PowTable:
    """Growing table of x^k mod g(x), k = 0..N, as integers of L bits."""

    def __init__(self, nbits: int, poly: int):
        self.nbits = nbits
        self.poly = poly
        self.tab = np.array([1], dtype=np.uint32)

    def upto(self, n: int) -> np.ndarray:
        if len(self.tab) <= n:
            grow = max(n + 1, 2 * len(self.tab), 4096)
            ext = np.empty(grow, dtype=np.uint32)
            ext[: len(self.tab)] = self.tab
            top = 1 << (self.nbits - 1)
            mask = (1 << self.nbits) - 1
            r = int(ext[len(self.tab) - 1])
            for k in range(len(self.tab), grow):
                r = ((r << 1) ^ (self.poly if r & top else 0)) & mask
                ext[k] = r
            self.tab = ext
        return self.tab[: n + 1]


@functools.lru_cache(maxsize=8)
def _table(kind: str) -> _PowTable:
    nbits, poly = POLY[kind]
    return _PowTable(nbits, poly)


def crc(bits: np.ndarray, kind: str) -> np.ndarray:
    """CRC parity bits for a {0,1} bit vector. Returns uint8 [L] (MSB first,
    i.e. the order they are appended to the transport block)."""
    nbits, _ = POLY[kind]
    bits = np.asarray(bits, dtype=np.uint8).ravel()
    n = len(bits)
    tab = _table(kind).upto(n - 1 + nbits)
    # bit i (MSB-first message order) contributes x^(n-1-i+nbits) mod g
    contrib = tab[nbits : n + nbits][::-1]
    sel = contrib[bits != 0]
    val = np.bitwise_xor.reduce(sel) if len(sel) else np.uint32(0)
    out = (int(val) >> np.arange(nbits - 1, -1, -1)) & 1
    return out.astype(np.uint8)


def attach(bits: np.ndarray, kind: str, mask: int = 0) -> np.ndarray:
    """Append CRC (optionally XOR-masked, e.g. PBCH antenna mask or
    PDCCH RNTI mask) to a bit vector."""
    nbits, _ = POLY[kind]
    par = crc(bits, kind)
    if mask:
        m = (mask >> np.arange(nbits - 1, -1, -1)) & 1
        par = par ^ m.astype(np.uint8)
    return np.concatenate([np.asarray(bits, dtype=np.uint8).ravel(), par])


def check(bits_with_crc: np.ndarray, kind: str, mask: int = 0) -> bool:
    """Whether the trailing (optionally XOR-masked) CRC matches the bits."""
    nbits, _ = POLY[kind]
    b = np.asarray(bits_with_crc, dtype=np.uint8).ravel()
    return bool(np.array_equal(attach(b[:-nbits], kind, mask), b))


@functools.lru_cache(maxsize=64)
def crc_matrix(n: int, kind: str) -> np.ndarray:
    """M[n, L] uint8 such that parity = (bits @ M) mod 2 — used on-device
    as a single matmul for batched CRC checks."""
    nbits, _ = POLY[kind]
    tab = _table(kind).upto(n - 1 + nbits)
    contrib = tab[nbits : n + nbits][::-1]  # [n] uint32
    cols = (contrib[:, None] >> np.arange(nbits - 1, -1, -1)[None, :]) & 1
    return cols.astype(np.uint8)
