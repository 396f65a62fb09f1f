"""Transport-block CRC attachment, code block segmentation and
desegmentation (36.212 5.1.2), host side. Counterpart of
``srsue_tpu/phy/segmentation.py``."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from . import crc
from .turbo import VALID_K

Z = 6144  # max code block size


@dataclass(frozen=True)
class SegPlan:
    """Static segmentation layout for a TB size."""

    tbs: int       # transport block payload bits (no CRC)
    c: int         # number of code blocks
    k_plus: int    # larger block size
    k_minus: int   # smaller block size (0 if unused)
    c_plus: int
    c_minus: int
    f: int         # filler bits (prepended to the first block)

    @property
    def block_ks(self) -> tuple[int, ...]:
        return (self.k_minus,) * self.c_minus + (self.k_plus,) * self.c_plus

    @property
    def uniform_k(self) -> int:
        """The largest block size, to which device arrays are padded."""
        return self.k_plus


@functools.lru_cache(maxsize=1024)
def plan(tbs: int) -> SegPlan:
    b = tbs + 24  # TB CRC24A
    if b <= Z:
        c, b_prime = 1, b
    else:
        c = -(-b // (Z - 24))
        b_prime = b + 24 * c
    k_plus = int(VALID_K[np.searchsorted(VALID_K, -(-b_prime // c))])
    if c == 1:
        c_plus, k_minus, c_minus = 1, 0, 0
    else:
        k_minus = int(VALID_K[np.searchsorted(VALID_K, k_plus) - 1])
        c_minus = (c * k_plus - b_prime) // (k_plus - k_minus)
        c_plus = c - c_minus
    f = c_plus * k_plus + c_minus * k_minus - b_prime
    return SegPlan(tbs, c, k_plus, k_minus, c_plus, c_minus, f)


def segment(tb_bits: np.ndarray) -> list[np.ndarray]:
    """TB payload bits -> code blocks (CRC24B each if C > 1, filler zeros
    prepended to block 0)."""
    tb_bits = np.asarray(tb_bits, np.uint8).ravel()
    p = plan(len(tb_bits))
    b = crc.attach(tb_bits, "24A")
    if p.c == 1:
        return [np.concatenate([np.zeros(p.f, np.uint8), b])]
    blocks = []
    pos = 0
    for i, k in enumerate(p.block_ks):
        f = p.f if i == 0 else 0
        n = k - 24 - f
        blk = np.concatenate([np.zeros(f, np.uint8), b[pos:pos + n]])
        pos += n
        blocks.append(crc.attach(blk, "24B"))
    assert pos == len(b)
    return blocks


def desegment(blocks: list[np.ndarray], tbs: int) -> tuple[np.ndarray, bool]:
    """Code blocks (hard bits, CRCs attached) -> (TB payload, crc_ok): each
    block's CRC24B when C > 1, then the TB's CRC24A."""
    p = plan(tbs)
    ok = True
    if p.c == 1:
        b = blocks[0][p.f:]
    else:
        parts = []
        for i, blk in enumerate(blocks):
            ok &= crc.check(blk, "24B")
            parts.append(blk[:-24][p.f if i == 0 else 0:])
        b = np.concatenate(parts)
    ok &= crc.check(b, "24A")
    return b[:-24], bool(ok)
