"""DCI formats 0 and 1A: size, RIV, pack/unpack and the 1A grant
(36.212 5.3.3, 36.213 7.1), host numpy. Formats 0 and 1A
are padded to one size, so one blind decode covers both (the flag bit
tells them apart).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import ra
from .cell import Cell, DlGrant


def _riv_bits(n_rb: int) -> int:
    return math.ceil(math.log2(n_rb * (n_rb + 1) / 2))


def riv_encode(n_rb: int, start: int, length: int) -> int:
    """Resource indication value, type-2 contiguous allocation."""
    if length - 1 <= n_rb // 2:
        return n_rb * (length - 1) + start
    return n_rb * (n_rb - length + 1) + (n_rb - 1 - start)


def riv_decode(n_rb: int, riv: int) -> tuple[int, int]:
    l = riv // n_rb + 1
    s = riv % n_rb
    if l - 1 > n_rb // 2 or s + l > n_rb:
        l = n_rb - l + 2
        s = n_rb - 1 - s
    return s, l


def _put(bits: list[int], val: int, n: int) -> None:
    bits.extend((val >> i) & 1 for i in range(n - 1, -1, -1))


class _Reader:
    def __init__(self, bits: np.ndarray):
        self.b = np.asarray(bits).astype(np.int64)
        self.i = 0

    def take(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.b[self.i])
            self.i += 1
        return v


@dataclass(frozen=True)
class Dci1A:
    """Compact DL assignment (also carries RA/SI grants)."""

    riv: int
    mcs: int
    harq_pid: int
    ndi: bool
    rv: int
    tpc: int
    distributed: bool = False


@dataclass(frozen=True)
class Dci0:
    """UL grant."""

    riv: int
    mcs: int
    ndi: bool
    tpc: int
    dmrs_cshift: int = 0
    cqi_request: bool = False
    hopping: bool = False


def size_0_1a(n_rb: int) -> int:
    """Common payload size of formats 0/1A (flag + fields, padded equal)."""
    s1a = 1 + 1 + _riv_bits(n_rb) + 5 + 3 + 1 + 2 + 2
    s0 = 1 + 1 + _riv_bits(n_rb) + 5 + 1 + 2 + 3 + 1
    n = max(s1a, s0)
    return n + 1 if n in _AMBIGUOUS_SIZES else n


# 36.212 Table 5.3.3.1.2-1: payload sizes that must be avoided (padded)
_AMBIGUOUS_SIZES = {12, 14, 16, 20, 24, 26, 32, 40, 44, 56}


def pack_1a(n_rb: int, d: Dci1A) -> np.ndarray:
    bits: list[int] = []
    bits.append(1)  # flag: 1 = format 1A
    bits.append(1 if d.distributed else 0)
    _put(bits, d.riv, _riv_bits(n_rb))
    _put(bits, d.mcs, 5)
    _put(bits, d.harq_pid, 3)
    bits.append(1 if d.ndi else 0)
    _put(bits, d.rv, 2)
    _put(bits, d.tpc, 2)
    out = np.zeros(size_0_1a(n_rb), np.uint8)
    out[: len(bits)] = bits
    return out


def unpack_0_1a(n_rb: int, bits: np.ndarray):
    r = _Reader(bits)
    flag = r.take(1)
    if flag:
        distributed = bool(r.take(1))
        return Dci1A(
            riv=r.take(_riv_bits(n_rb)),
            mcs=r.take(5),
            harq_pid=r.take(3),
            ndi=bool(r.take(1)),
            rv=r.take(2),
            tpc=r.take(2),
            distributed=distributed,
        )
    hopping = bool(r.take(1))
    return Dci0(
        riv=r.take(_riv_bits(n_rb)),
        mcs=r.take(5),
        ndi=bool(r.take(1)),
        tpc=r.take(2),
        dmrs_cshift=r.take(3),
        cqi_request=bool(r.take(1)),
        hopping=hopping,
    )


# 36.213 Table 7.1.7.2.3-1: TBS for DCI format 1C (32 entries)
TBS_1C = [40, 56, 72, 120, 136, 144, 176, 208, 224, 256, 280, 296, 328,
          336, 392, 488, 552, 600, 632, 696, 776, 840, 904, 1000, 1064,
          1128, 1224, 1288, 1384, 1480, 1608, 1736]


# ---------------------------------------------------------------------------
# grant conversion (srslte_dci_msg_to_*_grant parity)
# ---------------------------------------------------------------------------


def dci1a_to_grant(cell: Cell, d: Dci1A) -> DlGrant:
    start, length = riv_decode(cell.n_prb, d.riv)
    mod, i_tbs = ra.mcs_to_mod_itbs(d.mcs)
    return DlGrant(
        n_prb=length,
        prb_start=start,
        mcs=d.mcs,
        mod_order=mod,
        tbs=ra.tbs(i_tbs, length),
        rv=d.rv,
        ndi=d.ndi,
    )


