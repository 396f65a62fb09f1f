"""DCI formats 0, 1A, 1 and 1C: sizes, RIV, pack/unpack and grant
conversion (36.212 5.3.3, 36.213 7.1). Counterpart of
``srsue_tpu/phy/dci.py`` on the port's ``ra``; host numpy, since a DCI
payload is a handful of bits packed or parsed per grant. Formats 0 and 1A
are padded to one size, so one blind decode covers both (the flag bit
tells them apart).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from srsue_tpu.phy.cell import Cell, DlGrant, UlGrant

from . import ra


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


@dataclass(frozen=True)
class Dci1:
    """DL assignment with type-0 RBG bitmap."""

    rbg_bitmap: int
    mcs: int
    harq_pid: int
    ndi: bool
    rv: int
    tpc: int


def rbg_size(n_rb: int) -> int:
    """Type-0 resource block group size P (36.213 Table 7.1.6.1-1)."""
    return 1 if n_rb <= 10 else 2 if n_rb <= 26 else 3 if n_rb <= 63 else 4


def size_0_1a(n_rb: int) -> int:
    """Common payload size of formats 0/1A (flag + fields, padded equal)."""
    s1a = 1 + 1 + _riv_bits(n_rb) + 5 + 3 + 1 + 2 + 2
    s0 = 1 + 1 + _riv_bits(n_rb) + 5 + 1 + 2 + 3 + 1
    n = max(s1a, s0)
    return n + 1 if n in _AMBIGUOUS_SIZES else n


def size_1(n_rb: int) -> int:
    nbg = math.ceil(n_rb / rbg_size(n_rb))
    n = nbg + 5 + 3 + 1 + 2 + 2
    if n == size_0_1a(n_rb):
        n += 1
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


def pack_0(n_rb: int, d: Dci0) -> np.ndarray:
    bits: list[int] = []
    bits.append(0)  # flag: 0 = format 0
    bits.append(1 if d.hopping else 0)
    _put(bits, d.riv, _riv_bits(n_rb))
    _put(bits, d.mcs, 5)
    bits.append(1 if d.ndi else 0)
    _put(bits, d.tpc, 2)
    _put(bits, d.dmrs_cshift, 3)
    bits.append(1 if d.cqi_request else 0)
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


def pack_1(n_rb: int, d: Dci1) -> np.ndarray:
    nbg = math.ceil(n_rb / rbg_size(n_rb))
    bits: list[int] = []
    _put(bits, d.rbg_bitmap, nbg)
    _put(bits, d.mcs, 5)
    _put(bits, d.harq_pid, 3)
    bits.append(1 if d.ndi else 0)
    _put(bits, d.rv, 2)
    _put(bits, d.tpc, 2)
    out = np.zeros(size_1(n_rb), np.uint8)
    out[: len(bits)] = bits
    return out


def unpack_1(n_rb: int, bits: np.ndarray) -> Dci1:
    nbg = math.ceil(n_rb / rbg_size(n_rb))
    r = _Reader(bits)
    return Dci1(
        rbg_bitmap=r.take(nbg),
        mcs=r.take(5),
        harq_pid=r.take(3),
        ndi=bool(r.take(1)),
        rv=r.take(2),
        tpc=r.take(2),
    )


@dataclass(frozen=True)
class Dci1C:
    """Very compact DL assignment (SI/RA/paging; 36.212 §5.3.3.1.4):
    distributed VRBs in N_gap steps + restricted TBS index."""

    riv: int
    tbs_idx: int  # 5 bits, Table 7.1.7.2.3-1 column
    gap: int = 0


def _n_step_1c(n_rb: int) -> int:
    return 2 if n_rb < 50 else 4


def size_1c(n_rb: int) -> int:
    n_vrb = n_rb // _n_step_1c(n_rb)
    n = math.ceil(math.log2(n_vrb * (n_vrb + 1) / 2)) + 5
    if n_rb >= 50:
        n += 1
    return n


# 36.213 Table 7.1.7.2.3-1: TBS for DCI format 1C (32 entries)
TBS_1C = [40, 56, 72, 120, 136, 144, 176, 208, 224, 256, 280, 296, 328,
          336, 392, 488, 552, 600, 632, 696, 776, 840, 904, 1000, 1064,
          1128, 1224, 1288, 1384, 1480, 1608, 1736]


def pack_1c(n_rb: int, d: Dci1C) -> np.ndarray:
    bits: list[int] = []
    if n_rb >= 50:
        bits.append(d.gap & 1)
    step = _n_step_1c(n_rb)
    n_vrb = n_rb // step
    _put(bits, d.riv, math.ceil(math.log2(n_vrb * (n_vrb + 1) / 2)))
    _put(bits, d.tbs_idx, 5)
    out = np.zeros(size_1c(n_rb), np.uint8)
    out[: len(bits)] = bits
    return out


def unpack_1c(n_rb: int, bits: np.ndarray) -> Dci1C:
    r = _Reader(bits)
    gap = r.take(1) if n_rb >= 50 else 0
    step = _n_step_1c(n_rb)
    n_vrb = n_rb // step
    riv = r.take(math.ceil(math.log2(n_vrb * (n_vrb + 1) / 2)))
    return Dci1C(riv=riv, tbs_idx=r.take(5), gap=gap)


def dci1c_to_grant(cell: Cell, d: Dci1C) -> DlGrant:
    step = _n_step_1c(cell.n_prb)
    n_vrb = cell.n_prb // step
    start_g, len_g = riv_decode(n_vrb, d.riv)
    return DlGrant(
        n_prb=len_g * step,
        prb_start=start_g * step,
        mcs=0,
        mod_order=2,  # 1C is always QPSK
        tbs=TBS_1C[d.tbs_idx],
        rv=0,
    )


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


def dci0_to_grant(cell: Cell, d: Dci0) -> UlGrant:
    start, length = riv_decode(cell.n_prb, d.riv)
    if d.mcs < 29:
        mod, i_tbs = ra.mcs_to_mod_itbs(min(d.mcs, 28))
        mod = min(mod, 6)
        tbs = ra.tbs(i_tbs, length)
    else:
        mod, tbs = 2, 0  # retransmission-only MCS
    return UlGrant(
        n_prb=length,
        prb_start=start,
        mcs=d.mcs,
        mod_order=mod,
        tbs=tbs,
        rv=0,
        ndi=d.ndi,
    )


def rar_to_ul_grant(cell: Cell, rar_grant) -> UlGrant:
    """20-bit RAR grant -> Msg3 UL grant (srslte_ra_rar_to_ul_grant
    parity; truncated type-2 RIV + 4-bit MCS)."""
    start, length = riv_decode(cell.n_prb, rar_grant.riv)
    mod, i_tbs = ra.mcs_to_mod_itbs(min(rar_grant.mcs, 28))
    return UlGrant(
        n_prb=length, prb_start=start, mcs=rar_grant.mcs,
        mod_order=min(mod, 2),  # Msg3 is QPSK
        tbs=ra.tbs(i_tbs, length),
    )


def dci1_to_grant(cell: Cell, d: Dci1) -> DlGrant:
    p = rbg_size(cell.n_prb)
    nbg = math.ceil(cell.n_prb / p)
    prbs = []
    for g in range(nbg):
        if (d.rbg_bitmap >> (nbg - 1 - g)) & 1:
            for i in range(p):
                prb = g * p + i
                if prb < cell.n_prb:
                    prbs.append(prb)
    # contiguity not required by spec; our PDSCH codec currently assumes a
    # contiguous span, so expose (start, count) of the covered range.
    if not prbs:
        raise ValueError("empty format-1 allocation")
    start, n = prbs[0], len(prbs)
    mod, i_tbs = ra.mcs_to_mod_itbs(d.mcs)
    return DlGrant(
        n_prb=n,
        prb_start=start,
        mcs=d.mcs,
        mod_order=mod,
        tbs=ra.tbs(i_tbs, n),
        rv=d.rv,
        ndi=d.ndi,
    )
