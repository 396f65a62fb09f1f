"""PUSCH tables and the host encoder of one uplink grant (36.212 5.2.2,
36.211 5.3-5.5): the UCI positions in the channel interleaver, each code
block's rate-matching index map, the scrambling bits, the DMRS and the
RM(20, A) block code of the CQI. The uplink transmitter encodes with them;
the uplink receiver reads the same tables.

The port's semantics, where they depart from the text of 36.211/36.212
(the benchmark's configuration lists them under ``departures``): the CQI is
RM(20, A) coded and repeated circularly over its symbols (36.212 5.2.2.6.4
has RM(32, O)); the CQI and ACK bits are not scrambled; the ACK bit is
repeated on every bit of its symbols (0 for ACK); no group or sequence
hopping (u = cell_id mod 30, v = 0) and the configured cyclic shift in both
slots (no n_PRS); the DMRS table for 3 PRB and more only.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from . import ratematch, segmentation, seq, turbo
from .modulation import modulate_np

DMRS_SYMS = (3, 10)  # symbol 3 of each slot, normal CP
ACK_COLS = (2, 3, 8, 9)  # the interleaver's columns beside the DMRS symbols
N_DATA_SYMS = 12  # SC-FDMA symbols a subframe that carry data

# 36.212 Table 5.2.3.3-1: basis sequences M_{i,n}, i = 0..19, n = 0..12
RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], dtype=np.int64)


def rm20_encode(bits: np.ndarray) -> np.ndarray:
    """[A <= 13] information bits -> the [20] codeword, sum over n of a_n
    M_{i,n} mod 2."""
    a = np.asarray(bits, np.int64).ravel()
    return (RM20_BASIS[:, :len(a)] @ a % 2).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def rm20_codewords(n_bits: int) -> np.ndarray:
    """[2^A, 20] every codeword, word w carrying bit n of w as a_n."""
    words = np.arange(1 << n_bits)
    return np.stack([rm20_encode((w >> np.arange(n_bits)) & 1) for w in words])


def zadoff_chu(m_sc: int, u: int) -> np.ndarray:
    """The base sequence r_{u,0}(n) of 36.211 5.5.1.1 for M_sc >= 36: the
    q-th root Zadoff-Chu sequence of the largest prime length below M_sc,
    extended cyclically."""
    if m_sc < 36:
        raise ValueError("the DMRS of 1 and 2 PRB takes tables not written here")
    n_zc = next(p for p in range(m_sc - 1, 1, -1)
                if all(p % d for d in range(2, math.isqrt(p) + 1)))
    q = int(np.floor(n_zc * (u + 1) / 31 + 0.5))
    m = np.arange(m_sc) % n_zc
    return np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)


def dmrs(cell_id: int, m_sc: int, cyclic_shift: int) -> np.ndarray:
    """[M_sc] DMRS of either slot: the base sequence of group u = cell_id mod
    30 rotated by the cyclic shift, alpha = 2 pi n_cs / 12."""
    alpha = 2.0 * np.pi * cyclic_shift / 12.0
    return zadoff_chu(m_sc, cell_id % 30) * np.exp(1j * alpha * np.arange(m_sc))


class PuschMap:
    """The static tables of one (cell, grant, rnti, subframe, UCI).

    The data and the UCI share the channel interleaver's R x 12 matrix (R =
    M_sc rows, a column per data SC-FDMA symbol), written row by row and
    read column by column, so a position's stream index is column * M_sc +
    row: the CQI takes the first positions written, the data every other
    (rate matched over them), and the ACK overwrites the data's symbols at
    the bottom rows of the columns beside the DMRS (the receiver erases
    those data bits)."""

    def __init__(self, n_prb: int, prb_start: int, qm: int, tbs: int, rnti: int,
                 subframe: int, cell_id: int, n_cqi_bits: int, cqi_rep: int,
                 ack_syms: int, rv: int = 0):
        self.m_sc = 12 * n_prb
        self.sc0 = 12 * prb_start
        self.qm, self.tbs, self.n_cqi_bits = qm, tbs, n_cqi_bits
        self.n_re = N_DATA_SYMS * self.m_sc
        n_cqi_syms = -(-20 * cqi_rep // qm) if n_cqi_bits else 0
        rows, cols = np.meshgrid(np.arange(self.m_sc), np.arange(N_DATA_SYMS), indexing="ij")
        written = (cols * self.m_sc + rows).reshape(-1)  # stream index in writing order
        self.cqi_pos, self.data_pos = written[:n_cqi_syms], written[n_cqi_syms:]
        i = np.arange(ack_syms)
        self.ack_pos = np.asarray(ACK_COLS)[i % 4] * self.m_sc + (self.m_sc - 1 - i // 4)
        if np.isin(self.ack_pos, self.cqi_pos).any():
            raise ValueError("the ACK's symbols fall on the CQI's")
        self.erased = np.repeat(np.isin(self.data_pos, self.ack_pos), qm)  # [G] data bits
        self.G = len(self.data_pos) * qm
        self.plan = p = segmentation.plan(tbs)
        # 36.212 5.1.4.1.2: E per code block over G / Qm symbols
        g_sym = len(self.data_pos)
        gamma = g_sym % p.c
        self.E = [qm * (g_sym // p.c + (1 if i >= p.c - gamma else 0)) for i in range(p.c)]
        self.rm_idx = [ratematch.turbo_rm_indices(k + 4, self.E[i], rv,
                                                  n_filler=(p.f if i == 0 else 0))
                       for i, k in enumerate(p.block_ks)]
        # 36.211 5.3.1: c_init = rnti * 2^14 + floor(ns / 2) * 2^9 + cell_id
        self.scr_bits = seq.prs((rnti << 14) + (subframe << 9) + cell_id, self.G)

    def encode_stream(self, payload: np.ndarray, cqi: np.ndarray, ack: bool) -> np.ndarray:
        """One subframe's [12 M_sc] symbols in stream order: the scrambled
        codeword on the data positions, the repeated CQI codeword and the
        ACK over them."""
        cw = np.concatenate([turbo.encode(blk).reshape(-1)[self.rm_idx[i]]
                             for i, blk in enumerate(segmentation.segment(payload))])
        stream = np.zeros(self.n_re, np.complex128)
        stream[self.data_pos] = modulate_np(cw ^ self.scr_bits, self.qm)
        if len(self.cqi_pos):
            n = len(self.cqi_pos) * self.qm
            stream[self.cqi_pos] = modulate_np(np.resize(rm20_encode(cqi), n), self.qm)
        if len(self.ack_pos):
            bits = np.full(len(self.ack_pos) * self.qm, 0 if ack else 1, np.uint8)
            stream[self.ack_pos] = modulate_np(bits, self.qm)
        return stream
