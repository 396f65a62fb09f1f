"""PDSCH tables and the host encoder of one grant (36.212 5.3.2, 36.211
6.3/6.4): the RE map, each code block's rate-matching index map, the
scrambling bits and the segmentation plan. The transmitter encodes with
them; the receiver reads the same tables, as a tokenizer is shared."""

from __future__ import annotations

import numpy as np

from . import modulation, ratematch, regrid, segmentation, seq, turbo
from .cell import Cell, DlGrant


class PdschMap:
    """The static tables of one (cell, grant, rnti, subframe, cfi)."""

    def __init__(self, cell: Cell, grant: DlGrant, rnti: int, subframe: int, cfi: int = 1):
        self.cell, self.grant = cell, grant
        self.plan = p = segmentation.plan(grant.tbs)
        self.qm = grant.mod_order
        self.re_idx = regrid.pdsch_re(cell, subframe, cfi, grant.prb_start,
                                      grant.n_prb).astype(np.int64)
        self.n_re = len(self.re_idx)
        self.block_ks = p.block_ks
        # 36.212 5.1.4.1.2 bit selection: E per code block (one layer)
        gamma = self.n_re % p.c
        e = [self.qm * (self.n_re // p.c + (1 if i >= p.c - gamma else 0)) for i in range(p.c)]
        # out[e] = d_flat[idx[e]] over the block's [3, K+4] streams, stream-major
        self.rm_idx = [ratematch.turbo_rm_indices(k + 4, e[i], grant.rv,
                                                  n_filler=(p.f if i == 0 else 0))
                       for i, k in enumerate(p.block_ks)]
        # 36.211 6.3.1: c_init = rnti*2^14 + q*2^13 + floor(ns/2)*2^9 + cell_id
        c_init = (rnti << 14) + (subframe << 9) + cell.cell_id
        self.scr_bits = seq.prs(c_init, self.n_re * self.qm)

    def encode(self, payload: np.ndarray) -> np.ndarray:
        """TB payload bits [tbs] -> scrambled codeword bits [G]."""
        if len(payload) != self.grant.tbs:
            raise ValueError(f"payload has {len(payload)} bits, TBS is {self.grant.tbs}")
        cw = np.concatenate([turbo.encode(blk).reshape(-1)[self.rm_idx[i]]
                             for i, blk in enumerate(segmentation.segment(payload))])
        return (cw ^ self.scr_bits).astype(np.uint8)

    def encode_symbols(self, payload: np.ndarray) -> np.ndarray:
        """TB payload -> modulated symbols [n_re] complex64."""
        return modulation.modulate_np(self.encode(payload), self.qm)
