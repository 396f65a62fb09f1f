"""PDSCH transport-channel processing (36.212 5.3.2, 36.211 6.3/6.4).

Counterpart of ``srsue_tpu/phy/pdsch.py``. A ``PdschCodec`` holds the
host-side precompute of one static (cell, grant, rnti, subframe, cfi)
configuration -- RE map, per-block rate-matching index maps, scrambling
sequence, CRC syndrome matrices -- as numpy arrays for the host encoder
and as tensors on its device for the receive path. HARQ soft-combining is
``+`` of the softbuffers ``dematch`` returns.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ..utils.device import resolve
from ..utils.trace import annotate
from . import (chest, crc, equalize, frontend, modulation, ofdm, ratematch, regrid,
               segmentation, seq, turbo)
from .cell import Cell, DlGrant

FILLER_LLR = 1e4  # known-zero filler bits: saturated "bit 0" prior


def blk_crc_matrix(plan: segmentation.SegPlan, i: int, k: int) -> np.ndarray:
    """[K, 24] syndrome matrix of code block i over its whole K bits: the
    TB CRC24A (fillers excluded) when C == 1, else the block CRC24B."""
    m = np.zeros((k, 24), np.uint8)
    if plan.c == 1:
        f = plan.f if i == 0 else 0
        m[f:k - 24] = crc.crc_matrix(k - 24 - f, "24A")
    else:
        m[:k - 24] = crc.crc_matrix(k - 24, "24B")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    return m


class PdschCodec:
    """Static-shape PDSCH encoder (host) and decoder (torch, on `device`:
    the current CUDA device by default, "cpu" for the plain twins).

    The turbo decoder runs ``n_turbo_iters`` iterations with the
    half-iteration kernel instance ``kernel`` (``kernels.bcjr.KERNELS``):
    masked, with converged blocks frozen and a synchronised stop once all
    passed when ``early_exit``; or, when ``forced``, all iterations with no
    per-iteration CRC (``early_exit`` is then not read)."""

    def __init__(self, cell: Cell, grant: DlGrant, rnti: int, subframe: int,
                 cfi: int = 1, n_turbo_iters: int = 8, early_exit: bool = True,
                 device: str | torch.device = "cuda", kernel: str = "r2max",
                 forced: bool = False):
        plan = segmentation.plan(grant.tbs)
        re_idx = regrid.pdsch_re(cell, subframe, cfi, grant.prb_start, grant.n_prb)
        qm = grant.mod_order
        # 36.212 5.1.4.1.2 bit selection: E per code block (one layer)
        g_prime = len(re_idx)
        gamma = g_prime % plan.c
        e = [qm * (g_prime // plan.c + (1 if i >= plan.c - gamma else 0))
             for i in range(plan.c)]
        rm_idx = [ratematch.turbo_rm_indices(k + 4, e[i], grant.rv,
                                             n_filler=(plan.f if i == 0 else 0))
                  for i, k in enumerate(plan.block_ks)]
        # 36.211 6.3.1: c_init = rnti*2^14 + q*2^13 + floor(ns/2)*2^9 + cell_id
        c_init = (rnti << 14) + (subframe << 9) + cell.cell_id
        scr_pm1 = seq.prs_f32(c_init, g_prime * qm)
        blk_crc = {k: blk_crc_matrix(plan, i, k) for i, k in enumerate(plan.block_ks)}
        self._setup(cell, grant, re_idx, rm_idx, scr_pm1, blk_crc,
                    crc.crc_matrix(grant.tbs, "24A"), device, subframe,
                    n_turbo_iters, early_exit, kernel, forced)

    @classmethod
    def from_arrays(cls, cell: Cell, grant: DlGrant, re_idx, rm_idx, scr_pm1,
                    blk_crc: dict, tb_crc, device: str | torch.device = "cuda",
                    *, subframe: int | None = None, n_turbo_iters: int = 8,
                    early_exit: bool = True, kernel: str = "r2max",
                    forced: bool = False) -> "PdschCodec":
        """A codec from given tables (e.g. the reference codec's ``re_idx``,
        ``rm_idx``, ``scr_pm1``, ``_blk_crc`` and ``_tb_crc``)."""
        self = cls.__new__(cls)
        self._setup(cell, grant, re_idx, rm_idx, scr_pm1, blk_crc, tb_crc,
                    device, subframe, n_turbo_iters, early_exit, kernel, forced)
        return self

    def _setup(self, cell, grant, re_idx, rm_idx, scr_pm1, blk_crc, tb_crc,
               device, subframe, n_turbo_iters, early_exit, kernel, forced):
        dev = resolve(device)
        self.cell, self.grant, self.subframe = cell, grant, subframe
        self.n_turbo_iters, self.early_exit = n_turbo_iters, early_exit
        self.kernel, self.forced = kernel, forced
        self.device = dev
        self.plan = p = segmentation.plan(grant.tbs)
        self.qm = grant.mod_order
        self.re_idx = np.asarray(re_idx, np.int64)
        self.rm_idx = [np.asarray(r, np.int64) for r in rm_idx]
        self.scr_pm1 = np.asarray(scr_pm1, np.float32)
        self.scr_bits = (self.scr_pm1 < 0).astype(np.uint8)
        self.blk_crc = {int(k): np.asarray(m, np.uint8) for k, m in blk_crc.items()}
        self.tb_crc = np.asarray(tb_crc, np.uint8)
        self.n_re = len(self.re_idx)
        self.G = self.n_re * self.qm
        self.block_ks = p.block_ks
        self.e_offsets = np.concatenate(
            [[0], np.cumsum([len(r) for r in self.rm_idx])]).astype(np.int64)
        if self.e_offsets[-1] != self.G or len(self.scr_pm1) != self.G:
            raise ValueError("rate-matching maps / scrambling do not cover G")

        # K-groups (K- blocks first): one dematch table per group
        self.groups = []  # (k, first block, count, E lo, E hi, inverse index)
        b = 0
        for k in dict.fromkeys(p.block_ks):
            count = p.block_ks.count(k)
            d_len = 3 * (k + 4)
            idx = np.concatenate([j * d_len + self.rm_idx[b + j] for j in range(count)])
            self.groups.append((k, b, count, int(self.e_offsets[b]),
                                int(self.e_offsets[b + count]),
                                torch.as_tensor(ratematch.inverse_index(idx, count * d_len),
                                                device=dev)))
            b += count
        # int32 copies of the groups' inverse tables, as the demap kernel reads
        # them, and each code block's run of bits (ratematch.segment_ranges)
        self._inv32 = [g[5].to(torch.int32) for g in self.groups]
        self._ranges = [ratematch.segment_ranges(inv, count, hi - lo)
                        for (_, _, count, lo, hi, _), inv in zip(self.groups, self._inv32)]
        # TB bits (+ CRC24A) as positions in the concatenated hard blocks
        parts, off = [], 0
        for i, k in enumerate(p.block_ks):
            lo = p.f if i == 0 else 0
            hi = k if p.c == 1 else k - 24
            parts.append(np.arange(off + lo, off + hi))
            off += k
        self._tb_pos = torch.as_tensor(np.concatenate(parts), device=dev)
        self._re_idx = torch.as_tensor(self.re_idx, device=dev)
        self._scr = torch.as_tensor(self.scr_pm1, device=dev)
        self._blk_crc = {k: torch.as_tensor(m, dtype=torch.float32, device=dev)
                         for k, m in self.blk_crc.items()}
        self._tb_crc = torch.as_tensor(self.tb_crc, dtype=torch.float32, device=dev)

    @functools.cached_property
    def re_key(self) -> bytes:
        """A digest of the RE map, which keys ``equalized``'s CUDA graphs:
        codecs with equal maps extract the same REs."""
        return hashlib.blake2b(self.re_idx.tobytes(), digest_size=16).digest()

    # ------------------------------------------------------------------ TX
    def encode(self, payload: np.ndarray) -> np.ndarray:
        """TB payload bits [tbs] -> scrambled codeword bits [G] (host)."""
        if len(payload) != self.grant.tbs:
            raise ValueError(f"payload has {len(payload)} bits, TBS is {self.grant.tbs}")
        cw = np.concatenate([turbo.encode(blk).reshape(-1)[self.rm_idx[i]]
                             for i, blk in enumerate(segmentation.segment(payload))])
        return (cw ^ self.scr_bits).astype(np.uint8)

    def encode_symbols(self, payload: np.ndarray) -> np.ndarray:
        """TB payload -> modulated symbols [n_re] complex64 (host)."""
        return modulation.modulate_np(self.encode(payload), self.qm)

    def map_to_grid(self, grid: np.ndarray, symbols: np.ndarray) -> None:
        """In-place RE mapping into a [n_sym_sf, n_sc] numpy grid."""
        grid.reshape(-1)[self.re_idx] = symbols

    def map_to_grid_tm2(self, grids: list, symbols: np.ndarray) -> None:
        """2-port SFBC mapping (36.211 6.3.4.3) onto the per-port grids."""
        p0, p1 = equalize.alamouti_precode(symbols)
        grids[0].reshape(-1)[self.re_idx] = p0
        grids[1].reshape(-1)[self.re_idx] = p1

    # ------------------------------------------------------------------ RX
    def extract_re(self, grid: torch.Tensor) -> torch.Tensor:
        """[..., n_sym_sf, n_sc] -> [..., n_re]."""
        return grid.reshape(grid.shape[:-2] + (-1,))[..., self._re_idx]

    def demap_llrs(self, x_eq: torch.Tensor, nv_eff) -> torch.Tensor:
        """Equalized PDSCH symbols -> descrambled LLRs [..., G]."""
        return modulation.demodulate_soft(x_eq, self.qm, nv_eff) * self._scr

    def _filler(self, first: int, buf: torch.Tensor) -> torch.Tensor:
        if first == 0 and self.plan.f:
            buf[..., 0, :self.plan.f] += FILLER_LLR
        return buf

    def dematch(self, llrs: torch.Tensor) -> list[torch.Tensor]:
        """Descrambled LLRs [..., G] -> one softbuffer [..., count, 3(K+4)]
        per K-group, with the filler prior in block 0."""
        return [self._filler(first, ratematch.dematch(llrs[..., lo:hi], inv).reshape(
                    llrs.shape[:-1] + (count, 3 * (k + 4))))
                for k, first, count, lo, hi, inv in self.groups]

    def demap_dematch(self, x_eq: torch.Tensor, nv_eff) -> list[torch.Tensor]:
        """Equalized symbols [..., n_re] and their noise -> the softbuffers
        of ``dematch(demap_llrs(x_eq, nv_eff))``, bit for bit, by one
        ``ratematch.demap_dematch`` per K-group (on the card one launch of
        the demap kernel each, tiled by code block)."""
        with annotate("pdsch.demap_dematch"):
            return [self._filler(first, ratematch.demap_dematch(
                        x_eq, nv_eff, self.qm, self._scr, inv32, lo=lo, hi=hi,
                        ranges=ranges).reshape(x_eq.shape[:-1] + (count, 3 * (k + 4))))
                    for (k, first, count, lo, hi, _), inv32, ranges
                    in zip(self.groups, self._inv32, self._ranges)]

    def decode_blocks(self, groups: list[torch.Tensor]):
        """Softbuffer groups -> (hard [..., sum K] uint8, blk_ok [..., C]
        bool, iters [..., C] int32): the turbo decode of every block,
        forced (``turbo.decode_forced``) or masked with CRC freezing
        (``turbo.decode``), with the half-iteration kernel ``kernel``."""
        hards, oks, iters = [], [], []
        with annotate("pdsch.turbo"):
            for (k, _, count, *_), buf in zip(self.groups, groups):
                lead = buf.shape[:-2]
                d = buf.reshape(-1, 3, k + 4)
                if self.forced:
                    hard, it, ok = turbo.decode_forced(
                        d, k, self.n_turbo_iters, self._blk_crc[k], kernel=self.kernel)
                else:
                    hard, it, ok = turbo.decode(
                        d, k, self.n_turbo_iters, self._blk_crc[k],
                        early_exit=self.early_exit, kernel=self.kernel)
                hards.append(hard.reshape(lead + (count * k,)))
                oks.append(ok.reshape(lead + (count,)))
                iters.append(it.reshape(lead + (count,)))
            return torch.cat(hards, -1), torch.cat(oks, -1), torch.cat(iters, -1)

    def assemble_tb(self, hard: torch.Tensor, blk_ok: torch.Tensor):
        """Hard blocks -> (payload [..., tbs] uint8, tb_ok [...] bool); the
        TB CRC24A syndrome is an exact float32 product (TF32 off)."""
        tbs = self.grant.tbs
        with annotate("pdsch.tb_crc"):
            bits = hard[..., self._tb_pos]
            payload = bits[..., :tbs]
            if self.plan.c == 1:
                return payload, blk_ok[..., 0]
            syn = torch.remainder(torch.round(payload.to(torch.float32) @ self._tb_crc)
                                  + bits[..., tbs:].to(torch.float32), 2.0)
            return payload, (syn.sum(-1) == 0) & blk_ok.all(-1)

    def decode_softbuffers(self, groups: list[torch.Tensor]):
        """Softbuffer groups -> (payload [..., tbs] uint8, tb_ok [...] bool,
        blk_ok [..., C] bool, iters [..., C] int32)."""
        hard, blk_ok, iters = self.decode_blocks(groups)
        payload, tb_ok = self.assemble_tb(hard, blk_ok)
        return payload, tb_ok, blk_ok, iters

    def decode(self, x_eq: torch.Tensor, nv_eff):
        """Equalized symbols [..., n_re] and per-RE noise -> (payload,
        tb_ok, blk_ok, iters)."""
        return self.decode_softbuffers(self.demap_dematch(x_eq, nv_eff))


@functools.lru_cache(maxsize=64)
def codec(cell: Cell, grant: DlGrant, rnti: int, subframe: int, cfi: int = 1,
          n_turbo_iters: int = 8, device: str | torch.device = "cuda") -> PdschCodec:
    """The cached codec of one configuration (early exit, r2max), as the
    reference's ``codec`` getter, on `device`."""
    return PdschCodec(cell, grant, rnti, subframe, cfi, n_turbo_iters, device=device)


def equalized(cell: Cell, codec: PdschCodec, subframe: int, iq: torch.Tensor):
    """The grant-known receive front end of iq [B, sf_len]: OFDM demod ->
    CRS channel estimate (port 0) -> PDSCH RE extract -> ZF. Returns
    (x_eq, nv_eff, nvar, rsrp); ``codec.decode(x_eq, nv_eff)`` finishes the
    chain (``entry``, ``parallel.shard_decode``, ``bler.sweep_pdsch``). On a
    card the chain is replayed as one CUDA graph once this cell, subframe,
    RE map and input shape come back (``frontend.run``)."""
    with annotate("pdsch.frontend"):
        if iq.device.type != "cuda":
            return _equalized(cell, codec, subframe, iq)
        dev = iq.device
        return frontend.run(("pdsch.equalized", cell, subframe, codec.re_key),
                            lambda x: _equalized(cell, codec, subframe, x), (iq,), dev,
                            lambda: [chest.device_tables(cell, 0, subframe, dev), codec._re_idx])


def _equalized(cell: Cell, codec: PdschCodec, subframe: int, iq: torch.Tensor):
    grid = ofdm.demodulate(cell, iq)
    h, nvar, rsrp = chest.estimate(cell, grid, subframe, port=0)
    x_eq, nv_eff = equalize.zf(codec.extract_re(grid), codec.extract_re(h), nvar)
    return x_eq, nv_eff, nvar, rsrp
