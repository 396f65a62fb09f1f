"""The port's main path: the grant-known 20 MHz PDSCH receive chain.

Counterpart of ``__graft_entry__.entry()``: OFDM demod -> CRS channel
estimate -> ZF -> PDSCH extract / demap / descramble -> rate dematch ->
turbo decode (8 iterations: CRC early exit, all masked iterations, or
forced) -> TB CRC, batched over subframes. Configuration: 100 PRB SISO, cell 42,
subframe 6, MCS 28 (64QAM, TBS 75376, 13 code blocks of K=5824).
"""

from __future__ import annotations

import numpy as np
import torch

from srsue_tpu.phy.cell import Cell

from .phy import chest, enb_tx, equalize, ofdm, ra
from .phy.pdsch import PdschCodec

N_PRB, CELL_ID, SUBFRAME, MCS, RNTI = 100, 42, 6, 28, 0x1234


def stages(cell: Cell, codec: PdschCodec, subframe: int):
    """The chain's four stages, each a function of the previous one's
    output: frontend (OFDM demod, channel estimate, RE extract, ZF),
    demap + dematch, turbo decode, TB CRC."""

    def frontend(iq: torch.Tensor):
        grid = ofdm.demodulate(cell, iq)
        h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        return equalize.zf(codec.extract_re(grid), codec.extract_re(h), nvar)

    def demap_dematch(x_eq: torch.Tensor, nv_eff: torch.Tensor):
        return codec.dematch(codec.demap_llrs(x_eq, nv_eff))

    return frontend, demap_dematch, codec.decode_blocks, codec.assemble_tb


def chain(cell: Cell, codec: PdschCodec, subframe: int):
    """fn(iq [B, sf_len] complex64) -> (payload [B, tbs] uint8,
    tb_ok [B] bool, iters [B, C] int32)."""
    frontend, demap_dematch, turbo_decode, tb_crc = stages(cell, codec, subframe)

    def fn(iq: torch.Tensor):
        hard, blk_ok, iters = turbo_decode(demap_dematch(*frontend(iq)))
        payload, tb_ok = tb_crc(hard, blk_ok)
        return payload, tb_ok, iters

    return fn


def flagship(device: str | torch.device = "cuda", early_exit: bool = True,
             kernel: str = "r2max", forced: bool = False):
    """(cell, codec) of the flagship configuration on `device`; `kernel`,
    `early_exit` and `forced` choose the turbo decoder's form (PdschCodec)."""
    cell = Cell(n_prb=N_PRB, cell_id=CELL_ID)
    codec = PdschCodec(cell, ra.dl_grant(cell.n_prb, MCS), rnti=RNTI,
                       subframe=SUBFRAME, cfi=1, n_turbo_iters=8,
                       early_exit=early_exit, device=device, kernel=kernel,
                       forced=forced)
    return cell, codec


def make_waveforms(cell: Cell, codec: PdschCodec, rng: np.random.Generator,
                   batch: int, snr_db: float, n_distinct: int = 1):
    """Host test vectors: `n_distinct` random transport blocks, tiled over
    `batch` subframes, each with its own AWGN. Returns (noisy [batch,
    sf_len] complex64, payloads [batch, tbs] uint8). With batch = 1 this
    draws exactly what ``__graft_entry__.entry()`` draws from the same rng."""
    tbs = codec.grant.tbs
    pls = [rng.integers(0, 2, tbs).astype(np.uint8) for _ in range(n_distinct)]
    tds = np.stack([enb_tx.to_waveform(cell, enb_tx.build_pdsch_subframe(cell, codec, p))[0]
                    for p in pls])
    p_sig = float(np.mean(np.abs(tds) ** 2)) * cell.nfft / cell.n_sc
    sel = np.arange(batch) % n_distinct
    noisy, _ = enb_tx.awgn(rng, tds[sel], snr_db, signal_power=p_sig)
    return noisy, np.stack(pls)[sel]


def entry(device: str | torch.device = "cuda", batch: int = 1,
          snr_db: float = 26.0, early_exit: bool = True, seed: int = 0,
          n_distinct: int = 1, kernel: str = "r2max", forced: bool = False):
    """(fn, (iq,), payloads): the flagship step, its input on `device` and
    the transmitted payloads [batch, tbs] (numpy) to check it against."""
    cell, codec = flagship(device, early_exit, kernel, forced)
    noisy, payloads = make_waveforms(cell, codec, np.random.default_rng(seed),
                                     batch, snr_db, n_distinct)
    iq = torch.as_tensor(noisy, device=codec.device)
    return chain(cell, codec, SUBFRAME), (iq,), payloads
