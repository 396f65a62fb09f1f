"""The port's main path: the grant-known 20 MHz PDSCH receive chain.

Counterpart of ``__graft_entry__.entry()``: OFDM demod -> CRS channel
estimate -> ZF -> PDSCH extract / demap / descramble -> rate dematch ->
turbo decode (8 iterations: CRC early exit, all masked iterations, or
forced) -> TB CRC, batched over subframes. Configuration: 100 PRB SISO, cell 42,
subframe 6, MCS 28 (64QAM, TBS 75376, 13 code blocks of K=5824).

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: one step of each sharded path on `n`
ranks (``parallel``).
"""

from __future__ import annotations

import numpy as np
import torch

from .phy import enb_tx, ra
from .phy.cell import Cell
from .phy.pdsch import PdschCodec, equalized

N_PRB, CELL_ID, SUBFRAME, MCS, RNTI = 100, 42, 6, 28, 0x1234


def stages(cell: Cell, codec: PdschCodec, subframe: int):
    """The chain's four stages, each a function of the previous one's
    output: frontend (OFDM demod, channel estimate, RE extract, ZF),
    demap + dematch, turbo decode, TB CRC."""

    def frontend(iq: torch.Tensor):
        return equalized(cell, codec, subframe, iq)[:2]

    def demap_dematch(x_eq: torch.Tensor, nv_eff: torch.Tensor):
        return codec.demap_dematch(x_eq, nv_eff)

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
    sf_len] complex64, payloads [batch, tbs] uint8, clean [batch, sf_len]).
    With batch = 1 this draws exactly what ``__graft_entry__.entry()`` draws
    from the same rng; with n_distinct = batch, what its
    ``dryrun_multichip`` draws."""
    tbs = codec.grant.tbs
    pls = [rng.integers(0, 2, tbs).astype(np.uint8) for _ in range(n_distinct)]
    tds = np.stack([enb_tx.to_waveform(cell, enb_tx.build_pdsch_subframe(cell, codec, p))[0]
                    for p in pls])
    p_sig = float(np.mean(np.abs(tds) ** 2)) * cell.nfft / cell.n_sc
    sel = np.arange(batch) % n_distinct
    noisy, _ = enb_tx.awgn(rng, tds[sel], snr_db, signal_power=p_sig)
    return noisy, np.stack(pls)[sel], tds[sel]


def entry(device: str | torch.device = "cuda", batch: int = 1,
          snr_db: float = 26.0, early_exit: bool = True, seed: int = 0,
          n_distinct: int = 1, kernel: str = "r2max", forced: bool = False):
    """(fn, (iq,), payloads): the flagship step, its input on `device` and
    the transmitted payloads [batch, tbs] (numpy) to check it against."""
    cell, codec = flagship(device, early_exit, kernel, forced)
    noisy, payloads, _ = make_waveforms(cell, codec, np.random.default_rng(seed),
                                        batch, snr_db, n_distinct)
    iq = torch.as_tensor(noisy, device=codec.device)
    return chain(cell, codec, SUBFRAME), (iq,), payloads


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> list[dict]:
    """One step of every sharded path on `n_devices` spawned ranks (NCCL, one
    per GPU, on "cuda"; gloo on "cpu"), with the shapes, draws and checks of
    ``__graft_entry__.dryrun_multichip``: B = 2n subframes of 1.4 MHz QPSK
    (6 PRB, MCS 5, subframe 1, 4 turbo iterations, 20 dB) sharded by
    carrier, every TB passing bit-exact with n_ok == B; a time-sharded front
    end step; a window-sharded turbo decode of K = 128n; one flagship
    carrier per rank (100 PRB, MCS 28, 2 masked iterations). Raises on a
    wrong result; returns each rank's summary and kernel launches."""
    from .parallel import mesh, ranks

    out = mesh.launch(ranks.dryrun, n_devices, device)
    r0 = out[0]
    print(f"dryrun_multichip({n_devices}, {device}): {r0['carriers']} carriers decoded across "
          f"{n_devices} ranks (all CRC pass, mean SNR {r0['snr']:.1f} dB); time-shard halo "
          f"frontend ok; window-sharded turbo " + ("ok" if r0["turbo"] else "skipped (K > 6144)")
          + f"; FLAGSHIP 20 MHz max-TBS ({n_devices} carriers x TBS {r0['tbs_flagship']}, 13 "
          "codeblocks) sharded decode ok")
    return out
