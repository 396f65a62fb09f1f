"""BLER-vs-SNR sweep of the PDSCH link: counterpart of
``srsue_tpu/phy/bler.py``.

Sweeps the whole TX -> AWGN -> RX chain of one (cell, MCS) over an SNR
grid. The transmitter is the host's (``enb_tx``) and draws its payloads
and noise from numpy in the reference's order, so that the same `seed`
gives both packages the same IQ; each SNR point is one batch of
independent subframes through the receive chain on `device` (OFDM demod,
channel estimate, ZF: ``pdsch.equalized``; ``PdschCodec.decode`` with CRC
early exit).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import enb_tx, ra
from .cell import Cell
from .pdsch import PdschCodec, equalized


@dataclass
class BlerPoint:
    snr_db: float
    bler: float
    n_blocks: int
    mean_iters: float


def sweep_pdsch(
    cell: Cell,
    mcs: int,
    snrs_db: list[float],
    n_sf_per_point: int = 8,
    subframe: int = 1,
    rnti: int = 0x1234,
    n_turbo_iters: int = 8,
    seed: int = 0,
    tm2: bool = False,
    device: str | torch.device = "cuda",
) -> list[BlerPoint]:
    rng = np.random.default_rng(seed)
    grant = ra.dl_grant(cell.n_prb, mcs)
    codec = PdschCodec(cell, grant, rnti, subframe, cfi=1,
                       n_turbo_iters=n_turbo_iters, device=device)

    # one TX batch reused across SNR points (noise is redrawn per point)
    payloads = np.stack([
        rng.integers(0, 2, grant.tbs).astype(np.uint8)
        for _ in range(n_sf_per_point)
    ])
    grids = [enb_tx.build_pdsch_subframe(cell, codec, pl, tm2=tm2) for pl in payloads]
    td = np.stack([enb_tx.to_waveform(cell, g)[0] for g in grids])
    if tm2:
        td = td + np.stack([enb_tx.to_waveform(cell, g)[1] for g in grids])
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc

    def rx(iq):
        x_eq, nv_eff, _, _ = equalized(cell, codec, subframe, iq)
        _, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
        # the mean as jnp.mean takes it: the float32 sum times 1/n
        return (tb_ok.to(torch.float32).sum(),
                iters.to(torch.float32).sum() * (1.0 / iters.numel()))

    out = []
    for snr in snrs_db:
        noisy, _ = enb_tx.awgn(rng, td, snr, signal_power=p_sig)
        n_ok, iters = rx(torch.as_tensor(noisy, device=codec.device))
        out.append(
            BlerPoint(
                snr_db=snr,
                bler=1.0 - float(n_ok) / n_sf_per_point,
                n_blocks=n_sf_per_point,
                mean_iters=float(iters),
            )
        )
    return out


def waterfall_snr(points: list[BlerPoint], target: float = 0.1) -> float | None:
    """Interpolated SNR where BLER crosses `target` (the waterfall)."""
    for a, b in zip(points, points[1:]):
        if a.bler >= target >= b.bler:
            if a.bler == b.bler:
                return a.snr_db
            t = (a.bler - target) / (a.bler - b.bler)
            return a.snr_db + t * (b.snr_db - a.snr_db)
    return None
