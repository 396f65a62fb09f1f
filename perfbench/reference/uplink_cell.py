"""The plain reference of a loaded uplink subframe: an eNB's PUSCH receive of
several UEs that share one cell's subframe, each on its own band, with its
transmitter. Numpy float64 on the CPU, written apart from the port; it
shares with ``uplink.py`` its encoder and its one-UE receiver.

``build(cfg, seed, n)`` makes `n` subframes. Each UE of ``cfg["ues"]`` (in
order) draws its transport blocks, CQIs and ACK bits from one
``default_rng(seed)`` as ``uplink.build`` draws one UE's, is encoded and
DFT-precoded as there, and goes with its DMRS onto its own band of the
cell's grid; the grid is OFDM-modulated once, which is the sum of the UEs'
time-domain subframes.

``Receiver(cfg).pusch(iq, noise_var)`` decodes each UE on its own, as an
eNB with one ``uplink.Receiver`` per UE would: its own OFDM demodulation,
DMRS estimate, ZF, IDFT, demap, dematch, turbo decode and UCI. ``uplink.py``
takes the cell's width from the allocation's (``cell_of`` and ``pusch_map``
both read ``n_prb``), so this file builds the cell and each allocation's
``PuschMap`` itself.

``q`` rounds every stage's output, as in ``receiver.py``: ``exact`` keeps
the values, ``bf16`` is the control a comparison has to fail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .lte.cell import Cell
from .lte.ofdm import modulate_np
from .lte.pusch import DMRS_SYMS, PuschMap, dmrs
from .receiver import exact
from .uplink import Decoded
from .uplink import Receiver as UeReceiver


@dataclasses.dataclass
class Clean:
    """Noise-free subframes of every UE of one configuration."""

    cell: Cell
    pmaps: list               # each UE's PuschMap
    payloads: list            # each UE's [n, tbs] uint8
    cqi: list                 # each UE's [n, A] uint8
    ack: list                 # each UE's [n] bool
    td: np.ndarray            # [n, sf_len] complex64
    p_sig: float              # signal power per allocated subcarrier

    def noise_var(self, snr_db: float) -> float:
        """The AWGN's variance per subcarrier at `snr_db`, the noise floor
        the eNB's receiver is told."""
        return self.p_sig / 10.0 ** (snr_db / 10.0)


def cell_of(cfg: dict) -> Cell:
    return Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])


def pusch_map(cfg: dict, ue: dict) -> PuschMap:
    return PuschMap(ue["n_prb"], ue["prb_start"], ue["qm"], ue["tbs"], ue["rnti"],
                    cfg["subframe"], cfg["cell_id"], ue["cqi_bits"], ue["cqi_repetition"],
                    ue["ack_symbols"], cfg["rv"])


def build(cfg: dict, seed: int, n: int) -> Clean:
    """`n` subframes, each UE with its own transport block, CQI and ACK in
    each."""
    cell = cell_of(cfg)
    rng = np.random.default_rng(seed)
    grid = np.zeros((n, cell.n_sym_sf, cell.n_sc), np.complex128)
    data_syms = [s for s in range(cell.n_sym_sf) if s not in DMRS_SYMS]
    pmaps, payloads, cqis, acks = [], [], [], []
    for ue in cfg["ues"]:
        pm = pusch_map(cfg, ue)
        payload = rng.integers(0, 2, (n, pm.tbs), dtype=np.uint8)
        cqi = rng.integers(0, 2, (n, ue["cqi_bits"]), dtype=np.uint8)
        ack = rng.integers(0, 2, n).astype(bool)
        stream = np.stack([pm.encode_stream(p, c, a) for p, c, a in zip(payload, cqi, ack)])
        band = slice(pm.sc0, pm.sc0 + pm.m_sc)
        grid[:, data_syms, band] = np.fft.fft(stream.reshape(n, -1, pm.m_sc),
                                              axis=-1) / np.sqrt(pm.m_sc)
        grid[:, list(DMRS_SYMS), band] = dmrs(cell.cell_id, pm.m_sc, ue["cyclic_shift"])
        pmaps.append(pm)
        payloads.append(payload)
        cqis.append(cqi)
        acks.append(ack)
    td = modulate_np(cell, grid)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / sum(pm.m_sc for pm in pmaps)
    return Clean(cell, pmaps, payloads, cqis, acks, td, p_sig)


class _Allocation(UeReceiver):
    """``uplink.Receiver`` on one allocation of a wider cell."""

    def __init__(self, cfg: dict, cell: Cell, ue: dict):
        self.cfg, self.cell = cfg, cell
        self.pmap = pusch_map(cfg, ue)
        self.ref = np.conj(dmrs(cfg["cell_id"], self.pmap.m_sc, ue["cyclic_shift"]))


class Receiver:
    """The eNB's PUSCH receive of every UE of one configuration (a dict as in
    ``configs/<name>.json``, its UEs under ``ues``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.cell = cell_of(cfg)
        self.ues = [_Allocation(cfg, self.cell, ue) for ue in cfg["ues"]]

    def pusch(self, iq, noise_var: float, q=exact) -> list[Decoded]:
        """iq [n, sf_len] -> each UE's transport blocks, CRC flags, turbo
        iterations, CQI, ACK and softbuffers, each UE decoded on its own."""
        return [ue.pusch(iq, noise_var, q) for ue in self.ues]
