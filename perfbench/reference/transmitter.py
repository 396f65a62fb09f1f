"""The benchmark's transmitter: a configuration's downlink subframes, every
one with its own transport block, made on the host from the seed.

A subframe carries the CRS of every port, the PCFICH with the configured
CFI, one DCI 1A for the RNTI on the first search-space candidate with
L >= 4, and the PDSCH of the configured grant over the whole band: on one
port as it is, on two ports SFBC-precoded (36.211 6.3.4.3), control region
included, and the two ports summed. The noise is added on the device by
``add_noise`` from the seed as well.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lte import control, dci, ofdm, ra, regrid
from .lte.cell import Cell
from .lte.pdsch import PdschMap
from .lte.precode import alamouti_precode


@dataclasses.dataclass
class Clean:
    """Noise-free subframes of one configuration."""

    cell: Cell
    pdsch: PdschMap           # the grant's tables
    dci_bits: np.ndarray      # the DCI 1A payload
    payloads: np.ndarray      # [n, tbs] uint8, one transport block a subframe
    td: np.ndarray            # [n, sf_len] complex64
    p_sig: float              # signal power per used subcarrier


def cell_of(cfg: dict) -> Cell:
    return Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])


def dci_1a(cell: Cell, mcs: int) -> np.ndarray:
    """The DCI 1A payload of a whole-band grant at `mcs`, first HARQ
    process, new data, rv 0."""
    d = dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, cell.n_prb), mcs=mcs, harq_pid=0,
                  ndi=True, rv=0, tpc=0)
    return dci.pack_1a(cell.n_prb, d)


def control_grids(cell: Cell, cfg: dict, dci_bits: np.ndarray) -> list[np.ndarray]:
    """One grid per port holding the CRS, the PCFICH and the PDCCH."""
    sf, cfi, rnti = cfg["subframe"], cfg["cfi"], cfg["rnti"]
    n_cce, _ = control.pdcch_geometry(cell, cfi)
    start, l_aggr = [c for c in control.search_space_candidates(n_cce, rnti, sf)
                     if c[1] >= 4][0]
    grids = [np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64) for _ in range(cell.n_ports)]
    for p, grid in enumerate(grids):
        pos = regrid.crs_positions(cell, p, sf)
        grid[pos[:, 0], pos[:, 1]] = regrid.crs_values(cell, p, sf)
    if cell.n_ports == 2:
        control.pcfich_map_tm2(cell, grids, sf, cfi)
        control.pdcch_map_tm2(cell, grids, sf, cfi, dci_bits, rnti, start, l_aggr)
    else:
        control.pcfich_map(cell, grids[0], sf, cfi)
        control.pdcch_map(cell, grids[0], sf, cfi, dci_bits, rnti, start, l_aggr)
    return grids


def build(cfg: dict, seed: int, n: int) -> Clean:
    """`n` subframes, each with its own random transport block drawn from
    ``default_rng(seed)``."""
    cell = cell_of(cfg)
    grant = ra.dl_grant(cell.n_prb, cfg["mcs"])
    pdsch = PdschMap(cell, grant, cfg["rnti"], cfg["subframe"], cfg["cfi"])
    dci_bits = dci_1a(cell, cfg["mcs"])
    base = np.stack(control_grids(cell, cfg, dci_bits))  # [ports, n_sym, n_sc]
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 2, (n, grant.tbs), dtype=np.uint8)
    grids = np.repeat(base[None], n, axis=0)             # [n, ports, n_sym, n_sc]
    flat = grids.reshape(n, cell.n_ports, -1)
    syms = np.stack([pdsch.encode_symbols(p) for p in payloads])
    if cell.n_ports == 2:
        p0, p1 = alamouti_precode(syms)
        flat[:, 0, pdsch.re_idx] = p0
        flat[:, 1, pdsch.re_idx] = p1
    else:
        flat[:, 0, pdsch.re_idx] = syms
    td = ofdm.modulate_np(cell, grids).sum(axis=1).astype(np.complex64)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return Clean(cell, pdsch, dci_bits, payloads, td, p_sig)


def add_noise(clean: torch.Tensor, p_sig: float, snr_db: float,
              gen: torch.Generator) -> torch.Tensor:
    """clean [..., sf_len] complex64 plus complex AWGN at `snr_db` per used
    subcarrier, drawn from `gen` on clean's device."""
    nv = p_sig / 10.0 ** (snr_db / 10.0)
    noise = torch.randn(clean.shape + (2,), generator=gen, device=clean.device)
    return clean + torch.view_as_complex(noise * np.float32(np.sqrt(nv / 2.0)))
