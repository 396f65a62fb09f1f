"""eNodeB-side downlink subframe generation (host numpy): the test vectors
and benchmark inputs of the receive chain. Counterpart of
``srsue_tpu/phy/enb_tx.py`` for one antenna port (TM1), plus the full
control + data subframe (CRS, PCFICH, one PDCCH, PDSCH) that
``bench.build_clean`` assembles."""

from __future__ import annotations

import numpy as np

from . import control, ofdm, regrid, seq
from .cell import Cell
from .pdsch import PdschCodec


def empty_grid(cell: Cell) -> np.ndarray:
    return np.zeros((cell.n_sym_sf, cell.n_sc), dtype=np.complex64)


def add_crs(cell: Cell, grid: np.ndarray, subframe: int, port: int = 0) -> None:
    pos = regrid.crs_positions(cell, port, subframe)
    grid[pos[:, 0], pos[:, 1]] = regrid.crs_values(cell, port, subframe)


def add_sync(cell: Cell, grid: np.ndarray, subframe: int) -> None:
    """PSS + SSS in subframes 0 and 5."""
    if subframe not in (0, 5):
        return
    sc = regrid.sync_sc(cell)
    grid[regrid.pss_symbol(cell), sc] = seq.pss_freq(cell.n_id_2)
    grid[regrid.sss_symbol(cell), sc] = seq.sss_freq(cell.n_id_1, cell.n_id_2,
                                                     subframe == 5)


def build_pdsch_subframe(cell: Cell, codec: PdschCodec,
                         payload: np.ndarray) -> list[np.ndarray]:
    """Port-0 subframe grid with CRS (+ sync in subframes 0/5) and the
    PDSCH transport block; a one-element list like the reference's TM1."""
    sf = codec.subframe
    grid = empty_grid(cell)
    add_crs(cell, grid, sf, 0)
    add_sync(cell, grid, sf)
    codec.map_to_grid(grid, codec.encode_symbols(payload))
    return [grid]


def build_dl_subframe(cell: Cell, codec: PdschCodec, payload: np.ndarray, cfi: int,
                      dci_bits: np.ndarray, rnti: int, n_cce: int,
                      l_aggr: int) -> np.ndarray:
    """Port-0 grid of a control + data subframe: CRS, PCFICH with `cfi`, the
    DCI `dci_bits` for `rnti` on CCEs n_cce .. n_cce + l_aggr - 1, and the
    PDSCH transport block (the order of ``bench.build_clean``)."""
    sf = codec.subframe
    grid = empty_grid(cell)
    add_crs(cell, grid, sf, 0)
    control.pcfich_map(cell, grid, sf, cfi)
    control.pdcch_map(cell, grid, sf, cfi, dci_bits, rnti, n_cce, l_aggr)
    codec.map_to_grid(grid, codec.encode_symbols(payload))
    return grid


def awgn(rng: np.random.Generator, x: np.ndarray, snr_db: float,
         signal_power: float = 1.0) -> tuple[np.ndarray, float]:
    """Complex AWGN at an SNR relative to `signal_power`: (noisy, noise_var)."""
    nv = signal_power / (10 ** (snr_db / 10))
    n = (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)) * np.sqrt(nv / 2)
    return (x + n).astype(np.complex64), float(nv)


def to_waveform(cell: Cell, grids: list[np.ndarray]) -> list[np.ndarray]:
    """Per-port grids -> per-port time-domain subframes."""
    return [ofdm.modulate_np(cell, g) for g in grids]
