"""OFDM modulation on the host (36.211 6.12): subcarrier placement with DC
skipped, a unitary IFFT (sqrt(nfft) after its 1/nfft), CP insertion. The
grid convention is ``[..., n_sym_sf, n_sc]``."""

from __future__ import annotations

import numpy as np

from .cell import Cell


def modulate_np(cell: Cell, grid: np.ndarray) -> np.ndarray:
    """Host OFDM modulator: [..., n_sym_sf, n_sc] -> [..., sf_len]."""
    nfft = cell.nfft
    half = cell.n_sc // 2
    fd = np.zeros(grid.shape[:-2] + (cell.n_sym_sf, nfft), dtype=np.complex64)
    fd[..., 1:half + 1] = grid[..., half:]
    fd[..., nfft - half:] = grid[..., :half]
    td = np.fft.ifft(fd, axis=-1).astype(np.complex64) * np.sqrt(nfft)
    pieces = []
    for s, cp in enumerate(list(cell.cp_lengths) * 2):
        sym = td[..., s, :]
        pieces += [sym[..., nfft - cp:], sym]
    return np.concatenate(pieces, axis=-1).astype(np.complex64)
