"""OFDM demodulation (CP removal, FFT, used-subcarrier pick) and the host
modulator used to make test vectors. Counterpart of
``srsue_tpu/phy/ofdm.py``; the grid convention is ``[..., n_sym_sf, n_sc]``
with DC skipped (36.211 6.12).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsue_tpu.phy.cell import Cell


@functools.lru_cache(maxsize=32)
def symbol_starts(cell: Cell) -> tuple[int, ...]:
    """Start sample of each OFDM symbol's data part (after its CP)."""
    starts = []
    t = 0
    for _slot in range(2):
        for cp in cell.cp_lengths:
            t += cp
            starts.append(t)
            t += cell.nfft
    assert t == cell.sf_len
    return tuple(starts)


def demodulate(cell: Cell, sf_samples: torch.Tensor) -> torch.Tensor:
    """[..., sf_len] complex64 -> [..., n_sym_sf, n_sc] complex64."""
    nfft = cell.nfft
    half = cell.n_sc // 2
    sym_td = torch.stack(
        [sf_samples[..., s:s + nfft] for s in symbol_starts(cell)], dim=-2)
    sym_fd = torch.fft.fft(sym_td, dim=-1) * (1.0 / np.sqrt(nfft))
    # sc 0..half-1 <- bins nfft-half.., sc half.. <- bins 1..half
    return torch.cat([sym_fd[..., nfft - half:], sym_fd[..., 1:half + 1]],
                     dim=-1).to(torch.complex64)


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
