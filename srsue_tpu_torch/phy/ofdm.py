"""OFDM demodulation (CP removal, FFT, used-subcarrier pick) and
modulation (subcarrier placement, IFFT, CP insertion), on a tensor's device
and as host numpy copies. Counterpart of ``srsue_tpu/phy/ofdm.py``; the
grid convention is ``[..., n_sym_sf, n_sc]`` with DC skipped (36.211 6.12),
and both directions are unitary (the FFT scaled by 1/sqrt(nfft), the IFFT
by sqrt(nfft) after its 1/nfft).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cell import Cell


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


def demodulate_np(cell: Cell, sf_samples: np.ndarray) -> np.ndarray:
    """Host OFDM demodulator, a numpy copy of the reference's
    ``demodulate_np``: [..., sf_len] -> [..., n_sym_sf, n_sc] complex64."""
    nfft = cell.nfft
    half = cell.n_sc // 2
    sym_td = np.stack([sf_samples[..., s:s + nfft] for s in symbol_starts(cell)], axis=-2)
    sym_fd = np.fft.fft(sym_td, axis=-1) / np.sqrt(nfft)
    return np.concatenate([sym_fd[..., nfft - half:], sym_fd[..., 1:half + 1]],
                          axis=-1).astype(np.complex64)


def modulate(cell: Cell, grid: torch.Tensor) -> torch.Tensor:
    """OFDM modulator on the grid's device: [..., n_sym_sf, n_sc] complex ->
    [..., sf_len] complex64. Subcarriers half.. go to bins 1..half and
    0..half-1 to bins nfft-half.., DC and the guard bins stay zero; each
    symbol is led by the last cp samples of itself."""
    nfft = cell.nfft
    half = cell.n_sc // 2
    grid = grid.to(torch.complex64)
    fd = grid.new_zeros(grid.shape[:-2] + (cell.n_sym_sf, nfft))
    fd[..., 1:half + 1] = grid[..., half:]
    fd[..., nfft - half:] = grid[..., :half]
    td = torch.fft.ifft(fd, dim=-1) * np.sqrt(nfft)
    pieces = []
    for s, cp in enumerate(list(cell.cp_lengths) * 2):
        sym = td[..., s, :]
        pieces += [sym[..., nfft - cp:], sym]
    return torch.cat(pieces, dim=-1).to(torch.complex64)
