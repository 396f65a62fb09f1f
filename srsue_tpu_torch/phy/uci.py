"""UCI coding: the CQI block code RM(20, A) (36.212 5.2.3.3) and its PUCCH
format 2 carrier (36.211 5.4.2). The port's own numpy copy of
``srsue_tpu/phy/uci.py`` (its reference), built on the port's ``pucch``,
``modulation`` and ``seq``.

The (20, A <= 13) code of 36.212 Table 5.2.3.3-1; decoding is one
correlation against all 2^A codewords (ML; A <= 11 for CQI): on the host
(``rm20_decode``), or for a batch of words on their tensors' device
(``rm20_sums`` then ``rm20_decode_t``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modulation, seq as seqmod
from .cell import Cell
from .pucch import _shifted, pucch_prb

# 36.212 Table 5.2.3.3-1: basis sequences M_{i,n}, i = 0..19, n = 0..12
RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], dtype=np.uint8)


def rm20_encode(bits: np.ndarray) -> np.ndarray:
    """[A <= 13] information bits -> [20] codeword."""
    a = np.asarray(bits, np.uint8).ravel()
    assert len(a) <= 13
    return (RM20_BASIS[:, :len(a)] @ a % 2).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def _codebook(n_bits: int) -> np.ndarray:
    """[2^A, 20] +-1 codebook of the ML correlation decoder."""
    words = np.arange(1 << n_bits)
    bits = (words[:, None] >> np.arange(n_bits)[None, :]) & 1
    return (1.0 - 2.0 * ((bits @ RM20_BASIS[:, :n_bits].T) % 2)).astype(np.float32)


def rm20_decode(llrs: np.ndarray, n_bits: int) -> tuple[np.ndarray, float]:
    """ML decode by correlation with all 2^A codewords (LLR > 0 = bit 0 ->
    +1): (bits [A] uint8, the winning score)."""
    scores = _codebook(n_bits) @ np.asarray(llrs, np.float32)
    w = int(np.argmax(scores))
    return ((w >> np.arange(n_bits)) & 1).astype(np.uint8), float(scores[w])


def rm20_sums(llrs: torch.Tensor) -> torch.Tensor:
    """[..., n] LLRs of a codeword repeated circularly -> [..., 20]: LLR i
    added into position i mod 20, on the LLRs' device."""
    x = torch.nn.functional.pad(llrs, (0, -llrs.shape[-1] % 20))
    return x.reshape(llrs.shape[:-1] + (-1, 20)).sum(-2)


@functools.lru_cache(maxsize=16)
def _codebook_t(n_bits: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The transposed codebook [20, 2^A] and the bit shifts [A] on `device`."""
    return (torch.as_tensor(_codebook(n_bits).T.copy(), device=device),
            torch.arange(n_bits, device=device))


def rm20_decode_t(sums: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[..., 20] summed LLRs -> [..., A] uint8 bits on their device: the
    ML codeword, by one product with the +-1 codebook and its argmax (the
    first on a tie, as ``rm20_decode``)."""
    book_t, shifts = _codebook_t(n_bits, sums.device)
    w = torch.argmax(sums.to(torch.float32) @ book_t, -1, keepdim=True)
    return ((w >> shifts) & 1).to(torch.uint8)


# ---------------------------------------------------------------------------
# PUCCH format 2: 20 coded bits -> QPSK -> 10 cyclically shifted sequences
# ---------------------------------------------------------------------------

F2_DATA_SYMS = (0, 2, 3, 4, 6)  # per slot, normal CP (RS in symbols 1 and 5)
F2_RS_SYMS = (1, 5)


def _f2_scramble(cell: Cell, subframe: int) -> np.ndarray:
    """The cell and subframe's Gold sequence that format 2 is scrambled with
    here (the reference's cell-level choice, not the spec's RNTI-based one)."""
    return seqmod.prs(((subframe + 1) * (2 * cell.cell_id + 1) << 9) + cell.cell_id, 20)


def encode_format2(cell: Cell, subframe: int, n_pucch: int,
                   cqi_bits: np.ndarray) -> np.ndarray:
    """CQI payload -> the subframe's [n_sym_sf, n_sc] grid contribution,
    zero elsewhere: RM(20, A), scrambled, 10 QPSK symbols on the data
    symbols' sequences."""
    d = modulation.modulate_np(rm20_encode(cqi_bits) ^ _f2_scramble(cell, subframe), 2)
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    m = n_pucch % 12  # resource index -> cyclic shift offset (simplified)
    di = 0
    for slot in range(2):
        sc0 = pucch_prb(cell, n_pucch, slot) * 12
        for l in F2_DATA_SYMS:
            y = d[di] * _shifted(cell, subframe, slot, l, m)
            grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12] = y / np.sqrt(12)
            di += 1
        for l in F2_RS_SYMS:
            grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12] = (
                _shifted(cell, subframe, slot, l, m) / np.sqrt(12))
    return grid


def decode_format2(cell: Cell, grid: np.ndarray, subframe: int, n_pucch: int,
                   n_bits: int) -> tuple[np.ndarray, float]:
    """eNB side: coherent demodulation on the RS estimate of each slot, then
    RM(20, A) ML."""
    m = n_pucch % 12
    soft = np.zeros(10, np.complex64)
    di = 0
    for slot in range(2):
        sc0 = pucch_prb(cell, n_pucch, slot) * 12
        h = 0j
        for l in F2_RS_SYMS:
            h += np.vdot(_shifted(cell, subframe, slot, l, m),
                         grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12])
        for l in F2_DATA_SYMS:
            corr = np.vdot(_shifted(cell, subframe, slot, l, m),
                           grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12])
            soft[di] = corr * np.conj(h)
            di += 1
    # QPSK -> LLRs (positive = bit 0), then descramble
    llr = np.zeros(20, np.float32)
    llr[0::2] = np.real(soft) * np.sqrt(2)
    llr[1::2] = np.imag(soft) * np.sqrt(2)
    return rm20_decode(llr * (1.0 - 2.0 * _f2_scramble(cell, subframe)), n_bits)
