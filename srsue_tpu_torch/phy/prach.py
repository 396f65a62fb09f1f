"""PRACH: Zadoff-Chu preambles and the eNB-side detector (36.211 5.7). The
port's own numpy copy of ``srsue_tpu/phy/prach.py`` (its reference), which
keeps PRACH on the host: the 64 preambles are made once per configuration
and detection is one matched filter over all 64 by FFT.

Format 0 (the FDD default): N_zc = 839, 1.25 kHz subcarrier spacing,
T_cp = 3168 Ts, T_seq = 24576 Ts (Ts = 1/30.72 MHz), 6 PRB wide.
"""

from __future__ import annotations

import functools

import numpy as np

from .cell import Cell

NZC = 839
# 36.211 Table 5.7.2-2: N_cs of zeroCorrelationZoneConfig (format 0, unrestricted set)
NCS_TABLE = [0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419]

T_SEQ = 24576  # in Ts (30.72 Msps)
T_CP = 3168


@functools.lru_cache(maxsize=64)
def root_sequence(u: int) -> np.ndarray:
    n = np.arange(NZC)
    return np.exp(-1j * np.pi * u * n * (n + 1) / NZC).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def _logical_table() -> tuple[int, ...]:
    """Logical -> physical root order: the (u, NZC - u) pairs in order of u,
    which has the structure of 36.211 Table 5.7.2-4 (the reference's
    stand-in for the table's own sequence)."""
    return tuple(v for u in range(1, (NZC + 1) // 2) for v in (u, NZC - u))


def _logical_to_physical(logical: int) -> int:
    return _logical_table()[logical % (NZC - 1)]


@functools.lru_cache(maxsize=16)
def preamble_table(root_seq_index: int, zero_corr_config: int) -> np.ndarray:
    """[64, 839] preambles x_{u,v} in the logical order of 36.211 5.7.2:
    the cyclic shifts of one root, then the next root."""
    ncs = NCS_TABLE[zero_corr_config]
    n_shifts = max(1, NZC // ncs) if ncs else 1
    rows = []
    logical = root_seq_index
    while len(rows) < 64:
        x_u = root_sequence(_logical_to_physical(logical))
        rows += [np.roll(x_u, -v * ncs) for v in range(min(n_shifts, 64 - len(rows)))]
        logical += 1
    return np.stack(rows).astype(np.complex64)


def _geometry(cell: Cell, freq_offset: int):
    """(n_seq, n_cp, the 839 bins of the n_seq-point grid) at the cell's
    sample rate: bin spacing srate / n_seq = 1.25 kHz, the preamble starting
    freq_offset PRBs from the band edge."""
    scale = cell.srate / 30.72e6
    n_seq, n_cp = int(T_SEQ * scale), int(T_CP * scale)
    k0 = int((freq_offset * 12 - cell.n_sc // 2) * 15000 / 1250) + 7
    return n_seq, n_cp, (np.arange(NZC) + k0) % n_seq


@functools.lru_cache(maxsize=32)
def waveform(cell: Cell, root_seq_index: int, zero_corr: int, preamble_idx: int,
             freq_offset: int = 0) -> np.ndarray:
    """The time-domain preamble with its CP at the cell's sample rate."""
    n_seq, n_cp, bins = _geometry(cell, freq_offset)
    assert abs(cell.srate / n_seq - 1250.0) < 1e-6
    fd = np.zeros(n_seq, np.complex64)
    fd[bins] = np.fft.fft(preamble_table(root_seq_index, zero_corr)[preamble_idx])
    td = np.fft.ifft(fd) * np.sqrt(n_seq / NZC)
    return np.concatenate([td[-n_cp:], td]).astype(np.complex64)


def detect(cell: Cell, rx: np.ndarray, root_seq_index: int, zero_corr: int,
           freq_offset: int = 0, threshold: float = 8.0):
    """eNB-side matched filter over all 64 preambles at once (a circular
    correlation by FFT): [(preamble index, peak / mean power, lag in
    samples)] of the preambles above `threshold` whose lag lies in their
    zero-correlation zone."""
    n_seq, n_cp, bins = _geometry(cell, freq_offset)
    y = np.fft.fft(rx[n_cp:n_cp + n_seq])[bins]
    xf = np.fft.fft(preamble_table(root_seq_index, zero_corr), axis=-1)
    power = np.abs(np.fft.ifft(y[None, :] * np.conj(xf), axis=-1)) ** 2
    noise = np.mean(power) + 1e-12
    ncs = NCS_TABLE[zero_corr] or NZC
    hits = []
    for p in range(64):
        pk = power[p].max() / noise
        lag = int(np.argmax(power[p]))
        if pk > threshold and (lag < ncs or lag > NZC - 3):
            hits.append((p, float(pk), lag))
    return hits
