"""Cell search and synchronisation: PSS/SSS detection, timing and CFO
estimation (36.211 6.11). Counterpart of ``srsue_tpu/phy/sync.py``.

* PSS search: circular cross-correlation against the 3 root replicas in
  the frequency domain (``torch.fft``), batched over roots and search
  windows, then a normalised peak pick;
* SSS identification: one [62] x [62, 336] real product over every
  candidate (N_id_1, half-frame) sequence, then an argmax;
* CFO: cyclic-prefix autocorrelation (fractional CFO in subcarrier units);
  the correction is one complex rotation;
* decimation to the 1.92 Msps search rate: a 47-tap windowed-sinc FIR as a
  strided convolution, so only the kept outputs are computed.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import seq

SEARCH_NFFT = 128  # the PSS search runs at 1.92 Msps (6 PRB geometry)


@functools.lru_cache(maxsize=8)
def pss_time_replica(n_id_2: int, nfft: int = SEARCH_NFFT) -> np.ndarray:
    """Time-domain PSS replica of length nfft (unit energy)."""
    fd = np.zeros(nfft, np.complex64)
    d = seq.pss_freq(n_id_2)
    fd[1:32] = d[31:]
    fd[nfft - 31:] = d[:31]
    td = np.fft.ifft(fd).astype(np.complex64)
    return (td / np.linalg.norm(td)).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _replica_spectra(n: int, nfft: int, device: torch.device) -> torch.Tensor:
    """[3, n] spectra of the reversed conjugate replicas, zero-padded to n."""
    reps = np.stack([np.concatenate([np.conj(pss_time_replica(r, nfft))[::-1],
                                     np.zeros(n - nfft, np.complex64)]) for r in range(3)])
    return torch.fft.fft(torch.as_tensor(reps, device=device), dim=-1)


def pss_correlate(samples: torch.Tensor, nfft: int = SEARCH_NFFT) -> torch.Tensor:
    """Normalised PSS correlation magnitudes for all 3 roots.

    samples: [..., n] complex64 at the search rate. Returns [..., 3, n]
    float32 where entry t is the correlation of the window starting at t
    (circular at the tail), over the global RMS of `samples`."""
    n = samples.shape[-1]
    r_f = _replica_spectra(n, nfft, samples.device)
    # out[t] = sum_k x[t+k] conj(rep[k]): spectral product, then the shift
    corr = torch.fft.ifft(torch.fft.fft(samples, dim=-1)[..., None, :] * r_f, dim=-1)
    corr = torch.roll(corr, -(nfft - 1), -1)
    rms = torch.sqrt(torch.mean(torch.abs(samples) ** 2, -1) + 1e-12)
    return torch.abs(corr) / (rms[..., None, None] * math.sqrt(nfft))


def find_pss(samples: torch.Tensor, nfft: int = SEARCH_NFFT):
    """Peak pick over roots x time: (n_id_2, t_peak, peak_value) tensors,
    [...]-shaped for batched input."""
    c = pss_correlate(samples, nfft)
    n = c.shape[-1]
    peak, idx = c.reshape(c.shape[:-2] + (-1,)).max(-1)
    return idx // n, idx % n, peak


def cfo_estimate_cp(samples: torch.Tensor, nfft: int, cp: int) -> torch.Tensor:
    """Fractional CFO (in subcarrier units) from the CP autocorrelation of
    the leading OFDM symbol of `samples` [..., >= nfft + cp]."""
    r = torch.sum(samples[..., nfft: nfft + cp] * torch.conj(samples[..., :cp]), -1)
    return torch.angle(r) / (2 * np.pi)


def cfo_correct(samples: torch.Tensor, cfo, nfft: int) -> torch.Tensor:
    """Rotate out a CFO given in subcarrier units at the array's rate; the
    phase is float32, in the reference's order (-2 pi cfo t / nfft)."""
    t = torch.arange(samples.shape[-1], dtype=torch.float32, device=samples.device)
    c = torch.as_tensor(cfo, dtype=torch.float32, device=samples.device)
    ph = -2.0 * np.pi * c[..., None] * t / nfft
    return samples * torch.polar(torch.ones_like(ph), ph)


@functools.lru_cache(maxsize=4)
def _sss_bank() -> np.ndarray:
    """[3, 62, 336] matched-filter bank: for each n_id_2, the columns are
    the candidate SSS sequences for (n_id_1 in 0..167) x (sf0, sf5)."""
    bank = np.zeros((3, 62, 336), np.float32)
    for nid2 in range(3):
        for nid1 in range(168):
            bank[nid2, :, nid1] = seq.sss_freq(nid1, nid2, False)
            bank[nid2, :, 168 + nid1] = seq.sss_freq(nid1, nid2, True)
    return bank


@functools.lru_cache(maxsize=16)
def _sss_bank_tensor(n_id_2: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_sss_bank()[n_id_2], device=device)


def sss_identify(sss_fd: torch.Tensor, n_id_2: int):
    """N_id_1 and the half-frame from the 62 SSS subcarriers.

    sss_fd: [..., 62] frequency-domain SSS REs, equalized by the PSS channel
    estimate (coherent) or raw (enough at high SNR). Returns (n_id_1,
    is_sf5, score) tensors."""
    m = torch.abs(sss_fd.real @ _sss_bank_tensor(int(n_id_2), sss_fd.device))
    score, best = m.max(-1)
    return best % 168, best >= 168, score


def sss_coherent(pss_fd: torch.Tensor, sss_fd: torch.Tensor, n_id_2: int):
    """Coherent SSS identification: the SSS REs equalized with the channel
    estimated from the PSS symbol, one OFDM symbol later."""
    d = torch.as_tensor(seq.pss_freq(int(n_id_2)), device=pss_fd.device)
    h = pss_fd * torch.conj(d)  # channel * |d|^2 (|d| = 1)
    return sss_identify(sss_fd * torch.conj(h), n_id_2)


@functools.lru_cache(maxsize=16)
def _lpf_taps(decim: int, ntaps: int = 47) -> np.ndarray:
    """Windowed-sinc low-pass for decimation by `decim` (cutoff at the
    6 PRB band edge with a transition margin)."""
    if decim == 1:
        return np.array([1.0], np.float32)
    cutoff = 0.45 / decim
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def decimate(samples: torch.Tensor, decim: int) -> torch.Tensor:
    """FIR low-pass and downsample: [..., n] complex64 -> [..., ceil(n /
    decim)]. Output j is the filter centred on input j * decim (zeros past
    both ends); a correlation with stride `decim` over the real and the
    imaginary part computes the kept outputs only."""
    if decim == 1:
        return samples
    taps = torch.as_tensor(_lpf_taps(decim), device=samples.device)
    k = len(taps)
    lead = samples.shape[:-1]
    x = torch.view_as_real(samples.reshape(-1, samples.shape[-1])).permute(0, 2, 1)
    x = x.reshape(-1, 1, samples.shape[-1])  # [rows * (re, im), 1, n]
    y = torch.nn.functional.conv1d(torch.nn.functional.pad(x, (k // 2, k - 1 - k // 2)),
                                   taps.view(1, 1, k), stride=decim)
    y = y.reshape(-1, 2, y.shape[-1]).permute(0, 2, 1).contiguous()
    return torch.view_as_complex(y).reshape(lead + (y.shape[-2],))
