"""Equalizers returning (x_hat, nv_eff): the equalized symbols and the
per-RE effective noise variance for the max-log demapper. Single-port ZF
and MMSE, and the 2-port Alamouti (SFBC, TM2) combiner with the
transmitters' host precoder. Counterpart of ``srsue_tpu/phy/equalize.py``."""

from __future__ import annotations

import math

import numpy as np
import torch


def _per_re(noise_var, like: torch.Tensor) -> torch.Tensor:
    """Per-batch noise [B] broadcast over every trailing data dim of `like`."""
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=like.device)
    while nv.ndim and nv.ndim < like.ndim:
        nv = nv[..., None]
    return nv


def zf(y: torch.Tensor, h: torch.Tensor, noise_var):
    """Zero-forcing: x = y/h, nv_eff = nv/|h|^2."""
    h2 = torch.clamp_min(torch.abs(h) ** 2, 1e-12)
    return y * torch.conj(h) / h2, _per_re(noise_var, h2) / h2


def mmse(y: torch.Tensor, h: torch.Tensor, noise_var):
    """MMSE with bias removal: w = h*/(|h|^2+nv), x = wy/(wh); the same
    decision metric as ZF in SISO, bounded amplification in deep fades."""
    h2 = torch.abs(h) ** 2
    nvb = _per_re(noise_var, h2)
    g = h2 / (h2 + nvb)
    x = y * torch.conj(h) / torch.clamp_min(h2 + nvb, 1e-12) / torch.clamp_min(g, 1e-6)
    return x, nvb / torch.clamp_min(h2, 1e-9)


def alamouti_combine(y: torch.Tensor, h0: torch.Tensor, h1: torch.Tensor, noise_var):
    """SFBC (TM2) combining over RE pairs.

    For the symbol pair (x0, x1) on REs (2i, 2i+1), port 0 sends
    (x0, x1)/sqrt(2) and port 1 (-x1*, x0*)/sqrt(2) (36.211 6.3.4.3).
    y [..., n_re] (n_re even, pairs adjacent), h0/h1 the per-port channel at
    the same REs, averaged over each pair; noise_var a scalar or [...] (it
    gains one trailing axis, no more). Returns (x_hat [..., n_re],
    nv_eff [..., n_re]) with nv_eff = 2 nv / (|g0|^2 + |g1|^2) on both REs
    of a pair."""
    y0, y1 = y[..., 0::2], y[..., 1::2]
    g0 = 0.5 * (h0[..., 0::2] + h0[..., 1::2])
    g1 = 0.5 * (h1[..., 0::2] + h1[..., 1::2])
    p = torch.clamp_min(torch.abs(g0) ** 2 + torch.abs(g1) ** 2, 1e-12)
    # r0 = (g0 x0 - g1 x1*)/sqrt2 ; r1 = (g0 x1 + g1 x0*)/sqrt2
    x0 = (torch.conj(g0) * y0 + g1 * torch.conj(y1)) / p * math.sqrt(2.0)
    x1 = (torch.conj(g0) * y1 - g1 * torch.conj(y0)) / p * math.sqrt(2.0)
    x = torch.stack([x0, x1], -1).reshape(y.shape)
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    nv_pair = 2.0 * (nv[..., None] if nv.ndim else nv) / p
    return x, torch.repeat_interleave(nv_pair, 2, -1).reshape(x.shape)


def alamouti_precode(sym: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Transmit-side SFBC precoding on the host, the convention
    ``alamouti_combine`` inverts: [..., n_sym] layer symbols (pairs
    adjacent) -> the two ports' RE streams, port 0 (x0, x1)/sqrt2 and port 1
    (-x1*, x0*)/sqrt2, complex64. Every 2-port transmitter of the port
    (PDSCH, PBCH, PCFICH, PHICH, PDCCH) precodes through it."""
    x0, x1 = sym[..., 0::2], sym[..., 1::2]
    s = 1.0 / np.sqrt(2.0)
    p0 = np.stack([x0, x1], axis=-1).reshape(sym.shape) * s
    p1 = np.stack([-np.conj(x1), np.conj(x0)], axis=-1).reshape(sym.shape) * s
    return p0.astype(np.complex64), p1.astype(np.complex64)
