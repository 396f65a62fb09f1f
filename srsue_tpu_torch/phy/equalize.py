"""Single-port equalizers returning (x_hat, nv_eff): the equalized symbols
and the per-RE effective noise variance for the max-log demapper.
Counterpart of ``srsue_tpu/phy/equalize.py`` (zf, mmse)."""

from __future__ import annotations

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
