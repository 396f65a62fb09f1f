"""CRS channel estimation: LS at the pilots, delay-spread-adaptive pilot
FIR, frequency and time interpolation matrices, phase-aligned time
averaging, noise estimate. Counterpart of ``srsue_tpu/phy/chest.py`` with
its default behaviour (denoising, adaptive filter pick and time averaging
all on).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import regrid
from .cell import Cell


@functools.lru_cache(maxsize=256)
def _freq_interp_matrix(cell: Cell, port: int, crs_sym_i: int) -> np.ndarray:
    """W [n_sc, n_p]: linear interpolation (edge extrapolation) from this
    CRS symbol's pilot subcarriers to all subcarriers."""
    pos = regrid.crs_positions(cell, port, 0)
    sym = regrid.crs_symbols(cell, port)[crs_sym_i]
    ks = pos[pos[:, 0] == sym][:, 1].astype(np.float64)
    n_p = len(ks)
    w = np.zeros((cell.n_sc, n_p), dtype=np.float32)
    for k in range(cell.n_sc):
        j = int(np.searchsorted(ks, k))
        a, b = (0, 1) if j == 0 else (n_p - 2, n_p - 1) if j >= n_p else (j - 1, j)
        t = (k - ks[a]) / (ks[b] - ks[a])
        w[k, a] = 1.0 - t
        w[k, b] = t
    return w


@functools.lru_cache(maxsize=256)
def _time_interp_matrix(cell: Cell, port: int) -> np.ndarray:
    """W [n_sym_sf, n_crs_sym]: linear interpolation in time, clamped at
    the subframe edges."""
    ts = np.asarray(regrid.crs_symbols(cell, port), dtype=np.float64)
    n_t = len(ts)
    w = np.zeros((cell.n_sym_sf, n_t), dtype=np.float32)
    for s in range(cell.n_sym_sf):
        j = int(np.searchsorted(ts, s))
        if j == 0:
            w[s, 0] = 1.0
        elif j >= n_t:
            w[s, n_t - 1] = 1.0
        else:
            t = (s - ts[j - 1]) / (ts[j] - ts[j - 1])
            w[s, j - 1] = 1.0 - t
            w[s, j] = t
    return w


def _clamp_shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """x shifted by s along the pilot axis, edges repeated."""
    if s < 0:
        return torch.cat([x[..., :1].expand(x.shape[:-1] + (-s,)), x[..., :s]], -1)
    return torch.cat([x[..., s:], x[..., -1:].expand(x.shape[:-1] + (s,))], -1)


def _pilot_filter(h_sym: torch.Tensor, noise_var: torch.Tensor, n_eff: float):
    """Per batch element, the pilot-axis filter with the least estimated
    MSE among raw LS, 3-tap [1,2,1]/4 and 5-tap [1,2,2,2,1]/8.

    Noise gain per filter is known (1, 0.375, 0.21875 of sigma^2, divided
    by the n_eff symbols the time averaging later combines); bias is
    measured on the pilots with the known noise share subtracted. The
    noise measure is the phase-aligned difference of CRS symbols two apart
    (same subcarriers, static channel shape), independent of selectivity.
    Returns (filtered [..., n_crs, n_p], pick [...] in {0, 3, 5})."""
    fir3 = 0.25 * _clamp_shift(h_sym, -1) + 0.5 * h_sym + 0.25 * _clamp_shift(h_sym, 1)
    fir5 = (_clamp_shift(h_sym, -2) + 2.0 * _clamp_shift(h_sym, -1)
            + 2.0 * h_sym + 2.0 * _clamp_shift(h_sym, 1)
            + _clamp_shift(h_sym, 2)) / 8.0
    if h_sym.shape[-2] >= 4:
        a = h_sym[..., 0:2, :]
        b = h_sym[..., 2:4, :]
        corr = torch.sum(b * torch.conj(a), -1, keepdim=True)
        ph = corr / torch.clamp_min(torch.abs(corr), 1e-12)
        d = b * torch.conj(ph) - a
        nv = torch.mean(torch.abs(d) ** 2, dim=(-1, -2), keepdim=True) * 0.5
    else:
        nv = noise_var[..., None, None]
    d2 = h_sym[..., 2:] - 2.0 * h_sym[..., 1:-1] + h_sym[..., :-2]
    b3 = torch.clamp_min(
        torch.mean(torch.abs(d2) ** 2, dim=(-1, -2), keepdim=True) / 16.0
        - (6.0 / 16.0) * nv, 0.0)
    r5 = (fir5 - h_sym)[..., 2:-2]
    b5 = torch.clamp_min(
        torch.mean(torch.abs(r5) ** 2, dim=(-1, -2), keepdim=True)
        - 0.71875 * nv, 0.0)
    mse_raw = nv / n_eff
    mse3 = 0.375 * nv / n_eff + b3
    mse5 = 0.21875 * nv / n_eff + b5
    pick3 = (mse3 <= mse_raw) & (mse3 <= mse5)
    pick5 = (mse5 < mse_raw) & (mse5 < mse3)
    out = torch.where(pick5, fir5, torch.where(pick3, fir3, h_sym))
    pick = torch.where(pick5, 5, torch.where(pick3, 3, 0))[..., 0, 0]
    return out, pick


@functools.lru_cache(maxsize=64)
def device_tables(cell: Cell, port: int, subframe: int, device: torch.device):
    """Pilot flat indices, conj(refs), mean |refs|^2 and the frequency and
    time interpolation matrices on `device` (built once per configuration;
    a frontend's CUDA graph holds the ones it reads)."""
    pos = regrid.crs_positions(cell, port, subframe)
    refs = regrid.crs_values(cell, port, subframe)
    n_crs = len(regrid.crs_symbols(cell, port))
    flat_idx = torch.as_tensor(pos[:, 0].astype(np.int64) * cell.n_sc + pos[:, 1],
                               device=device)
    ref_conj = torch.as_tensor(np.conj(refs), device=device)
    ref_power = float(np.float32(np.mean(np.abs(refs) ** 2)))
    wf = [torch.as_tensor(np.ascontiguousarray(_freq_interp_matrix(cell, port, i).T),
                          device=device).to(torch.complex64) for i in range(n_crs)]
    wt = torch.as_tensor(_time_interp_matrix(cell, port), device=device).to(torch.complex64)
    return flat_idx, ref_conj, ref_power, wf, wt


def pilot_ls(cell: Cell, grid: torch.Tensor, subframe: int, port: int = 0):
    """LS estimates at the CRS pilots: [..., n_crs_sym, 2*n_prb]."""
    flat_idx, ref_conj, ref_power, wf, _ = device_tables(cell, port, subframe,
                                                        grid.device)
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    h_ls = flat[..., flat_idx] * ref_conj / ref_power
    return h_ls.reshape(h_ls.shape[:-1] + (len(wf), 2 * cell.n_prb))


def estimate(cell: Cell, grid: torch.Tensor, subframe: int, port: int = 0):
    """LS + adaptive FIR + 2D interpolation channel estimate for one port.

    grid: [..., n_sym_sf, n_sc] complex64.
    Returns (h [..., n_sym_sf, n_sc] complex64, noise_var [...] float32,
    rsrp [...] float32)."""
    _, _, _, wf, wt = device_tables(cell, port, subframe, grid.device)
    n_crs = len(wf)
    h_sym = pilot_ls(cell, grid, subframe, port)

    # noise: residual of LS pilots vs 3-tap smoothed pilots (2/3 of sigma^2
    # stays in the residual)
    h_smooth = (h_sym + torch.roll(h_sym, 1, -1) + torch.roll(h_sym, -1, -1)) / 3.0
    resid = (h_sym - h_smooth)[..., 1:-1]
    noise_var = torch.mean(torch.abs(resid) ** 2, dim=(-1, -2)) * 1.5

    n_eff = float(n_crs) if n_crs >= 2 else 1.0
    h_in, _ = _pilot_filter(h_sym, noise_var, n_eff)
    h_f = torch.stack([h_in[..., i, :] @ wf[i] for i in range(n_crs)], -2)

    if n_crs >= 2:
        # phase-align to the first CRS symbol, average the shape, restore
        # each symbol's phase (residual CFO / Doppler rotation is tracked)
        corr = torch.sum(h_f * torch.conj(h_f[..., :1, :]), -1, keepdim=True)
        ph = corr / torch.clamp_min(torch.abs(corr), 1e-12)
        h_f = torch.mean(h_f * torch.conj(ph), -2, keepdim=True) * ph

    h = wt @ h_f  # [n_sym, n_crs] @ [..., n_crs, n_sc]
    rsrp = torch.mean(torch.abs(h_sym) ** 2, dim=(-1, -2))
    return h.to(torch.complex64), noise_var.to(torch.float32), rsrp


def metrics(cell: Cell, grid: torch.Tensor, noise_var: torch.Tensor,
            rsrp: torch.Tensor) -> dict[str, torch.Tensor]:
    """RSSI / RSRQ / SNR / RSRP / noise per batch element."""
    rssi = torch.mean(torch.abs(grid) ** 2, dim=(-1, -2)) * cell.n_sc
    rsrq = 10.0 * torch.log10(cell.n_prb * rsrp / torch.clamp_min(rssi, 1e-12))
    snr_db = 10.0 * torch.log10(torch.clamp_min(
        rsrp / torch.clamp_min(noise_var, 1e-12), 1e-12))
    return {"rssi": rssi, "rsrq_db": rsrq, "snr_db": snr_db, "rsrp": rsrp,
            "noise": noise_var}
