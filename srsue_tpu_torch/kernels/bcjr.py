"""Windowed max-log-MAP BCJR half-iteration: the wrapper of the Hopper
kernel ``csrc/bcjr_half.cu`` and its plain PyTorch twin.

The kernel replaces ``srsue_tpu/phy/turbo_pallas.py::_half_kernel_v4``
(launched by ``half_tiled``); ``bcjr_half_windowed`` takes the contract of
``srsue_tpu/phy/turbo.py::_bcjr_half_windowed`` ([B, K] LLRs, [B, W, 8]
window boundaries) as ``bcjr_half_windowed_pallas`` does: it injects the
known start state and the tail beta, runs the [B*W, lw] half-iteration and
returns the boundaries shifted for next-iteration initialisation (NII).
With W = 1 (lw = K) the same function is the unwindowed
``turbo._bcjr_half``.

A CPU tensor goes to the plain twin; a CUDA tensor launches the kernel or
raises. ``bcjr_half_windowed.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..phy import turbo

_F32 = torch.float32


@functools.lru_cache(maxsize=16)
def _plain_tables(device: torch.device):
    """Sign tables of gamma for the forward (predecessor) and backward
    (successor) branches, the successor and predecessor states."""
    ns, u_sign, p_sign = turbo.trellis_tensors(device)
    ps_np, pu_np = turbo._prev_tables()
    prev_s = torch.as_tensor(ps_np, dtype=torch.long, device=device)
    prev_u = torch.as_tensor(pu_np, dtype=torch.long, device=device)
    return (u_sign[prev_u], p_sign[prev_s, prev_u], ns,
            u_sign.expand(8, 2).contiguous(), p_sign, prev_s)


def half_windowed_plain(lin: torch.Tensor, par: torch.Tensor, a0: torch.Tensor,
                        b0: torch.Tensor):
    """[n, lw] half-iteration in torch ops: (ext [n, lw], alpha_last [n, 8],
    beta_first [n, 8]). The arithmetic of turbo._bcjr_half_windowed, with
    the extrinsic fused into the backward loop."""
    fu, fp, ns, bu, bp, prev_s = _plain_tables(lin.device)
    lw = lin.shape[1]
    hl = 0.5 * lin
    hp = 0.5 * par
    alphas = []
    alpha = a0
    for t in range(lw):
        alphas.append(alpha)
        g = hl[:, t, None, None] * fu + hp[:, t, None, None] * fp
        a = (alpha[:, prev_s] + g).amax(-1)
        alpha = a - a.amax(-1, keepdim=True)
    ext = torch.empty_like(lin)
    beta = b0
    for t in range(lw - 1, -1, -1):
        g = hl[:, t, None, None] * bu + hp[:, t, None, None] * bp
        m = beta[:, ns] + g  # [n, 8, 2]
        full = alphas[t][:, :, None] + m
        ext[:, t] = (full[:, :, 0].amax(-1) - full[:, :, 1].amax(-1)) - lin[:, t]
        b = m.amax(-1)
        beta = b - b.amax(-1, keepdim=True)
    return ext, alpha, beta


def _check(lin, par, a0, b0):
    devs = {x.device for x in (lin, par, a0, b0)}
    if len(devs) != 1:
        raise ValueError(f"bcjr half: tensors on several devices {devs}")
    for name, x in (("lin", lin), ("par", par), ("a0", a0), ("b0", b0)):
        if x.dtype != _F32:
            raise TypeError(f"bcjr half: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"bcjr half: {name} must be contiguous")
    n, lw = lin.shape
    if par.shape != (n, lw) or a0.shape != (n, 8) or b0.shape != (n, 8):
        raise ValueError(
            f"bcjr half: shapes lin {tuple(lin.shape)} par {tuple(par.shape)} "
            f"a0 {tuple(a0.shape)} b0 {tuple(b0.shape)}; want [n, lw], [n, 8]")


def _half_cuda(lin, par, a0, b0):
    """Launch the kernel on the current stream; raises on any CUDA error."""
    from . import build

    lib = build.load().lib
    n, lw = lin.shape
    ext = torch.empty_like(lin)
    alast = torch.empty_like(a0)
    bfirst = torch.empty_like(b0)
    with torch.cuda.device(lin.device):
        stream = torch.cuda.current_stream(lin.device).cuda_stream
        rc = lib.srsue_bcjr_half(
            lin.data_ptr(), par.data_ptr(), a0.data_ptr(), b0.data_ptr(),
            ext.data_ptr(), alast.data_ptr(), bfirst.data_ptr(),
            ctypes.c_longlong(n), ctypes.c_int(lw), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"bcjr_half kernel launch failed: CUDA error {rc} "
                           f"(n={n}, lw={lw})")
    bcjr_half_windowed.launches += 1
    return ext, alast, bfirst


def half_windowed(lin, par, a0, b0):
    """[n, lw] contract of ``half_windowed_pallas``: plain twin for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    _check(lin, par, a0, b0)
    if lin.device.type == "cuda":
        return _half_cuda(lin, par, a0, b0)
    if lin.device.type == "cpu":
        return half_windowed_plain(lin, par, a0, b0)
    raise ValueError(f"bcjr half: unsupported device {lin.device}")


def _windowed(half, sys_llr, par_llr, apriori, tail_sys, tail_par,
              alpha_b, beta_b, lw):
    B, K = sys_llr.shape
    if K % lw:
        raise ValueError(f"window {lw} must divide K={K}")
    W = K // lw
    lin = (sys_llr + apriori).reshape(B * W, lw)
    a0 = alpha_b.clone()
    a0[:, 0] = turbo.NEG
    a0[:, 0, 0] = 0.0  # the trellis starts in state 0
    b0 = beta_b.clone()
    b0[:, W - 1] = turbo.tail_beta(tail_sys, tail_par)
    ext, alast, bfirst = half(lin, par_llr.reshape(B * W, lw).contiguous(),
                              a0.reshape(B * W, 8), b0.reshape(B * W, 8))
    alast = alast.reshape(B, W, 8)
    bfirst = bfirst.reshape(B, W, 8)
    z = torch.zeros(B, 1, 8, dtype=_F32, device=sys_llr.device)
    new_alpha_b = torch.cat([z, alast[:, :-1]], 1)
    new_beta_b = torch.cat([bfirst[:, 1:], z], 1)
    return ext.reshape(B, K), new_alpha_b, new_beta_b


def bcjr_half_windowed(sys_llr, par_llr, apriori, tail_sys, tail_par,
                       alpha_b, beta_b, lw: int):
    """One constituent half-iteration over W = K/lw windows.

    sys_llr, par_llr, apriori [B, K]; tail_sys, tail_par [B, 3];
    alpha_b, beta_b [B, W, 8] boundaries from the previous iteration.
    Returns (extrinsic [B, K], new alpha_b, new beta_b)."""
    return _windowed(half_windowed, sys_llr, par_llr, apriori, tail_sys,
                     tail_par, alpha_b, beta_b, lw)


bcjr_half_windowed.launches = 0


def bcjr_half_windowed_plain(sys_llr, par_llr, apriori, tail_sys, tail_par,
                             alpha_b, beta_b, lw: int):
    """The plain PyTorch version of ``bcjr_half_windowed`` on any device."""
    return _windowed(half_windowed_plain, sys_llr, par_llr, apriori, tail_sys,
                     tail_par, alpha_b, beta_b, lw)
