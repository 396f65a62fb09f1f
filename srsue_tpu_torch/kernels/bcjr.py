"""Windowed max-log-MAP BCJR half-iteration: the wrappers of the Hopper
kernels in ``csrc/`` and their plain PyTorch twins.

The half-iteration kernel instances, the ``kernel=`` argument, are named
after the variants of ``srsue_tpu/phy/turbo_pallas.py`` they replace (there
``SRSUE_TPU_TURBO_KERNEL`` selects them):

* ``"r2max"`` (``csrc/bcjr_half.cu``, the default): radix-2, metrics
  normalised by their per-step maximum, the arithmetic of
  ``turbo._bcjr_half_windowed``; it stands in for ``_half_kernel_v4`` on
  the default path;
* ``"v2v3"`` (``csrc/bcjr_half.cu``): radix-2, state 0's metric subtracted
  every 8 steps: ``_half_kernel`` (v2) and ``_half_kernel_v3``, which do
  the same float32 operations;
* ``"v4"`` (``csrc/bcjr_half_r4.cu``): radix-4 in float32,
  ``_half_kernel_v4``;
* ``"v5"`` (``csrc/bcjr_half_r4.cu``): the radix-4 kernel in bfloat16 with
  two windows per thread (v5); float32 in and out.

``half_windowed`` takes the [n, lw] contract of ``half_windowed_pallas``;
``bcjr_half_windowed`` the [B, K] LLRs / [B, W, 8] boundaries contract of
``bcjr_half_windowed_pallas``: it injects the known start state and the
tail beta, runs the [B*W, lw] half and returns the boundaries shifted for
next-iteration initialisation (NII). With W = 1 (lw = K) it is the
unwindowed ``turbo._bcjr_half``.

``bcjr_half_fused`` is one half of the forced decode with the QPP gather
and the boundary injection in its loads (``csrc/bcjr_half_fused.cu``,
replacing ``decode_forced_tiled`` / ``decode_forced_loop_tiled``).

A CPU tensor goes to the plain twin; a CUDA tensor launches the kernel or
raises. ``launches[name]`` counts the launches of each kernel instance
(``"fused"`` for the fused half).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..phy import turbo
from . import build

_F32 = torch.float32
KERNELS = build.HALF_KERNELS
NORM_EVERY = 8  # trellis steps between state-0 normalisations (v2v3, v4, v5)

launches = dict.fromkeys((*KERNELS, "fused"), 0)


# --------------------------------------------------------------- plain twins
@functools.lru_cache(maxsize=16)
def _r2_tables(device: torch.device):
    """Sign tables of gamma for the forward (predecessor) and backward
    (successor) branches, the successor and predecessor states."""
    ns, u_sign, p_sign = turbo.trellis_tensors(device)
    ps_np, pu_np = turbo._prev_tables()
    prev_s = torch.as_tensor(ps_np, dtype=torch.long, device=device)
    prev_u = torch.as_tensor(pu_np, dtype=torch.long, device=device)
    return (u_sign[prev_u], p_sign[prev_s, prev_u], ns,
            u_sign.expand(8, 2).contiguous(), p_sign, prev_s)


def _normalise(x: torch.Tensor, steps: int, state0: bool) -> torch.Tensor:
    """Per-step maximum, or state 0 after every NORM_EVERY steps."""
    if not state0:
        return x - x.amax(-1, keepdim=True)
    return x - x[:, :1] if steps % NORM_EVERY == 0 else x


def _r2_plain(lin, par, a0, b0, state0: bool):
    """Radix-2 half in torch ops; the extrinsic is fused into the backward
    loop as in the kernel."""
    fu, fp, ns, bu, bp, prev_s = _r2_tables(lin.device)
    lw = lin.shape[1]
    hl = 0.5 * lin
    hp = 0.5 * par
    alphas = []
    alpha = a0
    for t in range(lw):
        alphas.append(alpha)
        g = hl[:, t, None, None] * fu + hp[:, t, None, None] * fp
        alpha = _normalise((alpha[:, prev_s] + g).amax(-1), t + 1, state0)
    ext = torch.empty_like(lin)
    beta = b0
    for t in range(lw - 1, -1, -1):
        g = hl[:, t, None, None] * bu + hp[:, t, None, None] * bp
        m = beta[:, ns] + g  # [n, 8, 2]
        full = alphas[t][:, :, None] + m
        ext[:, t] = (full[:, :, 0].amax(-1) - full[:, :, 1].amax(-1)) - lin[:, t]
        beta = _normalise(m.amax(-1), lw - t, state0)
    return ext, alpha, beta


@functools.lru_cache(maxsize=16)
def _r4_tables(device: torch.device, dtype: torch.dtype):
    """Index and sign tensors of the radix-4 trellis: for each state its 4
    two-step predecessors [8, 4] (state, base key, sign), and for each
    state its 4 two-step successors [8, 4] ordered by q = u1*2 + u2."""
    fwd, paths = turbo.radix4_tables()

    def key(k):
        x, y, d = k
        return x * 4 + y * 2 + d

    def t(rows, dt=torch.long):
        return torch.tensor(rows, dtype=dt, device=device)

    f_sp = t([[sp for sp, _, _ in f] for f in fwd])
    f_key = t([[key(k) for _, k, _ in f] for f in fwd])
    f_sgn = t([[sg for _, _, sg in f] for f in fwd], dtype)
    by_sp = [[p for p in paths if p[0] == sp] for sp in range(8)]
    assert all([(p[4], p[5]) for p in row] == [(0, 0), (0, 1), (1, 0), (1, 1)]
               for row in by_sp)
    p_s2 = t([[p[1] for p in row] for row in by_sp])
    p_key = t([[key(p[2]) for p in row] for row in by_sp])
    p_sgn = t([[p[3] for p in row] for row in by_sp], dtype)
    return f_sp, f_key, f_sgn, p_s2, p_key, p_sgn


def _r4_plain(lin, par, a0, b0, dtype: torch.dtype):
    """Radix-4 half in torch ops in `dtype` (float32: v4, bfloat16: v5),
    rounding where _half_kernel_v4 rounds; float32 in and out."""
    f_sp, f_key, f_sgn, p_s2, p_key, p_sgn = _r4_tables(lin.device, dtype)
    lin = lin.to(dtype)
    par = par.to(dtype)
    n, lw = lin.shape
    half = lw // 2
    ne2 = NORM_EVERY // 2
    gpp = 0.5 * (lin + par)
    gpm = 0.5 * (lin - par)
    ga = torch.stack([gpp[:, 0::2], gpm[:, 0::2]], -1)[..., :, None]  # [n, lw/2, 2, 1]
    gb = torch.stack([gpp[:, 1::2], gpm[:, 1::2]], -1)[..., None, :]  # [n, lw/2, 1, 2]
    g2 = torch.stack([ga + gb, ga - gb], -1).reshape(n, half, 8)  # key x*4 + y*2 + d
    alphas = []
    alpha = a0.to(dtype)
    for td in range(half):
        alphas.append(alpha)
        alpha = (alpha[:, f_sp] + f_sgn * g2[:, td, f_key]).amax(-1)
        if (td + 1) % ne2 == 0:
            alpha = alpha - alpha[:, :1]
    ext = torch.empty_like(lin)
    beta = b0.to(dtype)
    for td in range(half - 1, -1, -1):
        t = 2 * td
        bc = beta[:, p_s2] + p_sgn * g2[:, td, p_key]  # [n, 8, 4]
        gm = (bc + alphas[td][:, :, None]).amax(1)  # [n, 4] by q = u1*2 + u2
        mx = torch.maximum
        ext[:, t] = (mx(gm[:, 0], gm[:, 1]) - mx(gm[:, 2], gm[:, 3])) - lin[:, t]
        ext[:, t + 1] = (mx(gm[:, 0], gm[:, 2]) - mx(gm[:, 1], gm[:, 3])) - lin[:, t + 1]
        beta = bc.amax(-1)
        if (half - td) % ne2 == 0:
            beta = beta - beta[:, :1]
    return ext.to(_F32), alpha.to(_F32), beta.to(_F32)


def half_windowed_plain(lin: torch.Tensor, par: torch.Tensor, a0: torch.Tensor,
                        b0: torch.Tensor, kernel: str = "r2max"):
    """[n, lw] half-iteration of kernel instance `kernel` in torch ops:
    (ext [n, lw], alpha_last [n, 8], beta_first [n, 8])."""
    _check_kernel(kernel, lin.shape[1])
    if kernel in ("r2max", "v2v3"):
        return _r2_plain(lin, par, a0, b0, state0=kernel == "v2v3")
    return _r4_plain(lin, par, a0, b0, torch.float32 if kernel == "v4" else torch.bfloat16)


# ------------------------------------------------------------------- checks
def _check_kernel(kernel: str, lw: int) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"bcjr half: unknown kernel {kernel!r}; one of {KERNELS}")
    if kernel != "r2max" and lw % NORM_EVERY:
        raise ValueError(f"bcjr half: kernel {kernel!r} needs lw % {NORM_EVERY} == 0, "
                         f"got lw={lw}")


def _check_f32(**tensors) -> torch.device:
    devs = {x.device for x in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"bcjr half: tensors on several devices {devs}")
    for name, x in tensors.items():
        if x.dtype != _F32:
            raise TypeError(f"bcjr half: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"bcjr half: {name} must be contiguous")
    return devs.pop()


def _check(lin, par, a0, b0):
    _check_f32(lin=lin, par=par, a0=a0, b0=b0)
    n, lw = lin.shape
    if par.shape != (n, lw) or a0.shape != (n, 8) or b0.shape != (n, 8):
        raise ValueError(
            f"bcjr half: shapes lin {tuple(lin.shape)} par {tuple(par.shape)} "
            f"a0 {tuple(a0.shape)} b0 {tuple(b0.shape)}; want [n, lw], [n, 8]")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


# ------------------------------------------------------------ [n, lw] half
def _half_cuda(kernel, lin, par, a0, b0):
    """Launch one instance on the current stream; raises on any CUDA error."""
    fn = getattr(build.load().lib, f"srsue_bcjr_half_{kernel}")
    n, lw = lin.shape
    ext = torch.empty_like(lin)
    alast = torch.empty_like(a0)
    bfirst = torch.empty_like(b0)
    with torch.cuda.device(lin.device):
        rc = fn(lin.data_ptr(), par.data_ptr(), a0.data_ptr(), b0.data_ptr(),
                ext.data_ptr(), alast.data_ptr(), bfirst.data_ptr(),
                ctypes.c_longlong(n), ctypes.c_int(lw), _stream(lin))
    if rc != 0:
        raise RuntimeError(f"bcjr_half_{kernel} kernel launch failed: CUDA error {rc} "
                           f"(n={n}, lw={lw})")
    launches[kernel] += 1
    return ext, alast, bfirst


def half_windowed(lin, par, a0, b0, kernel: str = "r2max"):
    """[n, lw] contract of ``half_windowed_pallas``: plain twin for CPU
    tensors, the CUDA kernel instance `kernel` for CUDA tensors."""
    _check(lin, par, a0, b0)
    _check_kernel(kernel, lin.shape[1])
    if lin.device.type == "cuda":
        return _half_cuda(kernel, lin, par, a0, b0)
    if lin.device.type == "cpu":
        return half_windowed_plain(lin, par, a0, b0, kernel)
    raise ValueError(f"bcjr half: unsupported device {lin.device}")


# ---------------------------------------------------------------- [B, K] half
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
                       alpha_b, beta_b, lw: int, kernel: str = "r2max"):
    """One constituent half-iteration over W = K/lw windows.

    sys_llr, par_llr, apriori [B, K]; tail_sys, tail_par [B, 3];
    alpha_b, beta_b [B, W, 8] boundaries from the previous iteration.
    Returns (extrinsic [B, K], new alpha_b, new beta_b)."""
    return _windowed(functools.partial(half_windowed, kernel=kernel), sys_llr, par_llr,
                     apriori, tail_sys, tail_par, alpha_b, beta_b, lw)


def bcjr_half_windowed_plain(sys_llr, par_llr, apriori, tail_sys, tail_par,
                             alpha_b, beta_b, lw: int, kernel: str = "r2max"):
    """The plain PyTorch version of ``bcjr_half_windowed`` on any device."""
    return _windowed(functools.partial(half_windowed_plain, kernel=kernel), sys_llr,
                     par_llr, apriori, tail_sys, tail_par, alpha_b, beta_b, lw)


# ----------------------------------------------------------------- fused half
def _fused_composed(half, sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw):
    """The fused half as torch glue around an [n, lw] half: gather, inject
    the boundaries, run, return them unshifted."""
    B, K = sys_h.shape
    W = K // lw
    lin = sys_h + ext_other[:, idx.long()]
    known0 = torch.full((B, 1, 8), turbo.NEG, dtype=_F32, device=sys_h.device)
    known0[:, :, 0] = 0.0
    a0 = torch.cat([known0, alast[:, :-1]], 1)
    b0 = torch.cat([bfirst[:, 1:], tail_b[:, None]], 1)
    ext, al, bf = half(lin.reshape(B * W, lw), par_h.reshape(B * W, lw),
                       a0.reshape(B * W, 8), b0.reshape(B * W, 8))
    return ext.reshape(B, K), al.reshape(B, W, 8), bf.reshape(B, W, 8)


def _check_fused(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw):
    dev = _check_f32(sys_h=sys_h, par_h=par_h, ext_other=ext_other, alast=alast,
                     bfirst=bfirst, tail_b=tail_b)
    B, K = sys_h.shape
    if lw <= 0 or K % lw:
        raise ValueError(f"window {lw} must divide K={K}")
    W = K // lw
    if (par_h.shape != (B, K) or ext_other.shape != (B, K) or idx.shape != (K,)
            or alast.shape != (B, W, 8) or bfirst.shape != (B, W, 8)
            or tail_b.shape != (B, 8)):
        raise ValueError("bcjr fused half: want sys, par, ext_other [B, K], idx [K], "
                         "alast, bfirst [B, W, 8], tail_b [B, 8]")
    if idx.device != dev or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("bcjr fused half: idx must be contiguous int32 on the LLRs' device")


def _fused_cuda(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw):
    B, K = sys_h.shape
    ext = torch.empty_like(sys_h)
    al = torch.empty_like(alast)
    bf = torch.empty_like(bfirst)
    with torch.cuda.device(sys_h.device):
        rc = build.load().lib.srsue_bcjr_half_fused(
            sys_h.data_ptr(), par_h.data_ptr(), ext_other.data_ptr(), idx.data_ptr(),
            alast.data_ptr(), bfirst.data_ptr(), tail_b.data_ptr(), ext.data_ptr(),
            al.data_ptr(), bf.data_ptr(), ctypes.c_longlong(B), ctypes.c_int(K),
            ctypes.c_int(lw), _stream(sys_h))
    if rc != 0:
        raise RuntimeError(f"bcjr_half_fused kernel launch failed: CUDA error {rc} "
                           f"(B={B}, K={K}, lw={lw})")
    launches["fused"] += 1
    return ext, al, bf


def bcjr_half_fused(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw: int,
                    kernel: str = "r2max"):
    """One half of the forced decode over W = K/lw windows.

    sys_h, par_h [B, K]: this half's systematic and parity LLRs; ext_other
    [B, K]: the other half's extrinsic in its own order, read as
    ext_other[:, idx] (idx [K] int32: qpp_inv for half 1, qpp_perm for
    half 2); alast, bfirst [B, W, 8]: this half's boundaries of the
    previous iteration, unshifted; tail_b [B, 8]: the tail beta. Window 0
    starts in state 0 and window W-1 ends at tail_b. Returns (ext [B, K],
    alast, bfirst [B, W, 8]), unshifted, in new tensors.

    For CUDA tensors with kernel "r2max" this is one launch of the fused
    kernel; the other instances have no fused form and run with the gather
    and the injection in torch. CPU tensors take the plain twin."""
    _check_fused(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw)
    _check_kernel(kernel, lw)
    if sys_h.device.type == "cuda" and kernel == "r2max":
        return _fused_cuda(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw)
    return _fused_composed(functools.partial(half_windowed, kernel=kernel), sys_h, par_h,
                           ext_other, idx, alast, bfirst, tail_b, lw)


def bcjr_half_fused_plain(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw: int,
                          kernel: str = "r2max"):
    """The plain PyTorch version of ``bcjr_half_fused`` on any device."""
    _check_fused(sys_h, par_h, ext_other, idx, alast, bfirst, tail_b, lw)
    _check_kernel(kernel, lw)
    return _fused_composed(functools.partial(half_windowed_plain, kernel=kernel), sys_h,
                           par_h, ext_other, idx, alast, bfirst, tail_b, lw)
