"""Constellation mapping (host numpy and on a tensor's device) and exact
max-log soft and hard demapping (36.211 7.1). Counterpart of
``srsue_tpu/phy/modulation.py``.

LLR > 0 favours bit 0 (the descrambler multiplies by the +-1 sequence).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import demap as demap_kernel
from .cell import MOD_16QAM, MOD_64QAM, MOD_BPSK, MOD_QPSK

_A16 = 1.0 / np.sqrt(10.0)
_A64 = 1.0 / np.sqrt(42.0)
_A2 = 1.0 / np.sqrt(2.0)


@functools.lru_cache(maxsize=8)
def constellation(mod_order: int) -> np.ndarray:
    """complex64 table of size 2**mod_order indexed by the bit word
    (b0 b1 ... b_{Qm-1}, b0 = MSB)."""
    m = mod_order
    words = np.arange(1 << m)
    bits = (words[:, None] >> np.arange(m - 1, -1, -1)[None, :]) & 1
    s = 1 - 2 * bits
    if m == MOD_BPSK:
        sym = s[:, 0] * (_A2 + 1j * _A2)
    elif m == MOD_QPSK:
        sym = _A2 * (s[:, 0] + 1j * s[:, 1])
    elif m == MOD_16QAM:
        sym = _A16 * (s[:, 0] * (2 - s[:, 2]) + 1j * s[:, 1] * (2 - s[:, 3]))
    elif m == MOD_64QAM:
        i = s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
        q = s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5]))
        sym = _A64 * (i + 1j * q)
    else:
        raise ValueError(f"unsupported mod_order={m}")
    return sym.astype(np.complex64)


def modulate_np(bits: np.ndarray, mod_order: int) -> np.ndarray:
    """Host mapper: [..., n*Qm] {0,1} -> [..., n] complex64."""
    m = mod_order
    b = np.asarray(bits, dtype=np.int64).reshape(bits.shape[:-1] + (-1, m))
    pw = (1 << np.arange(m - 1, -1, -1)).astype(np.int64)
    return constellation(m)[(b * pw).sum(-1)]


@functools.lru_cache(maxsize=8)
def _pam_levels(mod_order: int) -> tuple[np.ndarray, np.ndarray]:
    """(levels[L], bits[L, bits per axis]) of the per-axis PAM: sign bit
    first, then the magnitude bits (Gray mapping makes I and Q separable)."""
    if mod_order == MOD_QPSK:
        return (np.array([_A2, -_A2], np.float32),
                np.array([[0], [1]], np.int32))
    lv, bt = [], []
    for sb, s in enumerate((1, -1)):
        if mod_order == MOD_16QAM:
            for mb, g in enumerate((1, 3)):
                lv.append(_A16 * s * g)
                bt.append([sb, mb])
        elif mod_order == MOD_64QAM:
            for b2 in range(2):
                for b4 in range(2):
                    lv.append(_A64 * s * (4 - (1 - 2 * b2) * (2 - (1 - 2 * b4))))
                    bt.append([sb, b2, b4])
        else:
            raise ValueError(f"unsupported mod_order={mod_order}")
    return np.array(lv, np.float32), np.array(bt, np.int32)


@functools.lru_cache(maxsize=32)
def _pam_tensors(mod_order: int, device: torch.device):
    lv, bt = _pam_levels(mod_order)
    masks = [torch.as_tensor(bt[:, i] == 1, device=device) for i in range(bt.shape[1])]
    return torch.as_tensor(lv, device=device), torch.tensor(1e30, device=device), masks


def levels(mod_order: int, device: torch.device) -> torch.Tensor:
    """The per-axis PAM levels [2^(Qm/2)] float32 on `device`, indexed by the
    axis's bits (sign first, MSB first): the table the demap kernel reads."""
    return _pam_tensors(mod_order, device)[0]


def demodulate_soft_plain(sym: torch.Tensor, mod_order: int,
                          noise_var: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Exact max-log LLRs in torch ops: [..., n] complex -> [..., n*Qm]
    float32, the plain version of the kernel ``demodulate_soft`` launches.

    Per bit, (min over levels with bit 1 - min over levels with bit 0) of
    the squared distance, divided by ``noise_var`` (broadcast against the
    symbol shape, floored at 1e-9)."""
    lv_t, big, masks = _pam_tensors(mod_order, sym.device)

    def axis_llrs(x):
        d2 = (x[..., None] - lv_t) ** 2
        return [torch.where(m1, d2, big).amin(-1) - torch.where(m1, big, d2).amin(-1)
                for m1 in masks]

    i_llr = axis_llrs(sym.real)
    q_llr = axis_llrs(sym.imag)
    # transmit bit order: b0 (I sign), b1 (Q sign), b2 (I magnitude), ...
    llr = torch.stack([v for pair in zip(i_llr, q_llr) for v in pair], -1)
    nv = torch.as_tensor(noise_var, dtype=llr.dtype, device=sym.device)
    llr = llr / torch.clamp_min(nv[..., None] if nv.ndim else nv, 1e-9)
    return llr.reshape(sym.shape[:-1] + (-1,))


def kernel_noise(noise_var, device: torch.device):
    """The noise as the demap kernel takes it: a Python float for a number
    (rounded to float32 as the plain version's ``as_tensor`` rounds it), a
    tensor as it is (the kernel's wrapper checks its type and device), any
    other array a float32 tensor on `device`."""
    if isinstance(noise_var, torch.Tensor):
        return noise_var
    if np.ndim(noise_var) == 0:
        return float(noise_var)
    return torch.as_tensor(noise_var, dtype=torch.float32, device=device)


def demodulate_soft(sym: torch.Tensor, mod_order: int,
                    noise_var: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Exact max-log LLRs: [..., n] complex -> [..., n*Qm] float32 (see
    ``demodulate_soft_plain``). CPU tensors take the plain version; CUDA
    tensors launch the LLR form of the kernel ``csrc/demap.cu`` on their
    contiguous copy (``kernels/demap.py``, which raises on what it cannot
    take); any other device raises."""
    if sym.device.type == "cuda":
        return demap_kernel.demap_llr_cuda(sym.contiguous(), kernel_noise(noise_var, sym.device),
                                           mod_order, levels(mod_order, sym.device))
    if sym.device.type == "cpu":
        return demodulate_soft_plain(sym, mod_order, noise_var)
    raise ValueError(f"demodulate_soft: unsupported device {sym.device}")


@functools.lru_cache(maxsize=32)
def _map_tensors(mod_order: int, device: torch.device):
    pw = torch.as_tensor(1 << np.arange(mod_order - 1, -1, -1), device=device)
    return torch.as_tensor(constellation(mod_order), device=device), pw


def modulate(bits: torch.Tensor, mod_order: int) -> torch.Tensor:
    """Mapper on the bits' device: [..., n*Qm] {0,1} -> [..., n] complex64
    (a gather from the constellation table by the Qm-bit word, b0 = MSB)."""
    tab, pw = _map_tensors(mod_order, bits.device)
    b = bits.reshape(bits.shape[:-1] + (-1, mod_order)).to(torch.int64)
    return tab[torch.sum(b * pw, dim=-1)]


def demodulate_hard(sym: torch.Tensor, mod_order: int) -> torch.Tensor:
    """Hard decisions by the sign of the max-log LLRs: bit 1 where the LLR
    is below 0, so a symbol on a slicer boundary (LLR 0) gives bit 0."""
    return (demodulate_soft(sym, mod_order) < 0).to(torch.uint8)
