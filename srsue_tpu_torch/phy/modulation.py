"""Constellation mapping (host) and exact max-log soft demapping (36.211
7.1). Counterpart of ``srsue_tpu/phy/modulation.py``.

LLR > 0 favours bit 0 (the descrambler multiplies by the +-1 sequence).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


def demodulate_soft(sym: torch.Tensor, mod_order: int,
                    noise_var: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Exact max-log LLRs: [..., n] complex -> [..., n*Qm] float32.

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
