"""Tail-biting convolutional code (36.212 5.1.3.1): the host encoder and
the batched circular Viterbi decoder. Counterpart of
``srsue_tpu/phy/convcode.py``.

Convention: state s = (x_{k-1}..x_{k-6}) as a 6-bit int, newest bit =
MSB; the 7-bit word w = x_k*64 + s indexes branches; next state = w >> 1.
LLR sign: positive = bit 0 (as ``modulation.demodulate_soft``).

The decoder runs the trellis twice over the sequence (the wrap-around
pass warms the tail-biting state). ``decode_plain`` keeps register-exchange
survivors: each state carries its decoded input bits packed into 32-bit
words, and the result is read from the best state's words after the second
pass. On CUDA it is one launch of the hand-written kernel
``csrc/viterbi.cu`` (``kernels/viterbi.py``), which keeps the second pass's
decisions instead and traces the best state's path back through them: the
same path, from the same float32 operations in the same order, so both
give the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import viterbi as viterbi_kernel

GENS = (0o133, 0o171, 0o165)
K = 7
NSTATES = 64
NORM_EVERY = 2  # trellis steps between path-metric normalisations
MAX_N = 96      # longest sequence the kernel takes: 3 survivor words


def _popcount_parity(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(7):
        out ^= (x >> i) & 1
    return out


@functools.lru_cache(maxsize=1)
def _tables():
    """Trellis tables, as in the reference.

    out_pm1[w, j]: +-1 expected soft value (1-2*bit) of output stream j for
        branch word w in [0,128).
    prev[ns, t]: the two 7-bit branch words leading INTO next-state ns.
    """
    w = np.arange(128)
    outs = np.stack([_popcount_parity(w & g) for g in GENS], axis=1)  # [128,3]
    out_pm1 = (1.0 - 2.0 * outs).astype(np.float32)
    ns = np.arange(NSTATES)
    prev = np.stack([2 * ns, 2 * ns + 1], axis=1).astype(np.int32)  # [64,2]
    prev_state = prev & 63
    inp_bit = (np.arange(NSTATES) >> 5) & 1  # x_k = MSB of ns
    return out_pm1, prev, prev_state, inp_bit.astype(np.uint8)


def encode(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: [..., n] {0,1} -> [..., 3, n] uint8 (stream-major).
    The register starts with the last 6 bits, so word k holds bits k..k-6
    (indices mod n)."""
    b = np.asarray(bits, dtype=np.int64)
    n = b.shape[-1]
    k = np.arange(n)
    w = sum(b[..., (k - i) % n] << (6 - i) for i in range(7))
    out_pm1 = _tables()[0]
    return np.swapaxes((1.0 - out_pm1[w]) / 2.0, -1, -2).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def _encoder_tables(device: torch.device):
    out_bits = ((1.0 - _tables()[0]) / 2.0).astype(np.uint8)  # [128, 3]
    return torch.as_tensor(out_bits, device=device)


def encode_torch(bits: torch.Tensor) -> torch.Tensor:
    """The tail-biting encoder on the bits' device, batched: [B, n] {0,1}
    -> [B, 3, n] uint8, equal to ``encode`` row by row (the register starts
    with the last 6 bits; word k holds bits k..k-6, indices mod n)."""
    b = bits.to(torch.int64)
    n = b.shape[-1]
    k = torch.arange(n, device=b.device)
    w = sum(b[..., (k - i) % n] << (6 - i) for i in range(7))
    return _encoder_tables(b.device)[w].transpose(-1, -2).contiguous()


@functools.lru_cache(maxsize=16)
def _device_tables(device: torch.device):
    out_pm1, _, _, inp_bit = _tables()
    o = torch.as_tensor(out_pm1, device=device)
    return o[:, 0], o[:, 1], o[:, 2], torch.as_tensor(inp_bit.astype(np.int64), device=device)


def decode_plain(llrs: torch.Tensor) -> torch.Tensor:
    """Circular Viterbi in torch ops: [B, n, 3] float32 soft values (positive
    = bit 0) -> [B, n] uint8 hard decisions.

    Per step: branch metrics as the explicit sum (l0*o0 + l1*o1) + l2*o2;
    candidates through the concat view (state ns's predecessors are
    (2ns+t) & 63, t = 0, 1); ties keep t = 0 (strict >); path metrics
    minus their maximum every NORM_EVERY steps; the first maximal state
    wins at the end. Survivor words are int64 holding 32 bits each."""
    B, n, _ = llrs.shape
    o0, o1, o2, bit = _device_tables(llrs.device)
    n_words = -(-n // 32)
    pm = torch.zeros(B, NSTATES, dtype=torch.float32, device=llrs.device)
    surv = [torch.zeros(B, NSTATES, dtype=torch.int64, device=llrs.device)
            for _ in range(n_words)]
    for step in range(2 * n):
        l = llrs[:, step % n]
        bm = (l[:, 0:1] * o0 + l[:, 1:2] * o1) + l[:, 2:3] * o2  # [B, 128]
        cand = torch.cat([pm, pm], -1).view(B, NSTATES, 2) + bm.view(B, NSTATES, 2)
        take1 = cand[..., 1] > cand[..., 0]
        pm = torch.where(take1, cand[..., 1], cand[..., 0])
        carry = bit
        for w, s in enumerate(surv):
            sv = torch.cat([s, s], -1).view(B, NSTATES, 2)
            chosen = torch.where(take1, sv[..., 1], sv[..., 0])
            surv[w] = ((chosen << 1) & 0xFFFFFFFF) | carry
            carry = chosen >> 31
        if (step + 1) % NORM_EVERY == 0:
            pm = pm - pm.amax(-1, keepdim=True)
    best = pm.argmax(-1, keepdim=True)  # the first maximal state
    words = torch.cat([s.gather(1, best) for s in surv], 1)  # [B, n_words]
    pos = (n - 1) - torch.arange(n, device=llrs.device)  # LSB offset of bit k
    return ((words[:, pos // 32] >> (pos % 32)) & 1).to(torch.uint8)


def _check(llrs: torch.Tensor) -> None:
    if llrs.dtype != torch.float32:
        raise TypeError(f"viterbi: llrs must be float32, got {llrs.dtype}")
    if llrs.ndim != 3 or llrs.shape[-1] != 3:
        raise ValueError(f"viterbi: llrs must be [B, n, 3], got {tuple(llrs.shape)}")
    if not 1 <= llrs.shape[1] <= MAX_N:
        raise ValueError(f"viterbi: n={llrs.shape[1]} outside 1..{MAX_N}")
    if not llrs.is_contiguous():
        raise ValueError("viterbi: llrs must be contiguous")


def decode(llrs: torch.Tensor) -> torch.Tensor:
    """Batched circular Viterbi: [B, n, 3] float32 soft values (positive =
    bit 0) -> [B, n] uint8. CPU tensors take ``decode_plain``; CUDA tensors
    launch the kernel of ``kernels/viterbi.py`` (an empty batch launches
    nothing); any other input raises."""
    _check(llrs)
    if llrs.device.type == "cuda":
        if llrs.shape[0] == 0:
            return torch.empty(0, llrs.shape[1], dtype=torch.uint8, device=llrs.device)
        return viterbi_kernel.viterbi_cuda(llrs)
    if llrs.device.type == "cpu":
        return decode_plain(llrs)
    raise ValueError(f"viterbi: unsupported device {llrs.device}")
