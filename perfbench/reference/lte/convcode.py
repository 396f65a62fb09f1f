"""The tail-biting convolutional encoder on the host (36.212 5.1.3.1),
for the transmitter's PDCCH. Word w = x_k*64 + (x_{k-1}..x_{k-6}) indexes
the branches, newest bit the MSB."""

from __future__ import annotations

import functools

import numpy as np


GENS = (0o133, 0o171, 0o165)


def _popcount_parity(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(7):
        out ^= (x >> i) & 1
    return out


@functools.lru_cache(maxsize=1)
def _out_bits() -> np.ndarray:
    """[128, 3] uint8: output bit of stream j for branch word w."""
    w = np.arange(128)
    return np.stack([_popcount_parity(w & g) for g in GENS], axis=1).astype(np.uint8)


def encode(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: [..., n] {0,1} -> [..., 3, n] uint8 (stream-major).
    The register starts with the last 6 bits, so word k holds bits k..k-6
    (indices mod n)."""
    b = np.asarray(bits, dtype=np.int64)
    n = b.shape[-1]
    k = np.arange(n)
    w = sum(b[..., (k - i) % n] << (6 - i) for i in range(7))
    return np.swapaxes(_out_bits()[w], -1, -2).copy()
