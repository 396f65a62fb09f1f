"""Transmit diversity precoding on the host (36.211 6.3.4.3, two ports)."""

from __future__ import annotations

import numpy as np


def alamouti_precode(sym: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[..., n_sym] layer symbols (pairs adjacent) -> the two ports' RE
    streams: port 0 (x0, x1)/sqrt2 and port 1 (-x1*, x0*)/sqrt2, complex64."""
    x0, x1 = sym[..., 0::2], sym[..., 1::2]
    s = 1.0 / np.sqrt(2.0)
    p0 = np.stack([x0, x1], axis=-1).reshape(sym.shape) * s
    p1 = np.stack([-np.conj(x1), np.conj(x0)], axis=-1).reshape(sym.shape) * s
    return p0.astype(np.complex64), p1.astype(np.complex64)
