"""MAC PDU bit helpers: the port's own copy of ``bits_to_bytes`` from
``srsue_tpu/mac/pdu.py`` (its reference)."""

from __future__ import annotations

import numpy as np


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """{0,1} bits, MSB first, packed into bytes."""
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()
