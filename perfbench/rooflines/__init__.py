"""The least time of a kernel's work: operations and bytes counted from the
algorithm and its shapes (never from an implementation's windows, tiles or
boundary state), against the card's peaks in ``peaks.json``."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_seconds(n_bytes: float, ops: float) -> float:
    """The larger of the bytes over the memory's peak rate and the float32
    operations over the arithmetic's peak rate."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["fp32_flops_per_s"])
