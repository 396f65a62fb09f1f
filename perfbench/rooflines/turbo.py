"""The turbo decoder's work. One half-iteration of one code block of K bits
is K trellis steps of the radix-2 max-log-MAP BCJR: it reads the systematic,
the parity and the a-priori LLR of each step once and writes its extrinsic
once (4 float32 values, 16 bytes a step), and a step costs 120 float32
operations (branch metrics, the forward and backward add-compare-select
over 8 states and the extrinsic's two maxima over 8 states)."""

from __future__ import annotations

BYTES_PER_STEP = 16
OPS_PER_STEP = 120


def work(halves) -> dict:
    """{"bytes", "ops"} of `halves`, a list of (K, number of block
    half-iterations run at K)."""
    steps = sum(k * n for k, n in halves)
    return {"bytes": BYTES_PER_STEP * steps, "ops": OPS_PER_STEP * steps}
