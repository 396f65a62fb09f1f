"""The comparison that decides ``correct``: numbers worked out from the
port's outputs and the plain reference's, each held to its limit from the
cell's ``limits`` (``workloads/<cell>.json``). A number passes when it is
at most its limit; a missing limit, or a number that is not finite, fails."""

from __future__ import annotations

import math
import sys

import numpy as np


def rel_err(port, ref) -> float:
    """||port - ref|| / ||ref|| (float64)."""
    p = np.asarray(port, np.float64)
    r = np.asarray(ref, np.float64)
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))


def decisions(port_payload, port_ok, port_iters, ref) -> dict:
    """The decoded bits, CRC flags and turbo iterations that differ."""
    return {"payload_bits_wrong": int(np.sum(np.asarray(port_payload) != ref.payload)),
            "tb_flags_wrong": int(np.sum(np.asarray(port_ok) != ref.tb_ok)),
            "iters_wrong": int(np.sum(np.asarray(port_iters) != ref.iters))}


def merge(parts: list[dict]) -> dict:
    """Per-sample numbers into one per name: counts add, errors take the
    largest."""
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = max(out[k], v) if k.endswith("_err") and k in out else out.get(k, 0) + v
    return out


def correct(numbers: dict, limits: dict) -> bool:
    return bool(numbers) and all(
        k in limits and math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


def table(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number compared."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}


def report(rows: dict) -> None:
    """Each number compared beside its limit, on standard error."""
    for k, r in rows.items():
        print(f"compared {k} = {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
