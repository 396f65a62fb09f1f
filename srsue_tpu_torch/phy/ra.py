"""Resource allocation helpers: MCS/TBS mapping (36.213 7.1.7), host side.

Counterpart of ``srsue_tpu/phy/ra.py``: the same 27 x 110 TBS table, built
the same way -- spec-exact transcribed columns plus the generator-model
reconstruction of the remaining widths -- and the same ``dl_grant``.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from .cell import MOD_16QAM, MOD_64QAM, MOD_QPSK, DlGrant
from .segmentation import plan

# 36.213 Table 7.1.7.1-1: MCS -> (modulation order, I_TBS)
MCS_TABLE = [
    (MOD_QPSK, 0), (MOD_QPSK, 1), (MOD_QPSK, 2), (MOD_QPSK, 3), (MOD_QPSK, 4),
    (MOD_QPSK, 5), (MOD_QPSK, 6), (MOD_QPSK, 7), (MOD_QPSK, 8), (MOD_QPSK, 9),
    (MOD_16QAM, 9), (MOD_16QAM, 10), (MOD_16QAM, 11), (MOD_16QAM, 12),
    (MOD_16QAM, 13), (MOD_16QAM, 14), (MOD_16QAM, 15), (MOD_64QAM, 15),
    (MOD_64QAM, 16), (MOD_64QAM, 17), (MOD_64QAM, 18), (MOD_64QAM, 19),
    (MOD_64QAM, 20), (MOD_64QAM, 21), (MOD_64QAM, 22), (MOD_64QAM, 23),
    (MOD_64QAM, 24), (MOD_64QAM, 25), (MOD_64QAM, 26),
]

# 36.213 Table 7.1.7.2.1-1 columns (I_TBS 0..26) for every N_PRB where a
# spec-exact transcription is available in this (air-gapped) build
# environment: the standard bandwidths {6, 15, 25, 50, 75, 100}, the
# narrow widths 1..5 (DCI type-2 RA), and the contiguous sub-band range
# 7..24. Columns NOT listed here are reconstructed at import time (see
# TBS_TABLE below) by interpolating between the nearest exact columns
# and snapping down onto the valid-TBS alphabet — every reconstructed
# cell is alphabet-valid (zero-filler segmentation property), monotone
# along both axes, and within one alphabet step of the spec value
# (validated cell-exactly wherever an exact column exists).
TBS_COLUMNS: dict[int, list[int]] = {
    1: [16, 24, 32, 40, 56, 72, 88, 104, 120, 136, 144, 176, 208, 224,
        256, 280, 328, 336, 376, 408, 440, 488, 520, 552, 584, 616, 712],
    2: [32, 56, 72, 104, 120, 144, 176, 224, 256, 296, 328, 376, 440,
        488, 552, 600, 632, 696, 776, 840, 904, 1000, 1064, 1128, 1192,
        1256, 1480],
    3: [56, 88, 144, 176, 208, 224, 256, 328, 392, 456, 504, 584, 680,
        744, 840, 904, 968, 1064, 1160, 1288, 1384, 1480, 1608, 1736,
        1800, 1864, 2216],
    4: [88, 144, 176, 208, 256, 328, 392, 472, 536, 616, 680, 776, 904,
        1000, 1128, 1224, 1288, 1416, 1544, 1736, 1864, 1992, 2152,
        2280, 2408, 2536, 2984],
    5: [120, 176, 208, 256, 328, 424, 504, 584, 680, 776, 872, 1000,
        1128, 1256, 1416, 1544, 1608, 1800, 1992, 2152, 2344, 2472,
        2664, 2856, 2984, 3112, 3752],
    6: [152, 208, 256, 328, 408, 504, 600, 712, 808, 936, 1032, 1192, 1352,
        1544, 1736, 1800, 1928, 2152, 2344, 2600, 2792, 2984, 3240, 3496,
        3624, 3752, 4392],
    7: [176, 224, 296, 392, 488, 600, 712, 840, 968, 1096, 1224, 1384,
        1608, 1800, 2024, 2152, 2280, 2536, 2792, 2984, 3240, 3496, 3752,
        4008, 4264, 4392, 5160],
    8: [208, 256, 328, 440, 552, 680, 808, 968, 1096, 1256, 1384, 1608,
        1800, 2024, 2280, 2472, 2600, 2856, 3112, 3368, 3624, 3880, 4264,
        4584, 4776, 4968, 5992],
    9: [224, 328, 376, 504, 632, 776, 936, 1096, 1256, 1416, 1544, 1800,
        2024, 2280, 2600, 2728, 2984, 3240, 3496, 3752, 4136, 4392, 4776,
        5160, 5352, 5544, 6712],
    10: [256, 344, 424, 568, 696, 872, 1032, 1224, 1384, 1544, 1736, 2024,
         2280, 2536, 2856, 3112, 3240, 3624, 3880, 4264, 4584, 4968, 5352,
         5736, 5992, 6200, 7480],
    11: [288, 376, 472, 616, 776, 968, 1128, 1320, 1544, 1736, 1928, 2216,
         2472, 2792, 3112, 3368, 3624, 4008, 4264, 4584, 4968, 5352, 5992,
         6200, 6456, 6712, 8248],
    12: [328, 424, 520, 680, 840, 1032, 1224, 1480, 1672, 1864, 2088, 2408,
         2728, 3112, 3496, 3624, 3880, 4392, 4584, 4968, 5544, 5992, 6456,
         6968, 7224, 7480, 8760],
    13: [344, 456, 568, 744, 904, 1128, 1352, 1608, 1800, 2024, 2280, 2600,
         2984, 3368, 3752, 4008, 4264, 4776, 4968, 5352, 5992, 6456, 6968,
         7480, 7736, 7992, 9528],
    14: [376, 488, 616, 808, 1000, 1224, 1480, 1672, 1928, 2216, 2472,
         2792, 3240, 3624, 4008, 4264, 4584, 5160, 5352, 5736, 6456, 6968,
         7480, 7992, 8248, 8504, 10296],
    15: [392, 520, 648, 872, 1064, 1320, 1544, 1800, 2024, 2344, 2600, 2984,
         3368, 3880, 4264, 4584, 4968, 5352, 5992, 6456, 6968, 7480, 7992,
         8504, 9144, 9528, 11064],
    16: [424, 568, 696, 904, 1128, 1384, 1672, 1928, 2216, 2472, 2728,
         3240, 3624, 4136, 4584, 4968, 5160, 5736, 6200, 6968, 7480, 7992,
         8504, 9144, 9528, 9912, 11832],
    17: [456, 600, 744, 968, 1192, 1480, 1736, 2088, 2344, 2664, 2984,
         3496, 3880, 4392, 4968, 5160, 5544, 6200, 6456, 7224, 7992, 8504,
         9144, 9528, 10296, 10680, 12576],
    18: [488, 632, 776, 1032, 1256, 1544, 1864, 2216, 2536, 2856, 3112,
         3624, 4136, 4584, 5160, 5544, 5736, 6456, 6968, 7480, 8248, 8760,
         9528, 10296, 10680, 11064, 13536],
    19: [504, 680, 840, 1096, 1320, 1672, 1992, 2344, 2664, 2984, 3368,
         3880, 4392, 4968, 5544, 5736, 6200, 6712, 7224, 7992, 8760, 9144,
         9912, 10680, 11448, 11832, 14112],
    20: [536, 712, 872, 1160, 1416, 1736, 2088, 2472, 2792, 3112, 3496,
         4008, 4584, 5160, 5736, 6200, 6456, 7224, 7736, 8248, 9144, 9912,
         10680, 11448, 12216, 12576, 14688],
    21: [568, 744, 936, 1224, 1480, 1864, 2216, 2536, 2984, 3368, 3752,
         4264, 4776, 5352, 5992, 6456, 6712, 7480, 8248, 8760, 9528,
         10296, 11064, 11832, 12576, 12960, 15264],
    22: [600, 776, 968, 1256, 1544, 1928, 2280, 2664, 3112, 3496, 3880,
         4392, 4968, 5736, 6200, 6712, 6968, 7992, 8504, 9144, 9912,
         10680, 11448, 12576, 12960, 13536, 16416],
    23: [616, 808, 1000, 1320, 1608, 2024, 2408, 2792, 3240, 3624, 4008,
         4584, 5352, 5992, 6456, 6968, 7224, 8248, 8760, 9912, 10680,
         11448, 12216, 12960, 13536, 14112, 16992],
    24: [648, 872, 1064, 1384, 1736, 2088, 2472, 2984, 3368, 3752, 4264,
         4776, 5544, 6200, 6968, 7224, 7736, 8760, 9144, 10296, 11064,
         11832, 12576, 13536, 14112, 14688, 17568],
    25: [680, 904, 1096, 1416, 1800, 2216, 2600, 3112, 3496, 4008, 4392,
         4968, 5736, 6456, 7224, 7736, 7992, 9144, 9912, 10680, 11832,
         12576, 13536, 14112, 15264, 15840, 18336],
    50: [1384, 1800, 2216, 2856, 3624, 4392, 5160, 6200, 6968, 7992, 8760,
         9912, 11448, 12960, 14112, 15264, 16416, 18336, 19848, 21384,
         23688, 25456, 27376, 28336, 30576, 31704, 36696],
    75: [2088, 2728, 3368, 4264, 5352, 6712, 7736, 9144, 10680, 11832,
         12960, 14688, 17568, 19080, 21384, 22920, 24496, 27376, 29296,
         32856, 35160, 37888, 40576, 42368, 45352, 46888, 55056],
    100: [2792, 3624, 4584, 5736, 7224, 8760, 10296, 12216, 14112, 15840,
          17568, 19848, 22920, 25456, 28336, 30576, 32856, 36696, 39232,
          43816, 46888, 51024, 55056, 57336, 61664, 63776, 75376],
}


# The distinct values of 36.213 Table 7.1.7.2.1-1 form a small "valid TBS"
# alphabet: every value v satisfies the zero-filler segmentation property
# (v + 24-bit CRC, after 36.212 §5.1.2 segmentation with per-block CRCs,
# lands exactly on turbo QPP block sizes). Reconstructed columns draw
# only from this alphabet so every grant — exact or reconstructed —
# carries a real spec TBS with exact segmentation/filler behavior.
_VALID_TBS = sorted({v for col in TBS_COLUMNS.values() for v in col})


def _snap_alphabet() -> np.ndarray:
    """Alphabet for reconstructed cells: the transcribed-column values,
    with any gap wider than ~5.5% densified by zero-filler candidates
    (v % 8 == 0 and plan(v).f == 0 — the property every
    spec TBS satisfies). The top of the column alphabet is sparse
    (55056..75376 has only 3 members) while the true table's steps are
    a few percent; snapping across such a gap would misplace cells by
    thousands of bits."""
    base = sorted(_VALID_TBS)
    out = set(base)
    top = int(base[-1] * 1.2)

    def zero_filler_range(a: int, b: int):
        for v in range((a // 8 + 1) * 8, b, 8):
            if plan(v).f == 0:
                yield v

    for a, b in zip(base, base[1:]):
        if b - a > 0.055 * b:
            out.update(zero_filler_range(a, b))
    # extrapolation region above the largest transcribed value
    out.update(zero_filler_range(base[-1], top))
    return np.asarray(sorted(out), np.int64)


def _snap_nearest(valid: np.ndarray, approx: float) -> int:
    """Nearest alphabet member (the quantizer of the generator model)."""
    j = int(np.searchsorted(valid, approx))
    j = max(0, min(j, len(valid) - 1))
    if j > 0 and abs(valid[j - 1] - approx) <= abs(valid[j] - approx):
        j -= 1
    return int(valid[j])


def _reconstruct_column(n: int, anchors: list[int], valid: np.ndarray
                        ) -> np.ndarray:
    """One reconstructed column via the 36.213 GENERATOR MODEL
    (R1-081638 design procedure): the table was produced as
    ``TBS = quantize(SE_i * N_RE(n)) - CRC`` with N_RE proportional to
    n (120 RE/PRB reference configuration) — i.e. per I_TBS row,
    ``(TBS + 24) / n`` is a slowly-varying spectral efficiency (exactly
    constant over 25/50/75/100 for many rows, e.g. I_TBS 0: 28.16
    bits/PRB at every transcribed wide width). So: interpolate SE
    LINEARLY IN THE SE DOMAIN between the flanking exact columns, map
    back (SE*n - 24), and quantize to the valid-TBS alphabet."""
    lo = max((c for c in anchors if c <= n), default=None)
    his = [c for c in anchors if c >= n]
    out = np.zeros(27, np.int64)
    for i in range(27):
        if not his:  # extrapolate SE beyond the last anchor
            c1, c0 = anchors[-1], anchors[-2]
            se0 = (TBS_COLUMNS[c0][i] + 24) / c0
            se1 = (TBS_COLUMNS[c1][i] + 24) / c1
            se = se1 + (n - c1) * (se1 - se0) / (c1 - c0)
        else:
            hi = his[0]
            f = (n - lo) / (hi - lo)
            se_lo = (TBS_COLUMNS[lo][i] + 24) / lo
            se_hi = (TBS_COLUMNS[hi][i] + 24) / hi
            se = se_lo * (1.0 - f) + se_hi * f
        out[i] = _snap_nearest(valid, se * n - 24)
    return out


def _build_full_table() -> np.ndarray:
    """Full [27, 110] TBS table: spec-exact transcribed columns (the 24
    TBS_COLUMNS keys) + generator-model reconstruction (SE-domain
    interpolation, see _reconstruct_column) for the remaining widths;
    widths above 100 extrapolate the SE line. Monotonicity along both
    axes is asserted, not silently repaired."""
    cols = sorted(TBS_COLUMNS)
    valid = _snap_alphabet()
    t = np.zeros((27, 110), np.int64)
    for n in range(1, 111):
        if n in TBS_COLUMNS:
            t[:, n - 1] = TBS_COLUMNS[n]
        else:
            t[:, n - 1] = _reconstruct_column(n, cols, valid)
    t = np.maximum.accumulate(t, axis=1)  # densified-alphabet snap can
    # produce a locally flat-then-lower step at an exact-column seam;
    # accumulate restores N_PRB monotonicity without leaving the alphabet
    assert (np.diff(t, axis=0) >= 0).all(), "TBS not monotone in I_TBS"
    assert (np.diff(t, axis=1) >= 0).all(), "TBS not monotone in N_PRB"
    for n, col in TBS_COLUMNS.items():
        assert (t[:, n - 1] == np.asarray(col)).all(), f"col {n} clobbered"
    return t


TBS_TABLE = _build_full_table()  # [27 I_TBS, 110 N_PRB]

# Widths whose column is a spec-exact transcription; everything else is
# generator-model reconstructed (see _reconstruct_column).
TBS_EXACT_WIDTHS = frozenset(TBS_COLUMNS)


def mcs_to_mod_itbs(mcs: int) -> tuple[int, int]:
    return MCS_TABLE[mcs]


_warned_widths: set[int] = set()


def tbs(i_tbs: int, n_prb: int) -> int:
    """36.213 7.1.7.2.1 TBS lookup for any width 1..110.

    Widths outside TBS_EXACT_WIDTHS return the generator-model
    reconstruction: self-consistent within this stack, not guaranteed equal
    to a spec-conformant peer's cell for cell. Such a lookup warns once per
    width, and raises when SRSUE_TPU_TBS_STRICT=1 is set (for deployments
    against external peers, which must not take reconstructed values
    silently), as the reference's ``ra.tbs`` does."""
    if not 1 <= n_prb <= 110:
        raise ValueError(f"n_prb {n_prb} out of range")
    if n_prb not in TBS_EXACT_WIDTHS:
        if os.environ.get("SRSUE_TPU_TBS_STRICT", "0") == "1":
            raise ValueError(f"TBS width n_prb={n_prb} is reconstructed, not "
                             f"spec-transcribed (SRSUE_TPU_TBS_STRICT=1)")
        if n_prb not in _warned_widths:
            _warned_widths.add(n_prb)
            logging.getLogger("srsue_tpu_torch.ra").warning(
                "TBS column n_prb=%d is generator-model reconstructed (not "
                "spec-transcribed); self-consistent in-stack, verify against the "
                "peer for external interop", n_prb)
    return int(TBS_TABLE[i_tbs, n_prb - 1])


def dl_grant(n_prb_cell: int, mcs: int, n_prb_alloc: int | None = None,
             prb_start: int = 0, rv: int = 0) -> DlGrant:
    """A full-band (default) DL grant for an MCS."""
    if n_prb_alloc is None:
        n_prb_alloc = n_prb_cell
    mod, i_tbs = mcs_to_mod_itbs(mcs)
    return DlGrant(n_prb=n_prb_alloc, prb_start=prb_start, mcs=mcs,
                   mod_order=mod, tbs=tbs(i_tbs, n_prb_alloc), rv=rv)
