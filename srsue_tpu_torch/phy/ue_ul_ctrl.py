"""UL control scheduling: SR and periodic-CQI opportunities and payloads
(36.213 10.1 SR configuration, 7.2.2 periodic CQI). The port's own copy of
``srsue_tpu/phy/ue_ul_ctrl.py`` (its reference), on the port's ``ra``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import ra

# 36.213 Table 10.1-5: sr-ConfigIndex -> (period, first index); offset = index - first
_SR_PERIODS = ((5, 0), (10, 5), (20, 15), (40, 35), (80, 75))
_SR_END = 155
# 36.213 Table 7.2.2-1A (wideband): cqi-pmi-ConfigIndex -> (period, first index)
_CQI_PERIODS = ((2, 0), (5, 2), (10, 7), (20, 17), (40, 37), (80, 77), (160, 157))
_CQI_END = 317


def _period_offset(table, end: int, index: int, what: str) -> tuple[int, int]:
    if index >= end:
        raise ValueError(f"invalid {what} {index}")
    period, first = next(((p, f) for p, f in reversed(table) if index >= f), table[0])
    return period, index - first


def sr_period_offset(i_sr: int) -> tuple[int, int]:
    """sr-ConfigIndex -> (period, subframe offset)."""
    return _period_offset(_SR_PERIODS, _SR_END, i_sr, "sr-ConfigIndex")


def sr_opportunity(i_sr: int, tti: int) -> bool:
    p, off = sr_period_offset(i_sr)
    return tti % p == off


def cqi_period_offset(i_cqi: int) -> tuple[int, int]:
    """cqi-pmi-ConfigIndex -> (period, offset)."""
    return _period_offset(_CQI_PERIODS, _CQI_END, i_cqi, "cqi config index")


def cqi_opportunity(i_cqi: int, tti: int) -> bool:
    p, off = cqi_period_offset(i_cqi)
    return tti % p == off


# ---------------------------------------------------------------------------
# UE-selected subband reporting (periodic mode 2-0, 36.213 7.2.2)
# ---------------------------------------------------------------------------


def subband_geometry(n_prb: int) -> tuple[int, int]:
    """36.213 Table 7.2.2-2: system bandwidth -> (subband size k, bandwidth
    parts J) of UE-selected periodic reports."""
    if n_prb <= 7:
        return n_prb, 1  # wideband only (no subband reporting)
    if n_prb <= 10:
        return 4, 1
    if n_prb <= 26:
        return 4, 2
    if n_prb <= 63:
        return 6, 3
    return 8, 4


def subband_count(n_prb: int) -> int:
    k, _ = subband_geometry(n_prb)
    return -(-n_prb // k)


def subband_label_bits(n_prb: int) -> int:
    """L = ceil(log2(ceil(N/J))) label bits naming the selected subband in
    its bandwidth part."""
    _, j = subband_geometry(n_prb)
    per_part = -(-subband_count(n_prb) // j)
    return max(1, int(np.ceil(np.log2(max(per_part, 2)))))


def part_subbands(n_prb: int, j: int) -> tuple[int, int]:
    """Subband index range [lo, hi) of bandwidth part j."""
    _, parts = subband_geometry(n_prb)
    n_sb = subband_count(n_prb)
    per = -(-n_sb // parts)
    return j * per, min(j * per + per, n_sb)


def cqi_report_kind(i_cqi: int, tti: int, n_prb: int,
                    subband_k: int | None) -> tuple[str, int] | None:
    """This TTI's periodic report, shared by UE and eNB so both agree on the
    payload size: None | ("wb", 0) | ("sb", bandwidth part j). The wideband
    report recurs every H = J*K + 1 opportunities; the bandwidth parts cycle
    in between."""
    if not cqi_opportunity(i_cqi, tti):
        return None
    if subband_k is None:
        return ("wb", 0)
    p, off = cqi_period_offset(i_cqi)
    _, parts = subband_geometry(n_prb)
    m = ((tti - off) // p) % (parts * subband_k + 1)
    return ("wb", 0) if m == 0 else ("sb", (m - 1) % parts)


@dataclass
class UlCtrlConfig:
    sr_config_index: int | None = None
    sr_pucch_resource: int = 0
    cqi_config_index: int | None = None
    cqi_pucch_resource: int = 0
    # mode 2-0 (subbandCQI): the K parameter; None = widebandCQI
    cqi_subband_k: int | None = None
    n_prb: int = 0


def _msb_bits(value: int, n: int) -> np.ndarray:
    return ((value >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8)


class UlCtrl:
    """Per-TTI UL control decisions fed by the DL measurements: the glue
    between the channel estimator's metrics and the PUCCH payloads."""

    def __init__(self, cfg: UlCtrlConfig):
        self.cfg = cfg
        self.last_snr_db: float = 0.0
        self.subband_snr_db: np.ndarray | None = None
        self.metrics = {"cqi_sent": 0, "sr_sent": 0}

    def update_snr(self, snr_db: float) -> None:
        self.last_snr_db = 0.8 * self.last_snr_db + 0.2 * snr_db  # EMA

    def update_subband_snr(self, snr_db) -> None:
        """Per-subband SNR estimates (subband_count(n_prb) of them)."""
        v = np.asarray(snr_db, np.float64)
        if self.subband_snr_db is None or len(self.subband_snr_db) != len(v):
            self.subband_snr_db = v.copy()
        else:
            self.subband_snr_db = 0.8 * self.subband_snr_db + 0.2 * v

    def sr_opportunity(self, tti: int) -> bool:
        return self.cfg.sr_config_index is not None and sr_opportunity(
            self.cfg.sr_config_index, tti)

    def cqi_for_tti(self, tti: int) -> np.ndarray | None:
        """This TTI's periodic report payload, or None off an opportunity.
        Wideband: the 4-bit CQI. Subband (mode 2-0): the best subband's 4-bit
        CQI and its L-bit label in the current bandwidth part."""
        if self.cfg.cqi_config_index is None:
            return None
        kind = cqi_report_kind(self.cfg.cqi_config_index, tti, self.cfg.n_prb,
                               self.cfg.cqi_subband_k)
        if kind is None:
            return None
        self.metrics["cqi_sent"] += 1
        if kind[0] == "wb":
            return _msb_bits(ra.cqi_from_snr(self.last_snr_db), 4)
        if self.subband_snr_db is None:
            # a subband occasion before the first subband measurement: the
            # eNB derives the payload size (4 + L) from the schedule alone,
            # so the report keeps the subband shape, label 0 with the
            # wideband CQI
            label, cqi = 0, ra.cqi_from_snr(self.last_snr_db)
        else:
            lo, hi = part_subbands(self.cfg.n_prb, kind[1])
            sub = self.subband_snr_db[lo:hi]
            label = int(np.argmax(sub))
            cqi = ra.cqi_from_snr(float(sub[label]))
        return np.concatenate([_msb_bits(cqi, 4),
                               _msb_bits(label, subband_label_bits(self.cfg.n_prb))])
