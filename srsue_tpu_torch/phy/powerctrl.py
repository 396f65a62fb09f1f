"""UL power control: open loop and TPC accumulation (36.213 5.1). The
port's own copy of ``srsue_tpu/phy/powerctrl.py`` (its reference)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TPC_ACC = {0: -1.0, 1: 0.0, 2: 1.0, 3: 3.0}  # dB, accumulated mode


@dataclass
class UlPowerConfig:
    p_max_dbm: float = 23.0
    p0_nominal_pusch: float = -85.0
    alpha: float = 0.7
    p0_nominal_pucch: float = -105.0
    delta_preamble_msg3: float = 6.0


class UlPower:
    """Per-UE UL power state: the accumulated TPC corrections of PUSCH
    (f) and PUCCH (g)."""

    def __init__(self, cfg: UlPowerConfig | None = None):
        self.cfg = cfg or UlPowerConfig()
        self.f_pusch = 0.0
        self.g_pucch = 0.0

    def apply_tpc_pusch(self, tpc: int) -> None:
        self.f_pusch += TPC_ACC.get(tpc, 0.0)

    def apply_tpc_pucch(self, tpc: int) -> None:
        self.g_pucch += TPC_ACC.get(tpc, 0.0)

    def pusch_power_dbm(self, n_prb: int, pathloss_db: float, delta_tf_db: float = 0.0) -> float:
        c = self.cfg
        p = (10 * np.log10(max(n_prb, 1)) + c.p0_nominal_pusch + c.alpha * pathloss_db
             + delta_tf_db + self.f_pusch)
        return float(min(c.p_max_dbm, p))

    def pucch_power_dbm(self, pathloss_db: float, delta_format_db: float = 0.0) -> float:
        c = self.cfg
        p = c.p0_nominal_pucch + pathloss_db + delta_format_db + self.g_pucch
        return float(min(c.p_max_dbm, p))

    def prach_power_dbm(self, pathloss_db: float, target_rx_dbm: float) -> float:
        return float(min(self.cfg.p_max_dbm, target_rx_dbm + pathloss_db))

    def headroom_db(self, n_prb: int, pathloss_db: float) -> float:
        """The real power headroom P_max - P_pusch, unclamped: the [-23, 40]
        dB range of 36.133 9.1.8.4 belongs to the PHR's encoding, which
        the MAC applies."""
        return float(self.cfg.p_max_dbm - self.pusch_power_dbm(n_prb, pathloss_db))
