"""The port's own copy of ``srsue_tpu/utils/metrics.py`` (its reference), unchanged below this docstring.

Console metrics table (reference: ue/src/metrics_stdout.cc:85-139 —
1 Hz table of rsrp/pathloss/cfo/mcs/snr/turbo-iters/brate/bler, gated on
attached state, with UHD O/U/L error surfacing)."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class PhyMetricsSnapshot:
    rsrp_dbm: float = 0.0
    pathloss_db: float = 0.0
    cfo_hz: float = 0.0
    dl_snr_db: float = 0.0
    dl_mcs: float = 0.0
    turbo_iters: float = 0.0
    ul_mcs: float = 0.0
    ul_power_dbm: float = 0.0
    # IP-layer maximum achievable bitrate estimate: 0.8 x MAC MABR from
    # the last (mcs, prb) (phy.cc:118-121)
    mabr_mbps: float = 0.0


class MetricsPrinter:
    HEADER = (
        "--Signal--------------DL------------------------------UL----------\n"
        "  rsrp   pl    cfo   mcs   snr  iter  brate  bler   mcs  buff  brate"
    )

    def __init__(self, out=None, period_ttis: int = 1000):
        self.out = out or sys.stdout
        self.period = period_ttis
        self._count = 0
        self._lines = 0

    def step(self, tti: int, attached: bool, phy: PhyMetricsSnapshot,
             mac_metrics) -> None:
        self._count += 1
        if self._count < self.period or not attached:
            return
        self._count = 0
        if self._lines % 10 == 0:
            print(self.HEADER, file=self.out)
        self._lines += 1
        rx_total = max(1, mac_metrics.rx_pkts + mac_metrics.rx_errors)
        bler = 100.0 * mac_metrics.rx_errors / rx_total
        print(
            f"{phy.rsrp_dbm:6.1f} {phy.pathloss_db:4.0f} {phy.cfo_hz:6.0f} "
            f"{phy.dl_mcs:5.1f} {phy.dl_snr_db:5.1f} {phy.turbo_iters:5.1f} "
            f"{_rate(mac_metrics.rx_brate)} {bler:4.0f}% "
            f"{phy.ul_mcs:5.1f} {_size(mac_metrics.ul_buffer)} "
            f"{_rate(mac_metrics.tx_brate)}",
            file=self.out,
        )


def _rate(bits_per_period: float) -> str:
    v = bits_per_period
    for unit in ("b", "k", "M", "G"):
        if v < 1000:
            return f"{v:5.1f}{unit}"
        v /= 1000
    return f"{v:5.1f}T"


def _size(n: float) -> str:
    for unit in ("B", "k", "M"):
        if n < 1000:
            return f"{n:5.0f}{unit}"
        n /= 1000
    return f"{n:5.0f}G"
