"""The port's own copy of ``srsue_tpu/ue.py`` (its reference), unchanged below this docstring.

Top-level UE — layer construction + wiring (reference: ue/src/ue.cc
ue::init at 176-182: mac.init(&phy,&rlc..), rlc.init(&pdcp..),
pdcp.init(&rlc,&rrc,&gw..), rrc.init(&phy,&mac,..), nas.init(&usim..),
gw.init(&pdcp..), usim.init).

The reference is a singleton owning all layers by value; here a plain
class owning the layer objects, wired by reference. The PHY argument is
any object implementing the small phy-interface subset MAC/RRC use
(sr_send, prach_send, pdcch search arming, set_timeadv...) — the real
receiver loop (phy.rx_chain) or a test fake.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .gw import Gw
from .mac.mac import Mac
from .nas.nas import Nas
from .pdcp import Pdcp
from .rlc import Rlc
from .rrc.rrc import Rrc
from .usim.usim import Usim, UsimConfig


class NullPhy:
    """phy_interface stub for stack-level operation/tests."""

    def sync_start(self):
        pass

    def sr_opportunity(self, tti):
        return True

    def sr_send(self, tti):
        pass

    def prach_send(self, preamble_idx, power, tti):
        return tti

    def pdcch_dl_search_rar(self, ra_rnti, start, window):
        pass

    def pdcch_dl_search_temp_crnti(self, t_crnti):
        pass

    def pdcch_dl_search_crnti(self, crnti):
        pass

    def set_timeadv(self, ta):
        pass

    def get_headroom_db(self):
        return 20.0

    def configure_ul_params(self, sib2):
        pass


@dataclass
class UeMetrics:
    rrc_state: str = "IDLE"
    emm_state: str = "DEREGISTERED"
    mac: object = None
    gw: dict = field(default_factory=dict)


class Ue:
    def __init__(self, phy=None, usim_cfg: UsimConfig | None = None):
        self.phy = phy or NullPhy()
        self.usim = Usim(usim_cfg or UsimConfig())
        self.rlc = Rlc()
        self.pdcp = Pdcp()
        self.gw = Gw()
        self.mac = Mac(rlc=self.rlc, phy=self.phy)
        self.rrc = Rrc()
        self.nas = Nas()

        # wire it up (ue.cc:176-182)
        self.rlc.pdcp = self.pdcp
        self.rlc.rrc = self.rrc
        self.pdcp.rlc = self.rlc
        self.pdcp.rrc = self.rrc
        self.pdcp.gw = self.gw
        self.gw.pdcp = self.pdcp
        self.mac.rrc = self.rrc
        self.rrc.phy = self.phy
        self.rrc.mac = self.mac
        self.rrc.rlc = self.rlc
        self.rrc.pdcp = self.pdcp
        self.rrc.nas = self.nas
        self.rrc.usim = self.usim
        self.nas.usim = self.usim
        self.nas.rrc = self.rrc
        self.nas.gw = self.gw

        self.pdcp.add_bearer(1)  # SRB1 entity ready for ConnectionSetup

    def attach(self) -> None:
        self.nas.attach_request()

    def run_tti(self, tti: int) -> None:
        self.mac.run_tti(tti)
        if hasattr(self.rrc, "step_tti"):
            self.rrc.step_tti()  # RRC-owned timers (T304)
        self.rlc.step_timers()
        self.gw.poll_ul()

    def get_metrics(self) -> UeMetrics:
        """Only meaningful when registered+connected (ue.cc:249 gating)."""
        return UeMetrics(
            rrc_state=self.rrc.state.name,
            emm_state=self.nas.state.name,
            mac=self.mac.get_metrics(),
            gw=dict(self.gw.metrics),
        )

    @property
    def is_attached(self) -> bool:
        return self.nas.is_registered
