"""The port's own copy of ``srsue_tpu/rlc/rlc.py`` (its reference), unchanged below this docstring.

RLC container — bearer array + mode dispatch (reference:
ue/src/upper/rlc.cc: 11 bearers = 3 SRB + 8 DRB, default SRB1/2 AM
config at rlc.cc:123-141, BCCH passthrough at rlc.cc:102-118)."""

from __future__ import annotations

from enum import Enum

from .rlc_am import AmConfig, RlcAm
from .rlc_tm import RlcTm
from .rlc_um import RlcUm, UmConfig

N_BEARERS = 11  # SRSUE_N_RADIO_BEARERS


class RlcMode(Enum):
    TM = "tm"
    UM = "um"
    AM = "am"


class Rlc:
    """rlc_interface_mac (get_buffer_state/read_pdu/write_pdu by lcid) +
    rlc_interface_pdcp (write_sdu) + rlc_interface_rrc (add_bearer)."""

    def __init__(self, pdcp=None, rrc=None):
        self.pdcp = pdcp
        self.rrc = rrc
        self.bearers: dict[int, object] = {}
        # SRB0 always exists in TM (rlc.cc default)
        self.add_bearer(0, RlcMode.TM)

    def _write_up(self, lcid: int):
        def f(sdu: bytes) -> None:
            if self.pdcp is not None:
                self.pdcp.write_pdu(lcid, sdu)

        return f

    def _on_max_retx(self):
        def f() -> None:
            if self.rrc is not None:
                self.rrc.max_retx_attempted()

        return f

    def add_bearer(self, lcid: int, mode: RlcMode, cfg=None) -> None:
        if lcid in self.bearers:
            return
        if mode == RlcMode.TM:
            self.bearers[lcid] = RlcTm(write_up=self._write_up(lcid))
        elif mode == RlcMode.UM:
            self.bearers[lcid] = RlcUm(cfg or UmConfig(), write_up=self._write_up(lcid))
        else:
            self.bearers[lcid] = RlcAm(
                cfg or AmConfig(),
                write_up=self._write_up(lcid),
                on_max_retx=self._on_max_retx(),
            )

    def add_bearer_default_srb(self, lcid: int) -> None:
        """SRB1/SRB2 default AM configuration (rlc.cc:123-141)."""
        self.add_bearer(
            lcid,
            RlcMode.AM,
            AmConfig(t_poll_retx=45, poll_pdu=0x7FFFFFFF, poll_byte=0x7FFFFFFF,
                     max_retx_thresh=4, t_reordering=35, t_status_prohibit=0),
        )

    # ----------------------------------------------------- MAC interface
    def get_buffer_state(self, lcid: int) -> int:
        b = self.bearers.get(lcid)
        return b.get_buffer_state() if b else 0

    def read_pdu(self, lcid: int, nof_bytes: int) -> bytes:
        b = self.bearers.get(lcid)
        return b.read_pdu(nof_bytes) if b else b""

    def write_pdu(self, lcid: int, pdu: bytes) -> None:
        b = self.bearers.get(lcid)
        if b:
            b.write_pdu(pdu)

    def write_pdu_bcch_bch(self, pdu: bytes) -> None:
        if self.pdcp is not None:
            self.pdcp.write_pdu_bcch_bch(pdu)

    def write_pdu_bcch_dlsch(self, pdu: bytes) -> None:
        if self.pdcp is not None:
            self.pdcp.write_pdu_bcch_dlsch(pdu)

    def write_pdu_pcch(self, pdu: bytes) -> None:
        if self.pdcp is not None:
            self.pdcp.write_pdu_pcch(pdu)

    # ----------------------------------------------------- PDCP interface
    def write_sdu(self, lcid: int, sdu: bytes) -> None:
        b = self.bearers.get(lcid)
        if b:
            b.write_sdu(sdu)

    # ----------------------------------------------------- housekeeping
    def step_timers(self) -> None:
        for b in self.bearers.values():
            if hasattr(b, "step_timers"):
                b.step_timers()

    def reestablish(self) -> None:
        for b in self.bearers.values():
            b.reestablish()
