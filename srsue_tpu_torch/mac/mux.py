"""The port's own copy of ``srsue_tpu/mac/mux.py`` (its reference), unchanged below this docstring.

MAC mux — UL PDU assembly with logical channel prioritization
(36.321 §5.4.3; reference: ue/src/mac/mux.cc).

Token-bucket LCP: each logical channel has priority, PBR (prioritized bit
rate) and BSD (bucket size duration); Bj accumulates PBR per TTI and is
spent on allocation round 1; round 2 serves channels in strict priority
until the grant is full (mux.cc:137-230). Also inserts C-RNTI / BSR / PHR
control elements and manages the Msg3 buffer (mux.h:57-60).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from . import pdu as pdu_mod


@dataclass
class LogicalChannel:
    lcid: int
    priority: int  # lower value = higher priority
    pbr_bytes_per_tti: float  # -1 => infinite
    bsd_ttis: int = 100
    bj: float = 0.0


class Mux:
    """read_pdu(lcid, n) pulls up to n bytes from RLC (rlc_interface_mac);
    get_buffer_state(lcid) returns queued bytes."""

    def __init__(
        self,
        read_pdu: Callable[[int, int], bytes],
        get_buffer_state: Callable[[int], int],
    ):
        self.read_pdu = read_pdu
        self.get_buffer_state = get_buffer_state
        self.channels: dict[int, LogicalChannel] = {}
        self.pending_crnti: int | None = None
        self.pending_bsr: bytes | None = None
        self.pending_bsr_lcid: int | None = None
        self.pending_phr: int | None = None
        self.msg3_buf: bytes | None = None
        # padding-BSR hook (proc_bsr.cc:310 via mux.cc:137-230): wired by
        # MAC to BsrProc.generate_padding_bsr
        self.padding_bsr_cb: Callable[[int], tuple[int, bytes] | None] | None = None

    def set_priority(
        self, lcid: int, priority: int, pbr_bytes_per_tti: float = -1, bsd: int = 100
    ) -> None:
        self.channels[lcid] = LogicalChannel(lcid, priority, pbr_bytes_per_tti, bsd)

    def step_bj(self) -> None:
        """Advance token buckets by one TTI."""
        for ch in self.channels.values():
            if ch.pbr_bytes_per_tti >= 0:
                cap = ch.pbr_bytes_per_tti * ch.bsd_ttis
                ch.bj = min(ch.bj + ch.pbr_bytes_per_tti, cap)

    def pdu_get(self, grant_bytes: int) -> bytes:
        """Assemble one UL-SCH MAC PDU of exactly grant_bytes."""
        mac_pdu = pdu_mod.MacPdu()
        space = grant_bytes

        def sh_cost(payload_len: int) -> int:
            return payload_len + (2 if payload_len < 128 else 3)

        if self.pending_crnti is not None and space >= 3:
            mac_pdu.add_ce(pdu_mod.LCID_CRNTI, pdu_mod.make_ce_crnti(self.pending_crnti))
            space -= 3
            self.pending_crnti = None
        if self.pending_bsr is not None and space >= 1 + len(self.pending_bsr):
            mac_pdu.add_ce(self.pending_bsr_lcid, self.pending_bsr)
            space -= 1 + len(self.pending_bsr)
            self.pending_bsr = None
        if self.pending_phr is not None and space >= 2:
            mac_pdu.add_ce(pdu_mod.LCID_PHR, pdu_mod.make_ce_phr(self.pending_phr))
            space -= 2
            self.pending_phr = None

        order = sorted(self.channels.values(), key=lambda c: c.priority)
        # round 1: serve up to Bj per channel in priority order
        for ch in order:
            if space <= 2:
                break
            if ch.pbr_bytes_per_tti < 0:
                continue
            avail = self.get_buffer_state(ch.lcid)
            want = min(int(ch.bj), avail, space - 2)
            if want <= 0:
                continue
            data = self.read_pdu(ch.lcid, want)
            if data:
                ch.bj -= len(data)
                mac_pdu.add_sdu(ch.lcid, data)
                space -= sh_cost(len(data))
        # round 2: strict priority until grant exhausted
        for ch in order:
            while space > 2 and self.get_buffer_state(ch.lcid) > 0:
                data = self.read_pdu(ch.lcid, space - 2)
                if not data:
                    break
                mac_pdu.add_sdu(ch.lcid, data)
                space -= sh_cost(len(data))
        # leftover grant: padding BSR (short/truncated/long by room,
        # 36.321 §5.4.5 / proc_bsr.cc generate_padding_bsr)
        if space >= 2 and self.padding_bsr_cb is not None:
            gen = self.padding_bsr_cb(space)
            if gen is not None:
                mac_pdu.add_ce(gen[0], gen[1])
                space -= 1 + len(gen[1])
        return pdu_mod.pack(mac_pdu, grant_bytes, uplink=True)

    # --- Msg3 (mux.h:57-60) ------------------------------------------------
    def msg3_prepare(self, data: bytes) -> None:
        self.msg3_buf = data

    def msg3_get(self, grant_bytes: int) -> bytes:
        assert self.msg3_buf is not None
        mac_pdu = pdu_mod.MacPdu()
        if self.pending_crnti is not None and grant_bytes >= 3 + len(self.msg3_buf) + 1:
            mac_pdu.add_ce(pdu_mod.LCID_CRNTI, pdu_mod.make_ce_crnti(self.pending_crnti))
            self.pending_crnti = None
        mac_pdu.add_sdu(pdu_mod.LCID_CCCH, self.msg3_buf)
        return pdu_mod.pack(mac_pdu, grant_bytes, uplink=True)

    def msg3_flush(self) -> None:
        self.msg3_buf = None

    def msg3_is_pending(self) -> bool:
        return self.msg3_buf is not None
