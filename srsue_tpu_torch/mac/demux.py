"""The port's own copy of ``srsue_tpu/mac/demux.py`` (its reference), unchanged below this docstring.

MAC demux — routing decoded DL-SCH PDUs up the stack
(reference: ue/src/mac/demux.cc).

Parses MAC PDUs (SDU subheaders + CEs), routes SDUs to RLC by LCID,
handles TA and contention-resolution CEs, BCCH passthrough
(demux.cc:134-155), and the temp-CRNTI PDU hold for contention
resolution (demux.cc:98-128). The reference's lock-free qbuff rings are a
threading artifact; here delivery is a direct call in deterministic batch
order (SURVEY.md §2.8 mapping).
"""

from __future__ import annotations

from typing import Callable

from . import pdu as pdu_mod


class Demux:
    def __init__(
        self,
        write_pdu: Callable[[int, bytes], None],
        write_pdu_bcch: Callable[[bytes], None] | None = None,
        on_ta: Callable[[int], None] | None = None,
        on_con_res: Callable[[bytes], bool] | None = None,
        write_pdu_pcch: Callable[[bytes], None] | None = None,
    ):
        self.write_pdu = write_pdu
        self.write_pdu_bcch = write_pdu_bcch or (lambda b: None)
        self.write_pdu_pcch = write_pdu_pcch or (lambda b: None)
        self.on_ta = on_ta or (lambda ta: None)
        self.on_con_res = on_con_res or (lambda uecrid: True)
        self.metrics = {"rx_pdus": 0, "rx_bytes": 0}

    def push_pdu_bcch(self, data: bytes) -> None:
        """BCCH bypasses MAC subheader parsing entirely (demux.cc:134-155)."""
        self.write_pdu_bcch(data)

    def push_pdu_pcch(self, data: bytes) -> None:
        """PCCH rides a transparent MAC PDU like BCCH (capability-plus;
        the reference has no paging support at all)."""
        self.write_pdu_pcch(data)

    def push_pdu(self, data: bytes) -> None:
        mac_pdu = pdu_mod.unpack(data, uplink=False)
        self._process(mac_pdu)

    def push_pdu_temp_crnti(self, data: bytes) -> bool:
        """Msg4 path: the PDU must carry a CON_RES CE matching our UE-CRID
        before its SDUs are delivered (demux.cc:98-128). Returns whether
        contention resolution succeeded."""
        mac_pdu = pdu_mod.unpack(data, uplink=False)
        matched = False
        for sh in mac_pdu.subheaders:
            if sh.lcid == pdu_mod.LCID_CON_RES:
                matched = self.on_con_res(
                    pdu_mod.ce_contention_resolution(sh.payload)
                )
        if matched:
            self._process(mac_pdu, skip_con_res=True)
        return matched

    def _process(self, mac_pdu: pdu_mod.MacPdu, skip_con_res: bool = False) -> None:
        for sh in mac_pdu.subheaders:
            if sh.lcid == pdu_mod.LCID_TA:
                self.on_ta(pdu_mod.ce_timing_advance(sh.payload))
            elif sh.lcid == pdu_mod.LCID_CON_RES:
                if not skip_con_res:
                    self.on_con_res(pdu_mod.ce_contention_resolution(sh.payload))
            elif sh.lcid == pdu_mod.LCID_DRX:
                pass
            elif sh.lcid <= 10:  # logical channel SDU
                self.metrics["rx_pdus"] += 1
                self.metrics["rx_bytes"] += len(sh.payload)
                self.write_pdu(sh.lcid, sh.payload)
