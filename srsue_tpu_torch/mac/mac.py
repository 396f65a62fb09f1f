"""MAC main -- per-TTI engine routing PHY events to procedures and HARQ
entities (reference: ue/src/mac/mac.cc run_thread 142-213). The port's
counterpart of ``srsue_tpu/mac/mac.py`` (its reference), over the port's
DL HARQ (``dl_harq.py``, softbuffers on the codec's device) and UL HARQ.

It differs from the reference in two places only: the well-known RNTIs
come from ``rnti.py`` (one definition in the port), and ``_decode_now``
reads the decode's results through ``utils.device.to_host``.

Where the reference runs a dedicated MAC thread clocked by a condvar TTI
sync from the PHY receiver (tti_sync_cv, mac.cc:156), this engine is
stepped synchronously by the receiver loop (`run_tti`) -- deterministic,
single-threaded, batch-friendly. PHY callbacks arrive as plain method
calls (the mac_interface_phy surface, mac_interface.h:45-111):
new_grant_dl / tb_decoded / new_grant_ul / harq_recv / bch_decoded_ok.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import pdu as pdu_mod
from .demux import Demux
from .dl_harq import BCCH_PID, DlHarq
from .mux import Mux
from .proc_ra import RaConfig, RaProc
from .procs import BsrProc, PhrProc, SrProc
from .ul_harq import UlHarq
from .rnti import P_RNTI, RA_RNTI_BASE, SI_RNTI  # noqa: F401 (the MAC's names)
from ..utils.device import to_host
from ..utils.timers import TimersDb


@dataclass
class UlTx:
    """MAC -> PHY UL transmission descriptor: payload plus the redundancy
    version that must reach the waveform (ul_harq.cc rv handling; the
    rv drives PUSCH rate matching on retransmissions)."""

    payload: bytes
    rv: int = 0
    is_retx: bool = False


@dataclass
class MacMetrics:
    rx_pkts: int = 0
    rx_errors: int = 0
    rx_brate: int = 0
    tx_pkts: int = 0
    tx_errors: int = 0
    tx_brate: int = 0
    ul_buffer: int = 0


class Mac:
    """Host MAC engine. The PHY side (receiver loop) owns the device
    arrays; this class owns protocol state."""

    def __init__(self, rlc, phy, rrc=None):
        """rlc: rlc_interface_mac (get_buffer_state / read_pdu / write_pdu).
        phy: object with prach_send/set_rar_grant/sr_send hooks (subset of
        phy_interface used by MAC)."""
        self.rlc = rlc
        self.phy = phy
        self.rrc = rrc
        self.timers = TimersDb(32)

        self.demux = Demux(
            write_pdu=lambda lcid, b: rlc.write_pdu(lcid, b),
            write_pdu_bcch=lambda b: rlc.write_pdu_bcch_dlsch(b),
            on_ta=self._on_ta,
            on_con_res=self._on_con_res,
            write_pdu_pcch=lambda b: getattr(
                rlc, "write_pdu_pcch", lambda _: None)(b),
        )
        self.dl_harq = DlHarq(deliver=self._deliver)
        self.ul_harq = UlHarq()
        self.mux = Mux(
            read_pdu=lambda lcid, n: rlc.read_pdu(lcid, n),
            get_buffer_state=lambda lcid: rlc.get_buffer_state(lcid),
        )
        self.bsr = BsrProc(get_buffer_state=lambda l: rlc.get_buffer_state(l))
        self.mux.padding_bsr_cb = self.bsr.generate_padding_bsr
        self.sr = SrProc()
        self.phr = PhrProc()
        self.ra = RaProc(
            RaConfig(),
            prach_send=self._prach_send,
            start_rar_search=self._start_rar_search,
            send_msg3=self._send_msg3,
            on_complete=self._ra_complete,
            on_timing_advance=self._on_ta,
        )

        self.crnti: int = 0
        self.temp_crnti: int = 0
        self.contention_id: bytes = b""
        self.tti: int = 0
        self.metrics = MacMetrics()
        self.pcap = None  # MacPcap instance (utils/pcap.py), set by the app
        # timeAlignmentTimer (36.321 §5.2; expiry flushes HARQ and stops
        # UL transmission until the next RA — mac.cc:358-362)
        self.time_alignment_timer = self.timers.get_unique()
        self.time_alignment_timer.set(10240, self._time_alignment_expired)
        self.ul_time_aligned = False
        self._rar_window: tuple[int, int, int] | None = None  # (ra_rnti, start, len)
        self._pending_msg3: bytes | None = None
        self._deliver_temp_crnti = False

    # ------------------------------------------------------------------ TTI
    def run_tti(self, tti: int) -> None:
        """One MAC step (the reference's run_thread body per TTI)."""
        self.tti = tti
        self.bsr.step(tti)
        self.phr.step(tti)
        if self.bsr.sr_needed and self.crnti:
            self.sr.start()
            self.bsr.sr_needed = False
        if self.sr.step(tti, sr_opportunity=self.phy.sr_opportunity(tti)):
            self.phy.sr_send(tti)
        if self.sr.ra_needed or (self.bsr.sr_needed and not self.crnti):
            self.sr.reset()
            if not self.ra.is_running:
                self._start_ra_for_sr()
        self.ra.step(tti)
        self.mux.step_bj()
        self.timers.step_all()

    # ------------------------------------------------- PHY -> MAC callbacks
    def bch_decoded_ok(self, payload: bytes) -> None:
        if self.rrc is not None:
            self.rrc.write_pdu_bcch_bch(payload)

    def new_grant_dl(self, pid: int, grant, rnti: int, rnti_type: str):
        """PHY found a DL grant. Returns (decode_enabled, is_new_tx) — the
        dl_action equivalent."""
        if rnti_type == "SI":
            return True, self.dl_harq.new_grant_dl(BCCH_PID, grant)
        if rnti_type == "RAR":
            return True, True
        is_new = self.dl_harq.new_grant_dl(pid, grant)
        if rnti_type == "TEMP_CRNTI":
            self._deliver_temp_crnti = True
        return True, is_new

    def tb_decoded(self, pid: int, codec, softbuffers, rnti_type: str = "CRNTI") -> bool:
        """PHY decoded (or failed) a TB; combine + deliver. Returns ACK."""
        if rnti_type == "RAR":
            payload, ok = self._decode_now(codec, softbuffers)
            if ok:
                self.ra.rar_received(payload)
            return ok
        if rnti_type == "PAGING":
            payload, ok = self._decode_now(codec, softbuffers)
            if ok:
                self.demux.push_pdu_pcch(payload)
                self.metrics.rx_pkts += 1
            return ok
        if rnti_type == "SI":
            p = self.dl_harq.procs[BCCH_PID]
            payload, ok = self._decode_now(codec, softbuffers)
            if ok:
                self.demux.push_pdu_bcch(payload)
                self.metrics.rx_pkts += 1
                self.metrics.rx_brate += 8 * len(payload)
            else:
                self.metrics.rx_errors += 1
            return ok
        ok = self.dl_harq.tb_decoded(pid, codec, softbuffers)
        if ok:
            self.metrics.rx_pkts += 1
            self.metrics.rx_brate += codec.grant.tbs
            if self.pcap and self.dl_harq.procs[pid].payload:
                self.pcap.write_dl_crnti(
                    self.dl_harq.procs[pid].payload, self.crnti, self.tti
                )
        else:
            self.metrics.rx_errors += 1
        return ok

    def _decode_now(self, codec, softbuffers) -> tuple[bytes, bool]:
        payload, tb_ok, _, _ = codec.decode_softbuffers(softbuffers)
        ok = bool(to_host(tb_ok).all())
        bits = to_host(payload).astype(np.uint8).reshape(-1)
        return pdu_mod.bits_to_bytes(bits), ok

    def new_grant_ul(self, tti_tx: int, grant_bytes: int,
                     adaptive_rv: int | None = None,
                     ndi: bool | None = None) -> UlTx | None:
        """UL grant for tti_tx: assemble a new PDU, or hand back an
        adaptive retransmission when the grant's NDI is NOT toggled for
        this pid (36.321 §5.4.2.1 / ul_harq.cc:216-249)."""
        if not self.ul_harq.is_new_tx(tti_tx, ndi):
            r = self.ul_harq.retx(tti_tx, adaptive_rv)
            if r is not None:
                self.metrics.tx_pkts += 1
                return UlTx(r[0], r[1], is_retx=True)
            return None
        if self.mux.msg3_is_pending():
            payload = self.mux.msg3_get(grant_bytes)
            self.mux.msg3_flush()
            self.ul_harq.new_tx(tti_tx, payload, is_msg3=True, ndi=ndi)
            self.metrics.tx_pkts += 1
            if self.pcap:
                self.pcap.write_ul_crnti(payload, self.temp_crnti, tti_tx)
            return UlTx(payload)
        if self.bsr.triggered:
            gen = self.bsr.generate_bsr()
            if gen:
                self.mux.pending_bsr_lcid, self.mux.pending_bsr = gen[0], gen[1]
        phr = self.phr.generate_phr(self.phy.get_headroom_db())
        if phr is not None:
            self.mux.pending_phr = phr
        payload = self.mux.pdu_get(grant_bytes)
        self.ul_harq.new_tx(tti_tx, payload, ndi=ndi)
        self.metrics.tx_pkts += 1
        self.metrics.tx_brate += 8 * grant_bytes
        if self.pcap:
            self.pcap.write_ul_crnti(payload, self.crnti, tti_tx)
        return UlTx(payload)

    def ul_retx(self, tti_tx: int) -> UlTx | None:
        """Autonomous NON-ADAPTIVE retransmission at the retx opportunity
        of the process that was NACKed on PHICH (no new grant; same pid,
        next rv in {0,2,3,1} — ul_harq.cc:216-249)."""
        if not self.ul_harq.has_pending(tti_tx):
            return None
        r = self.ul_harq.retx(tti_tx, adaptive_rv=None)
        if r is None:
            return None
        self.metrics.tx_pkts += 1
        return UlTx(r[0], r[1], is_retx=True)

    def harq_recv(self, tti_tx: int, ack: bool) -> None:
        self.ul_harq.harq_feedback(tti_tx, ack)
        if not ack:
            self.metrics.tx_errors += 1

    # ------------------------------------------------------- RA wiring
    def start_ra(self, ccch_sdu: bytes, contention_id: bytes | None = None) -> None:
        """RRC has a CCCH message (ConnectionRequest) -> RA with Msg3
        (the mac.cc:186-190 mux-has-CCCH path). The contention-resolution
        identity is the first 48 bits of the Msg3 CCCH SDU (36.321
        §5.1.5) unless explicitly overridden."""
        if contention_id is None:
            contention_id = ccch_sdu[:6].ljust(6, b"\x00")
        self.contention_id = contention_id
        self.ra.start(ccch_sdu, contention_id)

    def _start_ra_for_sr(self) -> None:
        if self.crnti:
            self.mux.pending_crnti = self.crnti
            self.ra.start(b"", self.contention_id or b"\x00" * 6)

    def _prach_send(self, preamble_idx: int, power: float) -> int:
        return self.phy.prach_send(preamble_idx, power, self.tti)

    def _start_rar_search(self, ra_rnti: int, window: int) -> None:
        self._rar_window = (ra_rnti, self.tti + 3, window)
        self.phy.pdcch_dl_search_rar(ra_rnti, self.tti + 3, window)

    def _send_msg3(self, msg3: bytes, t_crnti: int) -> None:
        self.temp_crnti = t_crnti
        self.mux.msg3_prepare(msg3)
        self.phy.pdcch_dl_search_temp_crnti(t_crnti)

    def _ra_complete(self, crnti: int) -> None:
        self.crnti = crnti
        self.temp_crnti = 0
        self._deliver_temp_crnti = False
        self.phy.pdcch_dl_search_crnti(crnti)
        if self.rrc is not None:
            self.rrc.ra_completed()

    # ------------------------------------------------------- demux hooks
    def _deliver(self, pid: int, payload: bytes) -> None:
        if self._deliver_temp_crnti:
            self._deliver_temp_crnti = False
            self.demux.push_pdu_temp_crnti(payload)
        else:
            self.demux.push_pdu(payload)

    def _on_ta(self, ta: int) -> None:
        self.phy.set_timeadv(ta)
        self.ul_time_aligned = True
        self.time_alignment_timer.run()

    def _time_alignment_expired(self, timer_id: int) -> None:
        """timeAlignmentTimerExpire (mac.cc:358-362): flush HARQ buffers,
        UL out of sync until the next RA."""
        self.ul_time_aligned = False
        self.dl_harq.reset()
        self.ul_harq.reset()

    def set_time_alignment_timer(self, ttis: int) -> None:
        """SIB2 timeAlignmentTimer config fan-out."""
        self.time_alignment_timer.set(ttis, self._time_alignment_expired)

    def _on_con_res(self, crid: bytes) -> bool:
        return self.ra.con_res_id_received(crid)

    def reset(self) -> None:
        """MAC reset (36.321 §5.9, used by RRC re-establishment
        36.331 §5.3.7.2): flush HARQ buffers, cancel SR/BSR triggers,
        flush Msg3, discard the temporary C-RNTI, and consider the
        timeAlignmentTimer expired. The C-RNTI itself is an RRC variable
        (kept — the re-establishment request carries it)."""
        self.dl_harq.reset()
        self.ul_harq.reset()
        self.mux.msg3_flush()
        self.ra.reset()
        self.sr.reset()
        self.bsr.triggered = False
        self.bsr.sr_needed = False
        self.temp_crnti = 0
        self._deliver_temp_crnti = False
        self._rar_window = None
        self.time_alignment_timer.stop()
        self.ul_time_aligned = False

    def get_metrics(self) -> MacMetrics:
        """Interval semantics: zeroed on read (mac.cc:395-400)."""
        m = self.metrics
        self.metrics = MacMetrics()
        m.ul_buffer = sum(
            self.rlc.get_buffer_state(l) for l in self.mux.channels
        )
        return m
