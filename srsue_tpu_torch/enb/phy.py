"""eNB PHY + scheduler emulator — generates real downlink subframe
waveforms per TTI and receives the UE's uplink waveforms (PRACH detect,
PUSCH decode with HARQ soft-combining, PUCCH SR/HARQ-ACK/CQI detection,
SRS detection).

The reference's PHY/MAC tests run against a live commercial eNodeB over
the air (SURVEY.md §4.3); this module is the hermetic stand-in: a
time-master that schedules SIBs (SI windows), answers PRACH with RARs,
grants Msg3/UL, carries the EnbStack's RLC PDUs on PDSCH, and closes
BOTH HARQ feedback loops:

* DL: every C-RNTI PDSCH is watched for HARQ-ACK 4 TTIs later (PUCCH 1a
  at n1PucchAN + first CCE, or multiplexed on PUSCH); NACK/DTX queues a
  retransmission of the SAME TB with the next rv of {0,2,3,1} and an
  un-toggled NDI, so the UE soft-combines (dl_harq.cc:164-171 dual).
* UL: PUSCH CRC failure answers NACK on the PHICH resource derived from
  the allocation (36.213 §9.1.2) and keeps the dematched softbuffers;
  the UE's autonomous retransmission (rv sequence {0,2,3,1}) at tti+8
  is expected and soft-combined before re-decoding.

Remaining simplification (documented, not hidden): one UL grant profile.

The port's counterpart of ``srsue_tpu/enb/phy.py`` (its reference), over
the port's PHY. The downlink is built on the host, as in the reference
(``enb_tx``, the control-channel mappers, ``pbch.encode`` and the PDSCH
encoder). The uplink is received on ``device`` (the card unless the caller
passes "cpu"): the OFDM demod whose grid PUCCH, CQI and SRS detection read
back on the host, and the PUSCH decode (``PuschCodec.dematch_sf``, the
HARQ combining of the kept softbuffers, ``decode_softbuffers`` through the
r2max BCJR half). PRACH detection stays host numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..mac import pdu as pdu_mod
from ..phy import control, dci, enb_tx, ofdm, pbch, prach, pucch, pusch, ra
from ..phy.cell import Cell, UlGrant
from ..phy.pdsch import codec as pdsch_codec
from ..rrc.si_sched import paging_occasion, sib1_occasion
from ..utils.device import resolve, to_host
from .stack import EnbStack

RA_RESPONSE_DELAY = 4
MSG3_DELAY = 4
CFI = 2
RV_SEQ = (0, 2, 3, 1)


@dataclass
class _DlTx:
    """A C-RNTI DL-SCH transmission awaiting HARQ-ACK (retx record)."""

    payload: bytes
    n_prb_alloc: int
    mcs: int
    ndi: bool
    temp_crnti: bool = False
    irv: int = 0
    n_tx: int = 1


class EnbPhy:
    """Drives an EnbStack over real waveforms, one subframe per tti()."""

    MAX_DL_TX = 4

    def __init__(self, cell: Cell, stack: EnbStack, seed: int = 0,
                 prach_root: int = 128, prach_zcorr: int = 5,
                 n1_pucch_an: int = 2, device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.cell = cell
        self.stack = stack
        self.tm2 = cell.n_ports == 2  # transmit diversity on ALL DL channels
        self.rng = np.random.default_rng(seed)
        self.prach_root = prach_root
        self.prach_zcorr = prach_zcorr
        self.n1_pucch_an = n1_pucch_an
        self.crnti = stack.t_crnti
        self.sfn = 0
        # pending transmissions keyed by tti
        self._rar_at: dict[int, int] = {}  # tti -> preamble idx
        # tti the UE must TX in -> (grant, rv, is_retx)
        self._ul_grants: dict[int, tuple[UlGrant, int, bool]] = {}
        self._msg3_tti: int | None = None
        self._ue_connected = False
        self._need_con_res = False
        self._phich_at: dict[int, tuple[bool, int]] = {}  # tti -> (ack, prb)
        self._page_pending: tuple[int, bytes] | None = None  # (ue_id, pcch)
        self._page_t_drx = 128
        self._page_nb_t = 1.0
        self.events: list[str] = []
        self._mcs_data = 6
        self._ul_mcs = 4
        # closed-loop UL power control: target rx level locked to the
        # first decoded PUSCH; each UL DCI 0 carries a TPC command
        # steering the UE back to it (36.213 §5.1.1.1 accumulated mode)
        self._tpc_rx_target_db: float | None = None
        self._next_tpc = 1  # index 1 = 0 dB (neutral) until locked
        self.rar_ta = 0  # TA command sent in RARs (the eNB's timing cmd)
        self._ndi = False
        self._ul_ndi = False
        # DL HARQ watch: ack tti -> (n_pucch, _DlTx record)
        self._dl_ack_at: dict[int, tuple[int, _DlTx]] = {}
        self._dl_retx: _DlTx | None = None
        # UL HARQ soft state per pid
        self._ul_soft: dict[int, list] = {}
        # UE UL control config mirrors (the eNB configured them via RRC:
        # the stack's ConnectionSetup carries cqi_pmi_ConfigIndex=40 on
        # PUCCH resource 0; armed when the UE ACKs Msg4, i.e. after it
        # applied the dedicated config)
        self.dedicated_cqi: tuple | None = (40, 0)  # (index, n_pucch)
        self.cqi_cfg: tuple | None = None  # (index, n_pucch, subband_k)
        self.srs_cfg: tuple[int, int] | None = None  # (index, n_prb_srs)
        self.cqi_reports: list[tuple[int, int]] = []  # (tti, cqi)
        self.srs_detects: list[tuple[int, float]] = []
        self.ul_power_log: list[tuple[int, float]] = []  # (tti, mean amp^2)
        # fixed allocation buckets: keeps the number of distinct jitted
        # PDSCH configurations (and test compile time) small
        self._alloc_buckets = [4, 10, min(25, cell.n_prb), cell.n_prb]

    # ------------------------------------------------------------- downlink
    def build_dl_subframe(self, tti: int) -> np.ndarray:
        cell = self.cell
        sf = tti % 10
        self.sfn = tti // 10
        n_ports = 2 if self.tm2 else 1
        grids = [enb_tx.empty_grid(cell) for _ in range(n_ports)]
        grid = grids[0]
        for p in range(n_ports):
            enb_tx.add_crs(cell, grids[p], sf, p)
        enb_tx.add_sync(cell, grid, sf)
        if self.tm2:
            control.pcfich_map_tm2(cell, grids, sf, CFI)
        else:
            control.pcfich_map(cell, grid, sf, CFI)

        ph = self._phich_at.pop(tti, None)
        if ph is not None:
            ack, lowest_prb = ph
            grp, seq = control.phich_group_seq(
                lowest_prb, 0, control.n_phich_groups(cell))
            if self.tm2:
                control.phich_map_tm2(cell, grids, sf, grp, seq, ack)
            else:
                control.phich_map(cell, grid, sf, grp, seq, ack)

        if sf == 0:
            mib = pbch.Mib(cell.n_prb, "normal", 1.0, self.sfn)
            cw = pbch.encode(cell, mib, n_ports=n_ports)
            syms = pbch.frame_symbols(cell, cw, self.sfn % 4)
            if self.tm2:
                pbch.map_to_grid_tm2(cell, grids, syms)
            else:
                pbch.map_to_grid(cell, grid, syms)
        if sib1_occasion(tti):
            self._map_dlsch(grids, tti, self.stack.make_sib1(), 0xFFFF,
                            bcch=True)
        elif sf == 1 and self.sfn % 2 == 0:
            self._map_dlsch(grids, tti, self.stack.make_sib2(), 0xFFFF,
                            bcch=True)
        elif self._page_pending is not None and paging_occasion(
                tti, self._page_pending[0], n_b_t=self._page_nb_t,
                t_drx=self._page_t_drx):
            _, pcch = self._page_pending
            self._page_pending = None
            self._map_dlsch(grids, tti, pcch, 0xFFFE, bcch=True)
            self.events.append("paging_sent")
        elif tti in self._rar_at:
            idx = self._rar_at.pop(tti)
            msg3_tti = tti + MSG3_DELAY
            g20 = pdu_mod.RarGrant(False, dci.riv_encode(cell.n_prb, 0, 4),
                                   self._ul_mcs, 0, False, False)
            self._ul_grants[msg3_tti] = (
                dci.rar_to_ul_grant(cell, g20), 0, False)
            self._msg3_tti = msg3_tti
            rar = pdu_mod.Rar(idx, ta=self.rar_ta, grant=g20,
                              t_crnti=self.crnti)
            ra_rnti = getattr(self, "_rar_rnti", 1 + (tti % 10))
            self._map_dlsch(grids, tti, pdu_mod.pack_rar_pdu([rar], pdu_len=16),
                            ra_rnti)
            self.events.append("rar_sent")
        else:
            sent = False
            if sf in (3, 7):
                if self._dl_retx is not None:
                    rec = self._dl_retx
                    self._dl_retx = None
                    self._map_dlsch_rec(grids, tti, rec)
                    self.events.append(f"dl_retx_rv{RV_SEQ[rec.irv]}")
                    sent = True
                elif not self._dl_pid_busy():
                    # the single DL HARQ pid stays busy until ACK or drop:
                    # a new TB would toggle NDI and flush the UE's
                    # softbuffer mid-combining
                    sent = self._drain_stack_dl(grids, tti)
            if (not sent and self._ue_connected and sf == 4
                    and tti + MSG3_DELAY not in self._ul_grants):
                # periodic UL grant (DCI format 0 on the UE's C-RNTI);
                # NDI toggles per new transmission (36.321 §5.4.2.1).
                # Never granted on top of a pending retx expectation —
                # the synchronous HARQ pid is busy until ACK/max-retx.
                self._ul_ndi = not self._ul_ndi
                d0 = dci.Dci0(riv=dci.riv_encode(cell.n_prb, 0, 4),
                              mcs=self._ul_mcs, ndi=self._ul_ndi,
                              tpc=self._next_tpc)
                self._ul_grants[tti + MSG3_DELAY] = (
                    dci.dci0_to_grant(cell, d0), 0, False)
                n_cce, _ = control.pdcch_geometry(cell, CFI)
                cands = control.search_space_candidates(n_cce, self.crnti, sf)
                start, l = [c for c in cands if c[1] >= 4][0]
                if self.tm2:
                    control.pdcch_map_tm2(cell, grids, sf, CFI,
                                          dci.pack_0(cell.n_prb, d0),
                                          self.crnti, start, l)
                else:
                    control.pdcch_map(cell, grid, sf, CFI,
                                      dci.pack_0(cell.n_prb, d0), self.crnti,
                                      start, l)

        wfs = enb_tx.to_waveform(self.cell, grids)
        return wfs[0] if len(wfs) == 1 else np.sum(wfs, axis=0)

    def page(self, imsi: str, t_drx: int = 128, n_b_t: float = 1.0) -> None:
        """Queue a Paging message for the UE; transmitted with P-RNTI at
        the UE's next paging occasion (36.304 §7)."""
        self._page_pending = (int(imsi) % 1024, self.stack.make_paging(imsi))
        self._page_t_drx = t_drx
        self._page_nb_t = n_b_t

    def _dl_pid_busy(self) -> bool:
        return self._dl_retx is not None or bool(self._dl_ack_at)

    def _drain_stack_dl(self, grids, tti) -> bool:
        """Carry one pending SRB PDU (with Msg4 CON_RES when needed)."""
        ob = getattr(self.stack, "_ho_outbox", None)
        if ob:
            # source-role: the handover command was drained from the
            # source SRB1 at initiate_handover (under the OLD keys) —
            # carry it over the air on this cell's PDSCH
            pdu = ob.pop(0)
            mac_pdu = pdu_mod.MacPdu()
            mac_pdu.add_sdu(1, pdu)
            raw = pdu_mod.pack(mac_pdu, len(pdu) + 12)
            self._map_dlsch(grids, tti, raw, self.crnti)
            self.events.append("ho_cmd_dl")
            return True
        for lcid, ent in ((0, self.stack.srb0), (1, self.stack.srb1),
                          (3, self.stack.drb)):
            pdu = ent.read_pdu(200)
            if not pdu:
                continue
            mac_pdu = pdu_mod.MacPdu()
            t_crnti = False
            if lcid == 0 and self._need_con_res:
                # Msg4: contention resolution CE + the DL-CCCH SDU
                mac_pdu.add_ce(pdu_mod.LCID_CON_RES, self._msg3_crid)
                self._need_con_res = False
                t_crnti = True
            mac_pdu.add_sdu(lcid, pdu)
            raw = pdu_mod.pack(mac_pdu, len(pdu) + 12)
            self._map_dlsch(grids, tti, raw, self.crnti, temp_crnti=t_crnti)
            self.events.append(f"dl_lcid{lcid}")
            return True
        return False

    def _pick_alloc(self, payload: bytes, mcs: int) -> int:
        for n_prb in self._alloc_buckets:
            g = ra.dl_grant(self.cell.n_prb, mcs, n_prb_alloc=n_prb)
            if g.tbs >= 8 * len(payload):
                return n_prb
        return self.cell.n_prb

    def _map_dlsch(self, grids, tti: int, payload: bytes, rnti: int,
                   bcch: bool = False, temp_crnti: bool = False):
        if not bcch and rnti == self.crnti:
            self._ndi = not self._ndi  # NDI toggle: new DL-SCH TB
            rec = _DlTx(payload, self._pick_alloc(payload, self._mcs_data),
                        self._mcs_data, self._ndi, temp_crnti)
            self._map_dlsch_rec(grids, tti, rec)
            return
        self._map_dlsch_raw(grids, tti, payload, rnti,
                            self._pick_alloc(payload, self._mcs_data),
                            self._mcs_data, ndi=self._ndi, rv=0,
                            watch_ack=False)

    def _map_dlsch_rec(self, grids, tti: int, rec: _DlTx):
        start_cce = self._map_dlsch_raw(
            grids, tti, rec.payload, self.crnti, rec.n_prb_alloc, rec.mcs,
            ndi=rec.ndi, rv=RV_SEQ[rec.irv], watch_ack=True,
        )
        # HARQ-ACK expected 4 TTIs later on n1PucchAN + first CCE
        self._dl_ack_at[tti + 4] = (self.n1_pucch_an + start_cce, rec)

    def _map_dlsch_raw(self, grids, tti: int, payload: bytes, rnti: int,
                       n_prb_alloc: int, mcs: int, ndi: bool, rv: int,
                       watch_ack: bool) -> int:
        cell = self.cell
        sf = tti % 10
        g = replace(ra.dl_grant(cell.n_prb, mcs, n_prb_alloc=n_prb_alloc),
                    rv=rv, ndi=ndi)
        # the eNB only encodes its DL (host numpy): no decoder tables on the card
        codec = pdsch_codec(cell, g, rnti, sf, CFI, device="cpu")
        d = dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, g.n_prb), mcs=mcs,
                      harq_pid=0, ndi=ndi, rv=rv, tpc=0)
        if rnti >= 0xFFFE or rnti <= 10:
            start, l = 0, 4  # common search space (SI/P/RA-RNTI)
        else:
            n_cce, _ = control.pdcch_geometry(cell, CFI)
            cands = control.search_space_candidates(n_cce, rnti, sf)
            start, l = [c for c in cands if c[1] >= 4][0]
        bits = np.zeros(g.tbs, np.uint8)
        pb = np.unpackbits(np.frombuffer(payload, np.uint8))[: g.tbs]
        bits[: len(pb)] = pb
        if self.tm2:
            control.pdcch_map_tm2(cell, grids, sf, CFI,
                                  dci.pack_1a(cell.n_prb, d), rnti, start, l)
            codec.map_to_grid_tm2(grids, codec.encode_symbols(bits))
        else:
            control.pdcch_map(cell, grids[0], sf, CFI,
                              dci.pack_1a(cell.n_prb, d), rnti, start, l)
            codec.map_to_grid(grids[0], codec.encode_symbols(bits))
        return start

    # --------------------------------------------------------------- uplink
    PRACH_SF = 1  # must match the UE's PRACH opportunity gating

    def receive_ul(self, tti: int, samples: np.ndarray | None) -> None:
        sf = tti % 10
        g_entry = self._ul_grants.pop(tti, None)
        ack_entry = self._dl_ack_at.pop(tti, None)
        cqi_due = (self.cqi_cfg is not None and samples is not None
                   and self._cqi_opportunity(tti))

        if samples is None:
            if ack_entry is not None:
                # DTX: treat as NACK (phch_common pending-ACK semantics)
                self._harq_ack_result(False, ack_entry[1], tti)
            if g_entry is not None:
                self._pusch_missing(tti, g_entry)
            return

        # PRACH detection only in configured PRACH subframes
        if sf == self.PRACH_SF:
            hits = prach.detect(self.cell, samples, self.prach_root,
                                self.prach_zcorr, threshold=10.0)
            if hits:
                best = max(hits, key=lambda h: h[1])[0]
                # answer in the next subframe-6 at least RA_RESPONSE_DELAY
                # out (fixed RAR subframe keeps the jitted-config
                # population small)
                t = tti + RA_RESPONSE_DELAY
                while t % 10 != 6:
                    t += 1
                self._rar_at[t] = best
                self._rar_rnti = 1 + (tti % 10)
                self.events.append(f"prach_{best}")
                return

        self.ul_power_log.append((tti, float(np.mean(np.abs(samples) ** 2))))

        if g_entry is not None:
            self._decode_pusch(tti, samples, g_entry, ack_entry, cqi_due)
            return

        # no PUSCH this TTI: control rides PUCCH / SRS
        grid = to_host(ofdm.demodulate(
            self.cell, torch.as_tensor(samples, device=self.device)))
        if ack_entry is not None:
            n_pucch, rec = ack_entry
            metric, soft = pucch.detect_format1(self.cell, grid, sf, n_pucch)
            ack = metric > 0.5 and soft > 0
            self._harq_ack_result(ack, rec, tti)
            # simultaneousAckNackAndCQI=False: the UE drops the CQI
            # report when HARQ-ACK takes the PUCCH (36.213 §10.1)
            cqi_due = False
        if cqi_due:
            from ..phy import uci as ucimod

            bits, conf = ucimod.decode_format2(
                self.cell, grid, sf, self.cqi_cfg[1],
                n_bits=self._cqi_n_bits(tti))
            self._record_cqi(tti, bits)
        if self.srs_cfg is not None:
            from ..phy import srs as srsmod

            i_srs, n_prb_srs = self.srs_cfg
            if srsmod.ue_srs_subframe(i_srs, tti):
                m = srsmod.detect(self.cell, grid, n_prb_srs)
                if m > 0.3:
                    self.srs_detects.append((tti, m))
                    self.events.append("srs")

    def _cqi_opportunity(self, tti: int) -> bool:
        from ..phy.ue_ul_ctrl import cqi_opportunity

        return cqi_opportunity(self.cqi_cfg[0], tti)

    def _cqi_n_bits(self, tti: int) -> int:
        """Payload size of this TTI's periodic report — both ends derive
        it from the shared schedule (wideband 4; Mode 2-0 subband
        4 + label bits)."""
        from ..phy import ue_ul_ctrl as uc

        idx, _, sub_k = self.cqi_cfg
        kind = uc.cqi_report_kind(idx, tti, self.cell.n_prb, sub_k)
        if kind is not None and kind[0] == "sb":
            return 4 + uc.subband_label_bits(self.cell.n_prb)
        return 4

    def _record_cqi(self, tti: int, bits) -> None:
        from ..phy import ue_ul_ctrl as uc

        if not len(bits):
            return
        idx, _, sub_k = self.cqi_cfg
        kind = uc.cqi_report_kind(idx, tti, self.cell.n_prb, sub_k)
        cqi = int("".join(map(str, bits[:4].astype(int))), 2)
        if kind is not None and kind[0] == "sb":
            label = int("".join(map(str, bits[4:].astype(int))), 2)
            self.cqi_reports.append((tti, "sb", kind[1], label, cqi))
            self.events.append(f"cqi_sb{kind[1]}_{label}_{cqi}")
        else:
            self.cqi_reports.append((tti, cqi))
            self.events.append(f"cqi_{cqi}")

    def _harq_ack_result(self, ack: bool, rec: _DlTx, tti: int) -> None:
        if ack:
            self.events.append("dl_ack")
            if rec.temp_crnti and self.dedicated_cqi is not None:
                # Msg4 ACKed: the UE has applied the dedicated config ->
                # start decoding its periodic CQI reports (format picked
                # up from the stack's ConnectionSetup: wideband or
                # subbandCQI(k))
                self.cqi_cfg = (*self.dedicated_cqi[:2],
                                getattr(self.stack, "cqi_format_k", None))
            return
        self.events.append("dl_nack")
        if rec.n_tx >= self.MAX_DL_TX:
            self.events.append("dl_drop")
            return
        rec.irv = (rec.irv + 1) % 4
        rec.n_tx += 1
        self._dl_retx = rec  # sent at the next data subframe, same NDI

    def _pusch_missing(self, tti: int, g_entry) -> None:
        grant, irv, is_retx = g_entry
        self._phich_at[tti + 4] = (False, grant.prb_start)
        if irv < 3:
            self._ul_grants[tti + 8] = (grant, irv + 1, True)

    def _decode_pusch(self, tti: int, samples, g_entry, ack_entry,
                      cqi_due: bool) -> None:
        grant, irv, is_retx = g_entry
        pid = tti % 8
        # closed-loop TPC: steer the UE's PUSCH rx level back to the
        # target locked on the first decoded PUSCH (tpc indices per
        # 36.213 Table 5.1.1.1-2: 0=-1, 1=0, 2=+1, 3=+3 dB)
        rx_db = 10 * np.log10(float(np.mean(np.abs(samples) ** 2)) + 1e-12)
        if self._tpc_rx_target_db is None:
            self._tpc_rx_target_db = rx_db
        err = self._tpc_rx_target_db - rx_db
        self._next_tpc = 3 if err > 2.0 else (2 if err > 0.5 else
                                              (0 if err < -0.5 else 1))
        with_ack = ack_entry is not None
        n_cqi = self._cqi_n_bits(tti) if cqi_due else 0
        codec = pusch.PuschCodec(
            self.cell, replace(grant, rv=RV_SEQ[irv]), self.crnti, tti % 10,
            with_ack=with_ack, n_cqi_bits=n_cqi, device=self.device,
        )
        bufs = codec.dematch_sf(torch.as_tensor(samples[None], device=self.device),
                                noise_var=1e-4)
        if is_retx and pid in self._ul_soft:
            bufs = [a + b for a, b in zip(self._ul_soft[pid], bufs)]
        bits, ok, _ = codec.decode_softbuffers(bufs)
        good = bool(to_host(ok).all())
        # HARQ feedback rides PHICH at the allocation's group/seq
        self._phich_at[tti + 4] = (good, grant.prb_start)
        if with_ack or cqi_due:
            cqi_bits, ack = codec.decode_uci()
            if with_ack:
                self._harq_ack_result(bool(ack), ack_entry[1], tti)
            if cqi_due and cqi_bits is not None:
                self._record_cqi(tti, np.asarray(cqi_bits))
        if good:
            self._ul_soft.pop(pid, None)
            raw = np.packbits(to_host(bits)[0].astype(np.uint8)).tobytes()
            if is_retx:
                self.events.append(f"ul_retx_ok_rv{RV_SEQ[irv]}")
            self._on_ul_mac_pdu(raw, tti)
        else:
            self.events.append(f"ul_nack_rv{RV_SEQ[irv]}")
            self._ul_soft[pid] = bufs
            if irv < 3:
                # expect the UE's autonomous non-adaptive retx at tti+8
                self._ul_grants[tti + 8] = (grant, irv + 1, True)
            else:
                self._ul_soft.pop(pid, None)

    def _on_ul_mac_pdu(self, raw: bytes, tti: int) -> None:
        parsed = pdu_mod.unpack(raw, uplink=True)
        for sh in parsed.subheaders:
            if sh.lcid == pdu_mod.LCID_CCCH and sh.payload:
                self._msg3_crid = sh.payload[:6].ljust(6, b"\x00")
                self.stack.srb0.write_pdu(sh.payload)
                self._ue_connected = True
                self._need_con_res = True
                self.events.append("msg3")
            elif sh.lcid in (1, 2, 3) and sh.payload:
                ent = {1: self.stack.srb1, 3: self.stack.drb}.get(sh.lcid)
                if ent is not None:
                    ent.write_pdu(sh.payload)
                # any dedicated-channel UL means the UE is with us —
                # after a contention-free handover RA there is no Msg3
                # CCCH, the first UL is the Complete on SRB1
                self._ue_connected = True
                self.events.append(f"ul_lcid{sh.lcid}")

    def ul_grant_for(self, tti: int) -> UlGrant | None:
        e = self._ul_grants.get(tti)
        return e[0] if e else None
