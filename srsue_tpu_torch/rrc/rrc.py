"""The port's own copy of ``srsue_tpu/rrc/rrc.py`` (its reference), unchanged below this docstring.

RRC UE state machine — 36.331 subset (reference: ue/src/upper/rrc.cc,
1036 LoC): IDLE -> SIB acquisition -> connection establishment ->
security activation -> reconfiguration -> CONNECTED; config fan-out to
PHY/MAC (rrc.cc:589-860), NAS transport over SRB1/2.

The reference distributes ~100 scalar parameters through int64 param DBs;
here the fan-out pushes typed config objects to the phy/mac interfaces.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import Enum, auto

from . import messages as M


def _ie_ms(v, default: int) -> int:
    """'ms45' -> 45 (36.331 timer enum spelling)."""
    try:
        return int(str(v)[2:])
    except (ValueError, TypeError):
        return default


def _um_config_from_ie(body):
    """36.331 RLC-Config um-* IE -> UmConfig (rrc.cc:add_bearer fan-out
    analogue)."""
    from ..rlc.rlc_um import UmConfig

    body = body or {}
    dl = body.get("dl_UM_RLC") or {}
    sn_bits = 5 if dl.get("sn_FieldLength") == "size5" else 10
    return UmConfig(sn_bits=sn_bits,
                    t_reordering=_ie_ms(dl.get("t_Reordering"), 45))


def _am_config_from_ie(body):
    """36.331 RLC-Config am IE -> AmConfig."""
    from ..rlc.rlc_am import AmConfig

    body = body or {}
    ul = body.get("ul_AM_RLC") or {}
    dl = body.get("dl_AM_RLC") or {}
    poll_pdu = str(ul.get("pollPDU", "p4"))[1:]
    poll_byte = str(ul.get("pollByte", "kB3000"))[2:]
    return AmConfig(
        t_poll_retx=_ie_ms(ul.get("t_PollRetransmit"), 45),
        poll_pdu=10**9 if poll_pdu == "Infinity" else int(poll_pdu),
        poll_byte=(10**9 if poll_byte.lower() == "infinity"
                   else int(poll_byte) * 1000),
        max_retx_thresh=int(str(ul.get("maxRetxThreshold", "t8"))[1:]),
        t_reordering=_ie_ms(dl.get("t_Reordering"), 35),
        t_status_prohibit=_ie_ms(dl.get("t_StatusProhibit"), 0),
    )


class RrcState(Enum):
    IDLE = auto()
    PLMN_SELECTION = auto()
    SIB1_SEARCH = auto()
    SIB2_SEARCH = auto()
    WAIT_CON_SETUP = auto()
    COMPLETING_SETUP = auto()
    CONNECTED = auto()
    WAIT_CON_REESTABLISH = auto()


class Rrc:
    def __init__(self, phy=None, mac=None, rlc=None, pdcp=None, nas=None, usim=None):
        self.phy = phy
        self.mac = mac
        self.rlc = rlc
        self.pdcp = pdcp
        self.nas = nas
        self.usim = usim
        self.state = RrcState.IDLE
        self.sib1: dict | None = None
        self.sib2: dict | None = None
        self.paged = False
        self.si_modified = False
        self.ue_crid = os.urandom(5)
        self.transaction_id = 0
        self.eea = 0
        self.eia = 2
        self.connected_cb = None
        self.security_activated = False
        # serving-cell identity for re-establishment (set by PHY/tests)
        self.pci = 0
        self.earfcn = 0
        # radio-link-failure monitor (36.331 §5.3.11 / SIB2
        # ue-TimersAndConstants; counters stepped by the per-subframe
        # in-sync/out-of-sync indications from the PHY receiver)
        self.n310 = 1
        self.t310_ms = 1000
        self.n311 = 1
        self._oos_count = 0
        self._t310_left = -1  # -1 = not running
        self._is_count = 0
        self._t304_left = -1  # handover supervision timer (§5.3.5)
        self._pending_ho_complete: int | None = None
        self._reestablishing = False
        # measurement configuration + trigger state (§5.5)
        self.meas_objects: dict[int, dict] = {}
        self.meas_reports: dict[int, dict] = {}
        self.meas_ids: dict[int, tuple[int, int]] = {}
        self._meas_state: dict[int, dict] = {}
        self._meas_filter: dict = {}  # L3-filtered RSRP dBm per cell key
        self._meas_fc_a = 0.5  # filterCoefficient fc4

    # ------------------------------------------------------------- kickoff
    def connect(self) -> None:
        """NAS wants a connection (nas -> rrc_interface_nas)."""
        if self.state == RrcState.CONNECTED:
            self.nas.notify_connection_setup()
            return
        self.state = RrcState.SIB1_SEARCH
        if self.phy is not None:
            self.phy.sync_start()

    # ----------------------------------------------- broadcast reception
    def write_pdu_bcch_bch(self, payload: bytes) -> None:
        """MIB decoded (rrc.cc:132): start SIB search windows."""
        if self.state == RrcState.IDLE:
            self.state = RrcState.SIB1_SEARCH
        if self.mac is not None:
            self.mac_arm_si_search()

    def mac_arm_si_search(self) -> None:
        pass  # receiver loop drives SI windows; hook point for schedulers

    def write_pdu_bcch_dlsch(self, payload: bytes) -> None:
        """SIB container received on SI-RNTI (BCCH-DL-SCH-Message UPER)."""
        name, _, body = M.unpack("BCCH-DL-SCH", payload)
        if name == "systemInformationBlockType1":
            self.sib1 = body
            self._configure_si_windows(body)
            if self.state == RrcState.SIB1_SEARCH:
                self.state = RrcState.SIB2_SEARCH
                if self.sib2 is not None:
                    # SIB2 was already cached from a broad pre-SIB1 search
                    self.send_con_request()
        elif name == "systemInformation":
            for kind, sib in body["sib_TypeAndInfo"]:
                if kind == "sib2":
                    self.sib2 = sib
                    self.apply_sib2_configs(sib)
                    if self.state == RrcState.SIB2_SEARCH:
                        self.send_con_request()

    def _configure_si_windows(self, sib1: dict) -> None:
        """SI scheduling fan-out (rrc.cc:584-587 + mac.cc:215-244
        search_si_rnti analogue): SI-RNTI searches run only inside the
        SI windows derived from SIB1's schedulingInfoList."""
        if self.phy is None or not hasattr(self.phy, "configure_si"):
            return
        from .si_sched import SiConfig

        periods = tuple(
            int(si["si_Periodicity"][2:])
            for si in sib1.get("schedulingInfoList", [])
        )
        if not periods:
            return
        win = int(sib1["si_WindowLength"][2:])
        self.phy.configure_si(SiConfig(si_window_len_sf=win,
                                       si_periodicity_rf=periods))

    def write_pdu_pcch(self, payload: bytes) -> None:
        """Paging message on P-RNTI (capability-plus: the reference has
        no PCCH handling anywhere). Matches s-TMSI/IMSI paging records
        and honours systemInfoModification."""
        name, _, body = M.unpack("PCCH", payload)
        if name != "paging":
            return
        for rec in body.get("pagingRecordList") or []:
            kind, ident = rec["ue_Identity"]
            matched = False
            if kind == "imsi" and self.usim is not None:
                matched = "".join(map(str, ident)) == self.usim.get_imsi()
            elif kind == "s_TMSI" and self.nas is not None and self.nas.guti:
                # GUTI tail: MMEC (1 byte) + M-TMSI (4 bytes)
                want = (int.from_bytes(self.nas.guti[-5:-4], "big"),
                        int.from_bytes(self.nas.guti[-4:], "big"))
                matched = (ident["mmec"], ident["m_TMSI"]) == want
            if matched:
                self.paged = True
                if self.nas is not None and hasattr(self.nas, "paging_received"):
                    self.nas.paging_received(kind)
        if body.get("systemInfoModification") is not None:
            # 36.331 §5.2.2.4: re-acquire system information
            self.sib1 = None
            self.sib2 = None
            if self.state in (RrcState.SIB1_SEARCH, RrcState.SIB2_SEARCH):
                self.state = RrcState.SIB1_SEARCH
            self.si_modified = True

    def apply_sib2_configs(self, sib2: dict) -> None:
        """Config fan-out (rrc.cc:589-721): RACH/PRACH/PUSCH/PUCCH/power
        parameters into MAC + PHY, from the spec-shaped SIB2 IEs."""
        common = sib2["radioResourceConfigCommon"]
        pcch = common.get("pcch_Config")
        if (pcch and self.phy is not None
                and hasattr(self.phy, "configure_paging")):
            n_b_t = {"fourT": 4.0, "twoT": 2.0, "oneT": 1.0,
                     "halfT": 0.5, "quarterT": 0.25, "oneEighthT": 0.125,
                     "oneSixteenthT": 1 / 16, "oneThirtySecondT": 1 / 32}[
                pcch["nB"]]
            t_drx = int(pcch["defaultPagingCycle"][2:])
            imsi = self.usim.get_imsi() if self.usim is not None else "0"
            self.phy.configure_paging(int(imsi) % 1024, t_drx=t_drx,
                                      n_b_t=n_b_t)
        if self.mac is not None and hasattr(self.mac, "ra"):
            rach = common["rach_ConfigCommon"]
            sup = rach["ra_SupervisionInfo"]
            cfg = self.mac.ra.cfg
            cfg.preamble_trans_max = int(sup["preambleTransMax"][1:])
            cfg.power_ramp_db = int(
                rach["powerRampingParameters"]["powerRampingStep"][2:])
            cfg.response_window = int(sup["ra_ResponseWindowSize"][2:])
            cfg.contention_res_timer = int(
                sup["mac_ContentionResolutionTimer"][2:])
        if self.phy is not None and hasattr(self.phy, "configure_ul_power"):
            from ..phy.powerctrl import UlPowerConfig

            up = common["uplinkPowerControlCommon"]
            self.phy.configure_ul_power(UlPowerConfig(
                p0_nominal_pusch=float(up["p0_NominalPUSCH"]),
                alpha={"al0": 0.0, "al04": 0.4, "al05": 0.5, "al06": 0.6,
                       "al07": 0.7, "al08": 0.8, "al09": 0.9, "al1": 1.0}[
                    up["alpha"]],
                p0_nominal_pucch=float(up["p0_NominalPUCCH"]),
                # IE is in units of 2 dB (36.321 §5.1.3 DELTA_PREAMBLE_MSG3)
                delta_preamble_msg3=2.0 * float(up["deltaPreambleMsg3"]),
            ))
        if self.phy is not None and hasattr(self.phy, "configure_prach"):
            pr = common["prach_Config"]
            info = pr["prach_ConfigInfo"]
            self.phy.configure_prach(
                root_seq_index=pr["rootSequenceIndex"],
                zero_corr=info["zeroCorrelationZoneConfig"],
                freq_offset=info["prach_FreqOffset"],
                config_index=info["prach_ConfigIndex"],
            )
        tc = sib2.get("ue_TimersAndConstants")
        if tc:
            # RLF monitor constants (36.331 §5.3.11.1): nN -> N, msN -> N
            self.n310 = int(str(tc.get("n310", "n1"))[1:])
            self.n311 = int(str(tc.get("n311", "n1"))[1:])
            self.t310_ms = _ie_ms(tc.get("t310"), 1000)
        if self.phy is not None and hasattr(self.phy, "configure_ul_params"):
            self.phy.configure_ul_params(sib2)

    # ----------------------------------------------- connection establishment
    def send_con_request(self) -> None:
        self.state = RrcState.WAIT_CON_SETUP
        msg = M.pack("UL-CCCH", "rrcConnectionRequest", {
            "ue_Identity": ("randomValue",
                            int.from_bytes(self.ue_crid, "big")),
            "establishmentCause": "mo-Signalling",
            "spare": 0,
        })
        # CCCH SDU -> MAC triggers RA with this as Msg3 (mac.cc:186-190);
        # MAC derives the contention-resolution id from the SDU itself
        self.mac.start_ra(msg)

    # (ra_completed is defined with the handover logic below: after a
    # normal attach RA it is a no-op; after a handover RA it finishes
    # the procedure)

    # ----------------------------------------------- PDCP -> RRC delivery
    def write_pdu(self, lcid: int, payload: bytes) -> None:
        if lcid == 0:
            self._handle_dl_ccch(payload)
        else:
            self._handle_dl_dcch(payload)

    def _handle_dl_ccch(self, payload: bytes) -> None:
        name, tid, body = M.unpack("DL-CCCH", payload)
        if name == "rrcConnectionSetup":
            self.handle_con_setup(body, tid)
        elif name == "rrcConnectionReject":
            self.state = RrcState.IDLE
        elif name == "rrcConnectionReestablishment":
            self.handle_con_reestablishment(body, tid)
        elif name == "rrcConnectionReestablishmentReject":
            # 36.331 §5.3.7.8: leave RRC_CONNECTED (-> idle, NAS recovers
            # with a fresh attach)
            self.state = RrcState.IDLE
            self.security_activated = False
            if self.nas is not None and hasattr(self.nas, "connection_lost"):
                self.nas.connection_lost()

    @staticmethod
    def _lc_priority(item: dict, default: int) -> int:
        """Priority from an (SRB|DRB)-ToAddMod's logicalChannelConfig;
        default per 36.331 §9.2.1 when defaultValue/absent."""
        lc = item.get("logicalChannelConfig")
        if isinstance(lc, tuple) and lc[0] == "explicitValue":
            lc = lc[1]
        if isinstance(lc, dict) and lc.get("ul_SpecificParameters"):
            return lc["ul_SpecificParameters"]["priority"]
        return default

    def handle_con_setup(self, setup: dict, tid: int = 0) -> None:
        """rrc.cc:723: apply SRB1 + dedicated config, send SetupComplete
        with the NAS AttachRequest piggybacked."""
        rrcd = setup["radioResourceConfigDedicated"]
        prio = 1  # SRB1 default (36.331 §9.2.1.1)
        for srb in rrcd.get("srb_ToAddModList") or []:
            if srb["srb_Identity"] == 1:
                prio = self._lc_priority(srb, 1)
        self.rlc.add_bearer_default_srb(1)
        self.pdcp.add_bearer(1)
        if self.mac is not None and hasattr(self.mac, "mux"):
            self.mac.mux.set_priority(1, priority=prio, pbr_bytes_per_tti=-1)
        if rrcd.get("physicalConfigDedicated"):
            self._apply_physical_dedicated(rrcd["physicalConfigDedicated"])
        self.state = RrcState.COMPLETING_SETUP
        nas_pdu = self.nas.get_attach_request() if self.nas else b""
        msg = M.pack("UL-DCCH", "rrcConnectionSetupComplete", {
            "selectedPLMN_Identity": 1,
            "dedicatedInfoNAS": nas_pdu,
        }, tid=tid)
        self.pdcp.write_sdu(1, msg)
        self.state = RrcState.CONNECTED
        if self.nas:
            self.nas.notify_connection_setup()
        if self.connected_cb:
            self.connected_cb()

    def _handle_dl_dcch(self, payload: bytes) -> None:
        name, tid, body = M.unpack("DL-DCCH", payload)
        if name == "dlInformationTransfer":
            kind, nas_pdu = body["dedicatedInfoType"]
            if kind == "dedicatedInfoNAS":
                self.nas.write_pdu(nas_pdu)
        elif name == "securityModeCommand":
            self._handle_security_mode(body, tid)
        elif name == "ueCapabilityEnquiry":
            self._send_capability_info(tid)
        elif name == "rrcConnectionReconfiguration":
            self._handle_reconfig(body, tid)
        elif name == "rrcConnectionRelease":
            self.state = RrcState.IDLE
            self.rlc.reestablish()

    _EEA = {"eea0": 0, "eea1": 1, "eea2": 2}
    _EIA = {"reserved": 0, "eia1": 1, "eia2": 2}

    def _handle_security_mode(self, body: dict, tid: int) -> None:
        """rrc.cc:499-501: trigger AS key derivation + integrity on."""
        alg = body["securityConfigSMC"]["securityAlgorithmConfig"]
        self.eea = self._EEA.get(alg["cipheringAlgorithm"], 0)
        self.eia = self._EIA.get(alg["integrityProtAlgorithm"], 2)
        if self.usim is not None:
            nas_count = self.nas.k_enb_nas_count if self.nas else 0
            self.usim.generate_as_keys(nas_count, self.eea, self.eia)
            self.pdcp.config_security_all(
                self.usim.keys["rrc_enc"], self.usim.keys["rrc_int"]
            )
        self.pdcp.enable_integrity(1)
        self.security_activated = True
        msg = M.pack("UL-DCCH", "securityModeComplete", {}, tid=tid)
        self.pdcp.write_sdu(1, msg)

    def _send_capability_info(self, tid: int) -> None:
        """UE-EUTRA-Capability container (Cat 5 signaled, rrc.cc:366)."""
        cap = M.ue_eutra_capability(ue_category=5, rohc=False)
        msg = M.pack("UL-DCCH", "ueCapabilityInformation", {
            "ue_CapabilityRAT_ContainerList": [
                {"rat_Type": "eutra", "ueCapabilityRAT_Container": cap}],
        }, tid=tid)
        self.pdcp.write_sdu(1, msg)

    _PBR_BYTES_PER_TTI = {
        "kBps0": 0.0, "kBps8": 8.0, "kBps16": 16.0, "kBps32": 32.0,
        "kBps64": 64.0, "kBps128": 128.0, "kBps256": 256.0, "infinity": -1.0,
    }

    _SRS_BW_PRB = {"bw0": 4, "bw1": 8, "bw2": 16, "bw3": 24}

    def _apply_physical_dedicated(self, phys: dict) -> None:
        """Dedicated physical-config fan-out (rrc.cc:723-832 dedicated
        branch of set_ul_params): periodic CQI, SRS and SR schedules into
        the PHY's UL control (phch_worker.cc:479-658 consumers)."""
        if self.phy is None:
            return
        cqi = phys.get("cqi_ReportConfig") or {}
        per = cqi.get("cqi_ReportPeriodic")
        if (isinstance(per, tuple) and per[0] == "setup"
                and hasattr(self.phy, "configure_cqi")):
            fmt = per[1].get("cqi_FormatIndicatorPeriodic")
            sub_k = (fmt[1]["k"] if isinstance(fmt, tuple)
                     and fmt[0] == "subbandCQI" else None)
            self.phy.configure_cqi(per[1]["cqi_pmi_ConfigIndex"],
                                   per[1]["cqi_PUCCH_ResourceIndex"],
                                   subband_k=sub_k)
        srs = phys.get("soundingRS_UL_ConfigDedicated")
        if (isinstance(srs, tuple) and srs[0] == "setup"
                and hasattr(self.phy, "configure_srs")):
            self.phy.configure_srs(
                srs[1]["srs_ConfigIndex"],
                self._SRS_BW_PRB[srs[1]["srs_Bandwidth"]],
            )
        sr = phys.get("schedulingRequestConfig")
        if isinstance(sr, tuple) and sr[0] == "setup":
            if hasattr(self.phy, "configure_sr"):
                self.phy.configure_sr(sr[1]["sr_ConfigIndex"],
                                      sr[1]["sr_PUCCH_ResourceIndex"])
            if self.mac is not None and hasattr(self.mac, "sr"):
                self.mac.sr.sr_trans_max = int(sr[1]["dsr_TransMax"][1:])

    def _handle_reconfig(self, body: dict, tid: int) -> None:
        if body.get("mobilityControlInfo") is not None:
            self._handle_handover(body, tid)
            return
        if body.get("measConfig") is not None:
            self._apply_meas_config(body["measConfig"])
        rrcd = body.get("radioResourceConfigDedicated") or {}
        if rrcd.get("physicalConfigDedicated"):
            self._apply_physical_dedicated(rrcd["physicalConfigDedicated"])
        for drb in rrcd.get("drb_ToAddModList") or []:
            lcid = drb.get("logicalChannelIdentity") or (
                2 + drb["drb_Identity"])
            from ..rlc import RlcMode
            from ..pdcp.pdcp import PdcpConfig

            rlc_cfg = drb.get("rlc_Config")
            mode = RlcMode.AM
            ent_cfg = None
            if rlc_cfg is not None and rlc_cfg[0].startswith("um"):
                mode = RlcMode.UM
                ent_cfg = _um_config_from_ie(rlc_cfg[1])
            elif rlc_cfg is not None and rlc_cfg[0] == "am":
                ent_cfg = _am_config_from_ie(rlc_cfg[1])
            self.rlc.add_bearer(lcid, mode, ent_cfg)
            sn_bits = 12
            pdcp_cfg = drb.get("pdcp_Config")
            if pdcp_cfg and pdcp_cfg.get("rlc_UM"):
                sn_bits = 7 if (pdcp_cfg["rlc_UM"]["pdcp_SN_Size"]
                                == "len7bits") else 12
            self.pdcp.add_bearer(
                lcid, PdcpConfig(sn_bits=sn_bits, bearer_id=lcid))
            if self.mac is not None and hasattr(self.mac, "mux"):
                prio, pbr = 4, 8.0
                lc = drb.get("logicalChannelConfig")
                lcg = 2
                if lc and lc.get("ul_SpecificParameters"):
                    ul = lc["ul_SpecificParameters"]
                    prio = ul["priority"]
                    pbr = self._PBR_BYTES_PER_TTI.get(
                        ul["prioritisedBitRate"], 8.0)
                    if ul.get("logicalChannelGroup") is not None:
                        lcg = ul["logicalChannelGroup"]
                self.mac.mux.set_priority(lcid, prio, pbr)
                if hasattr(self.mac, "bsr"):
                    self.mac.bsr.set_lcg(lcid, lcg=lcg, priority=prio)
        for nas_pdu in body.get("dedicatedInfoNASList") or []:
            self.nas.write_pdu(nas_pdu)
        msg = M.pack("UL-DCCH", "rrcConnectionReconfigurationComplete", {},
                     tid=tid)
        self.pdcp.write_sdu(1, msg)
        if getattr(self, "_reestablishing", False):
            # 36.323 §5.3.1: on AM-DRB resume after re-establishment,
            # report rx status (FMS) so the peer can discard/retransmit
            self._reestablishing = False
            for drb in rrcd.get("drb_ToAddModList") or []:
                lcid = drb.get("logicalChannelIdentity") or (
                    2 + drb["drb_Identity"])
                ent = self.pdcp.entities.get(lcid)
                if ent is not None and not ent.cfg.is_control:
                    ent.send_status()

    # ----------------------------------------------- measurements (§5.5)
    # Capability-plus: the reference IGNORES measConfig entirely (no
    # measurement IE handling anywhere in rrc.cc); this implements the
    # intra-frequency EUTRA subset — measObjectEUTRA neighbor lists,
    # reportConfigEUTRA event A3 with hysteresis + timeToTrigger, L3
    # filtering (§5.5.3.2), MeasurementReport on SRB1 — closing the
    # A3 -> report -> handover loop with the eNB emulator.

    _QOFF_DB = {f"dB{v}": float(v) for v in (
        0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24)} | {
        f"dB_{v}": -float(v) for v in (
            1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24)}

    def _apply_meas_config(self, mc: dict) -> None:
        for oid in mc.get("measObjectToRemoveList") or []:
            self.meas_objects.pop(oid, None)
        for om in mc.get("measObjectToAddModList") or []:
            kind, obj = om["measObject"]
            if kind != "measObjectEUTRA":
                continue
            cells = {}
            for c in obj.get("cellsToAddModList") or []:
                cells[c["physCellId"]] = self._QOFF_DB.get(
                    c["cellIndividualOffset"], 0.0)
            self.meas_objects[om["measObjectId"]] = {
                "carrierFreq": obj["carrierFreq"],
                "cells": cells,
                "offset_freq": self._QOFF_DB.get(
                    obj.get("offsetFreq", "dB0"), 0.0),
            }
        for rid in mc.get("reportConfigToRemoveList") or []:
            self.meas_reports.pop(rid, None)
        for rm in mc.get("reportConfigToAddModList") or []:
            kind, rc = rm["reportConfig"]
            if kind != "reportConfigEUTRA":
                continue
            self.meas_reports[rm["reportConfigId"]] = rc
        for mid in mc.get("measIdToRemoveList") or []:
            self.meas_ids.pop(mid, None)
            self._meas_state.pop(mid, None)
        for im in mc.get("measIdToAddModList") or []:
            self.meas_ids[im["measId"]] = (im["measObjectId"],
                                           im["reportConfigId"])
            self._meas_state[im["measId"]] = {"ttt": 0, "fired": False}
        qc = (mc.get("quantityConfig") or {}).get("quantityConfigEUTRA")
        if qc:
            fc = int(str(qc.get("filterCoefficientRSRP", "fc4"))[2:])
            # §5.5.3.2: F_n = (1-a)*F_{n-1} + a*M_n, a = 1/2^(k/4)
            self._meas_fc_a = 1.0 / (2 ** (fc / 4.0))
        pcis = sorted({p for o in self.meas_objects.values()
                       for p in o["cells"]})
        if self.phy is not None and hasattr(self.phy,
                                            "configure_neighbor_meas"):
            self.phy.configure_neighbor_meas(pcis)

    def _l3_filter(self, key, raw_dbm: float) -> float:
        a = self._meas_fc_a
        old = self._meas_filter.get(key)
        f = raw_dbm if old is None else (1.0 - a) * old + a * raw_dbm
        self._meas_filter[key] = f
        return f

    def step_measurements(self) -> None:
        """Per-TTI A3 evaluation over the PHY's L1 measurements."""
        phy = self.phy
        if (phy is None or not self.meas_ids
                or self.state != RrcState.CONNECTED):
            return
        serv_raw = getattr(phy, "serving_rsrp_dbm", None)
        if serv_raw is None:
            return
        ms = self._l3_filter("serv", serv_raw)
        neigh = {pci: self._l3_filter(pci, dbm) for pci, dbm in
                 getattr(phy, "neighbor_rsrp_dbm", {}).items()}
        for mid, (oid, rid) in self.meas_ids.items():
            obj = self.meas_objects.get(oid)
            rc = self.meas_reports.get(rid)
            if not obj or not rc or rc["triggerType"][0] != "event":
                continue
            ev = rc["triggerType"][1]
            if ev["eventId"][0] != "eventA3":
                continue
            off = ev["eventId"][1]["a3_Offset"] * 0.5  # 0.5 dB units
            hys = ev["hysteresis"] * 0.5
            ttt_ms = _ie_ms(ev["timeToTrigger"], 0)
            st = self._meas_state.setdefault(mid, {"ttt": 0, "fired": False})
            entering = []
            all_left = True
            for pci, ocn in obj["cells"].items():
                if pci not in neigh:
                    continue
                mn = neigh[pci]
                # §5.5.4.4: A3-1 entry Mn+Ofn+Ocn-Hys > Ms+Ofs+Ocs+Off
                if mn + ocn - hys > ms + off:
                    entering.append((mn, pci))
                # A3-2 leave: Mn+Ofn+Ocn+Hys < Ms+Ofs+Ocs+Off
                if not (mn + ocn + hys < ms + off):
                    all_left = False
            if entering:
                if not st["fired"]:
                    st["ttt"] += 1
                    if st["ttt"] > ttt_ms:
                        st["fired"] = True
                        mn, pci = max(entering)
                        self._send_meas_report(mid, ms, pci, mn)
            else:
                st["ttt"] = 0
                if all_left:
                    st["fired"] = False  # re-arm after leaving

    @staticmethod
    def _rsrp_range(dbm: float) -> int:
        """36.133 §9.1.4 RSRP-Range: 0 = < -140 dBm ... 97 = >= -44."""
        return max(0, min(97, int(round(dbm + 141))))

    def _send_meas_report(self, mid: int, ms_dbm: float, pci: int,
                          mn_dbm: float) -> None:
        # RSRQ-Range (36.133 §9.1.7): 0 = < -19.5 dB, 34 = >= -3 dB.
        # Derived from the measured SINR (RSRQ ~ -10log10(12) + SINR-ish
        # for a lightly-loaded cell); good enough for reporting.
        snr_db = float(getattr(self.phy, "metrics", {}).get("snr_db", 0.0))
        rsrq_db = max(-19.5, min(-3.0, -10.8 + snr_db / 4.0))
        rsrq = int(round(2 * (rsrq_db + 19.5)))
        msg = M.pack("UL-DCCH", "measurementReport", {"measResults": {
            "measId": mid,
            "measResultServCell": {
                "rsrpResult": self._rsrp_range(ms_dbm),
                "rsrqResult": rsrq,
            },
            "measResultNeighCells": ("measResultListEUTRA", [{
                "physCellId": pci,
                "measResult": {"rsrpResult": self._rsrp_range(mn_dbm)},
            }]),
        }})
        self.pdcp.write_sdu(1, msg)

    # ----------------------------------------------- NAS uplink transport
    def write_sdu_nas(self, nas_pdu: bytes) -> None:
        msg = M.pack("UL-DCCH", "ulInformationTransfer", {
            "dedicatedInfoType": ("dedicatedInfoNAS", nas_pdu),
        })
        self.pdcp.write_sdu(1, msg)

    # ----------------------------------------------- connection re-establishment
    # Capability-plus: the reference leaves re-establishment explicitly
    # unhandled (rrc.cc:459-464 "Connection riestablishment not
    # supported"); this implements 36.331 §5.3.7 + §5.3.11.

    def radio_link_failure(self, cause: str = "otherFailure") -> None:
        """36.331 §5.3.11.3: on RLF, start re-establishment if AS
        security is active, else leave RRC_CONNECTED."""
        self._t310_left = -1
        self._oos_count = 0
        if self.state != RrcState.CONNECTED or not self.security_activated:
            self.state = RrcState.IDLE
            return
        self.reestablish(cause)

    def reestablish(self, cause: str = "otherFailure") -> None:
        """§5.3.7.2-4: suspend RBs, reset MAC, send the re-establishment
        request (carrying C-RNTI + PCI + shortMAC-I) over a fresh RA."""
        crnti = self.mac.crnti if self.mac is not None else 0
        short_mac = self.short_mac_i(crnti)
        if self.mac is not None and hasattr(self.mac, "reset"):
            self.mac.reset()
        if self.rlc is not None:
            self.rlc.reestablish()
        self.state = RrcState.WAIT_CON_REESTABLISH
        msg = M.pack("UL-CCCH", "rrcConnectionReestablishmentRequest", {
            "ue_Identity": {
                "c_RNTI": crnti,
                "physCellId": self.pci,
                "shortMAC_I": short_mac,
            },
            "reestablishmentCause": cause,
            "spare": 0,
        })
        self.mac.start_ra(msg)

    def short_mac_i(self, crnti: int) -> int:
        """§5.3.7.4: 16 LSBs of EIA(K_RRCint_old, COUNT/BEARER/DIRECTION
        all ones, UPER(VarShortMAC-Input))."""
        from . import asn1 as A
        from . import uper
        from ..usim import security as sec

        cell_id = 0
        if self.sib1 is not None:
            cell_id = self.sib1["cellAccessRelatedInfo"]["cellIdentity"]
        data = uper.encode(A.VarShortMAC_Input, {
            "cellIdentity": cell_id,
            "physCellId": self.pci,
            "c_RNTI": crnti,
        })
        key = (self.usim.keys.get("rrc_int", bytes(16))
               if self.usim is not None else bytes(16))
        mac = sec.eia2(key, 0xFFFFFFFF, 0x1F, 1, data)
        return int.from_bytes(mac[2:4], "big")

    def handle_con_reestablishment(self, body: dict, tid: int) -> None:
        """§5.3.7.5: re-establish PDCP+RLC for SRB1, re-key with K_eNB*
        per nextHopChainingCount, resume SRB1, send Complete. DRBs
        resume via the follow-up reconfiguration (§5.3.7.5 note)."""
        if self.state != RrcState.WAIT_CON_REESTABLISH:
            return
        rrcd = body["radioResourceConfigDedicated"]
        prio = 1
        for srb in rrcd.get("srb_ToAddModList") or []:
            if srb["srb_Identity"] == 1:
                prio = self._lc_priority(srb, 1)
        self.rlc.add_bearer_default_srb(1)   # fresh entity = re-establish
        self.pdcp.add_bearer(1)              # no-op if present...
        self.pdcp.reestablish_bearer(1)      # ...SRB COUNTs reset (36.323 §5.2)
        self._reestablishing = True          # DRB resume sends a PDCP status
        if self.mac is not None and hasattr(self.mac, "mux"):
            self.mac.mux.set_priority(1, priority=prio, pbr_bytes_per_tti=-1)
        ncc = body.get("nextHopChainingCount", 0)
        if self.usim is not None and self.usim.k_enb is not None:
            self.usim.refresh_as_keys(self.pci, self.earfcn, ncc,
                                      self.eea, self.eia)
            self.pdcp.config_security_all(
                self.usim.keys["rrc_enc"], self.usim.keys["rrc_int"])
        self.pdcp.enable_integrity(1)
        msg = M.pack("UL-DCCH", "rrcConnectionReestablishmentComplete", {},
                     tid=tid)
        self.pdcp.write_sdu(1, msg)
        self.state = RrcState.CONNECTED

    # ----------------------------------------------- intra-LTE handover
    # Capability-plus: the reference never decodes mobilityControlInfo.
    # 36.331 §5.3.5.4 (reconfiguration including mobility): apply the
    # target identity, reset MAC, re-key (K_eNB* with the signalled NCC
    # toward the TARGET PCI), re-establish PDCP/RLC, RA to the target,
    # then ReconfigurationComplete on the target's SRB1. T304 guards the
    # procedure; expiry -> re-establishment with cause handoverFailure
    # (§5.3.5.6).

    def _handle_handover(self, body: dict, tid: int) -> None:
        mci = body["mobilityControlInfo"]
        sec_ho = body.get("securityConfigHO")
        ncc = 0
        if sec_ho is not None and sec_ho["handoverType"][0] == "intraLTE":
            intra = sec_ho["handoverType"][1]
            ncc = intra.get("nextHopChainingCount", 0)
            alg = intra.get("securityAlgorithmConfig")
            if alg:
                self.eea = self._EEA.get(alg["cipheringAlgorithm"], self.eea)
                self.eia = self._EIA.get(alg["integrityProtAlgorithm"],
                                         self.eia)
        new_crnti = mci["newUE_Identity"]
        # Snapshot the SOURCE PCell context before applying the command:
        # a T304 expiry must build the ReestablishmentRequest with the
        # source PCI/C-RNTI/K_RRCint (36.331 §5.3.5.6 -> §5.3.7.4), not
        # the target's (ADVICE r3 medium).
        self._ho_src = {
            "pci": self.pci, "earfcn": self.earfcn,
            "eea": self.eea, "eia": self.eia,
            "crnti": self.mac.crnti if self.mac is not None else 0,
        }
        if self.usim is not None and self.usim.k_enb is not None:
            self._ho_src["usim"] = (self.usim.k_enb, self.usim.ncc,
                                    self.usim.nh, dict(self.usim.keys))
        self.pci = mci["targetPhysCellId"]
        cf = mci.get("carrierFreq")
        if cf:
            self.earfcn = cf["dl_CarrierFreq"]
        self._t304_left = _ie_ms(mci["t304"], 200)
        # MAC reset + target common config (prach fan-out)
        if self.mac is not None and hasattr(self.mac, "reset"):
            self.mac.reset()
        common = mci["radioResourceConfigCommon"]
        pr = common.get("prach_Config")
        if (pr and pr.get("prach_ConfigInfo") and self.phy is not None
                and hasattr(self.phy, "configure_prach")):
            info = pr["prach_ConfigInfo"]
            self.phy.configure_prach(
                root_seq_index=pr["rootSequenceIndex"],
                zero_corr=info["zeroCorrelationZoneConfig"],
                freq_offset=info["prach_FreqOffset"],
                config_index=info["prach_ConfigIndex"],
            )
        # retune the PHY to the target cell: CRS/scrambling/PDCCH all
        # key off the PCI (exercised over the air in test_ota_handover)
        if self.phy is not None and hasattr(self.phy, "set_pci"):
            self.phy.set_pci(self.pci)
        # §5.5.6.1: measurement L3 filters and timeToTrigger state
        # restart on the new serving cell
        self._meas_filter.clear()
        for st in self._meas_state.values():
            st["ttt"] = 0
            st["fired"] = False
        # re-key toward the target cell and re-establish the bearers
        if self.usim is not None and self.usim.k_enb is not None:
            self.usim.refresh_as_keys(self.pci, self.earfcn, ncc,
                                      self.eea, self.eia)
            self.pdcp.config_security_all(
                self.usim.keys["rrc_enc"], self.usim.keys["rrc_int"])
        if self.rlc is not None:
            self.rlc.reestablish()
        self.pdcp.reestablish_bearer(1)
        self.pdcp.enable_integrity(1)
        # (mac.crnti keeps the SOURCE identity until RA completes at the
        # target — a T304 expiry falls back to re-establishment with the
        # source context)
        # RA to the target carrying the new C-RNTI (contention-free when
        # rach-ConfigDedicated gives a preamble; else C-RNTI CE in Msg3)
        self._pending_ho_complete = tid
        if self.mac is not None and hasattr(self.mac, "mux"):
            self.mac.contention_id = b"\x00" * 6
            ded = mci.get("rach_ConfigDedicated")
            self.mac.ra.start(b"", self.mac.contention_id)
            if ded is not None:
                # dedicated preamble: no contention (§5.1.1 of 36.321)
                self.mac.ra.dedicated_preamble = ded["ra_PreambleIndex"]
            else:
                # contention-based HO RA only: identify via C-RNTI CE in
                # Msg3 (36.321 §5.1.5; a CE outside Msg3 would be
                # spurious — ADVICE r3 low)
                self.mac.mux.pending_crnti = new_crnti
        self._ho_new_crnti = new_crnti

    def ra_completed(self) -> None:
        """PDCCH now armed on C-RNTI. After a handover RA, finish the
        procedure: stop T304, send ReconfigurationComplete on SRB1."""
        tid = getattr(self, "_pending_ho_complete", None)
        if tid is None:
            return
        self._pending_ho_complete = None
        self._t304_left = -1
        # 36.321 §5.1.5: for dedicated-preamble RA the RAR's Temporary
        # C-RNTI is DISCARDED — the UE identity at the target is
        # mobilityControlInfo.newUE_Identity (ADVICE r3 medium). The
        # contention-based path resolves to the same value via the
        # C-RNTI CE, so install it unconditionally.
        new_crnti = getattr(self, "_ho_new_crnti", None)
        if new_crnti is not None and self.mac is not None:
            self.mac.crnti = new_crnti
            if hasattr(self.mac, "phy") and self.mac.phy is not None:
                self.mac.phy.pdcch_dl_search_crnti(new_crnti)
            self.mac.mux.pending_crnti = None
        self._ho_new_crnti = None
        self._ho_src = None  # success: source context no longer needed
        msg = M.pack("UL-DCCH", "rrcConnectionReconfigurationComplete", {},
                     tid=tid)
        self.pdcp.write_sdu(1, msg)
        self.state = RrcState.CONNECTED

    def _ho_restore_source(self) -> None:
        """T304 expiry: roll back to the source PCell context so the
        re-establishment request carries the source PCI / C-RNTI /
        shortMAC-I keyed with the source K_RRCint (§5.3.7.4)."""
        src = getattr(self, "_ho_src", None)
        if src is None:
            return
        self.pci = src["pci"]
        self.earfcn = src["earfcn"]
        self.eea = src["eea"]
        self.eia = src["eia"]
        u = src.get("usim")
        if u is not None and self.usim is not None:
            self.usim.k_enb, self.usim.ncc, self.usim.nh = u[0], u[1], u[2]
            self.usim.keys = dict(u[3])
            self.pdcp.config_security_all(
                self.usim.keys["rrc_enc"], self.usim.keys["rrc_int"])
        if self.mac is not None and src.get("crnti"):
            self.mac.crnti = src["crnti"]
            self.mac.mux.pending_crnti = None
        if self.phy is not None and hasattr(self.phy, "set_pci"):
            self.phy.set_pci(self.pci)
        self._ho_src = None

    def step_tti(self) -> None:
        """Per-TTI RRC timers (T304, T310; stepped from the UE main
        loop). T310 is wall-clock per 36.331 §5.3.11.2 — it runs down
        once per subframe regardless of that subframe's sync indication
        (ADVICE r3 low)."""
        if self._t304_left >= 0:
            self._t304_left -= 1
            if self._t304_left < 0:
                # §5.3.5.6: handover failure -> re-establishment with
                # the SOURCE cell context restored
                self._pending_ho_complete = None
                self._ho_new_crnti = None
                self._ho_restore_source()
                self.reestablish("handoverFailure")
        if self._t310_left >= 0:
            self._t310_left -= 1
            if self._t310_left < 0:
                self.radio_link_failure("otherFailure")
        self.step_measurements()

    # -------- radio-link monitoring (§5.3.11.1-2; counters are stepped
    # by per-subframe sync-quality indications from the receiver)
    def on_out_of_sync(self) -> None:
        if self.state != RrcState.CONNECTED:
            return
        if self._t310_left >= 0:
            # T310 runs on wall-clock (step_tti); an out-of-sync while it
            # runs only breaks the N311 CONSECUTIVE in-sync requirement
            # (36.331 §5.3.11.2; ADVICE r3 low)
            self._is_count = 0
            return
        self._is_count = 0
        self._oos_count += 1
        if self._oos_count >= self.n310:
            self._t310_left = self.t310_ms  # T310 started
            self._oos_count = 0

    def on_in_sync(self) -> None:
        if self._t310_left >= 0:
            self._is_count += 1
            if self._is_count >= self.n311:
                self._t310_left = -1  # T310 stopped: recovered
                self._is_count = 0
        else:
            self._oos_count = 0

    def max_retx_attempted(self) -> None:
        """RLC AM gave up. The reference leaves this TODO and the UE
        stuck (rrc.cc:194-197); 36.331 §5.3.11.3 says RLF -> initiate
        re-establishment."""
        self.radio_link_failure("otherFailure")
