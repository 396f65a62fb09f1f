"""The port's own copy of ``srsue_tpu/enb/stack.py`` (its reference), unchanged below this docstring.

eNB upper-stack emulator: RRC + NAS/MME responder driving a UE through
the full attach call flow (ConnectionSetup, authentication, NAS+AS
security, capability enquiry, DRB setup with AttachAccept), speaking the
same RRC/NAS codecs and RLC/PDCP entities as the UE (peer-configured).

Transport coupling is at the RLC-PDU level: `pump()` exchanges PDUs both
ways with configurable grant sizes — the MAC/PHY path below is exercised
by the PHY-level tests; this keeps the control-plane flow hermetic (the
layer-pair pattern of ue/test/upper/rlc_am_test.cc generalized to the
whole upper stack).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..nas import messages as NM
from ..pdcp.pdcp import PdcpConfig, PdcpEntity
from ..rlc.rlc_am import AmConfig, RlcAm
from ..rlc.rlc_tm import RlcTm
from ..rrc import messages as M
from ..usim import security as sec
from ..usim.usim import Usim, UsimConfig


class EnbStack:
    def __init__(self, ue_usim_cfg: UsimConfig | None = None):
        # the "HSS": knows the UE's K/OPc to run AKA
        self.hss = Usim(ue_usim_cfg or UsimConfig())
        self.rand = os.urandom(16)
        self.sqn = bytes(6)
        self.k_asme: bytes | None = None
        self.k_nas_int: bytes | None = None
        self.nas_count_dl = 0
        self.nas_count_ul = 0
        self.eea, self.eia = 0, 2

        self.srb0 = RlcTm(write_up=self._on_ccch)
        self.srb1 = RlcAm(
            AmConfig(), write_up=self._on_dcch
        )
        pc = PdcpConfig(is_control=True, bearer_id=1, tx_direction=1, rx_direction=0)
        self.pdcp1 = PdcpEntity(1, pc, self.srb1.write_sdu, self._on_dcch_sdu)
        # user-plane DRB peer (data loops back here in E2E tests)
        self.drb = RlcAm(AmConfig(), write_up=self._on_drb_pdu)
        self.drb_pdcp = PdcpEntity(
            3, PdcpConfig(sn_bits=12, bearer_id=3, tx_direction=1, rx_direction=0),
            self.drb.write_sdu, self._on_user_packet,
        )
        self.rx_packets: list[bytes] = []
        self.state = "idle"
        self.reconfig_complete = False
        self.t_crnti = 0x4601
        self.events: list[str] = []
        self.attach_request: NM.AttachRequest | None = None
        self.ue_capability: dict | None = None
        self.meas_reports: list[dict] = []
        # periodic-CQI format the ConnectionSetup configures: None =
        # widebandCQI, K = subbandCQI(k) Mode 2-0 (set before attach)
        self.cqi_format_k: int | None = None
        self.drb_lcid = 3
        self.ue_ip = "172.16.0.2"
        # serving-cell identity + AS key state for re-establishment
        self.pci = 0
        self.earfcn = 0
        self.cell_identity = 0x0101
        self.k_enb: bytes | None = None
        self.ncc = 0
        self.nh: bytes | None = None
        self.reest_ncc = 1  # NCC signalled in Reestablishment (exercises
        #                     the vertical NH-chain derivation)

    # ------------------------------------------------- broadcast
    def make_sib1(self) -> bytes:
        return M.pack_sib1({
            "cellAccessRelatedInfo": {
                "plmn_IdentityList": [{
                    "plmn_Identity": M.plmn(mcc=1, mnc=1),
                    "cellReservedForOperatorUse": "notReserved",
                }],
                "trackingAreaCode": 0x1234,
                "cellIdentity": 0x0101,
                "cellBarred": "notBarred",
                "intraFreqReselection": "allowed",
                "csg_Indication": False,
            },
            "cellSelectionInfo": {"q_RxLevMin": -60},
            "freqBandIndicator": 7,
            "schedulingInfoList": [{
                "si_Periodicity": "rf16",
                "sib_MappingInfo": [],  # first SI message implicitly = SIB2
            }],
            "si_WindowLength": "ms20",
            "systemInfoValueTag": 0,
        })

    def make_paging(self, imsi: str | None = None,
                    s_tmsi: tuple[int, int] | None = None,
                    si_modification: bool = False) -> bytes:
        """PCCH Paging message (36.331 §6.2.2; capability-plus — the
        reference eNB-side has no counterpart, and srsUE has no PCCH)."""
        body: dict = {}
        recs = []
        if imsi is not None:
            recs.append({"ue_Identity": ("imsi", [int(c) for c in imsi]),
                         "cn_Domain": "ps"})
        if s_tmsi is not None:
            recs.append({"ue_Identity": ("s_TMSI",
                                         {"mmec": s_tmsi[0],
                                          "m_TMSI": s_tmsi[1]}),
                         "cn_Domain": "ps"})
        if recs:
            body["pagingRecordList"] = recs
        if si_modification:
            body["systemInfoModification"] = "true"
        return M.pack("PCCH", "paging", body)

    def make_sib2(self) -> bytes:
        return M.pack_si_sib2({
            "radioResourceConfigCommon": {
                "rach_ConfigCommon": {
                    "preambleInfo": {"numberOfRA_Preambles": "n52"},
                    "powerRampingParameters": {
                        "powerRampingStep": "dB4",
                        "preambleInitialReceivedTargetPower": "dBm-104",
                    },
                    "ra_SupervisionInfo": {
                        "preambleTransMax": "n10",
                        "ra_ResponseWindowSize": "sf10",
                        "mac_ContentionResolutionTimer": "sf64",
                    },
                    "maxHARQ_Msg3Tx": 5,
                },
                "bcch_Config": {"modificationPeriodCoeff": "n2"},
                "pcch_Config": {"defaultPagingCycle": "rf128", "nB": "oneT"},
                "prach_Config": {
                    "rootSequenceIndex": 128,
                    "prach_ConfigInfo": {
                        "prach_ConfigIndex": 3,
                        "highSpeedFlag": False,
                        "zeroCorrelationZoneConfig": 5,
                        "prach_FreqOffset": 2,
                    },
                },
                "pdsch_ConfigCommon": {"referenceSignalPower": 0, "p_b": 0},
                "pusch_ConfigCommon": {
                    "pusch_ConfigBasic": {
                        "n_SB": 1, "hoppingMode": "interSubFrame",
                        "pusch_HoppingOffset": 2, "enable64QAM": False,
                    },
                    "ul_ReferenceSignalsPUSCH": {
                        "groupHoppingEnabled": False,
                        "groupAssignmentPUSCH": 0,
                        "sequenceHoppingEnabled": False,
                        "cyclicShift": 0,
                    },
                },
                "pucch_ConfigCommon": {
                    "deltaPUCCH_Shift": "ds1", "nRB_CQI": 1,
                    "nCS_AN": 0, "n1PUCCH_AN": 2,
                },
                "soundingRS_UL_ConfigCommon": ("release", None),
                "uplinkPowerControlCommon": {
                    "p0_NominalPUSCH": -85,
                    "alpha": "al07",
                    "p0_NominalPUCCH": -106,
                    "deltaFList_PUCCH": {
                        "deltaF_PUCCH_Format1": "deltaF0",
                        "deltaF_PUCCH_Format1b": "deltaF3",
                        "deltaF_PUCCH_Format2": "deltaF0",
                        "deltaF_PUCCH_Format2a": "deltaF0",
                        "deltaF_PUCCH_Format2b": "deltaF0",
                    },
                    "deltaPreambleMsg3": 3,  # = +6 dB (units of 2 dB)
                },
                "ul_CyclicPrefixLength": "len1",
            },
            "ue_TimersAndConstants": {
                "t300": "ms1000", "t301": "ms1000", "t310": "ms1000",
                "n310": "n1", "t311": "ms1000", "n311": "n1",
            },
            "freqInfo": {"additionalSpectrumEmission": 1},
            "timeAlignmentTimerCommon": "sf10240",
        })

    # ------------------------------------------------- RLC-facing plumbing
    def _on_ccch(self, sdu: bytes) -> None:
        name, _, body = M.unpack("UL-CCCH", sdu)
        if name == "rrcConnectionRequest":
            self.events.append("con_request")
            setup = M.pack("DL-CCCH", "rrcConnectionSetup", {
                "radioResourceConfigDedicated": {
                    "srb_ToAddModList": [{
                        "srb_Identity": 1,
                        "rlc_Config": ("defaultValue", None),
                        "logicalChannelConfig": ("defaultValue", None),
                    }],
                    "physicalConfigDedicated": {
                        "cqi_ReportConfig": {
                            "nomPDSCH_RS_EPRE_Offset": 0,
                            "cqi_ReportPeriodic": ("setup", {
                                "cqi_PUCCH_ResourceIndex": 0,
                                "cqi_pmi_ConfigIndex": 40,
                                "cqi_FormatIndicatorPeriodic": (
                                    ("subbandCQI", {"k": self.cqi_format_k})
                                    if self.cqi_format_k
                                    else ("widebandCQI", None)),
                                "simultaneousAckNackAndCQI": False,
                            }),
                        },
                        "schedulingRequestConfig": ("setup", {
                            "sr_PUCCH_ResourceIndex": 1,
                            "sr_ConfigIndex": 17,
                            "dsr_TransMax": "n64",
                        }),
                        "antennaInfo": ("explicitValue", {
                            "transmissionMode": "tm1",
                            "ue_TransmitAntennaSelection": ("release", None),
                        }),
                    },
                },
            }, tid=0)
            self.srb0.write_sdu(setup)
            self.state = "wait_setup_complete"
        elif name == "rrcConnectionReestablishmentRequest":
            self._on_reestablishment_request(body)

    # ---------------------------------------- connection re-establishment
    def _short_mac_i_expected(self, crnti: int) -> int:
        from ..rrc import asn1 as A
        from ..rrc import uper

        data = uper.encode(A.VarShortMAC_Input, {
            "cellIdentity": self.cell_identity,
            "physCellId": self.pci,
            "c_RNTI": crnti,
        })
        k_rrc_int = sec.kdf_as(self.k_enb, self.eia, "rrc_int")
        return int.from_bytes(
            sec.eia2(k_rrc_int, 0xFFFFFFFF, 0x1F, 1, data)[2:4], "big")

    def _k_enb_star(self, ncc: int, pci: int, earfcn: int) -> bytes:
        """Key chaining shared by re-establishment and handover
        (33.401 §7.2.8): horizontal from the current K_eNB at the same
        NCC, vertical via the NH chain for a larger one."""
        if ncc <= self.ncc:
            basis = self.k_enb
        else:
            while self.ncc < ncc:
                self.nh = sec.kdf_nh(self.k_asme, self.nh)
                self.ncc += 1
            basis = self.nh
        return sec.kdf_k_enb_star(basis, pci, earfcn)

    def _rebuild_srb1(self) -> None:
        """Fresh SRB1 RLC + PDCP entities under the current K_eNB,
        integrity on from the first PDU."""
        self.srb1 = RlcAm(AmConfig(), write_up=self._on_dcch)
        pc = PdcpConfig(is_control=True, bearer_id=1,
                        tx_direction=1, rx_direction=0)
        self.pdcp1 = PdcpEntity(1, pc, self.srb1.write_sdu,
                                self._on_dcch_sdu)
        self.pdcp1.config_security(
            sec.kdf_as(self.k_enb, self.eea, "rrc_enc"),
            sec.kdf_as(self.k_enb, self.eia, "rrc_int"),
        )
        self.pdcp1.enable_integrity()

    def _on_reestablishment_request(self, body: dict) -> None:
        self.events.append("reest_request")
        ident = body["ue_Identity"]
        known = (self.k_enb is not None
                 and ident["c_RNTI"] == self.t_crnti
                 and ident["physCellId"] == self.pci
                 and ident["shortMAC_I"]
                 == self._short_mac_i_expected(ident["c_RNTI"]))
        if not known:
            self.events.append("reest_reject")
            self.srb0.write_sdu(M.pack(
                "DL-CCCH", "rrcConnectionReestablishmentReject", {}))
            return
        # re-key: KeNB* with the signalled NCC (33.401 §7.2.8.4)
        ncc = self.reest_ncc
        self.k_enb = self._k_enb_star(ncc, self.pci, self.earfcn)
        # re-establish SRB1 (fresh RLC + PDCP state) under the new keys,
        # integrity on from the first PDU (36.331 §5.3.7.5)
        self._rebuild_srb1()
        reest = M.pack("DL-CCCH", "rrcConnectionReestablishment", {
            "radioResourceConfigDedicated": {
                "srb_ToAddModList": [{
                    "srb_Identity": 1,
                    "rlc_Config": ("defaultValue", None),
                    "logicalChannelConfig": ("defaultValue", None),
                }],
            },
            "nextHopChainingCount": ncc,
        }, tid=0)
        self.srb0.write_sdu(reest)
        self.state = "wait_reest_complete"

    def _on_dcch(self, pdu: bytes) -> None:
        self.pdcp1.write_pdu(pdu)

    def _on_drb_pdu(self, pdu: bytes) -> None:
        self.drb_pdcp.write_pdu(pdu)

    def _on_user_packet(self, lcid: int, sdu: bytes) -> None:
        self.rx_packets.append(sdu)

    def send_user_packet(self, pkt: bytes) -> None:
        self.drb_pdcp.write_sdu(pkt)

    def _on_dcch_sdu(self, lcid: int, sdu: bytes) -> None:
        kind, tid, body = M.unpack("UL-DCCH", sdu)
        self.events.append(kind)
        if kind == "rrcConnectionSetupComplete":
            self.attach_request = NM.AttachRequest.unpack(
                body["dedicatedInfoNAS"])
            self._send_auth_request()
        elif kind == "ulInformationTransfer":
            info_kind, nas_pdu = body["dedicatedInfoType"]
            if info_kind == "dedicatedInfoNAS":
                self._on_nas(nas_pdu)
        elif kind == "securityModeComplete":
            self._send_capability_enquiry()
        elif kind == "ueCapabilityInformation":
            caps = body["ue_CapabilityRAT_ContainerList"]
            self.ue_capability = next(
                (M.parse_ue_eutra_capability(c["ueCapabilityRAT_Container"])
                 for c in caps if c["rat_Type"] == "eutra"), None)
            self._send_reconfiguration_with_attach_accept()
        elif kind == "measurementReport":
            mr = body["measResults"]
            self.meas_reports.append(mr)
            ncells = mr.get("measResultNeighCells")
            if (ncells and ncells[0] == "measResultListEUTRA"
                    and getattr(self, "_meas_auto_ho", False)):
                best = max(ncells[1],
                           key=lambda c: c["measResult"].get("rsrpResult", 0))
                pci = best["physCellId"]
                self.events.append(f"a3_report_pci{pci}")
                self._meas_auto_ho = False
                ncc, ded, crnti = self._meas_ho_cfg
                self.initiate_handover(pci, crnti, ncc=ncc,
                                       dedicated_preamble=ded)
        elif kind == "rrcConnectionReconfigurationComplete":
            self.reconfig_complete = True
            if self.state == "wait_ho_complete":
                # arrived on the target's rebuilt SRB1 under the new keys
                self.state = "attached"
                self.events.append("ho_complete")
        elif kind == "rrcConnectionReestablishmentComplete":
            # resume the user plane: fresh RLC AM entity, but the AM-DRB
            # PDCP entity KEEPS its COUNTs (36.323 §5.2 — continuity is
            # covered by the status report) and is rebound to the new RLC;
            # the reconfiguration below re-adds the DRB on the UE side
            self.drb = RlcAm(AmConfig(), write_up=self._on_drb_pdu)
            self.drb_pdcp.rlc_write = self.drb.write_sdu
            self.state = "attached"
            msg = M.pack("DL-DCCH", "rrcConnectionReconfiguration", {
                "radioResourceConfigDedicated": {
                    "drb_ToAddModList": [self._drb_to_add_mod()],
                },
            }, tid=0)
            self.pdcp1.write_sdu(msg)

    # ------------------------------------------------- NAS/MME side
    def _send_dl_info(self, nas_pdu: bytes) -> None:
        msg = M.pack("DL-DCCH", "dlInformationTransfer", {
            "dedicatedInfoType": ("dedicatedInfoNAS", nas_pdu),
        }, tid=0)
        self.pdcp1.write_sdu(msg)

    def _send_auth_request(self) -> None:
        autn = self._make_autn()
        nas = NM.AuthRequest(self.rand, autn).pack()
        self._send_dl_info(nas)
        self.state = "wait_auth"

    def _make_autn(self) -> bytes:
        res, ck, ik, ak = sec.milenage_f2345(self.hss.cfg.k, self.hss.opc, self.rand)
        mac_a, _ = sec.milenage_f1(
            self.hss.cfg.k, self.hss.opc, self.rand, self.sqn, self.hss.cfg.amf
        )
        sqn_xor_ak = bytes(a ^ b for a, b in zip(self.sqn, ak))
        self.expected_res = res
        plmn = Usim._plmn_bytes(1, 1)
        self.k_asme = sec.kdf_k_asme(ck, ik, plmn, sqn_xor_ak)
        return sqn_xor_ak + self.hss.cfg.amf + mac_a

    def _on_nas(self, pdu: bytes) -> None:
        sec_type, mac4, seq, plain = NM.secure_unwrap(pdu)
        if sec_type != NM.SEC_NONE and self.k_nas_int is not None:
            want = sec.eia2(self.k_nas_int, self.nas_count_ul, 0, 0,
                            bytes([seq]) + plain)
            if want != mac4:
                self.events.append("nas_integrity_fail")
                return
            self.nas_count_ul += 1
        mt = NM.msg_type_of(plain)
        if mt == NM.MT_AUTH_RESPONSE:
            resp = NM.AuthResponse.unpack(plain)
            assert resp.res == self.expected_res, "AKA RES mismatch"
            self.events.append("auth_ok")
            self._send_nas_security_mode()
        elif mt == NM.MT_SECURITY_MODE_COMPLETE:
            self.events.append("nas_smc_ok")
            self._send_rrc_security_mode()
        elif mt == NM.MT_ATTACH_COMPLETE:
            self.events.append("attach_complete")
            self.state = "attached"

    def _send_nas_security_mode(self) -> None:
        self.k_nas_int = sec.kdf_nas(self.k_asme, self.eia, is_integrity=True)
        nas = NM.SecurityModeCommand(self.eea, self.eia).pack()
        self._send_dl_info(nas)

    def _send_rrc_security_mode(self) -> None:
        # derive AS keys like the UE will (nas ul count snapshot = 0)
        k_enb = sec.kdf_k_enb(self.k_asme, 0)
        self.k_enb, self.ncc, self.nh = k_enb, 0, k_enb
        self.pdcp1.config_security(
            sec.kdf_as(k_enb, self.eea, "rrc_enc"),
            sec.kdf_as(k_enb, self.eia, "rrc_int"),
        )
        msg = M.pack("DL-DCCH", "securityModeCommand", {
            "securityConfigSMC": {
                "securityAlgorithmConfig": {
                    "cipheringAlgorithm": f"eea{self.eea}",
                    "integrityProtAlgorithm":
                        "reserved" if self.eia == 0 else f"eia{self.eia}",
                },
            },
        }, tid=1)
        self.pdcp1.write_sdu(msg)
        self.pdcp1.enable_integrity()

    def _send_capability_enquiry(self) -> None:
        msg = M.pack("DL-DCCH", "ueCapabilityEnquiry", {
            "ue_CapabilityRequest": ["eutra"],
        }, tid=2)
        self.pdcp1.write_sdu(msg)

    def _send_reconfiguration_with_attach_accept(self) -> None:
        esm = NM.ActivateDefaultBearerRequest(ip_addr=self.ue_ip).pack()
        nas = NM.AttachAccept(esm_pdu=esm, guti=os.urandom(10)).pack()
        mac4 = sec.eia2(self.k_nas_int, self.nas_count_dl, 0, 1,
                        bytes([self.nas_count_dl & 0xFF]) + nas)
        nas_sec = NM.secure_wrap(nas, self.nas_count_dl, mac4)
        self.nas_count_dl += 1
        msg = M.pack("DL-DCCH", "rrcConnectionReconfiguration", {
            "dedicatedInfoNASList": [nas_sec],
            "radioResourceConfigDedicated": {
                "drb_ToAddModList": [self._drb_to_add_mod()],
            },
        }, tid=3)
        self.pdcp1.write_sdu(msg)

    def _drb_to_add_mod(self) -> dict:
        return {
            "eps_BearerIdentity": 5,
            "drb_Identity": 1,
            "pdcp_Config": {
                "discardTimer": "infinity",
                "rlc_AM": {"statusReportRequired": False},
                "headerCompression": ("notUsed", None),
            },
            "rlc_Config": ("am", {
                "ul_AM_RLC": {
                    "t_PollRetransmit": "ms45",
                    "pollPDU": "p64",
                    "pollByte": "kB500",
                    "maxRetxThreshold": "t4",
                },
                "dl_AM_RLC": {
                    "t_Reordering": "ms35",
                    "t_StatusProhibit": "ms0",
                },
            }),
            "logicalChannelIdentity": self.drb_lcid,
            "logicalChannelConfig": {
                "ul_SpecificParameters": {
                    "priority": 4,
                    "prioritisedBitRate": "kBps8",
                    "bucketSizeDuration": "ms100",
                    "logicalChannelGroup": 2,
                },
            },
        }

    # ------------------------------------------------- measurements (§5.5)
    def configure_measurements(self, neighbor_pcis, a3_offset_db: float = 3.0,
                               hysteresis_db: float = 1.0, ttt: str = "ms64",
                               auto_handover: bool = True,
                               ho_crnti: int | None = None, ncc: int = 1,
                               dedicated_preamble: int = 7) -> None:
        """Arm event-A3 measurement reporting on the UE (measConfig in a
        reconfiguration) and, when auto_handover, answer the first A3
        report with an intra-LTE handover toward the reported PCI —
        the closed mobility loop the reference never implements."""
        mc = {
            "measObjectToAddModList": [{
                "measObjectId": 1,
                "measObject": ("measObjectEUTRA", {
                    "carrierFreq": self.earfcn,
                    "allowedMeasBandwidth": "mbw15",
                    "presenceAntennaPort1": False,
                    "neighCellConfig": 0,
                    "cellsToAddModList": [
                        {"cellIndex": i + 1, "physCellId": pci,
                         "cellIndividualOffset": "dB0"}
                        for i, pci in enumerate(neighbor_pcis)
                    ],
                }),
            }],
            "reportConfigToAddModList": [{
                "reportConfigId": 1,
                "reportConfig": ("reportConfigEUTRA", {
                    "triggerType": ("event", {
                        "eventId": ("eventA3", {
                            "a3_Offset": int(round(2 * a3_offset_db)),
                            "reportOnLeave": False,
                        }),
                        "hysteresis": int(round(2 * hysteresis_db)),
                        "timeToTrigger": ttt,
                    }),
                    "triggerQuantity": "rsrp",
                    "reportQuantity": "sameAsTriggerQuantity",
                    "maxReportCells": 4,
                    "reportInterval": "ms480",
                    "reportAmount": "r1",
                }),
            }],
            "measIdToAddModList": [
                {"measId": 1, "measObjectId": 1, "reportConfigId": 1}],
            "quantityConfig": {
                "quantityConfigEUTRA": {"filterCoefficientRSRP": "fc4"}},
        }
        msg = M.pack("DL-DCCH", "rrcConnectionReconfiguration",
                     {"measConfig": mc}, tid=2)
        self.pdcp1.write_sdu(msg)
        self._meas_auto_ho = auto_handover
        self._meas_ho_cfg = (ncc, dedicated_preamble,
                             ho_crnti if ho_crnti is not None
                             else (self.t_crnti ^ 0x4000))
        self.events.append("meas_configured")

    # ------------------------------------------------- intra-LTE handover
    def initiate_handover(self, new_pci: int, new_crnti: int, ncc: int = 1,
                          dedicated_preamble: int | None = 7) -> None:
        """Source-role half of an intra-eNB handover: send the
        reconfiguration with mobilityControlInfo + securityConfigHO on
        the CURRENT SRB1, then become the target (new identity, K_eNB*
        keys, fresh SRB1/RLC; AM-DRB PDCP COUNTs continue)."""
        mci = {
            "targetPhysCellId": new_pci,
            "t304": "ms200",
            "newUE_Identity": new_crnti,
            "radioResourceConfigCommon": {
                "prach_Config": {"rootSequenceIndex": 128},
                "pusch_ConfigCommon": {
                    "pusch_ConfigBasic": {
                        "n_SB": 1, "hoppingMode": "interSubFrame",
                        "pusch_HoppingOffset": 2, "enable64QAM": False,
                    },
                    "ul_ReferenceSignalsPUSCH": {
                        "groupHoppingEnabled": False,
                        "groupAssignmentPUSCH": 0,
                        "sequenceHoppingEnabled": False,
                        "cyclicShift": 0,
                    },
                },
                "ul_CyclicPrefixLength": "len1",
            },
        }
        if dedicated_preamble is not None:
            mci["rach_ConfigDedicated"] = {
                "ra_PreambleIndex": dedicated_preamble,
                "ra_PRACH_MaskIndex": 0,
            }
        msg = M.pack("DL-DCCH", "rrcConnectionReconfiguration", {
            "mobilityControlInfo": mci,
            "securityConfigHO": {"handoverType": ("intraLTE", {
                "keyChangeIndicator": False,
                "nextHopChainingCount": ncc,
            })},
        }, tid=1)
        self.pdcp1.write_sdu(msg)
        # drain the handover command out of the SOURCE SRB1 before the
        # entity swap (it must reach the UE under the OLD keys)
        self._ho_outbox = []
        while True:
            p = self.srb1.read_pdu(4096)
            if not p:
                break
            self._ho_outbox.append(p)
        # become the target
        self.pci = new_pci
        self.t_crnti = new_crnti
        self.k_enb = self._k_enb_star(ncc, new_pci, self.earfcn)
        self._rebuild_srb1()
        self.drb = RlcAm(AmConfig(), write_up=self._on_drb_pdu)
        self.drb_pdcp.rlc_write = self.drb.write_sdu
        self.state = "wait_ho_complete"
        self.events.append("ho_initiated")

    # ------------------------------------------------- transport pump
    def pump(self, ue_rlc, n_rounds: int = 20, grant: int = 1000) -> None:
        """Exchange SRB0/SRB1 RLC PDUs with the UE's RLC container until
        quiescent (both directions, generous grants)."""
        for _ in range(n_rounds):
            moved = False
            while getattr(self, "_ho_outbox", None):
                # source-cell SRB1 PDUs drained at handover initiation
                ue_rlc.write_pdu(1, self._ho_outbox.pop(0))
                moved = True
            for lcid, enb_ent in ((0, self.srb0), (1, self.srb1), (3, self.drb)):
                pdu = ue_rlc.read_pdu(lcid, grant)
                if pdu:
                    enb_ent.write_pdu(pdu)
                    moved = True
                pdu = enb_ent.read_pdu(grant)
                if pdu:
                    ue_rlc.write_pdu(lcid, pdu)
                    moved = True
            if not moved:
                break
