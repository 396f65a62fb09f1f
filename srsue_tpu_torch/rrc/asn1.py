"""The port's own copy of ``srsue_tpu/rrc/asn1.py`` (its reference), unchanged below this docstring.

36.331 (Rel-8) ASN.1 message schemas over the UPER engine (rrc/uper.py).

Covers the message set srsUE touches (reference call sites:
ue/src/upper/rrc.cc:203-429 senders, 435-525 parsers, 589-860 config
fan-out; codecs consumed from liblte/src/liblte_rrc.cc) — MIB lives in
phy/pbch.py as raw 24-bit fields; everything else is here:

* BCCH-DL-SCH: SystemInformation (SIB2), SystemInformationBlockType1
* PCCH: Paging
* UL-CCCH: RRCConnectionRequest (+ ReestablishmentRequest schema)
* DL-CCCH: RRCConnectionSetup / Reject / Reestablishment(+Reject)
* UL-DCCH: SetupComplete, SecurityModeComplete/Failure,
  UECapabilityInformation (with UE-EUTRA-Capability container),
  ReconfigurationComplete, ULInformationTransfer,
  ReestablishmentComplete
* DL-DCCH: Reconfiguration, Release, SecurityModeCommand,
  UECapabilityEnquiry, DLInformationTransfer

Field names are the ASN.1 identifiers with '-' -> '_'. Alternatives the
stack never produces or consumes (CDMA2000 IRAT, handover, counter
check, measConfig) are `Unsupported` placeholders: they keep the CHOICE
index arithmetic bit-exact and fail loudly if one ever arrives.
"""

from __future__ import annotations

from .uper import (
    BitStr, Bool, Choice, Codec, Contained, Enum, Int, Null, OctetStr, OPT,
    Seq, SeqOf,
)


class Unsupported(Codec):
    """A spec alternative we deliberately don't implement (absent from
    srsUE's surface too). Keeps CHOICE indices exact; raises on use."""

    def __init__(self, what: str):
        self.what = what

    def enc(self, w, v):
        raise NotImplementedError(f"encoding of {self.what} not supported")

    def dec(self, r):
        raise NotImplementedError(f"decoding of {self.what} not supported")


# --------------------------------------------------------------------------
# Basic IEs
# --------------------------------------------------------------------------

MCC_MNC_Digit = Int(0, 9)
PLMN_Identity = Seq(
    ("mcc", SeqOf(MCC_MNC_Digit, 3, 3), OPT),
    ("mnc", SeqOf(MCC_MNC_Digit, 2, 3)),
)
C_RNTI = BitStr(16)
ARFCN_ValueEUTRA = Int(0, 65535)
TimeAlignmentTimer = Enum(
    "sf500", "sf750", "sf1280", "sf1920", "sf2560", "sf5120", "sf10240",
    "infinity",
)
RRC_TransactionIdentifier = Int(0, 3)
NextHopChainingCount = Int(0, 7)


def crit_ext_c1(n_spare: int, real_name: str, real: Codec) -> Codec:
    """criticalExtensions CHOICE { c1 CHOICE {x-r8, spareN..}, future {} }."""
    alts = [(real_name, real)] + [
        (f"spare{n_spare - i}", Null()) for i in range(n_spare)
    ]
    return Choice(
        ("c1", Choice(*alts)),
        ("criticalExtensionsFuture", Seq()),
    )


def crit_ext_plain(real_name: str, real: Codec) -> Codec:
    """criticalExtensions CHOICE { x-r8, criticalExtensionsFuture {} }."""
    return Choice((real_name, real), ("criticalExtensionsFuture", Seq()))


# --------------------------------------------------------------------------
# RLC / MAC / PDCP / logical channel dedicated IEs (36.331 §6.3.2)
# --------------------------------------------------------------------------

T_PollRetransmit = Enum(
    *[f"ms{v}" for v in range(5, 255, 5)],
    *[f"ms{v}" for v in range(300, 550, 50)],
    *[f"spare{i}" for i in range(9, 0, -1)],
)
PollPDU = Enum("p4", "p8", "p16", "p32", "p64", "p128", "p256", "pInfinity")
PollByte = Enum(
    "kB25", "kB50", "kB75", "kB100", "kB125", "kB250", "kB375", "kB500",
    "kB750", "kB1000", "kB1250", "kB1500", "kB2000", "kB3000", "kBinfinity",
    "spare1",
)
T_Reordering = Enum(
    *[f"ms{v}" for v in range(0, 105, 5)],
    *[f"ms{v}" for v in range(110, 210, 10)],
    "spare1",
)
T_StatusProhibit = Enum(
    *[f"ms{v}" for v in range(0, 255, 5)],
    *[f"ms{v}" for v in range(300, 550, 50)],
    *[f"spare{i}" for i in range(8, 0, -1)],
)
SN_FieldLength = Enum("size5", "size10")

UL_AM_RLC = Seq(
    ("t_PollRetransmit", T_PollRetransmit),
    ("pollPDU", PollPDU),
    ("pollByte", PollByte),
    ("maxRetxThreshold", Enum("t1", "t2", "t3", "t4", "t6", "t8", "t16", "t32")),
)
DL_AM_RLC = Seq(
    ("t_Reordering", T_Reordering),
    ("t_StatusProhibit", T_StatusProhibit),
)
UL_UM_RLC = Seq(("sn_FieldLength", SN_FieldLength))
DL_UM_RLC = Seq(
    ("sn_FieldLength", SN_FieldLength),
    ("t_Reordering", T_Reordering),
)

RLC_Config = Choice(
    ("am", Seq(("ul_AM_RLC", UL_AM_RLC), ("dl_AM_RLC", DL_AM_RLC))),
    ("um_Bi_Directional", Seq(("ul_UM_RLC", UL_UM_RLC), ("dl_UM_RLC", DL_UM_RLC))),
    ("um_Uni_Directional_UL", Seq(("ul_UM_RLC", UL_UM_RLC))),
    ("um_Uni_Directional_DL", Seq(("dl_UM_RLC", DL_UM_RLC))),
    ext=True,
)

LogicalChannelConfig = Seq(
    (
        "ul_SpecificParameters",
        Seq(
            ("priority", Int(1, 16)),
            ("prioritisedBitRate", Enum(
                "kBps0", "kBps8", "kBps16", "kBps32", "kBps64", "kBps128",
                "kBps256", "infinity", "spare8", "spare7", "spare6", "spare5",
                "spare4", "spare3", "spare2", "spare1")),
            ("bucketSizeDuration", Enum(
                "ms50", "ms100", "ms150", "ms300", "ms500", "ms1000",
                "spare2", "spare1")),
            ("logicalChannelGroup", Int(0, 3), OPT),
        ),
        OPT,
    ),
    ext=True,
)

PDCP_Config = Seq(
    ("discardTimer", Enum(
        "ms50", "ms100", "ms150", "ms300", "ms500", "ms750", "ms1500",
        "infinity"), OPT),
    ("rlc_AM", Seq(("statusReportRequired", Bool())), OPT),
    ("rlc_UM", Seq(("pdcp_SN_Size", Enum("len7bits", "len12bits"))), OPT),
    ("headerCompression", Choice(
        ("notUsed", Null()),
        ("rohc", Seq(
            ("maxCID", Int(1, 16383), OPT, 15),
            ("profiles", Seq(*[
                (f"profile0x{p}", Bool())
                for p in ("0001", "0002", "0003", "0004", "0006",
                          "0101", "0102", "0103", "0104")
            ])),
            ext=True,
        )),
    )),
    ext=True,
)

SRB_ToAddMod = Seq(
    ("srb_Identity", Int(1, 2)),
    ("rlc_Config", Choice(("explicitValue", RLC_Config), ("defaultValue", Null())), OPT),
    ("logicalChannelConfig", Choice(
        ("explicitValue", LogicalChannelConfig), ("defaultValue", Null())), OPT),
    ext=True,
)
DRB_ToAddMod = Seq(
    ("eps_BearerIdentity", Int(0, 15), OPT),
    ("drb_Identity", Int(1, 32)),
    ("pdcp_Config", PDCP_Config, OPT),
    ("rlc_Config", RLC_Config, OPT),
    ("logicalChannelIdentity", Int(3, 10), OPT),
    ("logicalChannelConfig", LogicalChannelConfig, OPT),
    ext=True,
)

# ------------------------------------------------------------------ MAC
DRX_Config = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("onDurationTimer", Enum(
            "psf1", "psf2", "psf3", "psf4", "psf5", "psf6", "psf8", "psf10",
            "psf20", "psf30", "psf40", "psf50", "psf60", "psf80", "psf100",
            "psf200")),
        ("drx_InactivityTimer", Enum(
            "psf1", "psf2", "psf3", "psf4", "psf5", "psf6", "psf8", "psf10",
            "psf20", "psf30", "psf40", "psf50", "psf60", "psf80", "psf100",
            "psf200", "psf300", "psf500", "psf750", "psf1280", "psf1920",
            "psf2560", *[f"spare{i}" for i in range(10, 0, -1)])),
        ("drx_RetransmissionTimer", Enum(
            "psf1", "psf2", "psf4", "psf6", "psf8", "psf16", "psf24", "psf33")),
        ("longDRX_CycleStartOffset", Choice(*[
            (f"sf{n}", Int(0, n - 1))
            for n in (10, 20, 32, 40, 64, 80, 128, 160, 256, 320, 512, 640,
                      1024, 1280, 2048, 2560)
        ])),
        ("shortDRX", Seq(
            ("shortDRX_Cycle", Enum(
                "sf2", "sf5", "sf8", "sf10", "sf16", "sf20", "sf32", "sf40",
                "sf64", "sf80", "sf128", "sf160", "sf256", "sf320", "sf512",
                "sf640")),
            ("drxShortCycleTimer", Int(1, 16)),
        ), OPT),
    )),
)

MAC_MainConfig = Seq(
    ("ul_SCH_Config", Seq(
        ("maxHARQ_Tx", Enum(
            "n1", "n2", "n3", "n4", "n5", "n6", "n7", "n8", "n10", "n12",
            "n16", "n20", "n24", "n28", "spare2", "spare1"), OPT),
        ("periodicBSR_Timer", Enum(
            "sf5", "sf10", "sf16", "sf20", "sf32", "sf40", "sf64", "sf80",
            "sf128", "sf160", "sf320", "sf640", "sf1280", "sf2560",
            "infinity", "spare1"), OPT),
        ("retxBSR_Timer", Enum(
            "sf320", "sf640", "sf1280", "sf2560", "sf5120", "sf10240",
            "spare2", "spare1")),
        ("ttiBundling", Bool()),
    ), OPT),
    ("drx_Config", DRX_Config, OPT),
    ("timeAlignmentTimerDedicated", TimeAlignmentTimer),
    ("phr_Config", Choice(
        ("release", Null()),
        ("setup", Seq(
            ("periodicPHR_Timer", Enum(
                "sf10", "sf20", "sf50", "sf100", "sf200", "sf500", "sf1000",
                "infinity")),
            ("prohibitPHR_Timer", Enum(
                "sf0", "sf10", "sf20", "sf50", "sf100", "sf200", "sf500",
                "sf1000")),
            ("dl_PathlossChange", Enum("dB1", "dB3", "dB6", "infinity")),
        )),
    ), OPT),
    ext=True,
)

# ------------------------------------------------------------------ SPS
SPS_ConfigDL = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("semiPersistSchedIntervalDL", Enum(
            "sf10", "sf20", "sf32", "sf40", "sf64", "sf80", "sf128", "sf160",
            "sf320", "sf640", *[f"spare{i}" for i in range(6, 0, -1)])),
        ("numberOfConfSPS_Processes", Int(1, 8)),
        ("n1_PUCCH_AN_PersistentList", SeqOf(Int(0, 2047), 1, 4)),
        ext=True,
    )),
)
SPS_ConfigUL = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("semiPersistSchedIntervalUL", Enum(
            "sf10", "sf20", "sf32", "sf40", "sf64", "sf80", "sf128", "sf160",
            "sf320", "sf640", *[f"spare{i}" for i in range(6, 0, -1)])),
        ("implicitReleaseAfter", Enum("e2", "e3", "e4", "e8")),
        ("p0_Persistent", Seq(
            ("p0_NominalPUSCH_Persistent", Int(-126, 24)),
            ("p0_UE_PUSCH_Persistent", Int(-8, 7)),
        ), OPT),
        ("twoIntervalsConfig", Enum("true"), OPT),
        ext=True,
    )),
)
SPS_Config = Seq(
    ("semiPersistSchedC_RNTI", C_RNTI, OPT),
    ("sps_ConfigDL", SPS_ConfigDL, OPT),
    ("sps_ConfigUL", SPS_ConfigUL, OPT),
)

# ------------------------------------------------------------------ PHY dedicated
PDSCH_ConfigDedicated = Seq(
    ("p_a", Enum("dB-6", "dB-4dot77", "dB-3", "dB-1dot77", "dB0", "dB1",
                 "dB2", "dB3")),
)
PUCCH_ConfigDedicated = Seq(
    ("ackNackRepetition", Choice(
        ("release", Null()),
        ("setup", Seq(
            ("repetitionFactor", Enum("n2", "n4", "n6", "spare1")),
            ("n1PUCCH_AN_Rep", Int(0, 2047)),
        )),
    )),
    ("tdd_AckNackFeedbackMode", Enum("bundling", "multiplexing"), OPT),
)
PUSCH_ConfigDedicated = Seq(
    ("betaOffset_ACK_Index", Int(0, 15)),
    ("betaOffset_RI_Index", Int(0, 15)),
    ("betaOffset_CQI_Index", Int(0, 15)),
)
FilterCoefficient = Enum(
    "fc0", "fc1", "fc2", "fc3", "fc4", "fc5", "fc6", "fc7", "fc8", "fc9",
    "fc11", "fc13", "fc15", "fc17", "fc19", "spare1", ext=True,
)
UplinkPowerControlDedicated = Seq(
    ("p0_UE_PUSCH", Int(-8, 7)),
    ("deltaMCS_Enabled", Enum("en0", "en1")),
    ("accumulationEnabled", Bool()),
    ("p0_UE_PUCCH", Int(-8, 7)),
    ("pSRS_Offset", Int(0, 15)),
    ("filterCoefficient", FilterCoefficient, OPT, "fc4"),
)
TPC_Index = Choice(
    ("indexOfFormat3", Int(1, 15)),
    ("indexOfFormat3A", Int(1, 31)),
)
TPC_PDCCH_Config = Choice(
    ("release", Null()),
    ("setup", Seq(("tpc_RNTI", BitStr(16)), ("tpc_Index", TPC_Index))),
)
CQI_ReportPeriodic = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("cqi_PUCCH_ResourceIndex", Int(0, 1185)),
        ("cqi_pmi_ConfigIndex", Int(0, 1023)),
        ("cqi_FormatIndicatorPeriodic", Choice(
            ("widebandCQI", Null()),
            ("subbandCQI", Seq(("k", Int(1, 4)))),
        )),
        ("ri_ConfigIndex", Int(0, 1023), OPT),
        ("simultaneousAckNackAndCQI", Bool()),
    )),
)
CQI_ReportConfig = Seq(
    ("cqi_ReportModeAperiodic", Enum(
        "rm12", "rm20", "rm22", "rm30", "rm31", "spare3", "spare2", "spare1"),
     OPT),
    ("nomPDSCH_RS_EPRE_Offset", Int(-1, 6)),
    ("cqi_ReportPeriodic", CQI_ReportPeriodic, OPT),
)
SoundingRS_UL_ConfigDedicated = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("srs_Bandwidth", Enum("bw0", "bw1", "bw2", "bw3")),
        ("srs_HoppingBandwidth", Enum("hbw0", "hbw1", "hbw2", "hbw3")),
        ("freqDomainPosition", Int(0, 23)),
        ("duration", Bool()),
        ("srs_ConfigIndex", Int(0, 1023)),
        ("transmissionComb", Int(0, 1)),
        ("cyclicShift", Enum("cs0", "cs1", "cs2", "cs3", "cs4", "cs5", "cs6",
                             "cs7")),
    )),
)
AntennaInfoDedicated = Seq(
    ("transmissionMode", Enum("tm1", "tm2", "tm3", "tm4", "tm5", "tm6",
                              "tm7", "spare1")),
    ("codebookSubsetRestriction", Choice(
        ("n2TxAntenna_tm3", BitStr(2)),
        ("n4TxAntenna_tm3", BitStr(4)),
        ("n2TxAntenna_tm4", BitStr(6)),
        ("n4TxAntenna_tm4", BitStr(64)),
        ("n2TxAntenna_tm5", BitStr(4)),
        ("n4TxAntenna_tm5", BitStr(16)),
        ("n2TxAntenna_tm6", BitStr(4)),
        ("n4TxAntenna_tm6", BitStr(16)),
    ), OPT),
    ("ue_TransmitAntennaSelection", Choice(
        ("release", Null()),
        ("setup", Enum("closedLoop", "openLoop")),
    )),
)
SchedulingRequestConfig = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("sr_PUCCH_ResourceIndex", Int(0, 2047)),
        ("sr_ConfigIndex", Int(0, 155)),
        ("dsr_TransMax", Enum("n4", "n8", "n16", "n32", "n64", "spare3",
                              "spare2", "spare1")),
    )),
)

PhysicalConfigDedicated = Seq(
    ("pdsch_ConfigDedicated", PDSCH_ConfigDedicated, OPT),
    ("pucch_ConfigDedicated", PUCCH_ConfigDedicated, OPT),
    ("pusch_ConfigDedicated", PUSCH_ConfigDedicated, OPT),
    ("uplinkPowerControlDedicated", UplinkPowerControlDedicated, OPT),
    ("tpc_PDCCH_ConfigPUCCH", TPC_PDCCH_Config, OPT),
    ("tpc_PDCCH_ConfigPUSCH", TPC_PDCCH_Config, OPT),
    ("cqi_ReportConfig", CQI_ReportConfig, OPT),
    ("soundingRS_UL_ConfigDedicated", SoundingRS_UL_ConfigDedicated, OPT),
    ("antennaInfo", Choice(
        ("explicitValue", AntennaInfoDedicated), ("defaultValue", Null())),
     OPT),
    ("schedulingRequestConfig", SchedulingRequestConfig, OPT),
    ext=True,
)

RadioResourceConfigDedicated = Seq(
    ("srb_ToAddModList", SeqOf(SRB_ToAddMod, 1, 2), OPT),
    ("drb_ToAddModList", SeqOf(DRB_ToAddMod, 1, 11), OPT),
    ("drb_ToReleaseList", SeqOf(Int(1, 32), 1, 11), OPT),
    ("mac_MainConfig", Choice(
        ("explicitValue", MAC_MainConfig), ("defaultValue", Null())), OPT),
    ("sps_Config", SPS_Config, OPT),
    ("physicalConfigDedicated", PhysicalConfigDedicated, OPT),
    ext=True,
)

# --------------------------------------------------------------------------
# Common (SIB2) IEs
# --------------------------------------------------------------------------

RACH_ConfigCommon = Seq(
    ("preambleInfo", Seq(
        ("numberOfRA_Preambles", Enum(*[f"n{i}" for i in range(4, 68, 4)])),
        ("preamblesGroupAConfig", Seq(
            ("sizeOfRA_PreamblesGroupA", Enum(*[f"n{i}" for i in range(4, 64, 4)])),
            ("messageSizeGroupA", Enum("b56", "b144", "b208", "b256")),
            ("messagePowerOffsetGroupB", Enum(
                "minusinfinity", "dB0", "dB5", "dB8", "dB10", "dB12", "dB15",
                "dB18")),
            ext=True,
        ), OPT),
    )),
    ("powerRampingParameters", Seq(
        ("powerRampingStep", Enum("dB0", "dB2", "dB4", "dB6")),
        ("preambleInitialReceivedTargetPower", Enum(
            *[f"dBm-{p}" for p in range(120, 88, -2)])),
    )),
    ("ra_SupervisionInfo", Seq(
        ("preambleTransMax", Enum("n3", "n4", "n5", "n6", "n7", "n8", "n10",
                                  "n20", "n50", "n100", "n200")),
        ("ra_ResponseWindowSize", Enum("sf2", "sf3", "sf4", "sf5", "sf6",
                                       "sf7", "sf8", "sf10")),
        ("mac_ContentionResolutionTimer", Enum(
            "sf8", "sf16", "sf24", "sf32", "sf40", "sf48", "sf56", "sf64")),
    )),
    ("maxHARQ_Msg3Tx", Int(1, 8)),
    ext=True,
)

BCCH_Config = Seq(("modificationPeriodCoeff", Enum("n2", "n4", "n8", "n16")))
PCCH_Config = Seq(
    ("defaultPagingCycle", Enum("rf32", "rf64", "rf128", "rf256")),
    ("nB", Enum("fourT", "twoT", "oneT", "halfT", "quarterT", "oneEighthT",
                "oneSixteenthT", "oneThirtySecondT")),
)
PRACH_ConfigInfo = Seq(
    ("prach_ConfigIndex", Int(0, 63)),
    ("highSpeedFlag", Bool()),
    ("zeroCorrelationZoneConfig", Int(0, 15)),
    ("prach_FreqOffset", Int(0, 94)),
)
PRACH_ConfigSIB = Seq(
    ("rootSequenceIndex", Int(0, 837)),
    ("prach_ConfigInfo", PRACH_ConfigInfo),
)
PDSCH_ConfigCommon = Seq(
    ("referenceSignalPower", Int(-60, 50)),
    ("p_b", Int(0, 3)),
)
UL_ReferenceSignalsPUSCH = Seq(
    ("groupHoppingEnabled", Bool()),
    ("groupAssignmentPUSCH", Int(0, 29)),
    ("sequenceHoppingEnabled", Bool()),
    ("cyclicShift", Int(0, 7)),
)
PUSCH_ConfigCommon = Seq(
    ("pusch_ConfigBasic", Seq(
        ("n_SB", Int(1, 4)),
        ("hoppingMode", Enum("interSubFrame", "intraAndInterSubFrame")),
        ("pusch_HoppingOffset", Int(0, 98)),
        ("enable64QAM", Bool()),
    )),
    ("ul_ReferenceSignalsPUSCH", UL_ReferenceSignalsPUSCH),
)
PUCCH_ConfigCommon = Seq(
    ("deltaPUCCH_Shift", Enum("ds1", "ds2", "ds3")),
    ("nRB_CQI", Int(0, 98)),
    ("nCS_AN", Int(0, 7)),
    ("n1PUCCH_AN", Int(0, 2047)),
)
SoundingRS_UL_ConfigCommon = Choice(
    ("release", Null()),
    ("setup", Seq(
        ("srs_BandwidthConfig", Enum("bw0", "bw1", "bw2", "bw3", "bw4",
                                     "bw5", "bw6", "bw7")),
        ("srs_SubframeConfig", Enum(*[f"sc{i}" for i in range(16)])),
        ("ackNackSRS_SimultaneousTransmission", Bool()),
        ("srs_MaxUpPts", Enum("true"), OPT),
    )),
)
DeltaFList_PUCCH = Seq(
    ("deltaF_PUCCH_Format1", Enum("deltaF-2", "deltaF0", "deltaF2")),
    ("deltaF_PUCCH_Format1b", Enum("deltaF1", "deltaF3", "deltaF5")),
    ("deltaF_PUCCH_Format2", Enum("deltaF-2", "deltaF0", "deltaF1", "deltaF2")),
    ("deltaF_PUCCH_Format2a", Enum("deltaF-2", "deltaF0", "deltaF2")),
    ("deltaF_PUCCH_Format2b", Enum("deltaF-2", "deltaF0", "deltaF2")),
)
UplinkPowerControlCommon = Seq(
    ("p0_NominalPUSCH", Int(-126, 24)),
    ("alpha", Enum("al0", "al04", "al05", "al06", "al07", "al08", "al09",
                   "al1")),
    ("p0_NominalPUCCH", Int(-127, -96)),
    ("deltaFList_PUCCH", DeltaFList_PUCCH),
    ("deltaPreambleMsg3", Int(-1, 6)),
)

RadioResourceConfigCommonSIB = Seq(
    ("rach_ConfigCommon", RACH_ConfigCommon),
    ("bcch_Config", BCCH_Config),
    ("pcch_Config", PCCH_Config),
    ("prach_Config", PRACH_ConfigSIB),
    ("pdsch_ConfigCommon", PDSCH_ConfigCommon),
    ("pusch_ConfigCommon", PUSCH_ConfigCommon),
    ("pucch_ConfigCommon", PUCCH_ConfigCommon),
    ("soundingRS_UL_ConfigCommon", SoundingRS_UL_ConfigCommon),
    ("uplinkPowerControlCommon", UplinkPowerControlCommon),
    ("ul_CyclicPrefixLength", Enum("len1", "len2")),
    ext=True,
)

UE_TimersAndConstants = Seq(
    ("t300", Enum("ms100", "ms200", "ms300", "ms400", "ms600", "ms1000",
                  "ms1500", "ms2000")),
    ("t301", Enum("ms100", "ms200", "ms300", "ms400", "ms600", "ms1000",
                  "ms1500", "ms2000")),
    ("t310", Enum("ms0", "ms50", "ms100", "ms200", "ms500", "ms1000",
                  "ms2000")),
    ("n310", Enum("n1", "n2", "n3", "n4", "n6", "n8", "n10", "n20")),
    ("t311", Enum("ms1000", "ms3000", "ms5000", "ms10000", "ms15000",
                  "ms20000", "ms30000")),
    ("n311", Enum("n1", "n2", "n3", "n4", "n5", "n6", "n8", "n10")),
    ext=True,
)

AC_BarringConfig = Seq(
    ("ac_BarringFactor", Enum(
        "p00", "p05", "p10", "p15", "p20", "p25", "p30", "p40", "p50", "p60",
        "p70", "p75", "p80", "p85", "p90", "p95")),
    ("ac_BarringTime", Enum("s4", "s8", "s16", "s32", "s64", "s128", "s256",
                            "s512")),
    ("ac_BarringForSpecialAC", BitStr(5)),
)

MBSFN_SubframeConfig = Seq(
    ("radioframeAllocationPeriod", Enum("n1", "n2", "n4", "n8", "n16", "n32")),
    ("radioframeAllocationOffset", Int(0, 7)),
    ("subframeAllocation", Choice(
        ("oneFrame", BitStr(6)), ("fourFrames", BitStr(24)))),
)

SystemInformationBlockType2 = Seq(
    ("ac_BarringInfo", Seq(
        ("ac_BarringForEmergency", Bool()),
        ("ac_BarringForMO_Signalling", AC_BarringConfig, OPT),
        ("ac_BarringForMO_Data", AC_BarringConfig, OPT),
    ), OPT),
    ("radioResourceConfigCommon", RadioResourceConfigCommonSIB),
    ("ue_TimersAndConstants", UE_TimersAndConstants),
    ("freqInfo", Seq(
        ("ul_CarrierFreq", ARFCN_ValueEUTRA, OPT),
        ("ul_Bandwidth", Enum("n6", "n15", "n25", "n50", "n75", "n100"), OPT),
        ("additionalSpectrumEmission", Int(1, 32)),
    )),
    ("mbsfn_SubframeConfigList", SeqOf(MBSFN_SubframeConfig, 1, 8), OPT),
    ("timeAlignmentTimerCommon", TimeAlignmentTimer),
    ext=True,
)

# --------------------------------------------------------------------------
# SIB1 / SystemInformation / Paging
# --------------------------------------------------------------------------

PLMN_IdentityInfo = Seq(
    ("plmn_Identity", PLMN_Identity),
    ("cellReservedForOperatorUse", Enum("reserved", "notReserved")),
)
SchedulingInfo = Seq(
    ("si_Periodicity", Enum("rf8", "rf16", "rf32", "rf64", "rf128", "rf256",
                            "rf512")),
    ("sib_MappingInfo", SeqOf(Enum(
        "sibType3", "sibType4", "sibType5", "sibType6", "sibType7",
        "sibType8", "sibType9", "sibType10", "sibType11",
        *[f"spare{i}" for i in range(7, 0, -1)], ext=True), 0, 31)),
)
TDD_Config = Seq(
    ("subframeAssignment", Enum(*[f"sa{i}" for i in range(7)])),
    ("specialSubframePatterns", Enum(*[f"ssp{i}" for i in range(9)])),
)

SystemInformationBlockType1 = Seq(
    ("cellAccessRelatedInfo", Seq(
        ("plmn_IdentityList", SeqOf(PLMN_IdentityInfo, 1, 6)),
        ("trackingAreaCode", BitStr(16)),
        ("cellIdentity", BitStr(28)),
        ("cellBarred", Enum("barred", "notBarred")),
        ("intraFreqReselection", Enum("allowed", "notAllowed")),
        ("csg_Indication", Bool()),
        ("csg_Identity", BitStr(27), OPT),
    )),
    ("cellSelectionInfo", Seq(
        ("q_RxLevMin", Int(-70, -22)),
        ("q_RxLevMinOffset", Int(1, 8), OPT),
    )),
    ("p_Max", Int(-30, 33), OPT),
    ("freqBandIndicator", Int(1, 64)),
    ("schedulingInfoList", SeqOf(SchedulingInfo, 1, 32)),
    ("tdd_Config", TDD_Config, OPT),
    ("si_WindowLength", Enum("ms1", "ms2", "ms5", "ms10", "ms15", "ms20",
                             "ms40")),
    ("systemInfoValueTag", Int(0, 31)),
    ("nonCriticalExtension", Seq(), OPT),
)

SystemInformation_r8_IEs = Seq(
    ("sib_TypeAndInfo", SeqOf(Choice(
        ("sib2", SystemInformationBlockType2),
        ("sib3", Unsupported("SIB3")),
        ("sib4", Unsupported("SIB4")),
        ("sib5", Unsupported("SIB5")),
        ("sib6", Unsupported("SIB6")),
        ("sib7", Unsupported("SIB7")),
        ("sib8", Unsupported("SIB8")),
        ("sib9", Unsupported("SIB9")),
        ("sib10", Unsupported("SIB10")),
        ("sib11", Unsupported("SIB11")),
        ext=True,
    ), 1, 32)),
    ("nonCriticalExtension", Seq(), OPT),
)
SystemInformation = Seq(
    ("criticalExtensions", crit_ext_plain(
        "systemInformation-r8", SystemInformation_r8_IEs)),
)

BCCH_DL_SCH_Message = Seq(("message", Choice(
    ("c1", Choice(
        ("systemInformation", SystemInformation),
        ("systemInformationBlockType1", SystemInformationBlockType1),
    )),
    ("messageClassExtension", Seq()),
)))

# ------------------------------------------------------------------ PCCH
S_TMSI = Seq(("mmec", BitStr(8)), ("m_TMSI", BitStr(32)))
PagingUE_Identity = Choice(
    ("s_TMSI", S_TMSI),
    ("imsi", SeqOf(Int(0, 9), 6, 21)),
    ext=True,
)
PagingRecord = Seq(
    ("ue_Identity", PagingUE_Identity),
    ("cn_Domain", Enum("ps", "cs")),
    ext=True,
)
Paging = Seq(
    ("pagingRecordList", SeqOf(PagingRecord, 1, 16), OPT),
    ("systemInfoModification", Enum("true"), OPT),
    ("etws_Indication", Enum("true"), OPT),
    ("nonCriticalExtension", Seq(), OPT),
)
PCCH_Message = Seq(("message", Choice(
    ("c1", Choice(("paging", Paging))),
    ("messageClassExtension", Seq()),
)))

# --------------------------------------------------------------------------
# UL-CCCH
# --------------------------------------------------------------------------

InitialUE_Identity = Choice(
    ("s_TMSI", S_TMSI),
    ("randomValue", BitStr(40)),
)
EstablishmentCause = Enum(
    "emergency", "highPriorityAccess", "mt-Access", "mo-Signalling",
    "mo-Data", "spare3", "spare2", "spare1",
)
RRCConnectionRequest_r8_IEs = Seq(
    ("ue_Identity", InitialUE_Identity),
    ("establishmentCause", EstablishmentCause),
    ("spare", BitStr(1)),
)
RRCConnectionRequest = Seq(
    ("criticalExtensions", crit_ext_plain(
        "rrcConnectionRequest-r8", RRCConnectionRequest_r8_IEs)),
)

ReestabUE_Identity = Seq(
    ("c_RNTI", C_RNTI),
    ("physCellId", Int(0, 503)),
    ("shortMAC_I", BitStr(16)),
)
RRCConnectionReestablishmentRequest_r8_IEs = Seq(
    ("ue_Identity", ReestabUE_Identity),
    ("reestablishmentCause", Enum("reconfigurationFailure", "handoverFailure",
                                  "otherFailure", "spare1")),
    ("spare", BitStr(2)),
)
RRCConnectionReestablishmentRequest = Seq(
    ("criticalExtensions", crit_ext_plain(
        "rrcConnectionReestablishmentRequest-r8",
        RRCConnectionReestablishmentRequest_r8_IEs)),
)

UL_CCCH_Message = Seq(("message", Choice(
    ("c1", Choice(
        ("rrcConnectionReestablishmentRequest",
         RRCConnectionReestablishmentRequest),
        ("rrcConnectionRequest", RRCConnectionRequest),
    )),
    ("messageClassExtension", Seq()),
)))

# --------------------------------------------------------------------------
# DL-CCCH
# --------------------------------------------------------------------------

RRCConnectionSetup_r8_IEs = Seq(
    ("radioResourceConfigDedicated", RadioResourceConfigDedicated),
    ("nonCriticalExtension", Seq(), OPT),
)
RRCConnectionSetup = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        7, "rrcConnectionSetup-r8", RRCConnectionSetup_r8_IEs)),
)
RRCConnectionReject_r8_IEs = Seq(
    ("waitTime", Int(1, 16)),
    ("nonCriticalExtension", Seq(), OPT),
)
RRCConnectionReject = Seq(
    ("criticalExtensions", crit_ext_c1(
        3, "rrcConnectionReject-r8", RRCConnectionReject_r8_IEs)),
)
RRCConnectionReestablishment_r8_IEs = Seq(
    ("radioResourceConfigDedicated", RadioResourceConfigDedicated),
    ("nextHopChainingCount", NextHopChainingCount),
    ("nonCriticalExtension", Seq(), OPT),
)
RRCConnectionReestablishment = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        7, "rrcConnectionReestablishment-r8",
        RRCConnectionReestablishment_r8_IEs)),
)
RRCConnectionReestablishmentReject = Seq(
    ("criticalExtensions", crit_ext_plain(
        "rrcConnectionReestablishmentReject-r8",
        Seq(("nonCriticalExtension", Seq(), OPT)))),
)

DL_CCCH_Message = Seq(("message", Choice(
    ("c1", Choice(
        ("rrcConnectionReestablishment", RRCConnectionReestablishment),
        ("rrcConnectionReestablishmentReject",
         RRCConnectionReestablishmentReject),
        ("rrcConnectionReject", RRCConnectionReject),
        ("rrcConnectionSetup", RRCConnectionSetup),
    )),
    ("messageClassExtension", Seq()),
)))

# --------------------------------------------------------------------------
# DL-DCCH
# --------------------------------------------------------------------------

DedicatedInfoNAS = OctetStr()

SecurityAlgorithmConfig = Seq(
    ("cipheringAlgorithm", Enum(
        "eea0", "eea1", "eea2", "spare5", "spare4", "spare3", "spare2",
        "spare1", ext=True)),
    ("integrityProtAlgorithm", Enum(
        "reserved", "eia1", "eia2", "spare5", "spare4", "spare3", "spare2",
        "spare1", ext=True)),
)
SecurityConfigSMC = Seq(
    ("securityAlgorithmConfig", SecurityAlgorithmConfig),
    ext=True,
)
SecurityModeCommand = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        3, "securityModeCommand-r8",
        Seq(("securityConfigSMC", SecurityConfigSMC),
            ("nonCriticalExtension", Seq(), OPT)))),
)

UECapabilityEnquiry_r8_IEs = Seq(
    ("ue_CapabilityRequest", SeqOf(Enum(
        "eutra", "utra", "geran-cs", "geran-ps", "cdma2000-1XRTT",
        "spare3", "spare2", "spare1", ext=True), 1, 8)),
    ("nonCriticalExtension", Seq(), OPT),
)
UECapabilityEnquiry = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        3, "ueCapabilityEnquiry-r8", UECapabilityEnquiry_r8_IEs)),
)

# ---- intra-LTE handover IEs (36.331 §6.3.4; capability-plus — the
# reference never decodes mobilityControlInfo) ----

PHICH_Config = Seq(
    ("phich_Duration", Enum("normal", "extended")),
    ("phich_Resource", Enum("oneSixth", "half", "one", "two")),
)
AntennaInfoCommon = Seq(
    ("antennaPortsCount", Enum("an1", "an2", "an4", "spare1")),
)
PRACH_Config = Seq(
    ("rootSequenceIndex", Int(0, 837)),
    ("prach_ConfigInfo", PRACH_ConfigInfo, OPT),
)
# the handover variant of the common config: most fields optional
# (delta signalling against the target's SIB2), no bcch/pcch
RadioResourceConfigCommon = Seq(
    ("rach_ConfigCommon", RACH_ConfigCommon, OPT),
    ("prach_Config", PRACH_Config),
    ("pdsch_ConfigCommon", PDSCH_ConfigCommon, OPT),
    ("pusch_ConfigCommon", PUSCH_ConfigCommon),
    ("phich_Config", PHICH_Config, OPT),
    ("pucch_ConfigCommon", PUCCH_ConfigCommon, OPT),
    ("soundingRS_UL_ConfigCommon", SoundingRS_UL_ConfigCommon, OPT),
    ("uplinkPowerControlCommon", UplinkPowerControlCommon, OPT),
    ("antennaInfoCommon", AntennaInfoCommon, OPT),
    ("p_Max", Int(-30, 33), OPT),
    ("tdd_Config", TDD_Config, OPT),
    ("ul_CyclicPrefixLength", Enum("len1", "len2")),
    ext=True,
)
CarrierFreqEUTRA = Seq(
    ("dl_CarrierFreq", ARFCN_ValueEUTRA),
    ("ul_CarrierFreq", ARFCN_ValueEUTRA, OPT),
)
_BW_ENUM = ("n6", "n15", "n25", "n50", "n75", "n100",
            *[f"spare{i}" for i in range(10, 0, -1)])
CarrierBandwidthEUTRA = Seq(
    ("dl_Bandwidth", Enum(*_BW_ENUM)),
    ("ul_Bandwidth", Enum(*_BW_ENUM), OPT),
)
RACH_ConfigDedicated = Seq(
    ("ra_PreambleIndex", Int(0, 63)),
    ("ra_PRACH_MaskIndex", Int(0, 15)),
)
MobilityControlInfo = Seq(
    ("targetPhysCellId", Int(0, 503)),
    ("carrierFreq", CarrierFreqEUTRA, OPT),
    ("carrierBandwidth", CarrierBandwidthEUTRA, OPT),
    ("additionalSpectrumEmission", Int(1, 32), OPT),
    ("t304", Enum("ms50", "ms100", "ms150", "ms200", "ms500", "ms1000",
                  "ms2000", "spare1")),
    ("newUE_Identity", C_RNTI),
    ("radioResourceConfigCommon", RadioResourceConfigCommon),
    ("rach_ConfigDedicated", RACH_ConfigDedicated, OPT),
    ext=True,
)
SecurityConfigHO = Seq(
    ("handoverType", Choice(
        ("intraLTE", Seq(
            ("securityAlgorithmConfig", SecurityAlgorithmConfig, OPT),
            ("keyChangeIndicator", Bool()),
            ("nextHopChainingCount", NextHopChainingCount),
        )),
        ("interRAT", Unsupported("interRAT handover")),
    )),
    ext=True,
)

# --------------------------------------------------------------------------
# Measurements (36.331 §5.5 + §6.3.5) — capability-plus: the reference
# IGNORES measConfig entirely (rrc.cc handles no measurement IEs); here
# the full EUTRA intra-frequency set is implemented to close the
# A3 -> MeasurementReport -> handover loop. Inter-RAT alternatives stay
# `Unsupported` placeholders (absent from srsUE's surface too).
# --------------------------------------------------------------------------

PhysCellId = Int(0, 503)
RSRP_Range = Int(0, 97)   # 36.133 §9.1.4: value = floor(rsrp_dbm + 141)
RSRQ_Range = Int(0, 34)
Hysteresis = Int(0, 30)   # 0.5 dB steps
MeasObjectId = Int(1, 32)
ReportConfigId = Int(1, 32)
MeasId = Int(1, 32)
Q_OffsetRange = Enum(
    "dB_24", "dB_22", "dB_20", "dB_18", "dB_16", "dB_14", "dB_12", "dB_10",
    "dB_8", "dB_6", "dB_5", "dB_4", "dB_3", "dB_2", "dB_1", "dB0", "dB1",
    "dB2", "dB3", "dB4", "dB5", "dB6", "dB8", "dB10", "dB12", "dB14",
    "dB16", "dB18", "dB20", "dB22", "dB24",
)
TimeToTrigger = Enum(
    "ms0", "ms40", "ms64", "ms80", "ms100", "ms128", "ms160", "ms256",
    "ms320", "ms480", "ms512", "ms640", "ms1024", "ms1280", "ms2560",
    "ms5120",
)
ReportInterval = Enum(
    "ms120", "ms240", "ms480", "ms640", "ms1024", "ms2048", "ms5120",
    "ms10240", "min1", "min6", "min12", "min30", "min60", "spare3",
    "spare2", "spare1",
)
FilterCoefficient = Enum(
    "fc0", "fc1", "fc2", "fc3", "fc4", "fc5", "fc6", "fc7", "fc8", "fc9",
    "fc11", "fc13", "fc15", "fc17", "fc19", "spare1", ext=True,
)
CellIndexList = SeqOf(Int(1, 32), 1, 32)
CellsToAddMod = Seq(
    ("cellIndex", Int(1, 32)),
    ("physCellId", PhysCellId),
    ("cellIndividualOffset", Q_OffsetRange),
)
PhysCellIdRange = Seq(
    ("start", PhysCellId),
    ("range", Enum("n4", "n8", "n12", "n16", "n24", "n32", "n48", "n64",
                   "n84", "n96", "n128", "n168", "n252", "n504", "spare2",
                   "spare1"), OPT),
)
BlackCellsToAddMod = Seq(
    ("cellIndex", Int(1, 32)),
    ("physCellIdRange", PhysCellIdRange),
)
MeasObjectEUTRA = Seq(
    ("carrierFreq", ARFCN_ValueEUTRA),
    ("allowedMeasBandwidth", Enum("mbw6", "mbw15", "mbw25", "mbw50",
                                  "mbw75", "mbw100")),
    ("presenceAntennaPort1", Bool()),
    ("neighCellConfig", BitStr(2)),
    ("offsetFreq", Q_OffsetRange, OPT, "dB0"),
    ("cellsToRemoveList", CellIndexList, OPT),
    ("cellsToAddModList", SeqOf(CellsToAddMod, 1, 32), OPT),
    ("blackCellsToRemoveList", CellIndexList, OPT),
    ("blackCellsToAddModList", SeqOf(BlackCellsToAddMod, 1, 32), OPT),
    ("cellForWhichToReportCGI", PhysCellId, OPT),
    ext=True,
)
ThresholdEUTRA = Choice(
    ("threshold_RSRP", RSRP_Range),
    ("threshold_RSRQ", RSRQ_Range),
)
ReportConfigEUTRA = Seq(
    ("triggerType", Choice(
        ("event", Seq(
            ("eventId", Choice(
                ("eventA1", Seq(("a1_Threshold", ThresholdEUTRA))),
                ("eventA2", Seq(("a2_Threshold", ThresholdEUTRA))),
                ("eventA3", Seq(("a3_Offset", Int(-30, 30)),
                                ("reportOnLeave", Bool()))),
                ("eventA4", Seq(("a4_Threshold", ThresholdEUTRA))),
                ("eventA5", Seq(("a5_Threshold1", ThresholdEUTRA),
                                ("a5_Threshold2", ThresholdEUTRA))),
                ext=True,
            )),
            ("hysteresis", Hysteresis),
            ("timeToTrigger", TimeToTrigger),
        )),
        ("periodical", Seq(
            ("purpose", Enum("reportStrongestCells", "reportCGI")),
        )),
    )),
    ("triggerQuantity", Enum("rsrp", "rsrq")),
    ("reportQuantity", Enum("sameAsTriggerQuantity", "both")),
    ("maxReportCells", Int(1, 8)),
    ("reportInterval", ReportInterval),
    ("reportAmount", Enum("r1", "r2", "r4", "r8", "r16", "r32", "r64",
                          "infinity")),
    ext=True,
)
MeasObjectToAddMod = Seq(
    ("measObjectId", MeasObjectId),
    ("measObject", Choice(
        ("measObjectEUTRA", MeasObjectEUTRA),
        ("measObjectUTRA", Unsupported("measObjectUTRA")),
        ("measObjectGERAN", Unsupported("measObjectGERAN")),
        ("measObjectCDMA2000", Unsupported("measObjectCDMA2000")),
        ext=True,
    )),
)
ReportConfigToAddMod = Seq(
    ("reportConfigId", ReportConfigId),
    ("reportConfig", Choice(
        ("reportConfigEUTRA", ReportConfigEUTRA),
        ("reportConfigInterRAT", Unsupported("reportConfigInterRAT")),
    )),
)
MeasIdToAddMod = Seq(
    ("measId", MeasId),
    ("measObjectId", MeasObjectId),
    ("reportConfigId", ReportConfigId),
)
QuantityConfigEUTRA = Seq(
    ("filterCoefficientRSRP", FilterCoefficient, OPT, "fc4"),
    ("filterCoefficientRSRQ", FilterCoefficient, OPT, "fc4"),
)
QuantityConfig = Seq(
    ("quantityConfigEUTRA", QuantityConfigEUTRA, OPT),
    ("quantityConfigUTRA", Unsupported("quantityConfigUTRA"), OPT),
    ("quantityConfigGERAN", Unsupported("quantityConfigGERAN"), OPT),
    ("quantityConfigCDMA2000", Unsupported("quantityConfigCDMA2000"), OPT),
    ext=True,
)
MeasGapConfig = Choice(
    ("release", Null()),
    ("setup", Seq(("gapOffset", Choice(
        ("gp0", Int(0, 39)), ("gp1", Int(0, 79)), ext=True,
    )))),
)
MeasConfig = Seq(
    ("measObjectToRemoveList", SeqOf(MeasObjectId, 1, 32), OPT),
    ("measObjectToAddModList", SeqOf(MeasObjectToAddMod, 1, 32), OPT),
    ("reportConfigToRemoveList", SeqOf(ReportConfigId, 1, 32), OPT),
    ("reportConfigToAddModList", SeqOf(ReportConfigToAddMod, 1, 32), OPT),
    ("measIdToRemoveList", SeqOf(MeasId, 1, 32), OPT),
    ("measIdToAddModList", SeqOf(MeasIdToAddMod, 1, 32), OPT),
    ("quantityConfig", QuantityConfig, OPT),
    ("measGapConfig", MeasGapConfig, OPT),
    ("s_Measure", RSRP_Range, OPT),
    ("preRegistrationInfoHRPD", Unsupported("preRegistrationInfoHRPD"),
     OPT),
    ("speedStatePars", Unsupported("speedStatePars"), OPT),
    ext=True,
)

RRCConnectionReconfiguration_r8_IEs = Seq(
    ("measConfig", MeasConfig, OPT),
    ("mobilityControlInfo", MobilityControlInfo, OPT),
    ("dedicatedInfoNASList", SeqOf(DedicatedInfoNAS, 1, 11), OPT),
    ("radioResourceConfigDedicated", RadioResourceConfigDedicated, OPT),
    ("securityConfigHO", SecurityConfigHO, OPT),
    ("nonCriticalExtension", Seq(), OPT),
)
RRCConnectionReconfiguration = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        7, "rrcConnectionReconfiguration-r8",
        RRCConnectionReconfiguration_r8_IEs)),
)

RedirectedCarrierInfo = Choice(
    ("eutra", ARFCN_ValueEUTRA),
    ("geran", Unsupported("geran redirect")),
    ("utra_FDD", Int(0, 16383)),
    ("utra_TDD", Int(0, 16383)),
    ("cdma2000_HRPD", Unsupported("cdma2000 redirect")),
    ("cdma2000_1xRTT", Unsupported("cdma2000 redirect")),
    ext=True,
)
RRCConnectionRelease_r8_IEs = Seq(
    ("releaseCause", Enum("loadBalancingTAUrequired", "other", "spare2",
                          "spare1")),
    ("redirectedCarrierInfo", RedirectedCarrierInfo, OPT),
    ("idleModeMobilityControlInfo", Unsupported("idleModeMobilityControlInfo"),
     OPT),
    ("nonCriticalExtension", Seq(), OPT),
)
RRCConnectionRelease = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        3, "rrcConnectionRelease-r8", RRCConnectionRelease_r8_IEs)),
)

DLInformationTransfer_r8_IEs = Seq(
    ("dedicatedInfoType", Choice(
        ("dedicatedInfoNAS", DedicatedInfoNAS),
        ("dedicatedInfoCDMA2000-1XRTT", OctetStr()),
        ("dedicatedInfoCDMA2000-HRPD", OctetStr()),
    )),
    ("nonCriticalExtension", Seq(), OPT),
)
DLInformationTransfer = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        3, "dlInformationTransfer-r8", DLInformationTransfer_r8_IEs)),
)

DL_DCCH_Message = Seq(("message", Choice(
    ("c1", Choice(
        ("csfbParametersResponseCDMA2000",
         Unsupported("csfbParametersResponseCDMA2000")),
        ("dlInformationTransfer", DLInformationTransfer),
        ("handoverFromEUTRAPreparationRequest",
         Unsupported("handoverFromEUTRAPreparationRequest")),
        ("mobilityFromEUTRACommand", Unsupported("mobilityFromEUTRACommand")),
        ("rrcConnectionReconfiguration", RRCConnectionReconfiguration),
        ("rrcConnectionRelease", RRCConnectionRelease),
        ("securityModeCommand", SecurityModeCommand),
        ("counterCheck", Unsupported("counterCheck")),
        ("ueCapabilityEnquiry", UECapabilityEnquiry),
        *[(f"spare{i}", Null()) for i in range(7, 0, -1)],
    )),
    ("messageClassExtension", Seq()),
)))

# --------------------------------------------------------------------------
# UL-DCCH
# --------------------------------------------------------------------------

RegisteredMME = Seq(
    ("plmn_Identity", PLMN_Identity, OPT),
    ("mmegi", BitStr(16)),
    ("mmec", BitStr(8)),
)
RRCConnectionSetupComplete_r8_IEs = Seq(
    ("selectedPLMN_Identity", Int(1, 6)),
    ("registeredMME", RegisteredMME, OPT),
    ("dedicatedInfoNAS", DedicatedInfoNAS),
    ("nonCriticalExtension", Seq(), OPT),
)
RRCConnectionSetupComplete = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        3, "rrcConnectionSetupComplete-r8",
        RRCConnectionSetupComplete_r8_IEs)),
)

SecurityModeComplete = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_plain(
        "securityModeComplete-r8", Seq(("nonCriticalExtension", Seq(), OPT)))),
)
SecurityModeFailure = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_plain(
        "securityModeFailure-r8", Seq(("nonCriticalExtension", Seq(), OPT)))),
)

# --- UE-EUTRA-Capability (the ueCapabilityRAT-Container payload) ----------
SupportedBandEUTRA = Seq(("bandEUTRA", Int(1, 64)), ("halfDuplex", Bool()))
BandInfoEUTRA = Seq(
    ("interFreqBandList", SeqOf(Seq(("interFreqNeedForGaps", Bool())), 1, 64)),
    ("interRAT_BandList", SeqOf(Seq(("interRAT_NeedForGaps", Bool())), 1, 64),
     OPT),
)
PDCP_Parameters = Seq(
    ("supportedROHC_Profiles", Seq(*[
        (f"profile0x{p}", Bool())
        for p in ("0001", "0002", "0003", "0004", "0006",
                  "0101", "0102", "0103", "0104")
    ])),
    ("maxNumberROHC_ContextSessions", Enum(
        "cs2", "cs4", "cs8", "cs12", "cs16", "cs24", "cs32", "cs48", "cs64",
        "cs128", "cs256", "cs512", "cs1024", "cs16384", "spare2", "spare1"),
     OPT, "cs16"),
    ext=True,
)
UE_EUTRA_Capability = Seq(
    ("accessStratumRelease", Enum(
        "rel8", "spare7", "spare6", "spare5", "spare4", "spare3", "spare2",
        "spare1", ext=True)),
    ("ue_Category", Int(1, 5)),
    ("pdcp_Parameters", PDCP_Parameters),
    ("phyLayerParameters", Seq(
        ("ue_TxAntennaSelectionSupported", Bool()),
        ("ue_SpecificRefSigsSupported", Bool()),
    )),
    ("rf_Parameters", Seq(
        ("supportedBandListEUTRA", SeqOf(SupportedBandEUTRA, 1, 64)),
    )),
    ("measParameters", Seq(
        ("bandListEUTRA", SeqOf(BandInfoEUTRA, 1, 64)),
    )),
    ("featureGroupIndicators", BitStr(32), OPT),
    ("interRAT_Parameters", Seq(
        ("utraFDD", Unsupported("utraFDD caps"), OPT),
        ("utraTDD128", Unsupported("utraTDD caps"), OPT),
        ("utraTDD384", Unsupported("utraTDD caps"), OPT),
        ("utraTDD768", Unsupported("utraTDD caps"), OPT),
        ("geran", Unsupported("geran caps"), OPT),
        ("cdma2000_HRPD", Unsupported("cdma2000 caps"), OPT),
        ("cdma2000_1xRTT", Unsupported("cdma2000 caps"), OPT),
    )),
    ("nonCriticalExtension", Seq(), OPT),
)

UE_CapabilityRAT_Container = Seq(
    ("rat_Type", Enum("eutra", "utra", "geran-cs", "geran-ps",
                      "cdma2000-1XRTT", "spare3", "spare2", "spare1",
                      ext=True)),
    ("ueCapabilityRAT_Container", OctetStr()),
)
UECapabilityInformation_r8_IEs = Seq(
    ("ue_CapabilityRAT_ContainerList", SeqOf(UE_CapabilityRAT_Container, 0, 8)),
    ("nonCriticalExtension", Seq(), OPT),
)
UECapabilityInformation = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_c1(
        7, "ueCapabilityInformation-r8", UECapabilityInformation_r8_IEs)),
)

RRCConnectionReconfigurationComplete = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_plain(
        "rrcConnectionReconfigurationComplete-r8",
        Seq(("nonCriticalExtension", Seq(), OPT)))),
)
RRCConnectionReestablishmentComplete = Seq(
    ("rrc_TransactionIdentifier", RRC_TransactionIdentifier),
    ("criticalExtensions", crit_ext_plain(
        "rrcConnectionReestablishmentComplete-r8",
        Seq(("nonCriticalExtension", Seq(), OPT)))),
)

ULInformationTransfer_r8_IEs = Seq(
    ("dedicatedInfoType", Choice(
        ("dedicatedInfoNAS", DedicatedInfoNAS),
        ("dedicatedInfoCDMA2000-1XRTT", OctetStr()),
        ("dedicatedInfoCDMA2000-HRPD", OctetStr()),
    )),
    ("nonCriticalExtension", Seq(), OPT),
)
ULInformationTransfer = Seq(
    ("criticalExtensions", crit_ext_c1(
        3, "ulInformationTransfer-r8", ULInformationTransfer_r8_IEs)),
)

# --- MeasurementReport (36.331 §6.2.2; capability-plus, see MeasConfig)
MeasResultEUTRA = Seq(
    ("physCellId", PhysCellId),
    ("cgi_Info", Unsupported("cgi-Info"), OPT),
    ("measResult", Seq(
        ("rsrpResult", RSRP_Range, OPT),
        ("rsrqResult", RSRQ_Range, OPT),
        ext=True,
    )),
)
MeasResults = Seq(
    ("measId", MeasId),
    ("measResultServCell", Seq(
        ("rsrpResult", RSRP_Range),
        ("rsrqResult", RSRQ_Range),
    )),
    ("measResultNeighCells", Choice(
        ("measResultListEUTRA", SeqOf(MeasResultEUTRA, 1, 8)),
        ("measResultListUTRA", Unsupported("measResultListUTRA")),
        ("measResultListGERAN", Unsupported("measResultListGERAN")),
        ("measResultsCDMA2000", Unsupported("measResultsCDMA2000")),
        ext=True,
    ), OPT),
    ext=True,
)
MeasurementReport = Seq(
    ("criticalExtensions", crit_ext_c1(
        7, "measurementReport-r8",
        Seq(("measResults", MeasResults),
            ("nonCriticalExtension", Seq(), OPT)))),
)

UL_DCCH_Message = Seq(("message", Choice(
    ("c1", Choice(
        ("csfbParametersRequestCDMA2000",
         Unsupported("csfbParametersRequestCDMA2000")),
        ("measurementReport", MeasurementReport),
        ("rrcConnectionReconfigurationComplete",
         RRCConnectionReconfigurationComplete),
        ("rrcConnectionReestablishmentComplete",
         RRCConnectionReestablishmentComplete),
        ("rrcConnectionSetupComplete", RRCConnectionSetupComplete),
        ("securityModeComplete", SecurityModeComplete),
        ("securityModeFailure", SecurityModeFailure),
        ("ueCapabilityInformation", UECapabilityInformation),
        ("ulHandoverPreparationTransfer",
         Unsupported("ulHandoverPreparationTransfer")),
        ("ulInformationTransfer", ULInformationTransfer),
        ("counterCheckResponse", Unsupported("counterCheckResponse")),
        *[(f"spare{i}", Null()) for i in range(5, 0, -1)],
    )),
    ("messageClassExtension", Seq()),
)))

# --------------------------------------------------------------------------
# UE variables (36.331 §7.4) — UPER-encoded KDF inputs
# --------------------------------------------------------------------------

# VarShortMAC-Input: the shortMAC-I derivation input for connection
# re-establishment (36.331 §5.3.7.4): cellIdentity of the current cell,
# physCellId of the PCell the trigger occurred in, and the C-RNTI held
# in that cell. Encoded with UPER and MAC'd with the *old* K_RRCint
# (COUNT/BEARER/DIRECTION all binary ones).
VarShortMAC_Input = Seq(
    ("cellIdentity", BitStr(28)),
    ("physCellId", Int(0, 503)),
    ("c_RNTI", C_RNTI),
)
