"""The port's own copy of ``srsue_tpu/rrc/messages.py`` (its reference), unchanged below this docstring.

RRC message channel API — bit-exact 36.331 Rel-8 UPER on the wire.

The schemas live in rrc/asn1.py (over the UPER engine in rrc/uper.py);
this module provides the channel-level pack/unpack the stack uses,
hiding the c1 / criticalExtensions nesting boilerplate:

    pack("UL-CCCH", "rrcConnectionRequest", {...})            -> bytes
    unpack("DL-DCCH", data) -> (name, transaction_id, r8_body)

Replaces the reference's per-message liblte entry points
(liblte_rrc_pack_*_msg / liblte_rrc_unpack_*_msg, liblte/hdr/
liblte_rrc.h:6628-6785) for the message set srsUE touches
(ue/src/upper/rrc.cc:203-525).
"""

from __future__ import annotations

from . import asn1 as A
from . import uper

CHANNELS = {
    "UL-CCCH": A.UL_CCCH_Message,
    "DL-CCCH": A.DL_CCCH_Message,
    "UL-DCCH": A.UL_DCCH_Message,
    "DL-DCCH": A.DL_DCCH_Message,
    "BCCH-DL-SCH": A.BCCH_DL_SCH_Message,
    "PCCH": A.PCCH_Message,
}

# (channel, msgName) -> (has_transaction_id, r8_suffix_name | None)
# r8 name None => the message body IS the c1 alternative (SIB1, Paging).
_SHAPE = {
    ("UL-CCCH", "rrcConnectionRequest"): (False, "rrcConnectionRequest-r8"),
    ("UL-CCCH", "rrcConnectionReestablishmentRequest"):
        (False, "rrcConnectionReestablishmentRequest-r8"),
    ("DL-CCCH", "rrcConnectionSetup"): (True, "rrcConnectionSetup-r8"),
    ("DL-CCCH", "rrcConnectionReject"): (False, "rrcConnectionReject-r8"),
    ("DL-CCCH", "rrcConnectionReestablishment"):
        (True, "rrcConnectionReestablishment-r8"),
    ("DL-CCCH", "rrcConnectionReestablishmentReject"):
        (False, "rrcConnectionReestablishmentReject-r8"),
    ("UL-DCCH", "rrcConnectionSetupComplete"):
        (True, "rrcConnectionSetupComplete-r8"),
    ("UL-DCCH", "securityModeComplete"): (True, "securityModeComplete-r8"),
    ("UL-DCCH", "securityModeFailure"): (True, "securityModeFailure-r8"),
    ("UL-DCCH", "ueCapabilityInformation"):
        (True, "ueCapabilityInformation-r8"),
    ("UL-DCCH", "rrcConnectionReconfigurationComplete"):
        (True, "rrcConnectionReconfigurationComplete-r8"),
    ("UL-DCCH", "rrcConnectionReestablishmentComplete"):
        (True, "rrcConnectionReestablishmentComplete-r8"),
    ("UL-DCCH", "ulInformationTransfer"):
        (False, "ulInformationTransfer-r8"),
    ("UL-DCCH", "measurementReport"): (False, "measurementReport-r8"),
    ("DL-DCCH", "dlInformationTransfer"): (True, "dlInformationTransfer-r8"),
    ("DL-DCCH", "rrcConnectionReconfiguration"):
        (True, "rrcConnectionReconfiguration-r8"),
    ("DL-DCCH", "rrcConnectionRelease"): (True, "rrcConnectionRelease-r8"),
    ("DL-DCCH", "securityModeCommand"): (True, "securityModeCommand-r8"),
    ("DL-DCCH", "ueCapabilityEnquiry"): (True, "ueCapabilityEnquiry-r8"),
    ("BCCH-DL-SCH", "systemInformation"): (False, "systemInformation-r8"),
    ("BCCH-DL-SCH", "systemInformationBlockType1"): (False, None),
    ("PCCH", "paging"): (False, None),
}


def _wrap_crit(r8_name: str, body):
    """Wrap an -r8-IEs body back into its criticalExtensions CHOICE; the
    codec (crit_ext_plain vs crit_ext_c1) decides how many spare bits the
    selector takes — the value shape is the same either way."""
    return (r8_name, body)


def pack(channel: str, name: str, body: dict, tid: int = 0) -> bytes:
    has_tid, r8 = _SHAPE[(channel, name)]
    if r8 is None:
        msg_val = body
    else:
        crit = _wrap_crit(r8, body)
        # crit_ext_c1 shapes need the extra ("c1", ...) level; detect from
        # the schema: plain crit-ext choices have the r8 name as an alt.
        codec = _msg_codec(channel, name)
        crit_codec = _crit_codec(codec, has_tid)
        if _is_c1(crit_codec, r8):
            crit = ("c1", crit)
        msg_val = {"criticalExtensions": crit}
        if has_tid:
            msg_val["rrc_TransactionIdentifier"] = tid
    return uper.encode(
        CHANNELS[channel],
        {"message": ("c1", (name, msg_val))},
    )


def unpack(channel: str, data: bytes):
    """-> (name, transaction_id, r8_body). For SIB1/Paging the body is the
    message itself and transaction_id is 0."""
    top = uper.decode(CHANNELS[channel], data)
    kind, inner = top["message"]
    if kind != "c1":
        raise ValueError(f"{channel}: messageClassExtension not supported")
    name, msg_val = inner
    has_tid, r8 = _SHAPE.get((channel, name), (False, None))
    if r8 is None:
        return name, 0, msg_val
    tid = msg_val.get("rrc_TransactionIdentifier", 0) if has_tid else 0
    crit = msg_val["criticalExtensions"]
    if crit[0] == "c1":
        crit = crit[1]
    got_name, body = crit
    if got_name != r8:
        raise ValueError(f"{channel}/{name}: unsupported extension {got_name}")
    return name, tid, body


def _msg_codec(channel: str, name: str):
    c1 = dict(CHANNELS[channel].fields[0].codec.alts)["c1"]
    return dict(c1.alts)[name]


def _crit_codec(codec, has_tid: bool):
    return codec.fields[1 if has_tid else 0].codec


def _is_c1(crit_codec, r8: str) -> bool:
    return all(a[0] != r8 for a in crit_codec.alts)


# --------------------------------------------------------------------------
# Convenience constructors for the bodies the stack produces
# --------------------------------------------------------------------------


def plmn(mcc: int = 1, mnc: int = 1, mnc_digits: int = 2) -> dict:
    return {
        "mcc": [(mcc // 100) % 10, (mcc // 10) % 10, mcc % 10],
        "mnc": [(mnc // 100) % 10, (mnc // 10) % 10, mnc % 10][-mnc_digits:],
    }


def pack_sib1(body: dict) -> bytes:
    return pack("BCCH-DL-SCH", "systemInformationBlockType1", body)


def pack_si_sib2(sib2_body: dict) -> bytes:
    """SystemInformation carrying one SIB2 (the SI message srsUE's attach
    needs, rrc.cc:571-582)."""
    return pack("BCCH-DL-SCH", "systemInformation", {
        "sib_TypeAndInfo": [("sib2", sib2_body)],
    })


def ue_eutra_capability(ue_category: int = 5,
                        rohc: bool = False,
                        band: int = 7) -> bytes:
    """Encoded UE-EUTRA-Capability for the ueCapabilityRAT-Container
    (reference fills category/bands via liblte, rrc.cc:352-429)."""
    profiles = {f"profile0x{p}": rohc and p == "0001"
                for p in ("0001", "0002", "0003", "0004", "0006",
                          "0101", "0102", "0103", "0104")}
    val = {
        "accessStratumRelease": "rel8",
        "ue_Category": ue_category,
        "pdcp_Parameters": {"supportedROHC_Profiles": profiles},
        "phyLayerParameters": {
            "ue_TxAntennaSelectionSupported": False,
            "ue_SpecificRefSigsSupported": False,
        },
        "rf_Parameters": {
            "supportedBandListEUTRA": [
                {"bandEUTRA": band, "halfDuplex": False}],
        },
        "measParameters": {
            "bandListEUTRA": [
                {"interFreqBandList": [{"interFreqNeedForGaps": False}]}],
        },
        "interRAT_Parameters": {},
    }
    return uper.encode(A.UE_EUTRA_Capability, val)


def parse_ue_eutra_capability(data: bytes) -> dict:
    return uper.decode(A.UE_EUTRA_Capability, data)
