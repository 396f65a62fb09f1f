"""The port's own copy of ``srsue_tpu/utils/pcap.py`` (its reference), unchanged below this docstring.

MAC-LTE pcap writer — Wireshark-compatible captures (reference:
ue/src/mac/mac_pcap.cc + ue/hdr/mac/pcap.h:35-110: DLT 147 with the
mac-lte framing: radioType/direction/rntiType + tags + payload).
"""

from __future__ import annotations

import struct
import time

DLT_MAC_LTE = 147

# mac-lte framing constants (packet-mac-lte dissector contract)
MAC_LTE_START = b"mac-lte"
FDD_RADIO = 1
DIRECTION_UPLINK = 0
DIRECTION_DOWNLINK = 1
NO_RNTI = 0
P_RNTI_T = 1
RA_RNTI_T = 2
C_RNTI_T = 3
SI_RNTI_T = 4
RNTI_TAG = 0x02
UEID_TAG = 0x03
SUBFRAME_TAG = 0x04
CRC_STATUS_TAG = 0x07
PAYLOAD_TAG = 0x01


class MacPcap:
    def __init__(self, path: str, ue_id: int = 1):
        self.f = open(path, "wb")
        self.ue_id = ue_id
        # pcap global header
        self.f.write(
            struct.pack(
                "<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, DLT_MAC_LTE
            )
        )

    def _write_pdu(self, context: bytes, pdu: bytes) -> None:
        ts = time.time()
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        data = context + bytes([PAYLOAD_TAG]) + pdu
        self.f.write(struct.pack("<IIII", sec, usec, len(data), len(data)))
        self.f.write(data)
        self.f.flush()

    def _context(self, direction: int, rnti_type: int, rnti: int | None,
                 tti: int | None, crc_ok: bool = True) -> bytes:
        out = bytearray([FDD_RADIO, direction, rnti_type])
        if rnti is not None:
            out += bytes([RNTI_TAG]) + struct.pack(">H", rnti)
        out += bytes([UEID_TAG]) + struct.pack(">H", self.ue_id)
        if tti is not None:
            out += bytes([SUBFRAME_TAG]) + struct.pack(">H", tti % 10)
        out += bytes([CRC_STATUS_TAG, 1 if crc_ok else 0])
        return bytes(out)

    # API mirroring mac_pcap.h:41-48
    def write_ul_crnti(self, pdu: bytes, rnti: int, tti: int) -> None:
        self._write_pdu(self._context(DIRECTION_UPLINK, C_RNTI_T, rnti, tti), pdu)

    def write_dl_crnti(self, pdu: bytes, rnti: int, tti: int, crc_ok: bool = True) -> None:
        self._write_pdu(self._context(DIRECTION_DOWNLINK, C_RNTI_T, rnti, tti, crc_ok), pdu)

    def write_dl_ranti(self, pdu: bytes, rnti: int, tti: int) -> None:
        self._write_pdu(self._context(DIRECTION_DOWNLINK, RA_RNTI_T, rnti, tti), pdu)

    def write_dl_sirnti(self, pdu: bytes, tti: int) -> None:
        self._write_pdu(self._context(DIRECTION_DOWNLINK, SI_RNTI_T, 0xFFFF, tti), pdu)

    def write_dl_bch(self, pdu: bytes, tti: int) -> None:
        self._write_pdu(self._context(DIRECTION_DOWNLINK, NO_RNTI, None, tti), pdu)

    def close(self) -> None:
        self.f.close()
