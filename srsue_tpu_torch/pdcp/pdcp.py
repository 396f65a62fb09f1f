"""The port's own copy of ``srsue_tpu/pdcp/pdcp.py`` (its reference), unchanged below this docstring.

PDCP — 36.323 (reference: ue/src/upper/pdcp_entity.cc).

* SRBs: control PDUs with 5-bit SN + 32-bit EIA2 MAC-I
  (pdcp_entity.cc:185-201); routing SRB->RRC.
* DRBs: data PDUs with 7- or 12-bit SN (pdcp_entity.cc:106-115);
  routing DRB->GW (pdcp_entity.cc:129-163).
* Security: keys configured by RRC (pdcp_entity.cc:118-126); ciphering
  EEA0/EEA2, integrity EIA2 (the reference runs EEA0 + EIA2,
  rrc.cc:493-496).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..usim import security as sec


@dataclass
class PdcpConfig:
    is_control: bool = False  # SRB (5-bit SN + MAC-I) vs DRB
    sn_bits: int = 12  # DRB: 7 or 12
    is_data_bearer: bool = True
    eea: int = 0  # ciphering algorithm id
    eia: int = 2  # integrity algorithm id
    bearer_id: int = 0
    # COUNT direction bits (36.323): UE sends UL(0), receives DL(1).
    # A peer entity (eNB side in loopback tests) swaps them.
    tx_direction: int = 0
    rx_direction: int = 1


class PdcpEntity:
    def __init__(self, lcid: int, cfg: PdcpConfig, rlc_write, up_write):
        self.lcid = lcid
        self.cfg = cfg
        self.rlc_write = rlc_write
        self.up_write = up_write
        self.tx_count = 0
        self.rx_count = 0
        self.k_enc: bytes | None = None
        self.k_int: bytes | None = None
        self.integrity_active = False
        self.ciphering_active = False
        self.peer_fms: int | None = None  # last received status report

    def config_security(self, k_enc: bytes, k_int: bytes) -> None:
        self.k_enc = k_enc
        self.k_int = k_int

    def reestablish(self) -> None:
        """PDCP re-establishment (36.323 §5.2): SRBs reset TX/RX COUNT
        and discard stored SDUs; AM DRBs keep COUNT (continuity is what
        the status report covers); UM DRBs reset."""
        if self.cfg.is_control or self.cfg.sn_bits == 7:
            self.tx_count = 0
            self.rx_count = 0

    # --- control PDUs (36.323 §6.2.6: PDCP status report) -------------------
    def make_status_pdu(self) -> bytes:
        """D/C=0 control PDU, type=0 (status), FMS = first missing SN
        (12-bit SN DRBs)."""
        fms = self.rx_count & 0xFFF
        return bytes([(fms >> 8) & 0x0F, fms & 0xFF])

    def handle_status_pdu(self, pdu: bytes) -> None:
        fms = ((pdu[0] & 0x0F) << 8) | pdu[1]
        self.peer_fms = fms

    def send_status(self) -> None:
        """Send a status report (no SN, not ciphered — control PDU)."""
        self.rlc_write(self.make_status_pdu())

    def enable_integrity(self) -> None:
        self.integrity_active = True

    def enable_ciphering(self) -> None:
        self.ciphering_active = True

    # --- TX (upper -> RLC) -------------------------------------------------
    def write_sdu(self, sdu: bytes) -> None:
        if self.cfg.is_control:
            sn = self.tx_count & 0x1F
            hdr = bytes([sn])
            if self.integrity_active:
                mac = sec.eia2(
                    self.k_int, self.tx_count, self.cfg.bearer_id,
                    self.cfg.tx_direction, hdr + sdu
                )
            else:
                mac = b"\x00" * 4
            body = self._cipher(sdu, self.tx_count, self.cfg.tx_direction)
            pdu = hdr + body + mac
        else:
            if self.cfg.sn_bits == 12:
                sn = self.tx_count & 0xFFF
                hdr = bytes([0x80 | (sn >> 8), sn & 0xFF])
            else:
                sn = self.tx_count & 0x7F
                hdr = bytes([0x80 | sn])
            pdu = hdr + self._cipher(sdu, self.tx_count, self.cfg.tx_direction)
        self.tx_count += 1
        self.rlc_write(pdu)

    # --- RX (RLC -> upper) -------------------------------------------------
    def write_pdu(self, pdu: bytes) -> None:
        if self.cfg.is_control:
            sn = pdu[0] & 0x1F
            body = pdu[1:-4]
            mac = pdu[-4:]
            count = self._infer_count(sn, 5)
            sdu = self._cipher(body, count, self.cfg.rx_direction)
            if self.integrity_active:
                want = sec.eia2(
                    self.k_int, count, self.cfg.bearer_id,
                    self.cfg.rx_direction, bytes([pdu[0]]) + sdu
                )
                if want != mac:
                    return  # integrity failure: discard
            self.rx_count = count + 1
            self.up_write(self.lcid, sdu)
        else:
            if not pdu[0] & 0x80:  # D/C = 0: control PDU (status report)
                self.handle_status_pdu(pdu)
                return
            if self.cfg.sn_bits == 12:
                sn = ((pdu[0] & 0xF) << 8) | pdu[1]
                body = pdu[2:]
                count = self._infer_count(sn, 12)
            else:
                sn = pdu[0] & 0x7F
                body = pdu[1:]
                count = self._infer_count(sn, 7)
            self.rx_count = count + 1
            self.up_write(self.lcid, self._cipher(body, count, self.cfg.rx_direction))

    def _infer_count(self, sn: int, bits: int) -> int:
        mod = 1 << bits
        hfn = self.rx_count >> bits
        cand = (hfn << bits) | sn
        if cand < self.rx_count - mod // 2:
            cand += mod
        return cand

    def _cipher(self, data: bytes, count: int, direction: int) -> bytes:
        if not self.ciphering_active or self.cfg.eea == 0 or self.k_enc is None:
            return data
        return sec.EEA[self.cfg.eea](
            self.k_enc, count, self.cfg.bearer_id, direction, data
        )


class Pdcp:
    """Container: pdcp_interface_gw/_rrc/_rlc surfaces."""

    def __init__(self, rlc=None, rrc=None, gw=None):
        self.rlc = rlc
        self.rrc = rrc
        self.gw = gw
        self.entities: dict[int, PdcpEntity] = {}

    def add_bearer(self, lcid: int, cfg: PdcpConfig | None = None) -> None:
        if lcid in self.entities:
            return
        cfg = cfg or PdcpConfig(is_control=lcid in (1, 2), bearer_id=lcid)

        def rlc_write(pdu: bytes, _l=lcid):
            self.rlc.write_sdu(_l, pdu)

        def up_write(l, sdu):
            if self.entities[l].cfg.is_control or l <= 2:
                if self.rrc is not None:
                    self.rrc.write_pdu(l, sdu)
            else:
                if self.gw is not None:
                    self.gw.write_pdu(l, sdu)

        self.entities[lcid] = PdcpEntity(lcid, cfg, rlc_write, up_write)

    def config_security(self, lcid: int, k_enc: bytes, k_int: bytes) -> None:
        self.entities[lcid].config_security(k_enc, k_int)

    def config_security_all(self, k_enc: bytes, k_int: bytes) -> None:
        for e in self.entities.values():
            e.config_security(k_enc, k_int)

    def enable_integrity(self, lcid: int) -> None:
        self.entities[lcid].enable_integrity()

    def reestablish_bearer(self, lcid: int) -> None:
        if lcid in self.entities:
            self.entities[lcid].reestablish()

    def enable_ciphering(self, lcid: int) -> None:
        self.entities[lcid].enable_ciphering()

    # gw/rrc side
    def write_sdu(self, lcid: int, sdu: bytes) -> None:
        if lcid == 0:  # SRB0: transparent, no PDCP header (CCCH)
            self.rlc.write_sdu(0, sdu)
            return
        self.entities[lcid].write_sdu(sdu)

    # rlc side
    def write_pdu(self, lcid: int, pdu: bytes) -> None:
        if lcid == 0:
            if self.rrc is not None:
                self.rrc.write_pdu(0, pdu)
            return
        if lcid in self.entities:
            self.entities[lcid].write_pdu(pdu)

    def write_pdu_bcch_bch(self, pdu: bytes) -> None:
        if self.rrc is not None:
            self.rrc.write_pdu_bcch_bch(pdu)

    def write_pdu_bcch_dlsch(self, pdu: bytes) -> None:
        if self.rrc is not None:
            self.rrc.write_pdu_bcch_dlsch(pdu)

    def write_pdu_pcch(self, pdu: bytes) -> None:
        if self.rrc is not None:
            self.rrc.write_pdu_pcch(pdu)
