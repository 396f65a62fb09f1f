"""The port's own copy of ``srsue_tpu/mac/pdu.py`` (its reference), unchanged below this docstring.

MAC PDU pack/parse — 36.321 §6 (DL-SCH/UL-SCH PDUs, control elements,
RAR PDUs).

Capability parity with the reference's template codec ``ue/src/mac/pdu.cc``
(class tree pdu.h:44-335): SDU subheaders with 7/15-bit length fields,
C-RNTI / contention-resolution / timing-advance / BSR / PHR control
elements, padding rules, and the RAR PDU with its 20-bit UL grant.

Pure host-side byte manipulation (numpy uint8) — this is control-plane
code; the TB payloads it wraps come from the device decode as bit arrays
packed via np.packbits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# LCIDs (36.321 Table 6.2.1-1/2)
LCID_CCCH = 0
LCID_PAD = 31
# DL-SCH CEs
LCID_DRX = 30
LCID_TA = 29
LCID_CON_RES = 28
# UL-SCH CEs
LCID_PHR = 26
LCID_CRNTI = 27
LCID_TRUNC_BSR = 28
LCID_SHORT_BSR = 29
LCID_LONG_BSR = 30


@dataclass
class SubHeader:
    lcid: int
    length: int | None = None  # None for fixed-size CE / last subheader
    payload: bytes = b""


@dataclass
class MacPdu:
    subheaders: list[SubHeader] = field(default_factory=list)

    def add_sdu(self, lcid: int, data: bytes) -> None:
        self.subheaders.append(SubHeader(lcid, len(data), bytes(data)))

    def add_ce(self, lcid: int, data: bytes = b"") -> None:
        self.subheaders.append(SubHeader(lcid, None, bytes(data)))


_CE_SIZES_DL = {LCID_TA: 1, LCID_CON_RES: 6, LCID_DRX: 0}
_CE_SIZES_UL = {
    LCID_CRNTI: 2,
    LCID_PHR: 1,
    LCID_SHORT_BSR: 1,
    LCID_TRUNC_BSR: 1,
    LCID_LONG_BSR: 3,
}


def pack(pdu: MacPdu, pdu_len: int, uplink: bool = False) -> bytes:
    """Pack subheaders + payloads into exactly pdu_len bytes (padding per
    36.321 §6.1.2: 1-2 byte padding -> leading pad subheaders; longer ->
    trailing padding subheader)."""
    ce_sizes = _CE_SIZES_UL if uplink else _CE_SIZES_DL
    shs = list(pdu.subheaders)
    # compute sizes: header bytes per subheader
    payload_bytes = sum(len(s.payload) for s in shs)

    def header_len(s: SubHeader, is_last: bool) -> int:
        if is_last or s.lcid in ce_sizes:
            return 1
        return 2 if len(s.payload) < 128 else 3

    total = payload_bytes + sum(header_len(s, i == len(shs) - 1) for i, s in enumerate(shs))
    pad = pdu_len - total
    if pad < 0:
        raise ValueError(f"PDU overflow: need {total}, have {pdu_len}")

    lead_pads = 0
    trail_pad = False
    if pad in (1, 2):
        lead_pads = pad  # each pad subheader costs exactly 1 byte
    elif pad > 2:
        trail_pad = True  # 1-byte subheader + (pad-1) padding bytes

    out = bytearray()
    headers = []
    if lead_pads:
        for _ in range(lead_pads):
            headers.append((LCID_PAD, None, b""))
    for s in shs:
        headers.append((s.lcid, s.length, s.payload))
    if trail_pad:
        headers.append((LCID_PAD, None, b""))

    for i, (lcid, length, payload) in enumerate(headers):
        is_last = i == len(headers) - 1
        e = 0 if is_last else 1
        if is_last or lcid in ce_sizes or lcid == LCID_PAD:
            out.append((e << 5) | (lcid & 0x1F))
        else:
            l = len(payload)
            if l < 128:
                out.append((e << 5) | (lcid & 0x1F))
                out[-1] |= 0  # R bits zero
                out.append(l & 0x7F)  # F=0
            else:
                out.append((e << 5) | (lcid & 0x1F))
                out.append(0x80 | ((l >> 8) & 0x7F))
                out.append(l & 0xFF)
    for lcid, length, payload in headers:
        out.extend(payload)
    out.extend(b"\x00" * (pdu_len - len(out)))
    return bytes(out)


def unpack(data: bytes, uplink: bool = False) -> MacPdu:
    """Parse a MAC PDU into subheaders + payloads."""
    ce_sizes = _CE_SIZES_UL if uplink else _CE_SIZES_DL
    pdu = MacPdu()
    pos = 0
    heads: list[tuple[int, int | None]] = []
    while pos < len(data):
        b0 = data[pos]
        pos += 1
        e = (b0 >> 5) & 1
        lcid = b0 & 0x1F
        if lcid == LCID_PAD:
            heads.append((lcid, 0))
            if not e:
                break
            continue
        if lcid in ce_sizes:
            heads.append((lcid, ce_sizes[lcid]))
            if not e:
                break
            continue
        if not e:  # last subheader: length implicit
            heads.append((lcid, None))
            break
        b1 = data[pos]
        pos += 1
        if b1 & 0x80:
            b2 = data[pos]
            pos += 1
            heads.append((lcid, ((b1 & 0x7F) << 8) | b2))
        else:
            heads.append((lcid, b1 & 0x7F))

    for i, (lcid, length) in enumerate(heads):
        if lcid == LCID_PAD:
            if i == len(heads) - 1:
                pos = len(data)  # trailing padding consumes the rest
            continue
        if length is None:
            length = len(data) - pos
        payload = data[pos : pos + length]
        pos += length
        sh = SubHeader(lcid, None if lcid in ce_sizes else length, payload)
        pdu.subheaders.append(sh)
    return pdu


# ---------------------------------------------------------------------------
# Control elements
# ---------------------------------------------------------------------------


def ce_timing_advance(payload: bytes) -> int:
    return payload[0] & 0x3F


def ce_contention_resolution(payload: bytes) -> bytes:
    return payload[:6]


def make_ce_crnti(rnti: int) -> bytes:
    return bytes([(rnti >> 8) & 0xFF, rnti & 0xFF])


def make_ce_short_bsr(lcg: int, bsr_idx: int) -> bytes:
    return bytes([((lcg & 3) << 6) | (bsr_idx & 0x3F)])


def make_ce_long_bsr(idx: list[int]) -> bytes:
    b0 = ((idx[0] & 0x3F) << 2) | ((idx[1] >> 4) & 3)
    b1 = ((idx[1] & 0xF) << 4) | ((idx[2] >> 2) & 0xF)
    b2 = ((idx[2] & 3) << 6) | (idx[3] & 0x3F)
    return bytes([b0, b1, b2])


def parse_long_bsr(payload: bytes) -> list[int]:
    b0, b1, b2 = payload[0], payload[1], payload[2]
    return [
        (b0 >> 2) & 0x3F,
        ((b0 & 3) << 4) | ((b1 >> 4) & 0xF),
        ((b1 & 0xF) << 2) | ((b2 >> 6) & 3),
        b2 & 0x3F,
    ]


def make_ce_phr(ph: int) -> bytes:
    return bytes([ph & 0x3F])


# 36.321 Table 6.1.3.1-1: BSR buffer-size levels (bytes, upper bounds)
BSR_TABLE = [
    0, 10, 12, 14, 17, 19, 22, 26, 31, 36, 42, 49, 57, 67, 78, 91,
    107, 125, 146, 171, 200, 234, 274, 321, 376, 440, 515, 603, 706,
    826, 967, 1132, 1326, 1552, 1817, 2127, 2490, 2915, 3413, 3995,
    4677, 5476, 6411, 7505, 8787, 10287, 12043, 14099, 16507, 19325,
    22624, 26487, 31009, 36304, 42502, 49759, 58255, 68201, 79846,
    93479, 109439, 128125, 150000, 150001,
]


def bsr_index(n_bytes: int) -> int:
    for i, ub in enumerate(BSR_TABLE):
        if n_bytes <= ub:
            return i
    return 63


# ---------------------------------------------------------------------------
# RAR PDU (36.321 §6.1.5, §6.2.2/6.2.3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RarGrant:
    """20-bit UL grant carried in the RAR (36.213 §6.2)."""

    hopping: bool
    riv: int  # 10-bit truncated RIV
    mcs: int  # 4 bits
    tpc: int  # 3 bits
    ul_delay: bool
    cqi_req: bool


@dataclass(frozen=True)
class Rar:
    rapid: int
    ta: int  # 11-bit timing advance
    grant: RarGrant
    t_crnti: int


def pack_rar_pdu(rars: list[Rar], backoff: int | None = None, pdu_len: int | None = None) -> bytes:
    out = bytearray()
    heads = []
    if backoff is not None:
        heads.append(0x80 | 0x00 | (backoff & 0xF))  # E set later, T=0 BI
    for r in rars:
        heads.append(0x40 | (r.rapid & 0x3F))  # T=1 RAPID
    for i, h in enumerate(heads):
        e = 0x80 if i < len(heads) - 1 else 0
        out.append((h & 0x7F) | e)
    for r in rars:
        g = r.grant
        grant20 = (
            (int(g.hopping) << 19)
            | ((g.riv & 0x3FF) << 9)
            | ((g.mcs & 0xF) << 5)
            | ((g.tpc & 7) << 2)
            | (int(g.ul_delay) << 1)
            | int(g.cqi_req)
        )
        b = bytearray(6)
        b[0] = (r.ta >> 4) & 0x7F
        b[1] = ((r.ta & 0xF) << 4) | ((grant20 >> 16) & 0xF)
        b[2] = (grant20 >> 8) & 0xFF
        b[3] = grant20 & 0xFF
        b[4] = (r.t_crnti >> 8) & 0xFF
        b[5] = r.t_crnti & 0xFF
        out.extend(b)
    if pdu_len is not None:
        out.extend(b"\x00" * (pdu_len - len(out)))
    return bytes(out)


def unpack_rar_pdu(data: bytes) -> tuple[list[Rar], int | None]:
    rars: list[Rar] = []
    backoff = None
    pos = 0
    rapids = []
    while pos < len(data):
        b0 = data[pos]
        pos += 1
        e = b0 & 0x80
        t = b0 & 0x40
        if t:
            rapids.append(b0 & 0x3F)
        else:
            backoff = b0 & 0xF
        if not e:
            break
    for rapid in rapids:
        b = data[pos : pos + 6]
        pos += 6
        ta = (b[0] << 4) | ((b[1] >> 4) & 0xF)
        grant20 = ((b[1] & 0xF) << 16) | (b[2] << 8) | b[3]
        t_crnti = (b[4] << 8) | b[5]
        g = RarGrant(
            hopping=bool((grant20 >> 19) & 1),
            riv=(grant20 >> 9) & 0x3FF,
            mcs=(grant20 >> 5) & 0xF,
            tpc=(grant20 >> 2) & 7,
            ul_delay=bool((grant20 >> 1) & 1),
            cqi_req=bool(grant20 & 1),
        )
        rars.append(Rar(rapid, ta, g, t_crnti))
    return rars, backoff


# ---------------------------------------------------------------------------
# bit <-> byte helpers (device TB bits <-> MAC bytes)
# ---------------------------------------------------------------------------


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def bytes_to_bits(data: bytes, n_bits: int | None = None) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    return bits[:n_bits] if n_bits is not None else bits
