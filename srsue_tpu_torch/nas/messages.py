"""The port's own copy of ``srsue_tpu/nas/messages.py`` (its reference), unchanged below this docstring.

NAS EMM/ESM message codecs — 24.301/24.008 octet-aligned framing
(reference: liblte/src/liblte_mme.cc, 265 pack/unpack functions; we cover
the attach call flow srsUE exercises: nas.cc:69-452).

Real NAS framing: every message starts with security-header-type(4) |
protocol-discriminator(4), then message type; integrity-protected
messages are wrapped with MAC(4 bytes) + sequence number. IEs use the
spec's TLV encodings for the subset carried in the attach flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PD_EMM = 0x07
PD_ESM = 0x02

# security header types
SEC_NONE = 0x0
SEC_INTEGRITY = 0x1
SEC_INTEGRITY_CIPHERED = 0x2
SEC_INTEGRITY_NEW_CTX = 0x3
SEC_INTEGRITY_CIPHERED_NEW_CTX = 0x4

# EMM message types
MT_ATTACH_REQUEST = 0x41
MT_ATTACH_ACCEPT = 0x42
MT_ATTACH_COMPLETE = 0x43
MT_ATTACH_REJECT = 0x44
MT_AUTH_REQUEST = 0x52
MT_AUTH_RESPONSE = 0x53
MT_AUTH_REJECT = 0x54
MT_IDENTITY_REQUEST = 0x55
MT_IDENTITY_RESPONSE = 0x56
MT_SECURITY_MODE_COMMAND = 0x5D
MT_SECURITY_MODE_COMPLETE = 0x5E
MT_SECURITY_MODE_REJECT = 0x5F
MT_DETACH_REQUEST = 0x45
MT_DETACH_ACCEPT = 0x46
MT_SERVICE_REJECT = 0x4E
MT_EMM_INFORMATION = 0x61
MT_EMM_STATUS = 0x60
# ESM message types
MT_PDN_CONNECTIVITY_REQUEST = 0xD0
MT_ESM_INFORMATION_REQUEST = 0xD9
MT_ESM_INFORMATION_RESPONSE = 0xDA
MT_ACT_DEF_BEARER_REQUEST = 0xC1
MT_ACT_DEF_BEARER_ACCEPT = 0xC2


def imsi_to_mobile_id(imsi: str) -> bytes:
    """24.008 §10.5.1.4 Mobile Identity, IMSI type."""
    digits = [int(c) for c in imsi]
    odd = len(digits) % 2
    b0 = (digits[0] << 4) | (odd << 3) | 0x1  # type IMSI
    out = [b0]
    i = 1
    while i < len(digits):
        lo = digits[i]
        hi = digits[i + 1] if i + 1 < len(digits) else 0xF
        out.append((hi << 4) | lo)
        i += 2
    return bytes([len(out)]) + bytes(out)


def mobile_id_to_imsi(data: bytes) -> str:
    n = data[0]
    body = data[1 : 1 + n]
    odd = (body[0] >> 3) & 1
    digits = [str((body[0] >> 4) & 0xF)]
    for b in body[1:]:
        digits.append(str(b & 0xF))
        digits.append(str((b >> 4) & 0xF))
    if not odd:
        digits = digits[:-1]
    return "".join(digits)


# ---------------------------------------------------------------------------
# EMM messages (plain, pre-security; wrapping below)
# ---------------------------------------------------------------------------


@dataclass
class AttachRequest:
    imsi: str
    ue_network_cap: bytes = b"\xe0\xe0"  # EEA0..2 / EIA1..2 support bits
    esm_pdu: bytes = b""

    def pack(self) -> bytes:
        out = bytearray([(SEC_NONE << 4) | PD_EMM, MT_ATTACH_REQUEST])
        out.append(0x01)  # EPS attach type=EPS attach | NAS KSI=0
        out += imsi_to_mobile_id(self.imsi)
        out.append(len(self.ue_network_cap))
        out += self.ue_network_cap
        out += len(self.esm_pdu).to_bytes(2, "big")
        out += self.esm_pdu
        return bytes(out)

    @classmethod
    def unpack(cls, b: bytes) -> "AttachRequest":
        assert b[1] == MT_ATTACH_REQUEST
        pos = 3
        n_id = b[pos]
        imsi = mobile_id_to_imsi(b[pos:])
        pos += 1 + n_id
        n_cap = b[pos]
        cap = b[pos + 1 : pos + 1 + n_cap]
        pos += 1 + n_cap
        n_esm = int.from_bytes(b[pos : pos + 2], "big")
        esm = b[pos + 2 : pos + 2 + n_esm]
        return cls(imsi, cap, esm)


@dataclass
class AuthRequest:
    rand: bytes
    autn: bytes
    ksi: int = 0

    def pack(self) -> bytes:
        return (
            bytes([(SEC_NONE << 4) | PD_EMM, MT_AUTH_REQUEST, self.ksi])
            + self.rand
            + bytes([len(self.autn)])
            + self.autn
        )

    @classmethod
    def unpack(cls, b: bytes) -> "AuthRequest":
        assert b[1] == MT_AUTH_REQUEST
        rand = b[3:19]
        n = b[19]
        return cls(rand, b[20 : 20 + n], b[2] & 0xF)


@dataclass
class AttachReject:
    """24.301 §8.2.3 (reference parser: nas.cc:262-272 — logs the cause
    and drops to DEREGISTERED)."""

    emm_cause: int

    def pack(self) -> bytes:
        return bytes([(SEC_NONE << 4) | PD_EMM, MT_ATTACH_REJECT,
                      self.emm_cause])

    @classmethod
    def unpack(cls, b: bytes) -> "AttachReject":
        assert b[1] == MT_ATTACH_REJECT
        return cls(b[2])


@dataclass
class IdentityRequest:
    """24.301 §8.2.18; id_type 1 = IMSI (reference stubs the parser,
    nas.cc:323-325 — we answer with an IdentityResponse)."""

    id_type: int = 1

    def pack(self) -> bytes:
        return bytes([(SEC_NONE << 4) | PD_EMM, MT_IDENTITY_REQUEST,
                      self.id_type & 0xF])

    @classmethod
    def unpack(cls, b: bytes) -> "IdentityRequest":
        assert b[1] == MT_IDENTITY_REQUEST
        return cls(b[2] & 0xF)


@dataclass
class IdentityResponse:
    imsi: str

    def pack(self) -> bytes:
        return (bytes([(SEC_NONE << 4) | PD_EMM, MT_IDENTITY_RESPONSE])
                + imsi_to_mobile_id(self.imsi))

    @classmethod
    def unpack(cls, b: bytes) -> "IdentityResponse":
        assert b[1] == MT_IDENTITY_RESPONSE
        return cls(mobile_id_to_imsi(b[2:]))


@dataclass
class AuthResponse:
    res: bytes

    def pack(self) -> bytes:
        return bytes([(SEC_NONE << 4) | PD_EMM, MT_AUTH_RESPONSE, len(self.res)]) + self.res

    @classmethod
    def unpack(cls, b: bytes) -> "AuthResponse":
        assert b[1] == MT_AUTH_RESPONSE
        return cls(b[3 : 3 + b[2]])


@dataclass
class SecurityModeCommand:
    eea: int
    eia: int
    ksi: int = 0
    replayed_cap: bytes = b"\xe0\xe0"

    def pack(self) -> bytes:
        return bytes(
            [
                (SEC_NONE << 4) | PD_EMM,
                MT_SECURITY_MODE_COMMAND,
                (self.eea << 4) | self.eia,
                self.ksi,
                len(self.replayed_cap),
            ]
        ) + self.replayed_cap

    @classmethod
    def unpack(cls, b: bytes) -> "SecurityModeCommand":
        assert b[1] == MT_SECURITY_MODE_COMMAND
        return cls((b[2] >> 4) & 0xF, b[2] & 0xF, b[3], b[5 : 5 + b[4]])


@dataclass
class SecurityModeComplete:
    imeisv: str | None = None

    def pack(self) -> bytes:
        out = bytearray([(SEC_NONE << 4) | PD_EMM, MT_SECURITY_MODE_COMPLETE])
        if self.imeisv:
            out.append(0x23)  # IEI
            out += imsi_to_mobile_id(self.imeisv)
        return bytes(out)

    @classmethod
    def unpack(cls, b: bytes) -> "SecurityModeComplete":
        assert b[1] == MT_SECURITY_MODE_COMPLETE
        if len(b) > 2 and b[2] == 0x23:
            return cls(mobile_id_to_imsi(b[3:]))
        return cls()


@dataclass
class AttachAccept:
    t3412: int = 0x21
    tai: bytes = b"\x00\xf1\x10\x00\x01"
    esm_pdu: bytes = b""
    guti: bytes | None = None

    def pack(self) -> bytes:
        out = bytearray([(SEC_NONE << 4) | PD_EMM, MT_ATTACH_ACCEPT])
        out.append(0x01)  # result: EPS only
        out.append(self.t3412)
        out.append(len(self.tai))
        out += self.tai
        out += len(self.esm_pdu).to_bytes(2, "big")
        out += self.esm_pdu
        if self.guti:
            out.append(0x50)
            out.append(len(self.guti))
            out += self.guti
        return bytes(out)

    @classmethod
    def unpack(cls, b: bytes) -> "AttachAccept":
        assert b[1] == MT_ATTACH_ACCEPT
        pos = 4
        n_tai = b[pos]
        tai = b[pos + 1 : pos + 1 + n_tai]
        pos += 1 + n_tai
        n_esm = int.from_bytes(b[pos : pos + 2], "big")
        esm = b[pos + 2 : pos + 2 + n_esm]
        pos += 2 + n_esm
        guti = None
        if pos < len(b) and b[pos] == 0x50:
            n = b[pos + 1]
            guti = b[pos + 2 : pos + 2 + n]
        return cls(b[3], tai, esm, guti)


@dataclass
class ServiceReject:
    """24.301 §8.2.24 (reference parser is a TODO stub, nas.cc:387-389;
    we parse the cause and optional T3442)."""

    emm_cause: int
    t3442: int | None = None

    def pack(self) -> bytes:
        out = bytearray([(SEC_NONE << 4) | PD_EMM, MT_SERVICE_REJECT,
                         self.emm_cause])
        if self.t3442 is not None:
            out.append(self.t3442)
        return bytes(out)

    @classmethod
    def unpack(cls, b: bytes) -> "ServiceReject":
        assert b[1] == MT_SERVICE_REJECT
        return cls(b[2], b[3] if len(b) > 3 else None)


@dataclass
class DetachRequestNw:
    """24.301 §8.2.11.2 network-initiated detach (absent in the reference;
    capability-plus). detach_type 1=re-attach required, 2=re-attach not
    required, 3=IMSI detach."""

    detach_type: int = 2

    def pack(self) -> bytes:
        return bytes([(SEC_NONE << 4) | PD_EMM, MT_DETACH_REQUEST,
                      self.detach_type & 0xF])

    @classmethod
    def unpack(cls, b: bytes) -> "DetachRequestNw":
        assert b[1] == MT_DETACH_REQUEST
        return cls(b[2] & 0xF)


@dataclass
class DetachAccept:
    """24.301 §8.2.10 (UE->network answer to network-initiated detach)."""

    def pack(self) -> bytes:
        return bytes([(SEC_NONE << 4) | PD_EMM, MT_DETACH_ACCEPT])

    @classmethod
    def unpack(cls, b: bytes) -> "DetachAccept":
        assert b[1] == MT_DETACH_ACCEPT
        return cls()


@dataclass
class AttachComplete:
    esm_pdu: bytes = b""

    def pack(self) -> bytes:
        return (
            bytes([(SEC_NONE << 4) | PD_EMM, MT_ATTACH_COMPLETE])
            + len(self.esm_pdu).to_bytes(2, "big")
            + self.esm_pdu
        )

    @classmethod
    def unpack(cls, b: bytes) -> "AttachComplete":
        assert b[1] == MT_ATTACH_COMPLETE
        n = int.from_bytes(b[2:4], "big")
        return cls(b[4 : 4 + n])


# ---------------------------------------------------------------------------
# ESM messages
# ---------------------------------------------------------------------------


@dataclass
class PdnConnectivityRequest:
    pti: int = 1
    pdn_type: int = 1  # IPv4

    def pack(self) -> bytes:
        return bytes(
            [(0 << 4) | PD_ESM, self.pti, MT_PDN_CONNECTIVITY_REQUEST,
             (self.pdn_type << 4) | 0x1]
        )

    @classmethod
    def unpack(cls, b: bytes) -> "PdnConnectivityRequest":
        assert b[2] == MT_PDN_CONNECTIVITY_REQUEST
        return cls(b[1], (b[3] >> 4) & 0xF)


@dataclass
class ActivateDefaultBearerRequest:
    eps_bearer_id: int = 5
    pti: int = 1
    apn: str = "internet"
    ip_addr: str = "192.168.1.2"

    def pack(self) -> bytes:
        apn_b = self.apn.encode()
        ip = bytes(int(x) for x in self.ip_addr.split("."))
        out = bytearray([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                         MT_ACT_DEF_BEARER_REQUEST])
        out.append(len(apn_b))
        out += apn_b
        out.append(0x01)  # PDN type IPv4
        out.append(len(ip))
        out += ip
        return bytes(out)

    @classmethod
    def unpack(cls, b: bytes) -> "ActivateDefaultBearerRequest":
        assert b[2] == MT_ACT_DEF_BEARER_REQUEST
        n_apn = b[3]
        apn = b[4 : 4 + n_apn].decode()
        pos = 4 + n_apn + 1
        n_ip = b[pos]
        ip = ".".join(str(x) for x in b[pos + 1 : pos + 1 + n_ip])
        return cls((b[0] >> 4) & 0xF, b[1], apn, ip)


@dataclass
class ActivateDefaultBearerAccept:
    eps_bearer_id: int = 5
    pti: int = 1

    def pack(self) -> bytes:
        return bytes([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                      MT_ACT_DEF_BEARER_ACCEPT])

    @classmethod
    def unpack(cls, b: bytes) -> "ActivateDefaultBearerAccept":
        assert b[2] == MT_ACT_DEF_BEARER_ACCEPT
        return cls((b[0] >> 4) & 0xF, b[1])


@dataclass
class EsmInformationRequest:
    """24.301 §8.3.13 (reference parser is a TODO stub, nas.cc:391-393)."""

    eps_bearer_id: int = 0
    pti: int = 1

    def pack(self) -> bytes:
        return bytes([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                      MT_ESM_INFORMATION_REQUEST])

    @classmethod
    def unpack(cls, b: bytes) -> "EsmInformationRequest":
        assert b[2] == MT_ESM_INFORMATION_REQUEST
        return cls((b[0] >> 4) & 0xF, b[1])


@dataclass
class EsmInformationResponse:
    """24.301 §8.3.14: UE answers with the APN it wants (TLV IEI 0x28)."""

    pti: int = 1
    apn: str | None = "internet"

    def pack(self) -> bytes:
        out = bytearray([(0 << 4) | PD_ESM, self.pti,
                         MT_ESM_INFORMATION_RESPONSE])
        if self.apn is not None:
            # 24.008 §10.5.6.1: APN is dot-separated labels, each
            # length-prefixed
            labels = bytearray()
            for part in self.apn.split("."):
                labels.append(len(part))
                labels += part.encode()
            out += bytes([0x28, len(labels)]) + labels
        return bytes(out)

    @classmethod
    def unpack(cls, b: bytes) -> "EsmInformationResponse":
        assert b[2] == MT_ESM_INFORMATION_RESPONSE
        apn = None
        pos = 3
        if pos < len(b) and b[pos] == 0x28:
            n = b[pos + 1]
            labels = b[pos + 2 : pos + 2 + n]
            parts = []
            i = 0
            while i < len(labels):
                ln = labels[i]
                parts.append(labels[i + 1 : i + 1 + ln].decode())
                i += 1 + ln
            apn = ".".join(parts)
        return cls(b[1], apn)


# ---------------------------------------------------------------------------
# security wrapping (24.301 §9.1: MAC + SN header)
# ---------------------------------------------------------------------------


def secure_wrap(plain: bytes, seq: int, mac4: bytes, sec_type: int = SEC_INTEGRITY) -> bytes:
    return bytes([(sec_type << 4) | PD_EMM]) + mac4 + bytes([seq & 0xFF]) + plain


def secure_unwrap(data: bytes) -> tuple[int, bytes, int, bytes]:
    """Returns (sec_type, mac4, seq, inner_plain)."""
    sec_type = (data[0] >> 4) & 0xF
    if sec_type == SEC_NONE:
        return SEC_NONE, b"", 0, data
    return sec_type, data[1:5], data[5], data[6:]


def msg_type_of(plain: bytes) -> int:
    pd = plain[0] & 0xF
    return plain[2] if pd == PD_ESM else plain[1]
