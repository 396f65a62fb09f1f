"""LTE security primitives -- 33.401/35.206 (reference:
liblte/src/liblte_security.cc:257-560). The port's counterpart of
``srsue_tpu/usim/security.py`` (its reference): the KDF, CMAC, EIA2, EEA2
and Milenage below are the reference's, over the port's own AES-128.

* KDF: HMAC-SHA256 key derivation (K_ASME, K_eNB, K_NAS/K_RRC/K_UP).
* 128-EIA2: AES-CMAC integrity (NIST SP 800-38B over the EIA2 framing).
* 128-EEA2: AES-CTR ciphering; EEA0 = null cipher.
* Milenage: f1/f1*/f2/f3/f4/f5/f5* on AES-128 (35.206).

The reference takes its AES core from the ``cryptography`` package. The port
carries its own AES-128 encryption in plain Python (FIPS-197: key
expansion, SubBytes, ShiftRows, MixColumns, AddRoundKey) so that it needs
no package beyond the standard library; ECB on one block and the CTR
keystream are built on it. Only encryption is needed: CTR, CMAC and
Milenage never run the inverse cipher.
"""

from __future__ import annotations

import functools
import hmac
import hashlib


# ---------------------------------------------------------------------------
# AES-128 encryption -- FIPS-197
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    """Product in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1 (FIPS-197 4.2)."""
    p = 0
    while b:
        if b & 1:
            p ^= a
        a = ((a << 1) ^ 0x11B) if a & 0x80 else a << 1
        b >>= 1
    return p


def _make_sbox() -> tuple[int, ...]:
    """S-box (FIPS-197 5.1.1): the multiplicative inverse (a^254; 0 maps to
    0) through the affine transform b ^ rotl(b, 1..4) ^ 0x63."""
    box = []
    for a in range(256):
        inv, base, e = 1, a, 254
        while e:
            if e & 1:
                inv = _gf_mul(inv, base)
            base = _gf_mul(base, base)
            e >>= 1
        inv = inv if a else 0
        s = inv
        for r in range(1, 5):
            s ^= ((inv << r) | (inv >> (8 - r))) & 0xFF
        box.append(s ^ 0x63)
    return tuple(box)


_SBOX = _make_sbox()
_MUL2 = tuple(_gf_mul(a, 2) for a in range(256))
_MUL3 = tuple(_gf_mul(a, 3) for a in range(256))
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# ShiftRows on the column-major state (byte i is row i % 4, column i // 4):
# row r moves r columns to the left
_SHIFT = tuple((i + 4 * (i % 4)) % 16 for i in range(16))


@functools.lru_cache(maxsize=64)
def _round_keys(key: bytes) -> tuple[tuple[int, ...], ...]:
    """The 11 round keys of AES-128 (FIPS-197 5.2), 16 bytes each."""
    if len(key) != 16:
        raise ValueError(f"AES-128 takes a 16-byte key, got {len(key)}")
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return tuple(tuple(b for word in w[4 * r: 4 * r + 4] for b in word)
                 for r in range(11))


def aes128_encrypt(key: bytes, block: bytes) -> bytes:
    """One 16-byte block through the AES-128 cipher (FIPS-197 5.1)."""
    if len(block) != 16:
        raise ValueError(f"AES takes a 16-byte block, got {len(block)}")
    rk = _round_keys(bytes(key))
    s = [b ^ k for b, k in zip(block, rk[0])]
    for r in range(1, 11):
        s = [_SBOX[s[j]] for j in _SHIFT]  # SubBytes + ShiftRows
        if r < 10:  # MixColumns
            m = []
            for c in range(0, 16, 4):
                a0, a1, a2, a3 = s[c: c + 4]
                m += [_MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3,
                      a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3,
                      a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3],
                      _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]]
            s = m
        s = [b ^ k for b, k in zip(s, rk[r])]
    return bytes(s)


def _aes_ecb(key: bytes, block: bytes) -> bytes:
    return aes128_encrypt(key, block)


def _aes_ctr(key: bytes, iv: bytes, msg: bytes) -> bytes:
    """CTR mode (SP 800-38A 6.5): the keystream is AES of the 128-bit
    counter block, incremented big-endian modulo 2^128 per block."""
    ctr = int.from_bytes(iv, "big")
    out = bytearray()
    for i in range(0, len(msg), 16):
        ks = aes128_encrypt(key, ((ctr + i // 16) % (1 << 128)).to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(msg[i: i + 16], ks))
    return bytes(out)


# ---------------------------------------------------------------------------
# KDF — 33.401 Annex A
# ---------------------------------------------------------------------------


def kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    s = bytes([fc])
    for p in params:
        s += p + len(p).to_bytes(2, "big")
    return hmac.new(key, s, hashlib.sha256).digest()


def kdf_k_asme(ck: bytes, ik: bytes, plmn: bytes, sqn_xor_ak: bytes) -> bytes:
    """A.2: K_ASME from CK||IK, SN id (3 bytes), SQN^AK (6 bytes)."""
    return kdf(ck + ik, 0x10, plmn, sqn_xor_ak)


def kdf_k_enb(k_asme: bytes, nas_count: int) -> bytes:
    return kdf(k_asme, 0x11, nas_count.to_bytes(4, "big"))


def kdf_nh(k_asme: bytes, sync_input: bytes) -> bytes:
    """A.4: NH derivation. sync_input = initial K_eNB for NH(1), the
    previous NH for NH(i>1) — the vertical key-chaining input used at
    handover/re-establishment (33.401 §7.2.8)."""
    return kdf(k_asme, 0x12, sync_input)


def kdf_k_enb_star(key: bytes, pci: int, earfcn_dl: int) -> bytes:
    """A.5: K_eNB* from current K_eNB (horizontal, NCC unchanged) or NH
    (vertical, NCC increased) + target PCI + DL EARFCN."""
    return kdf(key, 0x13, pci.to_bytes(2, "big"), earfcn_dl.to_bytes(2, "big"))


def kdf_nas(k_asme: bytes, alg_id: int, is_integrity: bool) -> bytes:
    dist = 0x02 if is_integrity else 0x01
    return kdf(k_asme, 0x15, bytes([dist]), bytes([alg_id]))[16:]


def kdf_as(k_enb: bytes, alg_id: int, kind: str) -> bytes:
    """kind in {'rrc_enc','rrc_int','up_enc','up_int'} (A.7)."""
    dist = {"up_enc": 0x03, "up_int": 0x04, "rrc_enc": 0x05, "rrc_int": 0x06}[kind]
    return kdf(k_enb, 0x15, bytes([dist]), bytes([alg_id]))[16:]


# ---------------------------------------------------------------------------
# AES-CMAC (SP 800-38B) + 128-EIA2
# ---------------------------------------------------------------------------


def _leftshift(b: bytes) -> bytes:
    n = int.from_bytes(b, "big") << 1
    return (n & ((1 << 128) - 1)).to_bytes(16, "big"), (n >> 128) & 1


def _cmac_subkeys(key: bytes) -> tuple[bytes, bytes]:
    l = _aes_ecb(key, b"\x00" * 16)
    k1, ov = _leftshift(l)
    if ov:
        k1 = (int.from_bytes(k1, "big") ^ 0x87).to_bytes(16, "big")
    k2, ov = _leftshift(k1)
    if ov:
        k2 = (int.from_bytes(k2, "big") ^ 0x87).to_bytes(16, "big")
    return k1, k2


def aes_cmac(key: bytes, msg: bytes) -> bytes:
    k1, k2 = _cmac_subkeys(key)
    n = max(1, (len(msg) + 15) // 16)
    complete = len(msg) > 0 and len(msg) % 16 == 0
    blocks = [msg[i * 16 : (i + 1) * 16] for i in range(n)]
    last = blocks[-1]
    if complete:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        pad = last + b"\x80" + b"\x00" * (15 - len(last))
        last = bytes(a ^ b for a, b in zip(pad, k2))
    x = b"\x00" * 16
    for blk in blocks[:-1]:
        x = _aes_ecb(key, bytes(a ^ b for a, b in zip(x, blk)))
    return _aes_ecb(key, bytes(a ^ b for a, b in zip(x, last)))


def eia2(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """128-EIA2 MAC-I (4 bytes)."""
    m = count.to_bytes(4, "big") + bytes([(bearer << 3) | (direction << 2)]) + b"\x00" * 3 + msg
    return aes_cmac(key, m)[:4]


def eea2(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """128-EEA2 AES-CTR cipher (encrypt == decrypt)."""
    iv = count.to_bytes(4, "big") + bytes([(bearer << 3) | (direction << 2)]) + b"\x00" * 11
    return _aes_ctr(key, iv, msg)


def eea0(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """Null ciphering (the reference's configured algorithm, rrc.cc:493-496)."""
    return bytes(msg)


EIA = {1: None, 2: eia2}  # EIA1 (SNOW) flagged unsupported
EEA = {0: eea0, 2: eea2}


# ---------------------------------------------------------------------------
# Milenage — 35.206 §4
# ---------------------------------------------------------------------------


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _rot(b: bytes, r_bits: int) -> bytes:
    n = int.from_bytes(b, "big")
    n = ((n << r_bits) | (n >> (128 - r_bits))) & ((1 << 128) - 1)
    return n.to_bytes(16, "big")


def milenage_opc(k: bytes, op: bytes) -> bytes:
    return _xor(_aes_ecb(k, op), op)


def milenage_f1(k: bytes, opc: bytes, rand: bytes, sqn: bytes, amf: bytes):
    """Returns (mac_a, mac_s)."""
    temp = _aes_ecb(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    out1 = _xor(
        _aes_ecb(k, _xor(_rot(_xor(in1, opc), 64), temp)), opc
    )
    return out1[:8], out1[8:]


def milenage_f2345(k: bytes, opc: bytes, rand: bytes):
    """Returns (res, ck, ik, ak)."""
    temp = _aes_ecb(k, _xor(rand, opc))
    # OUT2 = E[rot(temp^OPc, r2) ^ c2]K ^ OPc ; c2 = ...1, r2=0
    c2 = (1).to_bytes(16, "big")
    out2 = _xor(_aes_ecb(k, _xor(_xor(temp, opc), c2)), opc)
    res = out2[8:]
    ak = out2[:6]
    c3 = (2).to_bytes(16, "big")
    out3 = _xor(_aes_ecb(k, _xor(_rot(_xor(temp, opc), 32), c3)), opc)
    ck = out3
    c4 = (4).to_bytes(16, "big")
    out4 = _xor(_aes_ecb(k, _xor(_rot(_xor(temp, opc), 64), c4)), opc)
    ik = out4
    return res, ck, ik, ak


def milenage_f5_star(k: bytes, opc: bytes, rand: bytes) -> bytes:
    temp = _aes_ecb(k, _xor(rand, opc))
    c5 = (8).to_bytes(16, "big")
    out5 = _xor(_aes_ecb(k, _xor(_rot(_xor(temp, opc), 96), c5)), opc)
    return out5[:6]
