"""The port's own copy of ``srsue_tpu/rrc/uper.py`` (its reference), unchanged below this docstring.

ASN.1 Unaligned PER (X.691) codec engine — the encoding 36.331 uses
on the air.

The reference consumes hand-written bit codecs for 352 RRC messages
(liblte/src/liblte_rrc.cc, 13k LoC). Here the same wire format is
produced from declarative schemas (see rrc/asn1.py): each combinator
implements the exact UPER rules it needs —

* constrained whole numbers -> minimal-width bit fields (range <= 2^16,
  which covers every integer 36.331 Rel-8 uses);
* extensible SEQUENCE / CHOICE / ENUMERATED -> leading extension bit;
  unknown extension additions are *skipped* on decode via their open-type
  length wrappers (so messages from later-release eNBs still parse);
* OPTIONAL/DEFAULT -> presence bitmap before the root fields (canonical
  PER: DEFAULT values are omitted);
* unconstrained OCTET STRING / open types -> general length determinant
  (8-bit short form / 16-bit long form, fragmentation unsupported —
  no 36.331 UE message approaches 16 KiB).

Values are plain Python: dicts for SEQUENCE, ('alt', value) tuples for
CHOICE, str for ENUMERATED, int for INTEGER and BIT STRING, bytes for
OCTET STRING, list for SEQUENCE OF.
"""

from __future__ import annotations

from typing import Any

OPT = "opt"  # marker for OPTIONAL fields in Seq definitions


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        assert value >= 0 and (n == 0 or value < (1 << n)), (value, n)
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def put_bytes(self, data: bytes) -> None:
        for b in data:
            self.put(b, 8)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            v = 0
            for b in bits[i : i + 8]:
                v = (v << 1) | b
            out.append(v)
        return bytes(out) if out else b"\x00"  # PER: empty encoding -> 1 zero octet


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get(8) for _ in range(n))

    def skip(self, nbits: int) -> None:
        self.pos += nbits


# --- shared length forms ----------------------------------------------------


def put_general_length(w: BitWriter, n: int) -> None:
    """X.691 §10.9 general length determinant (unaligned: same bit
    patterns, just not octet-aligned)."""
    if n < 128:
        w.put(n, 8)
    elif n < 16384:
        w.put(0b10, 2)
        w.put(n, 14)
    else:
        raise ValueError(f"fragmented lengths unsupported: {n}")


def get_general_length(r: BitReader) -> int:
    if r.get(1) == 0:
        return r.get(7)
    if r.get(1) == 0:
        return r.get(14)
    raise ValueError("fragmented length determinant")


def put_normally_small(w: BitWriter, n: int) -> None:
    """X.691 §10.6 normally-small non-negative whole number."""
    if n < 64:
        w.put(0, 1)
        w.put(n, 6)
    else:
        w.put(1, 1)
        put_general_length(w, (n.bit_length() + 7) // 8)
        w.put(n, 8 * ((n.bit_length() + 7) // 8))


def get_normally_small(r: BitReader) -> int:
    if r.get(1) == 0:
        return r.get(6)
    n_oct = get_general_length(r)
    return r.get(8 * n_oct)


# --- codecs ------------------------------------------------------------------


class Codec:
    def enc(self, w: BitWriter, v: Any) -> None:
        raise NotImplementedError

    def dec(self, r: BitReader) -> Any:
        raise NotImplementedError


class Int(Codec):
    """Constrained INTEGER (lo..hi), range <= 2^16: minimal bit-field."""

    def __init__(self, lo: int, hi: int):
        assert hi >= lo
        self.lo, self.hi = lo, hi
        rng = hi - lo + 1
        assert rng <= 1 << 16, "indefinite-length integers unsupported"
        self.bits = 0 if rng == 1 else (rng - 1).bit_length()

    def enc(self, w, v):
        assert self.lo <= int(v) <= self.hi, (v, self.lo, self.hi)
        w.put(int(v) - self.lo, self.bits)

    def dec(self, r):
        return r.get(self.bits) + self.lo


class Bool(Codec):
    def enc(self, w, v):
        w.put(1 if v else 0, 1)

    def dec(self, r):
        return bool(r.get(1))


class Enum(Codec):
    """ENUMERATED; names are the root enumeration in spec order. ext=True
    adds the extension bit; unknown extension values decode to '_extN'."""

    def __init__(self, *names: str, ext: bool = False):
        self.names = names
        self.ext = ext
        self.bits = 0 if len(names) == 1 else (len(names) - 1).bit_length()

    def enc(self, w, v):
        if self.ext:
            w.put(0, 1)
        w.put(self.names.index(v), self.bits)

    def dec(self, r):
        if self.ext and r.get(1):
            return f"_ext{get_normally_small(r)}"
        return self.names[r.get(self.bits)]


class BitStr(Codec):
    """Fixed-size BIT STRING (SIZE (n)), n <= 64; value is an int with the
    first bit as MSB (how 36.331 reads SFN/cellIdentity/etc.)."""

    def __init__(self, n: int):
        assert 0 < n <= 64
        self.n = n

    def enc(self, w, v):
        w.put(int(v), self.n)

    def dec(self, r):
        return r.get(self.n)


class OctetStr(Codec):
    """OCTET STRING: fixed (lo==hi), size-constrained, or unconstrained
    (general length determinant). Values are bytes."""

    def __init__(self, lo: int | None = None, hi: int | None = None):
        self.lo, self.hi = lo, hi

    def enc(self, w, v):
        v = bytes(v)
        if self.lo is not None and self.lo == self.hi:
            assert len(v) == self.lo
        elif self.lo is not None and self.hi is not None:
            Int(self.lo, self.hi).enc(w, len(v))
        else:
            put_general_length(w, len(v))
        w.put_bytes(v)

    def dec(self, r):
        if self.lo is not None and self.lo == self.hi:
            n = self.lo
        elif self.lo is not None and self.hi is not None:
            n = Int(self.lo, self.hi).dec(r)
        else:
            n = get_general_length(r)
        return r.get_bytes(n)


class _Field:
    __slots__ = ("name", "codec", "optional", "default")

    def __init__(self, spec):
        self.name, self.codec = spec[0], spec[1]
        self.optional = len(spec) > 2
        self.default = spec[3] if len(spec) > 3 else None


class Seq(Codec):
    """SEQUENCE. Field spec: (name, codec) mandatory,
    (name, codec, OPT) optional, (name, codec, OPT, default) DEFAULT.
    ext=True adds the extension bit; decoded extension additions are
    skipped (raw bytes kept under '_ext')."""

    def __init__(self, *fields, ext: bool = False):
        self.fields = [_Field(f) for f in fields]
        self.ext = ext

    def enc(self, w, v: dict):
        if self.ext:
            w.put(0, 1)  # we only ever emit the Rel-8 root
        for f in self.fields:
            if f.optional:
                val = v.get(f.name)
                present = val is not None and val != f.default
                w.put(1 if present else 0, 1)
        for f in self.fields:
            val = v.get(f.name)
            if f.optional and (val is None or val == f.default):
                continue
            try:
                f.codec.enc(w, val)
            except (AssertionError, KeyError, ValueError, TypeError) as e:
                raise ValueError(f"encoding field {f.name!r}: {e}") from e

    def dec(self, r) -> dict:
        extended = bool(r.get(1)) if self.ext else False
        present = {}
        for f in self.fields:
            present[f.name] = bool(r.get(1)) if f.optional else True
        out = {}
        for f in self.fields:
            if present[f.name]:
                out[f.name] = f.codec.dec(r)
            else:
                out[f.name] = f.default  # None for plain OPTIONAL
        if extended:
            n_ext = get_normally_small(r) + 1
            flags = [r.get(1) for _ in range(n_ext)]
            raws = []
            for fl in flags:
                if fl:
                    n = get_general_length(r)
                    raws.append(r.get_bytes(n))
            out["_ext"] = raws
        return out


class Choice(Codec):
    """CHOICE; value is ('altName', altValue). Unknown extension
    alternatives decode to ('_extN', raw_bytes)."""

    def __init__(self, *alts, ext: bool = False):
        self.alts = alts
        self.ext = ext
        self.bits = 0 if len(alts) == 1 else (len(alts) - 1).bit_length()

    def enc(self, w, v):
        name, val = v
        if self.ext:
            w.put(0, 1)
        idx = [a[0] for a in self.alts].index(name)
        w.put(idx, self.bits)
        try:
            self.alts[idx][1].enc(w, val)
        except (AssertionError, KeyError, ValueError, TypeError) as e:
            raise ValueError(f"encoding choice {name!r}: {e}") from e

    def dec(self, r):
        if self.ext and r.get(1):
            idx = get_normally_small(r)
            n = get_general_length(r)
            return (f"_ext{idx}", r.get_bytes(n))
        idx = r.get(self.bits)
        name, codec = self.alts[idx]
        return (name, codec.dec(r))


class SeqOf(Codec):
    """SEQUENCE (SIZE (lo..hi)) OF inner."""

    def __init__(self, inner: Codec, lo: int, hi: int):
        self.inner = inner
        self.len_codec = Int(lo, hi)

    def enc(self, w, v):
        self.len_codec.enc(w, len(v))
        for item in v:
            self.inner.enc(w, item)

    def dec(self, r):
        n = self.len_codec.dec(r)
        return [self.inner.dec(r) for _ in range(n)]


class Null(Codec):
    def enc(self, w, v):
        pass

    def dec(self, r):
        return None


class Contained(Codec):
    """An inner PDU carried as an OCTET STRING (CONTAINING ...): the inner
    encoding is wrapped with a general length determinant. Value is the
    inner codec's value."""

    def __init__(self, inner: Codec):
        self.inner = inner

    def enc(self, w, v):
        data = encode(self.inner, v)
        put_general_length(w, len(data))
        w.put_bytes(data)

    def dec(self, r):
        n = get_general_length(r)
        return decode(self.inner, r.get_bytes(n))


def encode(codec: Codec, value: Any) -> bytes:
    w = BitWriter()
    codec.enc(w, value)
    return w.to_bytes()


def decode(codec: Codec, data: bytes) -> Any:
    return codec.dec(BitReader(data))
