"""The port's own copy of ``srsue_tpu/rlc/rlc_um.py`` (its reference), unchanged below this docstring.

RLC Unacknowledged Mode — 36.322 §5.1.2 (reference: ue/src/upper/rlc_um.cc).

Segmentation/concatenation with 5- or 10-bit SN, FI flags and LI
extension headers; RX reordering window with t_reordering; SDU reassembly
(rlc_um.cc:205-617 behaviors).

UM PDU header (10-bit SN): FI(2) E(1) SN(10) padded to 2 bytes; 5-bit SN:
FI(2) E(1) SN(5) = 1 byte. E-extensions: E(1) LI(11) pairs, 12 bits each.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class UmConfig:
    sn_bits: int = 10  # 5 or 10
    t_reordering: int = 45  # TTIs
    rx_window: int | None = None  # default: 2^(sn)/2

    @property
    def mod(self) -> int:
        return 1 << self.sn_bits

    @property
    def window(self) -> int:
        return self.rx_window if self.rx_window is not None else self.mod // 2


def _pack_header(sn: int, fi: int, lis: list[int], sn_bits: int) -> bytes:
    out = bytearray()
    e = 1 if lis else 0
    if sn_bits == 5:
        out.append(((fi & 3) << 6) | (e << 5) | (sn & 0x1F))
    else:
        out.append(((fi & 3) << 3) | (e << 2) | ((sn >> 8) & 3))
        out.append(sn & 0xFF)
    # LI extensions: 12-bit fields packed
    bits = []
    for i, li in enumerate(lis):
        e_next = 1 if i < len(lis) - 1 else 0
        bits.append(e_next)
        for j in range(10, -1, -1):
            bits.append((li >> j) & 1)
    while len(bits) % 8:
        bits.append(0)
    for i in range(0, len(bits), 8):
        v = 0
        for b in bits[i : i + 8]:
            v = (v << 1) | b
        out.append(v)
    return bytes(out)


def _unpack_header(data: bytes, sn_bits: int) -> tuple[int, int, list[int], int]:
    """Returns (sn, fi, LIs, header_len)."""
    if sn_bits == 5:
        b0 = data[0]
        fi = (b0 >> 6) & 3
        e = (b0 >> 5) & 1
        sn = b0 & 0x1F
        pos = 1
    else:
        b0, b1 = data[0], data[1]
        fi = (b0 >> 3) & 3
        e = (b0 >> 2) & 1
        sn = ((b0 & 3) << 8) | b1
        pos = 2
    lis = []
    bitpos = 0
    while e:
        # read 12 bits at bit offset
        byte0 = pos + bitpos // 8
        window = int.from_bytes(data[byte0 : byte0 + 3].ljust(3, b"\x00"), "big")
        shift = 24 - (bitpos % 8) - 12
        field12 = (window >> shift) & 0xFFF
        e = (field12 >> 11) & 1
        lis.append(field12 & 0x7FF)
        bitpos += 12
    pos += (bitpos + 7) // 8
    return sn, fi, lis, pos


class RlcUm:
    def __init__(self, cfg: UmConfig | None = None, write_up=None):
        self.cfg = cfg or UmConfig()
        self.write_up = write_up or (lambda b: None)
        # TX
        self.tx_sdus: deque[bytes] = deque()
        self.vt_us = 0
        self._tx_partial: bytes | None = None  # remainder of a split SDU
        # RX
        self.rx_pdus: dict[int, tuple[int, list[int], bytes]] = {}
        self.vr_ur = 0  # earliest SN still considered for reordering
        self.vr_uh = 0  # highest received + 1
        self.t_reordering = 0
        self.reordering_running = False
        self.vr_ux = 0
        self._reassembly: bytes = b""
        self._expect_sn: int | None = None
        self.metrics = {"tx_sdus": 0, "rx_sdus": 0, "lost_pdus": 0,
                        "dropped_pdus": 0}

    # --- PDCP side ---------------------------------------------------------
    def write_sdu(self, sdu: bytes) -> None:
        self.tx_sdus.append(bytes(sdu))
        self.metrics["tx_sdus"] += 1

    # --- MAC side ----------------------------------------------------------
    def get_buffer_state(self) -> int:
        n = sum(len(s) for s in self.tx_sdus)
        if self._tx_partial:
            n += len(self._tx_partial)
        if n:
            n += 3  # worst-case header estimate
        return n

    def read_pdu(self, nof_bytes: int) -> bytes:
        """Build one UMD PDU up to nof_bytes (segmentation happens HERE,
        sized to the grant — rlc.cc pull-model semantics)."""
        hdr_min = 1 if self.cfg.sn_bits == 5 else 2
        if nof_bytes <= hdr_min:
            return b""
        if not self.tx_sdus and not self._tx_partial:
            return b""

        segs: list[bytes] = []
        first_is_continuation = self._tx_partial is not None
        space = nof_bytes - hdr_min
        li_cost = 0

        def room() -> int:
            return space - li_cost

        last_is_partial = False
        while room() > 0:
            src = self._tx_partial if self._tx_partial is not None else (
                self.tx_sdus[0] if self.tx_sdus else None
            )
            if src is None:
                break
            extra_li = 0 if not segs else 2  # ~1.5B per LI, round up
            if room() - extra_li <= 0:
                break
            take = min(len(src), room() - extra_li)
            if take <= 0:
                break
            segs.append(src[:take])
            li_cost += extra_li
            space -= take
            if take < len(src):
                rest = src[take:]
                if self._tx_partial is not None:
                    self._tx_partial = rest
                else:
                    self.tx_sdus.popleft()
                    self._tx_partial = rest
                last_is_partial = True
                break
            else:
                if self._tx_partial is not None:
                    self._tx_partial = None
                else:
                    self.tx_sdus.popleft()

        if not segs:
            return b""
        fi = (2 if first_is_continuation else 0) | (1 if last_is_partial else 0)
        lis = [len(s) for s in segs[:-1]]
        hdr = _pack_header(self.vt_us, fi, lis, self.cfg.sn_bits)
        self.vt_us = (self.vt_us + 1) % self.cfg.mod
        return hdr + b"".join(segs)

    def _dist(self, x: int, base: int) -> int:
        return (x - base) % self.cfg.mod

    def write_pdu(self, pdu: bytes) -> None:
        """RX path: full 36.322 §5.1.2.2.2-3 receive window (reference:
        rlc_um.cc:304-366 handle_data_pdu). Duplicate and stale PDUs are
        discarded; an arrival outside the reordering window pushes VR_UH
        and may force VR_UR forward (so a wrapped SN can never be
        mistaken for an older one, the 5-bit-SN edge case)."""
        sn, fi, lis, hlen = _unpack_header(pdu, self.cfg.sn_bits)
        mod, w = self.cfg.mod, self.cfg.window
        lower = (self.vr_uh - w) % mod
        i_x = self._dist(sn, lower)
        i_ur = self._dist(self.vr_ur, lower)
        i_uh = self._dist(self.vr_uh, lower)
        # §5.1.2.2.2 discard: duplicate inside (VR_UR, VR_UH), or SN in
        # [VR_UH - window, VR_UR) i.e. already delivered/skipped
        if (i_ur < i_x < i_uh and sn in self.rx_pdus) or i_x < i_ur:
            self.metrics["dropped_pdus"] += 1
            return
        self.rx_pdus[sn] = (fi, lis, pdu[hlen:])
        # §5.1.2.2.3: SN outside the reordering window pushes VR_UH
        if i_x >= i_uh:
            self.vr_uh = (sn + 1) % mod
            new_lower = (self.vr_uh - w) % mod
            if self._dist(self.vr_ur, new_lower) >= w:
                # VR_UR fell out of the window: deliver/skip up to the
                # new lower edge
                self._deliver_up_to(new_lower)
        if self.vr_ur in self.rx_pdus:
            # advance VR_UR past the received run
            target = self.vr_ur
            while target in self.rx_pdus:
                target = (target + 1) % mod
            self._deliver_up_to(target)
        self._update_timer_state()

    def _deliver_up_to(self, target: int) -> None:
        """Move VR_UR to ``target``, reassembling received PDUs in SN
        order and dropping reassembly state across gaps."""
        while self.vr_ur != target:
            if self.vr_ur in self.rx_pdus:
                fi, lis, payload = self.rx_pdus.pop(self.vr_ur)
                self._reassemble(fi, lis, payload)
            else:
                # gap: any partially reassembled SDU is unrecoverable
                self.metrics["lost_pdus"] += 1
                self._reassembly = b""
                self._expect_sn = None
            self.vr_ur = (self.vr_ur + 1) % self.cfg.mod

    def _update_timer_state(self) -> None:
        """36.322 §5.1.2.2.3 t_reordering start/stop conditions."""
        if self.reordering_running:
            lower = (self.vr_uh - self.cfg.window) % self.cfg.mod
            i_ux = self._dist(self.vr_ux, lower)
            i_ur = self._dist(self.vr_ur, lower)
            if i_ux <= i_ur or (i_ux > self.cfg.window
                                and self.vr_ux != self.vr_uh):
                self.reordering_running = False
        if not self.reordering_running and self.vr_uh != self.vr_ur:
            self.reordering_running = True
            self.t_reordering = 0
            self.vr_ux = self.vr_uh

    def step_timers(self) -> None:
        """§5.1.2.2.4 t_reordering expiry: advance VR_UR to the first
        not-received SN at/after VR_UX, delivering what arrived."""
        if not self.reordering_running:
            return
        self.t_reordering += 1
        if self.t_reordering < self.cfg.t_reordering:
            return
        self.reordering_running = False
        target = self.vr_ux
        while target in self.rx_pdus:
            target = (target + 1) % self.cfg.mod
        self._deliver_up_to(target)
        if self.vr_uh != self.vr_ur:
            self.reordering_running = True
            self.t_reordering = 0
            self.vr_ux = self.vr_uh

    def _reassemble(self, fi: int, lis: list[int], payload: bytes) -> None:
        """FI: bit1 = first byte is NOT an SDU start; bit0 = last byte is
        NOT an SDU end."""
        parts: list[bytes] = []
        pos = 0
        for li in lis:
            parts.append(payload[pos : pos + li])
            pos += li
        parts.append(payload[pos:])

        first_cont = bool(fi & 2)
        last_partial = bool(fi & 1)

        for i, part in enumerate(parts):
            is_first = i == 0
            is_last = i == len(parts) - 1
            if is_first and first_cont:
                if self._expect_sn is not None:
                    self._reassembly += part
                else:
                    continue  # orphan continuation: drop
            else:
                if self._reassembly:
                    # previous SDU never completed -> drop it
                    self._reassembly = b""
                self._reassembly = part
            if is_last and last_partial:
                self._expect_sn = 0  # marker: awaiting continuation
            else:
                if self._reassembly:
                    self.write_up(self._reassembly)
                    self.metrics["rx_sdus"] += 1
                self._reassembly = b""
                self._expect_sn = None

    def reestablish(self) -> None:
        self.__init__(self.cfg, self.write_up)
