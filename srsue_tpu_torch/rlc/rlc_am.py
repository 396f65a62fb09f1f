"""The port's own copy of ``srsue_tpu/rlc/rlc_am.py`` (its reference), unchanged below this docstring.

RLC Acknowledged Mode — 36.322 §5.1.3/5.2 (reference:
ue/src/upper/rlc_am.cc, 887 LoC; state vars rlc_am.h:126-140).

Full ARQ: tx/retx windows (vt_a/vt_ms/vt_s, poll_sn), polling
(poll_pdu/poll_byte/t_poll_retransmit), STATUS PDUs with NACK_SN lists,
rx reordering (vr_r/vr_mr/vr_x/vr_ms/vr_h) with t_reordering and
t_status_prohibit, SDU segmentation/concatenation with LI headers,
max-retx notification to RRC.

AMD PDU header: D/C(1)=1 RF(1) P(1) FI(2) E(1) SN(10) = 2 bytes, then
12-bit E/LI extension pairs. STATUS PDU: D/C=0 CPT(3)=0 ACK_SN(10) E1,
then per-NACK: NACK_SN(10) E1 E2 (E2=0: no segment offsets; whole-PDU
retransmission — resegmentation is a flagged follow-up).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

MOD = 1024
AM_WINDOW = 512


def _sn_sub(a: int, b: int) -> int:
    return (a - b) % MOD


@dataclass
class AmConfig:
    t_poll_retx: int = 45
    poll_pdu: int = 4
    poll_byte: int = 3000
    max_retx_thresh: int = 8
    t_reordering: int = 35
    t_status_prohibit: int = 0


@dataclass
class _TxPdu:
    data: bytes  # full PDU (header + payload) as first transmitted
    retx_count: int = 0
    pending_retx: bool = False
    poll: bool = False
    # original segmentation structure (for re-segmentation on retx):
    pieces: tuple = ()  # lengths of the SDU pieces in the payload
    first_cont: bool = False
    last_partial: bool = False
    retx_offset: int = 0  # next SO to send when re-segmenting


def _pack_am_header(sn: int, fi: int, lis: list[int], poll: bool, rf: int = 0) -> bytes:
    out = bytearray()
    e = 1 if lis else 0
    out.append(
        (1 << 7) | ((rf & 1) << 6) | ((1 if poll else 0) << 5)
        | ((fi & 3) << 3) | (e << 2) | ((sn >> 8) & 3)
    )
    out.append(sn & 0xFF)
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


def _pack_am_segment_header(sn: int, fi: int, lis: list[int], poll: bool,
                            so: int, lsf: bool) -> bytes:
    """AMD PDU segment header: base header with RF=1 followed by
    LSF(1) | SO(15) (36.322 §6.2.1.5)."""
    base = _pack_am_header(sn, fi, lis, poll, rf=1)
    seg = bytes([((1 if lsf else 0) << 7) | ((so >> 8) & 0x7F), so & 0xFF])
    # SO bytes sit directly after the fixed 2-byte header, before LIs
    return base[:2] + seg + base[2:]


def _unpack_am_header(data: bytes):
    """Returns (dc, rf, poll, fi, sn, lis, header_len, lsf, so)."""
    b0 = data[0]
    dc = (b0 >> 7) & 1
    rf = (b0 >> 6) & 1
    p = (b0 >> 5) & 1
    fi = (b0 >> 3) & 3
    e = (b0 >> 2) & 1
    sn = ((b0 & 3) << 8) | data[1]
    pos = 2
    lsf, so = True, 0
    if rf:
        lsf = bool((data[2] >> 7) & 1)
        so = ((data[2] & 0x7F) << 8) | data[3]
        pos = 4
    lis = []
    bitpos = 0
    while e:
        byte0 = pos + bitpos // 8
        window = int.from_bytes(data[byte0 : byte0 + 3].ljust(3, b"\x00"), "big")
        shift = 24 - (bitpos % 8) - 12
        field12 = (window >> shift) & 0xFFF
        e = (field12 >> 11) & 1
        lis.append(field12 & 0x7FF)
        bitpos += 12
    pos += (bitpos + 7) // 8
    return dc, rf, p, fi, sn, lis, pos, lsf, so


def pack_status(ack_sn: int, nacks: list[int]) -> bytes:
    """D/C=0 CPT=000 ACK_SN(10) E1, then per NACK: NACK_SN(10) E1 E2."""
    bits = [0, 0, 0, 0]  # D/C + CPT
    for j in range(9, -1, -1):
        bits.append((ack_sn >> j) & 1)
    bits.append(1 if nacks else 0)
    for i, nsn in enumerate(nacks):
        for j in range(9, -1, -1):
            bits.append((nsn >> j) & 1)
        bits.append(1 if i < len(nacks) - 1 else 0)  # E1
        bits.append(0)  # E2
    while len(bits) % 8:
        bits.append(0)
    out = bytearray()
    for i in range(0, len(bits), 8):
        v = 0
        for b in bits[i : i + 8]:
            v = (v << 1) | b
        out.append(v)
    return bytes(out)


def unpack_status(data: bytes) -> tuple[int, list[int]]:
    bits = []
    for byte in data:
        for j in range(7, -1, -1):
            bits.append((byte >> j) & 1)
    pos = 4  # skip D/C + CPT
    ack_sn = 0
    for _ in range(10):
        ack_sn = (ack_sn << 1) | bits[pos]
        pos += 1
    e1 = bits[pos]
    pos += 1
    nacks = []
    while e1:
        nsn = 0
        for _ in range(10):
            nsn = (nsn << 1) | bits[pos]
            pos += 1
        e1 = bits[pos]
        pos += 1
        e2 = bits[pos]
        pos += 1
        nacks.append(nsn)
    return ack_sn, nacks


class RlcAm:
    def __init__(self, cfg: AmConfig | None = None, write_up=None, on_max_retx=None):
        self.cfg = cfg or AmConfig()
        self.write_up = write_up or (lambda b: None)
        self.on_max_retx = on_max_retx or (lambda: None)
        # TX state
        self.tx_sdus: deque[bytes] = deque()
        self._tx_partial: bytes | None = None
        self.vt_a = 0
        self.vt_s = 0
        self.poll_sn = 0
        self.pdu_without_poll = 0
        self.byte_without_poll = 0
        self.tx_window: dict[int, _TxPdu] = {}
        self.t_poll = 0
        self.poll_running = False
        self.status_requested = False
        # RX state
        self.rx_window: dict[int, tuple[int, list[int], bytes]] = {}
        self.vr_r = 0
        self.vr_x = 0
        self.vr_ms = 0
        self.vr_h = 0
        self.t_reord = 0
        self.reord_running = False
        self.t_status_prohibit = 0
        self.do_status = False
        self._reassembly = b""
        self._in_sdu = False
        self.rx_segments: dict[int, list] = {}
        self.metrics = {"tx_sdus": 0, "rx_sdus": 0, "retx": 0, "status_tx": 0}

    # ----------------------------------------------------------- PDCP side
    def write_sdu(self, sdu: bytes) -> None:
        self.tx_sdus.append(bytes(sdu))
        self.metrics["tx_sdus"] += 1

    # ------------------------------------------------------------ MAC side
    def get_buffer_state(self) -> int:
        n = 0
        if self.do_status and self.t_status_prohibit <= 0:
            n += 2 + 2 * max(1, len(self._nack_list()))
        for p in self.tx_window.values():
            if p.pending_retx:
                n += len(p.data)
        q = sum(len(s) for s in self.tx_sdus)
        if self._tx_partial:
            q += len(self._tx_partial)
        if q:
            q += 4
        return n + q

    def read_pdu(self, nof_bytes: int) -> bytes:
        # 1. STATUS if requested (rlc_am.cc:147-163 dispatch order)
        if self.do_status and self.t_status_prohibit <= 0:
            pdu = self._build_status()
            if len(pdu) <= nof_bytes:
                self.do_status = False
                self.t_status_prohibit = self.cfg.t_status_prohibit
                self.metrics["status_tx"] += 1
                return pdu
        # 2. retransmission (re-segmented when the grant is too small)
        for sn in sorted(self.tx_window, key=lambda s: _sn_sub(s, self.vt_a)):
            p = self.tx_window[sn]
            if not p.pending_retx:
                continue
            if len(p.data) <= nof_bytes:
                p.pending_retx = False
                p.retx_count += 1
                self.metrics["retx"] += 1
                if p.retx_count >= self.cfg.max_retx_thresh:
                    self.on_max_retx()
                return p.data
            seg = self._build_retx_segment(sn, p, nof_bytes)
            if seg:
                return seg
        # 3. new data PDU
        return self._build_data_pdu(nof_bytes)

    def _build_data_pdu(self, nof_bytes: int) -> bytes:
        if _sn_sub(self.vt_s, self.vt_a) >= AM_WINDOW:
            return b""  # window stalled
        if not self.tx_sdus and self._tx_partial is None:
            return b""
        hdr_min = 2
        if nof_bytes <= hdr_min + 1:
            return b""
        segs: list[bytes] = []
        first_cont = self._tx_partial is not None
        space = nof_bytes - hdr_min
        li_cost = 0
        last_partial = False
        while space - li_cost > 0:
            src = self._tx_partial if self._tx_partial is not None else (
                self.tx_sdus[0] if self.tx_sdus else None
            )
            if src is None:
                break
            extra_li = 0 if not segs else 2
            avail = space - li_cost - extra_li
            if avail <= 0:
                break
            take = min(len(src), avail)
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
                last_partial = True
                break
            if self._tx_partial is not None:
                self._tx_partial = None
            else:
                self.tx_sdus.popleft()
        if not segs:
            return b""
        payload = b"".join(segs)
        self.pdu_without_poll += 1
        self.byte_without_poll += len(payload)
        poll = self._check_poll()
        fi = (2 if first_cont else 0) | (1 if last_partial else 0)
        lis = [len(s) for s in segs[:-1]]
        hdr = _pack_am_header(self.vt_s, fi, lis, poll)
        pdu = hdr + payload
        self.tx_window[self.vt_s] = _TxPdu(
            pdu, poll=poll, pieces=tuple(len(s) for s in segs),
            first_cont=first_cont, last_partial=last_partial,
        )
        if poll:
            self.poll_sn = self.vt_s
            self.t_poll = 0
            self.poll_running = True
        self.vt_s = (self.vt_s + 1) % MOD
        return pdu

    def _build_retx_segment(self, sn: int, p: _TxPdu, nof_bytes: int) -> bytes:
        """AMD PDU segment (RF=1, SO/LSF) re-segmentation — 36.322 §5.2.1.
        Sends the next chunk of the original payload sized to the grant,
        with FI/LI recomputed for the chunk's own SDU-piece structure."""
        # original payload = data minus its header
        _, _, _, _, _, _, hlen, _, _ = _unpack_am_header(p.data)
        payload = p.data[hlen:]
        so = p.retx_offset
        # worst-case segment header: 4 bytes fixed + LIs (~2/piece)
        space = nof_bytes - 6
        if space < 1 or so >= len(payload):
            return b""
        chunk = payload[so : so + space]
        lsf = so + len(chunk) >= len(payload)
        # recompute piece boundaries inside [so, so+len(chunk))
        bounds = []
        pos = 0
        for ln in p.pieces:
            bounds.append((pos, pos + ln))
            pos += ln
        lis = []
        first_cont = bool(p.first_cont) if so == 0 else True
        last_partial = bool(p.last_partial) if lsf else True
        # refine: first_cont if so does not start at a piece boundary OR
        # the piece it starts in was itself a continuation
        for a, b in bounds:
            if a == so:
                first_cont = p.first_cont if a == 0 else False
            if a < so < b:
                first_cont = True
        end = so + len(chunk)
        for a, b in bounds:
            if b == end:
                last_partial = p.last_partial if b == len(payload) else False
            if a < end < b:
                last_partial = True
        # LIs: piece boundaries strictly inside the chunk
        cur = so
        for a, b in bounds:
            if so < b < end:
                lis.append(b - cur)
                cur = b
        fi = (2 if first_cont else 0) | (1 if last_partial else 0)
        hdr = _pack_am_segment_header(sn, fi, lis, False, so, lsf)
        if len(hdr) + len(chunk) > nof_bytes:
            chunk = chunk[: nof_bytes - len(hdr)]
            lsf = so + len(chunk) >= len(payload)
            hdr = _pack_am_segment_header(sn, fi | 1, lis, False, so, lsf)
        p.retx_offset = so + len(chunk)
        if lsf:
            p.pending_retx = False
            p.retx_offset = 0
            p.retx_count += 1
            self.metrics["retx"] += 1
            if p.retx_count >= self.cfg.max_retx_thresh:
                self.on_max_retx()
        return hdr + chunk

    def _check_poll(self) -> bool:
        if (
            self.pdu_without_poll >= self.cfg.poll_pdu
            or self.byte_without_poll >= self.cfg.poll_byte
            or (not self.tx_sdus and self._tx_partial is None)
        ):
            self.pdu_without_poll = 0
            self.byte_without_poll = 0
            return True
        return False

    def write_pdu(self, pdu: bytes) -> None:
        if not pdu:
            return
        if (pdu[0] >> 7) & 1:
            self._handle_data(pdu)
        else:
            self._handle_status(pdu)

    # ----------------------------------------------------------- RX side
    def _handle_data(self, pdu: bytes) -> None:
        dc, rf, p, fi, sn, lis, hlen, lsf, so = _unpack_am_header(pdu)
        if p:
            self.do_status = True
        if _sn_sub(sn, self.vr_r) >= AM_WINDOW:
            return  # outside rx window: discard (duplicate of delivered)
        if rf:
            merged = self._collect_segment(sn, fi, lis, pdu[hlen:], so, lsf)
            if merged is None:
                return
            fi, lis, payload = merged
            self.rx_window[sn] = (fi, lis, payload)
        else:
            self.rx_window[sn] = (fi, lis, pdu[hlen:])
        if _sn_sub(sn, self.vr_h) < AM_WINDOW:
            if _sn_sub(sn, self.vr_h) >= 0 and sn != self.vr_h:
                pass
        if _sn_sub(self.vr_h, sn) > AM_WINDOW:
            self.vr_h = (sn + 1) % MOD
        elif _sn_sub(sn, self.vr_h) < AM_WINDOW and _sn_sub(sn, self.vr_h) >= 0:
            self.vr_h = (sn + 1) % MOD
        # deliver in-order
        while self.vr_r in self.rx_window:
            fi_, lis_, payload = self.rx_window[self.vr_r]
            self._reassemble(fi_, lis_, payload)
            self.vr_r = (self.vr_r + 1) % MOD
        self.vr_ms = self.vr_r
        # reordering timer management (36.322 §5.1.3.2.3)
        if self.vr_h != self.vr_r and not self.reord_running:
            self.reord_running = True
            self.t_reord = 0
            self.vr_x = self.vr_h

    def _collect_segment(self, sn, fi, lis, payload, so, lsf):
        """Buffer AMD PDU segments; when [0, total) is covered, merge into
        one (fi, lis, payload) triple. Returns None while incomplete."""
        segs = self.rx_segments.setdefault(sn, [])
        segs.append((so, lsf, fi, lis, bytes(payload)))
        segs.sort(key=lambda t: t[0])
        total = None
        for s0, l, _, _, pl in segs:
            if l:
                total = s0 + len(pl)
        if total is None:
            return None
        cover = 0
        for s0, _, _, _, pl in segs:
            if s0 > cover:
                return None
            cover = max(cover, s0 + len(pl))
        if cover < total:
            return None
        # merge: split each segment into pieces, joining across boundaries
        pieces: list[bytes] = []
        open_piece = False
        consumed = 0
        for s0, l, sfi, slis, pl in segs:
            if s0 + len(pl) <= consumed:
                continue  # full duplicate
            pl = pl[consumed - s0 :]
            sub = []
            pos = 0
            for li in slis:
                sub.append(pl[pos : pos + li])
                pos += li
            sub.append(pl[pos:])
            s_first_cont = bool(sfi & 2)
            s_last_partial = bool(sfi & 1)
            for i, piece in enumerate(sub):
                if i == 0 and s_first_cont and open_piece and pieces:
                    pieces[-1] += piece
                else:
                    pieces.append(piece)
                open_piece = (i == len(sub) - 1) and s_last_partial
            consumed = s0 + len(pl)
        first_cont = bool(segs[0][2] & 2)
        last_partial = bool(segs[-1][2] & 1)
        del self.rx_segments[sn]
        out_fi = (2 if first_cont else 0) | (1 if last_partial else 0)
        out_lis = [len(p) for p in pieces[:-1]]
        return out_fi, out_lis, b"".join(pieces)

    def _nack_list(self) -> list[int]:
        nacks = []
        sn = self.vr_r
        while sn != self.vr_h:
            if sn not in self.rx_window and _sn_sub(sn, self.vr_r) < AM_WINDOW:
                nacks.append(sn)
            sn = (sn + 1) % MOD
            if len(nacks) > 16:
                break
        return nacks

    def _build_status(self) -> bytes:
        return pack_status(self.vr_ms if not self._nack_list() else self.vr_h,
                           self._nack_list())

    def _handle_status(self, pdu: bytes) -> None:
        ack_sn, nacks = unpack_status(pdu)
        # positive ack: everything < ack_sn except NACKed
        sn = self.vt_a
        while sn != ack_sn:
            if sn in self.tx_window and sn not in nacks:
                del self.tx_window[sn]
            sn = (sn + 1) % MOD
        for nsn in nacks:
            if nsn in self.tx_window:
                self.tx_window[nsn].pending_retx = True
        # advance vt_a to oldest outstanding
        while self.vt_a != self.vt_s and self.vt_a not in self.tx_window:
            self.vt_a = (self.vt_a + 1) % MOD
        if self.poll_running and _sn_sub(ack_sn, self.poll_sn) > 0:
            self.poll_running = False

    def _reassemble(self, fi: int, lis: list[int], payload: bytes) -> None:
        parts = []
        pos = 0
        for li in lis:
            parts.append(payload[pos : pos + li])
            pos += li
        parts.append(payload[pos:])
        first_cont = bool(fi & 2)
        last_partial = bool(fi & 1)
        for i, part in enumerate(parts):
            is_last = i == len(parts) - 1
            if i == 0 and first_cont and self._in_sdu:
                self._reassembly += part
            else:
                self._reassembly = part
                self._in_sdu = True
            if is_last and last_partial:
                pass  # wait for continuation
            else:
                self.write_up(self._reassembly)
                self.metrics["rx_sdus"] += 1
                self._reassembly = b""
                self._in_sdu = False

    # ----------------------------------------------------------- timers
    def step_timers(self) -> None:
        if self.t_status_prohibit > 0:
            self.t_status_prohibit -= 1
        if self.reord_running:
            self.t_reord += 1
            if self.t_reord >= self.cfg.t_reordering:
                self.reord_running = False
                self.do_status = True
                if self.vr_h != self.vr_r:
                    self.reord_running = True
                    self.t_reord = 0
                    self.vr_x = self.vr_h
        if self.poll_running:
            self.t_poll += 1
            if self.t_poll >= self.cfg.t_poll_retx:
                self.poll_running = False
                sn_prev = (self.vt_s - 1) % MOD
                if sn_prev in self.tx_window:
                    self.tx_window[sn_prev].pending_retx = True

    def reestablish(self) -> None:
        cfg, wu, omr = self.cfg, self.write_up, self.on_max_retx
        self.__init__(cfg, wu, omr)
