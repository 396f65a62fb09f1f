"""DL HARQ entity, 36.321 5.3.2. Counterpart of ``srsue_tpu/mac/dl_harq.py``.

8 HARQ processes + a dedicated BCCH process: NDI-toggle new-transmission
detection, softbuffer management, ACK generation. The softbuffer is the
list of LLR tensors produced by ``PdschCodec.dematch`` on the codec's
device; combining across retransmissions is element-wise addition there,
and only the decoded payload and the CRC verdict come to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..phy.cell import DlGrant
from ..phy.pdsch import PdschCodec
from ..utils.device import to_host
from .pdu import bits_to_bytes

N_HARQ_PROC = 8
BCCH_PID = -1


@dataclass
class _Proc:
    ndi: bool | None = None
    tbs: int = 0
    softbuffers: list | None = None
    decoded: bool = False
    payload: bytes | None = None


class DlHarq:
    """Per-cell DL HARQ entity.

    deliver(pid, payload_bytes) is the demux handoff."""

    def __init__(self, deliver: Callable[[int, bytes], None]):
        self.procs: dict[int, _Proc] = {p: _Proc() for p in range(N_HARQ_PROC)}
        self.procs[BCCH_PID] = _Proc()
        self.deliver = deliver
        self.metrics = {"rx_ok": 0, "rx_ko": 0, "rx_brate": 0}

    def reset(self) -> None:
        for p in self.procs.values():
            p.ndi = None
            p.softbuffers = None
            p.decoded = False

    def new_grant_dl(self, pid: int, grant: DlGrant) -> bool:
        """True if this is a NEW transmission (softbuffer reset), False for
        a retransmission (buffer kept for combining)."""
        p = self.procs[pid]
        if pid == BCCH_PID:  # RV-cycled; the caller manages epochs
            is_new = p.tbs != grant.tbs
        else:
            is_new = p.ndi is None or grant.ndi != p.ndi or p.tbs != grant.tbs
        if is_new:
            p.softbuffers = None
            p.decoded = False
            p.payload = None
        p.ndi = grant.ndi
        p.tbs = grant.tbs
        return is_new

    def tb_decoded(self, pid: int, codec: PdschCodec, softbuffers: list) -> bool:
        """Combine this transmission's dematched buffers into the process
        softbuffer, decode, and deliver on CRC pass. Returns ACK."""
        p = self.procs[pid]
        if p.decoded:
            return True  # already delivered; just re-ACK
        if p.softbuffers is None:
            p.softbuffers = softbuffers
        else:
            p.softbuffers = [a + b for a, b in zip(p.softbuffers, softbuffers)]
        payload, tb_ok, _, iters = codec.decode_softbuffers(p.softbuffers)
        ok = bool(to_host(tb_ok).all())
        self.metrics["last_iters"] = float(to_host(iters).mean())
        if ok:
            p.decoded = True
            p.payload = bits_to_bytes(to_host(payload).astype(np.uint8).reshape(-1))
            self.deliver(pid, p.payload)
            self.metrics["rx_ok"] += 1
            self.metrics["rx_brate"] += p.tbs
        else:
            self.metrics["rx_ko"] += 1
        return ok
