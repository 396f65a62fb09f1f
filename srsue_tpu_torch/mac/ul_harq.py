"""UL HARQ entity, 36.321 5.4.2. The port's own copy of
``srsue_tpu/mac/ul_harq.py`` (its reference).

8 synchronous processes, pid = f(tti_tx) with the 4 ms grant-to-transmit
offset; RV sequence {0, 2, 3, 1}; non-adaptive and adaptive
retransmission; Msg3's own retransmission limit; reaching the limit
flushes the process.
"""

from __future__ import annotations

from dataclasses import dataclass

RV_SEQ = (0, 2, 3, 1)
N_HARQ_PROC = 8
HARQ_DELAY = 4  # FDD: grant at tti -> transmission at tti + 4


def pid_of_tti(tti_tx: int) -> int:
    return tti_tx % N_HARQ_PROC


@dataclass
class _UlProc:
    payload: bytes | None = None
    n_retx: int = 0
    current_irv: int = 0
    is_msg3: bool = False
    ndi: bool | None = None  # the last grant's NDI (a toggle is a new TB)


class UlHarq:
    def __init__(self, max_retx: int = 5, max_msg3_retx: int = 5):
        self.procs = [_UlProc() for _ in range(N_HARQ_PROC)]
        self.max_retx = max_retx
        self.max_msg3_retx = max_msg3_retx
        self.metrics = {"tx_ok": 0, "tx_ko": 0, "retx": 0, "tx_brate": 0}

    def reset(self) -> None:
        for p in self.procs:
            p.payload = None
            p.n_retx = 0
            p.current_irv = 0

    def new_tx(self, tti_tx: int, payload: bytes, is_msg3: bool = False,
               ndi: bool | None = None) -> int:
        """Start a new transmission; returns its rv (always 0)."""
        p = self.procs[pid_of_tti(tti_tx)]
        p.payload, p.n_retx, p.current_irv = payload, 0, 0
        p.is_msg3, p.ndi = is_msg3, ndi
        self.metrics["tx_brate"] += 8 * len(payload)
        return RV_SEQ[0]

    def is_new_tx(self, tti_tx: int, ndi: bool | None) -> bool:
        """New-transmission detection for a granted pid: a toggled NDI, or
        nothing sent yet, is a new TB."""
        p = self.procs[pid_of_tti(tti_tx)]
        if p.payload is None:
            return True
        if ndi is None:
            return False
        return p.ndi is None or ndi != p.ndi

    def retx(self, tti_tx: int, adaptive_rv: int | None = None) -> tuple[bytes, int] | None:
        """The retransmission of tti_tx's process: non-adaptive advances the
        RV sequence, adaptive takes the DCI's rv. (payload, rv), or None once
        the retransmission limit is reached (the process is flushed)."""
        p = self.procs[pid_of_tti(tti_tx)]
        if p.payload is None:
            return None
        limit = self.max_msg3_retx if p.is_msg3 else self.max_retx
        if p.n_retx + 1 >= limit:
            p.payload = None
            self.metrics["tx_ko"] += 1
            return None
        p.n_retx += 1
        self.metrics["retx"] += 1
        if adaptive_rv is None:
            p.current_irv = (p.current_irv + 1) % 4
            rv = RV_SEQ[p.current_irv]
        else:
            rv = adaptive_rv
            p.current_irv = RV_SEQ.index(rv) if rv in RV_SEQ else p.current_irv
        return p.payload, rv

    def harq_feedback(self, tti_tx: int, ack: bool) -> None:
        """PHICH feedback for the transmission made at tti_tx."""
        p = self.procs[pid_of_tti(tti_tx)]
        if ack and p.payload is not None:
            p.payload = None
            p.n_retx = 0
            self.metrics["tx_ok"] += 1

    def has_pending(self, tti_tx: int) -> bool:
        return self.procs[pid_of_tti(tti_tx)].payload is not None
