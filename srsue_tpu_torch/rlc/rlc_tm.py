"""The port's own copy of ``srsue_tpu/rlc/rlc_tm.py`` (its reference), unchanged below this docstring.

RLC Transparent Mode (SRB0/CCCH) — pass-through queue
(reference: ue/src/upper/rlc_tm.cc)."""

from __future__ import annotations

from collections import deque


class RlcTm:
    def __init__(self, write_up=None):
        self.tx = deque()
        self.write_up = write_up or (lambda b: None)

    # PDCP/RRC side
    def write_sdu(self, sdu: bytes) -> None:
        self.tx.append(bytes(sdu))

    # MAC side
    def get_buffer_state(self) -> int:
        return sum(len(s) for s in self.tx)

    def read_pdu(self, n: int) -> bytes:
        if not self.tx or len(self.tx[0]) > n:
            return b""
        return self.tx.popleft()

    def write_pdu(self, pdu: bytes) -> None:
        self.write_up(pdu)

    def reestablish(self) -> None:
        self.tx.clear()
