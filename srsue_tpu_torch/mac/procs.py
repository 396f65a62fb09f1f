"""The port's own copy of ``srsue_tpu/mac/procs.py`` (its reference), unchanged below this docstring.

MAC procedures: BSR, SR, PHR — 36.321 §5.4.4/§5.4.5/§5.4.6
(reference: ue/src/mac/proc_bsr.cc, proc_sr.cc, proc_phr.cc).

TTI-stepped host state machines, mirroring the reference's step(tti)
pattern (mac.cc:142-213): MAC's run loop calls step() once per TTI.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from . import pdu as pdu_mod


class BsrProc:
    """Buffer status reporting: LCG mapping, regular/periodic/padding BSR
    (proc_bsr.cc:161-343)."""

    def __init__(
        self,
        get_buffer_state: Callable[[int], int],
        periodic_timer: int = 0,
        retx_timer: int = 2560,
    ):
        self.get_buffer_state = get_buffer_state
        self.lcg_of: dict[int, int] = {}
        self.priority_of: dict[int, int] = {}
        self.periodic_timer = periodic_timer
        self.retx_timer = retx_timer
        self._periodic_cnt = 0
        self._retx_cnt = 0
        self._last_nonzero: set[int] = set()
        self.triggered: bool = False
        self.sr_needed: bool = False

    def set_lcg(self, lcid: int, lcg: int, priority: int = 1) -> None:
        self.lcg_of[lcid] = lcg
        self.priority_of[lcid] = priority

    def _lcg_bytes(self) -> list[int]:
        out = [0, 0, 0, 0]
        for lcid, lcg in self.lcg_of.items():
            out[lcg] += self.get_buffer_state(lcid)
        return out

    def step(self, tti: int) -> None:
        nonzero = {l for l in self.lcg_of if self.get_buffer_state(l) > 0}
        # regular BSR: data arrives for a channel with higher priority than
        # any currently-buffered channel (or any data after empty)
        new = nonzero - self._last_nonzero
        if new:
            if not self._last_nonzero:
                self.triggered = True
                self.sr_needed = True
            else:
                cur_best = min(
                    self.priority_of.get(l, 99) for l in self._last_nonzero
                )
                if any(self.priority_of.get(l, 99) < cur_best for l in new):
                    self.triggered = True
                    self.sr_needed = True
        self._last_nonzero = nonzero
        if self.periodic_timer and nonzero:
            self._periodic_cnt += 1
            if self._periodic_cnt >= self.periodic_timer:
                self._periodic_cnt = 0
                self.triggered = True

    def generate_bsr(self) -> tuple[int, bytes] | None:
        """Returns (lcid, CE payload) for inclusion in the next UL PDU."""
        lcg = self._lcg_bytes()
        n_groups = sum(1 for g in lcg if g > 0)
        self.triggered = False
        self.sr_needed = False
        if n_groups == 0:
            return pdu_mod.LCID_SHORT_BSR, pdu_mod.make_ce_short_bsr(0, 0)
        if n_groups <= 1:
            g = next(i for i, v in enumerate(lcg) if v > 0)
            return pdu_mod.LCID_SHORT_BSR, pdu_mod.make_ce_short_bsr(
                g, pdu_mod.bsr_index(lcg[g])
            )
        return pdu_mod.LCID_LONG_BSR, pdu_mod.make_ce_long_bsr(
            [pdu_mod.bsr_index(v) for v in lcg]
        )

    def generate_padding_bsr(self, space_bytes: int) -> tuple[int, bytes] | None:
        """Padding BSR (36.321 §5.4.5, proc_bsr.cc:310
        generate_padding_bsr): when the UL PDU has room left over,

        * >= 4 bytes (subheader + 3): long BSR,
        * >= 2 bytes with a single non-empty LCG: short BSR,
        * >= 2 bytes with several LCGs: TRUNCATED BSR of the
          highest-priority LCG with data.
        Padding BSRs do not clear the regular-BSR trigger."""
        lcg = self._lcg_bytes()
        n_groups = sum(1 for g in lcg if g > 0)
        if space_bytes >= 4:
            return pdu_mod.LCID_LONG_BSR, pdu_mod.make_ce_long_bsr(
                [pdu_mod.bsr_index(v) for v in lcg]
            )
        if space_bytes < 2:
            return None
        if n_groups <= 1:
            g = next((i for i, v in enumerate(lcg) if v > 0), 0)
            return pdu_mod.LCID_SHORT_BSR, pdu_mod.make_ce_short_bsr(
                g, pdu_mod.bsr_index(lcg[g])
            )
        # several groups, room for one: truncated BSR of the
        # highest-priority logical channel's group
        best_lcid = min(
            (l for l in self.lcg_of if self.get_buffer_state(l) > 0),
            key=lambda l: self.priority_of.get(l, 99),
        )
        g = self.lcg_of[best_lcid]
        return pdu_mod.LCID_TRUNC_BSR, pdu_mod.make_ce_short_bsr(
            g, pdu_mod.bsr_index(lcg[g])
        )


class SrProc:
    """Scheduling request on PUCCH with sr-TransMax escalation to RA
    (proc_sr.cc, consumed at mac.cc:180-183)."""

    def __init__(self, sr_trans_max: int = 64):
        self.sr_trans_max = sr_trans_max
        self.pending = False
        self.sr_counter = 0
        self.ra_needed = False

    def start(self) -> None:
        self.pending = True
        self.sr_counter = 0

    def reset(self) -> None:
        self.pending = False
        self.sr_counter = 0
        self.ra_needed = False

    def step(self, tti: int, sr_opportunity: bool) -> bool:
        """Returns True if an SR should be transmitted this TTI."""
        if not self.pending or not sr_opportunity:
            return False
        if self.sr_counter >= self.sr_trans_max:
            self.ra_needed = True
            self.pending = False
            return False
        self.sr_counter += 1
        return True


class PhrProc:
    """Power headroom reporting: periodic + prohibit timers + pathloss
    change trigger (proc_phr.cc, consumed at mux.cc:180)."""

    def __init__(
        self,
        periodic_timer: int = 1000,
        prohibit_timer: int = 100,
        dl_pathloss_change_db: float = 3.0,
    ):
        self.periodic_timer = periodic_timer
        self.prohibit_timer = prohibit_timer
        self.dl_pathloss_change = dl_pathloss_change_db
        self._periodic_cnt = 0
        self._prohibit_cnt = 0
        self._last_pathloss: float | None = None
        self.triggered = True  # initial PHR on first grant

    def step(self, tti: int, pathloss_db: float | None = None) -> None:
        self._periodic_cnt += 1
        self._prohibit_cnt = max(0, self._prohibit_cnt - 1)
        if self._periodic_cnt >= self.periodic_timer:
            self._periodic_cnt = 0
            self.triggered = True
        if pathloss_db is not None:
            if (
                self._last_pathloss is not None
                and self._prohibit_cnt == 0
                and abs(pathloss_db - self._last_pathloss) > self.dl_pathloss_change
            ):
                self.triggered = True
            self._last_pathloss = pathloss_db

    def generate_phr(self, headroom_db: float) -> int | None:
        if not self.triggered:
            return None
        self.triggered = False
        self._prohibit_cnt = self.prohibit_timer
        # 36.133 §9.1.8.4: PH mapping -23..40 dB -> 0..63
        return int(max(0, min(63, round(headroom_db + 23))))
