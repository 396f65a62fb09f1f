"""The port's own copy of ``srsue_tpu/mac/proc_ra.py`` (its reference), unchanged below this docstring.

Random Access procedure — 36.321 §5.1 state machine
(reference: ue/src/mac/proc_ra.cc, 533 LoC; states & step at 449-484).

States: IDLE -> RESOURCE_SELECTION -> PREAMBLE_TX (power ramping) ->
RESPONSE_RECEPTION (RAR window on RA-RNTI) -> [contention: Msg3 +
CONTENTION_RESOLUTION] -> COMPLETION. Backoff table proc_ra.cc:46.

The proc is host-driven per TTI by Mac.run_tti; PHY interaction is via
callbacks (prach_send, pdcch search windows) mirroring phy_interface.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from enum import Enum, auto
from typing import Callable

from . import pdu as pdu_mod

BACKOFF_TABLE = [0, 10, 20, 30, 40, 60, 80, 120, 160, 240, 320, 480, 960]


class RaState(Enum):
    IDLE = auto()
    RESOURCE_SELECTION = auto()
    PREAMBLE_TX = auto()
    PDCCH_SETUP = auto()
    RESPONSE_RECEPTION = auto()
    BACKOFF_WAIT = auto()
    MSG3_TX = auto()
    CONTENTION_RESOLUTION = auto()
    COMPLETION = auto()
    RA_PROBLEM = auto()


@dataclass
class RaConfig:
    n_preambles: int = 64
    preamble_init_power: float = -104.0
    power_ramp_db: float = 4.0
    preamble_trans_max: int = 10
    response_window: int = 10
    contention_res_timer: int = 64
    group_a_size: int = 52


class RaProc:
    def __init__(
        self,
        cfg: RaConfig,
        prach_send: Callable[[int, float], int],
        start_rar_search: Callable[[int, int], None],
        send_msg3: Callable[[bytes, int], None],
        on_complete: Callable[[int], None],
        on_timing_advance: Callable[[int], None] | None = None,
        rng: random.Random | None = None,
    ):
        """prach_send(preamble_idx, power) -> tti of transmission.
        start_rar_search(ra_rnti, window) arms the PDCCH search.
        send_msg3(mac_pdu_bytes, t_crnti) queues Msg3 via mux/ul_harq.
        on_complete(crnti) notifies MAC/RRC."""
        self.cfg = cfg
        self.prach_send = prach_send
        self.start_rar_search = start_rar_search
        self.send_msg3 = send_msg3
        self.on_complete = on_complete
        self.on_timing_advance = on_timing_advance or (lambda ta: None)
        self.rng = rng or random.Random(0)

        self.state = RaState.IDLE
        self.preamble_idx = 0
        self.preamble_count = 0
        self.power = cfg.preamble_init_power
        self.ra_rnti = 0
        self.t_crnti = 0
        self.ue_crid: bytes = b""
        self._window_cnt = 0
        self._backoff_cnt = 0
        self._conres_cnt = 0
        self._backoff_param = 0
        self.msg3: bytes | None = None
        # contention-free RA (36.321 §5.1.2: ra-PreambleIndex signalled
        # by RRC, e.g. handover rach-ConfigDedicated): fixed preamble,
        # completion on RAR reception (no Msg3/contention)
        self.dedicated_preamble: int | None = None

    # --- kickoff (start_mux_order / start_pdcch_order etc.) ----------------
    def start(self, msg3: bytes, ue_crid: bytes) -> None:
        assert self.state == RaState.IDLE
        self.msg3 = msg3
        self.ue_crid = ue_crid
        self.preamble_count = 0
        self.power = self.cfg.preamble_init_power
        self.dedicated_preamble = None  # caller may set AFTER start
        self.state = RaState.RESOURCE_SELECTION

    def step(self, tti: int) -> None:
        s = self.state
        if s == RaState.COMPLETION:
            # one-shot: housekeeping done in on_complete; the procedure is
            # re-armable for a later SR-exhaustion RA (proc_ra.cc:439-447
            # step_completition -> back to idle semantics)
            self.state = RaState.IDLE
        elif s == RaState.RESOURCE_SELECTION:
            if self.dedicated_preamble is not None:
                self.preamble_idx = self.dedicated_preamble
            else:
                self.preamble_idx = self.rng.randrange(self.cfg.group_a_size)
            self.state = RaState.PREAMBLE_TX
        elif s == RaState.PREAMBLE_TX:
            if self.preamble_count >= self.cfg.preamble_trans_max:
                self.state = RaState.RA_PROBLEM
                return
            self.preamble_count += 1
            tx_tti = self.prach_send(self.preamble_idx, self.power)
            self.power += self.cfg.power_ramp_db
            # RA-RNTI = 1 + t_id (+ 10*f_id, FDD: f_id = 0) (36.321 §5.1.4)
            self.ra_rnti = 1 + (tx_tti % 10)
            self.start_rar_search(self.ra_rnti, self.cfg.response_window)
            self._window_cnt = 0
            self.state = RaState.RESPONSE_RECEPTION
        elif s == RaState.RESPONSE_RECEPTION:
            self._window_cnt += 1
            if self._window_cnt > self.cfg.response_window + 3:
                self._start_backoff()
        elif s == RaState.BACKOFF_WAIT:
            self._backoff_cnt -= 1
            if self._backoff_cnt <= 0:
                self.state = RaState.PREAMBLE_TX
        elif s == RaState.CONTENTION_RESOLUTION:
            self._conres_cnt += 1
            if self._conres_cnt > self.cfg.contention_res_timer:
                self._start_backoff()

    def _start_backoff(self) -> None:
        delay = self.rng.randint(0, BACKOFF_TABLE[min(self._backoff_param, 12)])
        self._backoff_cnt = delay
        self.state = RaState.BACKOFF_WAIT if delay else RaState.PREAMBLE_TX

    # --- RAR handling (tb_decoded_ok path, proc_ra.cc:263) -----------------
    def rar_received(self, rar_pdu_bytes: bytes) -> None:
        if self.state != RaState.RESPONSE_RECEPTION:
            return
        rars, backoff = pdu_mod.unpack_rar_pdu(rar_pdu_bytes)
        if backoff is not None:
            self._backoff_param = backoff
        for rar in rars:
            if rar.rapid == self.preamble_idx:
                self.on_timing_advance(rar.ta)  # process_timeadv_cmd
                self.last_rar = rar
                self.t_crnti = rar.t_crnti
                if self.dedicated_preamble is not None:
                    # contention-free RA: the RAR completes the procedure
                    # (36.321 §5.1.5: no contention resolution needed)
                    self.state = RaState.COMPLETION
                    self.on_complete(self.t_crnti)
                    return
                assert self.msg3 is not None
                self.send_msg3(self.msg3, rar.t_crnti)
                self._conres_cnt = 0
                self.state = RaState.CONTENTION_RESOLUTION
                return
        # our preamble not in RAR -> retry
        self._start_backoff()

    # --- contention resolution (demux CON_RES CE callback) -----------------
    def con_res_id_received(self, crid: bytes) -> bool:
        if self.state != RaState.CONTENTION_RESOLUTION:
            return False
        if crid == self.ue_crid[: len(crid)].ljust(len(crid), b"\x00"):
            self.state = RaState.COMPLETION
            self.on_complete(self.t_crnti)
            return True
        # contention lost -> backoff and retry
        self._start_backoff()
        return False

    def pdcch_to_crnti(self, is_ul_grant: bool) -> None:
        """C-RNTI PDCCH during contention resolution completes RA for
        non-initial access (proc_ra.cc:524-529)."""
        if self.state == RaState.CONTENTION_RESOLUTION:
            self.state = RaState.COMPLETION
            self.on_complete(self.t_crnti)

    @property
    def is_running(self) -> bool:
        return self.state not in (RaState.IDLE, RaState.COMPLETION, RaState.RA_PROBLEM)

    def reset(self) -> None:
        """Abort any ongoing RA (part of MAC reset, 36.321 §5.9)."""
        self.state = RaState.IDLE
        self.msg3 = b""
        self._backoff_cnt = 0
        self.dedicated_preamble = None
