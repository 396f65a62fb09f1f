"""The port's own copy of ``srsue_tpu/rrc/si_sched.py`` (its reference), unchanged below this docstring.

System-information scheduling — SIB1 occasions + SI windows
(36.331 §5.2.3; reference: rrc.cc:584-587 SI scheduling math + the
MAC SI-RNTI search windows of mac.cc:215-244) and paging occasions
(36.304 §7).
"""

from __future__ import annotations

from dataclasses import dataclass

SIB1_PERIOD_RF = 8  # SIB1 repeats every 20 ms within an 80 ms period


def sib1_occasion(tti: int) -> bool:
    """SIB1 transmissions: subframe 5 of every even radio frame."""
    return tti % 10 == 5 and (tti // 10) % 2 == 0


@dataclass(frozen=True)
class SiConfig:
    si_window_len_sf: int = 20  # si-WindowLength in subframes
    si_periodicity_rf: tuple = (16,)  # per SI message, in radio frames


def si_window(cfg: SiConfig, msg_idx: int, tti: int) -> bool:
    """Is `tti` inside the SI window of SI message `msg_idx` (0-based,
    excluding SIB1)?  36.331: n = msg_idx+1, x = (n-1)*w; the window
    starts at subframe (x mod 10) of radio frame satisfying
    SFN mod T = floor(x/10) and lasts w subframes."""
    w = cfg.si_window_len_sf
    t = cfg.si_periodicity_rf[msg_idx]
    n = msg_idx + 1
    x = (n - 1) * w
    sfn = tti // 10
    start_frame_mod = x // 10
    start_sf = x % 10
    # window start absolute subframe index within the period
    if sfn % t < start_frame_mod:
        return False
    start_tti_in_period = (sfn - sfn % t + start_frame_mod) * 10 + start_sf
    return 0 <= tti - start_tti_in_period < w


def paging_occasion(tti: int, ue_id: int, n_b_t: float = 1.0,
                    t_drx: int = 128) -> bool:
    """Paging occasion check (36.304 §7.1): PF = (T div N)*(UE_ID mod N);
    PO from the i_s table. n_b_t = nB/T in {4,2,1,1/2,...}."""
    n = min(t_drx, max(1, int(t_drx * n_b_t)))
    ns = max(1, int(n_b_t))
    pf = (t_drx // n) * (ue_id % n)
    sfn = tti // 10
    if sfn % t_drx != pf:
        return False
    i_s = (ue_id // n) % ns
    po_table = {1: [9], 2: [4, 9], 4: [0, 4, 5, 9]}
    pos = po_table.get(ns, [9])
    return tti % 10 == pos[i_s % len(pos)]
