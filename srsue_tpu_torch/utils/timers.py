"""The port's own copy of ``srsue_tpu/utils/timers.py`` (its reference), unchanged below this docstring.

TTI-resolution timers — manually stepped with expiry callbacks
(reference: ue/hdr/common/timers.h:41-90; MAC steps them per TTI at
mac.cc:210)."""

from __future__ import annotations

from typing import Callable


class Timer:
    def __init__(self):
        self.duration = 0
        self.counter = 0
        self.running = False
        self.callback: Callable[[int], None] | None = None
        self.timer_id = 0

    def set(self, duration: int, callback: Callable[[int], None] | None = None) -> None:
        self.duration = duration
        self.callback = callback

    def run(self) -> None:
        self.counter = 0
        self.running = True

    def stop(self) -> None:
        self.running = False

    def reset(self) -> None:
        self.counter = 0

    @property
    def is_expired(self) -> bool:
        return not self.running and self.counter >= self.duration > 0

    def step(self) -> None:
        if not self.running:
            return
        self.counter += 1
        if self.counter >= self.duration:
            self.running = False
            if self.callback:
                self.callback(self.timer_id)


class TimersDb:
    """Fixed pool of timers stepped together (timers_db.step_all)."""

    def __init__(self, n: int = 32):
        self.timers = [Timer() for _ in range(n)]
        for i, t in enumerate(self.timers):
            t.timer_id = i
        self._next = 0

    def get_unique(self) -> Timer:
        t = self.timers[self._next]
        self._next += 1
        return t

    def get(self, tid: int) -> Timer:
        return self.timers[tid]

    def step_all(self) -> None:
        for t in self.timers:
            t.step()
