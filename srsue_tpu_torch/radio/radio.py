"""Radio front ends over IQ streams: the port's own copy of ``Radio``,
``ArrayRadio``, ``FileRadio`` and ``write_iq`` of
``srsue_tpu/radio/radio.py`` (its reference), numpy only.

The RX contract is ``rx_now(n) -> (samples, timestamp)`` and TX is
``tx(samples, tx_time)``; the array and file radios serve a stored capture,
zero-padded past its end, and can seek.
"""

from __future__ import annotations

import numpy as np


class Radio:
    srate: float

    def rx_now(self, n: int) -> tuple[np.ndarray, float]:
        raise NotImplementedError

    def tx(self, samples: np.ndarray, tx_time: float) -> None:
        raise NotImplementedError

    def set_rx_srate(self, srate: float) -> None:
        self.srate = srate

    def seek(self, sample_pos: int) -> bool:
        """Reposition the RX stream (file and array radios only). A live
        radio returns False, and its caller consumes forward."""
        return False


class ArrayRadio(Radio):
    """Serves a preloaded IQ array (generated waveforms, captures in
    memory). TX is recorded with its timestamps."""

    def __init__(self, samples: np.ndarray, srate: float):
        self.samples = np.asarray(samples, np.complex64).ravel()
        self.srate = srate
        self.pos = 0
        self.tx_log: list[tuple[float, np.ndarray]] = []

    def rx_now(self, n: int) -> tuple[np.ndarray, float]:
        ts = self.pos / self.srate
        end = self.pos + n
        out = np.zeros(n, np.complex64)
        avail = max(0, min(end, len(self.samples)) - self.pos)
        if avail > 0:
            out[:avail] = self.samples[self.pos: self.pos + avail]
        self.pos = end
        return out, ts

    def tx(self, samples: np.ndarray, tx_time: float) -> None:
        self.tx_log.append((tx_time, np.asarray(samples, np.complex64)))

    def seek(self, sample_pos: int) -> bool:
        self.pos = int(sample_pos)
        return True

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.samples)


class FileRadio(ArrayRadio):
    """Replays a raw complex64 IQ capture file."""

    def __init__(self, path: str, srate: float):
        super().__init__(np.fromfile(path, dtype=np.complex64), srate)


def write_iq(path: str, samples: np.ndarray) -> None:
    np.asarray(samples, np.complex64).ravel().tofile(path)
