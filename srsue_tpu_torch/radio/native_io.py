"""Native-backed radio front end: the port's copy of
``srsue_tpu/radio/native_io.py`` (its reference), unchanged, over the
port's ``utils/native.py`` (which builds ``native/iq_stream.cc`` into
``build/native/``) and ``radio.Radio``.

``NativeFileRadio`` implements the same `Radio` contract as FileRadio
but with the reference's runtime shape (SURVEY.md §2.5): a C++ PREFETCH
THREAD streams the capture file into a lock-free ring while Python/TPU
work proceeds (the UHD RX streamer role, phch_recv.cc:318-358), and TX
goes through the native in-order timed-commit queue (the tx mutex ring,
phch_common.cc:210-240) which zero-pads burst gaps and counts LATE
bursts — the reference's O/U/L counters (ue.cc:271-292; underflows are
reads past EOF).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import native
from .radio import Radio


def available() -> bool:
    lib = native._load()
    return lib is not None and hasattr(lib, "iqstream_open")


class NativeFileRadio(Radio):
    """File radio backed by the C++ prefetching ring reader."""

    def __init__(self, path: str, srate: float,
                 ring_samples: int = 1 << 20, block: int = 16384):
        lib = native._load()
        if lib is None or not hasattr(lib, "iqstream_open"):
            raise RuntimeError("native IQ runtime unavailable")
        self._lib = lib
        self._h = lib.iqstream_open(path.encode(), ring_samples, block)
        if not self._h:
            raise FileNotFoundError(path)
        self.srate = srate
        self._txq = lib.txq_create()
        self._tx_seq = 0

    # ------------------------------------------------------------------ RX
    def rx_now(self, n: int) -> tuple[np.ndarray, float]:
        out = np.empty(2 * n, np.float32)
        pos = ctypes.c_int64()
        self._lib.iqstream_read(self._h, out, n, ctypes.byref(pos))
        ts = pos.value / self.srate
        return out.view(np.complex64), ts

    def seek(self, sample_pos: int) -> bool:
        return bool(self._lib.iqstream_seek(self._h, int(sample_pos)))

    @property
    def underflows(self) -> int:
        return int(self._lib.iqstream_underflows(self._h))

    # ------------------------------------------------------------------ TX
    def tx(self, samples: np.ndarray, tx_time: float) -> None:
        self.tx_seq(self._tx_seq, samples, tx_time)
        self._tx_seq += 1

    def tx_seq(self, seq: int, samples: np.ndarray, tx_time: float) -> None:
        """Submit burst `seq` (commits strictly in seq order — workers
        may submit out of order, mirroring the reference worker pool)."""
        iq = np.ascontiguousarray(samples, np.complex64).view(np.float32)
        self._lib.txq_submit(self._txq, int(seq),
                             int(round(tx_time * self.srate)), iq,
                             len(iq) // 2)

    @property
    def tx_late(self) -> int:
        return int(self._lib.txq_late(self._txq))

    @property
    def tx_committed(self) -> int:
        return int(self._lib.txq_committed(self._txq))

    def tx_stream(self) -> tuple[np.ndarray, int]:
        """The committed TX waveform (gaps zero-padded) and the absolute
        sample index of its first sample."""
        n = int(self._lib.txq_stream_len(self._txq))
        t0 = int(self._lib.txq_stream_t0(self._txq))
        if n <= 0:
            return np.zeros(0, np.complex64), t0
        out = np.empty(2 * n, np.float32)
        got = self._lib.txq_read_stream(self._txq, 0, out, n)
        return out[: 2 * got].view(np.complex64), t0

    def close(self) -> None:
        if self._h:
            self._lib.iqstream_close(self._h)
            self._h = None
        if self._txq:
            self._lib.txq_destroy(self._txq)
            self._txq = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
