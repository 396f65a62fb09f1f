"""The soft demap + descramble + rate dematch's work: it reads each
equalized symbol (complex64, 8 bytes) and its noise (float32, 4 bytes) once
and writes each softbuffer value (float32, 4 bytes) once. Its arithmetic is
far below the bytes' time, so the bytes bound it."""

from __future__ import annotations

SYMBOL_BYTES = 8 + 4
VALUE_BYTES = 4


def pdsch_bytes(batch: int, n_re: int, d_lens) -> int:
    """A PDSCH demap of `batch` subframes of `n_re` data symbols into code
    blocks whose softbuffers hold sum(`d_lens`) values a subframe."""
    return batch * (SYMBOL_BYTES * n_re + VALUE_BYTES * sum(d_lens))


def pdcch_bytes(batch: int, levels, dci_len: int) -> int:
    """A blind search's demap of `batch` subframes: each candidate of
    aggregation level L reads its 36 L QPSK symbols and fills a softbuffer
    of 3 (dci_len + 16) values."""
    return batch * sum(SYMBOL_BYTES * 36 * l + VALUE_BYTES * 3 * (dci_len + 16)
                       for l in levels)
