"""The roofline counts at the flagship shape (100 PRB, MCS 28, B = 256: 13
code blocks of K = 5824, 15,000 64QAM data symbols a subframe), with the
arithmetic written out."""

import pytest

from perfbench import rooflines
from perfbench.rooflines import demap, turbo


def test_turbo_forced_step():
    # a forced 8-iteration step: 2 halves x 8 iterations over 256 x 13 blocks
    halves = 2 * 8 * 256 * 13            # 53,248 block half-iterations
    steps = halves * 5824                # 310,116,352 trellis steps
    w = turbo.work([(5824, halves)])
    assert w["bytes"] == 16 * steps == 4_961_861_632
    assert w["ops"] == 120 * steps == 37_213_962_240
    # bytes bound it: 4.96 GB / 3.35 TB/s = 1.481 ms against 37.2 GFLOP / 67 TFLOP/s = 0.555 ms
    assert rooflines.least_seconds(w["bytes"], w["ops"]) == pytest.approx(4_961_861_632 / 3.35e12)
    # one half of the whole batch: 1.481 ms / 16 = 0.0926 ms
    assert rooflines.least_seconds(w["bytes"], w["ops"]) / 16 == pytest.approx(9.257e-5, rel=1e-3)


def test_demap_pdsch_step():
    d = 3 * (5824 + 4)                   # 17,484 softbuffer values a block
    n = demap.pdsch_bytes(256, 15000, [d] * 13)
    # 256 x (15,000 x 12 B read + 13 x 17,484 x 4 B written) = 256 x 1,089,168 B
    assert n == 256 * (15000 * 12 + 13 * d * 4) == 278_827_008
    assert rooflines.least_seconds(n, 0) == pytest.approx(8.323e-5, rel=1e-3)


def test_demap_pdcch():
    # candidates of L = 1, 2, 4, 8 reading 36 L symbols and writing 3 x (27 + 16) values
    assert demap.pdcch_bytes(1, [1, 2, 4, 8], 27) == 12 * 36 * 15 + 4 * 4 * 3 * 43
