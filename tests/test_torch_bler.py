"""The port's BLER sweep (``phy/bler.py``) against the JAX package's on the
grid, size and seed of tests/test_bler.py: 6 PRB, MCS 5, -4 / 0 / 4 / 10 dB,
6 subframes a point. Both draw the same payloads and noise from the seed,
so they decode the same IQ; every BlerPoint (bler and mean_iters) and the
waterfall SNR are equal.

A TB on the waterfall whose CRC outcome turns on an LLR margin below
float32 tolerance could flip between the two (the JAX side demodulates
through its matmul DFT). If a point differed, the test would have to show
that the LLRs agree within float32 tolerance and that the point is off by
one TB at most; on this grid and seed every point is equal.
"""

import dataclasses

from srsue_tpu.phy import bler as ref_bler
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import bler
from srsue_tpu_torch.phy import cell as port_cell

SNRS = [-4, 0, 4, 10]


def test_sweep_matches_reference():
    cell = Cell(n_prb=6, cell_id=3)
    ref = ref_bler.sweep_pdsch(cell, mcs=5, snrs_db=SNRS, n_sf_per_point=6)
    got = bler.sweep_pdsch(port_cell.Cell(**dataclasses.asdict(cell)), mcs=5, snrs_db=SNRS,
                           n_sf_per_point=6, device="cpu")
    assert [dataclasses.astuple(p) for p in got] == [dataclasses.astuple(p) for p in ref]
    assert bler.waterfall_snr(got) == ref_bler.waterfall_snr(ref)
    # the reference test's own sanity, on the port's curve
    assert got[0].bler >= 0.8 and got[-1].bler == 0.0
    assert got[-1].mean_iters <= got[0].mean_iters


def test_waterfall_snr_is_the_reference():
    pts = [ref_bler.BlerPoint(s, b, 8, 1.0) for s, b in ((0, 1.0), (2, 0.5), (4, 0.0))]
    mine = [bler.BlerPoint(*dataclasses.astuple(p)) for p in pts]
    for target in (0.1, 0.5, 0.9, 1.0):
        assert bler.waterfall_snr(mine, target) == ref_bler.waterfall_snr(pts, target)
    assert bler.waterfall_snr(mine[:1]) is None
