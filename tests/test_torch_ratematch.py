"""Rate dematching of the torch port (``phy/ratematch.py``): the gather over
the inverse index map, which sums the repeats of each softbuffer position
in ascending source order from 0.0, equals the CPU's ``index_add_`` and
the reference's scatter-add (``.at[...].add`` on XLA:CPU) bit for bit, at
every caller's shapes where a position repeats: the PDCCH blind search at
aggregation 4 and 8 (DCI 1A at 100 PRB), the flagship PDSCH grant, a 2 PRB
MCS 0 PDSCH grant on a 6 PRB cell and two PUSCH grants. The codecs and the
blind search hold these tables on their device, built once with the index.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import pdsch as ref_pdsch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy.cell import Cell, UlGrant
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import control, dci, ratematch
from srsue_tpu_torch.phy.pdsch import PdschCodec
from srsue_tpu_torch.phy.pusch import PuschCodec


def _mine(obj):
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _ul_grant(n_prb_alloc: int, mcs: int) -> UlGrant:
    g = ref_ra.dl_grant(6, mcs, n_prb_alloc=n_prb_alloc)
    return UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order,
                   tbs=g.tbs)


def _pdsch(n_prb, cell_id, mcs, n_alloc, rnti, subframe):
    return PdschCodec(port_cell.Cell(n_prb=n_prb, cell_id=cell_id),
                      _mine(ref_ra.dl_grant(n_prb, mcs, n_prb_alloc=n_alloc)), rnti, subframe,
                      cfi=1, device="cpu")


def _group_map(codec):
    """(flat index map, d_len, the codec's inverse table) of its first K-group."""
    k, first, count, _, _, inv = codec.groups[0]
    d_len = 3 * (k + 4)
    idx = np.concatenate([j * d_len + codec.rm_idx[first + j] for j in range(count)])
    return idx, count * d_len, inv


def _pdcch(l_aggr):
    n_coded = dci.size_0_1a(100) + 16
    return ratematch.conv_rm_indices(n_coded, 72 * l_aggr), 3 * n_coded, None


# name: (a function giving (index map, d_len, the caller's table or None),
#        E, d_len, the most repeats of one position)
ROWS = {
    "pdcch_1a_100prb_L4": (lambda: _pdcch(4), 288, 132, 3),
    "pdcch_1a_100prb_L8": (lambda: _pdcch(8), 576, 132, 5),
    "pdsch_flagship": (lambda: _group_map(_pdsch(100, 42, 28, None, 0x1234, 6)),
                       90000, 227292, 1),
    "pdsch_6prb_2prb_mcs0": (lambda: _group_map(_pdsch(6, 7, 0, 2, 0x42, 1)), 552, 180, 4),
    "pusch_4prb_mcs4": (lambda: _group_map(PuschCodec(
        port_cell.Cell(n_prb=6, cell_id=7), _mine(_ul_grant(4, 4)), 0x42, 2, device="cpu")),
        1152, 852, 2),
    "pusch_1prb_mcs0": (lambda: _group_map(PuschCodec(
        port_cell.Cell(n_prb=6, cell_id=7), _mine(_ul_grant(1, 0)), 0x42, 2, device="cpu")),
        288, 132, 3),
}


def _llrs(e, seed, batch=2):
    """Seeded LLRs with exact zeros of both signs among them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, e)) * 4).astype(np.float32)
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    return x


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.mark.parametrize("name", list(ROWS))
def test_gather_equals_index_add_and_the_reference_bit_for_bit(name):
    make, e, d_len, most = ROWS[name]
    idx, d, inv = make()
    assert (len(idx), d) == (e, d_len)
    table = ratematch.inverse_index(idx, d_len)
    assert table.shape == (d_len, most)
    assert np.bincount(idx, minlength=d_len).max() == most
    if inv is not None:  # the caller's table, built with its index
        np.testing.assert_array_equal(inv.numpy(), table)
    llr = _llrs(e, seed=most)
    got = ratematch.dematch(torch.as_tensor(llr), torch.as_tensor(table)).numpy()
    scatter = torch.zeros(2, d_len).index_add_(-1, torch.as_tensor(idx), torch.as_tensor(llr))
    np.testing.assert_array_equal(_bits(got), _bits(scatter.numpy()))
    np.testing.assert_array_equal(_bits(got), _bits(ref_rm.dematch(jnp.asarray(llr), idx,
                                                                   d_len)))


def test_inverse_index_lists_each_positions_sources_in_order():
    idx = np.array([2, 0, 2, 5, 2, 0])
    np.testing.assert_array_equal(ratematch.inverse_index(idx, 6),
                                  [[1, 5, 6], [6, 6, 6], [0, 2, 4], [6, 6, 6], [6, 6, 6],
                                   [3, 6, 6]])
    assert ratematch.inverse_index(np.zeros(0, np.int64), 4).shape == (4, 1)
    with pytest.raises(ValueError, match="outside"):
        ratematch.inverse_index(np.array([0, 4]), 4)


def test_the_sum_is_stepwise_not_a_reduction():
    """Three repeats whose float32 sum depends on the order: the gather adds
    them as (0 + a) + b + c, in the order sent."""
    a, b, c = np.float32(1e8), np.float32(1.0), np.float32(-1e8)
    llr = np.array([[a, b, c]], np.float32)
    got = ratematch.dematch(torch.as_tensor(llr),
                            torch.as_tensor(ratematch.inverse_index(np.zeros(3, np.int64), 1)))
    assert float(got[0, 0]) == float((a + b) + c) == 0.0
    assert float((a + c) + b) == 1.0  # another order gives another float


def test_pdsch_codec_softbuffers_equal_the_references_bit_for_bit():
    """``PdschCodec.dematch`` (the filler prior included) against the
    reference codec's on the same LLRs, on the 6 PRB cell's 2 PRB MCS 0 grant
    (every position sent up to 4 times) and a 25 PRB two-block grant."""
    for n_prb, mcs, n_alloc in ((6, 0, 2), (25, 16, None)):
        cell = Cell(n_prb=n_prb, cell_id=7)
        grant = ref_ra.dl_grant(n_prb, mcs, n_prb_alloc=n_alloc)
        ref = ref_pdsch.PdschCodec(cell, grant, rnti=0x42, subframe=1, cfi=1)
        mine = PdschCodec(_mine(cell), _mine(grant), 0x42, 1, cfi=1, device="cpu")
        llr = _llrs(mine.G, seed=n_prb)
        got = mine.dematch(torch.as_tensor(llr))
        want = ref.dematch(jnp.asarray(llr))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_blind_search_table_is_the_inverse_of_its_candidates_map():
    """``control._blind_tables`` holds the inverse of the concatenated
    candidates' map at 100 PRB, whose common-space candidates repeat up to 5
    times (L=8)."""
    cell = port_cell.Cell(n_prb=100, cell_id=42)
    n_coded = dci.size_0_1a(100) + 16
    n_cand, _, _, inv, _, _ = control._blind_tables(cell, 6, 1, 0x1234, n_coded - 16, True,
                                                    torch.device("cpu"))
    n_cce, _ = control.pdcch_geometry(cell, 1)
    cands = control.search_space_candidates(n_cce, 0x1234, 6)
    assert {l for _, l in cands} >= {4, 8} and len(cands) == n_cand
    idx = np.concatenate([i * 3 * n_coded + ratematch.conv_rm_indices(n_coded, 72 * l)
                          for i, (_, l) in enumerate(cands)])
    np.testing.assert_array_equal(inv.numpy(), ratematch.inverse_index(idx, n_cand * 3 * n_coded))
    assert inv.shape[1] == 5
