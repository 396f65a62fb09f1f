"""The port's UE DL facade (phy/ue_dl.py) on 1-port cells against the JAX
package's UeDl on the same noisy IQ (tests/test_torch_tm2.py holds the
2-port cells): CFI, blind-search hits of every batch element
and format, the DL grants, and the decoded payloads, CRC verdicts and
turbo iterations equal; the channel metrics agree to float32 rounding
(rtol 1e-4)."""

import dataclasses

import numpy as np
import pytest

from srsue_tpu.phy import control, dci, enb_tx, ra
from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.pdsch import PdschCodec
from srsue_tpu.phy.ue_dl import UeDl as RefUeDl
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy.ue_dl import UeDl

SI_RNTI = 0xFFFF


def _mine(obj):
    """The port's own Cell or DlGrant with the fields of the reference's."""
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _port_ue(cell):
    """The port's UeDl on the CPU for the reference's cell."""
    return UeDl(_mine(cell), device="cpu")


def _waveforms(cell, sf, cfi, dcis, pdsch, snr_db, seed, batch=1, per_elem=None):
    """`batch` noisy subframes: CRS, PCFICH, each (dci_bits, rnti, start, L)
    of `dcis` and of the subframe's own list in `per_elem` (one a subframe),
    and the PDSCH of each (grant, rnti) of `pdsch` with a random payload per
    subframe. Returns (iq, payloads [per pdsch entry][batch])."""
    rng = np.random.default_rng(seed)
    tds, pays = [], [[] for _ in pdsch]
    for b in range(batch):
        grid = enb_tx.empty_grid(cell)
        enb_tx.add_crs(cell, grid, sf, 0)
        control.pcfich_map(cell, grid, sf, cfi)
        for bits, rnti, start, l_aggr in dcis + (per_elem[b] if per_elem else []):
            control.pdcch_map(cell, grid, sf, cfi, bits, rnti, start, l_aggr)
        for j, (grant, rnti) in enumerate(pdsch):
            codec = PdschCodec(cell, grant, rnti, sf, cfi)
            pl = rng.integers(0, 2, grant.tbs).astype(np.uint8)
            codec.map_to_grid(grid, codec.encode_symbols(pl))
            pays[j].append(pl)
        tds.append(enb_tx.to_waveform(cell, [grid])[0])
    td = np.stack(tds)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0], [np.stack(p) for p in pays]


def _astuple(x):
    return (type(x).__name__,) + dataclasses.astuple(x)


def _assert_same(got, ref):
    assert got.cfi == ref.cfi
    assert [_astuple(g) for g in got.grants] == [_astuple(g) for g in ref.grants]
    assert ([[(f, _astuple(d)) for f, d in e] for e in got.hits_per_elem]
            == [[(f, _astuple(d)) for f, d in e] for e in ref.hits_per_elem])
    assert len(got.decoded) == len(ref.decoded)
    for a, b in zip(got.decoded, ref.decoded):
        assert _astuple(a[0]) == _astuple(b[0])
        for x, y in zip(a[1:], b[1:], strict=True):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert got.metrics.keys() == ref.metrics.keys()
    for k in got.metrics:
        np.testing.assert_allclose(got.metrics[k], np.asarray(ref.metrics[k]), rtol=1e-4)


def test_process_matches_reference():
    """tests/test_ue_dl.py's subframe: 25 PRB, CFI 2, DCI 1A at CCE 0 L=4."""
    cell = Cell(n_prb=25, cell_id=99)
    rnti, sf, cfi = 0x5A5A, 3, 2
    grant = ra.dl_grant(cell.n_prb, 12)
    d = dci.Dci1A(riv=dci.riv_encode(25, 0, 25), mcs=12, harq_pid=0, ndi=True, rv=0,
                  tpc=0)
    iq, (pays,) = _waveforms(cell, sf, cfi, [(dci.pack_1a(25, d), rnti, 0, 4)],
                             [(grant, rnti)], 20.0, 0)
    got = _port_ue(cell).process(iq, sf, rnti)
    _assert_same(got, RefUeDl(cell).process(iq, sf, rnti))
    assert got.cfi == cfi and len(got.grants) == 1 and got.grants[0].tbs == grant.tbs
    assert got.tb_ok.all()
    np.testing.assert_array_equal(got.payload, pays)
    assert "snr_db" in got.metrics

    none = _port_ue(cell).process(iq, sf, rnti ^ 0x0F0F)  # a wrong RNTI: no grant
    assert none.cfi == cfi and none.grants == [] and none.payload is None


def test_process_formats_match_reference():
    """Formats 0/1A, 1 and 1C searched together over a batch of 2
    (tests/test_dci_breadth.py's DCIs): a format-1 assignment on the
    C-RNTI, then a 1C on the SI-RNTI in the common space."""
    cfi = 2
    cell = Cell(n_prb=25, cell_id=31)
    crnti, sf = 0x4601, 3
    nbg = -(-cell.n_prb // dci.rbg_size(cell.n_prb))
    d1 = dci.Dci1(rbg_bitmap=(1 << nbg) - 1, mcs=9, harq_pid=0, ndi=True, rv=0, tpc=0)
    grant = dci.dci1_to_grant(cell, d1)
    n_cce, _ = control.pdcch_geometry(cell, cfi)
    start, l_aggr = [c for c in control.search_space_candidates(n_cce, crnti, sf)
                     if c[1] >= 4][0]
    iq, (pays,) = _waveforms(cell, sf, cfi, [(dci.pack_1(25, d1), crnti, start, l_aggr)],
                             [(grant, crnti)], 20.0, 2, batch=2)
    formats = ("0_1a", "1", "1c")
    got = _port_ue(cell).process(iq, sf, crnti, formats=formats)
    _assert_same(got, RefUeDl(cell).process(iq, sf, crnti, formats=formats))
    assert [f for f, _ in got.hits_per_elem[1]] == ["1"] and got.tb_ok.all()
    np.testing.assert_array_equal(got.payload, pays)

    cell = Cell(n_prb=25, cell_id=77)
    sf = 1
    d1c = dci.Dci1C(riv=dci.riv_encode(cell.n_prb // 2, 0, 6), tbs_idx=9)
    grant = dci.dci1c_to_grant(cell, d1c)
    iq, (pays,) = _waveforms(cell, sf, cfi, [(dci.pack_1c(25, d1c), SI_RNTI, 0, 4)],
                             [(grant, SI_RNTI)], 20.0, 4)
    got = _port_ue(cell).process(iq, sf, SI_RNTI, ue_specific=False, formats=("0_1a", "1c"))
    _assert_same(got, RefUeDl(cell).process(iq, sf, SI_RNTI, ue_specific=False,
                                            formats=("0_1a", "1c")))
    assert got.grants[0].tbs == grant.tbs and got.tb_ok.all()
    np.testing.assert_array_equal(got.payload, pays)


def test_process_control_differing_by_element_matches_reference():
    """A batch of 4 whose control differs by element, formats 0/1A and 1: a
    1A on one candidate; a DCI 0 and a 1A on two; no PDCCH; a format 1.
    Element 0's grant is decoded over the batch, its PDSCH in every
    subframe."""
    cfi = 2
    cell = Cell(n_prb=25, cell_id=61)
    crnti, sf = 0x3C21, 7
    n_cce, _ = control.pdcch_geometry(cell, cfi)
    cands = control.search_space_candidates(n_cce, crnti, sf)
    first = cands[0]
    apart = next(c for c in cands if c[0] >= first[0] + first[1])  # no CCE of `first`
    d1a = dci.Dci1A(riv=dci.riv_encode(25, 0, 25), mcs=10, harq_pid=2, ndi=True, rv=0, tpc=1)
    d1a_b = dci.Dci1A(riv=dci.riv_encode(25, 5, 10), mcs=4, harq_pid=5, ndi=False, rv=2,
                      tpc=3, distributed=True)
    d0 = dci.Dci0(riv=dci.riv_encode(25, 2, 8), mcs=12, ndi=True, tpc=2, dmrs_cshift=3,
                  cqi_request=True)
    nbg = -(-cell.n_prb // dci.rbg_size(cell.n_prb))
    d1 = dci.Dci1(rbg_bitmap=(1 << nbg) - 2, mcs=7, harq_pid=1, ndi=False, rv=1, tpc=0)
    per_elem = [[(dci.pack_1a(25, d1a), crnti, *first)],
                [(dci.pack_0(25, d0), crnti, *first), (dci.pack_1a(25, d1a_b), crnti, *apart)],
                [],
                [(dci.pack_1(25, d1), crnti, *apart)]]
    grant = dci.dci1a_to_grant(cell, d1a)
    iq, (pays,) = _waveforms(cell, sf, cfi, [], [(grant, crnti)], 20.0, 8, batch=4,
                             per_elem=per_elem)
    formats = ("0_1a", "1")
    got = _port_ue(cell).process(iq, sf, crnti, formats=formats)
    _assert_same(got, RefUeDl(cell).process(iq, sf, crnti, formats=formats))
    assert ([[(f, _astuple(d)) for f, d in e] for e in got.hits_per_elem]
            == [[("0_1a", _astuple(d1a))], [("0_1a", _astuple(d0)), ("0_1a", _astuple(d1a_b))],
                [], [("1", _astuple(d1))]])
    assert got.tb_ok.all()
    np.testing.assert_array_equal(got.payload, pays)


def test_decode_pdsch_and_two_ports():
    cell = Cell(n_prb=6, cell_id=17)
    grant = ra.dl_grant(cell.n_prb, 5)
    iq, (pays,) = _waveforms(cell, 1, 1, [], [(grant, 0x1234)], 20.0, 1, batch=2)
    got = _port_ue(cell).decode_pdsch(iq, _mine(grant), 0x1234, 1, 1)
    ref = RefUeDl(cell).decode_pdsch(iq, grant, 0x1234, 1, 1)
    for x, y in zip(got, ref, strict=True):
        np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(got[0], pays)
    two = UeDl(_mine(Cell(n_prb=15, cell_id=150, n_ports=2)), device="cpu")
    assert two.cell.n_ports == 2  # a 2-port cell takes the TM2 chain
    with pytest.raises(ValueError, match="4-port"):
        UeDl(_mine(Cell(n_prb=15, cell_id=150, n_ports=4)), device="cpu")


@pytest.mark.parametrize("n_prb", [6, 15])
def test_empty_search_space_gives_no_hits(n_prb):
    """At CFI 1 a 6 or 15 PRB carrier has 2 CCEs: the common space (L=4
    and 8) holds no candidate. ``UeDl.search`` then finds nothing for the
    SI-RNTI in either format and launches no search, and ``process``
    returns no grant (the OTA tests' 15 PRB cell reaches this in
    ``Phy.work``)."""
    cell, sf = Cell(n_prb=n_prb, cell_id=9), 1
    n_cce, _ = control.pdcch_geometry(cell, 1)
    assert control.search_space_candidates(n_cce, SI_RNTI, sf, ue_specific=False) == []
    iq, _ = _waveforms(cell, sf, 1, [], [], 20.0, 6, batch=2)
    ue = _port_ue(cell)
    front = ue.front_end(iq, sf)
    assert ue.cfi(front.g_eq, front.nv_eff, sf) == 1
    formats = ("0_1a", "1c")
    assert ue.search(front.g_eq, front.nv_eff, sf, 1, SI_RNTI, False, formats) == [[], []]
    assert ue.search(front.g_eq[0], front.nv_eff[0], sf, 1, SI_RNTI, False, formats) == [[]]
    res = ue.process(iq, sf, SI_RNTI, ue_specific=False, formats=formats)
    assert res.cfi == 1 and res.grants == [] and res.payload is None
    assert res.hits_per_elem == [[], []] and res.decoded == []
