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


def _waveforms(cell, sf, cfi, dcis, pdsch, snr_db, seed, batch=1):
    """`batch` noisy subframes: CRS, PCFICH, each (dci_bits, rnti, start, L)
    of `dcis`, and the PDSCH of each (grant, rnti) of `pdsch` with a random
    payload per subframe. Returns (iq, payloads [per pdsch entry][batch])."""
    rng = np.random.default_rng(seed)
    tds, pays = [], [[] for _ in pdsch]
    for _ in range(batch):
        grid = enb_tx.empty_grid(cell)
        enb_tx.add_crs(cell, grid, sf, 0)
        control.pcfich_map(cell, grid, sf, cfi)
        for bits, rnti, start, l_aggr in dcis:
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
