"""The mobility and measurement loop on single subframes, the port's
``Phy(device="cpu")`` against the reference's ``Phy``, fed the same
waveforms:

* the serving and neighbour RSRP of a combined two-cell waveform (the
  neighbour 6 dB over the serving cell, and a PCI that is not on the air);
* the P-RNTI search with DCI 1C: found at the UE's paging occasion and at no
  other TTI, the PCCH decoded and the UE paged;
* the subband SNR vector of a two-tap channel and the labels it gives.
"""

import dataclasses

import numpy as np
import pytest

from srsue_tpu.enb import phy as ref_enb_phy
from srsue_tpu.enb import stack as ref_stack
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import control as ref_control
from srsue_tpu.phy import phy as ref_phy
from srsue_tpu.rrc.si_sched import paging_occasion
from srsue_tpu.ue import Ue as RefUe
from srsue_tpu_torch.enb.stack import EnbStack
from srsue_tpu_torch.mac.rnti import P_RNTI
from srsue_tpu_torch.phy import control, dci, enb_tx, phy, ue_ul_ctrl
from srsue_tpu_torch.phy.pdsch import codec as pdsch_codec
from srsue_tpu_torch.ue import Ue
from test_torch_ota_lockstep import DB_ATOL, noise, port_cell_of

N_PRB, SRC_PCI, NEW_PCI, ABSENT_PCI = 15, 123, 77, 200
CFI = 2


def both_phys(cell, with_ue=False):
    """The reference's Phy and the port's on the CPU, on the same cell (with
    a UE each when `with_ue`)."""
    rp, pp = ref_phy.Phy(cell), phy.Phy(port_cell_of(cell), device="cpu")
    ues = None
    if with_ue:
        ues = RefUe(phy=rp), Ue(phy=pp)
        for p, ue in zip((rp, pp), ues):
            p.mac, p.rrc = ue.mac, ue.rrc
    return rp, pp, ues


def broadcast_enb(pci):
    """The reference eNB emulator of a cell that only broadcasts."""
    return ref_enb_phy.EnbPhy(ref_cell.Cell(n_prb=N_PRB, cell_id=pci), ref_stack.EnbStack())


def test_neighbour_rsrp_of_a_two_cell_waveform():
    cell = ref_cell.Cell(n_prb=N_PRB, cell_id=SRC_PCI)
    rp, pp, _ = both_phys(cell)
    for p in (rp, pp):
        p.configure_neighbor_meas([NEW_PCI, ABSENT_PCI])
    serving, neigh = broadcast_enb(SRC_PCI), broadcast_enb(NEW_PCI)
    rng = np.random.default_rng(3)
    for tti in range(12):
        dl = serving.build_dl_subframe(tti) + 2.0 * neigh.build_dl_subframe(tti)
        dl = dl + noise(rng, dl.shape)
        rp.work(tti, dl)
        pp.work(tti, dl)
        assert pp.serving_rsrp_dbm == pytest.approx(rp.serving_rsrp_dbm, abs=DB_ATOL), tti
        assert pp.neighbor_rsrp_dbm.keys() == rp.neighbor_rsrp_dbm.keys() == {
            NEW_PCI, ABSENT_PCI}
        for pci, v in rp.neighbor_rsrp_dbm.items():
            assert pp.neighbor_rsrp_dbm[pci] == pytest.approx(v, abs=DB_ATOL), (tti, pci)
    # the neighbour's CRS at 4x the power, the absent PCI far below both
    lift = pp.neighbor_rsrp_dbm[NEW_PCI] - pp.serving_rsrp_dbm
    assert 20 * np.log10(2.0) - 1.5 < lift < 20 * np.log10(2.0) + 1.5, lift
    assert pp.neighbor_rsrp_dbm[ABSENT_PCI] < pp.serving_rsrp_dbm - 6.0


def paging_subframe(cell, tti, pcch):
    """A subframe with a DCI 1C at P-RNTI in the common space and the PCCH on
    the PDSCH it grants (port host transmitter)."""
    sf = tti % 10
    tbs_idx = next(i for i, t in enumerate(dci.TBS_1C) if t >= 8 * len(pcch))
    d = dci.Dci1C(riv=dci.riv_encode(cell.n_prb // 2, 1, 3), tbs_idx=tbs_idx)
    grant = dci.dci1c_to_grant(cell, d)
    grid = enb_tx.empty_grid(cell)
    enb_tx.add_crs(cell, grid, sf, 0)
    control.pcfich_map(cell, grid, sf, CFI)
    control.pdcch_map(cell, grid, sf, CFI, dci.pack_1c(cell.n_prb, d), P_RNTI, 0, 4)
    codec = pdsch_codec(cell, grant, P_RNTI, sf, CFI, device="cpu")
    bits = np.zeros(grant.tbs, np.uint8)
    pb = np.unpackbits(np.frombuffer(pcch, np.uint8))
    bits[:len(pb)] = pb
    codec.map_to_grid(grid, codec.encode_symbols(bits))
    return enb_tx.to_waveform(cell, [grid])[0], d


def test_paging_dci_1c_found_at_the_paging_occasion_only(monkeypatch):
    cell = ref_cell.Cell(n_prb=N_PRB, cell_id=SRC_PCI)
    rp, pp, (rue, pue) = both_phys(cell, with_ue=True)
    imsi = pue.usim.get_imsi()
    assert imsi == rue.usim.get_imsi()
    ue_id, t_drx = int(imsi) % 1024, 32
    for p in (rp, pp):
        p.configure_paging(ue_id, t_drx=t_drx, n_b_t=1.0)
    occ = [t for t in range(t_drx * 10) if paging_occasion(t, ue_id, n_b_t=1.0, t_drx=t_drx)]
    assert len(occ) == 1
    logs = {"ref": [], "port": []}
    for key, mod in (("ref", ref_control), ("port", control)):
        orig = mod.pdcch_blind_decode

        def logged(*a, _orig=orig, _log=logs[key], **kw):
            hits = _orig(*a, **kw)
            if a[5] == P_RNTI:
                _log.append((a[6], [(int(s), int(l), np.asarray(b, np.uint8).tobytes())
                                    for s, l, b in hits]))
            return hits

        monkeypatch.setattr(mod, "pdcch_blind_decode", logged)
    pcch = EnbStack().make_paging(imsi)
    rng = np.random.default_rng(1)
    found = {}
    for tti in range(occ[0] - 3, occ[0] + 4):
        wf, d = paging_subframe(port_cell_of(cell), tti, pcch)
        wf = wf + noise(rng, wf.shape)
        n0 = len(logs["port"])
        rp.work(tti, wf)
        pp.work(tti, wf)
        assert logs["port"] == logs["ref"], tti
        found[tti] = logs["port"][n0:]
    size_1c = dci.size_1c(N_PRB)
    for tti, searches in found.items():
        if tti != occ[0]:
            assert searches == [], tti  # no P-RNTI search off the occasion
            continue
        assert [n for n, _ in searches] == [dci.size_0_1a(N_PRB), size_1c]
        hits_1c = searches[1][1]
        assert searches[0][1] == [] and len(hits_1c) == 1
        bits = np.frombuffer(hits_1c[0][2], np.uint8)
        assert dci.unpack_1c(N_PRB, bits) == d
    assert rue.rrc.paged and pue.rrc.paged and pue.nas.paging_pending


def test_subband_snr_of_a_two_tap_channel():
    cell = ref_cell.Cell(n_prb=N_PRB, cell_id=SRC_PCI)
    rp, pp, _ = both_phys(cell)
    for p in (rp, pp):
        p.configure_cqi(3, 5, subband_k=1)
    enb = broadcast_enb(SRC_PCI)
    taps = np.array([1.0, 0.0, 0.85], np.complex64)
    for tti in range(6):
        dl = enb.build_dl_subframe(tti)
        dl = np.convolve(dl, taps)[:len(dl)].astype(np.complex64)
        rp.work(tti, dl)
        pp.work(tti, dl)
        np.testing.assert_allclose(pp.ul_ctrl.subband_snr_db, rp.ul_ctrl.subband_snr_db,
                                   atol=DB_ATOL, err_msg=f"TTI {tti}")
    # the labels the reports carry follow the channel's strong subbands
    nfft, half = cell.nfft, cell.n_sc // 2
    hf = np.fft.fft(taps, nfft)
    gain_sc = np.abs(hf[np.r_[nfft - half:nfft, 1:half + 1]]) ** 2
    n_sb = ue_ul_ctrl.subband_count(N_PRB)
    k_sc = 12 * ue_ul_ctrl.subband_geometry(N_PRB)[0]
    exp_sb = [gain_sc[s * k_sc:(s + 1) * k_sc].mean() for s in range(n_sb)]
    for j in range(2):
        lo, hi = ue_ul_ctrl.part_subbands(N_PRB, j)
        assert (int(np.argmax(pp.ul_ctrl.subband_snr_db[lo:hi]))
                == int(np.argmax(exp_sb[lo:hi])))
    assert dataclasses.asdict(pp.ul_ctrl.cfg) == dataclasses.asdict(rp.ul_ctrl.cfg)
