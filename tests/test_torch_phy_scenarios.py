"""The reference's PHY scenarios on the port, decisions equal to the
reference's on the same seeded inputs:

* ``tests/test_dci1c.py``: DCI format 1C pack/unpack at 25/50/100 PRB, its
  grant, and the blind decode at SI-RNTI with the 1C size;
* ``tests/test_phy_attach.py``: waveform-level random access (PRACH
  detect -> RAR found by the blind RA-RNTI search -> Msg3 on PUSCH decoded
  by the eNB -> Msg4 contention resolution), run through each package's
  own modules, every decision and byte equal;
* ``tests/test_chest_adaptive.py``: the delay-spread-adaptive pilot filter
  at the port's fixed defaults (denoising and the adaptive pick on): its
  pick per channel, its MSE equal to the reference's adaptive MSE, and the
  reference's MSE ordering against raw LS and the fixed 3-tap filter.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsue_tpu.phy.chest as ref_chest
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import control as ref_control
from srsue_tpu.phy import dci as ref_dci
from srsue_tpu.phy import enb_tx as ref_enb_tx
from srsue_tpu.phy import equalize as ref_equalize
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu_torch.phy import chest, control, dci, enb_tx, equalize, ofdm, regrid
from srsue_tpu_torch.phy.cell import Cell


def _mine(obj):
    return type(obj).__name__, dataclasses.astuple(obj)


# ------------------------------------------------------------------ DCI 1C
@pytest.mark.parametrize("n_rb", [25, 50, 100])
def test_dci1c_pack_unpack(n_rb):
    d = dci.Dci1C(riv=7, tbs_idx=17, gap=0)
    bits = dci.pack_1c(n_rb, d)
    assert len(bits) == dci.size_1c(n_rb) == ref_dci.size_1c(n_rb)
    np.testing.assert_array_equal(bits, ref_dci.pack_1c(n_rb, ref_dci.Dci1C(riv=7, tbs_idx=17,
                                                                              gap=0)))
    assert dci.unpack_1c(n_rb, bits) == d


def test_dci1c_grant():
    cell = Cell(n_prb=50, cell_id=1)
    d = dci.Dci1C(riv=dci.riv_encode(50 // 4, 1, 2), tbs_idx=10)
    g = dci.dci1c_to_grant(cell, d)
    assert g.prb_start == 4 and g.n_prb == 8 and g.tbs == dci.TBS_1C[10] and g.mod_order == 2
    ref = ref_dci.dci1c_to_grant(ref_cell.Cell(n_prb=50, cell_id=1),
                                 ref_dci.Dci1C(riv=d.riv, tbs_idx=10))
    assert _mine(g) == _mine(ref)


def test_dci1c_blind_decode_si_equals_the_reference():
    """A 1C DCI at SI-RNTI found by the blind search with the 1C size, the
    same candidate and bits as the reference on the same noisy subframe."""
    cell = Cell(n_prb=50, cell_id=17)
    rcell = ref_cell.Cell(n_prb=50, cell_id=17)
    rng = np.random.default_rng(0)
    subframe, cfi = 5, 2
    d = dci.Dci1C(riv=dci.riv_encode(50 // 4, 0, 3), tbs_idx=12)
    grid = enb_tx.empty_grid(cell)
    enb_tx.add_crs(cell, grid, subframe, 0)
    control.pcfich_map(cell, grid, subframe, cfi)
    control.pdcch_map(cell, grid, subframe, cfi, dci.pack_1c(50, d), 0xFFFF, 0, 8)
    td = enb_tx.to_waveform(cell, [grid])[0]
    p = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    noisy, _ = enb_tx.awgn(rng, td[None], 10, signal_power=p)

    g = ofdm.demodulate(cell, torch.as_tensor(noisy[0]))
    h, nvar, _ = chest.estimate(cell, g, subframe, port=0)
    g_eq, nv = equalize.zf(g, h, nvar)
    hits = control.pdcch_blind_decode(cell, g_eq, nv, subframe, cfi, 0xFFFF, dci.size_1c(50),
                                      ue_specific=False)
    rg = ref_ofdm.demodulate(rcell, jnp.asarray(noisy[0]))
    rh, rnvar, _ = ref_chest.estimate(rcell, rg, subframe, port=0)
    rg_eq, rnv = ref_equalize.zf(rg, rh, rnvar)
    ref_hits = ref_control.pdcch_blind_decode(rcell, rg_eq, rnv, subframe, cfi, 0xFFFF,
                                              ref_dci.size_1c(50), ue_specific=False)
    assert hits and dci.unpack_1c(50, hits[0][2]) == d

    def key(hs):
        return [(int(s), int(l), np.asarray(b, np.uint8).tobytes()) for s, l, b in hs]

    assert key(hits) == key(ref_hits)


# ------------------------------------------------- waveform random access
class WaveformPhy:
    """The phy interface of ``tests/test_phy_attach.py``: synthesises the
    PRACH with the package's own ``prach.waveform``."""

    def __init__(self, cell, prach):
        self.cell, self.prach = cell, prach
        self.tx_prach, self.ta, self.rar_search, self.crnti_search = [], None, None, None

    def sync_start(self):
        pass

    def sr_opportunity(self, tti):
        return False

    def sr_send(self, tti):
        pass

    def prach_send(self, preamble_idx, power, tti):
        self.tx_prach.append((tti, self.prach.waveform(self.cell, root_seq_index=128,
                                                        zero_corr=5,
                                                        preamble_idx=preamble_idx)))
        return tti

    def pdcch_dl_search_rar(self, ra_rnti, start, window):
        self.rar_search = (ra_rnti, start, window)

    def pdcch_dl_search_temp_crnti(self, t_crnti):
        self.temp_crnti = t_crnti

    def pdcch_dl_search_crnti(self, crnti):
        self.crnti_search = crnti

    def set_timeadv(self, ta):
        self.ta = ta

    def get_headroom_db(self):
        return 20.0

    def configure_ul_params(self, sib2):
        pass


class FakeRlcCcch:
    """A canned ConnectionRequest on CCCH (``tests/test_phy_attach.py``)."""

    def __init__(self):
        self.ccch, self.delivered = b"", []

    def get_buffer_state(self, lcid):
        return len(self.ccch) if lcid == 0 else 0

    def read_pdu(self, lcid, n):
        if lcid == 0 and self.ccch and len(self.ccch) <= n:
            out, self.ccch = self.ccch, b""
            return out
        return b""

    def write_pdu(self, lcid, data):
        self.delivered.append((lcid, data))

    def write_pdu_bcch_dlsch(self, data):
        self.delivered.append(("bcch", data))


def rach_flow(pkg: str) -> dict:
    """The random access of ``tests/test_phy_attach.py`` through the modules
    of `pkg` ("srsue_tpu" or "srsue_tpu_torch", the latter on the CPU):
    its decisions and bytes, with the reference test's assertions."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    port = pkg == "srsue_tpu_torch"
    dev = {"device": "cpu"} if port else {}
    pdu_mod, d_, e_, c_, ra_, pr_ = (mod(n) for n in (
        "mac.pdu", "phy.dci", "phy.enb_tx", "phy.control", "phy.ra", "phy.prach"))
    cells = mod("phy.cell")
    cell = cells.Cell(n_prb=25, cell_id=123)
    phy = WaveformPhy(cell, pr_)
    mac = mod("mac.mac").Mac(rlc=FakeRlcCcch(), phy=phy)
    ue_dl = mod("phy.ue_dl").UeDl(cell, **dev)
    rng = np.random.default_rng(0)
    out = {}

    # Msg1
    conn_req = b"\x5a" * 6 + b"\x01\x02"
    mac.start_ra(conn_req)
    for tti in range(4):
        mac.run_tti(tti)
    assert phy.tx_prach, "no PRACH transmitted"
    ptti, wf = phy.tx_prach[0]
    noisy = wf + 0.02 * (rng.standard_normal(wf.shape)
                         + 1j * rng.standard_normal(wf.shape)).astype(np.complex64)
    hits = pr_.detect(cell, noisy, 128, 5)
    assert hits, "eNB missed the preamble"
    detected = max(hits, key=lambda h: h[1])[0]
    assert detected == mac.ra.preamble_idx
    out["prach"] = (ptti, [int(h[0]) for h in hits], detected)

    # Msg2: the RAR on PDSCH at RA-RNTI, found by the blind search
    ra_rnti, start, window = phy.rar_search
    assert ra_rnti == 1 + (ptti % 10)
    grant20 = pdu_mod.RarGrant(False, riv=d_.riv_encode(25, 0, 4) & 0x3FF, mcs=4, tpc=0,
                               ul_delay=False, cqi_req=False)
    rar_bytes = pdu_mod.pack_rar_pdu([pdu_mod.Rar(detected, ta=11, grant=grant20,
                                                  t_crnti=0x4601)], backoff=None, pdu_len=56)
    sf, cfi = 6, 2
    g = ra_.dl_grant(cell.n_prb, 3, n_prb_alloc=6)
    codec = mod("phy.pdsch").PdschCodec(cell, g, ra_rnti, sf, cfi, **dev)
    grid = e_.empty_grid(cell)
    e_.add_crs(cell, grid, sf, 0)
    c_.pcfich_map(cell, grid, sf, cfi)
    d1a = d_.Dci1A(riv=d_.riv_encode(25, 0, 6), mcs=3, harq_pid=0, ndi=False, rv=0, tpc=0)
    c_.pdcch_map(cell, grid, sf, cfi, d_.pack_1a(25, d1a), ra_rnti, 0, 4)
    bits = np.zeros(g.tbs, np.uint8)
    pb = np.unpackbits(np.frombuffer(rar_bytes, np.uint8))[:g.tbs]
    bits[:len(pb)] = pb
    codec.map_to_grid(grid, codec.encode_symbols(bits))
    td = e_.to_waveform(cell, [grid])[0]
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    noisy_dl, _ = e_.awgn(rng, td[None], 18, signal_power=p_sig)
    res = ue_dl.process(noisy_dl, sf, ra_rnti, ue_specific=False)
    assert res.grants and np.asarray(res.tb_ok).all(), "RAR PDSCH decode failed"
    rar_rx = np.packbits(np.asarray(res.payload[0], np.uint8)).tobytes()[:len(rar_bytes)]
    mac.ra.rar_received(rar_rx)
    assert mac.ra.state.name == "CONTENTION_RESOLUTION" and phy.ta == 11
    out["rar"] = (res.cfi, [_mine(gr) for gr in res.grants], rar_rx,
                  np.asarray(res.turbo_iters).tolist(), phy.ta)

    # Msg3: the UE's PUSCH, decoded by the eNB
    msg3_tx = mac.new_grant_ul(ptti + 6, grant_bytes=24)
    assert msg3_tx is not None
    ug = cells.UlGrant(n_prb=4, prb_start=0, mcs=2, mod_order=2, tbs=24 * 8)
    pc = mod("phy.pusch").PuschCodec(cell, ug, rnti=0x4601, subframe=(sf + 2) % 10, **dev)
    ul_td = pc.encode_sf(np.unpackbits(np.frombuffer(msg3_tx.payload, np.uint8)))
    ul_noisy = ul_td + 0.01 * (rng.standard_normal(ul_td.shape)
                               + 1j * rng.standard_normal(ul_td.shape)).astype(np.complex64)
    if port:
        got, ok, _ = pc.decode_sf(torch.as_tensor(ul_noisy[None]), noise_var=1e-4)
        got, ok = got.numpy(), ok.numpy()
    else:
        from srsue_tpu.utils.jaxutil import to_host

        got, ok = pc.decode_sf(jnp.asarray(ul_noisy[None]), noise_var=1e-4)
        got, ok = to_host(got), to_host(ok)
    assert bool(ok.all()), "eNB failed to decode Msg3 PUSCH"
    msg3_rx = np.packbits(got[0].astype(np.uint8)).tobytes()
    ccch = [s.payload for s in pdu_mod.unpack(msg3_rx, uplink=True).subheaders if s.lcid == 0]
    assert ccch and ccch[0] == conn_req
    out["msg3"] = (ul_td.tobytes(), msg3_rx)

    # Msg4: contention resolution
    m4 = pdu_mod.MacPdu()
    m4.add_ce(pdu_mod.LCID_CON_RES, ccch[0][:6])
    mac._deliver_temp_crnti = True
    mac._deliver(0, pdu_mod.pack(m4, 32))
    assert mac.crnti == 0x4601 and phy.crnti_search == 0x4601
    out["msg4"] = (mac.crnti, mac.ra.state.name)
    return out


def test_phy_level_rach_and_msg3_equal_the_reference():
    """Each MAC draws its preamble from its own ``random.Random(0)``."""
    assert rach_flow("srsue_tpu_torch") == rach_flow("srsue_tpu")


# -------------------------------------------------- adaptive pilot filter
CHANNELS = {  # name: (taps, SNR dB, seed, the pick the reference's test names)
    "flat": (np.array([1.0], np.complex64), 10.0, 0, 5),
    "long_delay_spread": (np.r_[1.0, np.zeros(39), 0.8, np.zeros(23)].astype(np.complex64),
                          20.0, 1, 0),
    "mid_selectivity": (np.r_[1.0, np.zeros(7), 0.6].astype(np.complex64), 12.0, 2, 3),
}


def _faded_grids(cell, taps, snr_db, seed, n_sf=8):
    """``tests/test_chest_adaptive.py::_mse``'s subframes: CRS and random
    QPSK on a static multipath channel, n_sf noise draws; (h_true, grids)."""
    taps = taps / np.sqrt(np.sum(np.abs(taps) ** 2))
    rng = np.random.default_rng(seed)
    grid = ref_enb_tx.empty_grid(cell)
    ref_enb_tx.add_crs(cell, grid, 2, 0)
    empty = grid == 0
    grid[empty] = ((rng.integers(0, 2, empty.sum()) * 2 - 1)
                   + 1j * (rng.integers(0, 2, empty.sum()) * 2 - 1)).astype(np.complex64) / \
        np.sqrt(2)
    hf = np.fft.fft(taps, cell.nfft)
    half = cell.n_sc // 2
    h_true = hf[np.r_[cell.nfft - half:cell.nfft, 1:half + 1]].astype(np.complex64)
    faded = grid * h_true[None, :]
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    return h_true, [(faded + sigma * (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(
        grid.shape)).astype(np.complex64)).astype(np.complex64) for _ in range(n_sf)]


def _ref_mse(cell, h_true, grids, denoise, adapt, monkeypatch):
    """The reference's estimation MSE at the CRS symbols with its stage
    switches set as its own test sets them."""
    monkeypatch.setattr(ref_chest, "_DENOISE", denoise)
    monkeypatch.setattr(ref_chest, "_ADAPT", adapt)
    syms = list(regrid.crs_symbols(Cell(**dataclasses.asdict(cell)), 0))
    return float(np.mean([np.mean(np.abs(np.asarray(ref_chest.estimate(
        cell, jnp.asarray(g), 2)[0])[syms] - h_true) ** 2) for g in grids]))


@pytest.mark.parametrize("name", CHANNELS)
def test_adaptive_filter_pick_and_mse_ordering_at_the_ports_defaults(name, monkeypatch):
    taps, snr_db, seed, want_pick = CHANNELS[name]
    rcell = ref_cell.Cell(n_prb=25, cell_id=31)
    cell = Cell(n_prb=25, cell_id=31)
    h_true, grids = _faded_grids(rcell, taps, snr_db, seed)
    syms = list(regrid.crs_symbols(cell, 0))
    errs, picks = [], []
    for g in grids:
        gt = torch.as_tensor(g)
        errs.append(np.mean(np.abs(chest.estimate(cell, gt, 2)[0].numpy()[syms] - h_true) ** 2))
        h_sym = chest.pilot_ls(cell, gt, 2)
        _, nvar, _ = chest.estimate(cell, gt, 2)
        picks.append(int(chest._pilot_filter(h_sym, nvar, float(h_sym.shape[-2]))[1]))
    port = float(np.mean(errs))
    adaptive = _ref_mse(rcell, h_true, grids, True, True, monkeypatch)
    raw = _ref_mse(rcell, h_true, grids, False, False, monkeypatch)
    fixed3 = _ref_mse(rcell, h_true, grids, True, False, monkeypatch)
    assert port == pytest.approx(adaptive, rel=1e-4)
    assert max(set(picks), key=picks.count) == want_pick, picks
    if name == "flat":  # denoising kept: at least as good as the fixed 3-tap
        assert fixed3 < 0.6 * raw and port <= fixed3 * 1.05, (port, fixed3, raw)
    elif name == "long_delay_spread":  # the 3-tap's bias dominates: back off
        assert fixed3 > 2.0 * raw and port < 0.6 * fixed3 and port <= 1.3 * raw
    else:  # the 3-tap wins, and the pick tracks it
        assert fixed3 < raw and port <= fixed3 * 1.1, (port, fixed3, raw)
