"""2-port transmit diversity (TM2) of the torch port against the JAX
reference: Alamouti combining and precoding, the SFBC control region, the
port-1 channel estimate, the TM2 transmitter, the TM2 data chain of
``rx.make_tm2_rx`` and ``UeDl`` on a 2-port cell.

Exact: host-side mappings, CFI, DCI hits, grants, TB bits, CRC verdicts,
turbo iterations, the pilot filter's pick. Float32 soft values (combined
symbols, noise, channel estimates) to rtol 1e-5 with a floor of 1e-5 of the
array's peak, as tests/test_torch_frontend.py holds the single-port ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from srsue_tpu.phy import chest as ref_chest
from srsue_tpu.phy import control as ref_control
from srsue_tpu.phy import dci as ref_dci
from srsue_tpu.phy import enb_tx as ref_enb_tx
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.pdsch import PdschCodec as RefCodec
from srsue_tpu.phy.ue_dl import UeDl as RefUeDl
from srsue_tpu_torch import rx
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import chest, control, enb_tx, equalize
from srsue_tpu_torch.phy.pdsch import PdschCodec
from srsue_tpu_torch.phy.ue_dl import UeDl


def _mine(obj):
    """The port's own Cell or DlGrant with the fields of the reference's."""
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _close(got, ref, rtol=1e-5, floor=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * np.abs(ref).max())


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ------------------------------------------------------------------ Alamouti
@pytest.mark.parametrize("noise", ["batch", "scalar", "float"])
def test_alamouti_combine_matches_reference(noise):
    """[B, n_re] inputs with [B] noise (one trailing axis, as the reference
    broadcasts it), a 0-dim tensor and a Python float."""
    rng = np.random.default_rng(0)
    y, h0, h1 = (_cplx(rng, 3, 240) for _ in range(3))
    h0[0, :6] = 1e-8  # both ports faded: the clamp on |g0|^2 + |g1|^2
    h1[0, :6] = 1e-8
    nv = {"batch": np.array([0.01, 0.1, 1.0], np.float32), "scalar": np.float32(0.05),
          "float": 0.05}[noise]
    nv_t = nv if noise == "float" else torch.as_tensor(nv)
    x, nve = equalize.alamouti_combine(*(torch.as_tensor(a) for a in (y, h0, h1)), nv_t)
    x_r, nve_r = ref_eq.alamouti_combine(*(jnp.asarray(a) for a in (y, h0, h1)),
                                         nv if noise == "float" else jnp.asarray(nv))
    assert x.shape == nve.shape == (3, 240)
    _close(x.numpy(), x_r)
    _close(nve.numpy(), nve_r)
    one = equalize.alamouti_combine(*(torch.as_tensor(a[0]) for a in (y, h0, h1)), 0.05)
    one_r = ref_eq.alamouti_combine(*(jnp.asarray(a[0]) for a in (y, h0, h1)), 0.05)
    _close(one[0].numpy(), one_r[0])
    _close(one[1].numpy(), one_r[1])


def test_alamouti_precode_matches_reference_and_inverts():
    rng = np.random.default_rng(1)
    x = _cplx(rng, 2, 64)
    p0, p1 = equalize.alamouti_precode(x)  # the port's one precoder, host numpy
    p0_r, p1_r = ref_eq.alamouti_precode(jnp.asarray(x))
    _close(p0, p0_r)
    _close(p1, p1_r)
    # the reference's control-region precoder, row by row: equal bit for bit
    for row in range(2):
        c0_r, c1_r = ref_control._sfbc_precode(x[row])
        np.testing.assert_array_equal(p0[row], c0_r)
        np.testing.assert_array_equal(p1[row], c1_r)
    assert p0.dtype == p1.dtype == np.complex64
    # flat channels g0, g1 per batch element: combine(precode(x)) = x
    g = torch.as_tensor(_cplx(rng, 2, 2, 1))
    y = torch.as_tensor(p0) * g[0] + torch.as_tensor(p1) * g[1]
    back, nve = equalize.alamouti_combine(y, g[0].expand_as(y), g[1].expand_as(y), 0.0)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-5)
    assert not nve.any()


# ------------------------------------------------------ SFBC control region
@pytest.mark.parametrize("n_prb,cell_id", [(15, 150), (6, 33), (25, 301)])
def test_tm2_control_mapping_matches_reference(n_prb, cell_id):
    cell = Cell(n_prb=n_prb, cell_id=cell_id, n_ports=2)
    mine = _mine(cell)
    np.testing.assert_array_equal(control._control_region_idx(mine),
                                  ref_control._control_region_idx(cell))
    idx = control._control_region_idx(mine)
    assert len(set(idx.tolist())) == len(idx)  # unique: the indexed writes are ordered
    sf, cfi, rnti = 3, 2, 0x7B7B
    d = ref_dci.Dci1A(riv=ref_dci.riv_encode(n_prb, 0, n_prb), mcs=9, harq_pid=0, ndi=True,
                      rv=0, tpc=0)
    bits = ref_dci.pack_1a(n_prb, d)
    got = [np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64) for _ in range(2)]
    ref = [np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64) for _ in range(2)]
    control.pcfich_map_tm2(mine, got, sf, cfi)
    control.pdcch_map_tm2(mine, got, sf, cfi, bits, rnti, 0, 4)
    ref_control.pcfich_map_tm2(cell, ref, sf, cfi)
    ref_control.pdcch_map_tm2(cell, ref, sf, cfi, bits, rnti, 0, 4)
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    one = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    one_r = one.copy()
    control.pdcch_map(mine, one, sf, cfi, bits, rnti, 0, 4)
    ref_control.pdcch_map(cell, one_r, sf, cfi, bits, rnti, 0, 4)
    np.testing.assert_array_equal(one, one_r)


def _tm2_subframe(cell, sf, cfi, rnti, mcs, snr_db, seed, batch=1, control_region=True):
    """`batch` noisy 2-port subframes from the reference's transmitter: CRS
    of both ports, SFBC PCFICH and DCI 1A at CCE 0 L=4 (tests/test_ue_dl.py's)
    unless `control_region` is off, and the SFBC PDSCH."""
    rng = np.random.default_rng(seed)
    grant = ref_ra.dl_grant(cell.n_prb, mcs)
    codec = RefCodec(cell, grant, rnti, sf, cfi)
    tds, pays = [], []
    for _ in range(batch):
        pays.append(rng.integers(0, 2, grant.tbs).astype(np.uint8))
        grids = [ref_enb_tx.empty_grid(cell) for _ in range(2)]
        for p in range(2):
            ref_enb_tx.add_crs(cell, grids[p], sf, p)
        if control_region:
            ref_control.pcfich_map_tm2(cell, grids, sf, cfi)
            d = ref_dci.Dci1A(riv=ref_dci.riv_encode(cell.n_prb, 0, cell.n_prb), mcs=mcs,
                              harq_pid=0, ndi=True, rv=0, tpc=0)
            ref_control.pdcch_map_tm2(cell, grids, sf, cfi, ref_dci.pack_1a(cell.n_prb, d),
                                      rnti, 0, 4)
        codec.map_to_grid_tm2(grids, codec.encode_symbols(pays[-1]))
        tds.append(np.sum(ref_enb_tx.to_waveform(cell, grids), axis=0))
    td = np.stack(tds)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return ref_enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0], np.stack(pays), grant


@pytest.mark.parametrize("n_prb,cell_id", [(15, 150), (6, 33)])
def test_sfbc_equalize_control_and_port1_estimate_match_reference(n_prb, cell_id):
    """The 6 PRB cell's control region spans 4 symbols."""
    from srsue_tpu.phy import ofdm as ref_ofdm
    from srsue_tpu_torch.phy import ofdm

    cell = Cell(n_prb=n_prb, cell_id=cell_id, n_ports=2)
    mine = _mine(cell)
    sf, cfi = 3, 2
    iq, _, _ = _tm2_subframe(cell, sf, cfi, 0x7B7B, 4, 15.0, 3, batch=2)
    grid = ofdm.demodulate(mine, torch.as_tensor(iq))
    grid_r = ref_ofdm.demodulate(cell, jnp.asarray(iq))
    hs, hs_r = [], []
    for port in (0, 1):
        h, nvar, rsrp = chest.estimate(mine, grid, sf, port=port)
        h_r, nvar_r, rsrp_r = ref_chest.estimate(cell, grid_r, sf, port=port)
        _close(h.numpy(), h_r)
        _close(nvar.numpy(), nvar_r)
        _close(rsrp.numpy(), rsrp_r)
        hs.append(h)
        hs_r.append(h_r)
    nv = chest.estimate(mine, grid, sf, port=0)[1]
    g_eq, nv_grid = control.sfbc_equalize_control(mine, grid, hs[0], hs[1], nv)
    g_eq_r, nv_grid_r = ref_control.sfbc_equalize_control(
        cell, grid_r, hs_r[0], hs_r[1], ref_chest.estimate(cell, grid_r, sf, port=0)[1])
    assert g_eq.dtype == torch.complex64 and nv_grid.dtype == torch.float32
    _close(g_eq.numpy(), g_eq_r)
    np.testing.assert_allclose(nv_grid.numpy(), np.asarray(nv_grid_r), rtol=1e-4)
    idx = control._control_region_idx(mine)
    outside = np.setdiff1d(np.arange(cell.n_sym_sf * cell.n_sc), idx)
    assert not g_eq.reshape(2, -1)[:, outside].any()
    assert (nv_grid.reshape(2, -1)[:, outside] == 1e6).all()
    # the single-port decoders read the combined grid unchanged
    cfi_got, scores = control.pcfich_decode(mine, g_eq, nv_grid, sf)
    cfi_ref, scores_r = ref_control.pcfich_decode(cell, g_eq_r, nv_grid_r, sf)
    assert cfi_got.tolist() == np.asarray(cfi_ref).tolist() == [cfi, cfi]
    _close(scores.numpy(), scores_r, rtol=1e-4, floor=1e-4)
    one = control.sfbc_equalize_control(mine, grid[0], hs[0][0], hs[1][0], nv[0])
    _close(one[0].numpy(), g_eq_r[0])


# ------------------------------------------- the Doppler-biased noise estimate
def _doppler_grids(cell, subframe, fd, snr_db, seed):
    """A 2-port CRS-only grid through a two-path channel (delays 0 and 5
    samples) whose paths rotate by +fd and -fd cycles per OFDM symbol: with
    fd != 0 the channel's shape changes between CRS symbols."""
    rng = np.random.default_rng(seed)
    half = cell.n_sc // 2
    bins = np.concatenate([np.arange(cell.nfft - half, cell.nfft), np.arange(1, half + 1)])
    sym = np.arange(cell.n_sym_sf)[:, None]
    h = sum(a * np.exp(2j * np.pi * f * sym) * np.exp(-2j * np.pi * bins * d / cell.nfft)[None]
            for d, a, f in ((0, 1.0, fd), (5, 0.7, -fd))) / np.sqrt(1.49)
    out = np.zeros((cell.n_sym_sf, cell.n_sc), complex)
    for p in range(2):
        g = enb_tx.empty_grid(cell)
        enb_tx.add_crs(cell, g, subframe, p)
        out += g * h
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    return (out + sigma * (rng.standard_normal(out.shape) + 1j * rng.standard_normal(out.shape))
            ).astype(np.complex64)


def _selector_model(h_sym, n_eff):
    """The reference's filter selector (srsue_tpu/phy/chest.py, the adaptive
    branch of ``estimate``) in float64 numpy: 0, 3 or 5 per batch element."""
    h = np.asarray(h_sym, np.complex128)

    def shift(x, s):
        if s < 0:
            return np.concatenate([np.repeat(x[..., :1], -s, -1), x[..., :s]], -1)
        return np.concatenate([x[..., s:], np.repeat(x[..., -1:], s, -1)], -1)

    fir5 = (shift(h, -2) + 2 * shift(h, -1) + 2 * h + 2 * shift(h, 1) + shift(h, 2)) / 8
    a, b = h[..., 0:2, :], h[..., 2:4, :]
    corr = np.sum(b * np.conj(a), -1, keepdims=True)
    d = b * np.conj(corr / np.maximum(np.abs(corr), 1e-12)) - a
    nv = np.mean(np.abs(d) ** 2, axis=(-1, -2)) * 0.5
    d2 = h[..., 2:] - 2 * h[..., 1:-1] + h[..., :-2]
    b3 = np.maximum(np.mean(np.abs(d2) ** 2, axis=(-1, -2)) / 16 - 6 / 16 * nv, 0)
    b5 = np.maximum(np.mean(np.abs((fir5 - h)[..., 2:-2]) ** 2, axis=(-1, -2))
                    - 0.71875 * nv, 0)
    mse = np.stack([nv / n_eff, 0.375 * nv / n_eff + b3, 0.21875 * nv / n_eff + b5])
    pick3 = (mse[1] <= mse[0]) & (mse[1] <= mse[2])
    pick5 = (mse[2] < mse[0]) & (mse[2] < mse[1])
    return np.where(pick5, 5, np.where(pick3, 3, 0)), nv


@pytest.mark.parametrize("port", [0, 1])
def test_doppler_biased_noise_estimate_is_the_references(port):
    """The filter selector measures noise as the phase-aligned difference of
    CRS symbols two apart, which a channel whose shape changes within the
    subframe inflates: Doppler pushes the pick to the 5-tap FIR where the
    same channel, static, takes the 3-tap one (20 dB) or none (30 dB). The
    port keeps the reference's estimate: the same pick (the reference's
    selector in float64) and the same h on every input."""
    cell = Cell(n_prb=25, cell_id=31, n_ports=2)
    mine = _mine(cell)
    sf = 2
    cases = [(fd, snr) for snr in (20.0, 30.0) for fd in (0.0, 0.01, 0.04)]
    grids = np.stack([_doppler_grids(mine, sf, fd, snr, 1) for fd, snr in cases])
    h, nvar, _ = chest.estimate(mine, torch.as_tensor(grids), sf, port=port)
    h_r, nvar_r, _ = ref_chest.estimate(cell, jnp.asarray(grids), sf, port=port)
    _close(h.numpy(), h_r)
    _close(nvar.numpy(), nvar_r)
    h_sym = chest.pilot_ls(mine, torch.as_tensor(grids), sf, port)
    _, pick = chest._pilot_filter(h_sym, nvar, float(h_sym.shape[-2]))
    model, nv_pair = _selector_model(h_sym.numpy(), float(h_sym.shape[-2]))
    assert pick.tolist() == model.tolist() == [3, 5, 5, 0, 5, 5]
    # the time-pair noise measure itself: ~sigma^2 static, inflated by Doppler
    for i, (fd, snr) in enumerate(cases):
        sigma2 = 10 ** (-snr / 10)
        assert (nv_pair[i] < 1.3 * sigma2) if fd == 0 else (nv_pair[i] > 2 * sigma2), cases[i]


# ------------------------------------------------------------- transmitter
def test_tm2_transmitter_matches_reference():
    cell = Cell(n_prb=15, cell_id=150, n_ports=2)
    grant = ref_ra.dl_grant(cell.n_prb, 8)
    payload = np.random.default_rng(1).integers(0, 2, grant.tbs).astype(np.uint8)
    for sf in (2, 5):
        ref = ref_enb_tx.build_pdsch_subframe(cell, RefCodec(cell, grant, 0x10, sf, 1),
                                              payload, tm2=True)
        got = enb_tx.build_pdsch_subframe(
            _mine(cell), PdschCodec(_mine(cell), _mine(grant), 0x10, sf, 1, device="cpu"),
            payload, tm2=True)
        assert len(got) == len(ref) == 2
        np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    one = enb_tx.build_pdsch_subframe(
        _mine(cell), PdschCodec(_mine(cell), _mine(grant), 0x10, 2, 1, device="cpu"), payload)
    assert len(one) == 1


# -------------------------------------------------------------- rx.make_tm2_rx
@pytest.mark.parametrize("early_exit", [True, False])
def test_make_tm2_rx_matches_bench(early_exit):
    """bench.make_tm2_rx's chain at 15 PRB, MCS 8, B=3, 8 dB."""
    cell = Cell(n_prb=15, cell_id=150, n_ports=2)
    sf, rnti = 6, 0x1234
    iq, pays, grant = _tm2_subframe(cell, sf, 1, rnti, 8, 8.0, 2, batch=3,
                                    control_region=False)
    codec_r = RefCodec(cell, grant, rnti=rnti, subframe=sf, cfi=1, n_turbo_iters=8,
                       early_exit=early_exit)
    iq_p = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    ref = np.asarray(jax.jit(bench.make_tm2_rx(cell, codec_r, sf, pays.astype(np.float32)))(
        jnp.asarray(iq_p)))[0, :3].tolist()
    fn = rx.make_tm2_rx(_mine(cell), _mine(grant), sf, rnti, early_exit, device="cpu")
    got = {k: float(v) for k, v in rx.tb_stats(fn(torch.as_tensor(iq)), pays).items()}
    assert [got["n_ok"], got["bit_match"], got["mean_iters"]] == ref
    assert got["n_ok"] == 3 and got["bit_match"] == 1.0
    if early_exit:
        forced = rx.tb_stats(rx.make_tm2_rx(_mine(cell), _mine(grant), sf, rnti, True,
                                            forced=True, device="cpu")(torch.as_tensor(iq)), pays)
        assert float(forced["mean_iters"]) == float(forced["max_iters"]) == 8
        assert float(forced["n_ok"]) == 3 and float(forced["bit_match"]) == 1.0


@pytest.mark.slow
def test_build_tm2_matches_bench():
    """The flagship TM2 test vectors (100 PRB, MCS 28, 2 ports), host only:
    the payloads, waveforms, signal power and generator state of bench.py."""
    mine = rx.build_tm2(2)
    ref = bench.build_tm2(2)
    assert dataclasses.asdict(mine.cell) == dataclasses.asdict(ref[0])
    assert dataclasses.asdict(mine.grant) == dataclasses.asdict(ref[1])
    assert (mine.subframe, mine.rnti) == (ref[2], ref[3])
    np.testing.assert_array_equal(mine.payloads, ref[5])
    np.testing.assert_array_equal(mine.td, ref[6])
    assert mine.p_sig == ref[7]
    assert mine.rng.integers(0, 1 << 30) == ref[8].integers(0, 1 << 30)
    tiled = rx.build_tm2(3, n_distinct=2)
    np.testing.assert_array_equal(tiled.payloads, mine.payloads[[0, 1, 0]])
    np.testing.assert_array_equal(tiled.td[2], mine.td[0])


# ---------------------------------------------------------------------- UeDl
def test_uedl_decode_pdsch_two_ports_matches_reference():
    """tests/test_ue_dl.py's TM2 data path: 15 PRB, cell 150, MCS 8, 18 dB."""
    cell = Cell(n_prb=15, cell_id=150, n_ports=2)
    iq, pays, grant = _tm2_subframe(cell, 2, 1, 0x10, 8, 18.0, 1, batch=2,
                                    control_region=False)
    got = UeDl(_mine(cell), device="cpu").decode_pdsch(iq, _mine(grant), 0x10, 2, 1)
    ref = RefUeDl(cell).decode_pdsch(iq, grant, 0x10, 2, 1)
    for x, y in zip(got, ref, strict=True):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got[1].all()
    np.testing.assert_array_equal(got[0], pays)


def test_uedl_process_two_ports_matches_reference():
    """tests/test_ue_dl.py's TM2 control path: PCFICH and the blind DCI
    search through the SFBC-combined control region, PDSCH through Alamouti."""
    cell = Cell(n_prb=15, cell_id=150, n_ports=2)
    rnti, sf, cfi = 0x7B7B, 3, 2
    iq, pays, grant = _tm2_subframe(cell, sf, cfi, rnti, 9, 20.0, 3, batch=2)
    got = UeDl(_mine(cell), device="cpu").process(iq, sf, rnti)
    ref = RefUeDl(cell).process(iq, sf, rnti)
    assert got.cfi == ref.cfi == cfi

    def tup(x):
        return (type(x).__name__,) + dataclasses.astuple(x)

    assert [tup(g) for g in got.grants] == [tup(g) for g in ref.grants]
    assert len(got.grants) == 1 and got.grants[0].tbs == grant.tbs
    assert ([[(f, tup(d)) for f, d in e] for e in got.hits_per_elem]
            == [[(f, tup(d)) for f, d in e] for e in ref.hits_per_elem])
    for a, b in zip(got.decoded, ref.decoded, strict=True):
        for x, y in zip(a[1:], b[1:], strict=True):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert got.tb_ok.all()
    np.testing.assert_array_equal(got.payload, pays)
    for k in got.metrics:
        np.testing.assert_allclose(got.metrics[k], np.asarray(ref.metrics[k]), rtol=1e-4)
    none = UeDl(_mine(cell), device="cpu").process(iq, sf, rnti ^ 0x0F0F)
    assert none.cfi == cfi and none.grants == [] and none.payload is None
