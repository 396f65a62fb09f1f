"""The whole receive slice of the torch port against the JAX reference, on
the same noisy IQ made by the reference transmitter (the configurations
of tests/test_pdsch_e2e.py::_run_chain, plus a grant with filler bits).

Soft values agree to float32 rounding: grids and channel estimates to
rtol 1e-5 (floor 1e-5 of the peak), LLRs and softbuffers to rtol 1e-4
(floor 1e-4 of the peak; see test_torch_frontend.py). Decisions -- tb_ok,
blk_ok and iterations -- are equal, and so are the payload bits of every
transport block that passes its CRC. The hard bits of a block that never
converges are not a decision: eight turbo iterations below threshold
amplify float32 rounding into different bits. So the reference's own
softbuffers are also fed to the port's decoder, which must then reproduce
every output bit for bit, CRC failures included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import chest as ref_chest
from srsue_tpu.phy import enb_tx as ref_tx
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy.cell import Cell, DlGrant
from srsue_tpu.phy.pdsch import PdschCodec as RefCodec
from srsue_tpu_torch.phy import chest, enb_tx, equalize, ofdm
from srsue_tpu_torch.phy.pdsch import PdschCodec


def _close(got, ref, rtol, floor):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * np.abs(ref).max())


def _iq(cell, codec, payloads, snr_db, rng):
    tds = np.stack([ref_tx.to_waveform(cell, ref_tx.build_pdsch_subframe(cell, codec, p))[0]
                    for p in payloads])
    p_sig = float(np.mean(np.abs(tds) ** 2)) * cell.nfft / cell.n_sc
    noisy, _ = ref_tx.awgn(rng, tds, snr_db, signal_power=p_sig)
    return noisy


CASES = {
    "1p4mhz_qpsk": (Cell(n_prb=6, cell_id=17), 5, 1, 20.0, 0, None),
    "5mhz_multi_codeblock": (Cell(n_prb=25, cell_id=301), 17, 3, 22.0, 0, None),
    "rv2": (Cell(n_prb=6, cell_id=5), 6, 4, 20.0, 2, None),
    "subframe0": (Cell(n_prb=6, cell_id=2), 4, 0, 20.0, 0, None),
    "crc_fail": (Cell(n_prb=6, cell_id=17), 9, 1, -3.0, 0, None),
    "filler_bits": (Cell(n_prb=6, cell_id=17), 5, 1, 20.0, 0, 500),
}


@pytest.mark.parametrize("name", list(CASES))
def test_slice_matches_reference(name):
    cell, mcs, subframe, snr_db, rv, tbs = CASES[name]
    grant = ref_ra.dl_grant(cell.n_prb, mcs, rv=rv)
    if tbs is not None:  # TBS 500 -> K=528 with 4 filler bits
        grant = DlGrant(grant.n_prb, grant.prb_start, mcs, grant.mod_order, tbs, rv)
    ref = RefCodec(cell, grant, rnti=0x1234, subframe=subframe, cfi=1)
    mine = PdschCodec(cell, grant, rnti=0x1234, subframe=subframe, cfi=1)
    if tbs is not None:
        assert mine.plan.f > 0
    rng = np.random.default_rng(0)
    payloads = np.stack([rng.integers(0, 2, grant.tbs).astype(np.uint8) for _ in range(2)])
    noisy = _iq(cell, ref, payloads, snr_db, rng)

    # reference chain, stage by stage
    g_r = ref_ofdm.demodulate(cell, jnp.asarray(noisy))
    h_r, nv_r, _ = ref_chest.estimate(cell, g_r, subframe, port=0)
    x_r, nve_r = ref_eq.zf(ref.extract_re(g_r), ref.extract_re(h_r), nv_r)
    llr_r = ref.demap_llrs(x_r, nve_r)
    bufs_r = ref.dematch(llr_r)
    out_r = [np.asarray(v) for v in ref.decode_softbuffers(bufs_r)]

    # port chain
    g = ofdm.demodulate(cell, torch.as_tensor(noisy))
    h, nv, _ = chest.estimate(cell, g, subframe, port=0)
    x, nve = equalize.zf(mine.extract_re(g), mine.extract_re(h), nv)
    llr = mine.demap_llrs(x, nve)
    bufs = mine.dematch(llr)
    out = [v.numpy() for v in mine.decode_softbuffers(bufs)]
    for a, b in zip(mine.decode(x, nve), out, strict=True):  # the same in one call
        np.testing.assert_array_equal(a.numpy(), b)

    _close(g.numpy(), g_r, 1e-5, 1e-5)
    _close(h.numpy(), h_r, 1e-5, 1e-5)
    _close(x.numpy(), x_r, 1e-4, 1e-4)
    _close(llr.numpy(), llr_r, 1e-4, 1e-4)
    for a, b in zip(bufs, bufs_r, strict=True):
        _close(a.numpy(), b, 1e-4, 1e-4)
    for a, b in zip(out[1:], out_r[1:], strict=True):  # tb_ok, blk_ok, iters
        np.testing.assert_array_equal(a, b)
    ok = out[1]
    np.testing.assert_array_equal(out[0][ok], out_r[0][ok])

    # the reference's own softbuffers through the port's decoder
    same_in = mine.decode_softbuffers([torch.as_tensor(np.array(b)) for b in bufs_r])
    for a, b in zip(same_in, out_r, strict=True):
        np.testing.assert_array_equal(a.numpy(), b)

    if snr_db < 0:
        assert not ok.any()
    else:
        assert ok.all()
        np.testing.assert_array_equal(out[0], payloads)


def test_port_transmitter_makes_reference_waveform():
    cell = Cell(n_prb=25, cell_id=301)
    grant = ref_ra.dl_grant(cell.n_prb, 17)
    ref = RefCodec(cell, grant, rnti=0x1234, subframe=0, cfi=1)
    mine = PdschCodec(cell, grant, rnti=0x1234, subframe=0, cfi=1)
    payload = np.random.default_rng(2).integers(0, 2, grant.tbs).astype(np.uint8)
    for a, b in zip(enb_tx.build_pdsch_subframe(cell, mine, payload),
                    ref_tx.build_pdsch_subframe(cell, ref, payload), strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(enb_tx.to_waveform(cell, [a])[0],
                                      ref_tx.to_waveform(cell, [b])[0])


@pytest.mark.slow
def test_entry_20mhz_mcs28_matches_reference():
    """The flagship step (100 PRB, MCS 28, TBS 75376, 13 blocks of K=5824)
    at B=1 on the reference's own IQ: equal payload, tb_ok and iterations."""
    import __graft_entry__
    from srsue_tpu.utils.jaxutil import iq_complex
    from srsue_tpu_torch import entry

    fn_r, (iq_p,) = __graft_entry__.entry()
    pay_r, ok_r, it_r = (np.asarray(v) for v in jax.jit(fn_r)(iq_p))
    fn, (iq,), payloads = entry.entry("cpu", batch=1)
    np.testing.assert_array_equal(iq.numpy(), np.asarray(iq_complex(jnp.asarray(iq_p))))
    pay, ok, it = fn(iq)
    assert ok_r.all() and ok.numpy().all()
    np.testing.assert_array_equal(pay.numpy(), pay_r.astype(np.uint8))
    np.testing.assert_array_equal(pay.numpy(), payloads)
    np.testing.assert_array_equal(it.numpy(), it_r)
