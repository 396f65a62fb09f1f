"""The uplink shared channel of the torch port (``phy/pusch.py``) against the
JAX reference (``srsue_tpu/phy/pusch.py``), on the same seeded numpy inputs.

UE side, host numpy on both sides: codeword bits equal bit for bit and
waveforms within 1e-5 (in practice equal). eNB side: softbuffers within
rtol 1e-5 with a floor of 1e-5 of the buffer's peak (float32 rounding of
the FFTs, the ZF division and the demapper); decisions exactly equal: TB
CRC, every payload bit of a TB that passes, the ACK bit and the CQI bits.
The reference's own softbuffers through the port's decoder reproduce every
output bit, failing TBs included.

Shapes follow the CPU rule of the port's tests: a 1.4 MHz cell (6 PRB, MCS
9: one block of K=960) and one multi-block case at 5 MHz (25 PRB, MCS 16:
2 x K=3904), two subframes each. The reference decodes each case once per
module (a fixture), so that its compile is paid once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import pusch as ref_pusch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy.cell import Cell, UlGrant
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import pusch

RNTI, SUBFRAME, B = 0x1234, 2, 2
CQI = np.array([1, 0, 1, 1, 0, 1], np.uint8)
# a 3-tap channel inside the 6 PRB cell's 9-sample CP: |H_k|^2 spans > 10x
TAPS = {0: 1.0, 3: 0.7j, 7: -0.45}
HARQ_SNR_DB = 4.0  # 6 PRB MCS 9: rv0 alone fails, rv0 + rv2 passes


def _mine(obj):
    """The port's own Cell or UlGrant with the fields of the reference's."""
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _grant(n_prb: int, mcs: int, rv: int = 0) -> UlGrant:
    g = ref_ra.dl_grant(n_prb, mcs)  # as bench.py builds its UL grant
    return UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order,
                   tbs=g.tbs, rv=rv)


def _codecs(cell, grant, **kw):
    return (ref_pusch.PuschCodec(cell, grant, RNTI, SUBFRAME, **kw),
            pusch.PuschCodec(_mine(cell), _mine(grant), RNTI, SUBFRAME, device="cpu", **kw))


def _noisy(rng, cell, wave, snr_db, taps=None):
    """[B, sf_len] copies of one subframe through a channel, each with its own
    AWGN at snr_db per occupied subcarrier."""
    x = np.stack([wave] * B)
    if taps:
        h = np.zeros(max(taps) + 1, np.complex64)
        for d, g in taps.items():
            h[d] = g
        x = np.stack([np.convolve(w, h)[:len(w)] for w in x])
    nv = float(np.mean(np.abs(wave) ** 2)) * cell.nfft / cell.n_sc / 10 ** (snr_db / 10)
    n = rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
    return (x + n * np.sqrt(nv / 2)).astype(np.complex64)


# name: (cell, mcs, snr dB, (cqi bits, ack) or None, channel taps)
CASES = {
    "awgn": (Cell(n_prb=6, cell_id=17), 9, 12.0, None, None),
    "uci_ack": (Cell(n_prb=6, cell_id=17), 9, 12.0, (CQI[:4], True), None),
    "uci_nack": (Cell(n_prb=6, cell_id=5), 9, 12.0, (CQI, False), None),
    "freq_selective": (Cell(n_prb=6, cell_id=17), 9, 18.0, (CQI[:4], True), TAPS),
    "crc_fail": (Cell(n_prb=6, cell_id=17), 9, -3.0, None, None),
    "multi_block": (Cell(n_prb=25, cell_id=301), 16, 14.0, (CQI[:4], False), None),
}


@pytest.fixture(scope="module")
def runs():
    """Every case through both codecs: {name: dict of inputs and outputs}."""
    out = {}
    for name, (cell, mcs, snr, uci, taps) in CASES.items():
        rng = np.random.default_rng(len(out))
        grant = _grant(cell.n_prb, mcs)
        kw = {} if uci is None else {"n_cqi_bits": len(uci[0]), "with_ack": True}
        ref, mine = _codecs(cell, grant, **kw)
        payload = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        enc = ((lambda c: c.encode_sf(payload)) if uci is None
               else (lambda c: c.encode_sf_uci(payload, cqi_bits=uci[0], ack=uci[1])))
        wave, wave_r = enc(mine), enc(ref)
        noisy = _noisy(rng, cell, wave_r, snr, taps)
        bufs_r = ref.dematch_sf(jnp.asarray(noisy))
        pay_r, ok_r = (np.asarray(v) for v in ref.decode_softbuffers(bufs_r))
        uci_r = ref.decode_uci()
        bufs = mine.dematch_sf(torch.as_tensor(noisy))
        uci_p = mine.decode_uci()
        pay, ok, iters = mine.decode_softbuffers(bufs)
        same_in = mine.decode_softbuffers([torch.as_tensor(np.array(b)) for b in bufs_r])
        out[name] = dict(cell=cell, grant=grant, uci=uci, ref=ref, mine=mine, payload=payload,
                         wave=wave, wave_r=wave_r, noisy=noisy, bufs=bufs, bufs_r=bufs_r,
                         port=(pay.numpy(), ok.numpy(), iters.numpy()), ref_out=(pay_r, ok_r),
                         same_in=[v.numpy() for v in same_in], uci_port=uci_p, uci_ref=uci_r)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_encode_matches_reference(runs, name):
    r = runs[name]
    np.testing.assert_array_equal(r["mine"].encode_bits(r["payload"]),
                                  r["ref"].encode_bits(r["payload"]))
    assert r["wave"].dtype == np.complex64 and r["wave"].shape == r["wave_r"].shape
    np.testing.assert_allclose(r["wave"], r["wave_r"], rtol=0, atol=1e-5)
    if r["uci"] is not None:
        with pytest.raises(ValueError, match="encode_sf_uci"):
            r["mine"].encode_sf(r["payload"])


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_reference(runs, name):
    r = runs[name]
    for a, b in zip(r["bufs"], r["bufs_r"], strict=True):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (B, a.shape[-1])
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    (pay, ok, iters), (pay_r, ok_r) = r["port"], r["ref_out"]
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(pay[ok], pay_r[ok])
    assert iters.shape == (B, r["mine"].plan.c) and (iters >= 1).all() and (iters <= 8).all()
    # the reference's softbuffers through the port's decoder: every bit
    np.testing.assert_array_equal(r["same_in"][0], pay_r)
    np.testing.assert_array_equal(r["same_in"][1], ok_r)
    # decode_sf is dematch_sf + decode_softbuffers in one call
    for a, b in zip(r["mine"].decode_sf(torch.as_tensor(r["noisy"])), r["port"], strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    if name == "crc_fail":
        assert not ok.any() and (iters == 8).all()
    else:
        assert ok.all()
        np.testing.assert_array_equal(pay, np.stack([r["payload"]] * B))
    if r["uci"] is not None:
        cqi, ack = r["uci_port"]
        cqi_r, ack_r = r["uci_ref"]
        assert ack is ack_r is r["uci"][1]
        np.testing.assert_array_equal(cqi, cqi_r)
        np.testing.assert_array_equal(cqi, r["uci"][0])
    else:
        assert r["uci_port"] == r["uci_ref"] == (None, None)


def test_frequency_selective_channel_pins_the_noise_quirk(runs):
    """The reference applies subcarrier k's noise noise_var/|h_k|^2 to
    time-domain sample k after the IDFT. Through this channel |h_k|^2 spans
    more than 10x, so any other scaling (the mean over subcarriers, which
    is each sample's real noise) would move the LLRs by far more than the
    softbuffer tolerance: the parity of test_decode_matches_reference
    [freq_selective] holds the port to the quirk, and its decisions equal
    the reference's."""
    r = runs["freq_selective"]
    cell, m_sc = r["cell"], r["mine"].m_sc
    h = np.zeros(cell.nfft, np.complex64)
    for d, g in TAPS.items():
        h[d] = g
    hk = np.fft.fft(h)
    sc = np.r_[np.arange(cell.nfft - cell.n_sc // 2, cell.nfft), np.arange(1, cell.n_sc // 2 + 1)]
    p = np.abs(hk[sc[:m_sc]]) ** 2
    assert p.max() / p.min() > 10
    # per sample, quirk / mean-noise LLR scale = |h_k|^2 * mean(1/|h|^2)
    ratio = p * np.mean(1 / p)
    assert ratio.max() / ratio.min() > 10
    assert r["port"][1].all() and r["ref_out"][1].all()


def test_harq_rv0_fails_and_rv0_plus_rv2_passes():
    """eNB-side HARQ combining: the softbuffers of rv0 and rv2, each
    dematched by its own codec, add; rv0 alone fails at 4 dB and the sum
    passes, on both sides, with equal decisions and payloads."""
    cell = Cell(n_prb=6, cell_id=17)
    rng = np.random.default_rng(40)
    payload = rng.integers(0, 2, _grant(6, 9).tbs).astype(np.uint8)
    bufs, bufs_r, codecs = [], [], []
    for rv in (0, 2):
        ref, mine = _codecs(cell, _grant(6, 9, rv))
        noisy = _noisy(rng, cell, ref.encode_sf(payload), HARQ_SNR_DB)
        np.testing.assert_array_equal(mine.encode_bits(payload), ref.encode_bits(payload))
        bufs.append(mine.dematch_sf(torch.as_tensor(noisy)))
        bufs_r.append(ref.dematch_sf(jnp.asarray(noisy)))
        codecs.append((ref, mine))
    (ref0, mine0), _ = codecs
    alone = mine0.decode_softbuffers(bufs[0])
    alone_r = ref0.decode_softbuffers(bufs_r[0])
    assert not alone[1].any() and not np.asarray(alone_r[1]).any()
    both = mine0.decode_softbuffers([a + b for a, b in zip(*bufs)])
    both_r = ref0.decode_softbuffers([a + b for a, b in zip(*bufs_r)])
    assert both[1].all() and np.asarray(both_r[1]).all()
    np.testing.assert_array_equal(both[0].numpy(), np.asarray(both_r[0]))
    np.testing.assert_array_equal(both[0].numpy(), np.stack([payload] * B))


def test_uci_layout_and_dmrs_match_reference():
    for m_sc, n_cqi, n_ack in ((72, 0, 0), (72, 20, 4), (300, 7, 4), (1200, 10, 8)):
        for a, b in zip(pusch.uci_layout(m_sc, n_cqi, n_ack),
                        ref_pusch.uci_layout(m_sc, n_cqi, n_ack), strict=True):
            np.testing.assert_array_equal(a, b)
    assert pusch.ACK_COLS == ref_pusch.ACK_COLS and pusch.RI_COLS == ref_pusch.RI_COLS
    assert pusch.N_DMRS_SYM == ref_pusch.N_DMRS_SYM
    for m_sc in (36, 72, 300, 600, 1200):
        assert pusch._largest_prime_below(m_sc) == ref_pusch._largest_prime_below(m_sc)
        for u in (0, 12, 29):
            for v in (0, 1):
                np.testing.assert_array_equal(pusch.dmrs_base_seq(m_sc, u, v),
                                              ref_pusch.dmrs_base_seq(m_sc, u, v))
        for cell_id, slot, cs in ((42, 0, 0), (301, 1, 5)):
            np.testing.assert_array_equal(
                pusch.dmrs_for_slot(port_cell.Cell(n_prb=100, cell_id=cell_id), m_sc, slot, cs),
                ref_pusch.dmrs_for_slot(Cell(n_prb=100, cell_id=cell_id), m_sc, slot, cs))
    with pytest.raises(AssertionError, match="1-2 PRB"):
        pusch.dmrs_base_seq(24, 0)


def test_build_pusch_vectors_decode():
    """rx.build_pusch's subframes are the reference encoder's waveforms of its
    payloads (a 6 PRB grant on the flagship cell here), and the port's
    decoder takes them back at 20 dB per allocated subcarrier."""
    from srsue_tpu_torch import rx

    ul = rx.build_pusch(3, n_prb=6, mcs=9, n_distinct=2)
    assert ul.td.shape == (3, ul.cell.sf_len) and ul.td.dtype == np.complex64
    np.testing.assert_array_equal(ul.payloads[2], ul.payloads[0])
    ref = ref_pusch.PuschCodec(Cell(n_prb=100, cell_id=42), _grant(6, 9), ul.rnti, ul.subframe)
    assert dataclasses.astuple(ul.grant) == dataclasses.astuple(ref.grant)
    for wave, payload in zip(ul.td, ul.payloads):
        np.testing.assert_allclose(wave, ref.encode_sf(payload), rtol=0, atol=1e-5)
    codec = pusch.PuschCodec(ul.cell, ul.grant, ul.rnti, ul.subframe, device="cpu")
    pay, ok, _ = codec.decode_sf(torch.as_tensor(rx.add_noise(ul.rng, ul.td, ul.p_sig, 20.0)))
    assert ok.all()
    np.testing.assert_array_equal(pay.numpy(), ul.payloads)


# per-subframe UCI: name -> (cell, mcs); 64QAM puts 42 CQI bits on 7 symbols,
# so a batch's CQI streams do not start on a 20-bit boundary
UCI_CASES = {
    "6prb_qpsk": (Cell(n_prb=6, cell_id=17), 9),
    "25prb_16qam": (Cell(n_prb=25, cell_id=301), 16),
    "6prb_64qam": (Cell(n_prb=6, cell_id=5), 20),
}
UCI_SENT = [([1, 0, 1, 1], True), ([0, 1, 1, 0], False), ([1, 1, 0, 1], True)]


def _uci_batch(name):
    """Both codecs and three 12 dB subframes, each its own TB, CQI and ACK."""
    cell, mcs = UCI_CASES[name]
    grant = _grant(cell.n_prb, mcs)
    ref, mine = _codecs(cell, grant, n_cqi_bits=4, with_ack=True)
    rng = np.random.default_rng(mcs + 100)
    noisy = np.concatenate([_noisy(rng, cell, mine.encode_sf_uci(
        rng.integers(0, 2, grant.tbs).astype(np.uint8), cqi_bits=np.asarray(c, np.uint8),
        ack=a), 12.0)[:1] for c, a in UCI_SENT])
    return ref, mine, noisy


@pytest.mark.parametrize("name", list(UCI_CASES))
def test_uci_per_subframe_equals_the_reference_on_each_alone(name):
    """``decode_uci_sf`` on a batch of three gives, for each subframe, what
    the reference's ``decode_uci`` gives on that subframe alone: the CQI and
    ACK that were sent, ACK and NACK mixed."""
    ref, mine, noisy = _uci_batch(name)
    mine.dematch_sf(torch.as_tensor(noisy))
    cqi, ack = mine.decode_uci_sf()
    assert cqi.dtype == torch.uint8 and cqi.shape == (3, 4)
    assert ack.dtype == torch.bool and ack.shape == (3,)
    for i in range(3):
        ref.dematch_sf(jnp.asarray(noisy[i:i + 1]))
        cqi_r, ack_r = ref.decode_uci()
        np.testing.assert_array_equal(cqi[i].numpy(), cqi_r)
        assert bool(ack[i]) is ack_r
    assert cqi.tolist() == [c for c, _ in UCI_SENT] and ack.tolist() == [a for _, a in UCI_SENT]


@pytest.mark.parametrize("name", list(UCI_CASES))
def test_uci_per_subframe_at_b1_is_decode_uci(name):
    """At B=1 the per-subframe decode and ``decode_uci`` are one decoder;
    a codec without UCI gives None for both."""
    _, mine, noisy = _uci_batch(name)
    for i in range(3):
        mine.dematch_sf(torch.as_tensor(noisy[i:i + 1]))
        (cqi, ack), (cqi_h, ack_h) = mine.decode_uci_sf(), mine.decode_uci()
        np.testing.assert_array_equal(cqi[0].numpy(), cqi_h)
        assert cqi_h.dtype == np.uint8 and bool(ack[0]) is ack_h
    bare = pusch.PuschCodec(mine.cell, mine.grant, RNTI, SUBFRAME, device="cpu")
    bare.dematch_sf(torch.as_tensor(noisy[:1]))
    assert bare.decode_uci_sf() == bare.decode_uci() == (None, None)
