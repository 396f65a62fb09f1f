"""The demap + descramble + dematch step of the torch port
(``ratematch.demap_dematch``, ``modulation.demodulate_soft`` and their
callers) against the JAX reference's composition, and the arithmetic of
the kernel ``csrc/demap.cu`` against its plain version, on the CPU.

Tolerances. Against the reference (``demodulate_soft(...) * scr`` ->
``ratematch.dematch(seg, idx, d_len)``): rtol 1e-4 with a floor of 1e-4 of
the peak, as test_torch_frontend.py holds the LLRs (a difference of squared
distances divided by a small noise variance amplifies input rounding); the
signs and the exact zeros (positions never sent, erased bits) are equal.
Within the port, at atol 0: the dispatch on the CPU equals the composition
the receivers ran before (demap every symbol, take the map, slice,
descramble, dematch), and ``_kernel_model``, the kernel's per-thread loop
written in numpy float32, equals the plain version bit for bit, ties,
zeros, infinities and NaNs included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import modulation as ref_mod
from srsue_tpu.phy import pusch as ref_pusch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy.cell import Cell, DlGrant, UlGrant
from srsue_tpu.phy.pdsch import PdschCodec as RefPdsch
from srsue_tpu_torch.kernels import demap as demap_kernel
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import modulation, pusch, ratematch
from srsue_tpu_torch.phy.pdsch import PdschCodec

F32 = np.float32


def _mine(obj):
    """The port's own Cell or grant with the fields of the reference's."""
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _close(got, ref):
    """rtol 1e-4, floor 1e-4 of the peak; equal signs and exact zeros."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_array_equal(got == 0, ref == 0)


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


def _symbols(rng, shape, qm, scale=0.15):
    """Noisy constellation points [*shape] complex64."""
    bits = rng.integers(0, 2, shape + (qm,)).astype(np.uint8)
    clean = modulation.modulate_np(bits.reshape(shape[:-1] + (-1,)), qm)
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (clean + scale * noise).astype(np.complex64)


def _repeat_map(rng, e, r, unsent=7):
    """An index map of e bits into d positions, the most repeated sent r
    times, `unsent` positions never sent: (idx [e], d)."""
    d_sent = -(-e // r)
    d = d_sent + unsent
    pos = rng.permutation(d)[:d_sent]
    return rng.permutation(np.tile(pos, r)[:e]), d


def _case(qm, r, seed):
    """Inputs of one generic case; the seed picks the leading dims, the map,
    the slice and the noise's form."""
    rng = np.random.default_rng(seed)
    lead = (3,) if seed % 2 else (2, 3)
    s = 37
    sym_map = rng.permutation(s)[:29].astype(np.int32) if seed % 3 else None
    n_sym = s if sym_map is None else len(sym_map)
    e = n_sym * qm
    lo, hi = (5, e - 3) if seed % 4 else (0, e)
    idx, d = _repeat_map(rng, hi - lo, r)
    scr = (1.0 - 2.0 * rng.integers(0, 2, e)).astype(F32)
    scr[rng.random(e) < 0.1] = 0.0  # erased bits
    sym = _symbols(rng, lead + (s,), qm)
    form = seed % 3
    nv = (0.5 if form == 0 else (0.01 + rng.random(lead + (s,))).astype(F32) if form == 1
          else (0.01 + rng.random(lead + (1,))).astype(F32))
    return dict(sym=sym, nv=nv, scr=scr, sym_map=sym_map, lo=lo, hi=hi, idx=idx, d=d)


def _t(x, dtype=None):
    return x if x is None or isinstance(x, float) else torch.as_tensor(x, dtype=dtype)


def _port(c, qm, dispatch=True):
    fn = ratematch.demap_dematch if dispatch else ratematch.demap_dematch_plain
    inv = ratematch.inverse_index(c["idx"], c["d"])
    return fn(_t(c["sym"]), _t(c["nv"]), qm, _t(c["scr"]), _t(inv, torch.int32),
              _t(c["sym_map"]), c["lo"], c["hi"]).numpy()


def _reference(c, qm):
    sym, nv = c["sym"], c["nv"]
    if c["sym_map"] is not None:
        sym = sym[..., c["sym_map"]]
        if not isinstance(nv, float):
            nv = np.broadcast_to(nv, c["sym"].shape)[..., c["sym_map"]]
    llr = ref_mod.demodulate_soft(jnp.asarray(sym), qm, nv if isinstance(nv, float)
                                  else jnp.asarray(nv)) * jnp.asarray(c["scr"])
    return np.asarray(ref_rm.dematch(llr[..., c["lo"]:c["hi"]], c["idx"], c["d"]))


def _composition(c, qm):
    """What the receivers ran before: every symbol demapped, the map on the
    LLRs, the slice, the scrambling, ``dematch``."""
    llr = modulation.demodulate_soft_plain(_t(c["sym"]), qm, _t(c["nv"]))
    if c["sym_map"] is not None:
        lead = llr.shape[:-1]
        llr = llr.reshape(lead + (-1, qm))[..., _t(c["sym_map"]).long(), :].reshape(lead + (-1,))
    seg = llr[..., c["lo"]:c["hi"]] * _t(c["scr"])[c["lo"]:c["hi"]]
    return ratematch.dematch(seg, _t(ratematch.inverse_index(c["idx"], c["d"]))).numpy()


def _kernel_model(sym, nv, qm, scr, inv, sym_map, lo, hi, llr_form=False):
    """The kernel's per-thread loop in numpy float32, every position of every
    row at once: rows [N, S] of symbols and noise, the levels of
    ``modulation.levels``. Softbuffer form: acc = 0.0, then for each repeat
    up to the pad acc += llr(e) * scr[e]; LLR form (inv None): llr of every
    bit of every symbol."""
    lv = modulation.levels(qm, torch.device("cpu")).numpy()
    nb = qm // 2
    nv = np.broadcast_to(np.asarray(nv, F32), sym.shape)

    def llr(e):  # [N, len(e)]
        si, bit = e // qm, e % qm
        s = si if sym_map is None else sym_map[si]
        y = sym[:, s]
        x = np.where(bit & 1, y.imag, y.real).astype(F32)
        k = bit >> 1
        m1 = np.full(x.shape, F32(1e30))
        m0 = np.full(x.shape, F32(1e30))
        for level in range(1 << nb):
            d = x - lv[level]
            d2 = d * d
            one = ((level >> (nb - 1 - k)) & 1).astype(bool)
            m1 = np.where(one & ((d2 < m1) | np.isnan(d2)), d2, m1)
            m0 = np.where(~one & ((d2 < m0) | np.isnan(d2)), d2, m0)
        v = nv[:, s]
        v = np.where(v < F32(1e-9), F32(1e-9), v)
        return (m1 - m0) / v

    with np.errstate(all="ignore"):
        if llr_form:
            return llr(np.arange(sym.shape[1] * qm))
        acc = np.zeros((sym.shape[0], inv.shape[0]), F32)
        for j in range(inv.shape[1]):
            ej = inv[:, j]
            live = (ej >= 0) & (ej < hi - lo)  # pads are trailing: a row stops at its first
            e = lo + ej[live]
            acc[:, live] = acc[:, live] + llr(e) * scr[e]
        return acc


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("qm", [2, 4, 6])
def test_demap_dematch_matches_the_reference(qm, r):
    for seed in range(4):  # every form of map, slice, noise and leading dims
        c = _case(qm, r, 10 * qm + r + 97 * seed)
        got = _port(c, qm)
        assert got.shape == c["sym"].shape[:-1] + (c["d"],)
        _close(got, _reference(c, qm))
        # the plain version is the receivers' old composition, bit for bit
        np.testing.assert_array_equal(_bits(got), _bits(_composition(c, qm)))
        np.testing.assert_array_equal(_bits(got), _bits(_port(c, qm, dispatch=False)))


def _special(rng, shape):
    """Symbols with exact ties between levels, zeros, huge values,
    infinities and NaNs among noisy points."""
    sym = _symbols(rng, shape, 6, scale=0.6)
    flat = sym.reshape(-1)
    picks = rng.permutation(flat.size)
    vals = [0.0, 1e20, -1e20, np.inf, -np.inf, np.nan, 2 / np.sqrt(42), 1 / np.sqrt(10),
            0.0 + 1e-30j, -0.0]
    for i, v in enumerate(vals * 3):
        flat[picks[i]] = np.complex64(complex(v, vals[(i + 3) % len(vals)]))
    return sym


@pytest.mark.parametrize("qm", [2, 4, 6])
def test_kernel_model_equals_the_plain_version(qm):
    rng = np.random.default_rng(qm)
    for r, noise in ((1, "per RE"), (3, "scalar"), (5, "tiny")):
        c = _case(qm, r, 1000 + qm + r)
        sym = _special(rng, (4, 37))
        nv = {"per RE": (0.01 + rng.random((4, 37))).astype(F32), "scalar": 0.25,
              "tiny": np.where(rng.random((4, 37)) < 0.5, F32(1e-12), F32(0.3)).astype(F32)}[noise]
        inv = ratematch.inverse_index(c["idx"], c["d"])
        plain = ratematch.demap_dematch(torch.as_tensor(sym), _t(nv), qm, _t(c["scr"]),
                                        _t(inv, torch.int32), _t(c["sym_map"]), c["lo"],
                                        c["hi"]).numpy()
        model = _kernel_model(sym, nv, qm, c["scr"], inv.astype(np.int32), c["sym_map"],
                              c["lo"], c["hi"])
        np.testing.assert_array_equal(model, plain)  # NaN where NaN
        np.testing.assert_array_equal(np.signbit(model), np.signbit(plain))
        llrs = modulation.demodulate_soft(torch.as_tensor(sym), qm, _t(nv)).numpy()
        model = _kernel_model(sym, nv, qm, None, None, None, 0, 0, llr_form=True)
        np.testing.assert_array_equal(model, llrs)
        np.testing.assert_array_equal(np.signbit(model), np.signbit(llrs))


PDSCH_CASES = {  # name: (cell, mcs, subframe, tbs or None)
    "6prb_qpsk": (Cell(n_prb=6, cell_id=17), 5, 1, None),
    "6prb_16qam": (Cell(n_prb=6, cell_id=5), 13, 4, None),
    # TBS 6208: one block of K=3136 and one of K=3200, 56 filler bits
    "25prb_two_groups_filler": (Cell(n_prb=25, cell_id=301), 20, 3, 6208),
}


@pytest.mark.parametrize("name", list(PDSCH_CASES))
def test_pdsch_demap_dematch_matches_the_reference(name):
    cell, mcs, subframe, tbs = PDSCH_CASES[name]
    grant = ref_ra.dl_grant(cell.n_prb, mcs)
    if tbs is not None:
        grant = DlGrant(grant.n_prb, grant.prb_start, mcs, grant.mod_order, tbs, 0)
    ref = RefPdsch(cell, grant, rnti=0x1234, subframe=subframe, cfi=1)
    mine = PdschCodec(_mine(cell), _mine(grant), rnti=0x1234, subframe=subframe, cfi=1,
                      device="cpu")
    if tbs is not None:
        assert len(mine.groups) == 2 and mine.plan.f > 0
    rng = np.random.default_rng(len(name))
    x = _symbols(rng, (2, mine.n_re), mine.qm)
    nve = (0.02 + rng.random((2, mine.n_re))).astype(F32)
    got = mine.demap_dematch(torch.as_tensor(x), torch.as_tensor(nve))
    want = ref.dematch(ref.demap_llrs(jnp.asarray(x), jnp.asarray(nve)))
    old = mine.dematch(mine.demap_llrs(torch.as_tensor(x), torch.as_tensor(nve)))
    for a, b, o in zip(got, want, old, strict=True):
        _close(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(o.numpy()))


PUSCH_CASES = {  # name: (cell, mcs, cqi bits, ack)
    "6prb_qpsk_ack_cqi": (Cell(n_prb=6, cell_id=17), 9, [1, 0, 1, 1], True),
    "25prb_16qam_nack_cqi": (Cell(n_prb=25, cell_id=301), 16, [0, 1, 1, 0, 1, 0], False),
}


@pytest.mark.parametrize("name", list(PUSCH_CASES))
def test_pusch_dematch_sf_matches_the_reference(name):
    cell, mcs, cqi, ack = PUSCH_CASES[name]
    g = ref_ra.dl_grant(cell.n_prb, mcs)
    grant = UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order,
                    tbs=g.tbs)
    kw = dict(n_cqi_bits=len(cqi), with_ack=True)
    ref = ref_pusch.PuschCodec(cell, grant, 0x1234, 2, **kw)
    mine = pusch.PuschCodec(_mine(cell), _mine(grant), 0x1234, 2, device="cpu", **kw)
    rng = np.random.default_rng(mcs)
    wave = mine.encode_sf_uci(rng.integers(0, 2, grant.tbs).astype(np.uint8),
                              cqi_bits=np.asarray(cqi, np.uint8), ack=ack)
    p = float(np.mean(np.abs(wave) ** 2)) * cell.nfft / mine.m_sc / 10 ** 1.2
    noisy = (wave[None] + np.sqrt(p / 2) * (rng.standard_normal((2,) + wave.shape) + 1j *
             rng.standard_normal((2,) + wave.shape))).astype(np.complex64)
    got = mine.dematch_sf(torch.as_tensor(noisy))
    want = ref.dematch_sf(jnp.asarray(noisy))
    for a, b in zip(got, want, strict=True):
        _close(a.numpy(), np.asarray(b))
    uci, uci_r = mine.decode_uci(), ref.decode_uci()
    np.testing.assert_array_equal(uci[0], uci_r[0])
    assert uci[1] is uci_r[1] is ack and list(uci[0]) == cqi

    # bit for bit the composition the codec ran before, on its own symbols
    syms, nv = mine.equalize_sf(torch.as_tensor(noisy))
    llr_all = modulation.demodulate_soft_plain(syms, mine.qm, nv).reshape(
        (2, mine.n_re, mine.qm))
    llr = llr_all[:, torch.as_tensor(mine.data_pos), :].reshape(2, mine.G)
    llr = llr * torch.as_tensor(mine.scr_pm1) * torch.as_tensor(mine._ack_erase)
    old = []
    for k, first, count, lo, hi, inv in mine.groups:
        buf = ratematch.dematch(llr[:, lo:hi], inv).reshape(2, count, 3 * (k + 4))
        if first == 0 and mine.plan.f:
            buf[:, 0, :mine.plan.f] += 1e4
        old.extend(buf.unbind(-2))
    for a, o in zip(got, old, strict=True):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(o.numpy()))
    cqi_llr, ack_llr = mine._last_uci_llrs
    np.testing.assert_array_equal(cqi_llr.numpy(), llr_all[:, mine.cqi_pos].numpy())
    np.testing.assert_array_equal(ack_llr.numpy(), llr_all[:, mine.ack_pos].numpy())


def test_dispatch_raises_on_other_devices():
    sym = torch.zeros(4, 8, dtype=torch.complex64, device="meta")
    inv = torch.zeros(8, 1, dtype=torch.int32, device="meta")
    scr = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        modulation.demodulate_soft(sym, 2, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        modulation.demodulate_hard(sym, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ratematch.demap_dematch(sym, 1.0, 2, scr, inv)


def test_wrapper_refuses_what_the_kernel_cannot_take_before_building():
    """The wrapper's checks come before the library is loaded, so they hold
    on a machine without nvcc too: a CPU tensor, a wrong dtype, a bad qm."""
    lv = modulation.levels(2, torch.device("cpu"))
    sym = torch.zeros(2, 8, dtype=torch.complex64)
    before = demap_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        demap_kernel.demap_llr_cuda(sym, 1.0, 2, lv)
    with pytest.raises(TypeError, match="complex64"):
        demap_kernel.demap_llr_cuda(sym.to(torch.complex128), 1.0, 2, lv)
    with pytest.raises(ValueError, match="qm=3"):
        demap_kernel.demap_dematch_cuda(sym, 1.0, 3, lv, torch.ones(16),
                                        torch.zeros(8, 1, dtype=torch.int32), None, 0, 16)
    assert demap_kernel.launches == before
