"""The turbo decoder's kernel variants and forced form in the torch port
against the JAX package's Pallas kernel forms (interpret mode on the CPU,
variants selected with the reference's own environment knobs).

* v2 (`_half_kernel`) and v3 (`_half_kernel_v3`) are equal to atol 0,
  which is why the port has one counterpart of both (``kernel="v2v3"``).
* The port's plain twins of "v2v3" and "v4" against the Pallas kernels:
  rtol 1e-5, atol 1e-4 on extrinsics (float32 LLRs of magnitude ~1e1-1e2,
  the same operations in the same order); boundaries after removing each
  window's maximum.
* "v5" (bfloat16) against the Pallas v5 kernel: extrinsics within one bf16
  unit in the last place of the largest extrinsic (2^-7 of it), since
  XLA:CPU may keep excess precision between bf16 operations; decisions of
  the whole decode are equal.
* ``decode_forced`` against the three forced forms of ``turbo_pallas``:
  hard bits, CRC flags and iteration counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import turbo_pallas
from srsue_tpu_torch.kernels import bcjr
from srsue_tpu_torch.phy import turbo

from test_torch_turbo import _close, _half_inputs, _make

HALF_ARGS = ("sys_llr", "par_llr", "apriori", "tail_sys", "tail_par", "alpha_b", "beta_b")
_JAX_HALVES = {}


def _jax_half(monkeypatch, variant, k, lw):
    """bcjr_half_windowed_pallas under SRSUE_TPU_TURBO_KERNEL=variant, in
    interpret mode, on _half_inputs(k, lw, 3, k, random boundaries);
    cached for the module (each call takes seconds)."""
    key = (variant, k, lw)
    if key not in _JAX_HALVES:
        monkeypatch.setenv("SRSUE_TPU_TURBO_KERNEL", variant)
        inp = _half_inputs(k, lw, 3, k, random_bounds=True)
        out = turbo_pallas.bcjr_half_windowed_pallas(
            *(jnp.asarray(inp[n]) for n in HALF_ARGS), lw, interpret=True)
        _JAX_HALVES[key] = [np.asarray(x) for x in out]
    return _JAX_HALVES[key]


def _port_half(kernel, k, lw):
    inp = _half_inputs(k, lw, 3, k, random_bounds=True)
    args = {n: torch.as_tensor(v) for n, v in inp.items()}
    return [x.numpy() for x in bcjr.bcjr_half_windowed(**args, lw=lw, kernel=kernel)]


def test_jax_v2_equals_v3(monkeypatch):
    v2 = _jax_half(monkeypatch, "v2", 512, 64)
    v3 = _jax_half(monkeypatch, "v3", 512, 64)
    for a, b in zip(v2, v3):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant,kernel,k,lw", [
    ("v2", "v2v3", 512, 64), ("v3", "v2v3", 512, 64), ("v3", "v2v3", 432, 48),
    ("v4", "v4", 512, 64), ("v4", "v4", 256, 256)])
def test_plain_twin_matches_pallas_variant(monkeypatch, variant, kernel, k, lw):
    _close(_port_half(kernel, k, lw), _jax_half(monkeypatch, variant, k, lw))


def test_bf16_plain_twin_matches_pallas_v5(monkeypatch):
    ref = _jax_half(monkeypatch, "v5", 512, 64)
    got = _port_half("v5", 512, 64)
    ulp = 2.0 ** -7 * np.abs(ref[0]).max()
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=ulp)
    for g, r in zip(got[1:], ref[1:]):
        g, r = g - g.max(-1, keepdims=True), r - r.max(-1, keepdims=True)
        np.testing.assert_allclose(g, r, rtol=0, atol=2.0 ** -7 * np.abs(r).max())


def test_radix4_tables_match_reference():
    assert turbo.radix4_tables() == turbo_pallas._radix4_tables()


@pytest.mark.parametrize("k,lw", [(512, 64), (432, 48), (256, 256)])
def test_fused_plain_equals_composition(k, lw):
    """The fused half's plain twin equals QPP gather + bcjr_half_windowed_plain
    + the NII boundary shift, at atol 0."""
    rng = np.random.default_rng(k)
    b, w = 3, k // lw
    t = {n: torch.as_tensor(rng.standard_normal(s).astype(np.float32) * 5)
         for n, s in (("sys", (b, k)), ("par", (b, k)), ("other", (b, k)), ("ts", (b, 3)),
                      ("tp", (b, 3)), ("al", (b, w, 8)), ("bf", (b, w, 8)))}
    inv = turbo.qpp_tensors(k, torch.device("cpu"))[1]
    tb = turbo.tail_beta(t["ts"], t["tp"])
    ext, al, bf = bcjr.bcjr_half_fused_plain(t["sys"], t["par"], t["other"],
                                             inv.to(torch.int32), t["al"], t["bf"], tb, lw)
    z = torch.zeros(b, 1, 8)
    ref = bcjr.bcjr_half_windowed_plain(
        t["sys"], t["par"], t["other"][:, inv], t["ts"], t["tp"],
        torch.cat([z, t["al"][:, :-1]], 1), torch.cat([t["bf"][:, 1:], z], 1), lw)
    torch.testing.assert_close(ext, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([z, al[:, :-1]], 1), ref[1], rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([bf[:, 1:], z], 1), ref[2], rtol=0, atol=0)


def test_decode_v4_matches_pallas_decode(monkeypatch):
    k = 512
    _, llrs, m = _make(k, 3, 1.0, np.random.default_rng(31))
    monkeypatch.setenv("SRSUE_TPU_TURBO_KERNEL", "v4")
    ref = turbo_pallas.decode(jnp.asarray(llrs), k, 4, crc_mat=m, window=64, interpret=True)
    got = turbo.decode(torch.as_tensor(llrs), k, 4, crc_mat=m, kernel="v4", window=64)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_v5_decode_matches_pallas_v5(monkeypatch):
    """The reference's own standard (test_v5_bf16_decodes_and_tracks_f32):
    same decisions, and at most one iteration more than float32."""
    k = 512
    payloads, llrs, m = _make(k, 3, 1.0, np.random.default_rng(31))
    monkeypatch.setenv("SRSUE_TPU_TURBO_KERNEL", "v5")
    h_ref, _, ok_ref = turbo_pallas.decode(jnp.asarray(llrs), k, 4, crc_mat=m, window=64,
                                           interpret=True)
    d = torch.as_tensor(llrs)
    h5, it5, ok5 = turbo.decode(d, k, 4, crc_mat=m, kernel="v5")
    _, it32, _ = turbo.decode(d, k, 4, crc_mat=m, kernel="v4")
    np.testing.assert_array_equal(h5.numpy(), np.asarray(h_ref))
    np.testing.assert_array_equal(ok5.numpy(), np.asarray(ok_ref))
    np.testing.assert_array_equal(h5.numpy(), payloads)
    assert (it5 <= it32 + 1).all()


def _forced_reference(form, llrs, k, n_iters, m):
    fn = {"window_linear": lambda d: turbo_pallas.decode(
              d, k, n_iters, crc_mat=m, window=64, early_exit=False, interpret=True),
          "tiled": lambda d: turbo_pallas.decode_forced_tiled(
              d, k, n_iters, crc_mat=m, window=64, interpret=True),
          "loop_tiled": lambda d: turbo_pallas.decode_forced_loop_tiled(
              d, k, n_iters, crc_mat=m, window=64, interpret=True)}[form]
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(llrs))]


@pytest.mark.parametrize("form", ["window_linear", "tiled", "loop_tiled"])
def test_decode_forced_matches_pallas_forced_forms(monkeypatch, form):
    """Five blocks (the padded path of the tiled forms); both the v4 kernel
    (the reference's arithmetic) and the default r2max kernel (the fused
    half on the card) give the reference's decisions."""
    k, n_iters = 512, 2
    payloads, llrs, m = _make(k, 5, 1.0, np.random.default_rng(13))
    monkeypatch.setenv("SRSUE_TPU_TURBO_KERNEL", "v4")
    monkeypatch.setenv("SRSUE_TPU_TURBO_FORCED", "unroll")
    h_ref, it_ref, ok_ref = _forced_reference(form, llrs, k, n_iters, m)
    assert ok_ref.all()
    for kernel in ("v4", "r2max"):
        h, it, ok = turbo.decode_forced(torch.as_tensor(llrs), k, n_iters, m,
                                        kernel=kernel, window=64)
        np.testing.assert_array_equal(h.numpy(), h_ref)
        np.testing.assert_array_equal(it.numpy(), it_ref)
        np.testing.assert_array_equal(ok.numpy(), ok_ref)
    np.testing.assert_array_equal(h_ref, payloads)


def test_forced_and_masked_contracts_differ():
    """decode(early_exit=False) is the masked contract: converged blocks
    freeze and report their own iteration counts. decode_forced is the
    forced contract: every block runs every iteration and reports n_iters.
    On blocks that converge both decide the same bits."""
    k, n_iters = 512, 6
    rng = np.random.default_rng(4)
    _, good, m = _make(k, 3, 1.5, rng)
    _, bad, _ = _make(k, 2, -4.0, rng)
    d = torch.as_tensor(np.concatenate([good, bad]))
    h_m, it_m, ok_m = turbo.decode(d, k, n_iters, crc_mat=m, early_exit=False)
    h_f, it_f, ok_f = turbo.decode_forced(d, k, n_iters, crc_mat=m)
    assert (it_m[:3] < n_iters).all() and (it_m[3:] == n_iters).all()
    assert (it_f == n_iters).all()
    assert ok_m[:3].all() and ok_f[:3].all() and not ok_f[3:].any()
    torch.testing.assert_close(h_f[:3], h_m[:3], rtol=0, atol=0)


def test_kernel_and_window_arguments_are_checked():
    lin = torch.zeros(4, 60)
    a0 = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="unknown kernel"):
        bcjr.half_windowed(torch.zeros(4, 64), torch.zeros(4, 64), a0, a0, kernel="v3")
    for kernel in ("v2v3", "v4", "v5"):
        with pytest.raises(ValueError, match="lw % 8"):
            bcjr.half_windowed(lin, lin, a0, a0, kernel=kernel)
    bcjr.half_windowed(lin, lin, a0, a0)  # radix-2 max takes any window
    d = torch.zeros(2, 3, 516)
    with pytest.raises(ValueError, match="must divide"):
        turbo.decode_forced(d, 512, 1, window=96)
    z = torch.zeros(2, 512)
    zb = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="int32"):
        bcjr.bcjr_half_fused(z, z, z, torch.arange(512), zb, zb, torch.zeros(2, 8), 64)


@pytest.mark.slow
def test_decode_forced_flagship_k_matches_block_minor(monkeypatch):
    """The flagship block K=5824 at the TPU's block-minor window lw=104."""
    k = 5824
    payloads, llrs, m = _make(k, 2, 1.0, np.random.default_rng(17))
    monkeypatch.setenv("SRSUE_TPU_TURBO_KERNEL", "v4")
    ref = turbo_pallas.decode_forced_bm(jnp.asarray(llrs), k, 3, crc_mat=m, window=104,
                                        interpret=True)
    got = turbo.decode_forced(torch.as_tensor(llrs), k, 3, m, kernel="v4", window=104)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[0].numpy(), payloads)
