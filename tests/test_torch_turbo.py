"""Turbo decoder of the torch port against the JAX reference.

The plain BCJR half (the CPU path of kernels/bcjr.py) is held to
turbo._bcjr_half_windowed, to the JAX package's Pallas kernel run in
interpret mode, and (W = 1) to turbo._bcjr_half; the full decode to
turbo.decode with hard bits, iterations and CRC flags equal.

Tolerances: the port performs the reference's float32 operations in the
same order, so extrinsics agree to float32 rounding (rtol 1e-5, atol 1e-4
on LLRs of magnitude ~1e2). Boundary metrics are compared after removing
each window's maximum, since only differences matter (the Pallas kernel
normalises by state 0, the reference by the maximum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import crc as crcmod
from srsue_tpu.phy import turbo as ref_turbo
from srsue_tpu.phy import turbo_pallas
from srsue_tpu_torch.kernels import bcjr
from srsue_tpu_torch.phy import turbo

RTOL, ATOL = 1e-5, 1e-4


def _make(k, b, snr_db, rng):
    m = np.zeros((k, 24), np.uint8)
    m[: k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    payloads, llrs = [], []
    for _ in range(b):
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        sigma = 10 ** (-snr_db / 20)
        x = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
        llrs.append(2 * x / sigma**2)
        payloads.append(msg)
    return np.stack(payloads), np.stack(llrs).astype(np.float32), m


def _half_inputs(k, lw, b, seed, random_bounds):
    rng = np.random.default_rng(seed)
    _, llrs, _ = _make(k, b, 2.0, rng)
    t = llrs[:, :, k:k + 4]
    w = k // lw
    bshape = (b, w, 8)
    bounds = (rng.standard_normal(bshape) * 5 if random_bounds
              else np.zeros(bshape)).astype(np.float32)
    return dict(
        sys_llr=llrs[:, 0, :k], par_llr=llrs[:, 1, :k],
        apriori=(rng.standard_normal((b, k)) * 3).astype(np.float32),
        tail_sys=np.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], 1),
        tail_par=np.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], 1),
        alpha_b=bounds, beta_b=bounds[:, ::-1].copy())


def _norm(x):
    return x - x.max(axis=-1, keepdims=True)


def _close(got, ref, boundaries=True):
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)
    if boundaries:
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(_norm(g), _norm(r), rtol=RTOL, atol=ATOL)


def _plain(inp, lw):
    args = {n: torch.as_tensor(v) for n, v in inp.items()}
    return [x.numpy() for x in bcjr.bcjr_half_windowed(**args, lw=lw)]


@pytest.mark.parametrize("k,lw,random_bounds", [
    (512, 64, False), (512, 64, True), (432, 48, True), (5824, 64, True)])
def test_plain_half_matches_reference(k, lw, random_bounds):
    inp = _half_inputs(k, lw, 3, k, random_bounds)
    ref = ref_turbo._bcjr_half_windowed(
        *(jnp.asarray(inp[n]) for n in ("sys_llr", "par_llr", "apriori", "tail_sys",
                                        "tail_par", "alpha_b", "beta_b")), lw)
    _close(_plain(inp, lw), [np.asarray(r) for r in ref])


def test_plain_half_matches_pallas_kernel_interpret():
    k, lw = 512, 64
    inp = _half_inputs(k, lw, 3, 5, random_bounds=True)
    ref = turbo_pallas.bcjr_half_windowed_pallas(
        *(jnp.asarray(inp[n]) for n in ("sys_llr", "par_llr", "apriori", "tail_sys",
                                        "tail_par", "alpha_b", "beta_b")),
        lw, interpret=True)
    _close(_plain(inp, lw), [np.asarray(r) for r in ref])


@pytest.mark.parametrize("k", [40, 256])
def test_single_window_is_unwindowed_half(k):
    inp = _half_inputs(k, k, 2, 9, random_bounds=True)
    ref = ref_turbo._bcjr_half(
        *(jnp.asarray(inp[n]) for n in ("sys_llr", "par_llr", "apriori",
                                        "tail_sys", "tail_par")))
    _close(_plain(inp, k), [np.asarray(ref)], boundaries=False)


def test_tail_beta_matches_reference():
    inp = _half_inputs(512, 64, 4, 3, random_bounds=False)
    ref = ref_turbo._tail_beta(jnp.asarray(inp["tail_sys"]), jnp.asarray(inp["tail_par"]), 4)
    got = turbo.tail_beta(torch.as_tensor(inp["tail_sys"]), torch.as_tensor(inp["tail_par"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_plain_twin_equals_dispatching_wrapper_on_cpu():
    inp = _half_inputs(432, 48, 2, 4, random_bounds=True)
    args = {n: torch.as_tensor(v) for n, v in inp.items()}
    before = dict(bcjr.launches)
    for kernel in bcjr.KERNELS:
        a = bcjr.bcjr_half_windowed(**args, lw=48, kernel=kernel)
        b = bcjr.bcjr_half_windowed_plain(**args, lw=48, kernel=kernel)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert bcjr.launches == before  # no kernel on the CPU


def test_wrapper_rejects_bad_inputs():
    lin = torch.zeros(4, 64)
    a0 = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        bcjr.half_windowed(lin.double(), lin.double(), a0, a0)
    with pytest.raises(ValueError):
        bcjr.half_windowed(lin, torch.zeros(4, 32), a0, a0)
    with pytest.raises(ValueError):
        bcjr.half_windowed(lin, lin, torch.zeros(4, 7), a0)
    with pytest.raises(ValueError):
        bcjr.half_windowed(lin.t(), lin.t(), a0, a0)


@pytest.mark.parametrize("k,early_exit", [
    (256, True), (512, True), (512, False), (6144, True), (6144, False)])
def test_decode_matches_reference(k, early_exit):
    rng = np.random.default_rng(1)
    payloads, llrs, m = _make(k, 2, 1.0, rng)
    h_ref, it_ref, ok_ref = ref_turbo.decode(
        jnp.asarray(llrs), k, 4, crc_mat=m, early_exit=early_exit)
    h, it, ok = turbo.decode(torch.as_tensor(llrs), k, 4, crc_mat=m,
                             early_exit=early_exit)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert ok.all()
    np.testing.assert_array_equal(h.numpy(), payloads)


def test_early_exit_and_masked_iterations_agree():
    """Stopping once every block passed (one host sync per iteration) and
    running all iterations with converged blocks frozen give identical
    results, also when some blocks never converge."""
    k = 512
    rng = np.random.default_rng(4)
    _, good, m = _make(k, 3, 1.5, rng)
    _, bad, _ = _make(k, 2, -4.0, rng)
    for llrs in (good, np.concatenate([good, bad])):
        d = torch.as_tensor(llrs)
        a = turbo.decode(d, k, 6, crc_mat=m, early_exit=True)
        b = turbo.decode(d, k, 6, crc_mat=m, early_exit=False)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)

