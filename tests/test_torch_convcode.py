"""The port's tail-biting convolutional code (phy/convcode.py) against the
JAX reference: trellis tables and the encoder equal; ``decode_plain`` hard
bits equal to JAX ``convcode.decode`` on noisy codewords at 0, 3 and
10 dB and on random LLRs (both compute the same float32 metrics; the
branch-metric sums may round in another order, which only a near-tie of
path metrics could expose, and the seeds are fixed); and a numpy model of
the CUDA kernel's algorithm (csrc/viterbi.cu: its lane layout and shuffle
exchange, ballot decision words, traceback) equal to both at atol 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import convcode as ref
from srsue_tpu_torch.kernels import viterbi
from srsue_tpu_torch.phy import convcode


def _inputs(batch, n, snr_db, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n)).astype(np.uint8)
    if snr_db is None:
        return (rng.standard_normal((batch, n, 3)) * 4.0).astype(np.float32), bits
    x = 1.0 - 2.0 * np.stack([ref.encode(b) for b in bits]).transpose(0, 2, 1)
    var = 10.0 ** (-snr_db / 10.0)
    y = x + np.sqrt(var) * rng.standard_normal(x.shape)
    return np.ascontiguousarray(2.0 * y / var, dtype=np.float32), bits


def test_tables_and_encoder_match_reference():
    for a, b in zip(convcode._tables(), ref._tables(), strict=True):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for n in (6, 7, 31, 33, 40, 44, 54, 96):
        bits = rng.integers(0, 2, (3, n)).astype(np.uint8)
        got = convcode.encode(bits)
        assert got.shape == (3, 3, n)
        for b, g in zip(bits, got):
            np.testing.assert_array_equal(g, ref.encode(b))
            np.testing.assert_array_equal(convcode.encode(b), g)


@pytest.mark.parametrize("n", [31, 33, 40, 44, 54])
def test_decode_plain_matches_reference(n):
    dec_ref = jax.jit(ref.decode)
    for j, snr in enumerate((0.0, 3.0, 10.0, None)):
        llr, bits = _inputs(64, n, snr, 100 * n + j)
        want = np.asarray(dec_ref(jnp.asarray(llr)))
        got = convcode.decode(torch.as_tensor(llr))
        assert got.dtype == torch.uint8 and got.shape == (64, n)
        np.testing.assert_array_equal(got.numpy(), want)
        if snr == 10.0:
            np.testing.assert_array_equal(got.numpy(), bits)


def _kernel_model(llr: np.ndarray) -> np.ndarray:
    """csrc/viterbi.cu in numpy, lane for lane: lane j of a hypothesis's
    warp holds x, the metric of state j + 32*(j odd), and y, that of the
    other of j and j + 32; two shuffles bring it the metrics of the
    predecessors 2j and 2j + 1 (mod 64); a metric is the max of its two
    candidates, and the odd predecessor was taken where the max differs
    from the even one's candidate; the second pass keeps a 64-bit decision
    word per step (bit s: state s took its odd predecessor); the traceback
    from the first maximal state reads them."""
    f32 = np.float32
    batch, n, _ = llr.shape
    lane = np.arange(32)
    up, odd = lane >= 16, (lane & 1).astype(bool)
    src_a = np.where(up, 2 * lane - 31, 2 * lane)  # qa is x of lane src_a
    src_b = np.where(up, 2 * lane - 32, 2 * lane + 1)  # qb is y of lane src_b
    out_pm1 = convcode._tables()[0]
    sign = np.where(odd, -1, 1).astype(f32)[:, None]
    fa = sign * out_pm1[np.where(up, 2 * lane + 1, 2 * lane)]  # [32, 3] factors of qa's word
    fb = sign * out_pm1[np.where(up, 2 * lane, 2 * lane + 1)]

    def branch(l, f):  # (l0*f0 + l1*f1) + l2*f2, each product exact
        return (l[:, None, 0] * f[:, 0] + l[:, None, 1] * f[:, 1]) + l[:, None, 2] * f[:, 2]

    x = np.zeros((batch, 32), f32)
    y = np.zeros((batch, 32), f32)
    dec = np.zeros((batch, n), np.uint64)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for k in range(2 * n):
        l = llr[:, k % n]
        qa, qb = x[:, src_a], y[:, src_b]
        ba, bb = branch(l, fa), branch(l, fb)
        xa, xb, ya, yb = qa + ba, qb + bb, qa - ba, qb - bb
        x, y = np.maximum(xa, xb), np.maximum(ya, yb)
        if k >= n:  # the two ballots, then the states in order
            tx = (x != np.where(up, xb, xa)).astype(np.uint64) @ weights
            ty = (y != np.where(up, yb, ya)).astype(np.uint64) @ weights
            even = np.uint64(0x55555555)
            lo = (tx & even) | (ty & ~even & np.uint64(0xFFFFFFFF))
            hi = (ty & even) | (tx & ~even & np.uint64(0xFFFFFFFF))
            dec[:, k - n] = (hi << np.uint64(32)) | lo
        if (k + 1) % convcode.NORM_EVERY == 0:
            m = np.maximum(x, y).max(1, keepdims=True)
            x, y = x - m, y - m
    pm = np.concatenate([np.where(odd, y, x), np.where(odd, x, y)], 1)  # states 0..63
    st = np.argmax(pm == pm.max(1, keepdims=True), 1)  # the first maximal state
    out = np.zeros((batch, n), np.uint8)
    for k in range(n - 1, -1, -1):
        out[:, k] = st >> 5
        st = (2 * st + ((dec[:, k] >> st.astype(np.uint64)) & np.uint64(1)).astype(np.int64)) & 63
    return out


def _model_inputs(kind, batch, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "noisy":
        return _inputs(batch, n, 3.0, seed)[0]
    if kind == "random":
        return (rng.standard_normal((batch, n, 3)) * 4.0).astype(np.float32)
    if kind == "zeros":
        return np.zeros((batch, n, 3), np.float32)
    # one constant per hypothesis, a multiple of 1/4: every sum is exact and
    # path metrics tie everywhere
    c = np.round(rng.uniform(-4.0, 4.0, batch) * 4.0) / 4.0
    return np.ascontiguousarray(np.broadcast_to(c[:, None, None], (batch, n, 3)),
                                dtype=np.float32)


@pytest.mark.parametrize("kind", ["noisy", "random", "zeros", "constant"])
@pytest.mark.parametrize("n", [1, 31, 33, 40, 44, 54, 96])
def test_kernel_model_matches_plain_and_reference(n, kind):
    llr = _model_inputs(kind, 24, n, 7 * n + len(kind))
    got = _kernel_model(llr)
    np.testing.assert_array_equal(got, convcode.decode_plain(torch.as_tensor(llr)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax.jit(ref.decode)(jnp.asarray(llr))))


def test_decode_checks_its_input():
    with pytest.raises(TypeError):
        convcode.decode(torch.zeros(2, 40, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        convcode.decode(torch.zeros(2, 40, 2))
    with pytest.raises(ValueError):
        convcode.decode(torch.zeros(2, convcode.MAX_N + 1, 3))
    with pytest.raises(ValueError):
        convcode.decode(torch.zeros(2, 3, 40).transpose(1, 2))
    with pytest.raises(ValueError):
        convcode.decode(torch.zeros(2, 40, 3, device="meta"))
    assert convcode.decode(torch.zeros(0, 40, 3)).shape == (0, 40)
    assert viterbi.launches == 0  # CPU tensors never launch the kernel
