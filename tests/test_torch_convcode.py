"""The port's tail-biting convolutional code (phy/convcode.py) against the
JAX reference: trellis tables and the encoder equal; ``decode_plain`` hard
bits equal to JAX ``convcode.decode`` on noisy codewords at 0, 3 and
10 dB and on random LLRs (both compute the same float32 metrics; the
branch-metric sums may round in another order, which only a near-tie of
path metrics could expose, and the seeds are fixed)."""

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
