"""The port's window-sharded turbo decoder (``parallel/turbo_shard.py``)
against the JAX package's ``make_sharded_decoder`` on the same mesh size,
and against the port's own unsharded ``turbo.decode(early_exit=False,
window=64)``: hard bits, iterations and CRC flags are equal, exactly. The
inputs are tests/test_distributed_dsp.py's: CRC24A blocks at sigma =
10^(-1/20), K = 512 and 1024 (W = 8 and 16 windows of 64). The port's ranks
are spawned gloo CPU processes."""

import datetime
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from srsue_tpu.parallel import turbo_shard as ref_turbo_shard
from srsue_tpu.parallel.mesh import make_mesh as ref_make_mesh
from srsue_tpu.utils.jaxutil import to_host
from srsue_tpu_torch.kernels import bcjr
from srsue_tpu_torch.parallel import mesh, ranks, turbo_shard
from srsue_tpu_torch.phy import crc as crcmod
from srsue_tpu_torch.phy import turbo

N_ITERS = 8
KS = (512, 1024)


def _blocks(k, b=2, seed=2):
    rng = np.random.default_rng(seed)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    sigma = 10 ** (-1.0 / 20)
    llrs, msgs = [], []
    for _ in range(b):
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        x = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
        llrs.append(2 * x / sigma ** 2)
        msgs.append(msg)
    return np.stack(llrs).astype(np.float32), np.stack(msgs), m


def _noisy_blocks(k):
    """Six blocks with more noise on the LLRs: they converge after 4 to 7
    iterations or never."""
    llrs, _, m = _blocks(k, b=6, seed=3)
    llrs = llrs + np.random.default_rng(4).standard_normal(llrs.shape).astype(
        np.float32) * 1.9
    return llrs, m


@functools.cache
def _sharded(n, noisy):
    """{K: (hard, iters, ok)} of the port's decoder on n spawned ranks for
    every K of KS, all decoded in one launch (one spawn per world size)."""
    ins = {k: _noisy_blocks(k) if noisy else _blocks(k)[::2] for k in KS}
    outs = mesh.launch(ranks.steps, n, "cpu",
                       *[(ranks.turbo, (llrs, k, N_ITERS, m), {}) for k, (llrs, m) in ins.items()])
    res = {}
    for k, out in zip(KS, zip(*outs)):
        for o in out[1:]:  # iters and ok are equal on every rank
            np.testing.assert_array_equal(o["iters"], out[0]["iters"])
            np.testing.assert_array_equal(o["ok"], out[0]["ok"])
        res[k] = np.concatenate([o["hard"] for o in out], 1), out[0]["iters"], out[0]["ok"]
    return res


def _unsharded(llrs, k, m):
    hard, iters, ok = turbo.decode(torch.as_tensor(llrs), k, N_ITERS, m, early_exit=False,
                                   window=64)
    return hard.numpy(), iters.numpy(), ok.numpy()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", [4, pytest.param(2, marks=pytest.mark.slow)])
def test_sharded_turbo_matches_reference(k, n):
    llrs, msgs, m = _blocks(k)
    run = ref_turbo_shard.make_sharded_decoder(k, N_ITERS, ref_make_mesh(n, axis="win"),
                                               window=64, crc_mat=m)
    r_hard, r_iters, r_ok = (to_host(x) for x in run(jnp.asarray(llrs)))
    hard, iters, ok = _sharded(n, noisy=False)[k]
    assert ok.all() and (hard == msgs).all()
    np.testing.assert_array_equal(hard, r_hard.astype(np.uint8))
    np.testing.assert_array_equal(iters, r_iters)
    np.testing.assert_array_equal(ok, r_ok)
    for got, want in zip((hard, iters, ok), _unsharded(llrs, k, m)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", KS)
def test_sharded_turbo_on_two_ranks_matches_unsharded(k):
    """World 2 against the port's unsharded decoder, with more noise on the
    LLRs: blocks converge after 4 to 7 iterations or never (hard bits of the
    failed ones included)."""
    llrs, m = _noisy_blocks(k)
    hard, iters, ok = _sharded(2, noisy=True)[k]
    assert 0 < ok.sum() < len(ok) and len(set(iters.tolist())) > 2
    for got, want in zip((hard, iters, ok), _unsharded(llrs, k, m)):
        np.testing.assert_array_equal(got, want)


def test_windows_must_split_evenly():
    m = mesh.Mesh(None, 0, 3, torch.device("cpu"))
    with pytest.raises(AssertionError, match="split evenly"):
        turbo_shard.make_sharded_decoder(512, 4, m)


def test_each_half_is_one_r2max_half(tmp_path, monkeypatch):
    """On a world of one rank in this process: every half goes through
    kernels.bcjr.half_windowed with the r2max instance, 2 x n_iters calls
    per decode (on the card, one kernel launch each)."""
    calls = []
    real = bcjr.half_windowed

    def spy(lin, par, a0, b0, kernel="r2max"):
        calls.append((kernel, tuple(lin.shape)))
        return real(lin, par, a0, b0, kernel)

    monkeypatch.setattr(bcjr, "half_windowed", spy)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        me = mesh.Mesh(dist.group.WORLD, 0, 1, torch.device("cpu"))
        llrs, msgs, m = _blocks(512)
        d_loc, tails = turbo_shard.shard_llrs(torch.as_tensor(llrs), 512, me)
        hard, iters, ok = turbo_shard.make_sharded_decoder(512, 4, me, crc_mat=m)(d_loc, tails)
    finally:
        dist.destroy_process_group()
    assert calls == [("r2max", (2 * 8, 64))] * 8
    assert ok.all() and (hard.numpy() == msgs).all()
