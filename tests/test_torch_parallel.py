"""The port's carrier-sharded decode (``parallel/mesh.py``) against the JAX
package's on the same mesh size: the port's ranks are spawned gloo CPU
processes, the reference runs on the virtual CPU devices of the conftest.
Shapes and draws of tests/test_parallel.py (6 PRB, MCS 5, 4 turbo
iterations, 20 dB), with B = 2n subframes. payload, tb_ok and n_ok are
equal; snr (the mean of rsrp / nvar over the global batch, in dB) within
1e-3 dB: the two sum it in another order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srsue_tpu.parallel.mesh import make_mesh as ref_make_mesh
from srsue_tpu.parallel.mesh import shard_decode as ref_shard_decode
from srsue_tpu.phy import enb_tx as ref_tx
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.pdsch import PdschCodec as RefCodec
from srsue_tpu.utils.jaxutil import to_host
from srsue_tpu_torch import entry
from srsue_tpu_torch.parallel import mesh, ranks
from srsue_tpu_torch.phy import cell as port_cell


def _mine(obj):
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _vectors(cell, codec, b):
    rng = np.random.default_rng(0)
    payloads = np.stack([rng.integers(0, 2, codec.grant.tbs).astype(np.uint8)
                         for _ in range(b)])
    td = np.stack([ref_tx.to_waveform(cell, ref_tx.build_pdsch_subframe(cell, codec, pl))[0]
                   for pl in payloads])
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    noisy, _ = ref_tx.awgn(rng, td, 20.0, signal_power=p_sig)
    return payloads, noisy.astype(np.complex64)


@pytest.mark.parametrize("n", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_shard_decode_matches_reference(n):
    cell = Cell(n_prb=6, cell_id=7)
    grant = ref_ra.dl_grant(cell.n_prb, 5)
    ref_codec = RefCodec(cell, grant, rnti=0x42, subframe=1, cfi=1, n_turbo_iters=4)
    b = 2 * n
    payloads, noisy = _vectors(cell, ref_codec, b)

    run, in_spec, _ = ref_shard_decode(cell, ref_codec, ref_make_mesh(n))
    r_payload, r_ok, r_n_ok, r_snr = run(jax.device_put(noisy, in_spec))

    out = mesh.launch(ranks.decode, n, "cpu", _mine(cell), _mine(grant), 0x42, 1, 4, noisy)
    payload = np.concatenate([o["payload"] for o in out])
    tb_ok = np.concatenate([o["tb_ok"] for o in out])
    assert tb_ok.all() and (payload == payloads).all()
    np.testing.assert_array_equal(payload, to_host(r_payload).astype(np.uint8))
    np.testing.assert_array_equal(tb_ok, to_host(r_ok))
    for o in out:  # the aggregates are mesh-global: equal on every rank
        assert o["n_ok"] == int(to_host(r_n_ok)) == b
        assert abs(o["snr"] - float(to_host(r_snr))) < 1e-3
        assert o["iters"].shape == (b // n, 1)


def test_uneven_carrier_shards_raise():
    cell = port_cell.Cell(n_prb=6, cell_id=7)
    grant = port_cell.DlGrant(**dataclasses.asdict(ref_ra.dl_grant(6, 5)))
    with pytest.raises(RuntimeError, match="does not split evenly"):
        mesh.launch(ranks.decode, 2, "cpu", cell, grant, 0x42, 1, 4,
                    np.zeros((3, cell.sf_len), np.complex64))


def test_dryrun_multichip_on_two_cpu_ranks():
    out = entry.dryrun_multichip(2, device="cpu")
    assert [o["n_ok"] for o in out] == [4, 4]
    assert all(o["turbo"] for o in out)
    assert out[0]["tbs_flagship"] == 75376


def test_launch_on_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.launch(ranks.dryrun, 1, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.launch(ranks.dryrun, 1)  # the card is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(1)
    with pytest.raises(ValueError, match="gloo"):
        mesh.launch(ranks.dryrun, 1, "cpu", backend="nccl")


def test_shard_splits_evenly():
    m = mesh.Mesh(None, 1, 4, torch.device("cpu"))
    x = np.arange(8)
    np.testing.assert_array_equal(mesh.shard(x, m), [2, 3])
    with pytest.raises(ValueError):
        mesh.shard(np.arange(6), m)
