"""The port's multi-host launch (``python -m srsue_tpu_torch.parallel.multihost``)
against the reference's two-process cluster (``tools/multihost_worker.py``,
``tests/test_multihost.py``): independent node processes, each starting
its own gloo CPU ranks, join one group over ``tcp://127.0.0.1`` and run the
carrier-sharded decode and the window-sharded turbo decoder on the
reference worker's seeded inputs. Their decisions equal the reference's
``shard_decode`` and ``make_sharded_decoder`` on the same mesh size (the
conftest's virtual CPU devices) and the port's unsharded decode and turbo
decoder: payload, tb_ok, n_ok, iters, hard bits and CRC flags exactly, snr
within 1e-3 dB (the two sum it in another order). Two nodes of one rank
each here; the reference's own shape, two nodes of four ranks (world 8),
under ``-m slow``."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.parallel import turbo_shard as ref_turbo_shard
from srsue_tpu.parallel.mesh import make_mesh as ref_make_mesh
from srsue_tpu.parallel.mesh import shard_decode as ref_shard_decode
from srsue_tpu.phy import crc as ref_crc
from srsue_tpu.phy import enb_tx as ref_tx
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import turbo as ref_turbo
from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.pdsch import PdschCodec as RefCodec
from srsue_tpu.utils.jaxutil import to_host
from srsue_tpu_torch.parallel import multihost
from srsue_tpu_torch.phy import ra, turbo
from srsue_tpu_torch.phy.pdsch import PdschCodec, equalized

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nodes(tmp_path, n_nodes, local_ranks, timeout_s=None, only=None):
    """Start the node processes (all, or those in `only`) and wait for them:
    [(returncode, stdout, stderr, decisions or None)] in node order."""
    address = f"tcp://127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    for node in only if only is not None else range(n_nodes):
        args = [sys.executable, "-m", "srsue_tpu_torch.parallel.multihost", str(node),
                str(n_nodes), address, str(local_ranks), "--device", "cpu",
                "--out", str(tmp_path / f"node{node}.npz")]
        if timeout_s is not None:
            args += ["--timeout", str(timeout_s)]
        procs.append((node, subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True)))
    outs = []
    try:
        for node, p in procs:
            out, err = p.communicate(timeout=420)
            path = tmp_path / f"node{node}.npz"
            outs.append((p.returncode, out, err, dict(np.load(path)) if path.exists() else None))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _reference(world):
    """The reference worker's draws and its two sharded paths at mesh size
    `world` on the virtual CPU devices: (inputs, decode outputs, turbo outputs)."""
    cell = Cell(n_prb=6, cell_id=7)
    grant = ref_ra.dl_grant(cell.n_prb, 5)
    codec = RefCodec(cell, grant, rnti=0x42, subframe=1, cfi=1, n_turbo_iters=4)
    rng = np.random.default_rng(0)
    b = 2 * world
    payloads = np.stack([rng.integers(0, 2, grant.tbs).astype(np.uint8) for _ in range(b)])
    td = np.stack([ref_tx.to_waveform(cell, ref_tx.build_pdsch_subframe(cell, codec, pl))[0]
                   for pl in payloads])
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    noisy, _ = ref_tx.awgn(rng, td, 20.0, signal_power=p_sig)
    noisy = noisy.astype(np.complex64)
    k = 512
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = ref_crc.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    msg = ref_crc.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
    x = 1.0 - 2.0 * ref_turbo.encode(msg).astype(np.float32)
    sigma = 10 ** (-2.0 / 20)
    xs = x[None] + rng.standard_normal((4,) + x.shape).astype(np.float32) * sigma
    llrs = (2 * xs / sigma ** 2).astype(np.float32)

    run, in_spec, _ = ref_shard_decode(cell, codec, ref_make_mesh(world))
    dec = [to_host(v) for v in run(jax.device_put(noisy, in_spec))]
    dec_t = ref_turbo_shard.make_sharded_decoder(k, 6, ref_make_mesh(world, axis="win"),
                                                 window=64, crc_mat=m)
    tur = [to_host(v) for v in dec_t(jnp.asarray(llrs))]
    return {"payloads": payloads, "noisy": noisy, "msg": msg, "llrs": llrs, "crc": m}, dec, tur


def _unsharded(noisy, llrs, m):
    """The port's unsharded decode and turbo decoder on the CPU: (payload,
    tb_ok, iters), (hard, iters, ok)."""
    codec = PdschCodec(multihost.CELL, ra.dl_grant(6, multihost.MCS), multihost.RNTI,
                       multihost.SUBFRAME, cfi=1, n_turbo_iters=multihost.DECODE_ITERS,
                       device="cpu")
    x_eq, nv_eff, _, _ = equalized(multihost.CELL, codec, codec.subframe,
                                   torch.as_tensor(noisy))
    payload, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
    tur = turbo.decode(torch.as_tensor(llrs), 512, 6, m, early_exit=False, window=64)
    return [v.numpy() for v in (payload, tb_ok, iters)], [v.numpy() for v in tur]


def _check_against_reference(outs, n_nodes, local_ranks):
    world = n_nodes * local_ranks
    for rc, out, err, _ in outs:
        assert rc == 0, f"node failed rc={rc}\n{out}\n{err[-3000:]}"
        assert "MULTIHOST_OK" in out and f"ndev={world} carriers={2 * world}" in out, out
    got = {key: np.concatenate([o[3][key] for o in outs], 1 if key == "turbo_hard" else 0)
           for key in ("payload", "tb_ok", "iters", "turbo_hard", "ranks")}
    np.testing.assert_array_equal(got["ranks"], np.arange(world))
    ins, (r_payload, r_ok, r_n_ok, r_snr), (r_hard, r_iters, r_ok_t) = _reference(world)

    port_ins = multihost.inputs(world)  # the node's own draws: the reference's
    for key in ("payloads", "msg", "llrs", "crc"):
        np.testing.assert_array_equal(port_ins[key], ins[key])
    np.testing.assert_allclose(port_ins["noisy"], ins["noisy"], rtol=0, atol=1e-5)

    assert got["tb_ok"].all() and (got["payload"] == ins["payloads"]).all()
    np.testing.assert_array_equal(got["payload"], r_payload.astype(np.uint8))
    np.testing.assert_array_equal(got["tb_ok"], r_ok)
    for _, _, _, o in outs:
        assert int(o["n_ok"]) == int(r_n_ok) == 2 * world
        assert abs(float(o["snr"]) - float(r_snr)) < 1e-3
        np.testing.assert_array_equal(o["turbo_iters"], r_iters)
        np.testing.assert_array_equal(o["turbo_ok"], r_ok_t)
    np.testing.assert_array_equal(got["turbo_hard"], r_hard.astype(np.uint8))
    assert (got["turbo_hard"] == ins["msg"][None]).all()

    (payload, tb_ok, iters), (hard, t_iters, t_ok) = _unsharded(ins["noisy"], ins["llrs"],
                                                                ins["crc"])
    np.testing.assert_array_equal(got["payload"], payload)
    np.testing.assert_array_equal(got["tb_ok"], tb_ok)
    np.testing.assert_array_equal(got["iters"], iters)
    np.testing.assert_array_equal(got["turbo_hard"], hard)
    np.testing.assert_array_equal(outs[0][3]["turbo_iters"], t_iters)
    np.testing.assert_array_equal(outs[0][3]["turbo_ok"], t_ok)


def test_two_nodes_over_tcp_match_the_reference(tmp_path):
    _check_against_reference(_nodes(tmp_path, 2, 1), 2, 1)


@pytest.mark.slow
def test_two_nodes_of_four_ranks_match_the_reference(tmp_path):
    """The reference's own shape: two processes of four ranks, world 8."""
    _check_against_reference(_nodes(tmp_path, 2, 4), 2, 4)


@pytest.mark.parametrize("node", [0, 1])
def test_a_node_whose_peer_never_comes_raises_within_its_timeout(tmp_path, node):
    """Node 0 listens and waits for the other rank; node 1 connects to an
    address where nobody listens. Each exits non-zero after its timeout."""
    (rc, out, err, saved), = _nodes(tmp_path, 2, 1, timeout_s=5, only=[node])
    assert rc != 0 and "MULTIHOST_OK" not in out and saved is None
    assert f"rank {node} of 2 failed" in err
    assert "Timed out" in err or "timed out" in err, err[-3000:]


@pytest.mark.parametrize("argv, match", [
    (["0", "2", "file:///tmp/x", "1", "--device", "cpu"], "tcp://"),
    (["2", "2", "tcp://127.0.0.1:1", "1", "--device", "cpu"], "node 2 of 2"),
    (["0", "2", "tcp://127.0.0.1:1", "0", "--device", "cpu"], "0 local ranks"),
])
def test_bad_arguments_raise(argv, match):
    with pytest.raises(ValueError, match=match):
        multihost.main(argv)


def test_a_rank_takes_the_card_of_its_local_rank(monkeypatch):
    """make_mesh joins with the global rank and picks the card by the local
    rank: under NCCL that card must exist on the node, under gloo ranks
    wrap round the cards. start_ranks keeps a node's ranks inside the group."""
    from srsue_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="outside a group"):
        mesh.start_ranks(None, (), "tcp://127.0.0.1:1", 4, first_rank=3, n_local=2,
                         device="cpu")
    joined, cards = [], []
    monkeypatch.setattr(mesh, "require_cuda", lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda *a, **kw: joined.append(kw))
    m = mesh.make_mesh(5, 8, "tcp://127.0.0.1:1", "cuda", local_rank=1, timeout_s=7)
    assert (m.rank, m.size, str(m.device), str(cards[-1])) == (5, 8, "cuda:1", "cuda:1")
    assert (joined[0]["rank"], joined[0]["world_size"]) == (5, 8)
    assert joined[0]["timeout"].total_seconds() == 7
    with pytest.raises(RuntimeError, match="3 NCCL ranks need 3 CUDA devices"):
        mesh.make_mesh(6, 8, "tcp://127.0.0.1:1", "cuda", local_rank=2)
    assert str(mesh.make_mesh(6, 8, "tcp://127.0.0.1:1", "cuda", "gloo", local_rank=2)
               .device) == "cuda:0"
    assert str(mesh.make_mesh(1, 2, "file:///x", "cuda").device) == "cuda:1"
