"""``turbo.decode``'s loop body and its CUDA graphs.

On the CPU: the loop with the tail betas computed once a decode and no exit
check before the first iteration gives the results, bit for bit, of a frozen
copy of the loop that recomputed them in every half and checked first.

The graph cache's policy (``utils.graphs.GraphCache``, which the
receive frontends share), with a stand-in for the capture: a shape that
comes back within the cache's last ``SIZE`` shapes is captured, one that
comes back later runs eagerly again.

On the card (marked ``cuda``, skipped without one): a shape's first call
runs the body eagerly, its second captures the prep and iteration graphs
and replays them, later calls replay; every replayed result equals the eager
one at atol 0, a capture happens once a shape, a returned result survives
the next call, shapes dropped and captured again in turns through the one
graph pool stay exact, and the half-iteration kernels' launch counter grows at each replay
by what its capture launched: 2 per iteration, 4 where the body launches
each half twice. This file imports no JAX:

    python -m pytest tests/test_torch_turbo_graph.py -m cuda --noconftest -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from srsue_tpu_torch.kernels import bcjr
from srsue_tpu_torch.phy import crc as crcmod
from srsue_tpu_torch.phy import turbo
from srsue_tpu_torch.utils import graphs, trace


def _inputs(k: int, snrs_db, seed: int):
    """LLRs [B, 3, K+4] of CRC24A-terminated blocks, one SNR a block, and
    the [K, 24] syndrome matrix over the whole block."""
    rng = np.random.default_rng(seed)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    llrs = []
    for snr in snrs_db:
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        sigma = 10 ** (-snr / 20)
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        x = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
        llrs.append(2 * x / sigma**2)
    return torch.as_tensor(np.stack(llrs), dtype=torch.float32), m


def _decode_before(d_llrs, k, n_iters, crc_mat, early_exit, kernel="r2max"):
    """``turbo.decode`` as it was before its tail betas were hoisted out of
    the loop: each half computed them again, and the loop checked for an
    early exit before its first iteration too."""
    dev = d_llrs.device
    B = d_llrs.shape[0]
    lw, d_llrs = turbo._prepare(d_llrs, k, kernel, None)
    W = k // lw
    perm, inv = turbo.qpp_tensors(k, dev)
    sys1, par1, par2, (t1s, t1p, t2s, t2p) = turbo._streams(d_llrs, k)
    sys2 = sys1[:, perm]
    crc_m = turbo._crc_of(crc_mat, dev)
    le21 = torch.zeros(B, k, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    hard = torch.zeros(B, k, dtype=torch.uint8, device=dev)
    ab1, bb1, ab2, bb2 = (torch.zeros(B, W, 8, device=dev) for _ in range(4))
    stop_early = early_exit and crc_m is not None
    for _ in range(n_iters):
        if stop_early and bool(done.all()):
            break
        le12, ab1n, bb1n = bcjr.bcjr_half_windowed(
            sys1, par1, le21, t1s, t1p, ab1, bb1, lw, kernel)
        le21_raw, ab2n, bb2n = bcjr.bcjr_half_windowed(
            sys2, par2, le12[:, perm], t2s, t2p, ab2, bb2, lw, kernel)
        le21_new = le21_raw[:, inv]
        hard_new = (sys1 + le12 + le21_new < 0).to(torch.uint8)
        ok = turbo._ok_of(hard_new, crc_m)
        m = done[:, None]
        m3 = done[:, None, None]
        le21 = torch.where(m, le21, le21_new)
        hard = torch.where(m, hard, hard_new)
        ab1 = torch.where(m3, ab1, ab1n)
        bb1 = torch.where(m3, bb1, bb1n)
        ab2 = torch.where(m3, ab2, ab2n)
        bb2 = torch.where(m3, bb2, bb2n)
        iters += (~done).to(torch.int32)
        done = done | ok
    return hard, iters, turbo._ok_of(hard, crc_m) | done


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


# per K: a block that converges at once, one after a few iterations and one
# that never does (the loop runs to its end); then three that all converge
# (early exit stops the loop)
CASES = [(40, (4.0, -2.0, -6.0)), (64, (4.0, -1.5, -6.0)), (512, (4.0, -0.5, -6.0)),
         (512, (4.0, 1.0, -0.5))]


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("k,snrs_db", CASES)
def test_hoisted_tail_betas_bit_exact(k, snrs_db, early_exit):
    d, m = _inputs(k, snrs_db, seed=k)
    got = turbo.decode(d, k, 8, m, early_exit=early_exit)
    want = _decode_before(d, k, 8, m, early_exit)
    _equal(got, want)
    assert len(set(got[1].tolist())) > 1


class _NoGraph:
    def replay(self):
        pass


def test_capture_lists_launches_that_replays_count(monkeypatch):
    """Inside a capture (``graphs.listing``) the wrappers' calls count
    nothing and are listed; each ``graphs.replay`` of the list counts them
    again."""
    monkeypatch.setattr(bcjr, "launches", dict.fromkeys(bcjr.launches, 0))
    monkeypatch.setattr(bcjr, "shapes", {name: set() for name in bcjr.launches})
    with graphs.listing() as calls:
        bcjr._count("r2max", (6, 64))
        bcjr._count("r2max", (6, 64))
        bcjr._count("fused", (3, 48))
    assert [call for _, call in calls] == [("r2max", (6, 64)), ("r2max", (6, 64)),
                                           ("fused", (3, 48))]
    assert not any(bcjr.launches.values()) and not any(bcjr.shapes.values())
    for _ in range(3):
        graphs.replay(_NoGraph(), calls)
    assert bcjr.launches == {**dict.fromkeys(bcjr.launches, 0), "r2max": 6, "fused": 3}
    assert bcjr.shapes["r2max"] == {(6, 64)} and bcjr.shapes["fused"] == {(3, 48)}
    bcjr._count("v4", (2, 64))  # outside a capture: counted at once
    assert bcjr.launches["v4"] == 1


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device(monkeypatch):
    """The card, with an empty graph cache: each test's first call at a
    shape runs eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from srsue_tpu_torch.utils.device import require_cuda

    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    return require_cuda()


def _card_inputs(b, c, k, device):
    """B subframes of C blocks of K, flattened as the PDSCH codec does."""
    d, m = _inputs(k, np.tile(np.linspace(-1.0, 3.0, c), b), seed=b * k)
    return d.to(device), torch.as_tensor(m, dtype=torch.float32, device=device)


def _captures(fn, tmp_path):
    with trace.ProfilerTrace(str(tmp_path / "prof")) as t:
        out = fn()
    torch.cuda.synchronize()
    assert t.errors == []
    events = json.loads(Path(t.path).read_text())["traceEvents"]
    return out, sum(1 for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation" and e["name"] == "turbo.graph_capture")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["r2max", "v4"])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("b,c,k", [(1, 13, 5824), (4, 3, 40)])
def test_replay_equals_eager(cuda_device, b, c, k, early_exit, kernel, tmp_path):
    d, m = _card_inputs(b, c, k, cuda_device)
    run = lambda: turbo.decode(d, k, 8, m, early_exit=early_exit, kernel=kernel)  # noqa: E731
    eager, n0 = _captures(run, tmp_path / "1")
    first, n1 = _captures(run, tmp_path / "2")
    held = [x.clone() for x in first]
    later = [_captures(run, tmp_path / str(i)) for i in (3, 4)]
    assert (n0, n1, [n for _, n in later]) == (0, 1, [0, 0]), "one capture, at the second call"
    for got, _ in [(first, n1), *later]:
        _equal(got, eager)
    _equal(first, held)  # not overwritten by the later calls at its shape
    assert int(eager[1].max()) >= 1


@pytest.mark.cuda
def test_replayed_launches_counted(cuda_device):
    k = 512
    d, m = _card_inputs(2, 3, k, cuda_device)
    for _ in range(2):  # eager, then the capture and its replays
        turbo.decode(d, k, 8, m, early_exit=False)
    bcjr.shapes["r2max"].clear()
    before = bcjr.launches["r2max"]
    _, iters, _ = turbo.decode(d, k, 5, m, early_exit=False)
    assert bcjr.launches["r2max"] - before == 2 * 5
    assert bcjr.shapes["r2max"] == {(6 * (k // turbo.pick_window(k)), turbo.pick_window(k))}
    before = bcjr.launches["r2max"]
    _, iters, _ = turbo.decode(d, k, 8, m)
    assert bcjr.launches["r2max"] - before == 2 * int(iters.max())


@pytest.mark.cuda
def test_replayed_launches_follow_the_body(cuda_device, monkeypatch):
    """A body that launches each half twice (the second result kept)
    counts 4 launches an iteration eagerly, at the capture's call and at a
    replay: a replay counts what its capture launched."""
    half = bcjr.half_windowed

    def twice(*args, **kwargs):
        half(*args, **kwargs)
        return half(*args, **kwargs)

    monkeypatch.setattr(bcjr, "half_windowed", twice)
    k = 512
    d, m = _card_inputs(2, 3, k, cuda_device)
    counts = []
    for _ in range(3):  # eager, the capture's call, a replay
        before = bcjr.launches["r2max"]
        turbo.decode(d, k, 5, m, early_exit=False)
        counts.append(bcjr.launches["r2max"] - before)
    assert counts == [4 * 5] * 3
    assert list(graphs.GRAPHS.keys.values()) != [None]


@pytest.mark.cuda
def test_shapes_share_the_pool(cuda_device, monkeypatch):
    """Two pairs of shapes in turns, each shape twice, with the cache held
    to two shapes, so that each pair's graphs are dropped and captured
    again into the one pool: each result equals its shape's eager one."""
    captured = []

    class Counted(turbo._Graphed):
        def __init__(self, *args):
            super().__init__(*args)
            captured.append(args[2])

    monkeypatch.setattr(graphs.GraphCache, "SIZE", 2)
    monkeypatch.setattr(turbo, "_Graphed", Counted)
    cases = [(k,) + _card_inputs(b, 3, k, cuda_device) for b, k in
             [(1, 40), (3, 40), (2, 512), (1, 5824)]]
    eager = [turbo.decode(d, k, 8, m) for k, d, m in cases]
    graphs.GRAPHS.keys.clear()
    for _ in range(3):
        for pair in ((0, 1), (2, 3)):
            for _ in range(2):
                for i in pair:
                    k, d, m = cases[i]
                    _equal(turbo.decode(d, k, 8, m), eager[i])
    assert captured == [40, 40, 512, 5824] * 3
    assert sum(g is not None for g in graphs.GRAPHS.keys.values()) == 2


def test_cache_captures_a_shape_that_comes_back_within_size(monkeypatch):
    """The cache's policy, with a stand-in for the capture: a key's first
    call runs eagerly, a waiting key (held without graphs) captures, a key
    holding them replays. Past ``SIZE`` waiting keys of a caller its least
    recently seen goes, so a key that comes back after more than ``SIZE``
    others of its caller runs eagerly again, and keys seen once drop no
    graphs and no other caller's waiting keys; past ``SIZE`` keys holding
    graphs a capture drops the least recently used. A capture takes a fresh
    pool once every graph of the last one has been dropped."""
    dev = torch.device("cpu")

    class Fake:
        def __init__(self, pool, stream):
            self.device, self.pool, self.bytes = dev, pool, 0

    pools = iter(range(1, 10))
    monkeypatch.setattr(graphs, "new_pool", lambda dev: next(pools))
    monkeypatch.setattr(graphs, "capture_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "memory", lambda dev: 1 << 40)
    cache = graphs.GraphCache()
    cache.SIZE = 3
    held, outcomes = {}, []
    for key in [("c", k) for k in (1, 1, 1, 2, 3, 4, 5, 1, 2, 2, 6, 6, 7, 1, 8, 8, 2)] + [
            ("d", k) for k in range(5)] + [("c", 7)]:
        got = cache.get(key, dev, Fake)
        outcomes.append("eager" if got is None else "replay" if got is held.get(key) else
                        f"capture into {got.pool}")
        held[key] = got
    assert outcomes == [
        "eager", "capture into 1", "replay", "eager", "eager", "eager", "eager", "replay",
        "eager", "capture into 1", "eager", "capture into 1", "eager", "replay", "eager",
        "capture into 1", "eager"] + ["eager"] * 5 + ["capture into 1"]
    assert [k for k, g in cache.keys.items() if g is not None] == [("c", 1), ("c", 8), ("c", 7)]
    assert list(cache.waiting["c"]) == [("c", 5), ("c", 2)]
    assert list(cache.waiting["d"]) == [("d", 2), ("d", 3), ("d", 4)]
    cache.keys.clear()  # every graph dropped
    assert [cache.get(("c", 9), dev, Fake), cache.get(("c", 9), dev, Fake).pool] == [None, 2]


def test_cache_holds_graphs_within_a_share_of_memory(monkeypatch):
    """Past ``1 / SHARE`` of the card's memory, a capture drops the least
    recently used shapes holding graphs (their keys too), never itself."""
    dev = torch.device("cpu")

    class Fake:
        def __init__(self, nbytes):
            self.device, self.bytes = dev, nbytes

    monkeypatch.setattr(graphs, "new_pool", lambda dev: None)
    monkeypatch.setattr(graphs, "capture_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "memory", lambda dev: graphs.GraphCache.SHARE * 100)
    cache = graphs.GraphCache()
    outcomes = []
    for key, nbytes in [("a", 60), ("a", 60), ("b", 30), ("b", 30), ("c", 30), ("c", 30),
                        ("a", 60), ("a", 60), ("d", 150), ("d", 150)]:
        got = cache.get(key, dev, lambda pool, stream, n=nbytes: Fake(n))
        outcomes.append("eager" if got is None else "graph")
    assert outcomes == ["eager", "graph"] * 5
    assert list(cache.keys) == ["d"]  # over the share alone: held, every other shape dropped
