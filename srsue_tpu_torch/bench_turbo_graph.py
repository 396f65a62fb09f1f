"""Times ``turbo.decode``'s CUDA graphs (``utils.graphs.GraphCache``) on one
CUDA GPU: what a shape's capture costs, and what the cache gives a UE whose
grants change from TTI to TTI.

    python -m srsue_tpu_torch.bench_turbo_graph [seed] [ttis]

Shapes: at each of three input shapes (B=1 x 13 blocks of K=5824, the
100 PRB MCS 28 TB; B=1 x 1 block of K=1056; B=256 x 13 of K=5824), the
host wall ms (synchronised) of an eager call, of the call that captures
(once with this module's capture, once through ``torch.cuda.graph``,
which first synchronises and empties the allocator's cache) and of a
replayed call, the eager call at another shape right after each capture,
and the memory the capture reserved: medians of three captures each way,
in turns, each on a fresh cache.

Sequences: `ttis` TTIs (default 2,000) of one UE on a 20 MHz cell, one TB
a TTI at B=1, segmented as TS 36.212 5.1.2 does; one ``turbo.decode`` call
with early exit a K-group, on encoded blocks with noise that converge in one
or two iterations. The grants, drawn from `seed`:

  * ``cqi_walk``: 100 PRB, the MCS a random walk of +-1 every 5 TTIs over
    0-28 (link adaptation on a full buffer);
  * ``buckets``: the PRB count drawn each TTI from the eNB emulator's
    buckets (4, 10, 25, 100), the MCS walking as above;
  * ``uniform``: PRB count 1-100 and MCS 0-28 drawn each TTI (nearly every
    shape new: the worst case for a cache).

Each sequence runs eagerly (no graphs) and through the cache at several
sizes; each line gives the distinct keys, the captures, the eager calls
and replays, the ms a call (mean, p50, p95) and in all, and the memory the
graphs held at the end (``_Graphed.bytes``).
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from .phy import crc as crcmod
from .phy import ra, segmentation, turbo
from .utils import graphs

SIZES = (4, 8, 16, 32, 64, 256)
SNR_DB = 3.0
PRB_BUCKETS = (4, 10, 25, 100)


class _Tally(graphs.GraphCache):
    """The cache at `size` keys (None: no graphs), noting each call's key
    and outcome: replay, capture or eager."""

    def __init__(self, size: int | None):
        super().__init__()
        self.size, self.last, self.seen = size, None, set()
        if size is not None:
            self.SIZE = size

    def get(self, key, dev, make):
        self.seen.add(key)
        if self.size is None:
            self.last = "eager"
            return None
        self.last = ("eager" if key not in self.keys else
                     "capture" if self.keys[key] is None else "replay")
        return super().get(key, dev, make)

    def held_mb(self) -> float:
        """The device memory the held graphs' inputs and state take."""
        return sum(g.bytes for g in self.keys.values() if g is not None) / 2**20


def _blocks(k: int, count: int, rng) -> tuple[torch.Tensor, torch.Tensor]:
    """LLRs [count, 3, K+4] of CRC24A-terminated blocks at SNR_DB and the
    [K, 24] syndrome matrix, on the card."""
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    sigma = 10 ** (-SNR_DB / 20)
    llrs = []
    for _ in range(count):
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        x = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
        llrs.append(2 * x / sigma**2)
    return (torch.as_tensor(np.stack(llrs), device="cuda"),
            torch.as_tensor(m, dtype=torch.float32, device="cuda"))


def _groups(n_prb: int, mcs: int) -> list[tuple[int, int]]:
    """(K, blocks) of each K-group of the TB of a 20 MHz grant."""
    ks = segmentation.plan(ra.dl_grant(100, mcs, n_prb_alloc=n_prb).tbs).block_ks
    return [(k, ks.count(k)) for k in dict.fromkeys(ks)]


def grants(kind: str, ttis: int, seed: int) -> list[tuple[int, int]]:
    """(PRB count, MCS) of each TTI of sequence `kind`."""
    rng = np.random.default_rng(seed)
    mcs, out = int(rng.integers(0, 29)), []
    for t in range(ttis):
        if kind == "uniform":
            out.append((int(rng.integers(1, 101)), int(rng.integers(0, 29))))
            continue
        if t % 5 == 0:
            mcs = int(np.clip(mcs + rng.integers(-1, 2), 0, 28))
        n_prb = 100 if kind == "cqi_walk" else int(rng.choice(PRB_BUCKETS))
        out.append((n_prb, mcs))
    return out


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def run_sequence(calls, size: int | None) -> dict:
    """The calls [(K, d, crc)] through a fresh cache of `size`."""
    tally = graphs.GRAPHS = _Tally(size)
    ms, outcomes = [], []
    for k, d, m in calls:
        ms.append(_timed(lambda: turbo.decode(d, k, 8, m)))
        outcomes.append(tally.last)
    return {"keys": len(tally.seen), "captures": outcomes.count("capture"),
            "eager": outcomes.count("eager"), "replays": outcomes.count("replay"),
            "mean_ms": statistics.fmean(ms), "p50_ms": _pct(ms, 50), "p95_ms": _pct(ms, 95),
            "total_s": sum(ms) / 1e3, "held_mb_at_end": tally.held_mb()}


def _ctx_capture(graph, pool, stream, body) -> list:
    """The capture as ``torch.cuda.graph`` makes it."""
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        with graphs.listing() as calls:
            body()
    return calls


def shape_costs(rng, reps: int = 3) -> list[dict]:
    """Each shape's eager, capture and replay ms, the capture both ways in
    turns, `reps` times each on a fresh cache (so a fresh pool); medians."""
    shapes = [(1, 13, 5824), (1, 1, 1056), (256, 13, 5824)]
    other_k, (other_d, other_m) = 512, _blocks(512, 3, rng)
    rows = []
    for b, c, k in shapes:
        d1, m = _blocks(k, c, rng)
        d = d1.repeat(b, 1, 1)
        row = {"shape": f"B={b} x {c} x K={k}"}
        graphs.GRAPHS = _Tally(None)
        row["eager_ms"] = statistics.median(
            _timed(lambda: turbo.decode(d, k, 8, m)) for _ in range(5))
        got: dict = {}
        for _ in range(reps):
            for name, capture in (("capture", turbo._capture), ("ctx_capture", _ctx_capture)):
                turbo._capture, saved = capture, turbo._capture
                try:
                    graphs.GRAPHS = _Tally(8)
                    turbo.decode(d, k, 8, m)  # eager: the key enters
                    before = torch.cuda.memory_reserved()
                    got.setdefault(f"{name}_ms", []).append(
                        _timed(lambda: turbo.decode(d, k, 8, m)))
                    got.setdefault(f"{name}_reserved_mb", []).append(
                        (torch.cuda.memory_reserved() - before) / 2**20)
                    got.setdefault(f"{name}_held_mb", []).append(graphs.GRAPHS.held_mb())
                    got.setdefault(f"{name}_next_eager_ms", []).append(
                        _timed(lambda: turbo.decode(other_d, other_k, 8, other_m)))
                    got.setdefault(f"{name}_replay_ms", []).append(statistics.median(
                        _timed(lambda: turbo.decode(d, k, 8, m)) for _ in range(10)))
                finally:
                    turbo._capture = saved
        row.update({name: statistics.median(v) for name, v in got.items()})
        row["capture_ms_each"] = [round(x, 3) for x in got["capture_ms"]]
        row["ctx_capture_ms_each"] = [round(x, 3) for x in got["ctx_capture_ms"]]
        rows.append(row)
        del d
        graphs.GRAPHS = _Tally(None)
        torch.cuda.empty_cache()
    return rows


def main(seed: int = 1, ttis: int = 2000) -> int:
    if not torch.cuda.is_available():
        print("bench_turbo_graph: needs a CUDA GPU", file=sys.stderr)
        return 2
    from .kernels import build

    build.load()
    rng = np.random.default_rng(seed)
    smi = torch.cuda.get_device_name()
    saved = graphs.GRAPHS
    try:
        for row in shape_costs(rng):
            print(f"shape {smi}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
                flush=True)
        for kind in ("cqi_walk", "buckets", "uniform"):
            seq = grants(kind, ttis, seed)
            inputs: dict = {}
            calls = []
            for n_prb, mcs in seq:
                for k, count in _groups(n_prb, mcs):
                    if (k, count) not in inputs:
                        inputs[(k, count)] = _blocks(k, count, rng)
                    calls.append((k, *inputs[(k, count)]))
            run_sequence(calls[:50], None)  # warm the allocator and the tables
            for size in (None, *SIZES):
                r = run_sequence(calls, size)
                print(f"sequence {kind} {smi}: {ttis} TTIs, {len(calls)} calls, cache "
                      f"{size if size is not None else 'off'}: " + ", ".join(
                          f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in r.items()), flush=True)
    finally:
        graphs.GRAPHS = saved
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:3])))
