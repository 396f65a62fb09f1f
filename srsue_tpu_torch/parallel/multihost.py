"""One node of a multi-host launch: the counterpart of
``tools/multihost_worker.py``.

    python -m srsue_tpu_torch.parallel.multihost <node_rank> <n_nodes> \\
        <tcp://host:port> <local_ranks> [--device cpu|cuda] [--backend gloo|nccl] \\
        [--out file.npz] [--timeout S]

Each node is an independent OS process (one per host). It starts
`local_ranks` ranks of its own (``mesh.start_ranks``), global ranks
``node_rank * local_ranks + local_rank``, and they join one group of
``n_nodes * local_ranks`` ranks that meets at the ``tcp://`` address, where
the node of rank 0 listens. Over that group it runs what the reference
worker runs over its global mesh, on the same seeded inputs drawn in the
same order (``inputs``): (a) the carrier-sharded decode (``ranks.decode``:
6 PRB cell 7, MCS 5, subframe 1, CFI 1, 4 turbo iterations, B = 2 x world
subframes at 20 dB from ``default_rng(0)``); (b) the window-sharded turbo
decoder (``ranks.turbo``: 4 noisy codewords of one K=512 CRC24A block,
sigma 10^(-2/20), 6 iterations, windows of 64). It raises unless n_ok == B
and its ranks' payloads are the ones sent, and unless every codeword passes
its CRC with no bit error; then prints ``MULTIHOST_OK pid=.. ndev=..
carriers=.. turbo_ok=1`` as the reference does and, with ``--out``, writes
its ranks' decisions and kernel launches (``run_node``'s keys) to an npz.

On ``cuda`` the ranks use NCCL, one card each by local rank (a node with
fewer cards than local ranks raises); ``--backend gloo`` lets them share a
card. A node whose peers never join raises after ``--timeout`` seconds
(``mesh.TIMEOUT_S`` by default).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..entry import make_waveforms
from ..phy import crc as crcmod
from ..phy import ra
from ..phy import turbo as turbo_mod
from ..phy.cell import Cell
from ..phy.pdsch import PdschCodec
from ..utils.device import require_cuda
from . import mesh, ranks

CELL = Cell(n_prb=6, cell_id=7)
MCS, RNTI, SUBFRAME, DECODE_ITERS, SNR_DB = 5, 0x42, 1, 4, 20.0
TURBO_K, TURBO_CODEWORDS, TURBO_ITERS, WINDOW = 512, 4, 6, 64
TURBO_SIGMA = 10 ** (-2.0 / 20)


def inputs(world: int) -> dict:
    """The reference worker's inputs for a group of `world` ranks, drawn from
    one ``default_rng(0)`` in its order: payloads [2 world, tbs] and their
    noisy subframes [2 world, sf_len]; then the turbo message [K] (CRC24A
    attached), its LLRs [4, 3, K+4] float32 and the CRC matrix [K, 24]."""
    grant = ra.dl_grant(CELL.n_prb, MCS)
    codec = PdschCodec(CELL, grant, RNTI, SUBFRAME, cfi=1, n_turbo_iters=DECODE_ITERS,
                       device="cpu")  # host tables of the transmitter only
    rng = np.random.default_rng(0)
    b = 2 * world
    noisy, payloads, _ = make_waveforms(CELL, codec, rng, b, SNR_DB, n_distinct=b)
    k = TURBO_K
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
    x = 1.0 - 2.0 * turbo_mod.encode(msg).astype(np.float32)
    xs = x[None] + rng.standard_normal((TURBO_CODEWORDS,) + x.shape).astype(
        np.float32) * TURBO_SIGMA
    return {"grant": grant, "noisy": noisy.astype(np.complex64), "payloads": payloads,
            "msg": msg, "llrs": (2 * xs / TURBO_SIGMA ** 2).astype(np.float32), "crc": m}


def run_node(node_rank: int, n_nodes: int, address: str, local_ranks: int,
             device: str | torch.device = "cuda", backend: str | None = None,
             timeout_s: float = mesh.TIMEOUT_S) -> dict:
    """Run this node's ranks of the two sharded paths and check them; returns
    its ranks' decisions in rank order: payload [b, tbs], tb_ok [b], iters
    [b, C] of their subframes, the global n_ok and snr, turbo_hard [4, K
    local_ranks / world] of their windows, turbo_iters and turbo_ok [4], and
    ranks (their global ranks), seconds (the launch, spawn included),
    r2max_launches per rank and r2max_shapes, rows of (rank, windows, lw)."""
    if not address.startswith("tcp://"):
        raise ValueError(f"a node meets its peers at a tcp:// address, not {address!r}")
    if not 0 <= node_rank < n_nodes or local_ranks < 1:
        raise ValueError(f"node {node_rank} of {n_nodes} with {local_ranks} local ranks")
    if torch.device(device).type == "cuda":
        require_cuda()
    world = n_nodes * local_ranks
    first = node_rank * local_ranks
    data = inputs(world)
    calls = [(ranks.decode, (CELL, data["grant"], RNTI, SUBFRAME, DECODE_ITERS, data["noisy"]),
              {}),
             (ranks.turbo, (data["llrs"], TURBO_K, TURBO_ITERS, data["crc"], WINDOW), {})]
    t0 = time.perf_counter()
    outs = mesh.start_ranks(ranks.steps, tuple(calls), address, world, first, local_ranks,
                            device, backend, timeout_s)
    seconds = time.perf_counter() - t0
    dec, tur = zip(*outs)
    b, k_loc = 2 * world, TURBO_K // world
    n_ok = {o["n_ok"] for o in dec}
    if n_ok != {b}:
        raise RuntimeError(f"carrier decode: n_ok {sorted(n_ok)} of {b}")
    payload = np.concatenate([o["payload"] for o in dec])
    if not np.array_equal(payload, data["payloads"][2 * first:2 * (first + local_ranks)]):
        raise RuntimeError("carrier decode: a payload differs from the one sent")
    hard = np.concatenate([o["hard"] for o in tur], 1)
    want = data["msg"][first * k_loc:(first + local_ranks) * k_loc]
    if not all(o["ok"].all() for o in tur):
        raise RuntimeError(f"sharded turbo: CRC {[o['ok'].tolist() for o in tur]}")
    if (hard != want[None]).any():
        raise RuntimeError(f"sharded turbo: {int((hard != want[None]).sum())} bit errors")
    return {"payload": payload, "tb_ok": np.concatenate([o["tb_ok"] for o in dec]),
            "iters": np.concatenate([o["iters"] for o in dec]), "n_ok": b,
            "snr": dec[0]["snr"], "turbo_hard": hard, "turbo_iters": tur[0]["iters"],
            "turbo_ok": tur[0]["ok"], "ranks": np.arange(first, first + local_ranks),
            "seconds": seconds,
            "r2max_launches": np.array([d["launches"]["r2max"] + t["launches"]["r2max"]
                                        for d, t in outs]),
            "r2max_shapes": np.array([(first + r, *s) for r, o in enumerate(outs)
                                      for step in o for s in step["shapes"]["r2max"]],
                                     np.int64).reshape(-1, 3)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m srsue_tpu_torch.parallel.multihost",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("node_rank", type=int)
    p.add_argument("n_nodes", type=int)
    p.add_argument("address", help="tcp://host:port, where the node of rank 0 listens")
    p.add_argument("local_ranks", type=int)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    p.add_argument("--out", default=None, help="write the decisions to this .npz")
    p.add_argument("--timeout", type=float, default=mesh.TIMEOUT_S,
                   help="seconds to wait for the peers and each collective")
    a = p.parse_args(argv)
    out = run_node(a.node_rank, a.n_nodes, a.address, a.local_ranks, a.device, a.backend,
                   a.timeout)
    if a.out:
        np.savez(a.out, **out)
    print(f"MULTIHOST_OK pid={a.node_rank} ndev={a.n_nodes * a.local_ranks} "
          f"carriers={out['n_ok']} turbo_ok=1", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
