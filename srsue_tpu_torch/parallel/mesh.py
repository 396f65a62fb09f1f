"""Ranks over ``torch.distributed``, and the carrier-sharded decode.

Counterpart of ``srsue_tpu/parallel/mesh.py``. JAX is single-controller:
one process sees every device, a ``Mesh`` names them and ``shard_map``
runs one program over all. ``torch.distributed`` runs one process per
rank, so the port has two pieces instead:

* ``Mesh``: what one rank knows of the group (the process group, its rank,
  the world size, its device; the axis is always the reference's
  ``"carrier"``); ``make_mesh`` joins the group from inside a rank;
* ``launch(fn, n, device, *args)``: spawns ``n`` ranks (the ``spawn`` start
  method: a fresh interpreter, never a fork of a process that holds CUDA),
  joins them into one group, runs ``fn(mesh, *args)`` on each and returns
  each rank's result to the caller.

On ``"cuda"`` the group is NCCL with one rank per GPU; asking for more ranks
than there are GPUs raises. On ``"cpu"`` it is gloo. ``backend="gloo"`` on
``"cuda"`` is the one explicit exception: gloo ranks may share a card.

``shard_decode`` is the carrier (data-parallel) axis: each rank decodes its
own subframes, and the mesh-global aggregates (TBs passed, mean SNR) are one
``all_reduce``.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import ClassVar

import torch
import torch.distributed as dist

from ..phy.cell import Cell
from ..phy.pdsch import PdschCodec, equalized
from ..utils.device import require_cuda

TIMEOUT_S = 600.0  # a rank's collectives, and a launch, give up after this


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh of `size` ranks. The collectives go
    through `group`; `axis` only names the mesh's one axis, as the
    reference's does."""

    group: object  # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    axis: ClassVar[str] = "carrier"


def _backend(device: torch.device, backend: str | None) -> str:
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU; only gloo")
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    return backend or "nccl"


def _check_ranks(n: int, device: torch.device, backend: str) -> None:
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    if device.type == "cuda":
        require_cuda()
        count = torch.cuda.device_count()
        if backend == "nccl" and n > count:
            raise RuntimeError(f"{n} NCCL ranks need {n} CUDA devices; "
                               f"torch.cuda.device_count() is {count}")


def make_mesh(rank: int, size: int, init_method: str, device: str | torch.device = "cuda",
              backend: str | None = None) -> Mesh:
    """Join the process group as `rank` of `size` (called inside a rank) and
    return its Mesh. On CUDA rank r takes card r (under gloo, r modulo the
    cards)."""
    dev = torch.device(device)
    backend = _backend(dev, backend)
    _check_ranks(size, dev, backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(dist.group.WORLD, rank, size, dev)


def _rank_main(rank, n, init_method, device, backend, fn, args, out):
    """A spawned rank: join, run fn, put (rank, ok, value or traceback)."""
    try:
        torch.set_num_threads(1)
        mesh = make_mesh(rank, n, init_method, device, backend)
        out.put((rank, True, fn(mesh, *args)))
    except Exception:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, n: int, device: str | torch.device = "cuda", *args,
           backend: str | None = None) -> list:
    """Run ``fn(mesh, *args)`` on `n` spawned ranks; returns their results
    in rank order. `fn` and `args` are pickled into each rank, so `fn` is a
    function of an importable module and the results are host values (numpy
    arrays, numbers). A rank that raises makes launch raise, with its
    traceback, after the other ranks are stopped."""
    dev = torch.device(device)
    backend = _backend(dev, backend)
    _check_ranks(n, dev, backend)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="srsue_mesh_"))
    init_method = f"file://{tmp / 'rendezvous'}"
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, init_method, str(dev), backend, fn,
                                                   args, out), daemon=True)
             for r in range(n)]
    results: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        while len(results) < n:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n - len(results)} rank(s) still running after "
                                       f"{TIMEOUT_S} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n)]


# ------------------------------------------------------------- collectives
def shard(x, mesh: Mesh):
    """This rank's equal part of `x` along its first axis, whose length must
    divide evenly over the ranks, as a sharded axis must."""
    if len(x) % mesh.size:
        raise ValueError(f"axis of {len(x)} does not split evenly over {mesh.size} ranks")
    part = len(x) // mesh.size
    return x[mesh.rank * part:(mesh.rank + 1) * part]


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order (a tiled
    all_gather)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` reduced over the ranks with `op` (in place; returned)."""
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


# -------------------------------------------------------- sharded decode
def shard_decode(cell: Cell, codec: PdschCodec, mesh: Mesh):
    """Batched PDSCH decode with the batch (carrier) axis sharded over the
    mesh: run(iq_local [b, sf_len] complex64 on mesh.device) -> (payload
    [b, tbs] uint8, tb_ok [b] bool, n_ok, snr, iters [b, C] int32) for this
    rank's b subframes, where n_ok (TBs passed) and snr (the mean of
    rsrp / nvar over the global batch, in dB) are mesh-global. The
    reference returns the first four; the port adds iters, as its codec does.
    Every rank must hold the same number of subframes."""

    def run(iq: torch.Tensor):
        x_eq, nv_eff, nvar, rsrp = equalized(cell, codec, codec.subframe, iq)
        payload, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
        b = iq.shape[0]
        # one all_reduce SUM: TBs passed, subframes, summed linear SNR
        tot = torch.stack([tb_ok.sum().to(torch.float64),
                           torch.tensor(float(b), dtype=torch.float64, device=iq.device),
                           (rsrp / torch.clamp_min(nvar, 1e-12)).sum().to(torch.float64)])
        all_reduce(tot, mesh)
        if int(tot[1]) != b * mesh.size:
            raise ValueError(f"uneven carrier shards: {b} here, {int(tot[1])} over "
                             f"{mesh.size} ranks")
        n_ok = tot[0].to(torch.int32)
        snr_lin = (tot[2] / tot[1]).to(torch.float32)
        snr = 10.0 * torch.log10(torch.clamp_min(snr_lin, 1e-12))
        return payload, tb_ok, n_ok, snr, iters

    return run
