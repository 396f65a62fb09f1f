"""Ranks over ``torch.distributed``, and the carrier-sharded decode.

Counterpart of ``srsue_tpu/parallel/mesh.py``. JAX is single-controller:
one process sees every device, a ``Mesh`` names them and ``shard_map``
runs one program over all. ``torch.distributed`` runs one process per
rank, so the port has two pieces instead:

* ``Mesh``: what one rank knows of the group (the process group, its rank,
  the world size, its device; the axis is always the reference's
  ``"carrier"``); ``make_mesh`` joins the group from inside a rank;
* ``start_ranks``: spawns one node's ranks (the ``spawn`` start method: a
  fresh interpreter, never a fork of a process that holds CUDA), joins them
  into a group that meets at an ``init_method``, runs ``fn(mesh, *args)``
  on each and returns each rank's result to the caller;
* ``launch(fn, n, device, *args)``: all ``n`` ranks on this host, meeting at
  a ``file://`` rendezvous in a fresh temp directory. The multi-host launch
  (``parallel/multihost.py``, one node process per host over ``tcp://``,
  the counterpart of ``tools/multihost_worker.py``) starts its ranks
  through ``start_ranks`` too.

On ``"cuda"`` the group is NCCL with one rank per GPU: a rank takes the card
of its local rank (its index on its node), and asking a node for more ranks
than it has GPUs raises. On ``"cpu"`` it is gloo. ``backend="gloo"`` on
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

TIMEOUT_S = 600.0  # a rank's joining and collectives give up after this


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
              backend: str | None = None, local_rank: int | None = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the process group as `rank` of `size` (called inside a rank) and
    return its Mesh. On CUDA the rank takes card `local_rank` (its index on
    its node; `rank` when every rank runs on this node), under gloo that
    modulo the cards. Joining, and every collective, gives up after
    `timeout_s`."""
    dev = torch.device(device)
    backend = _backend(dev, backend)
    local = rank if local_rank is None else local_rank
    _check_ranks(size if local_rank is None else local + 1, dev, backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(dist.group.WORLD, rank, size, dev)


def _rank_main(rank, local_rank, size, init_method, device, backend, timeout_s, fn, args, out):
    """A spawned rank: join, run fn, put (rank, ok, value or traceback)."""
    try:
        torch.set_num_threads(1)
        mesh = make_mesh(rank, size, init_method, device, backend, local_rank, timeout_s)
        out.put((rank, True, fn(mesh, *args)))
    except Exception:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(fn, args: tuple, init_method: str, size: int, first_rank: int = 0,
                n_local: int | None = None, device: str | torch.device = "cuda",
                backend: str | None = None, timeout_s: float = TIMEOUT_S) -> list:
    """Spawn this node's `n_local` ranks (all `size` by default), global
    ranks first_rank, ..., first_rank + n_local - 1 of a group of `size` that
    meets at `init_method`, and run ``fn(mesh, *args)`` on each; returns
    their results in rank order. `fn` and `args` are pickled into each rank,
    so `fn` is a function of an importable module and the results are host
    values (numpy arrays, numbers). A rank that raises makes this raise,
    with its traceback, after the other ranks are stopped; so does a rank
    still running after `timeout_s` (a peer that never joins makes its
    ranks raise after `timeout_s` themselves)."""
    n_local = size if n_local is None else n_local
    dev = torch.device(device)
    backend = _backend(dev, backend)
    _check_ranks(n_local, dev, backend)
    if not 0 <= first_rank <= size - n_local:
        raise ValueError(f"ranks {first_rank}..{first_rank + n_local - 1} outside a group "
                         f"of {size}")
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = {first_rank + r: ctx.Process(
        target=_rank_main, args=(first_rank + r, r, size, init_method, str(dev), backend,
                                 timeout_s, fn, args, out), daemon=True)
        for r in range(n_local)}
    results: dict[int, object] = {}
    try:
        for p in procs.values():
            p.start()
        # the ranks' own timeouts report first; this one catches a rank stuck elsewhere
        deadline = time.monotonic() + timeout_s + 30.0
        while len(results) < n_local:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in procs.items() if r not in results and not p.is_alive()]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_local - len(results)} rank(s) still running "
                                       f"after {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{value}")
            results[rank] = value
        for p in procs.values():
            p.join(timeout=60)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        out.close()
    return [results[r] for r in sorted(results)]


def launch(fn, n: int, device: str | torch.device = "cuda", *args,
           backend: str | None = None) -> list:
    """Run ``fn(mesh, *args)`` on `n` ranks spawned on this host
    (``start_ranks`` with a ``file://`` rendezvous in a fresh temp
    directory); returns their results in rank order."""
    tmp = Path(tempfile.mkdtemp(prefix="srsue_mesh_"))
    try:
        return start_ranks(fn, args, f"file://{tmp / 'rendezvous'}", n, device=device,
                           backend=backend)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
