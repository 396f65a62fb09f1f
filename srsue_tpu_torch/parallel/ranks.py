"""The functions that ``mesh.launch`` runs on each rank: each takes host
inputs (numpy arrays and the port's own ``Cell``/``DlGrant``), runs one
sharded path on its rank's device and returns host results, with the BCJR
kernel launches it made (``kernels.bcjr.launches`` and ``shapes``, zeroed
just before the path and read just after), so that the caller, in another
process, can check them. ``steps`` runs several of them in one rank process.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..entry import make_waveforms
from ..kernels import bcjr
from ..phy import crc as crcmod
from ..phy import ra
from ..phy import turbo as turbo_mod
from ..phy.cell import Cell, DlGrant
from ..phy.pdsch import PdschCodec
from ..utils.device import to_host
from . import timeshard, turbo_shard
from .mesh import Mesh, shard, shard_decode


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def counted(mesh: Mesh, fn):
    """(fn(), counts): counts holds the launches of every BCJR kernel
    instance fn made and the (windows, lw) shapes it made them at."""
    for name in bcjr.launches:
        bcjr.launches[name] = 0
        bcjr.shapes[name].clear()
    out = fn()
    _sync(mesh)
    return out, {"launches": dict(bcjr.launches),
                 "shapes": {name: sorted(s) for name, s in bcjr.shapes.items()}}


def wall_ms(mesh: Mesh, fn, reps: int) -> float:
    """Mean ms of fn over `reps` calls after one more, all ranks started
    together (a barrier), the host's clock around work ended by a
    synchronise."""
    fn()
    _sync(mesh)
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(mesh)
    return 1e3 * (time.perf_counter() - t0) / reps


def decode(mesh: Mesh, cell: Cell, grant: DlGrant, rnti: int, subframe: int,
           n_turbo_iters: int, iq: np.ndarray, reps: int = 0) -> dict:
    """``shard_decode`` (CRC early exit) of this rank's part of iq [B,
    sf_len] (B split evenly over the ranks): its payload, tb_ok, iters, the
    global n_ok and snr; with `reps`, its mean ms over that many calls."""
    codec = PdschCodec(cell, grant, rnti, subframe, cfi=1, n_turbo_iters=n_turbo_iters,
                       device=mesh.device)
    run = shard_decode(cell, codec, mesh)
    x = torch.as_tensor(np.ascontiguousarray(shard(iq, mesh)), device=mesh.device)
    (payload, tb_ok, n_ok, snr, iters), counts = counted(mesh, lambda: run(x))
    out = {"payload": to_host(payload), "tb_ok": to_host(tb_ok), "iters": to_host(iters),
           "n_ok": int(n_ok), "snr": float(snr), **counts}
    if reps:
        out["ms"] = wall_ms(mesh, lambda: run(x), reps)
    return out


def turbo(mesh: Mesh, d_llrs: np.ndarray, k: int, n_iters: int, crc_mat: np.ndarray | None,
          window: int = 64, reps: int = 0) -> dict:
    """``make_sharded_decoder`` on this rank's part of d_llrs [B, 3, K+4]:
    its hard bits [B, K/n], and iters and ok (equal on every rank)."""
    run = turbo_shard.make_sharded_decoder(k, n_iters, mesh, window, crc_mat)
    d = torch.as_tensor(d_llrs, device=mesh.device)
    d_loc, tails = turbo_shard.shard_llrs(d, k, mesh)
    (hard, iters, ok), counts = counted(mesh, lambda: run(d_loc, tails))
    out = {"hard": to_host(hard), "iters": to_host(iters), "ok": to_host(ok), **counts}
    if reps:
        out["ms"] = wall_ms(mesh, lambda: run(d_loc, tails), reps)
    return out


def frontend(mesh: Mesh, cell: Cell, iq: np.ndarray, n_sf_per_dev: int, decim: int = 1,
             cfo: float = 0.0, reps: int = 0) -> dict:
    """``sharded_frontend`` on this rank's block of the stream iq: its grids
    and the grid geometry's n_prb."""
    run, out_cell = timeshard.sharded_frontend(cell, mesh, n_sf_per_dev, decim, cfo)
    x = torch.as_tensor(np.ascontiguousarray(shard(iq, mesh)), device=mesh.device)
    out = {"grids": to_host(run(x)), "n_prb": out_cell.n_prb}
    if reps:
        out["ms"] = wall_ms(mesh, lambda: run(x), reps)
    return out


def steps(mesh: Mesh, *calls) -> list:
    """[fn(mesh, *args, **kwargs) for (fn, args, kwargs) in calls]: several
    paths in one rank process, which joins the group once."""
    return [fn(mesh, *args, **kwargs) for fn, args, kwargs in calls]


def dryrun(mesh: Mesh) -> dict:
    """One rank of ``entry.dryrun_multichip``: the steps and draws of
    ``__graft_entry__.dryrun_multichip`` on this rank's shards. Raises
    (AssertionError) on a wrong result."""

    def body():
        n = mesh.size
        dev = mesh.device
        # 1) carrier-sharded decode, tiny shapes: 1.4 MHz QPSK, B = 2n
        cell = Cell(n_prb=6, cell_id=7)
        grant = ra.dl_grant(cell.n_prb, 5)
        codec = PdschCodec(cell, grant, rnti=0x42, subframe=1, cfi=1, n_turbo_iters=4,
                           device=dev)
        rng = np.random.default_rng(0)
        b = 2 * n
        noisy, payloads, td = make_waveforms(cell, codec, rng, b, 20.0, n_distinct=b)
        run = shard_decode(cell, codec, mesh)
        payload, tb_ok, n_ok, snr, _ = run(torch.as_tensor(shard(noisy, mesh), device=dev))
        ok = to_host(tb_ok)
        assert ok.all(), f"sharded decode failed: {ok}"
        assert int(n_ok) == b
        assert (to_host(payload) == shard(payloads, mesh)).all()

        # 2) time-block sharding with the halo: one step of the front end
        trun, _ = timeshard.sharded_frontend(cell, mesh, 1, decim=1, cfo=0.05)
        stream = td.reshape(-1)[:n * cell.sf_len].astype(np.complex64)
        tgrid = trun(torch.as_tensor(shard(stream, mesh), device=dev))
        assert tgrid.shape == (1, cell.n_sym_sf, cell.n_sc)

        # 3) window-sharded turbo: K = 128n gives W = 2 windows per rank
        k = 128 * n
        turbo_ok = k <= max(turbo_mod.QPP_TABLE)  # the largest LTE code block
        if turbo_ok:
            m = np.zeros((k, 24), np.uint8)
            m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
            m[k - 24:] = np.eye(24, dtype=np.uint8)
            rng2 = np.random.default_rng(1)
            msg = crcmod.attach(rng2.integers(0, 2, k - 24).astype(np.uint8), "24A")
            x = 1.0 - 2.0 * turbo_mod.encode(msg).astype(np.float32)
            llr = 2.0 * (x + 0.5 * rng2.standard_normal(x.shape).astype(np.float32)) / 0.25
            srun = turbo_shard.make_sharded_decoder(k, 4, mesh, window=64, crc_mat=m)
            d_loc, tails = turbo_shard.shard_llrs(torch.as_tensor(llr[None], device=dev), k,
                                                  mesh)
            hard, _, okw = srun(d_loc, tails)
            assert to_host(okw).all(), "window-sharded turbo failed CRC"
            assert (to_host(hard)[0] == shard(msg, mesh)).all()

        # 4) the flagship shapes sharded: 20 MHz MCS 28 (TBS 75376, 13 code
        #    blocks), one carrier per rank, 2 masked turbo iterations
        cell_f = Cell(n_prb=100, cell_id=42)
        codec_f = PdschCodec(cell_f, ra.dl_grant(cell_f.n_prb, 28), rnti=0x1234, subframe=6,
                             cfi=1, n_turbo_iters=2, early_exit=False, device=dev)
        noisy_f, payloads_f, _ = make_waveforms(cell_f, codec_f, rng, n, 28.0, n_distinct=n)
        run_f = shard_decode(cell_f, codec_f, mesh)
        payload_f, ok_f, _, _, _ = run_f(torch.as_tensor(shard(noisy_f, mesh), device=dev))
        assert to_host(ok_f).all(), "flagship sharded decode failed CRC"
        assert (to_host(payload_f) == shard(payloads_f, mesh)).all()
        return {"n_ok": int(n_ok), "snr": float(snr), "carriers": b, "turbo": turbo_ok,
                "tbs_flagship": codec_f.grant.tbs}

    out, counts = counted(mesh, body)
    return {**out, **counts}
