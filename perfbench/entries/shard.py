"""The carrier-sharded decode, ``srsue_tpu_torch.parallel.mesh.shard_decode``,
on ``ranks`` spawned ranks (``mesh.launch``: NCCL, one rank a card): a
global batch of subframes split evenly, each rank's part resident on its
card, the forced codec, one ``all_reduce`` a step; each step ends with the
rank's payload, CRC flags and iterations and the global TB count and mean
SNR on its host.

The window runs inside the ranks in lockstep: a number of steps agreed
before it (``seconds`` over the slowest rank's mean step in a calibration
after the warm-up), rank 0's wall time from its first step to its last
being the window. Traced, every
rank profiles its last ``trace.SECONDS``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import core, inputs, judge
from perfbench.reference import receiver

CALIBRATION_STEPS = 64  # ~0.5 s of flagship steps; two read 60% slow after the warm-up


def rank_main(mesh, cfg, wl, seed, seconds, trace_s, fault=None):
    """One rank's set-up, warm-up and window; returns host values."""
    import torch.distributed as dist

    from perfbench import trace as tracing
    from srsue_tpu_torch.parallel import mesh as mesh_mod
    from srsue_tpu_torch.phy import ra
    from srsue_tpu_torch.phy.cell import Cell
    from srsue_tpu_torch.phy.pdsch import PdschCodec

    if fault == "no_exchange":
        mesh_mod.all_reduce = lambda x, m, op=None: x
    dev = mesh.device
    cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
    codec = PdschCodec(cell, ra.dl_grant(cell.n_prb, cfg["mcs"]), rnti=cfg["rnti"],
                       subframe=cfg["subframe"], cfi=cfg["cfi"],
                       n_turbo_iters=cfg["turbo_iters"], device=dev, kernel="r2max",
                       forced=wl["turbo"] == "forced")
    run = mesh_mod.shard_decode(cell, codec, mesh)
    _, iq = inputs.noisy_batches(cfg, seed, wl["batch"], wl["n_batches"], str(dev))
    local = [mesh_mod.shard(x, mesh).contiguous() for x in iq]
    del iq
    b = local[0].shape[0]
    tbs = codec.grant.tbs

    def step(i):
        payload, tb_ok, n_ok, snr, iters = run(local[i % len(local)])
        return (payload.cpu().numpy(), tb_ok.cpu().numpy(), iters.cpu().numpy(),
                int(n_ok), float(snr))

    for i in range(len(local)):
        step(i)
    # the window's step count: `seconds` over the slowest rank's mean step of
    # a calibration as long as the steps are steady (the ranks run in lockstep)
    t0 = time.perf_counter()
    for i in range(CALIBRATION_STEPS):
        step(i)
    per_step = torch.tensor([(time.perf_counter() - t0) / CALIBRATION_STEPS],
                            dtype=torch.float64, device=dev)
    dist.all_reduce(per_step, op=dist.ReduceOp.MAX, group=mesh.group)
    n_steps = max(1, math.ceil(seconds / float(per_step)))
    n_trace = 0 if trace_s is None else min(n_steps, math.ceil(trace_s / float(per_step)))
    if n_trace:  # the profiler's first start initialises CUPTI: not in the window
        tracing.stop(tracing.start())
    keep = core.Reservoir(wl["sample"]["steps"], np.random.default_rng([seed, 1, mesh.rank]))
    dist.barrier(group=mesh.group)
    out = {"rank": mesh.rank, "step_s": [], "bits": 0, "failed": 0, "tb": b}
    prof = None
    t_first = time.perf_counter()
    for i in range(n_steps):
        if n_trace and prof is None and i >= n_steps - n_trace:
            prof = tracing.start()
        t0 = time.perf_counter()
        if prof is not None:
            with tracing.step():
                payload, tb_ok, iters, n_ok, snr = step(i)
        else:
            payload, tb_ok, iters, n_ok, snr = step(i)
        t1 = time.perf_counter()
        out["step_s"].append(t1 - t0)
        out["bits"] += int(tb_ok.sum()) * tbs
        out["failed"] += int(b - tb_ok.sum())

        def kept():
            rows = np.sort(keep.rng.choice(b, wl["sample"]["rows"], replace=False))
            return {"batch": i % len(local), "rows": mesh.rank * b + rows,
                    "payload": payload[rows], "tb_ok": tb_ok[rows], "iters": iters[rows],
                    "snr": snr}

        keep.offer(kept)
    out["t_first"], out["window_s"] = t_first, t1 - t_first
    out["kept"] = keep.items
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    if prof is not None:
        rec = tracing.finish(prof)
        out["busy_s"] = rec.busy_s
        if mesh.rank == 0:
            out["trace"] = rec
    return out


class Runner:
    def __init__(self, cfg, wl, seed, device, trace):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.batch = wl["batch"]
        self.sample_steps = wl["sample"]["steps"]
        self.fault = None
        self._peak = 0

    def warm(self):
        """The ranks warm themselves up."""

    def window(self, run, seconds: float, trace_s, t_process: float) -> list:
        from srsue_tpu_torch.parallel import mesh

        ranks = mesh.launch(rank_main, self.wl["ranks"], self.device, self.cfg, self.wl,
                            self.seed, seconds, trace_s, self.fault)
        r0 = ranks[0]
        run.setup_s = r0["t_first"] - t_process
        run.step_s, run.window_s = r0["step_s"], r0["window_s"]
        run.bits = sum(r["bits"] for r in ranks)
        run.attempted = sum(r["tb"] * len(r["step_s"]) for r in ranks)
        run.failed = sum(r["failed"] for r in ranks)
        self._peak = max(r["memory_peak_bytes"] for r in ranks)
        if "trace" in r0:
            run.trace = r0["trace"]
            run.busy_s = sum(r["busy_s"] for r in ranks) / len(ranks)
        return [k for r in ranks for k in r["kept"]]

    def spans(self) -> dict:
        return {}

    def memory_peak(self) -> int:
        return self._peak

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """Hold each kept step's rows to the reference's decode of the same
        IQ, made again here from the seed, and its global SNR to the
        reference's mean over the whole global batch."""
        _, iq = inputs.noisy_batches(self.cfg, self.seed, self.batch, self.wl["n_batches"],
                                     self.device)
        iq = [x.cpu().numpy() for x in iq]
        ref = receiver.Receiver(self.cfg)
        snr_ref: dict = {}
        parts = []
        for k in kept:
            r = ref.grant_known(iq[k["batch"]][k["rows"]], forced=self.wl["turbo"] == "forced")
            part = judge.decisions(k["payload"], k["tb_ok"], k["iters"], r)
            if k["batch"] not in snr_ref:
                snr_ref[k["batch"]] = mean_snr(ref, iq[k["batch"]])
            part["snr_rel_err"] = abs(10.0 ** (k["snr"] / 10.0) - snr_ref[k["batch"]]) \
                / snr_ref[k["batch"]]
            parts.append(part)
        return judge.merge(parts)


def mean_snr(ref: receiver.Receiver, iq: np.ndarray, q=receiver.exact, block: int = 32) -> float:
    """The mean of rsrp / noise over every subframe of iq (linear), from the
    reference's channel estimate of port 0, in blocks of rows."""
    return float(sum(ref.snr(iq[lo:lo + block], q).sum()
                     for lo in range(0, len(iq), block))) / len(iq)


def pick_rows(batch: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(batch, n, replace=False))


def reference(ref: receiver.Receiver, wl: dict, iq: np.ndarray, q=receiver.exact):
    return ref.grant_known(iq, forced=wl["turbo"] == "forced", q=q)


def compare(port: receiver.Decoded, ref: receiver.Decoded) -> dict:
    return judge.decisions(port.payload, port.tb_ok, port.iters, ref)


def batch_numbers(ref: receiver.Receiver, iq: np.ndarray, q) -> dict:
    """The control's global SNR over a whole batch against the reference's."""
    exact = mean_snr(ref, iq)
    return {"snr_rel_err": abs(mean_snr(ref, iq, q) - exact) / exact}


def build(cfg, wl, seed, device, trace) -> Runner:
    return Runner(cfg, wl, seed, device, trace)
