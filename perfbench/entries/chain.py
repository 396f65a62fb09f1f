"""The grant-known PDSCH chain, ``srsue_tpu_torch.entry.chain``: a batch of
subframes resident on the card a step, decoded at the configured grant, the
step ending with the payload, CRC flags and turbo iterations on the host.

The step calls ``entry.stages``' four functions in turn, as ``entry.chain``
composes them; traced, it records CUDA events between them (the spans
``frontend``, ``demap``, ``turbo`` and ``tbcrc``, ms per step). For the
comparison each kept step also keeps its softbuffers on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import inputs, judge
from perfbench.reference import receiver
from perfbench.rooflines import demap as demap_roof
from perfbench.rooflines import turbo as turbo_roof

SPANS = ("frontend", "demap", "turbo", "tbcrc")


@dataclasses.dataclass
class Out:
    batch: int              # which of the resident batches
    payload: np.ndarray     # [B, tbs] uint8
    tb_ok: np.ndarray       # [B] bool
    iters: np.ndarray       # [B, C] int32
    softbuf: list           # per K-group [B, count, 3(K+4)] on the card


class Runner:
    def __init__(self, cfg, wl, seed, device, trace):
        from srsue_tpu_torch import entry
        from srsue_tpu_torch.phy import ra
        from srsue_tpu_torch.phy.cell import Cell
        from srsue_tpu_torch.phy.pdsch import PdschCodec

        self.cfg, self.wl, self.device = cfg, wl, device
        self.forced = wl["turbo"] == "forced"
        cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
        self.codec = PdschCodec(cell, ra.dl_grant(cell.n_prb, cfg["mcs"]), rnti=cfg["rnti"],
                                subframe=cfg["subframe"], cfi=cfg["cfi"],
                                n_turbo_iters=cfg["turbo_iters"],
                                early_exit=wl["turbo"] == "early_exit", device=device,
                                kernel="r2max", forced=self.forced)
        self.stages = entry.stages(cell, self.codec, cfg["subframe"])
        self.batch = wl["batch"]
        self.tbs = self.codec.grant.tbs
        _, self.iq = inputs.noisy_batches(cfg, seed, self.batch, wl["n_batches"], device)
        self.trace = trace
        self.events: list = []
        self.sample_steps = wl["sample"]["steps"]
        k_groups = [(k, count) for k, _, count, *_ in self.codec.groups]
        self._turbo_halves = [(k, self.batch * count) for k, count in k_groups]
        self._demap_bytes = demap_roof.pdsch_bytes(
            self.batch, self.codec.n_re, [3 * (k + 4) * count for k, count in k_groups])

    def warm(self):
        for i in range(len(self.iq)):
            self.step(i)
        self.events.clear()

    def step(self, i: int) -> Out:
        frontend, demap_dematch, turbo_decode, tb_crc = self.stages
        b = i % len(self.iq)
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(len(SPANS) + 1)]
              if self.trace and self.device == "cuda" else None)
        mark = (lambda j: ev[j].record()) if ev else (lambda j: None)
        mark(0)
        x = frontend(self.iq[b])
        mark(1)
        bufs = demap_dematch(*x)
        mark(2)
        hard, blk_ok, iters = turbo_decode(bufs)
        mark(3)
        payload, tb_ok = tb_crc(hard, blk_ok)
        mark(4)
        if ev:
            self.events.append(ev)
        return Out(b, payload.cpu().numpy(), tb_ok.cpu().numpy(), iters.cpu().numpy(), bufs)

    def n_ok(self, out: Out) -> int:
        return int(out.tb_ok.sum())

    def work(self, out: Out) -> dict:
        """The turbo decode's and the demap's work in this step, counted by
        the algorithm: forced, every block runs every iteration."""
        halves = [(k, n * 2 * self.cfg["turbo_iters"]) for k, n in self._turbo_halves] \
            if self.forced else self._needed_halves(out)
        return {"turbo": turbo_roof.work(halves), "demap_bytes": self._demap_bytes}

    def _needed_halves(self, out: Out) -> list:
        its, col, halves = out.iters, 0, []
        for k, count in [(k, c) for k, _, c, *_ in self.codec.groups]:
            halves.append((k, 2 * int(its[:, col:col + count].sum())))
            col += count
        return halves

    def spans(self) -> dict:
        if not self.events:
            return {}
        torch.cuda.synchronize()
        return {name: [e[j].elapsed_time(e[j + 1]) for e in self.events]
                for j, name in enumerate(SPANS)}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device == "cuda" else 0

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """Free the port's state, then hold `rows` subframes of each kept step
        to the reference's decode of the same IQ."""
        picks = []
        for _, out in kept:
            rows = pick_rows(self.batch, self.wl["sample"]["rows"], rng)
            port = receiver.Decoded(out.payload[rows], out.tb_ok[rows], out.iters[rows],
                                    softbuf=[b[rows].cpu().numpy() for b in out.softbuf])
            picks.append((port, self.iq[out.batch][rows].cpu().numpy()))
            out.softbuf = None
        del self.codec, self.stages, self.iq, kept
        torch.cuda.empty_cache()
        ref = receiver.Receiver(self.cfg)
        return judge.merge([compare(port, reference(ref, self.wl, iq)) for port, iq in picks])


def pick_rows(batch: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(batch, n, replace=False))


def reference(ref: receiver.Receiver, wl: dict, iq: np.ndarray, q=receiver.exact):
    return ref.grant_known(iq, forced=wl["turbo"] == "forced", q=q)


def compare(port: receiver.Decoded, ref: receiver.Decoded) -> dict:
    """The decisions that differ, and the softbuffers' largest relative
    error over the subframes."""
    out = judge.decisions(port.payload, port.tb_ok, port.iters, ref)
    out["softbuf_rel_err"] = max(judge.rel_err(p[i], r[i]) for p, r in
                                 zip(port.softbuf, ref.softbuf) for i in range(len(p)))
    return out


def build(cfg, wl, seed, device, trace) -> Runner:
    return Runner(cfg, wl, seed, device, trace)
