"""The UE's downlink facade, ``srsue_tpu_torch.phy.ue_dl.UeDl.process``, one
call a step with its defaults (DCI format 0/1A, the UE-specific search
space, the PDSCH codec with CRC early exit), ending with its ``DlResult`` on
the host.

``batch`` > 1: a batch of subframes resident on the card a step (the
facade's batch axis; the first subframe's CFI and grant rule the batch).
``batch`` = 1: one subframe a step, handed over from host memory as a radio
delivers it, from a pool of ``pool`` subframes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import inputs, judge
from perfbench.reference import receiver
from perfbench.reference.lte import control, dci
from perfbench.rooflines import demap as demap_roof
from perfbench.rooflines import turbo as turbo_roof

METRICS = ("rssi", "rsrq_db", "snr_db", "rsrp", "noise")


@dataclasses.dataclass
class Out:
    index: int              # which resident batch, or which subframe of the pool
    res: object             # the DlResult


class Runner:
    def __init__(self, cfg, wl, seed, device, trace):
        from srsue_tpu_torch.phy.cell import Cell
        from srsue_tpu_torch.phy.ue_dl import UeDl

        self.cfg, self.wl, self.device = cfg, wl, device
        self.cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
        self.ue = UeDl(self.cell, n_turbo_iters=cfg["turbo_iters"], device=device)
        self.batch = wl["batch"]
        self.host = self.batch == 1
        clean, iq = inputs.noisy_batches(cfg, seed, wl["pool"] if self.host else self.batch,
                                         1 if self.host else wl["n_batches"], device)
        self.tbs = int(clean.payloads.shape[1])
        # batch 1: the pool's subframes in host memory, one a step
        self.iq = list(iq[0].cpu().numpy()) if self.host else iq
        self.sample_steps = wl["sample"]["steps"]
        self._ks = list(clean.pdsch.block_ks)
        self._d_lens = [3 * (k + 4) for k in self._ks]
        self._n_re = clean.pdsch.n_re
        n_cce, _ = control.pdcch_geometry(clean.cell, cfg["cfi"])
        self._levels = [l for _, l in control.search_space_candidates(
            n_cce, cfg["rnti"], cfg["subframe"])]
        self._dci_len = dci.size_0_1a(self.cell.n_prb)

    def warm(self):
        for i in range(min(len(self.iq), self.wl.get("warm_steps", len(self.iq)))):
            self.step(i)

    def step(self, i: int) -> Out:
        b = i % len(self.iq)
        return Out(b, self.ue.process(self.iq[b], self.cfg["subframe"], self.cfg["rnti"]))

    def n_ok(self, out: Out) -> int:
        ok = out.res.tb_ok
        return 0 if ok is None else int(np.sum(ok))

    def work(self, out: Out) -> dict:
        """The work these inputs need: every block's turbo half-iterations
        up to its convergence, and the PDSCH's and the blind search's demap."""
        its = np.asarray(out.res.turbo_iters).reshape(self.batch, -1)
        halves = [(k, 2 * int(n)) for k, n in zip(self._ks, its.sum(0))]
        return {"turbo": turbo_roof.work(halves),
                "demap_bytes": demap_roof.pdsch_bytes(self.batch, self._n_re, self._d_lens)
                + demap_roof.pdcch_bytes(self.batch, self._levels, self._dci_len)}

    def spans(self) -> dict:
        return {}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device == "cuda" else 0

    def _port(self, res, rows) -> receiver.Decoded:
        """The port's outputs at `rows` of its batch (a batch of 1: row 0)."""
        pick = (lambda x: np.asarray(x).reshape((1,) + np.shape(x))) if self.host else \
            (lambda x: np.asarray(x)[rows])
        return receiver.Decoded(
            pick(res.payload), pick(res.tb_ok), pick(res.turbo_iters), cfi=res.cfi,
            hits=[[receiver.hit(f, d) for f, d in res.hits_per_elem[r]] for r in rows],
            metrics={k: pick(res.metrics[k]) for k in METRICS})

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """Free the port's state, then hold each kept step's subframes (with a
        batch, its first and `rows` - 1 more) to the reference's decode of the
        same IQ."""
        picks = []
        for _, out in kept:
            if self.host:
                rows, iq = np.array([0]), self.iq[out.index][None]
            else:
                rows = pick_rows(self.batch, self.wl["sample"]["rows"], rng)
                iq = self.iq[out.index][rows].cpu().numpy()
            picks.append((self._port(out.res, rows), iq))
        del self.ue, self.iq, kept
        torch.cuda.empty_cache()
        ref = receiver.Receiver(self.cfg)
        return judge.merge([compare(port, reference(ref, self.wl, iq)) for port, iq in picks])


def pick_rows(batch: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """The first subframe, whose CFI and grant rule the batch, and n - 1
    more."""
    if batch == 1:
        return np.array([0])
    return np.concatenate([[0], np.sort(1 + rng.choice(batch - 1, n - 1, replace=False))])


def reference(ref: receiver.Receiver, wl: dict, iq: np.ndarray, q=receiver.exact):
    return ref.ue_dl(iq, q=q)


def compare(port: receiver.Decoded, ref: receiver.Decoded) -> dict:
    """The decisions that differ, and the channel metrics' largest
    relative error."""
    out = judge.decisions(port.payload, port.tb_ok, port.iters, ref)
    out["cfi_wrong"] = int(port.cfi != ref.cfi)
    out["dci_wrong"] = sum(int(p != r) for p, r in zip(port.hits, ref.hits))
    out["metrics_rel_err"] = max(
        float(np.max(np.abs(np.asarray(port.metrics[k], np.float64) - ref.metrics[k])
                     / np.maximum(np.abs(np.asarray(ref.metrics[k], np.float64)), 1e-30)))
        for k in METRICS)
    return out


def build(cfg, wl, seed, device, trace) -> Runner:
    return Runner(cfg, wl, seed, device, trace)
