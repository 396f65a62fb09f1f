"""The blind control + data chain, ``srsue_tpu_torch.rx.make_rx``: a batch of
subframes resident on the card a step, each read from its control region
(PCFICH, the blind DCI search) ahead of the configured grant's PDSCH, the
step ending with the payload, CRC flags, turbo iterations, each subframe's
CFI and DCI hit on the host. For the comparison each kept step also keeps
the PDSCH's softbuffers on the card.

Its reference is ``reference/blind.py``; the bf16 control of its cells is
``perfbench/control.py``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import inputs, judge
from perfbench.reference import blind, receiver
from perfbench.reference.lte import control, dci
from perfbench.rooflines import demap as demap_roof
from perfbench.rooflines import turbo as turbo_roof


@dataclasses.dataclass
class Out:
    batch: int              # which of the resident batches
    payload: np.ndarray     # [B, tbs] uint8
    tb_ok: np.ndarray       # [B] bool
    iters: np.ndarray       # [B, C] int32
    cfi: np.ndarray         # [B]
    dci_hit: np.ndarray     # [B] bool
    softbuf: list | None    # per K-group [B, count, 3(K+4)] on the card


class Runner:
    def __init__(self, cfg, wl, seed, device, trace):
        from srsue_tpu_torch import rx
        from srsue_tpu_torch.phy import ra
        from srsue_tpu_torch.phy.cell import Cell

        self.cfg, self.wl, self.device = cfg, wl, device
        self.forced = wl["turbo"] == "forced"
        cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
        self.batch = wl["batch"]
        clean, self.iq = inputs.noisy_batches(cfg, seed, self.batch, wl["n_batches"], device)
        self.fn = rx.make_rx(cell, ra.dl_grant(cell.n_prb, cfg["mcs"]), cfg["subframe"],
                             cfg["cfi"], cfg["rnti"], clean.dci_bits, early_exit=True,
                             forced=self.forced, device=device)
        if "payload" not in self.fn(self.iq[0]):
            raise RuntimeError("rx.make_rx gives no decoded outputs")
        self.tbs = clean.pdsch.grant.tbs
        self.sample_steps = wl["sample"]["steps"]
        self._ks = list(clean.pdsch.block_ks)
        n_cce, _ = control.pdcch_geometry(clean.cell, cfg["cfi"])
        levels = [l for _, l in control.search_space_candidates(n_cce, cfg["rnti"],
                                                                cfg["subframe"])]
        self._demap_bytes = (
            demap_roof.pdsch_bytes(self.batch, clean.pdsch.n_re, [3 * (k + 4) for k in self._ks])
            + demap_roof.pdcch_bytes(self.batch, levels, dci.size_0_1a(cell.n_prb)))

    def warm(self):
        for i in range(len(self.iq)):
            self.step(i)

    def step(self, i: int) -> Out:
        b = i % len(self.iq)
        out = self.fn(self.iq[b])
        return Out(b, *(out[k].cpu().numpy() for k in ("payload", "tb_ok", "iters", "cfi",
                                                      "dci_hit")), out["softbuf"])

    def n_ok(self, out: Out) -> int:
        return int(out.tb_ok.sum())

    def work(self, out: Out) -> dict:
        """The turbo decode's work (forced: every block every iteration;
        else each block's halves up to its convergence) and the demap's:
        the PDSCH's and the blind search's."""
        its = out.iters.sum(0) if not self.forced else \
            np.full(len(self._ks), self.batch * self.cfg["turbo_iters"])
        halves = [(k, 2 * int(n)) for k, n in zip(self._ks, its)]
        return {"turbo": turbo_roof.work(halves), "demap_bytes": self._demap_bytes}

    def spans(self) -> dict:
        return {}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device == "cuda" else 0

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """Free the port's state, then hold `rows` subframes of each kept step
        to the reference's decode of the same IQ."""
        picks = []
        for _, out in kept:
            rows = pick_rows(self.batch, self.wl["sample"]["rows"], rng)
            port = receiver.Decoded(out.payload[rows], out.tb_ok[rows], out.iters[rows],
                                    softbuf=[b[rows].cpu().numpy() for b in out.softbuf],
                                    cfi=out.cfi[rows], hits=out.dci_hit[rows])
            picks.append((port, self.iq[out.batch][rows].cpu().numpy()))
            out.softbuf = None
        del self.fn, self.iq, kept
        if self.device == "cuda":
            torch.cuda.empty_cache()
        ref = receiver.Receiver(self.cfg)
        return judge.merge([compare(port, reference(ref, self.wl, iq)) for port, iq in picks])


def pick_rows(batch: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(batch, n, replace=False))


def reference(ref: receiver.Receiver, wl: dict, iq: np.ndarray, q=receiver.exact):
    return blind.decode(ref, iq, q=q)


def compare(port: receiver.Decoded, ref: receiver.Decoded) -> dict:
    """The decisions that differ (bits, CRC flags, iterations, subframes whose
    CFI or DCI hit differs), and the softbuffers' largest relative error over
    the subframes."""
    out = judge.decisions(port.payload, port.tb_ok, port.iters, ref)
    out["cfi_wrong"] = int(np.sum(np.asarray(port.cfi) != np.asarray(ref.cfi)))
    out["dci_wrong"] = int(np.sum(np.asarray(port.hits) != np.asarray(ref.hits)))
    out["softbuf_rel_err"] = max(judge.rel_err(p[i], r[i]) for p, r in
                                 zip(port.softbuf, ref.softbuf) for i in range(len(p)))
    return out


def build(cfg, wl, seed, device, trace) -> Runner:
    return Runner(cfg, wl, seed, device, trace)
