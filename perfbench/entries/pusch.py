"""An eNB's PUSCH receive, ``srsue_tpu_torch.phy.pusch.PuschCodec``: a batch
of one UE's uplink subframes resident on the card a step, each with its own
transport block, CQI and ACK, decoded at the configured grant. The step
calls ``dematch_sf``, ``decode_softbuffers`` and ``decode_uci_sf`` in turn
and ends with the payload, CRC flags, turbo iterations, CQI and ACK on the
host; for the comparison each kept step also keeps its softbuffers on the
card.

The inputs come from the plain reference's uplink transmitter
(``reference/uplink.py``), their noise drawn on the card by a
``torch.Generator`` from the seed. ``perfbench/control.py`` builds downlink
inputs, so the control of this entry's cells is here:

    python3 perfbench/entries/pusch.py --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, the numbers a run of the cell compares, read on the
plain reference rounded to bfloat16 at every stage in the port's place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import core, judge  # noqa: E402
from perfbench.reference import receiver, transmitter, uplink  # noqa: E402
from perfbench.rooflines import demap as demap_roof  # noqa: E402
from perfbench.rooflines import turbo as turbo_roof  # noqa: E402


@dataclasses.dataclass
class Out:
    batch: int              # which of the resident batches
    payload: np.ndarray     # [B, tbs] uint8
    tb_ok: np.ndarray       # [B] bool
    iters: np.ndarray       # [B, C] int32
    cqi: np.ndarray         # [B, A] uint8
    ack: np.ndarray         # [B] bool
    bufs: list | None       # per code block [B, 3(K+4)] on the card


def noisy_batches(cfg: dict, seed: int, batch: int, n_batches: int, device: str):
    """(clean, [n_batches x iq [batch, sf_len] complex64 on `device`]):
    `batch` uplink subframes and `n_batches` noise draws over them at the
    configuration's SNR."""
    clean = uplink.build(cfg, seed, batch)
    td = torch.as_tensor(clean.td, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return clean, [transmitter.add_noise(td, clean.p_sig, cfg["snr_db"], gen)
                   for _ in range(n_batches)]


class Runner:
    def __init__(self, cfg, wl, seed, device, trace):
        from srsue_tpu_torch.phy.cell import Cell, UlGrant
        from srsue_tpu_torch.phy.pusch import PuschCodec

        self.cfg, self.wl, self.device = cfg, wl, device
        cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
        grant = UlGrant(n_prb=cfg["n_prb"], prb_start=cfg["prb_start"], mcs=cfg["mcs"],
                        mod_order=cfg["qm"], tbs=cfg["tbs"], rv=cfg["rv"])
        self.codec = PuschCodec(cell, grant, cfg["rnti"], cfg["subframe"],
                                n_turbo_iters=cfg["turbo_iters"], n_cqi_bits=cfg["cqi_bits"],
                                with_ack=cfg["ack_symbols"] > 0,
                                cqi_rep=cfg["cqi_repetition"], ack_syms=cfg["ack_symbols"],
                                device=device)
        self.decode_uci = self.codec.decode_uci_sf  # a program without it stops here
        self.batch = wl["batch"]
        self.tbs = cfg["tbs"]
        clean, self.iq = noisy_batches(cfg, seed, self.batch, wl["n_batches"], device)
        self.noise_var = clean.noise_var(cfg["snr_db"])
        self.sample_steps = wl["sample"]["steps"]
        ks = self.codec.plan.block_ks
        self._demap_bytes = demap_roof.pdsch_bytes(self.batch, len(self.codec.data_pos),
                                                   [3 * (k + 4) for k in ks])

    def warm(self):
        for i in range(len(self.iq)):
            self.step(i)

    def step(self, i: int) -> Out:
        b = i % len(self.iq)
        bufs = self.codec.dematch_sf(self.iq[b], self.noise_var, self.cfg["cyclic_shift"])
        payload, tb_ok, iters = self.codec.decode_softbuffers(bufs)
        cqi, ack = self.decode_uci()
        return Out(b, payload.cpu().numpy(), tb_ok.cpu().numpy(), iters.cpu().numpy(),
                   cqi.cpu().numpy(), ack.cpu().numpy(), bufs)

    def n_ok(self, out: Out) -> int:
        return int(out.tb_ok.sum())

    def work(self, out: Out) -> dict:
        """The turbo decode's work these inputs need (each block's halves up
        to its convergence) and the demap's: every data symbol read once,
        every softbuffer value written once."""
        halves = [(k, 2 * int(out.iters[:, first:first + count].sum()))
                  for k, first, count, *_ in self.codec.groups]
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
            soft = [torch.stack(out.bufs[first:first + count], 1)[rows].cpu().numpy()
                    for _, first, count, *_ in self.codec.groups]
            port = uplink.Decoded(out.payload[rows], out.tb_ok[rows], out.iters[rows],
                                  out.cqi[rows], out.ack[rows], softbuf=soft)
            picks.append((port, self.iq[out.batch][rows].cpu().numpy()))
            out.bufs = None
        del self.codec, self.decode_uci, self.iq, kept
        if self.device == "cuda":
            torch.cuda.empty_cache()
        ref = uplink.Receiver(self.cfg)
        return judge.merge([compare(port, ref.pusch(iq, self.noise_var)) for port, iq in picks])


def pick_rows(batch: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(batch, n, replace=False))


def compare(port: uplink.Decoded, ref: uplink.Decoded) -> dict:
    """The decisions that differ (bits, CRC flags, iterations, subframes
    whose CQI or ACK differs), and the softbuffers' largest relative error
    over the subframes."""
    out = judge.decisions(port.payload, port.tb_ok, port.iters, ref)
    out["cqi_wrong"] = int(np.sum(np.any(np.asarray(port.cqi) != ref.cqi, -1)))
    out["ack_wrong"] = int(np.sum(np.asarray(port.ack) != ref.ack))
    out["softbuf_rel_err"] = max(judge.rel_err(p[i], r[i]) for p, r in
                                 zip(port.softbuf, ref.softbuf) for i in range(len(p)))
    return out


def build(cfg, wl, seed, device, trace) -> Runner:
    return Runner(cfg, wl, seed, device, trace)


def readings(cell: str, seed: int, device: str, cfg_over=None, wl_over=None) -> dict:
    """The compared numbers of the control of `cell` on `seed`'s inputs: as
    many subframes as a run compares, drawn alike, decoded by the reference
    rounded to bfloat16 and held to the exact reference."""
    wl = {**core.load_json("workloads", cell), **(wl_over or {})}
    cfg = {**core.load_json("configs", wl["config"]), **(cfg_over or {})}
    rng = np.random.default_rng([seed, 1])
    clean, iq = noisy_batches(cfg, seed, wl["batch"], wl["n_batches"], device)
    nv = clean.noise_var(cfg["snr_db"])
    ref = uplink.Receiver(cfg)
    parts = []
    for _ in range(wl["sample"]["steps"]):
        b = int(rng.integers(0, len(iq)))
        x = iq[b][pick_rows(wl["batch"], wl["sample"]["rows"], rng)].cpu().numpy()
        parts.append(compare(ref.pusch(x, nv, receiver.bf16), ref.pusch(x, nv)))
    numbers = judge.merge(parts)
    return {"seed": seed, "correct": judge.correct(numbers, wl["limits"]), "numbers": numbers}


def main() -> int:
    ap = argparse.ArgumentParser(description="The bf16 control of a cell of this entry.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **readings(args.workload, seed, "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
