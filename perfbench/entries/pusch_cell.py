"""An eNB's receive of a loaded uplink subframe,
``srsue_tpu_torch.phy.pusch.PuschCell``: a batch of cell subframes resident
on the card a step, each shared by the configuration's UEs (``ues``), each UE
with its own band, transport block, CQI and ACK. The step calls ``dematch``,
``decode`` and ``decode_uci_sf`` in turn and ends with every UE's payload,
CRC flags, turbo iterations, CQI and ACK on the host, read in one copy (the
outputs cast to bytes and joined on the card); for the comparison each kept
step also keeps every UE's softbuffers on the card.

The operation is one cell subframe: it counts as decoded, with the TB bits
of every UE (the configuration's ``tbs``), when all its UEs' TBs pass.

The inputs come from the plain reference's transmitter of the loaded cell
(``reference/uplink_cell.py``), their noise drawn on the card by a
``torch.Generator`` from the seed. ``perfbench/control.py`` builds downlink
inputs, so the control of this entry's cells is here:

    python3 perfbench/entries/pusch_cell.py --workload <cell> --seeds <n> [<n> ...]

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
from perfbench.reference import receiver, transmitter, uplink, uplink_cell  # noqa: E402
from perfbench.rooflines import demap as demap_roof  # noqa: E402
from perfbench.rooflines import turbo as turbo_roof  # noqa: E402


@dataclasses.dataclass
class Out:
    batch: int              # which of the resident batches
    ues: list               # each UE's (payload [B, tbs], tb_ok [B], iters [B, C], cqi, ack)
    bufs: list | None       # each UE's per-block softbuffers [B, 3(K+4)] on the card


def noisy_batches(cfg: dict, seed: int, batch: int, n_batches: int, device: str):
    """(clean, [n_batches x iq [batch, sf_len] complex64 on `device`]):
    `batch` loaded uplink subframes and `n_batches` noise draws over them at
    the configuration's SNR."""
    clean = uplink_cell.build(cfg, seed, batch)
    td = torch.as_tensor(clean.td, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return clean, [transmitter.add_noise(td, clean.p_sig, cfg["snr_db"], gen)
                   for _ in range(n_batches)]


class Runner:
    def __init__(self, cfg, wl, seed, device, trace):
        from srsue_tpu_torch.phy.cell import Cell, UlGrant
        from srsue_tpu_torch.phy.pusch import PuschCell, PuschCodec

        self.cfg, self.wl, self.device = cfg, wl, device
        cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
        codecs = [PuschCodec(cell, UlGrant(n_prb=ue["n_prb"], prb_start=ue["prb_start"],
                                           mcs=ue["mcs"], mod_order=ue["qm"], tbs=ue["tbs"],
                                           rv=cfg["rv"]),
                             ue["rnti"], cfg["subframe"], n_turbo_iters=cfg["turbo_iters"],
                             n_cqi_bits=ue["cqi_bits"], with_ack=ue["ack_symbols"] > 0,
                             cqi_rep=ue["cqi_repetition"], ack_syms=ue["ack_symbols"],
                             device=device)
                  for ue in cfg["ues"]]
        self.rx = PuschCell(cell, codecs, [ue["cyclic_shift"] for ue in cfg["ues"]])
        self.batch = wl["batch"]
        self.tbs = cfg["tbs"]
        clean, self.iq = noisy_batches(cfg, seed, self.batch, wl["n_batches"], device)
        self.noise_var = clean.noise_var(cfg["snr_db"])
        self.sample_steps = wl["sample"]["steps"]
        self._demap_bytes = sum(demap_roof.pdsch_bytes(self.batch, len(c.data_pos),
                                                       [3 * (k + 4) for k in c.plan.block_ks])
                                for c in codecs)

    def warm(self):
        for i in range(len(self.iq)):
            self.step(i)

    def step(self, i: int) -> Out:
        b = i % len(self.iq)
        bufs = self.rx.dematch(self.iq[b], self.noise_var)
        decoded = self.rx.decode(bufs)
        uci = self.rx.decode_uci_sf()
        return Out(b, to_host(decoded, uci, self.batch), bufs)

    def n_ok(self, out: Out) -> int:
        return int(np.logical_and.reduce([ue[1] for ue in out.ues]).sum())

    def work(self, out: Out) -> dict:
        """The turbo decode's work these inputs need (each block's halves up
        to its convergence, every UE) and the demap's: every UE's data
        symbols read once, every softbuffer value written once."""
        halves = [(k, 2 * int(ue[2][:, i].sum()))
                  for c, ue in zip(self.rx.codecs, out.ues) for i, k in enumerate(c.plan.block_ks)]
        return {"turbo": turbo_roof.work(halves), "demap_bytes": self._demap_bytes}

    def spans(self) -> dict:
        return {}

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device == "cuda" else 0

    def judge(self, kept: list, rng: np.random.Generator) -> dict:
        """Free the port's state, then hold every UE of `rows` subframes of
        each kept step to the reference's decode of the same IQ."""
        picks = []
        for _, out in kept:
            rows = pick_rows(self.batch, self.wl["sample"]["rows"], rng)
            port = [_port_of(ue, bufs, c, rows)
                    for ue, bufs, c in zip(out.ues, out.bufs, self.rx.codecs)]
            picks.append((port, self.iq[out.batch][rows].cpu().numpy()))
            out.bufs = None
        del self.rx, self.iq, kept
        if self.device == "cuda":
            torch.cuda.empty_cache()
        ref = uplink_cell.Receiver(self.cfg)
        return judge.merge([compare(port, ref.pusch(iq, self.noise_var)) for port, iq in picks])


def to_host(decoded: list, uci: list, batch: int) -> list:
    """Each UE's (payload [B, tbs] uint8, tb_ok [B] bool, iters [B, C] int32,
    cqi [B, A] uint8, ack [B] bool) on the host from ``PuschCell.decode``'s
    and ``decode_uci_sf``'s tensors, in one device-to-host copy: every output
    cast to bytes (bits, flags and at most 8 iterations fit) and joined on
    the card. A UE without a CQI gets [B, 0], one without an ACK zeros."""
    parts, widths = [], []
    for payload, tb_ok, iters, *ue_uci in (d + u for d, u in zip(decoded, uci, strict=True)):
        for v in (payload, tb_ok, iters, *ue_uci):
            parts.append(payload.new_zeros(batch, 0) if v is None
                         else v.reshape(batch, -1).to(torch.uint8))
            widths.append(parts[-1].shape[1])
    cols = np.split(torch.cat(parts, 1).cpu().numpy(), np.cumsum(widths)[:-1], axis=1)
    return [(payload, tb_ok[:, 0].astype(bool), iters.astype(np.int32), cqi,
             ack[:, 0].astype(bool) if ack.shape[1] else np.zeros(batch, bool))
            for payload, tb_ok, iters, cqi, ack in (cols[j:j + 5] for j in range(0, len(cols), 5))]


def _port_of(ue, bufs, codec, rows) -> uplink.Decoded:
    """One UE's outputs at `rows`, its softbuffers per K-group [n, count,
    3(K+4)] as the reference gives them."""
    soft = [torch.stack(bufs[first:first + count], 1)[rows].cpu().numpy()
            for _, first, count, *_ in codec.groups]
    payload, tb_ok, iters, cqi, ack = ue
    return uplink.Decoded(payload[rows], tb_ok[rows], iters[rows], cqi[rows], ack[rows],
                          softbuf=soft)


def pick_rows(batch: int, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(batch, n, replace=False))


def compare(port: list, ref: list) -> dict:
    """Over every UE, the one-UE cell's comparison (``entries/pusch.py``):
    the decisions that differ (bits, CRC flags, iterations, subframes whose
    CQI or ACK differs), and the softbuffers' largest relative error."""
    one_ue = core.load_module("entries", "pusch")
    return judge.merge([one_ue.compare(p, r) for p, r in zip(port, ref, strict=True)])


def build(cfg, wl, seed, device, trace) -> Runner:
    return Runner(cfg, wl, seed, device, trace)


def readings(cell: str, seed: int, device: str, cfg_over=None, wl_over=None) -> dict:
    """The compared numbers of the control of `cell` on `seed`'s inputs: as
    many subframes as a run compares, drawn alike, every UE decoded by the
    reference rounded to bfloat16 and held to the exact reference."""
    wl = {**core.load_json("workloads", cell), **(wl_over or {})}
    cfg = {**core.load_json("configs", wl["config"]), **(cfg_over or {})}
    rng = np.random.default_rng([seed, 1])
    clean, iq = noisy_batches(cfg, seed, wl["batch"], wl["n_batches"], device)
    nv = clean.noise_var(cfg["snr_db"])
    ref = uplink_cell.Receiver(cfg)
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
