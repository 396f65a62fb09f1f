"""Times the eNB's PUSCH receive of one UE a TTI at B=1, as
``enb/phy.py::_decode_pusch`` runs it, on a seeded sequence of grants: a
new ``PuschCodec`` each TTI, ``dematch_sf`` at a noise of 1e-4,
``decode_softbuffers``, the TB flags read, ``decode_uci`` where the TTI
carries UCI. Host wall clock, synchronised by those reads.

    python -m srsue_tpu_torch.bench_ul_grants [seed] [ttis]

Sequences of `ttis` TTIs (default 1,000) on a 20 MHz cell, subframe TTI
mod 10, after one warm-up of 200 TTIs drawn from another seed (kernels,
FFT plans, the turbo loop's shapes):

  * ``fixed``: one 25 PRB MCS 12 grant at rv 0, an ACK every TTI and a
    4-bit CQI every fifth: the receive's keys come back every 10 TTIs;
  * ``drawn``: each TTI's PRB count from the eNB emulator's buckets (4, 10,
    25, 100), its start, MCS 0-16, rv (0, or a retransmission's 2, 3, 1),
    ACK and CQI drawn anew, as a scheduler under changing load: the keys
    seldom come back.

Each line gives the share of TTIs whose receive key (band, modulation, TBS,
rv, subframe, UCI layout) came back within the last 256 TTIs, the uplink
stages' graph captures and replays (``phy/frontend.py``; none on a tree
without them), the turbo loop's captures, the TBs decoded, and the ms a TTI
(mean, p50, p95) to build the codec and to receive.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .phy import frontend, ra, turbo
from .phy.cell import Cell, UlGrant
from .phy.pusch import PuschCodec
from .utils.device import to_host

CELL = Cell(n_prb=100, cell_id=1)
RNTI, NOISE_VAR, SNR_DB, WARMUP, WINDOW = 0x4601, 1e-4, 15.0, 200, 256
PRB_BUCKETS = (4, 10, 25, 100)
RV_SEQ = (0, 2, 3, 1)


def _grants(kind: str, n: int, rng) -> list:
    """[(UlGrant, subframe, n_cqi_bits, with_ack)] of `n` TTIs."""
    out = []
    for tti in range(n):
        if kind == "fixed":
            mcs, n_prb, start, rv, ack, cqi = 12, 25, 0, 0, True, 4 * (tti % 5 == 0)
        else:
            mcs, n_prb = int(rng.integers(17)), int(rng.choice(PRB_BUCKETS))
            start = int(rng.integers(CELL.n_prb - n_prb + 1))
            rv = RV_SEQ[int(rng.choice(4, p=(0.85, 0.05, 0.05, 0.05)))]
            ack, cqi = bool(rng.integers(2)), 4 * bool(rng.random() < 0.2)
        qm, i_tbs = ra.mcs_to_mod_itbs(mcs)
        out.append((UlGrant(n_prb, start, mcs, qm, ra.tbs(i_tbs, n_prb), rv), tti % 10, cqi, ack))
    return out


def _subframes(grants: list, rng) -> list:
    """Each TTI's received IQ [1, sf_len] (host) at SNR_DB over its band."""
    out = []
    for grant, sf, cqi, ack in grants:
        c = PuschCodec(CELL, grant, RNTI, sf, n_cqi_bits=cqi, with_ack=ack, device="cpu")
        x = c.encode_sf_uci(rng.integers(0, 2, grant.tbs).astype(np.uint8),
                            rng.integers(0, 2, cqi).astype(np.uint8) if cqi else None,
                            bool(rng.integers(2)) if ack else None)
        nv = float(np.mean(np.abs(x) ** 2)) * CELL.nfft / c.m_sc / 10 ** (SNR_DB / 10)
        noise = rng.standard_normal((2, x.size)) * np.sqrt(nv / 2)
        out.append((x + noise[0] + 1j * noise[1]).astype(np.complex64)[None])
    return out


def _tti(dev, grant, sf, cqi, ack, iq):
    """One TTI's receive as the eNB runs it -> (build s, receive s, TB ok)."""
    t0 = time.perf_counter()
    codec = PuschCodec(CELL, grant, RNTI, sf, with_ack=ack, n_cqi_bits=cqi, device=dev)
    t1 = time.perf_counter()
    bufs = codec.dematch_sf(torch.as_tensor(iq, device=dev), noise_var=NOISE_VAR)
    _, ok, _ = codec.decode_softbuffers(bufs)
    good = bool(to_host(ok).all())
    if ack or cqi:
        codec.decode_uci()
    return t1 - t0, time.perf_counter() - t1, good


def _recurred(grants: list) -> float:
    """The share of TTIs whose key was seen within the WINDOW TTIs before."""
    last, hits = {}, 0
    for i, (g, sf, cqi, ack) in enumerate(grants):
        key = (g.prb_start, g.n_prb, g.mod_order, g.tbs, g.rv, sf, cqi, ack)
        hits += key in last and i - last[key] <= WINDOW
        last[key] = i
    return hits / len(grants)


def _pct(xs: list, p: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, p))


def warm_up(seed: int, dev: torch.device) -> None:
    rng = np.random.default_rng(seed + 1)
    warm = _grants("drawn", WARMUP, rng)
    for args, iq in zip(warm, _subframes(warm, rng)):
        _tti(dev, *args, iq)


def run(kind: str, seed: int, ttis: int, dev: torch.device) -> dict:
    rng = np.random.default_rng(seed)
    grants = _grants(kind, ttis, rng)
    iqs = _subframes(grants, rng)
    tally = {"captures": 0, "replays": 0, "turbo_captures": 0}
    counted = [(frontend._Replayed, "__init__", "captures"),
               (frontend._Replayed, "__call__", "replays"),
               (turbo._Graphed, "__init__", "turbo_captures")]
    saved = [getattr(cls, name) for cls, name, _ in counted]

    def counting(fn, what):
        def call(*a, **kw):
            tally[what] += 1
            return fn(*a, **kw)
        return call

    for (cls, name, what), fn in zip(counted, saved):
        setattr(cls, name, counting(fn, what))
    try:
        build, rx, ok = zip(*(_tti(dev, *args, iq) for args, iq in zip(grants, iqs)))
    finally:
        for (cls, name, _), fn in zip(counted, saved):
            setattr(cls, name, fn)
    return {"sequence": kind, "seed": seed, "ttis": ttis, "recurred": _recurred(grants),
            **tally, "tb_ok": sum(ok), "build_ms": {"mean": statistics.fmean(build) * 1e3,
                                                    "p50": _pct(build, 50), "p95": _pct(build, 95)},
            "rx_ms": {"mean": statistics.fmean(rx) * 1e3, "p50": _pct(rx, 50),
                      "p95": _pct(rx, 95)}}


def main(argv: list) -> None:
    seed = int(argv[1]) if len(argv) > 1 else 1
    ttis = int(argv[2]) if len(argv) > 2 else 1000
    dev = torch.device("cuda")
    warm_up(seed, dev)
    for kind in ("fixed", "drawn"):
        print(json.dumps(run(kind, seed, ttis, dev)), flush=True)


if __name__ == "__main__":
    main(sys.argv)
