"""Device-time breakdown of the port's main path on one CUDA GPU.

    python -m srsue_tpu_torch.profile_chain [B]

Runs, at B subframes (default 256), once each under ``torch.profiler``
after a warm-up call: the grant-known 20 MHz MCS 28 chain (``entry.entry``)
with the turbo decoder in each of its forms -- forced 8 iterations (the
fused half), 8 masked iterations and CRC early exit --; the blind control +
data chain (``rx.make_rx``, ZF) with CRC early exit and forced; and its
control stage alone (full-grid ZF, PCFICH, blind search). Prints for each:
the wall time of the call, the summed device time of its kernels, the
device's idle share of the wall time, and the kernels with the most device
time.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import entry, rx
from .phy import chest, dci, ofdm
from .utils.device import require_cuda


def breakdown(fn, args, top: int = 12) -> dict:
    """Profile one call of fn(*args); returns wall/device ms, idle share
    and the `top` kernels by device time as (name, calls, ms)."""
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "top": [(e.key, e.count, e.self_device_time_total / 1e3)
                    for e in kernels[:top]]}


def blind_runs(batch: int, dev):
    """(label, fn, args) of the blind chain (early exit, forced) and its
    control stage, on bench.py's subframes at 26 dB."""
    clean = rx.build_clean(batch, n_distinct=4)
    iq = torch.as_tensor(rx.add_noise(clean.rng, clean.td, clean.p_sig, 26.0), device=dev)
    args = (clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
            clean.dci_bits, clean.payloads)
    grid = ofdm.demodulate(clean.cell, iq)
    h, nvar, _ = chest.estimate(clean.cell, grid, clean.subframe)
    ctrl = rx.control_stage(clean.cell, clean.subframe, clean.cfi, clean.rnti,
                            dci.size_0_1a(clean.cell.n_prb))
    return [("blind early exit", rx.make_rx(*args, early_exit=True, device=dev), (iq,)),
            ("blind forced 8", rx.make_rx(*args, early_exit=True, forced=True, device=dev),
             (iq,)),
            ("control stage", ctrl, (grid, h, nvar))]


def main(batch: int = 256) -> None:
    dev = require_cuda()
    runs = []
    for mode, form in (("forced 8", {"forced": True}),
                       ("masked 8", {"early_exit": False}),
                       ("early exit", {"early_exit": True})):
        fn, args, _ = entry.entry(dev, batch=batch, n_distinct=4, **form)
        runs.append((mode, fn, args))
    for mode, fn, args in runs + blind_runs(batch, dev):
        r = breakdown(fn, args)
        print(f"{mode} B={batch}: wall {r['wall_ms']:.3f} ms, kernels "
              f"{r['device_ms']:.3f} ms, device idle {100 * r['idle_share']:.1f}%")
        for name, calls, ms in r["top"]:
            print(f"  {ms:9.3f} ms {calls:6d}x  {name[:100]}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
