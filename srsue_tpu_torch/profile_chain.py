"""Device-time breakdown of the port's main path on one CUDA GPU.

    python -m srsue_tpu_torch.profile_chain [B]

Runs the 20 MHz MCS 28 chain (``entry.entry``) at B subframes (default
256) with the turbo decoder in each of its forms -- forced 8 iterations
(the fused half), 8 masked iterations and CRC early exit -- once each under
``torch.profiler`` after a warm-up call, and prints for each: the wall
time of the call, the summed device time of its kernels, the device's idle
share of the wall time, and the kernels with the most device time.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import entry
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


def main(batch: int = 256) -> None:
    dev = require_cuda()
    for mode, form in (("forced 8", {"forced": True}),
                       ("masked 8", {"early_exit": False}),
                       ("early exit", {"early_exit": True})):
        fn, args, _ = entry.entry(dev, batch=batch, n_distinct=4, **form)
        r = breakdown(fn, args)
        print(f"{mode} B={batch}: wall {r['wall_ms']:.3f} ms, kernels "
              f"{r['device_ms']:.3f} ms, device idle {100 * r['idle_share']:.1f}%")
        for name, calls, ms in r["top"]:
            print(f"  {ms:9.3f} ms {calls:6d}x  {name[:100]}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
