"""Microbenchmark of the turbo decoder's half-iteration kernels on one CUDA
GPU, the counterpart of ``tools/bench_kernel_variants.py``.

    python -m srsue_tpu_torch.bench_kernel_variants [reps]

Times one half-iteration of every kernel instance with CUDA events (the
mean over `reps` back-to-back launches after a warm-up) at three window
batches:
  * the reference tool's own: 256 x 13 blocks of K=6144 in 96 windows of 64;
  * the flagship: 3,328 blocks of K=5824 in 91 windows of 64;
  * the TPU's block-minor window for K=5824: 56 windows of 104
    (``turbo_pallas._bm_window``).
The [n, lw] instances (``kernels.bcjr.KERNELS``) take random LLRs and
boundaries; the fused half takes the [B, K] contract of the same windows
with the QPP deinterleaver of K. Prints ms per half and each instance's
ratio to v2v3 (the reference's v2, the tool's base), as the tool does.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from .kernels import bcjr
from .phy import turbo
from .utils.device import require_cuda

SHAPES = (  # (label, K, lw, blocks)
    ("tool K=6144 lw=64", 6144, 64, 256 * 13),
    ("flagship K=5824 lw=64", 5824, 64, 3328),
    ("TPU window K=5824 lw=104", 5824, 104, 3328),
)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call between CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(device: torch.device, reps: int = 20) -> list[dict]:
    """One row {shape, kernel, windows, ms} per shape and kernel instance."""
    rows = []
    for label, k, lw, blocks in SHAPES:
        g = torch.Generator(device=device).manual_seed(k + lw)

        def rnd(*shape, scale):
            return torch.randn(*shape, generator=g, device=device) * scale

        w = k // lw
        n = blocks * w
        lin, par = rnd(n, lw, scale=6.0), rnd(n, lw, scale=6.0)
        a0, b0 = rnd(n, 8, scale=5.0), rnd(n, 8, scale=5.0)
        for kernel in bcjr.KERNELS:
            ms = cuda_ms(lambda: bcjr.half_windowed(lin, par, a0, b0, kernel), reps)
            rows.append({"shape": label, "kernel": kernel, "windows": n, "ms": ms})
        idx = turbo.qpp_tensors(k, device)[1].to(torch.int32)
        fused = (lin.reshape(blocks, k), par.reshape(blocks, k), rnd(blocks, k, scale=3.0), idx,
                 a0.reshape(blocks, w, 8), b0.reshape(blocks, w, 8), rnd(blocks, 8, scale=5.0), lw)
        ms = cuda_ms(lambda: bcjr.bcjr_half_fused(*fused), reps)
        rows.append({"shape": label, "kernel": "fused", "windows": n, "ms": ms})
    return rows


def report(rows: list[dict]) -> list[str]:
    """Lines of ms per half and the ratio to v2v3 at the same shape."""
    base = {r["shape"]: r["ms"] for r in rows if r["kernel"] == "v2v3"}
    return [f"{r['shape']:26s} {r['kernel']:6s} {r['windows']:7d} windows: "
            f"{r['ms']:8.4f} ms/half, v2v3/this {base[r['shape']] / r['ms']:.3f}x"
            for r in rows]


def main(reps: int = 20) -> None:
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    for line in report(run(dev, reps)):
        print(line)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
