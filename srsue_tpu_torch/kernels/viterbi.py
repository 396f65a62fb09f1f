"""Circular Viterbi decoder of the tail-biting convolutional code: the
launch of the Hopper kernel ``csrc/viterbi.cu``. ``phy/convcode.py::decode``
checks its input and calls it for CUDA tensors; ``convcode.decode_plain``
is the kernel's plain PyTorch twin. ``launches`` counts the kernel's
launches and ``shapes`` holds the (hypotheses, n) of each; a CUDA graph's
replay counts the launches its capture made (``utils.graphs.count_launch``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import graphs
from . import build

launches = 0
shapes: set = set()


def _tally(shape: tuple) -> None:
    global launches
    launches += 1
    shapes.add(shape)


def viterbi_cuda(llrs: torch.Tensor) -> torch.Tensor:
    """[B, n, 3] contiguous float32 CUDA tensor, 1 <= n <= 96 -> [B, n]
    uint8, one launch on the current stream; raises on any CUDA error."""
    B, n, _ = llrs.shape
    out = torch.empty(B, n, dtype=torch.uint8, device=llrs.device)
    with torch.cuda.device(llrs.device):
        rc = build.load().lib.srsue_viterbi(
            llrs.data_ptr(), out.data_ptr(), ctypes.c_longlong(B), ctypes.c_int(n),
            ctypes.c_void_p(torch.cuda.current_stream(llrs.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {rc} (B={B}, n={n})")
    graphs.count_launch(_tally, (B, n))
    return out
