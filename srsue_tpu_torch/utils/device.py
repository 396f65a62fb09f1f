"""Explicit device selection for the port: no global default device, and
no silent move to the CPU when CUDA is asked for but missing; and the
device-neutral copy of a result to the host."""

from __future__ import annotations

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no GPU is present.

    Also turns TF32 off for float32 matmuls (and cuDNN). The block and TB
    CRCs are GF(2) syndromes computed as float32 products of {0,1}
    matrices ([B, 75376] @ [75376, 24] for the TB): they are exact only in
    full float32, whose 24-bit mantissa holds every partial sum, while
    TF32's 10-bit mantissa does not. The channel estimator's complex
    interpolation products need the same precision."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: str | torch.device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:N"); CUDA goes
    through require_cuda()."""
    dev = torch.device(device)
    if dev.type == "cuda":
        cur = require_cuda()
        return dev if dev.index is not None else cur
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def to_host(x) -> np.ndarray:
    """A tensor on any device (or an array-like) as a numpy array; a CUDA
    tensor is copied to the host, which waits for the work that makes it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
