"""The cells' inputs: the reference transmitter's subframes from the seed,
with their noise drawn on the device by a ``torch.Generator`` from the same
seed."""

from __future__ import annotations

import torch

from .reference import transmitter


def noisy_batches(cfg: dict, seed: int, batch: int, n_batches: int, device: str):
    """(clean, [n_batches x iq [batch, sf_len] complex64 on `device`]):
    `batch` subframes, each with its own transport block, and `n_batches`
    independent noise draws over them at the configuration's SNR."""
    clean = transmitter.build(cfg, seed, batch)
    td = torch.as_tensor(clean.td, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    iq = [transmitter.add_noise(td, clean.p_sig, cfg["snr_db"], gen) for _ in range(n_batches)]
    return clean, iq
