"""Window-sharded turbo decoding: the BCJR windows of each code block split
over the ranks of a mesh.

Counterpart of ``srsue_tpu/parallel/turbo_shard.py``. A code block's K
trellis steps are W = K / window windows (``phy/turbo.py``); rank r holds
windows r*W/n .. (r+1)*W/n - 1 of every block:

* the shard-local half runs the r2max kernel over this rank's windows
  (``kernels.bcjr.half_windowed``; its plain twin for CPU tensors), with
  the boundaries injected here: the known start state only in global
  window 0 (rank 0), the tail beta only in the last global window (the last
  rank), the previous iteration's neighbour boundary everywhere else;
* the next-iteration boundaries that cross ranks (the final alpha of a
  rank's last window for its right neighbour, the first beta of its first
  window for its left one) travel as one ``all_gather`` of each rank's two
  edge boundaries, 16 floats per code block, from which a rank picks its
  neighbours' (the reference's ring ``ppermute``: 8 floats per hop);
* the QPP interleaver between the halves is an ``all_gather`` of the
  extrinsics and a per-rank slice of ``qpp_perm`` / ``qpp_inv``;
* the CRC is a partial GF(2) syndrome per rank, an ``all_reduce`` SUM and a
  mod 2 (the sums are integers below K: exact in float32).

All ``n_iters`` iterations run, masked (converged blocks frozen), with no
host synchronisation; ``iters`` and ``ok`` are made equal on every rank
with an ``all_reduce`` MAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import bcjr
from ..phy import turbo
from .mesh import Mesh, all_gather, all_reduce

_F32 = torch.float32


def _half_ring(sys_llr, par_llr, apriori, beta_tail, ab, bb, lw, mesh: Mesh):
    """One constituent half over this rank's windows. [B, k_loc] LLRs,
    [B, w_loc, 8] boundaries, beta_tail [B, 8]. Returns (extrinsic [B,
    k_loc], new ab, new bb) with the cross-rank boundaries exchanged."""
    B, k_loc = sys_llr.shape
    w_loc = k_loc // lw
    a0 = ab.clone()
    if mesh.rank == 0:  # global window 0 starts in state 0
        a0[:, 0] = turbo.NEG
        a0[:, 0, 0] = 0.0
    b0 = bb.clone()
    if mesh.rank == mesh.size - 1:  # the last global window ends at the tail
        b0[:, -1] = beta_tail
    lin = (sys_llr + apriori).reshape(B * w_loc, lw)
    ext, alast, bfirst = bcjr.half_windowed(
        lin, par_llr.reshape(B * w_loc, lw).contiguous(), a0.reshape(B * w_loc, 8),
        b0.reshape(B * w_loc, 8), "r2max")
    alast = alast.reshape(B, w_loc, 8)
    bfirst = bfirst.reshape(B, w_loc, 8)
    edges = all_gather(torch.cat([alast[:, -1], bfirst[:, 0]], -1)[None], mesh, 0)
    from_left = edges[(mesh.rank - 1) % mesh.size, :, :8]
    from_right = edges[(mesh.rank + 1) % mesh.size, :, 8:]
    new_ab = torch.cat([from_left[:, None], alast[:, :-1]], 1)
    new_bb = torch.cat([bfirst[:, 1:], from_right[:, None]], 1)
    return ext.reshape(B, k_loc), new_ab, new_bb


def shard_llrs(d_llrs: torch.Tensor, k: int, mesh: Mesh):
    """This rank's part of [B, 3, K+4] rate-dematched LLRs: (d_loc [B, 3,
    k_loc], tails [B, 3, 4])."""
    k_loc = k // mesh.size
    lo = mesh.rank * k_loc
    return d_llrs[:, :, lo:lo + k_loc], d_llrs[:, :, k:k + 4]


def make_sharded_decoder(k: int, n_iters: int, mesh: Mesh, window: int = 64,
                         crc_mat: np.ndarray | None = None):
    """Turbo decoder with the window (K) axis sharded over the mesh.

    run(d_loc [B, 3, k_loc], tails [B, 3, 4]) on mesh.device, the rank's
    part from ``shard_llrs`` -> (hard [B, k_loc] uint8, this rank's part;
    iters [B] int32, ok [B] bool, equal on every rank). crc_mat [K, 24]
    over the whole block, as for ``turbo.decode``."""
    n_dev = mesh.size
    W = k // window
    assert W % n_dev == 0, f"{W} windows must split evenly over {n_dev} devices"
    k_loc = k // n_dev
    lo = mesh.rank * k_loc
    dev = mesh.device
    my_perm = torch.as_tensor(turbo.qpp_perm(k)[lo:lo + k_loc], device=dev)
    my_inv = torch.as_tensor(turbo.qpp_inv(k)[lo:lo + k_loc], device=dev)
    crc_loc = None if crc_mat is None else torch.as_tensor(
        np.asarray(crc_mat, np.float32)[lo:lo + k_loc], device=dev)

    def crc_ok_of(hard_loc):
        if crc_loc is None:
            return torch.zeros(hard_loc.shape[0], dtype=torch.bool, device=dev)
        syn = all_reduce(hard_loc.to(_F32) @ crc_loc, mesh)
        return torch.remainder(torch.round(syn), 2.0).sum(-1) == 0

    def run(d_loc: torch.Tensor, tails: torch.Tensor):
        B = d_loc.shape[0]
        sys1 = d_loc[:, 0].contiguous()
        par1 = d_loc[:, 1].contiguous()
        par2 = d_loc[:, 2].contiguous()
        t = tails
        bt1 = turbo.tail_beta(torch.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], 1),
                              torch.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], 1))
        bt2 = turbo.tail_beta(torch.stack([t[:, 0, 2], t[:, 2, 2], t[:, 1, 3]], 1),
                              torch.stack([t[:, 1, 2], t[:, 0, 3], t[:, 2, 3]], 1))
        # the interleaved systematic: gathered from the whole block
        sys2 = all_gather(sys1, mesh, 1)[:, my_perm]
        le21 = torch.zeros(B, k_loc, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        hard = torch.zeros(B, k_loc, dtype=torch.uint8, device=dev)
        ab1, bb1, ab2, bb2 = (torch.zeros(B, k_loc // window, 8, device=dev)
                              for _ in range(4))
        for _ in range(n_iters):
            le12, ab1n, bb1n = _half_ring(sys1, par1, le21, bt1, ab1, bb1, window, mesh)
            apr2 = all_gather(le12, mesh, 1)[:, my_perm]  # the extrinsic exchange
            le21i, ab2n, bb2n = _half_ring(sys2, par2, apr2, bt2, ab2, bb2, window, mesh)
            le21_new = all_gather(le21i, mesh, 1)[:, my_inv]
            hard_new = (sys1 + le12 + le21_new < 0).to(torch.uint8)
            ok = crc_ok_of(hard_new)
            m = done[:, None]
            m3 = done[:, None, None]
            le21 = torch.where(m, le21, le21_new)
            hard = torch.where(m, hard, hard_new)
            ab1 = torch.where(m3, ab1, ab1n)
            bb1 = torch.where(m3, bb1, bb1n)
            ab2 = torch.where(m3, ab2, ab2n)
            bb2 = torch.where(m3, bb2, bb2n)
            iters += (~done).to(torch.int32)
            done = done | ok
        ok = (crc_ok_of(hard) | done).to(torch.int32)
        # equal on every rank by construction (the CRC is all-reduced); the
        # MAX makes it explicit, as the reference's pmax does
        all_reduce(iters, mesh, dist.ReduceOp.MAX)
        all_reduce(ok, mesh, dist.ReduceOp.MAX)
        return hard, iters, ok.to(torch.bool)

    return run
