"""Time-block sharding of the sample stream, with a halo from the right
neighbour.

Counterpart of ``srsue_tpu/parallel/timeshard.py``. Each rank holds a block
of `n_sf_per_dev` subframes of the IQ stream, in rank order. Its front end
corrects the CFO with the global sample index (so the phase is continuous
across blocks), FIR-decimates (``sync.decimate``) and OFDM-demodulates
(``ofdm.demodulate``, cuFFT on the card). The decimating FIR looks ahead
across the block's end: the lookahead (the halo, ``len(taps)`` samples) is
the head of the right neighbour's block, which every rank shares through
one ``all_gather`` of its head. The last rank has no right neighbour: its
halo is zero, the end of the capture.
"""

from __future__ import annotations

import numpy as np
import torch

from ..phy import ofdm, sync
from ..phy.cell import Cell
from .mesh import Mesh, all_gather


def sharded_frontend(cell: Cell, mesh: Mesh, n_sf_per_dev: int, decim: int = 1,
                     cfo: float = 0.0):
    """(run, out_cell): run(x [n_sf_per_dev * sf_len] complex64, this
    rank's block, on mesh.device) -> grids [n_sf_per_dev, n_sym, n_sc] of
    out_cell, the grid geometry after decimation (a 6 PRB cell whenever
    decim > 1, else `cell`). `cfo` is in subcarriers."""
    block = n_sf_per_dev * cell.sf_len
    out_cell = Cell(n_prb=6, cell_id=cell.cell_id) if decim > 1 else cell
    halo = len(sync._lpf_taps(decim)) if decim > 1 else 0

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.shape != (block,):
            raise ValueError(f"block of {tuple(x.shape)} samples; want ({block},)")
        ext = x
        if halo:
            heads = all_gather(torch.view_as_real(x[:halo])[None], mesh, 0)
            head = torch.view_as_complex(heads[(mesh.rank + 1) % mesh.size].contiguous())
            if mesh.rank == mesh.size - 1:
                head = torch.zeros_like(head)
            ext = torch.cat([x, head])
        if cfo:
            n = torch.arange(len(ext), dtype=torch.float64, device=x.device) + mesh.rank * block
            ph = (-2.0 * np.pi * cfo / cell.nfft) * n
            ext = ext * torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
        if decim > 1:
            sf = sync.decimate(ext, decim)[:block // decim]
        else:
            sf = ext
        return ofdm.demodulate(out_cell, sf.reshape(n_sf_per_dev, out_cell.sf_len))

    return run, out_cell
