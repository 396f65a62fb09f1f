"""PBCH / MIB (36.211 6.6, 36.212 5.3.1). Counterpart of
``srsue_tpu/phy/pbch.py``.

The 1920-bit (normal CP) PBCH codeword spans 4 radio frames; a UE that just
woke up knows neither which quarter it observes nor the eNB's port count.
All 4 quarter hypotheses are decoded by one ``convcode.decode`` call ([4,
40, 3]: on CUDA one launch of ``csrc/viterbi.cu``), and the CRC16 antenna
masks pick the winner on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import to_host
from . import convcode, crc, equalize, modulation, ratematch, regrid, seq
from .cell import Cell

MIB_LEN = 24
CODED = MIB_LEN + 16  # + CRC16
E_TOTAL = 1920  # normal CP
E_FRAME = 480

# CRC16 antenna masks (36.212 Table 5.3.1.1-1)
ANT_MASK = {1: 0x0000, 2: 0xFFFF, 4: 0x5555}

PRB_CODE = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
CODE_PRB = {v: k for k, v in PRB_CODE.items()}


@dataclass(frozen=True)
class Mib:
    n_prb: int
    phich_duration: str  # "normal" | "extended"
    phich_resources: float  # 1/6, 1/2, 1, 2
    sfn: int  # frame number (8 MSBs from the MIB, 2 LSBs from the quarter)


_PHICH_RES = [1 / 6, 1 / 2, 1.0, 2.0]


def pack_mib(mib: Mib) -> np.ndarray:
    bits = np.zeros(MIB_LEN, np.uint8)
    bw = PRB_CODE[mib.n_prb]
    bits[0:3] = [(bw >> i) & 1 for i in (2, 1, 0)]
    bits[3] = 0 if mib.phich_duration == "normal" else 1
    ng = _PHICH_RES.index(mib.phich_resources)
    bits[4:6] = [(ng >> i) & 1 for i in (1, 0)]
    sfn8 = (mib.sfn >> 2) & 0xFF
    bits[6:14] = [(sfn8 >> i) & 1 for i in range(7, -1, -1)]
    return bits


def unpack_mib(bits: np.ndarray, quarter: int) -> Mib:
    b = np.asarray(bits).astype(np.int64)
    bw = (b[0] << 2) | (b[1] << 1) | b[2]
    dur = "normal" if b[3] == 0 else "extended"
    ng = _PHICH_RES[(b[4] << 1) | b[5]]
    sfn8 = 0
    for i in range(8):
        sfn8 = (sfn8 << 1) | b[6 + i]
    return Mib(CODE_PRB.get(int(bw), 6), dur, ng, (int(sfn8) << 2) | quarter)


def _scramble_seq(cell_id: int) -> np.ndarray:
    return seq.prs(cell_id, E_TOTAL)


def encode(cell: Cell, mib: Mib, n_ports: int = 1) -> np.ndarray:
    """MIB -> the whole 1920-bit scrambled PBCH codeword (all 4 frames)."""
    b = crc.attach(pack_mib(mib), "16", mask=ANT_MASK[n_ports])
    coded = convcode.encode(b)  # [3, 40]
    e = coded.reshape(-1)[ratematch.conv_rm_indices(CODED, E_TOTAL)]
    return (e ^ _scramble_seq(cell.cell_id)).astype(np.uint8)


def frame_symbols(cell: Cell, codeword: np.ndarray, quarter: int) -> np.ndarray:
    """The 240 QPSK symbols sent in a radio frame with sfn mod 4 == quarter."""
    return modulation.modulate_np(codeword[quarter * E_FRAME: (quarter + 1) * E_FRAME], 2)


def map_to_grid(cell: Cell, grid: np.ndarray, symbols: np.ndarray) -> None:
    pos = regrid.pbch_positions(cell)
    grid[pos[:, 0], pos[:, 1]] = symbols


def map_to_grid_tm2(cell: Cell, grids: list[np.ndarray], symbols: np.ndarray) -> None:
    """2-port SFBC mapping of the PBCH block (36.211 6.6.3: transmit
    diversity over consecutive REs in mapping order), in the convention
    ``equalize.alamouti_combine`` inverts."""
    pos = regrid.pbch_positions(cell)
    p0, p1 = equalize.alamouti_precode(symbols)
    grids[0][pos[:, 0], pos[:, 1]] = p0
    grids[1][pos[:, 0], pos[:, 1]] = p1


def extract_re(cell: Cell, grid: torch.Tensor) -> torch.Tensor:
    """[..., n_sym_sf, n_sc] -> the PBCH REs [..., 240]."""
    pos = regrid.pbch_positions(cell)
    idx = torch.as_tensor(pos[:, 0].astype(np.int64) * cell.n_sc + pos[:, 1],
                          device=grid.device)
    return grid.reshape(grid.shape[:-2] + (-1,))[..., idx]


def dematch_quarter(llr: torch.Tensor) -> torch.Tensor:
    """The [..., 480] descrambled LLRs of one quarter -> the [..., 120]
    softbuffer of the 3 x 40 coded bits.

    ``conv_rm_indices(40, 1920)`` tiles one 120-long pattern, so every
    quarter holds 4 whole repeats of it: they are summed in the order sent
    and placed by the pattern. Unlike a scatter-add (``ratematch.dematch``
    on CUDA) the sum has one order on every device, and MIB decisions must
    be the same on each."""
    n = 3 * CODED
    pattern = torch.as_tensor(ratematch.conv_rm_indices(CODED, E_TOTAL)[:n], device=llr.device)
    r = llr.reshape(llr.shape[:-1] + (E_FRAME // n, n))
    out = torch.empty(llr.shape[:-1] + (n,), dtype=llr.dtype, device=llr.device)
    out[..., pattern] = ((r[..., 0, :] + r[..., 1, :]) + r[..., 2, :]) + r[..., 3, :]
    return out


def decode(cell: Cell, x_eq: torch.Tensor, nv_eff) -> tuple[Mib | None, int, int]:
    """Decode the MIB from one equalized PBCH block.

    x_eq: [240] equalized symbols, nv_eff: per-RE noise. Tries all 4 quarter
    offsets (one batched Viterbi call) x 3 port masks. Returns (mib | None,
    quarter, n_ports)."""
    llr = modulation.demodulate_soft(x_eq, 2, nv_eff)  # [480]
    scr = torch.as_tensor((1.0 - 2.0 * _scramble_seq(cell.cell_id)).astype(np.float32),
                          device=llr.device)
    d = dematch_quarter(llr * scr.reshape(4, E_FRAME))  # one row per quarter hypothesis
    hard = to_host(convcode.decode(d.reshape(4, 3, CODED).transpose(1, 2).contiguous()))

    for q in range(4):
        if not hard[q].any():
            # the all-zero codeword satisfies CRC(0) = 0 and is what Viterbi
            # gives for an empty PBCH region: reject it
            continue
        for ports, mask in ANT_MASK.items():
            if crc.check(hard[q], "16", mask=mask):
                return unpack_mib(hard[q][:MIB_LEN], q), q, ports
    return None, -1, 0
