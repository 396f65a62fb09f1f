"""Control region: PCFICH, PHICH and PDCCH, REG/CCE geometry, encode and
decode (36.211 6.7/6.8/6.9, 36.212 5.1.4.2/5.3.3, 36.213 9.1.1/9.1.2).
Counterpart of the receive side of ``srsue_tpu/phy/control.py`` for 1 and
2 ports (the 2-port control region is SFBC-combined into a pseudo-equalized
grid that the single-port decoders read) and of the transmit side its test
vectors need.

The REG/CCE geometry (quadruplet sub-block interleaver, cell-ID cyclic
shift, PCFICH and PHICH REGs) is host numpy, cached per configuration; the
device sees only:

* PCFICH: a [32] x [32, 3] correlation product -> argmax CFI;
* PHICH: a gather of the group's 12 REs and a despread (one product with
  the sequence's conjugated symbols) -> the soft ACK metric;
* PDCCH blind search: every (candidate, batch element) hypothesis gathered,
  demapped and dematched into one batch, decoded by ONE
  ``convcode.decode`` call, and checked by one RNTI-masked CRC16 product.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import resolve, to_host
from . import convcode, crc, equalize, modulation, ratematch, regrid, seq
from .cell import Cell

# ---------------------------------------------------------------------------
# REG geometry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def regs_in_symbol(cell: Cell, l: int) -> tuple[tuple[int, ...], ...]:
    """REGs of symbol l as tuples of 4 flat RE indices (sym*n_sc + k),
    ordered by frequency. In a symbol with CRS (l = 0, and l = 1 with four
    ports) a REG is the 4 REs of 6 subcarriers off the CRS positions
    k = vshift (mod 3)."""
    n_sc = cell.n_sc
    if l == 0 or (l == 1 and cell.n_ports == 4):
        a = cell.vshift % 6
        return tuple(tuple(l * n_sc + 6 * m + j for j in range(6) if j % 3 != a % 3)
                     for m in range(n_sc // 6))
    return tuple(tuple(l * n_sc + 4 * m + j for j in range(4)) for m in range(n_sc // 4))


@functools.lru_cache(maxsize=128)
def pcfich_regs(cell: Cell) -> tuple[int, ...]:
    """Indices (into regs_in_symbol(cell, 0)) of the 4 PCFICH REGs."""
    n_rb = cell.n_prb
    k_bar = 6 * (cell.cell_id % (2 * n_rb))
    return tuple(((k_bar + (z * n_rb // 2) * 6) % cell.n_sc) // 6 for z in range(4))


def n_phich_groups(cell: Cell) -> int:
    return max(1, math.ceil(cell.phich_resources * cell.n_prb / 8))


@functools.lru_cache(maxsize=128)
def phich_reg_table(cell: Cell) -> tuple[tuple[int, ...], ...]:
    """Per PHICH group: indices into regs_in_symbol(cell, 0) of its 3 REGs
    (normal duration: all in symbol 0). 36.211 6.9.3."""
    pcf = pcfich_regs(cell)
    avail = [i for i in range(len(regs_in_symbol(cell, 0))) if i not in pcf]
    n0 = len(avail)
    return tuple(tuple(avail[(cell.cell_id + m + (i * n0) // 3) % n0] for i in range(3))
                 for m in range(n_phich_groups(cell)))


@functools.lru_cache(maxsize=256)
def pdcch_geometry(cell: Cell, cfi: int):
    """(n_cce, cce_re_idx [n_cce, 36] int32): flat RE indices of each CCE
    after quadruplet interleaving and the cell-ID cyclic shift (36.211
    6.8.5)."""
    used0 = set(pcfich_regs(cell))
    for grp in phich_reg_table(cell):
        used0.update(grp)
    # REGs of the control region in (k, l) order
    reg_list = []
    for l in range(regrid.control_span(cell, cfi)):
        for i, res in enumerate(regs_in_symbol(cell, l)):
            if not (l == 0 and i in used0):
                reg_list.append(((res[0] % cell.n_sc, l), res))
    reg_list.sort(key=lambda t: t[0])
    regs_ordered = [res for _, res in reg_list]
    n_reg = len(regs_ordered)
    n_cce = n_reg // 9

    # quadruplet sub-block interleaver (the conv permutation on indices):
    # REG position i carries interleaved quadruplet perm[(i + cell_id) % n]
    perm = ratematch._interleave_idx(n_reg, ratematch.PERM_CONV)
    perm = perm[perm >= 0]
    reg_of_w = np.empty(n_reg, dtype=np.int64)
    reg_of_w[perm[(np.arange(n_reg) + cell.cell_id) % n_reg]] = np.arange(n_reg)
    cce_re = np.asarray([[re for j in range(9) for re in regs_ordered[reg_of_w[9 * c + j]]]
                         for c in range(n_cce)], dtype=np.int32).reshape(n_cce, 36)
    return n_cce, cce_re


# ---------------------------------------------------------------------------
# PCFICH
# ---------------------------------------------------------------------------

_CFI_CW = np.array(
    [
        [0, 1, 1] * 10 + [0, 1],
        [1, 0, 1] * 10 + [1, 0],
        [1, 1, 0] * 10 + [1, 1],
    ],
    dtype=np.uint8,
)  # 36.212 Table 5.3.4-1 (periodic 011/101/110 patterns, 32 bits)


def _cfi_scramble(cell: Cell, subframe: int) -> np.ndarray:
    c_init = ((subframe + 1) * (2 * cell.cell_id + 1) << 9) + cell.cell_id
    return seq.prs(c_init, 32)


@functools.lru_cache(maxsize=256)
def _pcfich_re(cell: Cell) -> np.ndarray:
    regs = regs_in_symbol(cell, 0)
    return np.asarray([re for r in pcfich_regs(cell) for re in regs[r]], dtype=np.int32)


def pcfich_encode(cell: Cell, subframe: int, cfi: int) -> np.ndarray:
    """The 16 QPSK symbols of the CFI codeword (host)."""
    return modulation.modulate_np(_CFI_CW[cfi - 1] ^ _cfi_scramble(cell, subframe), 2)


def pcfich_map(cell: Cell, grid: np.ndarray, subframe: int, cfi: int) -> None:
    grid.reshape(-1)[_pcfich_re(cell)] = pcfich_encode(cell, subframe, cfi)


@functools.lru_cache(maxsize=64)
def _pcfich_tensors(cell: Cell, subframe: int, device: torch.device):
    idx = torch.as_tensor(_pcfich_re(cell).astype(np.int64), device=device)
    s = torch.as_tensor((1.0 - 2.0 * _cfi_scramble(cell, subframe)).astype(np.float32),
                        device=device)
    cw = torch.as_tensor((1.0 - 2.0 * _CFI_CW).astype(np.float32).T.copy(), device=device)
    return idx, s, cw


def _flat_grid(grid_eq: torch.Tensor, nv_eff):
    """(symbols [..., n_sym * n_sc], noise) of an equalized [..., n_sym,
    n_sc] grid: a grid-shaped nv_eff flattened the same way, a batch-shaped
    one [...] with a trailing axis, a scalar as it is; the noise broadcasts
    against the symbols."""
    lead = grid_eq.shape[:-2]
    y = grid_eq.reshape(lead + (-1,))
    nv = torch.as_tensor(nv_eff, dtype=torch.float32, device=grid_eq.device)
    if nv.ndim >= 2 and nv.shape[-2:] == grid_eq.shape[-2:]:
        return y, nv.reshape(nv.shape[:-2] + (-1,))
    return y, (nv[..., None] if nv.ndim else nv)


def _gather_re(grid_eq: torch.Tensor, nv_eff, idx: torch.Tensor):
    """(symbols [..., m], noise) at the flat RE indices idx [m] of an
    equalized [..., n_sym, n_sc] grid: ``_flat_grid``'s, with a grid-shaped
    noise gathered too."""
    y, nv = _flat_grid(grid_eq, nv_eff)
    return y[..., idx], (nv[..., idx] if nv.ndim and nv.shape[-1] > 1 else nv)


def pcfich_decode(cell: Cell, grid_eq: torch.Tensor, nv_eff, subframe: int):
    """Equalized grid(s) -> (cfi [...] int64, correlation scores [..., 3])."""
    idx, s, cw = _pcfich_tensors(cell, subframe, grid_eq.device)
    y, nv = _gather_re(grid_eq, nv_eff, idx)
    llr = modulation.demodulate_soft(y, 2, nv)  # [..., 32]
    scores = (llr * s) @ cw
    return scores.argmax(-1) + 1, scores


# ---------------------------------------------------------------------------
# PHICH
# ---------------------------------------------------------------------------

_PHICH_W = np.array(
    [[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], dtype=np.float32,
)  # the real part; sequences 4..7 are j * w (36.211 Table 6.9.1-2)


@functools.lru_cache(maxsize=256)
def _phich_re(cell: Cell, group: int) -> np.ndarray:
    regs = regs_in_symbol(cell, 0)
    return np.asarray([re for r in phich_reg_table(cell)[group] for re in regs[r]],
                      dtype=np.int32)


def phich_symbols(cell: Cell, subframe: int, group: int, nseq: int, ack: bool) -> np.ndarray:
    """The 12 complex symbols of one PHICH: BPSK on the diagonal, spread by
    orthogonal sequence nseq, scrambled by the cell and subframe's sequence
    (the PCFICH's; host)."""
    c = 1.0 - 2.0 * _cfi_scramble(cell, subframe)[:12].astype(np.float32)
    z = (1.0 if ack else -1.0) / np.sqrt(2) * (1 + 1j)
    w = _PHICH_W[nseq % 4] * (1j if nseq >= 4 else 1.0)
    return (np.tile(w, 3) * z * c).astype(np.complex64)


def phich_map(cell: Cell, grid: np.ndarray, subframe: int, group: int, nseq: int,
              ack: bool) -> None:
    """Add one PHICH to its group's REs (the group's PHICHs superpose)."""
    grid.reshape(-1)[_phich_re(cell, group)] += phich_symbols(cell, subframe, group, nseq, ack)


@functools.lru_cache(maxsize=256)
def _phich_tensors(cell: Cell, subframe: int, group: int, nseq: int, device: torch.device):
    idx = torch.as_tensor(_phich_re(cell, group).astype(np.int64), device=device)
    ref = np.conj(phich_symbols(cell, subframe, group, nseq, ack=True))
    return idx, torch.as_tensor(ref, device=device)


def phich_decode(cell: Cell, grid_eq, subframe: int, group: int, nseq: int,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Equalized grid(s) [..., n_sym_sf, n_sc] -> the soft ACK metric [...]
    float32, > 0 for ACK: the group's 12 REs gathered and despread. A 1-port
    grid is the ZF-equalized one; a 2-port grid is the one
    ``sfbc_equalize_control`` makes. The decode runs on `device` (the card by
    default): a numpy grid is moved there, a tensor must already be there."""
    dev = resolve(device)
    if isinstance(grid_eq, torch.Tensor) and grid_eq.device != dev:
        raise ValueError(f"grid on {grid_eq.device}, PHICH decode asked on {dev}")
    g = torch.as_tensor(grid_eq, dtype=torch.complex64, device=dev)
    idx, ref = _phich_tensors(cell, subframe, group, nseq, dev)
    return (g.reshape(g.shape[:-2] + (-1,))[..., idx] @ ref).real


def phich_group_seq(n_prb_lowest: int, dmrs_cshift: int, n_groups: int) -> tuple[int, int]:
    """(group, sequence) of the PHICH that answers a PUSCH allocation
    (36.213 9.1.2)."""
    group = (n_prb_lowest + dmrs_cshift) % n_groups
    nseq = ((n_prb_lowest // n_groups) + dmrs_cshift) % 8
    return group, nseq


# ---------------------------------------------------------------------------
# Transmit diversity (2-port SFBC, 36.211 6.3.4.3) for the control region.
# Every control channel maps in REG quadruplets whose 4 REs stay adjacent in
# mapping order, so the SFBC pairs are (0, 1) and (2, 3) of each quadruplet:
# one precode/combine convention (``equalize.alamouti_precode`` /
# ``alamouti_combine``) serves PCFICH, PHICH and PDCCH alike.
# ---------------------------------------------------------------------------


def pcfich_map_tm2(cell: Cell, grids, subframe: int, cfi: int) -> None:
    p0, p1 = equalize.alamouti_precode(pcfich_encode(cell, subframe, cfi))
    idx = _pcfich_re(cell)
    grids[0].reshape(-1)[idx] = p0
    grids[1].reshape(-1)[idx] = p1


def phich_map_tm2(cell: Cell, grids, subframe: int, group: int, nseq: int,
                  ack: bool) -> None:
    """One PHICH, SFBC-precoded, added onto the two ports' grids (host)."""
    p0, p1 = equalize.alamouti_precode(phich_symbols(cell, subframe, group, nseq, ack))
    idx = _phich_re(cell, group)
    grids[0].reshape(-1)[idx] += p0
    grids[1].reshape(-1)[idx] += p1


@functools.lru_cache(maxsize=64)
def _control_region_idx(cell: Cell) -> np.ndarray:
    """Flat RE indices of every REG of the largest control region, in
    quadruplet order. Narrow cells (n_prb <= 10) carry it over CFI + 1
    symbols (36.211 Table 6.7-1), so their largest is 4 symbols, not 3."""
    return np.asarray([re for l in range(regrid.control_span(cell, 3))
                       for reg in regs_in_symbol(cell, l) for re in reg], dtype=np.int64)


@functools.lru_cache(maxsize=64)
def control_region_index(cell: Cell, device: torch.device) -> torch.Tensor:
    """``_control_region_idx`` on `device`, built once (a frontend's CUDA
    graph holds it: it reads no table from the host)."""
    return torch.as_tensor(_control_region_idx(cell), device=device)


def sfbc_equalize_control(cell: Cell, grid: torch.Tensor, h0: torch.Tensor,
                          h1: torch.Tensor, nvar):
    """Raw grid and the two ports' channel estimates -> a pseudo-equalized
    grid whose control-region REs hold the SFBC-combined symbol estimates
    (paired inside each REG quadruplet), and a per-RE noise grid to match
    (1e6 elsewhere, so stray REs demap to zero LLR). The single-port
    decoders (``pcfich_decode``, ``phich_decode``, ``pdcch_blind_*``) then
    run unchanged on the combined grid. The REG indices are unique, so the
    indexed assignments are deterministic."""
    idx = control_region_index(cell, grid.device)
    lead = grid.shape[:-2]
    n = cell.n_sym_sf * cell.n_sc

    def at(g):
        return g.reshape(g.shape[:-2] + (-1,))[..., idx]

    x, nv_eff = equalize.alamouti_combine(at(grid), at(h0), at(h1), nvar)
    g_eq = torch.zeros(lead + (n,), dtype=torch.complex64, device=grid.device)
    g_eq[..., idx] = x.to(torch.complex64)
    nv_grid = torch.full(lead + (n,), 1e6, dtype=torch.float32, device=grid.device)
    nv_grid[..., idx] = nv_eff.to(torch.float32)
    shape = lead + (cell.n_sym_sf, cell.n_sc)
    return g_eq.reshape(shape), nv_grid.reshape(shape)


# ---------------------------------------------------------------------------
# PDCCH
# ---------------------------------------------------------------------------


def _pdcch_scramble(cell: Cell, subframe: int, n_bits: int) -> np.ndarray:
    c_init = (subframe << 9) + cell.cell_id
    return seq.prs(c_init, n_bits)


def pdcch_encode(cell: Cell, subframe: int, dci_bits: np.ndarray, rnti: int,
                 l_aggr: int) -> np.ndarray:
    """DCI payload -> the 72*L coded bits (CRC16 masked by the RNTI,
    tail-biting conv coding, rate matching); scrambling is applied at map
    time, where the CCE offset is known."""
    b = crc.attach(dci_bits, "16", mask=rnti)
    coded = convcode.encode(b)
    return coded.reshape(-1)[ratematch.conv_rm_indices(len(b), 72 * l_aggr)]


def _pdcch_symbols(cell: Cell, subframe: int, cfi: int, dci_bits: np.ndarray, rnti: int,
                   n_cce: int, l_aggr: int):
    """(flat RE indices, QPSK symbols) of one DCI on CCEs n_cce .. n_cce +
    l_aggr - 1 (host)."""
    n_cce_tot, cce_re = pdcch_geometry(cell, cfi)
    bits = pdcch_encode(cell, subframe, dci_bits, rnti, l_aggr)
    scr = _pdcch_scramble(cell, subframe, 72 * n_cce_tot)[72 * n_cce: 72 * (n_cce + l_aggr)]
    return cce_re[n_cce: n_cce + l_aggr].reshape(-1), modulation.modulate_np(bits ^ scr, 2)


def pdcch_map(cell: Cell, grid: np.ndarray, subframe: int, cfi: int,
              dci_bits: np.ndarray, rnti: int, n_cce: int, l_aggr: int) -> None:
    """Map one DCI on CCEs n_cce .. n_cce + l_aggr - 1 (host)."""
    res, sym = _pdcch_symbols(cell, subframe, cfi, dci_bits, rnti, n_cce, l_aggr)
    grid.reshape(-1)[res] = sym


def pdcch_map_tm2(cell: Cell, grids, subframe: int, cfi: int, dci_bits: np.ndarray,
                  rnti: int, n_cce: int, l_aggr: int) -> None:
    """The same DCI, SFBC-precoded onto the two ports' grids (host)."""
    res, sym = _pdcch_symbols(cell, subframe, cfi, dci_bits, rnti, n_cce, l_aggr)
    p0, p1 = equalize.alamouti_precode(sym)
    grids[0].reshape(-1)[res] = p0
    grids[1].reshape(-1)[res] = p1


def search_space_candidates(n_cce: int, rnti: int, subframe: int,
                            ue_specific: bool = True) -> list[tuple[int, int]]:
    """Candidate (start_cce, L) list: common (L=4,8) then the UE-specific
    hash (36.213 9.1.1), deduplicated in order; the order indexes the
    outputs of ``pdcch_blind_batch``."""
    cands = [(m * l, l) for l, m_max in ((4, 4), (8, 2)) for m in range(m_max)
             if m * l + l <= n_cce]
    if ue_specific and rnti:
        y = rnti
        for _ in range(subframe + 1):
            y = (39827 * y) % 65537
        for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
            if n_cce // l == 0:
                continue
            for m in range(m_max):
                start = l * ((y + m) % (n_cce // l))
                if start + l <= n_cce:
                    cands.append((start, l))
    return list(dict.fromkeys(cands))


@functools.lru_cache(maxsize=64)
def _blind_tables(cell: Cell, subframe: int, cfi: int, rnti: int, dci_len: int,
                  ue_specific: bool, device: torch.device):
    """Every candidate's REs, one after the other: (n_cand, RE index [M],
    +-1 scrambling [2M], the inverse (``ratematch.inverse_index``) of the
    softbuffer index [2M] = candidate * 3 n_coded + its conv dematch
    position, the [n_coded, 16] CRC16 syndrome matrix and the RNTI mask
    bits)."""
    n_cce, cce_re = pdcch_geometry(cell, cfi)
    cands = search_space_candidates(n_cce, rnti, subframe, ue_specific)
    if not cands:
        raise ValueError("empty search space")
    scr_full = (1.0 - 2.0 * _pdcch_scramble(cell, subframe, 72 * n_cce)).astype(np.float32)
    n_coded = dci_len + 16
    res = np.concatenate([cce_re[s: s + l].reshape(-1) for s, l in cands]).astype(np.int64)
    scr = np.concatenate([scr_full[72 * s: 72 * (s + l)] for s, l in cands])
    buf = ratematch.inverse_index(
        np.concatenate([i * 3 * n_coded + ratematch.conv_rm_indices(n_coded, 72 * l)
                        for i, (_, l) in enumerate(cands)]), len(cands) * 3 * n_coded)
    m = np.zeros((n_coded, 16), np.float32)
    m[:dci_len] = crc.crc_matrix(dci_len, "16")
    m[dci_len:] = np.eye(16, dtype=np.float32)
    mask = ((rnti >> np.arange(15, -1, -1)) & 1).astype(np.float32)
    return (len(cands), *(torch.as_tensor(x, device=device) for x in (res, scr, buf, m, mask)))


@functools.lru_cache(maxsize=64)
def _blind_tables32(cell: Cell, subframe: int, cfi: int, rnti: int, dci_len: int,
                    ue_specific: bool, device: torch.device):
    """int32 copies of ``_blind_tables``' RE index and inverse index, as the
    demap kernel reads them, and each candidate buffer's run of bits
    (``ratematch.segment_ranges``)."""
    n_cand, res, scr, buf, _, _ = _blind_tables(cell, subframe, cfi, rnti, dci_len, ue_specific,
                                                device)
    buf32 = buf.to(torch.int32)
    return res.to(torch.int32), buf32, ratematch.segment_ranges(buf32, n_cand, scr.numel())


def pdcch_blind_batch(cell: Cell, grid_eq: torch.Tensor, nv_eff, subframe: int,
                      cfi: int, rnti: int, dci_len: int, ue_specific: bool = True):
    """Blind DCI search over every search-space candidate of every batch
    element, with no host sync.

    grid_eq: [..., n_sym_sf, n_sc] equalized grid(s); nv_eff grid-shaped,
    batch-shaped or scalar. Returns (hard [..., n_cand, dci_len] uint8
    payloads, ok [..., n_cand] bool RNTI-masked CRC16 pass) in the order
    of ``search_space_candidates``. One ``ratematch.demap_dematch`` (QPSK
    demap of the candidates' REs through the RE map, descramble and
    dematch; on the card one launch of the demap kernel) fills every
    candidate's softbuffer (the repeats of a position at
    L >= 2 sum in the order sent, from 0.0: the same bits on every device);
    one ``convcode.decode`` call decodes them all; the CRC16 is
    one float32 GF(2) product, exact in full float32
    (``utils.device.require_cuda`` turns TF32 off)."""
    n_cand, _, scr, _, crc_m, mask = _blind_tables(cell, subframe, cfi, rnti, dci_len,
                                                   ue_specific, grid_eq.device)
    res32, buf32, ranges = _blind_tables32(cell, subframe, cfi, rnti, dci_len, ue_specific,
                                           grid_eq.device)
    n_coded = dci_len + 16
    lead = grid_eq.shape[:-2]
    y, nv = _flat_grid(grid_eq, nv_eff)
    buffers = ratematch.demap_dematch(y, nv, 2, scr, buf32, sym_map=res32, ranges=ranges)
    flat = buffers.reshape(-1, 3, n_coded).transpose(1, 2).contiguous()
    hard = convcode.decode(flat).reshape(lead + (n_cand, n_coded))
    syn = torch.remainder(torch.round(hard.to(torch.float32) @ crc_m) + mask, 2.0)
    return hard[..., :dci_len], syn.sum(-1) == 0


def blind_hits(cands, hard: np.ndarray, ok: np.ndarray, dci_len: int) -> list:
    """Host-side hit selection over ``pdcch_blind_batch``'s output, hard
    [..., n_cand, >= dci_len] and ok [..., n_cand]: each element's list of
    (start_cce, L, payload_bits) in candidate order, or one such list for
    unbatched arrays. A candidate is a hit when its CRC passed and no
    earlier candidate of its element that passed carries the same payload
    (overlapping aggregation levels decode the same circular-buffer
    codeword; the first, smallest-L hit is kept). One ``np.nonzero`` finds
    the passes of the whole batch in (element, candidate) order, and only
    they are walked."""
    n_cand = len(cands)
    bits = np.asarray(hard)[..., :dci_len].reshape(-1, n_cand, dci_len)
    passed = np.nonzero(np.asarray(ok, bool).reshape(-1, n_cand))
    out: list[list] = [[] for _ in range(len(bits))]
    seen = set()
    for e, c in zip(*(i.tolist() for i in passed)):
        key = (e, bits[e, c].tobytes())
        if key not in seen:
            seen.add(key)
            out[e].append((*cands[c], bits[e, c]))
    return out if np.ndim(ok) > 1 else out[0]


def pdcch_blind_decode(cell: Cell, grid_eq: torch.Tensor, nv_eff, subframe: int,
                       cfi: int, rnti: int, dci_len: int, ue_specific: bool = True):
    """Blind search of one subframe's [n_sym_sf, n_sc] equalized grid for
    one DCI size: list of (start_cce, L, payload_bits) passing the
    RNTI-masked CRC. All candidates decode in one device call."""
    n_cce, _ = pdcch_geometry(cell, cfi)
    cands = search_space_candidates(n_cce, rnti, subframe, ue_specific)
    if not cands:
        return []
    hard, ok = pdcch_blind_batch(cell, grid_eq, nv_eff, subframe, cfi, rnti, dci_len,
                                 ue_specific)
    return blind_hits(cands, to_host(hard), to_host(ok), dci_len)
