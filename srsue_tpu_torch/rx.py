"""The blind control + data receive chain: counterpart of ``bench.py``'s
``build_clean`` and ``make_rx``.

One batch of subframes goes OFDM demod -> CRS channel estimate -> full-grid
ZF or MMSE -> PCFICH -> blind PDCCH search over every search-space
candidate (one Viterbi launch) -> PDSCH extract / equalize / demap /
dematch -> turbo decode -> TB CRC, on the device of its input and with no
host sync outside the turbo decoder's early exit. The flagship
configuration is bench.py's: 100 PRB SISO, cell 42, subframe 6, CFI 1,
RNTI 0x1234, DCI 1A on the first search-space candidate with L >= 4, PDSCH
at MCS 28 (TBS 75376, 13 blocks of K=5824). IQ is complex64 throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srsue_tpu.phy.cell import Cell, DlGrant

from .phy import chest, control, dci, enb_tx, equalize, ofdm, ra
from .phy.pdsch import PdschCodec

N_PRB, CELL_ID, SUBFRAME, CFI, RNTI, MCS = 100, 42, 6, 1, 0x1234, 28
EQS = ("zf", "mmse", "zf_scalar")


class Clean(NamedTuple):
    """Noise-free test vectors, in the order of ``bench.build_clean``'s tuple."""

    cell: Cell
    grant: DlGrant
    subframe: int
    cfi: int
    rnti: int
    dci_bits: np.ndarray      # the DCI 1A payload
    payloads: np.ndarray      # [B, tbs] uint8
    td: np.ndarray            # [B, sf_len] complex64
    p_sig: float              # signal power per used subcarrier
    rng: np.random.Generator  # the generator, for the noise


def build_clean(batch: int, cell: Cell | None = None, mcs: int = MCS,
                n_distinct: int | None = None, cfi: int = CFI) -> Clean:
    """`batch` subframes of CRS + PCFICH (`cfi`) + PDCCH (DCI 1A for RNTI) +
    PDSCH at `mcs` over the whole band: `n_distinct` random transport blocks
    (default: one per subframe), tiled, drawn from ``default_rng(0)``. With
    the defaults this draws exactly what ``bench.build_clean(batch)`` draws."""
    cell = cell or Cell(n_prb=N_PRB, cell_id=CELL_ID)
    grant = ra.dl_grant(cell.n_prb, mcs)
    codec = PdschCodec(cell, grant, rnti=RNTI, subframe=SUBFRAME, cfi=cfi)
    d = dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, cell.n_prb), mcs=mcs,
                  harq_pid=0, ndi=True, rv=0, tpc=0)
    dci_bits = dci.pack_1a(cell.n_prb, d)
    n_cce, _ = control.pdcch_geometry(cell, cfi)
    cands = control.search_space_candidates(n_cce, RNTI, SUBFRAME)
    start, l_aggr = [c for c in cands if c[1] >= 4][0]

    rng = np.random.default_rng(0)
    n_distinct = batch if n_distinct is None else n_distinct
    pls = np.stack([rng.integers(0, 2, grant.tbs).astype(np.uint8)
                    for _ in range(n_distinct)])
    tds = np.stack([enb_tx.to_waveform(cell, [enb_tx.build_dl_subframe(
        cell, codec, pl, cfi, dci_bits, RNTI, start, l_aggr)])[0] for pl in pls])
    sel = np.arange(batch) % n_distinct
    td = tds[sel]
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return Clean(cell, grant, SUBFRAME, cfi, RNTI, dci_bits, pls[sel], td, p_sig, rng)


def add_noise(rng: np.random.Generator, td: np.ndarray, p_sig: float,
              snr_db: float) -> np.ndarray:
    return enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0]


def _equalizer(eq: str):
    if eq not in EQS:
        raise ValueError(f"eq must be one of {EQS}, got {eq!r}")
    return equalize.mmse if eq == "mmse" else equalize.zf


def control_stage(cell: Cell, subframe: int, cfi: int, rnti: int, dci_len: int,
                  eq: str = "zf"):
    """fn(grid, h, nvar) -> (cfi [B], hard [B, n_cand, dci_len], ok [B,
    n_cand]): full-grid equalization, PCFICH and the blind search of one
    DCI size (the CFI of the search is the configured one, as in
    bench.py)."""
    eq_fn = _equalizer(eq)

    def run(grid: torch.Tensor, h: torch.Tensor, nvar: torch.Tensor):
        g_eq, nv_grid = eq_fn(grid, h, nvar)
        cfi_dev, _ = control.pcfich_decode(cell, g_eq, nv_grid, subframe)
        hard, ok = control.pdcch_blind_batch(cell, g_eq, nv_grid, subframe, cfi, rnti,
                                             dci_len)
        return cfi_dev, hard, ok

    return run


def make_rx(cell: Cell, grant: DlGrant, subframe: int, cfi: int, rnti: int,
            dci_bits: np.ndarray, expected: np.ndarray, early_exit: bool,
            eq: str = "zf", kernel: str = "r2max", forced: bool = False,
            device: str | torch.device = "cpu"):
    """The per-TTI chain of ``bench.make_rx``: fn(iq [B, sf_len] complex64 on
    `device`) -> stats, a dict of 0-dim float32 tensors: n_ok (TBs passing
    CRC), bit_match (share of payload bits equal to `expected` over the
    passing TBs), mean_iters (turbo iterations per block), n_dci (subframes
    whose blind search found `dci_bits` on a CRC-passing candidate), cfi_ok
    (subframes whose PCFICH gave `cfi`), and max_iters.

    eq: "zf" | "mmse" (per-RE noise-weighted demap) | "zf_scalar" (ZF with
    the noise averaged over the allocation before the demap). `kernel`,
    `early_exit` and `forced` choose the turbo decoder's form
    (``PdschCodec``)."""
    codec = PdschCodec(cell, grant, rnti=rnti, subframe=subframe, cfi=cfi,
                       n_turbo_iters=8, early_exit=early_exit, device=device,
                       kernel=kernel, forced=forced)
    dev = codec.device
    eq_fn = _equalizer(eq)
    ctrl = control_stage(cell, subframe, cfi, rnti, dci.size_0_1a(cell.n_prb), eq)
    exp_dci = torch.as_tensor(np.asarray(dci_bits, np.uint8), device=dev)
    want = torch.as_tensor(np.asarray(expected, np.uint8), device=dev)

    def rx(iq: torch.Tensor) -> dict[str, torch.Tensor]:
        grid = ofdm.demodulate(cell, iq)
        h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        cfi_dev, hard, ok = ctrl(grid, h, nvar)
        match = (hard == exp_dci).all(-1) & ok
        x_eq, nv_eff = eq_fn(codec.extract_re(grid), codec.extract_re(h), nvar)
        if eq == "zf_scalar":
            nv_eff = nv_eff.mean(-1, keepdim=True).expand_as(nv_eff)
        payload, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
        bad = ((payload != want[: iq.shape[0]]) & tb_ok[:, None]).sum()
        f32 = torch.float32
        return {"n_ok": tb_ok.sum().to(f32),
                "bit_match": (1.0 - bad.double() / payload.numel()).to(f32),
                "mean_iters": iters.to(f32).mean(),
                "n_dci": match.any(-1).sum().to(f32),
                "cfi_ok": (cfi_dev == cfi).sum().to(f32),
                "max_iters": iters.max().to(f32)}

    return rx
