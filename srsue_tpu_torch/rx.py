"""The blind control + data receive chain, the 2-port TM2 data chain and
their test vectors: counterpart of ``bench.py``'s ``build_clean``,
``make_rx``, ``build_tm2`` and ``make_tm2_rx``, plus the host-made downlink of
a live cell (``build_cell_stream``) for the cold-start path
(``phy/receiver.py``).

One batch of subframes goes OFDM demod -> CRS channel estimate -> full-grid
ZF or MMSE -> PCFICH -> blind PDCCH search over every search-space
candidate (one Viterbi launch) -> PDSCH extract / equalize / demap /
dematch -> turbo decode -> TB CRC, on the device of its input and with no
host sync outside the turbo decoder's early exit. The flagship
configuration is bench.py's: 100 PRB SISO, cell 42, subframe 6, CFI 1,
RNTI 0x1234, DCI 1A on the first search-space candidate with L >= 4, PDSCH
at MCS 28 (TBS 75376, 13 blocks of K=5824). The TM2 chain takes the same
grant on a 2-port cell: two channel estimates and Alamouti combining of the
PDSCH REs, no control region. IQ is complex64 throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mac.rnti import SI_RNTI
from .phy import chest, control, dci, enb_tx, equalize, ofdm, pbch, ra
from .phy.cell import Cell, DlGrant
from .phy.pdsch import PdschCodec
from .phy.pdsch import codec as cached_codec

N_PRB, CELL_ID, SUBFRAME, CFI, RNTI, MCS = 100, 42, 6, 1, 0x1234, 28
EQS = ("zf", "mmse", "zf_scalar")
# build_cell_stream's live cell: the SI PDSCH's MCS and the subframe that
# carries the C-RNTI data
SI_MCS, DATA_SF = 3, 3


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
    codec = PdschCodec(cell, grant, rnti=RNTI, subframe=SUBFRAME, cfi=cfi,
                       device="cpu")  # the transmitter: its host tables only
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
            device: str | torch.device = "cuda"):
    """The per-TTI chain of ``bench.make_rx``: fn(iq [B, sf_len] complex64 on
    `device`, the current CUDA device unless "cpu" is given) -> stats, a
    dict of 0-dim float32 tensors: n_ok (TBs passing CRC), bit_match (share
    of payload bits equal to `expected` over the passing TBs), mean_iters
    (turbo iterations per block), n_dci (subframes whose blind search found
    `dci_bits` on a CRC-passing candidate), cfi_ok (subframes whose PCFICH
    gave `cfi`), and max_iters.

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
        return {**_tb_stats(payload, tb_ok, iters, want[: iq.shape[0]]),
                "n_dci": match.any(-1).sum().to(torch.float32),
                "cfi_ok": (cfi_dev == cfi).sum().to(torch.float32)}

    return rx


def _tb_stats(payload, tb_ok, iters, want) -> dict[str, torch.Tensor]:
    """n_ok, bit_match, mean_iters and max_iters of one decoded batch."""
    bad = ((payload != want) & tb_ok[:, None]).sum()
    f32 = torch.float32
    return {"n_ok": tb_ok.sum().to(f32),
            "bit_match": (1.0 - bad.double() / payload.numel()).to(f32),
            "mean_iters": iters.to(f32).mean(),
            "max_iters": iters.max().to(f32)}


# ---------------------------------------------------------------------------
# TM2: 2-port transmit diversity at the flagship grant
# ---------------------------------------------------------------------------


class Tm2Clean(NamedTuple):
    """Noise-free TM2 test vectors, in the order of ``bench.build_tm2``'s
    tuple less its codec (the receiver builds its own, on its device)."""

    cell: Cell
    grant: DlGrant
    subframe: int
    rnti: int
    payloads: np.ndarray      # [B, tbs] uint8
    td: np.ndarray            # [B, sf_len] complex64, both ports summed
    p_sig: float
    rng: np.random.Generator


def build_tm2(batch: int, n_distinct: int | None = None) -> Tm2Clean:
    """`batch` TM2 (SFBC, 2 ports) subframes at 20 MHz, MCS 28 over the whole
    band, CFI 1, CRS of both ports and no control region: `n_distinct` random
    transport blocks (default: one per subframe), tiled, drawn from
    ``default_rng(1)``. With the default this draws exactly what
    ``bench.build_tm2(batch)`` draws."""
    cell = Cell(n_prb=N_PRB, cell_id=CELL_ID, n_ports=2)
    grant = ra.dl_grant(cell.n_prb, MCS)
    codec = PdschCodec(cell, grant, rnti=RNTI, subframe=SUBFRAME, cfi=CFI, device="cpu")
    rng = np.random.default_rng(1)
    n_distinct = batch if n_distinct is None else n_distinct
    pls = np.stack([rng.integers(0, 2, grant.tbs).astype(np.uint8)
                    for _ in range(n_distinct)])
    tds = np.stack([np.sum(enb_tx.to_waveform(cell, enb_tx.build_pdsch_subframe(
        cell, codec, pl, tm2=True)), axis=0) for pl in pls])
    sel = np.arange(batch) % n_distinct
    td = tds[sel]
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return Tm2Clean(cell, grant, SUBFRAME, RNTI, pls[sel], td, p_sig, rng)


def make_tm2_rx(cell: Cell, grant: DlGrant, subframe: int, rnti: int,
                expected: np.ndarray, early_exit: bool, kernel: str = "r2max",
                forced: bool = False, device: str | torch.device = "cuda"):
    """The TM2 data chain of ``bench.make_tm2_rx``: fn(iq [B, sf_len]
    complex64 on `device`, the current CUDA device unless "cpu" is given) ->
    the stats of ``make_rx`` less the control fields (n_ok, bit_match,
    mean_iters, max_iters). OFDM demod, one channel estimate per port,
    Alamouti combining of the PDSCH REs, decode; `kernel`, `early_exit` and
    `forced` choose the turbo decoder's form (``PdschCodec``)."""
    codec = PdschCodec(cell, grant, rnti=rnti, subframe=subframe, cfi=CFI,
                       n_turbo_iters=8, early_exit=early_exit, device=device,
                       kernel=kernel, forced=forced)
    want = torch.as_tensor(np.asarray(expected, np.uint8), device=codec.device)

    def rx(iq: torch.Tensor) -> dict[str, torch.Tensor]:
        grid = ofdm.demodulate(cell, iq)
        h0, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        h1, _, _ = chest.estimate(cell, grid, subframe, port=1)
        x_eq, nv_eff = equalize.alamouti_combine(
            codec.extract_re(grid), codec.extract_re(h0), codec.extract_re(h1), nvar)
        payload, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
        return _tb_stats(payload, tb_ok, iters, want[: iq.shape[0]])

    return rx


# ---------------------------------------------------------------------------
# A live cell's downlink, for the cold-start path
# ---------------------------------------------------------------------------


class CellStream(NamedTuple):
    """``build_cell_stream``'s result."""

    iq: np.ndarray        # the noisy stream, complex64 at cell.srate
    si_grant: DlGrant     # the SI PDSCH's grant
    cfi: int
    data: dict            # {(frame index, subframe): C-RNTI payload bits}


def build_cell_stream(cell: Cell, n_frames: int, sib: bytes | None = None,
                      snr_db: float = 15.0, seed: int = 0, sfn0: int = 0,
                      crnti: int = 0, mcs_data: int = 8, lead: int = 0, cfo: float = 0.0,
                      port_gains: tuple = (1.0, 1.0)) -> CellStream:
    """`n_frames` radio frames of a live 1- or 2-port cell (host numpy): CRS
    of every port and PCFICH (CFI 2) in every subframe, PSS/SSS in subframes
    0 and 5, PBCH in subframe 0 (the MIB of frame sfn0 + f), DCI 1A on the
    SI-RNTI at CCE 0, L = 4 with `sib` as its PDSCH (MCS ``SI_MCS``) in subframe
    5 of even frames when `sib` is given, and with a `crnti` a DCI 1A plus a
    PDSCH of random bits (MCS `mcs_data`) in subframe ``DATA_SF``. On 2 ports
    PBCH, PCFICH, PDCCH and PDSCH are SFBC-precoded and the ports summed,
    each through its flat channel gain of `port_gains` (a weak port 0 is
    what the single-port PBCH hypothesis cannot decode).
    AWGN at `snr_db` from ``default_rng(seed)``, then a CFO of `cfo`
    subcarriers and `lead` zero samples in front. On 1 port, without lead
    and CFO, this is the downlink ``tests/test_coldstart.py`` builds, draw
    for draw."""
    rng = np.random.default_rng(seed)
    tm2 = cell.n_ports == 2
    cfi = 2
    full = dci.riv_encode(cell.n_prb, 0, cell.n_prb)
    si_grant = ra.dl_grant(cell.n_prb, SI_MCS)
    data_grant = ra.dl_grant(cell.n_prb, mcs_data)
    n_cce, _ = control.pdcch_geometry(cell, cfi)
    data, sfs = {}, []

    def send(grids, sf, rnti, grant, mcs, ndi, start, l_aggr, bits):
        """One DCI 1A and its PDSCH over the whole band."""
        d = dci.Dci1A(riv=full, mcs=mcs, harq_pid=0, ndi=ndi, rv=0, tpc=0)
        codec = cached_codec(cell, grant, rnti, sf, cfi, device="cpu")  # its host tables
        syms = codec.encode_symbols(bits)
        if tm2:
            control.pdcch_map_tm2(cell, grids, sf, cfi, dci.pack_1a(cell.n_prb, d), rnti,
                                  start, l_aggr)
            codec.map_to_grid_tm2(grids, syms)
        else:
            control.pdcch_map(cell, grids[0], sf, cfi, dci.pack_1a(cell.n_prb, d), rnti,
                              start, l_aggr)
            codec.map_to_grid(grids[0], syms)

    for f in range(n_frames):
        sfn = sfn0 + f
        for sf in range(10):
            grids = [enb_tx.empty_grid(cell) for _ in range(cell.n_ports)]
            for p, grid in enumerate(grids):
                enb_tx.add_crs(cell, grid, sf, p)
            enb_tx.add_sync(cell, grids[0], sf)
            if tm2:
                control.pcfich_map_tm2(cell, grids, sf, cfi)
            else:
                control.pcfich_map(cell, grids[0], sf, cfi)
            if crnti and sf == DATA_SF:
                start, l_aggr = [c for c in control.search_space_candidates(n_cce, crnti, sf)
                                 if c[1] >= 4][0]
                data[(f, sf)] = rng.integers(0, 2, data_grant.tbs).astype(np.uint8)
                send(grids, sf, crnti, data_grant, mcs_data, True, start, l_aggr,
                     data[(f, sf)])
            if sf == 0:
                cw = pbch.encode(cell, pbch.Mib(cell.n_prb, "normal", 1.0, sfn),
                                 n_ports=cell.n_ports)
                syms = pbch.frame_symbols(cell, cw, sfn % 4)
                if tm2:
                    pbch.map_to_grid_tm2(cell, grids, syms)
                else:
                    pbch.map_to_grid(cell, grids[0], syms)
            if sf == 5 and sfn % 2 == 0 and sib is not None:
                bits = np.zeros(si_grant.tbs, np.uint8)
                pb = np.unpackbits(np.frombuffer(sib, np.uint8))
                bits[: len(pb)] = pb
                send(grids, sf, SI_RNTI, si_grant, SI_MCS, False, 0, 4, bits)
            tds = enb_tx.to_waveform(cell, grids)
            sfs.append(tds[0] if not tm2 else sum(
                np.complex64(g) * td for g, td in zip(port_gains, tds)))
    td = np.concatenate(sfs)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    iq = enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0]
    if cfo:
        iq = (iq * np.exp(2j * np.pi * cfo * np.arange(len(iq)) / cell.nfft)).astype(np.complex64)
    if lead:
        iq = np.concatenate([np.zeros(lead, np.complex64), iq])
    return CellStream(iq, si_grant, cfi, data)
