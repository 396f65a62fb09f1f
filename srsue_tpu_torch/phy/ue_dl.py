"""UE downlink subframe processor: OFDM demod -> channel estimate ->
equalization -> PCFICH -> PDCCH blind search -> PDSCH decode -> metrics.
Counterpart of ``srsue_tpu/phy/ue_dl.py``. A 1-port cell (TM1) is
zero-forced; a 2-port cell (TM2) takes the transmit-diversity chain: both
ports estimated, the control region SFBC-combined
(``control.sfbc_equalize_control``) and the PDSCH REs Alamouti-combined.

A [batch] axis of independent subframes rides through every stage. The
stages run eagerly on the device of the input with cached codecs and
tables. Control decisions surface to the host between stages, as at the
PHY -> MAC boundary: the CFI (one sync) and the blind-search hits (one per
DCI format searched). Each stage is a span (``utils.trace.SPANS``) under
``ue_dl.process`` while a profiler records. On a card the front end
replays as one CUDA graph at a recurring cell, subframe and input shape
(``phy/frontend.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve, to_host
from ..utils.trace import annotate
from . import chest, control, dci, equalize, frontend, ofdm
from .cell import Cell, DlGrant
from .pdsch import codec as get_codec


@dataclass
class DlResult:
    """MAC-facing per-TTI result (the `tb_decoded` + metrics payload)."""

    payload: np.ndarray | None  # [batch, tbs] bits or None if no grant
    tb_ok: np.ndarray | None
    turbo_iters: np.ndarray | None
    cfi: int
    grants: list  # DL grants found in batch element 0 (all formats)
    metrics: dict
    # per-batch-element blind-search hits: [(format, dci_obj), ...]
    hits_per_elem: list = None
    # every grant of element 0 decoded: [(grant, payload, tb_ok, iters)]
    decoded: list = None


class UeDl:
    """Per-cell DL receiver on `device` (the current CUDA device by
    default), with codecs cached per grant."""

    def __init__(self, cell: Cell, n_turbo_iters: int = 8,
                 device: str | torch.device = "cuda"):
        if cell.n_ports not in (1, 2):
            raise ValueError(f"UeDl: {cell.n_ports}-port cells are not supported")
        self.cell = cell
        self.n_turbo_iters = n_turbo_iters
        self.device = resolve(device)

    def _iq(self, iq) -> torch.Tensor:
        return torch.as_tensor(iq, dtype=torch.complex64, device=self.device)

    # --- stage 1: front end ----------------------------------------------
    def _front_end(self, iq, subframe: int):
        """(grid, channel estimate of each port, noise, equalized grid, its
        noise, channel metrics) of iq [..., sf_len]. On a card the whole
        chain is replayed as one CUDA graph once this cell, subframe and
        input shape come back (``frontend.run``); a host array is then
        copied straight into the graph's input."""
        with annotate("ue_dl.frontend"):
            if self.device.type != "cuda":
                return self._front_end_ops(self._iq(iq), subframe)
            x = self._iq(iq) if torch.is_tensor(iq) else torch.as_tensor(iq, dtype=torch.complex64)
            return frontend.run(("ue_dl.front_end", self.cell, subframe),
                                lambda x: self._front_end_ops(x, subframe), x, self.device,
                                lambda: self._tables(subframe))

    def _front_end_ops(self, iq: torch.Tensor, subframe: int):
        cell = self.cell
        grid = ofdm.demodulate(cell, iq)
        hs, nvar, rsrp = self._estimate(grid, subframe)
        if len(hs) == 2:
            g_eq, nv_eff = control.sfbc_equalize_control(cell, grid, hs[0], hs[1], nvar)
        else:
            g_eq, nv_eff = equalize.zf(grid, hs[0], nvar)
        return grid, hs, nvar, g_eq, nv_eff, chest.metrics(cell, grid, nvar, rsrp)

    def _tables(self, subframe: int) -> list:
        """The device tables ``_front_end_ops`` reads."""
        tables = [chest.device_tables(self.cell, p, subframe, self.device)
                  for p in range(self.cell.n_ports)]
        if self.cell.n_ports == 2:
            tables.append(control.control_region_index(self.cell, self.device))
        return tables

    def _estimate(self, grid: torch.Tensor, subframe: int):
        """(channel estimate of each port, port 0's noise and RSRP)."""
        h, nvar, rsrp = chest.estimate(self.cell, grid, subframe, port=0)
        if self.cell.n_ports == 2:
            return (h, chest.estimate(self.cell, grid, subframe, port=1)[0]), nvar, rsrp
        return (h,), nvar, rsrp

    # --- stage 2: grant-known PDSCH chain --------------------------------
    def _pdsch_chain(self, grid, hs, nvar, grant: DlGrant, rnti: int, subframe: int,
                     cfi: int):
        with annotate("ue_dl.pdsch"):
            codec = get_codec(self.cell, grant, rnti, subframe, cfi, self.n_turbo_iters,
                              self.device)
            y = codec.extract_re(grid)
            if len(hs) == 2:
                x_eq, nv_eff = equalize.alamouti_combine(
                    y, codec.extract_re(hs[0]), codec.extract_re(hs[1]), nvar)
            else:
                x_eq, nv_eff = equalize.zf(y, codec.extract_re(hs[0]), nvar)
            payload, tb_ok, _, iters = codec.decode(x_eq, nv_eff)
            with annotate("ue_dl.to_host"):
                return to_host(payload), to_host(tb_ok), to_host(iters)

    def decode_pdsch(self, iq, grant: DlGrant, rnti: int, subframe: int, cfi: int = 1):
        """Grant-known batched PDSCH decode: [batch, sf_len] IQ ->
        (payload [batch, tbs], tb_ok [batch], iters [batch, C]) on the host."""
        grid = ofdm.demodulate(self.cell, self._iq(iq))
        hs, nvar, _ = self._estimate(grid, subframe)
        return self._pdsch_chain(grid, hs, nvar, grant, rnti, subframe, cfi)

    # --- stage 3: blind search (all elements, all formats) -----------------
    def _blind_search(self, g_eq, nv_eff, subframe: int, cfi: int, rnti: int,
                      ue_specific: bool, formats: tuple) -> dict:
        """{format: (hard, ok)}: one batched search (one Viterbi launch) per
        DCI size, over every candidate and batch element."""
        with annotate("ue_dl.blind_search"):
            return {f: control.pdcch_blind_batch(self.cell, g_eq, nv_eff, subframe, cfi, rnti,
                                                 self._dci_len(f), ue_specific=ue_specific)
                    for f in formats}

    def _dci_len(self, fmt: str) -> int:
        n_rb = self.cell.n_prb
        return {"0_1a": dci.size_0_1a(n_rb), "1": dci.size_1(n_rb),
                "1c": dci.size_1c(n_rb)}[fmt]

    def _unpack(self, fmt: str, bits: np.ndarray):
        if fmt == "0_1a":
            return dci.unpack_0_1a(self.cell.n_prb, bits)
        if fmt == "1":
            return dci.unpack_1(self.cell.n_prb, bits)
        return dci.unpack_1c(self.cell.n_prb, bits)

    def _to_dl_grant(self, d):
        if isinstance(d, dci.Dci1A):
            return dci.dci1a_to_grant(self.cell, d)
        if isinstance(d, dci.Dci1):
            return dci.dci1_to_grant(self.cell, d)
        if isinstance(d, dci.Dci1C):
            return dci.dci1c_to_grant(self.cell, d)
        return None

    # --- full control + data subframe processing ---------------------------
    def process(self, iq, subframe: int, rnti: int, ue_specific: bool = True,
                formats: tuple = ("0_1a",)) -> DlResult:
        """Process one (batch of) subframe(s): PCFICH -> batched PDCCH blind
        search over all batch elements and DCI formats -> PDSCH decode of
        every DL grant found in element 0, for the whole batch.

        formats: DCI sizes to blind-search: "0_1a" always; add "1" for the
        TM1/TM2 C-RNTI search, "1c" for SI/P/RA-RNTI."""
        cell = self.cell
        with annotate("ue_dl.process"):
            grid, hs, nvar, g_eq, nv_eff, m = self._front_end(iq, subframe)
            with annotate("ue_dl.control"):
                with annotate("ue_dl.pcfich"):
                    cfi_dev, _ = control.pcfich_decode(cell, g_eq, nv_eff, subframe)
                    cfi = int(to_host(cfi_dev).reshape(-1)[0])

                raw = self._blind_search(g_eq, nv_eff, subframe, cfi, rnti, ue_specific,
                                         tuple(formats))
                with annotate("ue_dl.blind_hits"):
                    batched = g_eq.ndim == 3
                    n_batch = g_eq.shape[0] if batched else 1
                    n_cce, _ = control.pdcch_geometry(cell, cfi)
                    cands = control.search_space_candidates(n_cce, rnti, subframe, ue_specific)
                    hits_per_elem: list[list] = [[] for _ in range(n_batch)]
                    for f in formats:
                        hard, ok = (to_host(x) for x in raw[f])
                        if not batched:
                            hard, ok = hard[None], ok[None]
                        n = self._dci_len(f)
                        for b in range(n_batch):
                            for _, _, bits in control.blind_hits(cands, hard[b], ok[b], n):
                                hits_per_elem[b].append((f, self._unpack(f, bits)))

            grants = [g for g in (self._to_dl_grant(d) for _, d in hits_per_elem[0])
                      if g is not None]
            with annotate("ue_dl.metrics"):
                metrics = {k: to_host(v) for k, v in m.items()}
            if not grants:
                return DlResult(None, None, None, cfi, [], metrics,
                                hits_per_elem=hits_per_elem, decoded=[])
            decoded = [(g,) + self._pdsch_chain(grid, hs, nvar, g, rnti, subframe, cfi)
                       for g in grants]
            _, payload, tb_ok, iters = decoded[0]
            return DlResult(payload, tb_ok, iters, cfi, grants, metrics,
                            hits_per_elem=hits_per_elem, decoded=decoded)
