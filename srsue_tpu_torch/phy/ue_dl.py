"""UE downlink subframe processor: OFDM demod -> channel estimate ->
equalization -> PCFICH -> PDCCH blind search -> PDSCH decode -> metrics.
Counterpart of ``srsue_tpu/phy/ue_dl.py``. A 1-port cell (TM1) is
zero-forced; a 2-port cell (TM2) takes the transmit-diversity chain: both
ports estimated, the control region SFBC-combined
(``control.sfbc_equalize_control``) and the PDSCH REs Alamouti-combined.

The stages are the UE's one downlink receiver: ``process`` is
``front_end``, ``cfi``, ``search`` and each grant's ``equalize_pdsch`` and
decode, and the UE's ``Phy.work`` runs each subframe through the same
stages, handing the equalized PDSCH to the MAC's HARQ.

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
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve, to_host
from ..utils.trace import annotate
from . import chest, control, dci, equalize, frontend, ofdm, pdsch
from .cell import Cell, DlGrant


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


class Front(NamedTuple):
    """What ``UeDl.front_end`` gives, on the device, batched as its IQ."""

    grid: torch.Tensor    # [..., n_sym_sf, n_sc] resource grid
    hs: tuple             # the channel estimate of each port, grid-shaped
    nvar: torch.Tensor    # port 0's noise
    g_eq: torch.Tensor    # the grid zero-forced, or SFBC-combined over the control region
    nv_eff: torch.Tensor  # g_eq's noise
    metrics: dict         # ``chest.metrics``: RSSI, RSRQ, SNR, RSRP, noise


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
    def front_end(self, iq, subframe: int) -> Front:
        """The front end of iq [..., sf_len] (a batch or one subframe). On
        a card the whole chain is replayed as one CUDA graph once this
        cell, subframe and input shape come back (``frontend.run``); a host
        array is then copied straight into the graph's input."""
        with annotate("ue_dl.frontend"):
            if self.device.type != "cuda":
                return self._front_end_ops(self._iq(iq), subframe)
            x = self._iq(iq) if torch.is_tensor(iq) else torch.as_tensor(iq, dtype=torch.complex64)
            return frontend.run(("ue_dl.front_end", self.cell, subframe),
                                lambda x: self._front_end_ops(x, subframe), (x,), self.device,
                                lambda: self._tables(subframe))

    def _front_end_ops(self, iq: torch.Tensor, subframe: int) -> Front:
        cell = self.cell
        grid = ofdm.demodulate(cell, iq)
        h, nvar, rsrp = chest.estimate(cell, grid, subframe, port=0)
        if cell.n_ports == 2:
            hs = (h, chest.estimate(cell, grid, subframe, port=1)[0])
            g_eq, nv_eff = control.sfbc_equalize_control(cell, grid, h, hs[1], nvar)
        else:
            hs = (h,)
            g_eq, nv_eff = equalize.zf(grid, h, nvar)
        return Front(grid, hs, nvar, g_eq, nv_eff, chest.metrics(cell, grid, nvar, rsrp))

    def _tables(self, subframe: int) -> list:
        """The device tables ``_front_end_ops`` reads."""
        tables = [chest.device_tables(self.cell, p, subframe, self.device)
                  for p in range(self.cell.n_ports)]
        if self.cell.n_ports == 2:
            tables.append(control.control_region_index(self.cell, self.device))
        return tables

    # --- stage 2: control ---------------------------------------------------
    def cfi(self, g_eq, nv_eff, subframe: int) -> int:
        """The CFI of (the first) subframe from its PCFICH: one host read."""
        with annotate("ue_dl.pcfich"):
            cfi_dev, _ = control.pcfich_decode(self.cell, g_eq, nv_eff, subframe)
            return int(to_host(cfi_dev).reshape(-1)[0])

    def search(self, g_eq, nv_eff, subframe: int, cfi: int, rnti: int,
               ue_specific: bool = True, formats: tuple = ("0_1a",)) -> list[list]:
        """Blind search for `rnti` in each DCI format of `formats` ("0_1a",
        "1", "1c"): for each batch element (one for an unbatched grid) its
        hits [(format, start CCE, L, payload bits)], format by format, each
        in ``control.blind_hits``' order. One batched search (one Viterbi
        launch) per format over every candidate and element, all launched
        before the first host read. An empty search space gives no hits."""
        hits: list[list] = [[] for _ in range(g_eq.shape[0] if g_eq.ndim == 3 else 1)]
        n_prb = self.cell.n_prb
        with annotate("ue_dl.blind_search"):
            n_cce, _ = control.pdcch_geometry(self.cell, cfi)
            cands = control.search_space_candidates(n_cce, rnti, subframe, ue_specific)
            raw = {f: control.pdcch_blind_batch(self.cell, g_eq, nv_eff, subframe, cfi, rnti,
                                                dci.size(n_prb, f), ue_specific=ue_specific)
                   for f in (formats if cands else ())}
        with annotate("ue_dl.blind_hits"):
            for f, (hard, ok) in raw.items():
                # one read a format: the CRC flags ride as the payloads' last column
                both = to_host(torch.cat([hard, ok[..., None]], -1))
                both = both.reshape((-1,) + both.shape[-2:])  # an unbatched grid: a batch of one
                found = control.blind_hits(cands, both[..., :-1], both[..., -1], hard.shape[-1])
                for elem, elem_hits in zip(hits, found, strict=True):
                    elem.extend((f, start, l, bits) for start, l, bits in elem_hits)
        return hits

    # --- stage 3: grant-known PDSCH chain --------------------------------
    def codec(self, grant: DlGrant, rnti: int, subframe: int, cfi: int) -> pdsch.PdschCodec:
        """The grant's cached codec (``pdsch.codec``), one entry whichever
        facade asks."""
        return pdsch.codec(self.cell, grant, rnti, subframe, cfi, self.n_turbo_iters,
                           self.device)

    def equalize_pdsch(self, front: Front, codec: pdsch.PdschCodec):
        """(x_eq, nv_eff) of the codec's PDSCH REs in `front`: ZF on 1 port,
        Alamouti combining on 2."""
        y = codec.extract_re(front.grid)
        hs = [codec.extract_re(h) for h in front.hs]
        if len(hs) == 2:
            return equalize.alamouti_combine(y, hs[0], hs[1], front.nvar)
        return equalize.zf(y, hs[0], front.nvar)

    def _pdsch_chain(self, front: Front, grant: DlGrant, rnti: int, subframe: int, cfi: int):
        with annotate("ue_dl.pdsch"):
            codec = self.codec(grant, rnti, subframe, cfi)
            payload, tb_ok, _, iters = codec.decode(*self.equalize_pdsch(front, codec))
            with annotate("ue_dl.to_host"):
                return to_host(payload), to_host(tb_ok), to_host(iters)

    def decode_pdsch(self, iq, grant: DlGrant, rnti: int, subframe: int, cfi: int = 1):
        """Grant-known batched PDSCH decode: [batch, sf_len] IQ ->
        (payload [batch, tbs], tb_ok [batch], iters [batch, C]) on the host."""
        return self._pdsch_chain(self.front_end(iq, subframe), grant, rnti, subframe, cfi)

    # --- full control + data subframe processing ---------------------------
    def process(self, iq, subframe: int, rnti: int, ue_specific: bool = True,
                formats: tuple = ("0_1a",)) -> DlResult:
        """Process one (batch of) subframe(s): PCFICH -> batched PDCCH blind
        search over all batch elements and DCI formats -> PDSCH decode of
        every DL grant found in element 0, for the whole batch.

        formats: DCI sizes to blind-search: "0_1a" always; add "1" for the
        TM1/TM2 C-RNTI search, "1c" for SI/P/RA-RNTI."""
        n_prb = self.cell.n_prb
        with annotate("ue_dl.process"):
            front = self.front_end(iq, subframe)
            with annotate("ue_dl.control"):
                cfi = self.cfi(front.g_eq, front.nv_eff, subframe)
                hits = self.search(front.g_eq, front.nv_eff, subframe, cfi, rnti, ue_specific,
                                   tuple(formats))
                with annotate("ue_dl.dci"):
                    # one unpack a format over the batch, dealt back in the hits' order
                    dcis = {f: iter(dci.unpack_rows(n_prb, f, [b for elem in hits
                                                               for g, _, _, b in elem if g == f]))
                            for f in formats}
                    hits_per_elem = [[(f, next(dcis[f])) for f, *_ in elem] for elem in hits]

            grants = [g for g in (dci.to_dl_grant(self.cell, d) for _, d in hits_per_elem[0])
                      if g is not None]
            with annotate("ue_dl.metrics"):
                metrics = {k: to_host(v) for k, v in front.metrics.items()}
            if not grants:
                return DlResult(None, None, None, cfi, [], metrics,
                                hits_per_elem=hits_per_elem, decoded=[])
            decoded = [(g,) + self._pdsch_chain(front, g, rnti, subframe, cfi) for g in grants]
            _, payload, tb_ok, iters = decoded[0]
            return DlResult(payload, tb_ok, iters, cfi, grants, metrics,
                            hits_per_elem=hits_per_elem, decoded=decoded)
