"""The plain reference of the blind control + data chain, ``rx.make_rx``: one
receive of a batch of downlink subframes that reads every subframe's
control and decodes the configured grant's PDSCH. Composed of
``receiver.Receiver``'s stages:

- OFDM demodulation and the CRS estimate, ZF at the REs each stage reads;
- each subframe's CFI from its PCFICH;
- the blind search of DCI 0/1A over the UE-specific space at the configured
  CFI (the candidate set ``make_rx`` searches), and whether it found the
  cell's DCI 1A among the CRC-passing candidates;
- the configured grant's PDSCH with the forced 8 turbo iterations.
"""

from __future__ import annotations

import numpy as np

from .lte import dci, ra
from .lte.pdsch import PdschMap
from .receiver import Decoded, Receiver, exact
from .transmitter import dci_1a


def decode(ref: Receiver, iq, q=exact) -> Decoded:
    """iq [n, sf_len] -> the payloads, CRC flags, iterations and softbuffers
    of the configured grant (forced), with ``cfi`` each subframe's CFI [n]
    and ``hits`` whether each subframe's search found the DCI [n]."""
    cfg, cell = ref.cfg, ref.cell
    grid, hs, noise, _ = ref._front(iq, q)

    def eq(res):
        return ref._equalize(grid, hs, noise, res, q)

    cfi = ref._pcfich(eq)
    want = dci.unpack_0_1a(cell.n_prb, dci_1a(cell, cfg["mcs"]))
    found = ref._blind(eq, cfg["cfi"], q)
    pmap = PdschMap(cell, ra.dl_grant(cell.n_prb, cfg["mcs"]), ref.rnti, ref.sf, cfg["cfi"])
    out = ref._pdsch(grid, hs, noise, pmap, True, q)
    out.cfi = cfi
    out.hits = np.array([any(d == want for d in row) for row in found], bool)
    return out
