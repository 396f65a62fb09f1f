"""The receive frontends as CUDA graphs: ``UeDl.front_end`` (OFDM demod,
the CRS estimate of each port, ZF or the SFBC control combining, the
channel metrics), ``pdsch.equalized`` (OFDM demod, port 0's CRS estimate,
the PDSCH RE extract, ZF), and the uplink's two stages in ``phy/pusch.py``
(the front end: OFDM demod, each allocation's DMRS estimate and ZF, the
IDFTs; the demap: each UE's UCI LLRs and demap kernel launches) are chains
of 20-350 small operations, none of which reads a value back to the host,
so at a small batch, or with several allocations, the host's dispatch of
each sets their time. On a card ``run`` replays such a chain as one CUDA
graph once its key comes back, by the rule of ``utils.graphs.GraphCache``
(the turbo loop's); a key's first call runs eagerly, and the CPU never
comes here.
"""

from __future__ import annotations

import torch

from ..utils import graphs
from ..utils.trace import annotate


def _clone(out):
    """A copy of every tensor of a tuple, named tuple, list or dict of
    tensors (None kept)."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if hasattr(out, "_fields"):
        return type(out)(*map(_clone, out))
    return type(out)(_clone(v) for v in out)


class _Replayed:
    """`body` captured as one CUDA graph at its inputs' shapes and dtypes.

    A call copies its inputs into the static inputs, replays the graph and
    returns clones of the outputs, so a result a caller holds never changes
    under a later replay, whoever makes it. ``holds`` are the device tables
    the body reads, kept as long as the graph: the caches they came from
    may drop them, and a dropped table must not be freed under a live
    graph. They are fetched just before the capture, so the capture finds
    them cached and copies nothing from the host. (cuFFT's plans live in
    torch's plan cache, which holds thousands; the port uses a handful of
    sizes.) A replay counts the kernel launches its capture listed
    (``graphs.replay``). ``bytes``: the static inputs and the outputs the
    graph writes."""

    def __init__(self, body, xs: tuple, dev: torch.device, tables, pool, stream):
        self.device = dev
        self.holds = tables()
        before = torch.cuda.memory_allocated(dev)
        self.xs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in xs)
        self.graph = torch.cuda.CUDAGraph()

        def capture():
            self.out = body(*self.xs)

        with annotate("frontend.graph_capture"), torch.cuda.device(dev):
            self.launches = graphs.capture(self.graph, pool, stream, capture)
        self.bytes = torch.cuda.memory_allocated(dev) - before

    def __call__(self, *xs: torch.Tensor):
        with annotate("frontend.graph_replay"):
            for static, x in zip(self.xs, xs, strict=True):
                static.copy_(x)
            graphs.replay(self.graph, self.launches)
            return _clone(self.out)


def run(key: tuple, body, xs: tuple, dev: torch.device, tables):
    """``body(*xs)`` on the card `dev`: eagerly at the key's first call, then
    replayed as one CUDA graph (``_Replayed``).

    key: everything ``body``'s launches depend on but the inputs' shapes and
    dtypes (the cell, the subframe, the tables it reads), led by the body's
    name. xs: the tensors ``body`` takes, in order, each on `dev` or in host
    memory, whence a replay copies it straight into its static input.
    tables: a function returning the device tables ``body`` reads, called
    before a capture."""
    full = key + (dev,) + tuple(a for t in xs for a in (tuple(t.shape), t.dtype))
    replayed = graphs.GRAPHS.get(full, dev, lambda pool, stream: _Replayed(
        body, xs, dev, tables, pool, stream))
    if replayed is None:
        return body(*(t.to(dev) for t in xs))
    return replayed(*xs)
