"""The port's spans and the device profiler's exporter: counterpart of
``srsue_tpu/utils/trace.py``'s ``XlaTrace`` and ``annotate``.

``annotate(name)`` is a named host span on ``torch.profiler``'s timeline,
the clock of the device trace: ``torch.profiler.record_function`` while a
profiler records, and otherwise one shared no-op context, which adds no
sync, no CUDA event and no allocation. Spans live in the profiler's memory
and go out with its trace. ``SPANS`` names every span the receive path
records (``Phy.work`` records the frontend and control stages' spans
too, without ``ue_dl.process``, ``ue_dl.control`` and ``ue_dl.dci``;
``rx.make_rx`` records ``ue_dl.frontend`` and ``ue_dl.control`` as roots);
``turbo.exit_check``, ``turbo.graph_capture``, the frontends' and the
uplink stages' ``frontend.graph_capture`` and ``frontend.graph_replay``, and
the uplink's ``pusch.idft_group`` (opened where its front end runs on the
host: eagerly or in a capture, not in a replay) and ``pusch.k_group`` are
also counters (spans counted per step).

``ProfilerTrace`` stands in for the reference's ``XlaTrace`` (jax.profiler)
with the same contract: ``logdir``, ``active``, an ``errors`` list, and a
trace written into ``logdir``; here a Chrome trace by ``torch.profiler``,
which records the CUDA kernels when a GPU is present.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# every span of the receive path; a child sits inside its parent's interval
SPANS = (
    "ue_dl.process",         # UeDl.process, the whole call (root)
    "ue_dl.frontend",        # OFDM, CRS estimate(s), ZF or SFBC control combining, metrics;
                             # in rx.make_rx (a root there) OFDM and the CRS estimate
    "ue_dl.control",         # PCFICH to the unpacked hits of every batch element; in
                             # rx.make_rx (a root there) equalization, PCFICH, search, match
    "ue_dl.pcfich",          # control's child: PCFICH decode and the CFI read
    "ue_dl.blind_search",    # control's child: the batched search, its Viterbi launches
    "ue_dl.blind_hits",      # control's child: hard bits and flags read, hits selected
    "ue_dl.dci",             # control's child: every hit's DCI unpacked, one call a format
    "ue_dl.metrics",         # the channel metrics' host reads
    "ue_dl.pdsch",           # one grant's PDSCH chain
    "ue_dl.to_host",         # ue_dl.pdsch's child: payload, flags and iterations read
    "pdsch.frontend",        # the grant-known frontend (pdsch.equalized)
    "frontend.graph_capture",  # counter: a frontend's or uplink stage's capture as one CUDA graph
    "frontend.graph_replay",   # counter: its replay of the graph, copies in and out
    "pdsch.demap_dematch",   # every K-group's demap kernel
    "pdsch.turbo",           # the turbo driver over every K-group
    "turbo.iteration",       # one pass of a turbo loop
    "turbo.exit_check",      # counter: the early exit's host sync
    "turbo.graph_capture",   # counter: a shape's capture of the masked loop as CUDA graphs
    "pdsch.tb_crc",          # the TB CRC
    "shard.exchange",        # shard_decode's all_reduce through its check on the host
    "pusch.frontend",        # equalize_sf, PuschCell.dematch: OFDM, DMRS estimates, ZF, the IDFTs
    "pusch.idft_group",      # counter: one IDFT over the allocations of one size (eager, capture)
    "pusch.demap_dematch",   # the UCI symbols' LLRs and every K-group's demap kernel
    "pusch.turbo",           # decode_softbuffers: each K-group's stack and turbo.decode
    "pusch.k_group",         # counter: one turbo.decode over one K's blocks of every UE
    "pusch.uci",             # the CQI's and ACK's decode, per subframe or over the call
)

_NOOP = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """A named host span in the profiler's timeline while a profiler
    records (``torch.profiler.record_function``); otherwise the shared
    no-op context. Whether one records is asked at each call."""
    return torch.profiler.record_function(name) if _recording() else _NOOP


class ProfilerTrace:
    """Device-level profiling by ``torch.profiler`` (CPU ops, and CUDA
    kernels when a GPU is present): the counterpart of the reference's
    ``XlaTrace``.

    with ProfilerTrace("/tmp/prof") as t: run_things()
    # t.path: the Chrome trace written into logdir, spans included

    A profiler that cannot start or stop leaves its message in `errors`
    instead of raising, as ``XlaTrace`` does.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.active = False
        self.errors: list[str] = []
        self.path: str | None = None
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self.active = True
        except RuntimeError as e:  # profiler unsupported on this runtime
            self.errors.append(f"torch profiler unavailable: {e}")
        return self

    def __exit__(self, *exc):
        if self.active:
            try:
                self._prof.__exit__(None, None, None)
                os.makedirs(self.logdir, exist_ok=True)
                self.path = os.path.join(self.logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
                self._prof.export_chrome_trace(self.path)
            except (RuntimeError, OSError) as e:
                self.errors.append(f"torch profiler stop failed: {e}")
            self.active = False
        return False
