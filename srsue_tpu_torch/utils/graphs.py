"""CUDA graphs replayed at a repeated input shape: the one cache policy of
the port's graphs (``turbo.decode``'s loop, the receive frontends of
``phy/frontend.py``), with its graph pools, capture stream and memory
budget.

A caller keys its work by everything the captured launches depend on and
asks ``GRAPHS.get(key, device, make)``: None the first time a key is seen
(the caller runs eagerly), the graphs ``make(pool, stream)`` captures when
the key comes back, and those graphs after. Nothing here runs on the CPU:
callers ask only for CUDA tensors.

The hand-written kernels' wrappers count their launches through
``count_launch``: a capture launches nothing, so ``capture`` lists the
launches its body made and ``replay`` counts that list again at each
replay, whatever kernel a graph holds.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch


def memory(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).total_memory


def new_pool(dev: torch.device):
    """A private graph memory pool on `dev`."""
    with torch.cuda.device(dev):
        return torch.cuda.graph_pool_handle()


@functools.lru_cache(maxsize=None)
def capture_stream(dev: torch.device):
    """The one side stream of `dev` that every capture runs on: cuBLAS
    keeps a workspace for each stream it ran on, so one stream keeps one."""
    return torch.cuda.Stream(dev)


_listed: list | None = None  # the kernel launches of the capture in progress


def count_launch(tally, shape) -> None:
    """Count one kernel launch at `shape` by `tally(shape)` (a wrapper's own
    counter), or list it while a capture is in progress."""
    if _listed is None:
        tally(shape)
    else:
        _listed.append((tally, shape))


@contextlib.contextmanager
def listing():
    """Inside, ``count_launch`` counts nothing and lists each launch as
    (tally, shape)."""
    global _listed
    saved, _listed = _listed, []
    try:
        yield _listed
    finally:
        _listed = saved


def capture(graph, pool, stream, body) -> list:
    """Capture `body` into `graph` on `stream`, its memory from `pool`;
    returns the kernel launches it listed (``listing``), which ``replay``
    counts. ``torch.cuda.graph`` would first synchronise the device and
    empty the allocator's cache, which a capture does not need: every
    allocation after it would go back to ``cudaMalloc``. thread_local:
    another thread's CUDA calls (NCCL's watchdog) do not break the
    capture."""
    with torch.cuda.stream(stream), listing() as launches:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
    return launches


def replay(graph, launches: list) -> None:
    """Replay `graph` and count the kernel launches its capture listed."""
    graph.replay()
    for tally, shape in launches:
        tally(shape)


class GraphCache:
    """The keys asked for on the cards, with the graphs of those that
    recurred. A key is a tuple of everything a caller's captured work
    depends on (its device, input shape and dtype, and the tables and
    configuration it reads), led by its caller: a frontend's body name, the
    turbo loop's device; two callers' keys never compare equal. The graphs
    help only a caller whose input shape repeats: a UE whose grant stays the
    same from TTI to TTI, a receiver cycling the ten subframes of one cell,
    a batch of a fixed shape.

    A key holding graphs replays them; a key held without them (waiting)
    captures them, since its shape came back; any other key runs eagerly
    and waits, among its caller's last ``SIZE`` waiting keys: past those
    the least recently seen is dropped. So a shape seen once, or coming back
    only after more than ``SIZE`` others of its caller, never pays a
    capture, and one caller's keys seen once neither drop graphs nor shorten
    another caller's window. With one LRU of every key, the eNB's uplink
    receive at B=1 on grants drawn anew each TTI (``bench_ul_grants``: two
    uplink keys a TTI besides the turbo's) re-captured its turbo shapes 97
    times in 1,000 TTIs against 1 without the uplink's keys; with a window
    a caller, as often as without them (4-11 on three seeds). A device
    holds the graphs of at most ``SIZE`` keys, within ``1 / SHARE`` of its
    memory (each graph's ``bytes``: its static inputs, state and outputs): a
    capture past either drops the least recently used keys holding graphs,
    of any caller. On seeded grant sequences at B=1 (``bench_turbo_graph``;
    PERF.md) a turbo capture costs two to four eager calls and a replay an
    eighth of one, and a smaller ``SIZE`` was never faster: where every
    grant is drawn anew (238 shapes in 2,000 TTIs) a ``SIZE`` of 4 to 64 made
    decoding up to 35% slower than the eager path and never more than 4%
    faster, by captures whose graphs were dropped before their shape came
    back, and 256 made it 37-45% faster. So ``SIZE`` holds every shape a 20
    MHz UE decodes and the ten subframes of its frontend, and memory bounds
    large graphs before the count does: a turbo shape at B=1 holds at most a
    few MB, the largest the port decodes (B=256 x 13 blocks of K=5824) 0.65
    GB, a frontend at B=256 0.1-0.3 GB, so about seven of the largest fit a
    sixteenth of an 80 GB card. The first capture on a device also holds
    cuBLAS's workspace for the capture stream (32 MB).

    Memory: every graph of a device, turbo loop and frontend alike,
    captures into one private pool on one side stream of that device, so
    the pool holds each cached key's live tensors and one key's scratch,
    not a scratch a key. Sharing is safe because the graphs of a device
    replay one caller's call at a time, in stream order, and each call
    rewrites every pool tensor it reads before reading it (a turbo call's
    prep graph writes all the state its iteration graph reads; a frontend
    call's one graph computes everything from its static input) and clones
    its results out before it returns: another key's graph may reuse this
    one's scratch, state and outputs between two calls, never within one.
    The static inputs and the clones are outside the pool. Once every graph
    of a pool has been dropped the allocator refuses further captures into
    it, so the next capture takes a fresh pool.
    """

    SIZE = 256
    SHARE = 16

    def __init__(self):
        self.keys: collections.OrderedDict = collections.OrderedDict()  # key -> graphs | None
        self.waiting: dict = {}  # caller -> its keys without graphs, least recently seen first
        self.pools: dict = {}  # device -> graph pool

    def get(self, key, dev: torch.device, make):
        """The graphs of `key` on `dev`, captured now by `make(pool,
        stream)` if the key is held without them; None (run eagerly) if
        the key is not held. What `make` returns has ``device`` and
        ``bytes``."""
        if key not in self.keys:
            self.keys[key] = None
            waiting = self.waiting.setdefault(key[0], collections.OrderedDict())
            waiting.pop(key, None)
            waiting[key] = None
            if len(waiting) > self.SIZE:
                self.keys.pop(waiting.popitem(last=False)[0], None)
            return None
        self.keys.move_to_end(key)
        if self.keys[key] is None:
            self.waiting[key[0]].pop(key, None)
            if not self._holding(dev):
                self.pools[dev] = new_pool(dev)
            self.keys[key] = make(self.pools[dev], capture_stream(dev))
            held = self._holding(dev)
            while held[0] != key and (len(held) > self.SIZE or sum(
                    self.keys[h].bytes for h in held) > memory(dev) // self.SHARE):
                del self.keys[held.pop(0)]
        return self.keys[key]

    def _holding(self, dev) -> list:
        """The keys holding graphs on `dev`, least recently used first."""
        return [h for h, g in self.keys.items() if g is not None and g.device == dev]


GRAPHS = GraphCache()
