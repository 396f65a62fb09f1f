"""The one cache of the port's CUDA graphs (``utils/graphs.py``) as the turbo
driver and the receive frontends (``phy/frontend.py``) use it, on the CPU
with stand-ins for the captures: what a frontend's key holds (the uplink's
too: by value, so codecs built alike share graphs), the turbo's and the
frontends' keys in one LRU and one memory budget, and the tables a capture
holds. The CPU frontends and uplink receivers run the operations they ran
before the graphs, and never enter the cache. The card's side is in
``tests/test_torch_cuda.py``. Imports no JAX."""

import numpy as np
import pytest
import torch

from srsue_tpu_torch.phy import chest, control, equalize, frontend, ofdm, pdsch, pusch
from srsue_tpu_torch.phy.cell import Cell, UlGrant
from srsue_tpu_torch.phy.pdsch import PdschCodec
from srsue_tpu_torch.phy.ra import dl_grant
from srsue_tpu_torch.phy.ue_dl import UeDl
from srsue_tpu_torch.utils import graphs

CPU = torch.device("cpu")


@pytest.fixture
def cache(monkeypatch):
    """A fresh cache whose captures are stand-ins: a frontend's records its
    tables and runs its body eagerly at each call; the pools count up."""
    made = []

    class Fake:
        def __init__(self, body, xs, dev, tables, pool, stream):
            self.device, self.pool, self.bytes = dev, pool, sum(x.numel() for x in xs)
            self.body, self.holds = body, tables()
            made.append(self)

        def __call__(self, *xs):
            return self.body(*(x.to(self.device) for x in xs))

    pools = iter(range(1, 100))
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    monkeypatch.setattr(graphs, "new_pool", lambda dev: next(pools))
    monkeypatch.setattr(graphs, "capture_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "memory", lambda dev: 1 << 40)
    monkeypatch.setattr(frontend, "_Replayed", Fake)
    return made


def _run(key, x, body=lambda x: (x * 2, {"m": x.sum()}), tables=lambda: ["table"]):
    return frontend.run(key, body, (x,), CPU, tables)


def test_one_replay_counts_every_kernel_its_capture_launched(monkeypatch):
    """A capture lists the launches of whichever hand-written kernels its
    body made (``graphs.listing``) and counts none; each ``graphs.replay``
    counts them in each kernel's own counters."""
    from srsue_tpu_torch.kernels import bcjr, demap, viterbi

    monkeypatch.setattr(bcjr, "launches", dict.fromkeys(bcjr.launches, 0))
    monkeypatch.setattr(bcjr, "shapes", {name: set() for name in bcjr.launches})
    for module, names in ((demap, ("launches", "llr_launches")), (viterbi, ("launches",))):
        for name in names:
            monkeypatch.setattr(module, name, 0)
        monkeypatch.setattr(module, "shapes", set())
    with graphs.listing() as launches:
        bcjr._count("r2max", (6, 64))
        graphs.count_launch(demap._tally, ("softbuffer", 4, 3, 256, 18444))
        graphs.count_launch(demap._tally, ("llr", 2, 0, 256, 96))
        graphs.count_launch(viterbi._tally, (4, 40))
    assert (bcjr.launches["r2max"], demap.launches, viterbi.launches) == (0, 0, 0)

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    graph = Graph()
    for _ in range(2):
        graphs.replay(graph, launches)
    assert graph.replays == 2
    assert (bcjr.launches["r2max"], demap.launches, demap.llr_launches, viterbi.launches) == (
        2, 4, 2, 2)
    assert bcjr.shapes["r2max"] == {(6, 64)} and viterbi.shapes == {(4, 40)}
    assert demap.shapes == {("softbuffer", 4, 3, 256, 18444), ("llr", 2, 0, 256, 96)}


def test_frontend_key_holds_the_input_shape_and_dtype(cache):
    """A key's first call runs eagerly, its second captures (the tables
    fetched then), later ones replay; another shape, dtype or caller's key
    is another key."""
    x = torch.arange(6, dtype=torch.float32).to(torch.complex64)
    outcomes = []
    for key, xi in [(("a", 1), x), (("a", 1), x), (("a", 1), x), (("a", 2), x),
                    (("a", 1), x[None]), (("a", 1), x.to(torch.complex128)), (("b", 1), x),
                    (("a", 1), x + 1)]:
        n = len(cache)
        out, stats = _run(key, xi)
        torch.testing.assert_close(out, xi * 2, rtol=0, atol=0)
        outcomes.append("capture" if len(cache) > n else
                        "replay" if graphs.GRAPHS.keys[key + (CPU, tuple(xi.shape), xi.dtype)]
                        else "eager")
    assert outcomes == ["eager", "capture", "replay", "eager", "eager", "eager", "eager",
                        "replay"]
    assert [g.holds for g in cache] == [["table"]]
    assert list(graphs.GRAPHS.keys)[-1] == ("a", 1, CPU, (6,), torch.complex64)


def test_turbo_and_frontend_keys_share_one_lru(cache, monkeypatch):
    """The turbo driver's keys and the frontends' share one cache, each
    caller's waiting keys in a window of its own ``SIZE``: a frontend key
    that comes back after ``SIZE`` turbo keys captures, one that comes back
    after ``SIZE`` other keys of its frontend runs eagerly again. Their keys
    holding graphs are one LRU (the budget's, below)."""
    monkeypatch.setattr(graphs.GraphCache, "SIZE", 3)
    x = torch.ones(2, dtype=torch.complex64)

    class Turbo:
        def __init__(self, pool, stream):
            self.device, self.bytes = CPU, 0

    def turbo_key(i):  # the form of turbo.decode's keys
        return (CPU, (1, 3, 44), torch.float32, 40, 40, "r2max", (40, 24 + i))

    _run(("f", 0), x)
    for i in range(3):
        assert graphs.GRAPHS.get(turbo_key(i), CPU, Turbo) is None
    _run(("f", 0), x)
    assert len(cache) == 1  # the turbo keys waited in their own window
    for i in range(1, 5):
        _run(("f", i), x)
    _run(("f", 1), x)
    assert len(cache) == 1  # dropped by the frontend's own keys: eager again
    graphs.GRAPHS.get(turbo_key(2), CPU, Turbo)
    assert isinstance(graphs.GRAPHS.keys[turbo_key(2)], Turbo)


def test_budget_drops_least_recently_used_frontend_graphs(cache, monkeypatch):
    """Frontend and turbo graphs count against one ``1 / SHARE`` of the
    card: a capture past it drops the least recently used keys holding
    graphs, of either caller, never itself."""
    monkeypatch.setattr(graphs, "memory", lambda dev: graphs.GraphCache.SHARE * 100)
    x40 = torch.ones(40, dtype=torch.complex64)

    class Turbo:
        def __init__(self, pool, stream):
            self.device, self.bytes = CPU, 30

    for key in (("f", 1), ("f", 2)):
        _run(key, x40)
        _run(key, x40)
    assert [g.bytes for g in cache] == [40, 40]
    for _ in range(2):
        graphs.GRAPHS.get("turbo", CPU, Turbo)  # 110 bytes: ("f", 1) goes
    held = [k for k, g in graphs.GRAPHS.keys.items() if g is not None]
    assert held == [("f", 2, CPU, (40,), torch.complex64), "turbo"]
    _run(("f", 2), x40)
    _run(("f", 1), x40)  # eager: its key went with its graphs
    assert len(cache) == 2


def _old_sfbc_equalize_control(cell, grid, h0, h1, nvar):
    """``control.sfbc_equalize_control`` as it was before its REG table was
    cached on the device: the table copied in at each call."""
    idx = torch.as_tensor(control._control_region_idx(cell), device=grid.device)
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


def _old_front_end(cell, iq, subframe):
    """``UeDl.front_end`` as it was before its CUDA graph."""
    grid = ofdm.demodulate(cell, iq)
    h, nvar, rsrp = chest.estimate(cell, grid, subframe, port=0)
    hs = (h,) if cell.n_ports == 1 else (h, chest.estimate(cell, grid, subframe, port=1)[0])
    if len(hs) == 2:
        g_eq, nv_eff = _old_sfbc_equalize_control(cell, grid, hs[0], hs[1], nvar)
    else:
        g_eq, nv_eff = equalize.zf(grid, hs[0], nvar)
    return grid, hs, nvar, g_eq, nv_eff, chest.metrics(cell, grid, nvar, rsrp)


# operations that compute nothing: views, aliases and the host table's wrap
_NO_WORK = {"aten::as_strided", "aten::view", "aten::reshape", "aten::slice", "aten::select",
            "aten::unsqueeze", "aten::expand", "aten::alias", "aten::narrow", "aten::flatten",
            "aten::lift_fresh", "aten::to", "aten::real", "aten::view_as_real",
            "aten::_reshape_alias", "aten::detach", "aten::squeeze", "aten::unbind"}


def _ops(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events() if e.name.startswith("aten::")
                 and e.name not in _NO_WORK]


def _flat(out):
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    return [t for v in out for t in _flat(v)]


@pytest.mark.parametrize("ports,batch", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_cpu_frontends_run_the_ops_they_ran_before(cache, ports, batch):
    """On the CPU ``UeDl.front_end`` and ``pdsch.equalized`` compute what
    they computed before the graphs, bit for bit, with the same operations
    in the same order, and enter nothing into the cache."""
    cell = Cell(n_prb=6, cell_id=42, n_ports=ports)
    sf = 6
    rng = np.random.default_rng(ports * 10 + batch)
    shape = (batch, cell.sf_len) if batch > 1 else (cell.sf_len,)
    iq = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ue = UeDl(cell, device="cpu")
    ue.front_end(iq, sf)  # the tables cached, as in the old call's steady state
    new, new_ops = _ops(lambda: ue.front_end(iq, sf))
    old, old_ops = _ops(lambda: _old_front_end(cell, torch.as_tensor(iq), sf))
    assert new_ops == old_ops and len(new_ops) > 100
    for a, b in zip(_flat(new), _flat(old), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    if ports == 1:
        codec = PdschCodec(cell, dl_grant(cell.n_prb, 9), 0x1234, sf, 2, device="cpu")
        x = torch.as_tensor(iq)
        new, new_ops = _ops(lambda: pdsch.equalized(cell, codec, sf, x))
        old, old_ops = _ops(lambda: pdsch._equalized(cell, codec, sf, x))
        assert new_ops == old_ops and len(new_ops) > 50
        for a, b in zip(new, old, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cache == [] and not graphs.GRAPHS.keys


def test_re_key_is_the_re_map():
    """``equalized``'s graphs are keyed by the codec's RE map: equal for
    codecs that extract the same REs (another MCS, or the same tables
    given), another for another allocation or CFI."""
    cell = Cell(n_prb=6, cell_id=42)

    def key(mcs=9, n_prb=6, cfi=2):
        return PdschCodec(cell, dl_grant(cell.n_prb, mcs, n_prb_alloc=n_prb), 0x1234, 6, cfi,
                          device="cpu").re_key

    a = PdschCodec(cell, dl_grant(6, 9), 0x1234, 6, 2, device="cpu")
    b = PdschCodec.from_arrays(cell, a.grant, a.re_idx, a.rm_idx, a.scr_pm1, a.blk_crc,
                               a.tb_crc, device="cpu")
    assert key() == key(mcs=20) == a.re_key == b.re_key
    assert len({key(), key(n_prb=4), key(cfi=3)}) == 3


def test_two_port_tables_hold_the_control_region():
    """A 2-port frontend's capture holds both ports' CRS tables and the
    control region's REG index on the device, which the combining reads
    from its cache instead of copying it from the host each call."""
    cell = Cell(n_prb=6, cell_id=42, n_ports=2)
    tables = UeDl(cell, device="cpu")._tables(6)
    assert tables[:2] == [chest.device_tables(cell, p, 6, CPU) for p in (0, 1)]
    idx = control.control_region_index(cell, CPU)
    assert tables[2] is idx and idx is control.control_region_index(cell, CPU)
    np.testing.assert_array_equal(idx.numpy(), control._control_region_idx(cell))
    assert len(UeDl(Cell(n_prb=6, cell_id=42), device="cpu")._tables(6)) == 1


def test_clone_copies_every_output():
    """A replay's results are copies: a tuple of a tuple, a tensor and a
    dict keep their form, and no tensor is the graph's own."""
    out = (torch.ones(2), (torch.zeros(1), torch.ones(1)), {"a": torch.ones(3)})
    got = frontend._clone(out)
    assert type(got[1]) is tuple and set(got[2]) == {"a"}
    for a, b in zip(_flat(got), _flat(out), strict=True):
        assert a.data_ptr() != b.data_ptr()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------------- the uplink
# two UEs in a 25 PRB subframe: (n_prb, prb_start, qm, tbs, cyclic shift, CQI bits)
UL_UES = ((12, 1, 4, 4968, 0, 4), (6, 13, 2, 600, 6, 0))


def _ul_rx(ues=UL_UES, rv=0, ack_syms=4, cqi_rep=2):
    """A ``PuschCell`` of `ues` on the CPU, each with its ACK."""
    cell = Cell(n_prb=25, cell_id=301)
    codecs = [pusch.PuschCodec(cell, UlGrant(n, start, 0, qm, tbs, rv), 0x1234 + i, 2,
                               n_cqi_bits=cqi, with_ack=True, cqi_rep=cqi_rep,
                               ack_syms=ack_syms, device="cpu")
              for i, (n, start, qm, tbs, _, cqi) in enumerate(ues)]
    return pusch.PuschCell(cell, codecs, [ue[4] for ue in ues])


def _ul_iq(batch=2, seed=5):
    rng = np.random.default_rng(seed)
    n = Cell(n_prb=25, cell_id=301).sf_len
    return torch.as_tensor((rng.standard_normal((batch, n)) + 1j * rng.standard_normal(
        (batch, n))).astype(np.complex64))


@pytest.fixture
def card_keys(cache, monkeypatch):
    """The uplink's stages take the card's branch on the CPU (the stand-in
    captures run their bodies); returns a function of a receive call that
    gives the keys it entered, in order, and its result."""
    monkeypatch.setattr(pusch, "_graphed", lambda codecs, noise_var=None: True)

    def keys(call):
        before = list(graphs.GRAPHS.keys)
        out = call()
        return [k for k in graphs.GRAPHS.keys if k not in before], out
    return keys


@pytest.mark.parametrize("receiver", ["codec", "cell"])
def test_uplink_codecs_built_alike_share_graphs(card_keys, cache, receiver):
    """An eNB builds a ``PuschCodec`` a TTI: a second receiver built alike
    enters no key of its own and captures the two graphs (front end, demap)
    of the first one's keys, a third replays them; each gives the eager
    softbuffers and, from its own codecs, the UCI."""
    iq = _ul_iq()

    def call(rx):
        if receiver == "codec":
            c = rx.codecs[0]
            return lambda: ([c.dematch_sf(iq, 1e-3, rx.cyclic_shifts[0])], [c._uci(False)])
        return lambda: (rx.dematch(iq, 1e-3), rx.decode_uci_sf())

    keys, eager = card_keys(call(_ul_rx()))
    assert [k[0] for k in keys] == ["pusch.frontend", "pusch.demap_dematch"] and not cache
    for _ in range(2):  # the capture, then a replay
        new, got = card_keys(call(_ul_rx()))
        assert new == [] and len(cache) == 2
        for a, b in zip(_flat(got), _flat(eager), strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert list(graphs.GRAPHS.keys) == keys


# each change, and which of the two stages' keys it changes
UL_CHANGES = {
    "cyclic shift": ({"ues": ((12, 1, 4, 4968, 3, 4), UL_UES[1])}, "frontend"),
    "noise": ({"noise": 2e-3}, "frontend"),
    "rv": ({"rv": 2}, "both"),
    "CQI bits": ({"ues": ((12, 1, 4, 4968, 0, 6), UL_UES[1])}, "both"),
    "CQI repetition": ({"cqi_rep": 3}, "both"),
    "ACK symbols": ({"ack_syms": 8}, "both"),
    "allocation": ({"ues": ((12, 0, 4, 4968, 0, 4), UL_UES[1])}, "both"),
    "batch": ({"batch": 3}, "both"),
}


@pytest.mark.parametrize("change", list(UL_CHANGES))
def test_uplink_key_holds_what_the_launches_read(card_keys, change):
    """Another cyclic shift or noise changes the front end's key; another
    rv, UCI layout, allocation or batch shape both, since the front end keys
    on the whole receive."""
    over = dict(UL_CHANGES[change][0])
    batch, noise = over.pop("batch", 2), over.pop("noise", 1e-3)
    base, _ = card_keys(lambda: _ul_rx().dematch(_ul_iq(), 1e-3))
    other, _ = card_keys(lambda: _ul_rx(**over).dematch(_ul_iq(batch), noise))
    assert [k[0] for k in other] == {"frontend": ["pusch.frontend"],
                                     "both": ["pusch.frontend", "pusch.demap_dematch"]}[
        UL_CHANGES[change][1]]
    assert not set(other) & set(base)


def _old_dematch(codec, syms, nv):
    """(per-block softbuffers, UCI LLRs): ``_dematch`` with each K-group
    split into its blocks, as it was before the graphs."""
    groups, llrs = codec._dematch(syms, nv)
    return [b for g in groups for b in g.unbind(-2)], llrs


def _old_ul_codec(codec, iq, noise_var, cs):
    """``PuschCodec.dematch_sf`` as it was before its graphs."""
    syms, nv = pusch._equalize([codec], ofdm.demodulate(codec.cell, iq), noise_var, [cs])[0]
    return [_old_dematch(codec, syms, nv)]


def _old_ul_cell(rx, iq, noise_var):
    """``PuschCell.dematch`` as it was before its graphs."""
    eq = pusch._equalize(rx.codecs, ofdm.demodulate(rx.cell, iq), noise_var, rx.cyclic_shifts)
    return [_old_dematch(c, syms, nv) for c, (syms, nv) in zip(rx.codecs, eq)]


@pytest.mark.parametrize("receiver", ["codec", "cell"])
@pytest.mark.parametrize("batch", [1, 3])
def test_cpu_uplink_runs_the_ops_it_ran_before(cache, receiver, batch):
    """On the CPU ``PuschCodec.dematch_sf`` and ``PuschCell.dematch`` run the
    operations they ran before the graphs, in the same order, and give the
    same softbuffers and UCI LLRs bit for bit; nothing enters the cache."""
    iq = _ul_iq(batch)[0] if batch == 1 else _ul_iq(batch)
    rx = _ul_rx()
    if receiver == "codec":
        codecs = rx.codecs[:1]
        new_call = lambda: [codecs[0].dematch_sf(iq, 1e-3, rx.cyclic_shifts[0])]  # noqa: E731
        old_call = lambda: _old_ul_codec(codecs[0], iq, 1e-3, rx.cyclic_shifts[0])  # noqa: E731
    else:
        codecs = rx.codecs
        new_call, old_call = lambda: rx.dematch(iq, 1e-3), lambda: _old_ul_cell(rx, iq, 1e-3)
    new_call()  # the DMRS tables cached, as in the old call's steady state
    new, new_ops = _ops(new_call)
    new_llrs = [c._last_uci_llrs for c in codecs]
    old, old_ops = _ops(old_call)
    assert new_ops == old_ops and len(new_ops) > 20
    for a, b in zip(_flat([new, new_llrs]), _flat([[o[0] for o in old], [o[1] for o in old]]),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cache == [] and not graphs.GRAPHS.keys


@pytest.mark.parametrize("kind,recurred", [("fixed", (0.98, 1.0)), ("drawn", (0.0, 0.05))])
def test_ul_grant_sequences_recur_as_described(kind, recurred):
    """``bench_ul_grants``' fixed sequence comes back every 10 TTIs and its
    drawn one seldom; every grant makes a codec whose UCI fits."""
    from srsue_tpu_torch import bench_ul_grants as bench

    grants = bench._grants(kind, 500, np.random.default_rng(2**31 + 11))
    share = bench._recurred(grants)
    assert recurred[0] <= share <= recurred[1]
    if kind == "fixed":
        assert share == (500 - 10) / 500
    for grant, sf, cqi, ack in grants[:40]:
        pusch.PuschCodec(bench.CELL, grant, bench.RNTI, sf, n_cqi_bits=cqi, with_ack=ack,
                         device="cpu")
