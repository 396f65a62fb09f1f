"""The port's spans (``utils/trace.py``'s ``annotate`` and ``SPANS``) on the
CPU: the span tree of ``UeDl.process`` on 6 PRB TM1 and TM2 subframes from
the port's own transmitter (on the card too, with the turbo loop's capture as
CUDA graphs), the same stages' spans in the UE's ``Phy.work``, the blind
chain ``rx.make_rx``'s, the turbo loops' iteration and exit-check counts, the shared no-op with no profiler running, ``shard_decode``'s
exchange on each of two gloo ranks, and results that do not change while
spans record. Imports no JAX: the spawned ranks import this module."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from srsue_tpu_torch import rx
from srsue_tpu_torch.parallel import mesh
from srsue_tpu_torch.phy import control, dci, enb_tx, pdsch, pusch, turbo
from srsue_tpu_torch.phy.cell import Cell, UlGrant
from srsue_tpu_torch.phy.pdsch import PdschCodec
from srsue_tpu_torch.phy.phy import Phy
from srsue_tpu_torch.phy.ra import dl_grant
from srsue_tpu_torch.phy.ue_dl import UeDl
from srsue_tpu_torch.utils import graphs, trace

PACKAGE = Path(__file__).resolve().parent.parent / "srsue_tpu_torch"
# a 6 PRB carrier, CFI 3, C-RNTI 0x1234 granted the whole band at MCS 20 by a
# DCI 1A on CCE 0 with L=4, 8 turbo iterations, AWGN 26 dB
CFG = {"n_prb": 6, "cell_id": 42, "subframe": 6, "cfi": 3, "rnti": 0x1234, "mcs": 20,
       "turbo_iters": 8, "snr_db": 26.0}
PORTS = {"tm1": 1, "tm2": 2}
# UeDl.process's spans with one grant decoded, and each one's enclosing span
PARENT = {"ue_dl.process": None, "ue_dl.frontend": "ue_dl.process",
          "ue_dl.control": "ue_dl.process", "ue_dl.pcfich": "ue_dl.control",
          "ue_dl.blind_search": "ue_dl.control", "ue_dl.blind_hits": "ue_dl.control",
          "ue_dl.dci": "ue_dl.control",
          "ue_dl.metrics": "ue_dl.process", "ue_dl.pdsch": "ue_dl.process",
          "ue_dl.to_host": "ue_dl.pdsch", "pdsch.demap_dematch": "ue_dl.pdsch",
          "pdsch.turbo": "ue_dl.pdsch", "turbo.iteration": "pdsch.turbo",
          "turbo.exit_check": "pdsch.turbo", "pdsch.tb_crc": "ue_dl.pdsch"}


def _cell(tm: str) -> Cell:
    return Cell(n_prb=CFG["n_prb"], cell_id=CFG["cell_id"], n_ports=PORTS[tm])


def _iq(tm: str, batch: int = 2, seed: int = 41) -> torch.Tensor:
    """`batch` noisy subframes, each with its own transport block: CRS of
    every port, PCFICH, the DCI and the PDSCH (SFBC over both ports in TM2)."""
    cell, sf, cfi, rnti = _cell(tm), CFG["subframe"], CFG["cfi"], CFG["rnti"]
    codec = PdschCodec(cell, dl_grant(cell.n_prb, CFG["mcs"]), rnti, sf, cfi, device="cpu")
    bits = dci.pack_1a(cell.n_prb, dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, cell.n_prb),
                                             mcs=CFG["mcs"], harq_pid=0, ndi=True, rv=0, tpc=0))
    rng = np.random.default_rng(seed)
    tds = []
    for _ in range(batch):
        grids = [enb_tx.empty_grid(cell) for _ in range(cell.n_ports)]
        for p, grid in enumerate(grids):
            enb_tx.add_crs(cell, grid, sf, p)
        syms = codec.encode_symbols(rng.integers(0, 2, codec.grant.tbs).astype(np.uint8))
        if cell.n_ports == 2:
            control.pcfich_map_tm2(cell, grids, sf, cfi)
            control.pdcch_map_tm2(cell, grids, sf, cfi, bits, rnti, 0, 4)
            codec.map_to_grid_tm2(grids, syms)
        else:
            control.pcfich_map(cell, grids[0], sf, cfi)
            control.pdcch_map(cell, grids[0], sf, cfi, bits, rnti, 0, 4)
            codec.map_to_grid(grids[0], syms)
        tds.append(np.sum(enb_tx.to_waveform(cell, grids), axis=0))
    td = np.stack(tds)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return torch.as_tensor(enb_tx.awgn(rng, td, CFG["snr_db"], signal_power=p_sig)[0])


def _span_events(path: str) -> list[dict]:
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _parent(e: dict, events: list[dict]):
    """The name of the innermost other span of e's thread that holds e."""
    holders = [a for a in events if a is not e and a["tid"] == e["tid"]
               and a["ts"] <= e["ts"] and e["ts"] + e["dur"] <= a["ts"] + a["dur"]]
    return min(holders, key=lambda a: a["dur"])["name"] if holders else None


def _recorded(fn, tmp_path):
    with trace.ProfilerTrace(str(tmp_path / "prof")) as t:
        out = fn()
    assert t.errors == []
    return out, _span_events(t.path)


def _process(tm: str, iq: torch.Tensor):
    ue = UeDl(_cell(tm), n_turbo_iters=CFG["turbo_iters"], device="cpu")
    return ue.process(iq, CFG["subframe"], CFG["rnti"])


@pytest.mark.parametrize("tm", ["tm1", "tm2"])
def test_process_span_tree(tm, tmp_path):
    """Every stage of one call under its root, the control layer's four
    children inside ``ue_dl.control``; one exit check after each iteration
    but the last (the one that passes where the loop stopped early)."""
    res, events = _recorded(lambda: _process(tm, _iq(tm)), tmp_path)
    assert res.tb_ok is not None and res.tb_ok.all()
    names = [e["name"] for e in events]
    assert set(names) == set(PARENT) and set(names) <= set(trace.SPANS)
    for e in events:
        assert _parent(e, events) == PARENT[e["name"]], e["name"]
    for name in ("ue_dl.process", "ue_dl.control", "ue_dl.pdsch", "pdsch.turbo"):
        assert names.count(name) == 1, name

    n = CFG["turbo_iters"]
    codec = pdsch.codec(_cell(tm), res.grants[0], CFG["rnti"], CFG["subframe"], res.cfi, n,
                        "cpu")
    runs = [int(res.turbo_iters[:, first:first + count].max())
            for _, first, count, *_ in codec.groups]
    assert names.count("turbo.iteration") == sum(runs)
    assert names.count("turbo.exit_check") == sum(min(r, n - 1) for r in runs)


# rx.make_rx's spans and each one's enclosing span: its front end and control
# stage are roots beside the PDSCH codec's own
RX_PARENT = {"ue_dl.frontend": None, "ue_dl.control": None, "pdsch.demap_dematch": None,
             "pdsch.turbo": None, "turbo.iteration": "pdsch.turbo",
             "turbo.exit_check": "pdsch.turbo", "pdsch.tb_crc": None}


def test_make_rx_span_tree(tmp_path):
    """The blind chain records its front end, then its control stage (PCFICH,
    the search and the DCI match), then the PDSCH's spans, each once, and
    finds the DCI and the TB of every subframe."""
    cell = _cell("tm1")
    bits = dci.pack_1a(cell.n_prb, dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, cell.n_prb),
                                             mcs=CFG["mcs"], harq_pid=0, ndi=True, rv=0, tpc=0))
    fn = rx.make_rx(cell, dl_grant(cell.n_prb, CFG["mcs"]), CFG["subframe"], CFG["cfi"],
                    CFG["rnti"], bits, early_exit=True, device="cpu")
    out, events = _recorded(lambda: fn(_iq("tm1")), tmp_path)
    assert out["dci_hit"].all() and out["tb_ok"].all() and (out["cfi"] == CFG["cfi"]).all()
    names = [e["name"] for e in events]
    assert set(names) <= set(RX_PARENT) and set(names) <= set(trace.SPANS)
    for e in events:
        assert _parent(e, events) == RX_PARENT[e["name"]], e["name"]
    roots = [n for n in names if n in ("ue_dl.frontend", "ue_dl.control", "pdsch.demap_dematch",
                                       "pdsch.turbo")]
    assert roots == ["ue_dl.frontend", "ue_dl.control", "pdsch.demap_dematch", "pdsch.turbo"]


@pytest.mark.parametrize("tm", ["tm1", "tm2"])
def test_phy_work_runs_the_ue_dl_stages(tm, tmp_path):
    """The UE's ``Phy.work`` on one subframe with a DCI 1A for its C-RNTI
    runs ``UeDl``'s stages: the front end and the PCFICH once, one blind
    search of format 0/1A and one of format 1, and the DCI's grant goes to
    the PDSCH decode; it is no ``UeDl.process``."""
    cell = _cell(tm)
    p = Phy(cell, device="cpu")
    p.crnti = CFG["rnti"]
    grants = []
    decode = p._decode_dlsch
    p._decode_dlsch = lambda *a: (grants.append(a[4]), decode(*a))
    _, events = _recorded(lambda: p.work(CFG["subframe"], _iq(tm, batch=1)[0].numpy()),
                          tmp_path)
    names = [e["name"] for e in events]
    assert {"ue_dl.frontend", "ue_dl.pcfich", "ue_dl.blind_search", "ue_dl.blind_hits"} \
        <= set(names) and "ue_dl.process" not in names
    assert names.count("ue_dl.frontend") == names.count("ue_dl.pcfich") == 1
    assert names.count("ue_dl.blind_search") == names.count("ue_dl.blind_hits") == 2
    assert grants == [dl_grant(cell.n_prb, CFG["mcs"])]


def test_dci_span_inside_control_and_silent_without_a_profiler(tmp_path, monkeypatch):
    """``ue_dl.dci``, the batch's DCI unpack, is a span of SPANS, recorded
    once a call inside ``ue_dl.control``; with no profiler running no span
    opens."""
    assert "ue_dl.dci" in trace.SPANS
    iq = _iq("tm1")
    _, events = _recorded(lambda: _process("tm1", iq), tmp_path)
    dci_spans = [e for e in events if e["name"] == "ue_dl.dci"]
    assert len(dci_spans) == 1 and _parent(dci_spans[0], events) == "ue_dl.control"
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    assert _process("tm1", iq).hits_per_elem[0]
    assert opened == []


@pytest.mark.parametrize("tm", ["tm1", "tm2"])
def test_results_unchanged_while_spans_record(tm, tmp_path):
    iq = _iq(tm)
    plain = _process(tm, iq)
    rec, events = _recorded(lambda: _process(tm, iq), tmp_path)
    assert events
    for a, b in ((plain.payload, rec.payload), (plain.tb_ok, rec.tb_ok),
                 (plain.turbo_iters, rec.turbo_iters)):
        np.testing.assert_array_equal(a, b)
    assert plain.cfi == rec.cfi and plain.grants == rec.grants
    assert plain.hits_per_elem == rec.hits_per_elem
    for k in plain.metrics:
        np.testing.assert_array_equal(plain.metrics[k], rec.metrics[k])


@pytest.mark.cuda
def test_graph_capture_inside_pdsch_turbo(tmp_path, monkeypatch):
    """On the card the second call at a shape captures the turbo loop, one
    ``turbo.graph_capture`` span a K-group inside ``pdsch.turbo``; the third
    replays and records none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    iq = _iq("tm1").cuda()
    ue = UeDl(_cell("tm1"), n_turbo_iters=CFG["turbo_iters"], device="cuda")
    run = lambda: ue.process(iq, CFG["subframe"], CFG["rnti"])  # noqa: E731
    first = run()
    second, events = _recorded(run, tmp_path / "second")
    third, later = _recorded(run, tmp_path / "third")
    caps = [e for e in events if e["name"] == "turbo.graph_capture"]
    n_groups = len(pdsch.codec(_cell("tm1"), first.grants[0], CFG["rnti"], CFG["subframe"],
                               first.cfi, CFG["turbo_iters"], "cpu").groups)
    assert len(caps) == n_groups
    assert all(_parent(e, events) == "pdsch.turbo" for e in caps)
    assert "turbo.graph_capture" not in [e["name"] for e in later]
    for res in (second, third):
        np.testing.assert_array_equal(res.payload, first.payload)
        np.testing.assert_array_equal(res.turbo_iters, first.turbo_iters)


def test_graph_capture_is_a_span():
    assert "turbo.graph_capture" in trace.SPANS


@pytest.mark.cuda
@pytest.mark.parametrize("tm", ["tm1", "tm2"])
def test_frontend_graph_spans_inside_the_frontend(tm, tmp_path, monkeypatch):
    """On the card the second call at a shape captures the frontend, one
    ``frontend.graph_capture`` and one ``frontend.graph_replay`` span inside
    ``ue_dl.frontend``; the third only replays; the first records neither."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    iq = _iq(tm).cuda()
    ue = UeDl(_cell(tm), n_turbo_iters=CFG["turbo_iters"], device="cuda")
    counts = []
    for i in range(3):
        _, events = _recorded(lambda: ue.process(iq, CFG["subframe"], CFG["rnti"]),
                              tmp_path / str(i))
        ours = [e for e in events if e["name"].startswith("frontend.")]
        assert all(_parent(e, events) == "ue_dl.frontend" for e in ours)
        counts.append(sorted(e["name"] for e in ours))
    assert counts == [[], ["frontend.graph_capture", "frontend.graph_replay"],
                      ["frontend.graph_replay"]]
    assert {"frontend.graph_capture", "frontend.graph_replay"} <= set(trace.SPANS)


@pytest.mark.parametrize("form", ["forced", "masked"])
def test_iterations_counted_without_exit_checks(form, tmp_path):
    """Loops that run all their iterations: one ``turbo.iteration`` each, no
    exit check (``decode_forced``, and ``decode`` without early exit)."""
    k, n = 40, 3
    d = torch.as_tensor(np.random.default_rng(5).normal(0, 2, (2, 3, k + 4)),
                        dtype=torch.float32)
    fn = (lambda: turbo.decode_forced(d, k, n)) if form == "forced" else \
        (lambda: turbo.decode(d, k, n, early_exit=False))
    (_, iters, _), events = _recorded(fn, tmp_path)
    names = [e["name"] for e in events]
    assert names.count("turbo.iteration") == n and "turbo.exit_check" not in names
    assert iters.tolist() == [n, n]


def test_annotate_is_a_shared_noop_until_a_profiler_records(tmp_path):
    off = trace.annotate("ue_dl.process")
    assert off is trace.annotate("pdsch.turbo")
    with off, off:
        torch.ones(8).cumsum(0)
    with trace.ProfilerTrace(str(tmp_path / "prof")) as t:
        on = trace.annotate("ue_dl.process")
        assert on is not off
        with on:
            torch.ones(8).cumsum(0)
    assert [e["name"] for e in _span_events(t.path)] == ["ue_dl.process"]


def test_every_span_of_the_package_is_in_spans():
    """The names the package gives ``annotate`` are exactly SPANS, which
    holds each name once."""
    used = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "annotate"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                used.add(node.args[0].value)
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert used == set(trace.SPANS)


# PuschCodec's spans on a 6 PRB 16QAM grant with CQI and ACK, and each one's
# enclosing span
PUSCH_PARENT = {"pusch.frontend": None, "pusch.idft_group": "pusch.frontend",
                "pusch.demap_dematch": None, "pusch.turbo": None,
                "pusch.k_group": "pusch.turbo", "turbo.iteration": "pusch.k_group",
                "turbo.exit_check": "pusch.k_group", "pusch.uci": None}


def _pusch_step(device="cpu"):
    """An eNB's step on two uplink subframes at 20 dB: dematch, decode, each
    subframe's UCI."""
    cell = Cell(n_prb=6, cell_id=42)
    grant = UlGrant(n_prb=6, prb_start=0, mcs=20, mod_order=4, tbs=2600)
    codec = pusch.PuschCodec(cell, grant, 0x1234, 2, n_cqi_bits=4, with_ack=True, device=device)
    rng = np.random.default_rng(7)
    wave = np.stack([codec.encode_sf_uci(rng.integers(0, 2, grant.tbs).astype(np.uint8),
                                         cqi_bits=np.array([1, 0, 0, 1], np.uint8), ack=a)
                     for a in (True, False)])
    iq = torch.as_tensor(enb_tx.awgn(rng, wave, 20.0)[0], device=device)

    def step():
        payload, tb_ok, iters = codec.decode_softbuffers(codec.dematch_sf(iq))
        return payload, tb_ok, iters, *codec.decode_uci_sf()
    return step


def test_pusch_span_tree(tmp_path):
    """The uplink's four spans once each in a step, its one IDFT group inside
    ``pusch.frontend``, its one K-group inside ``pusch.turbo`` holding the
    turbo loop's spans, and the step's results as without a profiler."""
    step = _pusch_step()
    plain = step()
    rec, events = _recorded(step, tmp_path)
    names = [e["name"] for e in events]
    assert set(names) == set(PUSCH_PARENT) and set(names) <= set(trace.SPANS)
    for e in events:
        assert _parent(e, events) == PUSCH_PARENT[e["name"]], e["name"]
    for name in ("pusch.frontend", "pusch.idft_group", "pusch.demap_dematch", "pusch.turbo",
                 "pusch.k_group", "pusch.uci"):
        assert names.count(name) == 1, name
    assert rec[1].all() and rec[4].tolist() == [True, False]
    for a, b in zip(plain, rec, strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# PuschCell's step on a 15 PRB cell: two 4 PRB QPSK UEs (one size, one K) and
# a 6 PRB 16QAM UE with CQI; the top-level spans in the order they run
CELL_SPANS = ["pusch.frontend", "pusch.demap_dematch", "pusch.turbo", "pusch.uci"]


def _pusch_cell_step(device="cpu"):
    """``PuschCell``'s step on a 15 PRB cell: dematch, decode, each UE's UCI."""
    cell = Cell(n_prb=15, cell_id=42)
    ues = [(4, 1, 2, 176, 0), (4, 5, 2, 176, 6), (6, 9, 4, 1352, 3)]
    codecs = [pusch.PuschCodec(cell, UlGrant(n, start, 0, qm, tbs), 0x1234 + i, 2,
                               n_cqi_bits=4 if qm == 4 else 0, with_ack=True, device=device)
              for i, (n, start, qm, tbs, _) in enumerate(ues)]
    rng = np.random.default_rng(3)
    wave = sum(c.encode_sf_uci(rng.integers(0, 2, c.grant.tbs).astype(np.uint8),
                               cqi_bits=np.array([1, 0, 0, 1], np.uint8) if c.n_cqi_bits else None,
                               ack=True, cyclic_shift=ue[4]) for c, ue in zip(codecs, ues))
    iq = torch.as_tensor(enb_tx.awgn(rng, np.stack([wave] * 2), 20.0)[0], device=device)
    rx = pusch.PuschCell(cell, codecs, [ue[4] for ue in ues])

    def step():
        return [v for out in rx.decode(rx.dematch(iq)) for v in out], rx.decode_uci_sf()
    return step


def test_pusch_cell_span_tree(tmp_path):
    """One ``pusch.frontend`` holding one ``pusch.idft_group`` per allocation
    size (2), one ``pusch.turbo`` holding one ``pusch.k_group`` per K (2),
    the turbo loop's spans inside a K-group, one ``pusch.uci``; in that
    order, and the results as without a profiler."""
    step = _pusch_cell_step()
    plain = step()
    rec, events = _recorded(step, tmp_path)
    names = [e["name"] for e in events]
    assert set(names) == set(PUSCH_PARENT) and set(names) <= set(trace.SPANS)
    for e in events:
        assert _parent(e, events) == PUSCH_PARENT[e["name"]], e["name"]
    top = [e["name"] for e in sorted(events, key=lambda e: e["ts"])
           if PUSCH_PARENT[e["name"]] is None]
    assert top == CELL_SPANS
    assert names.count("pusch.idft_group") == names.count("pusch.k_group") == 2
    for a, b in zip(plain[0], rec[0], strict=True):
        assert torch.equal(a, b)
    assert all(bool(ok.all()) for ok in rec[0][1::3])
    assert [bool(ack.all()) for _, ack in rec[1]] == [True] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("receiver", ["codec", "cell"])
def test_uplink_graph_spans_inside_their_stages(receiver, tmp_path, monkeypatch):
    """On the card the first step records no ``frontend.*`` span; the second
    captures and replays each uplink stage, one ``frontend.graph_capture``
    and one ``frontend.graph_replay`` inside ``pusch.frontend`` and inside
    ``pusch.demap_dematch``; the third only replays; every step's results
    are the first's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    step = (_pusch_step if receiver == "codec" else _pusch_cell_step)("cuda")
    got, stages = [], []
    for i in range(3):
        out, events = _recorded(step, tmp_path / str(i))
        got.append(out)
        ours = [e for e in events if e["name"].startswith("frontend.")]
        stages.append(sorted((_parent(e, events), e["name"]) for e in ours))
    both = ["pusch.demap_dematch", "pusch.frontend"]
    assert stages == [[], [(s, n) for s in both
                           for n in ("frontend.graph_capture", "frontend.graph_replay")],
                      [(s, "frontend.graph_replay") for s in both]]
    flat = [_tensors(out) for out in got]
    for later in flat[1:]:
        assert all(torch.equal(a, b) for a, b in zip(later, flat[0], strict=True))


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for v in out if v is not None for t in _tensors(v)]


def test_pusch_spans_record_nothing_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    _pusch_step()()
    assert opened == []


def _exchange_rank(m, iq, logdir):
    """One rank: shard_decode of its part of iq, once unrecorded and once
    under the profiler; the spans recorded."""
    cell = _cell("tm1")
    codec = PdschCodec(cell, dl_grant(cell.n_prb, CFG["mcs"]), CFG["rnti"], CFG["subframe"],
                       CFG["cfi"], CFG["turbo_iters"], device=m.device)
    run = mesh.shard_decode(cell, codec, m)
    x = torch.as_tensor(mesh.shard(iq, m))
    run(x)
    with trace.ProfilerTrace(f"{logdir}/rank{m.rank}") as t:
        _, tb_ok, n_ok, _, _ = run(x)
    return {"events": _span_events(t.path), "errors": t.errors, "n_ok": int(n_ok),
            "tb_ok": tb_ok.numpy()}


def test_shard_exchange_recorded_on_each_rank(tmp_path):
    """Each rank's decode and its exchange, the collective started inside it
    (gloo records it on its own thread)."""
    iq = _iq("tm1").numpy()
    out = mesh.launch(_exchange_rank, 2, "cpu", iq, str(tmp_path))
    for o in out:
        assert o["errors"] == [] and o["tb_ok"].all() and o["n_ok"] == 2
        events = o["events"]
        names = [e["name"] for e in events]
        assert names.count("shard.exchange") == 1
        assert {"pdsch.frontend", "pdsch.demap_dematch", "pdsch.turbo", "pdsch.tb_crc"} \
            <= set(names)
        ex = next(e for e in events if e["name"] == "shard.exchange")
        coll = [e for e in events if e["name"] == "gloo:all_reduce"]
        assert len(coll) == 1 and ex["ts"] <= coll[0]["ts"] <= ex["ts"] + ex["dur"]
