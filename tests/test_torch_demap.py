"""The demap + descramble + dematch step of the torch port
(``ratematch.demap_dematch``, ``modulation.demodulate_soft`` and their
callers) against the JAX reference's composition, and the arithmetic of
the kernel ``csrc/demap.cu`` against its plain version, on the CPU.

Tolerances. Against the reference (``demodulate_soft(...) * scr`` ->
``ratematch.dematch(seg, idx, d_len)``): rtol 1e-4 with a floor of 1e-4 of
the peak, as test_torch_frontend.py holds the LLRs (a difference of squared
distances divided by a small noise variance amplifies input rounding); the
signs and the exact zeros (positions never sent, erased bits) are equal.
Within the port, at atol 0: the dispatch on the CPU equals the composition
the receivers ran before (demap every symbol, take the map, slice,
descramble, dematch), and ``_kernel_model``, the kernel written in numpy
float32 (its tiles, clusters, staged bits and chunked sums, under the
launch plans of ``kernels.demap.plan`` and plans forced to each of those
features), equals the plain version bit for bit, ties, zeros, infinities
and NaNs included. The planner is held to the callers' shapes, and
``ratematch.segment_ranges`` to the min and max of each segment of an
inverse index.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import modulation as ref_mod
from srsue_tpu.phy import pusch as ref_pusch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy.cell import Cell, DlGrant, UlGrant
from srsue_tpu.phy.pdsch import PdschCodec as RefPdsch
from srsue_tpu_torch.kernels import demap as demap_kernel
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import modulation, pusch, ratematch
from srsue_tpu_torch.phy.pdsch import PdschCodec

F32 = np.float32


def _mine(obj):
    """The port's own Cell or grant with the fields of the reference's."""
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _close(got, ref):
    """rtol 1e-4, floor 1e-4 of the peak; equal signs and exact zeros."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_array_equal(got == 0, ref == 0)


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


def _symbols(rng, shape, qm, scale=0.15):
    """Noisy constellation points [*shape] complex64."""
    bits = rng.integers(0, 2, shape + (qm,)).astype(np.uint8)
    clean = modulation.modulate_np(bits.reshape(shape[:-1] + (-1,)), qm)
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (clean + scale * noise).astype(np.complex64)


def _repeat_map(rng, e, r, unsent=7):
    """An index map of e bits into d positions, the most repeated sent r
    times, `unsent` positions never sent: (idx [e], d)."""
    d_sent = -(-e // r)
    d = d_sent + unsent
    pos = rng.permutation(d)[:d_sent]
    return rng.permutation(np.tile(pos, r)[:e]), d


def _case(qm, r, seed):
    """Inputs of one generic case; the seed picks the leading dims, the map,
    the slice and the noise's form."""
    rng = np.random.default_rng(seed)
    lead = (3,) if seed % 2 else (2, 3)
    s = 37
    sym_map = rng.permutation(s)[:29].astype(np.int32) if seed % 3 else None
    n_sym = s if sym_map is None else len(sym_map)
    e = n_sym * qm
    lo, hi = (5, e - 3) if seed % 4 else (0, e)
    idx, d = _repeat_map(rng, hi - lo, r)
    scr = (1.0 - 2.0 * rng.integers(0, 2, e)).astype(F32)
    scr[rng.random(e) < 0.1] = 0.0  # erased bits
    sym = _symbols(rng, lead + (s,), qm)
    form = seed % 3
    nv = (0.5 if form == 0 else (0.01 + rng.random(lead + (s,))).astype(F32) if form == 1
          else (0.01 + rng.random(lead + (1,))).astype(F32))
    return dict(sym=sym, nv=nv, scr=scr, sym_map=sym_map, lo=lo, hi=hi, idx=idx, d=d)


def _t(x, dtype=None):
    return x if x is None or isinstance(x, float) else torch.as_tensor(x, dtype=dtype)


def _port(c, qm, dispatch=True):
    fn = ratematch.demap_dematch if dispatch else ratematch.demap_dematch_plain
    inv = ratematch.inverse_index(c["idx"], c["d"])
    return fn(_t(c["sym"]), _t(c["nv"]), qm, _t(c["scr"]), _t(inv, torch.int32),
              _t(c["sym_map"]), c["lo"], c["hi"]).numpy()


def _reference(c, qm):
    sym, nv = c["sym"], c["nv"]
    if c["sym_map"] is not None:
        sym = sym[..., c["sym_map"]]
        if not isinstance(nv, float):
            nv = np.broadcast_to(nv, c["sym"].shape)[..., c["sym_map"]]
    llr = ref_mod.demodulate_soft(jnp.asarray(sym), qm, nv if isinstance(nv, float)
                                  else jnp.asarray(nv)) * jnp.asarray(c["scr"])
    return np.asarray(ref_rm.dematch(llr[..., c["lo"]:c["hi"]], c["idx"], c["d"]))


def _composition(c, qm):
    """What the receivers ran before: every symbol demapped, the map on the
    LLRs, the slice, the scrambling, ``dematch``."""
    llr = modulation.demodulate_soft_plain(_t(c["sym"]), qm, _t(c["nv"]))
    if c["sym_map"] is not None:
        lead = llr.shape[:-1]
        llr = llr.reshape(lead + (-1, qm))[..., _t(c["sym_map"]).long(), :].reshape(lead + (-1,))
    seg = llr[..., c["lo"]:c["hi"]] * _t(c["scr"])[c["lo"]:c["hi"]]
    return ratematch.dematch(seg, _t(ratematch.inverse_index(c["idx"], c["d"]))).numpy()


def _kernel_model(sym, nv, qm, scr, inv, sym_map, lo, hi, plan=None, ranges=None,
                  llr_form=False, stats=None):
    """The kernel in numpy float32, every row at once: rows [N, S] of symbols
    and noise, the levels of ``modulation.levels``. The LLR form (inv None):
    each symbol's qm LLRs. The softbuffer form by ``plan`` (a
    ``kernels.demap.Plan``; None: ``demap.plan`` of these sizes) and
    ``ranges`` (``ratematch.segment_ranges`` of inv; None: the whole row as
    one segment): each tile of plan.tile positions is split over plan.csize
    CTAs; the range of slice bits of the segments it overlaps is staged,
    t(e) = llr(e) * scr[e], in chunks of csize * bs symbols, CTA `rank`
    holding symbols [rank * bs, (rank + 1) * bs) of a chunk; each position
    sums 0.0 + t + ... in row order, carrying its sum from chunk to chunk
    through the output, reading each t from the CTA that holds it. A read
    of a slot that no CTA staged fails. `stats`
    (a dict) gets the most chunks of a tile and the count of positions whose
    entries fell into two chunks or more."""
    lv = modulation.levels(qm, torch.device("cpu")).numpy()
    nb = qm // 2
    nv = np.broadcast_to(np.asarray(nv, F32), sym.shape)

    def symbol_llrs(s):  # [N, len(s), qm], the axis distances once per symbol
        ms = s if sym_map is None else sym_map[s]
        y = sym[:, ms]
        v = nv[:, ms]
        v = np.where(v < F32(1e-9), F32(1e-9), v)
        xs = (y.real.astype(F32), y.imag.astype(F32))
        d2 = [[(x - lv[level]) * (x - lv[level]) for level in range(1 << nb)] for x in xs]
        out = np.empty(y.shape + (qm,), F32)
        for b in range(qm):
            m1 = np.full(y.shape, F32(1e30))
            m0 = np.full(y.shape, F32(1e30))
            for level, dd in enumerate(d2[b & 1]):  # fminf: a NaN loses
                if (level >> (nb - 1 - (b >> 1))) & 1:
                    m1 = np.fmin(m1, dd)
                else:
                    m0 = np.fmin(m0, dd)
            x = xs[b & 1]
            out[..., b] = np.where(np.isnan(x), x - x, m1 - m0) / v
        return out

    def alive(rows):  # entries up to each row's first pad
        return np.cumprod((rows >= 0) & (rows < hi - lo), axis=1).astype(bool)

    with np.errstate(all="ignore"):
        n_rows = sym.shape[0]
        if llr_form:
            return symbol_llrs(np.arange(sym.shape[1])).reshape(n_rows, -1)
        d, r = inv.shape
        if ranges is None:
            ranges = ratematch.segment_ranges(torch.as_tensor(inv), 1, hi - lo).numpy()
        seg = d // len(ranges)
        if plan is None:
            plan = demap_kernel.plan(n_rows, d, seg, hi - lo, qm)
        cs, bs, cap = plan.csize, plan.bs, plan.csize * plan.bs
        out = np.full((n_rows, d), np.nan, F32)
        written = np.zeros(d, bool)
        most, split = 0, 0
        for t0 in range(0, d, plan.tile):
            t1 = min(t0 + plan.tile, d)
            live = alive(inv[t0:t1])
            emin = int(ranges[t0 // seg:(t1 - 1) // seg + 1, 0].min())
            emax = int(ranges[t0 // seg:(t1 - 1) // seg + 1, 1].max())
            if emax >= 0:
                elo, ehi = lo + emin, lo + emax
                slo = elo // qm
                nsym = ehi // qm - slo + 1
            else:
                elo, ehi, slo, nsym = 0, -1, 0, 0
            chunks = max(1, -(-nsym // cap))
            most = max(most, chunks)
            chunk_of = np.where(live, (inv[t0:t1].astype(np.int64) + lo - slo * qm) // qm // cap,
                                -1)
            split += int(((chunk_of != chunk_of[:, :1]) & live).any(1).sum())
            share = -(-(t1 - t0) // cs)
            for c in range(chunks):
                stage = np.zeros((n_rows, cs, bs * qm), F32)
                staged = np.zeros((cs, bs * qm), bool)
                for rank in range(cs):
                    first = c * cap + rank * bs
                    i = np.arange(bs)
                    i = i[first + i < nsym]
                    s = slo + first + i
                    e = s[:, None] * qm + np.arange(qm)
                    ok = (e >= elo) & (e <= ehi)
                    t = symbol_llrs(s) * scr[np.where(ok, e, 0)]
                    slots = i[:, None] * qm + np.arange(qm)
                    stage[:, rank, slots[ok]] = t[:, ok]
                    staged[rank, slots[ok]] = True
                for rank in range(cs):
                    p0 = min(t0 + rank * share, t1)
                    p1 = min(p0 + share, t1)
                    rows = inv[p0:p1]
                    live = alive(rows)
                    acc = np.zeros((n_rows, p1 - p0), F32)
                    held = np.full(p1 - p0, c == 0)
                    for j in range(r):
                        rel = rows[:, j].astype(np.int64) + lo - slo * qm
                        k = rel // qm - c * cap
                        inch = live[:, j] & (k >= 0) & (k < cap)
                        owner = np.where(inch, k // bs, 0)
                        at = np.where(inch, rel - (c * cap + owner * bs) * qm, 0)
                        assert staged[owner[inch], at[inch]].all(), "a read of an unstaged slot"
                        fresh = inch & ~held
                        acc[:, fresh] = out[:, p0:p1][:, fresh]
                        held |= inch
                        acc[:, inch] = acc[:, inch] + stage[:, owner[inch], at[inch]]
                    out[:, p0:p1][:, held] = acc[:, held]
                    written[p0:p1] |= held
        assert written.all()
        if stats is not None:
            stats.update(chunks=most, split=split)
        return out


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("qm", [2, 4, 6])
def test_demap_dematch_matches_the_reference(qm, r):
    for seed in range(4):  # every form of map, slice, noise and leading dims
        c = _case(qm, r, 10 * qm + r + 97 * seed)
        got = _port(c, qm)
        assert got.shape == c["sym"].shape[:-1] + (c["d"],)
        _close(got, _reference(c, qm))
        # the plain version is the receivers' old composition, bit for bit
        np.testing.assert_array_equal(_bits(got), _bits(_composition(c, qm)))
        np.testing.assert_array_equal(_bits(got), _bits(_port(c, qm, dispatch=False)))


def _special(rng, shape):
    """Symbols with exact ties between levels, zeros, huge values,
    infinities and NaNs among noisy points."""
    sym = _symbols(rng, shape, 6, scale=0.6)
    flat = sym.reshape(-1)
    picks = rng.permutation(flat.size)
    vals = [0.0, 1e20, -1e20, np.inf, -np.inf, np.nan, 2 / np.sqrt(42), 1 / np.sqrt(10),
            0.0 + 1e-30j, -0.0]
    for i, v in enumerate(vals * 3):
        flat[picks[i]] = np.complex64(complex(v, vals[(i + 3) % len(vals)]))
    return sym


@pytest.mark.parametrize("qm", [2, 4, 6])
def test_kernel_model_equals_the_plain_version(qm):
    rng = np.random.default_rng(qm)
    for r, noise in ((1, "per RE"), (3, "scalar"), (5, "tiny")):
        c = _case(qm, r, 1000 + qm + r)
        sym = _special(rng, (4, 37))
        nv = {"per RE": (0.01 + rng.random((4, 37))).astype(F32), "scalar": 0.25,
              "tiny": np.where(rng.random((4, 37)) < 0.5, F32(1e-12), F32(0.3)).astype(F32)}[noise]
        inv = ratematch.inverse_index(c["idx"], c["d"])
        plain = ratematch.demap_dematch(torch.as_tensor(sym), _t(nv), qm, _t(c["scr"]),
                                        _t(inv, torch.int32), _t(c["sym_map"]), c["lo"],
                                        c["hi"]).numpy()
        model = _kernel_model(sym, nv, qm, c["scr"], inv.astype(np.int32), c["sym_map"],
                              c["lo"], c["hi"])
        np.testing.assert_array_equal(model, plain)  # NaN where NaN
        np.testing.assert_array_equal(np.signbit(model), np.signbit(plain))
        llrs = modulation.demodulate_soft(torch.as_tensor(sym), qm, _t(nv)).numpy()
        model = _kernel_model(sym, nv, qm, None, None, None, 0, 0, llr_form=True)
        np.testing.assert_array_equal(model, llrs)
        np.testing.assert_array_equal(np.signbit(model), np.signbit(llrs))


def _block_case(qm, r, seed, blocks=3):
    """`blocks` turbo code blocks rate-matched so that the most repeated
    position is sent r times (r = 1: a third never sent), each block's E a
    symbol apart from the next's, as a slice [lo, hi) that starts inside a
    symbol; 3 rows of symbols with the special values, gathered through a
    map, per-RE noise with some tiny values, scrambling with erasures:
    (sym, nv, scr, inv int32, sym_map, lo, hi, seg)."""
    rng = np.random.default_rng(seed)
    k = 1024 if r == 1 else 104
    seg = 3 * (k + 4)
    e_blk = 2 * seg // 3 if r == 1 else seg * (r - 1) + seg // 2
    idx = np.concatenate([j * seg + ratematch.turbo_rm_indices(k + 4, e_blk + qm * (j % 2), j % 4)
                          for j in range(blocks)])
    inv = ratematch.inverse_index(idx, blocks * seg).astype(np.int32)
    assert inv.shape == (blocks * seg, r)
    lo = 5
    hi = lo + len(idx)
    n_sym = -(-(hi + 3) // qm)
    n_col = n_sym + 11
    sym_map = rng.permutation(n_col)[:n_sym].astype(np.int32)
    sym = _special(rng, (3, n_col))
    nv = np.where(rng.random((3, n_col)) < 0.1, F32(1e-12),
                  0.01 + rng.random((3, n_col))).astype(F32)
    scr = (1.0 - 2.0 * rng.integers(0, 2, n_sym * qm)).astype(F32)
    scr[rng.random(scr.size) < 0.1] = 0.0  # erased bits
    return sym, nv, scr, inv, sym_map, lo, hi, seg


PLAN_KINDS = ("planner", "one CTA per tile", "cluster", "straddle", "chunked", "cluster chunked")


def _plan_of(kind, n, d, seg, n_e, qm):
    """A launch plan of the kind: the planner's at these sizes, or one that
    forces a feature of the kernel (a cluster, a tile straddling two
    segments, a chunked range) by the planner's own knobs."""
    one, many = dict(n_sm=1), dict(n_sm=10 ** 6)
    small = dict(stage_bytes=4 * qm * max(8, n_e // (3 * qm * 3)))  # ~3 chunks per block
    p = demap_kernel.plan(n, d, seg, n_e, qm, **{
        "planner": {}, "one CTA per tile": one, "cluster": many, "straddle": one,
        "chunked": {**one, **small}, "cluster chunked": {**many, **small}}[kind])
    if kind == "straddle":
        p = dataclasses.replace(p, tile=seg + seg // 2, tiles=-(-d // (seg + seg // 2)))
    return p


@pytest.mark.parametrize("kind", PLAN_KINDS)
@pytest.mark.parametrize("r", [1, 2, 3, 7])
def test_kernel_model_tiles_clusters_and_chunks(r, kind):
    """The kernel's tile, cluster and chunk structure gives the plain
    version's bits, NaNs and signs of zero included, on code blocks with
    r repeats, a map, erasures and the special values; the plan exercises
    what its kind names."""
    qm = (2, 4, 6)[(r + PLAN_KINDS.index(kind)) % 3]
    sym, nv, scr, inv, sym_map, lo, hi, seg = _block_case(qm, r, 100 * r + len(kind))
    plan = _plan_of(kind, sym.shape[0], inv.shape[0], seg, hi - lo, qm)
    ranges = ratematch.segment_ranges(torch.as_tensor(inv), inv.shape[0] // seg, hi - lo)
    stats = {}
    model = _kernel_model(sym, nv, qm, scr, inv, sym_map, lo, hi, plan, ranges.numpy(),
                          stats=stats)
    plain = ratematch.demap_dematch(torch.as_tensor(sym), _t(nv), qm, _t(scr),
                                    _t(inv), _t(sym_map), lo, hi).numpy()
    np.testing.assert_array_equal(model, plain)  # NaN where NaN
    np.testing.assert_array_equal(np.signbit(model), np.signbit(plain))
    assert np.isnan(plain).any() and ((plain == 0).any() or r > 1)  # r = 1: unsent positions
    if "cluster" in kind:
        assert plan.csize > 1 and plan.bs == 1 << plan.shift
    if kind in ("one CTA per tile", "straddle", "chunked"):
        assert plan.csize == 1
    if kind == "straddle":
        assert plan.tile % seg and plan.tile < inv.shape[0]
    else:
        assert plan.tile % seg == 0
    if "chunked" in kind:
        assert stats["chunks"] > 1
        assert stats["split"] > 0 or r == 1  # repeats on both sides of a chunk boundary
    else:
        assert stats["chunks"] == 1


@pytest.mark.parametrize("r", [1, 2, 7])
def test_segment_ranges_are_each_segments_least_and_largest_entry(r):
    """``ratematch.segment_ranges`` = min and max of each segment's entries
    below the pad, int32 max and -1 for a segment that draws on no bit."""
    _, _, _, inv, _, lo, hi, seg = _block_case(2, r, r)
    inv = np.concatenate([inv, np.full((seg, r), hi - lo, np.int32)])  # a segment never sent
    got = ratematch.segment_ranges(torch.as_tensor(inv), inv.shape[0] // seg, hi - lo).numpy()
    assert got.dtype == np.int32 and got.shape == (inv.shape[0] // seg, 2)
    for g, (least, most) in enumerate(got):
        ents = inv[g * seg:(g + 1) * seg]
        ents = ents[ents < hi - lo]
        if ents.size:
            assert (least, most) == (ents.min(), ents.max())
        else:
            assert (least, most) == (np.iinfo(np.int32).max, -1)
    with pytest.raises(ValueError, match="equal segments"):
        ratematch.segment_ranges(torch.as_tensor(inv), 5, hi - lo)


def _chunks_needed(inv, lo, n_e, qm, plan):
    """The most chunks any tile of `plan` stages, from the true ranges of
    its inv entries."""
    inv = inv.cpu().numpy()
    most = 1
    for t0 in range(0, inv.shape[0], plan.tile):
        rows = inv[t0:t0 + plan.tile]
        live = np.cumprod((rows >= 0) & (rows < n_e), axis=1).astype(bool)
        if live.any():
            nsym = (lo + int(rows[live].max())) // qm - (lo + int(rows[live].min())) // qm + 1
            most = max(most, -(-nsym // (plan.csize * plan.bs)))
    return most


def _caller_tables(name):
    """(rows, inv, seg, lo, hi, qm) of one call of a caller of the demap
    kernel at its own shapes, on the CPU."""
    from srsue_tpu_torch import entry
    from srsue_tpu_torch.phy import control, dci

    if name.startswith("flagship"):
        codec = entry.flagship("cpu")[1]
        (k, _, _, lo, hi, inv), = codec.groups
        seg = None if "without" in name else 3 * (k + 4)
        return (1 if "B=1" in name else 256), inv, seg, lo, hi, 6
    if name.startswith("blind"):
        cell = Cell(n_prb=100, cell_id=42)
        n_1a = dci.size_0_1a(100)
        _, _, scr, buf, _, _ = control._blind_tables(_mine(cell), 6, 1, 0x1234, n_1a, True,
                                                     torch.device("cpu"))
        return (1 if "B=1" in name else 256), buf, 3 * (n_1a + 16), 0, scr.numel(), 2
    if name.startswith("PUSCH"):
        g = ref_ra.dl_grant(100, 28)
        codec = pusch.PuschCodec(port_cell.Cell(n_prb=100, cell_id=42), port_cell.UlGrant(
            n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order, tbs=g.tbs),
            0x1234, 2, device="cpu")
        (k, _, _, lo, hi, inv), = codec.groups
        return 256, inv, 3 * (k + 4), lo, hi, codec.qm
    n_prb, mcs = {"OTA grant 100 PRB MCS 6, B=1": (100, 6),
                  "2 PRB MCS 0, B=256": (2, 0)}[name]
    codec = PdschCodec(port_cell.Cell(n_prb=100 if n_prb == 100 else 6, cell_id=123),
                       _mine(ref_ra.dl_grant(100 if n_prb == 100 else 6, mcs, n_prb_alloc=n_prb)),
                       0x46, 1, device="cpu")
    k, _, _, lo, hi, inv = codec.groups[-1]
    return (1 if "B=1" in name else 256), inv, 3 * (k + 4), lo, hi, codec.qm


@pytest.mark.parametrize("name", [
    "flagship B=256", "flagship B=1", "flagship without segments", "blind search B=256",
    "blind search B=1", "PUSCH 100 PRB MCS 28, B=256", "OTA grant 100 PRB MCS 6, B=1",
    "2 PRB MCS 0, B=256"])
def test_plan_at_the_callers_shapes(name):
    """The planner's launch at each caller's shape: tiles of whole segments,
    every true range staged in one chunk (the over-budget flagship row, in
    more), clusters where the rows and tiles leave the 132 SMs short, rows
    joined where CTAs are many, and the shared memory within the H100's."""
    n, inv, seg, lo, hi, qm = _caller_tables(name)
    d = inv.shape[0]
    p = demap_kernel.plan(n, d, seg, hi - lo, qm)
    assert p.tile % (seg or d) == 0 and p.tiles == -(-d // p.tile)
    assert p.smem == 4 * qm * p.bs * p.rows and 4 * qm * p.bs <= demap_kernel.STAGE_BYTES
    assert p.rows == 1 or (p.csize == 1 and p.smem <= demap_kernel.SM_SHARED // 2)
    assert 256 <= p.threads <= 1024 and p.threads & (p.threads - 1) == 0
    assert (p.csize > 1) == (n * p.tiles < demap_kernel.H100_SMS)
    if p.csize > 1:
        assert p.bs == 1 << p.shift
    chunks = _chunks_needed(inv, lo, hi - lo, qm, p)
    assert chunks == (2 if "without" in name else 1)
    if name == "flagship B=256":
        assert (p.tile, p.tiles, p.csize, p.rows, p.threads) == (3 * 5828, 13, 1, 4, 512)
    if name.startswith("blind search B=256"):
        assert p.tile == d  # every candidate in one tile


PDSCH_CASES = {  # name: (cell, mcs, subframe, tbs or None)
    "6prb_qpsk": (Cell(n_prb=6, cell_id=17), 5, 1, None),
    "6prb_16qam": (Cell(n_prb=6, cell_id=5), 13, 4, None),
    # TBS 6208: one block of K=3136 and one of K=3200, 56 filler bits
    "25prb_two_groups_filler": (Cell(n_prb=25, cell_id=301), 20, 3, 6208),
}


@pytest.mark.parametrize("name", list(PDSCH_CASES))
def test_pdsch_demap_dematch_matches_the_reference(name):
    cell, mcs, subframe, tbs = PDSCH_CASES[name]
    grant = ref_ra.dl_grant(cell.n_prb, mcs)
    if tbs is not None:
        grant = DlGrant(grant.n_prb, grant.prb_start, mcs, grant.mod_order, tbs, 0)
    ref = RefPdsch(cell, grant, rnti=0x1234, subframe=subframe, cfi=1)
    mine = PdschCodec(_mine(cell), _mine(grant), rnti=0x1234, subframe=subframe, cfi=1,
                      device="cpu")
    if tbs is not None:
        assert len(mine.groups) == 2 and mine.plan.f > 0
    rng = np.random.default_rng(len(name))
    x = _symbols(rng, (2, mine.n_re), mine.qm)
    nve = (0.02 + rng.random((2, mine.n_re))).astype(F32)
    got = mine.demap_dematch(torch.as_tensor(x), torch.as_tensor(nve))
    want = ref.dematch(ref.demap_llrs(jnp.asarray(x), jnp.asarray(nve)))
    old = mine.dematch(mine.demap_llrs(torch.as_tensor(x), torch.as_tensor(nve)))
    for a, b, o in zip(got, want, old, strict=True):
        _close(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(o.numpy()))


PUSCH_CASES = {  # name: (cell, mcs, cqi bits, ack)
    "6prb_qpsk_ack_cqi": (Cell(n_prb=6, cell_id=17), 9, [1, 0, 1, 1], True),
    "25prb_16qam_nack_cqi": (Cell(n_prb=25, cell_id=301), 16, [0, 1, 1, 0, 1, 0], False),
}


@pytest.mark.parametrize("name", list(PUSCH_CASES))
def test_pusch_dematch_sf_matches_the_reference(name):
    cell, mcs, cqi, ack = PUSCH_CASES[name]
    g = ref_ra.dl_grant(cell.n_prb, mcs)
    grant = UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order,
                    tbs=g.tbs)
    kw = dict(n_cqi_bits=len(cqi), with_ack=True)
    ref = ref_pusch.PuschCodec(cell, grant, 0x1234, 2, **kw)
    mine = pusch.PuschCodec(_mine(cell), _mine(grant), 0x1234, 2, device="cpu", **kw)
    rng = np.random.default_rng(mcs)
    wave = mine.encode_sf_uci(rng.integers(0, 2, grant.tbs).astype(np.uint8),
                              cqi_bits=np.asarray(cqi, np.uint8), ack=ack)
    p = float(np.mean(np.abs(wave) ** 2)) * cell.nfft / mine.m_sc / 10 ** 1.2
    noisy = (wave[None] + np.sqrt(p / 2) * (rng.standard_normal((2,) + wave.shape) + 1j *
             rng.standard_normal((2,) + wave.shape))).astype(np.complex64)
    got = mine.dematch_sf(torch.as_tensor(noisy))
    want = ref.dematch_sf(jnp.asarray(noisy))
    for a, b in zip(got, want, strict=True):
        _close(a.numpy(), np.asarray(b))
    uci, uci_r = mine.decode_uci(), ref.decode_uci()
    np.testing.assert_array_equal(uci[0], uci_r[0])
    assert uci[1] is uci_r[1] is ack and list(uci[0]) == cqi

    # bit for bit the composition the codec ran before, on its own symbols
    syms, nv = mine.equalize_sf(torch.as_tensor(noisy))
    llr_all = modulation.demodulate_soft_plain(syms, mine.qm, nv).reshape(
        (2, mine.n_re, mine.qm))
    llr = llr_all[:, torch.as_tensor(mine.data_pos), :].reshape(2, mine.G)
    llr = llr * torch.as_tensor(mine.scr_pm1) * torch.as_tensor(mine._ack_erase)
    old = []
    for k, first, count, lo, hi, inv in mine.groups:
        buf = ratematch.dematch(llr[:, lo:hi], inv).reshape(2, count, 3 * (k + 4))
        if first == 0 and mine.plan.f:
            buf[:, 0, :mine.plan.f] += 1e4
        old.extend(buf.unbind(-2))
    for a, o in zip(got, old, strict=True):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(o.numpy()))
    cqi_llr, ack_llr = mine._last_uci_llrs
    np.testing.assert_array_equal(cqi_llr.numpy(), llr_all[:, mine.cqi_pos].numpy())
    np.testing.assert_array_equal(ack_llr.numpy(), llr_all[:, mine.ack_pos].numpy())


def test_dispatch_raises_on_other_devices():
    sym = torch.zeros(4, 8, dtype=torch.complex64, device="meta")
    inv = torch.zeros(8, 1, dtype=torch.int32, device="meta")
    scr = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        modulation.demodulate_soft(sym, 2, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        modulation.demodulate_hard(sym, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ratematch.demap_dematch(sym, 1.0, 2, scr, inv)


def test_wrapper_refuses_what_the_kernel_cannot_take_before_building():
    """The wrapper's checks come before the library is loaded, so they hold
    on a machine without nvcc too: a CPU tensor, a wrong dtype, a bad qm."""
    lv = modulation.levels(2, torch.device("cpu"))
    sym = torch.zeros(2, 8, dtype=torch.complex64)
    before = demap_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        demap_kernel.demap_llr_cuda(sym, 1.0, 2, lv)
    with pytest.raises(TypeError, match="complex64"):
        demap_kernel.demap_llr_cuda(sym.to(torch.complex128), 1.0, 2, lv)
    with pytest.raises(ValueError, match="qm=3"):
        demap_kernel.demap_dematch_cuda(sym, 1.0, 3, lv, torch.ones(16),
                                        torch.zeros(8, 1, dtype=torch.int32), None, 0, 16)
    assert demap_kernel.launches == before
