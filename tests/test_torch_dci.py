"""The port's DCI formats (phy/dci.py) against the JAX package's: payload
sizes, RIV, pack/unpack of formats 0, 1A, 1 and 1C (one payload and many
rows at once), and the grant conversions, equal at every bandwidth."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from srsue_tpu.phy import dci as ref
from srsue_tpu.phy.cell import Cell as RefCell
from srsue_tpu_torch.phy import dci
from srsue_tpu_torch.phy.cell import Cell

BANDWIDTHS = (6, 15, 25, 50, 75, 100)


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def _same_dci(a, b):
    """The same DCI type and fields, each field of the same Python type (a
    bool stays a bool)."""
    _same(a, b)
    assert [type(x) for x in dataclasses.astuple(a)] == [type(x) for x in dataclasses.astuple(b)]


@pytest.mark.parametrize("n_rb", BANDWIDTHS)
def test_sizes_and_riv_match_reference(n_rb):
    assert dci.size_0_1a(n_rb) == ref.size_0_1a(n_rb)
    assert dci.size_1(n_rb) == ref.size_1(n_rb)
    assert dci.size_1c(n_rb) == ref.size_1c(n_rb)
    assert dci.rbg_size(n_rb) == ref.rbg_size(n_rb)
    for start in range(n_rb):
        for length in range(1, n_rb - start + 1):
            riv = dci.riv_encode(n_rb, start, length)
            assert riv == ref.riv_encode(n_rb, start, length)
            assert dci.riv_decode(n_rb, riv) == ref.riv_decode(n_rb, riv) == (start, length)


@pytest.mark.parametrize("n_rb", BANDWIDTHS)
def test_pack_unpack_and_grants_match_reference(n_rb):
    """Each format packed, unpacked alone and as rows (``unpack_rows``), and
    its grant, against the reference's, at every bandwidth; the rows also
    hold seeded random payloads (both values of the 0/1A flag), all zeros
    and all ones."""
    rng = np.random.default_rng(n_rb)
    cell = Cell(n_prb=n_rb, cell_id=3)
    rcell = RefCell(n_prb=n_rb, cell_id=3)
    nbg = -(-n_rb // dci.rbg_size(n_rb))
    n_vrb = n_rb // (2 if n_rb < 50 else 4)
    runpack = {"0_1a": ref.unpack_0_1a, "1": ref.unpack_1, "1c": ref.unpack_1c}
    rows = {fmt: [] for fmt in runpack}
    for _ in range(20):
        start = int(rng.integers(0, n_rb))
        riv = dci.riv_encode(n_rb, start, int(rng.integers(1, n_rb - start + 1)))
        mcs, pid, rv, tpc = (int(rng.integers(0, m)) for m in (29, 8, 4, 4))
        ndi = bool(rng.integers(0, 2))
        s_g = int(rng.integers(0, n_vrb))
        riv_1c = dci.riv_encode(n_vrb, s_g, int(rng.integers(1, n_vrb - s_g + 1)))
        cases = [
            (dci.Dci1A(riv, mcs, pid, ndi, rv, tpc, bool(rng.integers(0, 2))),
             dci.pack_1a, ref.pack_1a, "0_1a", dci.dci1a_to_grant, ref.dci1a_to_grant),
            (dci.Dci0(riv, int(rng.integers(0, 32)), ndi, tpc, int(rng.integers(0, 8)),
                      bool(rng.integers(0, 2)), bool(rng.integers(0, 2))),
             dci.pack_0, ref.pack_0, "0_1a", dci.dci0_to_grant, ref.dci0_to_grant),
            (dci.Dci1(int(rng.integers(1, 1 << nbg)), mcs, pid, ndi, rv, tpc),
             dci.pack_1, ref.pack_1, "1", dci.dci1_to_grant, ref.dci1_to_grant),
            (dci.Dci1C(riv_1c, int(rng.integers(0, 32)), int(rng.integers(0, 2))),
             dci.pack_1c, ref.pack_1c, "1c", dci.dci1c_to_grant, ref.dci1c_to_grant),
        ]
        for mine, pack, rpack, fmt, to_grant, rto_grant in cases:
            ref_obj = getattr(ref, type(mine).__name__)(*dataclasses.astuple(mine))
            bits = pack(n_rb, mine)
            np.testing.assert_array_equal(bits, rpack(n_rb, ref_obj))
            rows[fmt].append(bits)
            got = dci.unpack(n_rb, fmt, bits)
            _same_dci(got, runpack[fmt](n_rb, bits))
            if type(mine).__name__ != "Dci1C" or n_rb >= 50:
                _same(got, mine)
            _same(to_grant(cell, got), rto_grant(rcell, runpack[fmt](n_rb, bits)))
        rar = SimpleNamespace(riv=riv, mcs=int(rng.integers(0, 16)))
        _same(dci.rar_to_ul_grant(cell, rar), ref.rar_to_ul_grant(rcell, rar))
    for fmt, packed in rows.items():
        size = dci.size(n_rb, fmt)
        bits = np.concatenate([np.stack(packed), rng.integers(0, 2, (40, size), np.uint8),
                               np.zeros((1, size), np.uint8), np.ones((1, size), np.uint8)])
        got = dci.unpack_rows(n_rb, fmt, bits)
        assert len(got) == len(bits)
        for d, row in zip(got, bits, strict=True):
            _same_dci(d, runpack[fmt](n_rb, row))
        if fmt == "0_1a":
            assert {type(d).__name__ for d in got[-42:]} == {"Dci0", "Dci1A"}
        assert dci.unpack_rows(n_rb, fmt, np.zeros((0, size), np.uint8)) == []
    with pytest.raises(ValueError, match="empty"):
        dci.dci1_to_grant(cell, dci.Dci1(0, 5, 0, True, 0, 0))
