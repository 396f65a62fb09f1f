"""An uplink subframe shared by several UEs (``phy/pusch.py::PuschCell``) on
the CPU, at a 5 MHz cell (25 PRB).

Each UE's payload, CRC flag, iterations, CQI and ACK from the shared receive
equal what its own ``PuschCodec.decode_sf`` gives on the same IQ. Its
softbuffers agree within 1e-6 relative (L2): the shared receive runs one
IDFT over the allocations of one size, whose rounding may differ from a
lone IDFT's. One allocation alone takes the codec's own path, bit for bit.
An allocation off PRB 0 with QPSK, received beside the others, equals the
JAX package's ``PuschCodec`` (the oracle) within the tolerance of
``tests/test_torch_pusch.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import pusch as ref_pusch
from srsue_tpu.phy.cell import Cell as RefCell
from srsue_tpu.phy.cell import UlGrant as RefGrant
from srsue_tpu_torch.phy import pusch, turbo
from srsue_tpu_torch.phy.cell import Cell, UlGrant

CELL = Cell(n_prb=25, cell_id=301)
SUBFRAME, B, SNR_DB = 2, 2, 20.0
# name -> UEs: (n_prb, prb_start, qm, tbs, rnti, cyclic shift, CQI bits)
LAYOUTS = {
    "12_6_4": [(12, 1, 4, 4968, 0x1234, 0, 4), (6, 13, 2, 600, 0x1235, 6, 0),
               (4, 19, 2, 176, 0x1236, 3, 0)],
    "shared_sizes": [(6, 1, 2, 600, 0x1234, 0, 4), (6, 7, 2, 600, 0x1235, 6, 0),
                     (8, 13, 4, 1800, 0x1236, 3, 4), (4, 21, 2, 176, 0x1237, 9, 0)],
}
# (IDFT groups, K-groups) a step: one per allocation size, one per K
GROUPS = {"12_6_4": (3, 3), "shared_sizes": (3, 3)}


def _codecs(layout, device="cpu"):
    return [pusch.PuschCodec(CELL, UlGrant(n, start, 0, qm, tbs), rnti, SUBFRAME,
                             n_cqi_bits=cqi, with_ack=True, device=device)
            for n, start, qm, tbs, rnti, _, cqi in layout]


def _subframes(codecs, layout, seed):
    """B noisy subframes of every UE at once, each UE with its own TB, CQI and
    ACK in each, AWGN at SNR_DB per allocated subcarrier; and what was sent."""
    rng = np.random.default_rng(seed)
    sent, waves = [], []
    for _ in range(B):
        row, wave = [], 0
        for c, ue in zip(codecs, layout):
            payload = rng.integers(0, 2, c.grant.tbs).astype(np.uint8)
            cqi = rng.integers(0, 2, c.n_cqi_bits).astype(np.uint8) if c.n_cqi_bits else None
            ack = bool(rng.integers(0, 2))
            wave = wave + c.encode_sf_uci(payload, cqi_bits=cqi, ack=ack, cyclic_shift=ue[5])
            row.append((payload, cqi, ack))
        sent.append(row)
        waves.append(wave)
    x = np.stack(waves)
    m_sc = sum(c.m_sc for c in codecs)
    nv = float(np.mean(np.abs(x) ** 2)) * CELL.nfft / m_sc / 10 ** (SNR_DB / 10)
    x = x + np.sqrt(nv / 2) * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return torch.as_tensor(x.astype(np.complex64)), nv, sent


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_each_ue_equals_its_codec_alone(name, monkeypatch):
    layout = LAYOUTS[name]
    codecs = _codecs(layout)
    iq, nv, sent = _subframes(codecs, layout, seed=len(layout))
    rx = pusch.PuschCell(CELL, codecs, [ue[5] for ue in layout])
    calls = {"turbo": 0, "ifft": 0}
    decode, ifft = turbo.decode, torch.fft.ifft

    def counted(what, fn):
        def call(*a, **kw):
            calls[what] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(turbo, "decode", counted("turbo", decode))
    monkeypatch.setattr(torch.fft, "ifft", counted("ifft", ifft))
    bufs = rx.dematch(iq, nv)
    decoded, uci = rx.decode(bufs), rx.decode_uci_sf()
    assert (calls["ifft"], calls["turbo"]) == GROUPS[name]
    monkeypatch.undo()
    for u, (c, ue) in enumerate(zip(codecs, layout)):
        alone = c.dematch_sf(iq, nv, ue[5])
        assert len(alone) == len(bufs[u])
        for a, b in zip(bufs[u], alone, strict=True):
            assert a.shape == b.shape == (B, b.shape[-1]) and _rel(a, b) <= 1e-6
        for a, b in zip(decoded[u], c.decode_softbuffers(alone), strict=True):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for a, b in zip(uci[u], c.decode_uci_sf(), strict=True):
            assert (a is None and b is None) or torch.equal(a, b)
        payload, tb_ok, iters = decoded[u]
        assert tb_ok.all() and iters.shape == (B, c.plan.c)
        for r in range(B):
            np.testing.assert_array_equal(payload[r].numpy(), sent[r][u][0])
            assert bool(uci[u][1][r]) is sent[r][u][2]
            if c.n_cqi_bits:
                np.testing.assert_array_equal(uci[u][0][r].numpy(), sent[r][u][1])


def test_one_allocation_is_the_codec_path():
    """A lone full-band allocation: softbuffers, decisions and UCI bit for
    bit those of its codec."""
    codec = pusch.PuschCodec(CELL, UlGrant(25, 0, 0, 4, 7224), 0x1234, SUBFRAME, n_cqi_bits=4,
                             with_ack=True, device="cpu")
    iq, nv, _ = _subframes([codec], [(25, 0, 4, 7224, 0x1234, 5, 4)], seed=9)
    rx = pusch.PuschCell(CELL, [codec], [5])
    bufs = rx.dematch(iq, nv)
    uci = rx.decode_uci_sf()[0]
    got = rx.decode(bufs)[0]
    alone = codec.dematch_sf(iq, nv, 5)
    for a, b in zip(bufs[0], alone, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(got, codec.decode_softbuffers(alone), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(uci, codec.decode_uci_sf(), strict=True):
        assert torch.equal(a, b)
    assert got[1].all()


def test_qpsk_allocation_off_prb0_equals_the_jax_codec():
    """UE 1 of the 12/6/4 layout (6 PRB QPSK from PRB 13, cyclic shift 6),
    received beside the others, against the JAX codec on the same IQ: the
    softbuffers within rtol 1e-5 and a floor of 1e-5 of the peak, the
    payload, the CRC flag and the ACK equal."""
    layout = LAYOUTS["12_6_4"][:2]
    codecs = _codecs(layout)
    iq, nv, sent = _subframes(codecs, layout, seed=23)
    iq = iq[:1]
    rx = pusch.PuschCell(CELL, codecs, [0, 6])
    bufs = rx.dematch(iq, nv)
    (pay, ok, _), uci = rx.decode(bufs)[1], rx.decode_uci_sf()[1]
    n, start, qm, tbs, rnti, cs, _ = layout[1]
    ref = ref_pusch.PuschCodec(RefCell(n_prb=25, cell_id=301), RefGrant(n, start, 0, qm, tbs),
                               rnti, SUBFRAME, with_ack=True)
    bufs_r = ref.dematch_sf(jnp.asarray(iq.numpy()), nv, cs)
    for a, b in zip(bufs[1], bufs_r, strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    pay_r, ok_r = (np.asarray(v) for v in ref.decode_softbuffers(bufs_r))
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    np.testing.assert_array_equal(pay.numpy(), pay_r)
    assert ok.all() and (pay[0].numpy() == sent[0][1][0]).all()
    assert ref.decode_uci()[1] is bool(uci[1][0]) is sent[0][1][2]


@pytest.mark.parametrize("bad", ["overlap", "outside", "shifts"])
def test_cell_refuses_a_bad_layout(bad):
    layout = {"overlap": [(6, 1, 2, 600, 1, 0, 0), (6, 6, 2, 600, 2, 0, 0)],
              "outside": [(6, 20, 2, 600, 1, 0, 0)],
              "shifts": [(6, 1, 2, 600, 1, 0, 0)]}[bad]
    with pytest.raises(ValueError):
        pusch.PuschCell(CELL, _codecs(layout), [0, 0] if bad == "shifts" else [0] * len(layout))


def _row_cases():
    g = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    rows, other = list(g.unbind(-2)), torch.zeros(2, 6)
    return {  # name -> (blocks, whether they join as a view of g)
        "a K-group's rows": (rows, True),
        "consecutive rows of a group": (rows[1:3], True),
        "one row": (rows[2:3], True),
        "rows out of order": (rows[::-1], False),
        "a row twice": ([rows[0], rows[0]], False),
        "combined buffers": ([r + 0 for r in rows], False),
        "rows of two tensors": ([rows[3], other], False),
    }, g


@pytest.mark.parametrize("case", list(_row_cases()[0]))
def test_rows_join_a_k_group_without_a_copy(case):
    """``_rows`` gives what ``torch.stack(blocks, -2)`` gives; where the blocks
    are consecutive rows of one tensor (the demap's K-group, split for the
    caller), a view of it."""
    cases, g = _row_cases()
    blocks, view = cases[case]
    got = pusch._rows(blocks)
    assert torch.equal(got, torch.stack(blocks, -2))
    assert (got.untyped_storage().data_ptr() == g.untyped_storage().data_ptr()) is view


def test_decode_of_joined_rows_equals_decode_of_copies():
    """A codec's softbuffers decode alike whether ``_decode`` joins its
    K-group's rows as a view or stacks copies (as of HARQ-combined
    buffers)."""
    layout = [LAYOUTS["12_6_4"][1]]
    codec = _codecs(layout)[0]
    iq, nv, _ = _subframes([codec], layout, seed=11)
    bufs = codec.dematch_sf(iq, nv, layout[0][5])
    got = codec.decode_softbuffers(bufs)
    for a, b in zip(got, codec.decode_softbuffers([b.clone() for b in bufs]), strict=True):
        assert torch.equal(a, b)
    assert got[1].all()
