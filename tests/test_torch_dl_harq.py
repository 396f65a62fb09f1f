"""The port's DL HARQ entity (mac/dl_harq.py) against the JAX package's:
rv0 at 2 dB fails alone, rv0 + rv2 soft-combined passes, and both entities
give the same ACKs, deliveries and metrics. The rv0 softbuffer is the JAX
codec's, carried into the port as numpy; the rv2 softbuffer each side
computes from the same noisy IQ with its own chain."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from srsue_tpu.mac.dl_harq import DlHarq as RefHarq
from srsue_tpu.mac.pdu import bits_to_bytes
from srsue_tpu.phy import chest as ref_chest
from srsue_tpu.phy import enb_tx
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy.cell import Cell as RefCell
from srsue_tpu.phy.pdsch import PdschCodec as RefCodec
from srsue_tpu_torch.mac.dl_harq import BCCH_PID, DlHarq
from srsue_tpu_torch.phy import chest, equalize, ofdm, ra
from srsue_tpu_torch.phy.cell import Cell
from srsue_tpu_torch.phy.pdsch import PdschCodec

CELL = RefCell(n_prb=6, cell_id=9)
PCELL = Cell(n_prb=6, cell_id=9)  # the port's own object, the same fields
SF, RNTI, MCS, SNR_DB = 1, 0x10, 9, 2.0


def _noisy(rng, codec, payload):
    td = enb_tx.to_waveform(CELL, enb_tx.build_pdsch_subframe(CELL, codec, payload))[0][None]
    p_sig = float(np.mean(np.abs(td) ** 2)) * CELL.nfft / CELL.n_sc
    return enb_tx.awgn(rng, td, SNR_DB, signal_power=p_sig)[0]


def _ref_bufs(codec, noisy):
    g = ref_ofdm.demodulate(CELL, jnp.asarray(noisy))
    h, nv, _ = ref_chest.estimate(CELL, g, SF, port=0)
    x, nve = ref_eq.zf(codec.extract_re(g), codec.extract_re(h), nv)
    return codec.dematch(codec.demap_llrs(x, nve))


def _port_bufs(codec, noisy):
    g = ofdm.demodulate(PCELL, torch.as_tensor(noisy))
    h, nv, _ = chest.estimate(PCELL, g, SF, port=0)
    x, nve = equalize.zf(codec.extract_re(g), codec.extract_re(h), nv)
    return codec.dematch(codec.demap_llrs(x, nve))


def test_rv0_rv2_combining_matches_reference():
    rng = np.random.default_rng(42)
    g0, g2 = (ref_ra.dl_grant(CELL.n_prb, MCS, rv=rv) for rv in (0, 2))
    p0, p2 = (ra.dl_grant(PCELL.n_prb, MCS, rv=rv) for rv in (0, 2))
    assert [dataclasses.astuple(g) for g in (p0, p2)] == [dataclasses.astuple(g) for g in (g0, g2)]
    ref0, ref2 = (RefCodec(CELL, g, rnti=RNTI, subframe=SF, cfi=1) for g in (g0, g2))
    mine0, mine2 = (PdschCodec(PCELL, g, rnti=RNTI, subframe=SF, cfi=1, device="cpu")
                    for g in (p0, p2))
    payload = rng.integers(0, 2, g0.tbs).astype(np.uint8)
    iq0, iq2 = _noisy(rng, ref0, payload), _noisy(rng, ref2, payload)

    bufs0_ref = _ref_bufs(ref0, iq0)
    bufs0 = [torch.as_tensor(np.array(b)) for b in bufs0_ref]
    runs = {}
    for name, harq_cls, codec, first, second, (h0, h2) in (
            ("ref", RefHarq, ref0, bufs0_ref, _ref_bufs(ref2, iq2), (g0, g2)),
            ("port", DlHarq, mine0, bufs0, _port_bufs(mine2, iq2), (p0, p2))):
        got = []
        harq = harq_cls(lambda pid, data: got.append((pid, data)))
        acks = [harq.new_grant_dl(0, h0), harq.tb_decoded(0, codec, first),
                harq.new_grant_dl(0, h2), harq.tb_decoded(0, codec, second),
                harq.tb_decoded(0, codec, second)]  # delivered: re-ACK, no decode
        flipped = dataclasses.replace(h0, ndi=not h0.ndi)
        acks += [harq.new_grant_dl(0, flipped), harq.new_grant_dl(BCCH_PID, h0),
                 harq.new_grant_dl(BCCH_PID, h2)]
        runs[name] = (acks, got, dict(harq.metrics))
    assert runs["port"] == runs["ref"]
    acks, got, metrics = runs["port"]
    # new, NACK, retransmission, ACK, re-ACK, NDI toggled, BCCH new, BCCH same TBS
    assert acks == [True, False, False, True, True, True, True, False]
    assert got == [(0, bits_to_bytes(payload))]
    assert metrics["rx_ok"] == 1 and metrics["rx_ko"] == 1 and metrics["rx_brate"] == g0.tbs
