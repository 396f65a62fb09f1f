"""The reference transmitter and receiver round-trip at 6 PRB, and the
bf16 control departs from the float32 reference."""

import numpy as np
import pytest
import torch

from perfbench.reference import receiver, transmitter

SMALL = {"n_prb": 6, "cell_id": 42, "subframe": 6, "cfi": 3, "rnti": 0x1234, "mcs": 20,
         "turbo_iters": 8, "snr_db": 26.0}


def noisy(cfg, seed, n):
    clean = transmitter.build(cfg, seed, n)
    gen = torch.Generator().manual_seed(seed)
    iq = transmitter.add_noise(torch.as_tensor(clean.td), clean.p_sig, cfg["snr_db"], gen)
    return clean, iq.numpy()


@pytest.mark.parametrize("ports", [1, 2])
def test_round_trip(ports):
    cfg = {**SMALL, "n_ports": ports}
    clean, iq = noisy(cfg, 2**31 + 5, 3)
    out = receiver.Receiver(cfg).ue_dl(iq)
    assert (out.payload == clean.payloads).all() and out.tb_ok.all()
    assert out.cfi == cfg["cfi"]
    sent = receiver.hit("0_1a", receiver.dci.unpack_0_1a(6, clean.dci_bits))
    assert all(h == [sent] for h in out.hits)
    assert ((out.iters >= 1) & (out.iters <= 8)).all()


def test_forced_round_trip():
    cfg = {**SMALL, "n_ports": 1}
    clean, iq = noisy(cfg, 11, 2)
    out = receiver.Receiver(cfg).grant_known(iq, forced=True)
    assert (out.payload == clean.payloads).all() and out.tb_ok.all()
    assert (out.iters == 8).all()


def test_seed_gives_the_same_inputs():
    cfg = {**SMALL, "n_ports": 1}
    a, b = transmitter.build(cfg, 2**33 + 1, 2), transmitter.build(cfg, 2**33 + 1, 2)
    assert np.array_equal(a.td, b.td) and np.array_equal(a.payloads, b.payloads)
    assert not np.array_equal(a.payloads[0], a.payloads[1])


def test_bf16_control_departs():
    cfg = {**SMALL, "n_ports": 1}
    _, iq = noisy(cfg, 3, 2)
    ref = receiver.Receiver(cfg)
    exact, ctl = ref.grant_known(iq, True), ref.grant_known(iq, True, receiver.bf16)
    err = max(np.linalg.norm(c - e) / np.linalg.norm(e) for c, e in zip(ctl.softbuf, exact.softbuf))
    assert err > 1e-3
