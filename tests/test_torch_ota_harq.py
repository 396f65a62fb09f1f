"""The port's whole UE over the air on the CPU: the closed HARQ loops
through combining, the attach on a 2-port (TM2) cell, and attaches across
an injected LO offset. Counterparts of the slow tests of
``tests/test_harq_ota.py``, ``tests/test_ota_attach_tm2.py`` and
``tests/test_ota_attach_cfo.py``, on the port's Ue, Phy and EnbPhy. They
are not slow here: the port's UE takes 3-10 s per attach on the CPU, where
the reference's JAX UE takes minutes."""

import numpy as np
import pytest

from tests.test_harq_ota import UL_ERASABLE, _erase_symbols
from tests.test_torch_ota import mk, rot


def attach(cell, phy, ue, enb_stack, enb, rng, max_tti=220, cfo_norm=0.0):
    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
    for tti in range(max_tti):
        dl = enb.build_dl_subframe(tti)
        dl = dl + 0.01 * (rng.standard_normal(dl.shape) + 1j * rng.standard_normal(dl.shape)
                          ).astype(np.complex64)
        ul = phy.work(tti, rot(cell, dl, tti, cfo_norm) if cfo_norm else dl)
        ue.run_tti(tti)
        if ul is not None and cfo_norm:
            ul = rot(cell, ul, tti, -cfo_norm)
        enb.receive_ul(tti, ul)
        if ue.is_attached and enb_stack.state == "attached":
            return tti
    return None


def test_dl_harq_retx_combining_over_the_air():
    cell, phy, ue, enb_stack, enb = mk()
    tti0 = attach(cell, phy, ue, enb_stack, enb, np.random.default_rng(3)) + 1
    dpkt = b"\x45\x00harq-combining-payload"
    enb_stack.send_user_packet(dpkt)
    n_round = 0
    for tti in range(tti0, tti0 + 120):
        dl = enb.build_dl_subframe(tti)
        if tti % 10 in (3, 7):
            dl = _erase_symbols(cell, dl, n_round)
            n_round += 1
        ul = phy.work(tti, dl)
        ue.run_tti(tti)
        enb.receive_ul(tti, ul)
        if list(ue.gw.backend.to_net):
            break
    assert "dl_nack" in enb.events and "dl_ack" in enb.events, enb.events
    assert any(e.startswith("dl_retx_rv") for e in enb.events), enb.events
    assert list(ue.gw.backend.to_net) == [dpkt], enb.events


def test_ul_harq_autonomous_retx_over_the_air():
    cell, phy, ue, enb_stack, enb = mk()
    tti0 = attach(cell, phy, ue, enb_stack, enb, np.random.default_rng(5)) + 1
    pkt = b"\x45\x00uplink-harq-payload"
    ue.gw.backend.inject_ul(pkt)
    n_round = 0
    for tti in range(tti0, tti0 + 120):
        dl = enb.build_dl_subframe(tti)
        ul = phy.work(tti, dl)
        ue.run_tti(tti)
        if ul is not None and phy._phich_wait.get(tti + 4) == tti:
            ul = _erase_symbols(cell, ul, n_round, erasable=UL_ERASABLE, n_erase=9, step=6)
            n_round += 1
        enb.receive_ul(tti, ul)
        if enb_stack.rx_packets:
            break
    assert enb_stack.rx_packets == [pkt], enb.events
    assert any(e.startswith("ul_nack_rv0") for e in enb.events), enb.events
    assert any(e.startswith("ul_retx_ok_rv") for e in enb.events), enb.events
    assert ue.mac.ul_harq.metrics["retx"] >= 1 and phy.metrics["ul_retx"] >= 1


def test_over_the_air_attach_tm2():
    cell, phy, ue, enb_stack, enb = mk(n_ports=2)
    assert enb.tm2
    tti = attach(cell, phy, ue, enb_stack, enb, np.random.default_rng(0))
    assert tti is not None, enb.events[:30]
    assert ue.mac.crnti == enb.crnti
    for pkt, send, got in ((b"\x45\x00tm2-uplink!", ue.gw.backend.inject_ul,
                            lambda: enb_stack.rx_packets),
                           (b"\x45\x00tm2-downlink", enb_stack.send_user_packet,
                            lambda: list(ue.gw.backend.to_net))):
        send(pkt)
        for t in range(tti + 1, tti + 61):
            ul = phy.work(t, enb.build_dl_subframe(t))
            ue.run_tti(t)
            enb.receive_ul(t, ul)
            if got():
                break
        tti = t
        assert got() == [pkt]


@pytest.mark.parametrize("cfo_hz", [300.0, -300.0])
def test_ota_attach_with_injected_cfo(cfo_hz):
    cell, phy, ue, enb_stack, enb = mk()
    tti = attach(cell, phy, ue, enb_stack, enb, np.random.default_rng(5),
                 cfo_norm=cfo_hz / 15000.0)
    assert tti is not None, f"attach failed with cfo={cfo_hz} Hz"
    assert abs(phy.cfo_norm * 15000.0 - cfo_hz) < 60.0


def test_ota_attach_cfo_uncompensated_fails_at_900hz():
    cell, phy, ue, enb_stack, enb = mk()
    phy.cfo_track = False
    tti = attach(cell, phy, ue, enb_stack, enb, np.random.default_rng(5), max_tti=160,
                 cfo_norm=900.0 / 15000.0)
    assert tti is None, f"attach unexpectedly passed at tti={tti}"


def test_ota_attach_cfo_compensated_survives_900hz():
    cell, phy, ue, enb_stack, enb = mk()
    tti = attach(cell, phy, ue, enb_stack, enb, np.random.default_rng(5),
                 cfo_norm=900.0 / 15000.0)
    assert tti is not None, "compensated attach failed at 900 Hz"
    assert abs(phy.cfo_norm * 15000.0 - 900.0) < 120.0
