"""The whole UE over the air, the port against the reference, TTI by TTI.

One reference eNB emulator (``srsue_tpu.enb.phy.EnbPhy``, JAX on the CPU)
sends its downlink subframes, with the OTA tests' noise, to two complete
UEs: the reference's ``Ue`` + ``Phy`` and the port's ``Ue`` +
``Phy(device="cpu")``, built from the same ``Cell`` and ``UsimConfig``
(the port's own dataclasses, field by field) and the same seeded identity
stream. The eNB hears the reference UE. Per TTI the two UEs must make the
same decisions (CFI, every DCI found, every TB CRC and turbo iteration
count, every PHICH decision, every HARQ-ACK sent) and transmit the same
uplink waveform within float32 tolerance, with SNR, RSRP, pathloss and CFO
within tolerance. Then the port's UE attaches to the reference eNB at the
same TTI as the reference UE (``test_torch_ota_cross.py`` has the other
direction).
"""

import dataclasses
import random

import numpy as np
import pytest

from srsue_tpu.enb import phy as ref_enb_phy
from srsue_tpu.enb import stack as ref_stack
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import control as ref_control
from srsue_tpu.phy import phy as ref_phy
from srsue_tpu.rrc import rrc as ref_rrc
from srsue_tpu.ue import Ue as RefUe
from srsue_tpu.usim import usim as ref_usim
from srsue_tpu_torch.enb import phy as enb_phy
from srsue_tpu_torch.enb import stack
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import control, dci
from srsue_tpu_torch.phy import phy
from srsue_tpu_torch.phy.ue_dl import UeDl
from srsue_tpu_torch.rrc import rrc
from srsue_tpu_torch.ue import Ue
from srsue_tpu_torch.usim import usim

N_PRB, CELL_ID, NOISE, MAX_TTI = 15, 123, 0.01, 200
UL_PKT, DL_PKT = b"\x45\x00over-the-air!", b"\x45\x00downlink-data"
# tolerances of the float32 measurements and the UL waveform (host numpy in
# both UEs; its amplitude follows the measured pathloss and its
# pre-rotation the tracked CFO, both read off float32 device work)
DB_ATOL, CFO_ATOL, UL_RTOL, UL_ATOL = 1e-3, 1e-6, 1e-4, 1e-6


def port_cell_of(cell):
    """The port's Cell with the fields of the reference's."""
    return port_cell.Cell(**dataclasses.asdict(cell))


def port_usim_of(cfg):
    """The port's UsimConfig with the fields of the reference's (IMSI, IMEI,
    K, OP, AMF, algorithm): both UEs then hold the same keys."""
    return usim.UsimConfig(**dataclasses.asdict(cfg))


class SeededOs:
    """``os`` for a module whose only use of it is ``os.urandom``."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def urandom(self, n: int) -> bytes:
        return bytes(self._rng.getrandbits(8) for _ in range(n))


def seed_identities(mp):
    """The UE identity (RRC), RAND and GUTI (eNB stack) of both packages from
    one seeded stream per module."""
    for mod, seed in ((ref_rrc, 1), (rrc, 1), (ref_stack, 2), (stack, 2)):
        mp.setattr(mod, "os", SeededOs(seed))


def noise(rng, shape):
    return NOISE * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
                    ).astype(np.complex64)


def make_ue(pkg: str, cell, cfg=None):
    if pkg == "ref":
        p = ref_phy.Phy(cell)
        ue = RefUe(phy=p, usim_cfg=cfg)
    else:
        p = phy.Phy(port_cell_of(cell), device="cpu")
        ue = Ue(phy=p, usim_cfg=cfg)
    p.mac, p.rrc = ue.mac, ue.rrc
    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
    return p, ue


def make_enb(pkg: str, cell, usim_cfg):
    if pkg == "ref":
        st = ref_stack.EnbStack(ref_usim.UsimConfig(**dataclasses.asdict(usim_cfg)))
        return st, ref_enb_phy.EnbPhy(cell, st)
    st = stack.EnbStack(port_usim_of(usim_cfg))
    return st, enb_phy.EnbPhy(port_cell_of(cell), st, device="cpu")


def _hits(hits):
    return [(int(s), int(l), np.asarray(b, np.uint8).tobytes()) for s, l, b in hits]


class Decisions:
    """Logs, per TTI, what one UE's PHY decided: the CFI, every blind search's
    hits, every PHICH metric's sign, every TB decode (CRC, iterations) and
    the HARQ-ACK counters. The reference's searches are its
    ``control.pdcch_blind_decode`` calls, one DCI size each; the port's are
    its ``UeDl.search`` calls, which ``Phy.work`` makes one format each."""

    def __init__(self, mp, ctl, p, ue):
        self.log: list = []
        self.p, self.ue = p, ue
        for fn, entry in (
                ("pcfich_decode", lambda r, a: ("cfi", int(np.asarray(r[0])))),
                ("phich_decode", lambda r, a: ("phich", a[3], a[4],
                                               bool(float(np.asarray(r)) > 0)))):
            self._wrap(mp, ctl, fn, entry)
        if ctl is control:
            self._wrap(mp, UeDl, "search", lambda r, a: (
                "dci", a[5], dci.size(a[0].cell.n_prb, *a[7]),
                _hits((s, l, b) for _, s, l, b in r[0])))
        else:
            self._wrap(mp, ctl, "pdcch_blind_decode",
                       lambda r, a: ("dci", a[5], a[6], _hits(r)))
        tb = ue.mac.tb_decoded

        def tb_decoded(pid, codec, softbuffers, rnti_type="CRNTI"):
            ok = tb(pid, codec, softbuffers, rnti_type)
            self.log.append(("tb", pid, rnti_type, bool(ok), codec.grant.tbs,
                             ue.mac.dl_harq.metrics.get("last_iters")))
            return ok

        ue.mac.tb_decoded = tb_decoded

    def _wrap(self, mp, owner, fn, entry):
        orig = getattr(owner, fn)

        def wrapped(*a, **kw):
            r = orig(*a, **kw)
            if getattr(owner, fn) is wrapped:
                self.log.append(entry(r, a))
            return r

        mp.setattr(owner, fn, wrapped)

    def take(self):
        m = self.p.metrics
        out = self.log + [("acks", m["ack_tx"], m["nack_tx"], m["ul_tx"], m["ul_retx"],
                           m["cqi_tx"], m["dl_ok"], m["dl_ko"])]
        self.log = []
        return out

    def measured(self):
        return (self.p.metrics["snr_db"], self.p.serving_rsrp_dbm, self.p.pathloss_db,
                self.p.cfo_norm, self.p.metrics["pusch_dbm"])


@pytest.fixture(scope="module")
def lockstep():
    """The reference eNB and UE over the air with the port's UE in lockstep
    beside it: attach, one UL and one DL packet. Returns the per-TTI
    readings of both UEs and the run's outcome."""
    cell = ref_cell.Cell(n_prb=N_PRB, cell_id=CELL_ID)
    with pytest.MonkeyPatch.context() as mp:
        seed_identities(mp)
        rp, rue = make_ue("ref", cell)
        pp, pue = make_ue("port", cell, port_usim_of(rue.usim.cfg))
        st, enb = make_enb("ref", cell, rue.usim.cfg)
        # the two control modules are distinct: each UE's log sees its own
        rlog, plog = Decisions(mp, ref_control, rp, rue), Decisions(mp, control, pp, pue)
        rng = np.random.default_rng(0)
        ttis, attach_tti, stage = [], None, "attach"
        for tti in range(MAX_TTI + 2 * 60):
            dl = enb.build_dl_subframe(tti)
            dl = dl + noise(rng, dl.shape)  # throughout: the SNR stays finite
            ul_r = rp.work(tti, dl)
            rue.run_tti(tti)
            ul_p = pp.work(tti, dl)
            pue.run_tti(tti)
            ttis.append((tti, rlog.take(), plog.take(), rlog.measured(), plog.measured(),
                         ul_r, ul_p))
            enb.receive_ul(tti, ul_r)
            if stage == "attach" and rue.is_attached and st.state == "attached":
                attach_tti, stage = tti, "ul"
                assert pue.is_attached
                rue.gw.backend.inject_ul(UL_PKT)
                pue.gw.backend.inject_ul(UL_PKT)
            elif stage == "ul" and st.rx_packets:
                stage = "dl"
                st.send_user_packet(DL_PKT)
            elif stage == "dl" and list(rue.gw.backend.to_net):
                break
    return {"ttis": ttis, "attach_tti": attach_tti, "events": list(enb.events),
            "stack_events": list(st.events), "rx_packets": list(st.rx_packets),
            "ref_dl": list(rue.gw.backend.to_net), "port_dl": list(pue.gw.backend.to_net),
            "port_attached": pue.is_attached, "port_crnti": pue.mac.crnti,
            "ref_crnti": rue.mac.crnti, "enb_crnti": enb.crnti}


def test_the_reference_attaches_and_delivers(lockstep):
    assert lockstep["attach_tti"] is not None, lockstep["events"][:30]
    assert lockstep["rx_packets"] == [UL_PKT]
    assert lockstep["ref_dl"] == [DL_PKT]
    assert "auth_ok" in lockstep["stack_events"] and "nas_smc_ok" in lockstep["stack_events"]


def test_the_port_ue_attaches_and_delivers_in_lockstep(lockstep):
    assert lockstep["port_attached"]
    assert lockstep["port_crnti"] == lockstep["ref_crnti"] == lockstep["enb_crnti"]
    assert lockstep["port_dl"] == [DL_PKT]


def test_decisions_match_every_tti(lockstep):
    kinds = set()
    for tti, ref, mine, *_ in lockstep["ttis"]:
        assert mine == ref, f"TTI {tti}"
        kinds |= {e[0] for e in ref}
    assert kinds == {"cfi", "dci", "tb", "phich", "acks"}


def test_measurements_match_every_tti(lockstep):
    for tti, _, _, ref, mine, *_ in lockstep["ttis"]:
        snr, rsrp, pl, cfo, pusch = ref
        assert mine[0] == pytest.approx(snr, abs=DB_ATOL), f"SNR, TTI {tti}"
        assert mine[1] == pytest.approx(rsrp, abs=DB_ATOL), f"RSRP, TTI {tti}"
        assert mine[2] == pytest.approx(pl, abs=DB_ATOL), f"pathloss, TTI {tti}"
        assert mine[3] == pytest.approx(cfo, abs=CFO_ATOL), f"CFO, TTI {tti}"
        assert mine[4] == pytest.approx(pusch, abs=DB_ATOL), f"PUSCH power, TTI {tti}"


def test_uplink_waveforms_match_every_tti(lockstep):
    n_ul = 0
    for tti, *_, ul_r, ul_p in lockstep["ttis"]:
        assert (ul_p is None) == (ul_r is None), f"TTI {tti}"
        if ul_r is not None:
            n_ul += 1
            assert ul_p.dtype == np.complex64 and ul_p.shape == ul_r.shape
            np.testing.assert_allclose(ul_p, ul_r, rtol=UL_RTOL,
                                       atol=UL_ATOL * float(np.abs(ul_r).max()),
                                       err_msg=f"TTI {tti}")
    assert n_ul >= 20  # PRACH, Msg3, PUSCH, PUCCH ACKs and CQI


def attach_across(ue_pkg: str, enb_pkg: str):
    """One UE attaching to one eNB over the air (seeded noise and
    identities): (attach TTI, the eNB's events)."""
    cell = ref_cell.Cell(n_prb=N_PRB, cell_id=CELL_ID)
    with pytest.MonkeyPatch.context() as mp:
        seed_identities(mp)
        p, ue = make_ue(ue_pkg, cell, None if ue_pkg == "ref" else usim.UsimConfig())
        st, enb = make_enb(enb_pkg, cell, ue.usim.cfg)
        rng = np.random.default_rng(0)
        for tti in range(MAX_TTI):
            dl = enb.build_dl_subframe(tti)
            ul = p.work(tti, dl + noise(rng, dl.shape))
            ue.run_tti(tti)
            enb.receive_ul(tti, ul)
            if ue.is_attached and st.state == "attached":
                return tti, list(enb.events)
    raise AssertionError(f"no attach: {enb.events[:30]}")


def test_port_ue_attaches_to_the_reference_enb(lockstep):
    tti, events = attach_across("port", "ref")
    assert tti == lockstep["attach_tti"]
    assert events == lockstep["events"][:len(events)]
