"""The A3-triggered handover over the air, the port's UE against the
reference's, TTI by TTI.

The reference's eNB emulators (JAX on the CPU) serve both UEs: the source
cell 123 and, from the handover on, the target cell 77 on the same stack;
until then a broadcast-only neighbour on cell 77 (its own stack) is added
to the source's waveform, 20 dB down and then 6 dB above the serving cell,
as ``tests/test_meas_report.py`` runs it. The reference's ``Ue`` + ``Phy``
and the port's ``Ue`` + ``Phy(device="cpu")`` get the same downlink (with
the OTA tests' noise) and the same seeded identities; the eNBs hear the
reference UE. Per TTI the two UEs make the same decisions (CFI, every DCI,
TB, PHICH and HARQ-ACK), stand on the same PCI, C-RNTI and RRC state,
measure the same serving and neighbour RSRP within float32 tolerance, and
send the same uplink waveform: through the attach, the measurement
configuration, the A3 report, the handover command, the dedicated-preamble
PRACH, the target's RAR and the Complete on the target.

``-m slow``: the reference's UE and eNBs on the CPU make this file take
120-160 s on its own (most of it the reference's XLA:CPU compiles and its
Viterbi scan), at or over the ~150 s a Tier-1 file may take. The single-subframe
lockstep (``test_torch_mobility_subframes.py``) and the port-only scenarios
(``test_torch_mobility.py``) run in Tier-1.
"""

import numpy as np
import pytest

from srsue_tpu.enb import phy as ref_enb_phy
from srsue_tpu.enb import stack as ref_stack
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import control as ref_control
from srsue_tpu.rrc.rrc import RrcState
from srsue_tpu.usim import usim as ref_usim
from srsue_tpu_torch.phy import control
from test_torch_ota_lockstep import (CFO_ATOL, DB_ATOL, UL_ATOL, UL_RTOL, Decisions, make_enb,
                                     make_ue, noise, port_usim_of, seed_identities)

N_PRB, SRC_PCI, NEW_PCI = 15, 123, 77
MAX_ATTACH, MAX_HO = 200, 600
# the reference's XLA:CPU workaround of test_meas_report.py: two cells' worth
# of jitted stages in one process; the persistent compile cache keeps it cheap
CLEAR_JAX_EVERY = 150

pytestmark = pytest.mark.slow


def _ids(ue):
    return (ue.rrc.pci, ue.mac.crnti, ue.rrc.state.name, ue.is_attached)


def _measured(log, p):
    return log.measured() + (dict(getattr(p, "neighbor_rsrp_dbm", {})),)


@pytest.fixture(scope="module")
def a3_lockstep():
    import jax

    cell1 = ref_cell.Cell(n_prb=N_PRB, cell_id=SRC_PCI)
    cell2 = ref_cell.Cell(n_prb=N_PRB, cell_id=NEW_PCI)
    with pytest.MonkeyPatch.context() as mp:
        seed_identities(mp)
        rp, rue = make_ue("ref", cell1)
        pp, pue = make_ue("port", cell1, port_usim_of(rue.usim.cfg))
        st, enb1 = make_enb("ref", cell1, rue.usim.cfg)
        neigh = ref_enb_phy.EnbPhy(cell2, ref_stack.EnbStack(
            ref_usim.UsimConfig(**vars(rue.usim.cfg))))
        rlog, plog = Decisions(mp, ref_control, rp, rue), Decisions(mp, control, pp, pue)
        rng = np.random.default_rng(0)
        ttis, marks = [], {}
        gain, enb2, tti = 0.1, None, 0
        while tti < MAX_ATTACH + MAX_HO:
            if tti % CLEAR_JAX_EVERY == 0:
                jax.clear_caches()
            attached = "attach" in marks
            if attached and "meas_configured" in st.events and gain < 2.0 and rue.rrc.meas_ids:
                gain = 2.0  # 6 dB over the serving cell
                marks["gain"] = tti
            if enb2 is None and "ho_initiated" in st.events:
                enb2 = ref_enb_phy.EnbPhy(cell2, st)
                marks["ho_initiated"] = tti
            on_target = enb2 is not None and rue.rrc.pci == NEW_PCI
            if on_target:
                dl = enb2.build_dl_subframe(tti)
            else:
                dl = enb1.build_dl_subframe(tti)
                if attached:
                    dl = dl + gain * neigh.build_dl_subframe(tti)
            dl = dl + noise(rng, dl.shape)
            ul_r = rp.work(tti, dl)
            rue.run_tti(tti)
            ul_p = pp.work(tti, dl)
            pue.run_tti(tti)
            ttis.append((tti, rlog.take(), plog.take(), _measured(rlog, rp),
                         _measured(plog, pp), ul_r, ul_p, _ids(rue), _ids(pue)))
            (enb2 if on_target else enb1).receive_ul(tti, ul_r)
            tti += 1
            if not attached and rue.is_attached and st.state == "attached":
                marks["attach"] = tti - 1
                st.configure_measurements([NEW_PCI], a3_offset_db=3.0, hysteresis_db=1.0,
                                          ttt="ms40")
            elif (on_target and st.state == "attached" and rue.rrc.state == RrcState.CONNECTED
                  and rue.mac.crnti == st.t_crnti):
                marks["complete"] = tti - 1
                break
    return {"ttis": ttis, "marks": marks, "stack_events": list(st.events),
            "enb1_events": list(enb1.events), "enb2_events": list(enb2.events) if enb2 else [],
            "meas_reports": list(st.meas_reports), "t_crnti": st.t_crnti,
            "ref": _ids(rue), "port": _ids(pue)}


def test_the_reference_reports_a3_and_hands_over(a3_lockstep):
    r = a3_lockstep
    assert {"attach", "gain", "ho_initiated", "complete"} <= set(r["marks"]), r["marks"]
    assert f"a3_report_pci{NEW_PCI}" in r["stack_events"], r["stack_events"]
    assert r["meas_reports"] and "ho_cmd_dl" in r["enb1_events"]
    assert "rar_sent" in r["enb2_events"] and "msg3" not in r["enb2_events"]
    assert "ho_complete" in r["stack_events"]
    assert r["ref"] == (NEW_PCI, r["t_crnti"], "CONNECTED", True)


def test_the_port_ue_stands_where_the_reference_ue_does_every_tti(a3_lockstep):
    seen = set()
    for tti, *_, ids_r, ids_p in a3_lockstep["ttis"]:
        assert ids_p == ids_r, f"TTI {tti}"
        seen.add(ids_r[:2])
    assert a3_lockstep["port"] == (NEW_PCI, a3_lockstep["t_crnti"], "CONNECTED", True)
    # the attach's C-RNTI, then the target's from mobilityControlInfo
    assert {c for _, c in seen} >= {0x4601, a3_lockstep["t_crnti"]}
    assert (NEW_PCI, a3_lockstep["t_crnti"]) in seen


def test_decisions_match_every_tti(a3_lockstep):
    kinds = set()
    for tti, ref, mine, *_ in a3_lockstep["ttis"]:
        assert mine == ref, f"TTI {tti}"
        kinds |= {e[0] for e in ref}
    assert kinds == {"cfi", "dci", "tb", "phich", "acks"}


def test_serving_and_neighbour_rsrp_match_every_tti(a3_lockstep):
    n_neigh = 0
    for tti, _, _, ref, mine, *_ in a3_lockstep["ttis"]:
        for i, (what, atol) in enumerate((("SNR", DB_ATOL), ("RSRP", DB_ATOL),
                                          ("pathloss", DB_ATOL), ("CFO", CFO_ATOL),
                                          ("PUSCH power", DB_ATOL))):
            assert mine[i] == pytest.approx(ref[i], abs=atol), f"{what}, TTI {tti}"
        assert mine[5].keys() == ref[5].keys(), f"TTI {tti}"
        for pci, v in ref[5].items():
            assert mine[5][pci] == pytest.approx(v, abs=DB_ATOL), f"neighbour {pci}, TTI {tti}"
        n_neigh += bool(ref[5])
    # measured from the measurement configuration to the retune
    assert n_neigh >= 40


def test_uplink_waveforms_match_every_tti(a3_lockstep):
    n_ul = 0
    for tti, *_, ul_r, ul_p, _, _ in a3_lockstep["ttis"]:
        assert (ul_p is None) == (ul_r is None), f"TTI {tti}"
        if ul_r is not None:
            n_ul += 1
            assert ul_p.dtype == np.complex64 and ul_p.shape == ul_r.shape
            np.testing.assert_allclose(ul_p, ul_r, rtol=UL_RTOL,
                                       atol=UL_ATOL * float(np.abs(ul_r).max()),
                                       err_msg=f"TTI {tti}")
    assert n_ul >= 30  # PRACH twice, Msg3, the report, the Complete, PUCCH
