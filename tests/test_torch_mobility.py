"""The reference's over-the-air mobility and UL-control scenarios, rerun on
the port's ``Ue`` + ``Phy`` + ``EnbPhy`` on the CPU.

Each scenario is the reference's own test function (its loop, its seeds,
its 15 PRB cells and its assertions), loaded with its imports pointed at
``srsue_tpu_torch`` as ``tests/test_torch_stack.py`` loads the stack tests,
and with the port's ``Phy`` and ``EnbPhy`` built on ``device="cpu"``:

* ``test_ota_handover.py``: the handover command over the source cell's
  PDSCH, the dedicated-preamble PRACH detected by the target, its RAR, the
  Complete on the target's SRB1, a packet each way on the target;
* ``test_meas_report.py``: event A3 armed by measConfig, the neighbour's
  CRS RSRP measured from the combined waveform, the MeasurementReport over
  PUSCH and the handover it triggers (its ``jax.clear_caches()`` is the
  reference's XLA:CPU workaround, which runs as written and clears only the
  reference's caches; the port has no counterpart of it);
* ``test_paging.py``: a page found at the UE's paging occasion;
* ``test_ulctrl_ota.py``: periodic CQI on PUCCH format 2, SRS detected, the
  open-loop power tracking the pathloss;
* ``test_subband_cqi.py``: the subband CQI labels on a two-tap channel, and
  its unit scenarios on the port's ``ue_ul_ctrl``.

The unit scenarios of ``test_paging.py`` and ``test_meas_report.py`` run in
``tests/test_torch_stack.py``.
"""

import ast

import numpy as np
import pytest

from srsue_tpu_torch.enb import phy as enb_phy
from srsue_tpu_torch.phy import phy
from test_torch_stack import REPO, _load

SCENARIOS = (
    ("test_ota_handover", "test_over_the_air_handover"),
    ("test_meas_report", "test_ota_a3_measurement_triggers_handover"),
    ("test_paging", "test_paging_over_the_air"),
    ("test_ulctrl_ota", "test_cqi_srs_power_over_the_air"),
    ("test_subband_cqi", "test_subband_cqi_tracks_selective_channel_over_the_air"),
    ("test_subband_cqi", "test_subband_schedule_and_payload"),
    ("test_subband_cqi", "test_subband_occasion_before_first_measurement_keeps_shape"),
)


PHY, ENB_PHY = phy.Phy, enb_phy.EnbPhy


def _on_cpu(cls):
    """`cls` with ``device="cpu"`` as its default."""

    class OnCpu(cls):
        def __init__(self, *a, device="cpu", **kw):
            super().__init__(*a, device=device, **kw)

    OnCpu.__name__ = OnCpu.__qualname__ = cls.__name__
    return OnCpu


@pytest.fixture
def port_on_cpu(monkeypatch):
    """The port's Phy and EnbPhy default to the CPU while a scenario is
    loaded and run (its module-level and in-function imports both read the
    module attributes)."""
    monkeypatch.setattr(phy, "Phy", _on_cpu(phy.Phy))
    monkeypatch.setattr(enb_phy, "EnbPhy", _on_cpu(enb_phy.EnbPhy))


@pytest.mark.parametrize("name, scenario", SCENARIOS, ids=[f"{f}::{t}" for f, t in SCENARIOS])
def test_reference_scenario_on_the_port(name, scenario, port_on_cpu):
    _load(name, "srsue_tpu_torch")[scenario]()


def test_every_over_the_air_scenario_of_these_files_is_run():
    """No scenario of the five files is left out: the OTA ones run here, the
    unit ones of paging and A3 in ``tests/test_torch_stack.py``."""
    from test_torch_stack import CASES

    run = set(SCENARIOS) | set(CASES)
    for name in dict.fromkeys(f for f, _ in SCENARIOS):
        tree = ast.parse((REPO / "tests" / f"{name}.py").read_text())
        for n in tree.body:
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_"):
                assert (name, n.name) in run, (name, n.name)


def test_the_scenarios_build_the_ports_classes_on_the_cpu(port_on_cpu):
    """The loaded handover scenario reaches the port's own Phy and EnbPhy,
    and both are built on the CPU."""
    ns = _load("test_ota_handover", "srsue_tpu_torch")
    cell = ns["Cell"](n_prb=6, cell_id=ns["SRC_PCI"])
    ue_phy = ns["Phy"](cell)
    enb = ns["EnbPhy"](cell, ns["EnbStack"]())
    assert isinstance(ue_phy, PHY) and isinstance(enb, ENB_PHY)
    assert ue_phy.device.type == enb.device.type == "cpu"


@pytest.mark.parametrize("pkg", ["srsue_tpu", "srsue_tpu_torch"])
def test_dl_assignments_carry_tpc_minus_1_db_in_both_packages(pkg, monkeypatch):
    """ROADMAP fault 6, kept and pinned: the eNB emulator's DCI 1A carries
    TPC command 0 (-1 dB, accumulated) on every DL assignment, in the
    reference as in the port, and each UE's PUCCH power falls by 1 dB per
    assignment decoded, with no floor. After tens of assignments the UE's
    PUCCH HARQ-ACKs fall under the emulator's detection threshold: after the
    A3 handover a DL packet gets through only after HARQ drops and RLC
    retransmissions (chip_smoke phase 17 gives it the TTIs)."""
    import importlib

    mods = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "enb.phy", "enb.stack", "phy.cell", "phy.dci", "phy.phy")}
    cell = mods["phy.cell"].Cell(n_prb=6, cell_id=123)
    kw = {"device": "cpu"} if pkg == "srsue_tpu_torch" else {}
    enb = mods["enb.phy"].EnbPhy(cell, mods["enb.stack"].EnbStack(), **kw)
    sent = []
    ctl = mods["enb.phy"].control
    monkeypatch.setattr(ctl, "pdcch_map", lambda c, g, sf, cfi, bits, *a: sent.append(bits))
    grids = [np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)]
    enb._map_dlsch_raw(grids, 3, b"\x00" * 8, enb.crnti, 4, 6, ndi=True, rv=0, watch_ack=True)
    d = mods["phy.dci"].unpack_0_1a(cell.n_prb, np.asarray(sent[0], np.uint8))
    assert type(d).__name__ == "Dci1A" and d.tpc == 0
    ue_phy = mods["phy.phy"].Phy(cell, **kw)
    p0 = ue_phy.ul_power.pucch_power_dbm(0.0)
    for _ in range(30):
        ue_phy.ul_power.apply_tpc_pucch(d.tpc)
    assert ue_phy.ul_power.pucch_power_dbm(0.0) == pytest.approx(p0 - 30.0)

