"""The port's whole UE on the CPU, port only, at 15 PRB: the time advance
over a delaying channel, CFO tracking with the UL pre-rotation, the
reference's rx_gain_offset_db contract (ROADMAP fault 3, copied and
pinned), a PCI swap re-caching the device tables, and ``main`` (selftest,
``--iq`` on the CPU, the card by default). Counterparts of the non-slow
tests of ``tests/test_harq_ota.py`` and ``tests/test_ota_attach_cfo.py``."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from srsue_tpu_torch.enb.phy import EnbPhy
from srsue_tpu_torch.enb.stack import EnbStack
from srsue_tpu_torch.phy import enb_tx, prach as prach_mod
from srsue_tpu_torch.phy.cell import Cell
from srsue_tpu_torch.phy.phy import Phy
from srsue_tpu_torch.ue import Ue

REPO = Path(__file__).resolve().parent.parent


def mk(n_prb: int = 15, n_ports: int = 1):
    """The port's UE and eNB emulator on one cell, on the CPU."""
    cell = Cell(n_prb=n_prb, cell_id=123, n_ports=n_ports)
    phy = Phy(cell, device="cpu")
    ue = Ue(phy=phy)
    phy.mac, phy.rrc = ue.mac, ue.rrc
    enb_stack = EnbStack(ue.usim.cfg)
    enb = EnbPhy(cell, enb_stack, device="cpu")
    return cell, phy, ue, enb_stack, enb


def rot(cell, wf, tti, cfo_norm):
    """A continuous-phase LO rotation of subframe `tti` of a stream."""
    n = tti * cell.sf_len + np.arange(len(wf), dtype=np.float64)
    return (wf * np.exp(2j * np.pi * cfo_norm * n / cell.nfft)).astype(np.complex64)


def crs_subframes(cell, n, seed=1, amp=0.005, start=0):
    """n subframes of CRS and sync signals only, for TTIs start.., with AWGN."""
    rng = np.random.default_rng(seed)
    out = []
    for tti in range(start, start + n):
        grid = enb_tx.empty_grid(cell)
        enb_tx.add_crs(cell, grid, tti % 10, 0)
        enb_tx.add_sync(cell, grid, tti % 10)
        td = enb_tx.to_waveform(cell, [grid])[0]
        td += amp * (rng.standard_normal(td.shape) + 1j * rng.standard_normal(td.shape)
                     ).astype(np.complex64)
        out.append(td)
    return out


def test_time_advance_compensates_channel_delay():
    """A TA command advances every UL transmission by 16*TA samples (scaled
    to the cell's rate); a UL channel delaying by as much beyond the CP is
    then compensated, and Msg3 and every PUSCH decode."""
    cell, phy, ue, enb_stack, enb = mk()
    ta_cmd = 20
    delay = int(round(ta_cmd * 16 * cell.nfft / 2048))
    assert delay > cell.cp_lengths[1]
    phy.set_timeadv(ta_cmd)
    assert phy._ta_samples() == delay
    phy.set_timeadv(0)
    enb.rar_ta = ta_cmd
    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
    for tti in range(250):
        dl = enb.build_dl_subframe(tti)
        ul = phy.work(tti, dl)
        ue.run_tti(tti)
        if ul is not None and tti % 10 != phy.PRACH_SF:
            ul = np.concatenate([np.zeros(delay, ul.dtype), ul[:-delay]])
        enb.receive_ul(tti, ul)
        if ue.is_attached and enb_stack.state == "attached":
            break
    assert ue.is_attached and enb_stack.state == "attached", enb.events
    assert phy.ta == ta_cmd


def test_cfo_tracking_converges_and_ul_prerotated():
    """CFO-rotated CRS subframes drive cfo_norm to the injected offset, and
    the PRACH leaves pre-rotated: after the -cfo UL channel the eNB's
    detector finds the preamble."""
    cell, phy, *_ = mk()
    cfo_hz = 250.0
    cfo_norm = cfo_hz / 15000.0
    subframes = crs_subframes(cell, 24)
    for tti, td in enumerate(subframes):
        phy.work(tti, rot(cell, td, tti, cfo_norm))
    assert abs(phy.cfo_norm * 15000.0 - cfo_hz) < 40.0, phy.cfo_norm * 15000.0
    phy.prach_send(7, 0.0, 23)
    ul = phy.work(11, rot(cell, subframes[-1], 25, cfo_norm))  # PRACH_SF == 1
    assert ul is not None
    det = prach_mod.detect(cell, rot(cell, ul, 0, -cfo_norm), phy.prach_root, phy.prach_zcorr)
    assert det and det[0][0] == 7, det


def _gain_assignments(root: Path) -> list:
    """Every assignment to an attribute named rx_gain_offset_db under root."""
    found = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign)) else [])
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr == "rx_gain_offset_db":
                    found.append((path.relative_to(root).as_posix(), ast.unparse(node.value)))
    return found


def test_rx_gain_offset_is_the_references_and_nothing_sets_it():
    """ROADMAP fault 3, copied and pinned. ``Phy.rx_gain_offset_db`` removes
    a radio's digital AGC gain from RSRP, pathloss and the UL power, but no
    code of either package sets it from ``radio.rx_gain_db``: it stays 0
    unless set by hand. Set by hand to the same value on both packages'
    Phy, RSRP, pathloss and the PUSCH power are equal, each shifted by it."""
    from srsue_tpu.phy import phy as ref_phy
    from srsue_tpu.phy.cell import Cell as RefCell

    for pkg in ("srsue_tpu", "srsue_tpu_torch"):
        assert _gain_assignments(REPO / pkg) == [("phy/phy.py", "0.0")], pkg
    cell = Cell(n_prb=6, cell_id=123)
    subframes = crs_subframes(cell, 3, seed=4, amp=0.01)
    out = {}
    for gain in (0.0, 6.0):
        for pkg in ("ref", "port"):
            p = (ref_phy.Phy(RefCell(**dataclasses.asdict(cell))) if pkg == "ref"
                 else Phy(cell, device="cpu"))
            assert p.rx_gain_offset_db == 0.0
            p.ref_sig_power_dbm = 15.0
            p.rx_gain_offset_db = gain
            for tti, td in enumerate(subframes):
                p.work(tti, td)
            amp = p._pusch_amp(4)
            out[pkg, gain] = (p.serving_rsrp_dbm, p.pathloss_db, p.metrics["pusch_dbm"], amp)
    for gain in (0.0, 6.0):
        np.testing.assert_allclose(out["port", gain], out["ref", gain], rtol=1e-5, atol=1e-4)
    rsrp0, pl0, p0, _ = out["port", 0.0]
    rsrp6, pl6, p6, _ = out["port", 6.0]
    assert rsrp6 == pytest.approx(rsrp0 - 6.0, abs=1e-9)
    assert pl6 == pytest.approx(pl0 + 6.0, abs=1e-9)
    assert p6 > p0  # open-loop power control answers the larger pathloss


def test_subband_snr_matches_the_reference():
    """With subband CQI configured, the facade's per-subband SNR (mean |h|^2
    per subband of k PRBs over the subframe, torch in the port) equals the
    reference's on a frequency-selective channel; 15 PRB leaves a short last
    subband (4 subbands of 4 PRBs over 15)."""
    from srsue_tpu.phy import phy as ref_phy
    from srsue_tpu.phy.cell import Cell as RefCell

    cell = Cell(n_prb=15, cell_id=123)
    subframes = [np.convolve(td, [1.0, 0.0, 0.0, 0.6j])[: td.size].astype(np.complex64)
                 for td in crs_subframes(cell, 3, seed=6, amp=0.01)]
    got = []
    for p in (ref_phy.Phy(RefCell(**dataclasses.asdict(cell))), Phy(cell, device="cpu")):
        p.configure_cqi(40, 0, subband_k=1)
        for tti, td in enumerate(subframes):
            p.work(tti, td)
        got.append(p.ul_ctrl.subband_snr_db)
    ref, mine = got
    assert len(mine) == 4 and np.ptp(ref) > 1.0  # the channel is selective
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-3)


def test_set_pci_recaches_the_device_tables():
    """After set_pci the facade measures and decodes the new cell exactly as
    a facade built for it: every table cached per Cell value re-caches."""
    cell_a, cell_b = Cell(n_prb=6, cell_id=123), Cell(n_prb=6, cell_id=301)
    sub_a, sub_b = crs_subframes(cell_a, 2), crs_subframes(cell_b, 4, seed=2, start=2)
    swapped, fresh = Phy(cell_a, device="cpu"), Phy(cell_b, device="cpu")
    swapped.cfo_track = fresh.cfo_track = False  # no state carried across the swap
    for tti, td in enumerate(sub_a):
        swapped.work(tti, td)
    swapped.set_pci(301)
    assert swapped.cell == cell_b
    for tti, td in enumerate(sub_b, start=2):
        swapped.work(tti, td)
        fresh.work(tti, td)
        assert swapped.metrics["snr_db"] == fresh.metrics["snr_db"] > 20.0
        assert swapped.metrics["pathloss_db"] == fresh.metrics["pathloss_db"]
    # the old cell's CRS does not match the new PCI: it measures far lower
    wrong = Phy(cell_b, device="cpu")
    wrong.work(0, sub_a[0])
    assert wrong.metrics["snr_db"] < fresh.metrics["snr_db"] - 10.0


def test_metrics_snapshot_is_interval_averaged():
    cell, phy, *_ = mk(n_prb=6)
    for tti, td in enumerate(crs_subframes(cell, 4)):
        phy.work(tti, td)
    snap = phy.get_metrics()
    assert np.isfinite(snap.dl_snr_db) and snap.dl_snr_db > 20.0
    assert np.isfinite(snap.rsrp_dbm) and snap.pathloss_db == pytest.approx(-snap.rsrp_dbm)
    again = phy.get_metrics()  # read-and-reset
    assert again.dl_snr_db == 0.0 and again.rsrp_dbm == 0.0


def _main(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-m", "srsue_tpu_torch.main", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_main_selftest_and_pcap(tmp_path):
    pcap = tmp_path / "ue.pcap"
    r = _main("--selftest", "--pcap", str(pcap))
    assert r.returncode == 0, r.stderr
    assert "SELFTEST PASS: attached (rrc=CONNECTED, emm=REGISTERED)" in r.stdout
    assert "ul_pkts=True" in r.stdout and "dl_pkts=True" in r.stdout
    raw = pcap.read_bytes()
    assert len(raw) > 24 and raw[:4] == b"\xd4\xc3\xb2\xa1"


def test_main_iq_attaches_to_a_capture_on_the_cpu(tmp_path):
    """--iq with --device cpu: cell search, MIB and the steady loop decoding
    the C-RNTI's PDSCH; without --device the run asks for the card."""
    from srsue_tpu_torch import rx
    from srsue_tpu_torch.radio.radio import write_iq

    cell = Cell(n_prb=6, cell_id=77)
    stream = rx.build_cell_stream(cell, 4, snr_db=15, crnti=0x4601, mcs_data=6)
    path = tmp_path / "cap.iq"
    write_iq(str(path), stream.iq)
    r = _main("--iq", str(path), "--srate", str(cell.srate), "--rnti", "0x4601",
              "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "cell_id=77" in r.stderr and "n_prb=6" in r.stderr
    n = int(r.stderr.split("decoded ")[1].split(" TBs")[0])
    assert n >= 2, r.stderr
    if not torch.cuda.is_available():
        r = _main("--iq", str(path), "--srate", str(cell.srate))
        assert r.returncode != 0 and "CUDA" in r.stderr
