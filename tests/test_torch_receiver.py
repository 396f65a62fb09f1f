"""Cold start of the torch port (phy/receiver.py, radio/radio.py,
rx.build_cell_stream) against the JAX reference on the same raw IQ:
cell search -> MIB -> aligned subframes -> SIB.

Exact: cell id, half-frame flag, timing offsets, MIB fields, the detected
port count, the radio position, every TTI the generators yield, the sync
status sequence, slips and resyncs, CFI, grant and the SIB bytes. Float32
results of two FFT libraries are held to a stated tolerance: CFO (in
subcarriers) to 1e-4 absolute, the PSS peak and the sync quality to rtol
1e-4, and the yielded subframes to rtol 1e-4 with a floor of 1e-4 of their
peak.
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.receiver import Receiver as RefReceiver
from srsue_tpu.phy.ue_dl import UeDl as RefUeDl
from srsue_tpu.radio import ArrayRadio as RefArrayRadio
from srsue_tpu_torch import rx
from srsue_tpu_torch.mac.rnti import SI_RNTI
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy.receiver import Receiver
from srsue_tpu_torch.phy.ue_dl import UeDl
from srsue_tpu_torch.radio import ArrayRadio
from tests.test_coldstart import _build_downlink


def _mine(cell):
    return port_cell.Cell(**dataclasses.asdict(cell))


def _pair(iq, srate):
    """(the port's receiver on the CPU, the reference's) over the same IQ."""
    return (Receiver(ArrayRadio(iq, srate), device="cpu"),
            RefReceiver(RefArrayRadio(iq, srate)))


def _assert_same_search(got, ref, mine, theirs):
    assert (got is None) == (ref is None)
    if got is None:
        return
    assert got[:3] == ref[:3]  # cell id, is_sf5, full-rate offset
    assert abs(got[3] - ref[3]) < 1e-4
    np.testing.assert_allclose(mine.metrics["peak"], theirs.metrics["peak"], rtol=1e-4)
    assert mine.radio.pos == theirs.radio.pos


def _acquire_both(iq, srate):
    """Cell search and MIB on both sides, compared; returns the receivers
    and the port's (cell, mib, t_sf0, cfo)."""
    mine, theirs = _pair(iq, srate)
    found, found_r = mine.cell_search(), theirs.cell_search()
    _assert_same_search(found, found_r, mine, theirs)
    assert found is not None, "cell search failed"
    got = mine.decode_mib_stream(found[0], found[2], found[3], found[1])
    ref = theirs.decode_mib_stream(found_r[0], found_r[2], found_r[3], found_r[1])
    assert (got is None) == (ref is None)
    assert got is not None, "MIB decode failed"
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(ref[0])
    assert dataclasses.astuple(got[1]) == dataclasses.astuple(ref[1])
    assert got[2] == ref[2] and mine.radio.pos == theirs.radio.pos
    return mine, theirs, got, found[3], found_r[3]


@pytest.mark.parametrize("cell_id,n_prb", [(123, 25), (47, 6)])
def test_cold_start_to_mib_matches_reference(cell_id, n_prb):
    cell = Cell(n_prb=n_prb, cell_id=cell_id)
    stream = rx.build_cell_stream(_mine(cell), 3, snr_db=12, sfn0=4, lead=1234)
    td, _, _ = _build_downlink(cell, n_frames=3, snr_db=12, sfn0=4)
    # build_cell_stream draws what tests/test_coldstart.py's _build_downlink draws
    np.testing.assert_array_equal(stream.iq[1234:], td)
    assert not stream.iq[:1234].any()
    _, _, (got_cell, mib, _), _, _ = _acquire_both(stream.iq, cell.srate)
    assert (got_cell.cell_id, got_cell.n_prb, got_cell.n_ports) == (cell_id, n_prb, 1)
    assert mib.sfn >= 4 and mib.n_prb == n_prb


def test_cold_start_with_cfo_matches_reference():
    cell = Cell(n_prb=25, cell_id=200)
    stream = rx.build_cell_stream(_mine(cell), 3, snr_db=12, cfo=0.22)
    _, _, (got_cell, _, _), cfo, _ = _acquire_both(stream.iq, cell.srate)
    assert got_cell.cell_id == 200 and abs(cfo - 0.22) < 0.02


@pytest.mark.parametrize("gains,tries", [((1.0, 1.0), 1), ((0.35, 1.0), 2)])
def test_two_port_pbch_blind_port_detection_matches_reference(gains, tries, monkeypatch):
    """A 2-port cell sends its PBCH with SFBC (tests/test_sync_pbch.py's
    cell). With equal port gains the single-port hypothesis already decodes
    it and the CRC mask gives the port count; with port 0 9 dB under port 1
    it fails, and the Alamouti hypothesis finds the MIB: two decodes of the 4
    quarter hypotheses."""
    from srsue_tpu_torch.phy import convcode

    calls = []
    decode = convcode.decode
    monkeypatch.setattr(convcode, "decode", lambda llrs: calls.append(llrs.shape) or decode(llrs))
    cell = Cell(n_prb=6, cell_id=33, n_ports=2)
    stream = rx.build_cell_stream(_mine(cell), 3, snr_db=12, seed=5, sfn0=8, port_gains=gains)
    _, _, (got_cell, mib, _), _, _ = _acquire_both(stream.iq, cell.srate)
    assert (got_cell.n_ports, got_cell.n_prb, got_cell.cell_id) == (2, 6, 33)
    assert mib.sfn in (8, 9, 10)
    assert calls == [(4, 40, 3)] * tries


def test_full_si_acquisition_matches_reference():
    """Raw IQ -> cell -> MIB -> the aligned subframes of both generators ->
    blind SI-RNTI search and SIB decode through each side's UeDl."""
    cell = Cell(n_prb=25, cell_id=77)
    sib = np.random.default_rng(11).bytes(60)
    stream = rx.build_cell_stream(_mine(cell), 4, sib=sib, snr_db=15)
    mine, theirs, (got_cell, mib, t_sf0), cfo, cfo_r = _acquire_both(stream.iq, cell.srate)
    status, status_r = [], []
    mine.on_sync_status, theirs.on_sync_status = status.append, status_r.append
    ue, ue_r = UeDl(got_cell, device="cpu"), RefUeDl(cell)
    decoded = None
    subframes = zip(mine.subframes(got_cell, t_sf0, cfo, mib.sfn, 0, n=16),
                    theirs.subframes(cell, t_sf0, cfo_r, mib.sfn, 0, n=16), strict=True)
    for n, ((tti, iq), (tti_r, iq_r)) in enumerate(subframes):
        assert tti == tti_r == (mib.sfn * 10 + n) % 10240
        assert isinstance(iq, torch.Tensor) and iq.dtype == torch.complex64
        np.testing.assert_allclose(iq.numpy(), np.asarray(iq_r), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(iq_r)).max())
        if tti % 10 != 5 or (tti // 10) % 2 != 0:
            continue
        res = ue.process(iq, 5, SI_RNTI, ue_specific=False)
        res_r = ue_r.process(np.asarray(iq_r), 5, SI_RNTI, ue_specific=False)
        assert res.cfi == res_r.cfi == stream.cfi
        assert ([dataclasses.astuple(g) for g in res.grants]
                == [dataclasses.astuple(g) for g in res_r.grants]
                == [dataclasses.astuple(dataclasses.replace(stream.si_grant, ndi=False))])
        np.testing.assert_array_equal(res.payload, np.asarray(res_r.payload))
        np.testing.assert_array_equal(res.tb_ok, np.asarray(res_r.tb_ok))
        assert res.tb_ok.all()
        decoded = np.packbits(res.payload.reshape(-1)).tobytes()[: len(sib)]
    assert decoded == sib, "SIB decode through the blind SI search failed"
    assert status == status_r and all(status) and len(status) == 16
    assert mine.state == theirs.state == "SYNC_DONE"
    assert mine.radio.pos == theirs.radio.pos
    assert mine.metrics["slips"] == theirs.metrics["slips"]
    np.testing.assert_allclose(mine.metrics["cfo_hz"], theirs.metrics["cfo_hz"], atol=1.5)
    np.testing.assert_allclose(mine.metrics["sync_quality"], theirs.metrics["sync_quality"],
                               rtol=1e-4)


def test_silence_finds_no_cell_and_stream_ends():
    """Noise only: no cell on either side, and stream() returns when the
    capture is exhausted instead of searching forever."""
    cell = Cell(n_prb=6)
    rng = np.random.default_rng(2)
    n = 7 * 10 * cell.sf_len
    noise = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    mine, theirs = _pair(noise, cell.srate)
    assert mine.cell_search() is None and theirs.cell_search() is None
    mine, theirs = _pair(noise, cell.srate)
    status, status_r = [], []
    mine.on_sync_status, theirs.on_sync_status = status.append, status_r.append
    assert list(mine.stream(20)) == [] and list(theirs.stream(20)) == []
    assert status == status_r and not any(status) and len(status) == 90
    assert mine.radio.pos == theirs.radio.pos and mine.radio.exhausted
    short = Receiver(ArrayRadio(noise[: 4 * cell.sf_len], cell.srate), device="cpu")
    assert short.cell_search(n_frames=0.5) is None  # under two half-frames


def test_stream_state_machine_matches_reference():
    """stream(): acquisition, 25 subframes, then a dropout to the end of the
    capture: both sides yield the same TTIs, lose sync on the same subframe
    and end in CELL_SEARCH with the same counters."""
    cell = Cell(n_prb=6, cell_id=99)
    stream = rx.build_cell_stream(_mine(cell), 5, snr_db=18, cfo=0.11)
    iq = np.concatenate([stream.iq, np.zeros(20 * cell.sf_len, np.complex64)])
    mine, theirs = _pair(iq, cell.srate)
    resync, resync_r, status, status_r = [], [], [], []
    mine.on_sync_status, theirs.on_sync_status = status.append, status_r.append
    got = [t for t, _ in mine.stream(60, on_resync=lambda c, m: resync.append((c, m)))]
    ref = [t for t, _ in theirs.stream(60, on_resync=lambda c, m: resync_r.append((c, m)))]
    assert got == ref and 20 <= len(got) < 60
    assert status == status_r and True in status and False in status
    assert len(resync) == len(resync_r) == 1
    assert dataclasses.asdict(resync[0][0]) == dataclasses.asdict(resync_r[0][0])
    assert dataclasses.astuple(resync[0][1]) == dataclasses.astuple(resync_r[0][1])
    assert mine.state == theirs.state == "CELL_SEARCH"
    for key in ("resyncs", "slips"):
        assert mine.metrics[key] == theirs.metrics[key]


def _resample(x, ratio):
    """Linear-interpolation resampling as a sample-clock offset: output
    sample k takes input position k * ratio (tests/test_sync_robust.py's)."""
    pos = np.arange(int(len(x) / ratio)) * ratio
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    return (x[i0] * (1 - frac) + x[i1] * frac).astype(np.complex64)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["sfo", "gap", "loss"])
def test_sync_robustness_matches_reference(case):
    """tests/test_sync_robust.py's three streams through both receivers: a
    200 ppm sample-clock drift tracked by sample slips, a 25 ms dropout
    under CFO with re-acquisition, and a dropout to the end of the stream:
    the same TTIs, sync indications, slips, resyncs and final state."""
    if case == "sfo":
        cell = Cell(n_prb=6, cell_id=77)
        td = rx.build_cell_stream(_mine(cell), 14, snr_db=18).iq
        iq = np.concatenate([np.zeros(777, np.complex64), _resample(td, 1.0 + 200e-6)])
        n = 120
    elif case == "gap":
        cell = Cell(n_prb=6, cell_id=99)
        td1 = rx.build_cell_stream(_mine(cell), 6, snr_db=18).iq
        td2 = rx.build_cell_stream(_mine(cell), 8, snr_db=18, sfn0=32).iq
        iq = np.concatenate([td1, np.zeros(25 * cell.sf_len, np.complex64), td2])
        iq = (iq * np.exp(2j * np.pi * 0.21 * np.arange(len(iq)) / cell.nfft)
              ).astype(np.complex64)
        n = 100
    else:
        cell = Cell(n_prb=6, cell_id=99)
        td1 = rx.build_cell_stream(_mine(cell), 4, snr_db=18).iq
        iq = np.concatenate([td1, np.zeros(30 * cell.sf_len, np.complex64)])
        n = 60
    mine, theirs = _pair(iq, cell.srate)
    status, status_r = [], []
    mine.on_sync_status, theirs.on_sync_status = status.append, status_r.append
    got = [t for t, _ in mine.stream(n)]
    ref = [t for t, _ in theirs.stream(n)]
    assert got == ref and status == status_r
    assert mine.state == theirs.state
    for key in ("resyncs", "slips"):
        assert mine.metrics[key] == theirs.metrics[key], key
    np.testing.assert_allclose(mine.metrics["sfo_hz"], theirs.metrics["sfo_hz"], rtol=1e-6)
    if case == "sfo":
        assert len(got) == 120 and mine.metrics["resyncs"] == 1
        assert mine.metrics["slips"] <= -10
    elif case == "gap":
        assert mine.metrics["resyncs"] == 2
        assert abs(mine.metrics["cfo_hz"] - 0.21 * 15000) < 400
    else:
        assert status.count(False) >= 5 and status.count(True) > 10
