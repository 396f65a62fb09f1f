"""The port's native host library (``utils/native.py``) and native radio
(``radio/native_io.py``): the build goes into build/native/ and writes
nothing under native/; the IQ stream and the timed-TX queue behave as
tests/test_native.py asks of the reference; the gold, turbo-encode, conv,
CRC and turbo-decode bindings equal the port's own numpy/torch code."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from srsue_tpu_torch.phy import convcode, seq, turbo
from srsue_tpu_torch.phy import crc as crcmod
from srsue_tpu_torch.radio import FileRadio
from srsue_tpu_torch.radio.native_io import NativeFileRadio, available
from srsue_tpu_torch.utils import native

REPO = Path(__file__).resolve().parent.parent


def _tree(d: Path) -> dict:
    return {p.name: (p.stat().st_mtime_ns, hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(d.iterdir())}


def test_build_goes_to_build_native_only(tmp_path, monkeypatch):
    before = _tree(REPO / "native")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native, "_LIB_PATH", native.BUILD_DIR / "libsrsue_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available(), native.build_error
    assert [p.name for p in native.BUILD_DIR.iterdir()] == ["libsrsue_native.so"]
    assert _tree(REPO / "native") == before
    assert native.CXXFLAGS == ("-O3", "-march=native", "-fPIC", "-std=c++17")
    assert native.BUILD_DIR.parent.parent == tmp_path  # not the tracked library


def test_default_build_dir_is_git_ignored():
    assert native.BUILD_DIR == REPO / "build" / "native"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_bindings_equal_the_port():
    assert available(), native.build_error
    for c_init in (0, 1, 0x12345, (1 << 30) | 777):
        np.testing.assert_array_equal(native.gold_sequence(c_init, 500), seq.prs(c_init, 500))
    rng = np.random.default_rng(0)
    for k in (40, 512, 6144):
        bits = rng.integers(0, 2, k).astype(np.uint8)
        np.testing.assert_array_equal(native.turbo_encode(bits, turbo.qpp_perm(k)),
                                      turbo.encode(bits))
    bits = rng.integers(0, 2, 120).astype(np.uint8)
    np.testing.assert_array_equal(native.conv_encode(bits), convcode.encode(bits))
    bits = rng.integers(0, 2, 1000).astype(np.uint8)
    for kind, (order, poly) in crcmod.POLY.items():
        want = int("".join(map(str, crcmod.crc(bits, kind))), 2)
        assert native.crc_bits(bits, poly, order) == want, kind


def test_native_turbo_decode_equals_the_port():
    """The C++ max-log-MAP decoder and the port's windowed decoder agree on
    the decoded bits of noisy CRC24A blocks (tests/test_native.py's)."""
    k = 1024
    rng = np.random.default_rng(5)
    msgs, llrs = [], []
    for _ in range(6):
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        sigma = 10 ** (-1.0 / 20)
        llrs.append(2 * (x + rng.standard_normal(x.shape).astype(np.float32) * sigma)
                    / sigma ** 2)
        msgs.append(msg)
    llrs, msgs = np.stack(llrs), np.stack(msgs)
    hard, iters = native.turbo_decode(llrs, turbo.qpp_perm(k), turbo.qpp_inv(k), n_iters=8,
                                      crc_poly=0x864CFB, crc_order=24)
    np.testing.assert_array_equal(hard, msgs)
    assert (iters >= 1).all() and (iters <= 8).all()
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    hard_t, _, ok_t = turbo.decode(torch.as_tensor(llrs), k, 8, crc_mat=m)
    assert ok_t.all()
    np.testing.assert_array_equal(hard_t.numpy(), hard)


def test_iqstream_prefetch_ring(tmp_path):
    """Byte-exact replay (the same samples as FileRadio), seek, EOF zero
    fill and underflow counting."""
    assert available(), native.build_error
    rng = np.random.default_rng(0)
    n = 100_000
    data = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    path = tmp_path / "cap.iq"
    data.tofile(path)
    r = NativeFileRadio(str(path), srate=1.92e6, ring_samples=1 << 14, block=4096)
    f = FileRadio(str(path), srate=1.92e6)
    try:
        got, ts0 = r.rx_now(30_000)
        np.testing.assert_array_equal(got, f.rx_now(30_000)[0])
        np.testing.assert_array_equal(got, data[:30_000])
        assert ts0 == 0.0
        got2, ts2 = r.rx_now(30_000)
        np.testing.assert_array_equal(got2, data[30_000:60_000])
        assert abs(ts2 - 30_000 / 1.92e6) < 1e-12
        assert r.seek(10_000)
        got3, ts3 = r.rx_now(5_000)
        np.testing.assert_array_equal(got3, data[10_000:15_000])
        assert abs(ts3 - 10_000 / 1.92e6) < 1e-12
        assert r.seek(n - 100)
        got4, _ = r.rx_now(1_000)
        np.testing.assert_array_equal(got4[:100], data[-100:])
        np.testing.assert_array_equal(got4[100:], np.zeros(900, np.complex64))
        assert r.underflows >= 1
    finally:
        r.close()


def test_txq_in_order_commit(tmp_path):
    """Out-of-order submissions commit in sequence order, gaps zero-padded,
    late bursts counted."""
    assert available(), native.build_error
    path = tmp_path / "z.iq"
    np.zeros(16, np.complex64).tofile(path)
    r = NativeFileRadio(str(path), srate=1000.0)
    try:
        b0, b1, b2 = (np.full(100, v + 0j, np.complex64) for v in (1, 2, 3))
        r.tx_seq(1, b1, tx_time=0.250)
        assert r.tx_committed == 0  # held until seq 0 arrives
        r.tx_seq(0, b0, tx_time=0.100)
        assert r.tx_committed == 2
        r.tx_seq(2, b2, tx_time=0.200)  # overlaps the committed head: late
        assert r.tx_committed == 3 and r.tx_late == 1
        stream, t0 = r.tx_stream()
        assert t0 == 100
        np.testing.assert_array_equal(stream[0:100], b0)
        np.testing.assert_array_equal(stream[100:150], np.zeros(50, np.complex64))
        np.testing.assert_array_equal(stream[150:250], b1)
        np.testing.assert_array_equal(stream[250:350], b2)
    finally:
        r.close()


def test_missing_capture_raises(tmp_path):
    assert available(), native.build_error
    with pytest.raises(FileNotFoundError):
        NativeFileRadio(str(tmp_path / "none.iq"), srate=1.92e6)
