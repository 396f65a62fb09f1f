"""The port's hand-written CUDA kernels and the chain on the card, against
the plain PyTorch twins. Every test needs a CUDA GPU and skips without
one. This file imports no JAX and nothing of the JAX package, so on a
machine without it run:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance kernel vs plain: rtol 1e-5, atol 1e-3 on extrinsics and on the
offset-free boundary metrics (both perform the same float32 operations;
the kernel's compiler may contract or reorder them). The bfloat16 kernel
(v5) against its bf16 twin: one bf16 unit in the last place of the largest
value (2^-7 of it), since both round the same operations. Decisions of the
decoder and the chain are equal; the Viterbi kernel's hard bits equal its
twin's exactly (the same float32 operations, each rounded once).
"""

import numpy as np
import pytest
import torch

from srsue_tpu_torch.entry import chain, make_waveforms
from srsue_tpu_torch.kernels import bcjr
from srsue_tpu_torch.phy import crc as crcmod
from srsue_tpu_torch.phy import ra, turbo
from srsue_tpu_torch.phy.cell import Cell
from srsue_tpu_torch.phy.pdsch import PdschCodec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from srsue_tpu_torch.utils.device import require_cuda

    return require_cuda()


def _half_args(k, lw, blocks, device, seed):
    g = torch.Generator().manual_seed(seed)
    w = k // lw

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    return (rnd(blocks, k, scale=6.0), rnd(blocks, k, scale=6.0), rnd(blocks, k, scale=3.0),
            rnd(blocks, 3, scale=6.0), rnd(blocks, 3, scale=6.0),
            rnd(blocks, w, 8, scale=5.0), rnd(blocks, w, 8, scale=5.0), lw)


# lw = 36 and 20 end in a short checkpoint segment (bcjr_core.cuh kSeg = 8);
# 5 x 96 = 480 and 6 x 56 windows leave the last block of 128 part-full
@pytest.mark.parametrize("k,lw,blocks", [
    (5824, 64, 40), (512, 64, 64), (432, 48, 64), (256, 256, 64), (40, 40, 7),
    (432, 36, 33), (40, 20, 9), (6144, 64, 5), (5824, 104, 6)])
def test_kernel_matches_plain(cuda_device, k, lw, blocks):
    args = _half_args(k, lw, blocks, cuda_device, k)
    before = bcjr.launches["r2max"]
    got = bcjr.bcjr_half_windowed(*args)
    assert bcjr.launches["r2max"] == before + 1
    assert (blocks * (k // lw), lw) in bcjr.shapes["r2max"]
    ref = bcjr.bcjr_half_windowed_plain(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a - a.amax(-1, keepdim=True),
                                   b - b.amax(-1, keepdim=True), rtol=1e-5, atol=1e-3)


def _assert_matches(got, ref, kernel):
    for i, (a, b) in enumerate(zip(got, ref)):
        if i:  # boundaries: only differences between states matter
            a, b = a - a.amax(-1, keepdim=True), b - b.amax(-1, keepdim=True)
        if kernel == "v5":
            torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -7 * float(b.abs().max()))
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


# K = 40 as one window of 5 radix-4 segments of 8 steps, lw = 8 as one
# segment; 567, 65, 7, 185 and 2,112 windows leave the last block of 128
# threads part-full, and the odd counts leave v5's last thread one window
@pytest.mark.parametrize("kernel", ["v2v3", "v4", "v5"])
@pytest.mark.parametrize("k,lw,blocks", [(512, 64, 64), (432, 48, 63), (256, 256, 65),
                                         (6144, 64, 5), (5824, 104, 6), (40, 40, 7),
                                         (64, 8, 3), (40, 8, 37), (512, 8, 33)])
def test_instance_matches_plain(cuda_device, kernel, k, lw, blocks):
    args = _half_args(k, lw, blocks, cuda_device, k)
    before = dict(bcjr.launches)
    got = bcjr.bcjr_half_windowed(*args, kernel=kernel)
    assert bcjr.launches == {n: c + (n == kernel) for n, c in before.items()}
    _assert_matches(got, bcjr.bcjr_half_windowed_plain(*args, kernel=kernel), kernel)


def test_radix4_occupancy(cuda_device):
    """Registers, not shared memory, set the radix-4 kernels' residency at
    the flagship window (lw = 64): at least 12 warps per SM, from 4."""
    from srsue_tpu_torch.kernels import build

    assert build.warps_per_sm("v4", 64) >= 12
    assert build.warps_per_sm("v5", 64) >= 12


def _fused_case(device, k, lw, blocks, which):
    sys_h, par_h, other, ts, tp, al, bf, _ = _half_args(k, lw, blocks, device, k + 1)
    perm, inv = turbo.qpp_tensors(k, device)
    idx = (inv if which == "inv" else perm).to(torch.int32)
    args = (sys_h, par_h, other, idx, al, bf, turbo.tail_beta(ts, tp), lw)
    before = dict(bcjr.launches)
    got = bcjr.bcjr_half_fused(*args)
    assert bcjr.launches == {n: c + (n == "fused") for n, c in before.items()}
    _assert_matches(got, bcjr.bcjr_half_fused_plain(*args), "fused")


# one code block per CTA at W = 91 and 96 (the row brought in by TMA); several
# at small W, with a part-full last CTA (65 and 63 blocks); K = 40 as one window
@pytest.mark.parametrize("k,lw,blocks", [(512, 64, 64), (432, 48, 63), (256, 256, 65),
                                         (5824, 64, 9), (6144, 64, 7), (5824, 104, 5),
                                         (40, 40, 130)])
def test_fused_matches_plain(cuda_device, k, lw, blocks):
    _fused_case(cuda_device, k, lw, blocks, "inv")


@pytest.mark.parametrize("k,lw,blocks", [(5824, 64, 9), (512, 64, 65), (40, 40, 130)])
def test_fused_perm_matches_plain(cuda_device, k, lw, blocks):
    """The second half's index map (qpp_perm) in the gather."""
    _fused_case(cuda_device, k, lw, blocks, "perm")


def test_fused_splits_long_blocks(cuda_device):
    """W = 192 windows of 32 spread one code block over two CTAs."""
    _fused_case(cuda_device, 6144, 32, 3, "inv")


def test_radix2_occupancy(cuda_device):
    """Registers, not shared memory, set the radix-2 kernels' residency at
    the flagship shape (K=5824, 91 windows of 64)."""
    from srsue_tpu_torch.kernels import build

    assert build.warps_per_sm("r2max", 64) >= 16
    assert build.warps_per_sm("v2v3", 64) >= 16
    assert build.warps_per_sm("fused", 3328, 5824, 64) >= 12


def test_wrapper_rejects_cpu_cuda_mix(cuda_device):
    lin = torch.zeros(4, 64, device=cuda_device)
    a0 = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        bcjr.half_windowed(lin, lin, a0, a0)


def test_decode_on_card_matches_cpu(cuda_device):
    k = 512
    rng = np.random.default_rng(1)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    llrs = []
    for _ in range(4):
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        x = x + rng.standard_normal(x.shape).astype(np.float32) * 0.9
        llrs.append(2 * x / 0.81)
    llrs = np.stack(llrs).astype(np.float32)
    for early_exit in (True, False):
        cpu = turbo.decode(torch.as_tensor(llrs), k, 4, crc_mat=m, early_exit=early_exit)
        gpu = turbo.decode(torch.as_tensor(llrs, device=cuda_device), k, 4, crc_mat=m,
                           early_exit=early_exit)
        for x, y in zip(gpu, cpu):
            torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)


@pytest.mark.parametrize("kernel,forced", [
    ("v2v3", False), ("v4", False), ("v5", False), ("r2max", True), ("v4", True)])
def test_variants_on_card_match_cpu(cuda_device, kernel, forced):
    k = 512
    rng = np.random.default_rng(2)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    llrs = []
    for _ in range(5):
        msg = crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        llrs.append(2 * (x + rng.standard_normal(x.shape).astype(np.float32) * 0.9) / 0.81)
    llrs = np.stack(llrs).astype(np.float32)
    decode = turbo.decode_forced if forced else turbo.decode
    cpu = decode(torch.as_tensor(llrs), k, 4, m, kernel=kernel)
    gpu = decode(torch.as_tensor(llrs, device=cuda_device), k, 4, m, kernel=kernel)
    for x, y in zip(gpu, cpu):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)
    assert cpu[2].all()


@pytest.mark.parametrize("n_prb,mcs", [(6, 5), (25, 17)])
def test_chain_on_card_matches_cpu(cuda_device, n_prb, mcs):
    cell = Cell(n_prb=n_prb, cell_id=17)
    grant = ra.dl_grant(n_prb, mcs)
    out = {}
    for dev in ("cpu", cuda_device):
        codec = PdschCodec(cell, grant, 0x1234, 1, device=dev)
        noisy, payloads, _ = make_waveforms(cell, codec, np.random.default_rng(0), 3, 20.0)
        out[str(dev)] = [v.cpu() for v in chain(cell, codec, 1)(torch.as_tensor(noisy, device=dev))]
    gpu, cpu = out[str(cuda_device)], out["cpu"]
    assert cpu[1].all() and gpu[1].all()
    for x, y in zip(gpu, cpu):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    np.testing.assert_array_equal(gpu[0].numpy(), payloads)


def _viterbi_llrs(batch, n, kind, seed):
    """Noisy codewords at `kind` dB, or the tie inputs: all-zero LLRs, or
    one constant per hypothesis (a multiple of 1/4, so every sum is exact
    and path metrics tie everywhere)."""
    from srsue_tpu_torch.phy import convcode

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n)).astype(np.uint8)
    if kind == "zeros":
        return np.zeros((batch, n, 3), np.float32), bits
    if kind == "constant":
        c = np.round(rng.uniform(-4.0, 4.0, batch) * 4.0) / 4.0
        return np.broadcast_to(c[:, None, None], (batch, n, 3)).astype(np.float32), bits
    snr_db = kind
    x = 1.0 - 2.0 * np.swapaxes(convcode.encode(bits), -1, -2)
    var = 10.0 ** (-snr_db / 10.0)
    y = x + np.sqrt(var) * rng.standard_normal(x.shape)
    return np.ascontiguousarray(2.0 * y / var, dtype=np.float32), bits


# B = 1003, 33, 9 and 5 leave the last block of 8 hypotheses part-full
@pytest.mark.parametrize("batch,n", [(4608, 44), (1003, 44), (300, 54), (1536, 31), (4, 40),
                                     (33, 33), (9, 96), (5, 1)])
def test_viterbi_kernel_matches_plain(cuda_device, batch, n):
    from srsue_tpu_torch.kernels import viterbi
    from srsue_tpu_torch.phy import convcode

    for snr in (0.0, 10.0, "zeros", "constant"):  # ties: the twin's tie rules hold
        llr_np, bits = _viterbi_llrs(batch, n, snr, n)
        llr = torch.as_tensor(llr_np, device=cuda_device)
        before = viterbi.launches
        got = convcode.decode(llr)
        assert viterbi.launches == before + 1
        torch.testing.assert_close(got, convcode.decode_plain(llr), rtol=0, atol=0)
        torch.testing.assert_close(got.cpu(), convcode.decode(llr.cpu()), rtol=0, atol=0)
        if snr == 10.0 and n >= 6:
            np.testing.assert_array_equal(got.cpu().numpy(), bits)


def test_viterbi_wrapper_rejects_bad_input(cuda_device):
    from srsue_tpu_torch.kernels import viterbi
    from srsue_tpu_torch.phy import convcode

    with pytest.raises(ValueError):
        convcode.decode(torch.zeros(2, 97, 3, device=cuda_device))
    with pytest.raises(TypeError):
        convcode.decode(torch.zeros(2, 40, 3, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError):
        convcode.decode(torch.zeros(2, 3, 40, device=cuda_device).transpose(1, 2))
    before = viterbi.launches
    assert convcode.decode(torch.zeros(0, 40, 3, device=cuda_device)).shape == (0, 40)
    assert viterbi.launches == before


def test_device_timings_agree(cuda_device):
    """bench_kernel_variants' two device timings of the Viterbi at the blind
    search's shape: the profiler's kernel time and the per-call time of
    CUDA events behind a spin kernel, which also holds the card's gap
    between launches. The events' time is 0.9-1.25 x the profiler's."""
    from srsue_tpu_torch import bench_kernel_variants as bkv
    from srsue_tpu_torch.phy import convcode

    llr = bkv.viterbi_llrs(4608, 44, cuda_device)
    prof_ms, by = bkv.device_ms(lambda: convcode.decode(llr), 50, "viterbi")
    assert by == "profiler"
    gated = bkv.gated_ms(lambda: convcode.decode(llr), 50)
    assert 0.9 * prof_ms <= gated <= 1.25 * prof_ms, (gated, prof_ms)


@pytest.mark.parametrize("eq,forced", [("zf", False), ("mmse", False), ("zf_scalar", True)])
def test_blind_chain_on_card_matches_cpu(cuda_device, eq, forced):
    from srsue_tpu_torch import rx
    from srsue_tpu_torch.kernels import viterbi

    clean = rx.build_clean(3, cell=Cell(n_prb=25, cell_id=42), mcs=9, cfi=2)
    noisy = rx.add_noise(clean.rng, clean.td, clean.p_sig, 12.0)
    out = {}
    for dev in ("cpu", cuda_device):
        fn = rx.make_rx(clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
                        clean.dci_bits, True, eq, forced=forced, device=dev)
        before = viterbi.launches
        stats = rx.tb_stats(fn(torch.as_tensor(noisy, device=dev)), clean.payloads, clean.cfi)
        out[str(dev)] = {k: float(v) for k, v in stats.items()}
        assert viterbi.launches == before + (str(dev) != "cpu")
    assert out["cpu"] == out[str(cuda_device)]
    assert out["cpu"]["n_dci"] == out["cpu"]["n_ok"] == out["cpu"]["cfi_ok"] == 3


def test_ue_dl_on_card_matches_cpu(cuda_device):
    from srsue_tpu_torch import rx
    from srsue_tpu_torch.phy.ue_dl import UeDl

    clean = rx.build_clean(2, cell=Cell(n_prb=25, cell_id=42), mcs=9, cfi=2)
    noisy = rx.add_noise(clean.rng, clean.td, clean.p_sig, 12.0)
    cpu = UeDl(clean.cell, device="cpu").process(noisy, clean.subframe, clean.rnti)
    gpu = UeDl(clean.cell, device=cuda_device).process(noisy, clean.subframe, clean.rnti)
    assert gpu.cfi == cpu.cfi == 2 and gpu.grants == cpu.grants
    for a, b in zip((gpu.payload, gpu.tb_ok, gpu.turbo_iters),
                    (cpu.payload, cpu.tb_ok, cpu.turbo_iters)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gpu.payload, clean.payloads)


def test_cold_start_on_card_matches_cpu(cuda_device):
    """Cell search and MIB on a 25 PRB stream with a lead and a CFO: the
    card's decisions equal the CPU's exactly, CFO and peak within 1e-3, and
    the MIB try is one Viterbi launch at B=4, n=40."""
    import dataclasses

    from srsue_tpu_torch import rx
    from srsue_tpu_torch.kernels import viterbi
    from srsue_tpu_torch.phy.receiver import Receiver
    from srsue_tpu_torch.radio import ArrayRadio

    cell = Cell(n_prb=25, cell_id=123)
    stream = rx.build_cell_stream(cell, 3, snr_db=12, sfn0=4, lead=1234, cfo=0.22)
    out = {}
    for dev in ("cpu", cuda_device):
        r = Receiver(ArrayRadio(stream.iq, cell.srate), device=dev)
        found = r.cell_search()
        before = viterbi.launches
        got = r.decode_mib_stream(found[0], found[2], found[3], found[1])
        assert viterbi.launches == before + (str(dev) != "cpu")
        out[str(dev)] = (found, got, r.metrics["peak"])
    (f_c, g_c, peak_c), (f_g, g_g, peak_g) = out["cpu"], out[str(cuda_device)]
    assert f_g[:3] == f_c[:3] == (123, f_c[1], f_c[2])
    assert abs(f_g[3] - f_c[3]) < 1e-3 and abs(f_c[3] - 0.22) < 0.02
    assert abs(peak_g - peak_c) < 1e-3 * peak_c
    assert dataclasses.asdict(g_g[0]) == dataclasses.asdict(g_c[0])
    assert g_g[1] == g_c[1] and g_g[2] == g_c[2] and g_c[0].n_prb == 25


def test_pbch_dematch_on_card_equals_cpu(cuda_device):
    """The PBCH's fixed-order sum of the 4 repeats gives the same softbuffer
    bit for bit on both devices."""
    from srsue_tpu_torch.phy import pbch

    llr = (torch.randn(4, pbch.E_FRAME, generator=torch.Generator().manual_seed(3)) * 9.0)
    cpu = pbch.dematch_quarter(llr)
    gpu = pbch.dematch_quarter(llr.to(cuda_device))
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=0)


def test_two_port_ue_dl_on_card_matches_cpu(cuda_device):
    """UeDl.process on a 2-port 15 PRB cell's C-RNTI subframe: CFI and DCI
    through the SFBC control region, the TB through Alamouti."""
    from srsue_tpu_torch import rx
    from srsue_tpu_torch.phy.ue_dl import UeDl

    cell = Cell(n_prb=15, cell_id=150, n_ports=2)
    crnti = 0x7B7B
    stream = rx.build_cell_stream(cell, 1, snr_db=20, seed=3, crnti=crnti, mcs_data=9)
    sf = rx.DATA_SF
    iq = stream.iq[sf * cell.sf_len: (sf + 1) * cell.sf_len][None]
    cpu = UeDl(cell, device="cpu").process(iq, sf, crnti)
    gpu = UeDl(cell, device=cuda_device).process(iq, sf, crnti)
    assert gpu.cfi == cpu.cfi == stream.cfi and gpu.grants == cpu.grants
    assert len(gpu.grants) == 1
    for a, b in zip((gpu.payload, gpu.tb_ok, gpu.turbo_iters),
                    (cpu.payload, cpu.tb_ok, cpu.turbo_iters)):
        np.testing.assert_array_equal(a, b)
    assert gpu.tb_ok.all()
    np.testing.assert_array_equal(gpu.payload[0], stream.data[(0, sf)])


def test_pusch_cell_on_card_matches_cpu(cuda_device):
    """Three UEs in one 25 PRB subframe (12 PRB 16QAM with CQI, 6 and 4 PRB
    QPSK, each with its ACK and cyclic shift), 2 subframes at 20 dB, through
    ``PuschCell``: each UE's payload, CRC flag, iterations, CQI and ACK equal
    on the card and the CPU, softbuffers within float32 rounding (rtol 1e-5,
    floor 1e-5 of the peak); every TB passes."""
    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCell, PuschCodec

    cell = Cell(n_prb=25, cell_id=301)
    ues = [(12, 1, 4, 4968, 0, 4), (6, 13, 2, 600, 6, 0), (4, 19, 2, 176, 3, 0)]
    rng = np.random.default_rng(17)
    sent = [[(rng.integers(0, 2, tbs).astype(np.uint8), rng.integers(0, 2, cqi).astype(np.uint8),
              bool(rng.integers(0, 2))) for _, _, _, tbs, _, cqi in ues] for _ in range(2)]
    out = {}
    for dev in ("cpu", cuda_device):
        codecs = [PuschCodec(cell, UlGrant(n, start, 0, qm, tbs), 0x1234 + i, 2,
                             n_cqi_bits=cqi, with_ack=True, device=dev)
                  for i, (n, start, qm, tbs, _, cqi) in enumerate(ues)]
        if dev == "cpu":
            wave = np.stack([sum(c.encode_sf_uci(p, cqi_bits=q if c.n_cqi_bits else None, ack=a,
                                                 cyclic_shift=ue[4])
                                 for c, ue, (p, q, a) in zip(codecs, ues, row)) for row in sent])
            nv = float(np.mean(np.abs(wave) ** 2)) * cell.nfft / (12 * 22) / 100.0
            noisy = (wave + np.sqrt(nv / 2) * (rng.standard_normal(wave.shape)
                                               + 1j * rng.standard_normal(wave.shape))
                     ).astype(np.complex64)
        rx = PuschCell(cell, codecs, [ue[4] for ue in ues])
        bufs = rx.dematch(torch.as_tensor(noisy, device=dev), nv)
        out[str(dev)] = ([[b.cpu() for b in u] for u in bufs],
                         [[v.cpu().numpy() for v in d] for d in rx.decode(bufs)],
                         [[None if v is None else v.cpu().numpy() for v in u]
                          for u in rx.decode_uci_sf()])
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    for ua, ub in zip(gpu[0], cpu[0], strict=True):
        for a, b in zip(ua, ub, strict=True):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    for u, ue in enumerate(ues):
        for a, b in zip(gpu[1][u], cpu[1][u]):
            np.testing.assert_array_equal(a, b)
        assert gpu[1][u][1].all()
        np.testing.assert_array_equal(gpu[1][u][0], np.stack([row[u][0] for row in sent]))
        np.testing.assert_array_equal(gpu[2][u][1], [row[u][2] for row in sent])
        np.testing.assert_array_equal(gpu[2][u][1], cpu[2][u][1])
        if ue[5]:
            np.testing.assert_array_equal(gpu[2][u][0], np.stack([row[u][1] for row in sent]))
            np.testing.assert_array_equal(gpu[2][u][0], cpu[2][u][0])


def test_pusch_with_uci_on_card_matches_cpu(cuda_device):
    """The uplink at 25 PRB, MCS 16 (2 x K=3904), with ACK and 4 CQI bits on
    PUSCH, 2 subframes at 14 dB: payload, TB CRC, iterations, ACK and CQI
    equal on the card and the CPU; softbuffers within float32 rounding
    (rtol 1e-5, floor 1e-5 of the peak); the card decoded by r2max, 2 x the
    iterations the loop ran; PHICH on the card's grid gives the CPU's sign."""
    from srsue_tpu_torch.phy import control
    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCodec

    cell = Cell(n_prb=25, cell_id=301)
    g = ra.dl_grant(25, 16)
    grant = UlGrant(g.n_prb, g.prb_start, g.mcs, g.mod_order, g.tbs)
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    cqi = np.array([1, 0, 0, 1], np.uint8)
    codecs = {str(dev): PuschCodec(cell, grant, 0x1234, 2, n_cqi_bits=4, with_ack=True,
                                   device=dev) for dev in ("cpu", cuda_device)}
    wave = codecs["cpu"].encode_sf_uci(payload, cqi_bits=cqi, ack=True)
    nv = float(np.mean(np.abs(wave) ** 2)) * cell.nfft / cell.n_sc / 10 ** 1.4
    noisy = (wave + np.sqrt(nv / 2) * (rng.standard_normal((2, wave.size))
                                       + 1j * rng.standard_normal((2, wave.size)))
             ).astype(np.complex64)
    out = {}
    for dev, codec in codecs.items():
        before = dict(bcjr.launches)
        bufs = codec.dematch_sf(noisy)
        pay, ok, iters = codec.decode_softbuffers(bufs)
        launched = {k: bcjr.launches[k] - before[k] for k in before}
        out[dev] = ([b.cpu() for b in bufs], pay.cpu().numpy(), ok.cpu().numpy(),
                    iters.cpu().numpy(), codec.decode_uci(), launched)
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    for a, b in zip(gpu[0], cpu[0], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    for a, b in zip(gpu[1:4], cpu[1:4]):
        np.testing.assert_array_equal(a, b)
    assert gpu[2].all() and (gpu[1] == payload).all()
    np.testing.assert_array_equal(gpu[4][0], cpu[4][0])
    np.testing.assert_array_equal(gpu[4][0], cqi)
    assert gpu[4][1] is cpu[4][1] is True
    assert cpu[5] == dict.fromkeys(cpu[5], 0)
    assert gpu[5] == {k: 2 * int(gpu[3].max()) if k == "r2max" else 0 for k in gpu[5]}

    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    group, nseq = control.phich_group_seq(grant.prb_start, 0, control.n_phich_groups(cell))
    control.phich_map(cell, grid, 6, group, nseq, False)
    m_gpu = control.phich_decode(cell, grid, 6, group, nseq, device=cuda_device)
    m_cpu = control.phich_decode(cell, grid, 6, group, nseq, device="cpu")
    assert m_gpu.device.type == "cuda" and float(m_gpu) < 0 and float(m_cpu) < 0
    torch.testing.assert_close(m_gpu.cpu(), m_cpu, rtol=1e-5, atol=1e-6)


def test_ota_attach_on_card_matches_cpu(cuda_device):
    """A 15 PRB attach with the UE and the eNB emulator on the card gives the
    CPU run's attach TTI and eNB event list, through the r2max and Viterbi
    kernels (``profile_chain.ota_attach``: noise 0.01 from default_rng(0))."""
    from srsue_tpu_torch.kernels import viterbi
    from srsue_tpu_torch.profile_chain import ota_attach

    before = (bcjr.launches["r2max"], viterbi.launches)
    gpu = ota_attach(cuda_device, 15)
    launched = (bcjr.launches["r2max"] - before[0], viterbi.launches - before[1])
    cpu = ota_attach("cpu", 15)
    assert gpu == cpu
    assert launched[0] > 0 and launched[1] > 0


def test_sharded_turbo_on_the_card(cuda_device):
    """The window-sharded decoder on one NCCL rank: the r2max kernel, 2 x
    n_iters launches counted in the rank, and the unsharded decoder's hard
    bits, iterations and CRC flags exactly."""
    from srsue_tpu_torch.parallel import mesh, ranks

    k, b = 1024, 8
    rng = np.random.default_rng(2)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    msgs = np.stack([crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A")
                     for _ in range(b)])
    x = 1.0 - 2.0 * np.stack([turbo.encode(msg) for msg in msgs]).astype(np.float32)
    llrs = (2.0 * (x + rng.standard_normal(x.shape).astype(np.float32)) / 1.0).astype(np.float32)
    (out,) = mesh.launch(ranks.turbo, 1, "cuda", llrs, k, 8, m)
    assert out["launches"]["r2max"] == 16
    assert {tuple(s) for s in out["shapes"]["r2max"]} == {(b * k // 64, 64)}
    hard, iters, ok = turbo.decode(torch.as_tensor(llrs, device=cuda_device), k, 8, m,
                                   early_exit=False, window=64)
    np.testing.assert_array_equal(out["hard"], hard.cpu().numpy())
    np.testing.assert_array_equal(out["iters"], iters.cpu().numpy())
    np.testing.assert_array_equal(out["ok"], ok.cpu().numpy())


def test_sweep_on_the_card_equals_the_cpu(cuda_device):
    from srsue_tpu_torch.phy import bler

    cell = Cell(n_prb=6, cell_id=3)
    args = (cell, 5, [-4, 0, 4, 10])
    card = bler.sweep_pdsch(*args, n_sf_per_point=6, device=cuda_device)
    cpu = bler.sweep_pdsch(*args, n_sf_per_point=6, device="cpu")
    assert [p.bler for p in card] == [p.bler for p in cpu]
    assert [p.mean_iters for p in card] == [p.mean_iters for p in cpu]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().view(torch.int32).numpy()


def test_repeated_positions_sum_as_on_the_cpu(cuda_device):
    """ROADMAP fault 7: softbuffers whose positions are sent 3 to 5 times
    (the PDCCH blind search at 100 PRB, whose common space holds L=4 and L=8
    candidates; a 2 PRB MCS 0 PDSCH grant, 4 repeats; a 1 PRB MCS 0 PUSCH
    grant, 3 repeats) are the CPU's bit for bit, from the same LLRs through
    each caller's own tables."""
    from srsue_tpu_torch.phy import control, dci, ratematch
    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCodec

    rng = np.random.default_rng(7)
    cell = Cell(n_prb=100, cell_id=42)
    tables = {dev: control._blind_tables(cell, 6, 1, 0x1234, dci.size_0_1a(100), True,
                                         torch.device(dev)) for dev in (cuda_device, "cpu")}
    inv = {dev: t[3] for dev, t in tables.items()}
    assert inv["cpu"].shape[1] == 5
    llr = (rng.standard_normal((64, tables["cpu"][2].shape[0])) * 4).astype(np.float32)
    got = {dev: ratematch.dematch(torch.as_tensor(llr, device=dev), inv[dev]) for dev in inv}
    np.testing.assert_array_equal(_bits(got[cuda_device]), _bits(got["cpu"]))

    small = Cell(n_prb=6, cell_id=7)
    pdsch = {dev: PdschCodec(small, ra.dl_grant(6, 0, n_prb_alloc=2), 0x42, 1, device=dev)
             for dev in (cuda_device, "cpu")}
    assert pdsch["cpu"].groups[0][5].shape == (180, 4)
    llr = (rng.standard_normal((64, pdsch["cpu"].G)) * 4).astype(np.float32)
    got = {dev: c.dematch(torch.as_tensor(llr, device=dev)) for dev, c in pdsch.items()}
    for a, b in zip(got[cuda_device], got["cpu"]):
        np.testing.assert_array_equal(_bits(a), _bits(b))

    g = ra.dl_grant(6, 0, n_prb_alloc=1)
    ul = UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=g.mcs, mod_order=g.mod_order,
                 tbs=g.tbs)
    pusch = {dev: PuschCodec(small, ul, 0x42, 2, device=dev) for dev in (cuda_device, "cpu")}
    assert pusch["cpu"].groups[0][5].shape == (132, 3)
    llr = (rng.standard_normal((64, pusch["cpu"].G)) * 4).astype(np.float32)
    got = {dev: ratematch.dematch(torch.as_tensor(llr, device=dev), c.groups[0][5])
           for dev, c in pusch.items()}
    np.testing.assert_array_equal(_bits(got[cuda_device]), _bits(got["cpu"]))


def _demap_case(name, dev):
    """(sym, nv, qm, scr, inv, sym_map, lo, hi) of a caller of the demap
    kernel, its own tables on `dev` and seeded symbols and noise; inv None
    for the LLR form."""
    from srsue_tpu_torch import entry
    from srsue_tpu_torch.phy import control, dci
    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCodec

    rng = np.random.default_rng(len(name))

    def rnd_sym(*shape):
        return torch.as_tensor(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                                * 0.7).astype(np.complex64), device=dev)

    def rnd_nv(*shape):
        return torch.as_tensor((0.01 + rng.random(shape)).astype(np.float32), device=dev)

    def pdsch(codec, nv):
        k, first, count, lo, hi, _ = codec.groups[-1]
        return (rnd_sym(4, codec.n_re), nv(4, codec.n_re), codec.qm, codec._scr,
                codec._inv32[-1], None, lo, hi)

    def pusch(grant, **kw):
        c = PuschCodec(Cell(n_prb=6 if grant.n_prb < 6 else 100, cell_id=42), grant, 0x42, 2,
                       device=dev, **kw)
        _, _, _, lo, hi, _ = c.groups[0]
        return (rnd_sym(4, c.n_re), rnd_nv(4, c.n_re), c.qm, c._scr_erase, c._inv32[0],
                c._data_pos, lo, hi)

    def ul(n_prb, mcs, n_prb_alloc=None):
        g = ra.dl_grant(n_prb, mcs, n_prb_alloc=n_prb_alloc) if n_prb_alloc else ra.dl_grant(
            n_prb, mcs)
        return UlGrant(g.n_prb, g.prb_start, g.mcs, g.mod_order, g.tbs)

    if name == "flagship 64QAM per-RE noise":
        return pdsch(entry.flagship(dev)[1], rnd_nv)
    if name == "16QAM scalar noise":
        codec = PdschCodec(Cell(n_prb=100, cell_id=42), ra.dl_grant(100, 16), 0x1234, 6,
                           device=dev)
        return pdsch(codec, lambda *s: 0.37)
    if name == "2 PRB MCS 0 PDSCH (R=4)":
        return pdsch(PdschCodec(Cell(n_prb=6, cell_id=7), ra.dl_grant(6, 0, n_prb_alloc=2),
                                0x42, 1, device=dev), rnd_nv)
    if name == "blind search 100 PRB (R=5)":
        cell = Cell(n_prb=100, cell_id=42)
        args = (cell, 6, 1, 0x1234, dci.size_0_1a(100), True, torch.device(dev))
        _, _, scr, _, _, _ = control._blind_tables(*args)
        res32, buf32, _ = control._blind_tables32(*args)
        return (rnd_sym(4, cell.n_sym_sf * cell.n_sc), rnd_nv(4, 1), 2, scr, buf32, res32, 0,
                scr.numel())
    if name == "1 PRB MCS 0 PUSCH (R=3)":
        return pusch(ul(6, 0, 1))
    if name == "PUSCH 50 PRB MCS 20, ACK + CQI erasures":
        return pusch(ul(50, 20), n_cqi_bits=4, with_ack=True)
    if name == "PBCH LLRs":
        return rnd_sym(4, 240), rnd_nv(4, 240), 2, None, None, None, 0, 0
    return rnd_sym(4, 16), 0.25, 2, None, None, None, 0, 0  # PCFICH, scalar noise


DEMAP_CASES = ("flagship 64QAM per-RE noise", "16QAM scalar noise", "2 PRB MCS 0 PDSCH (R=4)",
               "blind search 100 PRB (R=5)", "1 PRB MCS 0 PUSCH (R=3)",
               "PUSCH 50 PRB MCS 20, ACK + CQI erasures", "PBCH LLRs", "PCFICH LLRs")


@pytest.mark.parametrize("name", DEMAP_CASES)
def test_demap_kernel_matches_plain(cuda_device, name):
    """csrc/demap.cu = its plain version at atol 0 (bit for bit), one launch
    per call, recorded at its (form, qm, R)."""
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy import modulation, ratematch

    sym, nv, qm, scr, inv, sym_map, lo, hi = _demap_case(name, cuda_device)
    before = demap.launches
    if inv is None:
        got = modulation.demodulate_soft(sym, qm, nv)
        ref = modulation.demodulate_soft_plain(sym, qm, nv)
        form, r = "llr", 0
    else:
        got = ratematch.demap_dematch(sym, nv, qm, scr, inv, sym_map, lo, hi)
        ref = ratematch.demap_dematch_plain(sym, nv, qm, scr, inv, sym_map, lo, hi)
        form, r = "softbuffer", inv.shape[1]
    torch.cuda.synchronize()
    assert demap.launches == before + 1
    assert (form, qm, r, 4, got.shape[-1]) in demap.shapes
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("name", ["flagship row in one tile (over budget, chunked)",
                                  "OTA grant 100 PRB MCS 6, B=1 (cluster)"])
def test_demap_kernel_chunked_and_split(cuda_device, name):
    """The tiled kernel's chunked range (the flagship's whole row as one
    segment: 90,000 bits, more than one CTA's shared memory) and a segment
    split over a cluster (B=1) = the plain version bit for bit, one launch."""
    from srsue_tpu_torch import bench_kernel_variants
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy import ratematch

    chunked = "chunked" in name
    c = bench_kernel_variants.demap_case(
        "flagship PDSCH B=256" if chunked else "OTA grant B=1", cuda_device)
    ranges = None if chunked else c["ranges"]
    del c["ranges"]
    n, d, n_e = c["sym"].shape[0], c["inv"].shape[0], c["hi"] - c["lo"]
    p = demap.plan(n, d, None if chunked else d // ranges.shape[0], n_e, c["qm"])
    live = c["inv"][(c["inv"] >= 0) & (c["inv"] < n_e)]
    nsym = (c["lo"] + int(live.max())) // c["qm"] - (c["lo"] + int(live.min())) // c["qm"] + 1
    if chunked:
        assert p.tiles == 1 and nsym > p.csize * p.bs
    else:
        assert p.csize > 1 and p.tiles * p.csize < 132
    before = demap.launches
    got = ratematch.demap_dematch(**c, ranges=ranges)
    ref = ratematch.demap_dematch_plain(**c)
    torch.cuda.synchronize()
    assert demap.launches == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("qm", [2, 4, 6])
def test_demap_kernel_special_values(cuda_device, qm):
    """Ties between levels, +-0, huge values, +-inf and NaN among the
    symbols, tiny and NaN noise, through a table of 3 repeats with erasures
    and in the LLR form: kernel = plain bit for bit on the card, NaNs
    included."""
    from srsue_tpu_torch import bench_kernel_variants
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy import modulation, ratematch

    sym, nv, scr, inv = bench_kernel_variants.demap_special_case(qm, 8, cuda_device, qm)
    before = demap.launches
    got = ratematch.demap_dematch(sym, nv, qm, scr, inv)
    ref = ratematch.demap_dematch_plain(sym, nv, qm, scr, inv)
    llr = modulation.demodulate_soft(sym, qm, nv)
    llr_ref = modulation.demodulate_soft_plain(sym, qm, nv)
    torch.cuda.synchronize()
    assert demap.launches == before + 2
    assert bool(ref.isnan().any()) and bool(llr_ref.isnan().any())
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(llr), _bits(llr_ref))


def test_demap_gather_variant_matches_plain(cuda_device):
    """The softbuffer form's earlier design, kept for the benchmark, gives
    the same bits; its launches count apart from the path's."""
    from srsue_tpu_torch import bench_kernel_variants
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy import ratematch

    c = bench_kernel_variants.demap_case("uplink PUSCH B=256", cuda_device)
    before, gathered = demap.launches, demap.gather_launches
    got = bench_kernel_variants.demap_variants(c)["demap_gather"]()
    c.pop("ranges")
    ref = ratematch.demap_dematch_plain(**c)
    torch.cuda.synchronize()
    assert (demap.launches, demap.gather_launches) == (before, gathered + 1)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_demap_wrapper_rejects_bad_input(cuda_device):
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy import modulation

    sym = torch.zeros(4, 32, dtype=torch.complex64, device=cuda_device)
    lv = modulation.levels(2, cuda_device)
    scr = torch.ones(64, device=cuda_device)
    inv = torch.arange(64, dtype=torch.int32, device=cuda_device)[:, None]
    before = demap.launches
    with pytest.raises(ValueError, match="contiguous"):
        demap.demap_llr_cuda(sym.t().contiguous().t(), 1.0, 2, lv)
    with pytest.raises(ValueError, match="contiguous"):
        demap.demap_dematch_cuda(sym, 1.0, 2, lv, scr, inv.expand(64, 2), None, 0, 64)
    with pytest.raises(TypeError, match="complex64"):
        demap.demap_llr_cuda(sym.to(torch.complex128), 1.0, 2, lv)
    with pytest.raises(TypeError, match="int32"):
        demap.demap_dematch_cuda(sym, 1.0, 2, lv, scr, inv.long(), None, 0, 64)
    with pytest.raises(TypeError, match="noise"):
        demap.demap_llr_cuda(sym, torch.ones(4, 32, dtype=torch.float64, device=cuda_device),
                             2, lv)
    with pytest.raises(ValueError, match="qm=3"):
        demap.demap_llr_cuda(sym, 1.0, 3, lv)
    with pytest.raises(ValueError, match="cpu"):
        demap.demap_dematch_cuda(sym, 1.0, 2, lv, scr.cpu(), inv, None, 0, 64)
    with pytest.raises(ValueError, match="cpu"):
        demap.demap_llr_cuda(sym, torch.ones(4, 32), 2, lv)
    with pytest.raises(ValueError, match="slice"):
        demap.demap_dematch_cuda(sym, 1.0, 2, lv, scr, inv, None, 0, 65)
    assert demap.launches == before


def test_blind_search_and_pusch_decode_through_the_demap_kernel(cuda_device):
    """The blind search (one demap launch, the softbuffer form) and the PUSCH
    decode with UCI (one per K-group, and the LLR form for the CQI and ACK
    symbols) on the card give the CPU's decisions."""
    from srsue_tpu_torch import rx
    from srsue_tpu_torch.kernels import demap
    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCodec

    clean = rx.build_clean(2, cell=Cell(n_prb=25, cell_id=42), mcs=9, cfi=2)
    noisy = rx.add_noise(clean.rng, clean.td, clean.p_sig, 12.0)
    found = {}
    for dev in ("cpu", cuda_device):
        fn = rx.make_rx(clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
                        clean.dci_bits, True, "zf", device=dev)
        before = demap.launches
        stats = rx.tb_stats(fn(torch.as_tensor(noisy, device=dev)), clean.payloads, clean.cfi)
        found[str(dev)] = {k: float(v) for k, v in stats.items()}
        # PCFICH (LLR form), the blind search and the PDSCH (softbuffer form)
        assert demap.launches == before + (3 if str(dev) != "cpu" else 0)
    assert found["cpu"] == found[str(cuda_device)]
    assert found["cpu"]["n_dci"] == found["cpu"]["n_ok"] == 2

    cell = Cell(n_prb=6, cell_id=17)
    g = ra.dl_grant(6, 9)
    grant = UlGrant(g.n_prb, g.prb_start, g.mcs, g.mod_order, g.tbs)
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    cqi = np.array([0, 1, 1, 0], np.uint8)
    out = {}
    for dev in ("cpu", cuda_device):
        codec = PuschCodec(cell, grant, 0x1234, 2, n_cqi_bits=4, with_ack=True, device=dev)
        wave = codec.encode_sf_uci(payload, cqi_bits=cqi, ack=False)
        iq = (wave + 0.05 * np.random.default_rng(1).standard_normal(wave.size)).astype(
            np.complex64)[None]
        before = demap.launches
        pay, ok, iters = codec.decode_sf(iq)
        assert demap.launches == before + (len(codec.groups) + 2 if str(dev) != "cpu" else 0)
        out[str(dev)] = (pay.cpu().numpy(), ok.cpu().numpy(), iters.cpu().numpy(),
                         codec.decode_uci())
    for a, b in zip(out["cpu"][:3], out[str(cuda_device)][:3]):
        np.testing.assert_array_equal(a, b)
    assert out["cpu"][1].all() and (out["cpu"][0] == payload).all()
    for uci in (out["cpu"][3], out[str(cuda_device)][3]):
        np.testing.assert_array_equal(uci[0], cqi)
        assert uci[1] is False


# ------------------------------------------------------- the frontends' graphs
@pytest.fixture
def frontend_graphs(cuda_device, monkeypatch):
    """The card with an empty graph cache, the frontends' captures and
    replays counted."""
    from srsue_tpu_torch.phy import frontend
    from srsue_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    counts = {"capture": 0, "replay": 0}

    class Counted(frontend._Replayed):
        def __init__(self, *args):
            super().__init__(*args)
            counts["capture"] += 1

        def __call__(self, *xs):
            counts["replay"] += 1
            return super().__call__(*xs)

    monkeypatch.setattr(frontend, "_Replayed", Counted)
    return counts


def _frontend_iq(ports: int, batch: int, seed: int = 3):
    """A C-RNTI subframe (DCI 1A and its PDSCH at MCS 9) of a 20 MHz cell at
    B=1, of a 5 MHz one at B=4 (one stream a row), in host memory."""
    from srsue_tpu_torch import rx

    cell = Cell(n_prb=100 if batch == 1 else 25, cell_id=150, n_ports=ports)
    sf, rows = rx.DATA_SF, []
    for i in range(batch):
        s = rx.build_cell_stream(cell, 1, snr_db=20, seed=seed + i, crnti=0x7B7B, mcs_data=9)
        rows.append(s.iq[sf * cell.sf_len: (sf + 1) * cell.sf_len])
    return cell, sf, (rows[0] if batch == 1 else np.stack(rows)).astype(np.complex64)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tensors(out[k])]
    return [t for v in out for t in _tensors(v)]


def _close(got, want) -> bool:
    """Every tensor within 1e-6 of the largest magnitude of its eager
    twin; True if all are equal bit for bit."""
    exact = True
    for g, w in zip(_tensors(got), _tensors(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= 1e-6 * scale
        exact &= bool(torch.equal(g, w))
    return exact


def _frontend_call(which: str, cell, sf, iq, dev):
    """The frontend `which` as its callers call it: ``UeDl.front_end`` on
    the host array (B=1) or a card tensor (B=4), or on a card tensor of
    one subframe [sf_len] as ``Phy.work`` passes it ("phy"),
    ``pdsch.equalized`` on a card tensor with a codec of the subframe's
    grant."""
    from srsue_tpu_torch.phy import pdsch
    from srsue_tpu_torch.phy.ue_dl import UeDl

    if which in ("ue_dl", "phy"):
        ue = UeDl(cell, device=dev)
        x = iq if which == "ue_dl" and iq.ndim == 1 else torch.as_tensor(iq, device=dev)
        return lambda: ue.front_end(x, sf)
    codec = PdschCodec(cell, ra.dl_grant(cell.n_prb, 9), 0x7B7B, sf, 2, device=dev)
    x = torch.as_tensor(iq, device=dev)
    return lambda: pdsch.equalized(cell, codec, sf, x)


@pytest.mark.parametrize("which,ports,batch", [
    ("equalized", 1, 1), ("equalized", 1, 4), ("ue_dl", 1, 1), ("ue_dl", 1, 4),
    ("ue_dl", 2, 1), ("ue_dl", 2, 4), ("phy", 1, 1)])
def test_frontend_replay_equals_eager(frontend_graphs, cuda_device, which, ports, batch):
    """A frontend's first call at a key runs eagerly, its second captures
    and replays, later ones replay; each replay equals the eager call within
    1e-6 of each output's scale (printed: bit for bit or not), and
    ``UeDl.process`` makes the CPU's decisions eager, capturing and
    replaying."""
    from srsue_tpu_torch.phy.ue_dl import UeDl

    cell, sf, iq = _frontend_iq(ports, batch)
    call = _frontend_call(which, cell, sf, iq, cuda_device)
    eager = call()
    assert frontend_graphs == {"capture": 0, "replay": 0}
    replays = []
    for i in range(3):
        replays.append(call())
        assert frontend_graphs == {"capture": 1, "replay": i + 1}
    exact = [_close(r, eager) for r in replays]
    print(f"frontend {which} ports {ports} B={batch}: replays bit for bit {exact}")

    cpu = UeDl(cell, device="cpu").process(iq, sf, 0x7B7B)
    assert len(cpu.grants) == 1 and cpu.tb_ok.all()
    for _ in range(3):  # eager, capture and replay (ue_dl: replays)
        res = UeDl(cell, device=cuda_device).process(iq, sf, 0x7B7B)
        assert res.cfi == cpu.cfi and res.grants == cpu.grants
        assert res.hits_per_elem == cpu.hits_per_elem
        for a, b in zip((res.payload, res.tb_ok, res.turbo_iters),
                        (cpu.payload, cpu.tb_ok, cpu.turbo_iters)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["equalized", "ue_dl"])
def test_frontend_held_results_survive(frontend_graphs, cuda_device, which):
    """A replayed result a caller holds stays as it was after the next
    replay at its key (on other IQ), after turbo decodes that capture and
    replay their own graphs into the same pool, and after the caches of
    the tables the graph reads drop them and the freed memory is reused;
    the graph then still gives the eager result."""
    from srsue_tpu_torch.phy import chest, control, frontend

    cell, sf, iq = _frontend_iq(2 if which == "ue_dl" else 1, 4)
    _, _, other = _frontend_iq(cell.n_ports, 4, seed=11)
    call = _frontend_call(which, cell, sf, iq, cuda_device)
    eager = frontend._clone(call())
    held = call()
    assert frontend_graphs["capture"] == 1
    _frontend_call(which, cell, sf, other, cuda_device)()
    d, m = _card_turbo_inputs(cuda_device)
    for _ in range(3):
        turbo.decode(d, 512, 8, m)
    chest.device_tables.cache_clear()
    control.control_region_index.cache_clear()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 20,), float("nan"), device=cuda_device) for _ in range(64)]
    assert _close(held, eager)
    assert _close(call(), eager)
    assert frontend_graphs == {"capture": 1, "replay": 3}
    del junk


def _card_turbo_inputs(dev):
    k = 512
    rng = np.random.default_rng(5)
    m = np.zeros((k, 24), np.uint8)
    m[:k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    msgs = [crcmod.attach(rng.integers(0, 2, k - 24).astype(np.uint8), "24A") for _ in range(3)]
    x = 1.0 - 2.0 * np.stack([turbo.encode(msg) for msg in msgs]).astype(np.float32)
    llrs = 2.0 * (x + 0.8 * rng.standard_normal(x.shape).astype(np.float32)) / 0.64
    return (torch.as_tensor(llrs, dtype=torch.float32, device=dev),
            torch.as_tensor(m, dtype=torch.float32, device=dev))


def test_frontend_cpu_tensors_never_capture(frontend_graphs):
    """On a machine with a card, CPU frontends stay eager and enter no key."""
    from srsue_tpu_torch.utils import graphs

    for which in ("ue_dl", "equalized"):
        cell, sf, iq = _frontend_iq(1, 1)
        call = _frontend_call(which, cell, sf, iq, torch.device("cpu"))
        for _ in range(3):
            call()
    assert frontend_graphs == {"capture": 0, "replay": 0} and not graphs.GRAPHS.keys


def test_frontend_budget_drops_least_recently_used(frontend_graphs, cuda_device, monkeypatch):
    """With room in a sixteenth of the card for one and a half frontend
    graphs, each capture at a new subframe drops the graph held before it;
    a dropped subframe runs eagerly again, then captures again, and every
    result equals its eager one."""
    from srsue_tpu_torch.phy import frontend
    from srsue_tpu_torch.phy.ue_dl import UeDl
    from srsue_tpu_torch.utils import graphs

    cell, _, iq = _frontend_iq(1, 4)
    ue = UeDl(cell, device=cuda_device)
    x = torch.as_tensor(iq, device=cuda_device)
    eager = {sf: frontend._clone(ue.front_end(x, sf)) for sf in (0, 1, 2, 3)}
    for sf in (0, 1):  # a capture each: the first also holds what its stream keeps
        ue.front_end(x, sf)
    (one,) = [g.bytes for k, g in graphs.GRAPHS.keys.items() if g is not None and k[2] == 1]
    graphs.GRAPHS.keys.clear()
    monkeypatch.setattr(graphs, "memory", lambda dev: graphs.GraphCache.SHARE * (3 * one // 2))

    def held():
        return [k[2] for k, g in graphs.GRAPHS.keys.items() if g is not None]

    for sf in (2, 3, 1):
        for _ in range(2):  # eager, then the capture
            assert _close(ue.front_end(x, sf), eager[sf])
        assert held() == [sf]
    assert frontend_graphs["capture"] == 5
    for sf in (2, 1):
        assert _close(ue.front_end(x, sf), eager[sf])  # 2 dropped: eager; 1 replays
    assert held() == [1] and frontend_graphs == {"capture": 5, "replay": 6}


# ------------------------------------------------------- the uplink's graphs
def _ul_receiver(which: str, dev):
    """On `dev`: "cell", ``PuschCell`` over perfbench's lte20_pusch_7ue_mixed
    (seven allocations, 16QAM and QPSK, each its DMRS shift and ACK, two with
    CQI); "codec", its first UE's ``PuschCodec`` (25 PRB 16QAM, CQI and ACK)
    alone, at its shift. Returns (receiver, its codecs, their shifts)."""
    import json
    from pathlib import Path

    from srsue_tpu_torch.phy.cell import UlGrant
    from srsue_tpu_torch.phy.pusch import PuschCell, PuschCodec

    cfg = json.loads((Path(__file__).resolve().parent.parent / "perfbench" / "configs" /
                      "lte20_pusch_7ue_mixed.json").read_text())
    cell = Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])
    ues = cfg["ues"][:1] if which == "codec" else cfg["ues"]
    codecs = [PuschCodec(cell, UlGrant(n_prb=ue["n_prb"], prb_start=ue["prb_start"],
                                       mcs=ue["mcs"], mod_order=ue["qm"], tbs=ue["tbs"],
                                       rv=cfg["rv"]),
                         ue["rnti"], cfg["subframe"], n_turbo_iters=cfg["turbo_iters"],
                         n_cqi_bits=ue["cqi_bits"], with_ack=ue["ack_symbols"] > 0,
                         cqi_rep=ue["cqi_repetition"], ack_syms=ue["ack_symbols"],
                         device=dev) for ue in ues]
    shifts = [ue["cyclic_shift"] for ue in ues]
    rx = codecs[0] if which == "codec" else PuschCell(cell, codecs, shifts)
    return rx, codecs, shifts


def _ul_iq(codecs, shifts, batch: int, seed: int):
    """`batch` subframes [batch, sf_len] in host memory, each UE its own TB,
    CQI and ACK, at 20 dB per allocated subcarrier, and the noise."""
    rng = np.random.default_rng(seed)
    td = np.stack([sum(c.encode_sf_uci(
        rng.integers(0, 2, c.grant.tbs).astype(np.uint8),
        cqi_bits=rng.integers(0, 2, c.n_cqi_bits).astype(np.uint8) if c.n_cqi_bits else None,
        ack=bool(rng.integers(2)), cyclic_shift=cs) for c, cs in zip(codecs, shifts))
        for _ in range(batch)])
    nv = float(np.mean(np.abs(td) ** 2)) * codecs[0].cell.nfft / sum(
        c.m_sc for c in codecs) / 100.0
    noisy = td + np.sqrt(nv / 2) * (rng.standard_normal(td.shape)
                                    + 1j * rng.standard_normal(td.shape))
    return noisy.astype(np.complex64), nv


def _ul_step(which, rx, codecs, shifts, iq, nv):
    """The receive as the benchmark's step runs it: (softbuffers, each
    codec's UCI LLRs, ``decode_uci_sf``, ``decode``), and the demap kernel's
    launches it counted."""
    from srsue_tpu_torch.kernels import demap

    before = demap.launches
    if which == "codec":
        bufs = [rx.dematch_sf(iq, nv, shifts[0])]
        uci, decoded = [rx.decode_uci_sf()], [rx.decode_softbuffers(bufs[0])]
    else:
        bufs = rx.dematch(iq, nv)
        uci, decoded = rx.decode_uci_sf(), rx.decode(bufs)
    return (bufs, [c._last_uci_llrs for c in codecs], uci, decoded), demap.launches - before


def _equal(got, want) -> None:
    """Every tensor of `got` equals its twin in `want` bit for bit (None
    where `want` has None)."""
    if want is None or isinstance(want, torch.Tensor):
        assert (got is None) == (want is None)
        assert want is None or (got.dtype == want.dtype and torch.equal(got, want))
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("which", ["cell", "codec"])
@pytest.mark.parametrize("batch", [1, 4])
def test_uplink_replay_equals_eager(frontend_graphs, cuda_device, which, batch):
    """The uplink receive's first call at a key runs eagerly, its second
    captures its two stages (front end, demap) and replays them, later ones
    replay; softbuffers, UCI LLRs, ``decode_uci_sf`` and ``decode`` equal the
    eager call's bit for bit, and each call counts the eager call's demap
    launches."""
    rx, codecs, shifts = _ul_receiver(which, cuda_device)
    iq, nv = _ul_iq(codecs, shifts, batch, seed=23)
    x = torch.as_tensor(iq, device=cuda_device)
    eager, launched = _ul_step(which, rx, codecs, shifts, x, nv)
    assert frontend_graphs == {"capture": 0, "replay": 0}
    assert launched == sum(len(c.groups) + bool(c.n_cqi_bits) + c.with_ack for c in codecs)
    for i in range(3):
        got, n = _ul_step(which, rx, codecs, shifts, x, nv)
        assert frontend_graphs == {"capture": 2, "replay": 2 * (i + 1)} and n == launched
        _equal(got, eager)
    assert all(bool(ok.all()) for _, ok, _ in eager[3])


def test_uplink_held_results_survive(frontend_graphs, cuda_device, monkeypatch):
    """Results held from one call of the 7-UE receive stay as they were
    after a replay on other IQ by a receiver built alike, and after turbo
    decodes reuse the pool; ``decode_uci_sf`` then reads the later call's
    LLRs, and both calls equal their eager twins bit for bit."""
    from srsue_tpu_torch.utils import graphs

    rx, codecs, shifts = _ul_receiver("cell", cuda_device)
    a, nv = _ul_iq(codecs, shifts, 4, seed=31)
    b, _ = _ul_iq(codecs, shifts, 4, seed=37)
    a, b = (torch.as_tensor(v, device=cuda_device) for v in (a, b))
    eager = {}
    for name, x in (("a", a), ("b", b)):  # each the first call of a fresh cache
        monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
        eager[name] = _ul_step("cell", rx, codecs, shifts, x, nv)[0]
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache())
    _ul_step("cell", rx, codecs, shifts, a, nv)
    held, _ = _ul_step("cell", rx, codecs, shifts, a, nv)
    assert frontend_graphs["capture"] == 2
    other, other_codecs, _ = _ul_receiver("cell", cuda_device)
    later, _ = _ul_step("cell", other, other_codecs, shifts, b, nv)
    assert frontend_graphs == {"capture": 2, "replay": 4}
    d, m = _card_turbo_inputs(cuda_device)
    for _ in range(3):
        turbo.decode(d, 512, 8, m)
    _equal(held, eager["a"])
    _equal(later, eager["b"])
    _equal(other.decode_uci_sf(), eager["b"][2])
    _equal(rx.decode_uci_sf(), eager["a"][2])
