"""Device-time breakdown of the port's main path on one CUDA GPU.

    python -m srsue_tpu_torch.profile_chain [B]
    python -m srsue_tpu_torch.profile_chain ota [n_prb]

Runs, at B subframes (default 256), once each under ``torch.profiler``
after a warm-up call: the grant-known 20 MHz MCS 28 chain (``entry.entry``)
with the turbo decoder in each of its forms -- forced 8 iterations (the
fused half), 8 masked iterations and CRC early exit --; the blind control +
data chain (``rx.make_rx``, ZF) with CRC early exit and forced; its
control stage alone (full-grid ZF, PCFICH, blind search); and the uplink's
eNB-side PUSCH decode at full width (``rx.build_pusch``: 100 PRB, MCS 28, 26
dB), ``PuschCodec.decode_sf`` and its two halves, ``dematch_sf`` and
``decode_softbuffers`` (CRC early exit). Prints for each:
the wall time of the call, the summed device time of its kernels, the
device's idle share of the wall time, and the kernels with the most device
time.

``ota``: the whole UE over the air (``Ue`` + ``Phy`` against ``EnbPhy`` on
an n_prb cell, default 100, noise 0.01 as in the OTA tests) attaches once
to warm every cache, then again under ``torch.profiler`` and once more with
host wall timers (synchronised) around the facade's stages. Prints the
attach's wall, device time and idle share, kernel launches and host reads
per TTI, the top kernels, and the host wall of each stage of
``Phy.work`` and ``EnbPhy.receive_ul`` summed over the attach.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import entry, rx
from .phy import chest, dci, ofdm
from .phy.pusch import PuschCodec
from .utils.device import require_cuda


def breakdown(fn, args, top: int = 12) -> dict:
    """Profile one call of fn(*args); returns wall/device ms, idle share
    and the `top` kernels by device time as (name, calls, ms)."""
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "top": [(e.key, e.count, e.self_device_time_total / 1e3)
                    for e in kernels[:top]]}


def blind_runs(batch: int, dev):
    """(label, fn, args) of the blind chain (early exit, forced) and its
    control stage, on bench.py's subframes at 26 dB."""
    clean = rx.build_clean(batch, n_distinct=4)
    iq = torch.as_tensor(rx.add_noise(clean.rng, clean.td, clean.p_sig, 26.0), device=dev)
    args = (clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
            clean.dci_bits, clean.payloads)
    grid = ofdm.demodulate(clean.cell, iq)
    h, nvar, _ = chest.estimate(clean.cell, grid, clean.subframe)
    ctrl = rx.control_stage(clean.cell, clean.subframe, clean.cfi, clean.rnti,
                            dci.size_0_1a(clean.cell.n_prb))
    return [("blind early exit", rx.make_rx(*args, early_exit=True, device=dev), (iq,)),
            ("blind forced 8", rx.make_rx(*args, early_exit=True, forced=True, device=dev),
             (iq,)),
            ("control stage", ctrl, (grid, h, nvar))]


def uplink_runs(batch: int, dev):
    """(label, fn, args) of the eNB-side PUSCH decode at full width and its
    two halves."""
    ul = rx.build_pusch(batch, n_distinct=4)
    iq = torch.as_tensor(rx.add_noise(ul.rng, ul.td, ul.p_sig, 26.0), device=dev)
    codec = PuschCodec(ul.cell, ul.grant, ul.rnti, ul.subframe, device=dev)
    bufs = codec.dematch_sf(iq)
    return [("pusch decode_sf", codec.decode_sf, (iq,)),
            ("pusch dematch_sf", codec.dematch_sf, (iq,)),
            ("pusch decode_softbuffers", codec.decode_softbuffers, (bufs,))]


def ota_attach(dev, n_prb: int, seed: int = 0, max_tti: int = 220):
    """One attach of the port's UE to its eNB emulator over the air (cell
    123, complex AWGN of amplitude 0.01 from default_rng(seed)); returns the
    attach TTI and the eNB's events."""
    from .enb.phy import EnbPhy
    from .enb.stack import EnbStack
    from .phy.cell import Cell
    from .phy.phy import Phy
    from .ue import Ue

    cell = Cell(n_prb=n_prb, cell_id=123)
    phy = Phy(cell, device=dev)
    ue = Ue(phy=phy)
    phy.mac, phy.rrc = ue.mac, ue.rrc
    stack = EnbStack(ue.usim.cfg)
    enb = EnbPhy(cell, stack, device=dev)
    rng = np.random.default_rng(seed)
    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
    for tti in range(max_tti):
        dl = enb.build_dl_subframe(tti)
        dl = dl + 0.01 * (rng.standard_normal(dl.shape) + 1j * rng.standard_normal(dl.shape)
                          ).astype(np.complex64)
        ul = phy.work(tti, dl)
        ue.run_tti(tti)
        enb.receive_ul(tti, ul)
        if ue.is_attached and stack.state == "attached":
            return tti, list(enb.events)
    raise RuntimeError(f"no attach in {max_tti} TTIs: {enb.events[:30]}")


# (owner module, function) pairs timed by ota_stages: the facade's stages
_OTA_STAGES = (("phy.phy", "Phy.work"), ("phy.sync", "cfo_correct"),
               ("phy.sync", "cfo_estimate_cp"), ("phy.ofdm", "demodulate"),
               ("phy.chest", "estimate"), ("phy.equalize", "zf"),
               ("phy.control", "sfbc_equalize_control"), ("phy.control", "pcfich_decode"),
               ("phy.control", "phich_decode"), ("phy.control", "pdcch_blind_decode"),
               ("phy.phy", "Phy._decode_dlsch"), ("mac.dl_harq", "DlHarq.tb_decoded"),
               ("mac.mac", "Mac._decode_now"), ("phy.phy", "Phy._assemble_ul"),
               ("enb.phy", "EnbPhy.build_dl_subframe"), ("enb.phy", "EnbPhy.receive_ul"),
               ("enb.phy", "EnbPhy._decode_pusch"))


@contextlib.contextmanager
def ota_stages(totals: dict):
    """Host wall ms (synchronised before and after) of every call of the
    _OTA_STAGES functions, summed into totals[name] = [calls, ms]; nested
    stages count inside their callers too."""
    import importlib

    saved = []
    for mod_name, qual in _OTA_STAGES:
        owner = importlib.import_module(f"{__package__}.{mod_name}")
        for part in qual.split(".")[:-1]:
            owner = getattr(owner, part)
        attr = qual.split(".")[-1]
        orig = getattr(owner, attr)

        def timed(*a, _orig=orig, _name=qual, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = _orig(*a, **kw)
            torch.cuda.synchronize()
            c = totals.setdefault(_name, [0, 0.0])
            c[0] += 1
            c[1] += (time.perf_counter() - t0) * 1e3
            return r

        saved.append((owner, attr, orig))
        setattr(owner, attr, timed)
    try:
        yield totals
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


def ota_main(n_prb: int = 100) -> None:
    dev = require_cuda()
    ota_attach(dev, n_prb)  # warm-up: cuFFT plans, codecs, tables, the kernels' build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tti, _ = ota_attach(dev, n_prb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    kernels = sorted((e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    runtime = collections.Counter({e.key: e.count for e in ev if e.key.startswith("cuda")})
    n = tti + 1
    print(f"ota attach {n_prb} PRB, {n} TTIs under the profiler: wall {wall_ms:.3f} ms "
          f"({wall_ms / n:.3f} per TTI), kernels {device_ms:.3f} ms, device idle "
          f"{100 * max(0.0, 1 - device_ms / wall_ms):.1f}%; per TTI: "
          f"{runtime['cudaLaunchKernel'] / n:.1f} cudaLaunchKernel, "
          f"{runtime['cudaMemcpyAsync'] / n:.1f} cudaMemcpyAsync, "
          f"{runtime['cudaStreamSynchronize'] / n:.1f} cudaStreamSynchronize")
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    totals: dict = {}
    with ota_stages(totals):
        t0 = time.perf_counter()
        ota_attach(dev, n_prb)
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"ota attach {n_prb} PRB with stage timers (synchronised): wall {wall_ms:.3f} ms; "
          f"host wall per stage, summed over the attach (calls, ms, ms per call):")
    for name, (calls, ms) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:28s} {calls:6d}x {ms:10.3f} ms {ms / calls:8.3f}")


def main(batch: int = 256) -> None:
    dev = require_cuda()
    runs = []
    for mode, form in (("forced 8", {"forced": True}),
                       ("masked 8", {"early_exit": False}),
                       ("early exit", {"early_exit": True})):
        fn, args, _ = entry.entry(dev, batch=batch, n_distinct=4, **form)
        runs.append((mode, fn, args))
    for mode, fn, args in runs + blind_runs(batch, dev) + uplink_runs(batch, dev):
        r = breakdown(fn, args)
        print(f"{mode} B={batch}: wall {r['wall_ms']:.3f} ms, kernels "
              f"{r['device_ms']:.3f} ms, device idle {100 * r['idle_share']:.1f}%")
        for name, calls, ms in r["top"]:
            print(f"  {ms:9.3f} ms {calls:6d}x  {name[:100]}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "ota":
        ota_main(int(sys.argv[2]) if len(sys.argv) > 2 else 100)
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
