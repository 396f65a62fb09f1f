"""UE application entry point (reference: ue/src/main.cc — config file +
CLI flags, metrics table thread, trace dumps). The port's counterpart of
``srsue_tpu/main.py`` (its reference): the same options, plus ``--device``
for the receive chain of ``--iq`` / ``--iq-tcp`` (the card by default).

Usage:
    python -m srsue_tpu_torch.main --iq capture.iq --srate 7.68e6 [ue.conf]
    python -m srsue_tpu_torch.main --selftest        # hermetic attach selftest

The reference drives a USRP; without RF hardware the production input is
an IQ stream (file/array radio). --selftest runs the full hermetic attach
+ data loop against the in-process eNB emulator (the fastest way to see
the whole stack alive)."""

from __future__ import annotations

import argparse
import configparser
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LTE UE on PyTorch/CUDA")
    p.add_argument("config", nargs="?", help="ue.conf-style INI file")
    p.add_argument("--iq", help="raw complex64 IQ capture to attach to")
    p.add_argument("--iq-tcp", metavar="HOST:RXPORT[:TXPORT]",
                   help="attach to a LIVE IQ stream over TCP (socket "
                        "radio: DL samples in, timed UL bursts out)")
    p.add_argument("--srate", type=float, default=7.68e6,
                   help="capture sample rate (Hz)")
    p.add_argument("--rnti", type=lambda v: int(v, 0), default=0,
                   help="C-RNTI to blind-search for PDSCH data in the "
                        "steady-state loop (0 = sync/MIB only)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --iq/--iq-tcp receive chain "
                        "(cuda, cuda:N or cpu)")
    p.add_argument("--selftest", action="store_true",
                   help="run the hermetic attach selftest and exit")
    p.add_argument("--log-level", default="warning",
                   choices=["none", "error", "warning", "info", "debug"])
    p.add_argument("--pcap", help="write MAC-LTE pcap to this file")
    p.add_argument("--metrics-period", type=int, default=1000,
                   help="metrics table period in TTIs")
    return p.parse_args(argv)


def load_config(path: str | None):
    from .usim.usim import UsimConfig

    cfg = configparser.ConfigParser()
    if path:
        cfg.read(path)
    usim = UsimConfig()
    if cfg.has_section("usim"):
        s = cfg["usim"]
        usim = UsimConfig(
            imsi=s.get("imsi", usim.imsi),
            imei=s.get("imei", usim.imei),
            k=bytes.fromhex(s.get("k", usim.k.hex())),
            op=bytes.fromhex(s.get("op", usim.op.hex())),
            algo=s.get("algo", usim.algo),
        )
    return usim


def run_selftest_inline(args) -> int:
    from .enb.stack import EnbStack
    from .mac import pdu as pdu_mod
    from .ue import Ue

    class Phy:
        def __init__(self):
            self.prach_tx = []
            self.ta = None

        def sync_start(self):
            pass

        def sr_opportunity(self, tti):
            return True

        def sr_send(self, tti):
            pass

        def prach_send(self, idx, power, tti):
            self.prach_tx.append((idx, power, tti))
            return tti

        def pdcch_dl_search_rar(self, *a):
            pass

        def pdcch_dl_search_temp_crnti(self, *a):
            pass

        def pdcch_dl_search_crnti(self, *a):
            pass

        def set_timeadv(self, ta):
            self.ta = ta

        def get_headroom_db(self):
            return 20.0

        def configure_ul_params(self, sib2):
            pass

    usim_cfg = load_config(args.config)
    ue = Ue(phy=Phy(), usim_cfg=usim_cfg)
    if args.pcap:
        from .utils.pcap import MacPcap

        ue.mac.pcap = MacPcap(args.pcap)
    enb = EnbStack(usim_cfg)
    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00" * 3)
    ue.rrc.write_pdu_bcch_dlsch(enb.make_sib1())
    ue.rrc.write_pdu_bcch_dlsch(enb.make_sib2())
    phy = ue.phy
    for tti in range(400):
        if ue.is_attached:
            break
        ue.run_tti(tti)
        if phy.prach_tx and ue.mac.ra.state.name == "RESPONSE_RECEPTION":
            idx, power, ptti = phy.prach_tx.pop(0)
            g = pdu_mod.RarGrant(False, 10, 2, 0, False, False)
            rar = pdu_mod.Rar(idx, ta=17, grant=g, t_crnti=enb.t_crnti)
            ue.mac.ra.rar_received(pdu_mod.pack_rar_pdu([rar]))
            msg3 = ue.mac.new_grant_ul(tti + 4, 64).payload
            for sh in pdu_mod.unpack(msg3, uplink=True).subheaders:
                if sh.lcid == pdu_mod.LCID_CCCH:
                    enb.srb0.write_pdu(sh.payload)
                    m4 = pdu_mod.MacPdu()
                    m4.add_ce(pdu_mod.LCID_CON_RES, sh.payload[:6].ljust(6, b"\0"))
                    dl = enb.srb0.read_pdu(1000)
                    if dl:
                        m4.add_sdu(0, dl)
                    ue.mac._deliver_temp_crnti = True
                    ue.mac._deliver(0, pdu_mod.pack(m4, 200))
            ue.mac.harq_recv(tti + 4, ack=True)
        enb.pump(ue.rlc)
    if not ue.is_attached:
        print("SELFTEST FAIL: not attached", file=sys.stderr)
        return 1
    # move some user data
    pkts = [b"\x45\x00selftest" + bytes([i]) for i in range(4)]
    for p in pkts:
        ue.gw.backend.inject_ul(p)
    for tti in range(30):
        ue.run_tti(1000 + tti)
        enb.pump(ue.rlc)
    dl = [b"\x45\x00dl" + bytes([i]) for i in range(2)]
    for p in dl:
        enb.send_user_packet(p)
    enb.pump(ue.rlc)
    m = ue.get_metrics()
    print(
        f"SELFTEST PASS: attached (rrc={m.rrc_state}, emm={m.emm_state}), "
        f"ip={ue.gw.ip_addr}, ul_pkts={enb.rx_packets == pkts}, "
        f"dl_pkts={list(ue.gw.backend.to_net) == dl}"
    )
    return 0


def run_iq(args) -> int:
    """Attach to a recorded/generated IQ capture: cell search -> MIB ->
    steady subframe loop with the metrics table."""
    from .phy.receiver import Receiver
    from .radio import FileRadio, SocketRadio
    from .utils.metrics import MetricsPrinter, PhyMetricsSnapshot

    if args.iq_tcp:
        parts = args.iq_tcp.split(":")
        host, rx_port = parts[0], int(parts[1])
        tx_port = int(parts[2]) if len(parts) > 2 else None
        radio = SocketRadio(host, rx_port, tx_port, srate=args.srate)
    else:
        radio = FileRadio(args.iq, args.srate)
    rx = Receiver(radio, device=args.device)
    print("searching for cell...", file=sys.stderr)
    found = rx.cell_search()
    if not found:
        print("no cell found", file=sys.stderr)
        return 1
    cell_id, is_sf5, t_off, cfo = found
    print(f"PSS/SSS: cell_id={cell_id} cfo={cfo*15000:.0f} Hz", file=sys.stderr)
    got = rx.decode_mib_stream(cell_id, t_off, cfo, is_sf5)
    if not got:
        print("MIB decode failed", file=sys.stderr)
        return 1
    cell, mib, t_next = got
    print(f"MIB: n_prb={cell.n_prb} sfn={mib.sfn} phich={mib.phich_resources}",
          file=sys.stderr)

    from .phy.ue_dl import UeDl
    from .mac.mac import MacMetrics

    ue_dl = UeDl(cell, device=args.device) if args.rnti else None
    mp = MetricsPrinter(out=sys.stderr, period_ttis=args.metrics_period)
    mm = MacMetrics()
    n = 0
    tb_bits = 0
    snr = 0.0
    for tti, iq in rx.subframes(cell, t_next, cfo, mib.sfn, 0, n=10_000):
        n += 1
        if ue_dl is not None:
            res = ue_dl.process(iq[None], tti % 10, args.rnti)
            if res.tb_ok is not None:
                ok = bool(res.tb_ok.all())
                mm.rx_pkts += int(ok)
                mm.rx_errors += int(not ok)
                if ok:
                    tb_bits += res.grants[0].tbs
                    mm.rx_brate += res.grants[0].tbs
            snr = float(np.mean(res.metrics["snr_db"]))
            mp.step(tti, attached=True,
                    phy=PhyMetricsSnapshot(dl_snr_db=snr,
                                           cfo_hz=rx.metrics["cfo_hz"],
                                           dl_mcs=res.grants[0].mcs if res.grants else 0),
                    mac_metrics=mm)
        if radio.exhausted:
            break
    print(
        f"processed {n} subframes; cfo_track={rx.metrics['cfo_hz']:.0f} Hz"
        + (f"; decoded {mm.rx_pkts} TBs ({tb_bits} bits), snr={snr:.1f} dB"
           if ue_dl else ""),
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest:
        return run_selftest_inline(args)
    if args.iq or args.iq_tcp:
        return run_iq(args)
    print("nothing to do: pass --selftest, --iq or --iq-tcp (see --help)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
