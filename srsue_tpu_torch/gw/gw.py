"""The port's own copy of ``srsue_tpu/gw/gw.py`` (its reference), unchanged below this docstring.

GW — the IP boundary (reference: ue/src/upper/gw.cc: TUN `tun_srsue`,
ioctl addr setup at gw.cc:109-197, TUN-read thread -> pdcp.write_sdu(DRB1)
at 202-240, DL pdu -> write(tun_fd) at 90-104).

Two back-ends:
* TunBackend: a real Linux TUN device via ioctl (requires /dev/net/tun +
  CAP_NET_ADMIN) — full parity with the reference.
* QueueBackend: in-memory packet queues — hermetic tests and headless
  deployments (the "file radio" analogue at the IP boundary).
"""

from __future__ import annotations

import fcntl
import os
import struct
from collections import deque

TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_NO_PI = 0x1000


class QueueBackend:
    def __init__(self):
        self.to_net = deque()  # packets the UE delivered (DL)
        self.from_net = deque()  # packets the app wants to send (UL)

    def write(self, pkt: bytes) -> None:
        self.to_net.append(pkt)

    def read(self) -> bytes | None:
        return self.from_net.popleft() if self.from_net else None

    def inject_ul(self, pkt: bytes) -> None:
        self.from_net.append(pkt)


class TunBackend:
    def __init__(self, name: str = "tun_srsue"):
        self.fd = os.open("/dev/net/tun", os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH", name.encode(), IFF_TUN | IFF_NO_PI)
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        self.name = name

    def write(self, pkt: bytes) -> None:
        os.write(self.fd, pkt)

    def read(self) -> bytes | None:
        try:
            return os.read(self.fd, 9000)
        except BlockingIOError:
            return None

    def set_addr(self, ip: str, prefix: int = 24) -> None:
        os.system(f"ip addr add {ip}/{prefix} dev {self.name} 2>/dev/null")
        os.system(f"ip link set {self.name} up")


class Gw:
    """gw_interface_pdcp (write_pdu) + gw_interface_nas (setup_if_addr)."""

    def __init__(self, pdcp=None, drb_lcid: int = 3, backend=None):
        self.pdcp = pdcp
        self.drb_lcid = drb_lcid
        self.backend = backend or QueueBackend()
        self.ip_addr: str | None = None
        self.metrics = {"dl_pkts": 0, "dl_bytes": 0, "ul_pkts": 0, "ul_bytes": 0}

    def setup_if_addr(self, ip_addr: str) -> None:
        self.ip_addr = ip_addr
        if hasattr(self.backend, "set_addr"):
            self.backend.set_addr(ip_addr)

    # DL: PDCP -> IP
    def write_pdu(self, lcid: int, pdu: bytes) -> None:
        self.metrics["dl_pkts"] += 1
        self.metrics["dl_bytes"] += len(pdu)
        self.backend.write(pdu)

    # UL: IP -> PDCP (the reference's TUN-reader thread body; here polled)
    def poll_ul(self, max_pkts: int = 32) -> int:
        n = 0
        while n < max_pkts:
            pkt = self.backend.read()
            if pkt is None:
                break
            self.metrics["ul_pkts"] += 1
            self.metrics["ul_bytes"] += len(pkt)
            if self.pdcp is not None:
                self.pdcp.write_sdu(self.drb_lcid, pkt)
            n += 1
        return n
