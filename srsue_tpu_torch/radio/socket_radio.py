"""The port's own copy of ``srsue_tpu/radio/socket_radio.py`` (its reference), unchanged below this docstring.

Live network radio — streaming IQ over localhost/LAN sockets.

The deployment stand-in for the reference's UHD front-end
(ue/src/radio/radio_uhd.cc) in an RF-less environment: where radio_uhd
streams timed IQ to/from a USRP over the host-device link, SocketRadio
streams timed IQ to/from a peer process (eNB emulator, channel
simulator, or a capture relay) over TCP. The same role srsRAN later
standardized with its ZMQ virtual RF — a byte-reliable transport so
protocol tests are loss-free (impairments are injected by the peer, not
by the transport).

Framing:
  RX (peer -> UE): raw complex64 little-endian sample stream, no
     framing — the byte stream IS the sample clock (position/srate =
     timestamp, like a capture file played live).
  TX (UE -> peer): 16-byte header per burst [float64 tx_time,
     uint32 n_samples, uint32 flags] + n complex64 samples — the timed-TX
     contract of radio.h:40 (tx at absolute time) made explicit on the
     wire. flags bit0 = end-of-burst.

The UE side is `SocketRadio` (connects out); the peer side is
`IqPeer` (listens), which serves a DL waveform and collects timed UL
bursts — both usable in-process (tests) or across processes.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from .radio import Radio

_HDR = struct.Struct("<dII")
EOB = 1  # end-of-burst flag


class Agc:
    """Receiver-side automatic gain control for LIVE inputs — the role
    of the reference's gain loop during cell search and steady state
    (ue/src/phy/phch_recv.cc:96-134 driving radio_uhd.cc:63-79
    set_rx_gain), realized as a DIGITAL gain since there is no RF
    front-end behind a socket: a first-order loop drives the measured
    input level to a target RMS so sync thresholds and LLR scales
    downstream see a calibrated signal regardless of the peer's level
    (validated over a +-20 dB sweep in test_socket_radio)."""

    def __init__(self, target_rms: float = 1.0, alpha: float = 0.25):
        self.target_rms = target_rms
        self.alpha = alpha
        self._p_ema: float | None = None
        self.gain = 1.0

    def process(self, x: np.ndarray, n_valid: int | None = None) -> np.ndarray:
        """Apply the current gain and update the level estimate from the
        VALID (non-zero-padded) part of the buffer."""
        n = len(x) if n_valid is None else n_valid
        if n >= 64:
            p = float(np.mean(np.abs(x[:n]) ** 2))
            if p > 1e-20:  # all-zero padding carries no level info
                self._p_ema = (p if self._p_ema is None
                               else (1.0 - self.alpha) * self._p_ema
                               + self.alpha * p)
                self.gain = float(self.target_rms / np.sqrt(self._p_ema))
        return (x * self.gain).astype(np.complex64)


class SocketRadio(Radio):
    """UE-side live radio: RX = reliable complex64 stream, TX = timed
    bursts. Blocking with a timeout; short reads surface as zero-padded
    subframes + an underflow count (the O/U/L surfacing of
    radio_uhd/ue.cc:271-292)."""

    def __init__(self, host: str, rx_port: int, tx_port: int | None = None,
                 srate: float = 1.92e6, timeout_s: float = 5.0,
                 agc: bool = True):
        self.srate = srate
        self.pos = 0
        self.underflows = 0
        self.tx_bursts = 0
        self._rx = socket.create_connection((host, rx_port),
                                            timeout=timeout_s)
        self._tx = (socket.create_connection((host, tx_port),
                                             timeout=timeout_s)
                    if tx_port else None)
        self._rx_buf = b""
        self._eof = False
        self.agc: Agc | None = Agc() if agc else None

    def rx_now(self, n: int) -> tuple[np.ndarray, float]:
        want = n * 8
        while len(self._rx_buf) < want and not self._eof:
            try:
                chunk = self._rx.recv(1 << 18)
            except TimeoutError:
                # Transient stall on a live peer (ADVICE r3): NOT end of
                # stream — deliver a zero-padded subframe (counted as an
                # underflow below) and keep the connection; only a peer
                # close / hard socket error is terminal.
                break
            except OSError:
                chunk = b""
            if not chunk:
                self._eof = True
                break
            self._rx_buf += chunk
        ts = self.pos / self.srate
        got = min(want, len(self._rx_buf)) // 8 * 8
        out = np.zeros(n, np.complex64)
        if got:
            out[: got // 8] = np.frombuffer(self._rx_buf[:got], np.complex64)
        if got < want:
            self.underflows += 1
        self._rx_buf = self._rx_buf[got:]
        self.pos += n
        if self.agc is not None:
            out = self.agc.process(out, n_valid=got // 8)
        return out, ts

    @property
    def rx_gain_db(self) -> float:
        """Digital AGC gain currently applied to RX samples, in dB
        (0.0 when AGC is off). Absolute-power consumers (RSRP,
        pathloss, open-loop UL power) must SUBTRACT this from
        sample-domain power measurements to recover the peer's actual
        level — the ADVICE r4 compensation hook; the reference surfaces
        the same via srslte_ue_dl metrics' rx_gain_offset."""
        if self.agc is None:
            return 0.0
        return float(20.0 * np.log10(max(self.agc.gain, 1e-20)))

    def tx(self, samples: np.ndarray, tx_time: float, eob: bool = False) -> None:
        if self._tx is None:
            return
        s = np.asarray(samples, np.complex64)
        self._tx.sendall(_HDR.pack(float(tx_time), len(s), EOB if eob else 0)
                         + s.tobytes())
        self.tx_bursts += 1

    @property
    def exhausted(self) -> bool:
        return self._eof and not self._rx_buf

    def close(self) -> None:
        for s in (self._rx, self._tx):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class IqPeer:
    """Peer side (eNB emulator / channel simulator): serves the DL
    sample stream and collects timed UL bursts on background threads."""

    def __init__(self, host: str = "127.0.0.1"):
        self._dl_srv = socket.create_server((host, 0))
        self._ul_srv = socket.create_server((host, 0))
        self.host = host
        self.rx_port = self._dl_srv.getsockname()[1]
        self.tx_port = self._ul_srv.getsockname()[1]
        self.ul_bursts: list[tuple[float, int, np.ndarray]] = []
        self._threads: list[threading.Thread] = []

    def serve_dl(self, samples: np.ndarray, chunk: int = 1 << 14) -> None:
        """Stream a waveform to the first DL connection, then close
        (like a finite capture; loop externally for continuous serving)."""
        data = np.asarray(samples, np.complex64).tobytes()

        def run():
            conn, _ = self._dl_srv.accept()
            try:
                for i in range(0, len(data), chunk * 8):
                    conn.sendall(data[i : i + chunk * 8])
            finally:
                conn.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)

    def collect_ul(self) -> None:
        """Accept one UL connection and parse timed bursts until EOF."""

        def run():
            conn, _ = self._ul_srv.accept()
            buf = b""
            try:
                while True:
                    chunk = conn.recv(1 << 18)
                    if not chunk:
                        break
                    buf += chunk
                    while len(buf) >= _HDR.size:
                        tx_time, n, flags = _HDR.unpack(buf[: _HDR.size])
                        need = _HDR.size + n * 8
                        if len(buf) < need:
                            break
                        iq = np.frombuffer(
                            buf[_HDR.size : need], np.complex64)
                        self.ul_bursts.append((tx_time, flags, iq.copy()))
                        buf = buf[need:]
            finally:
                conn.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)

    def join(self, timeout: float = 10.0) -> None:
        for t in self._threads:
            t.join(timeout)

    def close(self) -> None:
        for s in (self._dl_srv, self._ul_srv):
            try:
                s.close()
            except OSError:
                pass
