"""Receiver state machine: cell search -> MIB -> steady-state subframe
loop (CELL_SEARCH -> SYNCING -> SYNC_DONE, one iteration per 1 ms
subframe). Counterpart of ``srsue_tpu/phy/receiver.py``.

The loop is a host generator over an IQ stream. Alignment and CFO state
advance per subframe on the host; the DSP (decimation, PSS/SSS search, CFO
correction, PBCH) runs on the receiver's device, which takes each block of
samples as complex64. The subframes it yields are tensors on that device,
ready for ``UeDl``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..radio.radio import Radio
from ..utils.device import resolve, to_host
from . import chest, equalize, ofdm, pbch, sync
from .cell import Cell


@dataclass
class SyncResult:
    cell: Cell
    sample_offset: int  # start of the next subframe-0 in the stream
    cfo: float  # subcarrier units
    sfn: int


class Receiver:
    # sync-quality tracking (phch_recv.cc:359-364 loss handling +
    # srslte_ue_sync_get_sfo SFO metric)
    SYNC_LOSS_THRESHOLD = 0.3  # normalized CP correlation
    SYNC_LOSS_COUNT = 5  # consecutive bad subframes -> back to search
    TIMING_LAGS = 3  # +-lags evaluated for the timing error tracker

    def __init__(self, radio: Radio, device: str | torch.device = "cuda"):
        self.radio = radio
        self.device = resolve(device)
        self.state = "CELL_SEARCH"
        self.metrics = {"cfo_hz": 0.0, "peak": 0.0, "sfo_hz": 0.0,
                        "sync_quality": 0.0, "resyncs": 0, "slips": 0}
        self._t_err = 0.0  # EMA of the per-subframe timing error (samples)
        self._bad_count = 0
        self._slip_total = 0
        self._slip_elapsed_sf = 0
        # per-subframe in-sync/out-of-sync indication hook (fed to the
        # RRC radio-link-failure monitor, 36.331 §5.3.11.1: rrc.on_in_sync
        # / rrc.on_out_of_sync); called with True when sync quality is
        # above the loss threshold
        self.on_sync_status = None

    def _to_device(self, samples: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(samples, dtype=torch.complex64, device=self.device)

    # ------------------------------------------------- timing/quality track
    def _timing_update(self, iq_np: np.ndarray, cell: Cell) -> float:
        """CP-correlation timing tracker on a mid-subframe symbol:
        returns the normalized sync quality; updates the timing-error EMA
        and the SFO estimate. Positive error = boundary later than
        assumed (we are early)."""
        L = self.TIMING_LAGS
        cp = cell.cp_lengths[1]
        # symbol 4 start (normal CP): cp0+nfft + 3*(cp+nfft)
        start = cell.cp_lengths[0] + cell.nfft + 3 * (cp + cell.nfft)
        corrs = np.empty(2 * L + 1, np.complex64)
        for i, lag in enumerate(range(-L, L + 1)):
            a = iq_np[start + lag : start + lag + cp]
            b = iq_np[start + lag + cell.nfft : start + lag + cp + cell.nfft]
            corrs[i] = np.vdot(b, a)
        p1 = float(np.sum(np.abs(iq_np[start - L : start + cp + L]) ** 2))
        p2 = float(np.sum(
            np.abs(iq_np[start + cell.nfft - L
                         : start + cp + cell.nfft + L]) ** 2))
        denom = max(np.sqrt(p1 * p2) * cp / (cp + 2 * L), 1e-12)
        mags = np.abs(corrs)
        best = int(np.argmax(mags))
        quality = float(mags[best]) / denom
        self.metrics["sync_quality"] = quality
        if quality >= self.SYNC_LOSS_THRESHOLD:
            err = best - L
            self._t_err = 0.85 * self._t_err + 0.15 * err
        return quality

    def _maybe_slip(self, srate: float) -> None:
        """Sample-slip compensation: consume/rewind one sample when the
        tracked timing error accumulates (radio_uhd tx_offset /
        srslte_ue_sync SFO handling analogue)."""
        self._slip_elapsed_sf += 1
        slip = 0
        if self._t_err > 0.6:
            self.radio.rx_now(1)  # boundary is later: skip one sample
            slip = 1
        elif self._t_err < -0.6:
            if not self.radio.seek(self.radio.pos - 1):
                return
            slip = -1
        if slip:
            self._t_err -= slip
            self._slip_total += slip
            self.metrics["slips"] = self._slip_total
        if self._slip_elapsed_sf >= 50:
            # SFO = sample-clock offset ratio x sample rate; one subframe
            # is 1 ms = srate/1000 samples
            elapsed_samples = self._slip_elapsed_sf * (srate / 1e3)
            self.metrics["sfo_hz"] = self._slip_total / elapsed_samples * srate

    # ------------------------------------------------------------ search
    def cell_search(self, n_frames: int = 3, search_srate: float = 1.92e6):
        """PSS/SSS scan (phch_recv.cc:135-227): find N_id, coarse timing,
        CFO. Returns (cell_id, is_sf5, t_offset_fullrate, cfo) or None."""
        srate = self.radio.srate
        decim = int(round(srate / search_srate))
        n = int(n_frames * 10e-3 * srate)
        pos0 = self.radio.pos  # capture start: offsets below are absolute
        samples, ts = self.radio.rx_now(n)
        low = sync.decimate(self._to_device(samples), decim)

        cell6 = Cell(n_prb=6)
        half_len = 5 * cell6.sf_len  # 5 ms at search rate
        n_halves = int(low.shape[-1]) // half_len
        if n_halves < 2:
            return None
        # batch half-frames; PSS repeats every 5 ms
        segs = low[: n_halves * half_len].reshape(n_halves, half_len)
        # one transfer: float32 holds the root and the sample index exactly
        nid2_h, t_h, peak_h = to_host(torch.stack(
            [x.to(torch.float32) for x in sync.find_pss(segs)]))
        # detection statistic: noise-only peaks ~0.3, a true PSS inside a
        # wideband cell ~2+ (the PSS occupies only the center 1.4 MHz).
        # Prefer the EARLIEST strong half-frame so the stream position
        # stays well before the capture end.
        strong = np.nonzero(peak_h >= max(1.0, 0.6 * peak_h.max()))[0]
        if len(strong) == 0:
            return None
        best = int(strong[0])
        n_id_2 = int(nid2_h[best])
        t_pss = int(t_h[best])

        # CFO from the PSS symbol CP, then SSS one symbol earlier
        seg = segs[best]
        cp = cell6.cp_lengths[1]
        start = t_pss - cp
        if start < 0 or t_pss + cell6.nfft > half_len:
            return None
        cfo = float(to_host(sync.cfo_estimate_cp(
            seg[start : start + cell6.nfft + cp], cell6.nfft, cp
        )))
        seg_c = sync.cfo_correct(seg, cfo, cell6.nfft)
        pss_td = seg_c[t_pss : t_pss + cell6.nfft]
        pss_fd_full = torch.fft.fft(pss_td)
        sss_start = t_pss - cell6.nfft - cell6.cp_lengths[1]
        sss_td = seg_c[sss_start : sss_start + cell6.nfft]
        sss_fd_full = torch.fft.fft(sss_td)

        def center62(fd):
            return torch.cat([fd[-31:], fd[1:32]])

        nid1, is_sf5, _ = sync.sss_coherent(
            center62(pss_fd_full), center62(sss_fd_full), n_id_2
        )
        nid1, is_sf5 = (int(v) for v in to_host(torch.stack([nid1, is_sf5.to(nid1.dtype)])))
        cell_id = 3 * nid1 + n_id_2

        # full-rate offset of the subframe boundary AFTER the PSS symbol:
        # PSS ends at slot boundary (last symbol of slot 0)
        pss_end_low = best * half_len + t_pss + cell6.nfft
        sf_start_low = pss_end_low + cell6.slot_len  # end of slot 1 = sf end
        t_full = pos0 + sf_start_low * decim
        self.metrics["peak"] = float(peak_h[best])
        self.metrics["cfo_hz"] = cfo * 15000.0
        return cell_id, bool(is_sf5), t_full, cfo

    # ------------------------------------------------------------ MIB
    def decode_mib_stream(self, cell_id: int, t_offset: int, cfo: float,
                          is_sf5: bool, max_tries: int = 4):
        """Align to subframe 0 and decode PBCH (phch_recv sync_sfn
        230-264). The radio position is already past t_offset's capture;
        the caller provides a radio whose stream continues from where
        cell_search left it. Returns (Cell, Mib) or None."""
        cell6 = Cell(n_prb=6, cell_id=cell_id)
        # t_offset points at the subframe AFTER the detected sync; if the
        # sync was at sf5, the next subframe is sf6 -> wait 4 more sf.
        skip_sf = 4 if is_sf5 else 9  # land on a subframe 0... next sf idx:
        # after sf0's sync: next sf = 1 -> skip 9 to reach sf0. after sf5:
        # next sf = 6 -> skip 4.
        for _try in range(max_tries):
            # position at the target subframe-0 boundary (rewind via seek
            # for file/array radios: cell_search consumed ahead)
            target = t_offset + skip_sf * int(self.radio.srate // 1000)
            if not self.radio.seek(target):
                n_skip = target - self.radio.pos
                if n_skip > 0:
                    self.radio.rx_now(n_skip)
            sf0, ts = self.radio.rx_now(int(self.radio.srate // 1000))
            t_offset = target
            skip_sf = 10
            decim = int(round(self.radio.srate / cell6.srate))
            low = sync.decimate(self._to_device(sf0), decim)
            low = sync.cfo_correct(low, cfo, cell6.nfft)
            grid = ofdm.demodulate(cell6, low)
            h, nvar, _ = chest.estimate(cell6, grid, 0, port=0)
            y = pbch.extract_re(cell6, grid)
            hh = pbch.extract_re(cell6, h)
            x_eq, nv_eff = equalize.zf(y, hh, nvar)
            mib, quarter, ports = pbch.decode(cell6, x_eq, nv_eff)
            if mib is None:
                # 2-port hypothesis: the eNB transmits PBCH with SFBC
                # when it has two ports (36.211 §6.6.3) — single-port ZF
                # then yields superposed symbols and the mask check
                # fails. Try per-port chest + Alamouti combining; the
                # CRC16 antenna mask confirms or rejects the hypothesis
                # (srslte_pbch_decode's per-port-count trial loop,
                # phch_recv.cc:207-227).
                h1, _, _ = chest.estimate(cell6, grid, 0, port=1)
                x2, nv2 = equalize.alamouti_combine(
                    y, hh, pbch.extract_re(cell6, h1), nvar)
                mib, quarter, ports = pbch.decode(cell6, x2, nv2)
            if mib is not None:
                # camp with the MIB's PHICH configuration: Ng sets the
                # PHICH group count (36.211 §6.9), which the UL HARQ
                # feedback decode depends on (phch_recv.cc:254-258
                # applies the decoded MIB to the cell struct)
                cell = Cell(n_prb=mib.n_prb, cell_id=cell_id,
                            n_ports=max(1, ports),
                            phich_duration=mib.phich_duration,
                            phich_resources=mib.phich_resources)
                return cell, mib, t_offset
        return None

    # ------------------------------------------------------- steady state
    def subframes(self, cell: Cell, t_offset: int, cfo: float, start_sfn: int,
                  start_sf: int, n: int):
        """Generator of (tti, aligned subframe [sf_len] complex64 on the
        receiver's device): the SYNC_DONE loop (phch_recv.cc:309-368). Per subframe: CFO tracked from the CP,
        timing tracked by CP correlation with sample-slip compensation
        (SFO estimate), and sync quality monitored — SYNC_LOSS_COUNT
        consecutive bad subframes transition the state machine back to
        CELL_SEARCH and end the generator (phch_recv.cc:359-364)."""
        sf_len = cell.sf_len
        if not self.radio.seek(t_offset):
            if self.radio.pos < t_offset:
                self.radio.rx_now(t_offset - self.radio.pos)
        tti = (start_sfn * 10 + start_sf) % 10240
        self.state = "SYNC_DONE"
        self._bad_count = 0
        for _ in range(n):
            raw, ts = self.radio.rx_now(sf_len)
            if len(raw) < sf_len:
                self.state = "CELL_SEARCH"
                return
            quality = self._timing_update(np.asarray(raw), cell)
            if self.on_sync_status is not None:
                self.on_sync_status(quality >= self.SYNC_LOSS_THRESHOLD)
            if quality < self.SYNC_LOSS_THRESHOLD:
                self._bad_count += 1
                if self._bad_count >= self.SYNC_LOSS_COUNT:
                    # sync lost: back to search; UL must stop until
                    # re-acquisition (phch_recv.cc:359-364)
                    self.state = "CELL_SEARCH"
                    return
            else:
                self._bad_count = 0
            self._maybe_slip(cell.srate)
            iq = sync.cfo_correct(self._to_device(raw), cfo, cell.nfft)
            # track residual CFO from the first symbol's CP: the EMA is host
            # state, so this reads the device once per subframe
            cp = cell.cp_lengths[0]
            resid = float(to_host(sync.cfo_estimate_cp(iq, cell.nfft, cp)))
            cfo += 0.1 * resid
            self.metrics["cfo_hz"] = cfo * 15000.0
            yield tti, iq
            tti = (tti + 1) % 10240

    # ---------------------------------------------------- full state machine
    def stream(self, n_subframes: int, on_resync=None):
        """Cold start + steady state WITH loss recovery: yields
        (tti, subframe) across sync losses, re-entering CELL_SEARCH ->
        MIB -> SYNC_DONE as needed (the full phch_recv run_thread state
        machine, phch_recv.cc:266-375). Ends when the stream runs out or
        n_subframes were produced."""
        produced = 0
        while produced < n_subframes:
            found = self.cell_search()
            if found is None:
                # no sync over the scanned frames: keep the RRC
                # radio-link monitor clocked (the reference's PHY reports
                # out-of-sync every frame while unsynced) — one
                # indication per subframe consumed by the failed scan
                if self.on_sync_status is not None:
                    for _ in range(30):  # cell_search default: 3 frames
                        self.on_sync_status(False)
                if not self._stream_has_data():
                    return
                continue  # keep scanning
            cell_id, is_sf5, t_off, cfo = found
            got = self.decode_mib_stream(cell_id, t_off, cfo, is_sf5)
            if got is None:
                continue
            cell, mib, t_sf0 = got
            if on_resync is not None:
                on_resync(cell, mib)
            self.metrics["resyncs"] += 1
            for tti, iq in self.subframes(cell, t_sf0, cfo,
                                          mib.sfn, 0,
                                          n_subframes - produced):
                produced += 1
                yield tti, iq
            if self.state != "CELL_SEARCH":
                return  # n reached

    def _stream_has_data(self) -> bool:
        # file/array radios zero-pad past the end of the capture, so a
        # short read never happens — honour their `exhausted` flag or
        # stream() would spin in CELL_SEARCH forever on trailing silence
        if getattr(self.radio, "exhausted", False):
            return False
        probe, _ = self.radio.rx_now(1)
        return len(probe) == 1
