"""UE PHY facade — the reference's ``phy.cc`` + per-TTI worker role in
one front-end object: owns the DL processing (PCFICH -> blind DCI search
for every armed RNTI -> PDSCH decode -> MAC callbacks), the UL assembly
(PRACH, Msg3/PUSCH from RAR grants, DCI-0 granted PUSCH with HARQ-ACK /
CQI multiplexing, HARQ-ACK on PUCCH 1a, SR on PUCCH 1, periodic CQI on
PUCCH 2, SRS) and the MAC/RRC-facing control surface (``phy_interface``:
sync_start / prach_send / pdcch_dl_search_* / sr_send / set_timeadv /
configure_* — phy_interface.h:152-199).

Closed feedback loops (phch_worker.cc parity):

* DL HARQ: every C-RNTI PDSCH decode generates an ACK/NACK transmitted
  4 TTIs later on PUCCH 1a (resource n1PucchAN + first CCE of the DCI,
  36.213 §10.1) or multiplexed onto PUSCH when a grant coincides
  (phch_worker.cc:183-197, encode_pucch 592-634).
* UL HARQ: PHICH is decoded at the group/sequence derived from the
  actual PUSCH allocation (lowest PRB + DMRS shift, 36.213 §9.1.2);
  a NACK triggers an AUTONOMOUS non-adaptive retransmission at the same
  process 8 TTIs after the original, with the next rv of {0,2,3,1}
  reaching the waveform (ul_harq.cc:216-249).
* UL power control: open loop + TPC accumulation from SIB2
  uplinkPowerControlCommon (rrc.cc:589-721 fan-out). Amplitudes are
  normalized so the zero-pathloss nominal operating point is 1.0:
  amp = 10^((P_tx - P_0 - 10log10(M_PUSCH))/20), making partial
  pathloss compensation (alpha < 1) observable at the emulated eNB.
* Time advance: a TA command advances all UL transmissions by
  16*TA samples at 30.72 Msps scaled to the cell rate
  (phch_recv.cc:332-339 tx_time semantics).

Timing model: FDD n+4 — a grant decoded in TTI n is transmitted in
TTI n+4 (HARQ_DELAY), matching ul_harq.cc:133-139. The facade is driven
one subframe at a time by the owner loop: ``work(tti, dl_samples) ->
ul_samples | None`` (the phch_worker 'work_imp' surface without the
thread pool — batching happens inside the jitted stages).

The port's counterpart of ``srsue_tpu/phy/phy.py`` (its reference). The DL
runs in torch on ``device`` (the card unless the caller passes "cpu"): the
CFO correction, then the stages of the serving cell's ``UeDl`` (the front
end of OFDM demod, channel estimates and equalization, replayed as one CUDA
graph on a card; PCFICH; the blind PDCCH searches, one Viterbi launch per
armed RNTI and DCI size; the PDSCH equalization), PHICH, and the PDSCH
demap/dematch, whose softbuffers the MAC's DL HARQ decodes there (the
r2max BCJR half). The host reads what the reference
reads, once per subframe each: the residual CFO (the tracker's EMA is host
state), the CFI, RSRP and noise, every neighbour's RSRP, the PHICH metric
and each search's hit list. The UL assembly stays host numpy, as in the
reference, and goes to no device.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

import functools

import torch

from . import chest, control, dci, prach as prach_mod, pusch, ra, sync
from .cell import Cell, UlGrant
from .powerctrl import UlPower, UlPowerConfig
from .pucch import encode_format1
from .ue_dl import UeDl
from .ue_ul_ctrl import UlCtrl, UlCtrlConfig
from ..mac.rnti import P_RNTI, SI_RNTI
from ..rrc.si_sched import SiConfig, paging_occasion, si_window, sib1_occasion
from ..utils.device import resolve, to_host

HARQ_DELAY = 4
UL_RETX_DELAY = 8  # same synchronous pid, next opportunity


@functools.lru_cache(maxsize=64)
def _pusch_codec(cell: Cell, grant: UlGrant, rnti: int, subframe: int,
                 n_cqi_bits: int, with_ack: bool):
    """The UE's PUSCH encoder of one configuration, built once (its tables
    cost more host time than a subframe's encode). The UE only encodes, on
    the host, so the codec's decoder tables stay on the CPU."""
    return pusch.PuschCodec(cell, grant, rnti, subframe, n_cqi_bits=n_cqi_bits,
                            with_ack=with_ack, device="cpu")


class Phy:
    PRACH_SF = 1  # PRACH opportunity subframe (prach-ConfigIndex ~3:
    #               one opportunity per frame; both sides gate on it)

    def __init__(self, cell: Cell, mac=None, rrc=None,
                 prach_root: int = 128, prach_zcorr: int = 5,
                 n_pucch_sr: int = 0, n1_pucch_an: int = 2,
                 noise_floor: float = 1e-3,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.cell = cell
        self.dl = UeDl(cell, device=self.device)  # the serving cell's receiver
        self.mac = mac
        self.rrc = rrc
        self.prach_root = prach_root
        self.prach_zcorr = prach_zcorr
        self.n_pucch_sr = n_pucch_sr
        self.n1_pucch_an = n1_pucch_an
        self.noise_floor = noise_floor

        self.crnti = 0
        self.temp_crnti = 0
        self._rar_window: tuple[int, int, int] | None = None
        self._prach_pending: tuple[int, float] | None = None
        self._sr_pending_tti: int | None = None
        # tti -> (kind "new"|"retx", grant, rnti)
        self._ul_sched: dict[int, tuple[str, UlGrant, int]] = {}
        self._ul_inflight: dict[int, tuple[UlGrant, int]] = {}  # tti_tx -> .
        self._phich_wait: dict[int, int] = {}  # phich tti -> our UL tx tti
        self._dl_ack_pending: dict[int, tuple[bool, int]] = {}  # tti -> (ack, n_pucch)
        self.ta = 0
        self._si_cfg: SiConfig | None = None
        self._paging: tuple[int, int, float] | None = None

        # UL power control + control scheduling (filled by RRC fan-out)
        self.ul_power = UlPower()
        self.ul_ctrl = UlCtrl(UlCtrlConfig())
        self.srs_cfg: tuple[int, int] | None = None  # (I_srs, n_prb_srs)
        self.ref_sig_power_dbm = 0.0  # SIB2 referenceSignalPower
        self.prach_init_target_dbm = -104.0  # preambleInitialReceivedTargetPower
        # Digital-AGC compensation (ADVICE r4): when the radio rescales
        # RX samples (SocketRadio.rx_gain_db), absolute-power
        # measurements must remove that gain or RSRP/pathloss/open-loop
        # UL power reflect the AGC target instead of the peer's level.
        # The drive loop sets this per subframe from radio.rx_gain_db.
        self.rx_gain_offset_db = 0.0
        self.pathloss_db = 0.0
        # CFO tracking + UL pre-compensation (VERDICT r4 item 4b).
        # cfo_norm = tracked DL CFO as a fraction of the 15 kHz
        # subcarrier spacing; removed from each DL subframe before demod
        # (phch_recv's per-subframe srslte_cfo_correct) and
        # PRE-compensated onto every UL waveform — the shared-LO offset
        # measured on the DL otherwise lands MIRRORED on the UL at the
        # eNB (prach.cc:149-180 srslte_cfo_correct at TX;
        # phch_worker.cc:764 srslte_ue_ul_set_cfo).
        self.cfo_norm = 0.0
        self.cfo_track = True
        self._last_pusch_prb = 1
        self.metrics = {"dl_ok": 0, "dl_ko": 0, "ul_tx": 0, "snr_db": 0.0,
                        "ack_tx": 0, "nack_tx": 0, "ul_retx": 0,
                        "cqi_tx": 0, "srs_tx": 0, "pusch_dbm": 0.0,
                        "pathloss_db": 0.0}
        # interval accumulators (phch_common.cc:251-307: per-TTI values
        # incrementally averaged between get_metrics reads, then reset)
        self._m_sum: dict[str, float] = {}
        self._m_cnt: dict[str, int] = {}
        self._last_dl_mcs = 0
        self._last_dl_prb = 0

    def _m_add(self, key: str, value: float) -> None:
        self._m_sum[key] = self._m_sum.get(key, 0.0) + float(value)
        self._m_cnt[key] = self._m_cnt.get(key, 0) + 1

    def get_metrics(self):
        """Interval-averaged PHY metrics snapshot (phy.cc:114-122 +
        phch_common read-and-reset semantics) + the MABR estimate
        (IP MABR ~ 0.8 x MAC MABR(mcs, prb), phy.cc:118-121)."""
        from ..utils.metrics import PhyMetricsSnapshot

        def avg(key, default=0.0):
            c = self._m_cnt.get(key, 0)
            return self._m_sum.get(key, 0.0) / c if c else default

        snap = PhyMetricsSnapshot(
            rsrp_dbm=avg("rsrp_dbm"),
            pathloss_db=avg("pathloss_db"),
            cfo_hz=avg("cfo_hz"),
            dl_snr_db=avg("snr_db"),
            dl_mcs=avg("dl_mcs"),
            turbo_iters=avg("iters"),
            ul_mcs=avg("ul_mcs"),
            ul_power_dbm=avg("pusch_dbm"),
        )
        if self._last_dl_prb:
            mac_mabr_mbps = ra.tbs(
                ra.mcs_to_mod_itbs(self._last_dl_mcs)[1], self._last_dl_prb
            ) * 1000 / 1e6
            snap.mabr_mbps = 0.8 * mac_mabr_mbps
        self._m_sum.clear()
        self._m_cnt.clear()
        return snap

    # --------------------------------------------------- phy_interface (MAC)
    def sync_start(self):
        pass

    def prach_send(self, preamble_idx: int, power: float, tti: int) -> int:
        self._prach_pending = (preamble_idx, power)
        # transmitted at the next PRACH opportunity (the returned tti
        # feeds the RA-RNTI computation, 36.321 §5.1.4)
        t = tti + 1
        while t % 10 != self.PRACH_SF:
            t += 1
        return t

    def pdcch_dl_search_rar(self, ra_rnti: int, start: int, window: int):
        self._rar_window = (ra_rnti, start, window)

    def pdcch_dl_search_temp_crnti(self, t_crnti: int):
        self.temp_crnti = t_crnti

    def pdcch_dl_search_crnti(self, crnti: int):
        # contention resolved: the temp C-RNTI becomes the C-RNTI and the
        # temp search (with its Msg4 delivery gate) is torn down
        self.crnti = crnti
        self.temp_crnti = 0

    def sr_opportunity(self, tti: int) -> bool:
        if self.ul_ctrl.cfg.sr_config_index is not None:
            return self.ul_ctrl.sr_opportunity(tti)
        return self.n_pucch_sr >= 0

    def sr_send(self, tti: int):
        self._sr_pending_tti = tti

    def set_timeadv(self, ta: int):
        self.ta = ta

    def _ta_samples(self) -> int:
        """TA command units are 16 Ts = 16 samples at 30.72 Msps
        (36.213 §4.2.3), scaled to this cell's sample rate."""
        return int(round(self.ta * 16 * self.cell.nfft / 2048))

    def get_headroom_db(self) -> float:
        """Real power headroom from the open-loop state and the measured
        pathloss (phch_worker.cc:768 get_pathloss -> PHR)."""
        return self.ul_power.headroom_db(self._last_pusch_prb,
                                         self.pathloss_db)

    # ------------------------------------------------------ RRC config fan-out
    def configure_si(self, cfg: SiConfig):
        """RRC decoded SIB1: SI-RNTI searches now follow its windows."""
        self._si_cfg = cfg

    def configure_paging(self, ue_id: int, t_drx: int = 128,
                         n_b_t: float = 1.0):
        """RRC decoded SIB2 pcch-Config: arm P-RNTI paging-occasion
        searches (36.304 §7; capability-plus vs the reference)."""
        self._paging = (ue_id, t_drx, n_b_t)

    def configure_ul_params(self, sib2):
        """SIB2 radioResourceConfigCommon fan-out into the UL chain
        (the reference's configure_ul_params, rrc.cc:589-721 +
        phy.cc:160-166): PUCCH n1PucchAN, reference signal power (for
        pathloss), SRS common config."""
        common = sib2.get("radioResourceConfigCommon", sib2)
        pucch = common.get("pucch_Config")
        if pucch and "n1PUCCH_AN" in pucch:
            self.n1_pucch_an = int(pucch["n1PUCCH_AN"])
        pdsch = common.get("pdsch_Config")
        if pdsch and "referenceSignalPower" in pdsch:
            self.ref_sig_power_dbm = float(pdsch["referenceSignalPower"])
        srs_c = common.get("soundingRS_UL_ConfigCommon")
        if isinstance(srs_c, tuple) and srs_c[0] == "setup":
            # common config enables the SRS region; the UE-specific index
            # arrives in the dedicated config (configure_srs)
            self._srs_common = srs_c[1]

    def configure_ul_power(self, cfg: UlPowerConfig):
        self.ul_power = UlPower(cfg)

    def configure_cqi(self, cqi_config_index: int, n_pucch_cqi: int = 1,
                      subband_k: int | None = None):
        """Dedicated cqi-ReportPeriodic fan-out (rrc.cc dedicated config;
        phch_worker.cc:479-527 set_uci_periodic_cqi incl. the
        format_is_subband flag, phch_worker.cc:755)."""
        self.ul_ctrl.cfg.cqi_config_index = cqi_config_index
        self.ul_ctrl.cfg.cqi_pucch_resource = n_pucch_cqi
        self.ul_ctrl.cfg.cqi_subband_k = subband_k
        self.ul_ctrl.cfg.n_prb = self.cell.n_prb

    def configure_sr(self, sr_config_index: int, n_pucch_sr: int = 0):
        self.ul_ctrl.cfg.sr_config_index = sr_config_index
        self.n_pucch_sr = n_pucch_sr

    def configure_srs(self, srs_config_index: int, n_prb_srs: int = 4):
        """Dedicated soundingRS-UL-ConfigDedicated fan-out
        (phch_worker.cc:531-532,636-658 SRS schedule + encode)."""
        self.srs_cfg = (srs_config_index, n_prb_srs)

    def configure_prach(self, root_seq_index, zero_corr, freq_offset,
                        config_index):
        self.prach_root = root_seq_index
        self.prach_zcorr = zero_corr

    def set_pci(self, pci: int) -> None:
        """Retune the serving-cell identity (handover §5.3.5.4 /
        re-establishment cell selection): CRS sequences, scrambling
        c_init and PDCCH identities all key off the PCI. The device
        tables (CRS, PCFICH, PHICH, blind-search and codec tables) are
        cached per Cell value and device, so the swap re-caches cleanly."""
        self.cell = replace(self.cell, cell_id=pci)
        self.dl = UeDl(self.cell, device=self.device)
        self._l1_rsrp = {}  # serving changed: averages restart

    def configure_neighbor_meas(self, pcis) -> None:
        """RRC measConfig fan-out (§5.5): measure intra-frequency
        neighbor CRS RSRP for these PCIs every subframe (the L1 part of
        the A3 loop; L3 filtering happens in the RRC)."""
        self._meas_pcis = list(pcis)
        self.neighbor_rsrp_dbm = {}
        self._l1_rsrp = {}

    def _l1_avg(self, key, lin: float, alpha: float = 0.1) -> float:
        cache = getattr(self, "_l1_rsrp", None)
        if cache is None:
            cache = self._l1_rsrp = {}
        old = cache.get(key)
        v = lin if old is None else (1.0 - alpha) * old + alpha * lin
        cache[key] = v
        return v

    # -------------------------------------------------------- power scaling
    def _amp(self, p_tx_dbm: float, p0_ref_dbm: float, n_prb: int = 1) -> float:
        """dBm -> waveform amplitude, normalized so the zero-pathloss
        nominal point (P_tx = P_0 + 10log10(n_prb)) is amplitude 1."""
        return float(10 ** ((p_tx_dbm - p0_ref_dbm
                             - 10 * np.log10(max(n_prb, 1))) / 20))

    def _pusch_amp(self, n_prb: int) -> float:
        p = self.ul_power.pusch_power_dbm(n_prb, self.pathloss_db)
        self.metrics["pusch_dbm"] = p
        return self._amp(p, self.ul_power.cfg.p0_nominal_pusch, n_prb)

    def _pucch_amp(self) -> float:
        p = self.ul_power.pucch_power_dbm(self.pathloss_db)
        return self._amp(p, self.ul_power.cfg.p0_nominal_pucch)

    # ------------------------------------------------------------ per-TTI DL
    def work(self, tti: int, dl_samples: np.ndarray) -> np.ndarray | None:
        """Process one DL subframe, return the UL subframe to transmit in
        this TTI (or None)."""
        sf = tti % 10
        iq = torch.as_tensor(np.asarray(dl_samples, np.complex64),
                             device=self.device)
        if self.cfo_track:
            # correct with the current estimate, then track the residual
            # from the first symbol's CP (the phch_recv loop collapsed
            # into the worker: per-subframe correct + EMA track)
            iq = sync.cfo_correct(iq, self.cfo_norm, self.cell.nfft)
            resid = float(to_host(sync.cfo_estimate_cp(
                iq, self.cell.nfft, self.cell.cp_lengths[0])))
            self.cfo_norm += 0.3 * resid
            self._m_add("cfo_hz", self.cfo_norm * 15000.0)
        # the serving cell's receiver: on a 2-port cell ALL downlink
        # channels are SFBC (36.211 §6.3.4.3) — the control region is
        # combined once (REG-pair aligned), then the single-port decoders
        # run unchanged
        front = self.dl.front_end(iq, sf)
        cfi = self.dl.cfi(front.g_eq, front.nv_eff, sf)

        # measurements: SNR + pathloss (phch_worker update_measurements
        # 793-855: pathloss = referenceSignalPower - rsrp_dbm). Absolute
        # powers are referred to the ANTENNA port by removing any digital
        # AGC gain the radio applied (rx_gain_offset_db, ADVICE r4);
        # RATIOS (SNR, subband SNR) are gain-invariant and use the raw
        # sample-domain values.
        gain_db = float(self.rx_gain_offset_db)
        rsrp_lin = max(float(to_host(front.metrics["rsrp"])), 1e-12)
        nvar_h = max(float(to_host(front.nvar)), 1e-12)
        snr_db = float(10 * np.log10(max(rsrp_lin / nvar_h, 1e-9)))
        # per-subband SNR for Mode 2-0 UE-selected reports (§7.2.2):
        # mean |h|^2 per subband of k PRBs over the subframe's symbols
        if self.ul_ctrl.cfg.cqi_subband_k is not None:
            from .ue_ul_ctrl import subband_count, subband_geometry

            k_sb, _ = subband_geometry(self.cell.n_prb)
            n_sb = subband_count(self.cell.n_prb)
            hp = torch.mean(torch.abs(front.hs[0]).to(torch.float32) ** 2, dim=0)
            pad = n_sb * k_sb * 12 - hp.shape[0]
            counts = np.minimum(
                np.full(n_sb, k_sb * 12), 12 * self.cell.n_prb
                - 12 * k_sb * np.arange(n_sb)).astype(np.float32)
            if pad:
                hp = torch.cat([hp, hp.new_zeros(pad)])
            sb = torch.sum(hp.reshape(n_sb, k_sb * 12), dim=1)
            sb_h = np.maximum(np.asarray(to_host(sb)) / counts, 1e-12)
            self.ul_ctrl.update_subband_snr(10 * np.log10(sb_h / nvar_h))
        # L1 measurement averaging (36.133 §9.1.4: RSRP is averaged over
        # the measurement period, not read per-subframe): an EMA in the
        # LINEAR domain smooths per-subframe artifacts — e.g. a strong
        # neighbor's PBCH/PSS REs colliding with serving CRS once per
        # frame would otherwise spike the estimate and reset the RRC's
        # A3 timeToTrigger every 10 ms
        self.serving_rsrp_dbm = float(
            10 * np.log10(self._l1_avg("serv", rsrp_lin))) - gain_db
        # intra-frequency neighbor RSRP from the same grid, keyed by the
        # neighbor's CRS sequence (measConfig fan-out; §5.5 L1 part)
        for n_pci in getattr(self, "_meas_pcis", ()):
            ncell = replace(self.cell, cell_id=n_pci)
            _, _, n_rsrp = chest.estimate(ncell, front.grid, sf, port=0)
            v = self._l1_avg(n_pci, max(float(to_host(n_rsrp)), 1e-12))
            self.neighbor_rsrp_dbm[n_pci] = float(10 * np.log10(v)) - gain_db
        self.metrics["snr_db"] = snr_db
        self.ul_ctrl.update_snr(snr_db)
        self.pathloss_db = (self.ref_sig_power_dbm
                            - (10 * np.log10(rsrp_lin) - gain_db))
        self.metrics["pathloss_db"] = self.pathloss_db
        self._m_add("snr_db", snr_db)
        self._m_add("rsrp_dbm", 10 * np.log10(rsrp_lin) - gain_db)
        self._m_add("pathloss_db", self.pathloss_db)

        # PHICH at the group/seq of OUR transmission's allocation
        tx_tti = self._phich_wait.pop(tti, None)
        if tx_tti is not None and self.mac is not None:
            g_tx = self._ul_inflight.get(tx_tti)
            if g_tx is not None:
                grant_tx, rnti_tx = g_tx
                grp, seq = control.phich_group_seq(
                    grant_tx.prb_start, 0, control.n_phich_groups(self.cell)
                )
                m = control.phich_decode(self.cell, front.g_eq, sf, grp, seq,
                                         device=self.device)
                ack = bool(float(to_host(m)) > 0)
                self.mac.harq_recv(tx_tti, ack=ack)
                self._ul_inflight.pop(tx_tti, None)
                if not ack:
                    # autonomous non-adaptive retx at the same pid, next
                    # opportunity (ul_harq.cc:216-249); rv advances in MAC
                    self._ul_sched.setdefault(
                        tx_tti + UL_RETX_DELAY, ("retx", grant_tx, rnti_tx)
                    )

        searches = []
        si_hit = sib1_occasion(tti)
        if not si_hit:
            if self._si_cfg is not None:
                # SI windows from SIB1 scheduling (mac.cc:215-244)
                si_hit = any(
                    si_window(self._si_cfg, i, tti)
                    for i in range(len(self._si_cfg.si_periodicity_rf))
                )
            else:
                si_hit = sf == 1  # pre-SIB1: search broadly
        if si_hit:
            searches.append((SI_RNTI, "SI", False))
        if self._paging is not None:
            ue_id, t_drx, n_b_t = self._paging
            if paging_occasion(tti, ue_id, n_b_t=n_b_t, t_drx=t_drx):
                searches.append((P_RNTI, "PAGING", False))
        if self._rar_window is not None:
            ra_rnti, start, window = self._rar_window
            if start <= tti < start + window + 2:
                searches.append((ra_rnti, "RAR", False))
            elif tti >= start + window + 2:
                self._rar_window = None
        if self.temp_crnti and self.temp_crnti != self.crnti:
            searches.append((self.temp_crnti, "TEMP_CRNTI", True))
        if self.crnti:
            searches.append((self.crnti, "CRNTI", True))

        for rnti, rnti_type, ue_specific in searches:
            # DCI format breadth (phch_worker.cc:278-326
            # find_dl_dci_type): 0/1A always; format 1 for the C-RNTI
            # (TM1/TM2); 1C for SI/P-RNTI. One format a search, its hits
            # handled before the next format is searched, as in the reference
            formats = ["0_1a"]
            if rnti_type == "CRNTI":
                formats.append("1")
            if rnti_type in ("SI", "PAGING"):
                formats.append("1c")
            for fmt in formats:
                (hits,) = self.dl.search(front.g_eq, front.nv_eff, sf, cfi, rnti,
                                         ue_specific, (fmt,))
                for _, start_cce, _, bits in hits:
                    self._handle_dci(tti, sf, cfi, front, fmt, bits, rnti,
                                     rnti_type, start_cce)

        return self._assemble_ul(tti)

    def _handle_dci(self, tti, sf, cfi, front, fmt, bits, rnti, rnti_type,
                    start_cce):
        d = dci.unpack(self.cell.n_prb, fmt, bits)
        if isinstance(d, dci.Dci0):
            g = dci.dci0_to_grant(self.cell, d)
            self.ul_power.apply_tpc_pusch(d.tpc)
            self._ul_sched[tti + HARQ_DELAY] = ("new", g, rnti)
            return
        if not isinstance(d, dci.Dci1C):  # 1A and 1 carry a PUCCH TPC
            self.ul_power.apply_tpc_pucch(d.tpc)
        self._decode_dlsch(tti, sf, cfi, front, dci.to_dl_grant(self.cell, d),
                           rnti, rnti_type, d, start_cce)

    def _decode_dlsch(self, tti, sf, cfi, front, grant, rnti, rnti_type, d,
                      start_cce=0):
        codec = self.dl.codec(grant, rnti, sf, cfi)
        x_eq, nv_eff = self.dl.equalize_pdsch(front, codec)
        softbuffers = codec.demap_dematch(x_eq[None], nv_eff[None])
        if self.mac is None:
            return
        pid = d.harq_pid if hasattr(d, "harq_pid") else 0
        if rnti_type in ("SI", "RAR", "PAGING"):
            ok = self.mac.tb_decoded(pid, codec, softbuffers, rnti_type)
        else:
            self.mac.new_grant_dl(pid, grant, rnti, rnti_type)
            ok = self.mac.tb_decoded(pid, codec, softbuffers, rnti_type)
            # HARQ-ACK on PUCCH 1a (or PUSCH) 4 TTIs later; resource =
            # n1PucchAN + first CCE of the DCI (36.213 §10.1,
            # phch_worker.cc:183-197)
            self._dl_ack_pending[tti + HARQ_DELAY] = (
                ok, self.n1_pucch_an + start_cce
            )
        self.metrics["dl_ok" if ok else "dl_ko"] += 1
        if rnti_type in ("CRNTI", "TEMP_CRNTI"):
            self._m_add("dl_mcs", grant.mcs)
            self._m_add("iters",
                        self.mac.dl_harq.metrics.get("last_iters", 0.0))
            self._last_dl_mcs = grant.mcs
            self._last_dl_prb = grant.n_prb
        if rnti_type == "RAR":
            # schedule Msg3 from the RAR UL grant (tti + 6 in the spec;
            # the emulator uses tti_rar + HARQ_DELAY)
            if ok and self.mac.ra.state.name == "CONTENTION_RESOLUTION":
                g = dci.rar_to_ul_grant(self.cell, self.mac.ra.last_rar.grant)
                self._ul_sched[tti + HARQ_DELAY] = ("new", g, self.mac.temp_crnti)
            elif ok and self.mac.ra.state.name == "COMPLETION":
                # contention-free RA (handover dedicated preamble,
                # 36.321 §5.1.5): no Msg3/contention — the RAR's UL
                # grant carries the FIRST UL transmission on the target
                # (the ReconfigurationComplete on SRB1)
                g = dci.rar_to_ul_grant(self.cell, self.mac.ra.last_rar.grant)
                self._ul_sched[tti + HARQ_DELAY] = ("new", g, self.mac.crnti)

    # ------------------------------------------------------------ per-TTI UL
    def _assemble_ul(self, tti: int) -> np.ndarray | None:
        out = self._assemble_ul_inner(tti)
        if out is not None and self.cfo_track and self.cfo_norm != 0.0:
            # TX CFO pre-compensation: shift the UL waveform UP by the
            # tracked DL offset so it arrives on-frequency at the eNB
            # despite the shared-LO error (the DL appears at +cfo in the
            # UE's baseband, so the UE's TX lands at -cfo at the eNB
            # unless pre-rotated by +cfo). Covers PRACH, PUSCH, PUCCH
            # and SRS — every waveform leaves through this exit
            # (prach.cc:152, phch_worker.cc:764 parity).
            n = np.arange(len(out), dtype=np.float64)
            out = (out * np.exp(2j * np.pi * self.cfo_norm * n
                                / self.cell.nfft)).astype(np.complex64)
        adv = self._ta_samples()
        if out is not None and adv > 0:
            # advance UL timing: transmit at tti+4 MINUS timeAdvance
            # (phch_recv.cc:332-339) — within the subframe buffer the
            # waveform shifts adv samples earlier
            out = np.concatenate([out[adv:], np.zeros(adv, out.dtype)])
        return out

    def _assemble_ul_inner(self, tti: int) -> np.ndarray | None:
        if self._prach_pending is not None and tti % 10 == self.PRACH_SF:
            idx, power_dbm = self._prach_pending
            self._prach_pending = None
            wf = prach_mod.waveform(self.cell, self.prach_root,
                                    self.prach_zcorr, idx)
            # PRACH power: full-pathloss compensation + ramping, amplitude
            # normalized to the nominal first-attempt zero-pathloss point
            # (prach.cc:149-180): ramped attempts transmit ramp_db louder
            amp = self._amp(
                self.ul_power.prach_power_dbm(self.pathloss_db, power_dbm),
                self.pathloss_db + self.prach_init_target_dbm,
            )
            self.metrics["ul_tx"] += 1
            out = np.zeros(self.cell.sf_len, np.complex64)
            out[: len(wf)] = amp * wf[: self.cell.sf_len]
            return out

        ack_entry = self._dl_ack_pending.pop(tti, None)
        sched = self._ul_sched.pop(tti, None)
        if sched is not None and self.mac is not None:
            kind, grant, rnti = sched
            if kind == "retx":
                r = self.mac.ul_retx(tti)
            else:
                r = self.mac.new_grant_ul(tti, grant.tbs // 8,
                                          ndi=grant.ndi)
            if r is not None:
                g_rv = replace(grant, rv=r.rv)
                bits = np.unpackbits(np.frombuffer(r.payload, np.uint8))
                self.metrics["ul_tx"] += 1
                if r.is_retx:
                    self.metrics["ul_retx"] += 1
                self._last_pusch_prb = grant.n_prb
                self._phich_wait[tti + HARQ_DELAY] = tti
                self._ul_inflight[tti] = (grant, rnti)
                amp = self._pusch_amp(grant.n_prb)
                self._m_add("ul_mcs", grant.mcs)
                self._m_add("pusch_dbm", self.metrics["pusch_dbm"])
                cqi = self.ul_ctrl.cqi_for_tti(tti)
                if ack_entry is not None or cqi is not None:
                    # UCI rides PUSCH when a grant coincides
                    # (phch_worker.cc:545-590 encode_pusch w/ uci_data)
                    codec = _pusch_codec(
                        self.cell, g_rv, rnti, tti % 10,
                        0 if cqi is None else len(cqi),
                        ack_entry is not None,
                    )
                    ack = None if ack_entry is None else ack_entry[0]
                    if ack_entry is not None:
                        self.metrics["ack_tx" if ack else "nack_tx"] += 1
                    if cqi is not None:
                        self.metrics["cqi_tx"] += 1
                    return amp * codec.encode_sf_uci(bits, cqi_bits=cqi,
                                                     ack=ack)
                codec = _pusch_codec(self.cell, g_rv, rnti, tti % 10, 0,
                                     False)
                return amp * codec.encode_sf(bits)

        from . import ofdm as _ofdm

        if ack_entry is not None:
            # HARQ-ACK on PUCCH format 1a
            ack, n_pucch = ack_entry
            self.metrics["ack_tx" if ack else "nack_tx"] += 1
            grid = encode_format1(self.cell, tti % 10, n_pucch, ack=ack)
            self._sr_pending_tti = None  # ACK takes the TTI (36.213 §10.1)
            return self._pucch_amp() * _ofdm.modulate_np(self.cell, grid)
        if self._sr_pending_tti == tti:
            self._sr_pending_tti = None
            grid = encode_format1(self.cell, tti % 10, self.n_pucch_sr,
                                  ack=None)
            return self._pucch_amp() * _ofdm.modulate_np(self.cell, grid)
        cqi = self.ul_ctrl.cqi_for_tti(tti)
        if cqi is not None:
            # periodic CQI on PUCCH format 2 (phch_worker.cc:479-527)
            from . import uci as ucimod

            self.metrics["cqi_tx"] += 1
            grid = ucimod.encode_format2(
                self.cell, tti % 10, self.ul_ctrl.cfg.cqi_pucch_resource,
                cqi,
            )
            return self._pucch_amp() * _ofdm.modulate_np(self.cell, grid)
        if self.srs_cfg is not None:
            from . import srs as srsmod

            i_srs, n_prb_srs = self.srs_cfg
            if srsmod.ue_srs_subframe(i_srs, tti):
                self.metrics["srs_tx"] += 1
                grid = np.zeros((self.cell.n_sym_sf, self.cell.n_sc),
                                np.complex64)
                srsmod.map_to_grid(self.cell, grid, n_prb_srs)
                return self._pucch_amp() * _ofdm.modulate_np(self.cell, grid)
        return None
