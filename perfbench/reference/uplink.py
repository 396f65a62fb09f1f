"""The plain reference of the uplink: an eNB's PUSCH receive, with its
transmitter. Numpy float64 on the CPU, written apart from the port; it
shares with the downlink reference only the host tables of ``lte/`` and
``receiver.py``'s OFDM demodulator, demapper, dematcher and turbo decoder.

``build(cfg, seed, n)`` makes `n` uplink subframes of one UE, each with its
own transport block, 4-bit CQI and ACK bit drawn from ``default_rng(seed)``:
turbo encode, rate match, scramble, modulate, multiplex the UCI (36.212
5.2.2.6-8), DFT-precode each data symbol, put the DMRS in symbols 3 and 10
and OFDM-modulate (the downlink's modulator: no 7.5 kHz shift).

``Receiver(cfg).pusch(iq)`` decodes them as the eNB does: OFDM
demodulation, the least-squares estimate at the DMRS averaged over both
slots, ZF, the IDFT that undoes the precoding, with subcarrier k's noise
put on time-domain sample k (the port's and the JAX package's, ROADMAP
fault 5), max-log demapping, descrambling, the ACK's erasures, dematching
into softbuffers, the turbo decode with CRC early exit, and each subframe's
CQI (RM(20, A) by correlation with every codeword) and ACK (the sign of
the sum of its LLRs). A transport block passes when every code block's CRC
does, as the port's ``decode_softbuffers`` has it.

``q`` rounds every stage's output, as in ``receiver.py``: ``exact`` keeps
the values, ``bf16`` is the control a comparison has to fail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .lte import crc
from .lte.cell import Cell
from .lte.ofdm import modulate_np
from .lte.pusch import DMRS_SYMS, PuschMap, dmrs, rm20_codewords
from .receiver import FILLER_LLR, demap, dematch, exact, ofdm_demod, turbo_decode


@dataclasses.dataclass
class Clean:
    """Noise-free uplink subframes of one configuration."""

    cell: Cell
    pmap: PuschMap
    payloads: np.ndarray      # [n, tbs] uint8
    cqi: np.ndarray           # [n, A] uint8
    ack: np.ndarray           # [n] bool
    td: np.ndarray            # [n, sf_len] complex64
    p_sig: float              # signal power per allocated subcarrier

    def noise_var(self, snr_db: float) -> float:
        """The AWGN's variance per subcarrier at `snr_db`, the noise floor
        the eNB's receiver is told."""
        return self.p_sig / 10.0 ** (snr_db / 10.0)


def cell_of(cfg: dict) -> Cell:
    return Cell(n_prb=cfg["n_prb"], cell_id=cfg["cell_id"], n_ports=cfg["n_ports"])


def pusch_map(cfg: dict) -> PuschMap:
    return PuschMap(cfg["n_prb"], cfg["prb_start"], cfg["qm"], cfg["tbs"], cfg["rnti"],
                    cfg["subframe"], cfg["cell_id"], cfg["cqi_bits"], cfg["cqi_repetition"],
                    cfg["ack_symbols"], cfg["rv"])


def build(cfg: dict, seed: int, n: int) -> Clean:
    """`n` subframes, each with its own transport block, CQI and ACK."""
    cell, pmap = cell_of(cfg), pusch_map(cfg)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 2, (n, pmap.tbs), dtype=np.uint8)
    cqi = rng.integers(0, 2, (n, cfg["cqi_bits"]), dtype=np.uint8)
    ack = rng.integers(0, 2, n).astype(bool)
    m_sc = pmap.m_sc
    stream = np.stack([pmap.encode_stream(p, c, a) for p, c, a in zip(payloads, cqi, ack)])
    precoded = np.fft.fft(stream.reshape(n, -1, m_sc), axis=-1) / np.sqrt(m_sc)
    grid = np.zeros((n, cell.n_sym_sf, cell.n_sc), np.complex128)
    band = slice(pmap.sc0, pmap.sc0 + m_sc)
    grid[:, [s for s in range(cell.n_sym_sf) if s not in DMRS_SYMS], band] = precoded
    grid[:, list(DMRS_SYMS), band] = dmrs(cell.cell_id, m_sc, cfg["cyclic_shift"])
    td = modulate_np(cell, grid)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / m_sc
    return Clean(cell, pmap, payloads, cqi, ack, td, p_sig)


@dataclasses.dataclass
class Decoded:
    """What the uplink receive works out for a batch of subframes."""

    payload: np.ndarray       # [n, tbs] uint8
    tb_ok: np.ndarray         # [n] bool
    iters: np.ndarray         # [n, C] turbo iterations
    cqi: np.ndarray           # [n, A] uint8
    ack: np.ndarray           # [n] bool
    softbuf: list             # per K-group [n, count, 3(K+4)]


class Receiver:
    """The eNB's PUSCH receive of one configuration (a dict as in
    ``configs/<name>.json``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.cell = cell_of(cfg)
        self.pmap = pusch_map(cfg)
        self.ref = np.conj(dmrs(cfg["cell_id"], self.pmap.m_sc, cfg["cyclic_shift"]))

    def equalize(self, iq, noise_var: float, q=exact):
        """iq [n, sf_len] -> (symbols [n, 12 M_sc], their noise) in stream
        order."""
        cell, pm = self.cell, self.pmap
        region = q(ofdm_demod(cell, iq))[..., pm.sc0:pm.sc0 + pm.m_sc]
        h = q((region[:, DMRS_SYMS[0]] * self.ref + region[:, DMRS_SYMS[1]] * self.ref) / 2.0)
        h2 = np.maximum(np.abs(h) ** 2, 1e-12)[:, None, :]
        y = region[:, [s for s in range(cell.n_sym_sf) if s not in DMRS_SYMS]]
        x = np.fft.ifft(y * np.conj(h)[:, None, :] / h2, axis=-1) * np.sqrt(pm.m_sc)
        n = x.shape[0]
        nv = np.broadcast_to(noise_var / h2, x.shape)
        return q(x.reshape(n, -1)), q(nv.reshape(n, -1))

    def pusch(self, iq, noise_var: float, q=exact) -> Decoded:
        """iq [n, sf_len] -> every subframe's transport block, CRC flag,
        turbo iterations, CQI and ACK, and the softbuffers."""
        pm, n_iters = self.pmap, self.cfg["turbo_iters"]
        x, nv = self.equalize(iq, noise_var, q)
        n = x.shape[0]
        llr = demap(x[:, pm.data_pos], nv[:, pm.data_pos], pm.qm)
        llr = llr * (1.0 - 2.0 * pm.scr_bits) * ~pm.erased
        plan = pm.plan
        bufs, e0 = [], 0
        for i, k in enumerate(plan.block_ks):
            e1 = e0 + pm.E[i]
            b = dematch(llr[:, e0:e1], pm.rm_idx[i], 3 * (k + 4))
            if i == 0:
                b[:, :plan.f] += FILLER_LLR
            bufs.append(q(b))
            e0 = e1

        if plan.c == 1:
            def block_ok(bits):
                return crc.check(bits[plan.f:], "24A")
        else:
            def block_ok(bits):
                return crc.check(bits, "24B")

        hard, its, oks, soft, b = [], [], [], [], 0
        for k in dict.fromkeys(plan.block_ks):  # every block of one K in one decode
            count = plan.block_ks.count(k)
            g = np.stack(bufs[b:b + count], 1)  # [n, count, 3(K+4)], as the port's
            h, it, ok = turbo_decode(g.reshape(n * count, -1), k, n_iters, False, block_ok, q)
            hard += list(h.reshape(n, count, k).transpose(1, 0, 2))
            its += list(it.reshape(n, count).T)
            oks += list(ok.reshape(n, count).T)
            soft.append(g)
            b += count
        tb = np.stack([np.concatenate(  # 36.212 5.1.2: desegmentation
            [hard[i][r, (plan.f if i == 0 else 0):(k if plan.c == 1 else k - 24)]
             for i, k in enumerate(plan.block_ks)]) for r in range(n)])
        return Decoded(tb[:, :pm.tbs].astype(np.uint8), np.stack(oks, 1).all(1),
                       np.stack(its, 1), *self.uci(x, nv, q), softbuf=soft)

    def uci(self, x, nv, q=exact):
        """Each subframe's (CQI bits [n, A], ACK [n]): the CQI's LLRs added
        into the 20 codeword positions they repeat, the codeword of the
        largest correlation; the ACK where the sum of its LLRs is
        positive."""
        pm, n = self.pmap, x.shape[0]
        a = pm.n_cqi_bits
        cqi = np.zeros((n, a), np.uint8)
        if len(pm.cqi_pos):
            llr = q(demap(x[:, pm.cqi_pos], nv[:, pm.cqi_pos], pm.qm))
            acc = np.zeros((n, 20))
            for i in range(llr.shape[1]):
                acc[:, i % 20] += llr[:, i]
            w = (acc @ (1.0 - 2.0 * rm20_codewords(a)).T).argmax(-1)
            cqi = ((w[:, None] >> np.arange(a)) & 1).astype(np.uint8)
        ack = np.zeros(n, bool)
        if len(pm.ack_pos):
            ack = q(demap(x[:, pm.ack_pos], nv[:, pm.ack_pos], pm.qm)).sum(-1) > 0
        return cqi, ack
