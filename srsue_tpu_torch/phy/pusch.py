"""PUSCH: UL-SCH transport processing and SC-FDMA (36.212 5.2.2, 36.211
5.3-5.5), with UCI (CQI, HARQ-ACK) multiplexed onto it. Counterpart of
``srsue_tpu/phy/pusch.py``.

The UE side stays on the host, as in the reference (one small subframe
per TTI): turbo encode, rate match, scramble, modulate, UCI multiplexing,
DFT precoding by ``np.fft``, DMRS and the SC-FDMA modulator; numpy in,
numpy out. The eNB-side decode dual runs in torch on the codec's device:
OFDM demodulation (cuFFT), the DMRS least-squares estimate averaged over
both slots, ZF, the IDFT that undoes the precoding, demap, descramble, ACK
erasure and rate dematching into per-block softbuffers that do not depend
on rv (HARQ combining is ``+`` of them); then one ``turbo.decode`` per code
block size, all blocks of that K in one call.

Carried over from the reference unchanged: no group or sequence hopping
(u = cell_id mod 30, v = 0), no 7.5 kHz uplink frequency shift (the
uplink grid goes through the downlink's OFDM modulator), DMRS for 3 PRB
and more only, and its noise scaling: the per-subcarrier noise
``noise_var / |h_k|^2`` is applied to time-domain sample k after the IDFT,
where each sample's noise is really the mean over the subcarriers
(ROADMAP fault 5; decisions depend on it, so the port keeps it).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import resolve, to_host
from . import modulation, ofdm, ratematch, segmentation, seq, turbo, uci
from .cell import Cell, UlGrant
from .pdsch import FILLER_LLR, blk_crc_matrix

N_DMRS_SYM = (3, 10)  # DMRS symbols of a normal-CP subframe (symbol 3 of each slot)
ACK_COLS = (2, 3, 8, 9)  # channel-interleaver columns next to the DMRS symbols
RI_COLS = (1, 4, 7, 10)


def _largest_prime_below(n: int) -> int:
    k = n - 1
    while k < 2 or any(k % i == 0 for i in range(2, math.isqrt(k) + 1)):
        k -= 1
    return k


@functools.lru_cache(maxsize=256)
def dmrs_base_seq(m_sc: int, u: int, v: int = 0) -> np.ndarray:
    """Zadoff-Chu base sequence r_{u,v}(n) with cyclic extension (36.211
    5.5.1.1) for M_sc >= 36 (3 PRB and more); the tables of 12 and 24 are
    not included."""
    assert m_sc >= 36, "1-2 PRB DMRS tables not implemented"
    nzc = _largest_prime_below(m_sc)
    q_bar = nzc * (u + 1) / 31
    q = int(np.floor(q_bar + 0.5)) + v * (1 if q_bar % 2 < 1 else -1)
    m = np.arange(nzc)
    x_q = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    return x_q[np.arange(m_sc) % nzc].astype(np.complex64)


def dmrs_for_slot(cell: Cell, m_sc: int, slot: int, cyclic_shift: int = 0) -> np.ndarray:
    """The UL DMRS of one slot (group hopping off: u = cell_id mod 30; the
    same sequence in both slots)."""
    alpha = 2 * np.pi * cyclic_shift / 12
    base = dmrs_base_seq(m_sc, cell.cell_id % 30)
    return (base * np.exp(1j * alpha * np.arange(m_sc))).astype(np.complex64)


def uci_layout(m_sc: int, n_cqi_syms: int, n_ack_syms: int):
    """PUSCH channel-interleaver position sets (36.212 5.2.2.6-8).

    The R x 12 symbol matrix (R = M_sc rows, one column per data SC-FDMA
    symbol) is written row by row with [CQI || data] and read column by
    column. HARQ-ACK punctures the interleaved data: the data is laid out
    over every non-CQI position, the ACK's included, and the ACK symbols
    overwrite the bottom rows of the columns next to the DMRS; the receiver
    erases those data bits (LLR 0). Returns (cqi_pos, ack_pos, data_pos) as
    stream indices in the column-major (per SC-FDMA symbol) order of the
    mapper; ack_pos is a subset of data_pos."""
    i = np.arange(n_ack_syms)
    ack_pos = np.asarray(ACK_COLS, np.int64)[i % 4] * m_sc + (m_sc - 1 - i // 4)
    # row-major fill -> column-major stream index, over every position
    order = np.add.outer(np.arange(m_sc), np.arange(12) * m_sc).reshape(-1)
    cqi_pos, data_pos = order[:n_cqi_syms], order[n_cqi_syms:]
    assert not np.isin(ack_pos, cqi_pos).any(), "ACK/CQI region overlap"
    return cqi_pos, ack_pos, data_pos


class PuschCodec:
    """Static-configuration UL-SCH codec, the dual of ``PdschCodec``: the
    encoder on the host and the decoder in torch on `device` (the current
    CUDA device by default, "cpu" for the plain twins). The turbo decoder
    runs up to ``n_turbo_iters`` iterations with CRC early exit, the
    reference's default."""

    def __init__(self, cell: Cell, grant: UlGrant, rnti: int, subframe: int,
                 n_turbo_iters: int = 8, n_cqi_bits: int = 0, with_ack: bool = False,
                 cqi_rep: int = 2, ack_syms: int = 4, device: str | torch.device = "cuda"):
        dev = resolve(device)
        self.device = dev
        self.cell, self.grant, self.rnti, self.subframe = cell, grant, rnti, subframe
        self.n_turbo_iters = n_turbo_iters
        self.m_sc = 12 * grant.n_prb
        self.n_data_sym = cell.n_sym_sf - 2  # minus the 2 DMRS symbols
        self.n_re = self.m_sc * self.n_data_sym
        self.qm = grant.mod_order

        # UCI on PUSCH (36.212 5.2.2.6-8): CQI on the leading interleaver
        # positions, ACK on the DMRS-adjacent columns; the data is rate
        # matched over every non-CQI position and punctured by the ACK
        self.n_cqi_bits, self.with_ack, self.cqi_rep = n_cqi_bits, with_ack, cqi_rep
        n_cqi_syms = -(-20 * cqi_rep // self.qm) if n_cqi_bits else 0
        self.cqi_pos, self.ack_pos, self.data_pos = uci_layout(
            self.m_sc, n_cqi_syms, ack_syms if with_ack else 0)
        self.G = len(self.data_pos) * self.qm
        self._ack_erase = np.repeat(~np.isin(self.data_pos, self.ack_pos),
                                    self.qm).astype(np.float32)

        self.plan = p = segmentation.plan(grant.tbs)
        g_prime = self.G // self.qm
        gamma = g_prime % p.c
        self.E = [self.qm * (g_prime // p.c + (1 if i >= p.c - gamma else 0))
                  for i in range(p.c)]
        self.e_offsets = np.concatenate([[0], np.cumsum(self.E)]).astype(np.int64)
        self.rm_idx = [ratematch.turbo_rm_indices(k + 4, self.E[i], grant.rv,
                                                  n_filler=(p.f if i == 0 else 0))
                       for i, k in enumerate(p.block_ks)]
        c_init = (rnti << 14) + (subframe << 9) + cell.cell_id
        self.scr_bits = seq.prs(c_init, self.G)
        self.scr_pm1 = (1.0 - 2.0 * self.scr_bits).astype(np.float32)
        self.blk_crc = {k: blk_crc_matrix(p, i, k) for i, k in enumerate(p.block_ks)}

        # device tables of the receive path
        self.groups = []  # (k, first block, count, E lo, E hi, inverse index)
        b = 0
        for k in dict.fromkeys(p.block_ks):
            count = p.block_ks.count(k)
            d_len = 3 * (k + 4)
            idx = np.concatenate([j * d_len + self.rm_idx[b + j] for j in range(count)])
            self.groups.append((k, b, count, int(self.e_offsets[b]), int(self.e_offsets[b + count]),
                                torch.as_tensor(ratematch.inverse_index(idx, count * d_len),
                                                device=dev)))
            b += count
        parts, off = [], 0
        for i, k in enumerate(p.block_ks):
            parts.append(np.arange(off + (p.f if i == 0 else 0), off + (k if p.c == 1 else k - 24)))
            off += k
        self._tb_pos = torch.as_tensor(np.concatenate(parts)[:grant.tbs], device=dev)
        self._blk_crc = {k: torch.as_tensor(m, dtype=torch.float32, device=dev)
                         for k, m in self.blk_crc.items()}
        # the scrambling signs times the ACK's erasures (+-1, +-0 where the
        # ACK punctured a data bit), int32 tables, as the demap kernel reads
        # them, and each code block's run of bits (ratematch.segment_ranges)
        self._scr_erase = torch.as_tensor(self.scr_pm1 * self._ack_erase, device=dev)
        self._inv32 = [g[5].to(torch.int32) for g in self.groups]
        self._ranges = [ratematch.segment_ranges(inv, count, hi - lo)
                        for (_, _, count, lo, hi, _), inv in zip(self.groups, self._inv32)]
        self._data_pos = torch.as_tensor(self.data_pos.astype(np.int32), device=dev)
        self._cqi_pos = torch.as_tensor(self.cqi_pos, device=dev)
        self._ack_pos = torch.as_tensor(self.ack_pos, device=dev)
        self.data_sym = np.asarray([s for s in range(cell.n_sym_sf) if s not in N_DMRS_SYM])
        self._data_sym = torch.as_tensor(self.data_sym, device=dev)
        self._dmrs = {}  # cyclic shift -> [2, m_sc] conjugated DMRS on the device
        self._last_uci_llrs = (None, None)

    # ------------------------------------------------------------------ UE TX
    def encode_bits(self, payload: np.ndarray) -> np.ndarray:
        """TB payload bits [tbs] -> scrambled codeword bits [G] (host)."""
        cw = np.concatenate([turbo.encode(blk).reshape(-1)[self.rm_idx[i]]
                             for i, blk in enumerate(segmentation.segment(payload))])
        return (cw ^ self.scr_bits).astype(np.uint8)

    def _data_stream(self, payload: np.ndarray) -> np.ndarray:
        stream = np.zeros(self.n_re, np.complex64)
        stream[self.data_pos] = modulation.modulate_np(self.encode_bits(payload), self.qm)
        return stream

    def encode_sf(self, payload: np.ndarray, cyclic_shift: int = 0) -> np.ndarray:
        """TB -> SC-FDMA time-domain subframe [sf_len] complex64 (host)."""
        if self.n_cqi_bits or self.with_ack:
            raise ValueError("UCI-configured codec: use encode_sf_uci")
        return self.map_waveform(self._data_stream(payload), cyclic_shift)

    def encode_sf_uci(self, payload: np.ndarray, cqi_bits=None, ack: bool | None = None,
                      cyclic_shift: int = 0) -> np.ndarray:
        """TB + UCI -> SC-FDMA subframe (host). cqi_bits [n_cqi_bits]: RM(20, A)
        coded and repeated circularly; ack: the HARQ-ACK bit, repeated on
        its positions."""
        stream = self._data_stream(payload)
        if self.n_cqi_bits:
            assert cqi_bits is not None and len(cqi_bits) == self.n_cqi_bits
            n_bits = len(self.cqi_pos) * self.qm
            cw = uci.rm20_encode(np.asarray(cqi_bits))
            stream[self.cqi_pos] = modulation.modulate_np(
                np.tile(cw, -(-n_bits // 20))[:n_bits], self.qm)
        if self.with_ack:
            assert ack is not None
            abits = np.full(len(self.ack_pos) * self.qm, 0 if ack else 1, np.uint8)
            stream[self.ack_pos] = modulation.modulate_np(abits, self.qm)
        return self.map_waveform(stream, cyclic_shift)

    def map_waveform(self, syms: np.ndarray, cyclic_shift: int = 0) -> np.ndarray:
        """[n_re] data-stream symbols -> SC-FDMA subframe: DFT precoding per
        data symbol, DMRS in symbols 3 and 10, the OFDM modulator (host)."""
        cell, m_sc = self.cell, self.m_sc
        precoded = np.fft.fft(syms.reshape(self.n_data_sym, m_sc), axis=-1) / np.sqrt(m_sc)
        grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
        band = slice(self.grant.prb_start * 12, self.grant.prb_start * 12 + m_sc)
        grid[self.data_sym, band] = precoded
        for s in N_DMRS_SYM:
            grid[s, band] = dmrs_for_slot(cell, m_sc, s // cell.n_sym_slot, cyclic_shift)
        return ofdm.modulate_np(cell, grid)

    # ------------------------------------------------------------- eNB side
    def _dmrs_conj(self, cyclic_shift: int) -> torch.Tensor:
        """[2, m_sc] conjugated DMRS of the two slots on the codec's device."""
        if cyclic_shift not in self._dmrs:
            refs = [dmrs_for_slot(self.cell, self.m_sc, s // self.cell.n_sym_slot, cyclic_shift)
                    for s in N_DMRS_SYM]
            self._dmrs[cyclic_shift] = torch.as_tensor(np.conj(np.stack(refs)),
                                                       device=self.device)
        return self._dmrs[cyclic_shift]

    def equalize_sf(self, iq, noise_var: float = 1e-4, cyclic_shift: int = 0):
        """IQ [..., sf_len] (a tensor, or numpy moved to the codec's device)
        -> (syms [..., n_re] complex64, nv [..., n_re] float32): DMRS LS
        estimate, ZF and the IDFT, with the reference's per-symbol noise."""
        cell, m_sc = self.cell, self.m_sc
        if not isinstance(iq, torch.Tensor):
            iq = torch.as_tensor(np.asarray(iq, np.complex64), device=self.device)
        sc0 = self.grant.prb_start * 12
        region = ofdm.demodulate(cell, iq)[..., sc0:sc0 + m_sc]
        ref = self._dmrs_conj(cyclic_shift)
        h = (region[..., N_DMRS_SYM[0], :] * ref[0] + region[..., N_DMRS_SYM[1], :] * ref[1]) / 2.0
        y = region[..., self._data_sym, :]  # [..., 12, m_sc]
        h2 = torch.clamp_min(torch.abs(h) ** 2, 1e-12)[..., None, :]
        x_td = torch.fft.ifft(y * torch.conj(h)[..., None, :] / h2, dim=-1) * math.sqrt(m_sc)
        syms = x_td.reshape(x_td.shape[:-2] + (-1,))
        # the reference's quirk: subcarrier k's noise on time-domain sample k
        return syms, (noise_var / h2).expand(y.shape).reshape(syms.shape)

    def _uci_llrs(self, syms: torch.Tensor, nv: torch.Tensor, pos: torch.Tensor):
        """[..., len(pos), qm] LLRs of the symbols at stream positions pos."""
        llr = modulation.demodulate_soft(syms[..., pos], self.qm, nv[..., pos])
        return llr.reshape(syms.shape[:-1] + (len(pos), self.qm))

    def dematch_sf(self, iq, noise_var: float = 1e-4, cyclic_shift: int = 0) -> list:
        """IQ [..., sf_len] (a tensor, or numpy moved to the codec's device)
        -> per-code-block d-domain softbuffers, each [..., 3(K+4)]:
        ``equalize_sf``, then demap, descramble, ACK erasure and dematch of
        the data positions, one ``ratematch.demap_dematch`` per K-group (on
        the card one launch of the demap kernel each). The softbuffers do
        not depend on rv, so element-wise addition across retransmissions
        (each dematched by the codec of its rv) is the eNB's HARQ combining.
        The UCI symbols' LLRs (``modulation.demodulate_soft``) are kept for
        ``decode_uci``."""
        syms, nv = self.equalize_sf(iq, noise_var, cyclic_shift)
        lead = syms.shape[:-1]
        self._last_uci_llrs = (
            self._uci_llrs(syms, nv, self._cqi_pos) if self.n_cqi_bits else None,
            self._uci_llrs(syms, nv, self._ack_pos) if self.with_ack else None)
        bufs = []
        for (k, first, count, lo, hi, _), inv32, ranges in zip(self.groups, self._inv32,
                                                                self._ranges):
            buf = ratematch.demap_dematch(syms, nv, self.qm, self._scr_erase, inv32,
                                          self._data_pos, lo, hi, ranges).reshape(
                lead + (count, 3 * (k + 4)))
            if first == 0 and self.plan.f:
                buf[..., 0, :self.plan.f] += FILLER_LLR
            bufs.extend(buf.unbind(-2))
        return bufs

    def decode_softbuffers(self, bufs: list):
        """Per-block softbuffers -> (payload [..., tbs] uint8, tb_ok [...] bool,
        iters [..., C] int32). The blocks of one K decode in one
        ``turbo.decode`` call (CRC early exit, each block frozen on its own
        CRC: the same results as one call per block). tb_ok is every block's
        CRC, as in the reference (the TB CRC24A is the block CRC when C = 1
        and is not checked again when C > 1)."""
        hards, oks, iters = [], [], []
        for k, first, count, *_ in self.groups:
            buf = torch.stack(bufs[first:first + count], -2)
            lead = buf.shape[:-2]
            hard, it, ok = turbo.decode(buf.reshape(-1, 3, k + 4), k, self.n_turbo_iters,
                                        self._blk_crc[k])
            hards.append(hard.reshape(lead + (count * k,)))
            oks.append(ok.reshape(lead + (count,)))
            iters.append(it.reshape(lead + (count,)))
        blk_ok = torch.cat(oks, -1)
        return torch.cat(hards, -1)[..., self._tb_pos], blk_ok.all(-1), torch.cat(iters, -1)

    def decode_sf(self, iq, noise_var: float = 1e-4, cyclic_shift: int = 0):
        """IQ [..., sf_len] -> (payload, tb_ok, iters): ``dematch_sf`` then
        ``decode_softbuffers``."""
        return self.decode_softbuffers(self.dematch_sf(iq, noise_var, cyclic_shift))

    def decode_uci(self):
        """The UCI of the last ``dematch_sf`` call: (cqi_bits | None, ack |
        None). As in the reference, every CQI LLR of the call (all batch
        elements, in order) accumulates into the 20 RM positions on the host,
        and the ACK is the sign of the sum of its LLRs."""
        cqi_llr, ack_llr = self._last_uci_llrs
        cqi = ack = None
        if cqi_llr is not None:
            acc = np.zeros(20, np.float32)
            for i, v in enumerate(to_host(cqi_llr).reshape(-1)):
                acc[i % 20] += v
            cqi, _ = uci.rm20_decode(acc, self.n_cqi_bits)
        if ack_llr is not None:
            ack = bool(to_host(ack_llr).sum() > 0)
        return cqi, ack
