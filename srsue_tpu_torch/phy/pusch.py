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

``PuschCell`` receives one subframe shared by several UEs, one
``PuschCodec`` per allocation, through the same per-allocation code: one
OFDM demodulation for all of them, each allocation's estimate and ZF, one
IDFT for all the allocations of one size, each allocation's demap, and one
``turbo.decode`` for the blocks of one K (and one CRC) of every UE.

On a card both receivers replay their front end (span ``pusch.frontend``)
and their demap (``pusch.demap_dematch``) as one CUDA graph each once the
stage's key comes back (``phy/frontend.py``). The keys hold values, not
objects: each codec's ``key`` (cell, grant, RNTI, subframe, UCI layout),
for the front end also the DMRS shifts and the noise, and the inputs'
shapes, so codecs built alike share graphs (the eNB builds one a TTI). The
front end keys on the whole receive, not on its bands alone: at B=1 a
capture costs about three eager calls, and a band that comes back under
other grants replays too seldom to repay it. A noise given as a tensor or
an array stays eager.

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
from ..utils.trace import annotate
from . import frontend, modulation, ofdm, ratematch, segmentation, seq, turbo, uci
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
        n_ack_syms = ack_syms if with_ack else 0
        self.cqi_pos, self.ack_pos, self.data_pos = uci_layout(self.m_sc, n_cqi_syms, n_ack_syms)
        # the receive's configuration by value: its graphs' keys
        self.key = (cell, grant.prb_start, grant.n_prb, self.qm, grant.tbs, grant.rv, rnti,
                    subframe, n_cqi_bits, cqi_rep if n_cqi_bits else 0, n_ack_syms)
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
        self._k_plan = _k_plan([self])

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

    def _zf(self, grid: torch.Tensor, cyclic_shift: int):
        """The allocation's band of a demodulated grid [..., n_sym, n_sc]: the
        DMRS LS estimate averaged over both slots, and ZF of the data symbols
        -> (z [..., 12, m_sc], |h|^2 floored at 1e-12 [..., 1, m_sc])."""
        sc0 = self.grant.prb_start * 12
        region = grid[..., sc0:sc0 + self.m_sc]
        ref = self._dmrs_conj(cyclic_shift)
        h = (region[..., N_DMRS_SYM[0], :] * ref[0]
             + region[..., N_DMRS_SYM[1], :] * ref[1]) / 2.0
        y = region[..., self._data_sym, :]  # [..., 12, m_sc]
        h2 = torch.clamp_min(torch.abs(h) ** 2, 1e-12)[..., None, :]
        return y * torch.conj(h)[..., None, :] / h2, h2

    @staticmethod
    def _stream(x_td: torch.Tensor, h2: torch.Tensor, noise_var: float):
        """The IDFT's output [..., 12, m_sc] -> (syms [..., n_re], nv [...,
        n_re]) in stream order, with the reference's quirk: subcarrier k's
        noise on time-domain sample k."""
        syms = x_td.reshape(x_td.shape[:-2] + (-1,))
        return syms, (noise_var / h2).expand(x_td.shape).reshape(syms.shape)

    def equalize_sf(self, iq, noise_var: float = 1e-4, cyclic_shift: int = 0):
        """IQ [..., sf_len] (a tensor, or numpy moved to the codec's device)
        -> (syms [..., n_re] complex64, nv [..., n_re] float32): DMRS LS
        estimate, ZF and the IDFT, with the reference's per-symbol noise."""
        with annotate("pusch.frontend"):
            return _equalized([self], _iq_tensor(iq, self.device), noise_var,
                              [cyclic_shift])[0]

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
        ``decode_uci`` and ``decode_uci_sf``."""
        eq = self.equalize_sf(iq, noise_var, cyclic_shift)
        with annotate("pusch.demap_dematch"):
            return _dematched([self], [eq])[0]

    def _dematch(self, syms: torch.Tensor, nv: torch.Tensor):
        """Equalized symbols and noise [..., n_re] -> (each K-group's
        softbuffers [..., count, 3(K+4)], the UCI symbols' LLRs (cqi | None,
        ack | None))."""
        lead = syms.shape[:-1]
        uci_llrs = (self._uci_llrs(syms, nv, self._cqi_pos) if self.n_cqi_bits else None,
                    self._uci_llrs(syms, nv, self._ack_pos) if self.with_ack else None)
        bufs = []
        for (k, first, count, lo, hi, _), inv32, ranges in zip(self.groups, self._inv32,
                                                                self._ranges):
            buf = ratematch.demap_dematch(syms, nv, self.qm, self._scr_erase, inv32,
                                          self._data_pos, lo, hi, ranges).reshape(
                lead + (count, 3 * (k + 4)))
            if first == 0 and self.plan.f:
                buf[..., 0, :self.plan.f] += FILLER_LLR
            bufs.append(buf)
        return bufs, uci_llrs

    def _tables(self) -> list:
        """The device tables ``_dematch`` reads."""
        return [self._scr_erase, self._inv32, self._ranges, self._data_pos, self._cqi_pos,
                self._ack_pos, modulation.levels(self.qm, self.device)]

    def decode_softbuffers(self, bufs: list):
        """Per-block softbuffers -> (payload [..., tbs] uint8, tb_ok [...] bool,
        iters [..., C] int32). The blocks of one K decode in one
        ``turbo.decode`` call (CRC early exit, each block frozen on its own
        CRC: the same results as one call per block). tb_ok is every block's
        CRC, as in the reference (the TB CRC24A is the block CRC when C = 1
        and is not checked again when C > 1)."""
        return _decode([self], self._k_plan, [bufs])[0]

    def decode_sf(self, iq, noise_var: float = 1e-4, cyclic_shift: int = 0):
        """IQ [..., sf_len] -> (payload, tb_ok, iters): ``dematch_sf`` then
        ``decode_softbuffers``."""
        return self.decode_softbuffers(self.dematch_sf(iq, noise_var, cyclic_shift))

    def _uci(self, whole: bool):
        """The last ``dematch_sf``'s (cqi [..., A] uint8 | None, ack [...]
        bool | None) on the codec's device, of each subframe, or of the whole
        call as one stream (`whole`): the CQI's LLRs summed into the 20 RM
        positions in their order (``uci.rm20_sums``), then the ML codeword
        (``uci.rm20_decode_t``); the ACK where the sum of its LLRs is
        positive."""
        def words(llr):  # [..., n_pos, qm] -> [..., n_pos * qm], or [all] if whole
            return llr.reshape(-1) if whole else llr.flatten(-2)

        cqi_llr, ack_llr = self._last_uci_llrs
        cqi = None if cqi_llr is None else uci.rm20_decode_t(
            uci.rm20_sums(words(cqi_llr)), self.n_cqi_bits)
        ack = None if ack_llr is None else words(ack_llr).sum(-1) > 0
        return cqi, ack

    def decode_uci_sf(self):
        """The UCI of each subframe of the last ``dematch_sf`` call, as
        tensors on the codec's device: (cqi [..., A] uint8 | None, ack [...]
        bool | None), None where the codec carries no such UCI. Each
        subframe's CQI and ACK come from its own LLRs alone."""
        with annotate("pusch.uci"):
            return self._uci(whole=False)

    def decode_uci(self):
        """The UCI of the last ``dematch_sf`` call on the host: (cqi_bits
        [A] | None, ack | None). As in the reference, every CQI LLR of the
        call (all batch elements, in order) sums into the 20 RM positions as
        one stream, and the ACK is the sign of the sum of all its LLRs: the
        decoder of ``decode_uci_sf`` over the whole call, the same at B=1."""
        with annotate("pusch.uci"):
            cqi, ack = self._uci(whole=True)
        return (None if cqi is None else to_host(cqi),
                None if ack is None else bool(to_host(ack)))


class PuschCell:
    """An eNB's receive of one uplink subframe shared by several UEs: one
    ``PuschCodec`` per allocation (its band, modulation, transport block,
    RNTI, UCI and tables) on one `cell`, each UE with its DMRS cyclic shift.
    The codecs' decoders run on their device (all on one), with the same
    per-allocation code as ``PuschCodec``'s own receive:

    - ``dematch(iq, noise_var)``: one OFDM demodulation of the batch; each
      allocation's band, DMRS estimate and ZF; one IDFT for all the
      allocations of one M_sc (span ``pusch.idft_group`` each); each
      allocation's demap, descramble, ACK erasure and dematch. Returns each
      UE's per-block softbuffers.
    - ``decode(bufs)``: the blocks of one K and one CRC of every UE stacked
      into one ``turbo.decode`` call (span ``pusch.k_group`` each; CRC early
      exit, each block frozen on its own CRC), the results split back: each
      UE's (payload, tb_ok, iters), as its codec's ``decode_softbuffers``.
    - ``decode_uci_sf()``: each UE's (cqi, ack) of every subframe of the
      last ``dematch``, as its codec's ``decode_uci_sf``.
    """

    def __init__(self, cell: Cell, codecs: list, cyclic_shifts: list):
        codecs = list(codecs)
        if not codecs:
            raise ValueError("a subframe needs at least one allocation")
        if any(c.cell != cell for c in codecs):
            raise ValueError("every codec must be of the subframe's cell")
        if len({c.device for c in codecs}) != 1 or len({c.n_turbo_iters for c in codecs}) != 1:
            raise ValueError("the codecs must share one device and one turbo iteration count")
        bands = sorted((c.grant.prb_start, c.grant.prb_start + c.grant.n_prb) for c in codecs)
        if bands[0][0] < 0 or bands[-1][1] > cell.n_prb or any(
                a[1] > b[0] for a, b in zip(bands, bands[1:])):
            raise ValueError(f"allocations overlap or leave the cell: {bands}")
        self.cell, self.codecs, self.device = cell, codecs, codecs[0].device
        self.cyclic_shifts = list(cyclic_shifts)
        if len(self.cyclic_shifts) != len(codecs):
            raise ValueError("one cyclic shift per codec")
        self._k_plan = _k_plan(codecs)

    def dematch(self, iq, noise_var: float = 1e-4) -> list:
        """IQ [..., sf_len] (a tensor, or numpy moved to the device) -> each
        UE's per-code-block softbuffers, each [..., 3(K+4)]; each UE's UCI
        LLRs kept for ``decode_uci_sf``."""
        with annotate("pusch.frontend"):
            eq = _equalized(self.codecs, _iq_tensor(iq, self.device), noise_var,
                            self.cyclic_shifts)
        with annotate("pusch.demap_dematch"):
            return _dematched(self.codecs, eq)

    def decode(self, bufs: list) -> list:
        """Each UE's softbuffers -> each UE's (payload [..., tbs] uint8, tb_ok
        [...] bool, iters [..., C] int32)."""
        return _decode(self.codecs, self._k_plan, bufs)

    def decode_uci_sf(self) -> list:
        """Each UE's (cqi [..., A] uint8 | None, ack [...] bool | None) of each
        subframe of the last ``dematch``, on the device."""
        with annotate("pusch.uci"):
            return [c._uci(whole=False) for c in self.codecs]


def _iq_tensor(iq, device: torch.device) -> torch.Tensor:
    if isinstance(iq, torch.Tensor):
        return iq
    return torch.as_tensor(np.asarray(iq, np.complex64), device=device)


def _graphed(codecs: list, noise_var=None) -> bool:
    """Whether a stage of these codecs replays as a CUDA graph: on a card,
    with the noise, where the stage takes it, a number (a key holds it by
    value; a tensor or an array stays eager)."""
    return codecs[0].device.type == "cuda" and (
        noise_var is None or isinstance(noise_var, (int, float, np.floating)))


def _equalized(codecs: list, iq: torch.Tensor, noise_var, shifts: list) -> list:
    """Each codec's (syms, nv) from IQ [..., sf_len]: the OFDM demodulation,
    then ``_equalize``. On a card one CUDA graph once the codecs' keys, the
    shifts, the noise and the input shape come back."""
    cell = codecs[0].cell

    def body(x):
        return _equalize(codecs, ofdm.demodulate(cell, x), noise_var, shifts)

    if not _graphed(codecs, noise_var):
        return body(iq)
    key = ("pusch.frontend",) + tuple(c.key for c in codecs) + (tuple(shifts), noise_var)
    return frontend.run(key, body, (iq,), codecs[0].device, lambda: [
        (c._dmrs_conj(cs), c._data_sym) for c, cs in zip(codecs, shifts)])


def _dematched(codecs: list, eq: list) -> list:
    """Each codec's per-code-block softbuffers from its (syms, nv), its UCI
    symbols' LLRs kept for ``decode_uci`` and ``decode_uci_sf``. On a card one
    CUDA graph once the codecs' keys and the inputs' shapes come back; its
    K-groups and LLRs are then this call's clones. The blocks are each
    K-group's rows (views), which ``_decode`` joins again with no copy."""
    def body(*xs):
        return [c._dematch(xs[2 * i], xs[2 * i + 1]) for i, c in enumerate(codecs)]

    xs = tuple(t for pair in eq for t in pair)
    if not _graphed(codecs):
        out = body(*xs)
    else:
        out = frontend.run(("pusch.demap_dematch",) + tuple(c.key for c in codecs), body, xs,
                           codecs[0].device, lambda: [c._tables() for c in codecs])
    for c, (_, uci_llrs) in zip(codecs, out):
        c._last_uci_llrs = uci_llrs
    return [[b for group in groups for b in group.unbind(-2)] for groups, _ in out]


def _equalize(codecs: list, grid: torch.Tensor, noise_var: float, shifts: list) -> list:
    """Each codec's (syms, nv) from one demodulated grid: its band's estimate
    and ZF, then one IDFT for the allocations of one M_sc (stacked on a
    leading axis; a lone allocation's IDFT is its own)."""
    zf = [c._zf(grid, cs) for c, cs in zip(codecs, shifts)]
    by_size: dict = {}
    for i, c in enumerate(codecs):
        by_size.setdefault(c.m_sc, []).append(i)
    out = [None] * len(codecs)
    for m_sc, members in by_size.items():
        with annotate("pusch.idft_group"):
            if len(members) == 1:
                x_td = (torch.fft.ifft(zf[members[0]][0], dim=-1) * math.sqrt(m_sc),)
            else:
                x_td = (torch.fft.ifft(torch.stack([zf[i][0] for i in members]), dim=-1)
                        * math.sqrt(m_sc)).unbind(0)
        for x, i in zip(x_td, members):
            out[i] = codecs[i]._stream(x, zf[i][1], noise_var)
    return out


def _k_plan(codecs: list) -> list:
    """[(K, CRC matrix on the device, [(codec, first block, count)])]: the
    K-groups of every codec merged where K and the block CRC agree, in order
    of first appearance. A codec's blocks of one K are contiguous."""
    plan: dict = {}
    for u, c in enumerate(codecs):
        for k, first, count, *_ in c.groups:
            key = (k, c.blk_crc[k].tobytes())
            plan.setdefault(key, (k, c._blk_crc[k], []))[2].append((u, first, count))
    return list(plan.values())


def _rows(blocks: list) -> torch.Tensor:
    """Blocks [..., D] stacked on a new axis -2; where they are the
    consecutive rows of one tensor, as the demap leaves one codec's K-group,
    that tensor itself, a view, with no copy."""
    b0, d = blocks[0], blocks[0].shape[-1]
    at = b0.untyped_storage().data_ptr()
    if b0.stride(-1) == 1 and all(
            b.untyped_storage().data_ptr() == at and b.dtype == b0.dtype and b.shape == b0.shape
            and b.stride() == b0.stride() and b.storage_offset() == b0.storage_offset() + i * d
            for i, b in enumerate(blocks)):
        return b0.as_strided(b0.shape[:-1] + (len(blocks), d), b0.stride()[:-1] + (d, 1))
    return torch.stack(blocks, -2)


def _decode(codecs: list, plan: list, bufs: list) -> list:
    """Each codec's per-block softbuffers -> each codec's (payload, tb_ok,
    iters): one ``turbo.decode`` per entry of `plan`, its blocks stacked in
    plan order (``_rows``), the results split back and each codec's blocks
    put in order."""
    parts = [{} for _ in codecs]  # codec -> first block -> (hard, ok, iters)
    with annotate("pusch.turbo"):
        for k, crc_m, members in plan:
            buf = _rows([b for u, first, count in members
                         for b in bufs[u][first:first + count]])
            lead = buf.shape[:-2]
            with annotate("pusch.k_group"):
                hard, it, ok = turbo.decode(buf.reshape(-1, 3, k + 4), k,
                                            codecs[0].n_turbo_iters, crc_m)
            if len(members) == 1:  # one codec's blocks: its results as they come
                u, first, count = members[0]
                parts[u][first] = (hard.reshape(lead + (count * k,)), ok.reshape(lead + (count,)),
                                   it.reshape(lead + (count,)))
                continue
            hard = hard.reshape(lead + (-1, k))
            ok, it = ok.reshape(lead + (-1,)), it.reshape(lead + (-1,))
            j = 0
            for u, first, count in members:
                parts[u][first] = (hard.narrow(-2, j, count).reshape(lead + (count * k,)),
                                   ok.narrow(-1, j, count), it.narrow(-1, j, count))
                j += count
        out = []
        for c, got in zip(codecs, parts):
            hards, oks, iters = zip(*(got[f] for f in sorted(got)))
            out.append((torch.cat(hards, -1)[..., c._tb_pos], torch.cat(oks, -1).all(-1),
                         torch.cat(iters, -1)))
        return out
