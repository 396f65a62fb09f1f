"""The plain reference receiver: the receive arithmetic of the port's chains
written out in numpy float64 on the CPU, over the same IQ. It shares with
the transmitter only the host tables of ``lte/`` (RE maps, sequences, CRCs,
rate-matching index maps, DCI fields, the search space).

``Receiver(cfg)`` holds one configuration. ``grant_known(iq, forced)`` is
the chain of ``entry.chain``: OFDM demodulation, the CRS estimate, ZF (or
Alamouti with two ports), max-log demapping, descrambling and dematching
into softbuffers, the turbo decode and the TB CRC, at the configured grant
and CFI. ``ue_dl(iq)`` is the chain of ``UeDl.process`` with its defaults:
the estimate of every port, the control region equalized (ZF, or SFBC
combined in REG quadruplets), the PCFICH, the blind DCI 1A search of the
UE-specific space, and the PDSCH of the grant found in the first subframe
decoded in every subframe with CRC early exit.

Where the standard leaves a receiver free, the port's stated choices are
followed, since they change the numbers compared: the CRS estimator
(``channel``), the turbo decoder's windows (``window_len``) and the
two-pass circular Viterbi (``viterbi``).

``q`` is applied to every stage's output: ``exact`` keeps the values,
``bf16`` rounds each to bfloat16, the control that a comparison has to fail.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .lte import control, crc, dci, ra, ratematch, regrid, turbo
from .lte.cell import Cell
from .lte.pdsch import PdschMap
from .transmitter import cell_of

FILLER_LLR = 1e4  # the softbuffer's prior on a known-zero filler bit (bit 0)


def exact(x):
    return x


def bf16(x):
    """x with every real value rounded to bfloat16 (complex: both parts)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return bf16(x.real) + 1j * bf16(x.imag)
    if x.dtype.kind != "f":
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float64).numpy()


def _per_row(v, like):
    """A per-subframe value [n] broadcast against `like` [n, ...]."""
    return np.reshape(v, (-1,) + (1,) * (like.ndim - 1))


# ------------------------------------------------------------------ front end
def ofdm_demod(cell: Cell, iq) -> np.ndarray:
    """iq [n, sf_len] -> grid [n, n_sym_sf, n_sc] complex128 (36.211 6.12):
    each symbol's cyclic prefix dropped, a unitary FFT, subcarrier k at
    frequency k - n_sc/2 below DC and k - n_sc/2 + 1 above it."""
    nfft, half = cell.nfft, cell.n_sc // 2
    starts, t = [], 0
    for cp in list(cell.cp_lengths) * 2:
        starts.append(t + cp)
        t += cp + nfft
    x = np.asarray(iq, np.complex128)
    f = np.fft.fft(np.stack([x[:, s:s + nfft] for s in starts], 1), axis=-1) / np.sqrt(nfft)
    k = np.arange(cell.n_sc)
    return f[..., np.where(k < half, k - half, k - half + 1) % nfft]


@functools.lru_cache(maxsize=16)
def _pilots(cell: Cell, port: int, subframe: int):
    """(CRS symbols [n_crs], their subcarriers [n_crs, n_p] ascending, the
    reference values there [n_crs, n_p])."""
    pos = regrid.crs_positions(cell, port, subframe)
    val = regrid.crs_values(cell, port, subframe).astype(np.complex128)
    syms = np.unique(pos[:, 0])
    ks, vs = [], []
    for l in syms:
        at = pos[:, 0] == l
        order = np.argsort(pos[at, 1])
        ks.append(pos[at, 1][order])
        vs.append(val[at][order])
    return syms, np.array(ks), np.array(vs)


def _lerp(xp: np.ndarray, fp: np.ndarray, x: np.ndarray) -> np.ndarray:
    """fp [n, m] given at ascending xp [m], read at x: linear between the two
    neighbours, and past either end along the first or last two."""
    j = np.clip(np.searchsorted(xp, x), 1, len(xp) - 1)
    t = (x - xp[j - 1]) / (xp[j] - xp[j - 1])
    return (1.0 - t) * fp[:, j - 1] + t * fp[:, j]


def _smooth(h: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """The pilots [n, n_crs, n_p] through the filter along frequency with the
    least estimated error, per subframe: none, [1 2 1]/4 or [1 2 2 2 1]/8
    (edge pilots repeated). A filter's error is its noise gain (1, 6/16 or
    14/64 of the noise, over the n_crs symbols that the time averaging
    combines) plus its bias, which is measured on the pilots less the share
    the noise has in that measure. The noise here is that of CRS symbols 2,
    3 against 0, 1 on the same subcarriers, each pair's common phase taken
    out; with fewer than four symbols, ``noise``."""
    n_crs, p = h.shape[1], h.shape[2]
    n_avg = n_crs if n_crs >= 2 else 1
    hp = np.concatenate([h[..., :1], h[..., :1], h, h[..., -1:], h[..., -1:]], -1)

    def tap(d):
        return hp[..., 2 + d:2 + d + p]

    fir3 = (tap(-1) + 2.0 * tap(0) + tap(1)) / 4.0
    fir5 = (tap(-2) + 2.0 * tap(-1) + 2.0 * tap(0) + 2.0 * tap(1) + tap(2)) / 8.0
    if n_crs >= 4:
        a, b = h[:, 0:2], h[:, 2:4]
        c = np.sum(b * np.conj(a), -1, keepdims=True)
        turn = c / np.maximum(np.abs(c), 1e-12)
        nv = 0.5 * np.mean(np.abs(b * np.conj(turn) - a) ** 2, axis=(1, 2))
    else:
        nv = noise
    second = h[..., 2:] - 2.0 * h[..., 1:-1] + h[..., :-2]
    bias3 = np.maximum(np.mean(np.abs(second) ** 2, axis=(1, 2)) / 16.0 - 6.0 / 16.0 * nv, 0.0)
    bias5 = np.maximum(np.mean(np.abs((fir5 - h)[..., 2:-2]) ** 2, axis=(1, 2))
                       - 46.0 / 64.0 * nv, 0.0)
    e0, e3, e5 = nv / n_avg, 6.0 / 16.0 * nv / n_avg + bias3, 14.0 / 64.0 * nv / n_avg + bias5
    use3 = ((e3 <= e0) & (e3 <= e5))[:, None, None]
    use5 = ((e5 < e0) & (e5 < e3))[:, None, None]
    return np.where(use5, fir5, np.where(use3, fir3, h))


def channel(cell: Cell, grid: np.ndarray, subframe: int, port: int):
    """The port's CRS estimate of one port: (h [n, n_sym_sf, n_sc], noise
    [n], rsrp [n]).

    LS at the pilots; the noise from each inner pilot less the mean of it
    and its two neighbours, which keeps 2/3 of the noise power; RSRP the
    pilots' mean power; the pilots filtered (``_smooth``), interpolated
    along frequency (``_lerp``), their common shape averaged over the CRS
    symbols with each symbol's phase relative to the first kept; then
    linear in time between the CRS symbols, held before the first and after
    the last."""
    syms, ks, ref = _pilots(cell, port, subframe)
    h = grid[:, syms[:, None], ks] * np.conj(ref) / np.mean(np.abs(ref) ** 2)
    rsrp = np.mean(np.abs(h) ** 2, axis=(1, 2))
    resid = (2.0 * h[..., 1:-1] - h[..., :-2] - h[..., 2:]) / 3.0
    noise = 1.5 * np.mean(np.abs(resid) ** 2, axis=(1, 2))
    hs = _smooth(h, noise)
    sc = np.arange(cell.n_sc)
    hf = np.stack([_lerp(ks[i], hs[:, i], sc) for i in range(len(syms))], 1)
    if len(syms) >= 2:
        c = np.sum(hf * np.conj(hf[:, :1]), -1, keepdims=True)
        turn = c / np.maximum(np.abs(c), 1e-12)
        hf = np.mean(hf * np.conj(turn), axis=1, keepdims=True) * turn
    out = np.empty((grid.shape[0], cell.n_sym_sf, cell.n_sc), np.complex128)
    for s in range(cell.n_sym_sf):
        j = int(np.searchsorted(syms, s))
        if j == 0 or j >= len(syms):
            out[:, s] = hf[:, min(j, len(syms) - 1)]
        else:
            t = (s - syms[j - 1]) / (syms[j] - syms[j - 1])
            out[:, s] = (1.0 - t) * hf[:, j - 1] + t * hf[:, j]
    return out, noise, rsrp


def cell_metrics(cell: Cell, grid: np.ndarray, noise, rsrp) -> dict:
    """RSSI, RSRQ, SNR, RSRP and noise of each subframe."""
    rssi = np.mean(np.abs(grid) ** 2, axis=(1, 2)) * cell.n_sc
    return {"rssi": rssi,
            "rsrq_db": 10.0 * np.log10(cell.n_prb * rsrp / np.maximum(rssi, 1e-12)),
            "snr_db": 10.0 * np.log10(np.maximum(rsrp / np.maximum(noise, 1e-12), 1e-12)),
            "rsrp": rsrp, "noise": noise}


def zf(y, h, noise):
    """y / h at each RE, and its noise, noise / |h|^2 (|h|^2 floored)."""
    p = np.maximum(np.abs(h) ** 2, 1e-12)
    return y * np.conj(h) / p, _per_row(noise, p) / p


def sfbc(y, h0, h1, noise):
    """Alamouti combining of RE pairs (2i, 2i+1) along the last axis (36.211
    6.3.4.3): port 0 sent (x0, x1)/sqrt2 and port 1 (-x1*, x0*)/sqrt2, so
    with g the pair's mean channel, y0 = (g0 x0 - g1 x1*)/sqrt2 and
    y1 = (g0 x1 + g1 x0*)/sqrt2. Both estimates carry the noise
    2 noise / (|g0|^2 + |g1|^2)."""
    y0, y1 = y[..., 0::2], y[..., 1::2]
    g0 = 0.5 * (h0[..., 0::2] + h0[..., 1::2])
    g1 = 0.5 * (h1[..., 0::2] + h1[..., 1::2])
    p = np.maximum(np.abs(g0) ** 2 + np.abs(g1) ** 2, 1e-12)
    x0 = np.sqrt(2.0) * (np.conj(g0) * y0 + g1 * np.conj(y1)) / p
    x1 = np.sqrt(2.0) * (np.conj(g0) * y1 - g1 * np.conj(y0)) / p
    nv = 2.0 * _per_row(noise, p) / p
    return np.stack([x0, x1], -1).reshape(y.shape), np.repeat(nv, 2, -1)


# -------------------------------------------------------------- demap, dematch
@functools.lru_cache(maxsize=4)
def _constellation(qm: int):
    """(points [2^qm] complex128, bits [2^qm, qm]) of 36.211 7.1's tables:
    b0 and b1 the signs of I and Q, then I's and Q's magnitude bits."""
    bits = (np.arange(1 << qm)[:, None] >> np.arange(qm - 1, -1, -1)) & 1
    sign = 1 - 2 * bits
    if qm == 2:
        pts = (sign[:, 0] + 1j * sign[:, 1]) / np.sqrt(2.0)
    elif qm == 4:
        pts = (sign[:, 0] * (1 + 2 * bits[:, 2]) + 1j * sign[:, 1] * (1 + 2 * bits[:, 3])) \
            / np.sqrt(10.0)
    elif qm == 6:
        mag = np.array([[3, 1], [5, 7]])  # by (b2, b4) for I, (b3, b5) for Q
        pts = (sign[:, 0] * mag[bits[:, 2], bits[:, 4]]
               + 1j * sign[:, 1] * mag[bits[:, 3], bits[:, 5]]) / np.sqrt(42.0)
    else:
        raise ValueError(f"no constellation of {qm} bits")
    return pts, bits


def demap(x: np.ndarray, nv: np.ndarray, qm: int) -> np.ndarray:
    """[n, m] symbols and their noise -> [n, m*qm] max-log LLRs, > 0 for bit
    0: per bit, the least squared distance to a point whose bit is 1 less
    the least to one whose bit is 0, over the noise (floored at 1e-9)."""
    pts, bits = _constellation(qm)
    out = np.empty(x.shape + (qm,))
    for r in range(x.shape[0]):
        d = (x[r, :, None].real - pts.real) ** 2 + (x[r, :, None].imag - pts.imag) ** 2
        for i in range(qm):
            one = bits[:, i] == 1
            out[r, :, i] = d[:, one].min(-1) - d[:, ~one].min(-1)
    out /= np.maximum(np.broadcast_to(nv, x.shape), 1e-9)[..., None]
    return out.reshape(x.shape[0], -1)


def dematch(llr: np.ndarray, idx: np.ndarray, size: int) -> np.ndarray:
    """[n, E] LLRs -> [n, size] softbuffers: each LLR added to the position
    the rate-matching map sent it from, repeats summed, positions never
    sent 0."""
    out = np.zeros((llr.shape[0], size))
    np.add.at(out, (slice(None), np.asarray(idx)), llr)
    return out


# --------------------------------------------------------------- turbo decode
def _rsc_trellis():
    """(next [8, 2], parity [8, 2]) of the constituent encoder (36.212
    5.1.3.2.1): feedback 1 + D^2 + D^3, parity 1 + D + D^3, the state
    (r1, r2, r3) with r1 the newest register in bit 2."""
    nxt = np.zeros((8, 2), np.int64)
    par = np.zeros((8, 2), np.int64)
    for s in range(8):
        r1, r2, r3 = s >> 2 & 1, s >> 1 & 1, s & 1
        for u in (0, 1):
            a = u ^ r2 ^ r3
            nxt[s, u] = a << 2 | r1 << 1 | r2
            par[s, u] = a ^ r1 ^ r3
    return nxt, par


NXT, PAR = _rsc_trellis()
# the two (state, input) branches into each state
PREV_S, PREV_U = (np.array([[s for s in range(8) for u in (0, 1) if NXT[s, u] == t]
                            for t in range(8)]),
                  np.array([[u for s in range(8) for u in (0, 1) if NXT[s, u] == t]
                            for t in range(8)]))
U_SIGN = np.array([1.0, -1.0])
P_SIGN = 1.0 - 2.0 * PAR
WINDOWS = (64, 96, 128, 48, 32, 192, 256)  # the port's window lengths, first that divides K


def window_len(k: int) -> int:
    """The port's window: the first of WINDOWS that divides K into two or
    more, for K over 256; else the whole block."""
    if k > 256:
        for lw in WINDOWS:
            if k % lw == 0 and k // lw >= 2:
                return lw
    return k


def _gamma(lin, lp):
    """Branch metrics [..., 8, 2] by (state, input): half of the input LLR
    times the input's sign plus half of the parity LLR times the parity's
    sign."""
    return 0.5 * lin[..., None, None] * U_SIGN + 0.5 * lp[..., None, None] * P_SIGN


def _bcjr(lin, lp, a0, b0):
    """Max-log-MAP over [n, L] windows from alpha a0 [n, 8] and beta b0:
    (extrinsic [n, L], alpha after the last step, beta before the first),
    the two returned less their maximum."""
    n, length = lin.shape
    g = np.moveaxis(_gamma(lin, lp), 1, 0)  # [L, n, 8, 2] by (state, input)
    g_out = [np.ascontiguousarray(g[..., u]) for u in (0, 1)]  # branches out of each state
    g_in = [np.ascontiguousarray(g[:, :, PREV_S[:, j], PREV_U[:, j]]) for j in (0, 1)]
    alphas = np.empty((length, n, 8))
    a = a0
    for t in range(length):
        alphas[t] = a
        a = np.maximum(np.take(a, PREV_S[:, 0], 1) + g_in[0][t],
                       np.take(a, PREV_S[:, 1], 1) + g_in[1][t])
    ext = np.empty((n, length))
    b = b0
    for t in range(length - 1, -1, -1):
        m0 = np.take(b, NXT[:, 0], 1) + g_out[0][t]
        m1 = np.take(b, NXT[:, 1], 1) + g_out[1][t]
        ext[:, t] = (alphas[t] + m0).max(-1) - (alphas[t] + m1).max(-1) - lin[:, t]
        b = np.maximum(m0, m1)
    return ext, a - a.max(-1, keepdims=True), b - b.max(-1, keepdims=True)


def _tail_beta(ts, tp):
    """The beta at step K from the three termination steps' LLRs [n, 3],
    ending in state 0."""
    b = np.full((ts.shape[0], 8), -np.inf)
    b[:, 0] = 0.0
    for i in (2, 1, 0):
        b = (b[:, NXT] + _gamma(ts[:, i], tp[:, i])).max(-1)
        b = b - b.max(-1, keepdims=True)
    return b


def _half(lin, lp, alast, bfirst, tail_b, lw):
    """One constituent decoder over K/lw windows of each block: window 0
    starts in state 0, window w at the alpha window w - 1 ended with in the
    last iteration; the last window ends at the tail's beta, window w at the
    beta window w + 1 began with (zeros before the first iteration)."""
    n, k = lin.shape
    w = k // lw
    start = np.full((n, 1, 8), -np.inf)
    start[:, :, 0] = 0.0
    a0 = np.concatenate([start, alast[:, :-1]], 1)
    b0 = np.concatenate([bfirst[:, 1:], tail_b[:, None]], 1)
    ext, al, bf = _bcjr(lin.reshape(n * w, lw), lp.reshape(n * w, lw),
                        a0.reshape(n * w, 8), b0.reshape(n * w, 8))
    return ext.reshape(n, k), al.reshape(n, w, 8), bf.reshape(n, w, 8)


def turbo_decode(buf, k, n_iters, forced, block_ok, q=exact):
    """Softbuffers [n, 3(K+4)] -> (hard [n, K] uint8, iterations [n], CRC
    passed [n]). Each iteration runs decoder 1 on the natural order and
    decoder 2 on the QPP order, each handing the other its extrinsic; the
    decision is the sign of systematic + both extrinsics. Forced: every
    iteration, the CRC once at the end. Otherwise a block stops, and keeps
    its bits, at the iteration whose bits pass ``block_ok``."""
    n = buf.shape[0]
    d = buf.reshape(n, 3, k + 4)
    sys, p1, p2 = d[:, 0, :k], d[:, 1, :k], d[:, 2, :k]
    t = d[:, :, k:]
    # 36.212 5.1.3.2.2: the tails of both encoders across the three streams
    bt1 = _tail_beta(np.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], 1),
                     np.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], 1))
    bt2 = _tail_beta(np.stack([t[:, 0, 2], t[:, 2, 2], t[:, 1, 3]], 1),
                     np.stack([t[:, 1, 2], t[:, 0, 3], t[:, 2, 3]], 1))
    f1, f2 = turbo.QPP_TABLE[k]
    i = np.arange(k)
    perm = (f1 * i + f2 * i * i) % k
    inv = np.argsort(perm)
    lw = window_len(k)
    w = k // lw
    al1, bf1, al2, bf2 = (np.zeros((n, w, 8)) for _ in range(4))
    le21 = np.zeros((n, k))
    hard = np.zeros((n, k), np.uint8)
    iters = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    for _ in range(n_iters):
        rows = np.arange(n) if forced else np.nonzero(~done)[0]
        if rows.size == 0:
            break
        e1, al1[rows], bf1[rows] = _half(sys[rows] + le21[rows], p1[rows], al1[rows],
                                         bf1[rows], bt1[rows], lw)
        e1 = q(e1)
        e2, al2[rows], bf2[rows] = _half(sys[rows][:, perm] + e1[:, perm], p2[rows],
                                         al2[rows], bf2[rows], bt2[rows], lw)
        le21[rows] = q(e2)[:, inv]
        hard[rows] = (sys[rows] + e1 + le21[rows] < 0).astype(np.uint8)
        iters[rows] += 1
        if not forced:
            done[rows] = [block_ok(hard[r]) for r in rows]
    ok = np.array([block_ok(h) for h in hard], bool)
    return hard, iters, ok


# ---------------------------------------------------------------- control
def viterbi(soft: np.ndarray) -> np.ndarray:
    """Tail-biting decode of [n, 3, m] LLRs (> 0 for bit 0) of the code of
    36.212 5.1.3.1 (generators 133, 171, 165 octal, tap i of G on c_{k-i}
    where bit 6 - i of G is set) -> [n, m] bits. The port's circular
    Viterbi: two passes over the sequence from zero metrics, a state's
    better predecessor kept (the first on a tie), the best state at the end
    of the second pass traced back through that pass's choices. A state
    holds (c_{k-1}, ..., c_{k-6}), c_{k-1} in bit 0."""
    n, _, m = soft.shape
    s = np.arange(64)
    taps = [[i for i in range(7) if g >> (6 - i) & 1] for g in (0o133, 0o171, 0o165)]
    out_sign = np.empty((64, 2, 3))  # [state before, input, stream]: 1 - 2 * bit
    for c in (0, 1):
        hist = np.stack([np.full(64, c)] + [s >> (i - 1) & 1 for i in range(1, 7)], 1)
        for j, tj in enumerate(taps):
            out_sign[:, c, j] = 1 - 2 * (np.sum(hist[:, tj], 1) & 1)
    nxt_in = s & 1                     # the input that led into state s
    pred = np.stack([s >> 1, s >> 1 | 32], 1)  # its two predecessors
    pm = np.zeros((n, 64))
    took = np.empty((m, n, 64), bool)
    for step in range(2 * m):
        k = step % m
        bm = np.einsum("nj,scj->nsc", soft[:, :, k], out_sign)
        c0 = pm[:, pred[:, 0]] + bm[:, pred[:, 0], nxt_in]
        c1 = pm[:, pred[:, 1]] + bm[:, pred[:, 1], nxt_in]
        take = c1 > c0
        pm = np.where(take, c1, c0)
        if step >= m:
            took[k] = take
    state = pm.argmax(-1)
    bits = np.empty((n, m), np.uint8)
    rows = np.arange(n)
    for k in range(m - 1, -1, -1):
        bits[:, k] = state & 1
        state = np.where(took[k][rows, state], state >> 1 | 32, state >> 1)
    return bits


def hit(fmt: str, d) -> tuple:
    """A blind-search hit as plain values: the format, the DCI's kind and
    its fields."""
    return (fmt, type(d).__name__, tuple(int(v) for v in dataclasses.astuple(d)))


@dataclasses.dataclass
class Decoded:
    """What the reference works out for a batch of subframes (host arrays)."""

    payload: np.ndarray               # [n, tbs] uint8
    tb_ok: np.ndarray                 # [n] bool
    iters: np.ndarray                 # [n, C] turbo iterations
    softbuf: list | None = None       # per K-group [n, count, 3(K+4)]
    cfi: int | None = None            # the first subframe's CFI
    hits: list | None = None          # per subframe [hit(format, DCI)]
    metrics: dict | None = None       # per subframe rssi, rsrp, noise, ...


class Receiver:
    """The plain receive chains of one configuration (a dict as in
    ``configs/<name>.json``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.cell: Cell = cell_of(cfg)
        self.sf, self.rnti = cfg["subframe"], cfg["rnti"]
        self.n_iters = cfg["turbo_iters"]

    def _front(self, iq, q):
        """(grid, the estimate of every port, port 0's noise and RSRP)."""
        grid = q(ofdm_demod(self.cell, iq))
        est = [channel(self.cell, grid, self.sf, p) for p in range(self.cell.n_ports)]
        return grid, [q(h) for h, _, _ in est], q(est[0][1]), q(est[0][2])

    @staticmethod
    def _equalize(grid, hs, noise, res, q):
        """(symbols, noise) at the flat REs `res` (whole REG quadruplets or
        PDSCH pairs where two ports send)."""
        def at(g):
            return g.reshape(g.shape[0], -1)[:, res]

        x, nv = (sfbc(at(grid), at(hs[0]), at(hs[1]), noise) if len(hs) == 2
                 else zf(at(grid), at(hs[0]), noise))
        return q(x), q(nv)

    def _pdsch(self, grid, hs, noise, pmap: PdschMap, forced: bool, q) -> Decoded:
        x, nv = self._equalize(grid, hs, noise, pmap.re_idx, q)
        llr = demap(x, nv, pmap.qm) * (1.0 - 2.0 * pmap.scr_bits)
        plan, n = pmap.plan, grid.shape[0]
        bufs, e0 = [], 0
        for i, k in enumerate(plan.block_ks):
            e1 = e0 + len(pmap.rm_idx[i])
            b = dematch(llr[:, e0:e1], pmap.rm_idx[i], 3 * (k + 4))
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
            h, it, ok = turbo_decode(g.reshape(n * count, -1), k, self.n_iters, forced,
                                     block_ok, q)
            hard += list(h.reshape(n, count, k).transpose(1, 0, 2))
            its += list(it.reshape(n, count).T)
            oks += list(ok.reshape(n, count).T)
            soft.append(g)
            b += count
        tb = []
        for r in range(n):  # 36.212 5.1.2: desegmentation, then the TB's CRC24A
            parts = [hard[i][r, (plan.f if i == 0 else 0):(k if plan.c == 1 else k - 24)]
                     for i, k in enumerate(plan.block_ks)]
            tb.append(np.concatenate(parts))
        tb = np.array(tb)
        tb_ok = np.array([all(o[r] for o in oks) and crc.check(tb[r], "24A") for r in range(n)])
        return Decoded(tb[:, :pmap.grant.tbs].astype(np.uint8), tb_ok, np.stack(its, 1),
                       softbuf=soft)

    def grant_known(self, iq, forced: bool, q=exact) -> Decoded:
        """iq [n, sf_len] -> the chain of ``entry.chain`` at the configured
        grant and CFI."""
        cfg = self.cfg
        grid, hs, noise, _ = self._front(iq, q)
        pmap = PdschMap(self.cell, ra.dl_grant(self.cell.n_prb, cfg["mcs"]), self.rnti,
                        self.sf, cfg["cfi"])
        return self._pdsch(grid, hs, noise, pmap, forced, q)

    def _pcfich(self, eq) -> np.ndarray:
        """The CFI [n]: the 16 PCFICH symbols' descrambled QPSK LLRs
        correlated with the three codewords (36.212 5.3.4), the best kept."""
        x, nv = eq(control.pcfich_re(self.cell).astype(np.int64))
        llr = demap(x, nv, 2) * (1.0 - 2.0 * control.cfi_scramble(self.cell, self.sf))
        return (llr @ (1.0 - 2.0 * control.CFI_CW.T)).argmax(-1) + 1

    def _blind(self, eq, cfi: int, q) -> list:
        """Each subframe's DCI 0/1A found in the search space, in candidate
        order, one per distinct payload: a candidate's CCEs equalized, QPSK
        LLRs descrambled from its CCE offset, dematched, decoded, and kept
        where the CRC16 masked by the RNTI passes."""
        cell = self.cell
        n_cce, cce_re = control.pdcch_geometry(cell, cfi)
        n_bits = dci.size_0_1a(cell.n_prb)
        n_coded = n_bits + 16
        scr = 1.0 - 2.0 * control.pdcch_scramble(cell, self.sf, 72 * n_cce)
        found, seen = None, None
        for start, l in control.search_space_candidates(n_cce, self.rnti, self.sf):
            x, nv = eq(cce_re[start:start + l].reshape(-1).astype(np.int64))
            llr = demap(x, nv, 2) * scr[72 * start:72 * (start + l)]
            soft = q(dematch(llr, ratematch.conv_rm_indices(n_coded, 72 * l), 3 * n_coded))
            bits = viterbi(soft.reshape(-1, 3, n_coded))
            if found is None:
                found, seen = [[] for _ in bits], [set() for _ in bits]
            for r, b in enumerate(bits):
                if crc.check(b, "16", mask=self.rnti) and b[:n_bits].tobytes() not in seen[r]:
                    seen[r].add(b[:n_bits].tobytes())
                    found[r].append(dci.unpack_0_1a(cell.n_prb, b[:n_bits]))
        return found

    def ue_dl(self, iq, q=exact) -> Decoded:
        """iq [n, sf_len] -> the chain of ``UeDl.process(iq, subframe, rnti)``
        with its defaults: the first subframe's CFI rules the batch, and the
        grant found in it is decoded in every subframe."""
        cell = self.cell
        grid, hs, noise, rsrp = self._front(iq, q)
        metrics = {k: q(v) for k, v in cell_metrics(cell, grid, noise, rsrp).items()}

        def eq(res):
            return self._equalize(grid, hs, noise, res, q)

        cfi = int(self._pcfich(eq)[0])
        found = self._blind(eq, cfi, q)
        hits = [[hit("0_1a", d) for d in row] for row in found]
        grants = [dci.dci1a_to_grant(cell, d) for d in found[0] if isinstance(d, dci.Dci1A)]
        if not grants:
            raise ValueError("the reference found no DL grant in the first subframe")
        out = self._pdsch(grid, hs, noise,
                          PdschMap(cell, grants[0], self.rnti, self.sf, cfi), False, q)
        out.cfi, out.hits, out.metrics = cfi, hits, metrics
        return out

    def snr(self, iq, q=exact) -> np.ndarray:
        """RSRP over noise of port 0's estimate, linear, per subframe."""
        grid = q(ofdm_demod(self.cell, iq))
        _, noise, rsrp = channel(self.cell, grid, self.sf, 0)
        return q(rsrp) / np.maximum(q(noise), 1e-12)
