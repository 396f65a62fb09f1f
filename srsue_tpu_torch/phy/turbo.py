"""LTE turbo codec (36.212 5.1.3.2): rate-1/3 PCCC with QPP interleaver.

Counterpart of ``srsue_tpu/phy/turbo.py``. The host side (QPP and trellis
tables, and the encoder, vectorised over the block, of the UE's uplink and
of the test vectors) is carried over as numpy; the decoder is the batched
max-log-MAP iteration loop in torch around the windowed BCJR half-iteration
of ``kernels/bcjr.py``, replayed as CUDA graphs on a card.

LLR convention: positive = bit 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import graphs
from ..utils.trace import annotate

# --- QPP interleaver table: 36.212 Table 5.1.3-3 (K, f1, f2) ---------------
QPP_TABLE: dict[int, tuple[int, int]] = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16), 72: (7, 18),
    80: (11, 20), 88: (5, 22), 96: (11, 24), 104: (7, 26), 112: (41, 84),
    120: (103, 90), 128: (15, 32), 136: (9, 34), 144: (17, 108), 152: (9, 38),
    160: (21, 120), 168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56), 232: (85, 58),
    240: (29, 60), 248: (33, 62), 256: (15, 32), 264: (17, 198), 272: (33, 68),
    280: (103, 210), 288: (19, 36), 296: (19, 74), 304: (37, 76), 312: (19, 78),
    320: (21, 120), 328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48), 392: (243, 98),
    400: (151, 40), 408: (155, 102), 416: (25, 52), 424: (51, 106), 432: (47, 72),
    440: (91, 110), 448: (29, 168), 456: (29, 114), 464: (247, 58), 472: (29, 118),
    480: (89, 180), 488: (91, 122), 496: (157, 62), 504: (55, 84), 512: (31, 64),
    528: (17, 66), 544: (35, 68), 560: (227, 420), 576: (65, 96), 592: (19, 74),
    608: (37, 76), 624: (41, 234), 640: (39, 80), 656: (185, 82), 672: (43, 252),
    688: (21, 86), 704: (155, 44), 720: (79, 120), 736: (139, 92), 752: (23, 94),
    768: (217, 48), 784: (25, 98), 800: (17, 80), 816: (127, 102), 832: (25, 52),
    848: (239, 106), 864: (17, 48), 880: (137, 110), 896: (215, 112),
    912: (29, 114), 928: (15, 58), 944: (147, 118), 960: (29, 60), 976: (59, 122),
    992: (65, 124), 1008: (55, 84), 1024: (31, 64), 1056: (17, 66),
    1088: (171, 204), 1120: (67, 140), 1152: (35, 72), 1184: (19, 74),
    1216: (39, 76), 1248: (19, 78), 1280: (199, 240), 1312: (21, 82),
    1344: (211, 252), 1376: (21, 86), 1408: (43, 88), 1440: (149, 60),
    1472: (45, 92), 1504: (49, 846), 1536: (71, 48), 1568: (13, 28),
    1600: (17, 80), 1632: (25, 102), 1664: (183, 104), 1696: (55, 954),
    1728: (127, 96), 1760: (27, 110), 1792: (29, 112), 1824: (29, 114),
    1856: (57, 116), 1888: (45, 354), 1920: (31, 120), 1952: (59, 610),
    1984: (185, 124), 2016: (113, 420), 2048: (31, 64), 2112: (17, 66),
    2176: (171, 136), 2240: (209, 420), 2304: (253, 216), 2368: (367, 444),
    2432: (265, 456), 2496: (181, 468), 2560: (39, 80), 2624: (27, 164),
    2688: (127, 504), 2752: (143, 172), 2816: (43, 88), 2880: (29, 300),
    2944: (45, 92), 3008: (157, 188), 3072: (47, 96), 3136: (13, 28),
    3200: (111, 240), 3264: (443, 204), 3328: (51, 104), 3392: (51, 212),
    3456: (451, 192), 3520: (257, 220), 3584: (57, 336), 3648: (313, 228),
    3712: (271, 232), 3776: (179, 236), 3840: (331, 120), 3904: (363, 244),
    3968: (375, 248), 4032: (127, 168), 4096: (31, 64), 4160: (33, 130),
    4224: (43, 264), 4288: (33, 134), 4352: (477, 408), 4416: (35, 138),
    4480: (233, 280), 4544: (357, 142), 4608: (337, 480), 4672: (37, 146),
    4736: (71, 444), 4800: (71, 120), 4864: (37, 152), 4928: (39, 462),
    4992: (127, 234), 5056: (39, 158), 5120: (39, 80), 5184: (31, 96),
    5248: (113, 902), 5312: (41, 166), 5376: (251, 336), 5440: (43, 170),
    5504: (21, 86), 5568: (43, 174), 5632: (45, 176), 5696: (45, 178),
    5760: (161, 120), 5824: (89, 182), 5888: (323, 184), 5952: (47, 186),
    6016: (23, 94), 6080: (47, 190), 6144: (263, 480),
}

VALID_K = np.array(sorted(QPP_TABLE), dtype=np.int64)


@functools.lru_cache(maxsize=256)
def qpp_perm(k: int) -> np.ndarray:
    """pi(i) = (f1*i + f2*i^2) mod K. x'_i = x_{pi(i)} feeds encoder 2."""
    f1, f2 = QPP_TABLE[k]
    i = np.arange(k, dtype=np.int64)
    return (f1 * i + f2 * i * i) % k


@functools.lru_cache(maxsize=256)
def qpp_inv(k: int) -> np.ndarray:
    p = qpp_perm(k)
    inv = np.empty_like(p)
    inv[p] = np.arange(k)
    return inv


@functools.lru_cache(maxsize=1)
def _trellis():
    """(next_state[8,2], parity[8,2], term_u[8]) of the constituent RSC.

    State bits (r1, r2, r3) with r1 newest; feedback g0 = 1 + D^2 + D^3
    (f = r2 ^ r3), register input a = u ^ f, parity g1 = 1 + D + D^3
    (p = a ^ r1 ^ r3), next state (a, r1, r2)."""
    ns = np.zeros((8, 2), np.int32)
    par = np.zeros((8, 2), np.int32)
    term_u = np.zeros(8, np.int32)
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        f = r2 ^ r3
        term_u[s] = f
        for u in (0, 1):
            a = u ^ f
            ns[s, u] = (a << 2) | (r1 << 1) | r2
            par[s, u] = a ^ r1 ^ r3
    return ns, par, term_u


@functools.lru_cache(maxsize=1)
def _prev_tables():
    """(prev_state[8,2], prev_input[8,2]): the two (state, input) pairs
    entering each state."""
    ns, _, _ = _trellis()
    prev = np.zeros((8, 2, 2), np.int32)
    cnt = [0] * 8
    for s in range(8):
        for u in (0, 1):
            n = ns[s, u]
            prev[n, cnt[n]] = (s, u)
            cnt[n] += 1
    return prev[:, :, 0], prev[:, :, 1]


@functools.lru_cache(maxsize=1)
def radix4_tables():
    """Two-step (radix-4) trellis tables, the counterpart of
    ``turbo_pallas._radix4_tables``.

    The branch metric of a two-step path (sp, u1, u2) is sign * (A_x +- B_y)
    with A = (gpp_t, gpm_t), B = (gpp_t+1, gpm_t+1): key (x, y, d) names the
    base (d = 0: A_x + B_y, d = 1: A_x - B_y) and sign = 1 - 2*u1.

    Returns (fwd, paths): fwd[s2] lists the 4 (sp, key, sign) two-step
    predecessors of s2; paths lists all 32 (sp, s2, key, sign, u1, u2)."""
    ns, par, _ = _trellis()
    paths = []
    fwd = [[] for _ in range(8)]
    for sp in range(8):
        for u1 in (0, 1):
            sm = int(ns[sp, u1])
            for u2 in (0, 1):
                s2 = int(ns[sm, u2])
                key = (int(par[sp, u1] != u1), int(par[sm, u2] != u2), int(u1 != u2))
                sign = 1 - 2 * u1
                paths.append((sp, s2, key, sign, u1, u2))
                fwd[s2].append((sp, key, sign))
    return fwd, tuple(paths)


_IMPULSE_PERIOD = 7  # 1/(1 + D^2 + D^3): primitive, impulse response 1011100 repeating
_IMPULSE_TAPS = (0, 2, 3, 4)  # the delays (mod 7) where that response is 1


def _rsc_encode(bits: np.ndarray):
    """RSCs over the rows of [n, K] bits, vectorised over the whole block:
    (parity [n, K], tail_sys [n, 3], tail_par [n, 3]).

    The register input a_t = u_t ^ a_{t-2} ^ a_{t-3} is u filtered by
    1/(1 + D^2 + D^3), whose impulse response has period 7 and is 1 at the
    delays 0, 2, 3, 4 (mod 7). With Q the XOR prefix of u within each
    residue class mod 7 (Q_t = u_t ^ Q_{t-7}), a_t = Q_t ^ Q_{t-2} ^ Q_{t-3}
    ^ Q_{t-4}; the parity is p_t = a_t ^ a_{t-1} ^ a_{t-3} and the state after
    K bits is (a_{K-1}, a_{K-2}, a_{K-3})."""
    n, k = bits.shape
    m = -(-k // _IMPULSE_PERIOD)
    u = np.zeros((n, m * _IMPULSE_PERIOD), np.uint8)
    u[:, :k] = bits
    q = np.bitwise_xor.accumulate(u.reshape(n, m, _IMPULSE_PERIOD), axis=1).reshape(n, -1)
    pad = 4  # a zero history before t = 0
    qp = np.concatenate([np.zeros((n, pad), np.uint8), q[:, :k]], axis=1)
    a = np.zeros((n, pad + k), np.uint8)
    for d in _IMPULSE_TAPS:
        a[:, pad:] ^= qp[:, pad - d:pad - d + k]
    p = a[:, pad:] ^ a[:, pad - 1:pad - 1 + k] ^ a[:, pad - 3:pad - 3 + k]
    # trellis termination: 3 steps from the final state, input = feedback
    ns, par, term_u = _trellis()
    s = (a[:, pad + k - 1].astype(np.int64) << 2) | (a[:, pad + k - 2] << 1) | a[:, pad + k - 3]
    tail_sys = np.empty((n, 3), np.uint8)
    tail_par = np.empty((n, 3), np.uint8)
    for i in range(3):
        uu = term_u[s]
        tail_sys[:, i] = uu
        tail_par[:, i] = par[s, uu]
        s = ns[s, uu]
    assert not s.any()
    return p, tail_sys, tail_par


def encode(bits: np.ndarray) -> np.ndarray:
    """Turbo-encode one code block (host): [K] {0,1} -> d streams [3, K+4]
    with the tail multiplexing of 36.212 5.1.3.2.2."""
    b = np.asarray(bits, np.uint8).ravel()
    k = len(b)
    if k not in QPP_TABLE:
        raise ValueError(f"invalid turbo K={k}")
    (z1, z2), (t1x, t2x), (t1z, t2z) = _rsc_encode(np.stack([b, b[qpp_perm(k)]]))
    d = np.zeros((3, k + 4), np.uint8)
    d[0, :k], d[1, :k], d[2, :k] = b, z1, z2
    d[:, k + 0] = t1x[0], t1z[0], t1x[1]
    d[:, k + 1] = t1z[1], t1x[2], t1z[2]
    d[:, k + 2] = t2x[0], t2z[0], t2x[1]
    d[:, k + 3] = t2z[1], t2x[2], t2z[2]
    return d


# ---------------------------------------------------------------------------
# Max-log-MAP decoder
# ---------------------------------------------------------------------------

NEG = -1e9  # metric of an impossible state


@functools.lru_cache(maxsize=16)
def trellis_tensors(device: torch.device):
    """(next_state [8,2] long, u_sign [2], p_sign [8,2]) on `device`: the
    branch metric of (s, u) is 0.5*lin*u_sign[u] + 0.5*par*p_sign[s, u]."""
    ns, par, _ = _trellis()
    return (torch.as_tensor(ns, dtype=torch.long, device=device),
            torch.tensor([1.0, -1.0], device=device),
            torch.as_tensor(1.0 - 2.0 * par.astype(np.float32), device=device))


@functools.lru_cache(maxsize=64)
def qpp_tensors(k: int, device: torch.device):
    """(perm, inv) of the QPP interleaver on `device`."""
    return (torch.as_tensor(qpp_perm(k), device=device),
            torch.as_tensor(qpp_inv(k), device=device))


def tail_beta(tail_sys: torch.Tensor, tail_par: torch.Tensor) -> torch.Tensor:
    """Fold the 3 termination steps into the beta at step K: [B, 3] tail
    LLRs -> [B, 8]."""
    ns, u_sign, p_sign = trellis_tensors(tail_sys.device)
    beta = torch.full((tail_sys.shape[0], 8), NEG, device=tail_sys.device)
    beta[:, 0] = 0.0
    for i in range(2, -1, -1):
        g = (0.5 * tail_sys[:, i, None, None] * u_sign
             + 0.5 * tail_par[:, i, None, None] * p_sign)
        beta = (beta[:, ns] + g).amax(-1)
        beta = beta - beta.amax(-1, keepdim=True)
    return beta


def pick_window(k: int, target: int = 64) -> int | None:
    """A window length that divides K, or None for small blocks, which are
    decoded as one window (the same rule as the reference)."""
    if k <= 256:
        return None
    for lw in (target, 96, 128, 48, 32, 192, 256):
        if k % lw == 0 and k // lw >= 2:
            return lw
    return None


def crc_ok(hard: torch.Tensor, crc_m: torch.Tensor) -> torch.Tensor:
    """GF(2) syndrome check of [N, K] hard bits against a [K, L] float32
    matrix: an exact float32 product (sums stay far below 2^24; TF32 must
    be off, see utils/device.py)."""
    syn = torch.remainder(torch.round(hard.to(torch.float32) @ crc_m), 2.0)
    return syn.sum(-1) == 0


def _streams(d_llrs: torch.Tensor, k: int):
    """(sys1, par1, par2 [B, K], tails (sys1, par1, sys2, par2) [B, 3]): the
    tail demultiplexing of 36.212 5.1.3.2.2, inverse of ``encode``."""
    sys1 = d_llrs[:, 0, :k].contiguous()
    par1 = d_llrs[:, 1, :k].contiguous()
    par2 = d_llrs[:, 2, :k].contiguous()
    t = d_llrs[:, :, k:k + 4]
    tails = (torch.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], 1),
             torch.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], 1),
             torch.stack([t[:, 0, 2], t[:, 2, 2], t[:, 1, 3]], 1),
             torch.stack([t[:, 1, 2], t[:, 0, 3], t[:, 2, 3]], 1))
    return sys1, par1, par2, tails


def _window(k: int, window: int | None) -> int:
    lw = window or pick_window(k) or k
    if k % lw:
        raise ValueError(f"window {lw} must divide K={k}")
    return lw


def _prepare(d_llrs: torch.Tensor, k: int, kernel: str, window: int | None):
    """Window length and the LLRs the decoder works on. The bfloat16 kernel
    (v5) gets them rescaled to an RMS of 32, as ``turbo_pallas.decode``
    does: max-log BCJR is scale-invariant, so decisions do not change, and
    bf16's 8-bit mantissa then quantises at ~0.4% of a working LLR."""
    lw = _window(k, window)
    if kernel == "v5":
        rms = torch.sqrt(torch.mean(torch.square(d_llrs.to(torch.float32))) + 1e-9)
        d_llrs = d_llrs * (32.0 / rms)
    return lw, d_llrs


def _crc_of(crc_mat, device):
    return None if crc_mat is None else torch.as_tensor(
        np.asarray(crc_mat, np.float32) if isinstance(crc_mat, np.ndarray) else crc_mat,
        dtype=torch.float32, device=device)


def _ok_of(hard: torch.Tensor, crc_m: torch.Tensor | None) -> torch.Tensor:
    """CRC flags of [B, K] hard bits; all False without a CRC matrix."""
    if crc_m is None:
        return torch.zeros(hard.shape[0], dtype=torch.bool, device=hard.device)
    return crc_ok(hard, crc_m)


class _Loop:
    """The masked loop of ``decode`` at one input shape. ``prep`` makes its
    state from the softbuffers: the streams, the two tail betas (the tail
    LLRs do not change in a decode, so they are computed once, as
    ``decode_forced`` does) and the zeroed flags, decisions and window
    boundaries. ``iterate`` runs one masked iteration and writes every
    update into that state in place, so that a CUDA graph of it replays
    iteration i + 1 on what replay i left. The same two methods run eagerly
    and under capture (``_Graphed``)."""

    def __init__(self, k: int, lw: int, kernel: str, device: torch.device):
        self.k, self.lw, self.kernel = k, lw, kernel
        self.perm, self.inv = qpp_tensors(k, device)

    def prep(self, d_llrs: torch.Tensor, crc_m: torch.Tensor | None) -> None:
        k, B, dev = self.k, d_llrs.shape[0], d_llrs.device
        _, d_llrs = _prepare(d_llrs, k, self.kernel, self.lw)
        self.sys1, self.par1, self.par2, (t1s, t1p, t2s, t2p) = _streams(d_llrs, k)
        self.sys2 = self.sys1[:, self.perm]
        self.bt1, self.bt2 = tail_beta(t1s, t1p), tail_beta(t2s, t2p)
        self.crc = crc_m
        self.le21 = torch.zeros(B, k, device=dev)
        self.done = torch.zeros(B, dtype=torch.bool, device=dev)
        self.iters = torch.zeros(B, dtype=torch.int32, device=dev)
        self.hard = torch.zeros(B, k, dtype=torch.uint8, device=dev)
        self.bounds = [torch.zeros(B, k // self.lw, 8, device=dev) for _ in range(4)]

    def iterate(self) -> None:
        from ..kernels.bcjr import bcjr_half_windowed_tb as half

        ab1, bb1, ab2, bb2 = self.bounds
        le12, ab1n, bb1n = half(self.sys1, self.par1, self.le21, self.bt1, ab1, bb1, self.lw,
                                self.kernel)
        le21_raw, ab2n, bb2n = half(self.sys2, self.par2, le12[:, self.perm], self.bt2, ab2,
                                    bb2, self.lw, self.kernel)
        le21_new = le21_raw[:, self.inv]
        hard_new = (self.sys1 + le12 + le21_new < 0).to(torch.uint8)
        ok = _ok_of(hard_new, self.crc)
        m = self.done[:, None]
        m3 = self.done[:, None, None]
        torch.where(m, self.le21, le21_new, out=self.le21)
        torch.where(m, self.hard, hard_new, out=self.hard)
        for old, new in zip(self.bounds, (ab1n, bb1n, ab2n, bb2n)):
            torch.where(m3, old, new, out=old)
        self.iters += (~self.done).to(torch.int32)
        self.done |= ok


class _Graphed:
    """A ``_Loop`` captured as two CUDA graphs at one input shape: ``prep``
    copies the softbuffers and the CRC matrix into static inputs and replays
    the prep graph; ``iterate`` replays one iteration. Nothing in either
    body synchronises with the host. The kernels' counters grow at each
    replay by the launches its capture listed; ``bytes`` is the device
    memory the shape's static inputs and state hold."""

    def __init__(self, d_llrs, crc_m, k: int, lw: int, kernel: str, pool, stream):
        from ..kernels import build

        dev = self.device = d_llrs.device
        build.load()
        trellis_tensors(dev)  # cached before capture: a miss would copy from the host
        before = torch.cuda.memory_allocated(dev)
        self.d_in = torch.empty(d_llrs.shape, dtype=d_llrs.dtype, device=dev)
        self.crc = None if crc_m is None else torch.empty_like(crc_m)
        self.loop = _Loop(k, lw, kernel, dev)
        self.prep_g, self.iter_g = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with annotate("turbo.graph_capture"), torch.cuda.device(dev):
            self.prep_calls = graphs.capture(self.prep_g, pool, stream,
                                             lambda: self.loop.prep(self.d_in, self.crc))
            self.iter_calls = graphs.capture(self.iter_g, pool, stream, self.loop.iterate)
        self.bytes = torch.cuda.memory_allocated(dev) - before

    def prep(self, d_llrs: torch.Tensor, crc_m: torch.Tensor | None) -> None:
        self.d_in.copy_(d_llrs)
        if crc_m is not None:
            self.crc.copy_(crc_m)
        graphs.replay(self.prep_g, self.prep_calls)

    def iterate(self) -> None:
        graphs.replay(self.iter_g, self.iter_calls)


def decode(d_llrs: torch.Tensor, k: int, n_iters: int = 8,
           crc_mat: np.ndarray | torch.Tensor | None = None,
           early_exit: bool = True, kernel: str = "r2max", window: int | None = None):
    """Batched turbo decode, the counterpart of ``turbo.decode`` and of the
    masked paths of ``turbo_pallas.decode``.

    d_llrs: [B, 3, K+4] float32 rate-dematched LLRs.
    Returns (hard [B, K] uint8, iters [B] int32, crc_ok [B] bool).

    Blocks that pass the CRC (``crc_mat`` [K, 24] over the whole block)
    are frozen by masks, so iterations after convergence change nothing,
    and ``iters`` counts each block's iterations up to its convergence.
    ``early_exit`` stops the loop once every block has passed, at the cost
    of one host synchronisation after each iteration but the last; without
    it all ``n_iters`` masked iterations run with no synchronisation. Both
    give the same results. ``kernel`` is the half-iteration instance
    (``kernels.bcjr.KERNELS``); ``window`` the window length, by default
    ``pick_window(k)``, and blocks with no window run as one window of
    length K.

    On a card, an input shape that comes back among the last few shapes
    decoded has its loop captured and then replayed as CUDA graphs
    (``utils.graphs.GraphCache``): the same work, the same results bit for
    bit, without the host dispatching each of its operations.
    """
    dev = d_llrs.device
    lw = _window(k, window)
    crc_m = _crc_of(crc_mat, dev)
    graphed = None
    if dev.type == "cuda" and n_iters > 0:
        # everything the captured loop depends on; n_iters and early_exit
        # only steer the replays
        key = (dev, tuple(d_llrs.shape), d_llrs.dtype, k, lw, kernel,
               None if crc_m is None else tuple(crc_m.shape))
        graphed = graphs.GRAPHS.get(key, dev, lambda pool, stream: _Graphed(
            d_llrs, crc_m, k, lw, kernel, pool, stream))
    if graphed is None:
        loop = _Loop(k, lw, kernel, dev)
        loop.prep(d_llrs, crc_m)
        step = loop.iterate
    else:
        loop = graphed.loop
        graphed.prep(d_llrs, crc_m)
        step = graphed.iterate
    stop_early = early_exit and crc_m is not None
    for i in range(n_iters):
        if stop_early and i:  # done starts all False: nothing to check before the first
            with annotate("turbo.exit_check"):
                stop = bool(loop.done.all())
            if stop:
                break
        with annotate("turbo.iteration"):
            step()
    if graphed is None:
        return loop.hard, loop.iters, _ok_of(loop.hard, crc_m) | loop.done
    # After an iteration, _ok_of(hard) | done is done: a block that was not
    # done holds the last iteration's decision, whose CRC flag that
    # iteration or-ed into done. Cloned: the next decode at this shape
    # rewrites the static state.
    return loop.hard.clone(), loop.iters.clone(), loop.done.clone()


def decode_forced(d_llrs: torch.Tensor, k: int, n_iters: int = 8,
                  crc_mat: np.ndarray | torch.Tensor | None = None,
                  kernel: str = "r2max", window: int | None = None):
    """Forced-iteration turbo decode, the counterpart of the forced forms of
    ``turbo_pallas``: ``decode(early_exit=False)`` (window-linear, unrolled
    or ``fori_loop``), ``decode_forced_bm``, ``decode_forced_tiled`` and
    ``decode_forced_loop_tiled``. Their contract: every block runs all
    ``n_iters`` iterations with no per-iteration CRC and no freezing of
    converged blocks; the hard decision and the CRC come once, at the end,
    and ``iters`` is ``n_iters`` for every block.

    Each half is ``kernels.bcjr.bcjr_half_fused``: on CUDA with the default
    kernel one launch that gathers its a-priori input through the QPP
    interleaver and injects its window boundaries itself, so the loop
    holds no glue. The extrinsics and boundaries are double-buffered (every
    half writes new tensors). Same arguments and results as ``decode``.
    """
    from ..kernels.bcjr import bcjr_half_fused

    dev = d_llrs.device
    B = d_llrs.shape[0]
    lw, d_llrs = _prepare(d_llrs, k, kernel, window)
    W = k // lw
    perm, inv = qpp_tensors(k, dev)
    perm32, inv32 = perm.to(torch.int32), inv.to(torch.int32)
    sys1, par1, par2, (t1s, t1p, t2s, t2p) = _streams(d_llrs, k)
    sys2 = sys1[:, perm]
    bt1, bt2 = tail_beta(t1s, t1p), tail_beta(t2s, t2p)

    le12 = le21_raw = torch.zeros(B, k, device=dev)
    al1 = bf1 = al2 = bf2 = torch.zeros(B, W, 8, device=dev)
    for _ in range(n_iters):
        with annotate("turbo.iteration"):
            le12, al1, bf1 = bcjr_half_fused(sys1, par1, le21_raw, inv32, al1, bf1, bt1, lw,
                                             kernel)
            le21_raw, al2, bf2 = bcjr_half_fused(sys2, par2, le12, perm32, al2, bf2, bt2, lw,
                                                 kernel)
    hard = (sys1 + le12 + le21_raw[:, inv] < 0).to(torch.uint8)
    iters = torch.full((B,), n_iters, dtype=torch.int32, device=dev)
    return hard, iters, _ok_of(hard, _crc_of(crc_mat, dev))
