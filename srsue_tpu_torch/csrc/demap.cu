// Max-log soft demap, descramble and rate dematch in one pass, hand-written
// for Hopper (sm_90a).
//
// Replaces srsue_tpu/phy/modulation.py::demodulate_soft (:109) and
// srsue_tpu/phy/ratematch.py::dematch (:144) as the reference's receivers
// compose them (pdsch.py, pusch.py, control.py's blind search): XLA lowered
// and fused them on the TPU; neither is a Pallas kernel. The plain PyTorch
// version is phy/ratematch.py::demap_dematch_plain (the softbuffer form)
// and phy/modulation.py::demodulate_soft_plain (the LLR form).
//
// The softbuffer form. Inputs: symbols sym [N, S] complex64, the noise nv
// (per RE at nv[n * nv_sn + s * nv_ss], or one value), the modulation order
// qm in {2, 4, 6} with its per-axis PAM levels, the scrambling factors scr
// [E] (+-1, 0 where a bit is erased), an optional symbol map [E / qm] into
// S, a slice [lo, lo + n_e) of E and the inverse index inv [D, R]
// (ratematch.inverse_index of the slice: each row ascending, padded with
// n_e). Output buf [N, D]: position p of row n is
//   0.0 + t(lo + inv[p, 0]) + t(lo + inv[p, 1]) + ...
// in that order, one rounding per add, up to the first pad (+0.0 where
// nothing was sent); t(e) = llr(e) * scr[e], llr(e) the max-log LLR of bit
// e % qm of symbol e / qm (through the map):
//   d2     = (x - level)^2                       per level of the bit's axis
//   m1, m0 = min(1e30, min d2 over the levels whose bit is 1 / 0)
//   llr    = (m1 - m0) / max(nv, 1e-9)
// Bits 0, 2, 4 of a symbol are on the I axis and 1, 3, 5 on Q; bit 2k is
// the axis's bit k, and a level's bits are its index in binary, MSB first.
// Every operation is the plain version's, in its order and rounded once
// through the _rn intrinsics (no contraction into a multiply-add, a true
// IEEE divide), and a NaN coordinate gives a NaN as torch's amin does (all
// d2 of an axis are >= +0 or all NaN, so the minimum does not depend on
// the order of the levels), so the kernel gives the plain version's bits.
// The first add, 0.0 + t, turns a -0.0 into +0.0 as the plain version's
// padded copy does.
//
// The LLR form: sym [N, S] -> out [N, S * qm], the same llr with no scr,
// in transmit bit order (what demodulate_soft returns).
//
// What bounds it: bytes. At the flagship (PDSCH 64QAM, N = 256 subframes of
// 15,000 REs into 227,292 positions of 13 code blocks) the call must move
// ~280 MB: 30.7 MB of symbols, 15.4 MB of noise, 232.7 MB of softbuffer;
// 0.0836 ms at 3.35 TB/s.
//
// Where the earlier design lost its time (demap_dematch_gather_kernel, kept
// below for the benchmark): one thread per output value, each gathering
// its symbol, noise and scr through L2. Neighbouring positions of a turbo
// softbuffer come from bits the sub-block interleaver put 183-366 apart,
// so each lane of a warp touched its own 32-B sector in every gather
// (~96 B of sector traffic per 4-B value written), and each 64QAM symbol
// was fetched and searched again by the six threads of its six bits: 5.4x
// its bound.
//
// The design (demap_dematch_tile_kernel): a CTA owns a row (or a few) and
// one tile of consecutive positions, a whole number of the caller's
// segments (a code block's 3(K+4) positions, or the blind search's
// candidate buffers), which draws on one contiguous range of bits. It
//   1. takes that range [e_min, e_max] from the caller's per-segment range
//      table (ratematch.segment_ranges, built beside its inverse index);
//   2. stages t(e) of every bit of the range into shared memory: one thread
//      per symbol, coalesced loads of the symbol, its noise, scr and the
//      map, the axis distances computed once for the symbol's qm bits;
//   3. fills the tile's positions with stride blockDim.x (coalesced reads of
//      inv, coalesced writes of out), each summing its t from shared memory
//      in the order above. A warp's 32 neighbouring positions of a turbo
//      softbuffer read bits the sub-block interleaver put R_sb apart (183 at
//      K=5824: odd, so 32 different banks); four neighbours a thread (int4
//      and float4) measured slower for that reason.
// Where the rows and tiles leave many CTAs for each SM (the flagship), a CTA
// takes up to 4 rows of its tile, so that one read of an inv entry or a
// scrambling factor serves them all. Where they would leave SMs idle (B=1:
// the UE's grants, cold start), a tile is staged by a cluster of up to 8
// CTAs: each stages an equal share of the range into its own shared memory
// and fills its share of the positions, reading t from the shared memory
// of the CTA that staged it (distributed shared memory). A range larger
// than the shared memory is staged in ascending chunks; a position's sum
// carries from chunk to chunk through out, and since inv rows ascend, the
// adds keep their order and the bits. Each launch's tile, cluster size,
// rows and threads come from kernels/demap.py::plan.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGatherThreads = 256;
constexpr int kLlrThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr long long kMaxRows = 65535;  // gridDim.y

struct Noise {
  const float* p;  // null: one value for every RE
  long long sn, ss;
  float value;
};

// min that keeps a NaN, as torch's amin (the gather variant's)
__device__ __forceinline__ float min_nan(float acc, float d2) {
  return (d2 < acc || d2 != d2) ? d2 : acc;
}

// the clamped noise of symbol s of row n
__device__ __forceinline__ float noise_at(Noise nv, long long n, long long s) {
  const float v = nv.p ? __ldg(nv.p + n * nv.sn + s * nv.ss) : nv.value;
  return v < 1e-9f ? 1e-9f : v;  // clamp_min: a NaN stays NaN
}

// The max-log LLRs of the QM bits of symbol y with clamped noise v, in
// transmit bit order; lv holds the axis's 2^(QM/2) levels. An axis's d2
// are all >= +0 or, where its coordinate x is NaN, all NaN: the minima are
// fminf's (one instruction each) and a NaN x gives the NaN that the plain
// version's NaN minima give, x - x.
template <int QM>
__device__ __forceinline__ void symbol_llrs(float2 y, float v, const float (&lv)[1 << (QM / 2)],
                                            float (&llr)[QM]) {
  constexpr int kBits = QM / 2, kLevels = 1 << kBits;
  float d2[2][kLevels];
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const float di = __fsub_rn(y.x, lv[l]), dq = __fsub_rn(y.y, lv[l]);
    d2[0][l] = __fmul_rn(di, di);
    d2[1][l] = __fmul_rn(dq, dq);
  }
#pragma unroll
  for (int b = 0; b < QM; ++b) {
    const int k = b >> 1;
    float m1 = 1e30f, m0 = 1e30f;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if ((l >> (kBits - 1 - k)) & 1)
        m1 = fminf(m1, d2[b & 1][l]);
      else
        m0 = fminf(m0, d2[b & 1][l]);
    }
    const float x = (b & 1) ? y.y : y.x;
    llr[b] = __fdiv_rn(x != x ? __fsub_rn(x, x) : __fsub_rn(m1, m0), v);
  }
}

template <int QM>
__device__ __forceinline__ void load_levels(const float* __restrict__ levels,
                                            float (&lv)[1 << (QM / 2)]) {
#pragma unroll
  for (int l = 0; l < (1 << (QM / 2)); ++l) lv[l] = __ldg(levels + l);
}

// A barrier over the CTAs that share a tile: the cluster, or the CTA alone.
__device__ __forceinline__ void tile_sync(int csize) {
  if (csize > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

constexpr int kUnroll = 2;      // positions a thread fills together, their loads in flight at once
constexpr int kMaxRowsCta = 4;  // rows a CTA stages and fills together

// Position p of the CTA's rows n0 .. n0 + rows - 1 (out_p = &out[n0, p]):
// the sum of its staged t in row order, carried on from the rows' sums so
// far. e0 = inv[p, 0], already loaded. Entries outside chunk [lo_sym,
// lo_sym + cap) of the range are skipped; in a later chunk the first entry
// inside takes the sums so far from out. Row rb's stage is stage + rb *
// row_floats, in the shared memory of the CTA of the cluster that staged
// the entry's symbol.
template <int QM>
__device__ __forceinline__ void fill_position(const int* __restrict__ row, int R, int e0, int n_e,
                                              int base, int lo_sym, int cap, int csize,
                                              int rank, int bs, int shift, bool direct,
                                              bool first_chunk, float* stage, int row_floats,
                                              int rows, float* out_p, long long D) {
  float acc[kMaxRowsCta];
#pragma unroll
  for (int rb = 0; rb < kMaxRowsCta; ++rb) acc[rb] = 0.f;
  bool held = first_chunk;  // chunk 0 writes every position; later ones carry on
  for (int j = 0, ej = e0; j < R; ej = ++j < R ? __ldg(row + j) : -1) {
    if (ej < 0 || ej >= n_e) break;  // the pad: the rest of the row is pad too
    const int rel = ej - base;       // bit of the range
    const float* src;
    if (direct) {
      src = stage + rel;
    } else {
      const int k = rel / QM - lo_sym;
      if (k < 0 || k >= cap) continue;
      const int owner = csize > 1 ? k >> shift : 0;
      const int at = rel - (lo_sym + owner * bs) * QM;
      src = (owner == rank ? stage : cg::this_cluster().map_shared_rank(stage, owner)) + at;
    }
    if (!held) {
#pragma unroll
      for (int rb = 0; rb < kMaxRowsCta; ++rb)
        if (rb < rows) acc[rb] = out_p[rb * D];
      held = true;
    }
#pragma unroll
    for (int rb = 0; rb < kMaxRowsCta; ++rb)
      if (rb < rows) acc[rb] = __fadd_rn(acc[rb], src[rb * row_floats]);
  }
  if (held) {
#pragma unroll
    for (int rb = 0; rb < kMaxRowsCta; ++rb)
      if (rb < rows) out_p[rb * D] = acc[rb];
  }
}

// grid (x: tiles x csize, each tile's csize CTAs one cluster; y: groups of
// `rows` rows, striding by gridDim.y). ranges [D / seg, 2]: the least and
// largest slice bit of each segment of seg positions. Dynamic shared
// memory: rows * bs * QM floats, the staged t of this CTA's bs symbols of a
// chunk in each of its rows; a chunk is csize * bs symbols, CTA `rank`
// holding symbols [rank * bs, (rank + 1) * bs) of it (bs = 1 << shift when
// csize > 1).
template <int QM>
__global__ void __launch_bounds__(kMaxThreads)
demap_dematch_tile_kernel(const float2* __restrict__ sym, long long S, Noise nv,
                          const float* __restrict__ levels, const float* __restrict__ scr,
                          const int* __restrict__ sym_map, int lo, int n_e,
                          const int* __restrict__ inv, int R, const int* __restrict__ ranges,
                          int seg, int D, long long N, int tile, int csize, int bs, int shift,
                          int rows, float* __restrict__ out) {
  extern __shared__ float stage[];
  const int rank = blockIdx.x % csize;  // the CTA's rank in its (csize, 1, 1) cluster
  const int t0 = (blockIdx.x / csize) * tile;
  const int t1 = min(t0 + tile, D);
  const int share = (t1 - t0 + csize - 1) / csize;
  const int p0 = min(t0 + rank * share, t1), p1 = min(p0 + share, t1);  // positions filled here
  const int row_floats = bs * QM;

  // the first inv entries of this thread's first positions, in flight while the stage fills
  int head[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = p0 + threadIdx.x + u * blockDim.x;
    head[u] = p < p1 ? __ldg(inv + static_cast<long long>(p) * R) : -1;
  }
  // 1. the tile's range of slice bits [emin, emax], from its segments' ranges
  int emin = INT_MAX, emax = -1;
  for (int g = t0 / seg; g <= (t1 - 1) / seg; ++g) {
    emin = min(emin, __ldg(ranges + 2 * g));
    emax = max(emax, __ldg(ranges + 2 * g + 1));
  }
  // global bit indices elo..ehi, symbols slo..slo + nsym - 1
  const int elo = emax < 0 ? 0 : lo + emin, ehi = lo + emax;
  const int slo = elo / QM;
  const int nsym = emax < 0 ? 0 : ehi / QM - slo + 1;
  const int cap = csize * bs;  // symbols of one chunk
  const int chunks = nsym > cap ? (nsym + cap - 1) / cap : 1;
  const int base = slo * QM - lo;  // slice bit of stage entry 0 in the one-chunk case
  const bool direct = chunks == 1 && csize == 1;
  float lv[1 << (QM / 2)];
  load_levels<QM>(levels, lv);

  for (long long n0 = static_cast<long long>(blockIdx.y) * rows; n0 < N;
       n0 += static_cast<long long>(gridDim.y) * rows) {
    const int here = static_cast<int>(N - n0 < rows ? N - n0 : rows);  // rows of this group
    for (int c = 0; c < chunks; ++c) {
      // 2. stage t of this CTA's symbols of chunk c in each row
      const int first = c * cap + rank * bs;
      for (int i = threadIdx.x; i < bs && first + i < nsym; i += blockDim.x) {
        const int s = slo + first + i;
        const int ms = sym_map ? __ldg(sym_map + s) : s;
        float2 y[kMaxRowsCta];
        float v[kMaxRowsCta];
#pragma unroll
        for (int rb = 0; rb < kMaxRowsCta; ++rb) {
          if (rb < here) {
            y[rb] = sym[(n0 + rb) * S + ms];
            v[rb] = noise_at(nv, n0 + rb, ms);
          }
        }
        float sc[QM];
#pragma unroll
        for (int b = 0; b < QM; ++b) {
          const int e = s * QM + b;
          sc[b] = e >= elo && e <= ehi ? __ldg(scr + e) : 0.f;
        }
#pragma unroll
        for (int rb = 0; rb < kMaxRowsCta; ++rb) {
          if (rb < here) {
            float llr[QM];
            symbol_llrs<QM>(y[rb], v[rb], lv, llr);
#pragma unroll
            for (int b = 0; b < QM; ++b) {
              const int e = s * QM + b;
              if (e >= elo && e <= ehi)
                stage[rb * row_floats + i * QM + b] = __fmul_rn(llr[b], sc[b]);
            }
          }
        }
      }
      tile_sync(csize);
      // 3. fill this CTA's positions in each row from the staged t
      const int lo_sym = c * cap;  // chunk c: symbols [lo_sym, lo_sym + cap) of the range
      for (int p = p0 + threadIdx.x; p < p1; p += kUnroll * blockDim.x) {
        int e0[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u * blockDim.x;
          e0[u] = p == p0 + static_cast<int>(threadIdx.x)
                      ? head[u]
                      : (q < p1 ? __ldg(inv + static_cast<long long>(q) * R) : -1);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u * blockDim.x;
          if (q < p1)
            fill_position<QM>(inv + static_cast<long long>(q) * R, R, e0[u], n_e, base, lo_sym,
                              cap, csize, rank, bs, shift, direct, c == 0, stage, row_floats,
                              here, out + n0 * D + q, D);
        }
      }
      tile_sync(csize);  // every read of this chunk's stage is done before the next
    }
  }
}

// The earlier softbuffer kernel, kept as a variant for the benchmark (no path
// launches it): one thread per output value. grid (x: blocks of
// kGatherThreads positions of a row, y: rows, striding by gridDim.y).
template <int QM>
__global__ void __launch_bounds__(kGatherThreads)
demap_dematch_gather_kernel(const float2* __restrict__ sym, long long S, Noise nv,
                            const float* __restrict__ levels, const float* __restrict__ scr,
                            const int* __restrict__ sym_map, int lo, int n_e,
                            const int* __restrict__ inv, int R, long long D, long long N,
                            float* __restrict__ out) {
  constexpr int kBits = QM / 2;
  const long long p = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (p >= D) return;
  const int* row = inv + p * R;
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    float acc = 0.f;
    for (int j = 0; j < R; ++j) {
      const int ej = __ldg(row + j);
      if (ej < 0 || ej >= n_e) break;
      const int e = lo + ej;
      const int si = e / QM;
      const int s = sym_map ? __ldg(sym_map + si) : si;
      const int bit = e - si * QM, k = bit >> 1;
      const float2 y = sym[n * S + s];
      const float x = (bit & 1) ? y.y : y.x;
      float m1 = 1e30f, m0 = 1e30f;
#pragma unroll
      for (int l = 0; l < (1 << kBits); ++l) {
        const float d = __fsub_rn(x, __ldg(levels + l));
        const float d2 = __fmul_rn(d, d);
        if ((l >> (kBits - 1 - k)) & 1)
          m1 = min_nan(m1, d2);
        else
          m0 = min_nan(m0, d2);
      }
      const float llr = __fdiv_rn(__fsub_rn(m1, m0), noise_at(nv, n, s));
      acc = __fadd_rn(acc, __fmul_rn(llr, __ldg(scr + e)));
    }
    out[n * D + p] = acc;
  }
}

// The LLR form: one thread per symbol, its qm LLRs written together.
template <int QM>
__global__ void __launch_bounds__(kLlrThreads)
demap_llr_kernel(const float2* __restrict__ sym, long long S, Noise nv,
                 const float* __restrict__ levels, long long N, float* __restrict__ out) {
  const long long s = static_cast<long long>(blockIdx.x) * kLlrThreads + threadIdx.x;
  if (s >= S) return;
  float lv[1 << (QM / 2)];
  load_levels<QM>(levels, lv);
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    float llr[QM];
    symbol_llrs<QM>(sym[n * S + s], noise_at(nv, n, s), lv, llr);
    // a row is S * QM floats, so a symbol's QM values are 8-B aligned
    auto* dst = reinterpret_cast<float2*>(out + (n * S + s) * QM);
#pragma unroll
    for (int b = 0; b < QM / 2; ++b) dst[b] = make_float2(llr[2 * b], llr[2 * b + 1]);
  }
}

template <int QM>
const void* tile_fn() {
  return reinterpret_cast<const void*>(demap_dematch_tile_kernel<QM>);
}

const void* kernel_for(int form, int qm) {
  const void* fns[3][3] = {
      {tile_fn<2>(), tile_fn<4>(), tile_fn<6>()},
      {reinterpret_cast<const void*>(demap_llr_kernel<2>),
       reinterpret_cast<const void*>(demap_llr_kernel<4>),
       reinterpret_cast<const void*>(demap_llr_kernel<6>)},
      {reinterpret_cast<const void*>(demap_dematch_gather_kernel<2>),
       reinterpret_cast<const void*>(demap_dematch_gather_kernel<4>),
       reinterpret_cast<const void*>(demap_dematch_gather_kernel<6>)}};
  if (form < 0 || form > 2 || (qm != 2 && qm != 4 && qm != 6)) return nullptr;
  return fns[form][qm / 2 - 1];
}

template <int QM>
cudaError_t launch_tile(dim3 grid, int threads, size_t smem, cudaStream_t st, int csize,
                        const float2* s, long long S, Noise v, const float* levels,
                        const float* scr, const int* sym_map, int lo, int n_e, const int* inv,
                        int R, const int* ranges, int seg, int D, long long N, int tile, int bs,
                        int shift, int rows, float* out) {
  if (smem > 48 * 1024) {  // the kernel has no static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        demap_dematch_tile_kernel<QM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, demap_dematch_tile_kernel<QM>, s, S, v, levels, scr, sym_map,
                            lo, n_e, inv, R, ranges, seg, D, N, tile, csize, bs, shift, rows,
                            out);
}

}  // namespace

extern "C" {

// The softbuffer form on `stream` (a cudaStream_t, 0 for the default
// stream): buf [N, D] from sym [N, S]. nv null: nv_value for every RE.
// sym_map null: symbol e / qm is column e / qm of sym. ranges [D / seg, 2]:
// the least and largest entry of each segment of seg rows of inv below the
// pad (INT_MAX and -1 where there is none). The plan
// (kernels/demap.py::plan): tiles of `tile` positions, each staged by a
// cluster of csize CTAs (1, 2, 4 or 8) of `threads` threads holding bs
// symbols each (bs = 1 << shift when csize > 1) in each of the `rows` rows
// (1 to 4) it stages and fills together. Return the CUDA error code
// of the launch, 0 on success; cudaErrorInvalidValue for a qm outside
// {2, 4, 6}, a bad size or a bad plan.
int srsue_demap_dematch(const void* sym, long long S, const float* nv, long long nv_sn,
                        long long nv_ss, float nv_value, const float* levels, int qm,
                        const float* scr, const int* sym_map, long long lo, long long n_e,
                        const int* inv, int R, const int* ranges, long long seg, long long D,
                        long long N, float* out, long long tile, int csize, int bs, int shift,
                        int rows, int threads, void* stream) {
  if (N < 0 || D < 0 || S < 0 || R < 1 || lo < 0 || n_e < 0 || lo + n_e > INT_MAX ||
      D * R > INT_MAX || (qm != 2 && qm != 4 && qm != 6) || seg < 1 || D % seg ||
      tile < 1 || bs < 1 ||
      (csize != 1 && csize != 2 && csize != 4 && csize != 8) ||
      (csize > 1 && (shift < 0 || shift > 20 || bs != 1 << shift)) || threads < 32 ||
      threads > kMaxThreads || threads % 32 || (D + tile - 1) / tile * csize > INT_MAX ||
      rows < 1 || rows > kMaxRowsCta || static_cast<long long>(rows) * bs * qm * 4 > 226 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || D == 0) return 0;
  const auto* s = static_cast<const float2*>(sym);
  const Noise v{nv, nv_sn, nv_ss, nv_value};
  const auto st = static_cast<cudaStream_t>(stream);
  const long long groups = (N + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>((D + tile - 1) / tile * csize),
                  static_cast<unsigned>(groups < kMaxRows ? groups : kMaxRows));
  const size_t smem = static_cast<size_t>(rows) * bs * qm * sizeof(float);
  const int lo32 = static_cast<int>(lo), ne32 = static_cast<int>(n_e);
  const int d32 = static_cast<int>(D), t32 = static_cast<int>(tile < D ? tile : D);
  const int seg32 = static_cast<int>(seg);
  cudaError_t err;
  if (qm == 2)
    err = launch_tile<2>(grid, threads, smem, st, csize, s, S, v, levels, scr, sym_map, lo32,
                         ne32, inv, R, ranges, seg32, d32, N, t32, bs, shift, rows, out);
  else if (qm == 4)
    err = launch_tile<4>(grid, threads, smem, st, csize, s, S, v, levels, scr, sym_map, lo32,
                         ne32, inv, R, ranges, seg32, d32, N, t32, bs, shift, rows, out);
  else
    err = launch_tile<6>(grid, threads, smem, st, csize, s, S, v, levels, scr, sym_map, lo32,
                         ne32, inv, R, ranges, seg32, d32, N, t32, bs, shift, rows, out);
  const cudaError_t last = cudaGetLastError();  // read, so a refused launch leaves no error behind
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The earlier design (demap_dematch_gather_kernel): the same function and
// arguments, no plan. For the benchmark only.
int srsue_demap_dematch_gather(const void* sym, long long S, const float* nv, long long nv_sn,
                               long long nv_ss, float nv_value, const float* levels, int qm,
                               const float* scr, const int* sym_map, long long lo,
                               long long n_e, const int* inv, int R, long long D, long long N,
                               float* out, void* stream) {
  if (N < 0 || D < 0 || S < 0 || R < 1 || lo < 0 || n_e < 0 || lo + n_e > INT_MAX ||
      (D + kGatherThreads - 1) / kGatherThreads > INT_MAX || (qm != 2 && qm != 4 && qm != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || D == 0) return 0;
  const auto* s = static_cast<const float2*>(sym);
  const Noise v{nv, nv_sn, nv_ss, nv_value};
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>((D + kGatherThreads - 1) / kGatherThreads),
               static_cast<unsigned>(N < kMaxRows ? N : kMaxRows));
  const int lo32 = static_cast<int>(lo), ne32 = static_cast<int>(n_e);
  if (qm == 2)
    demap_dematch_gather_kernel<2><<<g, kGatherThreads, 0, st>>>(s, S, v, levels, scr, sym_map,
                                                                 lo32, ne32, inv, R, D, N, out);
  else if (qm == 4)
    demap_dematch_gather_kernel<4><<<g, kGatherThreads, 0, st>>>(s, S, v, levels, scr, sym_map,
                                                                 lo32, ne32, inv, R, D, N, out);
  else
    demap_dematch_gather_kernel<6><<<g, kGatherThreads, 0, st>>>(s, S, v, levels, scr, sym_map,
                                                                 lo32, ne32, inv, R, D, N, out);
  return static_cast<int>(cudaGetLastError());
}

// The LLR form: out [N, S * qm] from sym [N, S]. Return a CUDA error code.
int srsue_demap_llr(const void* sym, long long S, const float* nv, long long nv_sn,
                    long long nv_ss, float nv_value, const float* levels, int qm, long long N,
                    float* out, void* stream) {
  if (N < 0 || S < 0 || (S + kLlrThreads - 1) / kLlrThreads > INT_MAX ||
      (qm != 2 && qm != 4 && qm != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || S == 0) return 0;
  const auto* s = static_cast<const float2*>(sym);
  const Noise v{nv, nv_sn, nv_ss, nv_value};
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>((S + kLlrThreads - 1) / kLlrThreads),
               static_cast<unsigned>(N < kMaxRows ? N : kMaxRows));
  if (qm == 2)
    demap_llr_kernel<2><<<g, kLlrThreads, 0, st>>>(s, S, v, levels, N, out);
  else if (qm == 4)
    demap_llr_kernel<4><<<g, kLlrThreads, 0, st>>>(s, S, v, levels, N, out);
  else
    demap_llr_kernel<6><<<g, kLlrThreads, 0, st>>>(s, S, v, levels, N, out);
  return static_cast<int>(cudaGetLastError());
}

// Warps resident on one SM, by the CUDA occupancy calculator, of the
// softbuffer form (form 0) at `threads` threads and `smem_bytes` of dynamic
// shared memory (its plan's), the LLR form (1) or the gather variant (2) at
// qm. Return a CUDA error code.
int srsue_demap_warps(int form, int qm, int threads, int smem_bytes, int* warps_out) {
  const void* fn = kernel_for(form, qm);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  if (form != 0) {
    threads = form == 1 ? kLlrThreads : kGatherThreads;
    smem_bytes = 0;
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem_bytes);
  *warps_out = blocks * (threads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
