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
// (ratematch.inverse_index of the slice, padded with n_e). Output buf
// [N, D]: position p of row n is
//   0.0 + llr(lo + inv[p, 0]) + llr(lo + inv[p, 1]) + ...
// in that order, one rounding per add, up to the first pad (+0.0 where
// nothing was sent); llr(e) is the max-log LLR of bit e % qm of symbol
// e / qm (through the map), times scr[e]:
//   d2     = (x - level)^2                       per level of the bit's axis
//   m1, m0 = min(1e30, min d2 over the levels whose bit is 1 / 0)
//   llr    = ((m1 - m0) / max(nv, 1e-9)) * scr[e]
// Bits 0, 2, 4 of a symbol are on the I axis and 1, 3, 5 on Q; bit 2k is
// the axis's bit k, and a level's bits are its index in binary, MSB first.
// Every operation is the plain version's, in its order and rounded once
// through the _rn intrinsics (no contraction into a multiply-add, a true
// IEEE divide), and the minimum propagates a NaN as torch's amin does, so
// the kernel gives the plain version's bits. The first add, 0.0 + llr,
// turns a -0.0 into +0.0 as the plain version's padded copy does.
//
// The LLR form: sym [N, S] -> out [N, S * qm], the same llr with no scr,
// in transmit bit order (what demodulate_soft returns).
//
// What bounds it: bytes. Each output value is one thread; a thread reads its
// R inverse-table entries, scr and the one symbol and noise value its bit
// needs, does 2^(qm/2) subtract-square-min steps, and writes one float.
// At the flagship (PDSCH 64QAM, N = 256 subframes of 15,000 REs into
// 227,292 positions) the call must move ~279 MB: 30.7 MB of symbols,
// 15.4 MB of noise, 232.7 MB of softbuffer. The design: consecutive
// threads write consecutive positions p of one row, so the writes are
// coalesced; the grid's x runs over a row's positions and its y over the
// rows, so the blocks in flight cover one or two subframes, whose symbols
// (120 KB) and noise stay in L2 while the qm bits of a symbol are gathered
// by threads far apart in p; the inverse table (int32, shared by every row)
// and scr stay in L2 across the batch. One kernel instance per qm, so
// e / qm and e % qm are constant divisions, and no 64-bit division.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxRows = 65535;  // gridDim.y

struct Noise {
  const float* p;  // null: one value for every RE
  long long sn, ss;
  float value;
};

// min that keeps a NaN, as torch's amin
__device__ __forceinline__ float min_nan(float acc, float d2) {
  return (d2 < acc || d2 != d2) ? d2 : acc;
}

// (min d2 over the levels with the axis bit k = 1) - (min over bit 0)
template <int QM>
__device__ __forceinline__ float axis_llr(float x, const float* __restrict__ levels, int k) {
  constexpr int kBits = QM / 2;
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
  return __fsub_rn(m1, m0);
}

// the LLR of bit `bit` of symbol s of row n
template <int QM>
__device__ __forceinline__ float bit_llr(const float2* __restrict__ sym, long long S, Noise nv,
                                         const float* __restrict__ levels, long long n,
                                         long long s, int bit) {
  const float2 y = sym[n * S + s];
  const float x = (bit & 1) ? y.y : y.x;
  float v = nv.p ? __ldg(nv.p + n * nv.sn + s * nv.ss) : nv.value;
  v = v < 1e-9f ? 1e-9f : v;  // clamp_min: a NaN stays NaN
  return __fdiv_rn(axis_llr<QM>(x, levels, bit >> 1), v);
}

// grid (x: blocks of kThreads positions of a row, y: rows, striding by
// gridDim.y): one row's blocks are issued together, so the symbols of the
// subframes in flight stay in L2
template <int QM>
__global__ void __launch_bounds__(kThreads)
demap_dematch_kernel(const float2* __restrict__ sym, long long S, Noise nv,
                     const float* __restrict__ levels, const float* __restrict__ scr,
                     const int* __restrict__ sym_map, int lo, int n_e,
                     const int* __restrict__ inv, int R, long long D, long long N,
                     float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= D) return;
  const int* row = inv + p * R;
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    float acc = 0.f;
    for (int j = 0; j < R; ++j) {
      const int ej = __ldg(row + j);
      if (ej < 0 || ej >= n_e) break;  // the pad: the rest of the row is pad too
      const int e = lo + ej;
      const int si = e / QM;
      const int s = sym_map ? __ldg(sym_map + si) : si;
      const float llr = bit_llr<QM>(sym, S, nv, levels, n, s, e - si * QM);
      acc = __fadd_rn(acc, __fmul_rn(llr, __ldg(scr + e)));
    }
    out[n * D + p] = acc;
  }
}

template <int QM>
__global__ void __launch_bounds__(kThreads)
demap_llr_kernel(const float2* __restrict__ sym, long long S, Noise nv,
                 const float* __restrict__ levels, long long N, float* __restrict__ out) {
  const long long width = S * QM;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= width) return;
  const long long s = r / QM;
  for (long long n = blockIdx.y; n < N; n += gridDim.y)
    out[n * width + r] = bit_llr<QM>(sym, S, nv, levels, n, s, static_cast<int>(r - s * QM));
}

dim3 grid_for(long long width, long long rows) {
  return dim3(static_cast<unsigned>((width + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows < kMaxRows ? rows : kMaxRows));
}

}  // namespace

extern "C" {

// The softbuffer form on `stream` (a cudaStream_t, 0 for the default
// stream): buf [N, D] from sym [N, S]. nv null: nv_value for every RE.
// sym_map null: symbol e / qm is column e / qm of sym. Return the CUDA error
// code of the launch, 0 on success; cudaErrorInvalidValue for a qm outside
// {2, 4, 6} or a bad size.
int srsue_demap_dematch(const void* sym, long long S, const float* nv, long long nv_sn,
                        long long nv_ss, float nv_value, const float* levels, int qm,
                        const float* scr, const int* sym_map, long long lo, long long n_e,
                        const int* inv, int R, long long D, long long N, float* out,
                        void* stream) {
  if (N < 0 || D < 0 || S < 0 || R < 1 || lo < 0 || n_e < 0 || lo + n_e > 0x7fffffffLL ||
      (D + kThreads - 1) / kThreads > 0x7fffffffLL || (qm != 2 && qm != 4 && qm != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || D == 0) return 0;
  const auto* s = static_cast<const float2*>(sym);
  const Noise v{nv, nv_sn, nv_ss, nv_value};
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 g = grid_for(D, N);
  const int lo32 = static_cast<int>(lo), ne32 = static_cast<int>(n_e);
  if (qm == 2)
    demap_dematch_kernel<2><<<g, kThreads, 0, st>>>(s, S, v, levels, scr, sym_map, lo32, ne32,
                                                    inv, R, D, N, out);
  else if (qm == 4)
    demap_dematch_kernel<4><<<g, kThreads, 0, st>>>(s, S, v, levels, scr, sym_map, lo32, ne32,
                                                    inv, R, D, N, out);
  else
    demap_dematch_kernel<6><<<g, kThreads, 0, st>>>(s, S, v, levels, scr, sym_map, lo32, ne32,
                                                    inv, R, D, N, out);
  return static_cast<int>(cudaGetLastError());
}

// The LLR form: out [N, S * qm] from sym [N, S]. Return a CUDA error code.
int srsue_demap_llr(const void* sym, long long S, const float* nv, long long nv_sn,
                    long long nv_ss, float nv_value, const float* levels, int qm, long long N,
                    float* out, void* stream) {
  if (N < 0 || S < 0 || (S * qm + kThreads - 1) / kThreads > 0x7fffffffLL ||
      (qm != 2 && qm != 4 && qm != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || S == 0) return 0;
  const auto* s = static_cast<const float2*>(sym);
  const Noise v{nv, nv_sn, nv_ss, nv_value};
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 g = grid_for(S * qm, N);
  if (qm == 2)
    demap_llr_kernel<2><<<g, kThreads, 0, st>>>(s, S, v, levels, N, out);
  else if (qm == 4)
    demap_llr_kernel<4><<<g, kThreads, 0, st>>>(s, S, v, levels, N, out);
  else
    demap_llr_kernel<6><<<g, kThreads, 0, st>>>(s, S, v, levels, N, out);
  return static_cast<int>(cudaGetLastError());
}

// Warps of the softbuffer form (llr_form 0) or the LLR form (1) at qm
// resident on one SM, by the CUDA occupancy calculator. Return a CUDA error
// code.
int srsue_demap_warps(int llr_form, int qm, int* warps_out) {
  const void* fn = nullptr;
  if (qm == 2)
    fn = llr_form ? reinterpret_cast<const void*>(demap_llr_kernel<2>)
                  : reinterpret_cast<const void*>(demap_dematch_kernel<2>);
  else if (qm == 4)
    fn = llr_form ? reinterpret_cast<const void*>(demap_llr_kernel<4>)
                  : reinterpret_cast<const void*>(demap_dematch_kernel<4>);
  else if (qm == 6)
    fn = llr_form ? reinterpret_cast<const void*>(demap_llr_kernel<6>)
                  : reinterpret_cast<const void*>(demap_dematch_kernel<6>);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  *warps_out = blocks * (kThreads / 32);
  return static_cast<int>(err);
}

}  // extern "C"
