// Batched circular Viterbi decoder of the LTE tail-biting convolutional
// code (36.212 5.1.3.1: K=7, rate 1/3, generators 133, 171, 165 octal),
// hand-written for Hopper (sm_90a).
//
// Replaces srsue_tpu/phy/convcode.py::decode, which is a lax.scan and not
// a Pallas kernel: it decodes every PDCCH candidate of every subframe of a
// batch at once (B = 4,608 hypotheses of n = 44 at 100 PRB), and PBCH
// (n = 40). The plain PyTorch twin is phy/convcode.py::decode_plain.
//
// Contract: llr [B, n, 3] float32 (positive = bit 0), out [B, n] uint8,
// both contiguous, 1 <= n <= 96. Two passes over the sequence (2n trellis
// steps; the first warms the tail-biting state), register-exchange
// survivors, and the first maximal state's survivor bits as the result.
// The float32 operations are the twin's, in its order and each rounded
// once (__fadd_rn/__fsub_rn keep the compiler from contracting them), so
// kernel and twin give identical bits:
//   bm   = (+-l0 + +-l1) + +-l2      branch metric of a 7-bit word
//   cand = pm[pred] + bm             take the odd predecessor only if >
//   pm  -= max(pm) every 2 steps
//
// What bounds it: each hypothesis is a chain of 2n dependent trellis
// steps of 64 states and touches only 12n bytes, so the card's bandwidth
// and arithmetic are idle and the chain's latency is what counts. The
// design:
//   * one warp per hypothesis, two states per lane (l and l + 32). Both
//     have the predecessors 2l and 2l + 1 (mod 64) and differ only in the
//     input bit, so a step is four __shfl_sync of path metrics (each
//     predecessor's two slots) plus four per survivor word; nothing goes
//     through shared or device memory inside the loop;
//   * the 3n LLRs of a hypothesis are staged in shared memory with
//     coalesced loads and read as broadcasts; path metrics and survivor
//     words (ceil(n/32) of them, a template parameter) stay in registers;
//   * eight hypotheses per block; at B = 4,608 that is ~35 warps per SM to
//     hide the shuffle latency of the chain.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 96;
constexpr int kWarps = 8;  // hypotheses per block
constexpr int kNormEvery = 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float branch(unsigned signs, float l0, float l1, float l2) {
  const float x0 = (signs & 1u) ? -l0 : l0;
  const float x1 = (signs & 2u) ? -l1 : l1;
  const float x2 = (signs & 4u) ? -l2 : l2;
  return __fadd_rn(__fadd_rn(x0, x1), x2);
}

// bit j set where output stream j of branch word w is 1 (expected value -1)
__device__ __forceinline__ unsigned word_signs(int w) {
  return static_cast<unsigned>(__popc(w & 0133) & 1) |
         static_cast<unsigned>(__popc(w & 0171) & 1) << 1 |
         static_cast<unsigned>(__popc(w & 0165) & 1) << 2;
}

template <int NW>
__global__ void __launch_bounds__(32 * kWarps)
viterbi_kernel(const float* __restrict__ llr, unsigned char* __restrict__ out,
               long long B, int n) {
  __shared__ float s_llr[kWarps][3 * kMaxN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long h = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (h >= B) return;  // the whole warp leaves together
  float* s = s_llr[warp];
  const float* src = llr + h * 3 * n;
  for (int i = lane; i < 3 * n; i += 32) s[i] = src[i];
  __syncwarp();

  // the branch words into next states lane (input 0) and lane + 32 (input 1)
  const unsigned sg00 = word_signs(2 * lane), sg01 = word_signs(2 * lane + 1);
  const unsigned sg10 = word_signs(2 * lane + 64), sg11 = word_signs(2 * lane + 65);
  // predecessors 2*lane and 2*lane + 1 live in these lanes, in the high
  // slot when lane >= 16
  const int src0 = (2 * lane) & 31, src1 = (2 * lane + 1) & 31;
  const bool hi_src = lane >= 16;

  float pm_lo = 0.f, pm_hi = 0.f;
  unsigned sv_lo[NW], sv_hi[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) sv_lo[w] = sv_hi[w] = 0u;

  for (int k = 0; k < 2 * n; ++k) {
    const int i = 3 * (k < n ? k : k - n);
    const float l0 = s[i], l1 = s[i + 1], l2 = s[i + 2];
    const float a_lo = __shfl_sync(kFull, pm_lo, src0), a_hi = __shfl_sync(kFull, pm_hi, src0);
    const float b_lo = __shfl_sync(kFull, pm_lo, src1), b_hi = __shfl_sync(kFull, pm_hi, src1);
    const float p0 = hi_src ? a_hi : a_lo;  // metric of state 2*lane
    const float p1 = hi_src ? b_hi : b_lo;  // metric of state 2*lane + 1
    const float c0 = __fadd_rn(p0, branch(sg00, l0, l1, l2));
    const float c1 = __fadd_rn(p1, branch(sg01, l0, l1, l2));
    const float d0 = __fadd_rn(p0, branch(sg10, l0, l1, l2));
    const float d1 = __fadd_rn(p1, branch(sg11, l0, l1, l2));
    const bool t_lo = c1 > c0, t_hi = d1 > d0;
    pm_lo = t_lo ? c1 : c0;
    pm_hi = t_hi ? d1 : d0;
    unsigned carry_lo = 0u, carry_hi = 1u;  // the input bit of the next state
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned x_lo = __shfl_sync(kFull, sv_lo[w], src0);
      const unsigned x_hi = __shfl_sync(kFull, sv_hi[w], src0);
      const unsigned y_lo = __shfl_sync(kFull, sv_lo[w], src1);
      const unsigned y_hi = __shfl_sync(kFull, sv_hi[w], src1);
      const unsigned s0 = hi_src ? x_hi : x_lo;
      const unsigned s1 = hi_src ? y_hi : y_lo;
      const unsigned ch_lo = t_lo ? s1 : s0, ch_hi = t_hi ? s1 : s0;
      sv_lo[w] = (ch_lo << 1) | carry_lo;
      sv_hi[w] = (ch_hi << 1) | carry_hi;
      carry_lo = ch_lo >> 31;
      carry_hi = ch_hi >> 31;
    }
    if ((k + 1) % kNormEvery == 0) {
      float m = fmaxf(pm_lo, pm_hi);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      pm_lo = __fsub_rn(pm_lo, m);
      pm_hi = __fsub_rn(pm_hi, m);
    }
  }

  // the first maximal state: the lowest index among equal metrics
  float best = pm_lo;
  int idx = lane;
  if (pm_hi > pm_lo) {
    best = pm_hi;
    idx = lane + 32;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  unsigned words[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const unsigned lo = __shfl_sync(kFull, sv_lo[w], idx & 31);
    const unsigned hi = __shfl_sync(kFull, sv_hi[w], idx & 31);
    words[w] = idx >= 32 ? hi : lo;
  }
  // bit k (oldest first) sits at LSB offset n - 1 - k of the survivor
  for (int k = lane; k < n; k += 32) {
    const int pos = n - 1 - k;
    unsigned word = words[0];
#pragma unroll
    for (int w = 1; w < NW; ++w)
      if (pos >= 32 * w) word = words[w];
    out[h * n + k] = static_cast<unsigned char>((word >> (pos & 31)) & 1u);
  }
}

template <int NW>
int launch(const float* llr, unsigned char* out, long long B, int n, cudaStream_t stream) {
  const long long blocks = (B + kWarps - 1) / kWarps;
  viterbi_kernel<NW><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, stream>>>(llr, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int warps(int* out) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, viterbi_kernel<NW>, 32 * kWarps, 0);
  *out = blocks * kWarps;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Decode B hypotheses of n trellis steps on `stream` (a cudaStream_t, 0 for
// the default stream). Return the CUDA error code of the launch, 0 on
// success; cudaErrorInvalidValue for B < 1 or n outside 1..96.
int srsue_viterbi(const float* llr, unsigned char* out, long long B, int n, void* stream) {
  if (B <= 0 || n < 1 || n > kMaxN || (B + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((n + 31) / 32) {
    case 1: return launch<1>(llr, out, B, n, st);
    case 2: return launch<2>(llr, out, B, n, st);
    default: return launch<3>(llr, out, B, n, st);
  }
}

// Warps of the kernel for hypotheses of n steps resident on one SM, by the
// CUDA occupancy calculator. Return a CUDA error code.
int srsue_viterbi_warps(int n, int* warps_out) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  switch ((n + 31) / 32) {
    case 1: return warps<1>(warps_out);
    case 2: return warps<2>(warps_out);
    default: return warps<3>(warps_out);
  }
}

}  // extern "C"
