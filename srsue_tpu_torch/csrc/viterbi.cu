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
// steps; the first warms the tail-biting state), then the survivor path of
// the first maximal state. The float32 operations are the twin's, in its
// order and each rounded once, so kernel and twin give identical bits:
//   bm   = (+-l0 + +-l1) + +-l2      branch metric of a 7-bit word
//   cand = pm[pred] + bm             take the odd predecessor only if >
//   pm  -= max(pm) every 2 steps
//
// What bounds it: each hypothesis is a chain of 2n dependent trellis
// steps of 64 states and touches only 12n bytes, so the card's bandwidth
// and arithmetic are idle; the instructions a step issues, above all the
// warp shuffles (the shuffle unit serves one warp instruction per clock per
// SM, a quarter of the arithmetic rate), set the pace. The design:
//   * one warp per hypothesis, two states per lane: lane l holds x, the
//     metric of state l + 32*(l odd), and y, that of the other of l and
//     l + 32. Both have the predecessors 2l and 2l + 1 (mod 64), which
//     sit in x of lane 2l and y of lane 2l + 1 below lane 16, in x of lane
//     2l - 31 and y of lane 2l - 32 above: a step is two __shfl_sync and no
//     shuffled value is thrown away;
//   * each branch metric is +-l0 +- l1 +- l2 with per-lane signs as +-1.0
//     factors: l*s is exact, so fma(l0, s0, l1*s1) rounds once, as the
//     twin's sum does. The metric into state l + 32 is minus that into
//     state l (every generator taps the input bit), so the factors of x
//     carry the lane's parity and those of y are their negation;
//   * a state's metric is the max of its two candidates; it took the odd
//     predecessor (strictly larger, the twin's rule) exactly when that max
//     differs from the even one's candidate. The metrics equal the twin's
//     bit for bit, but for the sign of a zero, which compares equal in
//     every later test;
//   * the decisions of the second pass are kept, not survivor words: two
//     __ballot_sync per step give the 64 states' decision bits, 8 bytes in
//     shared memory. The traceback from the first maximal state then walks
//     them back: the output bit of step k is the input bit (bit 5) of the
//     state after it, and the state before it is (2s + decision) & 63. This
//     is the path whose bits the twin's register exchange carries;
//   * the maximum of the 64 metrics is one __reduce_max_sync on their
//     order-preserving integer images;
//   * the 3n LLRs of a hypothesis are staged in shared memory with
//     coalesced loads, one float4 per step, and read as broadcasts; eight
//     hypotheses per block.
// Measured on an H100 SXM (700 W) at B = 4,608, n = 44: 0.025 ms of device
// time at 64 warps per SM; 0.058 ms (48 warps) with register-exchange
// survivors, 0.032 with the ballots but the states in index order (four
// selects around the two shuffles per step).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 96;
constexpr int kWarps = 8;  // hypotheses per block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEven = 0x55555555u;  // the even lanes

// sign * +-1.0 factors of the three output streams of branch word w (-1
// where the stream's bit is 1, i.e. its expected soft value is -1)
__device__ __forceinline__ void word_factors(int w, float sign, float (&f)[3]) {
  f[0] = (__popc(w & 0133) & 1) ? -sign : sign;
  f[1] = (__popc(w & 0171) & 1) ? -sign : sign;
  f[2] = (__popc(w & 0165) & 1) ? -sign : sign;
}

// (x0 + x1) + x2 with x_j = l_j * f_j, each sum rounded once
__device__ __forceinline__ float branch(float4 l, const float (&f)[3]) {
  return __fmaf_rn(l.z, f[2], __fmaf_rn(l.x, f[0], l.y * f[1]));
}

// An integer image of a float32 whose signed order is the floats' order.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float warp_max(float x) {
  return unordered(__reduce_max_sync(kFull, ordered(x)));
}

__global__ void __launch_bounds__(32 * kWarps)
viterbi_kernel(const float* __restrict__ llr, unsigned char* __restrict__ out,
               long long B, int n) {
  __shared__ float4 s_llr[kWarps][kMaxN];              // step k: (l0, l1, l2, -)
  __shared__ unsigned long long s_dec[kWarps][kMaxN];  // bit s: state s took its odd pred
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long h = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (h >= B) return;  // the whole warp leaves together
  float4* s = s_llr[warp];
  unsigned long long* dec = s_dec[warp];
  const float* src = llr + h * 3 * n;
  for (int i = lane; i < 3 * n; i += 32) reinterpret_cast<float*>(s)[i / 3 * 4 + i % 3] = src[i];
  __syncwarp();

  const bool up = lane >= 16, odd = lane & 1;
  const int src_a = up ? 2 * lane - 31 : 2 * lane;  // qa is x of lane src_a
  const int src_b = up ? 2 * lane - 32 : 2 * lane + 1;  // qb is y of lane src_b
  // qa is the metric of predecessor 2*lane below lane 16 and of 2*lane + 1
  // above; its branch word into state lane is 2*lane or 2*lane + 1
  float fa[3], fb[3];
  word_factors(up ? 2 * lane + 1 : 2 * lane, odd ? -1.f : 1.f, fa);
  word_factors(up ? 2 * lane : 2 * lane + 1, odd ? -1.f : 1.f, fb);

  float x = 0.f, y = 0.f;
  auto step = [&](int k, int i, bool keep) {
    const float4 l = s[i];
    const float qa = __shfl_sync(kFull, x, src_a), qb = __shfl_sync(kFull, y, src_b);
    const float ba = branch(l, fa), bb = branch(l, fb);
    const float xa = __fadd_rn(qa, ba), xb = __fadd_rn(qb, bb);
    const float ya = __fsub_rn(qa, ba), yb = __fsub_rn(qb, bb);
    x = fmaxf(xa, xb);
    y = fmaxf(ya, yb);
    if (keep) {  // the even predecessor's candidate is qb's above lane 16
      const unsigned tx = __ballot_sync(kFull, x != (up ? xb : xa));
      const unsigned ty = __ballot_sync(kFull, y != (up ? yb : ya));
      // states 0..31 are x on even lanes and y on odd ones, 32..63 the others
      if (lane == 0)
        dec[i] = static_cast<unsigned long long>((ty & kEven) | (tx & ~kEven)) << 32 |
                 ((tx & kEven) | (ty & ~kEven));
    }
    if (k & 1) {  // minus the maximum every 2 steps
      const float m = warp_max(fmaxf(x, y));
      x = __fsub_rn(x, m);
      y = __fsub_rn(y, m);
    }
  };
  for (int k = 0; k < n; ++k) step(k, k, false);  // warms the tail-biting state
  for (int k = n; k < 2 * n; ++k) step(k, k - n, true);
  __syncwarp();

  // the first maximal state: the lowest index among metrics equal to the max
  const float m = warp_max(fmaxf(x, y));
  const unsigned at_lo = __ballot_sync(kFull, (odd ? y : x) == m);
  const unsigned at_hi = __ballot_sync(kFull, (odd ? x : y) == m);
  int st = at_lo ? __ffs(at_lo) - 1 : 31 + __ffs(at_hi);
  // trace back; lane j keeps the bits of steps j, j + 32 and j + 64
  unsigned mine = 0u;
  for (int k = n - 1; k >= 0; --k) {
    if ((k & 31) == lane) mine |= static_cast<unsigned>(st >> 5) << (k >> 5);
    st = (2 * st + static_cast<int>((dec[k] >> st) & 1ull)) & 63;
  }
  for (int w = 0; w * 32 + lane < n; ++w)
    out[h * n + w * 32 + lane] = static_cast<unsigned char>((mine >> w) & 1u);
}

}  // namespace

extern "C" {

// Decode B hypotheses of n trellis steps on `stream` (a cudaStream_t, 0 for
// the default stream). Return the CUDA error code of the launch, 0 on
// success; cudaErrorInvalidValue for B < 1 or n outside 1..96.
int srsue_viterbi(const float* llr, unsigned char* out, long long B, int n, void* stream) {
  if (B <= 0 || n < 1 || n > kMaxN || (B + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B + kWarps - 1) / kWarps;
  viterbi_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(llr, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

// Warps of the kernel for hypotheses of n steps resident on one SM, by the
// CUDA occupancy calculator. Return a CUDA error code.
int srsue_viterbi_warps(int n, int* warps_out) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, viterbi_kernel, 32 * kWarps, 0);
  *warps_out = blocks * kWarps;
  return static_cast<int>(err);
}

}  // extern "C"
