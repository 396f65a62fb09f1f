// One half-iteration of the forced turbo decode with its glue inside the
// kernel, hand-written for Hopper (sm_90a). Replaces the tiled forced forms
// srsue_tpu/phy/turbo_pallas.py::decode_forced_tiled and
// ::decode_forced_loop_tiled (with their index maps _tiled_maps and
// _tile_padded): there the QPP interleave and the window-boundary chaining
// are gathers between the halves; here the half's loads do them.
//
// For B code blocks of K bits in W = K/lw windows:
//   inputs   sys, par  [B, K]  the half's systematic and parity LLRs
//            ext_other [B, K]  the other half's extrinsic, in its order
//            idx       [K]     int32: lin[b, j] = sys[b, j] + ext_other[b, idx[j]]
//                              (qpp_inv for half 1, qpp_perm for half 2)
//            alast_prev, bfirst_prev [B, W, 8]  this half's boundaries of
//                              the previous iteration, unshifted
//            tail_b    [B, 8]  beta after the trellis termination
//   outputs  ext [B, K], alast, bfirst [B, W, 8] (unshifted)
// Window w starts from alpha = (0, NEG, ...) when w = 0, else
// alast_prev[b, w-1]; it ends at beta = tail_b[b] when w = W-1, else
// bfirst_prev[b, w+1] (next-iteration initialisation; at W = 1 both
// injections apply to the one window). The recursion is the radix-2,
// per-step-maximum one of bcjr_half.cu (bcjr_core.cuh), so the result equals
// the gather + bcjr_half_windowed + boundary shift composition of the plain
// PyTorch twin (kernels/bcjr.py) up to float32 rounding of the same
// operations. Outputs never alias inputs: the caller double-buffers.
//
// What bounds it on the card: the recursion, as in bcjr_half.cu, and the
// gather, random within a block row of ext_other (23 KB at K=5824). The
// first form gathered from device memory (4 useful bytes of each 32-byte
// sector) while the alpha history filled shared memory and left ~29 KB of
// L1: one block of 90 threads per SM and 1.00 ms per half at the flagship
// shape. This form:
//   * maps one CTA to one code block (W threads, one window each), or to
//     several code blocks when W is small, so that the gather row is the
//     CTA's own;
//   * brings that row into shared memory with one bulk TMA copy
//     (cp.async.bulk, completion on an mbarrier) issued by one thread at
//     the start; every thread waits on the barrier's phase, then gathers
//     ext_other[idx[j]] from shared memory; sys, par and idx are read per
//     window, 16-byte accesses where aligned;
//   * runs the checkpointed radix-2 window of bcjr_core.cuh, so shared
//     memory holds the row plus 256 B of alpha checkpoints per window
//     (~47 KB per CTA at K=5824): several CTAs per SM.
// The bulk copy moves 16-byte multiples between 16-byte aligned addresses:
// K % 4 == 0 (every LTE block size is a multiple of 8) and a 16-byte aligned
// ext_other, else the launch returns cudaErrorInvalidValue. Measured on an
// H100 SXM (700 W) at the
// flagship shape: 12 warps per SM (4 CTAs of 91 threads, shared memory
// bound), 158 registers, no spills, 0.34 ms per half.

#include <climits>

#include "bcjr_core.cuh"

namespace {

using bcjr::kStates;

constexpr float kNeg = -1e9f;          // metric of an impossible state
constexpr int kSeg = 8;                // trellis steps per alpha checkpoint
constexpr int kMaxThreads = 128;       // a CTA's windows, at most
constexpr int kMinBlocks = 3;          // resident CTAs per SM asked of the compiler
constexpr long long kRowBudget = 24 * 1024;  // bytes of gather rows per CTA when W is small

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// src into s_row with one bulk TMA copy that thread 0 issues and that
// completes on the mbarrier `bar`; every thread returns once it has landed.
__device__ __forceinline__ void tma_load_rows(float* s_row, const float* src, uint32_t bytes,
                                              uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(s_row)),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(b)
        : "memory");
  }
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(b), "r"(0u)
      : "memory");
}

// The rows of one window: lin = sys + ext_other[idx] (the other half's
// extrinsic from the CTA's shared copy of its row), par in, ext out. The
// next segment's sys, idx and par loads are issued ahead; the gather from
// shared memory waits until the segment's turn.
struct GatherIO {
  static constexpr bool kPrefetch = true;  // 0.35 ms per half; 0.38 in a form without
  struct Seg {
    float s[kSeg], p[kSeg];
    int j[kSeg];
  };
  const float* sys;
  const float* par;
  const int* idx;
  const float* s_row;
  float* ext;
  bool vec;
  __device__ __forceinline__ void fetch(int t0, int n, Seg& g) const {
    bcjr::load_seg<kSeg>(sys, t0, n, vec, g.s);
    bcjr::load_seg<kSeg>(idx, t0, n, vec, g.j);
    bcjr::load_seg<kSeg>(par, t0, n, vec, g.p);
  }
  __device__ __forceinline__ void unpack(const Seg& g, int n, float (&l)[kSeg],
                                         float (&p)[kSeg]) const {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      if (i < n) l[i] = g.s[i] + s_row[g.j[i]];
      p[i] = g.p[i];
    }
  }
  __device__ __forceinline__ void store(int t0, int n, const float (&e)[kSeg]) const {
    bcjr::store_seg<kSeg>(ext, t0, n, vec, e);
  }
};

// With parts == 1, block c decodes code blocks c*cbs .. c*cbs + cbs - 1
// (fewer in the last), thread t window t % W of code block t / W; with
// parts > 1 (W > kMaxThreads), cbs == 1 and blocks c*parts .. c*parts +
// parts - 1 share code block c, part p taking windows p*blockDim on.
// Dynamic shared memory: the ext_other rows [cbs][k], then the
// checkpoints [lw / kSeg][8][blockDim].
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
bcjr_half_fused_kernel(const float* __restrict__ sys, const float* __restrict__ par,
                       const float* __restrict__ ext_other, const int* __restrict__ idx,
                       const float* __restrict__ alast_prev,
                       const float* __restrict__ bfirst_prev, const float* __restrict__ tail_b,
                       float* __restrict__ ext, float* __restrict__ alast,
                       float* __restrict__ bfirst, int blocks_b, int k, int lw, int cbs,
                       int parts, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int W = k / lw;
  const int cb0 = blockIdx.x / parts * cbs;
  const int ncb = min(cbs, blocks_b - cb0);
  float* s_row = smem;
  float* s_ckpt = smem + cbs * k;
  const float* src = ext_other + static_cast<long long>(cb0) * k;
  tma_load_rows(s_row, src, static_cast<uint32_t>(ncb * k * sizeof(float)), &bar);

  const int cb = parts == 1 ? tid / W : 0;  // code block within the CTA
  const int wi = parts == 1 ? tid - cb * W : blockIdx.x % parts * blockDim.x + tid;
  if (cb >= ncb || wi >= W) return;
  const int b = cb0 + cb;
  const int w = b * W + wi;  // window index in [B * W]
  float a[kStates], bt[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    a[s] = wi == 0 ? (s == 0 ? 0.f : kNeg) : alast_prev[(w - 1) * kStates + s];
    bt[s] = wi == W - 1 ? tail_b[b * kStates + s] : bfirst_prev[(w + 1) * kStates + s];
  }
  const int row = w * lw;  // = b * k + wi * lw
  const GatherIO io{sys + row, par + row, idx + wi * lw, s_row + cb * k, ext + row, vec};
  bcjr::r2_window<kSeg, bcjr::Norm::kMax>(io, s_ckpt + tid, blockDim.x, lw, a, bt);
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    alast[w * kStates + s] = a[s];
    bfirst[w * kStates + s] = bt[s];
  }
}

struct Config {
  int cbs;       // code blocks per CTA
  int parts;     // CTAs per code block
  int threads;   // cbs * W, or ceil(W / parts)
  size_t smem;   // rows + checkpoints
};

int config(long long blocks_b, int k, int lw, Config* c) {
  if (blocks_b <= 0 || k <= 0 || lw <= 0 || k % lw != 0 || k % 4 != 0 ||
      blocks_b * k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = k / lw;
  const long long row = static_cast<long long>(k) * sizeof(float);
  long long cbs = kMaxThreads / W;
  if (cbs * row > kRowBudget) cbs = kRowBudget / row;
  if (cbs < 1) cbs = 1;
  if (cbs > blocks_b) cbs = blocks_b;
  c->cbs = static_cast<int>(cbs);
  c->parts = (W + kMaxThreads - 1) / kMaxThreads;
  c->threads = c->parts == 1 ? c->cbs * W : (W + c->parts - 1) / c->parts;
  c->smem = static_cast<size_t>(cbs * row + c->threads * bcjr::ckpt_bytes<kSeg>(lw));
  return bcjr::allow_smem(bcjr_half_fused_kernel, c->smem);
}

}  // namespace

extern "C" {

// Launch the fused half on `stream` (a cudaStream_t, 0 for the default
// stream). Return the CUDA error code of the launch, 0 on success.
int srsue_bcjr_half_fused(const float* sys, const float* par, const float* ext_other,
                          const int* idx, const float* alast_prev, const float* bfirst_prev,
                          const float* tail_b, float* ext, float* alast, float* bfirst,
                          long long blocks_b, int k, int lw, void* stream) {
  Config c{};
  const int rc = config(blocks_b, k, lw, &c);
  if (rc != 0) return rc;
  const long long grid = (blocks_b + c.cbs - 1) / c.cbs * c.parts;
  if (grid > INT_MAX || !bcjr::aligned16(ext_other))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = lw % 4 == 0 && bcjr::aligned16(sys) && bcjr::aligned16(par) &&
                   bcjr::aligned16(idx) && bcjr::aligned16(ext);
  bcjr_half_fused_kernel<<<static_cast<unsigned>(grid), c.threads, c.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      sys, par, ext_other, idx, alast_prev, bfirst_prev, tail_b, ext, alast, bfirst,
      static_cast<int>(blocks_b), k, lw, c.cbs, c.parts, vec);
  return static_cast<int>(cudaGetLastError());
}

// Warps of the fused half resident on one SM for B code blocks of K bits
// in windows of lw, by the CUDA occupancy calculator for the launch
// configuration above. Return a CUDA error code.
int srsue_bcjr_half_fused_warps(long long blocks_b, int k, int lw, int* warps_out) {
  Config c{};
  const int rc = config(blocks_b, k, lw, &c);
  return rc != 0 ? rc : bcjr::warps_per_sm(bcjr_half_fused_kernel, c.threads, c.smem, warps_out);
}

}  // extern "C"
