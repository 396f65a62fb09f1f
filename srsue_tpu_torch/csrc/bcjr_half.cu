// Windowed max-log-MAP (BCJR) half-iteration of the LTE turbo decoder,
// radix-2, hand-written for Hopper (sm_90a). Two instances of one template
// on the metric normalisation (bcjr_core.cuh):
//
//   srsue_bcjr_half_r2max  per-step maximum: the arithmetic of
//                          srsue_tpu/phy/turbo.py::_bcjr_half_windowed;
//                          stands in for turbo_pallas.py::_half_kernel_v4
//                          (launched by half_tiled) on the port's default path;
//   srsue_bcjr_half_v2v3   state 0 every 8 steps: replaces
//                          turbo_pallas.py::_half_kernel (v2) and
//                          ::_half_kernel_v3, which perform the same float32
//                          operations and differ only in how the TPU schedules
//                          them (0.5*lin + 0.5*par == 0.5*(lin + par) exactly).
//
// The I/O contract is that of half_windowed_pallas: for n independent
// (code block, window) pairs of lw trellis steps each,
//   inputs   lin [n, lw]  systematic + a-priori LLRs
//            par [n, lw]  parity LLRs
//            a0  [n, 8]   alpha at the window's first step
//            b0  [n, 8]   beta after the window's last step
//   outputs  ext [n, lw]  extrinsic LLRs (posterior - lin)
//            alast  [n, 8]  alpha after the last step
//            bfirst [n, 8]  beta before the first step
// all float32, row-major and contiguous. The results match the plain
// PyTorch twins (kernels/bcjr.py) up to float32 rounding of the same
// operations.
//
// What bounds it on the card: each window is a sequential chain of 2*lw
// dependent add-compare-select steps over 8 states, and the backward pass
// needs every forward alpha of its window. The first form kept that whole
// history (lw * 8 floats = 2 KB at lw=64) and the staged lin/par rows in
// shared memory, which held an SM to one block of 90 threads (2.8 warps
// for 4 schedulers) and took 0.59 ms per half at the flagship shape,
// whatever the chain depth. This form trades arithmetic for residency:
//   * one thread per window; the 8 state metrics live in registers and
//     the trellis is unrolled at compile time, so every index is static;
//   * alpha is checkpointed every kSeg steps in shared memory (256 B
//     per window at lw=64) and recomputed a segment at a time into
//     registers on the way back (bcjr_core.cuh), so registers, not shared
//     memory, set the occupancy: __launch_bounds__ asks for kMinBlocks
//     blocks of kThreads per SM;
//   * each thread reads its own window's lin and par and writes its ext
//     directly, 16-byte accesses where the rows are aligned: a 32-byte
//     sector holds 8 steps, and with little shared memory in use most of
//     the SM's 256 KB serves as L1. No staging, no __syncthreads.
// Measured on an H100 SXM (700 W) at the flagship shape: 16 warps per SM,
// 0.19 ms per half for both instances, with or without the next
// segment's loads issued ahead. A checkpoint every 4 steps (512 B per
// window, 12 warps, shared memory bound again) took 0.26 ms; asking for 5
// blocks per SM (96 registers) spilled and took 0.39 ms.

#include "bcjr_core.cuh"

namespace {

using bcjr::kStates;
using bcjr::Norm;

constexpr int kSeg = 8;         // trellis steps per alpha checkpoint
constexpr int kThreads = 128;   // threads (windows) per block
constexpr int kMinBlocks = 4;   // resident blocks per SM asked of the compiler

// The rows of one window: lin and par in, ext out. No prefetch: it took
// the kernel past its 128 registers (a 4-byte spill) for no gain.
struct RowIO {
  static constexpr bool kPrefetch = false;
  struct Seg {
    float l[kSeg], p[kSeg];
  };
  const float* lin;
  const float* par;
  float* ext;
  bool vec;
  __device__ __forceinline__ void fetch(int t0, int n, Seg& s) const {
    bcjr::load_seg<kSeg>(lin, t0, n, vec, s.l);
    bcjr::load_seg<kSeg>(par, t0, n, vec, s.p);
  }
  __device__ __forceinline__ void unpack(const Seg& s, int n, float (&l)[kSeg],
                                         float (&p)[kSeg]) const {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      l[i] = s.l[i];
      p[i] = s.p[i];
    }
  }
  __device__ __forceinline__ void store(int t0, int n, const float (&e)[kSeg]) const {
    bcjr::store_seg<kSeg>(ext, t0, n, vec, e);
  }
};

template <Norm N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bcjr_half_kernel(const float* __restrict__ lin, const float* __restrict__ par,
                 const float* __restrict__ a0, const float* __restrict__ b0,
                 float* __restrict__ ext, float* __restrict__ alast,
                 float* __restrict__ bfirst, long long n, int lw, bool vec) {
  extern __shared__ float s_ckpt[];  // [lw / kSeg][8][blockDim]
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= n) return;
  float a[kStates], b[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    a[s] = a0[w * kStates + s];
    b[s] = b0[w * kStates + s];
  }
  const long long row = w * lw;
  const RowIO io{lin + row, par + row, ext + row, vec};
  bcjr::r2_window<kSeg, N>(io, s_ckpt + threadIdx.x, blockDim.x, lw, a, b);
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    alast[w * kStates + s] = a[s];
    bfirst[w * kStates + s] = b[s];
  }
}

// Threads per block and dynamic shared memory: kThreads windows, fewer
// (a multiple of 32 where it can be) when their checkpoints do not fit.
template <Norm N>
int config(int lw, int* tpb, size_t* smem) {
  if (lw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == Norm::kState0 && lw % bcjr::kNormEvery != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bcjr::ckpt_config(bcjr_half_kernel<N>, bcjr::ckpt_bytes<kSeg>(lw), kThreads, tpb,
                           smem);
}

template <Norm N>
int launch(const float* lin, const float* par, const float* a0, const float* b0, float* ext,
           float* alast, float* bfirst, long long n, int lw, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int tpb = 0;
  size_t smem = 0;
  const int rc = config<N>(lw, &tpb, &smem);
  if (rc != 0) return rc;
  const long long blocks = (n + tpb - 1) / tpb;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      lw % 4 == 0 && bcjr::aligned16(lin) && bcjr::aligned16(par) && bcjr::aligned16(ext);
  bcjr_half_kernel<N><<<static_cast<unsigned>(blocks), tpb, smem,
                        static_cast<cudaStream_t>(stream)>>>(lin, par, a0, b0, ext, alast,
                                                             bfirst, n, lw, vec);
  return static_cast<int>(cudaGetLastError());
}

template <Norm N>
int warps(int lw, int* out) {
  int tpb = 0;
  size_t smem = 0;
  const int rc = config<N>(lw, &tpb, &smem);
  return rc != 0 ? rc : bcjr::warps_per_sm(bcjr_half_kernel<N>, tpb, smem, out);
}

}  // namespace

extern "C" {

// Launch a half-iteration on `stream` (a cudaStream_t, 0 for the default
// stream). Return the CUDA error code of the launch, 0 on success.
int srsue_bcjr_half_r2max(const float* lin, const float* par, const float* a0,
                          const float* b0, float* ext, float* alast, float* bfirst,
                          long long n, int lw, void* stream) {
  return launch<Norm::kMax>(lin, par, a0, b0, ext, alast, bfirst, n, lw, stream);
}

int srsue_bcjr_half_v2v3(const float* lin, const float* par, const float* a0,
                         const float* b0, float* ext, float* alast, float* bfirst,
                         long long n, int lw, void* stream) {
  return launch<Norm::kState0>(lin, par, a0, b0, ext, alast, bfirst, n, lw, stream);
}

// Warps of the instance resident on one SM at window length lw, by the
// CUDA occupancy calculator for the launch configuration above. Return a
// CUDA error code.
int srsue_bcjr_half_r2max_warps(int lw, int* warps_out) {
  return warps<Norm::kMax>(lw, warps_out);
}

int srsue_bcjr_half_v2v3_warps(int lw, int* warps_out) {
  return warps<Norm::kState0>(lw, warps_out);
}

}  // extern "C"
