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
// needs every forward alpha of its window (lw * 8 floats = 2 KB at lw=64).
// Keeping that history in registers is impossible and in device memory
// would move ~1.2 GB per half at the flagship shape (303k windows). The
// design:
//   * one thread per window; the 8 state metrics live in registers and
//     the trellis is unrolled at compile time, so every index is static;
//   * the alpha history lives in dynamic shared memory;
//   * a block's windows are contiguous in memory, so lin/par are staged
//     into shared memory with coalesced loads and ext is written back
//     through the same buffer;
//   * threads per block are chosen from the shared-memory need, which
//     bounds occupancy to ~90 threads per SM at lw=64.
// On the H100 both instances take the same 0.59 ms per half at the
// flagship shape although v2v3's dependent chain per step is a third as
// deep; issuing 8 loads per thread in the staging loop, or two smaller
// blocks per SM, moved it by 2-3%. The radix-4 kernels (bcjr_half_r4.cu),
// with half the steps and half the alpha history, take 0.37 ms.

#include "bcjr_core.cuh"

namespace {

using bcjr::kStates;
using bcjr::Norm;

template <Norm N>
__global__ void bcjr_half_kernel(const float* __restrict__ lin,
                                 const float* __restrict__ par,
                                 const float* __restrict__ a0,
                                 const float* __restrict__ b0,
                                 float* __restrict__ ext,
                                 float* __restrict__ alast,
                                 float* __restrict__ bfirst,
                                 long long n, int lw) {
  extern __shared__ float smem[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const long long w0 = static_cast<long long>(blockIdx.x) * tpb;
  const long long left = n - w0;
  const int nw = left < tpb ? static_cast<int>(left) : tpb;
  const int ls = lw + 1;
  float* s_lin = smem;                 // [tpb][ls], ext on the way out
  float* s_par = s_lin + tpb * ls;     // [tpb][ls]
  float* s_alpha = s_par + tpb * ls;   // [lw][8][tpb]

  const long long base = w0 * lw;
  const int cnt = nw * lw;
  for (int i = tid; i < cnt; i += tpb) {
    const int r = i / lw, c = i - r * lw;
    s_lin[r * ls + c] = lin[base + i];
    s_par[r * ls + c] = par[base + i];
  }
  __syncthreads();

  if (tid < nw) {
    const long long w = w0 + tid;
    float a[kStates], b[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      a[s] = a0[w * kStates + s];
      b[s] = b0[w * kStates + s];
    }
    bcjr::r2_window<N>(s_lin + tid * ls, s_par + tid * ls, s_alpha, tpb, tid, lw, a, b);
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      alast[w * kStates + s] = a[s];
      bfirst[w * kStates + s] = b[s];
    }
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += tpb) {
    const int r = i / lw, c = i - r * lw;
    ext[base + i] = s_lin[r * ls + c];
  }
}

template <Norm N>
int launch(const float* lin, const float* par, const float* a0, const float* b0, float* ext,
           float* alast, float* bfirst, long long n, int lw, void* stream) {
  if (n <= 0 || lw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == Norm::kState0 && lw % bcjr::kNormEvery != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // shared memory of one window: staged lin and par rows + alpha history
  const long long per = static_cast<long long>(2 * (lw + 1) + kStates * lw) * sizeof(float);
  unsigned tpb = 0, blocks = 0;
  size_t smem = 0;
  const int rc = bcjr::launch_config(bcjr_half_kernel<N>, per, n, &tpb, &blocks, &smem);
  if (rc != 0) return rc;
  bcjr_half_kernel<N><<<blocks, tpb, smem, static_cast<cudaStream_t>(stream)>>>(
      lin, par, a0, b0, ext, alast, bfirst, n, lw);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
