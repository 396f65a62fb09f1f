// Shared pieces of the port's BCJR kernels (bcjr_half.cu, bcjr_half_r4.cu,
// bcjr_half_fused.cu): the RSC trellis as compile-time functions, the
// radix-2 window recursion, and the launch configuration derived from the
// shared memory one thread needs.
//
// Every kernel keeps one window's state metrics in registers and the alpha
// history of its windows in dynamic shared memory, [step][state][thread],
// so that a warp's accesses hit 32 banks. The window rows of lin/par are
// staged into shared memory with row stride lw + 1 words (conflict-free for
// both the coalesced staging stores and the per-thread row reads).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace bcjr {

constexpr int kStates = 8;
constexpr int kNormEvery = 8;  // trellis steps between state-0 normalisations

// RSC trellis of 36.212 5.1.3.2 (g0 = 1 + D^2 + D^3, g1 = 1 + D + D^3),
// state bits (r1 r2 r3) with r1 newest -- the tables of
// srsue_tpu/phy/turbo.py::_trellis.
__host__ __device__ constexpr int next_state(int s, int u) {
  const int r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
  const int a = u ^ r2 ^ r3;
  return (a << 2) | (r1 << 1) | r2;
}

__host__ __device__ constexpr int parity(int s, int u) {
  const int r1 = (s >> 2) & 1, r2 = (s >> 1) & 1, r3 = s & 1;
  return u ^ r2 ^ r3 ^ r1 ^ r3;
}

// The two predecessors of state sp are 2*(sp&3) and 2*(sp&3)+1.
__host__ __device__ constexpr int pred_state(int sp, int j) {
  return 2 * (sp & 3) + j;
}

__host__ __device__ constexpr int pred_input(int sp, int j) {
  return next_state(pred_state(sp, j), 0) == sp ? 0 : 1;
}

constexpr bool trellis_consistent() {
  for (int sp = 0; sp < kStates; ++sp)
    for (int j = 0; j < 2; ++j)
      if (next_state(pred_state(sp, j), pred_input(sp, j)) != sp) return false;
  return true;
}
static_assert(trellis_consistent(), "predecessor formula disagrees with the trellis");

// gamma(s, u) = 0.5*lin*(1-2u) + 0.5*par*(1-2p(s,u)) is u_sign * (gpp if
// p(s,u) == u else gpm) with gpp = 0.5*(lin+par), gpm = 0.5*(lin-par):
// which of the two magnitudes, 0 = gpp, 1 = gpm.
__host__ __device__ constexpr int gamma_mag(int s, int u) {
  return parity(s, u) == u ? 0 : 1;
}

// Adds metric m to gamma(s, u) with the sign folded in (exact: fl(x - y) =
// fl(x + -y)).
__device__ __forceinline__ float add_gamma(float m, int s, int u, float gpp, float gpm) {
  const float mag = gamma_mag(s, u) == 0 ? gpp : gpm;
  return u == 0 ? m + mag : m - mag;
}

__device__ __forceinline__ float max8(const float* v) {
  return fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
               fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
}

// How the radix-2 recursion keeps its metrics bounded:
//   kMax    subtract the maximum after every step (the arithmetic of
//           srsue_tpu/phy/turbo.py::_bcjr_half_windowed);
//   kState0 subtract state 0's metric after every kNormEvery steps
//           (turbo_pallas.py::_half_kernel / _half_kernel_v3); needs
//           lw % kNormEvery == 0.
enum class Norm { kMax, kState0 };

template <Norm N>
__device__ __forceinline__ void normalise(float* x, int steps_done) {
  if (N == Norm::kMax) {
    const float mx = max8(x);
#pragma unroll
    for (int s = 0; s < kStates; ++s) x[s] -= mx;
  } else if (steps_done % kNormEvery == 0) {
    const float z = x[0];
#pragma unroll
    for (int s = 0; s < kStates; ++s) x[s] -= z;
  }
}

// One window's radix-2 forward and backward recursion.
//   my_lin   the window's staged lin row (lw values); the extrinsic
//            (posterior - lin) overwrites it step by step
//   my_par   the window's staged parity row
//   s_alpha  the block's alpha history [lw][8][tpb]; this thread's column
//   a, b     in: alpha at the first step, beta after the last step;
//            out: alpha after the last step, beta before the first step
template <Norm N>
__device__ __forceinline__ void r2_window(float* my_lin, const float* my_par, float* s_alpha,
                                          int tpb, int tid, int lw, float* a, float* b) {
  // ---- forward: alpha[t] is the metric before step t ----
  for (int t = 0; t < lw; ++t) {
    const float hl = 0.5f * my_lin[t], hp = 0.5f * my_par[t];
    const float gpp = hl + hp, gpm = hl - hp;
    float nx[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) s_alpha[(t * kStates + s) * tpb + tid] = a[s];
#pragma unroll
    for (int sp = 0; sp < kStates; ++sp) {
      const int p0 = pred_state(sp, 0), p1 = pred_state(sp, 1);
      nx[sp] = fmaxf(add_gamma(a[p0], p0, pred_input(sp, 0), gpp, gpm),
                     add_gamma(a[p1], p1, pred_input(sp, 1), gpp, gpm));
    }
    normalise<N>(nx, t + 1);
#pragma unroll
    for (int s = 0; s < kStates; ++s) a[s] = nx[s];
  }

  // ---- backward, fused with the extrinsic ----
  for (int t = lw - 1; t >= 0; --t) {
    const float l = my_lin[t];
    const float hl = 0.5f * l, hp = 0.5f * my_par[t];
    const float gpp = hl + hp, gpm = hl - hp;
    float nb[kStates];
    float l0 = -CUDART_INF_F, l1 = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      const float al = s_alpha[(t * kStates + s) * tpb + tid];
      const float m0 = add_gamma(b[next_state(s, 0)], s, 0, gpp, gpm);
      const float m1 = add_gamma(b[next_state(s, 1)], s, 1, gpp, gpm);
      nb[s] = fmaxf(m0, m1);
      l0 = fmaxf(l0, al + m0);
      l1 = fmaxf(l1, al + m1);
    }
    my_lin[t] = (l0 - l1) - l;
    normalise<N>(nb, lw - t);
#pragma unroll
    for (int s = 0; s < kStates; ++s) b[s] = nb[s];
  }
}

// Threads per block, blocks and dynamic shared memory for a kernel whose
// threads each need `per_thread` bytes of shared memory, `threads` threads
// in all; sets the kernel's shared-memory limit. Returns a CUDA error code.
template <typename Kernel>
int launch_config(Kernel kernel, long long per_thread, long long threads, unsigned* tpb_out,
                  unsigned* blocks_out, size_t* smem_out) {
  if (threads <= 0 || per_thread <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long tpb = smem_max / per_thread;
  if (tpb > 128) tpb = 128;
  if (tpb < 1) return static_cast<int>(cudaErrorInvalidValue);  // window too long
  const long long blocks = (threads + tpb - 1) / tpb;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tpb * per_thread);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *tpb_out = static_cast<unsigned>(tpb);
  *blocks_out = static_cast<unsigned>(blocks);
  *smem_out = smem;
  return 0;
}

}  // namespace bcjr
