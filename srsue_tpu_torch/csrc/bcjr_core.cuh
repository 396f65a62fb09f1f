// Shared pieces of the port's BCJR kernels (bcjr_half.cu, bcjr_half_r4.cu,
// bcjr_half_fused.cu): the RSC trellis as compile-time functions, the
// checkpointed radix-2 window recursion, and launch sizing.
//
// Every kernel runs one window per thread (two for the bf16x2 radix-4
// instance) with its 8 state metrics in registers. The forward pass stores
// alpha in shared memory only at every C-th step, [segment][state][thread]
// so that a warp's accesses hit 32 banks; the backward pass recomputes one
// segment's alphas at a time into registers from its checkpoint. The
// radix-2 window is r2_window below; the radix-4 one (bcjr_half_r4.cu)
// follows the same pattern with segments of 4 double steps.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

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

// ----------------------------------------------------- checkpointed window
// A window of lw steps is cut into segments of C steps (the last may be
// shorter); alpha is stored at the first step of each segment, C * 8
// floats of recomputed alphas live in registers. At lw = 64 and C = 8 the
// checkpoints take 256 B per window.
template <int C>
__host__ __device__ constexpr long long ckpt_bytes(int lw) {
  return static_cast<long long>((lw + C - 1) / C) * kStates * sizeof(float);
}

// One forward step: a holds alpha before the step, then after it. Both
// the forward pass and the backward pass's recomputation call this one
// function, so every recomputed alpha equals the stored one bit for bit.
template <Norm N>
__device__ __forceinline__ void fwd_step(float* a, float l, float p, int steps_done) {
  const float hl = 0.5f * l, hp = 0.5f * p;
  const float gpp = hl + hp, gpm = hl - hp;
  float nx[kStates];
#pragma unroll
  for (int sp = 0; sp < kStates; ++sp) {
    const int p0 = pred_state(sp, 0), p1 = pred_state(sp, 1);
    nx[sp] = fmaxf(add_gamma(a[p0], p0, pred_input(sp, 0), gpp, gpm),
                   add_gamma(a[p1], p1, pred_input(sp, 1), gpp, gpm));
  }
  normalise<N>(nx, steps_done);
#pragma unroll
  for (int s = 0; s < kStates; ++s) a[s] = nx[s];
}

// One backward step fused with the extrinsic: b holds beta after the
// step, then before it; al is alpha before the step. Returns the
// extrinsic (posterior - lin).
template <Norm N>
__device__ __forceinline__ float bwd_step(float* b, const float* al, float l, float p,
                                          int steps_done) {
  const float hl = 0.5f * l, hp = 0.5f * p;
  const float gpp = hl + hp, gpm = hl - hp;
  float nb[kStates];
  float l0 = -CUDART_INF_F, l1 = -CUDART_INF_F;
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    const float m0 = add_gamma(b[next_state(s, 0)], s, 0, gpp, gpm);
    const float m1 = add_gamma(b[next_state(s, 1)], s, 1, gpp, gpm);
    nb[s] = fmaxf(m0, m1);
    l0 = fmaxf(l0, al[s] + m0);
    l1 = fmaxf(l1, al[s] + m1);
  }
  normalise<N>(nb, steps_done);
#pragma unroll
  for (int s = 0; s < kStates; ++s) b[s] = nb[s];
  return (l0 - l1) - l;
}

// Whether a pointer allows 16-byte accesses (and bulk copies).
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ void from_bits(float& d, unsigned x) { d = __uint_as_float(x); }
__device__ __forceinline__ void from_bits(int& d, unsigned x) { d = static_cast<int>(x); }

// v[i] = row[t0 + i] for i < n (n <= C); as 16-byte loads when `vec`
// (row + t0 16-byte aligned) and the segment is whole.
template <int C, typename T>
__device__ __forceinline__ void load_seg(const T* __restrict__ row, int t0, int n, bool vec,
                                         T (&v)[C]) {
  static_assert(sizeof(T) == 4 && C % 4 == 0, "16-byte loads of 4-byte values");
  if (vec && n == C) {
    const uint4* q = reinterpret_cast<const uint4*>(row + t0);
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const uint4 x = __ldg(q + j);
      from_bits(v[4 * j], x.x);
      from_bits(v[4 * j + 1], x.y);
      from_bits(v[4 * j + 2], x.z);
      from_bits(v[4 * j + 3], x.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (i < n) v[i] = __ldg(row + t0 + i);
  }
}

// row[t0 + i] = v[i] for i < n, as 16-byte stores under the same rule.
template <int C>
__device__ __forceinline__ void store_seg(float* __restrict__ row, int t0, int n, bool vec,
                                          const float (&v)[C]) {
  if (vec && n == C) {
    float4* q = reinterpret_cast<float4*>(row + t0);
#pragma unroll
    for (int j = 0; j < C / 4; ++j)
      q[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (i < n) row[t0 + i] = v[i];
  }
}

// One window's radix-2 forward and backward recursion, checkpointed.
//   io     the window's rows, segment by segment: io.fetch(t0, n, seg)
//          issues the loads of steps t0..t0+n-1, io.unpack(seg, n, l, p)
//          gives their lin and par, io.store(t0, n, ext) writes their
//          extrinsic (posterior - lin); with IO::kPrefetch the next
//          segment's loads are issued before this one's recursion, so
//          they are in flight while it runs (at the cost of registers)
//   ckpt   this thread's first checkpoint word in shared memory; word
//          (g * 8 + s) * stride holds alpha[s] at step g * C
//   a, b   in: alpha at the window's first step, beta after its last;
//          out: alpha after the last step, beta before the first
// The forward recursion runs twice: once through, and once a segment at a
// time, last first, from each checkpoint on the way back.
template <int C, Norm N, class IO>
__device__ __forceinline__ void r2_window(const IO& io, float* ckpt, int stride, int lw,
                                          float* a, float* b) {
  const int nseg = (lw + C - 1) / C;
  typename IO::Seg cur, nxt;
  if constexpr (IO::kPrefetch) io.fetch(0, min(C, lw), nxt);
  for (int g = 0; g < nseg; ++g) {
    const int t0 = g * C;
    const int n = min(C, lw - t0);
    if constexpr (IO::kPrefetch) {
      cur = nxt;
      if (g + 1 < nseg) io.fetch(t0 + C, min(C, lw - t0 - C), nxt);
    } else {
      io.fetch(t0, n, cur);
    }
    float l[C], p[C];
    io.unpack(cur, n, l, p);
#pragma unroll
    for (int s = 0; s < kStates; ++s) ckpt[(g * kStates + s) * stride] = a[s];
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (i < n) fwd_step<N>(a, l[i], p[i], t0 + i + 1);
  }

  if constexpr (IO::kPrefetch) io.fetch((nseg - 1) * C, lw - (nseg - 1) * C, nxt);
  for (int g = nseg - 1; g >= 0; --g) {
    const int t0 = g * C;
    const int n = min(C, lw - t0);
    if constexpr (IO::kPrefetch) {
      cur = nxt;
      if (g > 0) io.fetch(t0 - C, C, nxt);
    } else {
      io.fetch(t0, n, cur);
    }
    float l[C], p[C];
    io.unpack(cur, n, l, p);
    float al[C][kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) al[0][s] = ckpt[(g * kStates + s) * stride];
#pragma unroll
    for (int i = 1; i < C; ++i) {
      if (i < n) {
#pragma unroll
        for (int s = 0; s < kStates; ++s) al[i][s] = al[i - 1][s];
        fwd_step<N>(al[i], l[i - 1], p[i - 1], t0 + i);
      }
    }
#pragma unroll
    for (int i = C - 1; i >= 0; --i)  // the extrinsic takes lin's register
      if (i < n) l[i] = bwd_step<N>(b, al[i], l[i], p[i], lw - (t0 + i));
    io.store(t0, n, l);
  }
}

// Warps of `kernel` resident on one SM at `threads` threads per block and
// `smem` bytes of dynamic shared memory (the kernel's shared-memory limit
// already set). Returns a CUDA error code.
template <typename Kernel>
int warps_per_sm(Kernel kernel, int threads, size_t smem, int* warps) {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *warps = blocks * ((threads + 31) / 32);
  return 0;
}

// Sets the kernel's dynamic shared-memory limit to `smem` bytes (with its
// static shared memory the block may need more than the default 48 KB);
// fails when that is above the card's opt-in maximum. Returns a CUDA
// error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Threads per block and dynamic shared memory of a checkpointed kernel
// whose threads each keep `per_thread` bytes of checkpoints: max_threads,
// fewer (a multiple of 32 where it can be) when their checkpoints do not
// fit; sets the kernel's shared-memory limit. Returns a CUDA error code.
template <typename Kernel>
int ckpt_config(Kernel kernel, long long per_thread, int max_threads, int* tpb, size_t* smem) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long t = smem_max / per_thread;
  if (t > max_threads) t = max_threads;
  if (t > 32) t -= t % 32;
  if (t < 1) return static_cast<int>(cudaErrorInvalidValue);  // window too long
  *tpb = static_cast<int>(t);
  *smem = static_cast<size_t>(t * per_thread);
  return allow_smem(kernel, *smem);
}

}  // namespace bcjr
