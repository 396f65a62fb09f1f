// Windowed max-log-MAP (BCJR) half-iteration of the LTE turbo decoder,
// hand-written for Hopper (sm_90a).
//
// Replaces srsue_tpu/phy/turbo_pallas.py::_half_kernel_v4 (launched by
// half_tiled), with the I/O contract of half_windowed_pallas: for n
// independent (code block, window) pairs of lw trellis steps each,
//   inputs   lin [n, lw]  systematic + a-priori LLRs
//            par [n, lw]  parity LLRs
//            a0  [n, 8]   alpha at the window's first step
//            b0  [n, 8]   beta after the window's last step
//   outputs  ext [n, lw]  extrinsic LLRs (posterior - lin)
//            alast  [n, 8]  alpha after the last step
//            bfirst [n, 8]  beta before the first step
// all float32, row-major and contiguous. The arithmetic is that of
// srsue_tpu/phy/turbo.py::_bcjr_half_windowed: radix-2 steps, metrics
// normalised by their per-step maximum, so the results match the plain
// PyTorch twin (kernels/bcjr.py) up to float32 rounding of the same
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
//   * the alpha history lives in dynamic shared memory, laid out
//     [step][state][thread] so that a warp's accesses hit 32 banks;
//   * a block's windows are contiguous in memory, so lin/par are staged
//     into shared memory with coalesced loads (row stride lw+1 to avoid
//     bank conflicts) and ext is written back through the same buffer;
//   * threads per block are chosen from the shared-memory need, which
//     bounds occupancy to ~90 threads per SM at lw=64. The kernel is
//     therefore latency-bound on the add-compare-select chain; radix-4
//     steps and a split of the state work across threads are the levers
//     for a later change.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kStates = 8;

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

// Branch metric gamma(s, u) = 0.5*lin*(1-2u) + 0.5*par*(1-2p(s,u)) takes
// one of +-gpp, +-gpm with gpp = 0.5*lin + 0.5*par, gpm = 0.5*lin - 0.5*par.
// Adds metric m to it with the sign folded in (exact: fl(x - y) = fl(x + -y)).
__device__ __forceinline__ float add_gamma(float m, int s, int u, float gpp, float gpm) {
  const float mag = (parity(s, u) == u) ? gpp : gpm;
  return u == 0 ? m + mag : m - mag;
}

__device__ __forceinline__ float max8(const float* v) {
  return fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
               fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
}

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
    float* my_lin = s_lin + tid * ls;
    const float* my_par = s_par + tid * ls;

    // ---- forward: alpha[t] is the metric before step t ----
    float a[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) a[s] = a0[w * kStates + s];
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
      const float mx = max8(nx);
#pragma unroll
      for (int s = 0; s < kStates; ++s) a[s] = nx[s] - mx;
    }
#pragma unroll
    for (int s = 0; s < kStates; ++s) alast[w * kStates + s] = a[s];

    // ---- backward, fused with the extrinsic ----
    float b[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) b[s] = b0[w * kStates + s];
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
      const float mx = max8(nb);
#pragma unroll
      for (int s = 0; s < kStates; ++s) b[s] = nb[s] - mx;
    }
#pragma unroll
    for (int s = 0; s < kStates; ++s) bfirst[w * kStates + s] = b[s];
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += tpb) {
    const int r = i / lw, c = i - r * lw;
    ext[base + i] = s_lin[r * ls + c];
  }
}

}  // namespace

extern "C" {

// Launches the half-iteration on `stream` (a cudaStream_t, 0 for the
// default stream). Returns the CUDA error code of the launch, 0 on success.
int srsue_bcjr_half(const float* lin, const float* par, const float* a0,
                    const float* b0, float* ext, float* alast, float* bfirst,
                    long long n, int lw, void* stream) {
  if (n <= 0 || lw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // shared memory of one window: staged lin and par rows + alpha history
  const long long per = static_cast<long long>(2 * (lw + 1) + kStates * lw) * sizeof(float);
  long long tpb = smem_max / per;
  if (tpb > 128) tpb = 128;
  if (tpb < 1) return static_cast<int>(cudaErrorInvalidValue);  // lw too long
  const size_t smem = static_cast<size_t>(tpb * per);
  err = cudaFuncSetAttribute(bcjr_half_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + tpb - 1) / tpb;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  bcjr_half_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(tpb), smem,
                     static_cast<cudaStream_t>(stream)>>>(lin, par, a0, b0, ext, alast,
                                                          bfirst, n, lw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
