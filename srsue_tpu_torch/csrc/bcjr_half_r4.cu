// Radix-4 windowed max-log-MAP (BCJR) half-iteration of the LTE turbo
// decoder, hand-written for Hopper (sm_90a). Replaces
// srsue_tpu/phy/turbo_pallas.py::_half_kernel_v4 (the TPU default) and its
// bfloat16 form v5 (`_variant`), in two instances of one template:
//
//   srsue_bcjr_half_v4  float32, one window per thread;
//   srsue_bcjr_half_v5  bfloat16, two windows per thread, one in each lane
//                       of a __nv_bfloat162 register: every add, subtract
//                       and max is one packed bf16x2 instruction for two
//                       windows (the card's counterpart of v5's
//                       (16, 128) bf16-native tiles). Inputs are rounded
//                       to bf16 on the way into shared memory and the
//                       outputs widened back to float32, as v5 casts at
//                       its call and between halves.
//
// The I/O contract is that of bcjr_half.cu (half_windowed_pallas), float32
// in and out. The arithmetic is v4's, operation for operation, so the
// plain PyTorch twins (kernels/bcjr.py) round at the same points:
//   * two trellis steps per recursion step: the branch metric of a
//     two-step path is sign * (A_x +- B_y) with A = (gpp_t, gpm_t),
//     B = (gpp_t+1, gpm_t+1), gpp = 0.5*(lin+par), gpm = 0.5*(lin-par);
//     the 8 bases G are formed once per double step;
//   * each state takes a four-way max, max(max(c0, c1), max(c2, c3));
//   * alpha is stored at even steps only, [lw/2][8][thread];
//   * the backward pass emits both bits' extrinsics from
//     alpha_t + (beta_t+2 +- G), grouped by the two inputs (u1, u2);
//   * state 0's metric is subtracted every 4 double steps.
//
// What bounds it on the card: as for the radix-2 kernel, the sequential
// add-compare-select chain (now lw/2 double steps) and the shared memory
// per window, which sets how many windows an SM holds: 1,544 B per window
// in float32 at lw=64 (2,568 B radix-2), 772 B per window in bf16x2.

#include <cuda_bf16.h>

#include "bcjr_core.cuh"

namespace {

using bcjr::kStates;

// Key of the two-step branch metric of (sp, u1, u2), an index into the 8
// bases G[x*4 + y*2 + d] = A_x + B_y (d = 0) or A_x - B_y (d = 1); its
// sign is + for u1 = 0 (turbo_pallas.py::_radix4_tables).
__host__ __device__ constexpr int r4_key(int sp, int u1, int u2) {
  return bcjr::gamma_mag(sp, u1) * 4 + bcjr::gamma_mag(bcjr::next_state(sp, u1), u2) * 2 +
         (u1 != u2 ? 1 : 0);
}

// Arithmetic of one thread's windows.
struct F32 {
  using V = float;
  static constexpr int kLanes = 1;
  static constexpr int kStageDepth = 1;
  static __device__ __forceinline__ V add(V a, V b) { return a + b; }
  static __device__ __forceinline__ V sub(V a, V b) { return a - b; }
  static __device__ __forceinline__ V max(V a, V b) { return fmaxf(a, b); }
  static __device__ __forceinline__ V half(V a) { return 0.5f * a; }
  static __device__ __forceinline__ void put(V* row, int c, int, float x) { row[c] = x; }
  static __device__ __forceinline__ float get(const V* row, int c, int) { return row[c]; }
  static __device__ __forceinline__ V load(const float* p, long long w, bool, int s) {
    return p[w * kStates + s];
  }
  static __device__ __forceinline__ void store(float* p, long long w, bool, int s, V v) {
    p[w * kStates + s] = v;
  }
};

struct BF2 {
  using V = __nv_bfloat162;
  static constexpr int kLanes = 2;
  static constexpr int kStageDepth = 8;
  static __device__ __forceinline__ V add(V a, V b) { return __hadd2(a, b); }
  static __device__ __forceinline__ V sub(V a, V b) { return __hsub2(a, b); }
  static __device__ __forceinline__ V max(V a, V b) { return __hmax2(a, b); }
  static __device__ __forceinline__ V half(V a) { return __hmul2(a, __float2bfloat162_rn(0.5f)); }
  // lane 0 is the low half (.x), lane 1 the high half (.y)
  static __device__ __forceinline__ void put(V* row, int c, int lane, float x) {
    reinterpret_cast<__nv_bfloat16*>(row + c)[lane] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float get(const V* row, int c, int lane) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row + c)[lane]);
  }
  static __device__ __forceinline__ V load(const float* p, long long w, bool second, int s) {
    return __floats2bfloat162_rn(p[w * kStates + s], second ? p[(w + 1) * kStates + s] : 0.f);
  }
  static __device__ __forceinline__ void store(float* p, long long w, bool second, int s, V v) {
    p[w * kStates + s] = __low2float(v);
    if (second) p[(w + 1) * kStates + s] = __high2float(v);
  }
};

// Stages `cnt` elements into shared memory: element i = tid, tid + tpb, ...
// is read by value(i) and written by put(i, v), the loads of Depth elements
// issued before any of them is stored. A bf16x2 thread stages two windows
// and rounds each value on the way; with depth 8 its half takes 0.42 ms
// instead of 0.71 at the flagship shape on the H100, while the float32
// kernel is fastest at depth 1 (0.37 ms, 0.39 at depth 8).
template <int Depth, class T, class Value, class Put>
__device__ __forceinline__ void stage(int cnt, int tid, int tpb, Value value, Put put) {
  for (int i0 = tid; i0 < cnt; i0 += Depth * tpb) {
    T v[Depth];
#pragma unroll
    for (int u = 0; u < Depth; ++u) {
      const int i = i0 + u * tpb;
      if (i < cnt) v[u] = value(i);
    }
#pragma unroll
    for (int u = 0; u < Depth; ++u) {
      const int i = i0 + u * tpb;
      if (i < cnt) put(i, v[u]);
    }
  }
}

// The 8 two-step bases of the double step starting at trellis step t.
template <class A>
__device__ __forceinline__ void bases(const typename A::V* my_lin, const typename A::V* my_par,
                                      int t, typename A::V* G) {
  using V = typename A::V;
  const V l0 = my_lin[t], p0 = my_par[t], l1 = my_lin[t + 1], p1 = my_par[t + 1];
  const V a[2] = {A::half(A::add(l0, p0)), A::half(A::sub(l0, p0))};
  const V b[2] = {A::half(A::add(l1, p1)), A::half(A::sub(l1, p1))};
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      G[x * 4 + y * 2] = A::add(a[x], b[y]);
      G[x * 4 + y * 2 + 1] = A::sub(a[x], b[y]);
    }
}

// Subtracts state 0's metric from every state's.
template <class A>
__device__ __forceinline__ void subtract_state0(typename A::V* x) {
  const typename A::V z = x[0];
#pragma unroll
  for (int s = 0; s < kStates; ++s) x[s] = A::sub(x[s], z);
}

template <class A>
__device__ __forceinline__ typename A::V max4(const typename A::V* c) {
  return A::max(A::max(c[0], c[1]), A::max(c[2], c[3]));
}

template <class A>
__global__ void bcjr_half_r4_kernel(const float* __restrict__ lin,
                                    const float* __restrict__ par,
                                    const float* __restrict__ a0,
                                    const float* __restrict__ b0,
                                    float* __restrict__ ext,
                                    float* __restrict__ alast,
                                    float* __restrict__ bfirst,
                                    long long n, int lw) {
  using V = typename A::V;
  constexpr int L = A::kLanes;
  constexpr int ne2 = bcjr::kNormEvery / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* smem = reinterpret_cast<V*>(smem_raw);
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const long long w0 = static_cast<long long>(blockIdx.x) * tpb * L;
  const long long left = n - w0;
  const int nw = left < tpb * L ? static_cast<int>(left) : tpb * L;
  const int ls = lw + 1;
  const int half = lw / 2;
  V* s_lin = smem;                // [tpb][ls]; lane l of row r is window r*L + l
  V* s_par = s_lin + tpb * ls;    // [tpb][ls]
  V* s_alpha = s_par + tpb * ls;  // [lw/2][8][tpb]

  const long long base = w0 * lw;
  const int cnt = nw * lw;
  stage<A::kStageDepth, float2>(
      cnt, tid, tpb, [&](int i) { return make_float2(lin[base + i], par[base + i]); },
      [&](int i, float2 v) {
        const int r = i / lw, c = i - r * lw;
        A::put(s_lin + (r / L) * ls, c, r % L, v.x);
        A::put(s_par + (r / L) * ls, c, r % L, v.y);
      });
  if (L == 2 && (nw & 1)) {  // the last thread's second lane holds no window
    for (int c = tid; c < lw; c += tpb) {
      A::put(s_lin + (nw / 2) * ls, c, 1, 0.f);
      A::put(s_par + (nw / 2) * ls, c, 1, 0.f);
    }
  }
  __syncthreads();

  if (tid * L < nw) {
    const long long w = w0 + static_cast<long long>(tid) * L;
    const bool second = L == 2 && tid * L + 1 < nw;
    V* my_lin = s_lin + tid * ls;
    const V* my_par = s_par + tid * ls;
    V a[kStates], b[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      a[s] = A::load(a0, w, second, s);
      b[s] = A::load(b0, w, second, s);
    }

    // ---- forward: alpha at even steps ----
    for (int td = 0; td < half; ++td) {
      V G[8];
      bases<A>(my_lin, my_par, 2 * td, G);
#pragma unroll
      for (int s = 0; s < kStates; ++s) s_alpha[(td * kStates + s) * tpb + tid] = a[s];
      V nx[kStates];
#pragma unroll
      for (int s2 = 0; s2 < kStates; ++s2) {
        V c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sm = bcjr::pred_state(s2, i >> 1), u2 = bcjr::pred_input(s2, i >> 1);
          const int sp = bcjr::pred_state(sm, i & 1), u1 = bcjr::pred_input(sm, i & 1);
          const V g = G[r4_key(sp, u1, u2)];
          c[i] = u1 == 0 ? A::add(a[sp], g) : A::sub(a[sp], g);
        }
        nx[s2] = max4<A>(c);
      }
      if ((td + 1) % ne2 == 0) subtract_state0<A>(nx);
#pragma unroll
      for (int s = 0; s < kStates; ++s) a[s] = nx[s];
    }
#pragma unroll
    for (int s = 0; s < kStates; ++s) A::store(alast, w, second, s, a[s]);

    // ---- backward, fused with the joint two-bit extrinsic ----
    for (int td = half - 1; td >= 0; --td) {
      const int t = 2 * td;
      const V lt = my_lin[t], lt1 = my_lin[t + 1];
      V G[8];
      bases<A>(my_lin, my_par, t, G);
      V nb[kStates], gm[4];
#pragma unroll
      for (int sp = 0; sp < kStates; ++sp) {
        V bc[4];  // q = u1*2 + u2
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int u1 = q >> 1, u2 = q & 1;
          const int s2 = bcjr::next_state(bcjr::next_state(sp, u1), u2);
          const V g = G[r4_key(sp, u1, u2)];
          bc[q] = u1 == 0 ? A::add(b[s2], g) : A::sub(b[s2], g);
        }
        nb[sp] = max4<A>(bc);
        const V al = s_alpha[(td * kStates + sp) * tpb + tid];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const V p = A::add(bc[q], al);
          gm[q] = sp == 0 ? p : A::max(gm[q], p);
        }
      }
      my_lin[t] = A::sub(A::sub(A::max(gm[0], gm[1]), A::max(gm[2], gm[3])), lt);
      my_lin[t + 1] = A::sub(A::sub(A::max(gm[0], gm[2]), A::max(gm[1], gm[3])), lt1);
      if ((half - td) % ne2 == 0) subtract_state0<A>(nb);
#pragma unroll
      for (int s = 0; s < kStates; ++s) b[s] = nb[s];
    }
#pragma unroll
    for (int s = 0; s < kStates; ++s) A::store(bfirst, w, second, s, b[s]);
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += tpb) {
    const int r = i / lw, c = i - r * lw;
    ext[base + i] = A::get(s_lin + (r / L) * ls, c, r % L);
  }
}

// Shared memory of one thread: staged lin and par rows + even-step alphas.
template <class A>
long long per_thread(int lw) {
  return static_cast<long long>(2 * (lw + 1) + kStates * (lw / 2)) * sizeof(typename A::V);
}

template <class A>
int launch(const float* lin, const float* par, const float* a0, const float* b0, float* ext,
           float* alast, float* bfirst, long long n, int lw, void* stream) {
  // lw/2 double steps, normalised every 4: every LTE K is a multiple of 8
  if (n <= 0 || lw <= 0 || lw % bcjr::kNormEvery != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned tpb = 0, blocks = 0;
  size_t smem = 0;
  const int rc = bcjr::launch_config(bcjr_half_r4_kernel<A>, per_thread<A>(lw),
                                     (n + A::kLanes - 1) / A::kLanes, &tpb, &blocks, &smem);
  if (rc != 0) return rc;
  bcjr_half_r4_kernel<A><<<blocks, tpb, smem, static_cast<cudaStream_t>(stream)>>>(
      lin, par, a0, b0, ext, alast, bfirst, n, lw);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM at window length lw, for a grid of full blocks.
template <class A>
int warps(int lw, int* out) {
  if (lw <= 0 || lw % bcjr::kNormEvery != 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned tpb = 0, blocks = 0;
  size_t smem = 0;
  const int rc = bcjr::launch_config(bcjr_half_r4_kernel<A>, per_thread<A>(lw), 1LL << 20,
                                     &tpb, &blocks, &smem);
  return rc != 0 ? rc : bcjr::warps_per_sm(bcjr_half_r4_kernel<A>, tpb, smem, out);
}

}  // namespace

extern "C" {

// Launch a half-iteration on `stream` (a cudaStream_t, 0 for the default
// stream). Return the CUDA error code of the launch, 0 on success.
int srsue_bcjr_half_v4(const float* lin, const float* par, const float* a0, const float* b0,
                       float* ext, float* alast, float* bfirst, long long n, int lw,
                       void* stream) {
  return launch<F32>(lin, par, a0, b0, ext, alast, bfirst, n, lw, stream);
}

int srsue_bcjr_half_v5(const float* lin, const float* par, const float* a0, const float* b0,
                       float* ext, float* alast, float* bfirst, long long n, int lw,
                       void* stream) {
  return launch<BF2>(lin, par, a0, b0, ext, alast, bfirst, n, lw, stream);
}

// Warps of the instance resident on one SM at window length lw, by the
// CUDA occupancy calculator for the launch configuration above. Return a
// CUDA error code.
int srsue_bcjr_half_v4_warps(int lw, int* warps_out) { return warps<F32>(lw, warps_out); }

int srsue_bcjr_half_v5_warps(int lw, int* warps_out) { return warps<BF2>(lw, warps_out); }

}  // extern "C"
