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
//                       to bf16 in registers as they are loaded and the
//                       outputs widened back to float32, as v5 casts at
//                       its call and between halves.
//
// The I/O contract is that of bcjr_half.cu (half_windowed_pallas), float32
// in and out, with lw % 8 == 0. The arithmetic is v4's, operation for
// operation, so the plain PyTorch twins (kernels/bcjr.py) round at the
// same points:
//   * two trellis steps per recursion step: the branch metric of a
//     two-step path is sign * (A_x +- B_y) with A = (gpp_t, gpm_t),
//     B = (gpp_t+1, gpm_t+1), gpp = 0.5*(lin+par), gpm = 0.5*(lin-par);
//     the 8 bases G are formed once per double step;
//   * each state takes a four-way max, max(max(c0, c1), max(c2, c3));
//   * the backward pass emits both bits' extrinsics from
//     alpha_t + (beta_t+2 +- G), grouped by the two inputs (u1, u2);
//   * state 0's metric is subtracted every 4 double steps.
//
// What bounds it on the card: the sequential add-compare-select chain of
// lw/2 double steps per window, and how many windows an SM holds to hide
// its latency. The first form kept the staged lin/par rows and the whole
// even-step alpha history in shared memory (1,544 B per thread at lw=64),
// so shared memory held an SM to one block of 128 threads (4 warps). This
// form is the radix-2 kernels' (bcjr_core.cuh):
//   * alpha is checkpointed at the start of each segment of 4 double
//     steps, the normalisation period, in shared memory ([segment][state]
//     [thread], 256 B per thread at lw=64, for v5 two windows'); the
//     backward pass recomputes a segment's alphas into registers from its
//     checkpoint through the same inlined forward double step, so every
//     recomputed alpha equals the stored one bit for bit;
//   * each thread reads its windows' lin and par rows and writes ext
//     directly, 16-byte accesses where the rows are aligned; nothing is
//     staged and there is no __syncthreads;
//   * __launch_bounds__ asks for kMinBlocks blocks of kThreads per SM, so
//     registers, not shared memory, set the occupancy.
// Measured on an H100 SXM (700 W) at the flagship shape (302,848 windows
// of 64), device time per half: v4 0.186 ms (0.368 in the first form), v5
// 0.301 (0.417), both at 16 warps per SM (4) with 128 and 126 registers
// and no spills. v5 does each add and max of two windows in one packed
// instruction and still takes 1.6x v4's time for the same windows: on this
// card a packed bf16x2 instruction (HFMA2, HADD2, HMNMX2, VHMNMX in its
// SASS) costs about three float32 ones.

#include <cuda_bf16.h>

#include "bcjr_core.cuh"

namespace {

using bcjr::kStates;

constexpr int kSeg2 = bcjr::kNormEvery / 2;  // double steps per checkpoint segment
constexpr int kSeg = 2 * kSeg2;              // trellis steps per segment
constexpr int kThreads = 128;                // threads per block
constexpr int kMinBlocks = 4;                // resident blocks per SM asked of the compiler

// Key of the two-step branch metric of (sp, u1, u2), an index into the 8
// bases G[x*4 + y*2 + d] = A_x + B_y (d = 0) or A_x - B_y (d = 1); its
// sign is + for u1 = 0 (turbo_pallas.py::_radix4_tables).
__host__ __device__ constexpr int r4_key(int sp, int u1, int u2) {
  return bcjr::gamma_mag(sp, u1) * 4 + bcjr::gamma_mag(bcjr::next_state(sp, u1), u2) * 2 +
         (u1 != u2 ? 1 : 0);
}

// Arithmetic and row I/O of one thread's windows: window w, and for bf16x2
// also w + 1 when `second` (else that lane holds zeros).
struct F32 {
  using V = float;
  static constexpr int kLanes = 1;
  static __device__ __forceinline__ V add(V a, V b) { return a + b; }
  static __device__ __forceinline__ V sub(V a, V b) { return a - b; }
  static __device__ __forceinline__ V max(V a, V b) { return fmaxf(a, b); }
  static __device__ __forceinline__ V half(V a) { return 0.5f * a; }
  static __device__ __forceinline__ V load(const float* p, long long w, bool, int s) {
    return p[w * kStates + s];
  }
  static __device__ __forceinline__ void store(float* p, long long w, bool, int s, V v) {
    p[w * kStates + s] = v;
  }
  // steps t0..t0+kSeg-1 of the thread's rows (`row` is window w's)
  static __device__ __forceinline__ void fetch(const float* lin, const float* par, int, bool,
                                               int t0, bool vec, V (&l)[kSeg], V (&p)[kSeg]) {
    bcjr::load_seg<kSeg>(lin, t0, kSeg, vec, l);
    bcjr::load_seg<kSeg>(par, t0, kSeg, vec, p);
  }
  static __device__ __forceinline__ void emit(float* ext, int, bool, int t0, bool vec,
                                              const V (&e)[kSeg]) {
    bcjr::store_seg<kSeg>(ext, t0, kSeg, vec, e);
  }
};

struct BF2 {
  using V = __nv_bfloat162;
  static constexpr int kLanes = 2;
  static __device__ __forceinline__ V add(V a, V b) { return __hadd2(a, b); }
  static __device__ __forceinline__ V sub(V a, V b) { return __hsub2(a, b); }
  static __device__ __forceinline__ V max(V a, V b) { return __hmax2(a, b); }
  static __device__ __forceinline__ V half(V a) { return __hmul2(a, __float2bfloat162_rn(0.5f)); }
  // lane 0 is the low half (.x), window w; lane 1 the high half (.y), w + 1
  static __device__ __forceinline__ V load(const float* p, long long w, bool second, int s) {
    return __floats2bfloat162_rn(p[w * kStates + s], second ? p[(w + 1) * kStates + s] : 0.f);
  }
  static __device__ __forceinline__ void store(float* p, long long w, bool second, int s, V v) {
    p[w * kStates + s] = __low2float(v);
    if (second) p[(w + 1) * kStates + s] = __high2float(v);
  }
  static __device__ __forceinline__ void pack(const float* r0, const float* r1, bool second,
                                              int t0, bool vec, V (&v)[kSeg]) {
    float x[kSeg], y[kSeg];
    bcjr::load_seg<kSeg>(r0, t0, kSeg, vec, x);
    if (second) {
      bcjr::load_seg<kSeg>(r1, t0, kSeg, vec, y);
    } else {
#pragma unroll
      for (int i = 0; i < kSeg; ++i) y[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSeg; ++i) v[i] = __floats2bfloat162_rn(x[i], y[i]);
  }
  static __device__ __forceinline__ void fetch(const float* lin, const float* par, int lw,
                                               bool second, int t0, bool vec, V (&l)[kSeg],
                                               V (&p)[kSeg]) {
    pack(lin, lin + lw, second, t0, vec, l);
    pack(par, par + lw, second, t0, vec, p);
  }
  static __device__ __forceinline__ void emit(float* ext, int lw, bool second, int t0, bool vec,
                                              const V (&e)[kSeg]) {
    float x[kSeg], y[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      x[i] = __low2float(e[i]);
      y[i] = __high2float(e[i]);
    }
    bcjr::store_seg<kSeg>(ext, t0, kSeg, vec, x);
    if (second) bcjr::store_seg<kSeg>(ext + lw, t0, kSeg, vec, y);
  }
};

// The 8 two-step bases of the double step over (l0, p0), (l1, p1).
template <class A>
__device__ __forceinline__ void bases(typename A::V l0, typename A::V p0, typename A::V l1,
                                      typename A::V p1, typename A::V* G) {
  using V = typename A::V;
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

// One forward double step: a holds alpha before it, then after it. Both
// the forward pass and the backward pass's recomputation call this one
// function, so every recomputed alpha equals the stored one bit for bit.
template <class A>
__device__ __forceinline__ void fwd_double(typename A::V* a, typename A::V l0, typename A::V p0,
                                           typename A::V l1, typename A::V p1, bool norm) {
  using V = typename A::V;
  V G[8];
  bases<A>(l0, p0, l1, p1, G);
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
  if (norm) subtract_state0<A>(nx);
#pragma unroll
  for (int s = 0; s < kStates; ++s) a[s] = nx[s];
}

// One backward double step fused with the joint two-bit extrinsic: b holds
// beta after it, then before it; al is alpha before it; e0, e1 hold the two
// steps' lin, then their extrinsics (posterior - lin).
template <class A>
__device__ __forceinline__ void bwd_double(typename A::V* b, const typename A::V* al,
                                           typename A::V& e0, typename A::V& e1,
                                           typename A::V p0, typename A::V p1, bool norm) {
  using V = typename A::V;
  V G[8];
  bases<A>(e0, p0, e1, p1, G);
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
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const V p = A::add(bc[q], al[sp]);
      gm[q] = sp == 0 ? p : A::max(gm[q], p);
    }
  }
  e0 = A::sub(A::sub(A::max(gm[0], gm[1]), A::max(gm[2], gm[3])), e0);
  e1 = A::sub(A::sub(A::max(gm[0], gm[2]), A::max(gm[1], gm[3])), e1);
  if (norm) subtract_state0<A>(nb);
#pragma unroll
  for (int s = 0; s < kStates; ++s) b[s] = nb[s];
}

template <class A>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bcjr_half_r4_kernel(const float* __restrict__ lin, const float* __restrict__ par,
                    const float* __restrict__ a0, const float* __restrict__ b0,
                    float* __restrict__ ext, float* __restrict__ alast,
                    float* __restrict__ bfirst, long long n, int lw, bool vec) {
  using V = typename A::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // checkpoints [lw / kSeg][8][blockDim]: this thread's first word
  V* ckpt = reinterpret_cast<V*>(smem_raw) + threadIdx.x;
  const int stride = blockDim.x;
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * A::kLanes;
  if (w >= n) return;
  const bool second = A::kLanes == 2 && w + 1 < n;
  V a[kStates], b[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    a[s] = A::load(a0, w, second, s);
    b[s] = A::load(b0, w, second, s);
  }
  const long long row = w * lw;
  const float* my_lin = lin + row;
  const float* my_par = par + row;
  const int nseg = lw / kSeg;

  // ---- forward: a checkpoint at the start of each segment ----
  for (int g = 0; g < nseg; ++g) {
    V l[kSeg], p[kSeg];
    A::fetch(my_lin, my_par, lw, second, g * kSeg, vec, l, p);
#pragma unroll
    for (int s = 0; s < kStates; ++s) ckpt[(g * kStates + s) * stride] = a[s];
#pragma unroll
    for (int i = 0; i < kSeg2; ++i)  // state 0 is subtracted after the segment's last
      fwd_double<A>(a, l[2 * i], p[2 * i], l[2 * i + 1], p[2 * i + 1], i == kSeg2 - 1);
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) A::store(alast, w, second, s, a[s]);

  // ---- backward, a segment at a time, last first ----
  for (int g = nseg - 1; g >= 0; --g) {
    V l[kSeg], p[kSeg];
    A::fetch(my_lin, my_par, lw, second, g * kSeg, vec, l, p);
    V al[kSeg2][kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) al[0][s] = ckpt[(g * kStates + s) * stride];
#pragma unroll
    for (int i = 1; i < kSeg2; ++i) {
#pragma unroll
      for (int s = 0; s < kStates; ++s) al[i][s] = al[i - 1][s];
      fwd_double<A>(al[i], l[2 * i - 2], p[2 * i - 2], l[2 * i - 1], p[2 * i - 1], false);
    }
    // the extrinsics take lin's registers; lw/2 is a multiple of kSeg2, so
    // state 0 is subtracted after the segment's first double step
#pragma unroll
    for (int i = kSeg2 - 1; i >= 0; --i)
      bwd_double<A>(b, al[i], l[2 * i], l[2 * i + 1], p[2 * i], p[2 * i + 1], i == 0);
    A::emit(ext + row, lw, second, g * kSeg, vec, l);
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) A::store(bfirst, w, second, s, b[s]);
}

template <class A>
int config(int lw, int* tpb, size_t* smem) {
  // lw/2 double steps, normalised every 4: every LTE K is a multiple of 8
  if (lw <= 0 || lw % kSeg != 0) return static_cast<int>(cudaErrorInvalidValue);
  return bcjr::ckpt_config(bcjr_half_r4_kernel<A>, bcjr::ckpt_bytes<kSeg>(lw), kThreads, tpb,
                           smem);
}

template <class A>
int launch(const float* lin, const float* par, const float* a0, const float* b0, float* ext,
           float* alast, float* bfirst, long long n, int lw, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int tpb = 0;
  size_t smem = 0;
  const int rc = config<A>(lw, &tpb, &smem);
  if (rc != 0) return rc;
  const long long threads = (n + A::kLanes - 1) / A::kLanes;
  const long long blocks = (threads + tpb - 1) / tpb;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = bcjr::aligned16(lin) && bcjr::aligned16(par) && bcjr::aligned16(ext);
  bcjr_half_r4_kernel<A><<<static_cast<unsigned>(blocks), tpb, smem,
                           static_cast<cudaStream_t>(stream)>>>(lin, par, a0, b0, ext, alast,
                                                                bfirst, n, lw, vec);
  return static_cast<int>(cudaGetLastError());
}

template <class A>
int warps(int lw, int* out) {
  int tpb = 0;
  size_t smem = 0;
  const int rc = config<A>(lw, &tpb, &smem);
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
