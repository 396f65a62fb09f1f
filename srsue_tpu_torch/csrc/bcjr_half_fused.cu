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
// gather, random within a block row of ext_other (23 KB at K=5824), 4 bytes
// of each 32-byte sector; the index slice is read coalesced. Measured on
// the H100 at the flagship shape (302,848 windows), this form takes 1.00 ms
// per half against 0.59 ms for bcjr_half.cu; 8 gathers in flight per
// thread took 1.60 ms, and gathering from the block's rows copied into
// shared memory first took 1.30 ms.

#include <climits>

#include "bcjr_core.cuh"

namespace {

using bcjr::kStates;

constexpr float kNeg = -1e9f;  // metric of an impossible state

__global__ void bcjr_half_fused_kernel(const float* __restrict__ sys,
                                       const float* __restrict__ par,
                                       const float* __restrict__ ext_other,
                                       const int* __restrict__ idx,
                                       const float* __restrict__ alast_prev,
                                       const float* __restrict__ bfirst_prev,
                                       const float* __restrict__ tail_b,
                                       float* __restrict__ ext,
                                       float* __restrict__ alast,
                                       float* __restrict__ bfirst,
                                       int n, int k, int lw) {
  extern __shared__ float smem[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * tpb;
  const int nw = n - w0 < tpb ? n - w0 : tpb;
  const int ls = lw + 1;
  const int W = k / lw;
  float* s_lin = smem;                 // [tpb][ls], ext on the way out
  float* s_par = s_lin + tpb * ls;     // [tpb][ls]
  float* s_alpha = s_par + tpb * ls;   // [lw][8][tpb]

  // windows w0.. are contiguous in [B, K]: position p is bit j of block b
  const int base = w0 * lw;
  const int cnt = nw * lw;
  for (int i = tid; i < cnt; i += tpb) {
    const int r = i / lw, c = i - r * lw;
    const int p = base + i;
    const int b = p / k, j = p - b * k;
    s_lin[r * ls + c] = sys[p] + ext_other[b * k + idx[j]];
    s_par[r * ls + c] = par[p];
  }
  __syncthreads();

  if (tid < nw) {
    const int w = w0 + tid;
    const int wi = w % W;
    const int b = w / W;
    float a[kStates], bt[kStates];
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      a[s] = wi == 0 ? (s == 0 ? 0.f : kNeg) : alast_prev[(w - 1) * kStates + s];
      bt[s] = wi == W - 1 ? tail_b[b * kStates + s] : bfirst_prev[(w + 1) * kStates + s];
    }
    bcjr::r2_window<bcjr::Norm::kMax>(s_lin + tid * ls, s_par + tid * ls, s_alpha, tpb, tid, lw,
                                      a, bt);
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      alast[w * kStates + s] = a[s];
      bfirst[w * kStates + s] = bt[s];
    }
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += tpb) {
    const int r = i / lw, c = i - r * lw;
    ext[base + i] = s_lin[r * ls + c];
  }
}

}  // namespace

extern "C" {

// Launch the fused half on `stream` (a cudaStream_t, 0 for the default
// stream). Return the CUDA error code of the launch, 0 on success.
int srsue_bcjr_half_fused(const float* sys, const float* par, const float* ext_other,
                          const int* idx, const float* alast_prev, const float* bfirst_prev,
                          const float* tail_b, float* ext, float* alast, float* bfirst,
                          long long blocks_b, int k, int lw, void* stream) {
  if (blocks_b <= 0 || k <= 0 || lw <= 0 || k % lw != 0 || blocks_b * k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(blocks_b * (k / lw));
  // shared memory of one window: staged lin and par rows + alpha history
  const long long per = static_cast<long long>(2 * (lw + 1) + kStates * lw) * sizeof(float);
  unsigned tpb = 0, grid = 0;
  size_t smem = 0;
  const int rc = bcjr::launch_config(bcjr_half_fused_kernel, per, n, &tpb, &grid, &smem);
  if (rc != 0) return rc;
  bcjr_half_fused_kernel<<<grid, tpb, smem, static_cast<cudaStream_t>(stream)>>>(
      sys, par, ext_other, idx, alast_prev, bfirst_prev, tail_b, ext, alast, bfirst, n, k, lw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
