// One fused incremental-PageRank pseudo-superstep over the dense base bin:
//
//     d_in[r,l] = Σ_k (msk[r,k] ? (damping·val[r,k]) · (send[s,l] ? delta[s,l] : 0)
//                               : 0)  + extra[r,l],       s = idx[r,k]
//     rank'     = rank + d_in
//     send'     = d_in > tol
//
// Replaces `fused_pr_step_pallas` (src/repro/kernels/pr_step/pr_step.py),
// the PageRank local phase of the hybrid engine.  (N,) and (N, L) frontiers.
//
// Bound on the H100: bytes — the idx/val/msk tiles streamed once (9 bytes a
// slot), gathers of delta and send through L2, and 13 bytes of row operands
// and outputs per (row, lane).  Two multiplies and an add per slot.
//
// Design (simple, first port): one thread per (row, lane), the slot sum in
// the reference's order (sequential inside each bk = min(128, K) block,
// block partials left to right), the multiply order (float32(damping) ·
// val) · contrib, and explicit __fmul_rn / __fadd_rn so nothing contracts
// into an FMA: bit-identical to the Pallas kernel and the plain version.
// The epilogue runs in registers, one pass instead of four round trips.
#include "semiring.cuh"

namespace graphhp {

__global__ void pr_step_kernel(const int* __restrict__ idx,
                               const float* __restrict__ val,
                               const bool* __restrict__ msk,
                               const float* __restrict__ delta,
                               const bool* __restrict__ send,
                               const float* __restrict__ rank,
                               const float* __restrict__ extra,
                               float* __restrict__ rank_out,
                               float* __restrict__ d_out,
                               bool* __restrict__ send_out,
                               long long rows, int k_slots, int lanes, int bk,
                               float damping, float tol) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * lanes) return;
  const long long r = t / lanes;
  const int l = static_cast<int>(t - r * lanes);
  const int* ri = idx + r * k_slots;
  const float* rv = val + r * k_slots;
  const bool* rm = msk + r * k_slots;

  float acc = 0.0f;
  for (int k0 = 0; k0 < k_slots; k0 += bk) {
    float part = 0.0f;
    for (int j = 0; j < bk; ++j) {
      const int k = k0 + j;
      float v = 0.0f;
      if (k < k_slots && rm[k]) {
        const long long s = static_cast<long long>(ri[k]) * lanes + l;
        const float contrib =
            __ldg(reinterpret_cast<const unsigned char*>(send) + s) ? __ldg(delta + s) : 0.0f;
        v = __fmul_rn(__fmul_rn(damping, rv[k]), contrib);
      }
      part = (j == 0) ? v : __fadd_rn(part, v);
    }
    acc = (k0 == 0) ? part : __fadd_rn(acc, part);
  }
  const float d = __fadd_rn(acc, extra[t]);
  rank_out[t] = __fadd_rn(rank[t], d);
  d_out[t] = d;
  send_out[t] = d > tol;
}

}  // namespace graphhp

// Returns cudaGetLastError() after the launch.  `lanes` is 1 for an (N,)
// frontier; `damping` and `tol` arrive already rounded to float32.
extern "C" int graphhp_pr_step(const void* idx, const void* val,
                               const void* msk, const void* delta,
                               const void* send, const void* rank,
                               const void* extra, void* rank_out,
                               void* d_out, void* send_out, long long rows,
                               int k_slots, int lanes, int bk, float damping,
                               float tol, void* stream) {
  using namespace graphhp;
  pr_step_kernel<<<grid_for(rows * lanes), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<const bool*>(msk), static_cast<const float*>(delta),
      static_cast<const bool*>(send), static_cast<const float*>(rank),
      static_cast<const float*>(extra), static_cast<float*>(rank_out),
      static_cast<float*>(d_out), static_cast<bool*>(send_out), rows,
      k_slots, lanes, bk, damping, tol);
  return static_cast<int>(cudaGetLastError());
}
