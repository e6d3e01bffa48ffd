// One fused monotone-semiring pseudo-superstep over the dense base bin:
//
//     d_in[r,l] = (⊕_k (msk[r,k] ∧ send[s,l]) ? x[s,l] ⊗ val[r,k] : ident)
//                 ⊕ extra[r,l],                         s = idx[r,k]
//     x'[r,l]   = xrow[r,l] ⊕ d_in[r,l]
//     send'     = d_in improves xrow   (< for min, > for max)
//
// Replaces `fused_min_step_pallas` (src/repro/kernels/min_step/min_step.py),
// the SSSP local phase of the hybrid engine (and WCC / widest path / random
// walk off the main path).  The four monotone semirings, (N,) and (N, L).
//
// Bound on the H100: bytes — the idx/val/msk tiles streamed once (9 bytes a
// slot), gathers of x and send through L2, and 9 bytes of row operands and
// outputs per (row, lane).  The arithmetic is one ⊗ and one ⊕ per slot.
//
// Design (simple, first port): one thread per (row, lane), the slot fold in
// the reference's order (sequential inside each bk = min(128, K) block,
// block partials left to right), then the epilogue in registers: the four
// HBM round trips of the unfused gather -> segment-⊕ -> ⊕ -> compare chain
// become one pass.  The send flag is read only for occupied slots.
#include "semiring.cuh"

namespace graphhp {

template <int S>
__global__ void min_step_kernel(const int* __restrict__ idx,
                                const float* __restrict__ val,
                                const bool* __restrict__ msk,
                                const float* __restrict__ x,
                                const bool* __restrict__ send,
                                const float* __restrict__ xrow,
                                const float* __restrict__ extra,
                                float* __restrict__ x_out,
                                float* __restrict__ d_out,
                                bool* __restrict__ send_out,
                                long long rows, int k_slots, int lanes,
                                int bk) {
  using SR = Semiring<S>;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * lanes) return;
  const long long r = t / lanes;
  const int l = static_cast<int>(t - r * lanes);
  const int* ri = idx + r * k_slots;
  const float* rv = val + r * k_slots;
  const bool* rm = msk + r * k_slots;

  float acc = SR::ident();
  for (int k0 = 0; k0 < k_slots; k0 += bk) {
    float part = SR::ident();
    for (int j = 0; j < bk; ++j) {
      const int k = k0 + j;
      float v = SR::ident();
      if (k < k_slots && rm[k]) {
        const long long s = static_cast<long long>(ri[k]) * lanes + l;
        if (__ldg(reinterpret_cast<const unsigned char*>(send) + s)) {
          v = SR::times(__ldg(x + s), rv[k]);
        }
      }
      part = (j == 0) ? v : SR::combine(part, v);
    }
    acc = (k0 == 0) ? part : SR::combine(acc, part);
  }
  const float d = SR::combine(acc, extra[t]);
  const float xr = xrow[t];
  x_out[t] = SR::combine(xr, d);
  d_out[t] = d;
  send_out[t] = SR::improves(d, xr);
}

template <int S>
void launch(const void* idx, const void* val, const void* msk, const void* x,
            const void* send, const void* xrow, const void* extra,
            void* x_out, void* d_out, void* send_out, long long rows,
            int k_slots, int lanes, int bk, cudaStream_t stream) {
  min_step_kernel<S><<<grid_for(rows * lanes), kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<const bool*>(msk), static_cast<const float*>(x),
      static_cast<const bool*>(send), static_cast<const float*>(xrow),
      static_cast<const float*>(extra), static_cast<float*>(x_out),
      static_cast<float*>(d_out), static_cast<bool*>(send_out), rows,
      k_slots, lanes, bk);
}

}  // namespace graphhp

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// semiring that is not monotone).  `lanes` is 1 for an (N,) frontier.
extern "C" int graphhp_min_step(int semiring, const void* idx,
                                const void* val, const void* msk,
                                const void* x, const void* send,
                                const void* xrow, const void* extra,
                                void* x_out, void* d_out, void* send_out,
                                long long rows, int k_slots, int lanes,
                                int bk, void* stream) {
  using namespace graphhp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kMinAdd:
      launch<kMinAdd>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, bk, s);
      break;
    case kMaxAdd:
      launch<kMaxAdd>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, bk, s);
      break;
    case kMinMul:
      launch<kMinMul>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, bk, s);
      break;
    case kMaxMin:
      launch<kMaxMin>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, bk, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
