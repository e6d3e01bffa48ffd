// Semiring SpMV / SpMM over one sliced-ELL degree bin:
//
//     y[r, l] = ⊕_k  msk[r,k] ? val[r,k] ⊗ x[idx[r,k], l] : ident(⊕)
//
// Replaces `ell_spmv_pallas` (src/repro/kernels/ell_spmv/ell_spmv.py), the
// kernel behind remote delivery, local delivery and every spill bin of the
// fused local phases.  All five semirings, (N,) and (N, L) frontiers.
//
// Bound on the H100: bytes.  Each output element does K ⊕ and K ⊗ (a few
// flops per 9 bytes of idx/val/msk), far below the card's ratio of ~20
// float32 flops per byte, so the floor is streaming the idx/val/msk tiles
// once (9 bytes a slot) plus gathering x[idx] through L2 (the frontier is
// at most tens of MB and mostly L2-resident).
//
// Design (simple, first port): one thread per (row, lane).  The thread
// walks its row's slots in the reference's fold order — sequential inside
// each bk = min(128, K) slot block, block partials folded left to right —
// so the result is bit-identical to the Pallas kernel (and to the plain
// PyTorch version), `add_mul` included.  Masked and pad slots contribute
// the ⊕ identity rather than being skipped, as in the reference.  Loads of
// a row's slots are strided across the warp (coalescing, warp-per-row and
// cp.async/TMA staging are later work); L1 absorbs part of the waste for
// the narrow bins of the main path.
#include "semiring.cuh"

namespace graphhp {

template <int S>
__global__ void ell_spmv_kernel(const int* __restrict__ idx,
                                const float* __restrict__ val,
                                const bool* __restrict__ msk,
                                const float* __restrict__ x,
                                float* __restrict__ y,
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
        v = SR::times(rv[k], __ldg(x + static_cast<long long>(ri[k]) * lanes + l));
      }
      part = (j == 0) ? v : SR::combine(part, v);
    }
    acc = (k0 == 0) ? part : SR::combine(acc, part);
  }
  y[t] = acc;
}

template <int S>
void launch(const void* idx, const void* val, const void* msk, const void* x,
            void* y, long long rows, int k_slots, int lanes, int bk,
            cudaStream_t stream) {
  ell_spmv_kernel<S><<<grid_for(rows * lanes), kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<const bool*>(msk), static_cast<const float*>(x),
      static_cast<float*>(y), rows, k_slots, lanes, bk);
}

}  // namespace graphhp

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unknown semiring).  `lanes` is 1 for an (N,) frontier.
extern "C" int graphhp_ell_spmv(int semiring, const void* idx,
                                const void* val, const void* msk,
                                const void* x, void* y, long long rows,
                                int k_slots, int lanes, int bk,
                                void* stream) {
  using namespace graphhp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kAddMul: launch<kAddMul>(idx, val, msk, x, y, rows, k_slots, lanes, bk, s); break;
    case kMinAdd: launch<kMinAdd>(idx, val, msk, x, y, rows, k_slots, lanes, bk, s); break;
    case kMaxAdd: launch<kMaxAdd>(idx, val, msk, x, y, rows, k_slots, lanes, bk, s); break;
    case kMinMul: launch<kMinMul>(idx, val, msk, x, y, rows, k_slots, lanes, bk, s); break;
    case kMaxMin: launch<kMaxMin>(idx, val, msk, x, y, rows, k_slots, lanes, bk, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
