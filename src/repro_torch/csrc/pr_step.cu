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
// Bound on the H100: bytes — the mask streamed once, idx/val of the
// occupied slots, a send flag per distinct source and its delta where the
// flag is set, and 17 bytes of row operands and outputs per (row, lane).
// Two multiplies and an add per slot, far below the float32 rate.  On the
// R-MAT 2^21 PageRank base bin (2,307,072 × 16, 1,281,709 slots occupied
// in 387,394 rows) that is 87 MB, 0.026 ms at 3.35 TB/s: 37 MB of mask,
// 39 MB of row operands and outputs.  A kernel moves more: at least a
// 32-byte sector of idx and one of val for each occupied row (the bound
// counts 8 bytes a slot), and the gathered frontier, cold in L2 at each
// call.
//
// Every path computes (float32(damping) · val) · contrib and sums with
// explicit __fmul_rn / __fadd_rn (nothing contracts into an FMA), in the
// reference's order (ROADMAP Queue 2): sequential inside each
// bk = min(128, K) block, block partials left to right.  val is read for
// every occupied slot: a slot whose send flag is clear still adds
// (damping·val)·0.0, which is -0.0 for a negative val and NaN for val =
// ±inf or NaN.  delta is gathered beside the send flag for every occupied
// slot and then selected by it: one dependent load less per row than
// gathering it after the flag, for the L2 traffic of the unsent slots.
//
// * Rows path (the main path: one lane, K = 8 or 16, mask rows aligned to
//   K bytes).  One thread per row, the row's mask as one 16- (8-) byte
//   streaming load, coalesced across the warp, with its rank and extra.
//   The bin is sparse and skewed (at K = 16: 83 % of rows empty, 32-row
//   spans holding 4 occupied slots at the median and 319 at the 99th
//   percentile).  So a warp walks its rows' 4-slot chunks only up to the
//   highest occupied one among its 32 rows (`__reduce_max_sync`), one
//   chunk a pass: idx/val of the chunk where occupied, its send and delta
//   gathers, its four terms onto the row's fold.  The slots past the last
//   chunk are empty in every row; their sum is the one +0.0 the fold then
//   adds.  A pass holds one chunk's operands, so the kernel fits 32
//   registers a thread and an SM holds 64 warps, whose rows' chains of
//   dependent loads cover each other.
// * One thread per (row, lane) otherwise (an (N, L) frontier, any other K,
//   a misaligned mask): the row's mask and occupied idx/val chunks in
//   registers, every gather, then the fold in registers (`ell_row.cuh`,
//   PrStepSlots), fold blocks of 128 slots for K > 128.  32-bit offsets
//   when they fit.
//
// `tools/ab_pr_step.py` holds this design against the alternatives tried
// on the main-path bin (PERF.md section 6).
#include <algorithm>

#include "ell_row.cuh"

namespace graphhp {

// Slot terms (float32(damping)·val)·(send ? delta : 0) of a Slots chunk,
// 0.0 for masked slots: every send and delta gather of the chunk first.
template <typename I>
struct PrStepSlots {
  const float* delta;
  const unsigned char* send;
  int lanes;
  int l;
  float damping;

  template <int C>
  __device__ __forceinline__ void operator()(const Slots<C>& s, float (&o)[C]) const {
    I at[C];
    bool f[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      at[j] = static_cast<I>(s.i[j]) * lanes + l;
      f[j] = s.m[j] && __ldg(send + at[j]) != 0;
    }
    float g[C];
#pragma unroll
    for (int j = 0; j < C; ++j) g[j] = s.m[j] ? __ldg(delta + at[j]) : 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j)   // the reference's order, rounded twice
      o[j] = s.m[j] ? __fmul_rn(__fmul_rn(damping, s.v[j]), f[j] ? g[j] : 0.0f) : 0.0f;
  }
};

template <int KT, typename I>
__global__ void pr_step_kernel(const int* __restrict__ idx,
                               const float* __restrict__ val,
                               const unsigned char* __restrict__ msk,
                               const float* __restrict__ delta,
                               const unsigned char* __restrict__ send,
                               const float* __restrict__ rank,
                               const float* __restrict__ extra,
                               float* __restrict__ rank_out,
                               float* __restrict__ d_out,
                               bool* __restrict__ send_out, I rows,
                               int k_slots, int lanes, float damping, float tol) {
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * lanes) return;
  I r = t;
  int l = 0;
  if (lanes != 1) {
    r = t / lanes;
    l = static_cast<int>(t - r * lanes);
  }
  const float rk = rank[t];
  const float ex = extra[t];
  const I base = r * k_slots;
  const float acc = fold_row<kAddMul, KT>(idx + base, val + base, msk + base, k_slots,
                                          PrStepSlots<I>{delta, send, lanes, l, damping});
  const float d = __fadd_rn(acc, ex);
  rank_out[t] = __fadd_rn(rk, d);
  d_out[t] = d;
  send_out[t] = d > tol;
}

// ------------------------------------------------------------------ rows --

// Blocks of the rows path an SM holds: its registers are capped to fit
// them (32 a thread, no spill, at 8), since the path is latency-bound.
constexpr int kRowBlocksPerSm = 8;

// Slots c0 .. c0+3 of the row, mask word `m`: idx/val where occupied, every
// send and delta gather, then their terms folded onto `acc` in slot order
// (`first`: the chunk starts the row's fold).
__device__ __forceinline__ float chunk_sum(float acc, bool first, unsigned m,
                                           const int* ip, const float* vp,
                                           const PrStepSlots<int>& terms) {
  Slots<4> s;
  s.unpack(m, 0);
  s.load_occupied(ip, vp);
  float o[4];
  terms(s, o);
  acc = first ? o[0] : __fadd_rn(acc, o[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) acc = __fadd_rn(acc, o[j]);
  return acc;
}

template <int KT>
__global__ void __launch_bounds__(kThreads, kRowBlocksPerSm)
pr_step_rows_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                    const unsigned char* __restrict__ msk,
                    const float* __restrict__ delta,
                    const unsigned char* __restrict__ send,
                    const float* __restrict__ rank,
                    const float* __restrict__ extra,
                    float* __restrict__ rank_out, float* __restrict__ d_out,
                    bool* __restrict__ send_out, int rows, float damping,
                    float tol) {
  const PrStepSlots<int> terms{delta, send, 1, 0, damping};
  // warp-uniform: a warp's 32 rows per pass
  for (int r0 = blockIdx.x * kThreads + (threadIdx.x & ~31); r0 < rows;
       r0 += gridDim.x * kThreads) {
    const int r = r0 + (threadIdx.x & 31);
    // the row operands first, all in flight together (an empty mask past
    // the last row)
    unsigned w[KT / 4] = {};
    float rk = 0.0f, ex = 0.0f;
    if (r < rows) {
      if constexpr (KT == 16) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(msk) + r);
        w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
      } else {
        const uint2 q = __ldcs(reinterpret_cast<const uint2*>(msk) + r);
        w[0] = q.x; w[1] = q.y;
      }
      rk = __ldcs(rank + r);
      ex = __ldcs(extra + r);
    }
    // the warp's rows hold no occupied slot past 4-slot chunk `need`
    unsigned hi = 0;
#pragma unroll
    for (int q = 0; q < KT / 4; ++q)
      if (w[q]) hi = q + 1;
    const unsigned need = __reduce_max_sync(0xffffffffu, hi);
    const int* ip = idx + static_cast<long long>(r) * KT;
    const float* vp = val + static_cast<long long>(r) * KT;
    float acc = 0.0f;                      // KT empty slots sum to +0.0
#pragma unroll 1
    for (unsigned q = 0; q < need; ++q) {
      unsigned m = w[0];
#pragma unroll
      for (int k = 1; k < KT / 4; ++k)
        if (q == static_cast<unsigned>(k)) m = w[k];
      acc = chunk_sum(acc, q == 0, m, ip + 4 * q, vp + 4 * q, terms);
    }
    // the empty slots past chunk `need` add +0.0 once (x + 0.0 + 0.0 =
    // x + 0.0; a -0.0 sum becomes +0.0, as the reference's does)
    if (need > 0 && need < KT / 4) acc = __fadd_rn(acc, 0.0f);
    if (r < rows) {
      const float d = __fadd_rn(acc, ex);
      rank_out[r] = __fadd_rn(rk, d);
      d_out[r] = d;
      send_out[r] = d > tol;
    }
  }
}

// ---------------------------------------------------------------- launch --

struct Args {
  const void* idx;
  const void* val;
  const void* msk;
  const void* delta;
  const void* send;
  const void* rank;
  const void* extra;
  void* rank_out;
  void* d_out;
  void* send_out;
  long long rows;
  int k_slots;
  int lanes;
  float damping;
  float tol;
  cudaStream_t stream;
};

template <int KT>
void launch_rows(const Args& a) {
  pr_step_rows_kernel<KT><<<grid_for(a.rows), kThreads, 0, a.stream>>>(
      static_cast<const int*>(a.idx), static_cast<const float*>(a.val),
      static_cast<const unsigned char*>(a.msk), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.send), static_cast<const float*>(a.rank),
      static_cast<const float*>(a.extra), static_cast<float*>(a.rank_out),
      static_cast<float*>(a.d_out), static_cast<bool*>(a.send_out),
      static_cast<int>(a.rows), a.damping, a.tol);
}

template <int KT, typename I>
void launch_thread(const Args& a) {
  pr_step_kernel<KT, I><<<grid_for(a.rows * a.lanes), kThreads, 0, a.stream>>>(
      static_cast<const int*>(a.idx), static_cast<const float*>(a.val),
      static_cast<const unsigned char*>(a.msk), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.send), static_cast<const float*>(a.rank),
      static_cast<const float*>(a.extra), static_cast<float*>(a.rank_out),
      static_cast<float*>(a.d_out), static_cast<bool*>(a.send_out),
      static_cast<I>(a.rows), a.k_slots, a.lanes, a.damping, a.tol);
}

template <typename I>
void launch_thread_k(const Args& a) {
  switch (a.k_slots) {
    case 8: launch_thread<8, I>(a); break;
    case 16: launch_thread<16, I>(a); break;
    default: launch_thread<0, I>(a); break;
  }
}

}  // namespace graphhp

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// fold block other than min(128, K)).  `lanes` is 1 for an (N,) frontier;
// `n_src` is the frontier's N; `damping` and `tol` arrive already rounded
// to float32.
extern "C" int graphhp_pr_step(const void* idx, const void* val,
                               const void* msk, const void* delta,
                               const void* send, const void* rank,
                               const void* extra, void* rank_out,
                               void* d_out, void* send_out, long long rows,
                               long long n_src, int k_slots, int lanes,
                               int bk, float damping, float tol, void* stream) {
  using namespace graphhp;
  if (bk != std::min(kFold, k_slots) || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{idx, val, msk, delta, send, rank, extra, rank_out, d_out, send_out,
               rows, k_slots, lanes, damping, tol, static_cast<cudaStream_t>(stream)};
  const bool fits = fits_int32(rows, k_slots, lanes, n_src);
  // the rows path loads a row's mask as one K-byte word
  const bool mask_rows_aligned =
      (reinterpret_cast<uintptr_t>(msk) & static_cast<uintptr_t>(k_slots - 1)) == 0;
  if (fits && lanes == 1 && k_slots == 16 && mask_rows_aligned)
    launch_rows<16>(a);
  else if (fits && lanes == 1 && k_slots == 8 && mask_rows_aligned)
    launch_rows<8>(a);
  else if (fits)
    launch_thread_k<int>(a);
  else
    launch_thread_k<long long>(a);
  return static_cast<int>(cudaGetLastError());
}
