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
// * Lane-chunk path (an (N, L) frontier, L % 4 == 0, delta / rank / extra
//   and the outputs 16-byte aligned, send and send' 4-byte aligned: the
//   K-lane ppr queries).  Bound: the same bytes with L of everything per
//   row and per source; on the base bin at L = 16, 692 MB, 0.2065 ms, of
//   which 627 MB are the row operands and outputs (17 L bytes a row).  The
//   first design gave each thread one (row, lane): each of a row's L
//   threads loaded the same mask, idx and val, divided by L at run time
//   and gathered one send byte and one delta a slot (0.7904 ms at L = 16,
//   3.8 × the bound).  Now a thread owns four consecutive lanes of one row
//   (block (L/4, 1024/L), ell_row.cuh's LaneChunkGrid, no runtime
//   division), and the row's mask, idx and val come once for its lanes.
//   At K = 8 and 16 with K-aligned mask rows the walk kernel: the
//   thread's rank and extra (16 bytes each) and its row's mask (one K-byte
//   load, a warp's 32 / (L/4) rows one contiguous span) first, then the
//   rows path's walk over the warp's 4-slot chunks up to its highest
//   occupied one, a chunk a pass: idx/val where occupied, the slot's four
//   send flags as one 4-byte load and its four deltas as one 16-byte load
//   (at L = 16 the row's four threads read one 64-byte segment), beside
//   each other and selected by the flags, sixteen terms onto four chains,
//   each in the reference's order; then 16-byte stores of rank' and d_in
//   and one 4-byte store of the four send' flags.  A pass holds one
//   chunk's operands (56 registers, four blocks an SM), so enough rows'
//   row operands are in flight to stream them.  Other K, a mask whose rows
//   are not K-aligned or 64-bit offsets take fold_row4 from L1
//   (pr_step_lanes_kernel).  The walk was held against min_step's
//   lane-chunk design (a warp's rows staged in shared memory, the whole
//   row's gathers at once) on the base bin (H100 80GB HBM3 at 700 W, cold
//   operands, `tools/ab_ppr_lanes.py` then): the walk took 0.2809–0.2810
//   ms at L = 16 (1.36 × the bound; staged 0.3882–0.3883, the thread
//   kernel 0.7864–0.7871), 0.0952–0.0953 at L = 4 (0.1204–0.1211;
//   0.2232–0.2243) and 0.9516–0.9560 at L = 64 (1.3754–1.3756;
//   2.9079–2.9085).
// * One thread per (row, lane) otherwise (any other L, a misaligned
//   frontier): the row's mask and occupied idx/val chunks in registers,
//   every gather, then the fold in registers (`ell_row.cuh`,
//   PrStepSlots), fold blocks of 128 slots for K > 128.  32-bit offsets
//   when they fit.
//
// `tools/ab_pr_step.py` holds the rows path against the alternatives
// tried on the main-path bin (PERF.md section 6).
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

// ----------------------------------------------------------------- lanes --

// Four lanes l0 .. l0+3 of one row (the lane-chunk path, ell_row.cuh): a
// slot's four send flags as one 4-byte load and its four deltas as one
// 16-byte load, both for every occupied slot, the deltas then selected by
// the flags.
template <typename I>
struct PrStepLanes {
  const float* delta;
  const unsigned char* send;
  int lanes;
  int l0;
  float damping;

  template <int C>
  __device__ __forceinline__ void operator()(const Slots<C>& s, float (&o)[C][4]) const {
    unsigned f[C];
    float4 g[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const I at = static_cast<I>(s.i[j]) * lanes + l0;
      f[j] = 0u;
      g[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s.m[j]) {
        f[j] = __ldg(reinterpret_cast<const unsigned*>(send + at));
        g[j] = __ldg(reinterpret_cast<const float4*>(delta + at));
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {   // the reference's order, rounded twice
      const float dv = __fmul_rn(damping, s.v[j]);
      o[j][0] = s.m[j] ? __fmul_rn(dv, (f[j] & 0xffu) ? g[j].x : 0.0f) : 0.0f;
      o[j][1] = s.m[j] ? __fmul_rn(dv, (f[j] & 0xff00u) ? g[j].y : 0.0f) : 0.0f;
      o[j][2] = s.m[j] ? __fmul_rn(dv, (f[j] & 0xff0000u) ? g[j].z : 0.0f) : 0.0f;
      o[j][3] = s.m[j] ? __fmul_rn(dv, (f[j] & 0xff000000u) ? g[j].w : 0.0f) : 0.0f;
    }
  }
};

// The lane-chunk epilogue: d_in = acc + extra, rank' = rank + d_in,
// send' = d_in > tol for lanes at .. at+3, one 16-byte store each and one
// 4-byte store of the four flags.
__device__ __forceinline__ void lanes_out(const float (&acc)[4], float4 rk, float4 ex,
                                          float tol, float* rank_out, float* d_out,
                                          bool* send_out, long long at) {
  const float d[4] = {__fadd_rn(acc[0], ex.x), __fadd_rn(acc[1], ex.y),
                      __fadd_rn(acc[2], ex.z), __fadd_rn(acc[3], ex.w)};
  *reinterpret_cast<float4*>(rank_out + at) =
      make_float4(__fadd_rn(rk.x, d[0]), __fadd_rn(rk.y, d[1]),
                  __fadd_rn(rk.z, d[2]), __fadd_rn(rk.w, d[3]));
  *reinterpret_cast<float4*>(d_out + at) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<unsigned*>(send_out + at) =
      (d[0] > tol ? 1u : 0u) | (d[1] > tol ? 1u << 8 : 0u) |
      (d[2] > tol ? 1u << 16 : 0u) | (d[3] > tol ? 1u << 24 : 0u);
}

// Blocks of the walk kernel an SM holds: registers capped to fit them, so
// enough rows' row-operand loads are in flight to stream them.
constexpr int kWalkBlocksPerSm = 4;

// The walk path (L % 4 == 0, aligned frontier, K = 8 or 16 with mask rows
// aligned to K bytes): one thread per (row, 4-lane chunk), block (L/4,
// 1024/L) as LaneChunkGrid gives it.  The thread's rank and extra (16
// bytes each) and its row's mask (one K-byte load, the same word for the
// row's L/4 threads) come first; the warp then walks its rows' 4-slot
// chunks up to the highest occupied one among them (the rows path's walk),
// one chunk a pass: idx/val of the chunk where occupied, its four send
// words and four delta float4s, sixteen terms onto four chains.
template <int KT>
__global__ void __launch_bounds__(kThreads, kWalkBlocksPerSm)
pr_step_walk_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                    const unsigned char* __restrict__ msk,
                    const float* __restrict__ delta,
                    const unsigned char* __restrict__ send,
                    const float* __restrict__ rank,
                    const float* __restrict__ extra,
                    float* __restrict__ rank_out, float* __restrict__ d_out,
                    bool* __restrict__ send_out, int rows, int lanes,
                    float damping, float tol) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int l0 = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  const bool live = r < rows && l0 < lanes;
  const int at = r * lanes + l0;
  unsigned w[KT / 4] = {};
  float4 rk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ex = rk;
  if (live) {
    if constexpr (KT == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(msk) + r);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(msk) + r);
      w[0] = q.x; w[1] = q.y;
    }
    rk = __ldcs(reinterpret_cast<const float4*>(rank + at));
    ex = __ldcs(reinterpret_cast<const float4*>(extra + at));
  }
  unsigned hi = 0;
#pragma unroll
  for (int q = 0; q < KT / 4; ++q)
    if (w[q]) hi = q + 1;
  const unsigned need = __reduce_max_sync(0xffffffffu, hi);
  const PrStepLanes<int> terms{delta, send, lanes, l0, damping};
  const int* ip = idx + r * KT;
  const float* vp = val + r * KT;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // KT empty slots sum to +0.0
#pragma unroll 1
  for (unsigned q = 0; q < need; ++q) {
    unsigned m = w[0];
#pragma unroll
    for (int k = 1; k < KT / 4; ++k)
      if (q == static_cast<unsigned>(k)) m = w[k];
    Slots<4> s;
    s.unpack(m, 0);
    s.load_occupied(ip + 4 * q, vp + 4 * q);
    float o[4][4];
    terms(s, o);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = q == 0 ? o[0][c] : __fadd_rn(acc[c], o[0][c]);
#pragma unroll
      for (int j = 1; j < 4; ++j) acc[c] = __fadd_rn(acc[c], o[j][c]);
    }
  }
  // the empty slots past chunk `need`: one +0.0 (the rows path)
  if (need > 0 && need < KT / 4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], 0.0f);
  }
  if (live) lanes_out(acc, rk, ex, tol, rank_out, d_out, send_out, at);
}

// The other lane-chunk launches (any K, mask rows not K-aligned, 64-bit
// offsets): fold_row4 from L1.
template <int KT, typename I>
__global__ void __launch_bounds__(kThreads)
pr_step_lanes_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                     const unsigned char* __restrict__ msk,
                     const float* __restrict__ delta,
                     const unsigned char* __restrict__ send,
                     const float* __restrict__ rank,
                     const float* __restrict__ extra,
                     float* __restrict__ rank_out, float* __restrict__ d_out,
                     bool* __restrict__ send_out, I rows, int k_slots,
                     int lanes, float damping, float tol) {
  const I r = static_cast<I>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int l0 = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (r >= rows || l0 >= lanes) return;
  const I at = r * lanes + l0;
  const I base = r * k_slots;
  float acc[4];
  fold_row4<kAddMul, KT, false>(idx + base, val + base, msk + base, k_slots,
                                PrStepLanes<I>{delta, send, lanes, l0, damping}, acc);
  lanes_out(acc, __ldcs(reinterpret_cast<const float4*>(rank + at)),
            __ldcs(reinterpret_cast<const float4*>(extra + at)), tol, rank_out,
            d_out, send_out, at);
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

template <int KT>
void launch_walk(const Args& a) {
  const LaneChunkGrid lg(a.rows, a.lanes);
  pr_step_walk_kernel<KT><<<lg.grid, lg.block, 0, a.stream>>>(
      static_cast<const int*>(a.idx), static_cast<const float*>(a.val),
      static_cast<const unsigned char*>(a.msk), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.send), static_cast<const float*>(a.rank),
      static_cast<const float*>(a.extra), static_cast<float*>(a.rank_out),
      static_cast<float*>(a.d_out), static_cast<bool*>(a.send_out),
      static_cast<int>(a.rows), a.lanes, a.damping, a.tol);
}

template <int KT, typename I>
void launch_lanes(const Args& a) {
  const LaneChunkGrid lg(a.rows, a.lanes);
  pr_step_lanes_kernel<KT, I><<<lg.grid, lg.block, 0, a.stream>>>(
      static_cast<const int*>(a.idx), static_cast<const float*>(a.val),
      static_cast<const unsigned char*>(a.msk), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.send), static_cast<const float*>(a.rank),
      static_cast<const float*>(a.extra), static_cast<float*>(a.rank_out),
      static_cast<float*>(a.d_out), static_cast<bool*>(a.send_out),
      static_cast<I>(a.rows), a.k_slots, a.lanes, a.damping, a.tol);
}

template <typename I>
void launch_lanes_k(const Args& a) {
  switch (a.k_slots) {
    case 8: launch_lanes<8, I>(a); break;
    case 16: launch_lanes<16, I>(a); break;
    default: launch_lanes<0, I>(a); break;
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
  const bool chunks = lane_chunks_apply(lanes, {delta, rank, extra, rank_out, d_out},
                                        {send, send_out});
  const bool walk = chunks && fits && mask_rows_aligned;
  if (fits && lanes == 1 && k_slots == 16 && mask_rows_aligned)
    launch_rows<16>(a);
  else if (fits && lanes == 1 && k_slots == 8 && mask_rows_aligned)
    launch_rows<8>(a);
  else if (walk && k_slots == 16)
    launch_walk<16>(a);
  else if (walk && k_slots == 8)
    launch_walk<8>(a);
  else if (chunks && fits)
    launch_lanes_k<int>(a);
  else if (chunks)
    launch_lanes_k<long long>(a);
  else if (fits)
    launch_thread_k<int>(a);
  else
    launch_thread_k<long long>(a);
  return static_cast<int>(cudaGetLastError());
}
