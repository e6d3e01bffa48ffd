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
// Bound on the H100: bytes — the mask streamed once, idx/val of the
// occupied slots, a send flag per distinct source (and its x where the flag
// is set, unless x is the row operand), and 17 bytes of row operands and
// outputs per (row, lane).  The arithmetic is one ⊗ and one ⊕ per slot.
// On the SSSP grid (4,194,304 × 8, half the slots occupied) that is 243 MB,
// 0.0725 ms at 3.35 TB/s; the idx/val rows are 32-byte sectors, so a
// kernel moves every slot's words, about 1.4 × the bound's bytes.
//
// Design, (N,) frontiers: one thread per row, K a template parameter (8
// and 16 unrolled, any other K in 4-slot chunks; `ell_row.cuh`).  The
// row's mask (8 bytes at K = 8) and idx come first, all in flight
// together: with aligned tiles a warp loads its 32 rows of both coalesced
// into shared memory, 16 bytes a lane, and each thread takes its row from
// there (per-thread row loads would stride the warp by 32 bytes a load).
// Then every `send` gather of an occupied slot; then, where a flag is set,
// the x gather and the slot's val (16 bytes per 4-slot chunk that holds a
// set flag): late in an SSSP run few flags are set, and most val words
// are never read.  Then the fold in registers in the reference's order
// (sequential inside each bk = min(128, K) block, block partials left to
// right), and the epilogue: the four HBM round trips of the unfused
// gather -> segment-⊕ -> ⊕ -> compare chain become one pass.  32-bit
// offsets when they fit.  Every slot folds in (the ⊕ identity where it
// contributes nothing), so the chain is the reference's own.
//
// (N, L) frontiers (the K-lane queries: serving's batches of 4 and 16,
// MultiSourceMonotone).  Bound: the same bytes with L of everything per
// row and per source — on the grid's base bin at L = 16, 1,375 MB, 0.4105
// ms; at L = 4, 469 MB, 0.1401 ms.  The first design gave each thread one
// (row, lane): at L = 16 a warp covered 2 rows, each of a row's 16
// threads loaded the same mask and idx again and gathered one send byte
// and one x float per slot, so the path was bound by issued loads (1.2949
// ms, 3.2 × its bound).  Lane-chunk path, where L % 4 == 0, x / xrow /
// extra 16-byte aligned and send 4-byte aligned (`ell_row.cuh`): a thread
// owns four consecutive lanes of one row (block (L/4, 1024/L), no runtime
// division); the row's mask and idx come once for the four lanes, staged
// per warp in shared memory as above (32 / (L/4) rows a warp) where K is
// 8 or 16 with aligned tiles and L/4 a power of two up to 32, else from
// L1; a slot's four send flags are one 4-byte load and, where one is set,
// its four x values one 16-byte load (at L = 16 the four threads of a row
// read one 64-byte segment) and its chunk's val one 16-byte load; four
// independent fold chains in registers, each in the reference's order;
// 16-byte loads of xrow / extra, 16-byte stores of x' / d_in and one
// 4-byte store of the four send' flags.  Staging measured 0.58 against
// 0.63 ms for L1 row loads at L = 16 (`tools/ab_lanes.py`).  Any other L
// (3, 6) or a misaligned view takes the thread-per-(row, lane) kernel,
// bit-identical too.  One launch a call either way, nothing allocated.
#include "ell_row.cuh"

namespace graphhp {

template <int S, typename I>
struct MinStepSlots {
  const float* x;
  const unsigned char* send;
  int lanes;
  int l;

  template <int C>
  __device__ __forceinline__ void operator()(const Slots<C>& s, float (&o)[C]) const {
    using SR = Semiring<S>;
    I at[C];
    bool f[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      at[j] = static_cast<I>(s.i[j]) * lanes + l;
      f[j] = s.m[j] && __ldg(send + at[j]) != 0;
    }
    // val where not loaded yet: the 4-slot chunks with a flag set only
    float v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = s.v[j];
    if constexpr (C % 4 == 0) {
      if (s.v_later) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
          if (f[4 * q] | f[4 * q + 1] | f[4 * q + 2] | f[4 * q + 3]) {
            const float4 b = __ldg(reinterpret_cast<const float4*>(s.v_later) + q);
            v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z; v[4 * q + 3] = b.w;
          }
      }
    }
    float g[C];
#pragma unroll
    for (int j = 0; j < C; ++j) g[j] = f[j] ? __ldg(x + at[j]) : 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) o[j] = f[j] ? SR::times(g[j], v[j]) : SR::ident();
  }
};

template <int S, int KT, typename I>
__global__ void min_step_kernel(const int* __restrict__ idx,
                                const float* __restrict__ val,
                                const unsigned char* __restrict__ msk,
                                const float* __restrict__ x,
                                const unsigned char* __restrict__ send,
                                const float* __restrict__ xrow,
                                const float* __restrict__ extra,
                                float* __restrict__ x_out,
                                float* __restrict__ d_out,
                                bool* __restrict__ send_out,
                                I rows, int k_slots, int lanes) {
  using SR = Semiring<S>;
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * lanes) return;
  I r = t;
  int l = 0;
  if (lanes != 1) {
    r = t / lanes;
    l = static_cast<int>(t - r * lanes);
  }
  const I base = r * k_slots;
  const float acc = fold_row<S, KT>(idx + base, val + base, msk + base, k_slots,
                                    MinStepSlots<S, I>{x, send, lanes, l});
  const float d = SR::combine(acc, extra[t]);
  const float xr = xrow[t];
  x_out[t] = SR::combine(xr, d);
  d_out[t] = d;
  send_out[t] = SR::improves(d, xr);
}

// lanes == 1, K = 8 or 16, aligned tiles: each warp's rows staged (ell_row.cuh).
template <int S, int KT>
__global__ void min_step_staged_kernel(const int* __restrict__ idx,
                                       const float* __restrict__ val,
                                       const unsigned char* __restrict__ msk,
                                       const float* __restrict__ x,
                                       const unsigned char* __restrict__ send,
                                       const float* __restrict__ xrow,
                                       const float* __restrict__ extra,
                                       float* __restrict__ x_out,
                                       float* __restrict__ d_out,
                                       bool* __restrict__ send_out, int rows) {
  using SR = Semiring<S>;
  __shared__ StagedRows<KT> staged[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  const int nrow = min(32, rows - r0);
  if (nrow <= 0) return;                                 // warp-uniform
  StagedRows<KT>& st = staged[threadIdx.x >> 5];
  st.template load<kStageMaskIdx>(idx, val, msk, r0, nrow, lane);
  if (lane >= nrow) return;
  const int t = r0 + lane;
  const float acc = fold_staged_row<S, KT>(st, lane, true, false, idx + t * KT,
                                           val + t * KT,
                                           MinStepSlots<S, int>{x, send, 1, 0});
  const float d = SR::combine(acc, extra[t]);
  const float xr = xrow[t];
  x_out[t] = SR::combine(xr, d);
  d_out[t] = d;
  send_out[t] = SR::improves(d, xr);
}

// Four lanes l0 .. l0+3 of one row (the lane-chunk path, ell_row.cuh): a
// slot's four send flags as one 4-byte load, then, where one is set, its
// four x values as one 16-byte load and the chunk's val.
template <int S, typename I>
struct MinStepLanes {
  const float* x;
  const unsigned char* send;
  int lanes;
  int l0;

  template <int C>
  __device__ __forceinline__ void operator()(const Slots<C>& s, float (&o)[C][4]) const {
    using SR = Semiring<S>;
    I at[C];
    unsigned f[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      at[j] = static_cast<I>(s.i[j]) * lanes + l0;
      f[j] = s.m[j] ? __ldg(reinterpret_cast<const unsigned*>(send + at[j])) : 0u;
    }
    // val (s.v_later) of the 4-slot chunks with a flag set only
    float v[C];
    bool vec = false;
    if constexpr (C % 4 == 0) {
      if (aligned(s.v_later, 16)) {
        vec = true;
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (f[4 * q] | f[4 * q + 1] | f[4 * q + 2] | f[4 * q + 3])
            b = __ldg(reinterpret_cast<const float4*>(s.v_later) + q);
          v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z; v[4 * q + 3] = b.w;
        }
      }
    }
    if (!vec) {
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = f[j] ? __ldg(s.v_later + j) : 0.0f;
    }
    float4 g[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      g[j] = f[j] ? __ldg(reinterpret_cast<const float4*>(x + at[j]))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      o[j][0] = (f[j] & 0xffu) ? SR::times(g[j].x, v[j]) : SR::ident();
      o[j][1] = (f[j] & 0xff00u) ? SR::times(g[j].y, v[j]) : SR::ident();
      o[j][2] = (f[j] & 0xff0000u) ? SR::times(g[j].z, v[j]) : SR::ident();
      o[j][3] = (f[j] & 0xff000000u) ? SR::times(g[j].w, v[j]) : SR::ident();
    }
  }
};

// (N, L) frontiers, L % 4 == 0, aligned operands: one thread per (row,
// 4-lane chunk), block (cpr, 256 / cpr) (ell_row.cuh).  Staged: K = 8 or
// 16 and a warp's 32 / cpr rows staged in shared memory (mask and idx).
template <int S, int KT, bool Staged, typename I>
__global__ void __launch_bounds__(kThreads)
min_step_lanes_kernel(const int* __restrict__ idx,
                      const float* __restrict__ val,
                      const unsigned char* __restrict__ msk,
                      const float* __restrict__ x,
                      const unsigned char* __restrict__ send,
                      const float* __restrict__ xrow,
                      const float* __restrict__ extra,
                      float* __restrict__ x_out,
                      float* __restrict__ d_out,
                      bool* __restrict__ send_out,
                      I rows, int k_slots, int lanes) {
  using SR = Semiring<S>;
  const I r = static_cast<I>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const int l0 = 4 * c;
  const MinStepLanes<S, I> terms{x, send, lanes, l0};
  float acc[4];
  if constexpr (Staged) {
    __shared__ StagedRows<KT> staged[kThreads / 32];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int wrows = 32 / blockDim.x;                   // whole rows a warp
    const int r0 = static_cast<int>(r) - (threadIdx.y & (wrows - 1));
    const int nrow = min(wrows, static_cast<int>(rows) - r0);
    if (nrow <= 0) return;                               // warp-uniform
    StagedRows<KT>& st = staged[tid >> 5];
    st.template load<kStageMaskIdx>(idx, val, msk, r0, nrow, tid & 31);
    if (r >= rows) return;
    fold_staged_row4<S, KT>(st, threadIdx.y & (wrows - 1), true, false,
                            idx + r * KT, val + r * KT, terms, acc);
  } else {
    if (r >= rows || l0 >= lanes) return;
    const I base = r * k_slots;
    fold_row4<S, KT, true>(idx + base, val + base, msk + base, k_slots, terms, acc);
  }
  const I at = r * lanes + l0;
  const float4 e = __ldcs(reinterpret_cast<const float4*>(extra + at));
  const float4 xr = __ldg(reinterpret_cast<const float4*>(xrow + at));
  const float d[4] = {SR::combine(acc[0], e.x), SR::combine(acc[1], e.y),
                      SR::combine(acc[2], e.z), SR::combine(acc[3], e.w)};
  __stcs(reinterpret_cast<float4*>(x_out + at),
         make_float4(SR::combine(xr.x, d[0]), SR::combine(xr.y, d[1]),
                     SR::combine(xr.z, d[2]), SR::combine(xr.w, d[3])));
  __stcs(reinterpret_cast<float4*>(d_out + at), make_float4(d[0], d[1], d[2], d[3]));
  const unsigned flags = (SR::improves(d[0], xr.x) ? 1u : 0u) |
                         (SR::improves(d[1], xr.y) ? 1u << 8 : 0u) |
                         (SR::improves(d[2], xr.z) ? 1u << 16 : 0u) |
                         (SR::improves(d[3], xr.w) ? 1u << 24 : 0u);
  __stcs(reinterpret_cast<unsigned*>(send_out + at), flags);
}

template <int S, int KT, typename I>
void launch_k(const void* idx, const void* val, const void* msk, const void* x,
              const void* send, const void* xrow, const void* extra,
              void* x_out, void* d_out, void* send_out, long long rows,
              int k_slots, int lanes, cudaStream_t stream) {
  if constexpr (KT > 0 && sizeof(I) == 4) {
    if (can_stage<KT>(idx, val, msk, lanes)) {
      min_step_staged_kernel<S, KT><<<grid_for(rows), kThreads, 0, stream>>>(
          static_cast<const int*>(idx), static_cast<const float*>(val),
          static_cast<const unsigned char*>(msk), static_cast<const float*>(x),
          static_cast<const unsigned char*>(send), static_cast<const float*>(xrow),
          static_cast<const float*>(extra), static_cast<float*>(x_out),
          static_cast<float*>(d_out), static_cast<bool*>(send_out),
          static_cast<int>(rows));
      return;
    }
  }
  if (lane_chunks_apply(lanes, {x, xrow, extra, x_out, d_out}, {send, send_out})) {
    const LaneChunkGrid lg(rows, lanes);
    constexpr bool can = KT > 0 && sizeof(I) == 4;
    const bool staged = can && lane_chunks_stage<KT>(lanes, idx, val, msk);
    auto kernel = staged ? min_step_lanes_kernel<S, KT, can, I>
                         : min_step_lanes_kernel<S, KT, false, I>;
    kernel<<<lg.grid, lg.block, 0, stream>>>(
        static_cast<const int*>(idx), static_cast<const float*>(val),
        static_cast<const unsigned char*>(msk), static_cast<const float*>(x),
        static_cast<const unsigned char*>(send), static_cast<const float*>(xrow),
        static_cast<const float*>(extra), static_cast<float*>(x_out),
        static_cast<float*>(d_out), static_cast<bool*>(send_out),
        static_cast<I>(rows), k_slots, lanes);
    return;
  }
  min_step_kernel<S, KT, I><<<grid_for(rows * lanes), kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<const unsigned char*>(msk), static_cast<const float*>(x),
      static_cast<const unsigned char*>(send), static_cast<const float*>(xrow),
      static_cast<const float*>(extra), static_cast<float*>(x_out),
      static_cast<float*>(d_out), static_cast<bool*>(send_out),
      static_cast<I>(rows), k_slots, lanes);
}

template <int S, typename I>
void launch_i(const void* idx, const void* val, const void* msk, const void* x,
              const void* send, const void* xrow, const void* extra,
              void* x_out, void* d_out, void* send_out, long long rows,
              int k_slots, int lanes, cudaStream_t stream) {
  switch (k_slots) {
    case 8:
      launch_k<S, 8, I>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, stream);
      break;
    case 16:
      launch_k<S, 16, I>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, stream);
      break;
    default:
      launch_k<S, 0, I>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, stream);
      break;
  }
}

template <int S>
void launch(const void* idx, const void* val, const void* msk, const void* x,
            const void* send, const void* xrow, const void* extra,
            void* x_out, void* d_out, void* send_out, long long rows,
            long long n_src, int k_slots, int lanes, cudaStream_t stream) {
  if (fits_int32(rows, k_slots, lanes, n_src))
    launch_i<S, int>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, stream);
  else
    launch_i<S, long long>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, k_slots, lanes, stream);
}

}  // namespace graphhp

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// semiring that is not monotone or a fold block other than min(128, K)).
// `lanes` is 1 for an (N,) frontier; `n_src` is the frontier's N.
extern "C" int graphhp_min_step(int semiring, const void* idx,
                                const void* val, const void* msk,
                                const void* x, const void* send,
                                const void* xrow, const void* extra,
                                void* x_out, void* d_out, void* send_out,
                                long long rows, long long n_src, int k_slots,
                                int lanes, int bk, void* stream) {
  using namespace graphhp;
  if (bk != (k_slots < kFold ? k_slots : kFold) || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kMinAdd:
      launch<kMinAdd>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, n_src, k_slots, lanes, s);
      break;
    case kMaxAdd:
      launch<kMaxAdd>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, n_src, k_slots, lanes, s);
      break;
    case kMinMul:
      launch<kMinMul>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, n_src, k_slots, lanes, s);
      break;
    case kMaxMin:
      launch<kMaxMin>(idx, val, msk, x, send, xrow, extra, x_out, d_out, send_out, rows, n_src, k_slots, lanes, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
