// Semiring SpMV / SpMM over one sliced-ELL degree bin:
//
//     y[r, l] = ⊕_k  msk[r,k] ? val[r,k] ⊗ x[idx[r,k], l] : ident(⊕)
//
// Replaces `ell_spmv_pallas` (src/repro/kernels/ell_spmv/ell_spmv.py), the
// kernel behind remote delivery, local delivery and every spill bin of the
// fused local phases.  All five semirings, (N,) and (N, L) frontiers.
//
// Bound on the H100: bytes.  A slot costs a ⊗ and a ⊕ against 9 bytes of
// idx/val/mask, far below the card's ~20 float32 operations per byte.  A
// kernel that reads the mask whole is bound by the mask streamed once,
// idx/val of the occupied slots, the frontier values of their sources and
// the outputs.  On the hub bins the mask alone is over 90 % of that:
// 15,992 × 29,168 mask bytes are 466 MB (0.139 ms at 3.35 TB/s) for 1 %
// occupied slots, and `torch.sparse.mm` on the bin as a CSR matrix, which
// never reads padding, beat that bound by 3.3 ×.  So the wide bins (K >
// 128) read a block plan instead (`kernels/ell_spmv/plan.py`, built once
// per graph and bin) and no mask byte at all: the planned bound is the
// plan (16 bytes of occupancy bits and 8 or 12 of indices per occupied
// fold block), idx/val of the occupied slots, the sources and the
// outputs.
//
// Fold order.  Every path folds in the reference's order: slots
// sequentially inside each bk = min(128, K) block, block partials left to
// right — never a tree, for any semiring.  `add_mul` is not associative,
// and the order also fixes which NaN of several propagates.
//
// Two paths, chosen by K in the C entry, one launch each but for K > 128
// at L = 1 (two):
//
// * Narrow bins (K < 128: the base bins, K = 8 and 16 on the main path).
//   One thread per row of an (N,) frontier; K is a template parameter (8,
//   16, else a loop over 4-slot chunks).  With aligned tiles, a warp's 32
//   rows are one contiguous span of idx/val/mask: the warp loads its mask
//   coalesced into shared memory, and idx/val too where at least half of
//   their 32-byte sectors hold an occupied slot; otherwise each thread
//   loads the 4-slot chunks of its row that hold one, by 16-byte vector
//   loads (the sparse remote and PageRank base bins).  Then all gathers
//   are issued, and the fold runs in registers (`ell_row.cuh`).  32-bit
//   offsets when they fit.  Masked slots fold in as the ⊕ identity,
//   exactly as the reference's chain does.
//   (N, L) frontiers (serving's K-lane batches, PPR).  Bound: L × the
//   frontier and output bytes — on the SSSP grid's base bin at L = 16,
//   704 MB, 0.2102 ms.  The first design gave each thread one (row, lane):
//   each of a row's L threads loaded the same mask, idx and val again and
//   gathered one float a slot, bound by issued loads (0.9270 ms there).
//   Lane-chunk path, where L % 4 == 0 and x and y are 16-byte aligned: a
//   thread owns four consecutive lanes of one row (block (L/4, 1024/L),
//   no runtime division); its row's mask, idx and val come once for the
//   four lanes, staged per warp (32 / (L/4) rows a warp), all three in one
//   round of loads, where K is 8 or 16 with aligned tiles and L/4 a power
//   of two up to 32, else from L1; an occupied slot's four x values are
//   one 16-byte load (at L = 16 the four threads of a row read one 64-byte
//   segment); four independent fold chains in registers, each in the
//   reference's order; one 16-byte store.  Measured on the H100
//   (`tools/ab_lanes.py`), grid base bin at L = 16: 0.39 ms staged in one
//   round, 0.43 from L1, 0.44 staged mask first (kStageAdaptive); launch
//   bounds for more resident warps gained nothing on top.  Any other L
//   (3, 6) or a misaligned view keeps the thread-per-(row, lane) kernel,
//   bit-identical too.
//
// * Wide bins (K ≥ 128: every spill bin).  The work is split by (row,
//   128-slot fold block).  In a fold block a warp reads the 128 mask bytes
//   coalesced (4 bytes a lane) and takes the occupancy with
//   `__ballot_sync`.  An all-padding block's partial is the ⊕ identity and
//   none of its idx, val or x is read.  In an occupied block the lanes load
//   idx and val of their occupied slots (16 bytes a lane) and gather x, in
//   parallel, and store the products, compacted in slot order, in shared
//   memory; one lane then folds them in slot order.  Occupied slots need
//   not be a prefix of the row.
//   - K = 128: a warp per row, two consecutive rows at once where the bin
//     has enough rows to fill the card that way (two lanes fold in
//     parallel, twice the loads in flight).  The warps are persistent
//     (as many blocks as the card holds) and walk their rows with the next
//     group's mask words in flight while they fold the current one.
//   - K > 128: the block plan lists each row's occupied fold blocks in
//     block order (a CSR over fold blocks: ptr, blk, each entry's row)
//     with each block's occupancy as 128 bits, from which a lane makes its
//     mask word; the mask itself is not read.  The row's block partials
//     fold left to right, a run of all-padding blocks between, before or
//     after them as one ⊕ identity, since x ⊕ e ⊕ e = x ⊕ e bit for bit
//     (a row of no occupied block is e).  The design before gave each row
//     a thread block that streamed the row's whole mask into occupancy
//     bits first: one pass over the mask at nearly the memory rate, but
//     5.5 × the library on the hub bin at L = 1 and, on the local spill
//     1,720 × 7,056, one thread block a row with the densest row (55 fold
//     blocks over 7 warps) setting the time (2.9 ×).
//     L = 1: a warp per plan entry, so the work is balanced over the
//     bin's occupied blocks, not its rows; each warp leaves its block's
//     partial in a scratch vector, and a second launch folds each row's
//     partials in block order, a warp per row, so the result does not
//     depend on the order in which warps finish.  Measured on the H100 at
//     700 W (`tools/ab_wide_plan.py`, device ms, hub bin / local spill):
//     folding a row in the same launch instead, by its last warp to
//     arrive (an integer counter per row, `__threadfence` before each
//     arrival), 0.0693–0.0695 / 0.0111–0.0113 against 0.0636–0.0643 /
//     0.0112–0.0115 for two launches; two or four entries a warp (that
//     many lanes folding at once) 0.069 / 0.0127–0.0129 and 0.0755 /
//     0.0129 against 0.0652 / 0.0112–0.0115 for one; the occupancy read
//     from the mask's 128 bytes instead of the plan's bits 0.0652–0.0655 /
//     0.0112–0.0115 against 0.0629 / 0.0112–0.0113.
//     L > 1: a thread block per row takes the row's plan entries in rounds
//     of kRound (more than 256 occupied blocks: K > 32,768), the warps a
//     block each, partials in shared memory, one thread per output lane
//     folding them, the left-to-right fold carried from one round to the
//     next.  Rounds of 64 or 32 entries (more blocks an SM) gained nothing
//     (hub 0.303 / 0.309 ms against 0.301 at L = 16).
//   - Lane path (an (N, L) frontier, L % 4 == 0 beyond four lanes, x
//     16-byte aligned: the K-lane ppr queries' spill bins).  Bound: the
//     mask once (the plan at K > 128), idx/val of the occupied slots, 4 L
//     bytes per distinct source and per row.  The first design took lane chunks of four, one
//     per blockIdx.y, each chunk scanning the whole mask again and
//     gathering one float a lane: at L = 16 the hub bin's 466 MB mask was
//     read four times (1.0619 ms against a 0.1817 ms bound, H100 80GB
//     HBM3 at 700 W, `tools/ab_ppr_lanes.py`).  Now one block (K > 128)
//     or warp (K = 128) takes up to kWideLanes = 16 lanes in one pass: the
//     occupied blocks (from the plan at K > 128) and their idx/val are
//     read once for all of them.  In an occupied block the warp compacts the occupied slots'
//     (idx, val) in slot order into shared memory, then, kGroup = 32 slots
//     at a time, gathers every (slot, 4 lanes) as one 16-byte load (at
//     L = 16 four threads read a source's 64-byte segment, four loads a
//     thread in flight), stages the products per (slot, lane) in shared
//     memory (32 × 16 floats a warp), and one lane per output lane folds
//     them onto its chain in slot order; block partials per (block, lane),
//     kRound × 16 floats, folded left to right as above, one thread per
//     output lane.  A block of 8 warps takes 40 KB (K > 128) or 24 KB
//     (K = 128) of shared memory.  Measured at L = 16 (same card and
//     tool): staging a whole fold block's products at once (88 KB, two
//     blocks an SM) took 0.51–0.56 ms on the hub bin, 64 slots at a time
//     0.375, 32 slots 0.340.  At L = 64, four passes of 16 lanes beat one
//     pass of 64 (1.148 against 1.254 ms on the hub bin: 64 lanes of
//     partials take 64 KB, two blocks an SM).  L <= 4, any other L or a
//     misaligned x keep the 4-lane chunks of scalar gathers.
//
// Why skipping padding is exact.  The reference folds every slot, a masked
// or pad slot as the ⊕ identity e.  For min_add, max_add, min_mul and
// max_min, e = ±inf is a two-sided identity of nan_min / nan_max bit for
// bit (`nan_min(a, +inf)` is a, NaN included), so dropping it changes
// nothing.  For add_mul e = +0.0 is not quite one: a + 0.0 is a for every a
// except -0.0, which becomes +0.0, and a NaN stays a NaN.  Let S be the
// reference's chain over all 128 slots and T the chain over the occupied
// slots only.  Inductively S = T, or S = +0.0 while T = -0.0: adding an
// occupied value keeps that (±0.0 + v agree unless v = -0.0, which keeps
// +0.0 / -0.0), and adding +0.0 turns -0.0 into +0.0.  T ends at -0.0 only
// if every occupied value is -0.0 (a sum of nonzero terms that cancels
// rounds to +0.0), and then any skipped slot has set S to +0.0.  So a
// block that skipped at least one slot (masked, padding, or past K in a
// ragged last block) ends with part = part ⊕ e — for add_mul
// `__fadd_rn(part, 0.0f)`, a no-op for the others — and equals the
// reference's partial bit for bit (NaN payloads aside).  A block of no
// occupied slot is e.  The chip-side sweep in `chip_smoke.py` (signed
// zeros, ±inf ties, 1 %–100 % occupancy, empty blocks between occupied
// ones) holds this against the plain version.
#include <algorithm>

#include "ell_row.cuh"

namespace graphhp {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kWarps = 8;         // warps a block of the wide path, at most
constexpr int kLaneChunk = 4;     // output lanes a block takes on the scalar lane path
// Output lanes a wide-bin block takes in one pass on the lane path (L % 4
// == 0, L > 4, x 16-byte aligned); kLaneChunk (4): every (N, L) frontier
// takes the scalar lane path, the design before.
constexpr int kWideLanes = 16;
constexpr int kSub = 16;          // lanes of one staged product pass (lane path)
// Occupied slots of a fold block whose products a warp stages at once
// (lane path): kGroup * kSub / 128 16-byte gathers a lane in flight.
constexpr int kGroup = 32;
constexpr int kRound = 256;       // fold-block partials held in shared memory

// ---------------------------------------------------------------- narrow --

template <int S, typename I>
struct SpmvSlots {
  const float* x;
  int lanes;
  int l;

  template <int C>
  __device__ __forceinline__ void operator()(const Slots<C>& s, float (&o)[C]) const {
    using SR = Semiring<S>;
    float g[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      g[j] = s.m[j] ? __ldg(x + static_cast<I>(s.i[j]) * lanes + l) : 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) o[j] = s.m[j] ? SR::times(s.v[j], g[j]) : SR::ident();
  }
};

template <int S, int KT, typename I>
__global__ void ell_narrow_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ val,
                                  const unsigned char* __restrict__ msk,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, I rows, int k_slots,
                                  int lanes) {
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * lanes) return;
  I r = t;
  int l = 0;
  if (lanes != 1) {
    r = t / lanes;
    l = static_cast<int>(t - r * lanes);
  }
  const I base = r * k_slots;
  y[t] = fold_row<S, KT>(idx + base, val + base, msk + base, k_slots,
                         SpmvSlots<S, I>{x, lanes, l});
}

// lanes == 1, K = 8 or 16, aligned tiles: each warp's rows staged (ell_row.cuh).
template <int S, int KT>
__global__ void ell_narrow_staged_kernel(const int* __restrict__ idx,
                                         const float* __restrict__ val,
                                         const unsigned char* __restrict__ msk,
                                         const float* __restrict__ x,
                                         float* __restrict__ y, int rows) {
  __shared__ StagedRows<KT> staged[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  const int nrow = min(32, rows - r0);
  if (nrow <= 0) return;                                 // warp-uniform
  StagedRows<KT>& st = staged[threadIdx.x >> 5];
  const bool dense = st.template load<kStageAdaptive>(idx, val, msk, r0, nrow, lane);
  if (lane >= nrow) return;
  const int at = (r0 + lane) * KT;
  y[r0 + lane] = fold_staged_row<S, KT>(st, lane, dense, true, idx + at,
                                        val + at, SpmvSlots<S, int>{x, 1, 0});
}

// Four lanes l0 .. l0+3 of one row (the lane-chunk path, ell_row.cuh): an
// occupied slot's four x values as one 16-byte load.
template <int S, typename I>
struct SpmvLanes {
  const float* x;
  int lanes;
  int l0;

  template <int C>
  __device__ __forceinline__ void operator()(const Slots<C>& s, float (&o)[C][4]) const {
    using SR = Semiring<S>;
    float4 g[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      g[j] = s.m[j] ? __ldg(reinterpret_cast<const float4*>(
                          x + static_cast<I>(s.i[j]) * lanes + l0))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      o[j][0] = s.m[j] ? SR::times(s.v[j], g[j].x) : SR::ident();
      o[j][1] = s.m[j] ? SR::times(s.v[j], g[j].y) : SR::ident();
      o[j][2] = s.m[j] ? SR::times(s.v[j], g[j].z) : SR::ident();
      o[j][3] = s.m[j] ? SR::times(s.v[j], g[j].w) : SR::ident();
    }
  }
};

// (N, L) frontiers, L % 4 == 0, 16-byte aligned x and y: one thread per
// (row, 4-lane chunk), block (cpr, 256 / cpr) (ell_row.cuh).  Staged: K =
// 8 or 16 and a warp's 32 / cpr rows staged in shared memory, mask, idx
// and val in one round (kStageAll).
template <int S, int KT, bool Staged, typename I>
__global__ void __launch_bounds__(kThreads)
ell_lanes_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                 const unsigned char* __restrict__ msk,
                 const float* __restrict__ x, float* __restrict__ y, I rows,
                 int k_slots, int lanes) {
  const I r = static_cast<I>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const int l0 = 4 * c;
  const SpmvLanes<S, I> terms{x, lanes, l0};
  float acc[4];
  if constexpr (Staged) {
    __shared__ StagedRows<KT> staged[kThreads / 32];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int wrows = 32 / blockDim.x;                   // whole rows a warp
    const int r0 = static_cast<int>(r) - (threadIdx.y & (wrows - 1));
    const int nrow = min(wrows, static_cast<int>(rows) - r0);
    if (nrow <= 0) return;                               // warp-uniform
    StagedRows<KT>& st = staged[tid >> 5];
    st.template load<kStageAll>(idx, val, msk, r0, nrow, tid & 31);
    if (r >= rows) return;
    fold_staged_row4<S, KT>(st, threadIdx.y & (wrows - 1), true, true,
                            idx + r * KT, val + r * KT, terms, acc);
  } else {
    if (r >= rows || l0 >= lanes) return;
    const I base = r * k_slots;
    fold_row4<S, KT, false>(idx + base, val + base, msk + base, k_slots, terms, acc);
  }
  __stcs(reinterpret_cast<float4*>(y + r * lanes + l0),
         make_float4(acc[0], acc[1], acc[2], acc[3]));
}

// ------------------------------------------------------------------ wide --

// Mask bytes of slots s .. s+3 as one word (zero past K).
__device__ __forceinline__ unsigned mask_word(const unsigned char* rm,
                                              int k_slots, int s) {
  if (s + 4 <= k_slots && aligned(rm + s, 4))
    return __ldcs(reinterpret_cast<const unsigned*>(rm + s));
  unsigned w = 0;
  for (int j = 0; j < 4; ++j)
    if (s + j < k_slots && rm[s + j]) w |= 1u << (8 * j);
  return w;
}

// Bit j set when slot j of a mask word is occupied.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  unsigned occ = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) occ |= (((w >> (8 * j)) & 0xffu) != 0 ? 1u : 0u) << j;
  return occ;
}

// One warp folds RW consecutive 128-slot fold blocks at once: block j
// starts at slot j*128 of ri / rv and holds min(128, lim - j*128) real
// slots; this lane's mask word of block j is w[j] (its slots 4*lane ..
// 4*lane+3).  `stage` holds RW * 128 * lc floats of this warp.  Output lanes
// l0 .. l0+lc-1: lane j*lc + c returns block j's partial for output lane
// l0 + c and sets *n to the block's occupied slots.
template <int S, int RW>
__device__ __forceinline__ float warp_blocks(const int* ri, const float* rv,
                                             int lim, const unsigned (&w)[RW],
                                             const float* x, int lanes,
                                             int l0, int lc, float* stage,
                                             int lane, int* n) {
  using SR = Semiring<S>;
  const unsigned lt = (1u << lane) - 1u;
  unsigned occ[RW];
  int n_occ[RW], rank[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    occ[j] = nibble(w[j]);
    const unsigned q0 = __ballot_sync(kFullWarp, occ[j] & 1u);
    const unsigned q1 = __ballot_sync(kFullWarp, occ[j] & 2u);
    const unsigned q2 = __ballot_sync(kFullWarp, occ[j] & 4u);
    const unsigned q3 = __ballot_sync(kFullWarp, occ[j] & 8u);
    n_occ[j] = __popc(q0) + __popc(q1) + __popc(q2) + __popc(q3);
    rank[j] = __popc(q0 & lt) + __popc(q1 & lt) + __popc(q2 & lt) + __popc(q3 & lt);
  }
  // idx and val of this lane's occupied slots, every block at once
  int i[RW][4];
  float v[RW][4];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int s = j * kFold + 4 * lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) { i[j][q] = 0; v[j][q] = 0.0f; }
    if (!occ[j]) continue;
    if (s + 4 <= lim && aligned(ri + s, 16) && aligned(rv + s, 16)) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(ri + s));
      const float4 c = __ldcs(reinterpret_cast<const float4*>(rv + s));
      i[j][0] = a.x; i[j][1] = a.y; i[j][2] = a.z; i[j][3] = a.w;
      v[j][0] = c.x; v[j][1] = c.y; v[j][2] = c.z; v[j][3] = c.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (occ[j] & (1u << q)) {
          i[j][q] = __ldcs(ri + s + q);
          v[j][q] = __ldcs(rv + s + q);
        }
    }
  }
  // gathers, then the products, compacted in slot order
  for (int c = 0; c < lc; ++c) {
    float g[RW][4];
#pragma unroll
    for (int j = 0; j < RW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g[j][q] = (occ[j] & (1u << q))
                      ? __ldg(x + static_cast<long long>(i[j][q]) * lanes + l0 + c)
                      : 0.0f;
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      int p = j * kFold + rank[j];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (occ[j] & (1u << q)) stage[(p++) * lc + c] = SR::times(v[j][q], g[j][q]);
    }
  }
  __syncwarp();
  float part = SR::ident();
  const int jb = lane / lc, c = lane - jb * lc;
  int nj = 0;
#pragma unroll
  for (int j = 0; j < RW; ++j) nj = (jb == j) ? n_occ[j] : nj;
  if (jb < RW && nj > 0) {
    // one lane folds the block's products in slot order, eight loads ahead
    const float* st = stage + jb * kFold * lc + c;
    part = st[0];
    int p = 1;
    for (; p + 8 <= nj; p += 8) {
      float t[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) t[q] = st[(p + q) * lc];
#pragma unroll
      for (int q = 0; q < 8; ++q) part = SR::combine(part, t[q]);
    }
    for (; p < nj; ++p) part = SR::combine(part, st[p * lc]);
    // skipped slots: one ⊕ identity stands for all of them (header)
    if (nj < kFold) part = SR::combine(part, SR::ident());
  }
  __syncwarp();
  *n = nj;
  return part;
}

// This lane's mask word (its slots 4*lane .. 4*lane+3, a byte each) of plan
// entry e's fold block, made from the plan's occupancy bits (four words an
// entry, bit i of word q for slot 32q + i).
__device__ __forceinline__ unsigned plan_word(const unsigned* bits, long long e,
                                              int lane) {
  const unsigned q = (__ldg(bits + 4 * e + (lane >> 3)) >> (4 * (lane & 7))) & 0xfu;
  return (q & 1u) | ((q & 2u) << 7) | ((q & 4u) << 14) | ((q & 8u) << 21);
}

// The lane path: one warp's 128-slot fold block for output lanes l0 ..
// l0+lc-1 at once (lc % 4 == 0).  The block starts at ri / rv and holds
// min(128, lim) real slots; this lane's mask word is w (its slots 4*lane ..
// 4*lane+3).  The occupied slots' (idx, val) go compacted in slot order to
// `slot` (128 of this warp); then, kSub lanes a pass and kGroup occupied
// slots at a time, the warp gathers every (slot, 4 lanes) as one 16-byte
// load, all of a lane's in flight, leaves the products in `stage` (kGroup
// × kSub floats of this warp), and lane c folds lane l0 + s0 + c's
// products onto its chain in slot order; it hands the block's partial to
// out(s0 + c, part).  A block of no occupied slot hands out the ⊕
// identity.
template <int S, class Out>
__device__ __forceinline__ void warp_block_lanes(const int* ri, const float* rv,
                                                 int lim, unsigned w,
                                                 const float* x, int lanes,
                                                 int l0, int lc, float* stage,
                                                 int2* slot, int lane,
                                                 const Out& out) {
  using SR = Semiring<S>;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned occ = nibble(w);
  const unsigned q0 = __ballot_sync(kFullWarp, occ & 1u);
  const unsigned q1 = __ballot_sync(kFullWarp, occ & 2u);
  const unsigned q2 = __ballot_sync(kFullWarp, occ & 4u);
  const unsigned q3 = __ballot_sync(kFullWarp, occ & 8u);
  const int n_occ = __popc(q0) + __popc(q1) + __popc(q2) + __popc(q3);
  if (n_occ == 0) {                                      // warp-uniform
    for (int c = lane; c < lc; c += 32) out(c, SR::ident());
    return;
  }
  if (occ) {
    int p = __popc(q0 & lt) + __popc(q1 & lt) + __popc(q2 & lt) + __popc(q3 & lt);
    const int s = 4 * lane;
    if (s + 4 <= lim && aligned(ri + s, 16) && aligned(rv + s, 16)) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(ri + s));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(rv + s));
      const int ia[4] = {a.x, a.y, a.z, a.w};
      const float va[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (occ & (1u << q)) slot[p++] = make_int2(ia[q], __float_as_int(va[q]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (occ & (1u << q))
          slot[p++] = make_int2(__ldcs(ri + s + q), __float_as_int(__ldcs(rv + s + q)));
    }
  }
  __syncwarp();
  constexpr int C4 = kSub / 4;                           // 16-byte words a pass
  constexpr int kGather = kGroup * C4 / 32;             // gathers a lane a group
  float4* st4 = reinterpret_cast<float4*>(stage);
  for (int s0 = 0; s0 < lc; s0 += kSub) {
    const int sw = min(kSub, lc - s0);
    const float* xs = x + l0 + s0;
    float part = 0.0f;
    for (int g0 = 0; g0 < n_occ; g0 += kGroup) {
      const int ng = min(kGroup, n_occ - g0);
      // gathers and products: item e is slot g0 + e / C4, lanes 4 * (e %
      // C4) .. of the pass, all of a lane's in flight at once
      float4 g[kGather];
      float v[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int e = 32 * u + lane;
        const int c4 = e % C4;
        g[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[u] = 0.0f;
        if (e / C4 < ng && 4 * c4 < sw) {
          const int2 iv = slot[g0 + e / C4];
          v[u] = __int_as_float(iv.y);
          g[u] = __ldg(reinterpret_cast<const float4*>(
              xs + static_cast<long long>(iv.x) * lanes + 4 * c4));
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int e = 32 * u + lane;
        if (e / C4 < ng && 4 * (e % C4) < sw)
          st4[e] = make_float4(SR::times(v[u], g[u].x), SR::times(v[u], g[u].y),
                               SR::times(v[u], g[u].z), SR::times(v[u], g[u].w));
      }
      __syncwarp();
      if (lane < sw) {
        // one lane per output lane folds the group's products in slot
        // order, eight loads ahead
        const float* sp = stage + lane;
        int p = 0;
        if (g0 == 0) {
          part = sp[0];
          p = 1;
        }
        for (; p + 8 <= ng; p += 8) {
          float t[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) t[q] = sp[(p + q) * kSub];
#pragma unroll
          for (int q = 0; q < 8; ++q) part = SR::combine(part, t[q]);
        }
        for (; p < ng; ++p) part = SR::combine(part, sp[p * kSub]);
      }
      __syncwarp();
    }
    if (lane < sw) {
      // skipped slots: one ⊕ identity stands for all of them (header)
      if (n_occ < kFold) part = SR::combine(part, SR::ident());
      out(s0 + lane, part);
    }
  }
}

// K = 128: a warp per row, RW consecutive rows at once (one fold block
// each, which is the row's result).  Persistent warps: each walks groups
// of RW rows a grid apart, the next group's mask words in flight while it
// folds this one.
template <int RW>
__device__ __forceinline__ void warp_rows_masks(const unsigned char* msk,
                                                long long rows, long long r0,
                                                int lane, unsigned (&w)[RW]) {
#pragma unroll
  for (int j = 0; j < RW; ++j)
    w[j] = r0 + j < rows ? mask_word(msk + (r0 + j) * kFold, kFold, 4 * lane) : 0u;
}

// Vec: the lane path (RW = 1; warp_block_lanes over `lcap` lanes a pass).
template <int S, int RW, bool Vec>
__global__ void __launch_bounds__(kWarps * 32)
ell_warp_rows_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                     const unsigned char* __restrict__ msk,
                     const float* __restrict__ x, float* __restrict__ y,
                     long long rows, int lanes, int lcap) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * RW;
  long long r0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * RW;
  if (r0 >= rows) return;                                // warp-uniform
  const int l0 = blockIdx.y * lcap;
  const int lc = min(lcap, lanes - l0);
  const int jb = lane / lc, c = lane - jb * lc;
  unsigned w_next[RW];
  warp_rows_masks<RW>(msk, rows, r0, lane, w_next);
  for (; r0 < rows; r0 += stride) {
    unsigned w[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) w[j] = w_next[j];
    if (r0 + stride < rows) warp_rows_masks<RW>(msk, rows, r0 + stride, lane, w_next);
    const long long base = r0 * kFold;
    if constexpr (Vec) {
      float* yr = y + r0 * lanes + l0;
      warp_block_lanes<S>(idx + base, val + base, kFold, w[0], x, lanes, l0, lc,
                          smem + warp * kGroup * kSub,
                          reinterpret_cast<int2*>(smem + kWarps * kGroup * kSub) +
                              warp * kFold,
                          lane, [&](int l, float part) { yr[l] = part; });
    } else {
      const int nrow = static_cast<int>(min(static_cast<long long>(RW), rows - r0));
      int n;
      const float part = warp_blocks<S, RW>(idx + base, val + base, nrow * kFold, w,
                                            x, lanes, l0, lc,
                                            smem + warp * RW * kFold * lcap, lane, &n);
      if (jb < nrow) y[(r0 + jb) * lanes + l0 + c] = part;
    }
  }
}

// The left-to-right fold of a row's block partials, which the plan lists
// in block order: block b's partial p after the blocks up to `prev`.  The
// all-padding blocks between them, which the plan leaves out, enter as one
// ⊕ identity (x ⊕ e ⊕ e = x ⊕ e bit for bit).
template <int S>
__device__ __forceinline__ float fold_part(float acc, int& prev, int b, float p) {
  using SR = Semiring<S>;
  if (b > prev + 1) acc = prev < 0 ? SR::ident() : SR::combine(acc, SR::ident());
  acc = b == 0 ? p : SR::combine(acc, p);
  prev = b;
  return acc;
}

// The row's trailing all-padding blocks (every block of a row the plan
// lists none of): one ⊕ identity.
template <int S>
__device__ __forceinline__ float fold_end(float acc, int prev, int nb) {
  using SR = Semiring<S>;
  if (prev == nb - 1) return acc;
  return prev < 0 ? SR::ident() : SR::combine(acc, SR::ident());
}

// One warp folds a row's block partials part[e0 .. e1) (of the blocks
// blk[e0 .. e1)) left to right: each lane loads one entry of a pass of 32,
// then every lane runs the same chain over the pass by shuffles.
template <int S>
__device__ __forceinline__ float fold_parts(const int* blk, const float* part,
                                            int e0, int e1, int nb, int lane) {
  float acc = Semiring<S>::ident();
  int prev = -1;
  for (int c = e0; c < e1; c += 32) {
    const int m = min(32, e1 - c);
    int b = 0;
    float p = 0.0f;
    if (lane < m) {
      b = __ldg(blk + c + lane);
      p = part[c + lane];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int bj = __shfl_sync(kFullWarp, b, j);
      const float pj = __shfl_sync(kFullWarp, p, j);
      if (j < m) acc = fold_part<S>(acc, prev, bj, pj);
    }
  }
  return fold_end<S>(acc, prev, nb);
}

// K > 128 at L = 1: a warp per plan entry e (an occupied fold block of row
// row[e]), its block's partial left in part[e].
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
ell_plan_blocks_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                       const float* __restrict__ x, const int* __restrict__ blk,
                       const int* __restrict__ row,
                       const unsigned* __restrict__ bits, int nnzb, int k_slots,
                       float* __restrict__ part) {
  __shared__ __align__(16) float stage[kWarps * kFold];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= nnzb) return;                                 // warp-uniform
  const int b = blk[e];
  const long long at = static_cast<long long>(row[e]) * k_slots + b * kFold;
  const unsigned w[1] = {plan_word(bits, e, lane)};
  int n;
  const float p = warp_blocks<S, 1>(idx + at, val + at, k_slots - b * kFold, w, x,
                                    1, 0, 1, stage + warp * kFold, lane, &n);
  if (lane == 0) part[e] = p;
}

// Then each row's fold, a warp per row; a row of no occupied block is the
// ⊕ identity.
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
ell_plan_fold_kernel(const int* __restrict__ ptr, const int* __restrict__ blk,
                     const float* __restrict__ part, float* __restrict__ y,
                     long long rows, int nb) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;                                 // warp-uniform
  const float acc = fold_parts<S>(blk, part, ptr[r], ptr[r + 1], nb, lane);
  if (lane == 0) y[r] = acc;
}

// K > 128 with an (N, L) frontier: a block per row (and pass of lcap
// lanes), in rounds of up to kRound of the row's plan entries.
// 1. The warps take the round's occupied fold blocks (warp_blocks, one at
//    a time; Vec: warp_block_lanes over `lcap` lanes a pass, the block has
//    at least lcap threads) and leave their partials in shared memory.
// 2. One thread per output lane folds them left to right (fold_part), the
//    fold carried from one round to the next.
template <int S, bool Vec>
__global__ void __launch_bounds__(kWarps * 32)
ell_block_rows_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                      const float* __restrict__ x, float* __restrict__ y,
                      const int* __restrict__ ptr, const int* __restrict__ blk,
                      const unsigned* __restrict__ bits, int k_slots, int lanes,
                      int lcap) {
  using SR = Semiring<S>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int list[kRound];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long r = blockIdx.x;
  const int l0 = blockIdx.y * lcap;
  const int lc = min(lcap, lanes - l0);
  // products, then (Vec) compacted slots, then kRound * lcap partials
  float* stage = smem;
  int2* slots = reinterpret_cast<int2*>(smem + nw * kGroup * kSub);
  float* parts = Vec ? smem + nw * (kGroup * kSub + 2 * kFold)
                     : smem + nw * kFold * lcap;
  const long long base = r * k_slots;
  const int* ri = idx + base;
  const float* rv = val + base;
  const int nb = (k_slots + kFold - 1) / kFold;
  const int e0 = ptr[r], e1 = ptr[r + 1];

  float acc = SR::ident();
  int prev = -1;                                         // the last block folded
  for (int c0 = e0; c0 < e1; c0 += kRound) {
    const int cn = min(kRound, e1 - c0);
    for (int t = threadIdx.x; t < cn; t += blockDim.x) list[t] = blk[c0 + t];
    __syncthreads();
    // 1. the round's occupied blocks, a warp each
    for (int e = warp; e < cn; e += nw) {
      const int b = list[e];
      const unsigned w[1] = {plan_word(bits, c0 + e, lane)};
      if constexpr (Vec) {
        float* pb = parts + e * lc;
        warp_block_lanes<S>(ri + b * kFold, rv + b * kFold, k_slots - b * kFold,
                            w[0], x, lanes, l0, lc, stage + warp * kGroup * kSub,
                            slots + warp * kFold, lane,
                            [&](int l, float part) { pb[l] = part; });
      } else {
        int n;
        const float part = warp_blocks<S, 1>(ri + b * kFold, rv + b * kFold,
                                             k_slots - b * kFold, w, x, lanes,
                                             l0, lc, stage + warp * kFold * lcap,
                                             lane, &n);
        if (lane < lc) parts[e * lc + lane] = part;
      }
    }
    __syncthreads();
    // 2. partials left to right
    if (threadIdx.x < lc)
      for (int e = 0; e < cn; ++e)
        acc = fold_part<S>(acc, prev, list[e], parts[e * lc + threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.x < lc) y[r * lanes + l0 + threadIdx.x] = fold_end<S>(acc, prev, nb);
}

// ---------------------------------------------------------------- launch --

template <int S, int KT, typename I>
void launch_narrow(const int* idx, const float* val, const unsigned char* msk,
                   const float* x, float* y, long long rows, int k_slots,
                   int lanes, cudaStream_t stream) {
  if constexpr (KT > 0 && sizeof(I) == 4) {
    if (can_stage<KT>(idx, val, msk, lanes)) {
      ell_narrow_staged_kernel<S, KT><<<grid_for(rows), kThreads, 0, stream>>>(
          idx, val, msk, x, y, static_cast<int>(rows));
      return;
    }
  }
  if (lane_chunks_apply(lanes, {x, y})) {
    const LaneChunkGrid lg(rows, lanes);
    constexpr bool can = KT > 0 && sizeof(I) == 4;
    const bool staged = can && lane_chunks_stage<KT>(lanes, idx, val, msk);
    auto kernel = staged ? ell_lanes_kernel<S, KT, can, I>
                         : ell_lanes_kernel<S, KT, false, I>;
    kernel<<<lg.grid, lg.block, 0, stream>>>(idx, val, msk, x, y,
                                             static_cast<I>(rows), k_slots, lanes);
    return;
  }
  ell_narrow_kernel<S, KT, I><<<grid_for(rows * lanes), kThreads, 0, stream>>>(
      idx, val, msk, x, y, static_cast<I>(rows), k_slots, lanes);
}

template <int S, typename I>
void launch_narrow_k(const int* idx, const float* val, const unsigned char* msk,
                     const float* x, float* y, long long rows, int k_slots,
                     int lanes, cudaStream_t stream) {
  switch (k_slots) {
    case 8: launch_narrow<S, 8, I>(idx, val, msk, x, y, rows, k_slots, lanes, stream); break;
    case 16: launch_narrow<S, 16, I>(idx, val, msk, x, y, rows, k_slots, lanes, stream); break;
    default: launch_narrow<S, 0, I>(idx, val, msk, x, y, rows, k_slots, lanes, stream); break;
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only once allowed; the call is no stream operation, so it may come
// inside a graph capture).
template <class K>
void allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
}

// The lane path: L % 4 == 0 beyond kLaneChunk lanes, x 16-byte aligned.
inline bool wide_lanes_apply(int lanes, const float* x) {
  return kWideLanes > kLaneChunk && lanes > kLaneChunk && lanes % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

template <int S, int RW, bool Vec>
void launch_rows_per_warp(const int* idx, const float* val,
                          const unsigned char* msk, const float* x, float* y,
                          long long rows, int lanes, int lcap, int sms,
                          cudaStream_t stream) {
  // persistent: as many blocks as the card holds at once, or fewer
  const size_t smem = Vec ? sizeof(float) * kWarps * (kGroup * kSub + 2 * kFold)
                          : sizeof(float) * kWarps * RW * kFold * lcap;
  auto kernel = ell_warp_rows_kernel<S, RW, Vec>;
  allow_smem(kernel, smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem);
  const long long warps = (rows + RW - 1) / RW;
  const long long blocks = std::min<long long>((warps + kWarps - 1) / kWarps,
                                               std::max(1, sms * per_sm));
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((lanes + lcap - 1) / lcap));
  kernel<<<grid, kWarps * 32, smem, stream>>>(idx, val, msk, x, y, rows, lanes, lcap);
}

// K = 128.  Two rows a warp halve the warps: worth it only on an (N,)
// frontier and a bin of at least four rows per warp the card holds at once,
// which then still fill it twice over (on the H100's 132 SMs × 64 warps,
// from 33,792 rows on).
template <int S>
void launch_warp_rows(const int* idx, const float* val, const unsigned char* msk,
                      const float* x, float* y, long long rows, int lanes,
                      int lcap, bool vec, cudaStream_t stream) {
  int dev = 0, sms = 0, sm_threads = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&sm_threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  const long long many_rows = 4LL * sms * (sm_threads / 32);
  if (vec)
    launch_rows_per_warp<S, 1, true>(idx, val, msk, x, y, rows, lanes, lcap, sms, stream);
  else if (lanes == 1 && rows >= many_rows)
    launch_rows_per_warp<S, 2, false>(idx, val, msk, x, y, rows, 1, 1, sms, stream);
  else
    launch_rows_per_warp<S, 1, false>(idx, val, msk, x, y, rows, lanes, lcap, sms, stream);
}

// The block plan of a K > 128 bin (`kernels/ell_spmv/plan.py`) and the
// L = 1 path's scratch `part` of nnzb floats.
struct BlockPlan {
  const int* ptr;
  const int* blk;
  const int* row;
  long long nnzb;
  float* part;
  const unsigned* bits;
};

template <int S>
void launch_planned(const int* idx, const float* val, const float* x, float* y,
                    long long rows, int k_slots, const BlockPlan& plan,
                    cudaStream_t stream) {
  const int nnzb = static_cast<int>(plan.nnzb);
  if (nnzb > 0)
    ell_plan_blocks_kernel<S><<<(nnzb + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
        idx, val, x, plan.blk, plan.row, plan.bits, nnzb, k_slots, plan.part);
  ell_plan_fold_kernel<S><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                            kWarps * 32, 0, stream>>>(
      plan.ptr, plan.blk, plan.part, y, rows, (k_slots + kFold - 1) / kFold);
}

template <int S>
void launch(const void* idx_, const void* val_, const void* msk_,
            const void* x_, void* y_, long long rows, long long n_src,
            int k_slots, int lanes, const BlockPlan& plan, cudaStream_t stream) {
  const int* idx = static_cast<const int*>(idx_);
  const float* val = static_cast<const float*>(val_);
  const unsigned char* msk = static_cast<const unsigned char*>(msk_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  if (k_slots < kFold) {
    if (fits_int32(rows, k_slots, lanes, n_src))
      launch_narrow_k<S, int>(idx, val, msk, x, y, rows, k_slots, lanes, stream);
    else
      launch_narrow_k<S, long long>(idx, val, msk, x, y, rows, k_slots, lanes, stream);
    return;
  }
  const bool vec = wide_lanes_apply(lanes, x);
  const int lcap = std::min(lanes, vec ? kWideLanes : kLaneChunk);
  if (k_slots == kFold) {
    launch_warp_rows<S>(idx, val, msk, x, y, rows, lanes, lcap, vec, stream);
    return;
  }
  if (lanes == 1) {
    launch_planned<S>(idx, val, x, y, rows, k_slots, plan, stream);
    return;
  }
  const int nb = (k_slots + kFold - 1) / kFold;
  int nw = std::max(1, std::min(kWarps, (nb + 7) / 8));
  if (vec) nw = std::max(nw, (lcap + 31) / 32);          // a thread per lane
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((lanes + lcap - 1) / lcap));
  const size_t smem = vec ? sizeof(float) * (nw * (kGroup * kSub + 2 * kFold) + kRound * lcap)
                          : sizeof(float) * (nw * kFold + kRound) * lcap;
  auto kernel = vec ? ell_block_rows_kernel<S, true> : ell_block_rows_kernel<S, false>;
  allow_smem(kernel, smem);
  kernel<<<grid, nw * 32, smem, stream>>>(idx, val, x, y, plan.ptr, plan.blk,
                                          plan.bits, k_slots, lanes, lcap);
}

}  // namespace graphhp

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unknown semiring, a fold block other than min(128, K), or K > 128
// without a block plan: ptr always, where nnzb > 0 also blk and bits, and
// at lanes == 1 row and part).  `lanes` is 1 for an (N,) frontier; `n_src` is
// the frontier's N.  The plan's arguments come last, so a launcher written
// for the signature before them still reads its own.
extern "C" int graphhp_ell_spmv(int semiring, const void* idx,
                                const void* val, const void* msk,
                                const void* x, void* y, long long rows,
                                long long n_src, int k_slots, int lanes,
                                int bk, void* stream, const void* ptr,
                                const void* blk, const void* row,
                                long long nnzb, void* part, const void* bits) {
  using namespace graphhp;
  if (bk != std::min(kFold, k_slots) || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan plan{static_cast<const int*>(ptr), static_cast<const int*>(blk),
                       static_cast<const int*>(row), nnzb, static_cast<float*>(part),
                       static_cast<const unsigned*>(bits)};
  if (k_slots > kFold &&
      (!plan.ptr || (nnzb > 0 && (!plan.blk || !plan.bits ||
                                  (lanes == 1 && (!plan.row || !plan.part))))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kAddMul: launch<kAddMul>(idx, val, msk, x, y, rows, n_src, k_slots, lanes, plan, s); break;
    case kMinAdd: launch<kMinAdd>(idx, val, msk, x, y, rows, n_src, k_slots, lanes, plan, s); break;
    case kMaxAdd: launch<kMaxAdd>(idx, val, msk, x, y, rows, n_src, k_slots, lanes, plan, s); break;
    case kMinMul: launch<kMinMul>(idx, val, msk, x, y, rows, n_src, k_slots, lanes, plan, s); break;
    case kMaxMin: launch<kMaxMin>(idx, val, msk, x, y, rows, n_src, k_slots, lanes, plan, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
