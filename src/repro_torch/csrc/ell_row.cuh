// One sliced-ELL row in registers, for the kernels that give each thread one
// (row, lane) output, or four lanes of one row (the lane-chunk path, below):
// the narrow bins of `ell_spmv` (K = 8, 16), the `min_step` base bin and
// `pr_step`'s lane paths.
//
// A thread has its row's mask and the idx (and, unless its slot functor
// reads only some, val) of its occupied slots in registers before it
// touches the frontier.  Two ways in:
// * StagedRows (K = 8 or 16, aligned tiles, a warp of whole rows: one lane,
//   or L / 4 chunk threads a row with L / 4 dividing 32): a warp's 32 (or
//   32 / (L/4)) rows are one contiguous span of each tile, loaded coalesced
//   into shared memory,
//   with streaming loads (`__ldcs`: each tile byte is read once, L2 is
//   kept for the gathered frontier); each thread then takes its own row
//   from there.  What is staged follows the bin's density and what the
//   kernel needs (StageMode).
// * Slots::load otherwise: the thread's own row by vector loads (8- or
//   16-byte words for the mask, 16 bytes of idx/val per 4-slot chunk that
//   holds an occupied slot), read-only cached, since a warp's rows
//   interleave in the same sectors; scalar loads where a chunk is not a
//   multiple of 4 slots or a pointer is misaligned.
// The caller's slot functor then issues every gather of the row before the
// fold, and the fold runs in registers in slot order — the reference's
// order (ROADMAP Queue 2): sequential inside each bk = min(128, K) block,
// block partials left to right, a ragged last block padded with the ⊕
// identity.
#pragma once

#include <stdint.h>

#include <initializer_list>

#include "semiring.cuh"

namespace graphhp {

// The reference's slot-block width (`kernels.common.FOLD_SLICES`).
constexpr int kFold = 128;

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & static_cast<uintptr_t>(bytes - 1)) == 0;
}

// C consecutive slots of one row: source index, edge value, occupancy.
template <int C>
struct Slots {
  int i[C];
  float v[C];
  bool m[C];
  // Set where val is not loaded yet: the row's val words of these slots,
  // for a slot functor that reads only the ones it needs.
  const float* v_later = nullptr;

  __device__ __forceinline__ void unpack(unsigned w, int at) {
#pragma unroll
    for (int b = 0; b < 4; ++b) m[at + b] = ((w >> (8 * b)) & 0xffu) != 0;
  }

  __device__ __forceinline__ void load_mask(const unsigned char* mp) {
    if constexpr (C % 16 == 0) {
      if (aligned(mp, 16)) {
#pragma unroll
        for (int q = 0; q < C / 16; ++q) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(mp) + q);
          unpack(w.x, 16 * q);
          unpack(w.y, 16 * q + 4);
          unpack(w.z, 16 * q + 8);
          unpack(w.w, 16 * q + 12);
        }
        return;
      }
    }
    if constexpr (C % 8 == 0) {
      if (aligned(mp, 8)) {
#pragma unroll
        for (int q = 0; q < C / 8; ++q) {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(mp) + q);
          unpack(w.x, 8 * q);
          unpack(w.y, 8 * q + 4);
        }
        return;
      }
    }
    if constexpr (C % 4 == 0) {
      if (aligned(mp, 4)) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
          unpack(__ldg(reinterpret_cast<const unsigned*>(mp) + q), 4 * q);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) m[j] = __ldg(mp + j) != 0;
  }

  // idx and val of the slots the mask marks, 16 bytes (4 slots) a load
  // where aligned; nothing of a 4-slot chunk that holds no occupied slot.
  __device__ __forceinline__ void load_occupied(const int* ip, const float* vp) {
    if constexpr (C % 4 == 0) {
      if (aligned(ip, 16) && aligned(vp, 16)) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          int4 a = make_int4(0, 0, 0, 0);
          float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (m[4 * q] | m[4 * q + 1] | m[4 * q + 2] | m[4 * q + 3]) {
            a = __ldg(reinterpret_cast<const int4*>(ip) + q);
            b = __ldg(reinterpret_cast<const float4*>(vp) + q);
          }
          i[4 * q] = a.x; i[4 * q + 1] = a.y; i[4 * q + 2] = a.z; i[4 * q + 3] = a.w;
          v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z; v[4 * q + 3] = b.w;
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      i[j] = m[j] ? __ldg(ip + j) : 0;
      v[j] = m[j] ? __ldg(vp + j) : 0.0f;
    }
  }

  // idx only, of the 4-slot chunks that hold an occupied slot; val is
  // left to the slot functor (v_later).
  __device__ __forceinline__ void load_idx(const int* ip, const float* vp) {
    v_later = vp;
    if constexpr (C % 4 == 0) {
      if (aligned(ip, 16)) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          int4 a = make_int4(0, 0, 0, 0);
          if (m[4 * q] | m[4 * q + 1] | m[4 * q + 2] | m[4 * q + 3])
            a = __ldg(reinterpret_cast<const int4*>(ip) + q);
          i[4 * q] = a.x; i[4 * q + 1] = a.y; i[4 * q + 2] = a.z; i[4 * q + 3] = a.w;
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) i[j] = m[j] ? __ldg(ip + j) : 0;
  }

  // LazyVal: val is left to the slot functor (load_idx).
  template <bool LazyVal = false>
  __device__ __forceinline__ void load(const int* ip, const float* vp,
                                       const unsigned char* mp) {
    load_mask(mp);
    if constexpr (LazyVal)
      load_idx(ip, vp);
    else
      load_occupied(ip, vp);
  }

  // Row t of a warp's staged rows (StagedRows<C>).  `dense`: its idx
  // was staged (else idx and val come from ip / vp, occupied chunks only);
  // `val_staged`: its val too (else val is left to the slot functor).
  template <class Staged>
  __device__ __forceinline__ void load_staged(const Staged& st, int t,
                                              bool dense, bool val_staged,
                                              const int* ip, const float* vp) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) unpack(st.m[t * (C / 4) + q], 4 * q);
    if (!dense) {
      load_occupied(ip, vp);
      return;
    }
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int4 a = st.i[t * (C / 4) + q];
      i[4 * q] = a.x; i[4 * q + 1] = a.y; i[4 * q + 2] = a.z; i[4 * q + 3] = a.w;
      float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (val_staged) b = st.v[t * (C / 4) + q];
      v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z; v[4 * q + 3] = b.w;
    }
    if (!val_staged) v_later = vp;
  }
};

// How a warp stages its rows (StagedRows::load).
enum StageMode {
  // The mask first; idx and val too where at least half of the span's
  // 32-byte idx sectors (8 slots) hold an occupied slot — every sector has
  // to come from memory then anyway.  Otherwise each thread loads only the
  // 4-slot chunks of its row that hold an occupied slot (the sparse remote
  // and PageRank base bins).
  kStageAdaptive,
  // Mask and idx at once, val never: a slot functor that needs val only
  // for some occupied slots loads those chunks itself (`min_step` reads
  // val only where the source's send flag is set).
  kStageMaskIdx,
  // Mask, idx and val at once, in one round of loads: where the frontier
  // and output bytes of several lanes outweigh the tile's, waiting on the
  // mask before idx and val costs more than their unoccupied sectors
  // (`ell_spmv`'s lane chunks: 0.39 against 0.44 ms adaptive at L = 16 on
  // the grid's base bin, `tools/ab_lanes.py`).
  kStageAll,
};

// The rows of one warp (up to 32), staged in shared memory.  Where a
// thread owns one row (lanes == 1), or a warp holds whole rows of 4-lane
// chunks, and K is 8 or 16 with 16-byte aligned idx/val and 4-byte aligned
// mask rows, a warp's rows are one contiguous span of each tile: its lanes
// load the span coalesced, 16 bytes each (4 for the mask), and each thread
// then takes its own row from shared memory.  Per-thread loads of whole
// rows would stride the warp by the row length.
template <int KT>
struct StagedRows {
  static constexpr int Q = KT / 4;
  int4 i[32 * Q];
  float4 v[32 * Q];
  unsigned m[32 * Q];

  // Rows r0 .. r0+nrow-1 (0 < nrow <= 32), ending in a warp barrier; every
  // lane of the warp takes part.  Returns whether idx was staged (the same
  // in every lane).
  template <StageMode Mode>
  __device__ __forceinline__ bool load(const int* idx, const float* val,
                                       const unsigned char* msk, int r0,
                                       int nrow, int lane) {
    const long long at = static_cast<long long>(r0) * KT;
    const int n4 = nrow * Q;
    const unsigned* gm = reinterpret_cast<const unsigned*>(msk + at);
    const int4* gi = reinterpret_cast<const int4*>(idx + at);
    const float4* gv = reinterpret_cast<const float4*>(val + at);
    if constexpr (Mode != kStageAdaptive) {
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int q = lane + 32 * u;
        if (q < n4) {
          m[q] = __ldcs(gm + q);
          i[q] = __ldcs(gi + q);
          if constexpr (Mode == kStageAll) v[q] = __ldcs(gv + q);
        }
      }
      __syncwarp();
      return true;
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = lane + 32 * u;
      if (q < n4) m[q] = __ldcs(gm + q);
    }
    __syncwarp();
    int busy = 0;
#pragma unroll
    for (int u = 0; u < KT / 8; ++u) {
      const int sct = lane + 32 * u;
      busy += __popc(__ballot_sync(0xffffffffu, sct < n4 / 2 &&
                                   (m[2 * sct] | m[2 * sct + 1]) != 0));
    }
    if (2 * busy < n4 / 2) return false;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = lane + 32 * u;
      if (q < n4) {
        i[q] = __ldcs(gi + q);
        v[q] = __ldcs(gv + q);
      }
    }
    __syncwarp();
    return true;
  }
};

template <int KT>
inline bool can_stage(const void* idx, const void* val, const void* msk,
                      int lanes) {
  return KT > 0 && KT % 8 == 0 && lanes == 1 &&
         (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(val) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(msk) & 3) == 0;
}

// Fold of one row of K slots.  `slot_values(s, out)` fills out[j] with slot
// j's operand (the ⊕ identity where it contributes nothing), gathers first.
// KT > 0: the row is exactly KT <= 128 slots (one fold block), unrolled in
// registers.  KT == 0: any K, in chunks of 4 slots.
template <int S, int KT, class SlotFn>
__device__ __forceinline__ float fold_row(const int* ri, const float* rv,
                                          const unsigned char* rm, int k_slots,
                                          const SlotFn& slot_values) {
  using SR = Semiring<S>;
  if constexpr (KT > 0) {
    Slots<KT> s;
    s.load(ri, rv, rm);
    float o[KT];
    slot_values(s, o);
    float acc = o[0];
#pragma unroll
    for (int j = 1; j < KT; ++j) acc = SR::combine(acc, o[j]);
    return acc;
  } else {
    const int bk = k_slots < kFold ? k_slots : kFold;
    float acc = SR::ident();
    for (int k0 = 0; k0 < k_slots; k0 += bk) {
      const int end = min(k0 + bk, k_slots);
      float part = SR::ident();
      int k = k0;
      for (; k + 4 <= end; k += 4) {
        Slots<4> s;
        s.load(ri + k, rv + k, rm + k);
        float o[4];
        slot_values(s, o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part = (k == k0 && j == 0) ? o[0] : SR::combine(part, o[j]);
      }
      for (; k < end; ++k) {
        Slots<1> s;
        s.load(ri + k, rv + k, rm + k);
        float o[1];
        slot_values(s, o);
        part = (k == k0) ? o[0] : SR::combine(part, o[0]);
      }
      // pad slots of a ragged last block: one ⊕ identity stands for all
      // of them (x ⊕ ident ⊕ ident = x ⊕ ident for every semiring)
      if (k0 + bk > k_slots) part = SR::combine(part, SR::ident());
      acc = (k0 == 0) ? part : SR::combine(acc, part);
    }
    return acc;
  }
}

// The fold of staged row t (KT <= 128 slots, one fold block); ip / vp are
// its idx and val in memory.
template <int S, int KT, class SlotFn>
__device__ __forceinline__ float fold_staged_row(const StagedRows<KT>& st, int t,
                                                 bool dense, bool val_staged,
                                                 const int* ip, const float* vp,
                                                 const SlotFn& slot_values) {
  using SR = Semiring<S>;
  Slots<KT> s;
  s.load_staged(st, t, dense, val_staged, ip, vp);
  float o[KT];
  slot_values(s, o);
  float acc = o[0];
#pragma unroll
  for (int j = 1; j < KT; ++j) acc = SR::combine(acc, o[j]);
  return acc;
}

// ------------------------------------------------ (N, L) lane chunks --
//
// Where L % 4 == 0 and the frontier's float operands are 16-byte aligned
// (its bool ones 4-byte aligned), a thread owns four consecutive lanes of
// one row: a block of (cpr, 256 / cpr) threads, cpr = L / 4 chunks a row
// (at most 256: wider rows take more blocks along y), so a warp holds
// consecutive (row, chunk) pairs, 32 / cpr whole rows where cpr divides 32,
// and no thread divides by a runtime value.  The thread reads its row's
// mask and idx once for its four lanes, gathers each occupied slot's four
// frontier values as one 16-byte load, and folds four independent chains
// in registers, each in the reference's order.  Its row loads come from
// L1, or, up to kStageChunksMax chunks a row with K = 8 or 16 and aligned
// tiles, from the warp's rows staged in shared memory (StagedRows, 32 /
// cpr rows a warp).

// The lane-chunk path is taken wherever it applies (false: every (N, L)
// launch takes the thread-per-(row, lane) kernel).
constexpr bool kLaneChunks = true;
// Chunks a row up to which a lane-chunk launch stages its rows.
constexpr int kStageChunksMax = 32;

// L % 4 == 0, every pointer of `vec16` 16-byte aligned and of `vec4`
// 4-byte aligned.
inline bool lane_chunks_apply(int lanes,
                              std::initializer_list<const void*> vec16,
                              std::initializer_list<const void*> vec4 = {}) {
  if (!kLaneChunks || lanes < 4 || lanes % 4 != 0) return false;
  for (const void* p : vec16)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  for (const void* p : vec4)
    if (reinterpret_cast<uintptr_t>(p) & 3) return false;
  return true;
}

// A lane-chunk launch stages its rows: K = 8 or 16, aligned tiles, and a
// power of two of at most kStageChunksMax chunks a row (whole rows a warp).
template <int KT>
inline bool lane_chunks_stage(int lanes, const void* idx, const void* val,
                              const void* msk) {
  const int cpr = lanes / 4;
  return can_stage<KT>(idx, val, msk, 1) && cpr <= kStageChunksMax &&
         (cpr & (cpr - 1)) == 0;
}

// Block and grid of a lane-chunk launch over `rows` rows.
struct LaneChunkGrid {
  dim3 block, grid;
  LaneChunkGrid(long long rows, int lanes) {
    const int cpr = lanes / 4;
    const int cx = cpr < kThreads ? cpr : kThreads;
    const int ry = kThreads / cx;
    block = dim3(cx, ry);
    grid = dim3(static_cast<unsigned>((rows + ry - 1) / ry),
                static_cast<unsigned>((cpr + cx - 1) / cx));
  }
};

// Four ⊕ chains over C slots' values o[j][c], slot order.
template <int S, int C>
__device__ __forceinline__ void fold_slots4(const float (&o)[C][4],
                                            float (&acc)[4]) {
  using SR = Semiring<S>;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[c] = o[0][c];
#pragma unroll
    for (int j = 1; j < C; ++j) acc[c] = SR::combine(acc[c], o[j][c]);
  }
}

// fold_row for four lanes at once: `slot_values(s, out)` fills out[j][c]
// with slot j's operand of lane c.  LazyVal: val is left to the functor
// (Slots::load_idx).
template <int S, int KT, bool LazyVal, class SlotFn>
__device__ __forceinline__ void fold_row4(const int* ri, const float* rv,
                                          const unsigned char* rm, int k_slots,
                                          const SlotFn& slot_values,
                                          float (&acc)[4]) {
  using SR = Semiring<S>;
  if constexpr (KT > 0) {
    Slots<KT> s;
    s.template load<LazyVal>(ri, rv, rm);
    float o[KT][4];
    slot_values(s, o);
    fold_slots4<S, KT>(o, acc);
  } else {
    const int bk = k_slots < kFold ? k_slots : kFold;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = SR::ident();
    for (int k0 = 0; k0 < k_slots; k0 += bk) {
      const int end = min(k0 + bk, k_slots);
      float part[4];
      int k = k0;
      for (; k + 4 <= end; k += 4) {
        Slots<4> s;
        s.template load<LazyVal>(ri + k, rv + k, rm + k);
        float o[4][4];
        slot_values(s, o);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[c] = (k == k0 && j == 0) ? o[0][c] : SR::combine(part[c], o[j][c]);
      }
      for (; k < end; ++k) {
        Slots<1> s;
        s.template load<LazyVal>(ri + k, rv + k, rm + k);
        float o[1][4];
        slot_values(s, o);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[c] = (k == k0) ? o[0][c] : SR::combine(part[c], o[0][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // a ragged last block's pad slots: one ⊕ identity (fold_row)
        if (k0 + bk > k_slots) part[c] = SR::combine(part[c], SR::ident());
        acc[c] = (k0 == 0) ? part[c] : SR::combine(acc[c], part[c]);
      }
    }
  }
}

// fold_staged_row for four lanes at once.
template <int S, int KT, class SlotFn>
__device__ __forceinline__ void fold_staged_row4(const StagedRows<KT>& st, int t,
                                                 bool dense, bool val_staged,
                                                 const int* ip, const float* vp,
                                                 const SlotFn& slot_values,
                                                 float (&acc)[4]) {
  Slots<KT> s;
  s.load_staged(st, t, dense, val_staged, ip, vp);
  float o[KT][4];
  slot_values(s, o);
  fold_slots4<S, KT>(o, acc);
}

// Offsets in 32 bits when every index of the launch fits, else 64.
inline bool fits_int32(long long rows, int k_slots, int lanes, long long n) {
  const long long lim = 0x7fffffffLL;
  return rows * (k_slots > lanes ? k_slots : lanes) < lim &&
         n * lanes < lim && rows * lanes < lim;
}

}  // namespace graphhp
