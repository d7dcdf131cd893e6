// Shared device code of the tile kernels (semiring_spmv.cu,
// spmspv_tiles.cu, semiring_spmv_fused.cu, semiring_spmv_sell.cu,
// spmspv_fused.cu): the five semirings and the per-block-row fold, over
// one vector (tile_fold_kernel) or a block of vectors
// (tile_fold_block_kernel, below).
// spgemm_tiles.cu uses the semirings (Ops, min_nan) only.
//
// Layouts (Layout below):
//   kEll     tiles T_val [mb, T, bm, bn]  ELL-of-tiles (PaddedBSR), pad
//            slots hold the ⊕-identity tile; index int32 [mb, T], the
//            tile-column of every slot; all T slots are folded
//   kActive  the same tiles; index int32 [mb, 1 + 2T] = n_active | slot
//            permutation | tile-column of every permuted slot; the first
//            n_active permuted slots are folded
//   kReal    the same tiles; index int32 [mb, 1 + T] = n_real | tile_cols;
//            the first n_real slots are folded
//   kSell    tiles T_val [slot_total, bm, bn] flat (SlicedELL); index
//            int32 [slot_total], the tile-column of every slot; row_meta
//            int32 [mb, 3] = (out_block, base, n_real) in compute order:
//            grid row i folds tiles[base : base + n_real] into output
//            block out_block
//   kUnion   the same tiles, for a block of vectors: see
//            tile_fold_block_kernel
//   x         T_val [nb * bn]        dense input vector
//   y         T_val [mb * bm]        output
//
// Design of tile_fold_kernel: blockIdx.x is the block row, blockIdx.y a group of kRowsPerBlock
// of its tile rows (so a 128-row block row gives 8 blocks, enough to fill
// the card when block rows are few). A warp per tile row, its lanes over
// the row's bn columns (16-byte vector loads where bn % 4 == 0 and the
// pointers are aligned), a butterfly shuffle ⊕-reduce per tile row. Each
// tile row is owned by one warp, which folds the row's slots in slot order
// into a register accumulator: no atomics, no shared memory, and the
// result does not depend on scheduling. Slots are taken kUnroll at a time
// so a warp keeps that many tile-row loads in flight. Every layout folds a
// slot's tile row the same way, so two layouts that list the same tiles in
// the same order give bit-identical rows.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tilefold {

enum SemiringCode {
  kBoolOrAnd = 0,  // ⟨max, min⟩ on int32 0/1
  kMinPlus = 1,    // ⟨min, +⟩ on f32, zero = +inf
  kPlusTimes = 2,  // ⟨+, ×⟩ on f32 (fp32 FMA on the CUDA cores)
  kMinTimes = 3,   // ⟨min, ×⟩ on f32, zero = +inf
  kPlusAnd = 4,    // ⟨+, min⟩ on int32
};

// min that returns NaN when either side is NaN, as jnp.minimum and
// torch.minimum do (fminf would drop it).
__device__ __forceinline__ float min_nan(float a, float b) {
  return ((a < b) | (a != a)) ? a : b;
}

// Each semiring: T, the ⊕-identity zero(), add (⊕), mul (⊗), fma(p, a, x)
// = p ⊕ (a ⊗ x), and kAnyOrder: whether ⊕ gives the same bits in every
// order (int32 max and wrapping +; not f32 +, and not min_nan, which keeps
// an operand's sign of zero and NaN payload by position).
template <int SR> struct Ops;

template <> struct Ops<kBoolOrAnd> {
  using T = int;
  __device__ __forceinline__ static T zero() { return 0; }
  __device__ __forceinline__ static T add(T a, T b) { return max(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return min(a, b); }
  __device__ __forceinline__ static T fma(T p, T a, T x) { return add(p, mul(a, x)); }
  static constexpr bool kAnyOrder = true;
};

template <> struct Ops<kMinPlus> {
  using T = float;
  __device__ __forceinline__ static T zero() { return INFINITY; }
  __device__ __forceinline__ static T add(T a, T b) { return min_nan(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return a + b; }
  __device__ __forceinline__ static T fma(T p, T a, T x) { return add(p, mul(a, x)); }
  static constexpr bool kAnyOrder = false;
};

template <> struct Ops<kPlusTimes> {
  using T = float;
  __device__ __forceinline__ static T zero() { return 0.0f; }
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
  // one rounding, written out rather than left to nvcc's contraction
  __device__ __forceinline__ static T fma(T p, T a, T x) { return __fmaf_rn(a, x, p); }
  static constexpr bool kAnyOrder = false;
};

template <> struct Ops<kMinTimes> {
  using T = float;
  __device__ __forceinline__ static T zero() { return INFINITY; }
  __device__ __forceinline__ static T add(T a, T b) { return min_nan(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
  __device__ __forceinline__ static T fma(T p, T a, T x) { return add(p, mul(a, x)); }
  static constexpr bool kAnyOrder = false;
};

template <> struct Ops<kPlusAnd> {
  using T = int;
  __device__ __forceinline__ static T zero() { return 0; }
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  __device__ __forceinline__ static T mul(T a, T b) { return min(a, b); }
  __device__ __forceinline__ static T fma(T p, T a, T x) { return add(p, mul(a, x)); }
  static constexpr bool kAnyOrder = true;
};

template <typename T, int VEC> struct Vec { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<int, 4> { using type = int4; };

// p ⊕ (a ⊗ x), element by element, in element order, through O::fma, so
// that every fold of this file rounds alike.
template <class O, int VEC>
__device__ __forceinline__ typename O::T chunk_fold(
    typename O::T p, const typename Vec<typename O::T, VEC>::type& a,
    const typename Vec<typename O::T, VEC>::type& x) {
  if constexpr (VEC == 4) {
    p = O::fma(p, a.x, x.x);
    p = O::fma(p, a.y, x.y);
    p = O::fma(p, a.z, x.z);
    p = O::fma(p, a.w, x.w);
  } else {
    p = O::fma(p, a, x);
  }
  return p;
}

// Butterfly ⊕-reduce over the warp. ⊕ is commutative, so every lane ends
// with the same, bit-identical value.
template <class O>
__device__ __forceinline__ typename O::T warp_fold(typename O::T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = O::add(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

constexpr int kThreads = 256;       // 8 warps per block
constexpr int kRowsPerBlock = 16;   // tile rows per block (2 per warp)
constexpr int kUnroll = 8;          // slots in flight per warp

enum Layout { kEll = 0, kActive = 1, kReal = 2, kSell = 3, kUnion = 4 };

// ONE_CHUNK: bn / VEC <= 32, so each lane reads at most one chunk per row.
template <int SR, int VEC, int LAYOUT, bool ONE_CHUNK>
__global__ void __launch_bounds__(kThreads)
tile_fold_kernel(const typename Ops<SR>::T* __restrict__ tiles,
                 const int* __restrict__ index,
                 const int* __restrict__ row_meta,
                 const typename Ops<SR>::T* __restrict__ x,
                 typename Ops<SR>::T* __restrict__ y,
                 int t_slots, int bm, int bn) {
  using O = Ops<SR>;
  using T = typename O::T;
  using V = typename Vec<T, VEC>::type;

  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_chunks = bn / VEC;
  const size_t tile_elems = (size_t)bm * bn;

  // Per block row: how many slots, where slot j's tile and column are, and
  // which output block the row writes. Offsets into the tiles are size_t:
  // a sell payload can hold more than 2^31 elements.
  int n_slots, out_block = i;
  const int* slot_of = nullptr;   // kActive only: the slot permutation
  const int* col_of;
  const T* row_tiles;
  if constexpr (LAYOUT == kSell) {
    const int* m = row_meta + (size_t)i * 3;
    out_block = m[0];
    const int base = m[1];
    n_slots = m[2];
    col_of = index + base;
    row_tiles = tiles + (size_t)base * tile_elems;
  } else {
    row_tiles = tiles + (size_t)i * t_slots * tile_elems;
    if constexpr (LAYOUT == kEll) {
      n_slots = t_slots;
      col_of = index + (size_t)i * t_slots;
    } else if constexpr (LAYOUT == kActive) {
      const int* m = index + (size_t)i * (1 + 2 * t_slots);
      n_slots = m[0];
      slot_of = m + 1;
      col_of = m + 1 + t_slots;
    } else {
      const int* m = index + (size_t)i * (1 + t_slots);
      n_slots = m[0];
      col_of = m + 1;
    }
  }

  const int row0 = static_cast<int>(blockIdx.y) * kRowsPerBlock;
  const int r_end = min(bm, row0 + kRowsPerBlock);
  for (int r = row0 + warp; r < r_end; r += n_warps) {
    T acc = O::zero();
    for (int j0 = 0; j0 < n_slots; j0 += kUnroll) {
      T part[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        part[u] = O::zero();
        if (j < n_slots) {
          const int slot = LAYOUT == kActive ? slot_of[j] : j;
          const V* a = reinterpret_cast<const V*>(
              row_tiles + (size_t)slot * tile_elems + (size_t)r * bn);
          const V* xb = reinterpret_cast<const V*>(x + (size_t)col_of[j] * bn);
          if (ONE_CHUNK) {
            if (lane < n_chunks) part[u] = chunk_fold<O, VEC>(part[u], a[lane], xb[lane]);
          } else {
            for (int c = lane; c < n_chunks; c += 32) {
              part[u] = chunk_fold<O, VEC>(part[u], a[c], xb[c]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u < n_slots) acc = O::add(acc, warp_fold<O>(part[u]));
      }
    }
    if (lane == 0) y[(size_t)out_block * bm + r] = acc;
  }
}

template <int SR, int LAYOUT>
int launch_semiring(const void* tiles, const void* index, const void* row_meta,
                    const void* x, void* y, int mb, int t_slots, int bm, int bn,
                    cudaStream_t stream) {
  using T = typename Ops<SR>::T;
  const T* a = static_cast<const T*>(tiles);
  const int* idx = static_cast<const int*>(index);
  const int* meta = static_cast<const int*>(row_meta);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  // Every tile row starts at a multiple of bn elements from the tiles'
  // base pointer (slot · bm · bn + r · bn in every layout), so an aligned
  // base and bn % 4 == 0 make every row's vector loads aligned.
  const bool vec4 = bn % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  const int n_chunks = vec4 ? bn / 4 : bn;
  const bool one = n_chunks <= 32;
  const dim3 grid(mb, (bm + kRowsPerBlock - 1) / kRowsPerBlock), block(kThreads);
  if (vec4 && one) {
    tile_fold_kernel<SR, 4, LAYOUT, true><<<grid, block, 0, stream>>>(a, idx, meta, xv, yv, t_slots, bm, bn);
  } else if (vec4) {
    tile_fold_kernel<SR, 4, LAYOUT, false><<<grid, block, 0, stream>>>(a, idx, meta, xv, yv, t_slots, bm, bn);
  } else if (one) {
    tile_fold_kernel<SR, 1, LAYOUT, true><<<grid, block, 0, stream>>>(a, idx, meta, xv, yv, t_slots, bm, bn);
  } else {
    tile_fold_kernel<SR, 1, LAYOUT, false><<<grid, block, 0, stream>>>(a, idx, meta, xv, yv, t_slots, bm, bn);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fold over a block of vectors: what the JAX package runs as jax.vmap of
// kernels 1 and 2 over a [B, n] frontier block (multi-source traversals).
//   x  T_val [B, x_len], y T_val [B, mb * bm]
//   kEll     index int32 [mb, T] shared by every vector; all T slots
//   kUnion   index int32 [G, mb, 1 + 3T], G = ceil(B / 32) vector groups:
//            n_union | union slots | their tile-columns | masks: the union
//            of the group's active slots in slot order
//            (ops._spmspv_union_batch); bit k of a mask says the slot is
//            active for vector 32g + k
//
// A CTA owns (block row i, kBlockRows tile rows, a group of up to 32
// vectors); blockIdx.x = i * G + g, so the groups of one block row run side
// by side and meet its tiles in L2. For each slot it stages the slot's tile
// rows and the x slice [<= 32, bn] of the slot's tile-column in shared
// memory with cp.async, in a ring of kStages: the copies of slot
// j + kStages - 1 are in flight while slot j is folded, and for B <= 32
// each tile byte crosses HBM -> SM once a launch. A warp owns 64 tile rows
// and 8 vectors: kLaneRows lanes across the rows, the others across the
// vectors, each thread an R x V register micro-tile of (row, vector)
// outputs (R·V = 16), so a warp's 8 vectors, and kUnion's skip, are
// warp-uniform. At bn = 128 a leaf's operands are loaded from shared
// memory while the leaf before is folded. Shared rows are padded to a pitch of an odd number
// of 16-byte chunks (an odd number of words for unvectorised rows), so the
// lanes of a quarter-warp read distinct banks.
//
// Each output equals tile_fold_kernel's on that vector bit for bit. Per
// slot, leaf l (l < 32) folds the chunks l, l + 32, ... from the identity as
// lane l does (chunk_fold), and the 32 leaves are combined in the tree that
// warp_fold's butterfly builds in lane 0: leaves in bit-reversed order (0,
// 16, 8, 24, 4, ...) onto a binary-counter stack of at most five partials,
// each combine ⊕(earlier, later). A leaf with no chunk (bn / VEC < 32)
// stays in the tree as the identity (-0 + 0 is +0). Then acc ⊕= value in
// slot order; kUnion folds a slot only into the vectors whose bit is set,
// so each vector folds exactly its own active slots in its own order, and
// never an identity in place of a skipped slot. Where ⊕ gives the same
// bits in any order (Ops::kAnyOrder, and the min semirings' first pass,
// FirstPass) a thread folds the whole tile row into one partial instead,
// with no tree. No split over slots, no atomics.
//
// The compile-time choices (tools/block_fold_sweep.py times them on cit-HP
// at B = 32 on an H100): 64 rows a CTA, 16 lanes across rows (R = 4, V = 4)
// and 2 stages, 101 KB of shared memory at bn = 128: two CTAs of four warps
// an SM, 540 CTAs on cit-HP's 270 block rows.
#ifndef TILEFOLD_BLOCK_ROWS
#define TILEFOLD_BLOCK_ROWS 64
#endif
#ifndef TILEFOLD_STAGES
#define TILEFOLD_STAGES 2
#endif
#ifndef TILEFOLD_LANE_ROWS
#define TILEFOLD_LANE_ROWS 16
#endif
constexpr int kBlockRows = TILEFOLD_BLOCK_ROWS;   // tile rows a CTA owns
constexpr int kStages = TILEFOLD_STAGES;          // slots staged at once
constexpr int kWarpRows = 64;                     // tile rows of a warp
constexpr int kWarpVecs = 8;                      // vectors of a warp
constexpr int kLaneRows = TILEFOLD_LANE_ROWS;     // lanes across the rows, the rest across vectors
constexpr int kChunkUnroll = 8;                   // chunks unrolled together in a kAnyOrder fold
constexpr int kRowsPerLane = kWarpRows / kLaneRows;                 // R
constexpr int kVecPerLane = kWarpVecs / (32 / kLaneRows);           // V; R·V = 16 outputs
constexpr int kVecGroup = 32;                                       // vectors of a CTA
constexpr int kBlockThreads = 32 * (kBlockRows / kWarpRows) * (kVecGroup / kWarpVecs);
static_assert(kLaneRows == 32 || kLaneRows == 16 || kLaneRows == 8, "lanes across rows");
static_assert(kBlockRows % kWarpRows == 0, "a CTA owns whole warps of rows");
static_assert(kStages >= 2, "one slot's copies in flight while another is folded");

__host__ __device__ constexpr int bitrev5(int q) {
  return ((q & 1) << 4) | ((q & 2) << 2) | (q & 4) | ((q & 8) >> 2) | ((q & 16) >> 4);
}

__host__ __device__ constexpr int trailing_ones(int q) {
  return (q & 1) ? 1 + trailing_ones(q >> 1) : 0;
}

// min.NaN.f32 (sm_80 and later): the smaller operand, or the canonical NaN
// if either is NaN. It differs from min_nan only in a NaN's payload and in
// the sign of a zero chosen between +0 and -0.
__device__ __forceinline__ float min_canonical_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The ⊕ of the block fold's first pass. The min semirings fold with
// min.NaN in any order (one instruction against min_nan's three, and no
// tree): where the result is neither a zero nor NaN, the smallest value
// has one bit pattern and the exact fold gives the same bits, and the
// kernel recomputes every other output exactly (kRecheck). The other
// semirings are their own first pass.
template <class O> struct FirstPass : O { static constexpr bool kRecheck = false; };

template <int SR> struct MinFirstPass {
  using T = float;
  __device__ __forceinline__ static T zero() { return INFINITY; }
  __device__ __forceinline__ static T add(T a, T b) { return min_canonical_nan(a, b); }
  __device__ __forceinline__ static T fma(T p, T a, T x) { return add(p, Ops<SR>::mul(a, x)); }
  static constexpr bool kAnyOrder = true;
  static constexpr bool kRecheck = true;
};
template <> struct FirstPass<Ops<kMinPlus>> : MinFirstPass<kMinPlus> {};
template <> struct FirstPass<Ops<kMinTimes>> : MinFirstPass<kMinTimes> {};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n rows of bn elements (source row stride `stride`) into shared rows
// of `pitch`, VEC elements a copy, spread over the CTA; FULL: bn / VEC = 32.
template <int VEC, bool FULL, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src, size_t stride,
                                           int n, int bn) {
  const int per_row = FULL ? 32 : bn / VEC;
  for (int k = threadIdx.x; k < n * per_row; k += blockDim.x) {
    const int r = k / per_row;
    const int c = (k - r * per_row) * VEC;
    cp_async<VEC * sizeof(T)>(dst + r * pitch + c, src + r * stride + c);
  }
}

// One chunk's operands of the micro-tile in registers: the lane's R tile
// rows and V vectors at chunk c.
template <class O, int VEC, int R, int V>
struct Chunk {
  using T = typename O::T;
  using Vt = typename Vec<T, VEC>::type;
  Vt a[R], x[V];
  __device__ __forceinline__ void load(const T* ts, const T* xs, int pitch, int c) {
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = *reinterpret_cast<const Vt*>(ts + r * kLaneRows * pitch + c * VEC);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = *reinterpret_cast<const Vt*>(xs + v * pitch + c * VEC);
  }
  // p ⊕= the chunk, for every output
  __device__ __forceinline__ void fold(T (&p)[R][V]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) p[r][v] = chunk_fold<O, VEC>(p[r][v], a[r], x[v]);
    }
  }
};

template <class O, int R, int V>
__device__ __forceinline__ void set_zero(typename O::T (&p)[R][V]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) p[r][v] = O::zero();
  }
}

// Leaf `leaf` of every output of the micro-tile: chunks leaf, leaf + 32, ...
// folded from the identity, as lane `leaf` of tile_fold_kernel folds them.
// ts: the lane's first tile row; xs: its first vector.
template <class O, int VEC, int R, int V>
__device__ __forceinline__ void fold_leaf(typename O::T (&cur)[R][V], const typename O::T* ts,
                                          const typename O::T* xs, int pitch, int n_chunks,
                                          int leaf) {
  set_zero<O>(cur);
  for (int c = leaf; c < n_chunks; c += 32) {
    Chunk<O, VEC, R, V> ch;
    ch.load(ts, xs, pitch, c);
    ch.fold(cur);
  }
}

// Leaves Q..31 of warp_fold's tree, leaf bitrev5(Q) pushed onto the stack:
// st[k] holds the pending subtree of 2^k leaves for each set bit k of Q.
// When FULL, leaf Q + 1's operands are loaded into buf while leaf Q folds.
template <class O, int VEC, bool FULL, int R, int V, int Q>
__device__ __forceinline__ void tree_leaves(typename O::T (&st)[5][R][V],
                                            typename O::T (&val)[R][V],
                                            Chunk<O, VEC, R, V> (&buf)[2],
                                            const typename O::T* ts, const typename O::T* xs,
                                            int pitch, int n_chunks) {
  if constexpr (Q < 32) {
    typename O::T cur[R][V];
    if constexpr (FULL) {
      if constexpr (Q + 1 < 32) buf[(Q + 1) & 1].load(ts, xs, pitch, bitrev5(Q + 1));
      set_zero<O>(cur);
      buf[Q & 1].fold(cur);
    } else {
      fold_leaf<O, VEC, R, V>(cur, ts, xs, pitch, n_chunks, bitrev5(Q));
    }
    constexpr int kOnes = trailing_ones(Q);
#pragma unroll
    for (int k = 0; k < kOnes; ++k) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int v = 0; v < V; ++v) cur[r][v] = O::add(st[k][r][v], cur[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if constexpr (kOnes < 5) {
          st[kOnes][r][v] = cur[r][v];
        } else {
          val[r][v] = cur[r][v];
        }
      }
    }
    tree_leaves<O, VEC, FULL, R, V, Q + 1>(st, val, buf, ts, xs, pitch, n_chunks);
  }
}

// One slot's value for every output of the micro-tile: warp_fold of the 32
// lane partials as tile_fold_kernel computes it in lane 0. Where the order
// of ⊕ does not matter, one running fold of the whole tile row instead.
template <class O, int VEC, bool FULL, int R, int V>
__device__ __forceinline__ void fold_slot(typename O::T (&val)[R][V], const typename O::T* ts,
                                          const typename O::T* xs, int pitch, int n_chunks) {
  if constexpr (O::kAnyOrder) {
    set_zero<O>(val);
    auto chunk = [&](int c) {
      Chunk<O, VEC, R, V> ch;
      ch.load(ts, xs, pitch, c);
      ch.fold(val);
    };
    if constexpr (FULL) {
#pragma unroll 1
      for (int c0 = 0; c0 < 32; c0 += kChunkUnroll) {
#pragma unroll
        for (int c = 0; c < kChunkUnroll; ++c) chunk(c0 + c);
      }
    } else {
      for (int c = 0; c < n_chunks; ++c) chunk(c);
    }
  } else {
    typename O::T st[5][R][V];
    Chunk<O, VEC, R, V> buf[2];
    if constexpr (FULL) buf[0].load(ts, xs, pitch, bitrev5(0));
    tree_leaves<O, VEC, FULL, R, V, 0>(st, val, buf, ts, xs, pitch, n_chunks);
  }
}

// One output of the block fold as tile_fold_kernel computes it (chunk_fold
// leaves, warp_fold's tree, the slots in order), read from global memory:
// the recheck of a first pass that cannot vouch for its bits. row: the
// output's tile row in slot 0 of its block row; xv: its vector; bit: its
// bit in kUnion's masks.
template <class O, int VEC, int LAYOUT>
__device__ __noinline__ typename O::T exact_output(
    const typename O::T* row, size_t tile_elems, const typename O::T* xv,
    const int* slot_of, const int* col_of, const unsigned* mask_of, int n_slots, int bit,
    int bn) {
  using T = typename O::T;
  const int n_chunks = bn / VEC;
  T acc = O::zero();
  for (int j = 0; j < n_slots; ++j) {
    if (LAYOUT == kUnion && !((mask_of[j] >> bit) & 1u)) continue;
    const T* a = row + (size_t)(LAYOUT == kEll ? j : slot_of[j]) * tile_elems;
    const T* xc = xv + (size_t)col_of[j] * bn;
    T st[5];
    T value = O::zero();
    for (int q = 0; q < 32; ++q) {
      T cur = O::zero();
      for (int c = bitrev5(q); c < n_chunks; c += 32) {
        for (int e = 0; e < VEC; ++e) cur = O::fma(cur, a[c * VEC + e], xc[c * VEC + e]);
      }
      int k = 0;
      for (; (q >> k) & 1; ++k) cur = O::add(st[k], cur);
      if (k == 5) {
        value = cur;
      } else {
        st[k] = cur;
      }
    }
    acc = O::add(acc, value);
  }
  return acc;
}

// FULL: bn / VEC == 32, one chunk a leaf (bn = 128 with 16-byte rows).
// pitch: shared row length; x_off: where a stage's x rows start;
// stage_elems: one stage; vec_warps: warps across the vectors (the rest
// across rows).
template <int SR, int VEC, bool FULL, int LAYOUT>
__global__ void __launch_bounds__(kBlockThreads)
tile_fold_block_kernel(const typename Ops<SR>::T* __restrict__ tiles,
                       const int* __restrict__ index,
                       const typename Ops<SR>::T* __restrict__ x,
                       typename Ops<SR>::T* __restrict__ y,
                       int t_slots, int bm, int bn, int x_len, int batch, int groups,
                       int pitch, int x_off, int stage_elems, int vec_warps) {
  using O = Ops<SR>;
  using F = FirstPass<O>;
  using T = typename O::T;
  constexpr int R = kRowsPerLane;
  constexpr int V = kVecPerLane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int mb = static_cast<int>(gridDim.x) / groups;
  const int i = static_cast<int>(blockIdx.x) / groups;
  const int g = static_cast<int>(blockIdx.x) - i * groups;
  const int b0 = g * kVecGroup;
  const int nv = min(kVecGroup, batch - b0);
  const int row0 = static_cast<int>(blockIdx.y) * kBlockRows;
  const int n_rows = min(kBlockRows, bm - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = (warp % vec_warps) * kWarpVecs;                        // the warp's first vector
  const int v0 = w0 + lane / kLaneRows * V;                              // the lane's first vector
  const int lr0 = (warp / vec_warps) * kWarpRows + lane % kLaneRows;    // the lane's first row
  const bool busy = w0 < nv;                                            // warp-uniform

  int n_slots;
  const int* slot_of = nullptr;
  const int* col_of;
  const unsigned* mask_of = nullptr;
  if constexpr (LAYOUT == kEll) {
    n_slots = t_slots;
    col_of = index + (size_t)i * t_slots;
  } else {
    static_assert(LAYOUT == kUnion, "the block fold reads kEll or kUnion");
    const int* m = index + ((size_t)g * mb + i) * (1 + 3 * (size_t)t_slots);
    n_slots = m[0];
    slot_of = m + 1;
    col_of = m + 1 + t_slots;
    mask_of = reinterpret_cast<const unsigned*>(m + 1 + 2 * t_slots);
  }

  T acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = F::zero();
  }
  const size_t tile_elems = (size_t)bm * bn;
  if (n_slots > 0) {
    const T* rows = tiles + (size_t)i * t_slots * tile_elems + (size_t)row0 * bn;
    const T* xg = x + (size_t)b0 * x_len;
    const int n_chunks = bn / VEC;
    auto copy_slot = [&](int j) {
      T* st = smem + (j % kStages) * stage_elems;
      const int slot = LAYOUT == kEll ? j : slot_of[j];
      stage_rows<VEC, FULL>(st, pitch, rows + (size_t)slot * tile_elems, (size_t)bn, n_rows, bn);
      stage_rows<VEC, FULL>(st + x_off, pitch, xg + (size_t)col_of[j] * bn, (size_t)x_len, nv,
                            bn);
    };
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_slots) copy_slot(j);
      cp_async_commit();
    }
    for (int j = 0; j < n_slots; ++j) {
      // the warp's 8 vectors: skip the slot if none needs it
      const unsigned bits = LAYOUT == kEll ? 0xffu : (mask_of[j] >> w0) & 0xffu;
      if (j + kStages - 1 < n_slots) copy_slot(j + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      if (busy && bits) {
        const T* st = smem + (j % kStages) * stage_elems;
        T val[R][V];
        fold_slot<F, VEC, FULL, R, V>(val, st + lr0 * pitch, st + x_off + v0 * pitch, pitch,
                                      n_chunks);
        const unsigned mine = bits >> (v0 - w0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if ((mine >> v) & 1u) acc[r][v] = F::add(acc[r][v], val[r][v]);
          }
        }
      }
      __syncthreads();
    }
  }
  if (busy) {
    const size_t y_stride = (size_t)mb * bm;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int lr = lr0 + kLaneRows * r;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (lr < n_rows && v0 + v < nv) {
          T out = acc[r][v];
          if constexpr (F::kRecheck) {
            if (out != out || out == T(0)) {
              out = exact_output<O, VEC, LAYOUT>(
                  tiles + (size_t)i * t_slots * tile_elems + (size_t)(row0 + lr) * bn,
                  tile_elems, x + (size_t)(b0 + v0 + v) * x_len, slot_of, col_of, mask_of,
                  n_slots, v0 + v, bn);
            }
          }
          y[(size_t)(b0 + v0 + v) * y_stride + (size_t)i * bm + row0 + lr] = out;
        }
      }
    }
  }
}

template <int SR, int VEC, bool FULL, int LAYOUT>
int launch_block_shape(const void* tiles, const void* index, const void* x, void* y, int mb,
                       int t_slots, int bm, int bn, int x_len, int batch, cudaStream_t stream) {
  using T = typename Ops<SR>::T;
  const auto kernel = tile_fold_block_kernel<SR, VEC, FULL, LAYOUT>;
  const int groups = (batch + kVecGroup - 1) / kVecGroup;
  const int vec_warps = (min(batch, kVecGroup) + kWarpVecs - 1) / kWarpVecs;
  const int row_warps = (min(bm, kBlockRows) + kWarpRows - 1) / kWarpRows;
  const int pitch = VEC == 4 ? 4 * ((bn / 4) | 1) : (bn | 1);
  const int x_off = row_warps * kWarpRows * pitch;
  const int stage_elems = x_off + vec_warps * kWarpVecs * pitch;
  const size_t smem = (size_t)kStages * stage_elems * sizeof(T);
  if ((long long)mb * groups >= (1LL << 31) || smem >= (1u << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB a kernel must opt in to its dynamic shared memory; the
  // card refuses more than it has (cudaErrorInvalidValue)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(mb * groups, (bm + kBlockRows - 1) / kBlockRows);
  const dim3 block(32 * row_warps * vec_warps);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(index), static_cast<const T*>(x),
      static_cast<T*>(y), t_slots, bm, bn, x_len, batch, groups, pitch, x_off, stage_elems,
      vec_warps);
  return static_cast<int>(cudaGetLastError());
}

template <int SR, int LAYOUT>
int launch_block_semiring(const void* tiles, const void* index, const void* x, void* y, int mb,
                          int t_slots, int bm, int bn, int x_len, int batch,
                          cudaStream_t stream) {
  // as in launch_semiring; x_len is a multiple of bn, so with bn % 4 == 0
  // every vector's rows stay 16-byte aligned
  const bool vec4 = bn % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  if (vec4 && bn == 128) {
    return launch_block_shape<SR, 4, true, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn,
                                                   x_len, batch, stream);
  } else if (vec4) {
    return launch_block_shape<SR, 4, false, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn,
                                                    x_len, batch, stream);
  }
  return launch_block_shape<SR, 1, false, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn,
                                                  x_len, batch, stream);
}

// The block launch: x [batch, x_len], y [batch, mb * bm]. Returns the
// cudaError_t of the launch; an unknown semiring code, or a tile shape
// whose stages do not fit in shared memory, returns cudaErrorInvalidValue
// without launching.
template <int LAYOUT>
int launch_block(const void* tiles, const void* index, const void* x, void* y, int mb,
                 int t_slots, int bm, int bn, int x_len, int batch, int sr_code,
                 cudaStream_t stream) {
  if (mb == 0 || bm == 0 || batch == 0) return 0;
  switch (sr_code) {
    case kBoolOrAnd: return launch_block_semiring<kBoolOrAnd, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, stream);
    case kMinPlus: return launch_block_semiring<kMinPlus, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, stream);
    case kPlusTimes: return launch_block_semiring<kPlusTimes, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, stream);
    case kMinTimes: return launch_block_semiring<kMinTimes, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, stream);
    case kPlusAnd: return launch_block_semiring<kPlusAnd, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns the cudaError_t of the launch (0 = success); an unknown semiring
// code returns cudaErrorInvalidValue without launching. row_meta is read by
// kSell only.
template <int LAYOUT>
int launch(const void* tiles, const void* index, const void* row_meta, const void* x,
           void* y, int mb, int t_slots, int bm, int bn, int sr_code, cudaStream_t stream) {
  if (mb == 0 || bm == 0) return 0;
  switch (sr_code) {
    case kBoolOrAnd: return launch_semiring<kBoolOrAnd, LAYOUT>(tiles, index, row_meta, x, y, mb, t_slots, bm, bn, stream);
    case kMinPlus: return launch_semiring<kMinPlus, LAYOUT>(tiles, index, row_meta, x, y, mb, t_slots, bm, bn, stream);
    case kPlusTimes: return launch_semiring<kPlusTimes, LAYOUT>(tiles, index, row_meta, x, y, mb, t_slots, bm, bn, stream);
    case kMinTimes: return launch_semiring<kMinTimes, LAYOUT>(tiles, index, row_meta, x, y, mb, t_slots, bm, bn, stream);
    case kPlusAnd: return launch_semiring<kPlusAnd, LAYOUT>(tiles, index, row_meta, x, y, mb, t_slots, bm, bn, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tilefold
