// Shared device code of the tile kernels (semiring_spmv.cu,
// spmspv_tiles.cu, semiring_spmv_fused.cu, semiring_spmv_sell.cu,
// spmspv_fused.cu): the five semirings and the per-block-row fold.
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
//   x         T_val [nb * bn]        dense input vector
//   y         T_val [mb * bm]        output
//
// Design: blockIdx.x is the block row, blockIdx.y a group of kRowsPerBlock
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
  return (a < b || a != a) ? a : b;
}

template <int SR> struct Ops;

template <> struct Ops<kBoolOrAnd> {
  using T = int;
  __device__ __forceinline__ static T zero() { return 0; }
  __device__ __forceinline__ static T add(T a, T b) { return max(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return min(a, b); }
};

template <> struct Ops<kMinPlus> {
  using T = float;
  __device__ __forceinline__ static T zero() { return INFINITY; }
  __device__ __forceinline__ static T add(T a, T b) { return min_nan(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return a + b; }
};

template <> struct Ops<kPlusTimes> {
  using T = float;
  __device__ __forceinline__ static T zero() { return 0.0f; }
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
};

template <> struct Ops<kMinTimes> {
  using T = float;
  __device__ __forceinline__ static T zero() { return INFINITY; }
  __device__ __forceinline__ static T add(T a, T b) { return min_nan(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
};

template <> struct Ops<kPlusAnd> {
  using T = int;
  __device__ __forceinline__ static T zero() { return 0; }
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  __device__ __forceinline__ static T mul(T a, T b) { return min(a, b); }
};

template <typename T, int VEC> struct Vec { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<int, 4> { using type = int4; };

// p ⊕ (a ⊗ x), element by element, in element order.
template <class O, int VEC>
__device__ __forceinline__ typename O::T chunk_fold(
    typename O::T p, const typename Vec<typename O::T, VEC>::type& a,
    const typename Vec<typename O::T, VEC>::type& x) {
  if constexpr (VEC == 4) {
    p = O::add(p, O::mul(a.x, x.x));
    p = O::add(p, O::mul(a.y, x.y));
    p = O::add(p, O::mul(a.z, x.z));
    p = O::add(p, O::mul(a.w, x.w));
  } else {
    p = O::add(p, O::mul(a, x));
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

enum Layout { kEll = 0, kActive = 1, kReal = 2, kSell = 3 };

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
