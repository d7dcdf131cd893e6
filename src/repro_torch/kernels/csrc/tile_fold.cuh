// Shared device code of the tile kernels (semiring_spmv.cu,
// spmspv_tiles.cu, semiring_spmv_fused.cu, semiring_spmv_sell.cu,
// spmspv_fused.cu): the five semirings and the per-block-row fold, over
// one vector (tile_fold_kernel) or a block of vectors
// (tile_fold_batch_kernel, below).
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
constexpr int kBatchRows = kRowsPerBlock / (kThreads / 32);   // 2: rows a warp folds at once

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

// warp_fold for N values per lane at once (N a power of two <= 32): a
// reduce-scatter. At each offset while a lane holds more than one value it
// keeps half of them (the upper half where its lane bit is set), sends the
// other half to its partner and ⊕-adds what comes back; then plain
// butterfly steps. Every addition is the one warp_fold makes, ⊕(mine,
// partner's), at the same offset and on the same operands, so the value
// each lane ends with, that of vector lane >> (5 - log2 N), is warp_fold's
// bit for bit, at N - 1 + 5 - log2 N shuffles instead of 5·N.
template <class O, int N, int OFF>
__device__ __forceinline__ void warp_fold_scatter(typename O::T* v, int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const typename O::T send = upper ? v[k] : v[k + H];
        const typename O::T keep = upper ? v[k + H] : v[k];
        v[k] = O::add(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
      }
      warp_fold_scatter<O, H, OFF / 2>(v, lane);
    } else {
      v[0] = O::add(v[0], __shfl_xor_sync(0xffffffffu, v[0], OFF));
      warp_fold_scatter<O, 1, OFF / 2>(v, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The fold over a block of vectors: what the JAX package runs as jax.vmap of
// kernels 1 and 2 over a [B, n] frontier block (multi-source traversals).
//   x  T_val [B, nb * bn], y T_val [B, mb * bm]
//   kEll     index int32 [mb, T] shared by every vector; a warp loads each
//            16-byte chunk of a tile row once and folds it against NB
//            vectors, so the tiles are streamed ceil(B / NB) times, not B
//   kActive  index int32 [B, mb, 1 + 2T], one meta per vector; NB = 1
// Grid: x = (block row i, vector group g), g fastest, so the groups that
// read block row i's tile rows run side by side and meet them in L2; y is
// the tile-row group of tile_fold_kernel, whose two rows per warp are
// folded together, so each x chunk load serves both. For every vector the
// lane→chunk mapping, chunk_fold order, warp_fold butterfly and slot order
// are those of tile_fold_kernel (the butterfly done as warp_fold_scatter),
// so row b is bit-identical to the single-vector launch on x[b]; only the
// number of slots in flight differs, which changes no sum. On the card,
// folding the two rows together was faster than one row at a time, and a
// second slot in flight at NB >= 4 slower (registers).
template <int SR, int VEC, int LAYOUT, bool ONE_CHUNK, int NB>
__global__ void __launch_bounds__(kThreads)
tile_fold_batch_kernel(const typename Ops<SR>::T* __restrict__ tiles,
                       const int* __restrict__ index, size_t index_stride,
                       const typename Ops<SR>::T* __restrict__ x, size_t x_stride,
                       typename Ops<SR>::T* __restrict__ y, size_t y_stride,
                       int t_slots, int bm, int bn, int batch, int groups) {
  using O = Ops<SR>;
  using T = typename O::T;
  using V = typename Vec<T, VEC>::type;
  // Each warp folds kBatchRows tile rows (r and r + n_warps) at once, so one
  // load of a vector's x chunk serves both rows; U slots in flight.
  constexpr int R = kBatchRows;
  constexpr int U = NB >= 4 ? 1 : 4 / NB;

  const int i = static_cast<int>(blockIdx.x) / groups;
  const int b0 = (static_cast<int>(blockIdx.x) - i * groups) * NB;
  const int nv = min(NB, batch - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_chunks = bn / VEC;
  const size_t tile_elems = (size_t)bm * bn;

  int n_slots;
  const int* slot_of = nullptr;
  const int* col_of;
  const T* row_tiles = tiles + (size_t)i * t_slots * tile_elems;
  if constexpr (LAYOUT == kEll) {
    n_slots = t_slots;
    col_of = index + (size_t)i * t_slots;
  } else {
    static_assert(LAYOUT == kActive && NB == 1, "kActive folds one vector per block");
    const int* m = index + (size_t)b0 * index_stride + (size_t)i * (1 + 2 * t_slots);
    n_slots = m[0];
    slot_of = m + 1;
    col_of = m + 1 + t_slots;
  }
  const T* xg = x + (size_t)b0 * x_stride;

  // after warp_fold_scatter a lane holds vector mine = lane / (32 / NB)
  constexpr int kLanesPerVector = 32 / NB;
  const int mine = lane / kLanesPerVector;
  const int row0 = static_cast<int>(blockIdx.y) * kRowsPerBlock;
  const int r_end = min(bm, row0 + kRowsPerBlock);
  for (int rb = row0 + warp; rb < r_end; rb += R * n_warps) {
    T acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = O::zero();
    for (int j0 = 0; j0 < n_slots; j0 += U) {
      T part[U][R][NB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
#pragma unroll
        for (int k = 0; k < R; ++k) {
#pragma unroll
          for (int v = 0; v < NB; ++v) part[u][k][v] = O::zero();
        }
        if (j < n_slots) {
          const int slot = LAYOUT == kActive ? slot_of[j] : j;
          const T* tile = row_tiles + (size_t)slot * tile_elems;
          const T* xcol = xg + (size_t)col_of[j] * bn;
          for (int c = lane; c < (ONE_CHUNK ? min(n_chunks, lane + 1) : n_chunks); c += 32) {
            V xv[NB];
#pragma unroll
            for (int v = 0; v < NB; ++v) {
              if (v < nv) xv[v] = reinterpret_cast<const V*>(xcol + (size_t)v * x_stride)[c];
            }
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const int r = rb + k * n_warps;
              if (r < r_end) {
                const V av = reinterpret_cast<const V*>(tile + (size_t)r * bn)[c];
#pragma unroll
                for (int v = 0; v < NB; ++v) {
                  if (v < nv) part[u][k][v] = chunk_fold<O, VEC>(part[u][k][v], av, xv[v]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < n_slots) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            warp_fold_scatter<O, NB, 16>(part[u][k], lane);
            acc[k] = O::add(acc[k], part[u][k][0]);
          }
        }
      }
    }
    if (lane % kLanesPerVector == 0 && mine < nv) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = rb + k * n_warps;
        if (r < r_end) y[(size_t)(b0 + mine) * y_stride + (size_t)i * bm + r] = acc[k];
      }
    }
  }
}

template <int SR, int VEC, int LAYOUT, bool ONE_CHUNK>
int launch_batch_nb(const typename Ops<SR>::T* a, const int* idx, size_t idx_stride,
                    const typename Ops<SR>::T* xv, size_t x_stride, typename Ops<SR>::T* yv,
                    size_t y_stride, int mb, int t_slots, int bm, int bn, int batch, int nb,
                    cudaStream_t stream) {
  if (LAYOUT == kActive || VEC != 4) nb = 1;
  const int groups = (batch + nb - 1) / nb;
  if ((long long)mb * groups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(mb * groups, (bm + kRowsPerBlock - 1) / kRowsPerBlock), block(kThreads);
#define TILEFOLD_BATCH(NB_)                                                                   \
  tile_fold_batch_kernel<SR, VEC, LAYOUT, ONE_CHUNK, NB_><<<grid, block, 0, stream>>>(       \
      a, idx, idx_stride, xv, x_stride, yv, y_stride, t_slots, bm, bn, batch, groups)
  if constexpr (LAYOUT == kActive || VEC != 4) {
    // one vector a block whatever nb says: kActive's slots differ per
    // vector, and the unvectorised tile shapes are not worth more
    // instantiations (rows are bit-identical for every nb)
    TILEFOLD_BATCH(1);
  } else {
    switch (nb) {
      case 1: TILEFOLD_BATCH(1); break;
      case 2: TILEFOLD_BATCH(2); break;
      case 4: TILEFOLD_BATCH(4); break;
      case 8: TILEFOLD_BATCH(8); break;
      case 16: TILEFOLD_BATCH(16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef TILEFOLD_BATCH
  return static_cast<int>(cudaGetLastError());
}

template <int SR, int LAYOUT>
int launch_batch_semiring(const void* tiles, const void* index, const void* x, void* y,
                          int mb, int t_slots, int bm, int bn, int x_len, int batch, int nb,
                          cudaStream_t stream) {
  using T = typename Ops<SR>::T;
  const T* a = static_cast<const T*>(tiles);
  const int* idx = static_cast<const int*>(index);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  const size_t idx_stride = LAYOUT == kActive ? (size_t)mb * (1 + 2 * t_slots) : 0;
  const size_t y_stride = (size_t)mb * bm;
  // as in launch_semiring; x_len is a multiple of bn, so with bn % 4 == 0
  // every vector's rows stay 16-byte aligned
  const bool vec4 = bn % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  const bool one = (vec4 ? bn / 4 : bn) <= 32;
  if (vec4 && one) {
    return launch_batch_nb<SR, 4, LAYOUT, true>(a, idx, idx_stride, xv, x_len, yv, y_stride, mb,
                                                t_slots, bm, bn, batch, nb, stream);
  } else if (vec4) {
    return launch_batch_nb<SR, 4, LAYOUT, false>(a, idx, idx_stride, xv, x_len, yv, y_stride, mb,
                                                 t_slots, bm, bn, batch, nb, stream);
  } else if (one) {
    return launch_batch_nb<SR, 1, LAYOUT, true>(a, idx, idx_stride, xv, x_len, yv, y_stride, mb,
                                                t_slots, bm, bn, batch, nb, stream);
  }
  return launch_batch_nb<SR, 1, LAYOUT, false>(a, idx, idx_stride, xv, x_len, yv, y_stride, mb,
                                               t_slots, bm, bn, batch, nb, stream);
}

// The block launch: x [batch, x_len], y [batch, mb * bm]; nb vectors per
// block: 1, 2, 4, 8 or 16 for kEll with 16-byte rows, taken as 1 for kActive
// and for the unvectorised shapes. Returns the
// cudaError_t of the launch; an unknown semiring code or nb returns
// cudaErrorInvalidValue without launching.
template <int LAYOUT>
int launch_batch(const void* tiles, const void* index, const void* x, void* y, int mb,
                 int t_slots, int bm, int bn, int x_len, int batch, int nb, int sr_code,
                 cudaStream_t stream) {
  if (mb == 0 || bm == 0 || batch == 0) return 0;
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (sr_code) {
    case kBoolOrAnd: return launch_batch_semiring<kBoolOrAnd, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, nb, stream);
    case kMinPlus: return launch_batch_semiring<kMinPlus, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, nb, stream);
    case kPlusTimes: return launch_batch_semiring<kPlusTimes, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, nb, stream);
    case kMinTimes: return launch_batch_semiring<kMinTimes, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, nb, stream);
    case kPlusAnd: return launch_batch_semiring<kPlusAnd, LAYOUT>(tiles, index, x, y, mb, t_slots, bm, bn, x_len, batch, nb, stream);
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
