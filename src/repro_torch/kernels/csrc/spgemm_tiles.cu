// Masked semiring tile SpGEMM for Hopper (sm_90a): C = (A ⊕.⊗ B) ⊙ M.
//
// Replaces the TPU kernel repro/kernels/spgemm_tiles.py:
// semiring_spgemm_padded (body _kernel). Like it, every output tile (i, j)
// whose mask tile is non-empty ⊕-folds all T slots of block row i in slot
// order, pads included, then keeps the result where mask != ⊕-identity;
// output tiles with an empty mask tile are the ⊕-identity and are not
// computed.
//
// Layout:
//   tiles   T_val [mb, T, bm, bk]   A's ELL-of-tiles: real tiles first in
//                                   increasing tile-column order, then pads
//                                   (⊕-identity tiles at tile-column 0)
//   meta    int32 [mb, T + nb]      meta[i, :T] = tile-columns,
//                                   meta[i, T+j] = 1 iff mask tile (i, j)
//                                   is non-empty
//   b       T_val [kb·bk, nb·bn]    dense right operand
//   mask    T_val [mb·bm, nb·bn]    structural mask
//   out     T_val [mb·bm, nb·bn]    filled with the ⊕-identity by the
//                                   wrapper; the kernel writes the active tiles
//   counts  uint64 [2]              (tile, slot) pairs folded as real slots
//                                   and as the pad row; the kernel adds to them
// Square output tiles, bn = bm ≤ 128, and bk ≤ 128.
//
// Design. Every pad slot is the same ⊕-identity tile under tile-column 0,
// so what it adds to output column c is one value, P[c] = ⊕_{k<bk} (zero ⊗
// b[k, c]), whatever the row. A block of 8 warps owns group q of block row
// i: the row's active output tiles (non-empty mask tiles) of ranks q·G to
// q·G + G − 1 (G = 16, 8, 4, 1 for bm up to 16, 32, 64, 128: 256 output
// columns, 128 at 128). It finds them from the row's mask-tile flags, and
// the row's real slots n_real (1 + the strict increases of its
// tile-columns: real tiles come first in increasing order, pads repeat
// tile-column 0), by two block-wide scans; a block whose group is empty
// returns. It folds only the n_real real slots, densely; then it folds
// P[c], computed from B's first bk rows, once for the row's pad slots
// (npad times for the int32 sum) and applies the mask. That is the TPU
// kernel's function exactly: pads come after the real slots in slot order,
// and their contribution is P. Each A tile staged serves G output tiles.
// The grid runs group q of every block row before group q + 1, so blocks
// running together read nearby column strips of B from L2. Nothing is
// prepared on the host or in another launch.
//
// The real slots stream through a 3-stage ring in shared memory, each
// stage kKC k-columns of one slot: the A tile's rows (k contiguous, row
// stride kKC + 4) and the group's B rows (G blocks side by side, row
// stride N + 8), copied by 16-byte cp.async (4-byte where bm or bk is not
// a multiple of 4 or an operand is not 16-byte aligned) two steps ahead,
// with one barrier per step. Pads inside a stage (k past bk, rows past bm,
// columns past bn, tiles past the group) hold the ⊕-identity, written
// once; zero ⊗ zero ⊕ x = x in every semiring, and they are not stored.
//
// The fold, on the CUDA cores for every semiring: each thread owns TM rows
// (4 apart) × 8 columns (two 4-wide runs 32 apart) of the group's output
// in registers; a warp is 4 row lanes × 8 column lanes. Per 4 k it loads
// TM 16-byte words of A (one per row, k contiguous) and 8 of B, for 32·TM
// ⊕/⊗ pairs. ⟨+,×⟩ is one fp32 FMA a pair; the min semirings fold with
// min.NaN (NaN wins, as min_nan). Integer and min semirings are exact in
// any order. ⟨+,×⟩ stays off the tensor cores: as three TF32 products
// (3×TF32) it ran ~10% faster, but the mma's fp32 accumulation is not
// rounded to nearest, and its error grows with a row's nonzeros, past
// rtol 1e-5 at a few hundred (PERF.md §6).
//
// Bound on the card: operations. ca-Q ⟨+,×⟩ at 64 × 64 needs 1.04e11 MACs
// over the real slots: 3.1 ms in fp32. Besides, the B block of every
// (output tile, real slot) pair and each group's row of A tiles cross L2
// into shared memory, 8.2 GB there. On an H100 SXM (700 W) the launch
// takes ~6.8 ms (tools/spgemm_tiles_sweep.py): 46% of the bound.

#include <cstdint>
#include <type_traits>

#include "tile_fold.cuh"

namespace spgemm {

using tilefold::kBoolOrAnd;
using tilefold::kMinPlus;
using tilefold::kMinTimes;
using tilefold::kPlusAnd;
using tilefold::kPlusTimes;
using tilefold::Ops;

constexpr int kThreads = 256;          // 8 warps
constexpr int kKC = 32;                // k-columns of one ring stage
constexpr int kStages = 3;             // ring depth
constexpr int kMaxBlock = 128;
constexpr int kColCache = 512;         // tile-columns of a row kept in shared memory
constexpr int kPadA = 4;               // words after each shared A row
constexpr int kPadB = 8;               // words after each shared B row
constexpr int kShortK = 16;            // k folded of a stage where bk ≤ 16

__host__ __device__ constexpr int round_block(int bm) {
  return bm <= 16 ? 16 : (bm <= 32 ? 32 : (bm <= 64 ? 64 : 128));
}

// Output tiles per group for a block of bm rows, 256 output columns up to
// 64 rows; the wrapper passes its own count, which must agree.
__host__ __device__ constexpr int group_size(int bm) {
  return bm <= 16 ? 16 : (bm <= 32 ? 8 : (bm <= 64 ? 4 : 1));
}

// BM is bm rounded up to 16, 32, 64 or 128.
template <int BM>
struct Shape {
  static constexpr int G = group_size(BM);
  static constexpr int N = G * BM;           // output columns of a group
  static constexpr int LDA = kKC + kPadA;    // 4 banks apart row to row
  static constexpr int LDB = N + kPadB;      // 8 banks apart row to row
  static constexpr int kStageElems = BM * LDA + kKC * LDB;
  // 8 columns and TM rows a thread; warps WM × WN, each 4·TM rows × 64
  // columns
  static constexpr int TM = BM * N / (kThreads * 8);
  static constexpr int WM = BM / (4 * TM);
  static constexpr int WN = N / 64;
  static_assert(TM >= 1 && WM * WN == kThreads / 32, "warp tiling");
};

template <typename T> struct V4;
template <> struct V4<float> { using type = float4; };
template <> struct V4<int> { using type = int4; };

template <typename V>
__device__ __forceinline__ auto lane(const V& v, int q) -> decltype(v.x) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// min that is NaN when either side is NaN, in one instruction (min_nan
// of tile_fold.cuh compares and selects; the two differ only in which
// zero of two signs they keep and in the NaN's payload).
__device__ __forceinline__ float min_nan_hw(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// p ⊕ (a ⊗ x) of the CUDA-core fold.
template <int SR>
__device__ __forceinline__ typename Ops<SR>::T fold(typename Ops<SR>::T p, typename Ops<SR>::T a,
                                                    typename Ops<SR>::T x) {
  if constexpr (SR == kMinPlus) {
    return min_nan_hw(p, a + x);
  } else if constexpr (SR == kMinTimes) {
    return min_nan_hw(p, a * x);
  } else {
    return Ops<SR>::fma(p, a, x);
  }
}

// acc ⊕ P folded npad times: as a wrapping product for the int32 sum,
// else once: ⊕ is idempotent for min and max, and the f32 sum's P is ±0
// or NaN, which a second add leaves as the first left it.
template <int SR>
__device__ __forceinline__ typename Ops<SR>::T pad_fold(typename Ops<SR>::T acc,
                                                        typename Ops<SR>::T p, int npad) {
  if (npad <= 0) return acc;
  if constexpr (SR == kPlusAnd) {
    return static_cast<int>(static_cast<unsigned>(acc) +
                            static_cast<unsigned>(npad) * static_cast<unsigned>(p));
  } else {
    return Ops<SR>::add(acc, p);
  }
}

template <typename T>
struct Args {
  const T* tiles;
  const int* meta;
  const T* b;
  const T* mask;
  T* out;
  unsigned long long* counts;
  int t_slots, mb, nb, bm, bk;
  int vec;  // 16-byte copies and vector epilogue
};

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the sum over the block. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    sum += warp_sum[w];
  }
  __syncthreads();  // warp_sum is free for the next call
  *total = sum;
  return before + x - v;
}

template <int SR, int BM>
__global__ void __launch_bounds__(kThreads, 1)
spgemm_group_kernel(const Args<typename Ops<SR>::T> p) {
  using O = Ops<SR>;
  using T = typename O::T;
  using V = typename V4<T>::type;
  using S = Shape<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int tile_j[S::G];
  __shared__ int cols_s[kColCache];
  __shared__ __align__(16) T pad_s[S::N];  // P of the group's columns

  const int tid = threadIdx.x;
  const int grp = blockIdx.x / p.mb, i = blockIdx.x % p.mb;
  const int bm = p.bm, bk = p.bk, bn = bm;
  const int* cols = p.meta + static_cast<size_t>(i) * (p.t_slots + p.nb);
  const int* flags = cols + p.t_slots;
  // the group: each thread counts the active tiles of its run of the
  // row's flags, and the strict increases of the row's tile-columns
  const int run = (p.nb + kThreads - 1) / kThreads;
  const int j0 = min(p.nb, tid * run), j1 = min(p.nb, j0 + run);
  int mine = 0, inc = 0;
  for (int j = j0; j < j1; ++j) mine += flags[j] > 0;
  for (int t = tid + 1; t < p.t_slots; t += kThreads) inc += cols[t] > cols[t - 1];
  int n_active, n_inc;
  int rank = block_exclusive_scan(mine, &n_active);
  block_exclusive_scan(inc, &n_inc);
  const int count = min(S::G, n_active - grp * S::G);
  if (count <= 0) return;  // the same for every thread of the block
  for (int j = j0; j < j1; ++j) {
    if (flags[j] > 0) {
      const int g = rank++ - grp * S::G;
      if (g >= 0 && g < S::G) tile_j[g] = j;
    }
  }
  const int n_real = 1 + n_inc;
  const int npad = p.t_slots - n_real;
  const int cps = (bk + kKC - 1) / kKC;  // ring steps per slot
  const int steps = n_real * cps;
  const bool short_k = bk <= kShortK;  // one stage a slot, its k past kShortK never written
  // b, mask and out are n_pad² elements, past 2³¹ above n ≈ 46k: every
  // offset into them is size_t.
  const size_t ld = static_cast<size_t>(p.nb) * bn;
  const size_t tile_elems = static_cast<size_t>(bm) * bk;
  const T* a_row = p.tiles + static_cast<size_t>(i) * p.t_slots * tile_elems;

  for (int e = tid; e < kStages * S::kStageElems; e += kThreads) smem[e] = O::zero();
  for (int t = tid; t < min(n_real, kColCache); t += kThreads) cols_s[t] = cols[t];
  __syncthreads();

  auto load = [&](int s, int stage) {
    const int t = s / cps;
    const int k0 = (s - t * cps) * kKC;
    const int kc = min(kKC, bk - k0);
    const int col = t < kColCache ? cols_s[t] : cols[t];
    T* as = smem + stage * S::kStageElems;
    T* bs = as + BM * S::LDA;
    const T* a = a_row + static_cast<size_t>(t) * tile_elems + k0;
    const T* brow = p.b + (static_cast<size_t>(col) * bk + k0) * ld;
    if (p.vec) {
      constexpr int QA = kKC / 4, QB = S::N / 4;
      for (int e = tid; e < BM * QA; e += kThreads) {
        const int r = e / QA, q = 4 * (e % QA);
        if (r < bm && q < kc) cp_async16(as + r * S::LDA + q, a + static_cast<size_t>(r) * bk + q);
      }
      for (int e = tid; e < kKC * QB; e += kThreads) {
        const int kk = e / QB, n = 4 * (e % QB);
        const int g = n / BM, c = n % BM;
        if (kk < kc && g < count && c < bn) {
          cp_async16(bs + kk * S::LDB + n, brow + kk * ld + static_cast<size_t>(tile_j[g]) * bn + c);
        }
      }
    } else {
      for (int e = tid; e < BM * kKC; e += kThreads) {
        const int r = e / kKC, q = e % kKC;
        if (r < bm && q < kc) cp_async4(as + r * S::LDA + q, a + static_cast<size_t>(r) * bk + q);
      }
      for (int e = tid; e < kKC * S::N; e += kThreads) {
        const int kk = e / S::N, n = e % S::N;
        const int g = n / BM, c = n % BM;
        if (kk < kc && g < count && c < bn) {
          cp_async4(bs + kk * S::LDB + n, brow + kk * ld + static_cast<size_t>(tile_j[g]) * bn + c);
        }
      }
    }
    if (cps > 1 && kc < kKC) {
      // the stage held a whole chunk before: its k past kc must read as
      // the ⊕-identity again (no copy into this stage is in flight)
      for (int e = tid; e < BM * kKC; e += kThreads) {
        if (e % kKC >= kc) as[(e / kKC) * S::LDA + e % kKC] = O::zero();
      }
      for (int e = kc * S::N + tid; e < kKC * S::N; e += kThreads) {
        bs[(e / S::N) * S::LDB + e % S::N] = O::zero();
      }
    }
  };

  const int warp = tid / 32, lane_id = tid % 32;
  const int lr = lane_id / 8, lc = lane_id % 8;
  const int row0 = (warp / S::WN) * 4 * S::TM + lr;  // rows row0 + 4u
  const int col0 = (warp % S::WN) * 64 + 4 * lc;      // columns col0 + v, col0 + 32 + v
  T acc[S::TM][8];
#pragma unroll
  for (int u = 0; u < S::TM; ++u) {
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = O::zero();
  }
  auto fold_stage = [&](const T* as, const T* bs, auto kend) {
    constexpr int KEND = decltype(kend)::value;
#pragma unroll
    for (int k = 0; k < KEND; k += 4) {
      V av[S::TM];
#pragma unroll
      for (int u = 0; u < S::TM; ++u) {
        av[u] = *reinterpret_cast<const V*>(as + (row0 + 4 * u) * S::LDA + k);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const V b0 = *reinterpret_cast<const V*>(bs + (k + q) * S::LDB + col0);
        const V b1 = *reinterpret_cast<const V*>(bs + (k + q) * S::LDB + col0 + 32);
#pragma unroll
        for (int u = 0; u < S::TM; ++u) {
          const T a = lane(av[u], q);
          acc[u][0] = fold<SR>(acc[u][0], a, b0.x);
          acc[u][1] = fold<SR>(acc[u][1], a, b0.y);
          acc[u][2] = fold<SR>(acc[u][2], a, b0.z);
          acc[u][3] = fold<SR>(acc[u][3], a, b0.w);
          acc[u][4] = fold<SR>(acc[u][4], a, b1.x);
          acc[u][5] = fold<SR>(acc[u][5], a, b1.y);
          acc[u][6] = fold<SR>(acc[u][6], a, b1.z);
          acc[u][7] = fold<SR>(acc[u][7], a, b1.w);
        }
      }
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  // P of the group's columns, while the first copies fly; the epilogue
  // reads it after the ring's barriers (steps ≥ 1)
  if (npad > 0) {
    for (int n = tid; n < S::N; n += kThreads) {
      const int g = n / BM, c = n % BM;
      if (g >= count || c >= bn) continue;
      const T* bc = p.b + static_cast<size_t>(tile_j[g]) * bn + c;
      T pv = O::zero();
#pragma unroll 8
      for (int k = 0; k < bk; ++k) pv = O::add(pv, O::mul(O::zero(), bc[k * ld]));
      pad_s[n] = pv;
    }
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < steps) load(nxt, nxt % kStages);
    cp_async_commit();
    const T* as = smem + (s % kStages) * S::kStageElems;
    const T* bs = as + BM * S::LDA;
    if (short_k) {
      fold_stage(as, bs, std::integral_constant<int, kShortK>{});
    } else {
      fold_stage(as, bs, std::integral_constant<int, kKC>{});
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < S::TM; ++u) {
    const int r = row0 + 4 * u;
    if (r >= bm) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = col0 + 32 * h;
      const int g = n / BM, c = n % BM;
      if (g >= count || c >= bn) continue;
      const size_t col = static_cast<size_t>(tile_j[g]) * bn + c;
      const size_t off = (static_cast<size_t>(i) * bm + r) * ld + col;
      T v[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) v[w] = acc[u][4 * h + w];
      if (p.vec) {  // c + 3 < bn: bn is a multiple of 4
        const V pr = *reinterpret_cast<const V*>(pad_s + n);
        const V m = *reinterpret_cast<const V*>(p.mask + off);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          v[w] = pad_fold<SR>(v[w], lane(pr, w), npad);
          v[w] = lane(m, w) != O::zero() ? v[w] : O::zero();
        }
        V o;
        o.x = v[0];
        o.y = v[1];
        o.z = v[2];
        o.w = v[3];
        *reinterpret_cast<V*>(p.out + off) = o;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (c + w >= bn) continue;
          const T x = pad_fold<SR>(v[w], pad_s[n + w], npad);
          p.out[off + w] = p.mask[off + w] != O::zero() ? x : O::zero();
        }
      }
    }
  }

  if (tid == 0) {
    atomicAdd(p.counts, static_cast<unsigned long long>(count) * n_real);
    atomicAdd(p.counts + 1, static_cast<unsigned long long>(count) * npad);
  }
}

template <int SR, int BM>
int launch(const Args<typename Ops<SR>::T>& args, cudaStream_t stream) {
  const int smem = kStages * Shape<BM>::kStageElems * static_cast<int>(sizeof(typename Ops<SR>::T));
  const long long blocks = static_cast<long long>(args.mb) *
                           ((args.nb + Shape<BM>::G - 1) / Shape<BM>::G);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = spgemm_group_kernel<SR, BM>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int SR>
int launch_semiring(const void* tiles, const void* meta, const void* b, const void* mask,
                    void* out, void* counts, int t_slots, int mb, int nb, int bm, int bk,
                    cudaStream_t stream) {
  using T = typename Ops<SR>::T;
  Args<T> args;
  args.tiles = static_cast<const T*>(tiles);
  args.meta = static_cast<const int*>(meta);
  args.b = static_cast<const T*>(b);
  args.mask = static_cast<const T*>(mask);
  args.out = static_cast<T*>(out);
  args.counts = static_cast<unsigned long long*>(counts);
  args.t_slots = t_slots;
  args.mb = mb;
  args.nb = nb;
  args.bm = bm;
  args.bk = bk;
  args.vec = bm % 4 == 0 && bk % 4 == 0 && aligned16(tiles) && aligned16(b) && aligned16(mask) &&
             aligned16(out);
  if (bm <= 16) return launch<SR, 16>(args, stream);
  if (bm <= 32) return launch<SR, 32>(args, stream);
  if (bm <= 64) return launch<SR, 64>(args, stream);
  return launch<SR, 128>(args, stream);
}

}  // namespace spgemm

extern "C" int spgemm_tiles_group_size(int bm) { return spgemm::group_size(bm); }

// Returns the cudaError_t of the launch (0 = success). A block shape the
// kernel does not take, a group size other than spgemm_tiles_group_size(bm),
// an unknown semiring code or a grid past 2³¹ − 1 blocks returns
// cudaErrorInvalidValue without launching; mb = 0 launches nothing.
extern "C" int semiring_spgemm_padded(const void* tiles, const void* meta, const void* b,
                                      const void* mask, void* out, void* counts, int t_slots,
                                      int mb, int nb, int bm, int bk, int group_size,
                                      int sr_code, void* stream) {
  using namespace spgemm;
  if (bm < 1 || bm > kMaxBlock || bk < 1 || bk > kMaxBlock || t_slots < 1 || nb < 1 ||
      mb < 0 || group_size != spgemm::group_size(bm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPGEMM_ARGS tiles, meta, b, mask, out, counts, t_slots, mb, nb, bm, bk, s
  // Built with -DSPGEMM_SEMIRING=<code> (kernels/_build.py builds one
  // library a semiring, in parallel): the library holds that semiring's
  // kernels alone, and another code returns cudaErrorInvalidValue.
#ifndef SPGEMM_SEMIRING
#error "spgemm_tiles.cu is built once a semiring: pass -DSPGEMM_SEMIRING=<0..4>"
#endif
  switch (sr_code) {
#if SPGEMM_SEMIRING == 0
    case kBoolOrAnd: return launch_semiring<kBoolOrAnd>(SPGEMM_ARGS);
#endif
#if SPGEMM_SEMIRING == 1
    case kMinPlus: return launch_semiring<kMinPlus>(SPGEMM_ARGS);
#endif
#if SPGEMM_SEMIRING == 2
    case kPlusTimes: return launch_semiring<kPlusTimes>(SPGEMM_ARGS);
#endif
#if SPGEMM_SEMIRING == 3
    case kMinTimes: return launch_semiring<kMinTimes>(SPGEMM_ARGS);
#endif
#if SPGEMM_SEMIRING == 4
    case kPlusAnd: return launch_semiring<kPlusAnd>(SPGEMM_ARGS);
#endif
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPGEMM_ARGS
}
