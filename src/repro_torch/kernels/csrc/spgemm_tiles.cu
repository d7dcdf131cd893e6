// Masked semiring tile SpGEMM for Hopper (sm_90a): C = (A ⊕.⊗ B) ⊙ M.
//
// Replaces the TPU kernel repro/kernels/spgemm_tiles.py:
// semiring_spgemm_padded (body _kernel). Like it, every output tile (i, j)
// whose mask tile is non-empty ⊕-folds ALL T slots of block row i in slot
// order, pads included (a pad is a ⊕-identity tile aliasing tile-column 0,
// but 0 · inf = NaN under ⟨+,×⟩ and inf · 0 under ⟨min,×⟩, so skipping
// pads is a different function), then keeps the result where
// mask != ⊕-identity. Output tiles with an empty mask tile are the
// ⊕-identity and are not computed.
//
// Layout (as the TPU kernel's):
//   tiles   T_val [mb, T, bm, bk]   A's ELL-of-tiles
//   meta    int32 [mb, T + nb]      meta[i, :T] = tile-columns,
//                                   meta[i, T + j] = 1 iff mask tile (i, j) is non-empty
//   b       T_val [kb·bk, nb·bn]    dense right operand
//   mask    T_val [mb·bm, nb·bn]    structural mask
//   active  int32 [n_active, 2]     (i, j) of every output tile whose mask
//                                   flag is set, compacted by the wrapper
//   out     T_val [mb·bm, nb·bn]    filled with the ⊕-identity by the
//                                   wrapper; the kernel writes the active tiles
// Square output tiles, bn = bm ≤ 128, and bk ≤ 128.
//
// Design: the TPU grid (mb, nb, T) carries each output tile in VMEM across
// its T steps. Here one block of 256 threads owns one active output tile
// and keeps it in registers: a 16 × 16 thread grid, each thread RPT × RPT
// outputs strided by 16 (RPT = 1, 2, 4, 8 for tiles up to 16, 32, 64, 128),
// so a warp's B reads are 16 consecutive words and its A reads two
// broadcasts. Per slot, the A tile and the B block are staged through
// shared memory 32 k-columns at a time (33 KB at 128 × 128), and every
// thread ⊕-folds a ⊗ b into its accumulators in slot order, k order. No
// atomics, nothing shared between blocks. ⟨+,×⟩ is fp32 FMA on the CUDA
// cores (nvcc contracts the ⊗ and the ⊕), no TF32. The grid covers only
// the active tiles (72,388 of 291,600 for cit-HP's triangle count at
// 64 × 64).
//
// Bound on the card: operations. cit-HP's triangle count folds
// 72,388 × 386 slots × 64³ ⊗/⊕ pairs (1.46e13 int32 operations) against
// 17.8 GB of operands and output; bytes take ~5 ms at 3.35 TB/s, the int32
// operations ~0.9 s at 64 lanes per SM per clock.
//
// Left for later: pads are folded although pad ⊗ b is the ⊕-identity for
// the 0/1 operands of a triangle count; ⟨+,×⟩ and 0/1 operands could run
// on the tensor cores; the staging is not double-buffered.

#include "tile_fold.cuh"

namespace spgemm {

using tilefold::kBoolOrAnd;
using tilefold::kMinPlus;
using tilefold::kMinTimes;
using tilefold::kPlusAnd;
using tilefold::kPlusTimes;
using tilefold::Ops;

constexpr int kThreads = 256;  // a kSide × kSide thread grid over the output tile
constexpr int kSide = 16;
constexpr int kChunk = 32;     // k-columns of A (rows of B) staged per step
constexpr int kMaxBlock = 128;

template <int SR, int RPT>
__global__ void __launch_bounds__(kThreads)
spgemm_tile_kernel(const typename Ops<SR>::T* __restrict__ tiles,
                   const int* __restrict__ meta,
                   const typename Ops<SR>::T* __restrict__ b,
                   const typename Ops<SR>::T* __restrict__ mask,
                   const int* __restrict__ active,
                   typename Ops<SR>::T* __restrict__ out,
                   int t_slots, int nb, int bm, int bk) {
  using O = Ops<SR>;
  using T = typename O::T;
  constexpr int kTile = kSide * RPT;
  __shared__ T as[kTile][kChunk + 1];  // A rows × k chunk (+1: no bank conflicts)
  __shared__ T bs[kChunk][kTile];      // k chunk × output columns

  const int i = active[2 * static_cast<size_t>(blockIdx.x)];
  const int j = active[2 * static_cast<size_t>(blockIdx.x) + 1];
  const int bn = bm;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  // b, mask and out are n_pad² elements, past 2^31 above n ≈ 46k: every
  // offset is size_t.
  const size_t ld = static_cast<size_t>(nb) * bn;
  const size_t tile_elems = static_cast<size_t>(bm) * bk;
  const int* cols = meta + static_cast<size_t>(i) * (t_slots + nb);
  const T* row_tiles = tiles + static_cast<size_t>(i) * t_slots * tile_elems;
  const T* b_cols = b + static_cast<size_t>(j) * bn;

  T acc[RPT][RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
#pragma unroll
    for (int v = 0; v < RPT; ++v) acc[u][v] = O::zero();
  }

  for (int t = 0; t < t_slots; ++t) {
    const T* a = row_tiles + static_cast<size_t>(t) * tile_elems;
    const T* bb = b_cols + static_cast<size_t>(cols[t]) * bk * ld;
    for (int k0 = 0; k0 < bk; k0 += kChunk) {
      const int kc = min(kChunk, bk - k0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int e = threadIdx.x; e < bm * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        if (kk < kc) as[r][kk] = a[static_cast<size_t>(r) * bk + k0 + kk];
      }
      for (int e = threadIdx.x; e < kChunk * bn; e += kThreads) {
        const int kk = e / bn, c = e % bn;
        if (kk < kc) bs[kk][c] = bb[static_cast<size_t>(k0 + kk) * ld + c];
      }
      __syncthreads();
      // Rows and columns past bm are never stored; their threads fold
      // whatever the staging left there.
      for (int kk = 0; kk < kc; ++kk) {
        T av[RPT], bv[RPT];
#pragma unroll
        for (int u = 0; u < RPT; ++u) av[u] = as[ty + kSide * u][kk];
#pragma unroll
        for (int v = 0; v < RPT; ++v) bv[v] = bs[kk][tx + kSide * v];
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
#pragma unroll
          for (int v = 0; v < RPT; ++v) acc[u][v] = O::add(acc[u][v], O::mul(av[u], bv[v]));
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = ty + kSide * u;
#pragma unroll
    for (int v = 0; v < RPT; ++v) {
      const int c = tx + kSide * v;
      if (r < bm && c < bn) {
        const size_t off = (static_cast<size_t>(i) * bm + r) * ld + static_cast<size_t>(j) * bn + c;
        out[off] = mask[off] != O::zero() ? acc[u][v] : O::zero();
      }
    }
  }
}

template <int SR>
int launch_semiring(const void* tiles, const void* meta, const void* b, const void* mask,
                    const void* active, void* out, int n_active, int t_slots, int nb,
                    int bm, int bk, cudaStream_t stream) {
  using T = typename Ops<SR>::T;
  const T* a = static_cast<const T*>(tiles);
  const int* m = static_cast<const int*>(meta);
  const T* bv = static_cast<const T*>(b);
  const T* mk = static_cast<const T*>(mask);
  const int* act = static_cast<const int*>(active);
  T* o = static_cast<T*>(out);
  const dim3 grid(n_active), block(kThreads);
  if (bm <= kSide) {
    spgemm_tile_kernel<SR, 1><<<grid, block, 0, stream>>>(a, m, bv, mk, act, o, t_slots, nb, bm, bk);
  } else if (bm <= 2 * kSide) {
    spgemm_tile_kernel<SR, 2><<<grid, block, 0, stream>>>(a, m, bv, mk, act, o, t_slots, nb, bm, bk);
  } else if (bm <= 4 * kSide) {
    spgemm_tile_kernel<SR, 4><<<grid, block, 0, stream>>>(a, m, bv, mk, act, o, t_slots, nb, bm, bk);
  } else {
    spgemm_tile_kernel<SR, 8><<<grid, block, 0, stream>>>(a, m, bv, mk, act, o, t_slots, nb, bm, bk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spgemm

// Returns the cudaError_t of the launch (0 = success). A block shape the
// kernel does not take or an unknown semiring code returns
// cudaErrorInvalidValue without launching; n_active = 0 launches nothing.
extern "C" int semiring_spgemm_padded(const void* tiles, const void* meta, const void* b,
                                      const void* mask, const void* active, void* out,
                                      int n_active, int t_slots, int nb, int bm, int bk,
                                      int sr_code, void* stream) {
  using namespace spgemm;
  if (bm < 1 || bm > kMaxBlock || bk < 1 || bk > kMaxBlock || t_slots < 1 || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_active == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sr_code) {
    case kBoolOrAnd: return launch_semiring<kBoolOrAnd>(tiles, meta, b, mask, active, out, n_active, t_slots, nb, bm, bk, s);
    case kMinPlus: return launch_semiring<kMinPlus>(tiles, meta, b, mask, active, out, n_active, t_slots, nb, bm, bk, s);
    case kPlusTimes: return launch_semiring<kPlusTimes>(tiles, meta, b, mask, active, out, n_active, t_slots, nb, bm, bk, s);
    case kMinTimes: return launch_semiring<kMinTimes>(tiles, meta, b, mask, active, out, n_active, t_slots, nb, bm, bk, s);
    case kPlusAnd: return launch_semiring<kPlusAnd>(tiles, meta, b, mask, active, out, n_active, t_slots, nb, bm, bk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
