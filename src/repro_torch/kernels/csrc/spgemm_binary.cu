// Masked tile SpGEMM of 0/1 operands on Hopper's int8 tensor cores
// (sm_90a): C = (A · B) ⊙ M under ⟨+,∧⟩, and C = (A · B > 0) ⊙ M under
// ⟨∨,∧⟩.
//
// Replaces, for these operands, the TPU kernel
// repro/kernels/spgemm_tiles.py::semiring_spgemm_padded (body _kernel),
// whose CUDA-core port is spgemm_tiles.cu. The front door
// (repro_torch/kernels/ops.py::semiring_spgemm) takes this kernel only
// when the semiring is ⟨+,∧⟩ or ⟨∨,∧⟩, bm and bk are multiples of 16 and
// every value of A's tiles and of the padded B is 0 or 1. There the
// function is exact on the tensor cores: on {0, 1}, min(a, b) = a · b;
// pad tiles hold 0, so each pad product is 0, the ⊕-identity, and the
// pads can be skipped; int32 sums are exact in any order; ⟨∨,∧⟩ is
// count > 0.
//
// Layout:
//   a8      int8  [mb, T, bm, bk]   A's ELL-of-tiles, k contiguous (packed
//                                   by the wrapper from the int32 tiles)
//   meta    int32 [mb, T + nb]      meta[i, :T] = tile-columns (the
//                                   mask-tile flags are read by the wrapper)
//   n_real  int32 [mb]              real slots of each block row (a row
//                                   with no real tile has 1, a zero pad)
//   bt8     int8  [nb·bn, kb·bk]    B transposed, k contiguous: mma.sync
//                                   and wgmma take 8-bit operands K-major
//                                   only (the hardware transpose is for
//                                   16-bit types)
//   mask    int32 [mb·bm, nb·bn]    structural mask (≠ 0 ⇒ keep)
//   active  int32 [n_slots, 2]      (i, j) of the output tiles whose mask
//                                   tile is non-empty, G entries a group
//   groups  int32 [n_groups, 2]     (first, count): active[first : first +
//                                   count] are up to G tiles of one block
//                                   row; groups with a tile are ordered by
//                                   their first tile-column, empty ones
//                                   (count 0) return at once
//   out     int32 [mb·bm, nb·bn]    zero-filled by the wrapper; the kernel
//                                   writes the active tiles
// Square output tiles, bn = bm; bm and bk multiples of 16, at most 128.
//
// Design. One block of 8 warps owns one group: G output tiles of the same
// block row (G = 8, 8, 4, 1 for bm up to 16, 32, 64, 128), so every A tile
// it loads serves G output tiles. It walks only the n_real(i) real slots
// of the row. Per slot, the A tile and the group's G B blocks (each bn
// rows of bk bytes of bt8) go into one stage of a 3-stage ring in shared
// memory by 16-byte cp.async, two slots ahead of the one being multiplied,
// with one barrier per slot. Rows are padded by 16 bytes, so the 32-bit
// fragment loads of a warp hit 32 distinct banks; where bk is not a
// multiple of 32 the k pad of the stage is zero (written once) and the
// mma's k of 32 reads zeros there. The warps tile the group's bm × G·bn
// output (2 × 4 warps at 64 × 256), each accumulating its part in int32
// registers with mma.sync.m16n8k32.s32.s8.s8. The epilogue applies the
// mask tile and ⟨∨,∧⟩'s threshold and writes int32 pairs. Groups are
// ordered by tile-column, so blocks running together read the same B
// column strips (2.2 MB of int8 each at 64 columns on cit-HP), which stay
// in L2. Offsets into the n² arrays are size_t (past 2³¹ above n ≈ 46k).
//
// Bound on the card: bytes. cit-HP's triangle count at 64 × 64 needs
// 3.26e12 MACs over its real slots (3.3 ms at the int8 rate) against
// 11.7 GB of operands read once and output written once (3.5 ms at
// 3.35 TB/s). What the kernel itself moves is more: the B block of every
// (output tile, real slot) pair, once per group (51 GB through L2 on
// cit-HP), and each group's row of real A tiles (13 GB). On an H100 SXM
// (700 W) it runs in ~19.6 ms there: ~3.3 TB/s through L2, the tensor
// cores at ~17% of their int8 rate. 62% of those B blocks are all zero on
// cit-HP, and this kernel does not skip them.

#include <cuda_runtime.h>

#include <cstdint>

namespace spgemm_binary {

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kRowPad = 16;    // bytes after each shared row
constexpr int kMaxBlock = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a · b over one 16 × 8 × 32 step: a is 16 rows × 32 k (row-major),
// b 32 k × 8 columns (column-major), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// BM is bm rounded up to 16, 32, 64 or 128; G tiles of BM columns per group.
template <int BM, int G>
struct Config {
  static constexpr int kWarpsM = BM == 16 ? 1 : (BM == 128 ? 4 : 2);
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kN = G * BM;                // output columns of a group
  static constexpr int kMF = BM / (16 * kWarpsM);  // m16 fragments per warp
  static constexpr int kNF = kN / (8 * kWarpsN);   // n8 fragments per warp
  static_assert(kMF >= 1 && kNF >= 1, "warp tiling");
};

template <int BM, int G>
__global__ void __launch_bounds__(kThreads, 2)
spgemm_binary_kernel(const int8_t* __restrict__ a8, const int* __restrict__ meta,
                     const int* __restrict__ n_real, const int8_t* __restrict__ bt8,
                     const int* __restrict__ mask, const int* __restrict__ active,
                     const int* __restrict__ groups, int* __restrict__ out, int t_slots,
                     int nb, int bm, int bk, int bk_pad, long long k_pad, int boolean) {
  using C = Config<BM, G>;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int tile_j[G];

  const int ld_s = bk_pad + kRowPad;  // bytes per shared row
  const int stage_bytes = (BM + C::kN) * ld_s;
  const int first = groups[2 * static_cast<size_t>(blockIdx.x)];
  const int count = groups[2 * static_cast<size_t>(blockIdx.x) + 1];
  if (count == 0) return;
  const int i = active[2 * static_cast<size_t>(first)];
  const int bn = bm;
  const int slots = n_real[i];
  const int chunks = bk / 16;  // 16-byte pieces of a row of A or of bt8
  const int* cols = meta + static_cast<size_t>(i) * (t_slots + nb);
  const int8_t* a_row = a8 + static_cast<size_t>(i) * t_slots * bm * bk;

  // Zero the ring once: the k pad past bk must read as 0. Rows past bm and
  // tiles past count are never loaded either; what they give is not stored.
  for (int e = threadIdx.x; e < kStages * stage_bytes / 16; e += kThreads) {
    reinterpret_cast<int4*>(smem)[e] = make_int4(0, 0, 0, 0);
  }
  if (threadIdx.x < count) {
    tile_j[threadIdx.x] = active[2 * (static_cast<size_t>(first) + threadIdx.x) + 1];
  }
  __syncthreads();

  // Each thread copies the 16-byte piece q of every rstep-th row, the same
  // rows of every slot: no index arithmetic per slot beyond the slot's
  // tile-column. cpad, the pieces per row rounded up to a power of two,
  // divides the 256 threads; threads with q past the row copy nothing.
  const int cshift = chunks <= 1 ? 0 : chunks <= 2 ? 1 : chunks <= 4 ? 2 : 3;
  const int q = threadIdx.x & ((1 << cshift) - 1);
  const int r0 = threadIdx.x >> cshift, rstep = kThreads >> cshift;
  auto load = [&](int t, int stage) {
    if (q >= chunks) return;
    int8_t* as = smem + stage * stage_bytes + 16 * q;
    int8_t* bs = as + BM * ld_s;
    const int8_t* a = a_row + static_cast<size_t>(t) * bm * bk + 16 * q;
    for (int r = r0; r < bm; r += rstep) cp_async16(as + r * ld_s, a + r * bk);
    const size_t k0 = static_cast<size_t>(cols[t]) * bk + 16 * q;
    for (int g = 0; g < count; ++g) {
      const int8_t* src = bt8 + static_cast<size_t>(tile_j[g]) * bn * k_pad + k0;
      int8_t* dst = bs + g * BM * ld_s;
      for (int c = r0; c < bn; c += rstep) cp_async16(dst + c * ld_s, src + c * k_pad);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp / C::kWarpsN) * C::kMF * 16;
  const int col0 = (warp % C::kWarpsN) * C::kNF * 8;
  const bool live = col0 / BM < count;  // the warp's first tile is in the group
  const int gid = lane >> 2, tig = lane & 3;
  int acc[C::kMF][C::kNF][4];
#pragma unroll
  for (int mf = 0; mf < C::kMF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < C::kNF; ++nf) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mf][nf][v] = 0;
    }
  }

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slots) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < slots; ++t) {
    cp_async_wait<kStages - 2>();  // slot t's copies by this thread have landed
    __syncthreads();               // ... and everyone's; slot t - 1 is done with
    const int next = t + kStages - 1;
    if (next < slots) load(next, next % kStages);
    cp_async_commit();
    if (!live) continue;
    const int8_t* as = smem + (t % kStages) * stage_bytes;
    const int8_t* bs = as + BM * ld_s;
    for (int kk = 0; kk < bk_pad; kk += 32) {
      unsigned af[C::kMF][4], bf[C::kNF][2];
#pragma unroll
      for (int mf = 0; mf < C::kMF; ++mf) {
        const int8_t* p = as + (row0 + mf * 16 + gid) * ld_s + kk + 4 * tig;
        af[mf][0] = lds32(p);
        af[mf][1] = lds32(p + 8 * ld_s);
        af[mf][2] = lds32(p + 16);
        af[mf][3] = lds32(p + 8 * ld_s + 16);
      }
#pragma unroll
      for (int nf = 0; nf < C::kNF; ++nf) {
        const int8_t* p = bs + (col0 + nf * 8 + gid) * ld_s + kk + 4 * tig;
        bf[nf][0] = lds32(p);
        bf[nf][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mf = 0; mf < C::kMF; ++mf) {
#pragma unroll
        for (int nf = 0; nf < C::kNF; ++nf) mma_s8(acc[mf][nf], af[mf], bf[nf]);
      }
    }
  }
  cp_async_wait<0>();

  const size_t ld = static_cast<size_t>(nb) * bn;
#pragma unroll
  for (int mf = 0; mf < C::kMF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < C::kNF; ++nf) {
      const int n = col0 + nf * 8 + 2 * tig;  // even; bn is a multiple of 16
      const int g = n / BM, c = n % BM;
      if (g >= count || c >= bn) continue;
      const size_t col = static_cast<size_t>(tile_j[g]) * bn + c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mf * 16 + gid + 8 * h;
        if (r >= bm) continue;
        const size_t off = (static_cast<size_t>(i) * bm + r) * ld + col;
        const int2 m = *reinterpret_cast<const int2*>(mask + off);
        int v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
        if (boolean) {
          v0 = v0 > 0;
          v1 = v1 > 0;
        }
        *reinterpret_cast<int2*>(out + off) = make_int2(m.x != 0 ? v0 : 0, m.y != 0 ? v1 : 0);
      }
    }
  }
}

// bt8 [n, k] = int8(b [k, n]) through a 64 × 64 tile in shared memory:
// 16-byte loads of b's rows, 16-byte stores of bt8's rows. k and n are
// multiples of 16, b and bt8 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
pack_bt_kernel(const int* __restrict__ b, int8_t* __restrict__ bt8, int k, int n) {
  __shared__ int8_t tile[64][64 + 4];
  const int n0 = blockIdx.x * 64;
  const int k0 = blockIdx.y * 64;
  for (int e = threadIdx.x; e < 64 * 16; e += kThreads) {
    const int r = e / 16, c = 4 * (e % 16);
    int4 v = make_int4(0, 0, 0, 0);
    if (k0 + r < k && n0 + c < n) {
      v = *reinterpret_cast<const int4*>(b + static_cast<size_t>(k0 + r) * n + n0 + c);
    }
    tile[r][c] = static_cast<int8_t>(v.x);
    tile[r][c + 1] = static_cast<int8_t>(v.y);
    tile[r][c + 2] = static_cast<int8_t>(v.z);
    tile[r][c + 3] = static_cast<int8_t>(v.w);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 4; e += kThreads) {
    const int c = e / 4, q = 16 * (e % 4);
    if (n0 + c < n && k0 + q < k) {
      union {
        int4 v;
        int8_t x[16];
      } u;
#pragma unroll
      for (int w = 0; w < 16; ++w) u.x[w] = tile[q + w][c];
      *reinterpret_cast<int4*>(bt8 + static_cast<size_t>(n0 + c) * k + k0 + q) = u.v;
    }
  }
}

template <int BM, int G>
int launch(const int8_t* a8, const int* meta, const int* n_real, const int8_t* bt8,
           const int* mask, const int* active, const int* groups, int* out, int n_groups,
           int t_slots, int nb, int kb, int bm, int bk, int boolean, cudaStream_t stream) {
  const int bk_pad = (bk + 31) / 32 * 32;
  const int smem = kStages * (BM + Config<BM, G>::kN) * (bk_pad + kRowPad);
  auto kernel = spgemm_binary_kernel<BM, G>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_groups, kThreads, smem, stream>>>(a8, meta, n_real, bt8, mask, active, groups, out,
                                               t_slots, nb, bm, bk, bk_pad,
                                               static_cast<long long>(kb) * bk, boolean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spgemm_binary

// Packs B (int32 [k, n], values in int8's range) into bt8 (int8 [n, k]) on
// the stream. Returns the launch's cudaError_t; k or n not a multiple of
// 16, or k past 64 · 65535, returns cudaErrorInvalidValue without launching.
extern "C" int spgemm_binary_pack_bt(const void* b, void* bt8, int k, int n, void* stream) {
  using namespace spgemm_binary;
  if (k < 16 || n < 16 || k % 16 || n % 16 || (k + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + 63) / 64, (k + 63) / 64);
  pack_bt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(b), static_cast<int8_t*>(bt8), k, n);
  return static_cast<int>(cudaGetLastError());
}

// Output tiles per group for a block of bm rows; the wrapper passes its own
// count, which must agree.
extern "C" int spgemm_binary_group_size(int bm) {
  return bm <= 32 ? 8 : (bm <= 64 ? 4 : 1);
}

// Returns the cudaError_t of the launch (0 = success). A block shape the
// kernel does not take, or a group size other than
// spgemm_binary_group_size(bm), returns cudaErrorInvalidValue without
// launching; n_groups = 0 launches nothing.
extern "C" int semiring_spgemm_binary(const void* a8, const void* meta, const void* n_real,
                                      const void* bt8, const void* mask, const void* active,
                                      const void* groups, void* out, int n_groups, int t_slots,
                                      int nb, int kb, int bm, int bk, int group_size,
                                      int boolean, void* stream) {
  using namespace spgemm_binary;
  if (bm < 16 || bm > kMaxBlock || bm % 16 || bk < 16 || bk > kMaxBlock || bk % 16 ||
      t_slots < 1 || nb < 1 || kb < 1 || n_groups < 0 ||
      group_size != spgemm_binary_group_size(bm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_groups == 0) return 0;
  const auto* a = static_cast<const int8_t*>(a8);
  const auto* m = static_cast<const int*>(meta);
  const auto* nr = static_cast<const int*>(n_real);
  const auto* bt = static_cast<const int8_t*>(bt8);
  const auto* mk = static_cast<const int*>(mask);
  const auto* act = static_cast<const int*>(active);
  const auto* grp = static_cast<const int*>(groups);
  auto* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 16) {
    return launch<16, 8>(a, m, nr, bt, mk, act, grp, o, n_groups, t_slots, nb, kb, bm, bk, boolean, s);
  }
  if (bm <= 32) {
    return launch<32, 8>(a, m, nr, bt, mk, act, grp, o, n_groups, t_slots, nb, kb, bm, bk, boolean, s);
  }
  if (bm <= 64) {
    return launch<64, 4>(a, m, nr, bt, mk, act, grp, o, n_groups, t_slots, nb, kb, bm, bk, boolean, s);
  }
  return launch<128, 1>(a, m, nr, bt, mk, act, grp, o, n_groups, t_slots, nb, kb, bm, bk, boolean, s);
}
