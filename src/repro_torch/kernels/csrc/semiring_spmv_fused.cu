// Fused Load+Kernel semiring ELL-of-tiles SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/semiring_spmv.py:
// semiring_spmv_fused_padded (body _fused_kernel, stream _stream_row).
// Block row i reads n_real_i and its tile-columns from meta [mb, 1 + T]
// (ops._spmv_fused_meta: n_real | tile_cols) and ⊕-folds only its first
// n_real_i slots, in slot order. The builder stores a row's real tiles
// first, so the pad slots behind them are never read. Everything else is
// kernel 1's fold (tile_fold.cuh), so where pad ⊗ x is the ⊕-identity the
// result is bit-identical to semiring_spmv_padded. Where it is not (0 · inf
// under ⟨+,×⟩), the two differ exactly as the TPU kernels do: a row with
// no real tile still streams one pad slot (n_real = 1).
//
// Bound on the card: bytes. It must read the real tiles once,
// Σ n_real · bm·bn·4 bytes (3.86 GB for cit-HP at 128×128 against kernel
// 1's 4.71 GB), plus meta, x and y, at 3.35 TB/s.
//
// Left for later: the TPU kernel's point is its two-slot double buffer
// (tile t+1's copy is issued before tile t's fold). Here a warp keeps
// kUnroll tile-row loads in flight from registers; a cp.async/TMA
// two-stage pipeline into shared memory is the redesign (ROADMAP §2).
// The chunk-major output ([d, m/d]) has the flat output's memory order, so
// the wrapper reshapes and the kernel never sees it.

#include "tile_fold.cuh"

extern "C" int semiring_spmv_fused_padded(const void* tiles, const void* meta,
                                          const void* x, void* y, int mb, int t_slots,
                                          int bm, int bn, int sr_code, void* stream) {
  return tilefold::launch<tilefold::kReal>(tiles, meta, nullptr, x, y, mb, t_slots, bm, bn,
                                           sr_code, static_cast<cudaStream_t>(stream));
}
