// Frontier-filtered semiring ELL-of-tiles SpMSpV for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spmspv_tiles.py:
// semiring_spmspv_padded (body _kernel). Block row i reads n_active_i,
// the slot permutation and the permuted tile-columns from
// meta [mb, 1 + 2T] (built by ops._spmspv_meta, active slots first) and
// ⊕-folds only its first n_active_i permuted slots, in permuted order.
// Device code: tile_fold.cuh.
//
// Bound on the card: bytes. It must read the active tiles once,
// Σ n_active · bm·bn·4 bytes, plus meta, x and y, at 3.35 TB/s.
//
// Left for later: every block row gets its blocks, even one with no
// active slot, so a sparse frontier on a tall matrix (8,499 block rows on
// r-TX) launches tens of thousands of blocks that only write the identity;
// block rows with many active slots set the tail; no cp.async/TMA
// pipeline; the meta is built by separate PyTorch ops on every call.

#include "tile_fold.cuh"

extern "C" int semiring_spmspv_padded(const void* tiles, const void* meta,
                                      const void* x, void* y, int mb, int t_slots,
                                      int bm, int bn, int sr_code, void* stream) {
  return tilefold::launch<tilefold::kActive>(tiles, meta, nullptr, x, y, mb, t_slots, bm, bn,
                                             sr_code, static_cast<cudaStream_t>(stream));
}
