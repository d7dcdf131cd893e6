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
// semiring_spmspv_padded_batch is the same kernel over a block of B
// vectors, each with its own meta: meta [B, mb, 1 + 2T], x [B, nb·bn] ->
// y [B, mb·bm], one vector a block, the B blocks of a block row side by
// side (tile_fold_batch_kernel). It is what jax.vmap of the Pallas kernel
// computes in the JAX package's multi-source traversals; row b is
// bit-identical to kernel 2 on meta[b] and x[b]. Each row's active set
// differs, so no tile load is shared. Bound: every row's active tiles read
// once, Σ_b Σ n_active · bm·bn·4 bytes, plus the metas, x and y.
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

extern "C" int semiring_spmspv_padded_batch(const void* tiles, const void* meta,
                                            const void* x, void* y, int mb, int t_slots,
                                            int bm, int bn, int x_len, int batch, int sr_code,
                                            void* stream) {
  return tilefold::launch_batch<tilefold::kActive>(tiles, meta, x, y, mb, t_slots, bm, bn,
                                                   x_len, batch, 1, sr_code,
                                                   static_cast<cudaStream_t>(stream));
}
