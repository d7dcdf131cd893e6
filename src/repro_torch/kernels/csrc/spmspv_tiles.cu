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
// semiring_spmspv_padded_batch is the same function over a block of B
// vectors, each with its own active slots: what jax.vmap of the Pallas
// kernel computes in the JAX package's multi-source traversals. Row b is
// bit-identical to kernel 2 on meta[b] and x[b]. Its index is not the
// metas but their union per group of 32 vectors, int32 [G, mb, 1 + 3T] =
// n_union | union slots | tile-columns | masks, built on the card by
// ops._spmspv_union_batch: tile_fold_block_kernel (kUnion) stages each
// union slot's tile rows and x slice once for the group, and each vector
// folds the slots whose mask bit it has, in slot order, which is its own
// meta's order. A block row whose union is empty writes the identity and
// returns. Bound: the tiles that some row needs, read once, against every
// row's active slots at 2·bm·bn operations each, plus the metas, x and y.
//
// Left for later: a warp folds all its 8 vectors for a union slot that any
// of them needs (rows of a sparse frontier pay for the dense ones), and
// every block row still gets its CTAs (8,499 on r-TX at B <= 32, most
// returning at once).

#include "tile_fold.cuh"

extern "C" int semiring_spmspv_padded(const void* tiles, const void* meta,
                                      const void* x, void* y, int mb, int t_slots,
                                      int bm, int bn, int sr_code, void* stream) {
  return tilefold::launch<tilefold::kActive>(tiles, meta, nullptr, x, y, mb, t_slots, bm, bn,
                                             sr_code, static_cast<cudaStream_t>(stream));
}

extern "C" int semiring_spmspv_padded_batch(const void* tiles, const void* union_meta,
                                            const void* x, void* y, int mb, int t_slots,
                                            int bm, int bn, int x_len, int batch, int sr_code,
                                            void* stream) {
  return tilefold::launch_block<tilefold::kUnion>(tiles, union_meta, x, y, mb, t_slots, bm, bn,
                                                  x_len, batch, sr_code,
                                                  static_cast<cudaStream_t>(stream));
}
