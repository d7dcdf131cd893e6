// Fused semiring SpMV over sell-C-σ tiles for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/semiring_spmv.py:
// semiring_spmv_sell (body _sell_kernel). Tiles are flat
// [slot_total, bm, bn]; grid row i reads row_meta[i] = (out_block, base,
// n_real), ⊕-folds tiles[base : base + n_real] against the x blocks named
// by tile_cols[base + j], and writes output block out_block (the
// Retrieve-side row permutation; row_meta[:, 0] is a permutation, so each
// output block is written once). A row with n_real = 0 writes the
// ⊕-identity. A row's tiles are in increasing tile-column order, as in the
// ELL layout, so the result is bit-identical to semiring_spmv_padded where
// pad ⊗ x is the ⊕-identity. Device code: tile_fold.cuh.
//
// Offsets: a sell payload can hold more than 2^31 elements (graph500
// scale 18 at 128×128: 615,147 slots, 1.0e10 elements), so base · bm · bn
// is computed in size_t.
//
// Bound on the card: bytes. It must read the real tiles once,
// Σ n_real · bm·bn·4 bytes, plus tile_cols, row_meta, x and y, at
// 3.35 TB/s. The pad slots of a slice are stored but never read.
//
// Left for later: the cp.async/TMA two-stage pipeline of the TPU kernel's
// double buffer (ROADMAP §2); one grid row per block row whatever its
// length, so a hub row (1,190 tiles on graph500-scale18) sets the tail.

#include "tile_fold.cuh"

extern "C" int semiring_spmv_sell(const void* tiles, const void* tile_cols,
                                  const void* row_meta, const void* x, void* y, int mb,
                                  int slot_total, int bm, int bn, int sr_code,
                                  void* stream) {
  return tilefold::launch<tilefold::kSell>(tiles, tile_cols, row_meta, x, y, mb, slot_total,
                                           bm, bn, sr_code, static_cast<cudaStream_t>(stream));
}
