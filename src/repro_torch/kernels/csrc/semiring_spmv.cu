// Semiring ELL-of-tiles SpMV for Hopper (sm_90a): y = A ⊕.⊗ x.
//
// Replaces the TPU kernel repro/kernels/semiring_spmv.py:
// semiring_spmv_padded (body _kernel). Like it, it ⊕-folds ALL T slots of
// every block row, pad tiles included (a pad is a ⊕-identity tile, but
// 0 · inf = NaN under ⟨+,×⟩ and ⟨min,×⟩, so skipping pads is a different
// function; that is the fused kernel's job). Device code: tile_fold.cuh.
//
// Bound on the card: bytes. It must read every tile once,
// T·mb·bm·bn·4 bytes (4.7 GB for cit-HP at 128×128 tiles), against
// 2·T·mb·bm·bn operations: at 3.35 TB/s and 67 TFLOP/s fp32 the bytes
// take ~40x longer than the arithmetic (1.41 ms vs 0.035 ms on cit-HP).
//
// semiring_spmv_padded_batch is the same kernel over a block of B vectors,
// x [B, nb·bn] -> y [B, mb·bm]: what the JAX package runs as jax.vmap of
// the Pallas kernel in its multi-source traversals (graphs/engine.py's
// batched closures). Row b is bit-identical to kernel 1 on x[b]. A warp
// loads each 16-byte chunk of a tile row once and folds it against a group
// of nb vectors (tile_fold_batch_kernel), so the tiles stream ceil(B / nb)
// times instead of B; the groups of one block row run side by side and
// share its tile rows in L2. Bound: the tiles read once (4.71 GB on cit-HP,
// 1.41 ms) against 2·B·T·mb·bm·bn operations (B = 32: 7.5e10 fp32
// operations, 1.12 ms; the integer semirings at the int32 rate, 4.5 ms),
// and every vector's x read and y written once.
//
// Left for later: the grid is fixed by the matrix (mb × bm/16 blocks, 2,160
// on cit-HP), so the last wave of blocks can leave SMs idle; the tile rows
// are read with plain vector loads, with no cp.async/TMA pipeline into
// shared memory; pad slots are read although they are known identities.

#include "tile_fold.cuh"

extern "C" int semiring_spmv_padded(const void* tiles, const void* tile_cols,
                                    const void* x, void* y, int mb, int t_slots,
                                    int bm, int bn, int sr_code, void* stream) {
  return tilefold::launch<tilefold::kEll>(tiles, tile_cols, nullptr, x, y, mb, t_slots, bm, bn,
                                          sr_code, static_cast<cudaStream_t>(stream));
}

extern "C" int semiring_spmv_padded_batch(const void* tiles, const void* tile_cols,
                                          const void* x, void* y, int mb, int t_slots,
                                          int bm, int bn, int x_len, int batch, int nb,
                                          int sr_code, void* stream) {
  return tilefold::launch_batch<tilefold::kEll>(tiles, tile_cols, x, y, mb, t_slots, bm, bn,
                                                x_len, batch, nb, sr_code,
                                                static_cast<cudaStream_t>(stream));
}
