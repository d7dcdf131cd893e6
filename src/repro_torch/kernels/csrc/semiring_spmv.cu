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
// semiring_spmv_padded_batch is the same function over a block of B
// vectors, x [B, nb·bn] -> y [B, mb·bm]: what the JAX package runs as
// jax.vmap of the Pallas kernel in its multi-source traversals
// (graphs/engine.py's batched closures). Row b is bit-identical to kernel
// 1 on x[b]. tile_fold_block_kernel: a CTA per (block row, 64 tile rows,
// group of 32 vectors) stages each slot's tile rows and x slice in shared
// memory through a cp.async ring and folds them from there, each thread a
// 2 x 8 (row, vector) register micro-tile, replaying kernel 1's butterfly
// tree per output; for B <= 32 the tiles cross HBM -> SM once a launch.
// Bound: the tiles read once (4.71 GB on cit-HP, 1.41 ms) against
// 2·B·T·mb·bm·bn operations (B = 32: 7.5e10 fp32 operations, 1.12 ms; the
// integer semirings at the int32 rate, 4.5 ms), and every vector's x read
// and y written once. The float semirings add 31 ⊕ a (row, vector, slot)
// for the tree, a quarter more operations at bn = 128.
//
// Left for later: kernel 1's grid is fixed by the matrix (mb × bm/16
// blocks, 2,160 on cit-HP), so the last wave of blocks can leave SMs idle,
// and its tile rows are read with plain vector loads, with no cp.async/TMA
// pipeline into shared memory; both kernels read pad slots although they
// are known identities.

#include "tile_fold.cuh"

extern "C" int semiring_spmv_padded(const void* tiles, const void* tile_cols,
                                    const void* x, void* y, int mb, int t_slots,
                                    int bm, int bn, int sr_code, void* stream) {
  return tilefold::launch<tilefold::kEll>(tiles, tile_cols, nullptr, x, y, mb, t_slots, bm, bn,
                                          sr_code, static_cast<cudaStream_t>(stream));
}

extern "C" int semiring_spmv_padded_batch(const void* tiles, const void* tile_cols,
                                          const void* x, void* y, int mb, int t_slots,
                                          int bm, int bn, int x_len, int batch, int sr_code,
                                          void* stream) {
  return tilefold::launch_block<tilefold::kEll>(tiles, tile_cols, x, y, mb, t_slots, bm, bn,
                                                x_len, batch, sr_code,
                                                static_cast<cudaStream_t>(stream));
}
