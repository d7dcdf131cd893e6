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
