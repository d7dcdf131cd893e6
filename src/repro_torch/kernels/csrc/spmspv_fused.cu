// Fused Load+Kernel frontier-filtered SpMSpV for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spmspv_tiles.py:
// semiring_spmspv_fused_padded (body _fused_kernel). It computes kernel 2's
// function on kernel 2's meta [mb, 1 + 2T] (n_active | slot permutation |
// permuted tile-columns): block row i ⊕-folds its first n_active_i
// permuted slots, in permuted order.
//
// On the TPU the fused kernel differs from the unfused one in its memory
// traffic: an inactive grid step of the unfused kernel re-reads a resident
// slot, the fused kernel issues no copy. On this card the unfused kernel
// (spmspv_tiles.cu) already issues no load for an inactive slot, so the
// two share one fold (tile_fold.cuh, layout kActive) and are the same
// memory behaviour; this entry point keeps the TPU kernel's interface,
// launch count and chunk-major output (a reshape in the wrapper).
//
// Bound on the card: bytes. Σ n_active · bm·bn·4 bytes of active tiles,
// plus meta, x and y, at 3.35 TB/s.
//
// Left for later: the cp.async/TMA two-stage pipeline (ROADMAP §2).

#include "tile_fold.cuh"

extern "C" int semiring_spmspv_fused_padded(const void* tiles, const void* meta,
                                            const void* x, void* y, int mb, int t_slots,
                                            int bm, int bn, int sr_code, void* stream) {
  return tilefold::launch<tilefold::kActive>(tiles, meta, nullptr, x, y, mb, t_slots, bm, bn,
                                             sr_code, static_cast<cudaStream_t>(stream));
}
