// MoE dispatch gather for Hopper (sm_90a): out[s] = x[slot_tok[s]], a zero
// row where slot_tok[s] is not a token index (the pad, T).
//
// Replaces the TPU kernel repro/kernels/moe_dispatch.py:
// moe_dispatch_gather (body _kernel). There the slot→token map is scalar
// prefetched so that the grid (S, D/block_d) DMAs only the routed rows
// HBM→VMEM, one row block per step. Here the grid has no order to exploit
// and nothing to stage: the kernel is a row copy, bound by the bytes it
// moves, each valid row read once and every output row written once:
// (n_valid + S)·D·esize + 4·S bytes at 3.35 TB/s.
//
// Layout (as the TPU kernel's):
//   x        [T, D]  bf16 or f32 (esize 2 or 4 bytes), row-major
//   slot_tok int32 [S]  source token of each expert-capacity slot
//   out      [S, D]  written whole by the kernel
//
// Design: one warp owns one slot row. Its lanes read the slot's index (one
// broadcast load), then copy the row with 16-byte vector loads and stores,
// neighbouring lanes on neighbouring addresses; a pad row stores zeros and
// reads nothing. The copy moves raw bytes, so bf16 and f32 rows are copied
// exactly by the same code. Where a row's byte count or a base pointer is
// not 16-byte aligned, the row is copied one element at a time instead.
// An index outside [0, T) is a pad, so no index can read outside x. All
// offsets are size_t; no shared memory, no atomics, nothing shared between
// warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace moe_dispatch {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__global__ void __launch_bounds__(kThreads)
gather_rows_vec16(const uint4* __restrict__ x, const int* __restrict__ slot_tok,
                  uint4* __restrict__ out, int n_tokens, long long n_slots,
                  size_t row_vecs) {
  const long long slot = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (slot >= n_slots) return;
  const int lane = threadIdx.x % 32;
  const int tok = __ldg(slot_tok + slot);
  uint4* dst = out + static_cast<size_t>(slot) * row_vecs;
  if (tok >= 0 && tok < n_tokens) {
    const uint4* src = x + static_cast<size_t>(tok) * row_vecs;
    for (size_t i = lane; i < row_vecs; i += 32) dst[i] = __ldg(src + i);
  } else {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (size_t i = lane; i < row_vecs; i += 32) dst[i] = zero;
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_scalar(const U* __restrict__ x, const int* __restrict__ slot_tok,
                   U* __restrict__ out, int n_tokens, long long n_slots, size_t row_elems) {
  const long long slot = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (slot >= n_slots) return;
  const int lane = threadIdx.x % 32;
  const int tok = __ldg(slot_tok + slot);
  U* dst = out + static_cast<size_t>(slot) * row_elems;
  if (tok >= 0 && tok < n_tokens) {
    const U* src = x + static_cast<size_t>(tok) * row_elems;
    for (size_t i = lane; i < row_elems; i += 32) dst[i] = src[i];
  } else {
    for (size_t i = lane; i < row_elems; i += 32) dst[i] = U(0);
  }
}

}  // namespace moe_dispatch

// Returns the cudaError_t of the launch (0 = success). An element size
// other than 2 or 4 bytes (bf16, f32) returns cudaErrorInvalidValue
// without launching; n_slots = 0 or d = 0 launches nothing.
extern "C" int moe_dispatch_gather(const void* x, const void* slot_tok, void* out,
                                   int n_tokens, long long n_slots, long long d, int esize,
                                   void* stream) {
  using namespace moe_dispatch;
  if (n_slots < 0 || d < 0 || !(esize == 2 || esize == 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_slots == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const size_t row_bytes = static_cast<size_t>(d) * static_cast<size_t>(esize);
  const int* tok = static_cast<const int*>(slot_tok);
  const bool aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    gather_rows_vec16<<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(x), tok,
                                                 static_cast<uint4*>(out), n_tokens, n_slots,
                                                 row_bytes / 16);
  } else if (esize == 2) {
    gather_rows_scalar<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), tok, static_cast<uint16_t*>(out), n_tokens, n_slots,
        static_cast<size_t>(d));
  } else {
    gather_rows_scalar<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), tok, static_cast<uint32_t*>(out), n_tokens, n_slots,
        static_cast<size_t>(d));
  }
  return static_cast<int>(cudaGetLastError());
}
