// MoE dispatch gather for Hopper (sm_90a): out[s] = x[slot_tok[s]], a zero
// row where slot_tok[s] is not a token index (the pad, T).
//
// Replaces the TPU kernel repro/kernels/moe_dispatch.py:
// moe_dispatch_gather (body _kernel). There the slot→token map is scalar
// prefetched so that the grid (S, D/block_d) DMAs only the routed rows
// HBM→VMEM, one row block per step. Here the kernel is a row copy, bound
// by the bytes it moves: each routed token row read once, every output
// row written once, (rows read + S)·D·esize + 4·S bytes at 3.35 TB/s.
//
// Layout (as the TPU kernel's):
//   x        [T, D]  bf16 or f32 (esize 2 or 4 bytes), row-major
//   slot_tok int32 [S]  source token of each expert-capacity slot
//   out      [S, D]  written whole by the kernel
//
// Two paths copy 16-byte vectors of raw bytes, so bf16 and f32 rows are
// copied exactly by the same code; both store with the evict-first hint
// (st.global.cs), so the output streams past L2 and leaves x there.
//
// The flat path (any plan): the output is one flat array of 16-byte
// vectors, cut into runs of kThreads·V vectors, one run to a CTA, as the
// TPU grid cuts each row into blocks. A thread reads its V slot indices,
// issues its V row loads (a pad loads nothing), then its V stores: one
// round trip of latency a thread, and enough CTAs to cover the SMs (V
// halves while the grid is smaller than the SM count). Index arithmetic
// is 32-bit where the output allows it.
//
// The window path (plans that models/moe.py::dispatch_plan builds, given
// the hint group = C, experts = E): the buffer is expert-major, slot
// (b, e, p) = b·E·C + e·C + p, and each group of C slots holds its kept
// tokens ascending with the pads (T) at the tail. A token routed to k
// experts is then read by k far-apart slots; when x outgrows L2 the flat
// path reads it k times from HBM. Here a CTA owns a window of kWindow
// tokens of one batch row and a chunk of kChunk vectors of D: it stages
// the window's rows in shared memory (cp.async, one read each), finds in
// each group the slot range of its window's tokens and the start of the
// tail past the batch row's tokens (a search by a subgroup of lanes),
// and writes every slot of its range and of its equal share of the tail,
// so the pads are spread over all CTAs. The ranges partition every group
// for any slot_tok, sorted or not (the search's result is monotone in
// its key), and each slot is written by the same rule: a token of the
// CTA's window from shared memory, another token from x, a pad as zeros.
// So the result does not depend on the plan being sorted; only the bytes
// read do. Where x holds less than 40% of L2, the flat path's repeated
// reads hit L2 and it is as fast or faster (with 64 experts, at 32% of
// L2, by 15%), so it runs there.
//
// Rows or pointers that are not 16-byte aligned take an element-wise
// path, one warp a slot row. An index outside [0, T) is a pad, so no
// index can read outside x. Offsets are 64-bit (32-bit on the flat path
// where they fit); no atomics.
//
// The second entry, moe_dispatch_gather_backward (kernel 7ᵀ), is the
// gather's transpose, the gradient of x:
//   grad_x[r] = Σ_j grad_out[tok_slots[r, j]] over the j with a slot in [0, S)
// tok_slots int32 [T, k] holds each token's slots in ascending expert
// order, S for a dropped assignment. The reference has no kernel for it:
// XLA derives it from the gather (repro/models/moe.py, the take and the
// .at[].add of moe_sparse). Each kept slot names one token, so the sum is
// a gather, not a scatter: one warp owns a token row and writes it once,
// with no atomics. A lane takes 16-byte vectors of D, keeps up to
// kBackSlots slot rows' loads in flight, then adds them in ascending j in
// fp32 (from zero, each add rounded to nearest) and rounds once to the
// row's type, the order and rounding of the plain version, so the two
// agree bit for bit and a rerun gives the same bits. It is bound by
// bytes: the kept slot rows read once, grad_x written once, the index
// read once.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Compile-time choices swept by tools/moe_dispatch_sweep.py on an H100,
// each set to the best of its variants (PERF.md).
#ifndef MOE_THREADS
#define MOE_THREADS 128  // threads a CTA on the flat path
#endif
#ifndef MOE_VECS
#define MOE_VECS 2  // 16-byte loads in flight a thread on the flat path (1, 2, 4 or 8)
#endif
#ifndef MOE_WINDOW
#define MOE_WINDOW 4  // tokens a window CTA stages
#endif
#ifndef MOE_X_L2_PCT
#define MOE_X_L2_PCT 40  // the window path needs x to hold this share of L2 (%)
#endif

namespace moe_dispatch {

constexpr int kThreads = MOE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = MOE_VECS;
constexpr int kWinThreads = 128;  // threads a CTA on the window path
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kWindow = MOE_WINDOW;
constexpr int kChunk = 384;       // 16-byte vectors of each staged row (a chunk of D)
constexpr int kSearchLanes = 16;  // at most this many lanes search a group
// a batch row shorter than four windows (decode) takes the flat path
constexpr int kMinRowTokens = 4 * kWindow;
constexpr size_t kStageBytes = sizeof(uint4) * kWindow * kChunk;
// the window kernel's static shared memory: 6 int arrays, the warp totals, one int
constexpr size_t kWinStaticBytes = sizeof(int) * (6 * kWinThreads + kWinWarps + 1);
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, at most 1024 threads");
static_assert(kVecs == 1 || kVecs == 2 || kVecs == 4 || kVecs == 8, "V is 1, 2, 4 or 8");

// path codes the C entry reports
enum Path : int { kNone = 0, kElementwise = 1, kFlat = 2, kWindowPath = 3 };

__device__ __forceinline__ bool is_token(int tok, int n_tokens) {
  return tok >= 0 && tok < n_tokens;
}

// ------------------------------------------------------------- flat path

template <int V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_flat(const uint4* __restrict__ x, const int* __restrict__ slot_tok,
            uint4* __restrict__ out, int n_tokens, I n_slots, I row_vecs, I step_rows,
            I step_cols) {
  // vector j of this thread: kThreads·j past its first, row and column
  // advanced by (step_rows, step_cols) = divmod(kThreads, row_vecs)
  const I first = static_cast<I>(blockIdx.x) * (kThreads * V) + threadIdx.x;
  I r = first / row_vecs;
  I c = first - r * row_vecs;
  I row[V], col[V];
  int tok[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    row[j] = r;
    col[j] = c;
    c += step_cols;
    r += step_rows;
    if (c >= row_vecs) {
      c -= row_vecs;
      ++r;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) tok[j] = row[j] < n_slots ? __ldg(slot_tok + row[j]) : -1;
  uint4 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (is_token(tok[j], n_tokens)) v[j] = __ldg(x + static_cast<I>(tok[j]) * row_vecs + col[j]);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (row[j] < n_slots) __stcs(out + row[j] * row_vecs + col[j], v[j]);
  }
}

// ----------------------------------------------------------- window path

struct WindowPlan {
  const uint4* x;
  const int* slot_tok;
  uint4* out;
  long long row_vecs;  // 16-byte vectors of a row
  int n_tokens;        // T = batch · row_tokens
  int group;           // C, slots of an expert group
  int experts;         // E ≤ kWinThreads
  int row_tokens;      // tokens of a batch row
  int windows;         // CTAs of a batch row (and chunk)
  int chunks;          // chunks of kChunk vectors in a row
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Probe i of the interval [f, f + n) cut into lanes + 1 parts (n > lanes):
// strictly increasing in i, all inside the interval.
__device__ __forceinline__ int probe(int f, int n, int lanes, int i) {
  return f + static_cast<int>(static_cast<long long>(i + 1) * n / (lanes + 1));
}

// One step of the search on [f, f + n) after `below` of its probes fell
// below the key: the interval between the last probe below and the next.
__device__ __forceinline__ void narrow(int& f, int& n, int lanes, int below) {
  const int lo = below == 0 ? f : probe(f, n, lanes, below - 1) + 1;
  const int hi = below == lanes ? f + n : probe(f, n, lanes, below);
  f = lo;
  n = hi - lo;
}

// The lanes of a subgroup (`lanes` a power of two ≤ 32, aligned in its
// warp) search a[0, n) for K keys together. Each step every lane probes
// one entry a key, and the count of probes below the key (a ballot) picks
// the next interval, cutting it (lanes + 1)-fold; the last step probes
// every entry left. For a sorted array the result is the first index
// whose entry is >= the key; for any array it is monotone in the key,
// which is all the partition of the slots needs. Every lane of the warp
// calls it; lanes with `active` false search nothing.
template <int K>
__device__ __forceinline__ void subgroup_search(const int* __restrict__ a, int n,
                                                const int (&key)[K], int lanes, bool active,
                                                int (&at)[K]) {
  const int lane = threadIdx.x % 32;
  const int sub = lane & (lanes - 1);
  const int first = lane - sub;
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  int f[K], m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    f[k] = 0;
    m[k] = active ? n : 0;
  }
  for (;;) {
    bool more = false;
#pragma unroll
    for (int k = 0; k < K; ++k) more |= m[k] > lanes;
    if (!__any_sync(0xffffffffu, more)) break;
    bool below[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      below[k] = m[k] > lanes && __ldg(a + probe(f[k], m[k], lanes, sub)) < key[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = __popc((__ballot_sync(0xffffffffu, below[k]) >> first) & mask);
      if (m[k] > lanes) narrow(f[k], m[k], lanes, c);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool e = sub < m[k] && __ldg(a + f[k] + sub) < key[k];
    at[k] = f[k] + __popc((__ballot_sync(0xffffffffu, e) >> first) & mask);
  }
}

// inclusive prefix sum of v over a window CTA
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWinWarps ? warp_total[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += n;
    }
    if (lane < kWinWarps) warp_total[lane] = t;
  }
  __syncthreads();
  return warp > 0 ? v + warp_total[warp - 1] : v;
}

__global__ void __launch_bounds__(kWinThreads) gather_windows(const WindowPlan p) {
  extern __shared__ uint4 stage[];  // [kWindow][kChunk]: the window's rows, this chunk
  __shared__ int own_lo[kWinThreads];    // a group's range of the window's tokens
  __shared__ int own_len[kWinThreads];
  __shared__ int tail_lo[kWinThreads];   // its share of the group's tail
  __shared__ int slots_end[kWinThreads];  // inclusive prefix of the groups' slot counts
  __shared__ int warp_total[kWinWarps];
  __shared__ int total_slots;
  __shared__ int list_slot[kWinThreads];  // slot within the batch row's E·C
  __shared__ int list_tok[kWinThreads];

  const int chunk = blockIdx.x % p.chunks;
  const int unit = blockIdx.x / p.chunks;
  const int b = unit / p.windows, u = unit % p.windows;
  const long long c0 = static_cast<long long>(chunk) * kChunk;
  const int ncol = static_cast<int>(min(static_cast<long long>(kChunk), p.row_vecs - c0));
  const int row_first = b * p.row_tokens;
  const int row_end = row_first + p.row_tokens;
  // this CTA's own tokens [key_lo, key_hi): staged and served from shared memory
  const int key_lo = row_first + u * kWindow;
  const int key_hi = min(key_lo + kWindow, row_end);
  for (int t = 0; t < key_hi - key_lo; ++t) {
    const uint4* src = p.x + (key_lo + t) * p.row_vecs + c0;
    for (int col = threadIdx.x; col < ncol; col += kWinThreads) {
      cp_async16(stage + t * kChunk + col, src + col);
    }
  }

  // each group's ranges for this CTA, found while the rows arrive: a
  // subgroup of `lanes` threads a group, as many as E groups leave
  const int* row_slots = p.slot_tok + static_cast<long long>(b) * p.experts * p.group;
  int lanes = kSearchLanes;
  while (lanes > 1 && lanes * p.experts > kWinThreads) lanes >>= 1;
  const int g_own = threadIdx.x / lanes;
  const bool active = g_own < p.experts;
  const int keys[3] = {key_lo, key_hi, row_end};
  int at[3];
  subgroup_search<3>(row_slots + static_cast<long long>(active ? g_own : 0) * p.group, p.group,
                     keys, lanes, active, at);
  // [at 0, at 1) the window's slots (from 0 for the first window); the
  // tail [at 2, C) cut into equal shares, one a window
  const int lo = u == 0 ? 0 : at[0];
  const long long tail = p.group - at[2];
  const int t_lo = at[2] + static_cast<int>(tail * u / p.windows);
  const int t_hi = at[2] + static_cast<int>(tail * (u + 1) / p.windows);
  const bool owner = active && threadIdx.x % lanes == 0;
  const int n_own = max(at[1] - lo, 0), n_tail = t_hi - t_lo;
  const int end = block_inclusive_scan(owner ? n_own + n_tail : 0, warp_total);
  if (owner) {
    own_lo[g_own] = lo;
    own_len[g_own] = n_own;
    tail_lo[g_own] = t_lo;
    slots_end[g_own] = end;
  }
  if (threadIdx.x == kWinThreads - 1) total_slots = end;
  cp_async_wait_all();
  __syncthreads();
  const int total = total_slots;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint4* out_row = p.out + static_cast<long long>(b) * p.experts * p.group * p.row_vecs + c0;

  for (int base = 0; base < total; base += kWinThreads) {
    const int q = base + threadIdx.x;
    if (q < total) {
      // the group of list entry q: first g with slots_end[g] > q
      int g = 0, n = p.experts;
      while (n > 0) {
        const int h = n >> 1;
        if (slots_end[g + h] <= q) {
          g += h + 1;
          n -= h + 1;
        } else {
          n = h;
        }
      }
      const int o = q - (g == 0 ? 0 : slots_end[g - 1]);
      const int in_group = o < own_len[g] ? own_lo[g] + o : tail_lo[g] + (o - own_len[g]);
      const int slot = g * p.group + in_group;
      list_slot[threadIdx.x] = slot;
      list_tok[threadIdx.x] = __ldg(row_slots + slot);
    }
    __syncthreads();
    const int m = min(kWinThreads, total - base);
    for (int e = warp; e < m; e += kWinWarps) {
      const int tok = list_tok[e];
      uint4* dst = out_row + static_cast<long long>(list_slot[e]) * p.row_vecs;
      if (tok >= key_lo && tok < key_hi) {
        const uint4* src = stage + (tok - key_lo) * kChunk;
#pragma unroll 4
        for (int col = lane; col < ncol; col += 32) __stcs(dst + col, src[col]);
      } else if (is_token(tok, p.n_tokens)) {
        const uint4* src = p.x + tok * p.row_vecs + c0;
#pragma unroll 4
        for (int col = lane; col < ncol; col += 32) __stcs(dst + col, __ldg(src + col));
      } else {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
        for (int col = lane; col < ncol; col += 32) __stcs(dst + col, zero);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------- unaligned path

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_scalar(const U* __restrict__ x, const int* __restrict__ slot_tok,
                   U* __restrict__ out, int n_tokens, long long n_slots, long long row_elems) {
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (slot >= n_slots) return;
  const int lane = threadIdx.x % 32;
  const int tok = __ldg(slot_tok + slot);
  U* dst = out + slot * row_elems;
  if (is_token(tok, n_tokens)) {
    const U* src = x + tok * row_elems;
    for (long long i = lane; i < row_elems; i += 32) dst[i] = src[i];
  } else {
    for (long long i = lane; i < row_elems; i += 32) dst[i] = U(0);
  }
}

// an attribute of the current device (fallback where the query fails)
int device_attribute(cudaDeviceAttr attr, int fallback) {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, attr, dev) != cudaSuccess) {
    return fallback;
  }
  return n;
}

template <int V, typename I>
void launch_flat_as(const uint4* x, const int* tok, uint4* out, int n_tokens, I n_slots,
                    I row_vecs, unsigned blocks, cudaStream_t s) {
  gather_flat<V, I><<<blocks, kThreads, 0, s>>>(x, tok, out, n_tokens, n_slots, row_vecs,
                                                 kThreads / row_vecs, kThreads % row_vecs);
}

// V = the largest of kVecs, kVecs/2, ..., 1 whose grid still covers the
// SMs (1 where none does): small decode plans keep every SM busy
template <int V>
int launch_flat(const uint4* x, const int* tok, uint4* out, int n_tokens, long long n_slots,
                long long row_vecs, int sms, cudaStream_t s) {
  const long long total = n_slots * row_vecs;
  const long long blocks = (total + kThreads * V - 1) / (kThreads * V);
  if constexpr (V > 1) {
    if (blocks < sms) return launch_flat<V / 2>(x, tok, out, n_tokens, n_slots, row_vecs, sms, s);
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  // 32-bit offsets where every vector of the output (and of x) has one
  const long long reach = blocks * kThreads * V + kThreads * V;
  if (reach <= INT_MAX && static_cast<long long>(n_tokens) * row_vecs <= INT_MAX) {
    launch_flat_as<V, int>(x, tok, out, n_tokens, static_cast<int>(n_slots),
                           static_cast<int>(row_vecs), grid, s);
  } else {
    launch_flat_as<V, long long>(x, tok, out, n_tokens, n_slots, row_vecs, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// A window CTA's shared memory past 48 KB needs an opt-in, once for each
// device; a stage that fits (the default build) needs none.
template <bool kLarge>
int opt_in_stage() {
  return 0;
}

template <>
int opt_in_stage<true>() {
  static bool opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(gather_windows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStageBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  return 0;
}

int launch_windows(const WindowPlan& p, int batch, cudaStream_t s) {
  const int err = opt_in_stage<(kStageBytes + kWinStaticBytes > 48 * 1024)>();
  if (err) return err;
  const long long blocks = static_cast<long long>(batch) * p.windows * p.chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_windows<<<static_cast<unsigned>(blocks), kWinThreads, kStageBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* slot_tok, void* out, int n_tokens, long long n_slots,
             long long d, int esize, int group, int experts, cudaStream_t s, int* path) {
  *path = kNone;
  if (n_slots < 0 || d < 0 || n_tokens < 0 || !(esize == 2 || esize == 4) || group < 0 ||
      experts < 0 || (group == 0) != (experts == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long batch = 0;
  if (group > 0) {
    const long long per_row = static_cast<long long>(group) * experts;
    batch = n_slots / per_row;
    if (n_slots % per_row != 0 || (batch == 0 ? n_tokens != 0 : n_tokens % batch != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n_slots == 0 || d == 0) return 0;
  const long long row_bytes = d * esize;
  const int* tok = static_cast<const int*>(slot_tok);
  const bool aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!aligned) {
    const long long blocks = (n_slots + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    *path = kElementwise;
    if (esize == 2) {
      gather_rows_scalar<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), tok, static_cast<uint16_t*>(out), n_tokens, n_slots,
          d);
    } else {
      gather_rows_scalar<uint32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const uint32_t*>(x), tok, static_cast<uint32_t*>(out), n_tokens, n_slots,
          d);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long row_vecs = row_bytes / 16;
  const auto* xv = static_cast<const uint4*>(x);
  auto* ov = static_cast<uint4*>(out);
  const int row_tokens = batch > 0 ? static_cast<int>(n_tokens / batch) : 0;
  // x that L2 holds already serves the flat path's repeated reads of a
  // token; the window path pays for its searches only where it does not
  static const long long l2_bytes = device_attribute(cudaDevAttrL2CacheSize, 50 << 20);
  static const int sms = device_attribute(cudaDevAttrMultiProcessorCount, 132);
  if (group == 0 || experts > kWinThreads || row_tokens < kMinRowTokens ||
      static_cast<long long>(group) * experts > INT_MAX ||
      n_tokens * row_bytes * 100 < l2_bytes * MOE_X_L2_PCT) {
    *path = kFlat;
    return launch_flat<kVecs>(xv, tok, ov, n_tokens, n_slots, row_vecs, sms, s);
  }
  WindowPlan p;
  p.x = xv;
  p.slot_tok = tok;
  p.out = ov;
  p.row_vecs = row_vecs;
  p.n_tokens = n_tokens;
  p.group = group;
  p.experts = experts;
  p.row_tokens = row_tokens;
  p.windows = (row_tokens + kWindow - 1) / kWindow;
  p.chunks = static_cast<int>((row_vecs + kChunk - 1) / kChunk);
  *path = kWindowPath;
  return launch_windows(p, static_cast<int>(batch), s);
}

// ------------------------------------------------ transpose (kernel 7ᵀ)

constexpr int kBackThreads = 256;  // 8 warps, one token row each
constexpr int kBackWarps = kBackThreads / 32;
constexpr int kBackSlots = 8;      // slot rows in flight a lane: k ≤ 8 in one pass

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// acc[i] += element i of a 16-byte vector (8 bf16 or 4 f32), in order
template <bool kBf16>
__device__ __forceinline__ void add_vec(float* acc, const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      acc[2 * i] = __fadd_rn(acc[2 * i], bf16_bits_to_float(w[i] & 0xffffu));
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], bf16_bits_to_float(w[i] >> 16));
    } else {
      acc[i] = __fadd_rn(acc[i], __uint_as_float(w[i]));
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ uint4 pack_vec(const float* acc) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      w[i] = float_to_bf16_bits(acc[2 * i]) | (float_to_bf16_bits(acc[2 * i + 1]) << 16);
    } else {
      w[i] = __float_as_uint(acc[i]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kBf16>
__global__ void __launch_bounds__(kBackThreads)
gather_back(const uint4* __restrict__ grad_out, const int* __restrict__ tok_slots,
            uint4* __restrict__ grad_x, int n_tokens, int k, long long n_slots,
            long long row_vecs) {
  constexpr int kPer = kBf16 ? 8 : 4;
  const long long r = static_cast<long long>(blockIdx.x) * kBackWarps + threadIdx.x / 32;
  if (r >= n_tokens) return;
  const int lane = threadIdx.x % 32;
  const int* slots = tok_slots + r * k;
  for (long long c = lane; c < row_vecs; c += 32) {
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
    for (int j0 = 0; j0 < k; j0 += kBackSlots) {
      uint4 v[kBackSlots];
      bool live[kBackSlots];
#pragma unroll
      for (int j = 0; j < kBackSlots; ++j) {
        const int slot = j0 + j < k ? __ldg(slots + j0 + j) : -1;
        live[j] = slot >= 0 && slot < n_slots;
        v[j] = live[j] ? __ldg(grad_out + static_cast<long long>(slot) * row_vecs + c)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kBackSlots; ++j) {
        if (live[j]) add_vec<kBf16>(acc, v[j]);
      }
    }
    grad_x[r * row_vecs + c] = pack_vec<kBf16>(acc);
  }
}

// rows or pointers that are not 16-byte aligned: one warp a token row,
// one element a lane at a time, the same order and rounding
template <bool kBf16>
__global__ void __launch_bounds__(kBackThreads)
gather_back_scalar(const void* __restrict__ grad_out, const int* __restrict__ tok_slots,
                   void* __restrict__ grad_x, int n_tokens, int k, long long n_slots,
                   long long d) {
  const long long r = static_cast<long long>(blockIdx.x) * kBackWarps + threadIdx.x / 32;
  if (r >= n_tokens) return;
  const int lane = threadIdx.x % 32;
  const int* slots = tok_slots + r * k;
  for (long long i = lane; i < d; i += 32) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int slot = __ldg(slots + j);
      if (slot < 0 || slot >= n_slots) continue;
      const long long at = static_cast<long long>(slot) * d + i;
      const float g = kBf16 ? bf16_bits_to_float(static_cast<const uint16_t*>(grad_out)[at])
                            : static_cast<const float*>(grad_out)[at];
      acc = __fadd_rn(acc, g);
    }
    if constexpr (kBf16) {
      static_cast<uint16_t*>(grad_x)[r * d + i] = static_cast<uint16_t>(float_to_bf16_bits(acc));
    } else {
      static_cast<float*>(grad_x)[r * d + i] = acc;
    }
  }
}

int dispatch_back(const void* grad_out, const void* tok_slots, void* grad_x, int n_tokens,
                  int k, long long n_slots, long long d, int esize, cudaStream_t s) {
  if (n_tokens < 0 || k < 0 || n_slots < 0 || d < 0 || !(esize == 2 || esize == 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tokens == 0 || d == 0) return 0;
  const auto blocks = static_cast<unsigned>((n_tokens + kBackWarps - 1) / kBackWarps);
  const int* slots = static_cast<const int*>(tok_slots);
  const long long row_bytes = d * esize;
  const bool aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(grad_out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(grad_x) % 16 == 0;
  if (aligned) {
    const auto* g = static_cast<const uint4*>(grad_out);
    auto* out = static_cast<uint4*>(grad_x);
    if (esize == 2) {
      gather_back<true><<<blocks, kBackThreads, 0, s>>>(g, slots, out, n_tokens, k, n_slots,
                                                        row_bytes / 16);
    } else {
      gather_back<false><<<blocks, kBackThreads, 0, s>>>(g, slots, out, n_tokens, k, n_slots,
                                                         row_bytes / 16);
    }
  } else if (esize == 2) {
    gather_back_scalar<true><<<blocks, kBackThreads, 0, s>>>(grad_out, slots, grad_x, n_tokens,
                                                             k, n_slots, d);
  } else {
    gather_back_scalar<false><<<blocks, kBackThreads, 0, s>>>(grad_out, slots, grad_x, n_tokens,
                                                              k, n_slots, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe_dispatch

// Returns the cudaError_t of the launch (0 = success) and sets *path to
// the kernel launched: 0 none, 1 element-wise, 2 flat, 3 window. An
// element size other than 2 or 4 bytes (bf16, f32), or a hint (group C,
// experts E; both 0 for none) that does not split S into B·E·C and T
// into B rows, returns cudaErrorInvalidValue without launching; n_slots
// = 0 or d = 0 launches nothing. The window path runs where the hint
// holds, the rows are 16-byte aligned, E ≤ 128, a batch row has at least
// four windows' tokens and x holds at least MOE_X_L2_PCT% of L2; the
// flat path otherwise. Launches on `stream` of `device`, which is made
// current for the launch if it is not.
extern "C" int moe_dispatch_gather(const void* x, const void* slot_tok, void* out,
                                   int n_tokens, long long n_slots, long long d, int esize,
                                   int group, int experts, int device, void* stream,
                                   int* path) {
  *path = moe_dispatch::kNone;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = moe_dispatch::dispatch(x, slot_tok, out, n_tokens, n_slots, d, esize, group,
                                        experts, static_cast<cudaStream_t>(stream), path);
  if (current != device) cudaSetDevice(current);
  return rc;
}

// Kernel 7ᵀ: grad_x [T, D] from grad_out [S, D] and tok_slots int32
// [T, k] (see the top of the file). Returns the launch's cudaError_t; an
// element size other than 2 or 4 bytes or a negative size returns
// cudaErrorInvalidValue without launching, and T = 0 or D = 0 launches
// nothing. Launches on `stream` of `device`, made current for the launch
// if it is not.
extern "C" int moe_dispatch_gather_backward(const void* grad_out, const void* tok_slots,
                                            void* grad_x, int n_tokens, int k, long long n_slots,
                                            long long d, int esize, int device, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = moe_dispatch::dispatch_back(grad_out, tok_slots, grad_x, n_tokens, k, n_slots,
                                             d, esize, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return rc;
}
