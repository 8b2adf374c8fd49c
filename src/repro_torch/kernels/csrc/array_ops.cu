// Sorted-array pair kernel for Hopper (sm_90a): two-sided membership masks
// and the intersection count, or the count alone.
//
// Replaces two Pallas calls of the JAX package's
// src/repro/kernels/array_ops.py: `array_pair_masks` at :161
// (`_pair_masks_kernel`, :107) and `array_intersect_card` at :216
// (`_intersect_card_kernel`, :177).
//
// Row r holds two sorted arrays of distinct values in [0, 65535]: a[r]'s
// first a_card[r] slots and b[r]'s first b_card[r] slots (cards clamped to
// [0, 4096]).  mask_a[r, i] = 1 where A's slot i holds a value of B, mask_b
// the same from B's side, both 0 at and above the cards; count[r] = the sum
// of mask_a, as the TPU computes it.
//
// What bounds it: bytes, at this slice's sizes.  Per row it reads 32,768
// bytes of values and 8 of cards and writes 32,768 of masks and 4 of count
// (about 65,548 bytes; 32,780 in the count-only form).  The search does
// about 12 shared-memory probes per valid slot and side, which at full
// arrays is of the same order as the bytes; below a few hundred values a
// row, as at 0.1% density, the bytes dominate.
//
// Design: one block of 256 threads per row.  Both rows' valid prefixes are
// staged in shared memory (2 x 16 KiB); then each thread binary-searches
// each of its A slots in B's prefix, and (with MASKS) each of its B slots in
// A's prefix.  Every mask slot is written by exactly one thread from its
// own search, so the masks are deterministic with no atomics, and the count
// is a block reduction of A's hits.  The TPU compares 512 x 512 tiles all
// against all and skips tile pairs whose ranges cannot overlap (the paper's
// Algorithm 1 block stepping); the search does the same work in
// O(n log n) compares instead of O(n^2 / tile skips).  A merge path and the
// block compare are later work.
//
// Off contract (unsorted or repeated values, values outside [0, 65535]) the
// searches still read only the valid prefix of the other row and end after
// at most 13 steps, so the kernel stays inside its buffers and terminates.
//
// Interface: a plain C function, bound from Python with ctypes
// (repro_torch/kernels/array_ops.py).  It launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kArrayCap = 4096;
constexpr int kThreads = 256;
constexpr int kSlotsPerThread = kArrayCap / kThreads;     // 16

// Whether `v` occurs in the sorted s[0 .. n): lower bound, then compare.
__device__ __forceinline__ int found(const int32_t* s, int n, int v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n && s[lo] == v;
}

template <bool MASKS>
__global__ void __launch_bounds__(kThreads)
array_pair_kernel(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ a_card,
                  const int32_t* __restrict__ b,
                  const int32_t* __restrict__ b_card,
                  int32_t* __restrict__ mask_a, int32_t* __restrict__ mask_b,
                  int32_t* __restrict__ count) {
  __shared__ int32_t s_a[kArrayCap];
  __shared__ int32_t s_b[kArrayCap];
  __shared__ unsigned warp_sum[kThreads / 32];
  const int64_t row = blockIdx.x;
  const int na = min(max(__ldg(a_card + row), 0), kArrayCap);
  const int nb = min(max(__ldg(b_card + row), 0), kArrayCap);
  const int32_t* ar = a + row * kArrayCap;
  const int32_t* br = b + row * kArrayCap;
  for (int i = threadIdx.x; i < na; i += kThreads) s_a[i] = __ldg(ar + i);
  for (int i = threadIdx.x; i < nb; i += kThreads) s_b[i] = __ldg(br + i);
  __syncthreads();
  unsigned acc = 0u;
#pragma unroll 4
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int hit = i < na ? found(s_b, nb, s_a[i]) : 0;
    acc += hit;
    if (MASKS) mask_a[row * kArrayCap + i] = hit;
  }
  if (MASKS) {
#pragma unroll 4
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int i = j * kThreads + threadIdx.x;
      mask_b[row * kArrayCap + i] = i < nb ? found(s_a, na, s_b[i]) : 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    count[row] = static_cast<int32_t>(total);
  }
}

}  // namespace

// a, b (m, 4096) int32 values, a_card, b_card (m,) int32; outputs mask_a,
// mask_b (m, 4096) int32 -- both nullptr for the count-only kernel -- and
// count (m,) int32.  m = 0 launches nothing.  Returns the cudaError_t of the
// launch.
extern "C" int array_pair_cuda(const void* a, const void* a_card,
                               const void* b, const void* b_card, int64_t m,
                               void* mask_a, void* mask_b, void* count,
                               void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX || (mask_a == nullptr) != (mask_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pac = static_cast<const int32_t*>(a_card);
  const auto* pb = static_cast<const int32_t*>(b);
  const auto* pbc = static_cast<const int32_t*>(b_card);
  auto* pc = static_cast<int32_t*>(count);
  if (mask_a != nullptr) {
    array_pair_kernel<true><<<static_cast<unsigned>(m), kThreads, 0, s>>>(
        pa, pac, pb, pbc, static_cast<int32_t*>(mask_a),
        static_cast<int32_t*>(mask_b), pc);
  } else {
    array_pair_kernel<false><<<static_cast<unsigned>(m), kThreads, 0, s>>>(
        pa, pac, pb, pbc, nullptr, nullptr, pc);
  }
  return static_cast<int>(cudaGetLastError());
}
