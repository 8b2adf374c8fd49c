// Array -> bitset conversion kernels for Hopper (sm_90a): array_to_bitset
// and the fused bitset_set_many.
//
// Replaces two Pallas calls of the JAX package's
// src/repro/kernels/bitset_convert.py: `array_to_bitset` at :84
// (`_a2b_kernel`, :52) and `bitset_set_many` at :103 (`_set_many_kernel`,
// :56), which share `_a2b_body` (:34).
//
// Row r holds up to 4,096 int32 values, of which the first card[r] are
// valid (card clamped to [0, 4096]).  Each valid value v in [0, 65535]
// ADDS 1 << (v & 31) to word v >> 5, modulo 2^32: the TPU's disjoint-sum
// trick.  Array containers hold distinct values, so that is an OR; a
// repeated value carries into the next bit, as in both JAX versions and
// the port's plain version.  A value outside [0, 65535] drops, as in the
// Pallas kernel.  bitset_set_many then writes new = old | add and
// delta[r] = popcount(old ^ new), the paper's section 3.2 XOR trick.
//
// What bounds it: bytes.  Per row it reads 4 bytes of card and 4 a valid
// value (about 64 values at the path's 0.1% density) and writes 8,192 bytes
// of words; bitset_set_many also reads the 8,192 old bytes and writes 4 of
// delta.  A few integer ops a value and a popcount a word are far below
// the card's rate.
//
// Design: one block of 256 threads per row.  The TPU has no scatter in a
// kernel, so Pallas compares every value with every word index (a (2048,
// 512) tile per step); here the row's 2,048 words live in 8 KiB of shared
// memory, each value is one shared-memory atomicAdd (atomicAdd, not
// atomicOr, so that duplicates carry as in the reference), and the words
// leave with 16-byte coalesced stores.  Values are read as 16-byte groups
// of four slots, only groups that start below card.  The delta is a block
// sum of __popc: Hopper has the popcount instruction that the TPU's
// Harley-Seal circuit stands in for.
//
// Interface: plain C functions, bound from Python with ctypes
// (repro_torch/kernels/bitset_convert.py).  Each launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;                  // 32-bit words per container
constexpr int kRowVecs = kWords / 4;          // uint4 per word row
constexpr int kArrayCap = 4096;               // slots of a value row
constexpr int kSlotVecs = kArrayCap / 4;      // int4 per value row
constexpr int kThreads = 256;
constexpr int kWordVecsPerThread = kRowVecs / kThreads;    // 2

__device__ __forceinline__ void add_value(uint32_t* w, int v) {
  if (static_cast<unsigned>(v) < 65536u) {
    atomicAdd(w + (v >> 5), 1u << (v & 31));
  }
}

// Sum of `v` over the block's kThreads threads, valid in thread 0.
__device__ __forceinline__ unsigned block_sum(unsigned v) {
  __shared__ unsigned warp_sum[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned total = 0u;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
  }
  return total;
}

template <bool SET_MANY>
__global__ void __launch_bounds__(kThreads)
a2b_kernel(const int4* __restrict__ vals, const int32_t* __restrict__ card,
           const uint4* __restrict__ old, uint4* __restrict__ out,
           int32_t* __restrict__ delta) {
  __shared__ __align__(16) uint32_t s_words[kWords];
  const int64_t row = blockIdx.x;
  uint4* sv = reinterpret_cast<uint4*>(s_words);
#pragma unroll
  for (int j = 0; j < kWordVecsPerThread; ++j) {
    sv[j * kThreads + threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int n = min(max(__ldg(card + row), 0), kArrayCap);
  const int4* vr = vals + row * kSlotVecs;
  for (int g = threadIdx.x; 4 * g < n; g += kThreads) {
    const int4 v = __ldg(vr + g);
    const int s = 4 * g;
    add_value(s_words, v.x);
    if (s + 1 < n) add_value(s_words, v.y);
    if (s + 2 < n) add_value(s_words, v.z);
    if (s + 3 < n) add_value(s_words, v.w);
  }
  __syncthreads();
  uint4* orow = out + row * kRowVecs;
  unsigned acc = 0u;
#pragma unroll
  for (int j = 0; j < kWordVecsPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    uint4 a = sv[i];
    if (SET_MANY) {
      const uint4 o = __ldg(old + row * kRowVecs + i);
      a = make_uint4(o.x | a.x, o.y | a.y, o.z | a.z, o.w | a.w);
      acc += __popc(o.x ^ a.x) + __popc(o.y ^ a.y) + __popc(o.z ^ a.z) +
             __popc(o.w ^ a.w);
    }
    orow[i] = a;
  }
  if (SET_MANY) {
    const unsigned total = block_sum(acc);
    if (threadIdx.x == 0) delta[row] = static_cast<int32_t>(total);
  }
}

}  // namespace

// vals (m, 4096) int32, card (m,) int32; output words (m, 2048) int32.  Row
// pointers must be 16-byte aligned.  m = 0 launches nothing.  Returns the
// cudaError_t of the launch.
extern "C" int array_to_bitset_cuda(const void* vals, const void* card,
                                    int64_t m, void* words, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a2b_kernel<false><<<static_cast<unsigned>(m), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(vals), static_cast<const int32_t*>(card),
      nullptr, static_cast<uint4*>(words), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// old (m, 2048) int32 words, vals (m, 4096) int32, card (m,) int32; outputs
// words (m, 2048) int32 (may not alias old) and delta (m,) int32.  Row
// pointers must be 16-byte aligned.  m = 0 launches nothing.  Returns the
// cudaError_t of the launch.
extern "C" int bitset_set_many_cuda(const void* old, const void* vals,
                                    const void* card, int64_t m, void* words,
                                    void* delta, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a2b_kernel<true><<<static_cast<unsigned>(m), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(vals), static_cast<const int32_t*>(card),
      static_cast<const uint4*>(old), static_cast<uint4*>(words),
      static_cast<int32_t*>(delta));
  return static_cast<int>(cudaGetLastError());
}
