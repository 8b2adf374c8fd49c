// Container popcount for Hopper (sm_90a): (n, 2048) 32-bit words -> (n,)
// int32 cardinalities.
//
// Replaces the Pallas call of the JAX package's
// src/repro/kernels/harley_seal.py: `popcount` at :99 (def :89, kernel
// body `_popcount_kernel`, :81).  The TPU has no vector popcount, so that
// kernel runs the paper's Harley-Seal carry-save circuit (section 4.1.1)
// over 16 words at a time; Hopper has the popcount instruction, so here
// each word is one __popc.
//
// What bounds it: bytes.  Per row it reads 8,192 bytes of words and writes
// 4 of count; one popcount and one add a word are far below the card's
// integer rate.
//
// Design: one block of 256 threads per row; each thread loads two 16-byte
// vectors (a warp reads 512 contiguous bytes), sums __popc, and warp
// shuffles plus one shared-memory step reduce the count.
//
// Interface: a plain C function, bound from Python with ctypes
// (repro_torch/kernels/harley_seal.py).  It launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;                  // 32-bit words per container
constexpr int kRowVecs = kWords / 4;          // uint4 per word row
constexpr int kThreads = 256;
constexpr int kWordVecsPerThread = kRowVecs / kThreads;    // 2

__global__ void __launch_bounds__(kThreads)
popcount_kernel(const uint4* __restrict__ words, int32_t* __restrict__ out) {
  __shared__ unsigned warp_sum[kThreads / 32];
  const int64_t row = blockIdx.x;
  const uint4* wr = words + row * kRowVecs;
  unsigned v = 0u;
#pragma unroll
  for (int j = 0; j < kWordVecsPerThread; ++j) {
    const uint4 x = __ldg(wr + j * kThreads + threadIdx.x);
    v += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    out[row] = static_cast<int32_t>(total);
  }
}

}  // namespace

// words (n, 2048) int32, 16-byte aligned; output (n,) int32.  n = 0
// launches nothing.  Returns the cudaError_t of the launch.
extern "C" int popcount_cuda(const void* words, int64_t n, void* out,
                             void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  popcount_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
