// Two-by-two container kernels for Hopper (sm_90a): the bitset pair kernel
// (words and count, or count only) and the array x bitset probe.
//
// Replaces three Pallas calls of the JAX package's
// src/repro/kernels/pair_ops.py: `bitset_pair_op` at :90 (`_pair_op_kernel`,
// :52), `bitset_pair_card` at :118 (`_pair_card_kernel`, :59) and
// `array_bitset_probe` at :169 (`_probe_kernel`, :129).
//
// Bitset pair.  Row r applies op id opids[r] to a[r] and b[r], 2048 32-bit
// words each: 0 and, 1 or, 2 xor, and andnot (a & ~b) for every other id,
// as the TPU's `_mixed_op` selects.  It writes the words (when asked) and
// the row's popcount.
//
// What bounds it: bytes.  Per row it reads 16,384 bytes of words and 4 of
// op id and writes 8,192 bytes of words (none in the count-only form) and 4
// of count: at 3.35 TB/s about 24,584 (16,392) bytes / 3.35e12 seconds a
// row.  One logical op and one popcount per word are far below the card's
// integer rate.
//
// Design: one block of 256 threads per row; each thread loads two 16-byte
// vectors of a and of b (a warp reads 512 contiguous bytes of each), applies
// the row's op -- uniform across the block, so the switch does not diverge
// -- stores the words only in the WRITE_WORDS instantiation, and sums
// __popc.  Warp shuffles and one shared-memory step reduce the count; no
// atomics, no second pass.  The TPU's Harley-Seal circuit is its substitute
// for a popcount instruction, which Hopper has.
//
// Probe.  mask[r, i] = bit vals[r, i] of words[r] for slots i below card[r]
// (clamped to [0, 4096]), 0 at and above it; count[r] = the sum.  A value
// outside [0, 65535] is outside the contract: its word index is clipped to
// [0, 2047] and its bit is value & 31, as the port's plain version (and the
// JAX reference) do, so the kernel never reads outside the row and equals
// the plain version on any input.
//
// What bounds it: bytes.  Per row it reads 16,384 bytes of values, 8,192 of
// words and 4 of card, and writes 16,384 of mask and 4 of count: about
// 40,968 bytes a row.  The TPU gathers the word with a one-hot contraction
// over value tiles (its vector unit has no gather); here the row's 8 KiB of
// words are staged in shared memory with 16-byte loads and each value is
// one shared-memory load and a shift.  A thread owns four 16-byte groups of
// four slots (a warp reads 512 contiguous bytes), loads a group's values
// only when the group starts below card, and writes all four mask slots
// with one 16-byte store.
//
// Interface: plain C functions, bound from Python with ctypes
// (repro_torch/kernels/pair_ops.py).  Each launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;                  // 32-bit words per container
constexpr int kRowVecs = kWords / 4;          // uint4 per word row
constexpr int kArrayCap = 4096;               // slots of an array row
constexpr int kSlotVecs = kArrayCap / 4;      // int4 per value row
constexpr int kThreads = 256;
constexpr int kWordVecsPerThread = kRowVecs / kThreads;    // 2
constexpr int kSlotVecsPerThread = kSlotVecs / kThreads;   // 4

__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 pair_op(int op, uint4 a, uint4 b) {
  switch (op) {
    case 0:
      return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case 1:
      return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case 2:
      return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    default:                                  // andnot, for every other id
      return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
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

template <bool WRITE_WORDS>
__global__ void __launch_bounds__(kThreads)
bitset_pair_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   const int32_t* __restrict__ opids,
                   uint4* __restrict__ out, int32_t* __restrict__ cards) {
  const int64_t row = blockIdx.x;
  const int op = __ldg(opids + row);
  const uint4* ar = a + row * kRowVecs;
  const uint4* br = b + row * kRowVecs;
  uint4 x[kWordVecsPerThread], y[kWordVecsPerThread];
#pragma unroll
  for (int j = 0; j < kWordVecsPerThread; ++j) {
    const int v = j * kThreads + threadIdx.x;
    x[j] = __ldg(ar + v);
    y[j] = __ldg(br + v);
  }
  unsigned acc = 0u;
#pragma unroll
  for (int j = 0; j < kWordVecsPerThread; ++j) {
    const uint4 r = pair_op(op, x[j], y[j]);
    if (WRITE_WORDS) out[row * kRowVecs + j * kThreads + threadIdx.x] = r;
    acc += popc4(r);
  }
  const unsigned total = block_sum(acc);
  if (threadIdx.x == 0) cards[row] = static_cast<int32_t>(total);
}

__device__ __forceinline__ int probe_bit(const uint32_t* words, int v) {
  const int w = min(max(v >> 5, 0), kWords - 1);
  return static_cast<int>((words[w] >> (v & 31)) & 1u);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int4* __restrict__ vals, const int32_t* __restrict__ card,
             const uint4* __restrict__ words, int4* __restrict__ mask,
             int32_t* __restrict__ count) {
  __shared__ __align__(16) uint32_t s_words[kWords];
  const int64_t row = blockIdx.x;
  const int n = min(max(__ldg(card + row), 0), kArrayCap);
  const uint4* wr = words + row * kRowVecs;
#pragma unroll
  for (int j = 0; j < kWordVecsPerThread; ++j) {
    const int v = j * kThreads + threadIdx.x;
    reinterpret_cast<uint4*>(s_words)[v] = __ldg(wr + v);
  }
  __syncthreads();
  const int4* vr = vals + row * kSlotVecs;
  int4* mr = mask + row * kSlotVecs;
  unsigned acc = 0u;
#pragma unroll
  for (int j = 0; j < kSlotVecsPerThread; ++j) {
    const int g = j * kThreads + threadIdx.x;      // slots 4g .. 4g + 3
    const int s = 4 * g;
    int4 m = make_int4(0, 0, 0, 0);
    if (s < n) {
      const int4 v = __ldg(vr + g);
      m.x = probe_bit(s_words, v.x);
      m.y = s + 1 < n ? probe_bit(s_words, v.y) : 0;
      m.z = s + 2 < n ? probe_bit(s_words, v.z) : 0;
      m.w = s + 3 < n ? probe_bit(s_words, v.w) : 0;
      acc += m.x + m.y + m.z + m.w;
    }
    mr[g] = m;
  }
  const unsigned total = block_sum(acc);
  if (threadIdx.x == 0) count[row] = static_cast<int32_t>(total);
}

}  // namespace

// a, b (m, 2048) int32 words, opids (m,) int32; outputs words (m, 2048)
// int32 -- or nullptr for the count-only kernel -- and cards (m,) int32.
// Row pointers must be 16-byte aligned.  m = 0 launches nothing.  Returns
// the cudaError_t of the launch.
extern "C" int bitset_pair_cuda(const void* a, const void* b,
                                const void* opids, int64_t m, void* words,
                                void* cards, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint4*>(a);
  const auto* pb = static_cast<const uint4*>(b);
  const auto* po = static_cast<const int32_t*>(opids);
  auto* pc = static_cast<int32_t*>(cards);
  if (words != nullptr) {
    bitset_pair_kernel<true><<<static_cast<unsigned>(m), kThreads, 0, s>>>(
        pa, pb, po, static_cast<uint4*>(words), pc);
  } else {
    bitset_pair_kernel<false><<<static_cast<unsigned>(m), kThreads, 0, s>>>(
        pa, pb, po, nullptr, pc);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals (m, 4096) int32, card (m,) int32, words (m, 2048) int32; outputs
// mask (m, 4096) int32 and count (m,) int32.  Row pointers must be 16-byte
// aligned.  m = 0 launches nothing.  Returns the cudaError_t of the launch.
extern "C" int array_bitset_probe_cuda(const void* vals, const void* card,
                                       const void* words, int64_t m,
                                       void* mask, void* count,
                                       void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<<<static_cast<unsigned>(m), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(vals), static_cast<const int32_t*>(card),
      static_cast<const uint4*>(words), static_cast<int4*>(mask),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
