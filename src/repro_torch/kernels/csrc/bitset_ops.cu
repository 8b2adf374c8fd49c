// Fused bitset op + cardinality for Hopper (sm_90a): one logical op for the
// whole call, words and count, or the count alone.
//
// Replaces two Pallas calls of the JAX package's
// src/repro/kernels/bitset_ops.py: `bitset_op` at :69 (`_op_kernel`, :39)
// and `bitset_op_card` at :96 (`_card_kernel`, :46), the paper's section
// 4.1.2 fused op and popcount and its section 5.9 count-only "fast count".
//
// Row r applies OP to a[r] and b[r], 2048 32-bit words each: and, or, xor
// or andnot (a & ~b).  It writes the words (WRITE_WORDS) and the row's
// popcount.  The TPU kernel's op is static (`functools.partial(_op_kernel,
// op=op)` under `static_argnames`), so here it is a template parameter:
// one instantiation per op and form, no op read from memory and no switch.
//
// What bounds it: bytes.  Per row it reads 16,384 bytes of words and writes
// 8,192 bytes of words (none in the count-only form) and 4 of count: at
// 3.35 TB/s about 24,580 (16,388) bytes / 3.35e12 seconds a row.  One
// logical op and one popcount per word are far below the card's integer
// rate.
//
// Design: one block of 256 threads per row; each thread loads two 16-byte
// vectors of a and of b (a warp reads 512 contiguous bytes of each),
// applies OP, stores the words with 16-byte stores only in the WRITE_WORDS
// instantiation, and sums __popc.  Warp shuffles and one shared-memory step
// reduce the count; no atomics, no second pass.  The TPU runs the paper's
// Harley-Seal carry-save circuit because it has no popcount instruction;
// Hopper has one, so the circuit is not carried over.
//
// Interface: a plain C function, bound from Python with ctypes
// (repro_torch/kernels/bitset_ops.py).  It launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;                  // 32-bit words per container
constexpr int kRowVecs = kWords / 4;          // uint4 per word row
constexpr int kThreads = 256;
constexpr int kWordVecsPerThread = kRowVecs / kThreads;    // 2

// Op ids, in the order of the port's ref.PAIR_OPS.
constexpr int kAnd = 0;
constexpr int kOr = 1;
constexpr int kXor = 2;
constexpr int kAndNot = 3;

template <int OP>
__device__ __forceinline__ uint4 apply(uint4 a, uint4 b) {
  if constexpr (OP == kAnd) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  } else if constexpr (OP == kOr) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  } else if constexpr (OP == kXor) {
    return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  } else {
    return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
  }
}

template <int OP, bool WRITE_WORDS>
__global__ void __launch_bounds__(kThreads)
bitset_op_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                 uint4* __restrict__ out, int32_t* __restrict__ cards) {
  __shared__ unsigned warp_sum[kThreads / 32];
  const int64_t row = blockIdx.x;
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
    const uint4 r = apply<OP>(x[j], y[j]);
    if (WRITE_WORDS) out[row * kRowVecs + j * kThreads + threadIdx.x] = r;
    acc += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
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
    cards[row] = static_cast<int32_t>(total);
  }
}

template <int OP>
void launch(const uint4* a, const uint4* b, unsigned m, uint4* words,
            int32_t* cards, cudaStream_t s) {
  if (words != nullptr) {
    bitset_op_kernel<OP, true><<<m, kThreads, 0, s>>>(a, b, words, cards);
  } else {
    bitset_op_kernel<OP, false><<<m, kThreads, 0, s>>>(a, b, nullptr, cards);
  }
}

}  // namespace

// a, b (m, 2048) int32 words; op 0 and, 1 or, 2 xor, 3 andnot (any other
// value is refused); outputs words (m, 2048) int32 -- or nullptr for the
// count-only kernel -- and cards (m,) int32.  Row pointers must be 16-byte
// aligned.  m = 0 launches nothing.  Returns the cudaError_t of the launch.
extern "C" int bitset_op_cuda(const void* a, const void* b, int op,
                              int64_t m, void* words, void* cards,
                              void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint4*>(a);
  const auto* pb = static_cast<const uint4*>(b);
  auto* pw = static_cast<uint4*>(words);
  auto* pc = static_cast<int32_t*>(cards);
  const auto n = static_cast<unsigned>(m);
  switch (op) {
    case kAnd:
      launch<kAnd>(pa, pb, n, pw, pc, s);
      break;
    case kOr:
      launch<kOr>(pa, pb, n, pw, pc, s);
      break;
    case kXor:
      launch<kXor>(pa, pb, n, pw, pc, s);
      break;
    case kAndNot:
      launch<kAndNot>(pa, pb, n, pw, pc, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
