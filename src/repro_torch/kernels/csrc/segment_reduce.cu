// Segmented K-way OR / AND / XOR / ANDNOT / threshold reduction fused with
// the popcount of each result, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas call at src/repro/kernels/segment_ops.py:243
// (`segment_reduce`, with its three bodies `_reduce_kernel`, `_andnot_kernel`
// and `_threshold_kernel`, and its two gather front ends
// `segment_reduce_rows` and `segment_reduce_rows_dual`).
//
// What bounds it: bytes.  Every row of a segment is read once (8192 bytes),
// every segment writes its words once (8192 bytes), and the index vectors
// (starts, ids / pos + sidx, weights, T) are a few bytes a row.  At the
// H100's 3.35 TB/s that is (rows * 8192 + S * 8192 + index bytes) / 3.35e12
// seconds.  The OR / AND / XOR / ANDNOT bodies do one logical op per loaded
// word; the threshold body does about 2 * planes ops per loaded word and
// per weight bit, which stays under the card's integer rate for the counter
// widths the planner asks for.
//
// What the design does about it:
//   * one pass over each row: a thread owns 4 neighbouring 32-bit words
//     (one 16-byte load per row), so a warp reads 512 contiguous bytes of a
//     row and the block 2 KiB; the grid is (segments x 4 column tiles);
//   * no materialised gather: the row source (the slab itself, table[ids],
//     or table[pos] | staged[sidx]) is a template parameter folded into the
//     load, where the TPU version builds a gathered slab with jnp.take first;
//   * no padded steps: each thread walks its segment's rows
//     starts[s] .. starts[s+1] at run time, where the TPU grid walks jmax
//     steps and feeds the op identity past a segment's end;
//   * the threshold counter planes live in registers (at most 32 planes,
//     the loops unrolled to a compile-time cap of 4, 8, 16 or 32 and guarded
//     by the run-time `planes`); T, the weights, `planes` and `wbits` are
//     run-time arguments;
//   * the card is __popc per word, a warp shuffle reduce, and one integer
//     atomicAdd per warp into a card vector the caller zeroed;
//   * every segment offset and row index is checked against its array's
//     length (one compare per row, the same for the whole warp); a bad row
//     index is clamped to row 0 for its load and remembered, and the thread
//     traps after its loop, as PyTorch's device-side asserts do, so the
//     error surfaces at the caller's next synchronisation.  Trapping only
//     after the loop keeps the loads free to run ahead of the checks.
//
// Interface: a plain C function, bound from Python with ctypes
// (repro_torch/kernels/segment_ops.py).  It launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;                  // 32-bit words per container
constexpr int kVec = 4;                       // words per thread (16 bytes)
constexpr int kRowVecs = kWords / kVec;       // uint4 per row: 512
constexpr int kThreads = 128;
constexpr int kTiles = kRowVecs / kThreads;   // column tiles per segment: 4

enum Op { kOr = 0, kAnd = 1, kXor = 2, kAndNot = 3, kThreshold = 4 };
enum Src { kSlab = 0, kIds = 1, kDual = 2 };

struct Rows {
  const uint4* __restrict__ table;    // (n_table, 512) uint4
  const uint4* __restrict__ staged;   // (n_staged, 512) uint4, dual only
  const int32_t* __restrict__ pos;    // slot -> table row (ids / dual)
  const int32_t* __restrict__ sidx;   // slot -> staged row (dual)
  int64_t n_slots;                    // rows of the slab, or length of pos
  int64_t n_table;
  int64_t n_staged;
};

__device__ __forceinline__ void check(bool ok) {
  if (!ok) __trap();
}

// The segment's slot range [r0, r1), checked against the slot count.
__device__ __forceinline__ void segment(const Rows& rows,
                                        const int32_t* __restrict__ starts,
                                        int s, int64_t* r0, int64_t* r1) {
  *r0 = starts[s];
  *r1 = starts[s + 1];
  check(*r0 >= 0 && *r1 <= rows.n_slots);
}

// One row of the source; an out-of-range index sets `bad` and reads row 0.
template <int SRC>
__device__ __forceinline__ uint4 load_row(const Rows& rows, int64_t slot,
                                          int col, bool& bad) {
  if (SRC == kSlab) {
    return __ldg(rows.table + slot * kRowVecs + col);
  } else if (SRC == kIds) {
    int64_t r = __ldg(rows.pos + slot);
    const bool ok = r >= 0 && r < rows.n_table;
    bad |= !ok;
    r = ok ? r : 0;
    return __ldg(rows.table + r * kRowVecs + col);
  } else {
    int64_t r = __ldg(rows.pos + slot);
    int64_t q = __ldg(rows.sidx + slot);
    const bool ok = r >= 0 && r < rows.n_table && q >= 0 &&
                    q < rows.n_staged;
    bad |= !ok;
    r = ok ? r : 0;
    q = ok ? q : 0;
    const uint4 a = __ldg(rows.table + r * kRowVecs + col);
    const uint4 b = __ldg(rows.staged + q * kRowVecs + col);
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
}

template <int OP>
__device__ __forceinline__ uint4 combine(uint4 a, uint4 b) {
  if (OP == kOr) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  if (OP == kAnd) return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// Store one thread's 4 result words and add their popcount to cards[s]:
// a warp reduce, then one atomicAdd per warp.
__device__ __forceinline__ void finish(uint4 r, int s, int col,
                                       uint4* __restrict__ out,
                                       int32_t* __restrict__ cards) {
  out[static_cast<int64_t>(s) * kRowVecs + col] = r;
  int c = __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(cards + s, c);
}

// OR / AND / XOR fold every row into one register; ANDNOT keeps row 0 and
// an OR of the rest.
template <int SRC, int OP>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(Rows rows, const int32_t* __restrict__ starts,
              uint4* __restrict__ out, int32_t* __restrict__ cards) {
  const int s = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  int64_t r0, r1;
  segment(rows, starts, s, &r0, &r1);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  bool bad = false;
  if (r1 > r0) {
    acc = load_row<SRC>(rows, r0, col, bad);
    if (OP == kAndNot) {
      uint4 rest = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
      for (int64_t r = r0 + 1; r < r1; ++r) {
        rest = combine<kOr>(rest, load_row<SRC>(rows, r, col, bad));
      }
      acc = make_uint4(acc.x & ~rest.x, acc.y & ~rest.y, acc.z & ~rest.z,
                       acc.w & ~rest.w);
    } else {
#pragma unroll 4
      for (int64_t r = r0 + 1; r < r1; ++r) {
        acc = combine<OP>(acc, load_row<SRC>(rows, r, col, bad));
      }
    }
  }
  check(!bad);
  finish(acc, s, col, out, cards);
}

// Bit-sliced weighted counter: plane i holds bit i of every word's count.
// Weight bit b adds the row at plane b by ripple carry (shift-and-add); the
// comparator then runs from the most significant plane against T[s].
template <int SRC, int P>
__global__ void __launch_bounds__(kThreads)
threshold_kernel(Rows rows, const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ thresh,
                 const int32_t* __restrict__ weights, int planes, int wbits,
                 uint4* __restrict__ out, int32_t* __restrict__ cards) {
  const int s = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  int64_t r0, r1;
  segment(rows, starts, s, &r0, &r1);
  uint32_t cnt[P][kVec];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) cnt[i][k] = 0u;
  }
  bool bad = false;
  for (int64_t r = r0; r < r1; ++r) {
    const uint4 x4 = load_row<SRC>(rows, r, col, bad);
    const uint32_t x[kVec] = {x4.x, x4.y, x4.z, x4.w};
    const int w = weights != nullptr ? __ldg(weights + r) : 1;
    for (int b = 0; b < wbits; ++b) {
      if (((w >> b) & 1) == 0) continue;
      uint32_t carry[kVec] = {x[0], x[1], x[2], x[3]};
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (i >= b && i < planes) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const uint32_t c = cnt[i][k];
            cnt[i][k] = c ^ carry[k];
            carry[k] = c & carry[k];
          }
        }
      }
    }
  }
  const int t = thresh[s];
  uint32_t gt[kVec] = {0u, 0u, 0u, 0u};
  uint32_t eq[kVec] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    if (i < planes) {
      const uint32_t tm = ((t >> i) & 1) ? ~0u : 0u;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        gt[k] |= eq[k] & cnt[i][k] & ~tm;
        eq[k] &= ~(cnt[i][k] ^ tm);
      }
    }
  }
  uint4 res = make_uint4(gt[0] | eq[0], gt[1] | eq[1], gt[2] | eq[2],
                         gt[3] | eq[3]);
  if (r1 <= r0) res = make_uint4(0u, 0u, 0u, 0u);
  check(!bad);
  finish(res, s, col, out, cards);
}

template <int SRC>
cudaError_t launch(const Rows& rows, const int32_t* starts, int n_seg, int op,
                   const int32_t* thresh, const int32_t* weights, int planes,
                   int wbits, uint4* out, int32_t* cards,
                   cudaStream_t stream) {
  const dim3 grid(n_seg, kTiles);
  const dim3 block(kThreads);
  switch (op) {
    case kOr:
      reduce_kernel<SRC, kOr><<<grid, block, 0, stream>>>(rows, starts, out,
                                                          cards);
      break;
    case kAnd:
      reduce_kernel<SRC, kAnd><<<grid, block, 0, stream>>>(rows, starts, out,
                                                           cards);
      break;
    case kXor:
      reduce_kernel<SRC, kXor><<<grid, block, 0, stream>>>(rows, starts, out,
                                                           cards);
      break;
    case kAndNot:
      reduce_kernel<SRC, kAndNot><<<grid, block, 0, stream>>>(rows, starts,
                                                              out, cards);
      break;
    case kThreshold:
      if (planes <= 4) {
        threshold_kernel<SRC, 4><<<grid, block, 0, stream>>>(
            rows, starts, thresh, weights, planes, wbits, out, cards);
      } else if (planes <= 8) {
        threshold_kernel<SRC, 8><<<grid, block, 0, stream>>>(
            rows, starts, thresh, weights, planes, wbits, out, cards);
      } else if (planes <= 16) {
        threshold_kernel<SRC, 16><<<grid, block, 0, stream>>>(
            rows, starts, thresh, weights, planes, wbits, out, cards);
      } else {
        threshold_kernel<SRC, 32><<<grid, block, 0, stream>>>(
            rows, starts, thresh, weights, planes, wbits, out, cards);
      }
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// src: 0 = slab rows in order, 1 = table[pos[slot]],
//      2 = table[pos[slot]] | staged[sidx[slot]].
// op:  0 or, 1 and, 2 xor, 3 andnot, 4 threshold.
// All pointers are device pointers to int32 data; `staged`, `pos`, `sidx`,
// `thresh` and `weights` may be null where the source or op does not read
// them (a null `weights` means weight 1 for every row).  `n_table` and
// `n_staged` are the row counts of `table` and `staged`; `n_slots` is the
// number of slots `starts` may address (slab rows, or the length of `pos`),
// and `weights`, where given, has at least `n_slots` entries.  `out` is
// (n_seg, 2048) int32 and `cards` (n_seg,) int32, zeroed by the caller.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int segment_reduce_cuda(const void* table, int64_t n_table,
                                   const void* staged, int64_t n_staged,
                                   const void* pos, const void* sidx,
                                   int64_t n_slots, int src,
                                   const void* starts, int n_seg, int op,
                                   const void* thresh, const void* weights,
                                   int planes, int wbits, void* out,
                                   void* cards, void* stream) {
  if (n_seg <= 0) return 0;
  if (op == kThreshold && (planes < 1 || planes > 32 || wbits < 1 ||
                           wbits > 31 || thresh == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows rows{static_cast<const uint4*>(table),
                  static_cast<const uint4*>(staged),
                  static_cast<const int32_t*>(pos),
                  static_cast<const int32_t*>(sidx),
                  n_slots, n_table, n_staged};
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* th = static_cast<const int32_t*>(thresh);
  const auto* wt = static_cast<const int32_t*>(weights);
  auto* o = static_cast<uint4*>(out);
  auto* c = static_cast<int32_t*>(cards);
  auto strm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (src) {
    case kSlab:
      err = launch<kSlab>(rows, st, n_seg, op, th, wt, planes, wbits, o, c,
                          strm);
      break;
    case kIds:
      err = launch<kIds>(rows, st, n_seg, op, th, wt, planes, wbits, o, c,
                         strm);
      break;
    case kDual:
      err = launch<kDual>(rows, st, n_seg, op, th, wt, planes, wbits, o, c,
                          strm);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
