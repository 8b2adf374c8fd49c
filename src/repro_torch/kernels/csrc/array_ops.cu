// Sorted-array kernels for Hopper (sm_90a): the A-side intersection mask and
// count; the two-sided membership masks and the count; the count alone.
//
// Replaces three Pallas calls of the JAX package's
// src/repro/kernels/array_ops.py: `array_intersect` at :83
// (`_intersect_kernel`, :34; `array_difference`, :98, wraps it),
// `array_pair_masks` at :161 (`_pair_masks_kernel`, :107) and
// `array_intersect_card` at :216 (`_intersect_card_kernel`, :177).
//
// Row r holds two sorted arrays of distinct values in [0, 65535]: a[r]'s
// first a_card[r] slots and b[r]'s first b_card[r] slots (cards clamped to
// [0, 4096]).  mask_a[r, i] = 1 where A's slot i holds a value of B, mask_b
// the same from B's side, both 0 at and above the cards; count[r] = the sum
// of mask_a, as the TPU computes it.  A slot at or above a card never
// matches, whatever it holds: the JAX reference's rule.  (The Pallas kernel
// pads B with the value 65537, which an off-contract A value of 65537
// matches.)
//
// What bounds them: bytes, at this slice's sizes.  The A-side kernel reads
// 8 bytes of cards and 4 a valid value of either side and writes 16,384
// bytes of mask and 4 of count a row; the pair kernel reads 32,768 bytes of
// values and 8 of cards and writes 32,768 of masks and 4 of count (about
// 65,548 bytes).  The count alone needs only the valid values and 12
// bytes a row.  The search does about 12 probes per valid slot and side,
// which at full arrays is of the same order as the bytes; below a few
// hundred values a row, as at 0.1% density, the bytes dominate, and at
// the count's few bytes a row, latency does.
//
// Design of the A-side kernel (array_intersect_kernel): a block of 256
// threads a row, the zero tail first.  At the path's mean card of about 64,
// 1,008 of a row's 1,024 16-byte mask groups are zeros whatever A and B
// hold: every group from ceil(a_card / 4) on.  A thread stores its share of
// them (streaming stores: nothing here reads the mask again) as soon as the
// clamped card has arrived, before any value of A or B is loaded and before
// any barrier, so every SM has stores in flight one DRAM round trip into
// the launch (256 rows at M = 256 are two blocks on most of the 132 SMs).
// Then B's valid prefix goes to shared memory, all of it (16 KiB holds a
// full row, so every probe is a shared-memory load) with every load in
// flight at once, while each thread's valid A groups come to registers;
// one barrier; each thread searches the four slots of each of its valid
// groups in lock step with `found`'s probes, branch-free, writes the group
// with one 16-byte store and adds its hits; __reduce_add_sync and a second
// barrier sum the block.  A full-card row spreads its 4,096 searches over
// all eight warps (16 a thread), not one warp's chain; such rows are bound
// by the search's instructions (13 steps of about 8 a slot), not bytes.
// The first values of each side are asked for in the same round trip as
// the cards, so a path row needs one DRAM round trip, not two, before its
// searches: 128 of each (all of a path row) at launches of up to 2,048
// rows, where latency sets the time, and 64 past that, where the extra
// bytes cost more than the round trip they save (on an H100 the wider
// choice was the slower at M = 8,192, the narrower at M = 256).
// Design of the pair kernel (array_pair_kernel): one block of 256 threads
// per row, every mask slot written by exactly one thread from its own
// search, so the masks are deterministic with no atomics, and the count is
// a block reduction of A's hits.  It stages both rows' valid prefixes (2 x
// 16 KiB); each thread binary-searches each of its A slots in B's prefix,
// and each of its B slots in A's prefix.
// Design of the count (intersect_card_kernel): a warp a row, four rows a
// block.  At the path's mean card of about 64, a block a row left 192 of
// 256 threads idle and paid two barriers and a block reduction for half a
// KiB of data.  A warp's 2 KiB shared slice holds B's valid prefix (up to
// 512 values) or the top of the search tree over B; a lane searches one A
// slot a step (16 slots a batch above 256 values), with branch-free steps
// so the loads of a lane's searches overlap, and __reduce_add_sync sums
// the warp.  No block-wide barrier.  Each search is `found`'s own, probe
// for probe, so the count is the masks' count on every input, off
// contract too (no merge path, whose count differs there).
// The TPU compares 512 x 512 tiles all against all and skips tile pairs
// whose ranges cannot overlap (the paper's Algorithm 1 block stepping); the
// search does the same work in O(n log n) compares instead of O(n^2 / tile
// skips).  A merge path and the block compare are later work.
//
// Off contract (unsorted or repeated values, values outside [0, 65535]) the
// searches still read only the valid prefix of the other row and end after
// at most 13 steps, so the kernels stay inside their buffers and terminate.
//
// Interface: plain C functions, bound from Python with ctypes
// (repro_torch/kernels/array_ops.py).  Each launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kArrayCap = 4096;
constexpr int kSlotVecs = kArrayCap / 4;      // int4 per value row
constexpr int kThreads = 256;
constexpr int kSlotsPerThread = kArrayCap / kThreads;     // 16
constexpr int kSlotVecsPerThread = kSlotVecs / kThreads;  // 4

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

// Hits of the four A slots s0 .. s0 + 3 (values v) in the sorted s[0 ..
// nb): `found`'s probes, `steps` of them, the four searches in lock step
// and branch-free; a finished search (lo == hi) takes the "not less" side,
// which keeps its bounds.  s has kArrayCap + 4 slots, so a probe at mid =
// nb = 4,096 needs no clamp.  A slot at or past na never matches.
__device__ __forceinline__ int4 found4(const int32_t* s, int nb, int steps,
                                       int4 v, int s0, int na) {
  const int val[4] = {v.x, v.y, v.z, v.w};
  int lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] = 0;
    hi[q] = s0 + q < na ? nb : 0;
  }
  for (int d = 0; d < steps; ++d) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mid = (lo[q] + hi[q]) >> 1;
      const int x = s[mid];
      const bool up = (lo[q] < hi[q]) & (x < val[q]);
      lo[q] = up ? mid + 1 : lo[q];
      hi[q] = up ? hi[q] : mid;
    }
  }
  int hit[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hit[q] = (s0 + q < na) & (lo[q] < nb) & (s[lo[q]] == val[q]);
  }
  return make_int4(hit[0], hit[1], hit[2], hit[3]);
}

// 16-byte groups of each side asked for with the cards: 32 (all of a path
// row) at launches of up to kEarlyRows rows, where latency sets the time;
// 16 past that, where the bytes do.
constexpr int kEarlyWide = 32;
constexpr int kEarlyNarrow = 16;
constexpr int64_t kEarlyRows = 2048;

template <int kEarly>
__global__ void __launch_bounds__(kThreads)
array_intersect_kernel(const int4* __restrict__ a,
                       const int32_t* __restrict__ a_card,
                       const int4* __restrict__ b,
                       const int32_t* __restrict__ b_card,
                       int4* __restrict__ mask, int32_t* __restrict__ count) {
  __shared__ __align__(16) int32_t s_b[kArrayCap + 4];
  __shared__ unsigned warp_sum[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t row = blockIdx.x;
  const int4* ar = a + row * kSlotVecs;
  const int4* br = b + row * kSlotVecs;
  int4* mr = mask + row * kSlotVecs;
  const int4 zero = make_int4(0, 0, 0, 0);
  const int na_in = __ldg(a_card + row);
  const int nb_in = __ldg(b_card + row);
  // A's group t (threads below kEarly) and B's group t - kEarly (the next
  // kEarly threads), asked for in the same round trip as the cards: always
  // inside the row's 4,096 slots, whatever the cards say.
  int4 early = zero;
  if (t < 2 * kEarly) early = __ldg(t < kEarly ? ar + t : br + t - kEarly);
  const int na = min(max(na_in, 0), kArrayCap);
  const int nb = min(max(nb_in, 0), kArrayCap);
  const int ga = (na + 3) >> 2;     // groups holding a slot below na
  const int gb = (nb + 3) >> 2;
  // 1. the zero tail: groups ga .. 1023, depending on the card alone;
  // streaming stores, since this launch never reads the mask again
#pragma unroll
  for (int j = 0; j < kSlotVecsPerThread; ++j) {
    const int g = j * kThreads + t;
    if (g >= ga) __stcs(mr + g, zero);
  }
  // 2. B's valid prefix to shared memory, every load in flight at once
  // (slots past nb may hold anything: no search reads them as B); A's
  // valid groups to registers, group j * 256 + t in v[j]
  int4* sb4 = reinterpret_cast<int4*>(s_b);
  if (t >= kEarly && t < 2 * kEarly) sb4[t - kEarly] = early;
  int4 rest[kSlotVecsPerThread];
#pragma unroll
  for (int k = 0; k < kSlotVecsPerThread; ++k) {
    const int g = kEarly + k * kThreads + t;
    rest[k] = g < gb ? __ldg(br + g) : zero;
  }
  int4 v[kSlotVecsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotVecsPerThread; ++j) {
    const int g = j * kThreads + t;
    v[j] = j == 0 && t < kEarly ? early : g < ga ? __ldg(ar + g) : zero;
  }
#pragma unroll
  for (int k = 0; k < kSlotVecsPerThread; ++k) {
    const int g = kEarly + k * kThreads + t;
    if (g < gb) sb4[g] = rest[k];
  }
  __syncthreads();
  // 3. the valid groups: four searches each, one 16-byte store
  const int steps = 32 - __clz(nb);  // found's most steps over nb values
  unsigned acc = 0u;
#pragma unroll
  for (int j = 0; j < kSlotVecsPerThread; ++j) {
    const int g = j * kThreads + t;
    if (g < ga) {
      const int4 m = found4(s_b, nb, steps, v[j], 4 * g, na);
      mr[g] = m;
      acc += m.x + m.y + m.z + m.w;
    }
  }
  // 4. the count
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) warp_sum[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    count[row] = static_cast<int32_t>(total);
  }
}

__global__ void __launch_bounds__(kThreads)
array_pair_kernel(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ a_card,
                  const int32_t* __restrict__ b,
                  const int32_t* __restrict__ b_card,
                  int32_t* __restrict__ mask_a, int32_t* __restrict__ mask_b,
                  int32_t* __restrict__ count) {
  __shared__ int32_t s_a[kArrayCap];
  __shared__ int32_t s_b[kArrayCap];
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
    mask_a[row * kArrayCap + i] = hit;
  }
#pragma unroll 4
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    mask_b[row * kArrayCap + i] = i < nb ? found(s_a, na, s_b[i]) : 0;
  }
  const unsigned total = block_sum(acc);
  if (threadIdx.x == 0) count[row] = static_cast<int32_t>(total);
}

// |A ∩ B| alone (intersect_card_kernel): a warp a row, kCardRows rows a
// block, no block-wide barrier.  Each search is `found`'s, probe for
// probe.  A warp's own shared slice of kCardStage ints holds B's valid
// prefix when it fits; else the top nine levels of found's search tree
// over B (the value at each node's mid: the tree depends only on B's
// card), so a search takes its first nine probes from shared memory and
// its last four at most from B in place through __ldg, inside a window of
// eight values.  A lane takes one A slot a step, so the path's rows of
// about 64 values keep all 32 lanes busy; above kWideCard values, four
// groups of four slots (16-byte loads, all in flight together) a batch,
// each group's four searches in lock step.
constexpr int kCardRows = 4;                 // rows a block, a warp each
constexpr int kCardStage = 512;              // ints of a warp's slice
constexpr int kTreeLevels = 9;               // tree nodes 1 .. 511
constexpr int kWideCard = 256;               // A cards taken 4 x 4 a lane

// The mid of found's search-tree node `node` over n values (root 1;
// children 2i, the lower half, and 2i + 1, the upper), or -1 where its
// interval is empty: the node's path replayed from the root.
__device__ __forceinline__ int tree_mid(int node, int n) {
  int lo = 0;
  int hi = n;
  for (int bit = 30 - __clz(node); bit >= 0; --bit) {
    const int mid = (lo + hi) >> 1;
    if ((node >> bit) & 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < hi ? (lo + hi) >> 1 : -1;
}

// A lane's batch of A values: kGroups groups of kSlots slots (kSlots 1 or
// 4), group j from slot i + 32 * kSlots * j, one load each; zeros at and
// past na.
template <int kSlots, int kGroups>
__device__ __forceinline__ void load_batch(const int32_t* ar, int i, int na,
                                           int (&v)[kGroups][kSlots]) {
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int at = i + 32 * kSlots * j;
    if constexpr (kSlots == 4) {
      const int4 x = at < na ? __ldg(reinterpret_cast<const int4*>(ar + at))
                             : make_int4(0, 0, 0, 0);
      v[j][0] = x.x;
      v[j][1] = x.y;
      v[j][2] = x.z;
      v[j][3] = x.w;
    } else {
      v[j][0] = at < na ? __ldg(ar + at) : 0;
    }
  }
}

// Hits of A's valid slots in B, a batch a step.  `sb` is the warp's
// slice: B itself, or (kTree) the top of the tree over `bg`, B in device
// memory.  `v` holds the lane's first batch, loaded before the slice was
// filled.  The steps have no branches: every search loads each step (a
// finished one at a clamped index, keeping its bounds), so a group's loads
// issue back to back.
template <bool kTree, int kSlots, int kGroups>
__device__ __forceinline__ unsigned count_row(const int32_t* ar, int na,
                                              const int32_t* sb,
                                              const int32_t* bg, int nb,
                                              int (&v)[kGroups][kSlots],
                                              int lane) {
  constexpr int kSpan = 32 * kSlots;       // slots a group covers
  const int steps = 32 - __clz(nb);        // found's most steps over nb
  const int cached = kTree ? min(steps, kTreeLevels) : steps;
  unsigned acc = 0u;
  for (int i = kSlots * lane; i < na; i += kSpan * kGroups) {
    if (i != kSlots * lane) load_batch<kSlots, kGroups>(ar, i, na, v);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int at = i + kSpan * j;
      int lo[kSlots], hi[kSlots], node[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        lo[q] = 0;
        hi[q] = at + q < na ? nb : 0;
        node[q] = 1;
      }
      for (int d = 0; d < cached; ++d) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int mid = (lo[q] + hi[q]) >> 1;
          const int x = kTree ? sb[node[q]] : sb[min(mid, kCardStage - 1)];
          const bool on = lo[q] < hi[q];
          const bool up = x < v[j][q];
          lo[q] = on && up ? mid + 1 : lo[q];
          hi[q] = on && !up ? mid : hi[q];
          node[q] = on ? 2 * node[q] + up : node[q];
        }
      }
      if (kTree) {
        for (int d = cached; d < steps; ++d) {
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const int mid = (lo[q] + hi[q]) >> 1;
            const int x = __ldg(bg + min(mid, nb - 1));
            const bool on = lo[q] < hi[q];
            const bool up = x < v[j][q];
            lo[q] = on && up ? mid + 1 : lo[q];
            hi[q] = on && !up ? mid : hi[q];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int x = kTree ? __ldg(bg + min(lo[q], nb - 1))
                            : sb[min(lo[q], kCardStage - 1)];
        acc += at + q < na && lo[q] < nb && x == v[j][q];
      }
    }
  }
  return acc;
}

// One row: its first batch of A loads issued, B's prefix (or the top of
// its search tree) staged in the warp's slice, then the count.
template <int kSlots, int kGroups>
__device__ __forceinline__ unsigned count_one_row(const int32_t* ar, int na,
                                                  const int4* br, int nb,
                                                  int32_t* sb, int lane) {
  int v[kGroups][kSlots];
  load_batch<kSlots, kGroups>(ar, kSlots * lane, na, v);
  const int32_t* bg = reinterpret_cast<const int32_t*>(br);
  if (nb <= kCardStage) {
    for (int g = lane; 4 * g < nb; g += 32)
      reinterpret_cast<int4*>(sb)[g] = __ldg(br + g);
    __syncwarp();
    return count_row<false, kSlots, kGroups>(ar, na, sb, bg, nb, v, lane);
  }
  for (int i = 1 + lane; i < kCardStage; i += 32) {
    const int mid = tree_mid(i, nb);
    if (mid >= 0) sb[i] = __ldg(bg + mid);
  }
  __syncwarp();
  return count_row<true, kSlots, kGroups>(ar, na, sb, bg, nb, v, lane);
}

__global__ void __launch_bounds__(32 * kCardRows)
intersect_card_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ a_card,
                      const int4* __restrict__ b,
                      const int32_t* __restrict__ b_card, int64_t m,
                      int32_t* __restrict__ count) {
  __shared__ __align__(16) int32_t s_b[kCardRows][kCardStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kCardRows + warp;
  if (row >= m) return;                    // whole warps: no barrier below
  const int na = min(max(__ldg(a_card + row), 0), kArrayCap);
  const int nb = min(max(__ldg(b_card + row), 0), kArrayCap);
  const int32_t* ar = a + row * kArrayCap;
  const int4* br = b + row * kSlotVecs;
  unsigned acc = na > kWideCard
      ? count_one_row<4, 4>(ar, na, br, nb, s_b[warp], lane)
      : count_one_row<1, 1>(ar, na, br, nb, s_b[warp], lane);
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) count[row] = static_cast<int32_t>(acc);
}

}  // namespace

// a, b (m, 4096) int32 values, a_card, b_card (m,) int32; outputs mask_a,
// mask_b (m, 4096) int32 and count (m,) int32.  m = 0 launches nothing.
// Returns the cudaError_t of the launch.
extern "C" int array_pair_cuda(const void* a, const void* a_card,
                               const void* b, const void* b_card, int64_t m,
                               void* mask_a, void* mask_b, void* count,
                               void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX || mask_a == nullptr || mask_b == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  array_pair_kernel<<<static_cast<unsigned>(m), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(a_card),
      static_cast<const int32_t*>(b), static_cast<const int32_t*>(b_card),
      static_cast<int32_t*>(mask_a), static_cast<int32_t*>(mask_b),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

// a, b (m, 4096) int32 values, a_card, b_card (m,) int32; output count
// (m,) int32.  Row pointers must be 16-byte aligned.  m = 0 launches
// nothing.  Returns the cudaError_t of the launch.
extern "C" int array_intersect_card_cuda(const void* a, const void* a_card,
                                         const void* b, const void* b_card,
                                         int64_t m, void* count,
                                         void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((m + kCardRows - 1)
                                                / kCardRows);
  intersect_card_kernel<<<blocks, 32 * kCardRows, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(a_card),
      static_cast<const int4*>(b), static_cast<const int32_t*>(b_card), m,
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

// a, b (m, 4096) int32 values, a_card, b_card (m,) int32; outputs mask
// (m, 4096) int32 over A's slots and count (m,) int32.  Row pointers must
// be 16-byte aligned.  m = 0 launches nothing.  Returns the cudaError_t of
// the launch.
extern "C" int array_intersect_cuda(const void* a, const void* a_card,
                                    const void* b, const void* b_card,
                                    int64_t m, void* mask, void* count,
                                    void* stream) {
  if (m == 0) return 0;
  if (m < 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m <= kEarlyRows ? array_intersect_kernel<kEarlyWide>
                                 : array_intersect_kernel<kEarlyNarrow>;
  kernel<<<static_cast<unsigned>(m), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), static_cast<const int32_t*>(a_card),
      static_cast<const int4*>(b), static_cast<const int32_t*>(b_card),
      static_cast<int4*>(mask), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
