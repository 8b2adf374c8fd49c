// Similarity top-k for Hopper (sm_90a): a score kernel and a select kernel,
// and their labelled twins for one shard of the sharded engine.
//
// Replaces four Pallas calls of the JAX package's
// src/repro/kernels/topk_ops.py: the score stage at :147 (`_score_kernel`,
// :58) and the select stage at :166 (`_select_kernel`, :86) of
// `similarity_topk`; the shard's score stage at :273 (`_score_ids_kernel`,
// :190, in `similarity_topk_ids`) and the labelled select at :310
// (`_select_ids_kernel`, :220, in `topk_merge`).
//
// Score.  inter[t] = sum over rows r in starts[t]..starts[t+1] of
// popc(rows[r] & q_words[row_col[r]]), then score[t] = the metric of
// (inter[t], q_card, cards[t]) in float32, forced to -1.0 at t == exclude.
//
// What bounds it: bytes.  Every candidate row is read once (8192 bytes), the
// query block (C rows of 8192 bytes) is read from device memory once and
// then from L2, plus 4 bytes of row_col per row; the outputs are 8 bytes a
// candidate.  At the H100's 3.35 TB/s that is about (N * 8196 + C * 8192) /
// 3.35e12 seconds.  One AND and one popcount per loaded word stay far below
// the card's integer rate.
//
// What the design does about it:
//   * one block per candidate walks that candidate's own rows at run time,
//     where the TPU grid pads every candidate to jmax steps; a thread owns
//     two 16-byte vectors of each row, so a warp reads 1 KiB of a row and
//     the block the whole 8 KiB row, and the row loop is unrolled twice to
//     keep four row loads and four query loads in flight per thread;
//   * a candidate has at most one row per chunk key, so the longest block
//     reads at most C rows: the imbalance between blocks is bounded by the
//     key count (256 at 2^24 documents);
//   * the intersection is a per-candidate sum (unsigned, so a count past
//     2^31 wraps exactly as the plain version's int64 -> int32 cast does),
//     reduced by warp shuffles and shared memory, and thread 0 writes the
//     score: no global prefix, no atomics, no second pass;
//   * the score is float32 with the plain version's operation order, each
//     step an explicitly rounded intrinsic (__int2float_rn, __fadd_rn,
//     __fsub_rn, __fmul_rn, __fsqrt_rn, __fdiv_rn), so nvcc cannot contract
//     `qc + oc - inter` or `qc * oc` into an FMA and the bits match the
//     reference on every path (no --use_fast_math);
//   * the candidate's row range is checked against the row count before the
//     loop (a bad one traps), and each row_col entry against the query
//     block's rows: a bad one is clamped to column 0 for its load and
//     remembered, and the thread traps after its loop, so the loads can run
//     ahead of the checks.
//
// Select.  The function is k rounds of (max, lowest index of the max),
// each recording idx, the round's value and inter of the winner and then
// masking it with -2.0.  For scores that are not NaN: the entries above
// -2.0 come first in the order of a stable descending sort (-0.0 and
// +0.0 tie, so the lower index goes first), each with its own score bits;
// every later round gives the lowest index whose score is at least -2.0
// (taken entries hold -2.0), at -2.0, with its inter; when no score
// reaches -2.0, round 0 gives the stable argmax at its own score and every
// later round that index at -2.0.
//
// What bounds it: latency, not bytes (8 bytes a candidate read, 12 a
// result written).  The design is a rank by counting (rank_select_kernel
// below): one launch of a warp per entry, each counting the keys that sort
// before its own, with no k-round loop and no block-wide reduction per
// round, so its time does not grow with k.  At this slice's T = 1,024
// that is 128 blocks (one wave) and 32 shared-memory compares a lane.
//
// Score over ids (one shard).  The same block per slot and the same
// float32 metric code, with three differences.  The slot's rows are read
// from the shard's own slab through local positions (`table[pos[r]]`), as
// segment_reduce reads an arena slab, so no gathered copy of the rows is
// made (the JAX package gathers them with an XLA take outside its kernel).
// Each slot carries its global candidate id: the slot whose id is `exclude`
// scores -1.0, and then every slot at or past `n_valid` (padding) scores
// -2.0, in that order.  And each position is checked against the slab's
// rows like row_col against the query block.  Bound by bytes, as the score
// kernel: 8192 bytes a row read once, plus 8 bytes of pos and row_col.
//
// Select over ids.  The function: (id, score) groups of M labelled
// entries in order of score descending, then id ascending, each group
// once with the largest inter of its entries (at least 0), while groups
// with score > -2.0 remain; every later round of the k repeats (lowest id
// among entries with score >= -2.0, -2.0, the largest inter of that id's
// entries there).  That is what k rounds of masking give (the JAX
// package's rounds, kept going once every entry is masked, so a shard
// with fewer than k valid slots gives the same k-list); scores are never
// NaN.  -0.0 and +0.0 are one score; a group at zero is written +0.0
// while an entry of +0.0 bits with an id at or past its own remains, else
// -0.0, as the JAX rounds' max gives it.  The same kernel merges the
// gathered S*k lists.
//
// What bounds it: latency, not bytes (12 bytes an entry read, 12 a result
// written), so the design is one pass with few barriers.  Up to 1,024
// entries, one block sorts (key, inter) pairs in shared memory with a bitonic network
// (log2(M)^2 / 2 barrier steps), where the 64-bit key orders score
// descending, then id ascending, and inter descending breaks ties, so a
// group's first entry holds its largest inter.  A ballot prefix over the
// group starts gives each group its rank, and a group above -2.0 whose
// rank is below k writes its slot: no k-round loop, no scratch.  One
// block-wide minimum of (id, then largest inter) over the entries with
// score >= -2.0 fills the remaining rounds.  Past 1,024 entries each
// chunk of 1,024 keeps its k best groups and its minimum (a group's rank
// within a chunk is never worse than its global rank, so the k best
// survive with their largest inters), level after level, and one block
// ranks the rest: exact for any M and k <= 512; above that, one block
// sorts all M in device memory.
//
// Interface: plain C functions, bound from Python with ctypes
// (repro_torch/kernels/topk_ops.py).  Each launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowVecs = 2048 / 4;            // uint4 per 2048-word row
constexpr int kScoreThreads = 256;
constexpr int kVecsPerThread = kRowVecs / kScoreThreads;   // 2
constexpr int kSelectThreads = 1024;

enum Metric { kJaccard = 0, kCosine = 1, kContainment = 2 };

__device__ __forceinline__ unsigned popc_and(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

// The reference's float32 formula, one rounding per step.
__device__ __forceinline__ float metric_score(int inter, int q_card,
                                              int card, int metric) {
  const float fi = __int2float_rn(inter);
  const float qc = __int2float_rn(q_card);
  const float oc = __int2float_rn(card);
  float denom;
  if (metric == kJaccard) {
    denom = __fsub_rn(__fadd_rn(qc, oc), fi);
  } else if (metric == kCosine) {
    denom = __fsqrt_rn(__fmul_rn(qc, oc));
  } else {
    denom = qc;
  }
  return denom > 0.0f ? __fdiv_rn(fi, denom) : 1.0f;
}

__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const uint4* __restrict__ rows, int64_t n_rows,
             const int32_t* __restrict__ row_col,
             const int32_t* __restrict__ starts,
             const uint4* __restrict__ q_words, int64_t n_cols, int q_card,
             const int32_t* __restrict__ cards, int exclude, int metric,
             float* __restrict__ score, int32_t* __restrict__ inter) {
  const int t = blockIdx.x;
  const int64_t r0 = starts[t];
  const int64_t r1 = starts[t + 1];
  if (!(r0 >= 0 && r0 <= r1 && r1 <= n_rows)) __trap();
  unsigned acc = 0u;
  bool bad = false;
#pragma unroll 2
  for (int64_t r = r0; r < r1; ++r) {
    int64_t c = __ldg(row_col + r);
    const bool ok = c >= 0 && c < n_cols;
    bad |= !ok;
    c = ok ? c : 0;
    const uint4* row = rows + r * kRowVecs;
    const uint4* q = q_words + c * kRowVecs;
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const int v = j * kScoreThreads + threadIdx.x;
      acc += popc_and(__ldg(row + v), __ldg(q + v));
    }
  }
  if (bad) __trap();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ unsigned warp_sum[kScoreThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kScoreThreads / 32; ++w) total += warp_sum[w];
    const int n = static_cast<int>(total);
    inter[t] = n;
    score[t] = t == exclude ? -1.0f : metric_score(n, q_card, cards[t],
                                                    metric);
  }
}

__global__ void __launch_bounds__(kScoreThreads)
score_ids_kernel(const uint4* __restrict__ table, int64_t n_table,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ row_col, int64_t n_pos,
                 const int32_t* __restrict__ starts,
                 const uint4* __restrict__ q_words, int64_t n_cols,
                 int q_card, const int32_t* __restrict__ cards,
                 const int32_t* __restrict__ gidx, int n_valid, int exclude,
                 int metric, float* __restrict__ score,
                 int32_t* __restrict__ inter) {
  const int t = blockIdx.x;
  const int64_t r0 = starts[t];
  const int64_t r1 = starts[t + 1];
  if (!(r0 >= 0 && r0 <= r1 && r1 <= n_pos)) __trap();
  unsigned acc = 0u;
  bool bad = false;
#pragma unroll 2
  for (int64_t r = r0; r < r1; ++r) {
    int64_t p = __ldg(pos + r);
    int64_t c = __ldg(row_col + r);
    const bool ok = p >= 0 && p < n_table && c >= 0 && c < n_cols;
    bad |= !ok;
    p = ok ? p : 0;
    c = ok ? c : 0;
    const uint4* row = table + p * kRowVecs;
    const uint4* q = q_words + c * kRowVecs;
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const int v = j * kScoreThreads + threadIdx.x;
      acc += popc_and(__ldg(row + v), __ldg(q + v));
    }
  }
  if (bad) __trap();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ unsigned warp_sum[kScoreThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kScoreThreads / 32; ++w) total += warp_sum[w];
    const int n = static_cast<int>(total);
    float s = metric_score(n, q_card, cards[t], metric);
    if (gidx[t] == exclude) s = -1.0f;
    if (t >= n_valid) s = -2.0f;
    inter[t] = n;
    score[t] = s;
  }
}

// Both selects order entries by one 64-bit key: the score mapped to an
// unsigned order, descending, above the index or global id, ascending, so
// one compare gives (score descending, id ascending).  -0.0 maps as +0.0:
// the two compare equal, so the lower id goes first, as in the JAX
// package's rounds.  The labelled select sorts (key, inter) pairs, and
// inter descending breaks ties, so each (id, score) group's first entry
// carries the group's largest inter.  A sentinel key (all ones) sorts last.
using u64 = unsigned long long;
constexpr int kIdsChunk = 1024;        // entries a block sorts in shared
constexpr u64 kNoKey = ~0ull;

__device__ __forceinline__ u64 make_key(float score, int gid) {
  const unsigned bits = __float_as_uint(score);
  const unsigned u = bits == 0x80000000u ? 0u : bits;       // -0.0 -> +0.0
  const unsigned asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(~asc) << 32)
         | (static_cast<unsigned>(gid) ^ 0x80000000u);
}
__device__ __forceinline__ float key_score(u64 key) {
  const unsigned asc = ~static_cast<unsigned>(key >> 32);
  return __uint_as_float((asc & 0x80000000u) ? (asc & 0x7fffffffu) : ~asc);
}
__device__ __forceinline__ int key_gid(u64 key) {
  return static_cast<int>(static_cast<unsigned>(key) ^ 0x80000000u);
}
// (lowest id, then largest inter) as one minimum
__device__ __forceinline__ u64 make_pack(int gid, int inter) {
  return (static_cast<u64>(static_cast<unsigned>(gid) ^ 0x80000000u) << 32)
         | ~(static_cast<unsigned>(inter) ^ 0x80000000u);
}
__device__ __forceinline__ int pack_gid(u64 pk) {
  return static_cast<int>(static_cast<unsigned>(pk >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int pack_inter(u64 pk) {
  return static_cast<int>(~static_cast<unsigned>(pk) ^ 0x80000000u);
}
__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }
// (largest id) as one minimum, over the entries whose score is +0.0 bits
__device__ __forceinline__ u64 make_zero_pack(int gid) {
  return ~(static_cast<unsigned>(gid) ^ 0x80000000u);
}
__device__ __forceinline__ int zero_pack_gid(u64 zp) {
  return static_cast<int>(~static_cast<unsigned>(zp) ^ 0x80000000u);
}

__device__ u64 block_min(u64 x, u64* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = umin64(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (lane == 0) s_red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < static_cast<int>(blockDim.x >> 5) ? s_red[lane] : kNoKey;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = umin64(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) s_red[32] = x;
  }
  __syncthreads();
  return s_red[32];
}

// The single-device select: a rank by counting.  Warp w of block b owns
// entry i = 8b + w; its lanes compare i's key with every key of the T
// entries, staged in shared memory a tile at a time, and add up the ones
// that sort before it.  Keys are unique (the index is in them), so the
// entries of rank r < k are exactly one each, and that entry writes slot
// r: itself when its score is above -2.0; else the round that the JAX
// rounds give once every entry above -2.0 is taken (see the header).  One
// launch of ceil(T / 8) blocks, no k-round loop and no scratch; a warp
// stops counting once k keys sort before its entry, and the block stops
// staging tiles once all its warps have.  Tiles start at the block's own,
// so inputs sorted either way stop after a tile or two.
constexpr int kRankWarps = 8;                // entries a block ranks
constexpr int kRankThreads = 32 * kRankWarps;
constexpr int kRankTile = 2048;              // keys a block stages at once

__global__ void __launch_bounds__(kRankThreads)
rank_select_kernel(const float* __restrict__ score,
                   const int32_t* __restrict__ inter, int n, int k,
                   int32_t* __restrict__ out_idx,
                   float* __restrict__ out_score,
                   int32_t* __restrict__ out_inter) {
  __shared__ u64 s_key[kRankTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRankWarps + warp;
  const u64 mine = i < n ? make_key(__ldg(score + i), i) : 0;
  const int n_tiles = (n + kRankTile - 1) / kRankTile;
  const int own = blockIdx.x * kRankWarps / kRankTile;
  unsigned rank = 0;
  bool done = i >= n;
  for (int step = 0; step < n_tiles; ++step) {
    int tile = own + step;
    tile -= tile >= n_tiles ? n_tiles : 0;
    const int lo = tile * kRankTile;
    const int len = min(kRankTile, n - lo);
    for (int j = threadIdx.x; j < len; j += kRankThreads)
      s_key[j] = make_key(__ldg(score + lo + j), lo + j);
    __syncthreads();
    if (!done) {
      unsigned cnt = 0;
#pragma unroll 8
      for (int j = lane; j < len; j += 32) cnt += s_key[j] < mine;
      rank += __reduce_add_sync(0xffffffffu, cnt);
      done = rank >= static_cast<unsigned>(k);
    }
    if (__syncthreads_and(done)) break;      // also frees s_key
  }
  if (done) return;                          // past the k-list, or no entry
  const float s = score[i];
  if (s > -2.0f) {
    if (lane == 0) {
      out_idx[rank] = i;
      out_score[rank] = s;
      out_inter[rank] = inter[i];
    }
    return;
  }
  // every entry above -2.0 is taken by now: the round takes the lowest
  // index with a score of at least -2.0 (taken entries hold -2.0), at -2.0
  int w = -1;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const unsigned hit = __ballot_sync(0xffffffffu,
                                       j < n && score[j] >= -2.0f);
    if (hit) {
      w = base + __ffs(hit) - 1;
      break;
    }
  }
  float out = -2.0f;
  if (w < 0) {                               // no score reaches -2.0
    if (rank == 0) {                         // round 0 takes the argmax
      w = i;
      out = s;
    } else {                                 // later rounds repeat it
      u64 best = kNoKey;
      for (int j = lane; j < n; j += 32)
        best = umin64(best, make_key(score[j], j));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best = umin64(best, __shfl_xor_sync(0xffffffffu, best, off));
      w = key_gid(best);
    }
  }
  if (lane == 0) {
    out_idx[rank] = w;
    out_score[rank] = out;
    out_inter[rank] = inter[w];
  }
}

struct SelectIds {
  const float* score;                  // raw entries (first level)
  const int32_t* inter;
  const int32_t* gidx;
  const u64* in_key;                   // or keyed entries (later levels)
  const int32_t* in_inter;
  int64_t n;                           // entries at this level
  int chunk;                           // entries a block takes
  int pow2;                            // sort size: a power of two >= chunk
  u64* buf_key;                        // global sort buffer, or null for
  int32_t* buf_inter;                  //   shared memory
  int k;                               // groups to emit (a chunk's, or k)
  int final_level;                     // 1: write the k-list
  u64* out_key;                        // a chunk's k groups, in order
  int32_t* out_inter;
  u64* packs;                          // per first-level chunk: (min id,
  int n_packs;                         //   max inter) over scores >= -2
  u64* zero_packs;                     //   and its largest id of +0.0
  int32_t* out_gidx;
  float* out_score;
  int32_t* out_top_inter;
};

// One pass of the labelled select over a chunk of entries: load, bitonic
// sort, then the rank of each group is the count of group starts before
// it (a ballot prefix).  A chunk of a first or middle level emits its k
// best groups (with their largest inter) and, on the first level, its
// (min id, max inter) pack and its zero pack; the final level writes the
// k-list: groups with score > -2.0 at their rank, then the exhaustion
// rounds.  A group of score zero is written as the JAX package's round
// max gives it: +0.0 while an entry of +0.0 bits remains, that is, while
// the largest id of such an entry is at least the group's; else -0.0.
template <bool kRaw>
__global__ void __launch_bounds__(kSelectThreads)
select_ids_kernel(SelectIds a) {
  extern __shared__ __align__(16) unsigned char ids_smem[];
  __shared__ u64 s_red[33];
  __shared__ int s_cnt[32], s_cnt_a[32], s_off[32], s_tot[2];
  u64* key = a.buf_key ? a.buf_key : reinterpret_cast<u64*>(ids_smem);
  int32_t* itr = a.buf_inter ? a.buf_inter
      : reinterpret_cast<int32_t*>(ids_smem + sizeof(u64) * a.pow2);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.chunk;
  const int64_t left = a.n - lo;
  const int cnt = left < a.chunk ? static_cast<int>(left) : a.chunk;

  u64 pack = kNoKey, zero = kNoKey;
  for (int i = tid; i < a.pow2; i += nthreads) {
    u64 kk = kNoKey;
    int it = INT_MIN;
    if (i < cnt) {
      if (kRaw) {
        const float sc = a.score[lo + i];
        const int g = a.gidx[lo + i];
        it = a.inter[lo + i];
        kk = make_key(sc, g);
        if (sc >= -2.0f) pack = umin64(pack, make_pack(g, it));
        if (__float_as_uint(sc) == 0u) zero = umin64(zero, make_zero_pack(g));
      } else {
        kk = a.in_key[lo + i];
        it = a.in_inter[lo + i];
      }
    }
    key[i] = kk;
    itr[i] = it;
  }
  if (a.final_level && a.n_packs > 0) {
    for (int i = tid; i < a.n_packs; i += nthreads) {
      pack = umin64(pack, a.packs[i]);
      zero = umin64(zero, a.zero_packs[i]);
    }
  }
  if (kRaw || a.final_level) {
    pack = block_min(pack, s_red);
    zero = block_min(zero, s_red);
    if (!a.final_level && tid == 0) {
      a.packs[blockIdx.x] = pack;
      a.zero_packs[blockIdx.x] = zero;
    }
  }
  __syncthreads();

  // bitonic sort, ascending by (key, then inter descending)
  for (int size = 2; size <= a.pow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < a.pow2 / 2; t += nthreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const u64 ki = key[i], kj = key[j];
        const int ii = itr[i], ij = itr[j];
        const bool up = (i & size) == 0;
        const bool swap = up ? (kj < ki || (kj == ki && ij > ii))
                             : (ki < kj || (ki == kj && ii > ij));
        if (swap) {
          key[i] = kj;
          key[j] = ki;
          itr[i] = ij;
          itr[j] = ii;
        }
      }
      __syncthreads();
    }
  }

  // the exhaustion rounds' (id, inter): the pack over scores >= -2.0, or,
  // when no score reaches -2.0, the top group's (the first round takes it
  // at its score and every later round at -2.0)
  const bool none = pack == kNoKey;
  const int w_gid = none ? key_gid(key[0]) : pack_gid(pack);
  const int w_inter = max(0, none ? itr[0] : pack_inter(pack));

  // group starts in sorted order; rank = group starts before
  int base = 0, n_above = 0;           // groups so far; of them score > -2
  for (int r0 = 0; r0 < a.pow2; r0 += nthreads) {
    const int i = r0 + tid;
    u64 ki = kNoKey;
    bool start = false;
    if (i < a.pow2) {
      ki = key[i];
      start = ki != kNoKey && (i == 0 || key[i - 1] != ki);
    }
    const bool above = start && key_score(ki) > -2.0f;
    const unsigned bal = __ballot_sync(0xffffffffu, start);
    const unsigned bal_a = __ballot_sync(0xffffffffu, above);
    if (lane == 0) {
      s_cnt[warp] = __popc(bal);
      s_cnt_a[warp] = __popc(bal_a);
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = nthreads >> 5;
      const int c = lane < nw ? s_cnt[lane] : 0;
      int ca = lane < nw ? s_cnt_a[lane] : 0;
      int x = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ca += __shfl_xor_sync(0xffffffffu, ca, off);
      s_off[lane] = x - c;
      if (lane == 31) s_tot[0] = x;
      if (lane == 0) s_tot[1] = ca;
    }
    __syncthreads();
    const int rank = base + s_off[warp]
                     + __popc(bal & ((1u << lane) - 1u));
    if (start && rank < a.k) {
      if (!a.final_level) {
        a.out_key[static_cast<int64_t>(blockIdx.x) * a.k + rank] = ki;
        a.out_inter[static_cast<int64_t>(blockIdx.x) * a.k + rank] = itr[i];
      } else if (above || (none && rank == 0)) {
        const int g = key_gid(ki);
        const float sc = key_score(ki);
        a.out_gidx[rank] = g;
        a.out_score[rank] = sc == 0.0f && (zero == kNoKey
                                           || g > zero_pack_gid(zero))
                            ? -0.0f : sc;
        a.out_top_inter[rank] = max(0, itr[i]);
      }
    }
    base += s_tot[0];
    n_above += s_tot[1];
    if (base >= a.k) break;            // uniform: every later rank is >= k
  }
  if (!a.final_level) {                // a chunk with fewer than k groups
    for (int r = base + tid; r < a.k; r += nthreads) {
      a.out_key[static_cast<int64_t>(blockIdx.x) * a.k + r] = kNoKey;
      a.out_inter[static_cast<int64_t>(blockIdx.x) * a.k + r] = INT_MIN;
    }
    return;
  }
  // the rounds after every group above -2.0 is taken (n_above is exact
  // when it is below k: those groups sort first)
  for (int r = (none ? 1 : n_above) + tid; r < a.k; r += nthreads) {
    a.out_gidx[r] = w_gid;
    a.out_score[r] = -2.0f;
    a.out_top_inter[r] = w_inter;
  }
}

int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int select_threads(int pow2) {
  const int t = pow2 / 2;
  return t < 32 ? 32 : (t > kSelectThreads ? kSelectThreads : t);
}

// How the labelled select runs: one block sorting in shared memory up to
// kIdsChunk entries; past that, levels of kIdsChunk-entry chunks when k <=
// kIdsChunk / 2 (each level keeps every chunk's k best groups, so the
// entries at least halve) and a final block over what remains; else one
// block sorting all entries in `work`.  The scratch is the first level's
// packs and zero packs and two levels of chunk lists, or the global sort
// buffer.
struct IdsPlan {
  int64_t n_chunks;        // first-level chunks (0: one block)
  int64_t list;            // entries of a level's chunk lists
  int64_t global_sort;     // entries of the global sort buffer, or 0
};

IdsPlan ids_plan(int64_t n, int k) {
  IdsPlan plan{0, 0, 0};
  if (n <= kIdsChunk) return plan;
  if (k <= kIdsChunk / 2) {
    plan.n_chunks = (n + kIdsChunk - 1) / kIdsChunk;
    plan.list = plan.n_chunks * k;
  } else {
    plan.global_sort = pow2_at_least(n);
  }
  return plan;
}

size_t ids_workspace(const IdsPlan& plan) {
  return 2 * sizeof(u64) * plan.n_chunks
         + (sizeof(u64) + sizeof(int32_t)) * (2 * plan.list
                                              + plan.global_sort);
}

cudaError_t launch_ids(bool raw, const SelectIds& a, int blocks,
                       cudaStream_t stream) {
  const bool shared = a.buf_key == nullptr;       // at most 12 KB
  const size_t smem = shared ? (sizeof(u64) + sizeof(int32_t)) * a.pow2 : 0;
  const int threads = shared ? select_threads(a.pow2) : kSelectThreads;
  if (raw) {
    select_ids_kernel<true><<<blocks, threads, smem, stream>>>(a);
  } else {
    select_ids_kernel<false><<<blocks, threads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// rows (n_rows, 2048) int32, row_col (n_rows,) int32, starts (n_cand + 1,)
// int32, q_words (n_cols, 2048) int32, cards (n_cand,) int32; outputs score
// (n_cand,) float32 and inter (n_cand,) int32.  metric: 0 jaccard, 1 cosine,
// 2 containment.  exclude: a candidate scored -1.0, or -1 for none.  Row
// pointers must be 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int similarity_score_cuda(const void* rows, int64_t n_rows,
                                     const void* row_col, const void* starts,
                                     int n_cand, const void* q_words,
                                     int64_t n_cols, int q_card,
                                     const void* cards, int exclude,
                                     int metric, void* score, void* inter,
                                     void* stream) {
  if (n_cand <= 0) return 0;
  if (metric < kJaccard || metric > kContainment || n_cols < 1 ||
      q_card < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  score_kernel<<<n_cand, kScoreThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), n_rows,
      static_cast<const int32_t*>(row_col),
      static_cast<const int32_t*>(starts),
      static_cast<const uint4*>(q_words), n_cols, q_card,
      static_cast<const int32_t*>(cards), exclude, metric,
      static_cast<float*>(score), static_cast<int32_t*>(inter));
  return static_cast<int>(cudaGetLastError());
}

// score (n,) float32 and inter (n,) int32 in; work: kept for the
// interface, unused (the rank select needs no scratch; may be null);
// out_idx (k,) int32, out_score (k,) float32, out_inter (k,) int32 out.
// 1 <= k <= n.  One launch.  Returns the cudaError_t of the launch.
extern "C" int similarity_select_cuda(const void* score, const void* inter,
                                      int n, int k, void* work,
                                      void* out_idx, void* out_score,
                                      void* out_inter, void* stream) {
  (void)work;
  if (n < 1 || k < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n + kRankWarps - 1)
                                                / kRankWarps);
  rank_select_kernel<<<blocks, kRankThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const int32_t*>(inter),
      n, k, static_cast<int32_t*>(out_idx), static_cast<float*>(out_score),
      static_cast<int32_t*>(out_inter));
  return static_cast<int>(cudaGetLastError());
}

// table (n_table, 2048) int32 (a shard's slab), pos and row_col (n_pos,)
// int32, starts (n_slots + 1,) int32 offsets into pos, q_words (n_cols,
// 2048) int32, cards and gidx (n_slots,) int32; outputs score (n_slots,)
// float32 and inter (n_slots,) int32.  exclude: a global id scored -1.0
// (-1: none); slots >= n_valid score -2.0.  Row pointers must be 16-byte
// aligned.  Returns the cudaError_t of the launch.
extern "C" int similarity_score_ids_cuda(
    const void* table, int64_t n_table, const void* pos, const void* row_col,
    int64_t n_pos, const void* starts, int n_slots, const void* q_words,
    int64_t n_cols, int q_card, const void* cards, const void* gidx,
    int n_valid, int exclude, int metric, void* score, void* inter,
    void* stream) {
  if (n_slots <= 0) return 0;
  if (metric < kJaccard || metric > kContainment || n_cols < 1 ||
      n_table < 1 || q_card < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  score_ids_kernel<<<n_slots, kScoreThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), n_table,
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(row_col),
      n_pos, static_cast<const int32_t*>(starts),
      static_cast<const uint4*>(q_words), n_cols, q_card,
      static_cast<const int32_t*>(cards), static_cast<const int32_t*>(gidx),
      n_valid, exclude, metric, static_cast<float*>(score),
      static_cast<int32_t*>(inter));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch `similarity_select_ids_cuda` needs for n entries and k.
extern "C" size_t similarity_select_ids_workspace(int64_t n, int k) {
  return n < 1 || k < 1 ? 0 : ids_workspace(ids_plan(n, k));
}

// score (n,) float32, inter and gidx (n,) int32 in; work: the scratch
// `similarity_select_ids_workspace` sizes (null when it is 0); out_gidx
// (k,) int32, out_score (k,) float32, out_inter (k,) int32 out.  n >= 1,
// k >= 1 (k may exceed n).  One launch up to 1,024 entries; past that, a
// launch a level for k <= 512, else one block sorting in `work` (see
// IdsPlan).  Returns the cudaError_t of the launches.
extern "C" int similarity_select_ids_cuda(const void* score,
                                          const void* inter,
                                          const void* gidx, int64_t n, int k,
                                          void* work, void* out_gidx,
                                          void* out_score, void* out_inter,
                                          void* stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const IdsPlan plan = ids_plan(n, k);
  if (ids_workspace(plan) > 0 && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SelectIds a{};
  a.score = static_cast<const float*>(score);
  a.inter = static_cast<const int32_t*>(inter);
  a.gidx = static_cast<const int32_t*>(gidx);
  a.n = n;
  a.k = k;
  a.out_gidx = static_cast<int32_t*>(out_gidx);
  a.out_score = static_cast<float*>(out_score);
  a.out_top_inter = static_cast<int32_t*>(out_inter);
  a.final_level = 1;
  if (plan.n_chunks == 0) {            // one block: shared, or global sort
    a.chunk = static_cast<int>(n);
    a.pow2 = pow2_at_least(n);
    if (plan.global_sort > 0) {
      a.buf_key = static_cast<u64*>(work);
      a.buf_inter = reinterpret_cast<int32_t*>(a.buf_key + a.pow2);
    }
    return static_cast<int>(launch_ids(true, a, 1, st));
  }
  u64* packs = static_cast<u64*>(work);
  u64* zero_packs = packs + plan.n_chunks;
  u64* keys[2] = {zero_packs + plan.n_chunks,
                  zero_packs + plan.n_chunks + plan.list};
  int32_t* inters[2] = {reinterpret_cast<int32_t*>(keys[1] + plan.list),
                        nullptr};
  inters[1] = inters[0] + plan.list;
  // first level: raw entries -> every chunk's k best groups and its pack
  SelectIds lvl = a;
  lvl.final_level = 0;
  lvl.chunk = kIdsChunk;
  lvl.pow2 = kIdsChunk;
  lvl.packs = packs;
  lvl.zero_packs = zero_packs;
  lvl.out_key = keys[0];
  lvl.out_inter = inters[0];
  cudaError_t err = launch_ids(true, lvl, static_cast<int>(plan.n_chunks),
                               st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t m = plan.list;
  int cur = 0;
  while (m > kIdsChunk) {              // k <= kIdsChunk / 2: m halves
    const int64_t blocks = (m + kIdsChunk - 1) / kIdsChunk;
    SelectIds mid = lvl;
    mid.score = nullptr;
    mid.in_key = keys[cur];
    mid.in_inter = inters[cur];
    mid.n = m;
    mid.out_key = keys[1 - cur];
    mid.out_inter = inters[1 - cur];
    err = launch_ids(false, mid, static_cast<int>(blocks), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    m = blocks * k;
    cur = 1 - cur;
  }
  a.in_key = keys[cur];
  a.in_inter = inters[cur];
  a.n = m;
  a.chunk = static_cast<int>(m);
  a.pow2 = pow2_at_least(m);
  a.packs = packs;
  a.zero_packs = zero_packs;
  a.n_packs = static_cast<int>(plan.n_chunks);
  return static_cast<int>(launch_ids(false, a, 1, st));
}
