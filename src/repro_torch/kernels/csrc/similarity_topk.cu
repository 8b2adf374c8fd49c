// Similarity top-k for Hopper (sm_90a): a score kernel and a select kernel,
// two launches.
//
// Replaces the two Pallas calls of the JAX package's `similarity_topk` in
// src/repro/kernels/topk_ops.py: the score stage at :147 (`_score_kernel`,
// :58) and the select stage at :166 (`_select_kernel`, :86).
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
// Select.  k rounds of a block-wide (max, lowest index of the max) over the
// T scores; each round records idx, score and inter of the winner and
// masks it with -2.0.  That is the order of a stable descending sort: ties
// go to the lowest index.  It is bound by the latency of k block-wide
// reductions, not by bytes (8 bytes a candidate read, 12 a result written):
// one block of 1024 threads, each scanning a strided share of a scratch
// copy of the scores (L1-resident at this slice's T = 1,024), warp shuffles
// and one shared-memory step per round.  Scores are never NaN.
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

// (value, index) pair that wins: the larger value, then the lower index;
// index INT_MAX marks a thread that saw no candidate and always loses.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (oi != INT_MAX && (i == INT_MAX || ov > v || (ov == v && oi < i))) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const float* __restrict__ score,
              const int32_t* __restrict__ inter, int n, int k,
              float* work, int32_t* __restrict__ out_idx,
              float* __restrict__ out_score,
              int32_t* __restrict__ out_inter) {
  __shared__ float s_val[kSelectThreads / 32];
  __shared__ int s_idx[kSelectThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n; i += kSelectThreads) work[i] = score[i];
  __syncthreads();
  for (int round = 0; round < k; ++round) {
    float v = 0.0f;
    int bi = INT_MAX;
    // indices rise along a thread's stride, so a strict > keeps the lowest
    for (int i = threadIdx.x; i < n; i += kSelectThreads) {
      const float x = work[i];
      if (bi == INT_MAX || x > v) {
        v = x;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      better(v, bi, ov, oi);
    }
    if (lane == 0) {
      s_val[warp] = v;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      v = s_val[lane];
      bi = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        better(v, bi, ov, oi);
      }
      if (lane == 0) {
        out_idx[round] = bi;
        out_score[round] = score[bi];
        out_inter[round] = inter[bi];
        work[bi] = -2.0f;
      }
    }
    __syncthreads();
  }
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

// score (n,) float32 and inter (n,) int32 in; work (n,) float32 scratch;
// out_idx (k,) int32, out_score (k,) float32, out_inter (k,) int32 out.
// 1 <= k <= n.  Returns the cudaError_t of the launch.
extern "C" int similarity_select_cuda(const void* score, const void* inter,
                                      int n, int k, void* work,
                                      void* out_idx, void* out_score,
                                      void* out_inter, void* stream) {
  if (n < 1 || k < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  select_kernel<<<1, kSelectThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const int32_t*>(inter),
      n, k, static_cast<float*>(work), static_cast<int32_t*>(out_idx),
      static_cast<float*>(out_score), static_cast<int32_t*>(out_inter));
  return static_cast<int>(cudaGetLastError());
}
