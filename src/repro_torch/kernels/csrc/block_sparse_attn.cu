// Roaring block-sparse decode attention for Hopper (sm_90a): one new query
// token per sequence over its KV cache, where a Roaring bitset container
// row says which key/value blocks the token may see.
//
// Replaces the Pallas call of the JAX package's
// src/repro/kernels/block_sparse_attn.py: `decode_attention` at :110
// (`_bsa_kernel`, :32), the paper's data structure on an LLM's decode hot
// path.  q is (B, H, D), k and v are (B, Hkv, S, D), the mask is (B, W)
// 32-bit words (block j in word j >> 5, bit j & 31) and kv_len is (B,).
// The output is (B, H, D) in q's type, bfloat16 or float32.
//
// Arithmetic, in the TPU kernel's order: the scores are q . k in float32,
// then `* sm_scale`, then `softcap * tanhf(s / softcap)` (when softcap is
// not 0), then -1e30 at positions at or past kv_len.  An online softmax
// carries the running max m, sum l and accumulator acc over the visible
// blocks in ascending order: m_new = max(m, max_j s_j), p_j = expf(s_j -
// m_new), alpha = expf(m - m_new), l = l * alpha + sum_j p_j, acc = acc *
// alpha + sum_j p_j v_j, with float32 weights times float32 values.  The
// output is acc / l, or 0 where l = 0 (nothing visible).  IEEE expf, tanhf
// and division; no fast-math.
//
// What bounds it: bytes.  A block whose bit is clear, or that starts at or
// past kv_len, costs no load at all (the TPU kernel's @pl.when skip); a
// visible block reads bs * D elements of K and of V once.  The least time is
// (visible valid K/V blocks + q + out + mask words + kv_len) bytes over
// 3.35 TB/s; the FLOPs (4 * g * D a visible key) are far below the card's
// float32 rate.
//
// Design, simple first: one block of 256 threads per (sequence, KV head),
// so the g = H / Hkv query heads that share a KV head share its loads.  The
// block stages those g query rows in shared memory as float32 and walks the
// row's mask words, taking the set bits with __ffs in ascending order and
// stopping at the first block past kv_len.  Per visible block, three
// steps with a barrier after each: every thread scores (head, key) pairs
// (the K row read with 16-byte loads, 8 in flight; the q row broadcast
// from shared memory); one warp per head reduces the max and the sum; every
// thread sums p_j * v_j for (head, column) pairs over the block's keys (a
// warp reads 32 neighbouring columns of a V row, 32 rows in flight).  The
// loads a block keeps in flight set its speed, since the card holds only
// B * Hkv blocks at the live shape.  Splitting a row's blocks across
// blocks (flash-decoding), TMA and wgmma are for a later change.
//
// Interface: a plain C function, bound from Python with ctypes
// (repro_torch/kernels/block_sparse_attn.py).  It launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;          // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of a row as float32: four floats or eight bfloat16.
template <typename T>
constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

size_t smem_bytes(int g, int d, int bs) {
  // q rows, accumulators, one block's scores, then m, l and alpha
  return sizeof(float) * (2 * static_cast<size_t>(g) * d
                          + static_cast<size_t>(g) * bs + 3 * g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint32_t* __restrict__ mask,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, int h, int hkv, int64_t s, int d,
                        int bs, int n_words, float sm_scale, float softcap) {
  extern __shared__ float smem[];
  const int g = h / hkv;
  const int64_t b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  float* q_s = smem;                  // (g, d)
  float* acc_s = q_s + g * d;         // (g, d)
  float* p_s = acc_s + g * d;         // (g, bs): scores, then weights
  float* m_s = p_s + g * bs;          // (g,)
  float* l_s = m_s + g;               // (g,)
  float* alpha_s = l_s + g;           // (g,)

  const int64_t q_off = (b * h + static_cast<int64_t>(kvh) * g) * d;
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    q_s[i] = to_f32(q[q_off + i]);
    acc_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int kvl = kv_len[b];
  const int64_t nblk = s / bs;
  // blocks that start below kv_len: none past them is ever read
  const int64_t reach = (static_cast<int64_t>(kvl) + bs - 1) / bs;
  const int64_t n_live = kvl <= 0 ? 0 : (reach < nblk ? reach : nblk);
  const int64_t head_off = (b * hkv + kvh) * s * d;
  const T* kh = k + head_off;
  const T* vh = v + head_off;
  const uint32_t* mrow = mask + b * n_words;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int64_t w = 0; w * 32 < n_live; ++w) {
    uint32_t bits = mrow[w];
    const int64_t rest = n_live - w * 32;
    if (rest < 32) bits &= (1u << rest) - 1u;
    while (bits) {                      // uniform over the block
      const int64_t start = (w * 32 + __ffs(bits) - 1) * bs;
      bits &= bits - 1u;

      // scores: one (head, key) pair per thread at a time
      for (int idx = threadIdx.x; idx < g * bs; idx += kThreads) {
        const int hh = idx / bs;
        const int j = idx - hh * bs;
        const T* krow = kh + (start + j) * d;
        const float* qh = q_s + hh * d;
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < d; c += kPerVec<T>) {
          float kv[kPerVec<T>];
          load_vec(krow + c, kv);
#pragma unroll
          for (int e = 0; e < kPerVec<T>; ++e)
            dot = fmaf(qh[c + e], kv[e], dot);
        }
        float sc = dot * sm_scale;
        if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
        p_s[idx] = start + j < kvl ? sc : kNeg;
      }
      __syncthreads();

      // online softmax statistics, one warp per head
      for (int hh = warp; hh < g; hh += kWarps) {
        float* ph = p_s + hh * bs;
        float mx = kNeg;
        for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, ph[j]);
        const float m_old = m_s[hh];
        const float m_new = fmaxf(m_old, warp_max(mx));
        float sum = 0.f;
        for (int j = lane; j < bs; j += 32) {
          const float p = expf(ph[j] - m_new);
          ph[j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          l_s[hh] = l_s[hh] * alpha + sum;
          m_s[hh] = m_new;
          alpha_s[hh] = alpha;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p . v: one (head, column) pair per thread
      for (int idx = threadIdx.x; idx < g * d; idx += kThreads) {
        const int hh = idx / d;
        const float* ph = p_s + hh * bs;
        const T* vcol = vh + start * d + (idx - hh * d);
        float pv = 0.f;
#pragma unroll 32
        for (int j = 0; j < bs; ++j)
          pv = fmaf(ph[j], to_f32(vcol[static_cast<int64_t>(j) * d]), pv);
        acc_s[idx] = acc_s[idx] * alpha_s[hh] + pv;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const float l = l_s[i / d];
    store(out + q_off + i, l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* kv_len, void* out, int64_t b, int h, int hkv,
           int64_t s, int d, int bs, int n_words, float sm_scale,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(h / hkv, d, bs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<T><<<static_cast<unsigned>(b * hkv), kThreads,
                               smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint32_t*>(mask),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(out), h, hkv, s,
      d, bs, n_words, sm_scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (the wrapper refuses
// shapes above the card's 227 KB).
size_t decode_attention_smem(int g, int d, int bs) {
  return smem_bytes(g, d, bs);
}

// is_bf16: 1 for bfloat16 tensors, 0 for float32.  Grid: B * Hkv blocks.
int decode_attention_cuda(const void* q, const void* k, const void* v,
                          const void* mask, const void* kv_len, void* out,
                          int is_bf16, int64_t b, int h, int hkv, int64_t s,
                          int d, int bs, int n_words, float sm_scale,
                          float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, kv_len, out, b, h, hkv, s, d,
                                 bs, n_words, sm_scale, softcap, st);
  return launch<float>(q, k, v, mask, kv_len, out, b, h, hkv, s, d, bs,
                       n_words, sm_scale, softcap, st);
}

}  // extern "C"
