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
// Arithmetic, as the TPU kernel's: the scores are q . k in float32, then
// `* sm_scale`, then `softcap * tanhf(s / softcap)` (when softcap is not
// 0), then -1e30 at positions at or past kv_len.  An online softmax
// carries the running max m, sum l and accumulator acc over the visible
// keys: m_new = max(m, max_j s_j), p_j = expf(s_j - m_new), alpha = expf(m
// - m_new), l = l * alpha + sum_j p_j, acc = acc * alpha + sum_j p_j v_j,
// with float32 weights times float32 values.  Partial states (m, l, acc)
// merge as m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i -
// m).  The output is acc / l, or 0 where l = 0 (nothing visible).  IEEE
// expf, tanhf and division; no fast-math.
//
// What bounds it: bytes.  A block whose bit is clear, or that starts at or
// past kv_len, costs no load at all (the TPU kernel's @pl.when skip); a
// visible block reads its keys below kv_len, rounded up to 8, of K and of
// V once.  The least time is (visible valid K/V rows + q + out + mask
// words + kv_len) bytes over 3.35 TB/s; the FLOPs (4 * g * D a visible
// key) are far below the card's float32 rate.
//
// Design (flash-decoding).  Only g = H / Hkv query rows share a KV row
// (2 for Gemma2), far below a tensor-core tile, so the kernel runs on
// CUDA cores and its speed is the loads it keeps in flight.
//   * Split.  A row's visible keys are cut into chunks of 8 keys, in
//     ascending order, and the chunks into P contiguous ranges of equal
//     count: grid (B * Hkv * ceil(g / GH), P), where a block holds GH of
//     the g query heads and the wrapper picks P from the static shapes
//     (the most that fill one wave of the card).  Each block counts the
//     row's visible blocks with __popc over its mask words cut at kv_len,
//     and the valid keys of the last one, so its range is balanced
//     whatever the mask's shape, and walks the set bits to its first
//     block on the device: the host never reads the mask or kv_len.  A
//     block with an empty range writes an empty partial (m = -1e30, l =
//     0).
//   * Loads in flight.  Each of a block's four warps takes every fourth
//     chunk of the block's range and streams it through its own ring of
//     three shared-memory stages filled by cp.async (16 bytes a lane, K
//     and V rows padded by 16 bytes so the score loads hit 32 banks), so
//     two chunks load while one is computed and no block-wide barrier
//     runs in the loop.
//   * Arithmetic from shared memory.  Scores: four lanes share one key's
//     dot product (16-byte loads, q broadcast from shared memory as
//     float32), reduced with two shuffles; the chunk's max and sum with
//     three more.  PV: each lane owns 8-byte granules of the D columns
//     (4 bf16 or 2 float32 values) and sums the chunk's 8 weights times
//     V in registers.
//   * Merge.  The four warps' states merge in warp order in shared
//     memory.  With P = 1 the block writes acc / l; otherwise it writes
//     its float32 (m, l, acc) to a workspace (B, H, P, D + 2) and a
//     second kernel merges the P partials in ascending p.  No atomics:
//     the same inputs give the same bits on every run.
//
// Interface: plain C functions, bound from Python with ctypes
// (repro_torch/kernels/block_sparse_attn.py).  A call launches one kernel
// (P = 1) or two, on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8;               // keys a warp takes at a time
constexpr int kParts = 32 / kChunk;     // lanes sharing one key's dot
constexpr int kStages = 3;              // a warp's ring of chunks
constexpr int kCombineThreads = 128;
constexpr float kNeg = -1e30f;          // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of a shared-memory row as float32: four floats or eight bf16.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// 8 bytes: two floats or four bf16.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x; out[1] = x.y;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Mask word w with the bits of blocks at or past n_live cleared.
__device__ __forceinline__ uint32_t live_bits(const uint32_t* mrow,
                                              int64_t w, int64_t n_live) {
  uint32_t bits = __ldg(mrow + w);
  const int64_t rest = n_live - w * 32;
  if (rest < 32) bits &= (1u << rest) - 1u;
  return bits;
}

// The visible block of rank r (0-based) below n_live; r < the count.
__device__ int64_t nth_set(const uint32_t* mrow, int64_t n_live, int64_t r) {
  for (int64_t w = 0; w * 32 < n_live; ++w) {
    uint32_t bits = live_bits(mrow, w, n_live);
    const int cnt = __popc(bits);
    if (r < cnt) {
      for (; r > 0; --r) bits &= bits - 1u;
      return w * 32 + __ffs(bits) - 1;
    }
    r -= cnt;
  }
  return n_live;
}

// The first visible block at or after `from`, below n_live.
__device__ int64_t next_set(const uint32_t* mrow, int64_t n_live,
                            int64_t from) {
  for (int64_t w = from >> 5; w * 32 < n_live; ++w) {
    uint32_t bits = live_bits(mrow, w, n_live);
    if (w == (from >> 5)) bits &= ~0u << (from & 31);
    if (bits) return w * 32 + __ffs(bits) - 1;
  }
  return n_live;
}

__host__ __device__ inline size_t row_bytes(int d, int esz) {
  return static_cast<size_t>(d) * esz + 16;
}

// At most 208,992 bytes (float32, D = 256, GH = 8), under the 227 KB a
// block may opt into; 53,600 at Gemma2's decode shape (four blocks an SM).
size_t smem_bytes(int gh, int d, int esz) {
  const size_t ring = static_cast<size_t>(kWarps) * kStages * 2 * kChunk
                      * row_bytes(d, esz);
  const size_t merge = static_cast<size_t>(kWarps) * gh * (d + 2)
                       * sizeof(float);
  return (ring > merge ? ring : merge)             // the merge reuses it
         + static_cast<size_t>(gh) * d * sizeof(float)      // q rows
         + static_cast<size_t>(kWarps) * gh * kChunk * sizeof(float)
         + static_cast<size_t>(kWarps) * kStages * sizeof(long long);
}

template <typename T, int GH>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const uint32_t* __restrict__ mask,
             const int32_t* __restrict__ kv_len, T* __restrict__ out,
             float* __restrict__ part, int h, int hkv, int n_hc, int64_t s,
             int d, int bs, int n_words, float sm_scale, float softcap) {
  constexpr int kEpv = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int kEpg = 8 / static_cast<int>(sizeof(T));   // per granule
  constexpr int kGpl = 8 / kEpg;       // granules a lane owns at D = 256
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = h / hkv;
  const int hc = blockIdx.x % n_hc;
  const int64_t bk = blockIdx.x / n_hc;              // b * hkv + kv head
  const int64_t b = bk / hkv;
  const int h0 = static_cast<int>(bk % hkv) * g + hc * GH;
  const int gh = min(GH, g - hc * GH);
  const int p = blockIdx.y;
  const int n_split = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t rb = row_bytes(d, sizeof(T));
  const size_t stage = 2 * kChunk * rb;              // K rows, then V rows
  const size_t ring = kWarps * kStages * stage;
  const size_t merge = static_cast<size_t>(kWarps) * GH * (d + 2) * 4;
  float* q_s = reinterpret_cast<float*>(smem + (ring > merge ? ring
                                                             : merge));
  float* p_s = q_s + GH * d;                         // (warps, GH, chunk)
  long long* start_s = reinterpret_cast<long long*>(p_s + kWarps * GH
                                                    * kChunk);

  // q rows as float32; rows past gh are zero, so every loop runs all GH
  const T* qb = q + (b * h + h0) * d;
  for (int i = threadIdx.x; i < GH * d; i += kThreads)
    q_s[i] = i < gh * d ? to_f32(qb[i]) : 0.f;

  // the row's visible blocks below kv_len, and its chunks of 8 valid keys
  const int kvl = kv_len[b];
  const int64_t nblk = s / bs;
  const int64_t reach = (static_cast<int64_t>(kvl) + bs - 1) / bs;
  const int64_t n_live = kvl <= 0 ? 0 : (reach < nblk ? reach : nblk);
  const uint32_t* mrow = mask + b * n_words;
  int64_t n_vis = 0, last = 0;
  for (int64_t w = 0; w * 32 < n_live; ++w) {
    const uint32_t bits = live_bits(mrow, w, n_live);
    n_vis += __popc(bits);
    if (bits) last = w * 32 + 31 - __clz(bits);
  }
  const int cpb = bs / kChunk;
  int64_t n_chunks = 0;
  if (n_vis > 0) {
    const int64_t tail = kvl - last * bs;            // valid keys, last block
    n_chunks = (n_vis - 1) * cpb
               + ((tail < bs ? tail : bs) + kChunk - 1) / kChunk;
  }
  const int64_t c0 = n_chunks * p / n_split;
  const int64_t c1 = n_chunks * (p + 1) / n_split;
  const int64_t first = c0 + warp;                   // this warp's chunks:
  const int my_n = first < c1                        // first + 4 i < c1
      ? static_cast<int>((c1 - first + kWarps - 1) / kWarps) : 0;

  float m[GH], l[GH], acc[GH][8];
#pragma unroll
  for (int hh = 0; hh < GH; ++hh) {
    m[hh] = kNeg;
    l[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[hh][i] = 0.f;
  }
  __syncthreads();                                   // q_s

  const int nv = d * static_cast<int>(sizeof(T)) / 16;   // vectors a row
  const int ng = d / kEpg;                               // granules a row
  unsigned char* wring = smem + warp * kStages * stage;
  const T* kh = k + bk * s * d;
  const T* vh = v + bk * s * d;
  int64_t br = 0, blk = 0;                           // loader's block
  if (my_n > 0) {
    br = first / cpb;
    blk = nth_set(mrow, n_live, br);
  }
  auto issue = [&](int i) {                          // chunk i -> its stage
    if (i < my_n) {
      const int64_t c = first + static_cast<int64_t>(kWarps) * i;
      while (c / cpb > br) {
        ++br;
        blk = next_set(mrow, n_live, blk + 1);
      }
      const int64_t ks = blk * bs + (c % cpb) * kChunk;
      unsigned char* st = wring + (i % kStages) * stage;
      for (int idx = lane; idx < kChunk * nv; idx += 32) {
        const int r = idx / nv;
        const int c16 = idx - r * nv;
        const int64_t off = (ks + r) * d + c16 * kEpv;
        cp_async16(st + r * rb + c16 * 16, kh + off);
        cp_async16(st + (kChunk + r) * rb + c16 * 16, vh + off);
      }
      if (lane == 0) start_s[warp * kStages + i % kStages] = ks;
    }
    cp_async_commit();                               // empty groups too
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  const int key = lane & (kChunk - 1);
  const int part_of = lane / kChunk;
  float* pw = p_s + warp * GH * kChunk;
  for (int i = 0; i < my_n; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();                    // chunk i has landed
    __syncwarp();
    const unsigned char* st = wring + (i % kStages) * stage;
    const int64_t ks = start_s[warp * kStages + i % kStages];

    // scores: four lanes a key, each a quarter of the row's vectors
    const T* krow = reinterpret_cast<const T*>(st + key * rb);
    float dot[GH];
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) dot[hh] = 0.f;
    for (int c16 = part_of; c16 < nv; c16 += kParts) {
      float kf[kEpv];
      load16(krow + c16 * kEpv, kf);
#pragma unroll
      for (int hh = 0; hh < GH; ++hh) {
        const float* qh = q_s + hh * d + c16 * kEpv;
#pragma unroll
        for (int e = 0; e < kEpv; ++e) dot[hh] = fmaf(qh[e], kf[e], dot[hh]);
      }
    }
    float alpha[GH];
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) {
      float x = dot[hh];
      x += __shfl_xor_sync(~0u, x, 8);
      x += __shfl_xor_sync(~0u, x, 16);
      float sc = x * sm_scale;
      if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
      if (ks + key >= kvl) sc = kNeg;
      float mx = sc;
#pragma unroll
      for (int o = 1; o < kChunk; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float m_new = fmaxf(m[hh], mx);
      const float pj = expf(sc - m_new);
      float sum = pj;
#pragma unroll
      for (int o = 1; o < kChunk; o <<= 1)
        sum += __shfl_xor_sync(~0u, sum, o);
      alpha[hh] = expf(m[hh] - m_new);
      l[hh] = l[hh] * alpha[hh] + sum;
      m[hh] = m_new;
      if (part_of == 0) pw[hh * kChunk + key] = pj;
    }
    __syncwarp();

    // acc = acc * alpha + p . v, a lane's granules of the D columns
    const unsigned char* vrows = st + kChunk * rb;
#pragma unroll
    for (int j8 = 0; j8 < kGpl; ++j8) {
      const int gi = lane + 32 * j8;
      if (gi < ng) {
        float vf[kChunk][kEpg];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          load8(reinterpret_cast<const T*>(vrows + j * rb) + gi * kEpg,
                vf[j]);
#pragma unroll
        for (int hh = 0; hh < GH; ++hh) {
#pragma unroll
          for (int e = 0; e < kEpg; ++e) {
            float pv = 0.f;
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              pv = fmaf(pw[hh * kChunk + j], vf[j][e], pv);
            float& a = acc[hh][j8 * kEpg + e];
            a = a * alpha[hh] + pv;
          }
        }
      }
    }
    __syncwarp();                    // the stage and pw are free again
  }
  cp_async_wait<0>();
  __syncthreads();                   // every warp is out of its ring

  // merge the four warps' states in warp order (the ring's space)
  float* mg = reinterpret_cast<float*>(smem);        // (warps, GH, d + 2)
#pragma unroll
  for (int hh = 0; hh < GH; ++hh) {
    float* row = mg + (warp * GH + hh) * (d + 2);
    if (lane == 0) {
      row[0] = m[hh];
      row[1] = l[hh];
    }
#pragma unroll
    for (int j8 = 0; j8 < kGpl; ++j8) {
      const int gi = lane + 32 * j8;
      if (gi < ng) {
#pragma unroll
        for (int e = 0; e < kEpg; ++e)
          row[2 + gi * kEpg + e] = acc[hh][j8 * kEpg + e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gh * d; i += kThreads) {
    const int hh = i / d;
    const int c = i - hh * d;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, mg[(w * GH + hh) * (d + 2)]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = mg + (w * GH + hh) * (d + 2);
      const float f = expf(row[0] - mx);
      lsum += row[1] * f;
      a += row[2 + c] * f;
    }
    const int64_t hrow = b * h + h0 + hh;
    if (n_split == 1) {
      store(out + hrow * d + c, lsum > 0.f ? a / lsum : 0.f);
    } else {
      float* dst = part + (hrow * n_split + p) * (d + 2);
      if (c == 0) {
        dst[0] = mx;
        dst[1] = lsum;
      }
      dst[2 + c] = a;
    }
  }
}

// One block per (sequence, head): the P partials merged in ascending p.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine(const float* __restrict__ part, T* __restrict__ out,
               int n_split, int d) {
  const int64_t row = blockIdx.x;
  const float* pr = part + row * n_split * (d + 2);
  float mx = kNeg;
  for (int p = 0; p < n_split; ++p) mx = fmaxf(mx, pr[p * (d + 2)]);
  float lsum = 0.f;
  for (int p = 0; p < n_split; ++p)
    lsum += pr[p * (d + 2) + 1] * expf(pr[p * (d + 2)] - mx);
  for (int c = threadIdx.x; c < d; c += kCombineThreads) {
    float a = 0.f;
    for (int p = 0; p < n_split; ++p)
      a += pr[p * (d + 2) + 2 + c] * expf(pr[p * (d + 2)] - mx);
    store(out + row * d + c, lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, int GH>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* kv_len, void* out, void* part, int64_t b, int h,
           int hkv, int64_t s, int d, int bs, int n_words, int n_split,
           float sm_scale, float softcap, cudaStream_t stream) {
  const int n_hc = (h / hkv + GH - 1) / GH;
  const size_t smem = smem_bytes(GH, d, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split<T, GH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(b * hkv * n_hc),
                  static_cast<unsigned>(n_split));
  decode_attention_split<T, GH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint32_t*>(mask),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(out),
      static_cast<float*>(part), h, hkv, n_hc, s, d, bs, n_words, sm_scale,
      softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_attention_combine<T><<<static_cast<unsigned>(b * h),
                                 kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n_split, d);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int gh, const void* q, const void* k, const void* v,
             const void* mask, const void* kv_len, void* out, void* part,
             int64_t b, int h, int hkv, int64_t s, int d, int bs,
             int n_words, int n_split, float sm_scale, float softcap,
             cudaStream_t st) {
  switch (gh) {
    case 1: return launch<T, 1>(q, k, v, mask, kv_len, out, part, b, h, hkv,
                                s, d, bs, n_words, n_split, sm_scale,
                                softcap, st);
    case 2: return launch<T, 2>(q, k, v, mask, kv_len, out, part, b, h, hkv,
                                s, d, bs, n_words, n_split, sm_scale,
                                softcap, st);
    case 4: return launch<T, 4>(q, k, v, mask, kv_len, out, part, b, h, hkv,
                                s, d, bs, n_words, n_split, sm_scale,
                                softcap, st);
    case 8: return launch<T, 8>(q, k, v, mask, kv_len, out, part, b, h, hkv,
                                s, d, bs, n_words, n_split, sm_scale,
                                softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a split block needs, in bytes, for GH query heads
// a block (1, 2, 4 or 8), head dim d and element size esz (2 or 4).
size_t decode_attention_smem(int gh, int d, int esz) {
  return smem_bytes(gh, d, esz);
}

// is_bf16: 1 for bfloat16 tensors, 0 for float32.  gh: query heads a block
// (1, 2, 4 or 8).  n_split: P >= 1; for P > 1, part is float32 scratch of
// (B, H, P, D + 2).  Grid: (B * Hkv * ceil(g / gh), P), then B * H blocks
// for the merge when P > 1.
int decode_attention_cuda(const void* q, const void* k, const void* v,
                          const void* mask, const void* kv_len, void* out,
                          void* part, int is_bf16, int64_t b, int h, int hkv,
                          int64_t s, int d, int bs, int n_words, int gh,
                          int n_split, float sm_scale, float softcap,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(gh, q, k, v, mask, kv_len, out, part, b,
                                   h, hkv, s, d, bs, n_words, n_split,
                                   sm_scale, softcap, st);
  return dispatch<float>(gh, q, k, v, mask, kv_len, out, part, b, h, hkv, s,
                         d, bs, n_words, n_split, sm_scale, softcap, st);
}

}  // extern "C"
