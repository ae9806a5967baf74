// Decode attention with A^3 masking for Hopper (sm_90a): one new query
// per sequence against an S-row KV ring, GQA group as the rows of a
// [G, block_k] score tile. Three kernels, each with a plain C entry point
// (loaded through ctypes by repro_torch/kernels/decode_attention/kernel.py):
//
//   decode_attention_fused   replaces repro/kernels/decode_attention/kernel.py
//                            ::_fused_kernel (single-pass online softmax,
//                            threshold against the running max)
//   decode_attention_rowmax  replaces ::_rowmax_kernel (exact_two_pass
//                            pass 1: masked row max)
//   decode_attention_attend  replaces ::_attend_kernel (pass 2: drop
//                            s < rowmax - t, exp-sum, P.V)
//
// Semantics follow the Pallas kernels exactly: scores are q.k * scale in
// float32, masked scores read -1e30 (not -inf), the running max advances
// once per block_k tile (so the fused threshold keeps the same set as the
// Pallas kernel at the same block_k, and the exact rule when S <= block_k),
// and a row with no kept entry outputs 0.
//
// Bound: decode attention reads the K/V ring once, so it is bound by
// device-memory bytes. At the serving path's shape (B=4, Hkv=8, S=512,
// D=128, bf16) that is 4*8*512*128*2 B * 2 = 8.4 MB per launch, about
// 2.5 us at 3.35 TB/s.
//
// Design (simple and right, not fast yet): one thread block per
// (batch, kv head) walks the ring tile by tile. A warp scores one key row
// against all G query rows (the key row is read once into registers and
// reduced over D with warp shuffles), the [G, block_k] float32 tile sits
// in shared memory (6 KB at G=3, block_k=512), one warp per query row
// reduces the tile max, applies mask, threshold and exp, and all threads
// then accumulate P.V for their (row, column) pairs with the
// exp(m_prev - m_cur) rescale. At the serving shape only B*Hkv = 32
// blocks run, a quarter of the H100's 132 SMs, and loads are plain
// global reads: a split-S grid with cp.async/TMA staging is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;   // a lane holds kMaxD / 32 key values

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// s_s[g * bk + j] = scale * (q_g . k_j) for the bk key rows at krows.
template <typename T>
__device__ void score_tile(const float* q_s, const T* __restrict__ krows,
                           float* s_s, int G, int D, int bk, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < bk; j += kWarps) {
    const T* krow = krows + (size_t)j * D;
    float kr[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < D ? to_f32(krow[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * D;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc += qg[d] * kr[i];
      }
      acc = warp_sum(acc);
      if (lane == 0) s_s[g * bk + j] = acc * scale;
    }
  }
}

// acc_s[g, dv] = acc_s[g, dv] * alpha_g + sum_j p[g, j] * v[j, dv]
// (alpha_s == nullptr: no rescale)
template <typename T>
__device__ void accumulate_pv(const float* p_s, const T* __restrict__ vrows,
                              float* acc_s, const float* alpha_s, int G,
                              int Dv, int bk) {
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
    const int g = i / Dv, dv = i % Dv;
    const float* pg = p_s + g * bk;
    float sum = 0.f;
    for (int j = 0; j < bk; ++j)
      sum += pg[j] * to_f32(vrows[(size_t)j * Dv + dv]);
    const float a = alpha_s != nullptr ? alpha_s[g] : 1.f;
    acc_s[i] = acc_s[i] * a + sum;
  }
}

template <typename T>
__device__ void load_q(const T* __restrict__ q, float* q_s, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) q_s[i] = to_f32(q[i]);
}

template <typename T>
__device__ void emit(const float* acc_s, const float* l_s, T* __restrict__ out,
                     int G, int Dv) {
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
    const float l = l_s[i / Dv];
    out[i] = from_f32<T>(l == 0.f ? 0.f : acc_s[i] / l);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const uint8_t* __restrict__ mask,
             T* __restrict__ out, int Hq, int Hkv, int S, int D, int Dv,
             int bk, float scale, int has_thr, float thr) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* q_s = smem;              // [G, D]
  float* s_s = q_s + G * D;       // [G, bk] scores, then probabilities
  float* acc_s = s_s + G * bk;    // [G, Dv]
  float* m_s = acc_s + G * Dv;    // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* a_s = l_s + G;           // [G] this tile's rescale factor
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;   // first query row
  const size_t kv0 = ((size_t)b * Hkv + h) * S;         // first ring row
  load_q(q + row0 * D, q_s, G, D);
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += bk) {
    score_tile(q_s, k + (kv0 + t0) * D, s_s, G, D, bk, scale);
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const uint8_t* mg = mask + (row0 + g) * S + t0;
      float* sg = s_s + g * bk;
      float tmax = kNegInf;
      for (int j = lane; j < bk; j += 32) {
        const float sv = mg[j] ? sg[j] : kNegInf;
        sg[j] = sv;
        tmax = fmaxf(tmax, sv);
      }
      tmax = warp_max(tmax);
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float sv = sg[j];
        bool keep = mg[j] != 0;
        if (has_thr) keep = keep && (sv >= m_cur - thr);
        const float p = keep ? expf(sv - m_cur) : 0.f;
        sg[j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_cur;
      }
    }
    __syncthreads();
    accumulate_pv(s_s, v + (kv0 + t0) * Dv, acc_s, a_s, G, Dv, bk);
    __syncthreads();
  }
  emit(acc_s, l_s, out + row0 * Dv, G, Dv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowmax_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const uint8_t* __restrict__ mask, float* __restrict__ rowmax,
              int Hq, int Hkv, int S, int D, int bk, float scale) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* q_s = smem;              // [G, D]
  float* s_s = q_s + G * D;       // [G, bk]
  float* m_s = s_s + G * bk;      // [G]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;
  const size_t kv0 = ((size_t)b * Hkv + h) * S;
  load_q(q + row0 * D, q_s, G, D);
  for (int g = threadIdx.x; g < G; g += kThreads) m_s[g] = kNegInf;
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += bk) {
    score_tile(q_s, k + (kv0 + t0) * D, s_s, G, D, bk, scale);
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const uint8_t* mg = mask + (row0 + g) * S + t0;
      const float* sg = s_s + g * bk;
      float tmax = kNegInf;
      for (int j = lane; j < bk; j += 32)
        tmax = fmaxf(tmax, mg[j] ? sg[j] : kNegInf);
      tmax = warp_max(tmax);
      if (lane == 0) m_s[g] = fmaxf(m_s[g], tmax);
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G; g += kThreads) rowmax[row0 + g] = m_s[g];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ mask,
              const float* __restrict__ rowmax, T* __restrict__ out,
              int Hq, int Hkv, int S, int D, int Dv, int bk, float scale,
              int has_thr, float thr) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* q_s = smem;              // [G, D]
  float* s_s = q_s + G * D;       // [G, bk]
  float* acc_s = s_s + G * bk;    // [G, Dv]
  float* l_s = acc_s + G * Dv;    // [G]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;
  const size_t kv0 = ((size_t)b * Hkv + h) * S;
  load_q(q + row0 * D, q_s, G, D);
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += kThreads) l_s[g] = 0.f;
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += bk) {
    score_tile(q_s, k + (kv0 + t0) * D, s_s, G, D, bk, scale);
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const uint8_t* mg = mask + (row0 + g) * S + t0;
      float* sg = s_s + g * bk;
      const float rm = rowmax[row0 + g];
      float psum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float sv = sg[j];
        bool keep = mg[j] != 0;
        if (has_thr) keep = keep && (sv >= rm - thr);
        const float p = keep ? expf(sv - rm) : 0.f;
        sg[j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) l_s[g] += psum;
    }
    __syncthreads();
    accumulate_pv(s_s, v + (kv0 + t0) * Dv, acc_s,
                  static_cast<const float*>(nullptr), G, Dv, bk);
    __syncthreads();
  }
  emit(acc_s, l_s, out + row0 * Dv, G, Dv);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* mask, void* out, int B, int Hq, int Hkv, int S,
                 int D, int Dv, int bk, float scale, int has_thr, float thr,
                 cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)G * bk + (size_t)G * Dv +
                       3 * (size_t)G);
  int e = prepare(fused_kernel<T>, smem);
  if (e != 0) return e;
  fused_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), Hq, Hkv, S, D, Dv, bk, scale, has_thr, thr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rowmax(const void* q, const void* k, const void* mask,
                  void* rowmax, int B, int Hq, int Hkv, int S, int D, int bk,
                  float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)G * bk + (size_t)G);
  int e = prepare(rowmax_kernel<T>, smem);
  if (e != 0) return e;
  rowmax_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const uint8_t*>(mask), static_cast<float*>(rowmax), Hq,
      Hkv, S, D, bk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* mask, const void* rowmax, void* out, int B,
                  int Hq, int Hkv, int S, int D, int Dv, int bk, float scale,
                  int has_thr, float thr, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)G * bk + (size_t)G * Dv +
                       (size_t)G);
  int e = prepare(attend_kernel<T>, smem);
  if (e != 0) return e;
  attend_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(rowmax), static_cast<T*>(out), Hq, Hkv, S, D,
      Dv, bk, scale, has_thr, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: pointers and the stream as void*, shapes as int; each
// returns the cudaError_t of the launch (0 = success). is_bf16 selects
// __nv_bfloat16 inputs and output, else float32; mask is uint8 [B, Hq, S],
// rowmax float32 [B, Hq].
extern "C" {

int decode_attention_fused(const void* q, const void* k, const void* v,
                           const void* mask, void* out, int is_bf16, int B,
                           int Hq, int Hkv, int S, int D, int Dv, int bk,
                           float scale, int has_thr, float thr,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fused<__nv_bfloat16>(q, k, v, mask, out, B, Hq, Hkv, S, D,
                                       Dv, bk, scale, has_thr, thr, st);
  return launch_fused<float>(q, k, v, mask, out, B, Hq, Hkv, S, D, Dv, bk,
                             scale, has_thr, thr, st);
}

int decode_attention_rowmax(const void* q, const void* k, const void* mask,
                            void* rowmax, int is_bf16, int B, int Hq,
                            int Hkv, int S, int D, int bk, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_rowmax<__nv_bfloat16>(q, k, mask, rowmax, B, Hq, Hkv, S, D,
                                        bk, scale, st);
  return launch_rowmax<float>(q, k, mask, rowmax, B, Hq, Hkv, S, D, bk,
                              scale, st);
}

int decode_attention_attend(const void* q, const void* k, const void* v,
                            const void* mask, const void* rowmax, void* out,
                            int is_bf16, int B, int Hq, int Hkv, int S,
                            int D, int Dv, int bk, float scale, int has_thr,
                            float thr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_attend<__nv_bfloat16>(q, k, v, mask, rowmax, out, B, Hq,
                                        Hkv, S, D, Dv, bk, scale, has_thr,
                                        thr, st);
  return launch_attend<float>(q, k, v, mask, rowmax, out, B, Hq, Hkv, S, D,
                              Dv, bk, scale, has_thr, thr, st);
}

}  // extern "C"
