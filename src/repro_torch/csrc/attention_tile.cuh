// Shared tile machinery of the prefill attention kernels
// (flash_attention.cu, a3_attention.cu) for Hopper (sm_90a).
//
// A CUDA block of kThreads threads owns kRows query rows; each row has
// its own q/output offset and absolute position, so a kernel can gather
// rows from several query heads (the GQA group folded into the rows).
// The block walks key/value sub-tiles of up to kCols rows: it stages the
// keys in shared memory, forms the [kRows, kCols] float32 score tile on
// a 16 x 16 thread grid (each thread 4 rows x 4 columns), lets one warp
// per row apply the masks and the softmax arithmetic, then stages the
// values in the same buffer and accumulates P.V in registers (each
// thread 4 rows x NC value columns, tx + 16 c: NC = 8 for Dv up to 128,
// 16 up to 256; kernels pick NC on the host with value_cols). Everything
// is float32 on the
// CUDA cores: bf16 inputs are widened on load (exact), as the Pallas
// kernels widen them to float32 before their dots.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;        // query rows per CUDA block
constexpr int kCols = 64;        // key rows per sub-tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;

// Value columns a thread holds for a value width Dv (at most 256).
inline int value_cols(int Dv) { return Dv > 128 ? 16 : 8; }

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

// Per-row bookkeeping in shared memory.
struct Rows {
  long long q_off[kRows];     // element offset of the row's q (-1: no row)
  long long o_off[kRows];     // element offset of the row's output row
  int abs_pos[kRows];         // absolute position (causal / window)
  float m[kRows];             // running or final row max
  float l[kRows];             // running sum
  float alpha[kRows];         // this tile's rescale factor
};

// Shared memory: Rows, then q [kRows][D+1], then one [kCols][max(D+1,Dv)]
// buffer for keys (stride D+1) and then values (stride Dv), then the
// score tile [kRows][kCols+1]. The +1 strides keep the column reads of
// the score loop free of bank conflicts.
__host__ __device__ inline size_t smem_bytes(int D, int Dv) {
  const int kv = (D + 1) > Dv ? (D + 1) : Dv;
  return sizeof(Rows) +
         sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kCols * kv +
                          (size_t)kRows * (kCols + 1));
}

struct Smem {
  Rows* rows;
  float* q;
  float* kv;
  float* s;
};

__device__ inline Smem carve(unsigned char* base, int D, int Dv) {
  Smem sm;
  sm.rows = reinterpret_cast<Rows*>(base);
  sm.q = reinterpret_cast<float*>(base + sizeof(Rows));
  sm.kv = sm.q + (size_t)kRows * (D + 1);
  const int kv = (D + 1) > Dv ? (D + 1) : Dv;
  sm.s = sm.kv + (size_t)kCols * kv;
  return sm;
}

__device__ __forceinline__ bool allowed(int row_abs, int col, int causal,
                                        int has_window, int window) {
  if (causal && col > row_abs) return false;
  if (has_window && col <= row_abs - window) return false;
  return true;
}

// q rows into sm.q (zero for rows without a query).
template <typename T>
__device__ void load_q(const T* __restrict__ q, const Smem& sm, int D) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long off = sm.rows->q_off[r];
    sm.q[r * (D + 1) + d] = off >= 0 ? to_f32(q[off + d]) : 0.f;
  }
}

// ncols rows of a [*, width] matrix starting at row0 into sm.kv with the
// given shared stride (zero past ncols).
template <typename T>
__device__ void load_tile(const T* __restrict__ x, long long row0, int ncols,
                          int width, int stride, float* dst) {
  for (int i = threadIdx.x; i < kCols * width; i += kThreads) {
    const int j = i / width, d = i % width;
    dst[j * stride + d] =
        j < ncols ? to_f32(x[(row0 + j) * (long long)width + d]) : 0.f;
  }
}

// sm.s[r][j] = scale * (q_r . k_j) for the staged keys.
__device__ void score_tile(const Smem& sm, int D, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  const float* qrow = sm.q + (ty * 4) * (D + 1);
  const float* krow = sm.kv + tx * (D + 1);
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qrow[i * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = krow[(16 * c) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] += qv[i] * kv[c];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sm.s[(ty * 4 + i) * (kCols + 1) + tx + 16 * c] = acc[i][c] * scale;
}

// acc[i][c] (row ty*4+i, value column tx+16c) += sum_j p[row][j] v[j][col]
// over the first ncols staged value rows; with rescale, acc is first
// multiplied by each row's alpha.
template <int NC>
__device__ void accumulate_pv(const Smem& sm, float (&acc)[4][NC], int Dv,
                              int ncols, bool rescale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (rescale) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sm.rows->alpha[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
  }
  for (int j = 0; j < ncols; ++j) {
    float p[4], vv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = sm.s[(ty * 4 + i) * (kCols + 1) + j];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      vv[c] = col < Dv ? sm.kv[j * Dv + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += p[i] * vv[c];
  }
}

// out[row] = l == 0 ? 0 : acc / l, in the output type.
template <int NC, typename T>
__device__ void emit(const Smem& sm, const float (&acc)[4][NC],
                     T* __restrict__ out, int Dv) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (sm.rows->q_off[r] < 0) continue;
    const float l = sm.rows->l[r];
    const long long o = sm.rows->o_off[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) out[o + col] = from_f32<T>(l == 0.f ? 0.f : acc[i][c] / l);
    }
  }
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

}  // namespace tile
