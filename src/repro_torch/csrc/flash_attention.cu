// Causal / sliding-window GQA flash attention for Hopper (sm_90a), with a
// plain C entry point loaded through ctypes by
// repro_torch/kernels/flash_attention/kernel.py.
//
//   flash_attention_fwd  replaces repro/kernels/flash_attention/kernel.py
//                        ::_flash_kernel (online softmax over kv tiles;
//                        query rows offset by seq_k - seq_q; l == 0 -> 0)
//
// Semantics follow the Pallas kernel: s = (q . k) * scale in float32 (the
// scale applied after the dot), masked scores at -1e30, running max m,
// sum l and accumulator rescaled by exp(m_prev - m_new), output acc / l
// in q's dtype and 0 where l == 0.
//
// Bound: at the prefill shape (B=1, Hq=24, Hkv=8, S=2048, D=128, bf16,
// causal) the admitted pairs need 4*D flops each, 25.8 GFLOP, 26 us at
// 989 TFLOP/s, against 34 MB of q/k/v/out (10 us at 3.35 TB/s): the
// kernel is bound by operations, i.e. by the tensor cores.
//
// Design (simple and right, not fast yet): a CUDA block owns 64 query
// rows of one (batch, head) and loops over kv tiles of 64 keys inside the
// block, which replaces the TPU grid's sequential kv axis. The loop runs
// only over the column range the causal diagonal and the window admit
// for the block's rows, so tiles wholly above the diagonal or wholly
// outside the window are never visited (exact: a fully masked tile
// leaves m, l and acc unchanged) and causal work halves. Scores and P.V
// run in float32 on the CUDA cores through shared-memory tiles
// (attention_tile.cuh), not on the tensor cores, so the kernel sits far
// above its operations bound: mma/wgmma tiles, TMA staging and a
// persistent schedule are later work.

#include "attention_tile.cuh"

namespace {

using namespace tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
             int Sq, int Sk, int D, int Dv, float scale, int causal,
             int has_window, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, D, Dv);
  const int bh = blockIdx.y;                   // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int off = Sk - Sq;                     // query i sits at i + off
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int i = q0 + r;
    const bool ok = i < Sq;
    sm.rows->q_off[r] = ok ? ((long long)bh * Sq + i) * D : -1;
    sm.rows->o_off[r] = ok ? ((long long)bh * Sq + i) * Dv : -1;
    sm.rows->abs_pos[r] = i + off;
    sm.rows->m[r] = kNegInf;
    sm.rows->l[r] = 0.f;
  }
  __syncthreads();
  load_q(q, sm, D);

  // the columns any row of this block admits: [lo, hi)
  const int first = q0 + off;
  const int last = min(q0 + kRows, Sq) - 1 + off;
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, last + 1);
  if (has_window) lo = max(0, first - window + 1);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const long long kv0 = ((long long)b * Hkv + hk) * Sk;
  for (int c0 = lo; c0 < hi; c0 += kCols) {
    const int ncols = min(kCols, hi - c0);
    __syncthreads();                           // kv buffer is free
    load_tile(k, kv0 + c0, ncols, D, D + 1, sm.kv);
    __syncthreads();
    score_tile(sm, D, scale);
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      float* sr = sm.s + r * (kCols + 1);
      const int pos = sm.rows->abs_pos[r];
      float sv[2];
      bool ok[2];
      float tmax = kNegInf;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        ok[t] = j < ncols && allowed(pos, c0 + j, causal, has_window, window);
        sv[t] = ok[t] ? sr[j] : kNegInf;
        tmax = fmaxf(tmax, sv[t]);
      }
      tmax = warp_max(tmax);
      const float m_prev = sm.rows->m[r];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = ok[t] ? expf(sv[t] - m_new) : 0.f;
        sr[lane + 32 * t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sm.rows->alpha[r] = alpha;
        sm.rows->l[r] = alpha * sm.rows->l[r] + psum;
        sm.rows->m[r] = m_new;
      }
    }
    __syncthreads();                           // scores done with keys
    load_tile(v, kv0 + c0, ncols, Dv, Dv, sm.kv);
    __syncthreads();
    accumulate_pv(sm, acc, Dv, ncols, true);
  }
  __syncthreads();
  emit(sm, acc, out, Dv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int Dv, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  int e = prepare(flash_kernel<T>, smem);
  if (e != 0) return e;
  const dim3 grid((Sq + kRows - 1) / kRows, B * Hq);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk, D, Dv,
      scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: pointers and the stream as void*, shapes as int; returns
// the cudaError_t of the launch (0 = success). q [B,Hq,Sq,D], k [B,Hkv,Sk,D],
// v [B,Hkv,Sk,Dv], out [B,Hq,Sq,Dv], all contiguous; is_bf16 selects
// __nv_bfloat16 inputs and output, else float32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int is_bf16, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int Dv,
                                   float scale, int causal, int has_window,
                                   int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, Dv,
                                 scale, causal, has_window, window, st);
  return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, Dv, scale, causal,
                       has_window, window, st);
}
