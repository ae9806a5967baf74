// Chunkwise mLSTM forward for Hopper (sm_90a), with a plain C entry point
// loaded through ctypes by repro_torch/kernels/mlstm_chunk/kernel.py.
//
//   mlstm_chunk_fwd  replaces repro/kernels/mlstm_chunk/kernel.py
//                    ::_mlstm_kernel (chunkwise-parallel mLSTM, forward)
//
// Semantics follow the Pallas kernel chunk for chunk, in float32: with
// F the cumulative log forget gate of the chunk, the intra-chunk decay
// D[t,u] = F[t] - F[u] + log_i[u] (u <= t, else -1e30), the row
// stabiliser m_row[t] = max(max_u D[t,u], F[t] + m_prev), the weighted
// scores s = (q . k * scale) * exp(D - m_row), and
//   h = (s V + exp(F + m_prev - m_row) q C)
//       / max(|sum_u s + exp(F + m_prev - m_row) q . n|, exp(-m_row)),
// then the end-of-chunk state update of (C, n, m). Two additions to the
// Pallas kernel, which the model's chunk loop (models/xlstm.py) needs:
// the state may start from a carried (C0, n0, m0) instead of zeros and
// -1e30, and the final state may be written out. h is written in
// float32. A last chunk shorter than L is the Pallas kernel's padded
// chunk without the pad rows: pad rows carry log_i = -1e30, log_f = 0
// and come after every real row, so they change neither a real row's
// output nor the final state.
//
// Bound: at xlstm-350m's prefill shape (B=4, H=4, S=2048, Dk=Dv=256,
// L=256, bf16 streams) one call needs about 12.9 GFLOP (the causal
// q.k and s.V pairs, q.C and the k^T V state update) against 50 MB of
// bf16 q/k/v and 34 MB of float32 h: at 3.35 TB/s and 989 TFLOP/s it is
// bound by the bytes (~25 us).
//
// Design (simple and right, not fast yet). The Pallas kernel keeps the
// whole state in VMEM across the sequential chunk axis; at head_dim 256
// C alone is 256 KB of float32, more than a block's 227 KB of shared
// memory, and the L x L decay tile another 256 KB. So the value columns
// are split across blocks: grid (Dv/64, B*H), each block carrying its
// own 64 columns of C (64 KB) plus the whole n and m through the chunks
// in a loop that replaces the TPU grid's chunk axis. num and the C
// update of a column slice depend only on that slice; den, n and m do
// not depend on Dv, so every block recomputes the chunk's q.k^T over
// the full Dk and gets them whole (4x redundant q.k^T at Dv=256). The
// chunk is walked in 64-row tiles of t and u (tiles above the diagonal
// are skipped: a masked weight is exp(-1e30 - m_row) = 0, and a row
// whose m_row is -1e30 gets h = num / exp(1e30) = 0 either way). All
// products are float32 on the CUDA cores through shared-memory tiles,
// each thread a 4 x 4 register tile of a 64 x 64 product: tensor cores
// (wgmma), a finer split of the grid (64 blocks at B*H=16 leave half of
// the 132 SMs idle) and staging by TMA are later work.

#include "attention_tile.cuh"

namespace {

using tile::kNegInf;
using tile::to_f32;
using tile::warp_max;
using tile::warp_sum;

constexpr int kT = 64;           // rows and columns of a tile; value columns per block
constexpr int kThreads = 256;    // 16 x 16 grid, each thread 4 x 4 of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 256;       // longest chunk
constexpr int kMaxDk = 256;      // widest key head

// Shared memory, all float32:
//   C  [Dk][kT]       this block's columns of the state
//   n  [Dk]
//   a  [kT][W]        q tile, stride Dk+1 (outputs) / v tile, stride kT
//                     (state update); W = max(Dk+1, kT) holds either
//   b  [kT][W]        k tile, then v tile (outputs) / k * wr
//   s  [kT][kT+1]     weighted scores of one (t, u) tile pair
//   gates [5][kMaxL]  F, log_i, m_row, inter weight, wr
//   den [kT], scal [4] (m_prev, m_new, f_eff)
// The +1 strides keep the column reads of the products free of bank
// conflicts; b is followed by s, so the transposed reads of the state
// update may run past b's last row when Dk is not a multiple of 64
// (those products are discarded).
struct Smem {
  float *C, *n, *a, *b, *s, *F, *li, *mrow, *interw, *wr, *den, *scal;
};

__host__ __device__ inline int tile_width(int Dk) {
  return Dk + 1 > kT ? Dk + 1 : kT;
}

__host__ __device__ inline size_t smem_floats(int Dk) {
  return (size_t)Dk * kT + Dk + 2 * (size_t)kT * tile_width(Dk) +
         kT * (kT + 1) + 5 * kMaxL + kT + 4;
}

__device__ inline Smem carve(float* p, int Dk) {
  Smem sm;
  sm.C = p;        p += (size_t)Dk * kT;
  sm.n = p;        p += Dk;
  sm.a = p;        p += (size_t)kT * tile_width(Dk);
  sm.b = p;        p += (size_t)kT * tile_width(Dk);
  sm.s = p;        p += kT * (kT + 1);
  sm.F = p;        p += kMaxL;
  sm.li = p;       p += kMaxL;
  sm.mrow = p;     p += kMaxL;
  sm.interw = p;   p += kMaxL;
  sm.wr = p;       p += kMaxL;
  sm.den = p;      p += kT;
  sm.scal = p;
  return sm;
}

// acc[i][j] += sum_{p < P} A(ty + 16 i, p) * B(p, tx + 16 j), where
// A(r, p) = a[r * lda + p] (a[p * lda + r] when AT) and
// B(p, c) = b[p * ldb + c] (b[c * ldb + p] when BT).
template <bool AT, bool BT>
__device__ __forceinline__ void tile_mma(float acc[4][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int P) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int p = 0; p < P; ++p) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      av[i] = AT ? a[p * lda + r] : a[r * lda + p];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      bv[j] = BT ? b[c * ldb + p] : b[p * ldb + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dst[r * ld + c] = src[r * stride + col0 + c] * scale (* mul[r]) for
// r < nrows, c < ncols; zero for the rest of the kT x width tile.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int stride, int nrows,
                          int col0, int ncols, int width, float* dst, int ld,
                          float scale, const float* mul) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    float x = 0.f;
    if (r < nrows && c < ncols) {
      x = to_f32(src[(long long)r * stride + col0 + c]) * scale;
      if (mul != nullptr) x *= mul[r];
    }
    dst[r * ld + c] = x;
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ log_i,
             const float* __restrict__ log_f, const float* __restrict__ C0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             float* __restrict__ h, float* __restrict__ C_out,
             float* __restrict__ n_out, float* __restrict__ m_out, int S,
             int Dk, int Dv, int L, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, Dk);
  const int bh = blockIdx.y;                   // b * H + h
  const int j0 = blockIdx.x * kT;              // first value column
  const int nj = min(kT, Dv - j0);
  const int QP = Dk + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const T* qb = q + (long long)bh * S * Dk;
  const T* kb = k + (long long)bh * S * Dk;
  const T* vb = v + (long long)bh * S * Dv;
  const float* lib = log_i + (long long)bh * S;
  const float* lfb = log_f + (long long)bh * S;
  float* hb = h + (long long)bh * S * Dv;

  for (int idx = tid; idx < Dk * kT; idx += kThreads) {
    const int r = idx / kT, c = idx % kT;
    sm.C[idx] = (C0 != nullptr && c < nj)
                    ? C0[((long long)bh * Dk + r) * Dv + j0 + c] : 0.f;
  }
  for (int d = tid; d < Dk; d += kThreads)
    sm.n[d] = n0 != nullptr ? n0[(long long)bh * Dk + d] : 0.f;
  if (tid == 0) sm.scal[0] = m0 != nullptr ? m0[bh] : kNegInf;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lc = min(L, S - c0);
    // ---- gates of the chunk ----
    __syncthreads();
    for (int u = tid; u < Lc; u += kThreads) {
      sm.li[u] = lib[c0 + u];
      sm.F[u] = lfb[c0 + u];
    }
    __syncthreads();
    if (tid == 0) {                            // cumulative sum, in order
      float f = 0.f;
      for (int u = 0; u < Lc; ++u) {
        f += sm.F[u];
        sm.F[u] = f;
      }
    }
    __syncthreads();
    const float m_prev = sm.scal[0];
    const float ftot = sm.F[Lc - 1];
    for (int t = tid; t < Lc; t += kThreads) {
      const float ft = sm.F[t];
      float mx = kNegInf;                      // the masked entries' value
      for (int u = 0; u <= t; ++u) mx = fmaxf(mx, ft - sm.F[u] + sm.li[u]);
      const float inter = ft + m_prev;
      const float mr = fmaxf(mx, inter);
      sm.mrow[t] = mr;
      sm.interw[t] = expf(inter - mr);
      sm.wr[t] = ftot - ft + sm.li[t];         // log weight, for now
    }
    __syncthreads();
    if (warp == 0) {
      float mx = kNegInf;
      for (int u = lane; u < Lc; u += 32) mx = fmaxf(mx, sm.wr[u]);
      mx = warp_max(mx);
      if (lane == 0) {
        const float m_new = fmaxf(ftot + m_prev, mx);
        sm.scal[1] = m_new;
        sm.scal[2] = expf(ftot + m_prev - m_new);
      }
    }
    __syncthreads();
    const float m_new = sm.scal[1], f_eff = sm.scal[2];
    for (int u = tid; u < Lc; u += kThreads) sm.wr[u] = expf(sm.wr[u] - m_new);

    // ---- outputs, one tile of 64 rows at a time ----
    for (int t0 = 0; t0 < Lc; t0 += kT) {
      const int nt = min(kT, Lc - t0);
      __syncthreads();                         // a is free
      load_tile(qb + (long long)(c0 + t0) * Dk, Dk, nt, 0, Dk, Dk, sm.a, QP,
                1.f, nullptr);
      __syncthreads();
      float acc[4][4];
      zero(acc);
      tile_mma<false, false>(acc, sm.a, QP, sm.C, kT, Dk);    // q C
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float w = r < nt ? sm.interw[t0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= w;
      }
      for (int r = warp; r < kT; r += kWarps) {                 // q . n
        float x = 0.f;
        for (int d = lane; d < Dk; d += 32) x += sm.a[r * QP + d] * sm.n[d];
        x = warp_sum(x);
        if (lane == 0) sm.den[r] = r < nt ? sm.interw[t0 + r] * x : 0.f;
      }
      for (int u0 = 0; u0 <= t0; u0 += kT) {   // u tiles up to the diagonal
        const int nu = min(kT, Lc - u0);
        __syncthreads();                       // b is free
        load_tile(kb + (long long)(c0 + u0) * Dk, Dk, nu, 0, Dk, Dk, sm.b, QP,
                  scale, nullptr);
        __syncthreads();
        float st[4][4];
        zero(st);
        tile_mma<false, true>(st, sm.a, QP, sm.b, QP, Dk);     // q k^T
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j, u = u0 + c;
            float w = 0.f;
            if (r < nt && c < nu && u <= t)
              w = expf(sm.F[t] - sm.F[u] + sm.li[u] - sm.mrow[t]);
            sm.s[r * (kT + 1) + c] = st[i][j] * w;
          }
        }
        __syncthreads();                       // s written, k read
        for (int r = warp; r < kT; r += kWarps) {
          const float x = warp_sum(sm.s[r * (kT + 1) + lane] +
                                   sm.s[r * (kT + 1) + lane + 32]);
          if (lane == 0) sm.den[r] += x;
        }
        load_tile(vb + (long long)(c0 + u0) * Dv, Dv, nu, j0, nj, kT, sm.b, kT,
                  1.f, nullptr);
        __syncthreads();
        tile_mma<false, false>(acc, sm.s, kT + 1, sm.b, kT, nu);  // s V
      }
      __syncthreads();                         // den complete
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= nt) continue;
        const int t = t0 + r;
        const float den = fmaxf(fabsf(sm.den[r]), expf(-sm.mrow[t]));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < nj) hb[(long long)(c0 + t) * Dv + j0 + c] = acc[i][j] / den;
        }
      }
    }

    // ---- state update to the end of the chunk ----
    __syncthreads();                           // outputs done with C, n
    for (int idx = tid; idx < Dk * kT; idx += kThreads) sm.C[idx] *= f_eff;
    for (int d = tid; d < Dk; d += kThreads) sm.n[d] *= f_eff;
    for (int u0 = 0; u0 < Lc; u0 += kT) {
      const int nu = min(kT, Lc - u0);
      __syncthreads();
      load_tile(kb + (long long)(c0 + u0) * Dk, Dk, nu, 0, Dk, Dk, sm.b, QP,
                scale, sm.wr + u0);            // k * scale * wr
      load_tile(vb + (long long)(c0 + u0) * Dv, Dv, nu, j0, nj, kT, sm.a, kT,
                1.f, nullptr);
      __syncthreads();
      for (int d0 = 0; d0 < Dk; d0 += kT) {    // C[d0:d0+64] += kw^T V
        float acc[4][4];
        zero(acc);
        tile_mma<true, false>(acc, sm.b + d0, QP, sm.a, kT, nu);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = d0 + ty + 16 * i;
          if (r >= Dk) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) sm.C[r * kT + tx + 16 * j] += acc[i][j];
        }
      }
      for (int d = tid; d < Dk; d += kThreads) {
        float x = 0.f;
        for (int u = 0; u < nu; ++u) x += sm.b[u * QP + d];
        sm.n[d] += x;
      }
    }
    __syncthreads();
    if (tid == 0) sm.scal[0] = m_new;
  }
  __syncthreads();

  if (C_out != nullptr) {
    for (int idx = tid; idx < Dk * kT; idx += kThreads) {
      const int r = idx / kT, c = idx % kT;
      if (c < nj) C_out[((long long)bh * Dk + r) * Dv + j0 + c] = sm.C[idx];
    }
    if (blockIdx.x == 0) {
      for (int d = tid; d < Dk; d += kThreads)
        n_out[(long long)bh * Dk + d] = sm.n[d];
      if (tid == 0) m_out[bh] = sm.scal[0];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_i,
           const float* log_f, const float* C0, const float* n0,
           const float* m0, float* h, float* C_out, float* n_out,
           float* m_out, int BH, int S, int Dk, int Dv, int L, float scale,
           cudaStream_t stream) {
  if (Dk > kMaxDk || L > kMaxL || L < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(Dk) * sizeof(float);
  int e = tile::prepare(mlstm_kernel<T>, smem);
  if (e != 0) return e;
  const dim3 grid((Dv + kT - 1) / kT, BH);
  mlstm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_i, log_f, C0, n0, m0, h, C_out, n_out,
      m_out, S, Dk, Dv, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: pointers and the stream as void*, shapes as int; returns
// the cudaError_t of the launch (0 = success). q/k [B,H,S,Dk], v [B,H,S,Dv]
// (is_bf16 selects __nv_bfloat16, else float32), log_i/log_f [B,H,S]
// float32, h [B,H,S,Dv] float32, all contiguous. C0 [B,H,Dk,Dv], n0
// [B,H,Dk], m0 [B,H] float32 may all be null (zero state, m = -1e30);
// C_out, n_out, m_out likewise (final state not written).
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* log_i, const void* log_f,
                               const void* C0, const void* n0, const void* m0,
                               void* h, void* C_out, void* n_out, void* m_out,
                               int is_bf16, int BH, int S, int Dk, int Dv,
                               int L, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *li = static_cast<const float*>(log_i),
              *lf = static_cast<const float*>(log_f),
              *c0 = static_cast<const float*>(C0),
              *nn0 = static_cast<const float*>(n0),
              *mm0 = static_cast<const float*>(m0);
  float *hh = static_cast<float*>(h), *co = static_cast<float*>(C_out),
        *no = static_cast<float*>(n_out), *mo = static_cast<float*>(m_out);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, li, lf, c0, nn0, mm0, hh, co, no,
                                 mo, BH, S, Dk, Dv, L, scale, st);
  return launch<float>(q, k, v, li, lf, c0, nn0, mm0, hh, co, no, mo, BH, S,
                       Dk, Dv, L, scale, st);
}
