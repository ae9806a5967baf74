// Chunkwise mLSTM forward for Hopper (sm_90a), with plain C entry points
// loaded through ctypes by repro_torch/kernels/mlstm_chunk/kernel.py. Two
// kernels, one per route; the wrapper picks the route before the launch:
//
//   mlstm_chunk_fwd_wgmma  bf16 q/k/v, Dk and Dv multiples of 64 up to
//                          256, chunk length L a multiple of 64, 16-byte
//                          aligned: the tensor-core kernel
//                          (mlstm_wgmma_kernel)
//   mlstm_chunk_fwd        float32 streams and every other shape: the
//                          CUDA-core kernel (mlstm_kernel)
//
// Both replace repro/kernels/mlstm_chunk/kernel.py::_mlstm_kernel
// (chunkwise-parallel mLSTM, forward). Semantics follow the Pallas kernel
// chunk for chunk, in float32: with F the cumulative log forget gate of
// the chunk, the intra-chunk decay D[t,u] = F[t] - F[u] + log_i[u]
// (u <= t, else -1e30), the row stabiliser m_row[t] = max(max_u D[t,u],
// F[t] + m_prev), the weighted scores s = (q . k * scale) * exp(D - m_row),
// and
//   h = (s V + exp(F + m_prev - m_row) q C)
//       / max(|sum_u s + exp(F + m_prev - m_row) q . n|, exp(-m_row)),
// then the end-of-chunk state update of (C, n, m). Two additions to the
// Pallas kernel, which the model's chunk loop (models/xlstm.py) needs:
// the state may start from a carried (C0, n0, m0) instead of zeros and
// -1e30, and the final state may be written out (where it is not, the
// last chunk's state update is skipped: nothing reads it). h is written in
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
// Both kernels split the value columns across CTAs: grid (Dv/64, B*H),
// each CTA carrying its 64 columns of C plus the whole n and m through
// the chunks in a loop that replaces the TPU grid's chunk axis (C is
// 256 KB of float32 at head_dim 256, more than a CTA's shared memory).
// num and the C update of a column slice depend only on that slice; den,
// n and m do not depend on Dv, so every CTA recomputes the chunk's q.k^T
// (4x at Dv=256).
//
// mlstm_wgmma_kernel (the bf16 route) puts the four products on the
// tensor cores (wgmma, float32 accumulators): S = q k^T with q and k
// K-major straight from the bf16 streams; num += s V (s from registers,
// V MN-major); num += q C (C^T K-major); C^T += (v w_r)^T k (both
// MN-major). s, C and v w_r are float32, and one rounding to bf16 (about
// 2^-9 relative) puts h far outside the 2e-4 check; so s and v w_r are
// split into a bf16 hi + lo pair (about 2^-17 left) and C, whose q C term
// dominates h after a carried state, into hi + mid + lo (about 2^-25),
// each part multiplied in turn (tests/test_torch_mlstm_chunk.py emulates
// this on the CPU and shows one rounding failing). The split keeps the
// shared-memory operands in the layouts TMA and the accumulators give;
// tf32 wgmma (K-major operands only, 2^-11 a rounding) would need
// transposed copies of V and k and still miss the tolerance on s. A CTA
// has two consumer warpgroups and a producer warpgroup (setmaxnreg 24 /
// 240). The producer streams, per chunk, the q rows of each t block (two
// 64-row strips, one per consumer) and for each the 64-row k strips and
// the CTA's 64-column v strips up to its diagonal, then every strip again
// for the state update, by TMA into a 2-stage mbarrier ring (rows past S
// arrive as zeros). The state stays on chip, transposed: consumer g
// holds C^T's 64 value rows by 128 columns of d in its accumulator
// registers, so the update is one m64n128 wgmma a step ((v w_r)^T k), and
// writes their bf16 parts to shared memory, one warpgroup a round, for
// q C; n lives in shared memory. The gates are parallel: F by a warp scan,
// and the row max over u <= t of D[t,u] = F[t] + (log_i[u] - F[u]) by a
// running (prefix) max in the same scan, so the decay weight is
// 2^(a[t] + b[u]) with one exponent half per row and per column. Weights
// above the diagonal, past the chunk's end (a short last chunk) and the
// state update's rows past S are zero; strips above the diagonal are
// skipped. To fill the card, a pair of CTAs shares each (batch x head,
// 64 value columns) while the doubled grid fits one wave (t_split in the
// wrapper): they take the chunk's t strips {0, 3} and {1, 2} (equal
// causal work) and both carry the whole state, so q k^T is computed
// 4x over the value slices and the state update 2x. Products wait for
// each other (no software pipeline yet) while the next strips load.
//
// mlstm_kernel (float32 streams, other shapes) is the simple CUDA-core
// design: the chunk is walked in 64-row tiles of t and u (tiles above the
// diagonal skipped), all products float32 through shared-memory tiles,
// each thread a 4 x 4 register tile of a 64 x 64 product.

#include "attention_tile.cuh"
#include "hopper.cuh"

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

    // the last chunk's state update only where the state is returned
    if (C_out == nullptr && c0 + Lc == S) break;
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

// ---------------------------------------------------------------------------
// the tensor-core route (bf16 streams, Dk and Dv multiples of 64 up to
// 256, L a multiple of 64)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kStrip = 64;             // rows of a q/k/v strip; C's columns
constexpr int kStages = 2;             // k/v strip ring depth
constexpr int kThreadsWg = 3 * 128;    // two consumer WGs + producer WG
constexpr int kBoxBytes = kStrip * 64 * 2;     // 64 rows x 64 bf16: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of bf16 element (r, c) of a 64-column, 128-byte-swizzled box
// column (what TMA writes and a B128 descriptor reads).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1);
}

// Shared memory, all boxes 1024-byte aligned:
//   q      [2 WGs][NB boxes]    the t block's q rows, 64 per WG
//   k      [kStages][NB boxes]  a 64-row k strip
//   v      [kStages]            the CTA's 64 columns of a v strip
//   cs     C^T's bf16 hi / mid / lo parts, 128 columns of d at a time
//          [3][2 boxes] (64 rows), during the outputs; two buffers
//          of a v * w_r strip (hi, lo) during the update; the row
//          groups' sums of k w_r for n at the chunk's end
//   gates  F, P, a2, b2, interw, floor, wr [kMaxL]; n [kMaxDk]; scal [4]
//   bars   q_full, q_empty, kv_full [kStages], kv_empty [kStages]
struct Layout {
  unsigned char *q, *k, *v, *cs;
  float *F, *P, *a2, *b2, *interw, *floor, *wr, *n, *scal;
  uint64_t *q_full, *q_empty, *kv_full, *kv_empty;
};

// C^T's three parts for 128 columns of d (48 KB); the update's two v w_r
// buffers (32 KB) fit inside.
constexpr size_t kCsBytes = 3 * 2 * kBoxBytes;

__host__ __device__ inline size_t smem_bytes(int nb) {
  return 1024 + (size_t)2 * nb * kBoxBytes +
         (size_t)kStages * (nb + 1) * kBoxBytes + kCsBytes +
         4 * (7 * (size_t)kMaxL + kMaxDk + 4) + 8 * (2 + 2 * kStages);
}

__device__ inline Layout carve_wg(unsigned char* raw, int nb) {
  unsigned char* p = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
  Layout s;
  s.q = p;   p += (size_t)2 * nb * kBoxBytes;
  s.k = p;   p += (size_t)kStages * nb * kBoxBytes;
  s.v = p;   p += (size_t)kStages * kBoxBytes;
  s.cs = p;  p += kCsBytes;
  float* f = reinterpret_cast<float*>(p);
  s.F = f;       f += kMaxL;
  s.P = f;       f += kMaxL;
  s.a2 = f;      f += kMaxL;
  s.b2 = f;      f += kMaxL;
  s.interw = f;  f += kMaxL;
  s.floor = f;   f += kMaxL;
  s.wr = f;      f += kMaxL;
  s.n = f;       f += kMaxDk;
  s.scal = f;    f += 4;
  uint64_t* b = reinterpret_cast<uint64_t*>(f);
  s.q_full = b;
  s.q_empty = b + 1;
  s.kv_full = b + 2;
  s.kv_empty = b + 2 + kStages;
  return s;
}

// Float pairs (x0, x1) -> bf16 hi and lo pairs with hi + lo = x to about
// 2^-16 relative.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The t rows of a chunk go in t blocks of two 64-row strips, one per
// consumer warpgroup. With tsplit 1 a CTA walks all of them (strips 2 tb
// and 2 tb + 1 of t block tb); with tsplit 2 a pair of CTAs shares the
// chunk, rank 0 taking strips 0 and 3 and rank 1 strips 1 and 2 (equal
// causal work, L <= 256), and each carries the whole state update.
__device__ __forceinline__ int n_tblocks(int nus, int tsplit) {
  return tsplit == 1 ? (nus + 1) / 2 : 1;
}
__device__ __forceinline__ int strip_of(int tb, int g, int tsplit,
                                        int rank) {
  return tsplit == 1 ? 2 * tb + g : (g == 0 ? rank : 3 - rank);
}

// Float pairs -> bf16 hi, mid and lo pairs with hi + mid + lo = x to
// about 2^-24 relative.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  split2(x0 - hf.x, x1 - hf.y, mid, lo);
}

}  // namespace wg

// Gates of one chunk (Lc rows from c0) into shared memory, by the 256
// consumer threads: F by a warp scan, the prefix max P[t] = max_{u<=t}
// (li[u] - F[u]) by another, so the row stabiliser is m_row[t] =
// max(F[t] + P[t], F[t] + m_prev); then per row the exponent halves
// a2 = (F - m_row) log2 e and b2 = (li - F) log2 e of the decay weight
// exp(D[t,u] - m_row[t]) = 2^(a2[t] + b2[u]), the inter-chunk weight, the
// denominator's floor exp(-m_row) and the state weight w_r * scale; and
// m_new, f_eff in scal[1], scal[2]. Rows past Lc get zero weights.
__device__ void chunk_gates(const wg::Layout& sm, const float* __restrict__ lib,
                            const float* __restrict__ lfb, int c0, int Lc,
                            int L, float m_prev, float scale, int tid) {
  using namespace wg;
  float* li = sm.interw;                       // staging until the last pass
  float* lf = sm.floor;
  if (tid < L) {                               // L <= 256 rows, one a thread
    li[tid] = tid < Lc ? lib[c0 + tid] : kNegInf;
    lf[tid] = tid < Lc ? lfb[c0 + tid] : 0.f;
  }
  hopper::named_barrier(1, 256);
  if (tid < 32) {
    const int lane = tid;
    float run = 0.f, part[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int u = lane * 8 + e;
      run += u < L ? lf[u] : 0.f;
      part[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int u = lane * 8 + e;
      if (u < L) sm.F[u] = incl - run + part[e];
    }
    __syncwarp();
    const float ftot = sm.F[Lc - 1];
    float pm = kNegInf, wmax = kNegInf;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int u = lane * 8 + e;
      if (u < Lc) {
        pm = fmaxf(pm, li[u] - sm.F[u]);
        wmax = fmaxf(wmax, ftot - sm.F[u] + li[u]);
      }
      part[e] = pm;
    }
    float inclm = pm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, inclm, o);
      if (lane >= o) inclm = fmaxf(inclm, y);
    }
    float excl = __shfl_up_sync(0xffffffffu, inclm, 1);
    if (lane == 0) excl = kNegInf;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int u = lane * 8 + e;
      if (u < L) sm.P[u] = fmaxf(excl, part[e]);
    }
    wmax = warp_max(wmax);
    if (lane == 0) {
      const float m_new = fmaxf(ftot + m_prev, wmax);
      sm.scal[0] = ftot;
      sm.scal[1] = m_new;
      sm.scal[2] = expf(ftot + m_prev - m_new);
    }
  }
  hopper::named_barrier(1, 256);
  const float ftot = sm.scal[0], m_new = sm.scal[1];
  const int t = tid;                           // L <= 256 rows, one a thread
  const float lt = t < L ? li[t] : 0.f, ft = t < L ? sm.F[t] : 0.f;
  hopper::named_barrier(1, 256);               // staging read: overwrite
  if (t < Lc) {
    const float mr = fmaxf(ft + sm.P[t], ft + m_prev);
    sm.interw[t] = expf(ft + m_prev - mr);
    sm.floor[t] = expf(-mr);
    sm.a2[t] = (ft - mr) * kLog2e;
    sm.b2[t] = (lt - ft) * kLog2e;
    sm.wr[t] = scale * expf(ftot - ft + lt - m_new);
  } else if (t < L) {
    sm.interw[t] = 0.f;
    sm.floor[t] = 1.f;
    sm.a2[t] = 0.f;
    sm.b2[t] = kNegInf;
    sm.wr[t] = 0.f;
  }
  hopper::named_barrier(1, 256);
}

template <int NB>
__global__ void __launch_bounds__(wg::kThreadsWg, 1)
mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ log_i,
                   const float* __restrict__ log_f,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   const float* __restrict__ m0, float* __restrict__ h,
                   float* __restrict__ C_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int Dv, int L,
                   float scale, int tsplit) {
  using namespace hopper;
  using namespace wg;
  constexpr int Dk = NB * 64;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  const Layout sm = carve_wg(wg_raw, NB);
  const int bh = blockIdx.y;                   // b * H + h
  const int j0 = blockIdx.x / tsplit * kStrip; // first value column
  const int rank = blockIdx.x % tsplit;         // which strips (tsplit 2)
  const int nchunks = (S + L - 1) / L;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    mbar_init(sm.q_empty, 8);                  // one per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.kv_full + s, 1);
      mbar_init(sm.kv_empty + s, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one lane streams, per chunk, the q blocks of
    // 128 rows, for each the k/v strips up to its diagonal, then every
    // k/v strip again for the state update
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int j = 0, qi = 0;
      auto load_kv = [&](int row) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(sm.kv_empty + s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(sm.kv_full + s, (NB + 1) * kBoxBytes);
        for (int x = 0; x < NB; ++x)
          tma_load_3d(sm.k + (s * NB + x) * kBoxBytes, &kmap, sm.kv_full + s,
                      x * 64, row, bh);
        tma_load_3d(sm.v + s * kBoxBytes, &vmap, sm.kv_full + s, j0, row, bh);
        ++j;
      };
      for (int c = 0; c < nchunks; ++c) {
        const int c0 = c * L, Lc = min(L, S - c0);
        const int nus = (Lc + kStrip - 1) / kStrip;
        for (int tb = 0; tb < n_tblocks(nus, tsplit); ++tb) {
          if (qi > 0) mbar_wait(sm.q_empty, (qi - 1) & 1);
          mbar_expect_tx(sm.q_full, 2 * NB * kBoxBytes);
          for (int w = 0; w < 2; ++w)
            for (int x = 0; x < NB; ++x)
              tma_load_3d(sm.q + (w * NB + x) * kBoxBytes, &qmap, sm.q_full,
                          x * 64,
                          c0 + strip_of(tb, w, tsplit, rank) * kStrip, bh);
          ++qi;
          const int top = max(strip_of(tb, 0, tsplit, rank),
                              strip_of(tb, 1, tsplit, rank));
          for (int us = 0; us < min(top + 1, nus); ++us)
            load_kv(c0 + us * kStrip);
        }
        if (C_out != nullptr || c + 1 < nchunks)   // the state update
          for (int us = 0; us < nus; ++us) load_kv(c0 + us * kStrip);
      }
    }
    return;
  }

  // consumers: warpgroup g takes one 64-row t strip of each t block and
  // C^T's columns d = 128 g + [0, 128)
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x;
  const int g = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row_a = 16 * warp + lane / 4;      // and row_a + 8
  const unsigned char* qw = sm.q + g * NB * kBoxBytes;
  const float* lib = log_i + (long long)bh * S;
  const float* lfb = log_f + (long long)bh * S;
  float* hb = h + (long long)bh * S * Dv;
  constexpr int kRounds = (NB + 1) / 2;        // 128 columns of d a round

  // the state: this CTA's 64 value columns of C, transposed, in the
  // accumulators: warpgroup g holds C^T's 64 rows (v) by the columns
  // d = 128 g + [0, nd), nd = 128, 64 or 0; n in shared memory
  const int nd = min(128, max(0, Dk - 128 * g));
  float cacc[64];
  float (&cacc64)[32] = *reinterpret_cast<float(*)[32]>(cacc);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int v = row_a + ((i & 2) ? 8 : 0);
    const int dl = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    cacc[i] = (C0 != nullptr && dl < nd)
                  ? C0[((long long)bh * Dk + 128 * g + dl) * Dv + j0 + v]
                  : 0.f;
  }
  for (int d = tid; d < Dk; d += 256)
    sm.n[d] = n0 != nullptr ? n0[(long long)bh * Dk + d] : 0.f;
  float m_prev = m0 != nullptr ? m0[bh] : kNegInf;

  int j = 0, qi = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * L, Lc = min(L, S - c0);
    const int nus = (Lc + kStrip - 1) / kStrip;
    chunk_gates(sm, lib, lfb, c0, Lc, L, m_prev, scale, tid);
    const float m_new = sm.scal[1], f_eff = sm.scal[2];

    // ---- outputs, one t block of 128 rows at a time ----
    for (int tb = 0; tb < n_tblocks(nus, tsplit); ++tb) {
      const int ts = strip_of(tb, g, tsplit, rank);
      const int top = max(strip_of(tb, 0, tsplit, rank),
                          strip_of(tb, 1, tsplit, rank));
      const int tw = ts * kStrip;                // the WG's first row
      const bool rows = tw < Lc;
      const int ta = tw + row_a, tb8 = ta + 8;   // the lane's two rows
      mbar_wait(sm.q_full, qi & 1);
      float num[32];
      float den_a = 0.f, den_b = 0.f, qn_a = 0.f, qn_b = 0.f;
      // q . n on the CUDA cores, run by each WG while the other writes
      // C's parts (or after the rounds): a quad shares two rows, each
      // lane a quarter of the 16-byte chunks
      auto q_dot_n = [&]() {
#pragma unroll
        for (int m = 0; m < 2 * NB; ++m) {
          const int cc = (lane & 3) + 4 * m, x = cc >> 3, jj = cc & 7;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = row_a + 8 * hh;
            const uint4 raw = *reinterpret_cast<const uint4*>(
                qw + x * kBoxBytes + r * 128 + ((jj ^ (r & 7)) << 4));
            const __nv_bfloat162* b2 =
                reinterpret_cast<const __nv_bfloat162*>(&raw);
            const float* nn = sm.n + cc * 8;
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(b2[e]);
              acc = fmaf(f.x, nn[2 * e], fmaf(f.y, nn[2 * e + 1], acc));
            }
            if (hh) qn_b += acc;
            else qn_a += acc;
          }
        }
      };
      // num = q C, then weighted by the inter-chunk weight. C^T goes to
      // shared memory (the B operand, K-major: row v, columns d in boxes
      // of 64) as bf16 hi / mid / lo parts, 128 columns of d a round,
      // written by the warpgroup that holds them; both WGs pass every
      // barrier.
      const int qn_round = g == 1 ? 0 : 1;       // not the WG's own round
#pragma unroll
      for (int p = 0; p < kRounds; ++p) {
        named_barrier(1, 256);                   // the parts are free
        if (rows && p == qn_round) q_dot_n();
        if (g == p) {
#pragma unroll
          for (int i = 0; i < 64; i += 2) {
            const int dl = 8 * (i >> 2) + 2 * (lane & 3);
            if (dl < nd) {
              const int off = (dl >> 6) * kBoxBytes +
                              swz(row_a + ((i & 2) ? 8 : 0), dl & 63);
              uint32_t hi, mid, lo;
              split3(cacc[i], cacc[i + 1], hi, mid, lo);
              *reinterpret_cast<uint32_t*>(sm.cs + off) = hi;
              *reinterpret_cast<uint32_t*>(sm.cs + 2 * kBoxBytes + off) = mid;
              *reinterpret_cast<uint32_t*>(sm.cs + 4 * kBoxBytes + off) = lo;
            }
          }
        }
        fence_proxy_async();
        named_barrier(1, 256);
        if (rows) {
          fence_regs(num);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {          // 16 rows of d a step
            const int kg = 8 * p + kk;
            if (kg < 4 * NB) {
              const uint64_t da = sw128_desc(qw + (kg >> 2) * kBoxBytes +
                                             (kg & 3) * 32, 16, 1024);
#pragma unroll
              for (int part = 0; part < 3; ++part)
                wgmma_ss_n64<0, 0>(
                    num, da,
                    sw128_desc(sm.cs + part * 2 * kBoxBytes +
                                   (kk >> 2) * kBoxBytes + (kk & 3) * 32,
                               16, 1024),
                    kg > 0 || part > 0);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(num);
        }
      }
      if (rows && qn_round >= kRounds) q_dot_n();
      if (rows) {
        const float iw_a = sm.interw[ta];
        const float iw_b = sm.interw[tb8];
#pragma unroll
        for (int i = 0; i < 32; ++i) num[i] *= (i & 2) ? iw_b : iw_a;
      }
      const float a2_a = rows ? sm.a2[ta] : 0.f;
      const float a2_b = rows ? sm.a2[tb8] : 0.f;
      for (int us = 0; us < min(top + 1, nus); ++us, ++j) {
        const int s = j % kStages;
        mbar_wait(sm.kv_full + s, (j / kStages) & 1);
        if (rows && us <= ts) {
          const unsigned char* ks = sm.k + s * NB * kBoxBytes;
          const unsigned char* vs = sm.v + s * kBoxBytes;
          float sc[32];
          fence_regs(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NB; ++kk) {
            const int x = kk >> 2, in = (kk & 3) * 32;
            wgmma_ss_n64<0, 0>(sc, sw128_desc(qw + x * kBoxBytes + in, 16,
                                              1024),
                               sw128_desc(ks + x * kBoxBytes + in, 16, 1024),
                               kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          // s = (q . k) scale exp(D - m_row), causal within the chunk
          const int u0 = us * kStrip;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int t = (i & 2) ? tb8 : ta;
            const int u = u0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            const float w = (u <= t && u < Lc)
                ? fast_exp2(((i & 2) ? a2_b : a2_a) + sm.b2[u]) : 0.f;
            sc[i] = sc[i] * scale * w;
            if (i & 2) den_b += sc[i];
            else den_a += sc[i];
          }
          uint32_t ph[4][4], pl[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              split2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);
          fence_regs(num);
          fence_regs(ph);
          fence_regs(pl);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db = sw128_desc(vs + kk * 2048, 8192, 1024);
            wgmma_rs_n64_tb(num, ph[kk], db);
            wgmma_rs_n64_tb(num, pl[kk], db);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(num);
          fence_regs(ph);
          fence_regs(pl);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.kv_empty + s);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.q_empty);
      ++qi;
      if (rows) {
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          den_a += __shfl_xor_sync(0xffffffffu, den_a, x);
          den_b += __shfl_xor_sync(0xffffffffu, den_b, x);
          qn_a += __shfl_xor_sync(0xffffffffu, qn_a, x);
          qn_b += __shfl_xor_sync(0xffffffffu, qn_b, x);
        }
        const float dn_a = fmaxf(fabsf(den_a + sm.interw[ta] *
                                                   qn_a),
                                 sm.floor[ta]);
        const float dn_b = fmaxf(fabsf(den_b + sm.interw[tb8] *
                                                   qn_b),
                                 sm.floor[tb8]);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int t = (i & 2) ? tb8 : ta;
          const int col = 8 * (i >> 2) + 2 * (lane & 3);
          if (t < Lc) {
            const float dn = (i & 2) ? dn_b : dn_a;
            *reinterpret_cast<float2*>(hb + (long long)(c0 + t) * Dv + j0 +
                                       col) =
                make_float2(num[i] / dn, num[i + 1] / dn);
          }
        }
      }
    }

    // the last chunk's state update only where the state is returned
    if (C_out == nullptr && c + 1 == nchunks) break;
    // ---- state update to the end of the chunk ----
    named_barrier(1, 256);                     // both WGs done with C's parts
#pragma unroll
    for (int i = 0; i < 64; ++i) cacc[i] *= f_eff;
    // sum_u k w_r for n on the CUDA cores, beside the products: thread
    // tid sums one 16-byte chunk of a k row (8 columns of d) over the
    // strip rows of its row group, 16-byte loads kept in flight
    constexpr int kNChunks = 8 * NB, kNGroups = 256 / kNChunks;
    const int nc = tid % kNChunks, nr = tid / kNChunks;
    float n_part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int us = 0; us < nus; ++us, ++j) {
      const int s = j % kStages;
      const unsigned char* ks = sm.k + s * NB * kBoxBytes;
      const unsigned char* vs = sm.v + s * kBoxBytes;
      const float* wr = sm.wr + us * kStrip;
      // v w_r (hi, lo), shared by both WGs and double-buffered: the
      // barrier below, which each thread reaches after its wait on the
      // previous strip's products, also frees the other buffer
      unsigned char* vw_hi = sm.cs + (us & 1) * 2 * kBoxBytes;
      unsigned char* vw_lo = vw_hi + kBoxBytes;
      mbar_wait(sm.kv_full + s, (j / kStages) & 1);
      // chunk by 16-byte chunk: the swizzle permutes chunks inside a row,
      // so a chunk's row is its offset / 128
      for (int pc = tid; pc < kBoxBytes / 16; pc += 256) {
        const uint4 raw = *reinterpret_cast<const uint4*>(vs + pc * 16);
        const __nv_bfloat162* b2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float w = wr[pc >> 3];
        uint4 hi, lo;
        uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(b2[e]);
          split2(f.x * w, f.y * w, hp[e], lp[e]);
        }
        *reinterpret_cast<uint4*>(vw_hi + pc * 16) = hi;
        *reinterpret_cast<uint4*>(vw_lo + pc * 16) = lo;
      }
      fence_proxy_async();
      named_barrier(1, 256);
      // C^T += (v w_r)^T k: v w_r MN-major (rows u, columns v), k too
      // (rows u, this WG's columns d: boxes 2 g and 2 g + 1, 8 KB apart)
      fence_regs(cacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            sw128_desc(ks + 2 * g * kBoxBytes + kk * 2048, kBoxBytes, 1024);
        const uint64_t dh = sw128_desc(vw_hi + kk * 2048, 8192, 1024);
        const uint64_t dl = sw128_desc(vw_lo + kk * 2048, 8192, 1024);
        if (nd == 128) {
          wgmma_ss_n128<1, 1>(cacc, dh, db, 1);
          wgmma_ss_n128<1, 1>(cacc, dl, db, 1);
        } else if (nd == 64) {
          wgmma_ss_n64<1, 1>(cacc64, dh, db, 1);
          wgmma_ss_n64<1, 1>(cacc64, dl, db, 1);
        }
      }
      wgmma_commit();
      if (nr < kNGroups) {
        const unsigned char* kc = ks + (nc >> 3) * kBoxBytes;
        for (int r = nr; r < kStrip; r += kNGroups) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kc + r * 128 + (((nc & 7) ^ (r & 7)) << 4));
          const __nv_bfloat162* b2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float w = wr[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(b2[e]);
            n_part[2 * e] = fmaf(f.x, w, n_part[2 * e]);
            n_part[2 * e + 1] = fmaf(f.y, w, n_part[2 * e + 1]);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(cacc);
      if (lane == 0) mbar_arrive(sm.kv_empty + s);
    }
    named_barrier(1, 256);                     // cs free of v w_r
    float* n_red = reinterpret_cast<float*>(sm.cs);   // [kNGroups][Dk]
    if (nr < kNGroups)
#pragma unroll
      for (int e = 0; e < 8; ++e) n_red[nr * Dk + nc * 8 + e] = n_part[e];
    named_barrier(1, 256);
    if (tid < Dk) {
      float x = 0.f;
      for (int r = 0; r < kNGroups; ++r) x += n_red[r * Dk + tid];
      sm.n[tid] = f_eff * sm.n[tid] + x;
    }
    m_prev = m_new;
    named_barrier(1, 256);
  }

  if (C_out != nullptr && rank == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int v = row_a + ((i & 2) ? 8 : 0);
      const int dl = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (dl < nd)
        C_out[((long long)bh * Dk + 128 * g + dl) * Dv + j0 + v] = cacc[i];
    }
    if (blockIdx.x == 0) {
      for (int d = tid; d < Dk; d += 256)
        n_out[(long long)bh * Dk + d] = sm.n[d];
      if (tid == 0) m_out[bh] = m_prev;
    }
  }
}

template <int NB>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const float* log_i, const float* log_f, const float* C0,
                 const float* n0, const float* m0, float* h, float* C_out,
                 float* n_out, float* m_out, int BH, int S, int Dv, int L,
                 float scale, int tsplit, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int e = hopper::make_map(&qmap, q, BH, S, NB * 64, wg::kStrip);
  if (e == 0) e = hopper::make_map(&kmap, k, BH, S, NB * 64, wg::kStrip);
  if (e == 0) e = hopper::make_map(&vmap, v, BH, S, Dv, wg::kStrip);
  if (e != 0) return e;
  const size_t smem = wg::smem_bytes(NB);
  e = tile::prepare(mlstm_wgmma_kernel<NB>, smem);
  if (e != 0) return e;
  const dim3 grid(Dv / wg::kStrip * tsplit, BH);
  mlstm_wgmma_kernel<NB><<<grid, wg::kThreadsWg, smem, stream>>>(
      qmap, kmap, vmap, log_i, log_f, C0, n0, m0, h, C_out, n_out, m_out, S,
      Dv, L, scale, tsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: pointers and the stream as void*, shapes as int; returns
// the cudaError_t of the launch (0 = success). q/k [B,H,S,Dk], v [B,H,S,Dv]
// (is_bf16 selects __nv_bfloat16, else float32), log_i/log_f [B,H,S]
// float32, h [B,H,S,Dv] float32, all contiguous. C0 [B,H,Dk,Dv], n0
// [B,H,Dk], m0 [B,H] float32 may all be null (zero state, m = -1e30);
// C_out, n_out, m_out likewise (final state neither updated in the
// last chunk nor written).
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

// The tensor-core route: bf16 q/k [B,H,S,Dk], v [B,H,S,Dv], contiguous
// and 16-byte aligned, Dk and Dv multiples of 64 up to 256, L a multiple
// of 64 up to 256 (the wrapper checks), tsplit 1 or 2 CTAs per chunk and
// value slice; the rest as mlstm_chunk_fwd.
extern "C" int mlstm_chunk_fwd_wgmma(const void* q, const void* k,
                                     const void* v, const void* log_i,
                                     const void* log_f, const void* C0,
                                     const void* n0, const void* m0, void* h,
                                     void* C_out, void* n_out, void* m_out,
                                     int BH, int S, int Dk, int Dv, int L,
                                     float scale, int tsplit, void* stream) {
  if (Dk % 64 != 0 || Dv % 64 != 0 || Dk > kMaxDk || Dv > kMaxDk ||
      L % 64 != 0 || L > kMaxL || L < 64 || S < 1 || tsplit < 1 ||
      tsplit > 2)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(q, k, v, static_cast<const float*>(log_i),
              static_cast<const float*>(log_f),
              static_cast<const float*>(C0), static_cast<const float*>(n0),
              static_cast<const float*>(m0), static_cast<float*>(h),
              static_cast<float*>(C_out), static_cast<float*>(n_out),
              static_cast<float*>(m_out), BH, S, Dv, L, scale, tsplit,
              static_cast<cudaStream_t>(stream));
  };
  switch (Dk / 64) {
    case 1: return go(launch_wgmma<1>);
    case 2: return go(launch_wgmma<2>);
    case 3: return go(launch_wgmma<3>);
    default: return go(launch_wgmma<4>);
  }
}
