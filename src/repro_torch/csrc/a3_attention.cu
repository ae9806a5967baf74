// A^3 block-sparse prefill attention for Hopper (sm_90a): two kernels,
// each with a plain C entry point loaded through ctypes by
// repro_torch/kernels/a3_attention/kernel.py.
//
//   a3_sparse_rowmax  replaces repro/kernels/a3_attention/kernel.py
//                     ::_sparse_rowmax_kernel (pass 1: the true masked row
//                     max over the live kv blocks of each q block)
//   a3_sparse_attend  replaces ::_sparse_attend_kernel (pass 2: drop
//                     s < rowmax - threshold, exp-sum and P.V over the
//                     live blocks; l == 0 -> 0)
//
// Semantics follow the Pallas kernels: the candidate map is per kv head
// (kv_indices [B,Hkv,nq,maxb], kv_counts [B,Hkv,nq], block_q x block_k
// granularity), s = (q . k) * scale in float32, the causal / window masks
// of _block_mask apply per element inside each live block, masked scores
// are -1e30 (so a row with no admitted entry has row max -1e30), pass 2
// keeps an entry iff it is admitted and s >= rowmax - threshold, takes
// p = exp(s - rowmax) and writes 0 where l == 0. Block ids outside
// [0, Sk / block_k) are treated as dead, as the plain version does.
//
// Bound: on these inputs both passes score every admitted pair of the
// live blocks (2*D flops each), and pass 2 adds 2*Dv flops per kept
// pair; at the prefill shape (S=2048, 24/8 heads, D=128, bf16) and a
// half-dense map that is ~6-7 GFLOP per pass, a few microseconds of
// tensor-core time, over ~13-30 MB of q/k/v/out: bound by operations.
//
// Design (simple and right, not fast yet): a CUDA block reads its own
// kv_indices row and count (this replaces scalar prefetch) and loops only
// over the `count` live blocks (the TPU grid runs maxb steps and
// predicates the dead ones off). Its 64 rows are (query, head) pairs of
// one q block taken query-major across the GQA group — the group folded
// into the rows, as the Pallas kernel folds it into the q tile — so one
// staging of a live K/V sub-tile serves every head of the group. A q
// block of 128 x G rows spans ceil(128 G / 64) CUDA blocks (shared memory
// holds 64 rows), each reading the map of the q block its rows belong to.
// Sub-tiles that lie wholly above the causal diagonal or outside the
// window for the block's rows are skipped (exact: nothing is admitted).
// Arithmetic is float32 on the CUDA cores (attention_tile.cuh), far above
// the operations bound: tensor-core tiles come in later work.

#include "attention_tile.cuh"

namespace {

using namespace tile;

struct Geometry {
  int Hq, Hkv, Sq, Sk, D, Dv, bq, bk, nq, nk, maxb;
  int causal, has_window, window;
};

// Fill the block's row bookkeeping; returns the (b*Hkv + hk) and q block
// ids and the range of absolute positions of its rows.
__device__ void setup_rows(const Geometry& g, const Smem& sm, int& bhk,
                           int& iq, int& pos_lo, int& pos_hi) {
  const int G = g.Hq / g.Hkv;
  const int per_qblock = (G * g.bq + kRows - 1) / kRows;
  bhk = blockIdx.y;
  iq = blockIdx.x / per_qblock;
  const int r0 = (blockIdx.x % per_qblock) * kRows;
  const int b = bhk / g.Hkv, hk = bhk % g.Hkv;
  const int off = g.Sk - g.Sq;
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int flat = r0 + r;                  // query-major: (i, head g)
    const bool ok = flat < G * g.bq;
    const int i = flat / G, hg = flat % G;
    const int qpos = iq * g.bq + i;
    const long long row = ((long long)b * g.Hq + hk * G + hg) * g.Sq + qpos;
    sm.rows->q_off[r] = ok ? row * g.D : -1;
    sm.rows->o_off[r] = ok ? row : -1;        // row index (row max / out)
    sm.rows->abs_pos[r] = qpos + off;
    sm.rows->m[r] = kNegInf;
    sm.rows->l[r] = 0.f;
  }
  const int last = min(r0 + kRows, G * g.bq) - 1;
  pos_lo = iq * g.bq + r0 / G + off;
  pos_hi = iq * g.bq + last / G + off;
}

__device__ __forceinline__ bool tile_dead(const Geometry& g, int c0, int n,
                                          int pos_lo, int pos_hi) {
  if (g.causal && c0 > pos_hi) return true;
  if (g.has_window && c0 + n - 1 <= pos_lo - g.window) return true;
  return false;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rowmax_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const int* __restrict__ kv_idx, const int* __restrict__ kv_cnt,
              float* __restrict__ rowmax, Geometry g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, g.D, g.D);
  int bhk, iq, pos_lo, pos_hi;
  setup_rows(g, sm, bhk, iq, pos_lo, pos_hi);
  __syncthreads();
  load_q(q, sm, g.D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long map = (long long)bhk * g.nq + iq;
  const int count = min(kv_cnt[map], g.maxb);
  const long long kv0 = (long long)bhk * g.Sk;

  for (int c = 0; c < count; ++c) {
    const int jk = kv_idx[map * g.maxb + c];
    if (jk < 0 || jk >= g.nk) continue;       // dead
    for (int sub = 0; sub < g.bk; sub += kCols) {
      const int c0 = jk * g.bk + sub;
      const int ncols = min(kCols, g.bk - sub);
      if (tile_dead(g, c0, ncols, pos_lo, pos_hi)) continue;
      __syncthreads();
      load_tile(k, kv0 + c0, ncols, g.D, g.D + 1, sm.kv);
      __syncthreads();
      score_tile(sm, g.D, scale);
      __syncthreads();
      for (int r = warp; r < kRows; r += kWarps) {
        const float* sr = sm.s + r * (kCols + 1);
        const int pos = sm.rows->abs_pos[r];
        float tmax = kNegInf;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = lane + 32 * t;
          const bool ok = j < ncols && allowed(pos, c0 + j, g.causal,
                                               g.has_window, g.window);
          tmax = fmaxf(tmax, ok ? sr[j] : kNegInf);
        }
        tmax = warp_max(tmax);
        if (lane == 0) sm.rows->m[r] = fmaxf(sm.rows->m[r], tmax);
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    if (sm.rows->q_off[r] >= 0) rowmax[sm.rows->o_off[r]] = sm.rows->m[r];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_idx,
              const int* __restrict__ kv_cnt,
              const float* __restrict__ rowmax, T* __restrict__ out,
              Geometry g, float scale, int has_thr, float thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, g.D, g.Dv);
  int bhk, iq, pos_lo, pos_hi;
  setup_rows(g, sm, bhk, iq, pos_lo, pos_hi);
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const long long row = sm.rows->o_off[r];
    sm.rows->m[r] = row >= 0 ? rowmax[row] : kNegInf;
    sm.rows->o_off[r] = row >= 0 ? row * g.Dv : -1;
  }
  load_q(q, sm, g.D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long map = (long long)bhk * g.nq + iq;
  const int count = min(kv_cnt[map], g.maxb);
  const long long kv0 = (long long)bhk * g.Sk;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int c = 0; c < count; ++c) {
    const int jk = kv_idx[map * g.maxb + c];
    if (jk < 0 || jk >= g.nk) continue;       // dead
    for (int sub = 0; sub < g.bk; sub += kCols) {
      const int c0 = jk * g.bk + sub;
      const int ncols = min(kCols, g.bk - sub);
      if (tile_dead(g, c0, ncols, pos_lo, pos_hi)) continue;
      __syncthreads();
      load_tile(k, kv0 + c0, ncols, g.D, g.D + 1, sm.kv);
      __syncthreads();
      score_tile(sm, g.D, scale);
      __syncthreads();
      for (int r = warp; r < kRows; r += kWarps) {
        float* sr = sm.s + r * (kCols + 1);
        const int pos = sm.rows->abs_pos[r];
        const float rm = sm.rows->m[r];
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = lane + 32 * t;
          const float s = sr[j];
          bool keep = j < ncols && allowed(pos, c0 + j, g.causal,
                                           g.has_window, g.window);
          if (has_thr) keep = keep && s >= rm - thr;
          const float p = keep ? expf(s - rm) : 0.f;
          sr[j] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        if (lane == 0) sm.rows->l[r] += psum;
      }
      __syncthreads();
      load_tile(v, kv0 + c0, ncols, g.Dv, g.Dv, sm.kv);
      __syncthreads();
      accumulate_pv(sm, acc, g.Dv, ncols, false);
    }
  }
  __syncthreads();
  emit(sm, acc, out, g.Dv);
}

Geometry geometry(int Hq, int Hkv, int Sq, int Sk, int D, int Dv, int bq,
                  int bk, int maxb, int causal, int has_window, int window) {
  return Geometry{Hq, Hkv, Sq, Sk, D, Dv, bq, bk, Sq / bq, Sk / bk, maxb,
                  causal, has_window, window};
}

dim3 grid_of(const Geometry& g, int B) {
  const int G = g.Hq / g.Hkv;
  const int per_qblock = (G * g.bq + kRows - 1) / kRows;
  return dim3(g.nq * per_qblock, B * g.Hkv);
}

template <typename T>
int launch_rowmax(const void* q, const void* k, const void* idx,
                  const void* cnt, void* rowmax, int B, const Geometry& g,
                  float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.D, g.D);
  int e = prepare(rowmax_kernel<T>, smem);
  if (e != 0) return e;
  rowmax_kernel<T><<<grid_of(g, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<float*>(rowmax), g, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* idx, const void* cnt, const void* rowmax,
                  void* out, int B, const Geometry& g, float scale,
                  int has_thr, float thr, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.D, g.Dv);
  int e = prepare(attend_kernel<T>, smem);
  if (e != 0) return e;
  attend_kernel<T><<<grid_of(g, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const float*>(rowmax),
      static_cast<T*>(out), g, scale, has_thr, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: pointers and the stream as void*, shapes as int; each
// returns the cudaError_t of the launch (0 = success). q [B,Hq,Sq,D],
// k [B,Hkv,Sk,D], v [B,Hkv,Sk,Dv], kv_indices int32 [B,Hkv,Sq/bq,maxb],
// kv_counts int32 [B,Hkv,Sq/bq], rowmax float32 [B,Hq,Sq] (the Pallas
// [B,Hkv,G,Sq] layout), out [B,Hq,Sq,Dv]; all contiguous. is_bf16 selects
// __nv_bfloat16 q/k/v/out, else float32.
extern "C" {

int a3_sparse_rowmax(const void* q, const void* k, const void* idx,
                     const void* cnt, void* rowmax, int is_bf16, int B,
                     int Hq, int Hkv, int Sq, int Sk, int D, int bq, int bk,
                     int maxb, float scale, int causal, int has_window,
                     int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(Hq, Hkv, Sq, Sk, D, D, bq, bk, maxb, causal,
                              has_window, window);
  if (is_bf16)
    return launch_rowmax<__nv_bfloat16>(q, k, idx, cnt, rowmax, B, g, scale,
                                        st);
  return launch_rowmax<float>(q, k, idx, cnt, rowmax, B, g, scale, st);
}

int a3_sparse_attend(const void* q, const void* k, const void* v,
                     const void* idx, const void* cnt, const void* rowmax,
                     void* out, int is_bf16, int B, int Hq, int Hkv, int Sq,
                     int Sk, int D, int Dv, int bq, int bk, int maxb,
                     float scale, int causal, int has_window, int window,
                     int has_thr, float thr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(Hq, Hkv, Sq, Sk, D, Dv, bq, bk, maxb, causal,
                              has_window, window);
  if (is_bf16)
    return launch_attend<__nv_bfloat16>(q, k, v, idx, cnt, rowmax, out, B, g,
                                        scale, has_thr, thr, st);
  return launch_attend<float>(q, k, v, idx, cnt, rowmax, out, B, g, scale,
                              has_thr, thr, st);
}

}  // extern "C"
