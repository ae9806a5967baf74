// A^3 block-sparse prefill attention for Hopper (sm_90a): two passes,
// each with two routes, each kernel with a plain C entry point loaded
// through ctypes by repro_torch/kernels/a3_attention/kernel.py.
//
//   pass 1 (kernel #5) replaces repro/kernels/a3_attention/kernel.py
//     ::_sparse_rowmax_kernel: the true masked row max over the live kv
//     blocks of each q block
//   pass 2 (kernel #6) replaces ::_sparse_attend_kernel: drop
//     s < rowmax - threshold, exp-sum and P.V over the live blocks;
//     l == 0 -> 0
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
// The wrapper picks one route for both passes before the launch
// (sparse_route), so the row max and the weights sum q.k in one order:
//
//   a3_sparse_rowmax_wgmma,  bf16, D and Dv multiples of 16 up to 128,
//   a3_sparse_attend_wgmma   block_q = block_k = 128, 16-byte aligned:
//                            the tensor-core kernels (rowmax_wgmma_kernel,
//                            attend_wgmma_kernel)
//   a3_sparse_rowmax,        float32 and every other call (head dims up
//   a3_sparse_attend         to 256): the CUDA-core kernels (rowmax_kernel,
//                            attend_kernel)
//
// The tensor-core kernels run on kernel #4's engine (wgmma_attention.cuh):
// a CTA owns the 128 rows of one q block of one q head, in two consumer
// warpgroups of 64 rows, and a producer warpgroup loads Q by TMA, reads
// and compacts the CTA's live list once while Q lands (dead ids and
// blocks wholly above the diagonal or outside the window dropped;
// start_q_and_live_list) and streams only those tiles through a ring.
// Both score with the same issue_s, so a score and the row max it is held
// against are the same float, and threshold 0 keeps each row's maximum.
// attend_wgmma_kernel streams K and V through the 3-stage ring; the row
// max comes from pass 1, so the weights need no online rescale of O:
// p = exp(s - rowmax) for the kept entries, the per-element mask only on
// tiles that cross the diagonal or the window edge, P rounded to bf16 for
// P.V, as #4 does. rowmax_wgmma_kernel streams only K, through its own
// kRowmaxStages-deep ring, takes the tiles in pairs on two accumulator
// sets (S_{j+1} runs while S_j is reduced) and keeps a running max per
// row in registers: no exp, no P.V, no l. The GQA group is not folded
// into the rows: the heads of a group read the same K/V tiles, which L2
// serves.
//
// The CUDA-core kernels are the simple design on attention_tile.cuh: a
// CUDA block reads its own kv_indices row and count (this replaces scalar
// prefetch) and loops only over the `count` live blocks (the TPU grid
// runs maxb steps and predicates the dead ones off). Its 64 rows are
// (query, head) pairs of one q block taken query-major across the GQA
// group — the group folded into the rows, as the Pallas kernel folds it
// into the q tile — so one staging of a live K/V sub-tile serves every
// head of the group. A q block of 128 x G rows spans ceil(128 G / 64)
// CUDA blocks (shared memory holds 64 rows), each reading the map of the
// q block its rows belong to. Sub-tiles that lie wholly above the causal
// diagonal or outside the window for the block's rows are skipped
// (exact: nothing is admitted). Both score with score_tile, in float32
// on the CUDA cores, a thread holding 8 value columns for Dv up to 128
// and 16 up to 256.

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "wgmma_attention.cuh"

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

template <typename T, int NC>
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

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

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

// ---------------------------------------------------------------------------
// the tensor-core route of the attend kernel (bf16, 128 x 128 blocks)
// ---------------------------------------------------------------------------

// Weights of one 64 x 128 score tile held in wgmma accumulator registers
// (element i of a lane at row row_a + 8 * ((i >> 1) & 1) of the
// warpgroup, column c0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1)): raw
// q.k in, p = exp(s - rowmax) out for the kept entries (admitted and
// s >= rowmax - thr, i.e. s >= cut), 0 for the rest; rm2 is the row max
// in the log2 domain; l_a / l_b gather the lane's share of its two rows'
// sums. MASK applies the causal / window mask per element (only tiles
// that cross an edge).
template <bool MASK>
__device__ __forceinline__ void sparse_weights(
    float (&sc)[64], float cut_a, float cut_b, float rm2_a, float rm2_b,
    float& l_a, float& l_b, float scale, int c0, int lane, int pos_a,
    int causal, int has_window, int window) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float s = sc[i] * scale;
    bool keep = s >= ((i & 2) ? cut_b : cut_a);
    if (MASK) {
      const int col = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int pos = pos_a + ((i & 2) ? 8 : 0);
      keep = keep && allowed(pos, col, causal, has_window, window);
    }
    const float p = keep ? hopper::fast_exp2(fmaf(s, wgattn::kLog2e,
                                                  -((i & 2) ? rm2_b : rm2_a)))
                         : 0.f;
    sc[i] = p;
    if (i & 2) l_b += p;
    else l_a += p;
  }
}

// The producer's prologue of both tensor-core kernels, run by its one
// issuing lane: start the TMA load of the CTA's 128 Q rows (NB boxes per
// consumer warpgroup) into q_s, and while they land compact the CTA's
// live list into tiles[] — ids outside [0, Sk / 128) are dead, and so are
// blocks wholly above the causal diagonal or left of the window for the
// CTA's rows [first, last] — then publish its length in *n_tiles and
// release both on list_full. Returns the length.
template <int NB>
__device__ int start_q_and_live_list(
    const CUtensorMap* qmap, unsigned char* q_s, uint64_t* q_full, int q0,
    int bh, const int* __restrict__ kv_idx, const int* __restrict__ kv_cnt,
    long long map, int maxb, int nk, int causal, int has_window,
    int window, int first, int last, int* tiles, int* n_tiles,
    uint64_t* list_full) {
  using namespace hopper;
  using namespace wgattn;
  mbar_expect_tx(q_full, 2 * NB * kQBoxBytes);
  for (int w = 0; w < 2; ++w)
    for (int x = 0; x < NB; ++x)
      tma_load_3d(q_s + (w * NB + x) * kQBoxBytes, qmap, q_full, x * kBox,
                  q0 + w * kWgRows, bh);
  const int count = min(kv_cnt[map], maxb);
  int ntiles = 0;
  for (int c = 0; c < count; ++c) {
    const int jk = kv_idx[map * maxb + c];
    if (jk < 0 || jk >= nk) continue;
    const int c0 = jk * kKeys;
    if (causal && c0 > last) continue;
    if (has_window && c0 + kKeys - 1 <= first - window) continue;
    tiles[ntiles++] = jk;
  }
  *n_tiles = ntiles;
  mbar_arrive(list_full);                             // release: list written
  return ntiles;
}

// Shared memory of attend_wgmma_kernel: flash_wgmma_kernel's (Q, the K/V
// ring, barriers), then the live list's barrier, the CTA's visited block
// ids and their count.
size_t attend_wg_smem_bytes(int nb, int nvb, int maxb) {
  return wgattn::wg_smem_bytes(nb, nvb) + 8 + 4 * ((size_t)maxb + 1);
}

template <int NB, int NVB>
__global__ void __launch_bounds__(wgattn::kWgThreads, 1)
attend_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const int* __restrict__ kv_idx,
                    const int* __restrict__ kv_cnt,
                    const float* __restrict__ rowmax,
                    __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                    int Sk, int Dv, int maxb, float scale, int causal,
                    int has_window, int window, int has_thr, float thr) {
  using namespace hopper;
  using namespace wgattn;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  const WgSmem sm = wg_carve(wg_raw, NB, NVB);
  uint64_t* list_full = sm.empty + kStages;
  int* tiles = reinterpret_cast<int*>(list_full + 1);      // [maxb]
  int* n_tiles = tiles + maxb;
  const int bh = blockIdx.x;                          // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int nq = gridDim.y;
  const int iq = nq - 1 - blockIdx.y;                 // heaviest first
  const int q0 = iq * kQRows;
  const int off = Sk - Sq;                            // query i sits at i + off
  const int first = q0 + off, last = q0 + kQRows - 1 + off;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.k_full + s, 1);
      mbar_init(sm.v_full + s, 1);
      mbar_init(sm.empty + s, 8);                     // one per consumer warp
    }
    mbar_init(list_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup, as in flash_wgmma_kernel, over the live list
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const int ntiles = start_q_and_live_list<NB>(
          &qmap, sm.q, sm.q_full, q0, bh, kv_idx, kv_cnt,
          (long long)bkv * nq + iq, maxb, Sk / kKeys, causal, has_window,
          window, first, last, tiles, n_tiles, list_full);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(sm.empty + s, ((j / kStages) & 1) ^ 1);
        const int c0 = tiles[j] * kKeys;
        mbar_expect_tx(sm.k_full + s, NB * kKVBoxBytes);
        for (int x = 0; x < NB; ++x)
          tma_load_3d(sm.k + (s * NB + x) * kKVBoxBytes, &kmap,
                      sm.k_full + s, x * kBox, c0, bkv);
        mbar_expect_tx(sm.v_full + s, NVB * kKVBoxBytes);
        for (int x = 0; x < NVB; ++x)
          tma_load_3d(sm.v + (s * NVB + x) * kKVBoxBytes, &vmap,
                      sm.v_full + s, x * kBox, c0, bkv);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_a = 16 * warp + lane / 4;             // and row_a + 8
  const int qa = q0 + wg * kWgRows + row_a;
  const int pos_a = qa + off;
  const int pos_first = q0 + wg * kWgRows + off;
  const int pos_last = pos_first + kWgRows - 1;
  const float rm_a = rowmax[(size_t)bh * Sq + qa];
  const float rm_b = rowmax[(size_t)bh * Sq + qa + 8];
  const float no_cut = __int_as_float(0xff800000);         // -inf: keep all
  const float cut_a = has_thr ? rm_a - thr : no_cut;       // keep s >= cut
  const float cut_b = has_thr ? rm_b - thr : no_cut;
  const float rm2_a = rm_a * kLog2e, rm2_b = rm_b * kLog2e;
  const unsigned char* qw = sm.q + wg * NB * kQBoxBytes;
  mbar_wait(list_full, 0);
  const int ntiles = *n_tiles;

  float o[32 * NVB];
#pragma unroll
  for (int i = 0; i < 32 * NVB; ++i) o[i] = 0.f;
  float l_a = 0.f, l_b = 0.f;

  auto issue_qk = [&](float (&sc)[64], int j) {
    const int s = j % kStages;
    mbar_wait(sm.k_full + s, (j / kStages) & 1);
    issue_s<NB>(sc, qw, sm.k + s * NB * kKVBoxBytes);
  };
  auto issue_pv = [&](uint32_t (&pa)[8][4], int j) {
    const int s = j % kStages;
    const unsigned char* vs = sm.v + s * NVB * kKVBoxBytes;
    mbar_wait(sm.v_full + s, (j / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      pv_mma<NVB>(o, pa[kk], sw128_desc(vs + kk * 2048, kKVBoxBytes, 1024));
    wgmma_commit();
  };
  auto weights = [&](float (&sc)[64], int j) {
    const int c0 = tiles[j] * kKeys;
    const bool need_mask = (causal && c0 + kKeys - 1 > pos_first) ||
                           (has_window && c0 <= pos_last - window);
    if (need_mask)
      sparse_weights<true>(sc, cut_a, cut_b, rm2_a, rm2_b, l_a, l_b, scale,
                           c0, lane, pos_a, causal, has_window, window);
    else
      sparse_weights<false>(sc, cut_a, cut_b, rm2_a, rm2_b, l_a, l_b, scale,
                            c0, lane, pos_a, causal, has_window, window);
  };
  auto to_bf16 = [](const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // flash_wgmma_kernel's software pipeline without the rescale (the row
  // max is given): S_j and P_{j-1} V_{j-1} are issued together and the
  // weights of S_j are formed while the tensor cores finish the product.
  float sc[64];
  uint32_t pa[8][4];
  mbar_wait(sm.q_full, 0);
  if (ntiles > 0) {
    fence_regs(sc);
    wgmma_fence();
    issue_qk(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    weights(sc, 0);
    to_bf16(sc, pa);
  }
  for (int j = 1; j < ntiles; ++j) {
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_qk(sc, j);
    issue_pv(pa, j - 1);
    wgmma_wait<1>();                                  // S_j is ready
    fence_regs(sc);
    weights(sc, j);
    wgmma_wait<0>();                                  // P_{j-1} V_{j-1} too
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(sm.empty + (j - 1) % kStages);
    to_bf16(sc, pa);
  }
  if (ntiles > 0) {
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(pa, ntiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }

  // epilogue: l over the quad, O / l (0 where l == 0) in bf16
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
#pragma unroll
  for (int i = 0; i < 32 * NVB; i += 2) {
    const int row = qa + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (col < Dv) {
      const float inv = (i & 2) ? inv_b : inv_a;
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)bh * Sq + row) * Dv + col) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
  }
}

template <int NB, int NVB>
int launch_attend_wgmma(const void* q, const void* k, const void* v,
                        const void* idx, const void* cnt, const void* rowmax,
                        void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                        int D, int Dv, int maxb, float scale, int causal,
                        int has_window, int window, int has_thr, float thr,
                        cudaStream_t stream) {
  using namespace wgattn;
  CUtensorMap qmap, kmap, vmap;
  int e = hopper::make_map(&qmap, q, B * Hq, Sq, D, kWgRows);
  if (e == 0) e = hopper::make_map(&kmap, k, B * Hkv, Sk, D, kKeys);
  if (e == 0) e = hopper::make_map(&vmap, v, B * Hkv, Sk, Dv, kKeys);
  if (e != 0) return e;
  const size_t smem = attend_wg_smem_bytes(NB, NVB, maxb);
  e = prepare(attend_wgmma_kernel<NB, NVB>, smem);
  if (e != 0) return e;
  const dim3 grid(B * Hq, Sq / kQRows);
  attend_wgmma_kernel<NB, NVB><<<grid, kWgThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const float*>(rowmax),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Sk, Dv, maxb, scale,
      causal, has_window, window, has_thr, thr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core route of the row-max kernel (bf16, 128 x 128 blocks)
// ---------------------------------------------------------------------------

// Depth of rowmax_wgmma_kernel's K-only ring: a K tile is 16 KB per box
// of D, so at D = 128 three stages and Q take 128 KB. On an H100 depths
// 3 to 6 ran alike and 2 about 7% slower (tools/rowmax_ring_depth.py).
constexpr int kRowmaxStages = 3;

// The running row max of one 64 x 128 score tile held in wgmma
// accumulator registers (element i of a lane at row row_a + 8 * ((i >> 1)
// & 1) of the warpgroup, column c0 + 8 * (i >> 2) + 2 * (lane % 4) +
// (i & 1)): s = raw q.k * scale exactly as sparse_weights forms it, -1e30
// where masked. MASK applies the causal / window mask per element (only
// tiles that cross an edge).
template <bool MASK>
__device__ __forceinline__ void rowmax_tile(const float (&sc)[64],
                                            float& m_a, float& m_b,
                                            float scale, int c0, int lane,
                                            int pos_a, int causal,
                                            int has_window, int window) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float s = sc[i] * scale;
    if (MASK) {
      const int col = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int pos = pos_a + ((i & 2) ? 8 : 0);
      if (!allowed(pos, col, causal, has_window, window)) s = kNegInf;
    }
    if (i & 2) m_b = fmaxf(m_b, s);
    else m_a = fmaxf(m_a, s);
  }
}

// Shared memory of rowmax_wgmma_kernel, boxes 1024-byte aligned: Q
// [2 WGs][nb], K [kRowmaxStages][nb], then the barriers (Q, live list,
// kRowmaxStages full and empty), the CTA's visited block ids and their
// count.
size_t rowmax_wg_smem_bytes(int nb, int maxb) {
  return 1024 + (size_t)2 * nb * wgattn::kQBoxBytes +
         (size_t)kRowmaxStages * nb * wgattn::kKVBoxBytes +
         8 * (2 + 2 * kRowmaxStages) + 4 * ((size_t)maxb + 1);
}

template <int NB>
__global__ void __launch_bounds__(wgattn::kWgThreads, 1)
rowmax_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const int* __restrict__ kv_idx,
                    const int* __restrict__ kv_cnt,
                    float* __restrict__ rowmax, int Hq, int Hkv, int Sq,
                    int Sk, int maxb, float scale, int causal,
                    int has_window, int window) {
  using namespace hopper;
  using namespace wgattn;
  constexpr int ST = kRowmaxStages;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* k_s = q_s + 2 * NB * kQBoxBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(k_s + ST * NB * kKVBoxBytes);
  uint64_t* list_full = q_full + 1;
  uint64_t* k_full = q_full + 2;                      // [ST]
  uint64_t* empty = k_full + ST;                      // [ST]
  int* tiles = reinterpret_cast<int*>(empty + ST);    // [maxb]
  int* n_tiles = tiles + maxb;
  const int bh = blockIdx.x;                          // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int nq = gridDim.y;
  const int iq = nq - 1 - blockIdx.y;                 // heaviest first
  const int q0 = iq * kQRows;
  const int off = Sk - Sq;                            // query i sits at i + off

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(list_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(empty + s, 8);                        // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: Q and the live list as attend_wgmma_kernel, then
    // only the K tiles
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const int ntiles = start_q_and_live_list<NB>(
          &qmap, q_s, q_full, q0, bh, kv_idx, kv_cnt,
          (long long)bkv * nq + iq, maxb, Sk / kKeys, causal, has_window,
          window, q0 + off, q0 + kQRows - 1 + off, tiles, n_tiles,
          list_full);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(empty + s, ((j / ST) & 1) ^ 1);
        mbar_expect_tx(k_full + s, NB * kKVBoxBytes);
        for (int x = 0; x < NB; ++x)
          tma_load_3d(k_s + (s * NB + x) * kKVBoxBytes, &kmap, k_full + s,
                      x * kBox, tiles[j] * kKeys, bkv);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_a = 16 * warp + lane / 4;             // and row_a + 8
  const int qa = q0 + wg * kWgRows + row_a;
  const int pos_a = qa + off;
  const int pos_first = q0 + wg * kWgRows + off;
  const int pos_last = pos_first + kWgRows - 1;
  const unsigned char* qw = q_s + wg * NB * kQBoxBytes;
  mbar_wait(list_full, 0);
  const int ntiles = *n_tiles;
  float m_a = kNegInf, m_b = kNegInf;

  auto issue_qk = [&](float (&sc)[64], int j) {
    const int s = j % ST;
    mbar_wait(k_full + s, (j / ST) & 1);
    fence_regs(sc);
    wgmma_fence();
    issue_s<NB>(sc, qw, k_s + s * NB * kKVBoxBytes);
  };
  // tile j's stage is released as soon as S_j has read it
  auto reduce = [&](float (&sc)[64], int j) {
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty + j % ST);
    const int c0 = tiles[j] * kKeys;
    const bool need_mask = (causal && c0 + kKeys - 1 > pos_first) ||
                           (has_window && c0 <= pos_last - window);
    if (need_mask)
      rowmax_tile<true>(sc, m_a, m_b, scale, c0, lane, pos_a, causal,
                        has_window, window);
    else
      rowmax_tile<false>(sc, m_a, m_b, scale, c0, lane, pos_a, causal,
                         has_window, window);
  };
  // Tiles go in pairs on two accumulator sets: S_{j+1} runs on the
  // tensor cores while S_j is reduced. Each pair ends with nothing in
  // flight, so no wgmma crosses the loop's back edge (ptxas serialises
  // every wgmma of a kernel where one does).
  float s0[64], s1[64];
  mbar_wait(q_full, 0);
  int j = 0;
  for (; j + 1 < ntiles; j += 2) {
    issue_qk(s0, j);
    issue_qk(s1, j + 1);
    wgmma_wait<1>();                                  // S_j is ready
    reduce(s0, j);
    wgmma_wait<0>();
    reduce(s1, j + 1);
  }
  if (j < ntiles) {
    issue_qk(s0, j);
    wgmma_wait<0>();
    reduce(s0, j);
  }

  // the quad's four lanes share a row: reduce over them, one write a row
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, x));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, x));
  }
  if ((lane & 3) == 0) {
    rowmax[(size_t)bh * Sq + qa] = m_a;
    rowmax[(size_t)bh * Sq + qa + 8] = m_b;
  }
}

template <int NB>
int launch_rowmax_wgmma(const void* q, const void* k, const void* idx,
                        const void* cnt, void* rowmax, int B, int Hq,
                        int Hkv, int Sq, int Sk, int D, int maxb, float scale,
                        int causal, int has_window, int window,
                        cudaStream_t stream) {
  using namespace wgattn;
  CUtensorMap qmap, kmap;
  int e = hopper::make_map(&qmap, q, B * Hq, Sq, D, kWgRows);
  if (e == 0) e = hopper::make_map(&kmap, k, B * Hkv, Sk, D, kKeys);
  if (e != 0) return e;
  const size_t smem = rowmax_wg_smem_bytes(NB, maxb);
  e = prepare(rowmax_wgmma_kernel<NB>, smem);
  if (e != 0) return e;
  const dim3 grid(B * Hq, Sq / kQRows);
  rowmax_wgmma_kernel<NB><<<grid, kWgThreads, smem, stream>>>(
      qmap, kmap, static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<float*>(rowmax), Hq, Hkv, Sq, Sk, maxb, scale, causal,
      has_window, window);
  return (int)cudaGetLastError();
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

template <typename T, int NC>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* idx, const void* cnt, const void* rowmax,
                  void* out, int B, const Geometry& g, float scale,
                  int has_thr, float thr, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.D, g.Dv);
  int e = prepare(attend_kernel<T, NC>, smem);
  if (e != 0) return e;
  attend_kernel<T, NC><<<grid_of(g, B), kThreads, smem, stream>>>(
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
// [B,Hkv,G,Sq] layout), out [B,Hq,Sq,Dv]; all contiguous, D and Dv up to
// 256. is_bf16 selects __nv_bfloat16 q/k/v/out, else float32.
extern "C" {

int a3_sparse_rowmax(const void* q, const void* k, const void* idx,
                     const void* cnt, void* rowmax, int is_bf16, int B,
                     int Hq, int Hkv, int Sq, int Sk, int D, int bq, int bk,
                     int maxb, float scale, int causal, int has_window,
                     int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 256) return (int)cudaErrorInvalidValue;
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
  if (D > 256 || Dv > 256) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(Hq, Hkv, Sq, Sk, D, Dv, bq, bk, maxb, causal,
                              has_window, window);
  auto go = [&](auto fn) {
    return fn(q, k, v, idx, cnt, rowmax, out, B, g, scale, has_thr, thr, st);
  };
  const bool wide = tile::value_cols(Dv) == 16;
  if (is_bf16)
    return wide ? go(launch_attend<__nv_bfloat16, 16>)
                : go(launch_attend<__nv_bfloat16, 8>);
  return wide ? go(launch_attend<float, 16>) : go(launch_attend<float, 8>);
}

// The tensor-core route of the row-max kernel: bf16 q/k as above,
// 16-byte aligned, D a multiple of 16 up to 128, block_q = block_k = 128
// (the wrapper checks). Returns the cudaError_t of the launch.
int a3_sparse_rowmax_wgmma(const void* q, const void* k, const void* idx,
                           const void* cnt, void* rowmax, int B, int Hq,
                           int Hkv, int Sq, int Sk, int D, int maxb,
                           float scale, int causal, int has_window,
                           int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || D > 128 || Sq % wgattn::kQRows != 0 ||
      Sk % wgattn::kKeys != 0)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(q, k, idx, cnt, rowmax, B, Hq, Hkv, Sq, Sk, D, maxb, scale,
              causal, has_window, window, st);
  };
  return D > 64 ? go(launch_rowmax_wgmma<2>) : go(launch_rowmax_wgmma<1>);
}

// The tensor-core route of the attend kernel: bf16 q/k/v/out as above,
// 16-byte aligned, D and Dv multiples of 16 up to 128, block_q = block_k
// = 128 (the wrapper checks). Returns the cudaError_t of the launch.
int a3_sparse_attend_wgmma(const void* q, const void* k, const void* v,
                           const void* idx, const void* cnt,
                           const void* rowmax, void* out, int B, int Hq,
                           int Hkv, int Sq, int Sk, int D, int Dv, int maxb,
                           float scale, int causal, int has_window,
                           int window, int has_thr, float thr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || Dv % 16 != 0 || D > 128 || Dv > 128 ||
      Sq % wgattn::kQRows != 0 || Sk % wgattn::kKeys != 0)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(q, k, v, idx, cnt, rowmax, out, B, Hq, Hkv, Sq, Sk, D, Dv,
              maxb, scale, causal, has_window, window, has_thr, thr, st);
  };
  if (D > 64)
    return Dv > 64 ? go(launch_attend_wgmma<2, 2>)
                   : go(launch_attend_wgmma<2, 1>);
  return Dv > 64 ? go(launch_attend_wgmma<1, 2>)
                 : go(launch_attend_wgmma<1, 1>);
}

}  // extern "C"
