// Causal / sliding-window GQA flash attention for Hopper (sm_90a), with
// plain C entry points loaded through ctypes by
// repro_torch/kernels/flash_attention/kernel.py. Two kernels, one per
// route; the wrapper picks the route from dtype and head dims before the
// launch:
//
//   flash_attention_fwd_wgmma  bf16, D and Dv multiples of 16 up to 128,
//                              16-byte aligned inputs, a positive scale:
//                              the tensor-core kernel (flash_wgmma_kernel)
//   flash_attention_fwd        float32 and every other call (head dims
//                              up to 256): the CUDA-core kernel
//                              (flash_kernel)
//
// Both replace repro/kernels/flash_attention/kernel.py::_flash_kernel
// (online softmax over kv tiles; query rows offset by seq_k - seq_q;
// l == 0 -> 0). Semantics follow the Pallas kernel: s = (q . k) * scale
// in float32 (the scale applied after the dot), masked scores at -1e30,
// running max m, sum l and accumulator rescaled by exp(m_prev - m_new),
// output acc / l in q's dtype and 0 where l == 0.
//
// Bound: at the prefill shape (B=1, Hq=24, Hkv=8, S=2048, D=128, bf16,
// causal) the admitted pairs need 4*D flops each, 25.8 GFLOP, 26 us at
// 989 TFLOP/s, against 34 MB of q/k/v/out (10 us at 3.35 TB/s): the
// kernel is bound by operations, i.e. by the tensor cores.
//
// flash_wgmma_kernel (the bf16 route) puts both products on the tensor
// cores (its CTA shape, K/V ring and P.V product live in
// wgmma_attention.cuh, which a3_attention.cu's tensor-core attend kernel
// shares). A CTA owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each and one producer warpgroup, which hands its
// registers to the consumers (setmaxnreg 24 / 240: the accumulators of S,
// O and P need ~180 a thread) and has one lane load the CTA's Q once and
// stream 128-key K and V tiles through a 3-stage ring with TMA (128-byte
// swizzle, 64-column boxes, mbarriers with transaction counts; rows past
// Sk and columns past D arrive as zeros). Each consumer computes
// S = Q K^T with wgmma m64n128k16 (Q and K from shared memory, both
// K-major), runs the online softmax on the accumulator registers (exp2
// on the special-function unit, the scale folded into one FFMA, the
// per-element mask only on tiles that cross the causal diagonal, the
// window edge or Sk), converts P to bf16 in registers and accumulates
// O += P V with wgmma (P as the register A operand, V the MN-major B
// operand). The loop is software-pipelined: S_j and P_{j-1} V_{j-1} are
// issued together and the softmax of S_j runs while the tensor cores
// finish P_{j-1} V_{j-1}. The loop covers only the kv tiles the causal
// diagonal and the window admit for the CTA's rows, and the grid runs
// the heaviest causal query blocks first. What bounds it now is the
// softmax's share of the special-function unit and issue slots beside
// the wgmma (about half of each tile's time on an H100).
//
// Precision: P is rounded to bf16 before P.V (the Pallas kernel and
// flash_kernel multiply in float32); scores, m, l and O stay float32.
// Against the plain version that is a relative error of about 2^-9 per
// weight, inside the 2e-2 bf16 tolerance.
//
// flash_kernel (float32 and other head dims, D and Dv up to 256) is the
// simple CUDA-core design: a block owns 64 query rows and loops over
// 64-key tiles of the admitted column range; scores and P.V run in
// float32 through shared-memory tiles (attention_tile.cuh), a thread
// holding 8 value columns for Dv up to 128 and 16 up to 256 (at
// D = Dv = 256 the tiles take 147 KB of shared memory, one block an SM).

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace tile;
using namespace wgattn;

template <typename T, int NC>
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

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

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

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int Dv, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  int e = prepare(flash_kernel<T, NC>, smem);
  if (e != 0) return e;
  const dim3 grid((Sq + kRows - 1) / kRows, B * Hq);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk, D, Dv,
      scale, causal, has_window, window);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// the tensor-core route (bf16)
// ---------------------------------------------------------------------------

// Online softmax of one 64 x 128 score tile held in wgmma accumulator
// registers: element i of a lane sits at row row_a + 8 * ((i >> 1) & 1)
// of the warpgroup and column c0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1),
// so a row's 128 columns spread over the 4 lanes of a quad. Raw scores
// in, probabilities out; m is kept in the log2 domain (scale * log2 e
// folded into one FFMA per element), l as this lane's share of the row;
// al_a / al_b return the rescale factors of the lane's two rows.
// MASK applies the causal / window / Sk mask per element (only tiles
// that cross an edge); masked entries get weight 0 even while their
// whole row is masked (m at its initial value).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[64], float& m_a, float& m_b, float& l_a, float& l_b,
    float& al_a, float& al_b, float scale2, int c0, int lane, int pos_a,
    int Sk, int causal, int has_window, int window) {
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (MASK) {
      const int col = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int pos = pos_a + ((i & 2) ? 8 : 0);
      if (!(col < Sk && allowed(pos, col, causal, has_window, window)))
        sc[i] = kNegInf;
    }
    if (i & 2) mx_b = fmaxf(mx_b, sc[i]);
    else mx_a = fmaxf(mx_a, sc[i]);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
  }
  const float mn_a = fmaxf(m_a, mx_a * scale2);
  const float mn_b = fmaxf(m_b, mx_b * scale2);
  al_a = hopper::fast_exp2(m_a - mn_a);
  al_b = hopper::fast_exp2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float mn = (i & 2) ? mn_b : mn_a;
    float p = hopper::fast_exp2(fmaf(sc[i], scale2, -mn));
    if (MASK && sc[i] == kNegInf) p = 0.f;
    sc[i] = p;
    if (i & 2) ps_b += p;
    else ps_a += p;
  }
  l_a = l_a * al_a + ps_a;
  l_b = l_b * al_b + ps_b;
}

template <int NB, int NVB>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                   int Sk, int Dv, float scale, int causal, int has_window,
                   int window) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  const WgSmem sm = wg_carve(wg_raw, NB, NVB);
  const int bh = blockIdx.x;                          // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;   // heaviest first
  const int off = Sk - Sq;                            // query i sits at i + off

  // the kv tiles any row of the CTA admits: [t0, t0 + ntiles * kKeys)
  const int first = q0 + off;
  const int last = min(q0 + kQRows, Sq) - 1 + off;
  const int hi = causal ? min(Sk, last + 1) : Sk;
  const int lo = has_window ? max(0, first - window + 1) : 0;
  const int t0 = (lo / kKeys) * kKeys;
  const int ntiles = hi > lo ? (hi - t0 + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.k_full + s, 1);
      mbar_init(sm.v_full + s, 1);
      mbar_init(sm.empty + s, 8);                     // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: gives its registers to the consumers; one lane
    // issues every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(sm.q_full, 2 * NB * kQBoxBytes);
      for (int w = 0; w < 2; ++w)
        for (int x = 0; x < NB; ++x)
          tma_load_3d(sm.q + (w * NB + x) * kQBoxBytes, &qmap, sm.q_full,
                      x * kBox, q0 + w * kWgRows, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(sm.empty + s, ((j / kStages) & 1) ^ 1);
        const int c0 = t0 + j * kKeys;
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
  const int pos_a = q0 + wg * kWgRows + row_a + off;
  const int pos_first = q0 + wg * kWgRows + off;
  const int pos_last = pos_first + kWgRows - 1;
  const float scale2 = scale * kLog2e;                // exp(x) = exp2(x log2 e)
  const unsigned char* qw = sm.q + wg * NB * kQBoxBytes;

  float o[32 * NVB];
#pragma unroll
  for (int i = 0; i < 32 * NVB; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float al_a = 1.f, al_b = 1.f;           // the last softmax's rescales

  // S_j = Q K_j^T once tile j has landed: issued, not waited for
  auto issue_qk = [&](float (&sc)[64], int j) {
    const int s = j % kStages;
    mbar_wait(sm.k_full + s, (j / kStages) & 1);
    issue_s<NB>(sc, qw, sm.k + s * NB * kKVBoxBytes);
  };
  // O += P_j V_j (V MN-major: 8-key groups 1024 B apart, 64-column boxes
  // kKVBoxBytes apart; a k16 step is 16 keys = 2048 B): issued
  auto issue_pv = [&](uint32_t (&pa)[8][4], int j) {
    const int s = j % kStages;
    const unsigned char* vs = sm.v + s * NVB * kKVBoxBytes;
    mbar_wait(sm.v_full + s, (j / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      pv_mma<NVB>(o, pa[kk], sw128_desc(vs + kk * 2048, kKVBoxBytes, 1024));
    wgmma_commit();
  };
  auto softmax = [&](float (&sc)[64], int j) {
    const int c0 = t0 + j * kKeys;
    const bool need_mask = c0 + kKeys > Sk ||
                           (causal && c0 + kKeys - 1 > pos_first) ||
                           (has_window && c0 <= pos_last - window);
    if (need_mask)
      softmax_tile<true>(sc, m_a, m_b, l_a, l_b, al_a, al_b, scale2, c0,
                         lane, pos_a, Sk, causal, has_window, window);
    else
      softmax_tile<false>(sc, m_a, m_b, l_a, l_b, al_a, al_b, scale2, c0,
                          lane, pos_a, Sk, causal, has_window, window);
  };
  auto to_bf16 = [](const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // Software pipeline: while the tensor cores run P_{j-1} V_{j-1}, the
  // warpgroup runs the softmax of S_j, which was issued just before it.
  // O is rescaled by tile j-1's alpha before P_{j-1} V_{j-1} is issued,
  // and P_j is written only after that product has read P_{j-1}.
  float sc[64];
  uint32_t pa[8][4];
  mbar_wait(sm.q_full, 0);
  if (ntiles > 0) {
    fence_regs(sc);
    wgmma_fence();
    issue_qk(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, 0);
    to_bf16(sc, pa);
  }
  for (int j = 1; j < ntiles; ++j) {
#pragma unroll
    for (int i = 0; i < 32 * NVB; ++i) o[i] *= (i & 2) ? al_b : al_a;
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_qk(sc, j);
    issue_pv(pa, j - 1);
    wgmma_wait<1>();                                  // S_j is ready
    fence_regs(sc);
    softmax(sc, j);
    wgmma_wait<0>();                                  // P_{j-1} V_{j-1} too
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(sm.empty + (j - 1) % kStages);
    to_bf16(sc, pa);
  }
  if (ntiles > 0) {
#pragma unroll
    for (int i = 0; i < 32 * NVB; ++i) o[i] *= (i & 2) ? al_b : al_a;
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
  const int qa = q0 + wg * kWgRows + row_a;
#pragma unroll
  for (int i = 0; i < 32 * NVB; i += 2) {
    const int row = qa + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < Sq && col < Dv) {
      const float inv = (i & 2) ? inv_b : inv_a;
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)bh * Sq + row) * Dv + col) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
  }
}

template <int NB, int NVB>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
                 float scale, int causal, int has_window, int window,
                 cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int e = hopper::make_map(&qmap, q, B * Hq, Sq, D, kWgRows);
  if (e == 0) e = hopper::make_map(&kmap, k, B * Hkv, Sk, D, kKeys);
  if (e == 0) e = hopper::make_map(&vmap, v, B * Hkv, Sk, Dv, kKeys);
  if (e != 0) return e;
  const size_t smem = wg_smem_bytes(NB, NVB);
  e = prepare(flash_wgmma_kernel<NB, NVB>, smem);
  if (e != 0) return e;
  const dim3 grid(B * Hq, (Sq + kQRows - 1) / kQRows);
  flash_wgmma_kernel<NB, NVB><<<grid, kWgThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Sk,
      Dv, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: pointers and the stream as void*, shapes as int; returns
// the cudaError_t of the launch (0 = success). q [B,Hq,Sq,D], k [B,Hkv,Sk,D],
// v [B,Hkv,Sk,Dv], out [B,Hq,Sq,Dv], all contiguous, D and Dv up to 256;
// is_bf16 selects __nv_bfloat16 inputs and output, else float32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int is_bf16, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int Dv,
                                   float scale, int causal, int has_window,
                                   int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 256 || Dv > 256) return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, Dv, scale, causal,
              has_window, window, st);
  };
  const bool wide = tile::value_cols(Dv) == 16;
  if (is_bf16)
    return wide ? go(launch<__nv_bfloat16, 16>) : go(launch<__nv_bfloat16, 8>);
  return wide ? go(launch<float, 16>) : go(launch<float, 8>);
}

// The tensor-core route: bf16 q [B,Hq,Sq,D], k [B,Hkv,Sk,D],
// v [B,Hkv,Sk,Dv], out [B,Hq,Sq,Dv], contiguous and 16-byte aligned, D and
// Dv multiples of 16 up to 128 (the wrapper checks). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Hq, int Hkv, int Sq, int Sk,
                                         int D, int Dv, float scale,
                                         int causal, int has_window,
                                         int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || Dv % 16 != 0 || D > 128 || Dv > 128)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, Dv, scale, causal,
              has_window, window, st);
  };
  if (D > 64)
    return Dv > 64 ? go(launch_wgmma<2, 2>) : go(launch_wgmma<2, 1>);
  return Dv > 64 ? go(launch_wgmma<1, 2>) : go(launch_wgmma<1, 1>);
}
