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
// 2.5 us at 3.35 TB/s; the dots are 0.2 MFLOP per (batch, kv head).
//
// Fused kernel design (fused_cluster_kernel): with one block per
// (batch, kv head) only B*Hkv = 32 blocks would run on 132 SMs, each
// load-latency bound. So a thread-block cluster of C <= 4 CTAs serves
// each (batch, kv head): 128 CTAs at the serving shape. Each CTA owns a
// contiguous C-th of every block_k tile, and the tiles go in order. A
// CTA stages its K and V rows with cp.async.bulk into a ring of
// shared-memory slots (all 64 KB of a CTA in flight at S=512), scores
// its keys for the G query rows on the CUDA cores in float32 (8 lanes a
// key row with 16-byte loads, so a warp reduces 4 dots at once in 3
// shuffle steps), and publishes its row maxima; after cluster.sync()
// every CTA reads the others' maxima through distributed shared memory
// and forms the same m_cur, so the kept set is the Pallas kernel's (a
// flash-decoding split would test each part against its own max and keep
// another set). Each CTA rescales its partial l and acc by the shared
// alpha and reads its V rows once for every 4 of the G rows (a thread
// owns two value columns); at the end every CTA stores its partials into
// rank 0's shared memory and rank 0 sums them and writes the output. The
// wrapper picks C from (S, block_k) so that every CTA keeps at least 32
// keys of a tile. What bounds it now is latency, not bytes: the first
// loads' round trip, the per-tile cluster barrier and the launch.
//
// Two-pass kernels (simple and right, not fast yet): one thread block
// per (batch, kv head) walks the ring tile by tile. A warp scores one key
// row against all G query rows (the key row is read once into registers
// and reduced over D with warp shuffles), the [G, block_k] float32 tile
// sits in shared memory, one warp per query row reduces the tile max (or
// applies pass 1's row max) with the mask, threshold and exp, and all
// threads then accumulate P.V for their (row, column) pairs. Loads are
// plain global reads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// fused kernel (#1): a thread-block cluster per (batch, kv head)
// ---------------------------------------------------------------------------

constexpr int kSlotBytes = 32 * 1024;     // most bytes of one staged chunk
constexpr int kRingBytes = 160 * 1024;    // shared memory for the K/V ring
constexpr int kMaxCluster = 8;
constexpr int kKeyLanes = 8;              // lanes that score one key row

// Where the pieces of the fused kernel's shared memory start, for G query
// rows, n keys per CTA and tile, a cluster of C and rows of esz-byte
// elements; vec: rows are 16-byte aligned (vector loads, V read as
// column pairs).
struct FusedLayout {
  size_t ring, q, s, acc, red, lmax, m, l, alpha, mask, total;
  int ns, slot, cr, nch, ngroups, mask_tiles;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline FusedLayout fused_layout(int G, int D, int Dv,
                                                    int n, int ntiles, int C,
                                                    int esz, int vec) {
  FusedLayout f;
  const int width = (D > Dv ? D : Dv) * esz;        // bytes of a row
  f.cr = kSlotBytes / width;                        // rows of a chunk
  if (f.cr > n) f.cr = n;
  if (f.cr < 1) f.cr = 1;
  f.nch = (n + f.cr - 1) / f.cr;
  f.slot = (int)align16((size_t)f.cr * width);
  const int nseg = 2 * f.nch * ntiles;
  f.ns = kRingBytes / f.slot;
  if (f.ns > nseg) f.ns = nseg;
  if (f.ns < 1) f.ns = 1;
  const int cols = vec ? Dv / 2 : Dv;               // column slots of P.V
  f.ngroups = kThreads / cols > 0 ? kThreads / cols : 1;
  // the mask of all of the CTA's tiles when it is small, else one tile
  f.mask_tiles = (size_t)G * n * ntiles <= 16 * 1024 ? ntiles : 1;
  size_t o = align16((size_t)f.ns * 8);             // the ring's mbarriers
  f.ring = o;
  o += (size_t)f.ns * f.slot;
  f.q = o;      o = align16(o + sizeof(float) * G * D);
  f.s = o;      o = align16(o + sizeof(float) * G * n);
  f.acc = o;    o = align16(o + sizeof(float) * f.ngroups * G * Dv);
  f.red = o;    o = align16(o + sizeof(float) * C * G * (Dv + 1));
  f.lmax = o;   o = align16(o + sizeof(float) * 2 * G);
  f.m = o;      o = align16(o + sizeof(float) * G);
  f.l = o;      o = align16(o + sizeof(float) * G);
  f.alpha = o;  o = align16(o + sizeof(float) * G);
  f.mask = o;   o = align16(o + (size_t)G * n * f.mask_tiles);
  f.total = o;
  return f;
}

// Segment i of a CTA's stream: tile i / (2 nch); within a tile first the
// nch chunks of K rows, then the nch chunks of V rows.
struct Segment {
  const unsigned char* src;
  int rows, bytes;
};

template <typename T>
__device__ __forceinline__ Segment segment(
    int i, const FusedLayout& f, const T* k, const T* v, size_t kv0, int bk,
    int n, int rank, int D, int Dv) {
  const int per = 2 * f.nch, t = i / per, c = (i % per) % f.nch;
  const bool is_v = (i % per) >= f.nch;
  const int r0 = c * f.cr;
  Segment g;
  g.rows = min(f.cr, n - r0);
  const size_t key = kv0 + (size_t)t * bk + (size_t)rank * n + r0;
  const int w = is_v ? Dv : D;
  g.src = reinterpret_cast<const unsigned char*>((is_v ? v : k) + key * w);
  g.bytes = g.rows * w * (int)sizeof(T);
  return g;
}

// 16 bytes of a row as floats (8 bf16 or 4 float32); a bf16 is the top
// half of its float32, so widening is a shift (exact, and no register
// has its address taken).
__device__ __forceinline__ void widen(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// s_s[g * n + j] = scale * (q_g . k_j) for the rows of one staged K chunk
// (16-byte aligned rows): 8 lanes share a key row, each reading 16 bytes
// at a time, so a warp scores 4 keys at once and reduces each dot in 3
// shuffle steps.
template <typename T>
__device__ __forceinline__ void score_chunk_vec(const T* ks, int rows,
                                                int r0, const float* q_s,
                                                float* s_s, int G, int D,
                                                int n, float scale) {
  constexpr int E = 16 / sizeof(T);                 // elements per load
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / kKeyLanes, part = lane % kKeyLanes;
  for (int j0 = warp * 4; j0 < rows; j0 += kWarps * 4) {
    const int j = j0 + sub;
    const bool has = j < rows;
    for (int g0 = 0; g0 < G; g0 += 4) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (has) {
        for (int c = part * E; c < D; c += kKeyLanes * E) {
          float x[E];
          widen(*reinterpret_cast<const uint4*>(ks + (size_t)j * D + c), x);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (g0 + u < G) {
              const float4* qg =
                  reinterpret_cast<const float4*>(q_s + (g0 + u) * D + c);
#pragma unroll
              for (int e = 0; e < E / 4; ++e) {
                const float4 qv = qg[e];
                a[u] += qv.x * x[4 * e] + qv.y * x[4 * e + 1] +
                        qv.z * x[4 * e + 2] + qv.w * x[4 * e + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int o = kKeyLanes / 2; o > 0; o >>= 1)
          a[u] += __shfl_xor_sync(0xffffffffu, a[u], o);
      if (has && part == 0)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (g0 + u < G) s_s[(g0 + u) * n + r0 + j] = a[u] * scale;
    }
  }
}

// The same for rows that are not 16-byte aligned: a warp per key row,
// lanes over D.
template <typename T>
__device__ __forceinline__ void score_chunk_scalar(const T* ks, int rows,
                                                   int r0, const float* q_s,
                                                   float* s_s, int G, int D,
                                                   int n, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < rows; j += kWarps) {
    const T* kr = ks + (size_t)j * D;
    float kv[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? to_f32(kr[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * D;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) a += qg[d] * kv[i];
      }
      a = warp_sum(a);
      if (lane == 0) s_s[g * n + r0 + j] = a * scale;
    }
  }
}

__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// acc = acc * alpha (first chunk of a tile) + P V over one staged V
// chunk. vec: thread (grp, c) owns value columns 2c, 2c + 1 and the
// grp-th contiguous share of the chunk's rows; else thread (grp, c) owns
// column c and rows grp, grp + ngroups, ... Up to 4 query rows at a
// time, so each V element is read once per 4 rows.
template <typename T>
__device__ __forceinline__ void pv_chunk(const T* vs, int rows, int r0,
                                         const float* s_s, float* acc_s,
                                         const float* a_s, int G, int Dv,
                                         int n, int ngroups, bool first,
                                         bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int cols = Dv / 2, grp = tid / cols, c = tid % cols;
    if (grp >= ngroups) return;
    const int per = (rows + ngroups - 1) / ngroups;
    const int lo = grp * per, hi = min(rows, lo + per);
    for (int g0 = 0; g0 < G; g0 += 4) {
      float a[4][2] = {};
#pragma unroll 4
      for (int j = lo; j < hi; ++j) {
        const float2 x = pair_f32(vs + (size_t)j * Dv + 2 * c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (g0 + u < G) {
            const float p = s_s[(g0 + u) * n + r0 + j];
            a[u][0] += p * x.x;
            a[u][1] += p * x.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (g0 + u >= G) break;
        float2* acc = reinterpret_cast<float2*>(
            acc_s + ((size_t)grp * G + g0 + u) * Dv + 2 * c);
        float2 y = *acc;
        const float al = first ? a_s[g0 + u] : 1.f;
        y.x = y.x * al + a[u][0];
        y.y = y.y * al + a[u][1];
        *acc = y;
      }
    }
    return;
  }
  const int grp = tid / Dv, dv = tid % Dv;
  if (grp >= ngroups) return;
  for (int g0 = 0; g0 < G; g0 += 4) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = grp; j < rows; j += ngroups) {
      const float x = to_f32(vs[(size_t)j * Dv + dv]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g0 + u < G) a[u] += s_s[(g0 + u) * n + r0 + j] * x;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (g0 + u >= G) break;
      float* acc = acc_s + ((size_t)grp * G + g0 + u) * Dv + dv;
      *acc = (first ? *acc * a_s[g0 + u] : *acc) + a[u];
    }
  }
}

// One CTA of a cluster of C owns keys [rank n, (rank + 1) n) of every
// block_k tile (n = bk / C). Per tile it scores its keys for the G query
// rows, publishes its row maxima, and after cluster.sync() reads the
// other CTAs' maxima through distributed shared memory, so every CTA
// forms the same m_cur = max(m_prev, max of the whole tile) and applies
// the same threshold and rescale as the Pallas kernel. At the end each
// CTA stores its partial acc and l into rank 0's shared memory, and after
// one more cluster.sync() rank 0 sums them and writes the output. K and V
// rows arrive as contiguous chunks through cp.async.bulk into a ring of
// shared-memory slots (all of a CTA's chunks in flight when they fit), or
// with plain loads when the rows are not 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, int Hq, int Hkv, int S, int D,
                     int Dv, int bk, float scale, int has_thr, float thr,
                     int vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int n = bk / C, ntiles = S / bk;
  const FusedLayout f =
      fused_layout(G, D, Dv, n, ntiles, C, (int)sizeof(T), vec);
  extern __shared__ __align__(16) unsigned char fsm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(fsm);
  unsigned char* ring = fsm + f.ring;
  float* q_s = reinterpret_cast<float*>(fsm + f.q);         // [G, D]
  float* s_s = reinterpret_cast<float*>(fsm + f.s);         // [G, n]
  float* acc_s = reinterpret_cast<float*>(fsm + f.acc);     // [ngroups, G, Dv]
  float* red_s = reinterpret_cast<float*>(fsm + f.red);     // [C, G, Dv + 1]
  float* lmax_s = reinterpret_cast<float*>(fsm + f.lmax);   // [2, G]
  float* m_s = reinterpret_cast<float*>(fsm + f.m);         // [G]
  float* l_s = reinterpret_cast<float*>(fsm + f.l);         // [G]
  float* a_s = reinterpret_cast<float*>(fsm + f.alpha);     // [G]
  uint8_t* mk_s = fsm + f.mask;                             // [tiles, G, n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;       // first query row
  const size_t kv0 = ((size_t)b * Hkv + h) * S;             // first ring row
  const int nseg = 2 * f.nch * ntiles;

  if (vec && tid == 0) {
    for (int i = 0; i < f.ns; ++i) hopper::mbar_init(bars + i, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (vec && tid == 0) {
    for (int i = 0; i < f.ns; ++i) {                // every slot in flight
      const Segment g = segment(i, f, k, v, kv0, bk, n, rank, D, Dv);
      hopper::mbar_expect_tx(bars + i, g.bytes);
      hopper::bulk_load(ring + (size_t)i * f.slot, g.src, g.bytes, bars + i);
    }
  }
  // q and the mask of the first tiles, read while the first chunks fly
  auto load_mask = [=](int t) {
    const int nt = min(f.mask_tiles, ntiles - t);
    const size_t col0 = (size_t)t * bk + (size_t)rank * n;
    for (int e = tid; e < nt * G * n; e += kThreads) {
      const int tt = e / (G * n), g = (e / n) % G, j = e % n;
      mk_s[e] = mask[(row0 + g) * S + col0 + (size_t)tt * bk + j];
    }
  };
  load_mask(0);
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(q[row0 * D + i]);
  for (int i = tid; i < f.ngroups * G * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // wait for (or, without bulk copies, load) segment i; returns its slot
  auto acquire = [=](int i) -> const T* {
    unsigned char* slot = ring + (size_t)(i % f.ns) * f.slot;
    if (vec) {
      hopper::mbar_wait(bars + i % f.ns, (uint32_t)((i / f.ns) & 1));
    } else {
      const Segment g = segment(i, f, k, v, kv0, bk, n, rank, D, Dv);
      const T* src = reinterpret_cast<const T*>(g.src);
      T* dst = reinterpret_cast<T*>(slot);
      for (int e = tid; e < g.bytes / (int)sizeof(T); e += kThreads)
        dst[e] = src[e];
      __syncthreads();
    }
    return reinterpret_cast<const T*>(slot);
  };
  // after every thread is done with segment i: refill its slot
  auto release = [=](int i) {
    __syncthreads();
    if (vec && tid == 0 && i + f.ns < nseg) {
      const int j = i + f.ns;
      const Segment g = segment(j, f, k, v, kv0, bk, n, rank, D, Dv);
      hopper::mbar_expect_tx(bars + j % f.ns, g.bytes);
      hopper::bulk_load(ring + (size_t)(j % f.ns) * f.slot, g.src, g.bytes,
                        bars + j % f.ns);
    }
  };

  int seg = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0 && t % f.mask_tiles == 0) load_mask(t);   // seen after a sync
    const uint8_t* mk = mk_s + (size_t)(t % f.mask_tiles) * G * n;

    // scores of this CTA's n keys
    for (int c = 0; c < f.nch; ++c, ++seg) {
      const T* ks = acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      if (vec)
        score_chunk_vec(ks, rows, r0, q_s, s_s, G, D, n, scale);
      else
        score_chunk_scalar(ks, rows, r0, q_s, s_s, G, D, n, scale);
      release(seg);
    }

    // this CTA's masked row maxima, then the whole tile's through DSMEM
    float* lm = lmax_s + (t & 1) * G;
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32)
        mx = fmaxf(mx, mk[g * n + j] ? s_s[g * n + j] : kNegInf);
      mx = warp_max(mx);
      if (lane == 0) lm[g] = mx;
    }
    cluster.sync();
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      if (lane < C) mx = cluster.map_shared_rank(lm, lane)[g];
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float sv = s_s[g * n + j];
        bool keep = mk[g * n + j] != 0;
        if (has_thr) keep = keep && (sv >= m_cur - thr);
        const float p = keep ? expf(sv - m_cur) : 0.f;
        s_s[g * n + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;             // this CTA's share
        m_s[g] = m_cur;
      }
    }
    __syncthreads();

    for (int c = 0; c < f.nch; ++c, ++seg) {
      const T* vs = acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      pv_chunk(vs, rows, r0, s_s, acc_s, a_s, G, Dv, n, f.ngroups, c == 0,
               vec != 0);
      release(seg);
    }
  }

  // this CTA's acc over its thread groups and its l, into rank 0's
  // shared memory; rank 0 sums the cluster's partials
  float* red0 = cluster.map_shared_rank(red_s, 0) +
                (size_t)rank * G * (Dv + 1);
  for (int i = tid; i < G * Dv; i += kThreads) {
    float a = acc_s[i];
    for (int grp = 1; grp < f.ngroups; ++grp)
      a += acc_s[(size_t)grp * G * Dv + i];
    red0[i] = a;
  }
  for (int g = tid; g < G; g += kThreads) red0[G * Dv + g] = l_s[g];
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < G * Dv; i += kThreads) {
      const int g = i / Dv;
      float a = 0.f, l = 0.f;
      for (int r = 0; r < C; ++r) {
        const float* part = red_s + (size_t)r * G * (Dv + 1);
        a += part[i];
        l += part[G * Dv + g];
      }
      out[row0 * Dv + i] = from_f32<T>(l == 0.f ? 0.f : a / l);
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

template <typename T>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* mask, void* out, int B, int Hq, int Hkv, int S,
                 int D, int Dv, int bk, int cluster, float scale, int has_thr,
                 float thr, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (cluster < 1 || cluster > kMaxCluster || bk % cluster != 0 ||
      S % bk != 0 || D > kMaxD || Dv > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int n = bk / cluster;
  const int esz = (int)sizeof(T);
  const int vec = (reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   (D * esz) % 16 == 0 && (Dv * esz) % 16 == 0) ? 1 : 0;
  const FusedLayout f =
      fused_layout(G, D, Dv, n, S / bk, cluster, esz, vec);
  int e = prepare(fused_cluster_kernel<T>, f.total);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = f.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t r = cudaLaunchKernelEx(
      &cfg, fused_cluster_kernel<T>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), Hq, Hkv, S, D,
      Dv, bk, scale, has_thr, thr, vec);
  if (r != cudaSuccess) return (int)r;
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
                           int cluster, float scale, int has_thr, float thr,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fused<__nv_bfloat16>(q, k, v, mask, out, B, Hq, Hkv, S, D,
                                       Dv, bk, cluster, scale, has_thr, thr,
                                       st);
  return launch_fused<float>(q, k, v, mask, out, B, Hq, Hkv, S, D, Dv, bk,
                             cluster, scale, has_thr, thr, st);
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
