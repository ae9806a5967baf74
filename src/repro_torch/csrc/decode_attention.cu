// Decode attention with A^3 masking for Hopper (sm_90a): one new query
// per sequence against an S-row KV ring, the GQA group's G query rows
// scored together. Three kernels, each with a plain C entry point
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
// All three kernels run a thread-block cluster of C CTAs per (batch, kv
// head) (one block per pair would leave B*Hkv = 32 blocks on 132 SMs,
// each load-latency bound) and share one machinery (Ring): a CTA streams
// its K and V rows in contiguous chunks with cp.async.bulk into a ring
// of shared-memory slots, one mbarrier a slot, every slot in flight from
// the start; it scores its keys for the G query rows on the CUDA cores in
// float32 with one scoring function (score_chunk: KL lanes a key row, 8
// at D=128, each holding 16 columns of 4 query rows in registers and
// reading the row once in 16-byte loads, the dots reduced by a butterfly
// over the KL lanes; a warp a row when the rows are not 16-byte aligned),
// and reads each V element once for every 4 of the G rows, their 4
// weights in one load (pv_chunk; scores sit key-major, sidx). At the end
// each CTA stores its partials into rank 0's shared memory through
// distributed shared memory, and after one cluster.sync() rank 0 reduces
// them and writes the output. The scoring loop is straight code (no
// branch around a row's dot, lanes per key a template argument):
// branches there made the compiler run the rows' FMA chains one after
// another, several times slower.
//
// Fused kernel (fused_cluster_kernel): each CTA owns a contiguous C-th
// of every block_k tile, and the tiles go in order; per tile the CTAs
// publish their row maxima and after cluster.sync() every CTA reads the
// others' and forms the same m_cur, so the kept set is the Pallas
// kernel's (a flash-decoding split would test each part against its own
// max and keep another set), then rescales its partial l and acc by the
// shared alpha. The wrapper picks C from (S, block_k) so that every CTA
// keeps at least 32 keys of a tile. What bounds it is latency: the first
// loads' round trip, the per-tile cluster barrier and the launch.
//
// Two-pass kernels (rowmax_cluster_kernel, attend_cluster_kernel): pass 1
// takes a max over the whole ring (associative and exact) and pass 2
// tests every score against pass 1's row max, an input, so the kept set
// does not depend on how the ring is split. Each CTA therefore owns a
// contiguous S/C of the ring's rows and walks it with no cluster barrier
// on the way: #2 keeps its masked row maxima, #3 keeps l and P.V of
// p = keep ? exp(s - rowmax) : 0 with no rescale; one reduction ends
// each. block_k does not shape them (the wrapper picks C from S, at most
// 4: 128 CTAs at the serving shape, one wave). Chunks are 32 KB (128 key
// rows at D=128, bf16) in a 64 KB ring, and a thread keeps to 128
// registers, so two CTAs can share an SM on larger grids. A score in #3
// and the row max it is held against must be the same float (at
// threshold 0 a row would otherwise drop its own maximum): both kernels
// call score_chunk with the route the host decided from K alone (16-byte
// aligned rows: vector scoring), its sums pinned with fmaf and the scale
// with __fmul_rn, so no contraction can differ between the two kernels.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;                // a lane holds kMaxD / 32 key values
constexpr int kMaxCluster = 8;
constexpr int kLaneCols = 16;             // key columns a scoring lane holds
constexpr int kSlotBytes = 32 * 1024;     // most bytes of one staged chunk
// the fused kernel's ring holds a CTA's whole share at S=512; the
// two-pass kernels' lets two CTAs share an SM
constexpr int kFusedRingBytes = 160 * 1024;
constexpr int kTwoPassRingBytes = 64 * 1024;
constexpr int kWindowScores = 4096;       // floats of a two-pass [G, w] window
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory a block may
                                          // opt in to on sm_90

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

// Split cluster barrier: every thread arrives once the CTA has started
// (relaxed: it orders nothing) and waits before its first access to
// another CTA's shared memory, which must not come before that CTA runs.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the shared machinery: shared-memory layout, K/V ring, mask, scores, P.V
// ---------------------------------------------------------------------------

// Where the pieces of a CTA's shared memory start, computed on the host
// and passed to the kernel: G query rows; tiles of n keys, ntiles of them
// per CTA; a cluster of C; rows of esz-byte elements in chunks of cr rows
// (nch chunks a tile, at most kSlotBytes each), staged through ns slots
// of `slot` bytes within ring_bytes; per segments a tile (nch of K, then
// nch of V when Dv > 0); ngroups groups of pv_chunk's threads share a
// chunk's rows.
struct RingLayout {
  size_t ring, q, s, acc, red, lmax, m, l, alpha, mask, total;
  int n, ntiles, per, ns, slot, cr, nch, ngroups, mask_tiles;
};

inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Value columns a thread of pv_chunk owns.
__host__ __device__ inline int pv_cols(int Dv) { return Dv % 4 == 0 ? 4 : 1; }

inline RingLayout ring_layout(int G, int D, int Dv, int n, int ntiles, int C,
                              int esz, int ring_bytes) {
  RingLayout f;
  f.n = n;
  f.ntiles = ntiles;
  const int width = (D > Dv ? D : Dv) * esz;        // bytes of a row
  f.cr = kSlotBytes / width;                        // rows of a chunk
  if (f.cr > n) f.cr = n;
  if (f.cr < 1) f.cr = 1;
  f.nch = (n + f.cr - 1) / f.cr;
  f.slot = (int)align16((size_t)f.cr * width);
  f.per = (Dv > 0 ? 2 : 1) * f.nch;
  const int nseg = f.per * ntiles;
  f.ns = ring_bytes / f.slot;
  if (f.ns > nseg) f.ns = nseg;
  if (f.ns < 1) f.ns = 1;
  const int tpr = Dv / pv_cols(Dv);                 // pv_chunk's threads a row
  f.ngroups = tpr > 0 && kThreads / tpr > 0 ? kThreads / tpr : 1;
  // the mask of all of the CTA's tiles when it is small, else one tile
  f.mask_tiles = (size_t)G * n * ntiles <= 16 * 1024 ? ntiles : 1;
  // the ring gives up slots until the whole fits kMaxSmem: the
  // accumulators and the cluster reduction grow as G * Dv (at G = 10,
  // Dv = 256 they take 80 KB)
  for (;; --f.ns) {
    size_t o = align16((size_t)f.ns * 8);           // the ring's mbarriers
    f.ring = o;
    o += (size_t)f.ns * f.slot;
    f.q = o;      o = align16(o + sizeof(float) * G * D);
    f.s = o;      o = align16(o + sizeof(float) * ((G + 3) & ~3) * n);
    f.acc = o;    o = align16(o + sizeof(float) * f.ngroups * G * Dv);
    f.red = o;    o = align16(o + sizeof(float) * C * G * (Dv + 1));
    f.lmax = o;   o = align16(o + sizeof(float) * 2 * G);
    f.m = o;      o = align16(o + sizeof(float) * G);
    f.l = o;      o = align16(o + sizeof(float) * G);
    f.alpha = o;  o = align16(o + sizeof(float) * G);
    f.mask = o;   o = align16(o + (size_t)G * n * f.mask_tiles);
    f.total = o;
    if (f.total <= kMaxSmem || f.ns == 1) return f;
  }
}

struct Segment {
  const unsigned char* src;
  int rows, bytes;
};

// A CTA's stream of K (and V) chunks through the ring. Tile t covers ring
// rows base + t * stride + [0, n); segment i is chunk (i % per) % nch of
// tile i / per, of K rows for the first nch and of V rows after. bulk:
// the chunks arrive by cp.async.bulk, every slot in flight from the
// start; else (rows not 16-byte aligned) the block copies each chunk
// with plain loads when it is needed.
template <typename T>
struct Ring {
  const RingLayout& f;
  uint64_t* bars;
  unsigned char* slots;
  const T* k;
  const T* v;
  size_t base, stride;
  int D, Dv;
  bool bulk;

  __device__ __forceinline__ int count() const { return f.per * f.ntiles; }

  __device__ __forceinline__ Segment segment(int i) const {
    const int t = i / f.per, c = (i % f.per) % f.nch;
    const bool is_v = (i % f.per) >= f.nch;
    const int r0 = c * f.cr;
    Segment g;
    g.rows = min(f.cr, f.n - r0);
    const size_t key = base + (size_t)t * stride + r0;
    const int w = is_v ? Dv : D;
    g.src = reinterpret_cast<const unsigned char*>((is_v ? v : k) + key * w);
    g.bytes = g.rows * w * (int)sizeof(T);
    return g;
  }

  __device__ __forceinline__ void issue(int i) const {
    const Segment g = segment(i);
    uint64_t* bar = bars + i % f.ns;
    hopper::mbar_expect_tx(bar, g.bytes);
    hopper::bulk_load(slots + (size_t)(i % f.ns) * f.slot, g.src, g.bytes,
                      bar);
  }

  // before the block's first __syncthreads: the slots' barriers
  __device__ __forceinline__ void init() const {
    if (!bulk || threadIdx.x != 0) return;
    for (int i = 0; i < f.ns; ++i) hopper::mbar_init(bars + i, 1);
    hopper::fence_barrier_init();
  }

  // after it: every slot in flight
  __device__ __forceinline__ void fill() const {
    if (!bulk || threadIdx.x != 0) return;
    for (int i = 0; i < f.ns; ++i) issue(i);
  }

  // wait for (or, without bulk copies, load) segment i; returns its slot
  __device__ __forceinline__ const T* acquire(int i) const {
    unsigned char* slot = slots + (size_t)(i % f.ns) * f.slot;
    if (bulk) {
      hopper::mbar_wait(bars + i % f.ns, (uint32_t)((i / f.ns) & 1));
    } else {
      const Segment g = segment(i);
      const T* src = reinterpret_cast<const T*>(g.src);
      T* dst = reinterpret_cast<T*>(slot);
      for (int e = threadIdx.x; e < g.bytes / (int)sizeof(T); e += kThreads)
        dst[e] = src[e];
      __syncthreads();
    }
    return reinterpret_cast<const T*>(slot);
  }

  // after every thread is done with segment i: refill its slot
  __device__ __forceinline__ void release(int i) const {
    __syncthreads();
    if (bulk && threadIdx.x == 0 && i + f.ns < count()) issue(i + f.ns);
  }
};

// The mask of tiles [t, t + mask_tiles) of a CTA's keys into
// mk_s [tiles, G, n]: query row row0 + g, key j of tile tt at column
// col0 + tt * stride + j.
__device__ __forceinline__ void stage_mask(uint8_t* mk_s,
                                           const uint8_t* __restrict__ mask,
                                           const RingLayout& f, size_t row0,
                                           int S, size_t col0, size_t stride,
                                           int t, int G) {
  const int n = f.n, nt = min(f.mask_tiles, f.ntiles - t);
  for (int e = threadIdx.x; e < nt * G * n; e += kThreads) {
    const int tt = e / (G * n), g = (e / n) % G, j = e % n;
    mk_s[e] = mask[(row0 + g) * S + col0 + (size_t)(t + tt) * stride + j];
  }
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

// Scores live key-major, four query rows a key: row g of key j at
// sidx(g, j, n), so P.V reads a key's 4 weights in one 16-byte load.
__device__ __forceinline__ int sidx(int g, int j, int n) {
  return ((g >> 2) * n + j) * 4 + (g & 3);
}

// Lanes that share a key row in score_chunk_vec: the fewest (a power of
// two) whose kLaneCols columns each cover D.
__device__ __forceinline__ int key_lanes(int D) {
  int kl = 1;
  while (kl * kLaneCols < D) kl <<= 1;
  return kl;
}

// This lane's columns of q rows g0 .. g0 + 3 (zero past G and D), the
// operand score_chunk_vec keeps in registers: lane part of a key's kl
// lanes holds the 16-byte column blocks part, part + kl, ... of each row.
template <typename T>
__device__ __forceinline__ void load_q_lane(float (&qr)[4][kLaneCols],
                                            const float* q_s, int g0, int G,
                                            int D) {
  constexpr int E = 16 / sizeof(T);                 // elements per load
  const int kl = key_lanes(D), part = (threadIdx.x % 32) % kl;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int m = 0; m < kLaneCols / E; ++m) {
      const int c = part * E + m * kl * E;
      const bool in = g0 + u < G && c < D;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 t =
            in ? *reinterpret_cast<const float4*>(q_s + (g0 + u) * D + c + e)
               : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[u][m * E + e] = t.x;
        qr[u][m * E + e + 1] = t.y;
        qr[u][m * E + e + 2] = t.z;
        qr[u][m * E + e + 3] = t.w;
      }
    }
}

// Scores of the rows of one staged K chunk (16-byte aligned rows):
// s[g][r0 + j] = scale * (q_g . k_j). KL lanes share a key row (8 at
// D=128), each reading its 16-byte column blocks of the row once and
// holding the same columns of 4 query rows in registers (qr, loaded
// once by the caller when G <= 4, here per row group otherwise); each
// dot is reduced over the KL lanes by a butterfly. The loop is straight
// code: all 4 rows are computed (qr is zero past G), a lane past the
// chunk recomputes its last row, and only the stores are guarded, so the
// compiler interleaves the 4 dots. A dot sums the lane's columns in
// order with fmaf, then the butterfly: a key's score is the same float
// whichever kernel or chunk scores it.
template <typename T, int KL>
__device__ __forceinline__ void score_rows_vec(const T* ks, int rows,
                                               int r0, const float* q_s,
                                               float (&qr)[4][kLaneCols],
                                               float* s_s, int G, int D,
                                               int n, float scale) {
  constexpr int E = 16 / sizeof(T), M = kLaneCols / E, KW = 32 / KL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / KL, part = lane % KL;
  for (int g0 = 0; g0 < G; g0 += 4) {
    if (G > 4) load_q_lane<T>(qr, q_s, g0, G, D);
    for (int j0 = warp * KW; j0 < rows; j0 += kWarps * KW) {
      const int j = j0 + sub, jr = min(j, rows - 1);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = part * E + m * KL * E;
        uint4 r = make_uint4(0u, 0u, 0u, 0u);
        if (c < D) r = *reinterpret_cast<const uint4*>(ks + (size_t)jr * D + c);
        float x[E];
        widen(r, x);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < E; ++e)
            a[u] = fmaf(qr[u][m * E + e], x[e], a[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int o = KL / 2; o > 0; o >>= 1)
          a[u] += __shfl_xor_sync(0xffffffffu, a[u], o);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j < rows && g0 + u < G && part == u % KL)
          s_s[sidx(g0 + u, r0 + j, n)] = __fmul_rn(a[u], scale);
    }
  }
}

template <typename T>
__device__ __forceinline__ void score_chunk_vec(const T* ks, int rows,
                                                int r0, const float* q_s,
                                                float (&qr)[4][kLaneCols],
                                                float* s_s, int G, int D,
                                                int n, float scale) {
  switch (key_lanes(D)) {
    case 1:
      score_rows_vec<T, 1>(ks, rows, r0, q_s, qr, s_s, G, D, n, scale);
      break;
    case 2:
      score_rows_vec<T, 2>(ks, rows, r0, q_s, qr, s_s, G, D, n, scale);
      break;
    case 4:
      score_rows_vec<T, 4>(ks, rows, r0, q_s, qr, s_s, G, D, n, scale);
      break;
    case 8:
      score_rows_vec<T, 8>(ks, rows, r0, q_s, qr, s_s, G, D, n, scale);
      break;
    default:
      score_rows_vec<T, 16>(ks, rows, r0, q_s, qr, s_s, G, D, n, scale);
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
        if (d < D) a = fmaf(qg[d], kv[i], a);
      }
      a = warp_sum(a);
      if (lane == 0) s_s[sidx(g, r0 + j, n)] = __fmul_rn(a, scale);
    }
  }
}

// The one scoring function of all three kernels; vec (16-byte aligned K
// rows) is decided on the host, from K alone.
template <typename T>
__device__ __forceinline__ void score_chunk(const T* ks, int rows, int r0,
                                            const float* q_s,
                                            float (&qr)[4][kLaneCols],
                                            float* s_s, int G, int D, int n,
                                            float scale, bool vec) {
  if (vec)
    score_chunk_vec(ks, rows, r0, q_s, qr, s_s, G, D, n, scale);
  else
    score_chunk_scalar(ks, rows, r0, q_s, s_s, G, D, n, scale);
}

// 4 value columns of a row as floats (8 bytes of bf16, 16 of float32).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}

// acc = acc * alpha (first chunk of a tile, a_s) + P V over one staged V
// chunk. Thread (grp, c) owns value columns [c vw, (c + 1) vw) (vw =
// pv_cols(Dv): 4 when Dv % 4 == 0, else 1) and rows grp, grp + ngroups,
// ... of the chunk; the G query rows go 4 at a time, so each V element
// is read once per 4 rows and a key's 4 weights in one 16-byte load.
template <typename T>
__device__ __forceinline__ void pv_chunk(const T* vs, int rows, int r0,
                                         const float* s_s, float* acc_s,
                                         const float* a_s, int G, int Dv,
                                         int n, int ngroups, bool first) {
  const int vw = pv_cols(Dv), tpr = Dv / vw;
  const int grp = threadIdx.x / tpr, c = (threadIdx.x % tpr) * vw;
  if (grp >= ngroups) return;
  for (int g0 = 0; g0 < G; g0 += 4) {
    const float4* p4 = reinterpret_cast<const float4*>(s_s) +
                       (size_t)(g0 >> 2) * n + r0;
    float a[4][4] = {};
    if (vw == 4) {
#pragma unroll 4
      for (int j = grp; j < rows; j += ngroups) {
        float x[4];
        load4(vs + (size_t)j * Dv + c, x);
        const float4 p = p4[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[0][k] += p.x * x[k];
          a[1][k] += p.y * x[k];
          a[2][k] += p.z * x[k];
          a[3][k] += p.w * x[k];
        }
      }
    } else {
      for (int j = grp; j < rows; j += ngroups) {
        const float x = to_f32(vs[(size_t)j * Dv + c]);
        const float4 p = p4[j];
        a[0][0] += p.x * x;
        a[1][0] += p.y * x;
        a[2][0] += p.z * x;
        a[3][0] += p.w * x;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (g0 + u < G) {
        float* acc = acc_s + ((size_t)grp * G + g0 + u) * Dv + c;
        const float al = first ? a_s[g0 + u] : 1.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < vw) acc[k] = acc[k] * al + a[u][k];
      }
    }
  }
}

// Each CTA's acc (summed over its thread groups) and l into rank 0's
// shared memory red_s [C, G, Dv + 1]; after one cluster.sync() rank 0
// sums the cluster's partials and writes l == 0 ? 0 : acc / l for the G
// query rows. Every CTA must have passed a cluster barrier since the
// cluster started.
template <typename T>
__device__ __forceinline__ void cluster_emit(const float* acc_s,
                                             const float* l_s, float* red_s,
                                             T* __restrict__ out, int G,
                                             int Dv, int ngroups) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  float* red0 = cluster.map_shared_rank(red_s, 0) +
                (size_t)rank * G * (Dv + 1);
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
    float a = acc_s[i];
    for (int grp = 1; grp < ngroups; ++grp)
      a += acc_s[(size_t)grp * G * Dv + i];
    red0[i] = a;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) red0[G * Dv + g] = l_s[g];
  cluster.sync();
  if (rank != 0) return;
  for (int i = threadIdx.x; i < G * Dv; i += kThreads) {
    const int g = i / Dv;
    float a = 0.f, l = 0.f;
    for (int r = 0; r < C; ++r) {
      const float* part = red_s + (size_t)r * G * (Dv + 1);
      a += part[i];
      l += part[G * Dv + g];
    }
    out[i] = from_f32<T>(l == 0.f ? 0.f : a / l);
  }
}

// ---------------------------------------------------------------------------
// fused kernel (#1)
// ---------------------------------------------------------------------------

// One CTA of a cluster of C owns keys [rank n, (rank + 1) n) of every
// block_k tile (n = bk / C). Per tile it scores its keys for the G query
// rows, publishes its row maxima, and after cluster.sync() reads the
// other CTAs' maxima through distributed shared memory, so every CTA
// forms the same m_cur = max(m_prev, max of the whole tile) and applies
// the same threshold and rescale as the Pallas kernel; cluster_emit
// reduces the partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, int Hq, int Hkv, int S, int D,
                     int Dv, int bk, float scale, int has_thr, float thr,
                     int vec, const __grid_constant__ RingLayout f) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int n = f.n, ntiles = f.ntiles;
  extern __shared__ __align__(16) unsigned char fsm[];
  float* q_s = reinterpret_cast<float*>(fsm + f.q);         // [G, D]
  float* s_s = reinterpret_cast<float*>(fsm + f.s);         // sidx(g, j, n)
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
  const size_t col0 = (size_t)rank * n;                     // first own key
  const Ring<T> ring{f, reinterpret_cast<uint64_t*>(fsm), fsm + f.ring,
                     k, v, kv0 + col0, (size_t)bk, D, Dv, vec != 0};

  ring.init();
  __syncthreads();
  ring.fill();
  // q and the mask of the first tiles, read while the first chunks fly
  stage_mask(mk_s, mask, f, row0, S, col0, bk, 0, G);
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(q[row0 * D + i]);
  for (int i = tid; i < f.ngroups * G * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  int seg = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0 && t % f.mask_tiles == 0)                // seen after a sync
      stage_mask(mk_s, mask, f, row0, S, col0, bk, t, G);
    const uint8_t* mk = mk_s + (size_t)(t % f.mask_tiles) * G * n;

    // scores of this CTA's n keys; q in registers for the tile only, so
    // P.V gets the registers back
    float qr[4][kLaneCols];
    if (vec) load_q_lane<T>(qr, q_s, 0, G, D);
    for (int c = 0; c < f.nch; ++c, ++seg) {
      const T* ks = ring.acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      score_chunk(ks, rows, r0, q_s, qr, s_s, G, D, n, scale, vec != 0);
      ring.release(seg);
    }

    // this CTA's masked row maxima, then the whole tile's through DSMEM
    float* lm = lmax_s + (t & 1) * G;
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32)
        mx = fmaxf(mx, mk[g * n + j] ? s_s[sidx(g, j, n)] : kNegInf);
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
        const float sv = s_s[sidx(g, j, n)];
        bool keep = mk[g * n + j] != 0;
        if (has_thr) keep = keep && (sv >= m_cur - thr);
        const float p = keep ? expf(sv - m_cur) : 0.f;
        s_s[sidx(g, j, n)] = p;
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
      const T* vs = ring.acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      pv_chunk(vs, rows, r0, s_s, acc_s, a_s, G, Dv, n, f.ngroups, c == 0);
      ring.release(seg);
    }
  }
  cluster_emit(acc_s, l_s, red_s, out + row0 * Dv, G, Dv, f.ngroups);
}

// ---------------------------------------------------------------------------
// two-pass kernels (#2, #3): the ring split over a cluster, one reduction
// ---------------------------------------------------------------------------

// #2: CTA rank of C owns ring rows [rank S/C, (rank + 1) S/C), walked in
// ntiles windows of n rows; it keeps the masked row maxima of its keys,
// stores them into rank 0's shared memory, and after one cluster.sync()
// rank 0 writes the cluster's maxima (-1e30 for a row with nothing
// admitted).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rowmax_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ rowmax, int Hq, int Hkv, int S,
                      int D, float scale, int kvec,
                      const __grid_constant__ RingLayout f) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int n = f.n, ntiles = f.ntiles;
  extern __shared__ __align__(16) unsigned char fsm[];
  float* q_s = reinterpret_cast<float*>(fsm + f.q);         // [G, D]
  float* s_s = reinterpret_cast<float*>(fsm + f.s);         // sidx(g, j, n)
  float* red_s = reinterpret_cast<float*>(fsm + f.red);     // [C, G]
  float* m_s = reinterpret_cast<float*>(fsm + f.m);         // [G]
  uint8_t* mk_s = fsm + f.mask;                             // [tiles, G, n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;
  const size_t kv0 = ((size_t)b * Hkv + h) * S;
  const size_t col0 = (size_t)rank * n * ntiles;            // first own key
  const Ring<T> ring{f, reinterpret_cast<uint64_t*>(fsm), fsm + f.ring,
                     k, nullptr, kv0 + col0, (size_t)n, D, 0, kvec != 0};

  ring.init();
  __syncthreads();
  ring.fill();
  stage_mask(mk_s, mask, f, row0, S, col0, n, 0, G);
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(q[row0 * D + i]);
  for (int g = tid; g < G; g += kThreads) m_s[g] = kNegInf;
  __syncthreads();
  cluster_arrive_relaxed();

  int seg = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0 && t % f.mask_tiles == 0)
      stage_mask(mk_s, mask, f, row0, S, col0, n, t, G);
    const uint8_t* mk = mk_s + (size_t)(t % f.mask_tiles) * G * n;
    float qr[4][kLaneCols];
    if (kvec) load_q_lane<T>(qr, q_s, 0, G, D);
    for (int c = 0; c < f.nch; ++c, ++seg) {
      const T* ks = ring.acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      score_chunk(ks, rows, r0, q_s, qr, s_s, G, D, n, scale, kvec != 0);
      ring.release(seg);
    }
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32)
        mx = fmaxf(mx, mk[g * n + j] ? s_s[sidx(g, j, n)] : kNegInf);
      mx = warp_max(mx);
      if (lane == 0) m_s[g] = fmaxf(m_s[g], mx);
    }
    __syncthreads();
  }

  cluster_wait();
  float* red0 = cluster.map_shared_rank(red_s, 0) + (size_t)rank * G;
  for (int g = tid; g < G; g += kThreads) red0[g] = m_s[g];
  cluster.sync();
  if (rank != 0) return;
  for (int g = tid; g < G; g += kThreads) {
    float mx = kNegInf;
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, red_s[r * G + g]);
    rowmax[row0 + g] = mx;
  }
}

// #3: the same split; each CTA scores its keys with #2's score_chunk,
// keeps keep = mask && (!has_thr || s >= rowmax - thr) at weight
// exp(s - rowmax), and accumulates l and P.V with no rescale;
// cluster_emit reduces the partials. bulk: K and V both arrive by
// cp.async.bulk (both 16-byte aligned), else both by plain loads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
attend_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ rowmax, T* __restrict__ out,
                      int Hq, int Hkv, int S, int D, int Dv, float scale,
                      int has_thr, float thr, int kvec, int bulk,
                      const __grid_constant__ RingLayout f) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int n = f.n, ntiles = f.ntiles;
  extern __shared__ __align__(16) unsigned char fsm[];
  float* q_s = reinterpret_cast<float*>(fsm + f.q);         // [G, D]
  float* s_s = reinterpret_cast<float*>(fsm + f.s);         // sidx(g, j, n)
  float* acc_s = reinterpret_cast<float*>(fsm + f.acc);     // [ngroups, G, Dv]
  float* red_s = reinterpret_cast<float*>(fsm + f.red);     // [C, G, Dv + 1]
  float* rm_s = reinterpret_cast<float*>(fsm + f.m);        // [G]
  float* l_s = reinterpret_cast<float*>(fsm + f.l);         // [G]
  uint8_t* mk_s = fsm + f.mask;                             // [tiles, G, n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;
  const size_t kv0 = ((size_t)b * Hkv + h) * S;
  const size_t col0 = (size_t)rank * n * ntiles;
  const Ring<T> ring{f, reinterpret_cast<uint64_t*>(fsm), fsm + f.ring,
                     k, v, kv0 + col0, (size_t)n, D, Dv, bulk != 0};

  ring.init();
  __syncthreads();
  ring.fill();
  stage_mask(mk_s, mask, f, row0, S, col0, n, 0, G);
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(q[row0 * D + i]);
  for (int i = tid; i < f.ngroups * G * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    rm_s[g] = rowmax[row0 + g];
    l_s[g] = 0.f;
  }
  __syncthreads();
  cluster_arrive_relaxed();

  int seg = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0 && t % f.mask_tiles == 0)
      stage_mask(mk_s, mask, f, row0, S, col0, n, t, G);
    const uint8_t* mk = mk_s + (size_t)(t % f.mask_tiles) * G * n;
    float qr[4][kLaneCols];
    if (kvec) load_q_lane<T>(qr, q_s, 0, G, D);
    for (int c = 0; c < f.nch; ++c, ++seg) {
      const T* ks = ring.acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      score_chunk(ks, rows, r0, q_s, qr, s_s, G, D, n, scale, kvec != 0);
      ring.release(seg);
    }
    for (int g = warp; g < G; g += kWarps) {
      const float rm = rm_s[g], lo = rm - thr;
      float psum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float sv = s_s[sidx(g, j, n)];
        bool keep = mk[g * n + j] != 0;
        if (has_thr) keep = keep && (sv >= lo);
        const float p = keep ? expf(sv - rm) : 0.f;
        s_s[sidx(g, j, n)] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) l_s[g] += psum;
    }
    __syncthreads();
    for (int c = 0; c < f.nch; ++c, ++seg) {
      const T* vs = ring.acquire(seg);
      const int r0 = c * f.cr, rows = min(f.cr, n - r0);
      pv_chunk(vs, rows, r0, s_s, acc_s, static_cast<const float*>(nullptr),
               G, Dv, n, f.ngroups, false);
      ring.release(seg);
    }
  }
  cluster_wait();
  cluster_emit(acc_s, l_s, red_s, out + row0 * Dv, G, Dv, f.ngroups);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline bool rows_aligned(const void* p, int width, int esz) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (width * esz) % 16 == 0;
}

// Rows of a window of a two-pass CTA's `span` keys: the most that divide
// span with the window's [G, w] scores within kWindowScores floats.
inline int two_pass_window(int G, int span) {
  for (int d = 1; d <= span; ++d)
    if (span % d == 0 && (size_t)G * (span / d) <= kWindowScores)
      return span / d;
  return 1;
}

// Launch `kernel` as blocks / cluster clusters of `cluster` CTAs of
// kThreads threads with `smem` bytes of dynamic shared memory; returns
// the cudaError_t of the launch.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int blocks, int cluster, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t r = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
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
  const int esz = (int)sizeof(T);
  const int vec = rows_aligned(k, D, esz) && rows_aligned(v, Dv, esz);
  const RingLayout f =
      ring_layout(G, D, Dv, bk / cluster, S / bk, cluster, esz,
                  kFusedRingBytes);
  return launch_cluster(
      fused_cluster_kernel<T>, B * Hkv * cluster, cluster, f.total, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), Hq, Hkv, S, D, Dv, bk, scale, has_thr, thr, vec,
      f);
}

// Checks shared by the two-pass launches: the cluster splits the ring,
// block_k divides it (as the Pallas kernel asserts), and the scoring
// route the host chose fits K.
template <typename T>
bool two_pass_ok(const void* k, int S, int D, int bk, int cluster, int kvec) {
  return cluster >= 1 && cluster <= kMaxCluster && S % cluster == 0 &&
         bk >= 1 && S % bk == 0 && D <= kMaxD &&
         (kvec == 0 || rows_aligned(k, D, (int)sizeof(T)));
}

template <typename T>
int launch_rowmax(const void* q, const void* k, const void* mask,
                  void* rowmax, int B, int Hq, int Hkv, int S, int D, int bk,
                  int cluster, int kvec, float scale, cudaStream_t stream) {
  if (!two_pass_ok<T>(k, S, D, bk, cluster, kvec))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv, span = S / cluster;
  const int w = two_pass_window(G, span);
  const RingLayout f = ring_layout(G, D, 0, w, span / w, cluster,
                                   (int)sizeof(T), kTwoPassRingBytes);
  return launch_cluster(
      rowmax_cluster_kernel<T>, B * Hkv * cluster, cluster, f.total, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const uint8_t*>(mask), static_cast<float*>(rowmax), Hq,
      Hkv, S, D, scale, kvec, f);
}

template <typename T>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* mask, const void* rowmax, void* out, int B,
                  int Hq, int Hkv, int S, int D, int Dv, int bk, int cluster,
                  int kvec, float scale, int has_thr, float thr,
                  cudaStream_t stream) {
  if (!two_pass_ok<T>(k, S, D, bk, cluster, kvec) || Dv > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv, span = S / cluster, esz = (int)sizeof(T);
  const int w = two_pass_window(G, span);
  const int bulk = kvec && rows_aligned(v, Dv, esz);
  const RingLayout f = ring_layout(G, D, Dv, w, span / w, cluster, esz,
                                   kTwoPassRingBytes);
  return launch_cluster(
      attend_cluster_kernel<T>, B * Hkv * cluster, cluster, f.total, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(rowmax), static_cast<T*>(out), Hq, Hkv, S,
      D, Dv, scale, has_thr, thr, kvec, bulk, f);
}

}  // namespace

// C entry points: pointers and the stream as void*, shapes as int; each
// returns the cudaError_t of the launch (0 = success). is_bf16 selects
// __nv_bfloat16 inputs and output, else float32; mask is uint8 [B, Hq, S],
// rowmax float32 [B, Hq]; cluster is the CTAs per (batch, kv head); kvec
// (the two-pass pair's scoring route, 1 = 16-byte vector loads) must be
// the same for both passes and needs 16-byte aligned K rows.
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
                            int Hkv, int S, int D, int bk, int cluster,
                            int kvec, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_rowmax<__nv_bfloat16>(q, k, mask, rowmax, B, Hq, Hkv, S, D,
                                        bk, cluster, kvec, scale, st);
  return launch_rowmax<float>(q, k, mask, rowmax, B, Hq, Hkv, S, D, bk,
                              cluster, kvec, scale, st);
}

int decode_attention_attend(const void* q, const void* k, const void* v,
                            const void* mask, const void* rowmax, void* out,
                            int is_bf16, int B, int Hq, int Hkv, int S,
                            int D, int Dv, int bk, int cluster, int kvec,
                            float scale, int has_thr, float thr,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_attend<__nv_bfloat16>(q, k, v, mask, rowmax, out, B, Hq,
                                        Hkv, S, D, Dv, bk, cluster, kvec,
                                        scale, has_thr, thr, st);
  return launch_attend<float>(q, k, v, mask, rowmax, out, B, Hq, Hkv, S, D,
                              Dv, bk, cluster, kvec, scale, has_thr, thr, st);
}

}  // extern "C"
