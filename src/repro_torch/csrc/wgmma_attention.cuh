// The tensor-core attention engine shared by flash_attention.cu (kernel
// #4's bf16 route) and a3_attention.cu (the bf16 routes of kernels #5 and
// #6) for Hopper (sm_90a): the CTA shape, the S = Q K^T tile, the
// shared-memory carve-up of the Q block and the K/V ring, and the P.V
// product. A CTA owns 128 query rows
// of one (batch, head) in two consumer warpgroups of 64 rows; a producer
// warpgroup streams 128-key K and V tiles by TMA (64-column boxes,
// 128-byte swizzle) through a kStages-deep ring of mbarriers.
#pragma once

#include "hopper.cuh"

namespace wgattn {

constexpr int kWgRows = 64;                 // query rows of a consumer WG
constexpr int kQRows = 2 * kWgRows;         // query rows of a CTA
constexpr int kKeys = 128;                  // keys of a kv tile
constexpr int kStages = 3;                  // K/V ring depth
constexpr int kWgThreads = 3 * 128;        // two consumer WGs + producer WG
constexpr int kBox = 64;                    // columns of a TMA box (128 B)
constexpr int kQBoxBytes = kWgRows * kBox * 2;     // 8 KB
constexpr int kKVBoxBytes = kKeys * kBox * 2;      // 16 KB
constexpr float kLog2e = 1.4426950408889634f;

// S = Q K^T of one consumer warpgroup and one 128-key tile, a 64 x 128
// float32 accumulator over the NB boxes of D (columns past D are zeros in
// both operands): Q from the warpgroup's boxes at qw, K from the tile's
// boxes at ks, both K-major, the k16 steps in order; committed, not waited
// for. Every tensor-core kernel that scores q.k calls this one function,
// so A^3's row max (#5) and its weights (#6) sum each score in the same
// order and agree to the bit.
template <int NB>
__device__ __forceinline__ void issue_s(float (&sc)[64],
                                        const unsigned char* qw,
                                        const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const int x = kk >> 2, in = (kk & 3) * 32;
    hopper::wgmma_ss_n128(
        sc, hopper::sw128_desc(qw + x * kQBoxBytes + in, 16, 1024),
        hopper::sw128_desc(ks + x * kKVBoxBytes + in, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// Shared memory of one CTA, all boxes 1024-byte aligned: Q [2 WGs][nb],
// K [stage][nb], V [stage][nvb] (nb = ceil(D/64), nvb = ceil(Dv/64)
// boxes), then the barriers.
struct WgSmem {
  unsigned char* q;
  unsigned char* k;
  unsigned char* v;
  uint64_t* q_full;
  uint64_t* k_full;                         // [kStages]
  uint64_t* v_full;                         // [kStages]
  uint64_t* empty;                          // [kStages]
};

inline size_t wg_smem_bytes(int nb, int nvb) {
  return 1024 + (size_t)2 * nb * kQBoxBytes +
         (size_t)kStages * (nb + nvb) * kKVBoxBytes + 8 * (1 + 3 * kStages);
}

__device__ inline WgSmem wg_carve(unsigned char* raw, int nb, int nvb) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
  WgSmem s;
  s.q = base;
  s.k = s.q + (size_t)2 * nb * kQBoxBytes;
  s.v = s.k + (size_t)kStages * nb * kKVBoxBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(s.v + (size_t)kStages * nvb * kKVBoxBytes);
  s.q_full = bars;
  s.k_full = bars + 1;
  s.v_full = bars + 1 + kStages;
  s.empty = bars + 1 + 2 * kStages;
  return s;
}

// O accumulator columns: 64 per box of Dv, a 64 x (64 nvb) tile.
template <int NVB>
__device__ __forceinline__ void pv_mma(float (&o)[32 * NVB],
                                       const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_mma<1>(float (&o)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  hopper::wgmma_rs_n64_tb(o, a, db);
}
template <>
__device__ __forceinline__ void pv_mma<2>(float (&o)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  hopper::wgmma_rs_n128_tb(o, a, db);
}

}  // namespace wgattn
