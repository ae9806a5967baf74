// The tensor-core attention engine shared by flash_attention.cu (kernel
// #4's bf16 route) and a3_attention.cu (the bf16 routes of kernels #5 and
// #6) for Hopper (sm_90a): the CTA shape, the kv tile and ring depth, the
// S = Q K^T tile, the shared-memory carve-up of the Q block and the K/V
// ring, and the P.V product. A CTA owns 128 query rows of one (batch,
// head) in two consumer warpgroups of 64 rows; a producer warpgroup
// streams K and V tiles by TMA (64-column boxes, 128-byte swizzle)
// through a ring of mbarriers.
//
// The kv tile follows the head dims at compile time (KvTile):
//   D, Dv <= 128 (NB, NVB <= 2 boxes of 64 columns): 128-key tiles in a
//     3-stage ring, Q 32 KB + 3 x 4 x 16 KB = 224 KB at D = Dv = 128; a
//     thread holds S in 64 registers, P in 32 and O in 64.
//   D or Dv in (128, 256]: 64-key tiles in a 2-stage ring, Q 64 KB +
//     2 x 8 x 8 KB = 192 KB at D = Dv = 256 (128-key tiles would need
//     449 KB); S 32 registers, P 16, O 128, under the consumers' 240.
//     With two stages the ring would have no slack if a stage came free
//     only when both its K and V were read (S_j runs beside
//     P_{j-1} V_{j-1}), so K and V come free apart: K as soon as S_j has
//     read it, V after P V. Each load then has one tile's compute to land.
//     FlashAttention-3 takes 80-key tiles at head dim 256; 64 keys divide
//     A^3's 128-key blocks, so a live block is two whole tiles.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace wgattn {

constexpr int kWgRows = 64;                 // query rows of a consumer WG
constexpr int kQRows = 2 * kWgRows;         // query rows of a CTA
constexpr int kWgThreads = 3 * 128;        // two consumer WGs + producer WG
constexpr int kBox = 64;                    // columns of a TMA box (128 B)
constexpr int kQBoxBytes = kWgRows * kBox * 2;     // 8 KB
constexpr int kBlock = 128;                 // A^3's q and kv block
constexpr float kLog2e = 1.4426950408889634f;

// The kv tile and ring of a kernel with NB boxes of D and NVB of Dv.
// Wide (D or Dv above 128): 64-key tiles, 2 stages, K and V freed apart.
template <int NB, int NVB>
struct KvTile {
  static constexpr bool kWide = NB > 2 || NVB > 2;
  static constexpr int kKeys = kWide ? 64 : 128;   // keys of a kv tile
  static constexpr int kStages = kWide ? 2 : 3;    // K/V ring depth
  static constexpr int kBoxBytes = kKeys * kBox * 2;   // a K or V box
  static constexpr int kS = kKeys / 2;             // S floats a thread
  static constexpr int kSteps = kKeys / 16;        // k16 steps of P V
};

// S = Q K^T of one consumer warpgroup and one KEYS-key tile, a 64 x KEYS
// float32 accumulator over the NB boxes of D (columns past D are zeros in
// both operands): Q from the warpgroup's boxes at qw, K from the tile's
// boxes at ks, both K-major, the k16 steps in order, wgmma m64n128k16 or
// m64n64k16; committed, not waited for. Every tensor-core kernel that
// scores q.k calls this one function, and A^3's row max (#5) and its
// weights (#6) call it with the same tile, so both sum each score in the
// same order and agree to the bit.
template <int NB, int KEYS>
__device__ __forceinline__ void issue_s(float (&sc)[KEYS / 2],
                                        const unsigned char* qw,
                                        const unsigned char* ks) {
  static_assert(KEYS == 128 || KEYS == 64, "kv tile of 64 or 128 keys");
  constexpr int kBoxBytes = KEYS * kBox * 2;
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const int x = kk >> 2, in = (kk & 3) * 32;
    const uint64_t da = hopper::sw128_desc(qw + x * kQBoxBytes + in, 16, 1024);
    const uint64_t db = hopper::sw128_desc(ks + x * kBoxBytes + in, 16, 1024);
    if constexpr (KEYS == 128)
      hopper::wgmma_ss_n128(sc, da, db, kk > 0);
    else
      hopper::wgmma_ss_n64<0, 0>(sc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// Shared memory of one CTA, all boxes 1024-byte aligned: Q [2 WGs][NB],
// K [stage][NB], V [stage][NVB], then the barriers: Q, K and V full, and
// the stages' empty barriers (one per stage, or when wide one for K and
// one for V).
struct WgSmem {
  unsigned char* q;
  unsigned char* k;
  unsigned char* v;
  uint64_t* q_full;
  uint64_t* k_full;                         // [kStages]
  uint64_t* v_full;                         // [kStages]
  uint64_t* empty;                          // [kStages]: K's when wide
  uint64_t* v_empty;                        // [kStages]: = empty without it
  uint64_t* end;                            // past the barriers
};

template <int NB, int NVB>
constexpr size_t wg_smem_bytes() {
  using T = KvTile<NB, NVB>;
  return 1024 + (size_t)2 * NB * kQBoxBytes +
         (size_t)T::kStages * (NB + NVB) * T::kBoxBytes +
         8 * (1 + (T::kWide ? 4 : 3) * T::kStages);
}

template <int NB, int NVB>
__device__ inline WgSmem wg_carve(unsigned char* raw) {
  using T = KvTile<NB, NVB>;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
  WgSmem s;
  s.q = base;
  s.k = s.q + (size_t)2 * NB * kQBoxBytes;
  s.v = s.k + (size_t)T::kStages * NB * T::kBoxBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      s.v + (size_t)T::kStages * NVB * T::kBoxBytes);
  s.q_full = bars;
  s.k_full = bars + 1;
  s.v_full = bars + 1 + T::kStages;
  s.empty = bars + 1 + 2 * T::kStages;
  s.v_empty = T::kWide ? s.empty + T::kStages : s.empty;
  s.end = bars + 1 + (T::kWide ? 4 : 3) * T::kStages;
  return s;
}

// O += P V for one k16 step of keys: O a 64 x (64 NVB) accumulator, a the
// step's bf16 P fragment, vs the step's first V box (MN-major, 8-key
// groups 1024 B apart, boxes BOX bytes apart). NVB 3 and 4 take two
// products on the same P: columns [0, 128), then [128, 64 NVB).
template <int NVB, int BOX>
__device__ __forceinline__ void pv_mma(float (&o)[32 * NVB],
                                       const uint32_t (&a)[4],
                                       const unsigned char* vs) {
  static_assert(NVB >= 1 && NVB <= 4, "Dv of 1 to 4 boxes");
  const uint64_t db = hopper::sw128_desc(vs, BOX, 1024);
  if constexpr (NVB == 1) {
    hopper::wgmma_rs_n64_tb(o, a, db);
  } else {
    hopper::wgmma_rs_n128_tb(o, a, db);
    if constexpr (NVB > 2) {
      const uint64_t dh = hopper::sw128_desc(vs + 2 * BOX, BOX, 1024);
      if constexpr (NVB == 3)
        hopper::wgmma_rs_n64_tb<64>(o, a, dh);
      else
        hopper::wgmma_rs_n128_tb<64>(o, a, dh);
    }
  }
}

// The bf16 A fragments of P V from a 64 x KEYS tile of weights held as
// the S accumulator: k16 step kk takes columns [16 kk, 16 kk + 16).
template <int STEPS>
__device__ __forceinline__ void to_bf16(const float (&sc)[STEPS * 8],
                                        uint32_t (&pa)[STEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r],
                                    sc[8 * kk + 2 * r + 1]);
}

// The tensor-core instantiations that exist, one per (ceil(D / 64),
// ceil(Dv / 64)) for D and Dv in (0, 256]: returns go(nb, nvb), both
// std::integral_constant<int, 1 to 4>. Every entry point of #4, #5 and
// #6 dispatches through it.
template <class F>
inline int dispatch_head_dims(int D, int Dv, F go) {
  auto by_dv = [&](auto nb) {
    switch ((Dv + kBox - 1) / kBox) {
      case 1: return go(nb, std::integral_constant<int, 1>());
      case 2: return go(nb, std::integral_constant<int, 2>());
      case 3: return go(nb, std::integral_constant<int, 3>());
      default: return go(nb, std::integral_constant<int, 4>());
    }
  };
  switch ((D + kBox - 1) / kBox) {
    case 1: return by_dv(std::integral_constant<int, 1>());
    case 2: return by_dv(std::integral_constant<int, 2>());
    case 3: return by_dv(std::integral_constant<int, 3>());
    default: return by_dv(std::integral_constant<int, 4>());
  }
}

}  // namespace wgattn
