// The expand-then-dense tile of the units probe (sp24_units.cu: fp1_launch),
// run_probe_fp1's design rebuilt for Hopper.
//
// out [M, N] bf16 = A @ B for A in 2:4 planes v0, v1, codes [K4, M] (k-major,
// code i0 * 4 + i1) and B [K, N] row-major, f32 accumulation, rows of B past
// K and groups past K4 read as zero. M a multiple of 128, N of 64, operands
// 16-byte aligned.
//
// What bounds it on the H100: the 2:4 product's bytes (the planes at 1.25 B
// a logical element, B and C once) and the dense operations it does on the
// expanded A at 989 TFLOP/s, whichever is larger. The SM's shared memory
// comes first (PERF.md: units_probe --ablate): a 64-deep step moves about
// 100 KB through it (TMA fills, the expansion's reads and writes, wgmma's
// reads of A and of B by both warpgroups) against 512 clocks of dense MMAs.
// Design, in the shape of the ELL tile (ell_tile.cuh, whose helpers it
// uses):
//   * persistent: one block per SM walks the (m-tile, n-tile) units, the
//     n-tiles of one m-tile adjacent so that its planes come from L2;
//   * two producer warps, each with its own ring of kStages mbarrier'd stages:
//     one TMA-loads the planes of a 64-deep k-step (v0 and v1 as [16, 128]
//     bf16 boxes at (m0, 16 kt), codes as a [16, 128] uint8 box), the other
//     B's 64 rows as BN / 64 boxes of 64 columns with the 128-byte swizzle,
//     as K4/K5 load B. The plane ring is handed back as soon as a k-step is
//     expanded, the B ring once its products are done;
//   * two consumer warpgroups of 64 rows each: each expands its rows of the
//     staged planes (one thread a group and 8 rows: three 16-byte reads,
//     byte masks of the codes that select each k-row's values, four 16-byte
//     writes) into a dense A^T slot [64][64] in exactly the layout TMA gives
//     K5's values_km (16-byte chunk c of k-row r at chunk c ^ (r & 7)),
//     fences the generic stores for the async proxy, and multiplies the
//     slot with wgmma m64nBNk16 (A M-major, B N-major), f32 accumulators in
//     registers. Three dense slots: step t + 1 expands while the products of
//     steps t - 1 and t run, as run_probe_fp1 pipelines its expansion and its
//     dot;
//   * the epilogue: bf16 from registers through a staging tile per
//     warpgroup to 16-byte stores (ellt::store_tile), while the producers load
//     the next unit.
#pragma once

#include "ell_tile.cuh"

namespace sp24x {

using smt::bf16;

constexpr int kBM = 128;           // rows of a tile: two warpgroups of 64
constexpr int kBK = 64;            // logical k of a step
constexpr int kG = kBK / 4;        // groups of a step
constexpr int kThreads = 320;      // two consumer warpgroups, two producers
constexpr int kStages = 4;
constexpr int kSlots = 3;          // dense A^T slots

// Byte offset of dense A^T element (k, m) in a slot of kBK x kBM bf16: two
// boxes of 64 rows (m / 64), k-rows of 128 bytes, 16-byte chunk c = (m % 64)
// / 8 at c ^ (k & 7). units_probe.expand_slot_offset is this function.
__host__ __device__ __forceinline__ int slot_offset(int k, int m) {
  return (m / 64) * kBK * 128 + k * 128 + ((((m % 64) / 8) ^ (k & 7)) << 4) +
         (m % 8) * 2;
}

template <int BN>
struct Layout {
  static constexpr int B_STAGE = kBK * BN * 2;
  static constexpr int SLOT = kBK * kBM * 2;
  static constexpr int V_BYTES = kG * kBM * 2;  // one plane's [16, 128]
  static constexpr int P_STAGE = 2 * V_BYTES + kG * kBM;
  static constexpr int STAGING = ellt::Layout<BN, kBK>::STAGING;  // elements
  static constexpr int B_OFF = 0;
  static constexpr int SLOT_OFF = B_OFF + kStages * B_STAGE;
  static constexpr int P_OFF = SLOT_OFF + kSlots * SLOT;
  static constexpr int ST_OFF = P_OFF + kStages * P_STAGE;
  static constexpr int BAR_OFF = ST_OFF + 2 * STAGING * 2;
  static constexpr int BYTES = 1024 + BAR_OFF + 4 * kStages * 8;
  static_assert(B_STAGE % 1024 == 0 && SLOT % 1024 == 0 &&
                    P_STAGE % 128 == 0 && SLOT_OFF % 1024 == 0,
                "alignment");
  static_assert(BYTES <= ellt::kSmemMax, "shared memory");
};

struct Params {
  CUtensorMap tv0, tv1;  // planes [K4, M] bf16, box {128, 16}
  CUtensorMap tc;        // codes [K4, M] uint8, box {128, 16}
  CUtensorMap tb;        // B [K, N] bf16, box {64, 64}, 128-byte swizzle
  bf16* out;
  int M, N, KT, n_tiles, units;
};

// 0xFF in each byte of x (a 2-bit index a byte) that equals q, else 0.
__device__ __forceinline__ uint32_t eq_bytes(uint32_t x, uint32_t q) {
  const uint32_t d = x ^ (q * 0x01010101u);
  return (((d | (d >> 1)) & 0x01010101u) ^ 0x01010101u) * 0xFFu;
}

// The 8 dense values of k-row 4g + q for 8 rows (bf16 pairs in a, b; their
// codes in c, byte e for row e): v0 where i0 == q, v1 where i1 == q, else
// zero. Byte masks widen to the halves of each pair with one byte_perm.
__device__ __forceinline__ uint4 expand8(const uint4& a, const uint4& b,
                                         uint2 c, uint32_t q) {
  const uint32_t m0x = eq_bytes((c.x >> 2) & 0x03030303u, q);
  const uint32_t m0y = eq_bytes((c.y >> 2) & 0x03030303u, q);
  const uint32_t m1x = eq_bytes(c.x & 0x03030303u, q);
  const uint32_t m1y = eq_bytes(c.y & 0x03030303u, q);
  auto pick = [](uint32_t va, uint32_t vb, uint32_t m0, uint32_t m1,
                 uint32_t sel) {
    return (va & __byte_perm(m0, 0, sel)) | (vb & __byte_perm(m1, 0, sel));
  };
  return make_uint4(pick(a.x, b.x, m0x, m1x, 0x1100),
                    pick(a.y, b.y, m0x, m1x, 0x3322),
                    pick(a.z, b.z, m0y, m1y, 0x1100),
                    pick(a.w, b.w, m0y, m1y, 0x3322));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    expand_tma_kernel(__grid_constant__ const Params p) {
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ellt::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* b_st = base + L::B_OFF;
  unsigned char* slots = base + L::SLOT_OFF;
  unsigned char* p_st = base + L::P_OFF;
  bf16* staging = reinterpret_cast<bf16*>(base + L::ST_OFF);
  uint64_t* pfull = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* pempty = pfull + kStages;
  uint64_t* bfull = pempty + kStages;
  uint64_t* bempty = bfull + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ellt::bar_init(&pfull[s], 1);
      ellt::bar_init(&pempty[s], 2);  // one arrival per consumer warpgroup
      ellt::bar_init(&bfull[s], 1);
      ellt::bar_init(&bempty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {  // the producers: warp 8 the planes, warp 9 B
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int m0 = (u / p.n_tiles) * kBM, n0 = (u % p.n_tiles) * BN;
      for (int kt = 0; kt < p.KT; ++kt) {
        if (warp == 8) {
          ellt::bar_wait(&pempty[stage], phase ^ 1);
          if (lane == 0) {
            unsigned char* st = p_st + stage * L::P_STAGE;
            ellt::bar_arrive_tx(&pfull[stage], L::P_STAGE);
            ellt::tma_load(st, &p.tv0, &pfull[stage], m0, kt * kG);
            ellt::tma_load(st + L::V_BYTES, &p.tv1, &pfull[stage], m0,
                           kt * kG);
            ellt::tma_load(st + 2 * L::V_BYTES, &p.tc, &pfull[stage], m0,
                           kt * kG);
          }
        } else {
          ellt::bar_wait(&bempty[stage], phase ^ 1);
          if (lane == 0) {
            unsigned char* st = b_st + stage * L::B_STAGE;
            ellt::bar_arrive_tx(&bfull[stage], L::B_STAGE);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              ellt::tma_load(st + j * kBK * 128, &p.tb, &bfull[stage],
                             n0 + 64 * j, kt * kBK);
          }
        }
        __syncwarp();
        ellt::advance(stage, phase, kStages);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg.. of every tile
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int gl = t / 8, c = t % 8;  // this thread's group and 8 rows
  ellt::Params ep;                  // what store_tile reads
  ep.c = nullptr;
  ep.out = p.out;
  ep.M = p.M;
  ep.N = p.N;
  ep.alpha = 1.f;
  ep.beta = 0.f;
  ep.tout = 0;
  float acc[BN / 2];
  int pstage = 0, bstage = 0;  // the plane ring runs a k-step ahead
  uint32_t pphase = 0, bphase = 0;
  // Expands k-step kt, staged at plane stage pstage, into slot kt % kSlots
  // and hands the stage back.
  auto expand = [&](int kt) {
    unsigned char* slot = slots + (kt % kSlots) * L::SLOT;
    ellt::bar_wait(&pfull[pstage], pphase);
    const unsigned char* st = p_st + pstage * L::P_STAGE;
    const int off = gl * kBM + 64 * wg + 8 * c;  // element of [16, 128]
    const uint4 a = *reinterpret_cast<const uint4*>(st + 2 * off);
    const uint4 b = *reinterpret_cast<const uint4*>(st + L::V_BYTES + 2 * off);
    const uint2 cd = *reinterpret_cast<const uint2*>(st + 2 * L::V_BYTES + off);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<uint4*>(slot + slot_offset(4 * gl + q,
                                                   64 * wg + 8 * c)) =
          expand8(a, b, cd, q);
    fence_proxy_async();
    ellt::named_sync(1 + wg);  // the warpgroup's rows are expanded
    if (t == 0) ellt::bar_arrive(&pempty[pstage]);
    ellt::advance(pstage, pphase, kStages);
  };
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int m0 = (u / p.n_tiles) * kBM, n0 = (u % p.n_tiles) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int held = -1;  // the B stage whose products may still be in flight
    expand(0);
    for (int kt = 0; kt < p.KT; ++kt) {
      ellt::bar_wait(&bfull[bstage], bphase);
      const uint32_t a =
          ellt::smem_addr(slots + (kt % kSlots) * L::SLOT) + wg * kBK * 128;
      const uint32_t b = ellt::smem_addr(b_st + bstage * L::B_STAGE);
      ellt::fence_acc(acc);
      ellt::wg_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        ellt::Wgmma<BN, 1>::mma(
            acc, ellt::desc(a + k * 16 * 128, kBK * 128, 1024, 1),
            ellt::desc(b + k * 16 * 128, kBK * 128, 1024, 1));
      ellt::wg_commit();
      // the next k-step's slot was last read by step kt - 2, whose products
      // the wait of step kt - 1 saw done; it expands while two steps'
      // products may run
      if (kt + 1 < p.KT) expand(kt + 1);
      ellt::wg_wait<1>();  // step kt - 1's products are done
      ellt::fence_acc(acc);
      if (held >= 0 && t == 0) ellt::bar_arrive(&bempty[held]);
      held = bstage;
      ellt::advance(bstage, bphase, kStages);
    }
    ellt::wg_wait<0>();
    ellt::fence_acc(acc);
    if (held >= 0 && t == 0) ellt::bar_arrive(&bempty[held]);
    ellt::store_tile<BN, bf16>(ep, acc, staging + wg * L::STAGING, wg,
                               m0 + 64 * wg, n0, 0);
  }
}

// static: the opt-in flags stay this library's own (a template's static
// local is otherwise one object in the whole process, shared with another
// build of this header that the process loads, whose opt-in then stands
// for this build's kernel)
template <int BN>
static cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = expand_tma_kernel<BN>;
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  cudaError_t e = smt::allow_smem(kern, Layout<BN>::BYTES, ready);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int grid = p.units < sms ? p.units : sms;
  kern<<<grid, kThreads, Layout<BN>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// out = A @ B on the expand-then-dense tile: M % 128 == 0, N % 64 == 0,
// 16-byte aligned operands, else cudaErrorInvalidValue. The tile is 128
// columns wide where N allows, else 64.
inline cudaError_t run(const void* v0, const void* v1, const void* codes,
                       const void* b, void* out, int M, int N, int K, int K4,
                       cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K4 <= 0 || 4 * K4 < K || M % kBM != 0 ||
      N % 64 != 0 || !smt::aligned16(v0) || !smt::aligned16(v1) ||
      !smt::aligned16(codes) || !smt::aligned16(b) || !smt::aligned16(out))
    return cudaErrorInvalidValue;
  Params p;
  cudaError_t e = ellt::make_map(&p.tv0, v0, M, K4, kBM, kG,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = ellt::make_map(&p.tv1, v1, M, K4, kBM, kG, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = ellt::make_map(&p.tc, codes, M, K4, kBM, kG,
                       CU_TENSOR_MAP_SWIZZLE_NONE,
                       CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (e == cudaSuccess)
    e = ellt::make_map(&p.tb, b, N, K, 64, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const int bn = N % 128 == 0 ? 128 : 64;
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.KT = (K + kBK - 1) / kBK;
  p.n_tiles = N / bn;
  p.units = (M / kBM) * p.n_tiles;
  return bn == 128 ? launch<128>(p, stream) : launch<64>(p, stream);
}

}  // namespace sp24x
