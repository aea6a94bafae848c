// The wgmma.sp tile: run_probe's tile rebuilt for Hopper. It is K3's
// wgmma_sp route (spmm24.cu: spmm24_wg_launch, kFull at 4 stages), the
// units probe's "wgmma_sp" design (sp24_wg_units.cu, every mode) and K7's
// wgmma_sp ring step (ring24_wg.cu: kRing at 4 stages), beside K3's mma_sp
// tile (sp24_tile.cuh), which it leaves as it is.
//
// C [M, N] bf16 = A @ B with A in 2:4 form and B [K, N] row-major, f32
// accumulation, rows of B past K read as zero. A comes in the layout that
// spmm24_kernel.pack_wgmma_sp (plain) and spmm24.cu's wg_pack_kernel derive
// once from the planes v0, v1, codes: per
// 64-deep k-step (KTP of them cover the planes) and 128-row tile one
// contiguous block of 9 KB, [KTP, M / 128, 2304] words, which one bulk copy
// moves into a stage as it is (the blocks the persistent blocks read at once
// lie side by side):
//   * 8 KB of compressed values, K-major (128 rows of 32 bf16: compressed
//     column 2g is v0[g], 2g + 1 is v1[g], zero past the planes), each
//     64-byte row's 16-byte chunk c at c ^ ((row >> 1) & 3): the 64-byte
//     swizzle wgmma reads, as TMA would have written it;
//   * 1 KB of metadata words [2 (warpgroup), 2 (k32 half), 4 (warp), 8
//     (gid), 2 (h)], in the order in which the threads of a warpgroup hand
//     them to wgmma.sp: the word of thread (warp, gid, tig) holds groups 4
//     (tig & 1)..+3 of the half for row 16 warp + gid (low 16 bits) and that
//     row + 8 (high 16 bits), nibble j = i0 | i1 << 2 (CUTLASS's
//     ELayout_64x32 for 16-bit types; threads with tig & 2 repeat them,
//     sparsity selector 0). So a k-step loads its metadata and never builds
//     it.
// M a multiple of 128, N of the tile width BN (64 or 128), 16-byte aligned
// operands.
//
// What bounds it on the H100: the 2:4 product's bytes (the compressed values
// and metadata at 1.25 B a logical element, B and C once) or the 2:4
// operations at 1979 TFLOP/s. At deep k the SM's shared memory comes first
// (PERF.md): a 64-deep step's fills (25 KB) and wgmma's reads (B by both
// warpgroups, 40 KB) against 256 clocks of 2:4 MMAs. Design, in the shape of
// the ELL tile (ell_tile.cuh, whose helpers it uses):
//   * persistent, with split-k: one block per SM walks the units (m-tile,
//     n-tile, split), the splits and n-tiles of one m-tile adjacent. The plan
//     (BN, splits, k-steps a split, grid) is spmm24_kernel.wg_plan's; with
//     splits, each split stores f32 partials and wg_reduce sums them in
//     split order (no atomics);
//   * one producer warp loads a ring of STAGES stages of 64 logical k: the
//     9 KB block of A and metadata (one bulk copy, contiguous in device
//     memory) and B's 64 rows as BN / 64 TMA boxes of 64 columns (128-byte
//     swizzle), completed on mbarriers;
//   * two consumer warpgroups of 64 rows each issue two wgmma.sp m64nBNk32 a
//     stage (A K-major, B N-major, each thread's metadata word from the
//     stage) and retire them before the next stage's wait, then hand the
//     stage back (wgmma.sp may read its metadata register while it runs,
//     and the compiler, which does not know that, reused the register of a
//     group left in flight: kRing for the next wait's clock read, kFull for
//     the next stage's words; utils/sass.py reads the SASS for that);
//   * the epilogue: bf16 from registers through a staging tile per warpgroup
//     to 16-byte stores (ellt::store_tile), f32 partials from registers.
// MODE and STAGES take the probe's work apart, as sp24_tile.cuh's knobs do
// for K3's tile (bench/units_probe.py says what each computes):
//   * kFull: the product; STAGES 4, 2, or 1 (a one-slot ring: load, wait,
//     multiply, release);
//   * kFeed: every stage loaded; the consumers read their metadata words and
//     the tile's first staged row, XOR the words (each once: threads with
//     tig & 2 skip their copies) into the unit's `side` word and sum the row
//     (every element of the tile gets the sum), and issue no wgmma;
//   * kMma: a unit's first STAGES k-steps loaded once, then its k-steps of
//     wgmma.sp on slot kt % STAGES with no loads.
// kRing is kFull on a window of a larger operand with an accumulator
// epilogue: K7's step (ring24_wg.cu says what it adds).
#pragma once

#include "ell_tile.cuh"

namespace sp24w {

using smt::bf16;

constexpr int kBM = 128;       // rows of a tile: two warpgroups of 64
constexpr int kKS = 64;        // logical k of a stage
constexpr int kKC = kKS / 2;   // compressed columns of a stage
constexpr int kWords = 256;    // metadata words of a stage (1 KB)
constexpr int kBlock = kBM * kKC * 2 + kWords * 4;  // A and metadata bytes
constexpr int kThreads = 288;  // two consumer warpgroups, a producer warp
// The modes (bench/units_probe.py: MODES), as sp24_tile.cuh's, and K7's.
constexpr int kFull = 0, kFeed = 1, kMma = 2, kRing = 3;

template <int BN, int STAGES>
struct Layout {
  static constexpr int A_STAGE = kBlock;  // values, then metadata words
  static constexpr int E_OFF_IN = kBM * kKC * 2;
  static constexpr int B_STAGE = kKS * BN * 2;
  static constexpr int STAGING = ellt::Layout<BN, kKS>::STAGING;  // elements
  static constexpr int B_OFF = 0;
  static constexpr int A_OFF = B_OFF + STAGES * B_STAGE;
  static constexpr int ST_OFF = A_OFF + STAGES * A_STAGE;
  static constexpr int SIDE_OFF = ST_OFF + 2 * STAGING * 2;  // 2 x 8 words
  static constexpr int BAR_OFF = SIDE_OFF + 64;
  static constexpr int BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(B_STAGE % 1024 == 0 && A_STAGE % 1024 == 0, "alignment");
  static_assert(BYTES <= ellt::kSmemMax, "shared memory");
};

struct Params {
  CUtensorMap tb;     // B [K, N] bf16, box {64, 64}, 128-byte swizzle
  const uint32_t* a;  // A and metadata [KTP, M / 128, kBlock / 4]
  void* out;          // C [M, N] bf16, or the f32 partials [splits, M, N]
  int* side;          // [splits, n_tiles * m_tiles], one word a unit, or
                      // nullptr (kFull only: K3 has no side words)
  int M, N, KT, KTP, n_tiles, m_tiles, splits, kps, units;
  // kRing only. A is a window of an operand of a_tiles m-tiles: block (kt,
  // m_tile) lies at a + ((kt0 + kt) * a_tiles + mt0 + m_tile) * kBlock / 4.
  // With one split the unit adds c (f32 [M, N], nullptr: nothing; its
  // fragment read before the unit's k-steps) and writes C in f32 where
  // out_f32, else in bf16; with more, f32 partials.
  const float* c;
  int a_tiles, mt0, kt0, out_f32;
};

// D[64 x BN] += A[64 x 32, 2:4, compressed to 64 x 16] B[32 x BN]: bf16 in,
// f32 accumulators, A K-major, B N-major (the transpose bit), sparsity
// selector 0.
template <int BN>
struct WgmmaSp;

template <>
struct WgmmaSp<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, uint32_t e) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
        "wgmma.mma_async.sp.sync.aligned.m64n64k32.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, %34, 0, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(e), "r"(1));
  }
};

template <>
struct WgmmaSp<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, uint32_t e) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
        "wgmma.mma_async.sp.sync.aligned.m64n128k32.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, %66, 0, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(e), "r"(1));
  }
};

// This thread's fragment of rows m0 .. m0 + 63 and columns n0 .. n0 + BN -
// 1 of the f32 matrix c (row stride N), in the order of its wgmma
// accumulators (ellt::store_tile's): rows r0 and r0 + 8, columns 8 j + cq
// and the next.
template <int BN>
__device__ __forceinline__ void load_fragment(const float* c, int N, int m0,
                                              int n0, float (&f)[BN / 2]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(
          c + (size_t)(m0 + r0 + 8 * h) * N + n0 + 8 * j + cq);
      f[4 * j + 2 * h] = v.x;
      f[4 * j + 2 * h + 1] = v.y;
    }
}

// The unit u's tile and split.
struct Unit {
  int m_tile, n_tile, split;
  __device__ __forceinline__ Unit(const Params& p, int u) {
    split = u % p.splits;
    const int t = u / p.splits;
    n_tile = t % p.n_tiles;
    m_tile = t / p.n_tiles;
  }
};

// The tile's body: a block of kThreads threads with Layout<BN, STAGES>::BYTES
// of dynamic shared memory walks its units. p is the kernel's
// __grid_constant__ parameter (its tensor map is read in place).
template <int MODE, int STAGES, int BN>
__device__ __forceinline__ void wgsp_tile(const Params& p) {
  using L = Layout<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ellt::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* b_st = base + L::B_OFF;
  unsigned char* a_st = base + L::A_OFF;
  bf16* staging = reinterpret_cast<bf16*>(base + L::ST_OFF);
  uint32_t* side_w = reinterpret_cast<uint32_t*>(base + L::SIDE_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ellt::bar_init(&full[s], 1);
      // kFeed: every consumer thread, once its reads are done; else one
      // arrival per consumer warpgroup, once its products are
      ellt::bar_init(&empty[s], MODE == kFeed ? 256 : 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // kMma stages k-steps 0..nload-1 of each unit, once
  const int nload = p.KT < STAGES ? p.KT : STAGES;

  if (warp == 8) {  // the producer: every lane walks, lane 0 issues
    auto load = [&](int slot, int kt, int m_tile, int n0) {
      ellt::bar_arrive_tx(&full[slot], L::A_STAGE + L::B_STAGE);
      const uint32_t* src =
          p.a + (MODE == kRing ? (size_t)(p.kt0 + kt) * p.a_tiles + p.mt0 +
                                     m_tile
                               : (size_t)kt * p.m_tiles + m_tile) *
                    (kBlock / 4);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(ellt::smem_addr(a_st +
                                                        slot * L::A_STAGE)),
          "l"(src), "r"(L::A_STAGE), "r"(ellt::smem_addr(&full[slot]))
          : "memory");
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        ellt::tma_load(b_st + slot * L::B_STAGE + j * kKS * 128, &p.tb,
                       &full[slot], n0 + 64 * j, kt * kKS);
    };
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit w(p, u);
      const int n0 = w.n_tile * BN;
      if constexpr (MODE == kMma) {
        for (int s = 0; s < nload; ++s) {
          ellt::bar_wait(&empty[s], phase ^ 1);
          if (lane == 0) load(s, s, w.m_tile, n0);
          __syncwarp();
        }
        phase ^= 1;
      } else {
        const int kt0 = w.split * p.kps;
        const int kt1 = min(p.KT, kt0 + p.kps);
        for (int kt = kt0; kt < kt1; ++kt) {
          ellt::bar_wait(&empty[stage], phase ^ 1);
          if (lane == 0) load(stage, kt, w.m_tile, n0);
          __syncwarp();
          ellt::advance(stage, phase, STAGES);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg.. of every tile
  const int wg = warp / 4, t = threadIdx.x % 128;
  // this thread's metadata word in a stage's [2][64] words of warpgroup wg
  const int widx = wg * 128 + (t / 32) * 16 + ((t / 4) & 7) * 2 + (t & 1);
  ellt::Params ep;  // what store_tile reads
  ep.c = nullptr;
  ep.M = p.M;
  ep.N = p.N;
  ep.alpha = 1.f;
  ep.beta = 0.f;
  ep.tout = 0;
  ep.out = p.out;
  float acc[BN / 2];
  // kRing with one split: C = the product + c, c's fragment loaded before
  // the unit's k-steps, so that its latency hides behind them
  const float* cin_src = MODE == kRing && p.splits == 1 ? p.c : nullptr;
  float cin[MODE == kRing ? BN / 2 : 1];
  int stage = 0;
  uint32_t phase = 0;
  int parity = 0;  // kFeed: which of the two sets of side words

  // the two wgmma.sp of a stage on its slot
  auto mma_stage = [&](int slot) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(
        a_st + slot * L::A_STAGE + L::E_OFF_IN);
    const uint32_t e0 = words[widx], e1 = words[widx + 64];
    const uint32_t a = ellt::smem_addr(a_st + slot * L::A_STAGE) + wg * 4096;
    const uint32_t b = ellt::smem_addr(b_st + slot * L::B_STAGE);
    ellt::fence_acc(acc);
    ellt::wg_fence();
    WgmmaSp<BN>::mma(acc, ellt::desc(a, 16, 512, 2),
                     ellt::desc(b, kKS * 128, 1024, 1), e0);
    WgmmaSp<BN>::mma(acc, ellt::desc(a + 32, 16, 512, 2),
                     ellt::desc(b + 32 * 128, kKS * 128, 1024, 1), e1);
    ellt::wg_commit();
  };

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w(p, u);
    const int kt0 = w.split * p.kps;
    const int kt1 = min(p.KT, kt0 + p.kps);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    if constexpr (MODE == kRing) {
      if (cin_src != nullptr)
        load_fragment<BN>(cin_src, p.N, w.m_tile * kBM + 64 * wg,
                          w.n_tile * BN, cin);
    }
    float first = 0.f;  // kFeed: this lane's part of the first row's sum
    uint32_t x = 0;     // kFeed: the XOR of this thread's words
    if constexpr (MODE == kMma) {
      for (int s = 0; s < nload; ++s) ellt::bar_wait(&full[s], phase);
      for (int kt = kt0; kt < kt1; ++kt) {
        mma_stage(kt % STAGES);
        ellt::wg_wait<1>();
      }
      ellt::wg_wait<0>();
      ellt::fence_acc(acc);
      if (t == 0)
        for (int s = 0; s < nload; ++s) ellt::bar_arrive(&empty[s]);
      phase ^= 1;
    } else {
      for (int kt = kt0; kt < kt1; ++kt) {
        ellt::bar_wait(&full[stage], phase);
        if constexpr (MODE == kFeed) {
          const uint32_t* words = reinterpret_cast<const uint32_t*>(
              a_st + stage * L::A_STAGE + L::E_OFF_IN);
          if (!(t & 2)) x ^= words[widx] ^ words[widx + 64];
          // row 0 of the stage (unswizzled: the 64-byte swizzle leaves rows
          // 0 and 1 in place), one compressed column a lane
          first += __bfloat162float(
              reinterpret_cast<const bf16*>(a_st + stage * L::A_STAGE)[lane]);
          ellt::bar_arrive(&empty[stage]);
        } else {
          // the stage's products retired before anything else runs, so no
          // register of theirs is in flight when the compiler reuses it
          mma_stage(stage);
          ellt::wg_wait<0>();
          ellt::fence_acc(acc);
          if (t == 0) ellt::bar_arrive(&empty[stage]);
        }
        ellt::advance(stage, phase, STAGES);
      }
    }
    const size_t unit_word =
        (size_t)w.split * p.n_tiles * p.m_tiles + w.n_tile * p.m_tiles +
        w.m_tile;
    if constexpr (MODE == kFeed) {
      // the row's sum to every lane (the same butterfly in every warp), then
      // to every accumulator; the words of the 8 warps to the unit's word
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        first += __shfl_xor_sync(0xffffffffu, first, o);
        x ^= __shfl_xor_sync(0xffffffffu, x, o);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = first;
      if (lane == 0) side_w[parity * 8 + warp] = x;
      asm volatile("bar.sync 3, 256;" ::: "memory");
      if (threadIdx.x == 0) {
        uint32_t v = 0;
        for (int i = 0; i < 8; ++i) v ^= side_w[parity * 8 + i];
        p.side[unit_word] = (int)v;
      }
      parity ^= 1;  // the next unit writes the other set
    } else if (threadIdx.x == 0 && p.side != nullptr) {
      p.side[unit_word] = 0;
    }
    const int m0 = w.m_tile * kBM + 64 * wg, n0 = w.n_tile * BN;
    if constexpr (MODE == kRing) {
      if (cin_src != nullptr) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += cin[i];
      }
      if (p.splits == 1 && !p.out_f32)
        ellt::store_tile<BN, bf16>(ep, acc, staging + wg * L::STAGING, wg,
                                   m0, n0, 0);
      else
        ellt::store_tile<BN, float>(ep, acc, staging + wg * L::STAGING, wg,
                                    m0, n0, p.splits == 1 ? 0 : w.split);
    } else if (p.splits == 1) {
      ellt::store_tile<BN, bf16>(ep, acc, staging + wg * L::STAGING, wg, m0,
                                 n0, 0);
    } else {
      ellt::store_tile<BN, float>(ep, acc, staging + wg * L::STAGING, wg,
                                  m0, n0, w.split);
    }
  }
}

template <int MODE, int STAGES, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    wgsp_kernel(__grid_constant__ const Params p) {
  wgsp_tile<MODE, STAGES, BN>(p);
}

// The second pass of split-k: out = the sum of the f32 partials [splits,
// mn] in split order, 4 elements a thread; block 0 also XORs the units'
// side words [splits, tiles] into side [tiles], where there are side words.
__global__ void __launch_bounds__(256)
    wg_reduce(const float* __restrict__ ws, int splits, long long mn,
              bf16* __restrict__ out, const int* __restrict__ parts,
              int* __restrict__ side, int tiles) {
  const long long step = 4ll * gridDim.x * blockDim.x;
  for (long long i = 4ll * (blockIdx.x * blockDim.x + threadIdx.x); i < mn;
       i += step) {
    float4 v = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < splits; ++s) {
      const float4 w = *reinterpret_cast<const float4*>(ws + s * mn + i);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = packed;
  }
  if (blockIdx.x == 0 && side != nullptr)
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
      int v = 0;
      for (int s = 0; s < splits; ++s) v ^= parts[s * tiles + i];
      side[i] = v;
    }
}

// static, as sp24x::launch: the opt-in flags stay this library's own
template <int MODE, int STAGES, int BN>
static cudaError_t launch_kernel(const Params& p, int grid,
                                 cudaStream_t stream) {
  auto kern = wgsp_kernel<MODE, STAGES, BN>;
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  const cudaError_t e = smt::allow_smem(kern, Layout<BN, STAGES>::BYTES,
                                        ready);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, Layout<BN, STAGES>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// The (mode, stages) pairs built: units_probe.VARIANTS.
template <int BN>
cudaError_t launch_variant(int mode, int stages, const Params& p, int grid,
                           cudaStream_t s) {
#define SP24W_VARIANT(MODE, ST) \
  if (mode == MODE && stages == ST)   \
    return launch_kernel<MODE, ST, BN>(p, grid, s);
  SP24W_VARIANT(kFull, 4)
  SP24W_VARIANT(kFull, 2)
  SP24W_VARIANT(kFull, 1)
  SP24W_VARIANT(kFeed, 4)
  SP24W_VARIANT(kFeed, 2)
  SP24W_VARIANT(kMma, 4)
  SP24W_VARIANT(kMma, 2)
#undef SP24W_VARIANT
  return cudaErrorInvalidValue;
}

// Runs the plan (bn, splits, kps, grid) of spmm24_kernel.wg_plan with the
// kernel that launch(bn, params, grid, stream) starts, then split-k's
// second pass. a: A and its metadata words [KTP, M / 128, kBlock / 4]; out:
// C [M, N] bf16; side: [N / bn, M / 128] int32, or nullptr (no side words;
// kFull only); with splits > 1, ws: f32 [splits, M, N] and, with side
// words, parts: int32 [splits, N / bn * M / 128].
template <class Launch>
inline cudaError_t run_plan(Launch&& launch, const void* a, const void* b,
                            void* out, void* side, void* ws, void* parts,
                            int M, int N, int K, int KTP, int bn, int splits,
                            int kps, int grid, cudaStream_t stream) {
  const int KT = (K + kKS - 1) / kKS;
  const bool ok =
      M > 0 && M % kBM == 0 && (bn == 64 || bn == 128) && N > 0 &&
      N % bn == 0 && K > 0 && KT <= KTP && splits >= 1 && kps >= 1 &&
      (splits - 1) * kps < KT && splits * kps >= KT && grid >= 1 &&
      smt::aligned16(a) && smt::aligned16(b) && smt::aligned16(out) &&
      (splits == 1 ||
       (smt::aligned16(ws) && (side == nullptr || parts != nullptr)));
  if (!ok) return cudaErrorInvalidValue;
  Params p;
  cudaError_t e =
      ellt::make_map(&p.tb, b, N, K, 64, kKS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  p.a = static_cast<const uint32_t*>(a);
  p.out = splits == 1 ? out : ws;
  p.side = static_cast<int*>(splits == 1 ? side : (side ? parts : nullptr));
  p.M = M;
  p.N = N;
  p.KT = KT;
  p.KTP = KTP;
  p.n_tiles = N / bn;
  p.m_tiles = M / kBM;
  p.splits = splits;
  p.kps = kps;
  p.units = p.m_tiles * p.n_tiles * splits;
  p.c = nullptr;  // kRing's fields: the whole operand, no accumulator
  p.a_tiles = p.m_tiles;
  p.mt0 = p.kt0 = p.out_f32 = 0;
  e = launch(bn, p, grid, stream);
  if (e != cudaSuccess || splits == 1) return e;
  const long long mn = (long long)M * N;
  const long long blocks = (mn / 4 + 255) / 256;
  wg_reduce<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      static_cast<const float*>(ws), splits, mn, static_cast<bf16*>(out),
      static_cast<const int*>(parts), static_cast<int*>(side),
      p.n_tiles * p.m_tiles);
  return cudaGetLastError();
}

}  // namespace sp24w
