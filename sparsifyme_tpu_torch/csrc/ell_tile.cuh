// The Hopper tile of the port's Blocked-ELL kernels: ell_spmm.cu (K4, the
// gather formulation) and ell_expand.cu (K5, the expand formulation) share it.
//
// C = BlockedEll(A, cols) @ B in bf16 with f32 accumulation, for block-rows
// of bs rows (bs a multiple of 128), bk-deep blocks (bk a multiple of 32), N
// a multiple of 8 and 16-byte aligned operands:
//   * K4 reads A as values [M, ell * bk] (k contiguous) and sums repeated
//     block columns;
//   * K5 reads A as values_km [ell * bk, M] (M contiguous) and multiplies only
//     the live slots of a block-row: in range, and named by no later slot of
//     the row (the last slot wins);
//   * rows of B past Kb read as zero.
//
// What bounds it on the H100: at 50% block sparsity the ResNet-50 layers need
// half the dense operations; wide-n, deep-k layers are bound by tensor-core
// operations, n = 64 and shallow-k layers by device-memory bytes (at
// 12544 x 256 x 64 the 205 MB of C). Design, in the usual Hopper shape:
//   * a persistent kernel: one block per SM (two for tiles of at most 128
//     columns, where the plan asks) walks work units (m-tile, n-tile, split)
//     in the order of the unit index, n-tiles of one m-tile next to each
//     other so that their A slabs are read from L2;
//   * one producer warp issues TMA loads into a ring of 3-5 shared-memory
//     stages, completed on mbarriers. A stage holds one BK-deep step of one
//     slot (BK <= bk, so a stage never spans two slots): the A slab, a 2-D box
//     at (e * bk + kk, m0), and the slot's B rows, BN / 64 boxes at (n0 +
//     64 j, col * bk + kk), the coordinate read from cols; TMA's zero fill
//     of boxes past Kb gives the zero rows with no test per element. The
//     producer owns the schedule: it walks the slots (for K5 only the live
//     ones), and flags each stage as the last of its unit, or as one with
//     no data (a unit with nothing to multiply);
//   * two consumer warpgroups of 64 rows each multiply with wgmma
//     (m64nBNk16, bf16 in, f32 accumulators in registers) straight from the
//     swizzled stages: A K-major for K4 and M-major (the transpose bit) for
//     K5, B N-major (the transpose bit), one wgmma group in flight, each
//     stage handed back to the producer when its products are done;
//   * the epilogue: alpha, beta * c (f32, the layout of the output) and the
//     rounding in registers; bf16 C goes through a staging tile per
//     warpgroup to 16-byte stores along the rows of C or of C^T; f32 C is
//     stored from registers. The producer meanwhile loads the next unit's
//     stages, so one tile's epilogue overlaps the next tile's loads;
//   * split-k over slots where the tiles are too few to fill the card: each
//     split stores an f32 partial [M, N] into a workspace, and ell_reduce
//     sums the partials in split order (no atomics: the same result on every
//     run) and applies alpha, beta * c, the output type and C^T.
// The plan (BN, BK, stages, splits, blocks per SM, grid) is made by the
// Python wrapper (ops/kernels/ell_kernel.py: ell_plan), which also mirrors
// this file's shared-memory layout (Layout::bytes).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "tile_mma.cuh"

namespace ellt {

using smt::bf16;

constexpr int kBM = 128;          // rows of a tile: two warpgroups of 64
constexpr int kThreads = 288;     // two consumer warpgroups, a producer warp
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kLdsT = 64 + 8;     // row of a C^T staging tile (bf16)

// Flags of a stage, written by the producer before it arrives on the stage.
constexpr uint32_t kLast = 1, kNoData = 2;

// Shared memory of a block (offsets from a 1024-byte aligned base): the A
// stages, the B stages, one bf16 staging tile per consumer warpgroup (64
// rows of C or BN rows of C^T, padded by 8 columns against bank conflicts),
// the full and empty mbarriers and the flags of each stage. 1024 bytes of
// slack align the base.
template <int BN, int BK>
struct Layout {
  static constexpr int A_STAGE = kBM * BK * 2;
  static constexpr int B_STAGE = BN * BK * 2;
  static constexpr int LDS = BN + 8;  // row of a C staging tile (bf16)
  static constexpr int STAGING =
      64 * LDS > BN * kLdsT ? 64 * LDS : BN * kLdsT;  // elements
  static constexpr int bytes(int stages) {
    return 1024 + stages * (A_STAGE + B_STAGE) + 2 * STAGING * 2 +
           stages * 24;
  }
};

struct Params {
  CUtensorMap ta;  // A: K4 values [M, ell*bk], box {BK, 128}; K5 values_km
                   // [ell*bk, M], box {64, BK}
  CUtensorMap tb;  // B [Kb, N], box {64, BK}
  const int* cols;
  const float* c;  // beta * c is added; null for none (and for partials)
  void* out;       // C [M, N], C^T [N, M], or the f32 partials [splits, M, N]
  int M, N, Kb, bs, bk, ell;
  int n_tiles, splits, slots_per_split, units, stages;
  float alpha, beta;
  int tout;
};

using smt::smem_addr;

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and expect `bytes` of TMA transactions on the barrier.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the barrier with parity `parity` has completed. A
// wait of some 10 s (2^34 clocks) traps: a broken pipeline fails the launch
// instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// One 2-D TMA box at (c0 inner, c1 outer) into dst, completed on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma and its wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x BN] += A[64 x 16] B[16 x BN]: bf16 in, f32 accumulators. TA = 1
// reads A M-major (the transpose bit); B is always N-major (transposed).
template <int BN, int TA>
struct Wgmma;

template <int TA>
struct Wgmma<64, TA> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <int TA>
struct Wgmma<128, TA> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, 1;\n}\n"
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
        : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <int TA>
struct Wgmma<256, TA> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

__device__ __forceinline__ void advance(int& stage, uint32_t& phase,
                                        int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// The unit u's tile and split.
struct Unit {
  int m0, n0, split;
  __device__ __forceinline__ Unit(const Params& p, int u, int bn) {
    split = u % p.splits;
    const int t = u / p.splits;
    n0 = (t % p.n_tiles) * bn;
    m0 = (t / p.n_tiles) * kBM;
  }
};

// K5: slot e of a block-row reaches the product (its column is in range and
// no later slot names it). The producer warp decides it together.
__device__ __forceinline__ bool live(const int* rcols, int ell, int kblocks,
                                     int e, int lane) {
  const int col = rcols[e];
  bool hit = false;
  for (int f = e + 1 + lane; f < ell; f += 32) hit |= rcols[f] == col;
  return !__any_sync(0xffffffffu, hit) && col >= 0 && col < kblocks;
}

// The first slot at or after `from` in [from, e1) that the unit multiplies,
// or e1.
template <bool EXPAND>
__device__ __forceinline__ int next_slot(const int* rcols, int ell,
                                         int kblocks, int from, int e1,
                                         int lane) {
  if constexpr (EXPAND) {
    for (int e = from; e < e1; ++e)
      if (live(rcols, ell, kblocks, e, lane)) return e;
    return e1;
  } else {
    return from < e1 ? from : e1;
  }
}

// The producer warp: every lane walks the schedule, lane 0 issues.
template <bool EXPAND, int BN, int BK>
__device__ __forceinline__ void produce(const Params& p, unsigned char* a_st,
                                        unsigned char* b_st, uint64_t* full,
                                        uint64_t* empty,
                                        volatile uint32_t* flags) {
  using L = Layout<BN, BK>;
  const int lane = threadIdx.x % 32;
  const int kblocks = (p.Kb + p.bk - 1) / p.bk;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w(p, u, BN);
    const int* rcols = p.cols + (size_t)(w.m0 / p.bs) * p.ell;
    const int e0 = w.split * p.slots_per_split;
    const int e1 = min(p.ell, e0 + p.slots_per_split);
    int e = next_slot<EXPAND>(rcols, p.ell, kblocks, e0, e1, lane);
    if (e >= e1) {  // nothing to multiply: the consumers store zeros
      bar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        flags[stage] = kLast | kNoData;
        bar_arrive(&full[stage]);
      }
      __syncwarp();
      advance(stage, phase, p.stages);
      continue;
    }
    while (e < e1) {
      const int en = next_slot<EXPAND>(rcols, p.ell, kblocks, e + 1, e1, lane);
      const long long col = rcols[e];
      for (int kk = 0; kk < p.bk; kk += BK) {
        bar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          flags[stage] = en >= e1 && kk + BK >= p.bk ? kLast : 0u;
          bar_arrive_tx(&full[stage], L::A_STAGE + L::B_STAGE);
          unsigned char* a = a_st + stage * L::A_STAGE;
          unsigned char* b = b_st + stage * L::B_STAGE;
          const int ka = e * p.bk + kk;
          if (EXPAND) {
            tma_load(a, &p.ta, &full[stage], w.m0, ka);
            tma_load(a + BK * 128, &p.ta, &full[stage], w.m0 + 64, ka);
          } else {
            tma_load(a, &p.ta, &full[stage], ka, w.m0);
          }
          // B rows of the slot; a box wholly outside [0, Kb) reads zeros
          long long kr = col * p.bk + kk;
          kr = kr < -BK ? -BK : (kr > p.Kb ? p.Kb : kr);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b + j * BK * 128, &p.tb, &full[stage], w.n0 + 64 * j,
                     (int)kr);
        }
        __syncwarp();
        advance(stage, phase, p.stages);
      }
      e = en;
    }
  }
}

// Stores a warpgroup's 64 x BN accumulators (rows m0.., columns n0..) as
// alpha * acc + beta * c. Accumulator 4j + 2h + i of thread t is row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + i.
template <int BN, typename O>
__device__ __forceinline__ void store_tile(const Params& p,
                                           float (&acc)[BN / 2], bf16* st,
                                           int wg, int m0, int n0, int split) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  const size_t M = p.M, N = p.N;
  if constexpr (std::is_same<O, float>::value) {
    float* out = static_cast<float*>(p.out) + (size_t)split * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + r0 + 8 * h, gn = n0 + 8 * j + cq;
        if (gn >= p.N) continue;
        const size_t o0 = p.tout ? gn * M + gm : gm * N + gn;
        const size_t o1 = p.tout ? o0 + M : o0 + 1;
        float v0 = p.alpha * acc[4 * j + 2 * h];
        float v1 = p.alpha * acc[4 * j + 2 * h + 1];
        if (p.c != nullptr) {
          v0 += p.beta * p.c[o0];
          v1 += p.beta * p.c[o1];
        }
        if (p.tout) {
          out[o0] = v0;
          out[o1] = v1;
        } else {
          *reinterpret_cast<float2*>(out + o0) = make_float2(v0, v1);
        }
      }
  } else {
    // bf16 C: the rounded tile goes through the warpgroup's staging tile to
    // 16-byte stores along the rows of C or of C^T
    constexpr int LDS = Layout<BN, 64>::LDS;
    bf16* out = static_cast<bf16*>(p.out);
    named_sync(1 + wg);  // the last unit's stores have read the staging tile
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, cc = 8 * j + cq;
        const int gm = m0 + r, gn = n0 + cc;
        float v0 = p.alpha * acc[4 * j + 2 * h];
        float v1 = p.alpha * acc[4 * j + 2 * h + 1];
        if (p.c != nullptr && gn < p.N) {
          const size_t o0 = p.tout ? gn * M + gm : gm * N + gn;
          v0 += p.beta * p.c[o0];
          v1 += p.beta * p.c[p.tout ? o0 + M : o0 + 1];
        }
        if (p.tout) {
          st[cc * kLdsT + r] = __float2bfloat16(v0);
          st[(cc + 1) * kLdsT + r] = __float2bfloat16(v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(st + r * LDS + cc) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    named_sync(1 + wg);
    if (!p.tout) {  // 8 consecutive columns of a row of C per store
      for (int i = t; i < 64 * BN / 8; i += 128) {
        const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
        if (n0 + cc < p.N)
          *reinterpret_cast<uint4*>(out + (m0 + r) * N + n0 + cc) =
              *reinterpret_cast<const uint4*>(st + r * LDS + cc);
      }
    } else {  // 8 consecutive rows of a column of C^T
      for (int i = t; i < BN * 8; i += 128) {
        const int cc = i / 8, r = (i % 8) * 8;
        if (n0 + cc < p.N)
          *reinterpret_cast<uint4*>(out + (n0 + cc) * M + m0 + r) =
              *reinterpret_cast<const uint4*>(st + cc * kLdsT + r);
      }
    }
  }
}

// A consumer warpgroup: rows 64 wg.. of every unit's tile.
template <bool EXPAND, int BN, int BK, typename O>
__device__ __forceinline__ void consume(const Params& p, int wg,
                                        unsigned char* a_st,
                                        unsigned char* b_st, bf16* st,
                                        uint64_t* full, uint64_t* empty,
                                        volatile uint32_t* flags) {
  using L = Layout<BN, BK>;
  // K4's A is K-major (rows of BK * 2 bytes, swizzled across 8-row groups);
  // K5's A and every B are N- or M-major: 64-column boxes of BK rows of 128
  // bytes, 8-row groups 1024 bytes apart, boxes BK * 128 bytes apart.
  constexpr uint32_t A_WG = EXPAND ? BK * 128 : 64 * BK * 2;
  constexpr uint32_t A_STEP = EXPAND ? 16 * 128 : 32;  // bytes per k16
  constexpr uint32_t A_LBO = EXPAND ? BK * 128 : 16;
  constexpr uint32_t A_SBO = EXPAND ? 1024 : 8 * BK * 2;
  constexpr uint32_t A_SWZ = EXPAND || BK == 64 ? 1 : 2;
  const int t = threadIdx.x % 128;
  float acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w(p, u, BN);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int held = -1;  // the stage whose products may still be in flight
    uint32_t f;
    do {
      bar_wait(&full[stage], phase);
      f = flags[stage];
      if (!(f & kNoData)) {
        const uint32_t a = smem_addr(a_st + stage * L::A_STAGE) + wg * A_WG;
        const uint32_t b = smem_addr(b_st + stage * L::B_STAGE);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          Wgmma<BN, EXPAND ? 1 : 0>::mma(
              acc, desc(a + k * A_STEP, A_LBO, A_SBO, A_SWZ),
              desc(b + k * 16 * 128, BK * 128, 1024, 1));
        wg_commit();
        wg_wait<1>();  // the products of the held stage are done
        fence_acc(acc);
        if (held >= 0 && t == 0) bar_arrive(&empty[held]);
        held = stage;
      } else if (t == 0) {
        bar_arrive(&empty[stage]);
      }
      advance(stage, phase, p.stages);
    } while (!(f & kLast));
    wg_wait<0>();
    fence_acc(acc);
    if (held >= 0 && t == 0) bar_arrive(&empty[held]);
    store_tile<BN, O>(p, acc, st, wg, w.m0 + 64 * wg, w.n0, w.split);
  }
}

// CTAS blocks share an SM: one (up to 224 registers a thread), or two for
// tiles of at most 128 columns (up to 112), whose units then overlap one
// block's epilogue with the other's products.
template <bool EXPAND, int BN, int BK, typename O, int CTAS>
__global__ void __launch_bounds__(kThreads, CTAS)
    ell_tma_kernel(__grid_constant__ const Params p) {
  static_assert(CTAS == 1 || (CTAS == 2 && BN <= 128), "blocks per SM");
  using L = Layout<BN, BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* a_st = base;
  unsigned char* b_st = a_st + p.stages * L::A_STAGE;
  bf16* staging = reinterpret_cast<bf16*>(b_st + p.stages * L::B_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * L::STAGING);
  uint64_t* empty = full + p.stages;
  volatile uint32_t* flags = reinterpret_cast<uint32_t*>(empty + p.stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2)
    produce<EXPAND, BN, BK>(p, a_st, b_st, full, empty, flags);
  else
    consume<EXPAND, BN, BK, O>(p, wg, a_st, b_st, staging + wg * L::STAGING,
                               full, empty, flags);
}

// The second pass of split-k: out = alpha * sum of the partials (in split
// order) + beta * c, as C or C^T, through a 32 x 32 tile.
template <typename O>
__global__ void __launch_bounds__(256)
    ell_reduce(const float* __restrict__ ws, int splits, int M, int N,
               const float* __restrict__ c, O* __restrict__ out, float alpha,
               float beta, int tout) {
  __shared__ float tile[32][33];
  const int m0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t mn = (size_t)M * N;
  for (int i = ty; i < 32; i += 8) {
    const int gm = m0 + i, gn = n0 + tx;
    float v = 0.f;
    if (gm < M && gn < N)
      for (int s = 0; s < splits; ++s) v += ws[s * mn + (size_t)gm * N + gn];
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int gm = tout ? m0 + tx : m0 + i;
    const int gn = tout ? n0 + i : n0 + tx;
    if (gm >= M || gn >= N) continue;
    const size_t off = tout ? (size_t)gn * M + gm : (size_t)gm * N + gn;
    float v = alpha * (tout ? tile[tx][i] : tile[i][tx]);
    if (c != nullptr) v += beta * c[off];
    out[off] = smt::from_f<O>(v);
  }
}

// --- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call; the library links only the
// runtime, so it is looked up in the driver library the process has loaded.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 2-D bf16 tensor map: `inner` x `outer` elements, rows `inner` apart, boxes
// of box_inner x box_outer, zero fill outside.
inline cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t inner,
                            uint64_t outer, uint32_t box_inner,
                            uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool EXPAND, int BN, int BK, typename O, int CTAS>
cudaError_t launch_kernel(const Params& p, int grid, cudaStream_t stream) {
  auto kern = ell_tma_kernel<EXPAND, BN, BK, O, CTAS>;
  static bool ready[smt::kMaxDevices] = {};
  const cudaError_t e = smt::allow_smem(kern, kSmemMax, ready);
  if (e != cudaSuccess) return e;
  const int smem = Layout<BN, BK>::bytes(p.stages);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool EXPAND, typename O>
cudaError_t launch_plan(const Params& p, int bn, int bk_step, int ctas,
                        int grid, cudaStream_t stream) {
#define ELLT_LAUNCH(BNv, BKv, CTASv)                                      \
  if (bn == BNv && bk_step == BKv && ctas == CTASv)                       \
  return launch_kernel<EXPAND, BNv, BKv, O, CTASv>(p, grid, stream)
  ELLT_LAUNCH(256, 64, 1);
  ELLT_LAUNCH(256, 32, 1);
  ELLT_LAUNCH(128, 64, 1);
  ELLT_LAUNCH(128, 32, 1);
  ELLT_LAUNCH(64, 64, 1);
  ELLT_LAUNCH(64, 32, 1);
  ELLT_LAUNCH(128, 64, 2);
  ELLT_LAUNCH(128, 32, 2);
  ELLT_LAUNCH(64, 64, 2);
  ELLT_LAUNCH(64, 32, 2);
#undef ELLT_LAUNCH
  return cudaErrorInvalidValue;
}

// Runs the plan (bn, bk_step, stages, splits, ctas, grid) made by the
// wrapper: ctas blocks share an SM. a is
// K4's values or K5's values_km, ws the f32 workspace [splits, M, N] when
// splits > 1. out_dtype is smt::kBF16 or smt::kF32.
template <bool EXPAND>
cudaError_t run(const void* a, const void* cols, const void* b, const void* c,
                void* out, void* ws, int M, int N, int Kb, int bs, int bk,
                int ell, float alpha, float beta, int tout, int out_dtype,
                int bn, int bk_step, int stages, int splits, int ctas,
                int grid, cudaStream_t stream) {
  const bool ok =
      bs % kBM == 0 && M % bs == 0 && bk % bk_step == 0 &&
      (bk_step == 32 || bk_step == 64) && N % 8 == 0 && Kb > 0 && ell > 0 &&
      stages >= 2 && splits >= 1 && grid >= 1 && smt::aligned16(a) &&
      smt::aligned16(b) && smt::aligned16(out) &&
      (c == nullptr || smt::aligned16(c)) &&
      (splits == 1 || (ws != nullptr && smt::aligned16(ws)));
  if (!ok) return cudaErrorInvalidValue;
  Params p;
  const uint64_t ellk = (uint64_t)ell * bk;
  cudaError_t e =
      EXPAND ? make_map(&p.ta, a, M, ellk, 64, bk_step,
                        CU_TENSOR_MAP_SWIZZLE_128B)
             : make_map(&p.ta, a, ellk, M, bk_step, kBM,
                        bk_step == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  e = make_map(&p.tb, b, N, Kb, 64, bk_step, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  p.cols = static_cast<const int*>(cols);
  p.M = M;
  p.N = N;
  p.Kb = Kb;
  p.bs = bs;
  p.bk = bk;
  p.ell = ell;
  p.n_tiles = (N + bn - 1) / bn;
  p.splits = splits;
  p.slots_per_split = (ell + splits - 1) / splits;
  p.units = (M / kBM) * p.n_tiles * splits;
  p.stages = stages;
  if (splits == 1) {
    p.c = static_cast<const float*>(c);
    p.out = out;
    p.alpha = alpha;
    p.beta = beta;
    p.tout = tout;
    return out_dtype == smt::kBF16
               ? launch_plan<EXPAND, bf16>(p, bn, bk_step, ctas, grid,
                                                    stream)
           : out_dtype == smt::kF32
               ? launch_plan<EXPAND, float>(p, bn, bk_step, ctas, grid,
                                                     stream)
               : cudaErrorInvalidValue;
  }
  p.c = nullptr;
  p.out = ws;
  p.alpha = 1.f;
  p.beta = 0.f;
  p.tout = 0;
  e = launch_plan<EXPAND, float>(p, bn, bk_step, ctas, grid, stream);
  if (e != cudaSuccess) return e;
  const dim3 rgrid((N + 31) / 32, (M + 31) / 32);
  const float* w = static_cast<const float*>(ws);
  const float* c32 = static_cast<const float*>(c);
  if (out_dtype == smt::kBF16)
    ell_reduce<bf16><<<rgrid, 256, 0, stream>>>(
        w, splits, M, N, c32, static_cast<bf16*>(out), alpha, beta, tout);
  else if (out_dtype == smt::kF32)
    ell_reduce<float><<<rgrid, 256, 0, stream>>>(
        w, splits, M, N, c32, static_cast<float*>(out), alpha, beta, tout);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace ellt
