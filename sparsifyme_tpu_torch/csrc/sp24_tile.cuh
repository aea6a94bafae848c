// The 2:4 tile of the port's SpMM kernels (spmm24.cu: K3, ring24.cu: K7).
//
// A thread block computes one tile of C = A @ B from A's k-major compressed
// planes v0/v1/codes [K4, M] (K4 groups of 4 along k). Plane element (g, m)
// lies at g * ldp + m: ldp is M for a whole plane and the parent's row
// length for a window of one (a ring step reads the k-slice and column range
// of its shard in place). B is [K, N] row-major; rows >= K read as zero.
//
//   * sparse_tile: the bf16 fast path (M, N and ldp multiples of 8, 16-byte
//     aligned values and B, 8-byte aligned codes) on Hopper's 2:4 sparse
//     tensor cores, mma.sp m16n8k32 (bf16 in, f32 accumulators), so the
//     tensor cores do the 2:4 work and no more, and the kernel is left
//     bound by the bytes it streams. The compressed operand goes to the
//     instruction as it is: per 64-deep k-step a 4-stage cp.async ring in
//     dynamic shared memory stages the v0 and v1 rows interleaved
//     (compressed column 2g is v0[g], 2g+1 is v1[g]), the matching code
//     bytes and the B rows, with 16-byte (codes: 8-byte) copies along M and
//     N and zero fill at the edges, so the loads of later k-steps overlap
//     the MMAs of this one. ldmatrix.trans reads the A and B fragments; no
//     zero of A is ever written. The metadata comes from the staged codes
//     (i0*4+i1, i0 < i1): one pass per k-step swaps each code's 2-bit
//     halves into the instruction's nibble i0 | i1 << 2 and lays the
//     nibbles out as the fragment wants them (threads 2h and 2h+1 of a
//     quad: groups 4h..4h+3 of rows gid and gid+8, in the low and high
//     16 bits). Four tile sizes (256 x 128 on 8 warps, one block per SM;
//     128 x 128, 128 x 64 and 64 x 64 on 4 warps, two), picked per launch
//     by one rule in the
//     Python wrapper (spmm24_kernel.pick_tile) so that a launch fills the
//     card. wgmma.sp, TMA multicast and a persistent scheduler are left to
//     a later change.
//     Two compile-time knobs serve the probes of bench/units_probe.py and
//     leave K3 and K7 as they were at their defaults: STAGES, the depth of
//     the ring (kSpStages; 1 is a serial load, wait, MMA loop), and MODE:
//     kFull (the product), kFeed (every k-step's loads and metadata, no
//     mma.sp: each row of the tile gets the f32 sum over k of the block's
//     first row of A, and the metadata words are XORed into one word per
//     block, `side`) or kMma (the first STAGES k-steps staged and their
//     metadata built once, then KT k-steps of MMAs on slot kt % STAGES
//     with no loads: C = sum over kt < KT of A_{kt % S} B_{kt % S}).
//   * simple_tile: any type and shape; BM x kBN tiles, BK-deep k-steps, A^T
//     expanded in shared memory, the product on the tensor cores (bf16) or
//     CUDA-core FMAs (f32, never TF32).
#pragma once

#include "tile_mma.cuh"

namespace sp24 {

using smt::bf16;
using smt::kBN;
using smt::kThreads;

constexpr int BM = 128;
constexpr int BK = 32;  // k per step of simple_tile: 8 groups
constexpr int LDA = BM + 8;
constexpr int LDB = kBN + 8;
constexpr int LDC = kBN + 4;

template <typename T>
__device__ __forceinline__ T zero() { return smt::from_f<T>(0.f); }

// Tile (m0, n0) of out = alpha * A @ B + beta * c (c may be null; it may
// alias out, each element being read before it is written by the same
// thread). PACKED: split-half nibble codes [K4/2, M], byte j holding groups
// j and j + K4/2.
template <typename T, typename O, bool PACKED>
__device__ void simple_tile(const T* v0, const T* v1, const uint8_t* codes,
                            const T* B, const float* c, O* out, int M, int N,
                            int K, int K4, int ldp, float alpha, float beta,
                            bool tout, int ldo, int m0, int n0) {
  constexpr int AB_BYTES = (BK * LDA + BK * LDB) * (int)sizeof(T);
  constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES
                                                                  : C_BYTES];
  T* As = reinterpret_cast<T*>(smem);  // A^T slab [BK][LDA]
  T* Bs = As + BK * LDA;               // B slab   [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);
  const int half = K4 / 2;
  smt::Mma<T, BM, BK, true> mma;
  mma.init();

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Expand the [BK/4, BM] plane slab into A^T rows 4g+j.
    for (int idx = threadIdx.x; idx < (BK / 4) * BM; idx += kThreads) {
      const int gl = idx / BM, r = idx % BM;
      const int g = k0 / 4 + gl, gm = m0 + r;
      T a0 = zero<T>(), a1 = zero<T>();
      int i0 = 0, i1 = 1;
      if (g < K4 && gm < M) {
        const size_t off = (size_t)g * ldp + gm;
        a0 = v0[off];
        a1 = v1[off];
        int code;
        if (PACKED)
          code = g < half ? codes[(size_t)g * ldp + gm] & 15
                          : codes[(size_t)(g - half) * ldp + gm] >> 4;
        else
          code = codes[off];
        i0 = code >> 2;
        i1 = code & 3;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        As[(gl * 4 + j) * LDA + r] = j == i0 ? a0 : (j == i1 ? a1 : zero<T>());
    }
    for (int idx = threadIdx.x; idx < BK * kBN; idx += kThreads) {
      const int kr = idx / kBN, cc = idx % kBN;
      const int gk = k0 + kr, gn = n0 + cc;
      Bs[kr * LDB + cc] =
          (gk < K && gn < N) ? B[(size_t)gk * N + gn] : zero<T>();
    }
    __syncthreads();
    mma.step(As, LDA, Bs, LDB);
    __syncthreads();
  }
  mma.store(Cs, LDC);
  __syncthreads();
  smt::epilogue<O, BM>(Cs, LDC, out, c, M, N, m0, n0, alpha, beta, tout, ldo);
}

// ---------------------------------------------------------------------------
// The sparse tensor-core tile.

constexpr int kSpStages = 4;
// The modes of sparse_tile (bench/units_probe.py: MODES).
constexpr int kFull = 0, kFeed = 1, kMma = 2;

template <int BM_, int BN_, int STAGES = kSpStages>
struct SpShape {
  static constexpr int KS = 64;          // logical k per stage
  static constexpr int G = KS / 4;       // groups per stage (16)
  static constexpr int KC = KS / 2;      // compressed columns per stage (32)
  static constexpr int LDA = BM_ + 8;    // bf16 per interleaved plane row
  static constexpr int LDB = BN_ + 8;    // bf16 per B row
  static constexpr int A_BYTES = KC * LDA * 2;
  static constexpr int E_BYTES = G * BM_;  // code bytes, [G][BM]
  static constexpr int B_BYTES = KS * LDB * 2;
  static constexpr int STAGE = A_BYTES + E_BYTES + B_BYTES;
  static constexpr int META_WORDS = 2 * BM_;  // [half][mf][gid][h]
  static constexpr int PIPE = STAGES * STAGE + META_WORDS * 4;
  static constexpr int LDC = BN_ + 4;
  static constexpr int EPI = BM_ * LDC * 4;
  static constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
  // 2 x 2 warps, or 4 x 2 for the 256-row tile (one block per SM)
  static constexpr int WARPS_M = BM_ >= 256 ? 4 : 2;
  static constexpr int THREADS = WARPS_M * 2 * 32;
  static constexpr int MIN_BLOCKS = BM_ >= 256 ? 1 : 2;
  static constexpr int WM = BM_ / WARPS_M, WN = BN_ / 2;  // warp tile
  static constexpr int TM = WM / 16, TN = WN / 8;   // m16 x n8 fragments
  static_assert(TM >= 1 && TN >= 1, "tile");
  static_assert(A_BYTES % 16 == 0 && E_BYTES % 16 == 0, "alignment");
  // kMma keeps each staged k-step's metadata in its code bytes' place
  static_assert(META_WORDS * 4 <= E_BYTES, "metadata");
};

using smt::cp16;
using smt::cp8;
using smt::cp_commit;
using smt::cp_wait;
using smt::smem_addr;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

#if (__CUDACC_VER_MAJOR__ < 12) || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 5)
#error "sp24_tile.cuh needs CUDA 12.5 or later (mma.sp::ordered_metadata)"
#endif

// d += A (16 x 32, 2:4 along k, compressed to 16 x 16) @ B (32 x 8).
__device__ __forceinline__ void mma_sp(float* d, const uint32_t* a,
                                       const uint32_t* b, uint32_t e) {
  asm volatile(
      "mma.sp::ordered_metadata.sync.aligned.m16n8k32.row.col.f32.bf16.bf16."
      "f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, "
      "0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(b[2]), "r"(b[3]), "r"(e));
}

// Four code bytes (groups j = 0..3 of one row, byte j) -> the instruction's
// 16 metadata bits: nibble j = i0 | i1 << 2. A zero-filled byte (i0 = i1 =
// 0, only past the planes' edge, where the values are zero too) becomes the
// ordered pattern (0, 1). spmm24_kernel.nibbles16 is this function.
__device__ __forceinline__ uint32_t nibbles16(uint32_t x) {
  const uint32_t i1 = x & 0x03030303u, i0 = (x >> 2) & 0x03030303u;
  const uint32_t z = ((i1 | (i1 >> 1)) & 0x01010101u) ^ 0x01010101u;
  uint32_t n = i0 | (i1 << 2) | (z << 2);
  n = (n | (n >> 4)) & 0x00FF00FFu;
  return (n | (n >> 8)) & 0xFFFFu;
}

// r[i] byte j = x[j] byte i: four rows' code bytes of four groups.
__device__ __forceinline__ void transpose4(const uint32_t* x, uint32_t* r) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t2 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  r[0] = __byte_perm(t0, t1, 0x5410);
  r[1] = __byte_perm(t0, t1, 0x7632);
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

// Tile (m0, n0) of out = alpha * A @ B + beta * c on the sparse tensor
// cores, with c and out as in simple_tile. packed: split-half nibble codes
// [K4/2, ldp]. smem: SpShape<BM_, BN_, STAGES>::SMEM bytes of dynamic shared
// memory. MODE and STAGES as in the header; side (kFeed only): the block's
// word, zeroed before the tile's first barrier, which the block's metadata
// words are XORed into.
template <int BM_, int BN_, typename O, int MODE = kFull,
          int STAGES = kSpStages>
__device__ __forceinline__ void sparse_tile(
    const bf16* v0, const bf16* v1, const uint8_t* codes, const bf16* B,
    const float* c, O* out, int M, int N, int K, int K4, int ldp, bool packed,
    float alpha, float beta, bool tout, int ldo, int m0, int n0,
    unsigned char* smem, uint32_t* side = nullptr) {
  using S = SpShape<BM_, BN_, STAGES>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % S::WARPS_M, wn = warp / S::WARPS_M;
  const int half_k4 = K4 / 2;
  uint32_t* meta = reinterpret_cast<uint32_t*>(smem + STAGES * S::STAGE);
  const int KT = (K + S::KS - 1) / S::KS;
  uint32_t meta_xor = 0;  // kFeed: the XOR of the words this thread built
  float first_row = 0.f;  // kFeed: this lane's part of the first row's sum

  // Stage kt (64 logical k: groups 16kt.., B rows 64kt..) into ring slot.
  auto load = [&](int slot, int kt) {
    unsigned char* st = smem + slot * S::STAGE;
    bf16* As = reinterpret_cast<bf16*>(st);
    uint8_t* Es = st + S::A_BYTES;
    bf16* Bs = reinterpret_cast<bf16*>(st + S::A_BYTES + S::E_BYTES);
    const int g0 = kt * S::G;
    constexpr int ACH = BM_ / 8, BCH = BN_ / 8;
    constexpr int NA = S::KC * ACH, NE = S::G * ACH, NB = S::KS * BCH;
#pragma unroll
    for (int it = 0; it < (NA + S::THREADS - 1) / S::THREADS; ++it) {
      const int ch = tid + it * S::THREADS;
      if (NA % S::THREADS != 0 && ch >= NA) break;
      const int r = ch / ACH, col = (ch % ACH) * 8;  // r = 2 * gl + plane
      const int g = g0 + (r >> 1), gm = m0 + col;
      const bool ok = g < K4 && gm < M;
      const bf16* src = (r & 1) ? v1 : v0;
      cp16(As + r * S::LDA + col, ok ? src + (size_t)g * ldp + gm : src, ok);
    }
#pragma unroll
    for (int it = 0; it < (NE + S::THREADS - 1) / S::THREADS; ++it) {
      const int ch = tid + it * S::THREADS;
      if (NE % S::THREADS != 0 && ch >= NE) break;
      const int gl = ch / ACH, col = (ch % ACH) * 8;
      const int g = g0 + gl, gm = m0 + col;
      const int row = packed && g >= half_k4 ? g - half_k4 : g;
      const bool ok = g < K4 && gm < M;
      cp8(Es + gl * BM_ + col, ok ? codes + (size_t)row * ldp + gm : codes,
          ok);
    }
#pragma unroll
    for (int it = 0; it < (NB + S::THREADS - 1) / S::THREADS; ++it) {
      const int ch = tid + it * S::THREADS;
      if (NB % S::THREADS != 0 && ch >= NB) break;
      const int r = ch / BCH, col = (ch % BCH) * 8;
      const int gk = kt * S::KS + r, gn = n0 + col;
      const bool ok = gk < K && gn < N;
      cp16(Bs + r * S::LDB + col, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  };

  // Metadata words of stage kt from its code bytes: item (half, mf, h, gq)
  // reads groups 8*half + 4h + j (j = 0..3) of rows mf*16 + gq*4 + i and
  // those rows + 8 (i = 0..3) as 32-bit words, transposes the 4 x 4 bytes
  // and writes the words of gid = gq*4 + i. spmm24_kernel.meta_words is
  // this pass.
  auto build_meta = [&](int slot, int kt, uint32_t* meta) {
    const uint8_t* Es = smem + slot * S::STAGE + S::A_BYTES;
    constexpr int MF = BM_ / 16;
    for (int it = tid; it < 2 * MF * 4; it += S::THREADS) {
      const int gq = it & 1, h = (it >> 1) & 1, mf = (it >> 2) % MF,
                hf = (it >> 2) / MF;
      uint32_t L[4], U[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gl = hf * 8 + 4 * h + j;
        const uint8_t* p = Es + gl * BM_ + mf * 16 + gq * 4;
        L[j] = *reinterpret_cast<const uint32_t*>(p);
        U[j] = *reinterpret_cast<const uint32_t*>(p + 8);
        if (packed) {
          const int sh = kt * S::G + gl >= half_k4 ? 4 : 0;
          L[j] = (L[j] >> sh) & 0x0F0F0F0Fu;
          U[j] = (U[j] >> sh) & 0x0F0F0F0Fu;
        }
      }
      uint32_t lo[4], hi[4];
      transpose4(L, lo);
      transpose4(U, hi);
      uint32_t* w = meta + ((hf * MF + mf) * 8 + gq * 4) * 2 + h;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[2 * i] = nibbles16(lo[i]) | (nibbles16(hi[i]) << 16);
        if constexpr (MODE == kFeed) meta_xor ^= w[2 * i];
      }
    }
  };
  // kFeed: the staged plane rows of the block's first row (interleaved row
  // r = 2 * group + plane; rows past the planes are zero), one per lane.
  auto feed_first_row = [&](int slot) {
    static_assert(S::KC == 32, "one staged plane row per lane");
    const bf16* As = reinterpret_cast<const bf16*>(smem + slot * S::STAGE);
    first_row += __bfloat162float(As[lane * S::LDA]);
  };

  float acc[S::TM][S::TN][4];
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if constexpr (MODE != kMma && STAGES > 1) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load(s, s);
      cp_commit();
    }
  }
  const int q = lane >> 3;
  // The MMAs of one stage, with its metadata words in meta.
  auto mma_stage = [&](int slot, const uint32_t* meta) {
    const unsigned char* st = smem + slot * S::STAGE;
    const bf16* As = reinterpret_cast<const bf16*>(st);
    const bf16* Bs =
        reinterpret_cast<const bf16*>(st + S::A_BYTES + S::E_BYTES);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // two m16n8k32 k-steps per stage
      uint32_t a[S::TM][4], e[S::TM];
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        // matrix q of the x4: compressed columns +8*(q>>1), rows +8*(q&1)
        ldsm_x4_trans(a[i], As + (hf * 16 + (q >> 1) * 8 + (lane & 7)) *
                                     S::LDA +
                                 wm * S::WM + i * 16 + (q & 1) * 8);
        e[i] = meta[((hf * (BM_ / 16) + wm * S::TM + i) * 8 + gid) * 2 +
                    (tig & 1)];
      }
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        uint32_t b[4];  // matrix q: k rows 8q..8q+7 of this k-step
        ldsm_x4_trans(b, Bs + (hf * 32 + lane) * S::LDB + wn * S::WN + j * 8);
#pragma unroll
        for (int i = 0; i < S::TM; ++i) mma_sp(acc[i][j], a[i], b, e[i]);
      }
    }
  };
  if constexpr (MODE == kMma) {
    // Stage the first STAGES k-steps and build their metadata once, each
    // into its stage's code bytes (read by then); the k-steps then run
    // MMAs only, the two barriers of a k-step kept.
    auto meta_of = [&](int slot) {
      return reinterpret_cast<uint32_t*>(smem + slot * S::STAGE + S::A_BYTES);
    };
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (s < KT) load(s, s);
      cp_commit();
    }
    cp_wait<0>();
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      __syncthreads();  // stage s landed; meta is free again
      if (s < KT) build_meta(s, s, meta);
      __syncthreads();  // its words written, its code bytes read
      for (int i = tid; i < S::META_WORDS; i += S::THREADS)
        meta_of(s)[i] = meta[i];
    }
    for (int kt = 0; kt < KT; ++kt) {
      const int slot = kt % STAGES;
      __syncthreads();
      __syncthreads();
      mma_stage(slot, meta_of(slot));
    }
  } else if constexpr (STAGES == 1) {
    // The serial ring: load, wait, MMA. One slot takes a third barrier:
    // stage kt may overwrite it only once every warp is done with kt - 1.
    for (int kt = 0; kt < KT; ++kt) {
      __syncthreads();  // every warp is done with stage kt - 1
      load(0, kt);
      cp_commit();
      cp_wait<0>();
      __syncthreads();  // stage kt landed
      build_meta(0, kt, meta);
      if constexpr (MODE == kFeed) feed_first_row(0);
      __syncthreads();  // metadata of stage kt written
      if constexpr (MODE == kFull) mma_stage(0, meta);
    }
  } else {
    for (int kt = 0; kt < KT; ++kt) {
      const int slot = kt % STAGES;
      cp_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; every warp is done with kt - 1
      build_meta(slot, kt, meta);
      if constexpr (MODE == kFeed) feed_first_row(slot);
      if (kt + STAGES - 1 < KT)
        load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
      cp_commit();
      __syncthreads();  // metadata of stage kt written
      if constexpr (MODE == kFull) mma_stage(slot, meta);
    }
  }
  cp_wait<0>();
  __syncthreads();
  if constexpr (MODE == kFeed) {
    // the first row's sum to every lane (the same butterfly order in every
    // warp), then to every element of the tile; the metadata to `side`
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      first_row += __shfl_xor_sync(0xffffffffu, first_row, o);
      meta_xor ^= __shfl_xor_sync(0xffffffffu, meta_xor, o);
    }
    if (lane == 0) atomicXor(side, meta_xor);
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = first_row;
  }
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int r = wm * S::WM + i * 16 + gid;
      const int cc = wn * S::WN + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(Cs + r * S::LDC + cc) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * S::LDC + cc) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  smt::epilogue_vec<O, BM_, BN_, S::THREADS>(Cs, S::LDC, out, c, M, N, m0,
                                             n0, alpha, beta, tout, ldo);
}

// f(BM, BN) (as std::integral_constant<int, ...>) for tile index `tile` of
// spmm24_kernel.SP_TILES: 256x128, 128x128, 128x64, 64x64.
template <int V>
using Int = std::integral_constant<int, V>;

template <typename F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(Int<256>{}, Int<128>{});
    case 1: return f(Int<128>{}, Int<128>{});
    case 2: return f(Int<128>{}, Int<64>{});
    case 3: return f(Int<64>{}, Int<64>{});
  }
  return cudaErrorInvalidValue;
}

// Launch kern (a __global__ wrapper of sparse_tile<BM_, BN_, ..., STAGES>)
// on a grid of BM_ x BN_ tiles, z = fold, after opting it into its shared
// memory on the current device. `ready` is the caller's per-device flag
// array, one for each kernel.
template <int BM_, int BN_, int STAGES = kSpStages, typename Kernel,
          typename... Args>
cudaError_t launch_sparse(Kernel kern, bool* ready, int M, int N, int fold,
                          cudaStream_t stream, Args... args) {
  using S = SpShape<BM_, BN_, STAGES>;
  const cudaError_t e = smt::allow_smem(kern, S::SMEM, ready);
  if (e != cudaSuccess) return e;
  dim3 grid((M + BM_ - 1) / BM_, (N + BN_ - 1) / BN_, fold);
  kern<<<grid, S::THREADS, S::SMEM, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sp24
