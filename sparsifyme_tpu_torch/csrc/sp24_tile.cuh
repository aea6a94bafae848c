// The 2:4 tile of the port's SpMM kernels (spmm24.cu: K3, ring24.cu: K7).
//
// A thread block computes one tile of C = A @ B, where A^T is expanded on the
// fly from k-major compressed planes v0/v1/codes [K4, M] (K4 groups of 4
// along k). Plane element (g, m) lies at g * ldp + m: ldp is M for a whole
// plane and the parent's row length for a window of one (a ring step reads
// the k-slice and column range of its shard in place). B is [K, N]
// row-major; rows >= K read as zero.
//
//   * simple_tile: any type and shape; BM x kBN tiles, BK-deep k-steps, the
//     product on the tensor cores (bf16) or CUDA-core FMAs (f32, never TF32).
//   * Loader: the bf16 fast path's register-staged loads for
//     smt::pipelined_tile (M, N and ldp multiples of 8, 16-byte aligned
//     operands): 16-byte plane loads, expanded into four 16-byte stores of
//     A^T rows.
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

// bf16 fast path: BM x BN tiles, 64-deep k-steps (16 groups). A chunk is 8
// columns ms..ms+7 of one group gl: one 16-byte load per value plane and 8
// code bytes, expanded into four 16-byte shared-memory stores (A^T rows
// 4*gl + j).
template <int BN, bool PACKED>
struct Loader {
  static constexpr int BK = 64;
  static constexpr int NT = smt::kFastThreads;
  static constexpr int A_ITERS = (BK / 4) * (BM / 8) / NT;
  static constexpr int B_VECS = BK * BN / 8 / NT;
  const bf16* v0;
  const bf16* v1;
  const uint8_t* codes;
  const bf16* B;
  int M, N, K, K4, ldp, m0, n0;
  uint4 ra0[A_ITERS], ra1[A_ITERS], rb[B_VECS];
  uint2 rc[A_ITERS];

  __device__ void fetch(int s) {
    const int k0 = s * BK;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int ch = threadIdx.x + i * NT;
      const int g = k0 / 4 + ch / (BM / 8), gm = m0 + (ch % (BM / 8)) * 8;
      ra0[i] = ra1[i] = make_uint4(0, 0, 0, 0);
      rc[i] = make_uint2(0, 0);
      if (g < K4 && gm < M) {
        const size_t off = (size_t)g * ldp + gm;
        ra0[i] = *reinterpret_cast<const uint4*>(v0 + off);
        ra1[i] = *reinterpret_cast<const uint4*>(v1 + off);
        if (PACKED) {
          const int half = K4 / 2;
          const bool hi = g >= half;
          const uint2 p = *reinterpret_cast<const uint2*>(
              codes + (size_t)(hi ? g - half : g) * ldp + gm);
          const int sh = hi ? 4 : 0;
          rc[i] = make_uint2((p.x >> sh) & 0x0F0F0F0Fu,
                             (p.y >> sh) & 0x0F0F0F0Fu);
        } else {
          rc[i] = *reinterpret_cast<const uint2*>(codes + off);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = threadIdx.x + i * NT;
      const int kr = v / (BN / 8), cc = (v % (BN / 8)) * 8;
      const int gk = k0 + kr, gn = n0 + cc;
      rb[i] = (gk < K && gn < N)
                  ? *reinterpret_cast<const uint4*>(B + (size_t)gk * N + gn)
                  : make_uint4(0, 0, 0, 0);
    }
  }

  // bf16 bits of dense A^T row 4*gl + j at column ms + e of chunk i.
  __device__ uint32_t pick(int i, int e, int j) const {
    const uint32_t code =
        ((e < 4 ? rc[i].x : rc[i].y) >> ((e & 3) * 8)) & 0xFFu;
    return (code >> 2) == (uint32_t)j  ? smt::lane16(ra0[i], e)
           : (code & 3) == (uint32_t)j ? smt::lane16(ra1[i], e)
                                       : 0u;
  }

  __device__ void stash(bf16* As, int lda, bf16* Bs, int ldb) const {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int ch = threadIdx.x + i * NT;
      const int gl = ch / (BM / 8), ms = (ch % (BM / 8)) * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          w[p] = pick(i, 2 * p, j) | (pick(i, 2 * p + 1, j) << 16);
        *reinterpret_cast<uint4*>(As + (gl * 4 + j) * lda + ms) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = threadIdx.x + i * NT;
      const int kr = v / (BN / 8), cc = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + kr * ldb + cc) = rb[i];
    }
  }
};

}  // namespace sp24
