// Shared pieces of the port's matmul kernels (spmm24.cu and ring24.cu through
// sp24_tile.cuh, ell_spmm.cu, ell_expand.cu).
//
// A thread block of kThreads threads computes a BM x kBN tile of C in f32.
// Each k-step stages an A slab and a B slab in shared memory; Mma<T, ...>
// accumulates their product:
//   * bf16: warp-level tensor-core MMA (nvcuda::wmma 16x16x16, f32
//     accumulators);
//   * f32: plain f32 FMAs on the CUDA cores. Never TF32, which keeps
//     about three decimal digits.
// The accumulators then go through a shared-memory f32 tile to a
// coalesced epilogue that applies alpha/beta/c and stores C or C^T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace smt {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 64;        // n-edge of every block tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Product of the staged slabs, accumulated over k-steps.
//   A_KMAJOR: As is A^T, [BK][lda] (element (m, k) at As[k * lda + m]);
//   else As is A, [BM][lda] (element (m, k) at As[m * lda + k]).
//   Bs is [BK][ldb], row-major.
template <typename T, int BM, int BK, bool A_KMAJOR>
struct Mma;

template <int BM, int BK, bool A_KMAJOR>
struct Mma<bf16, BM, BK, A_KMAJOR> {
  static_assert(BM == 16 || BM == 32 || BM == 64 || BM == 128, "BM");
  static_assert(BK % 16 == 0, "BK");
  static constexpr int FM = BM / 16;              // fragment rows
  static constexpr int FN = kBN / 16;             // fragment cols (4)
  static constexpr int WM = FM < 8 ? FM : 8;      // warps along m
  static constexpr int WN = 8 / WM;               // warps along n
  static constexpr int FN_PER = FN / WN > 0 ? FN / WN : 1;
  using ALayout = typename std::conditional<A_KMAJOR, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[FN_PER];
  int fm, fn0;
  bool active;

  __device__ void init() {
    const int warp = threadIdx.x / 32;
    fm = warp % WM;
    fn0 = (warp / WM) * FN_PER;
    active = fn0 < FN;
#pragma unroll
    for (int j = 0; j < FN_PER; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);
  }

  __device__ void step(const bf16* As, int lda, const bf16* Bs, int ldb) {
    if (!active) return;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, ALayout>
          a;
      const bf16* ap = A_KMAJOR ? As + kk * lda + fm * 16
                                : As + fm * 16 * lda + kk;
      nvcuda::wmma::load_matrix_sync(a, ap, lda);
#pragma unroll
      for (int j = 0; j < FN_PER; ++j) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                               nvcuda::wmma::row_major>
            b;
        nvcuda::wmma::load_matrix_sync(b, Bs + kk * ldb + (fn0 + j) * 16, ldb);
        nvcuda::wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  __device__ void store(float* Cs, int ldc) {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < FN_PER; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + fm * 16 * ldc + (fn0 + j) * 16,
                                      acc[j], ldc, nvcuda::wmma::mem_row_major);
  }
};

template <int BM, int BK, bool A_KMAJOR>
struct Mma<float, BM, BK, A_KMAJOR> {
  // Thread t owns column n = t % kBN and rows t / kBN + 4 * i.
  static constexpr int PER = BM * kBN / kThreads;
  static_assert(PER >= 1 && BM * kBN % kThreads == 0, "BM");
  float acc[PER];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  }

  __device__ void step(const float* As, int lda, const float* Bs, int ldb) {
    const int n = threadIdx.x % kBN;
    const int m0 = threadIdx.x / kBN;
    constexpr int kStride = kThreads / kBN;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float b = Bs[kk * ldb + n];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int m = m0 + i * kStride;
        const float a = A_KMAJOR ? As[kk * lda + m] : As[m * lda + kk];
        acc[i] = fmaf(a, b, acc[i]);
      }
    }
  }

  __device__ void store(float* Cs, int ldc) {
    const int n = threadIdx.x % kBN;
    const int m0 = threadIdx.x / kBN;
    constexpr int kStride = kThreads / kBN;
#pragma unroll
    for (int i = 0; i < PER; ++i) Cs[(m0 + i * kStride) * ldc + n] = acc[i];
  }
};

// out = alpha * Cs + beta * c for rows [m0, m0 + BM) and columns
// [n0, n0 + kBN), masked to M x N. Row-major C is [M, N] with row stride
// ldo (N, or 2N for the two interleaved halves of a fold=2 product); with
// tout, C^T is [N, M]. c (f32, same layout as out) may be null.
template <typename O, int BM>
__device__ void epilogue(const float* Cs, int ldc, O* out, const float* c,
                         int M, int N, int m0, int n0, float alpha, float beta,
                         bool tout, int ldo) {
  for (int idx = threadIdx.x; idx < BM * kBN; idx += kThreads) {
    int r, cc;
    if (tout) {  // consecutive threads walk m: coalesced C^T rows
      cc = idx / BM;
      r = idx % BM;
    } else {  // consecutive threads walk n: coalesced C rows
      r = idx / kBN;
      cc = idx % kBN;
    }
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= M || gn >= N) continue;
    const size_t off = tout ? (size_t)gn * M + gm : (size_t)gm * ldo + gn;
    float v = alpha * Cs[r * ldc + cc];
    if (c != nullptr) v += beta * c[off];
    out[off] = from_f<O>(v);
  }
}

// dtype codes shared with the Python wrappers.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// ---------------------------------------------------------------------------
// Pieces of the bf16 fast paths (sp24_tile.cuh): 16-byte aligned operands and
// a vectorised epilogue for blocks of kFastThreads threads.
constexpr int kFastThreads = 128;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename O>
__device__ __forceinline__ void store8(O* dst, const float* v);
template <>
__device__ __forceinline__ void store8<bf16>(bf16* dst, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    w[p] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * p])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * p + 1]))
            << 16);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// epilogue() with 8 consecutive outputs per thread (16- or 32-byte stores),
// for a block of NT threads.
template <typename O, int BM, int BN, int NT = kFastThreads>
__device__ void epilogue_vec(const float* Cs, int ldc, O* out, const float* c,
                             int M, int N, int m0, int n0, float alpha,
                             float beta, bool tout, int ldo) {
  for (int idx = threadIdx.x; idx < BM * BN / 8; idx += NT) {
    int r, cc;
    if (tout) {  // 8 consecutive m of one column of C^T
      cc = idx / (BM / 8);
      r = (idx % (BM / 8)) * 8;
    } else {  // 8 consecutive n of one row of C
      r = idx / (BN / 8);
      cc = (idx % (BN / 8)) * 8;
    }
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= M || gn >= N) continue;
    const size_t off = tout ? (size_t)gn * M + gm : (size_t)gm * ldo + gn;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = alpha * (tout ? Cs[(r + i) * ldc + cc] : Cs[r * ldc + cc + i]);
    if (c != nullptr) {
      const float4 c0 = reinterpret_cast<const float4*>(c + off)[0];
      const float4 c1 = reinterpret_cast<const float4*>(c + off)[1];
      v[0] += beta * c0.x; v[1] += beta * c0.y;
      v[2] += beta * c0.z; v[3] += beta * c0.w;
      v[4] += beta * c1.x; v[5] += beta * c1.y;
      v[6] += beta * c1.z; v[7] += beta * c1.w;
    }
    store8<O>(out + off, v);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// device: the attribute belongs to the current device's copy of the kernel,
// and the ranks of a ring may launch it on several cards. `done` is the
// caller's flag array for this kernel, kMaxDevices long.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

}  // namespace smt
