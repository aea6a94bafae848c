// K3: 2:4 SpMM, C[M, N] = decompress24(v0, v1, codes)[:, :K] @ B[K, N].
//
// Replaces sparsifyme_tpu/ops/kernels/spmm24_kernel.py: spmm24_pallas (the
// classic grid), spmm24_pallas_fp (fused alpha/beta/c epilogue, split-half
// packed codes) and spmm24_fold_pallas (:925, fold=2 planes). One kernel
// serves all three.
//
// Operands: k-major, batch-folded planes v0/v1/codes [K4, M] (K4 groups of
// 4 along k; 4*K4 >= K), B [K, N] row-major, optional f32 c in the layout of
// the output. Output C [M, N] or, with tout, C^T [N, M].
//
// fold=2 planes are [2*K4, M] for a product of 2*M rows: column j holds row
// 2j in plane rows [0, K4) and row 2j+1 in [K4, 2*K4). The grid gets a
// z-dimension of 2; half h reads plane rows [h*K4, (h+1)*K4) (column stride
// M, as for fold=1 planes) and writes C rows 2j+h: row-major C at offset
// h*N with row stride 2N. Neither the planes nor C are copied or
// un-folded, and loads keep their 16-byte width along M.
//
// What bounds it on the H100: for the bf16 ResNet-50 layers, tensor-core
// operations on wide-n layers and device-memory bytes (A at 1.25 B per
// logical element, plus B and C) on n=64 layers. Design: each block owns a
// tile of C and walks k. Per k-step it reads the compact plane slabs
// (coalesced along M: 1.25 B per A element, not 2), expands them in shared
// memory into a dense A^T slab, stages the matching rows of B (rows >= K
// read as zero) and runs bf16 tensor-core MMAs (wmma) with f32 accumulators.
// The bf16 fast path (M, N multiples of 8, aligned operands) uses 128 x 128
// tiles (128 x 64 where n < 128), 64-deep k-steps, 16-byte loads and two
// shared-memory buffers, so the loads of the next step overlap the MMAs of
// this one. Every other case (f32 operands: plain f32 FMAs on the CUDA
// cores, never TF32; ragged shapes) takes a simple 128 x 64 tile kernel.
// The sparse tensor cores (mma.sp with metadata from codes>>2, codes&3),
// TMA and wgmma are later work.
#include "tile_mma.cuh"

namespace {

using smt::bf16;
using smt::kBN;
using smt::kThreads;

constexpr int BM = 128;
constexpr int BK = 32;  // k per step: 8 groups
constexpr int LDA = BM + 8;
constexpr int LDB = kBN + 8;
constexpr int LDC = kBN + 4;

template <typename T>
__device__ __forceinline__ T zero() { return smt::from_f<T>(0.f); }

template <typename T, typename O, bool PACKED>
__global__ void __launch_bounds__(kThreads)
spmm24_kernel(const T* __restrict__ v0, const T* __restrict__ v1,
              const uint8_t* __restrict__ codes, const T* __restrict__ B,
              const float* __restrict__ c, O* __restrict__ out, int M, int N,
              int K, int K4, float alpha, float beta, int tout, int ldo) {
  constexpr int AB_BYTES = (BK * LDA + BK * LDB) * (int)sizeof(T);
  constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES
                                                                  : C_BYTES];
  T* As = reinterpret_cast<T*>(smem);  // A^T slab [BK][LDA]
  T* Bs = As + BK * LDA;               // B slab   [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int half = K4 / 2;
  const size_t zp = (size_t)blockIdx.z * K4 * M;  // fold=2 half
  v0 += zp;
  v1 += zp;
  codes += zp;
  out += (size_t)blockIdx.z * N;
  if (c != nullptr) c += (size_t)blockIdx.z * N;
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
        const size_t off = (size_t)g * M + gm;
        a0 = v0[off];
        a1 = v1[off];
        int code;
        if (PACKED)  // split-half nibbles: byte j holds groups j, j + K4/2
          code = g < half ? codes[(size_t)g * M + gm] & 15
                          : codes[(size_t)(g - half) * M + gm] >> 4;
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
  smt::epilogue<O, BM>(Cs, LDC, out, c, M, N, m0, n0, alpha, beta, tout != 0,
                       ldo);
}

// bf16 fast path (M, N multiples of 8, 16-byte aligned operands): 128 x BN
// tiles, 64-deep k-steps (16 groups), double-buffered. A chunk is 8 rows
// ms..ms+7 of one group gl: one 16-byte load per value plane and 8 code
// bytes, expanded into four 16-byte shared-memory stores (A^T rows
// 4*gl + j).
template <int BN, bool PACKED>
struct Sp24Loader {
  static constexpr int BK = 64;
  static constexpr int NT = smt::kFastThreads;
  static constexpr int A_ITERS = (BK / 4) * (BM / 8) / NT;
  static constexpr int B_VECS = BK * BN / 8 / NT;
  const bf16* v0;
  const bf16* v1;
  const uint8_t* codes;
  const bf16* B;
  int M, N, K, K4, m0, n0;
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
        const size_t off = (size_t)g * M + gm;
        ra0[i] = *reinterpret_cast<const uint4*>(v0 + off);
        ra1[i] = *reinterpret_cast<const uint4*>(v1 + off);
        if (PACKED) {  // split-half nibbles: byte j holds groups j, j + K4/2
          const int half = K4 / 2;
          const bool hi = g >= half;
          const uint2 p = *reinterpret_cast<const uint2*>(
              codes + (size_t)(hi ? g - half : g) * M + gm);
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

  // bf16 bits of dense A^T row 4*gl + j at row ms + e of chunk i.
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

template <typename O, int BN, bool PACKED>
__global__ void __launch_bounds__(smt::kFastThreads, 2)
spmm24_fast_kernel(const bf16* __restrict__ v0, const bf16* __restrict__ v1,
                   const uint8_t* __restrict__ codes,
                   const bf16* __restrict__ B, const float* __restrict__ c,
                   O* __restrict__ out, int M, int N, int K, int K4,
                   float alpha, float beta, int tout, int ldo) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  const size_t zp = (size_t)blockIdx.z * K4 * M;  // fold=2 half
  Sp24Loader<BN, PACKED> ld;
  ld.v0 = v0 + zp;
  ld.v1 = v1 + zp;
  ld.codes = codes + zp;
  ld.B = B;
  ld.M = M;
  ld.N = N;
  ld.K = K;
  ld.K4 = K4;
  ld.m0 = blockIdx.x * BM;
  ld.n0 = blockIdx.y * BN;
  const size_t zo = (size_t)blockIdx.z * N;
  smt::pipelined_tile<BM, BN, 64, true>(ld, (K + 63) / 64, smem_dyn, out + zo,
                                        c == nullptr ? c : c + zo, M, N,
                                        ld.m0, ld.n0, alpha, beta, tout != 0,
                                        ldo);
}

template <typename O, int BN, bool PACKED>
cudaError_t launch_fast(const void* v0, const void* v1, const void* codes,
                        const void* b, const void* c, void* out, int M, int N,
                        int K, int K4, float alpha, float beta, int tout,
                        int fold, cudaStream_t stream) {
  constexpr int smem = smt::PipeShape<BM, BN, 64, true>::SMEM;
  auto kern = spmm24_fast_kernel<O, BN, PACKED>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = smt::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, fold);
  kern<<<grid, smt::kFastThreads, smem, stream>>>(
      static_cast<const bf16*>(v0), static_cast<const bf16*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<const bf16*>(b),
      static_cast<const float*>(c), static_cast<O*>(out), M, N, K, K4, alpha,
      beta, tout, fold * N);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_fast_bn(const void* v0, const void* v1, const void* codes,
                           const void* b, const void* c, void* out, int M,
                           int N, int K, int K4, float alpha, float beta,
                           int tout, int packed, int fold,
                           cudaStream_t stream) {
#define SMT_SP24_FAST(BNv, PKv)                                              \
  return launch_fast<O, BNv, PKv>(v0, v1, codes, b, c, out, M, N, K, K4,     \
                                  alpha, beta, tout, fold, stream)
  if (N >= 128) {
    if (packed) SMT_SP24_FAST(128, true);
    SMT_SP24_FAST(128, false);
  }
  if (packed) SMT_SP24_FAST(64, true);
  SMT_SP24_FAST(64, false);
#undef SMT_SP24_FAST
}

template <typename T, typename O>
cudaError_t launch(const void* v0, const void* v1, const void* codes,
                   const void* b, const void* c, void* out, int M, int N,
                   int K, int K4, float alpha, float beta, int tout,
                   int packed, int fold, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN, fold);
  auto kern = packed ? spmm24_kernel<T, O, true> : spmm24_kernel<T, O, false>;
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<const T*>(b),
      static_cast<const float*>(c), static_cast<O*>(out), M, N, K, K4, alpha,
      beta, tout, fold * N);
  return cudaGetLastError();
}

}  // namespace

// M is the plane width: the output has M rows, or 2*M with fold=2 (row-major
// C only, unpacked codes).
extern "C" int spmm24_launch(const void* v0, const void* v1, const void* codes,
                             const void* b, const void* c, void* out, int M,
                             int N, int K, int K4, float alpha, float beta,
                             int tout, int packed, int fold, int dtype,
                             int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!(fold == 1 || (fold == 2 && !tout && !packed)))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaSuccess;
  const bool fast = dtype == smt::kBF16 && M % 8 == 0 && N % 8 == 0 &&
                    smt::aligned16(v0) && smt::aligned16(v1) &&
                    smt::aligned16(codes) && smt::aligned16(b) &&
                    smt::aligned16(out) && (c == nullptr || smt::aligned16(c));
#define SMT_SP24_ARGS \
  v0, v1, codes, b, c, out, M, N, K, K4, alpha, beta, tout, packed, fold, s
  if (fast && out_dtype == smt::kBF16)
    return launch_fast_bn<bf16>(SMT_SP24_ARGS);
  if (fast && out_dtype == smt::kF32)
    return launch_fast_bn<float>(SMT_SP24_ARGS);
  if (dtype == smt::kBF16 && out_dtype == smt::kBF16)
    return launch<bf16, bf16>(SMT_SP24_ARGS);
  if (dtype == smt::kBF16 && out_dtype == smt::kF32)
    return launch<bf16, float>(SMT_SP24_ARGS);
  if (dtype == smt::kF32 && out_dtype == smt::kBF16)
    return launch<float, bf16>(SMT_SP24_ARGS);
  if (dtype == smt::kF32 && out_dtype == smt::kF32)
    return launch<float, float>(SMT_SP24_ARGS);
#undef SMT_SP24_ARGS
  return (int)cudaErrorInvalidValue;
}
