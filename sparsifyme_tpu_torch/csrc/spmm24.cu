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
// TMA and wgmma are later work. The tile is sp24_tile.cuh, shared with K7
// (ring24.cu).
#include "sp24_tile.cuh"

namespace {

using smt::bf16;
using sp24::BM;

template <typename T, typename O, bool PACKED>
__global__ void __launch_bounds__(smt::kThreads)
spmm24_kernel(const T* __restrict__ v0, const T* __restrict__ v1,
              const uint8_t* __restrict__ codes, const T* __restrict__ B,
              const float* __restrict__ c, O* __restrict__ out, int M, int N,
              int K, int K4, float alpha, float beta, int tout, int ldo) {
  const size_t zp = (size_t)blockIdx.z * K4 * M;  // fold=2 half
  const size_t zo = (size_t)blockIdx.z * N;
  sp24::simple_tile<T, O, PACKED>(
      v0 + zp, v1 + zp, codes + zp, B, c == nullptr ? c : c + zo, out + zo, M,
      N, K, K4, M, alpha, beta, tout != 0, ldo, blockIdx.x * BM,
      blockIdx.y * smt::kBN);
}

template <typename O, int BN, bool PACKED>
__global__ void __launch_bounds__(smt::kFastThreads, 2)
spmm24_fast_kernel(const bf16* __restrict__ v0, const bf16* __restrict__ v1,
                   const uint8_t* __restrict__ codes,
                   const bf16* __restrict__ B, const float* __restrict__ c,
                   O* __restrict__ out, int M, int N, int K, int K4,
                   float alpha, float beta, int tout, int ldo) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  const size_t zp = (size_t)blockIdx.z * K4 * M;  // fold=2 half
  sp24::Loader<BN, PACKED> ld;
  ld.v0 = v0 + zp;
  ld.v1 = v1 + zp;
  ld.codes = codes + zp;
  ld.B = B;
  ld.M = M;
  ld.N = N;
  ld.K = K;
  ld.K4 = K4;
  ld.ldp = M;
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
  static bool ready[smt::kMaxDevices] = {};
  const cudaError_t e = smt::allow_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
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
  dim3 grid((M + BM - 1) / BM, (N + smt::kBN - 1) / smt::kBN, fold);
  auto kern = packed ? spmm24_kernel<T, O, true> : spmm24_kernel<T, O, false>;
  kern<<<grid, smt::kThreads, 0, stream>>>(
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
