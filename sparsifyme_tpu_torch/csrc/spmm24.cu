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
// What bounds it on the H100: at the 2:4 tensor-core rate (1979 TFLOP/s
// dense-equivalent) every bf16 ResNet-50 layer is bound by device-memory
// bytes: A at 1.25 B per logical element, plus B and C. A kernel that
// expanded A to dense would do twice the 2:4 work on the tensor cores and
// stage zeros. Design (sp24_tile.cuh): the bf16 fast path (M, N multiples
// of 8, aligned operands) multiplies the compressed planes on the sparse
// tensor cores (mma.sp m16n8k32, metadata derived in the kernel from the
// codes, packed or not), fed by a 4-stage cp.async ring, so the loads of
// later k-steps overlap the MMAs and the kernel streams the planes
// (coalesced along M) at the memory rate. Each block owns one tile of C and
// walks k; the tile (256x128 down to 64x64) is chosen per launch in the
// Python wrapper: the largest whose grid still gives every SM a block (a
// larger tile re-reads B and A fewer times; small-M, deep-k layers such as
// 196x512x4608 and K7's ring steps take smaller ones). Every other case (f32
// operands: plain f32 FMAs on the CUDA cores, never TF32; ragged shapes)
// takes the simple 128 x 64 tile kernel. wgmma.sp, TMA multicast and a
// persistent scheduler are later work. The tile is shared with K7
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

template <int BM_, int BN_, typename O>
__global__ void __launch_bounds__(sp24::SpShape<BM_, BN_>::THREADS,
                                  sp24::SpShape<BM_, BN_>::MIN_BLOCKS)
spmm24_sp_kernel(const bf16* __restrict__ v0, const bf16* __restrict__ v1,
                 const uint8_t* __restrict__ codes, const bf16* __restrict__ B,
                 const float* __restrict__ c, O* __restrict__ out, int M,
                 int N, int K, int K4, float alpha, float beta, int tout,
                 int packed, int ldo) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  const size_t zp = (size_t)blockIdx.z * K4 * M;  // fold=2 half
  const size_t zo = (size_t)blockIdx.z * N;
  sp24::sparse_tile<BM_, BN_, O>(v0 + zp, v1 + zp, codes + zp, B,
                                 c == nullptr ? c : c + zo, out + zo, M, N, K,
                                 K4, M, packed != 0, alpha, beta, tout != 0,
                                 ldo, blockIdx.x * BM_, blockIdx.y * BN_,
                                 smem_dyn);
}

template <typename O, int BM_, int BN_>
cudaError_t launch_sp(const void* v0, const void* v1, const void* codes,
                      const void* b, const void* c, void* out, int M, int N,
                      int K, int K4, float alpha, float beta, int tout,
                      int packed, int fold, cudaStream_t stream) {
  static bool ready[smt::kMaxDevices] = {};
  return sp24::launch_sparse<BM_, BN_>(
      spmm24_sp_kernel<BM_, BN_, O>, ready, M, N, fold, stream,
      static_cast<const bf16*>(v0), static_cast<const bf16*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<const bf16*>(b),
      static_cast<const float*>(c), static_cast<O*>(out), M, N, K, K4, alpha,
      beta, tout, packed, fold * N);
}

// tile: index into spmm24_kernel.SP_TILES (sp24::with_tile).
template <typename O>
cudaError_t launch_sp_tile(int tile, const void* v0, const void* v1,
                           const void* codes, const void* b, const void* c,
                           void* out, int M, int N, int K, int K4,
                           float alpha, float beta, int tout, int packed,
                           int fold, cudaStream_t stream) {
  return sp24::with_tile(tile, [&](auto bm, auto bn) {
    return launch_sp<O, decltype(bm)::value, decltype(bn)::value>(
        v0, v1, codes, b, c, out, M, N, K, K4, alpha, beta, tout, packed,
        fold, stream);
  });
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
// C only, unpacked codes). tile picks the sparse tile of the bf16 fast path.
extern "C" int spmm24_launch(const void* v0, const void* v1, const void* codes,
                             const void* b, const void* c, void* out, int M,
                             int N, int K, int K4, float alpha, float beta,
                             int tout, int packed, int fold, int dtype,
                             int out_dtype, int tile, void* stream) {
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
    return launch_sp_tile<bf16>(tile, SMT_SP24_ARGS);
  if (fast && out_dtype == smt::kF32)
    return launch_sp_tile<float>(tile, SMT_SP24_ARGS);
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
