// K4: Blocked-ELL SpMM, C[M, N] = BlockedEll(values, cols) @ B[Kb, N].
//
// Replaces sparsifyme_tpu/ops/kernels/ell_kernel.py: ell_spmm_pallas (the
// gather formulation, bodies _kernel and _kernel_db).
//
// Operands (batch folded into rows): values [M, ell * bk] row-major, the
// kept blocks of each block-row packed along columns; cols [M / bs, ell]
// int32 block-column indices; B [Kb, N] row-major; optional f32 c in the
// layout of the output. Output C [M, N] or, with tout, C^T [N, M].
//
// What bounds it on the H100: at 50% block sparsity the ResNet-50 layers
// need half the dense operations and half the A bytes; wide-n layers are
// bound by tensor-core operations, n=64 layers by device-memory bytes.
// Design: only kept blocks are read and multiplied. The bf16 path (bs a
// multiple of 128, bk of 32, N of 8, 16-byte aligned operands) is the Hopper
// tile of ell_tile.cuh (TMA into a ring of stages, wgmma, a persistent grid,
// split-k), run with the plan the wrapper passes (bn != 0). Other block
// sizes, and f32 (plain f32 FMAs on the CUDA cores, never TF32), take a
// simple kernel: a block owns rows of one block-row and an n-tile, reads that
// block-row's column indices itself, and for each slot stages the values
// slab and the gathered B rows col*bk + kk.. (rows >= Kb read as zero) in
// shared memory for the MMAs; its tile is the largest of 128/64/16 rows
// dividing bs.
#include "ell_tile.cuh"
#include "tile_mma.cuh"

namespace {

using smt::bf16;
using smt::kBN;
using smt::kThreads;

constexpr int LDB = kBN + 8;
constexpr int LDC = kBN + 4;

template <typename T>
__device__ __forceinline__ T zero() { return smt::from_f<T>(0.f); }

template <typename T, typename O, int BM, int BK>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const T* __restrict__ values, const int* __restrict__ cols,
           const T* __restrict__ B, const float* __restrict__ c,
           O* __restrict__ out, int M, int N, int Kb, int bs, int bk, int ell,
           float alpha, float beta, int tout) {
  constexpr int LDA = BK + 8;
  constexpr int AB_BYTES = (BM * LDA + BK * LDB) * (int)sizeof(T);
  constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES
                                                                  : C_BYTES];
  T* As = reinterpret_cast<T*>(smem);  // values slab [BM][LDA]
  T* Bs = As + BM * LDA;               // gathered B  [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int brow = m0 / bs;
  const size_t ellk = (size_t)ell * bk;
  smt::Mma<T, BM, BK, false> mma;
  mma.init();

  for (int e = 0; e < ell; ++e) {
    const int col = cols[(size_t)brow * ell + e];
    for (int kk0 = 0; kk0 < bk; kk0 += BK) {
      for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
        const int r = idx / BK, kc = idx % BK;
        As[r * LDA + kc] = values[(size_t)(m0 + r) * ellk + (size_t)e * bk +
                                  kk0 + kc];
      }
      for (int idx = threadIdx.x; idx < BK * kBN; idx += kThreads) {
        const int kr = idx / kBN, cc = idx % kBN;
        const long long gk = (long long)col * bk + kk0 + kr;
        const int gn = n0 + cc;
        Bs[kr * LDB + cc] = (gk >= 0 && gk < Kb && gn < N)
                                ? B[(size_t)gk * N + gn]
                                : zero<T>();
      }
      __syncthreads();
      mma.step(As, LDA, Bs, LDB);
      __syncthreads();
    }
  }
  mma.store(Cs, LDC);
  __syncthreads();
  smt::epilogue<O, BM>(Cs, LDC, out, c, M, N, m0, n0, alpha, beta, tout != 0,
                       N);
}

template <typename T, typename O, int BM, int BK>
cudaError_t launch_tile(const void* values, const void* cols, const void* b,
                        const void* c, void* out, int M, int N, int Kb, int bs,
                        int bk, int ell, float alpha, float beta, int tout,
                        cudaStream_t stream) {
  dim3 grid(M / BM, (N + kBN - 1) / kBN);
  ell_kernel<T, O, BM, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<const float*>(c),
      static_cast<O*>(out), M, N, Kb, bs, bk, ell, alpha, beta, tout);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch(const void* values, const void* cols, const void* b,
                   const void* c, void* out, int M, int N, int Kb, int bs,
                   int bk, int ell, float alpha, float beta, int tout,
                   cudaStream_t stream) {
  // BM: the largest supported tile that divides the block-row edge; BK: the
  // k-step, which must divide the block column-edge.
#define SMT_ELL_LAUNCH(BMv, BKv)                                             \
  return launch_tile<T, O, BMv, BKv>(values, cols, b, c, out, M, N, Kb, bs, \
                                     bk, ell, alpha, beta, tout, stream)
  if (bs % 128 == 0) {
    if (bk % 32 == 0) SMT_ELL_LAUNCH(128, 32);
    SMT_ELL_LAUNCH(128, 16);
  }
  if (bs % 64 == 0) {
    if (bk % 32 == 0) SMT_ELL_LAUNCH(64, 32);
    SMT_ELL_LAUNCH(64, 16);
  }
  if (bk % 32 == 0) SMT_ELL_LAUNCH(16, 32);
  SMT_ELL_LAUNCH(16, 16);
#undef SMT_ELL_LAUNCH
}

}  // namespace

// plan: bn (0: the simple kernels), bk_step, stages, splits, blocks per SM
// and grid of the Hopper tile; ws is its f32 workspace [splits, M, N] when
// splits > 1.
extern "C" int ell_spmm_launch(const void* values, const void* cols,
                               const void* b, const void* c, void* out,
                               void* ws, int M, int N, int Kb, int bs, int bk,
                               int ell, float alpha, float beta, int tout,
                               int dtype, int out_dtype, int bn, int bk_step,
                               int stages, int splits, int ctas, int grid,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || bs % 16 != 0 || M % bs != 0 ||
      !(bk == 16 || bk == 32 || bk == 64 || bk == 128))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N <= 0) return (int)cudaSuccess;
  if (bn != 0)
    return dtype == smt::kBF16
               ? (int)ellt::run<false>(values, cols, b, c, out, ws, M, N, Kb,
                                       bs, bk, ell, alpha, beta, tout,
                                       out_dtype, bn, bk_step, stages, splits,
                                       ctas, grid, s)
               : (int)cudaErrorInvalidValue;
  if (dtype == smt::kBF16 && out_dtype == smt::kBF16)
    return launch<bf16, bf16>(values, cols, b, c, out, M, N, Kb, bs, bk, ell,
                              alpha, beta, tout, s);
  if (dtype == smt::kBF16 && out_dtype == smt::kF32)
    return launch<bf16, float>(values, cols, b, c, out, M, N, Kb, bs, bk, ell,
                               alpha, beta, tout, s);
  if (dtype == smt::kF32 && out_dtype == smt::kBF16)
    return launch<float, bf16>(values, cols, b, c, out, M, N, Kb, bs, bk, ell,
                               alpha, beta, tout, s);
  if (dtype == smt::kF32 && out_dtype == smt::kF32)
    return launch<float, float>(values, cols, b, c, out, M, N, Kb, bs, bk, ell,
                                alpha, beta, tout, s);
  return (int)cudaErrorInvalidValue;
}
