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
// Design: each block owns rows of one block-row and an n-tile, and reads that
// block-row's column indices itself (no scalar prefetch on a GPU). For each
// ELL slot it stages the values slab (coalesced along k) and the gathered B
// rows col*bk + kk.. (rows >= Kb read as zero) in shared memory and
// accumulates with bf16 tensor-core MMAs (wmma, f32 accumulators). Only kept
// blocks are read and multiplied: skipped blocks cost nothing. The bf16 fast
// path (bs a multiple of 128, bk of 32) uses 128 x 128 tiles (128 x 64
// where n < 128), 16-byte loads and two shared-memory buffers, so the next
// slab's loads overlap this slab's MMAs. Other block sizes, and f32 (plain
// f32 FMAs on the CUDA cores, never TF32), take a simple kernel whose tile
// is the largest of 128/64/16 rows dividing bs. B slabs are re-read by every
// block-row from L2; TMA multicast and wgmma are later work.
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

// bf16 fast path (bs a multiple of 128, bk a multiple of 32, N a multiple of
// 8, aligned operands): 128 x BN tiles, BK-deep steps over (slot, k-slab),
// 16-byte loads, double-buffered.
template <int BN, int BK>
struct EllLoader {
  static constexpr int NT = smt::kFastThreads;
  static constexpr int A_VECS = 128 * BK / 8 / NT;
  static constexpr int B_VECS = BK * BN / 8 / NT;
  const bf16* values;
  const int* cols;
  const bf16* B;
  int N, Kb, bk, ell, m0, n0, brow, steps_per_slot;
  size_t ellk;
  uint4 ra[A_VECS], rb[B_VECS];

  __device__ void fetch(int s) {
    const int e = s / steps_per_slot, kk = (s % steps_per_slot) * BK;
    const long long col = cols[(size_t)brow * ell + e];
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = threadIdx.x + i * NT;
      const int r = v / (BK / 8), kc = (v % (BK / 8)) * 8;
      ra[i] = *reinterpret_cast<const uint4*>(
          values + (size_t)(m0 + r) * ellk + (size_t)e * bk + kk + kc);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = threadIdx.x + i * NT;
      const int kr = v / (BN / 8), cc = (v % (BN / 8)) * 8;
      const long long gk = col * bk + kk + kr;
      const int gn = n0 + cc;
      rb[i] = (gk >= 0 && gk < Kb && gn < N)
                  ? *reinterpret_cast<const uint4*>(B + (size_t)gk * N + gn)
                  : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void stash(bf16* As, int lda, bf16* Bs, int ldb) const {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = threadIdx.x + i * NT;
      const int r = v / (BK / 8), kc = (v % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * lda + kc) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = threadIdx.x + i * NT;
      const int kr = v / (BN / 8), cc = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + kr * ldb + cc) = rb[i];
    }
  }
};

template <typename O, int BN, int BK>
__global__ void __launch_bounds__(smt::kFastThreads, 2)
ell_fast_kernel(const bf16* __restrict__ values, const int* __restrict__ cols,
                const bf16* __restrict__ B, const float* __restrict__ c,
                O* __restrict__ out, int M, int N, int Kb, int bs, int bk,
                int ell, float alpha, float beta, int tout) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  EllLoader<BN, BK> ld;
  ld.values = values;
  ld.cols = cols;
  ld.B = B;
  ld.N = N;
  ld.Kb = Kb;
  ld.bk = bk;
  ld.ell = ell;
  ld.m0 = blockIdx.x * 128;
  ld.n0 = blockIdx.y * BN;
  ld.brow = ld.m0 / bs;
  ld.steps_per_slot = bk / BK;
  ld.ellk = (size_t)ell * bk;
  smt::pipelined_tile<128, BN, BK, false>(ld, ell * (bk / BK), smem_dyn, out,
                                          c, M, N, ld.m0, ld.n0, alpha, beta,
                                          tout != 0, N);
}

template <typename O, int BN, int BK>
cudaError_t launch_fast(const void* values, const void* cols, const void* b,
                        const void* c, void* out, int M, int N, int Kb, int bs,
                        int bk, int ell, float alpha, float beta, int tout,
                        cudaStream_t stream) {
  constexpr int smem = smt::PipeShape<128, BN, BK, false>::SMEM;
  auto kern = ell_fast_kernel<O, BN, BK>;
  static bool ready[smt::kMaxDevices] = {};
  const cudaError_t e = smt::allow_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
  dim3 grid(M / 128, (N + BN - 1) / BN);
  kern<<<grid, smt::kFastThreads, smem, stream>>>(
      static_cast<const bf16*>(values), static_cast<const int*>(cols),
      static_cast<const bf16*>(b), static_cast<const float*>(c),
      static_cast<O*>(out), M, N, Kb, bs, bk, ell, alpha, beta, tout);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_fast_tile(const void* values, const void* cols,
                             const void* b, const void* c, void* out, int M,
                             int N, int Kb, int bs, int bk, int ell,
                             float alpha, float beta, int tout,
                             cudaStream_t stream) {
#define SMT_ELL_FAST(BNv, BKv)                                              \
  return launch_fast<O, BNv, BKv>(values, cols, b, c, out, M, N, Kb, bs, bk, \
                                  ell, alpha, beta, tout, stream)
  if (N >= 128) {
    if (bk % 64 == 0) SMT_ELL_FAST(128, 64);
    SMT_ELL_FAST(128, 32);
  }
  if (bk % 64 == 0) SMT_ELL_FAST(64, 64);
  SMT_ELL_FAST(64, 32);
#undef SMT_ELL_FAST
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

extern "C" int ell_spmm_launch(const void* values, const void* cols,
                               const void* b, const void* c, void* out, int M,
                               int N, int Kb, int bs, int bk, int ell,
                               float alpha, float beta, int tout, int dtype,
                               int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || bs % 16 != 0 || M % bs != 0 ||
      !(bk == 16 || bk == 32 || bk == 64 || bk == 128))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N <= 0) return (int)cudaSuccess;
  const bool fast = dtype == smt::kBF16 && bs % 128 == 0 && bk % 32 == 0 &&
                    N % 8 == 0 && smt::aligned16(values) &&
                    smt::aligned16(b) && smt::aligned16(out) &&
                    (c == nullptr || smt::aligned16(c));
  if (fast && out_dtype == smt::kBF16)
    return launch_fast_tile<bf16>(values, cols, b, c, out, M, N, Kb, bs, bk,
                                  ell, alpha, beta, tout, s);
  if (fast && out_dtype == smt::kF32)
    return launch_fast_tile<float>(values, cols, b, c, out, M, N, Kb, bs, bk,
                                   ell, alpha, beta, tout, s);
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
