// K5: Blocked-ELL SpMM, the expand formulation:
// C[M, N] = BlockedEll(values_km, cols) @ B[Kb, N].
//
// Replaces sparsifyme_tpu/ops/kernels/ell_kernel.py: ell_expand_spmm_pallas
// (:448, body _kernel_expand).
//
// Operands (batch folded into M): values_km [ell * bk, M], the packed blocks
// k-major (row e*bk + kk holds column kk of slot e's block for every row);
// cols [M / bs, ell] int32 block-column indices; B [Kb, N] row-major. Output
// C [M, N] or, with tout, C^T [N, M]. B rows past Kb read as zero.
//
// Semantics, as the TPU kernel's: each block-row's slabs are written into a
// zeroed dense A^T at their block-columns, so when two slots of a block-row
// name the same block-column, the LAST slot's slab is the one multiplied
// (the gather formulation, K4, sums them instead). A block-column outside
// [0, ceil(Kb / bk)) meets only B rows that read as zero.
//
// What bounds it on the H100: as K4, half the dense operations and half the
// A bytes at 50% block sparsity; n=64 layers are bound by device-memory
// bytes, wide-n layers by tensor-core operations. Design: the TPU version
// zero-filled a dense A^T tile and ran dense operations, because its matrix
// unit wanted deep contractions; here nothing is expanded, and only the
// slots that reach the product (dropping a slot that a later slot of the
// same block-column overrides) are read and multiplied. The bf16 path (bs a
// multiple of 128, bk of 32, N of 8, 16-byte aligned operands) is the Hopper
// tile of ell_tile.cuh, whose producer walks only those slots and whose
// wgmma reads the k-major slabs M-major, run with the plan the wrapper
// passes (bn != 0). Other block sizes, and f32 (plain f32 FMAs, never TF32),
// take a simple kernel: a block owns rows of one block-row and an n-tile,
// lists the live slots, then stages each one's k-major slab (coalesced along
// M) and the matching B rows for the MMAs; its tile is the largest of
// 128/64/16 rows dividing bs.
#include "ell_tile.cuh"
#include "tile_mma.cuh"

namespace {

using smt::bf16;
using smt::kBN;
using smt::kThreads;

constexpr int kMaxEll = 1024;  // slots per block-row (4 KB of shared memory)
constexpr int LDB = kBN + 8;
constexpr int LDC = kBN + 4;

template <typename T>
__device__ __forceinline__ T zero() { return smt::from_f<T>(0.f); }

// Lists in live[] (ascending) the slots of one block-row (cols[0..ell)) that
// reach the product and returns their count. A slot is dropped when a later
// slot names the same block-column, or when its block-column lies outside
// [0, kblocks). Every thread of the block must call it.
__device__ int live_slots(const int* __restrict__ cols, int ell, int kblocks,
                          int* live) {
  __shared__ int count;
  for (int e = threadIdx.x; e < ell; e += blockDim.x) {
    const int col = cols[e];
    bool keep = col >= 0 && col < kblocks;
    for (int f = e + 1; keep && f < ell; ++f) keep = cols[f] != col;
    live[e] = keep;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // compact in place: the write index trails e
    int c = 0;
    for (int e = 0; e < ell; ++e)
      if (live[e]) live[c++] = e;
    count = c;
  }
  __syncthreads();
  return count;
}

template <typename T, typename O, int BM, int BK>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const T* __restrict__ values_km, const int* __restrict__ cols,
              const T* __restrict__ B, O* __restrict__ out, int M, int N,
              int Kb, int bs, int bk, int ell, int tout) {
  constexpr int LDA = BM + 8;
  constexpr int AB_BYTES = (BK * LDA + BK * LDB) * (int)sizeof(T);
  constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES
                                                                  : C_BYTES];
  __shared__ int live[kMaxEll];
  T* As = reinterpret_cast<T*>(smem);  // A^T slab [BK][LDA]
  T* Bs = As + BK * LDA;               // B slab   [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int* rcols = cols + (size_t)(m0 / bs) * ell;
  const int nlive = live_slots(rcols, ell, (Kb + bk - 1) / bk, live);
  smt::Mma<T, BM, BK, true> mma;
  mma.init();

  for (int i = 0; i < nlive; ++i) {
    const int e = live[i];
    const long long col = rcols[e];
    for (int kk0 = 0; kk0 < bk; kk0 += BK) {
      for (int idx = threadIdx.x; idx < BK * BM; idx += kThreads) {
        const int kr = idx / BM, r = idx % BM;  // threads walk M: coalesced
        As[kr * LDA + r] =
            values_km[(size_t)(e * bk + kk0 + kr) * M + m0 + r];
      }
      for (int idx = threadIdx.x; idx < BK * kBN; idx += kThreads) {
        const int kr = idx / kBN, cc = idx % kBN;
        const long long gk = col * bk + kk0 + kr;
        const int gn = n0 + cc;
        Bs[kr * LDB + cc] =
            (gk < Kb && gn < N) ? B[(size_t)gk * N + gn] : zero<T>();
      }
      __syncthreads();
      mma.step(As, LDA, Bs, LDB);
      __syncthreads();
    }
  }
  mma.store(Cs, LDC);
  __syncthreads();
  smt::epilogue<O, BM>(Cs, LDC, out, nullptr, M, N, m0, n0, 1.f, 0.f,
                       tout != 0, N);
}

template <typename T, typename O, int BM, int BK>
cudaError_t launch_tile(const void* values_km, const void* cols, const void* b,
                        void* out, int M, int N, int Kb, int bs, int bk,
                        int ell, int tout, cudaStream_t stream) {
  dim3 grid(M / BM, (N + kBN - 1) / kBN);
  expand_kernel<T, O, BM, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(values_km), static_cast<const int*>(cols),
      static_cast<const T*>(b), static_cast<O*>(out), M, N, Kb, bs, bk, ell,
      tout);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch(const void* values_km, const void* cols, const void* b,
                   void* out, int M, int N, int Kb, int bs, int bk, int ell,
                   int tout, cudaStream_t stream) {
  // BM: the largest supported tile that divides the block-row edge; BK: the
  // k-step, which must divide the block column-edge.
#define SMT_EXP_LAUNCH(BMv, BKv)                                             \
  return launch_tile<T, O, BMv, BKv>(values_km, cols, b, out, M, N, Kb, bs, \
                                     bk, ell, tout, stream)
  if (bs % 128 == 0) {
    if (bk % 32 == 0) SMT_EXP_LAUNCH(128, 32);
    SMT_EXP_LAUNCH(128, 16);
  }
  if (bs % 64 == 0) {
    if (bk % 32 == 0) SMT_EXP_LAUNCH(64, 32);
    SMT_EXP_LAUNCH(64, 16);
  }
  if (bk % 32 == 0) SMT_EXP_LAUNCH(16, 32);
  SMT_EXP_LAUNCH(16, 16);
#undef SMT_EXP_LAUNCH
}

}  // namespace

// plan: bn (0: the simple kernels), bk_step, stages, splits, blocks per SM
// and grid of the Hopper tile; ws is its f32 workspace [splits, M, N] when
// splits > 1.
extern "C" int ell_expand_launch(const void* values_km, const void* cols,
                                 const void* b, void* out, void* ws, int M,
                                 int N, int Kb, int bs, int bk, int ell,
                                 int tout, int dtype, int out_dtype, int bn,
                                 int bk_step, int stages, int splits,
                                 int ctas, int grid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || bs % 16 != 0 || M % bs != 0 || ell < 0 || ell > kMaxEll ||
      !(bk == 16 || bk == 32 || bk == 64 || bk == 128))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N <= 0) return (int)cudaSuccess;
  if (bn != 0)
    return dtype == smt::kBF16
               ? (int)ellt::run<true>(values_km, cols, b, nullptr, out, ws, M,
                                      N, Kb, bs, bk, ell, 1.f, 0.f, tout,
                                      out_dtype, bn, bk_step, stages, splits,
                                      ctas, grid, s)
               : (int)cudaErrorInvalidValue;
#define SMT_EXP_ARGS values_km, cols, b, out, M, N, Kb, bs, bk, ell, tout, s
  if (dtype == smt::kBF16 && out_dtype == smt::kBF16)
    return launch<bf16, bf16>(SMT_EXP_ARGS);
  if (dtype == smt::kBF16 && out_dtype == smt::kF32)
    return launch<bf16, float>(SMT_EXP_ARGS);
  if (dtype == smt::kF32 && out_dtype == smt::kBF16)
    return launch<float, bf16>(SMT_EXP_ARGS);
  if (dtype == smt::kF32 && out_dtype == smt::kF32)
    return launch<float, float>(SMT_EXP_ARGS);
#undef SMT_EXP_ARGS
  return (int)cudaErrorInvalidValue;
}
