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
// takes the simple 128 x 64 tile kernel. The tile is shared with K7
// (ring24.cu).
//
// The wgmma_sp route (spmm24_wg_launch, after the mma_sp entry below): the
// persistent, TMA-fed wgmma.sp tile of sp24_wg_tile.cuh in its kFull mode
// at 4 stages, on A packed once after compress (spmm24_pack_launch writes
// the operand from the planes: 9 KB a 64-deep k-step and 128-row tile,
// values pre-swizzled, then the metadata words in wgmma.sp's thread order;
// spmm24_kernel.pack_wgmma_sp is its plain version). It takes bf16 A and
// B, bf16 C, M % 128 == 0 and N % 64 == 0, and no epilogue; every other
// call keeps the mma_sp tile. Split-k (spmm24_kernel.wg_plan) sums f32
// partials in a second pass. On large compute-bound products (M % 256 ==
// 0) the plan may take the tile's 256-row unit instead, walked in bands of
// m-tiles that share B's column strips (spmm24_wg256_launch). Where it
// wins on the H100 (PERF.md): a warpgroup issues 64 x BN x 32 sparse
// products from shared memory, where mma.sp issues 16 x 8 x 32 from
// registers, and a stage's A and metadata arrive in one bulk copy instead
// of being built by the block.
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
                             int out_dtype, int tile, int device,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!(fold == 1 || (fold == 2 && !tout && !packed)))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaSuccess;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
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

// --- the wgmma_sp route ----------------------------------------------------
// Everything below this line is K3's wgmma_sp route; the mma_sp kernels
// above do not depend on it (tests/test_torch_cuda.py builds the text above
// alone and finds their SASS unchanged).
#include "sp24_wg_tile.cuh"

namespace {

constexpr int kPackPitch = 136;  // bf16 a staged group row: 128 + 8 (pad)

// nibble i0 | i1 << 2 of a code i0 * 4 + i1; i1 == 0 (only the zero code of
// the padding) becomes (0, 1), as spmm24_kernel.nibbles16 makes it
__device__ __forceinline__ uint32_t wg_nibble(uint32_t code) {
  const uint32_t i1 = code & 3;
  return ((code >> 2) & 3) | ((i1 ? i1 : 1u) << 2);
}

// One block a (k-step, 128-row tile) of the wgmma_sp operand: the planes'
// 16 groups x 128 rows staged in shared memory (16-byte loads along M, zero
// past K4), then the tile's 9 KB written in order with 16-byte stores: 512
// chunks of compressed values, chunk q holding row q / 4's logical chunk
// (q % 4) ^ ((row >> 1) & 3) (groups 4 lc..4 lc + 3, v0 in the low and v1 in
// the high half of each word), then the 256 metadata words, one a thread
// (word t = [warpgroup, k32 half, warp, gid, h]).
__global__ void __launch_bounds__(256)
    wg_pack_kernel(const bf16* __restrict__ v0, const bf16* __restrict__ v1,
                   const uint8_t* __restrict__ codes,
                   uint32_t* __restrict__ out, int M, int K4) {
  __shared__ __align__(16) bf16 s0[16][kPackPitch];
  __shared__ __align__(16) bf16 s1[16][kPackPitch];
  __shared__ __align__(16) uint8_t sc[16][128];
  const int tile = blockIdx.x, kt = blockIdx.y, t = threadIdx.x;
  const size_t m0 = (size_t)tile * sp24w::kBM;
  {
    const int g = t / 16, c = t % 16;  // group row, 8 bf16 of it
    const int gg = kt * 16 + g;
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (gg < K4) {
      a = *reinterpret_cast<const uint4*>(v0 + (size_t)gg * M + m0 + 8 * c);
      b = *reinterpret_cast<const uint4*>(v1 + (size_t)gg * M + m0 + 8 * c);
    }
    *reinterpret_cast<uint4*>(&s0[g][8 * c]) = a;
    *reinterpret_cast<uint4*>(&s1[g][8 * c]) = b;
    if (t < 128) {
      const int gc = t / 8, cc = t % 8;  // group row, 16 codes of it
      uint4 q = make_uint4(0, 0, 0, 0);
      if (kt * 16 + gc < K4)
        q = *reinterpret_cast<const uint4*>(
            codes + (size_t)(kt * 16 + gc) * M + m0 + 16 * cc);
      *reinterpret_cast<uint4*>(&sc[gc][16 * cc]) = q;
    }
  }
  __syncthreads();
  uint32_t* blk =
      out + ((size_t)kt * gridDim.x + tile) * (sp24w::kBlock / 4);
#pragma unroll
  for (int q = t; q < 512; q += 256) {
    const int r = q / 4, lc = (q % 4) ^ ((r >> 1) & 3);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (uint32_t)__bfloat16_as_ushort(s0[4 * lc + e][r]) |
             ((uint32_t)__bfloat16_as_ushort(s1[4 * lc + e][r]) << 16);
    reinterpret_cast<uint4*>(blk)[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int h = t & 1, gid = (t >> 1) & 7, warp = (t >> 4) & 3;
  const int half = (t >> 6) & 1, wg = t >> 7;
  const int r = 64 * wg + 16 * warp + gid;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int g = 8 * half + 4 * h + j;
    word |= wg_nibble(sc[g][r]) << (4 * j);
    word |= wg_nibble(sc[g][r + 8]) << (16 + 4 * j);
  }
  blk[2048 + t] = word;
}

// The route's kernel: kFull at 4 stages, 64 or 128 columns.
cudaError_t wg_full(int bn, const sp24w::Params& p, int grid,
                    cudaStream_t stream) {
  return bn == 128
             ? sp24w::launch_kernel<sp24w::kFull, 4, 128>(p, grid, stream)
             : sp24w::launch_kernel<sp24w::kFull, 4, 64>(p, grid, stream);
}

// The same on the 256-row unit.
cudaError_t wg_tall(int bn, const sp24w::Params& p, int grid,
                    cudaStream_t stream) {
  return bn == 128 ? sp24w::launch_tall<128>(p, grid, stream)
                   : sp24w::launch_tall<64>(p, grid, stream);
}

}  // namespace

// The wgmma_sp operand [KTP, M / 128, 2304] int32 from planes v0, v1 (bf16)
// and codes (uint8), each [K4, M] with M % 128 == 0, KTP >= ceil(K4 / 16)
// (k-steps past the planes are zero values), 16-byte aligned. Reads the
// planes once (1.25 B a logical element), writes 1.125 B a logical element.
extern "C" int spmm24_pack_launch(const void* v0, const void* v1,
                                  const void* codes, void* out, int M, int K4,
                                  int KTP, int device, void* stream) {
  if (M <= 0 || M % sp24w::kBM || K4 <= 0 || KTP < (K4 + 15) / 16 ||
      !smt::aligned16(v0) || !smt::aligned16(v1) || !smt::aligned16(codes) ||
      !smt::aligned16(out))
    return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  wg_pack_kernel<<<dim3(M / sp24w::kBM, KTP), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(v0), static_cast<const bf16*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<uint32_t*>(out), M, K4);
  return (int)cudaGetLastError();
}

// C [M, N] bf16 = A @ B on the wgmma_sp tile: a the packed operand
// [KTP, M / 128, 2304], b [K, N] bf16, the plan (bn, splits, kps, grid) of
// spmm24_kernel.wg_plan; ws f32 [splits, M, N] where splits > 1.
extern "C" int spmm24_wg_launch(const void* a, const void* b, void* out,
                                void* ws, int M, int N, int K, int KTP,
                                int bn, int splits, int kps, int grid,
                                int device, void* stream) {
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  return (int)sp24w::run_plan(wg_full, a, b, out, nullptr, ws, nullptr, M,
                              N, K, KTP, bn, splits, kps, grid,
                              static_cast<cudaStream_t>(stream));
}

// The same on the 256-row unit (M % 256 == 0), its units in bands of band
// m-tiles: the plan (bn, splits, kps, band, grid) of spmm24_kernel.wg_plan.
extern "C" int spmm24_wg256_launch(const void* a, const void* b, void* out,
                                   void* ws, int M, int N, int K, int KTP,
                                   int bn, int splits, int kps, int band,
                                   int grid, int device, void* stream) {
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  return (int)sp24w::run_plan(wg_tall, a, b, out, nullptr, ws, nullptr, M,
                              N, K, KTP, bn, splits, kps, grid,
                              static_cast<cudaStream_t>(stream),
                              sp24w::kTallBM, band);
}
