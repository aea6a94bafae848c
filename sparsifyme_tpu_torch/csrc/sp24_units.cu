// Probes of K3's tile: the sparse tile of sp24_tile.cuh with its work taken
// apart (MODE), at a chosen ring depth (STAGES), and the expand-then-dense
// tile beside it. bench/units_probe.py times them; the port does not call
// them. The wgmma.sp design of the same probe is sp24_wg_units.cu.
//
// Replaces experiments/units.py: run_probe (body probe_kernel, modes dot,
// expand, both, parity and chain), which asks whether a TPU overlaps the
// 2:4 expansion of A (VPU) with the dot (MXU) in one kernel body, and
// run_probe_fp1, the software-pipelined expand -> dot (each step expands one
// row block into a dense slab, the next step multiplies that slab by B).
//
//   * units24_launch: sparse_tile<BM, BN, bf16, MODE, STAGES> at the tile of
//     spmm24_kernel.pick_tile. MODE kFeed is `expand` (every k-step's
//     cp.async loads of A's planes, codes and B, and its metadata, no
//     mma.sp), kMma is `dot` (MMAs on staged k-steps, no loads), kFull is
//     `both` (K3's tile; its epilogue here knows alpha = 1, beta = 0 and no
//     transpose at compile time); STAGES = 2 is `parity` (two slabs by
//     step parity), STAGES = 1 `chain` (one slab, each step waiting for its
//     load). The modes keep the ring's two barriers a k-step, so they differ
//     only in the work they name. What bounds each: kFeed the bytes it
//     streams, kMma the 2:4 tensor-core rate, kFull the larger.
//     bf16 in and out, M and N multiples of 8, 16-byte aligned operands: the
//     shapes of K3's sparse tile.
//   * fp1_launch: the expand-then-dense tile of sp24_expand_tile.cuh (TMA
//     loads of the planes and B, A expanded into a swizzled dense A^T slot
//     in shared memory, wgmma on it): run_probe_fp1's design on this card.
//     The TPU kernel's slab is quarter-major (row q * k4 + g holds A[:, 4g +
//     q]), so it multiplies B's rows in that order; the wrapper permutes B
//     once (B'[4g + q] = B[q * k4 + g]) and this tile computes A @ B', what
//     the TPU kernel computes. Bound by the 2:4 product's bytes or the dense
//     operations, whichever is larger. M a multiple of 128, N of 64,
//     16-byte aligned operands.
#include "sp24_expand_tile.cuh"
#include "sp24_tile.cuh"

namespace {

using smt::bf16;

template <int BM_, int BN_, int MODE, int STAGES>
__global__ void __launch_bounds__(sp24::SpShape<BM_, BN_, STAGES>::THREADS,
                                  sp24::SpShape<BM_, BN_, STAGES>::MIN_BLOCKS)
units_kernel(const bf16* __restrict__ v0, const bf16* __restrict__ v1,
             const uint8_t* __restrict__ codes, const bf16* __restrict__ B,
             bf16* __restrict__ out, uint32_t* __restrict__ side, int M,
             int N, int K, int K4) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  // one side word a block, [grid.y][grid.x], zeroed here: the tile's
  // barriers order this store before kFeed's XORs into it
  uint32_t* word = side + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) *word = 0;
  sp24::sparse_tile<BM_, BN_, bf16, MODE, STAGES>(
      v0, v1, codes, B, nullptr, out, M, N, K, K4, M, false, 1.f, 0.f, false,
      N, blockIdx.x * BM_, blockIdx.y * BN_, smem_dyn, word);
}

template <int BM_, int BN_, int MODE, int STAGES>
cudaError_t launch_units(const void* v0, const void* v1, const void* codes,
                         const void* b, void* out, void* side, int M, int N,
                         int K, int K4, cudaStream_t stream) {
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  return sp24::launch_sparse<BM_, BN_, STAGES>(
      units_kernel<BM_, BN_, MODE, STAGES>, ready, M, N, 1, stream,
      static_cast<const bf16*>(v0), static_cast<const bf16*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), static_cast<uint32_t*>(side), M, N, K, K4);
}

// The (mode, stages) pairs built: units_probe.VARIANTS.
template <int BM_, int BN_>
cudaError_t launch_variant(int mode, int stages, const void* v0,
                           const void* v1, const void* codes, const void* b,
                           void* out, void* side, int M, int N, int K, int K4,
                           cudaStream_t s) {
#define SMT_UNITS(MODE, ST)                                                  \
  if (mode == MODE && stages == ST)                                          \
    return launch_units<BM_, BN_, MODE, ST>(v0, v1, codes, b, out, side, M, \
                                            N, K, K4, s);
  SMT_UNITS(sp24::kFull, 4)
  SMT_UNITS(sp24::kFull, 2)
  SMT_UNITS(sp24::kFull, 1)
  SMT_UNITS(sp24::kFeed, 4)
  SMT_UNITS(sp24::kFeed, 2)
  SMT_UNITS(sp24::kMma, 4)
  SMT_UNITS(sp24::kMma, 2)
#undef SMT_UNITS
  return cudaErrorInvalidValue;
}

bool aligned(int M, int N, const void* v0, const void* v1, const void* codes,
             const void* b, const void* out) {
  return M % 8 == 0 && N % 8 == 0 && smt::aligned16(v0) &&
         smt::aligned16(v1) && smt::aligned16(codes) && smt::aligned16(b) &&
         smt::aligned16(out);
}

}  // namespace

// out [M, N] bf16 from planes v0, v1, codes [K4, M] and B [K, N]; side
// [ceil(N / BN), ceil(M / BM)] uint32 (0 but in kFeed). mode:
// 0 kFull, 1 kFeed, 2 kMma; tile: an index of spmm24_kernel.SP_TILES.
extern "C" int units24_launch(const void* v0, const void* v1,
                              const void* codes, const void* b, void* out,
                              void* side, int M, int N, int K, int K4,
                              int mode, int stages, int tile, int device,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || 4 * K4 < K || side == nullptr ||
      !aligned(M, N, v0, v1, codes, b, out))
    return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)sp24::with_tile(tile, [&](auto bm, auto bn) {
    return launch_variant<decltype(bm)::value, decltype(bn)::value>(
        mode, stages, v0, v1, codes, b, out, side, M, N, K, K4, s);
  });
}

// out [M, N] bf16 = A @ B from planes [K4, M] and B [K, N] (the permuted B'
// of run_probe_fp1's product), on the expand-then-dense tile.
extern "C" int fp1_launch(const void* v0, const void* v1, const void* codes,
                          const void* b, void* out, int M, int N, int K,
                          int K4, int device, void* stream) {
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  return (int)sp24x::run(v0, v1, codes, b, out, M, N, K, K4,
                         static_cast<cudaStream_t>(stream));
}
