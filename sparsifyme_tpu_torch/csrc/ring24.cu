// K7: one step of the row-partitioned 2:4 ring SpMM,
//   acc[cols] (+)= expand24(v0, v1, codes)[k-slice, cols]^T @ slot.
//
// Replaces sparsifyme_tpu/parallel/ring_kernel.py: spmm_24_ring_pallas (:146,
// body _ring_kernel :58) and spmm_24_ring_tiled_pallas (:377, body
// _ring_kernel_tiled :231). On the TPU one kernel runs the whole ring, remote
// copies and semaphores included. On Hopper a remote copy leaves the kernel:
// the exchange of B shards is copies between the ranks' buffers on comm
// streams, ordered by CUDA events (sparsifyme_tpu_torch/parallel/
// ring_kernel.py), and this kernel is the contraction of one ring step. The
// tiled route calls it on one m-tile's columns at a time.
//
// Operands: v0/v1/codes point at the window (group src*K4, column c0) of the
// rank's k-major planes, whose rows are ldp elements apart; the window is
// [K4, M]. slot is the held B shard [4*K4, N], row-major, in natural k order
// (the Pallas kernel's quarter-major permutation of B is not needed: the
// metadata places each kept value at its own k). acc is the rank's f32
// accumulator window [M, N] (row stride N), out its C window in out_dtype.
//   first: the step writes acc instead of adding to it (acc is not read);
//   last:  the step writes acc + part to out in out_dtype (C itself, no cast
//          pass) and leaves acc alone.
// One rank on one step with first and last (P = 1) writes the product to out.
//
// What bounds it on the H100: per step 2 * M * N * 4 * K4 operations (the
// 2:4 rate counts dense-equivalent ones) against the plane window (1.25 B
// per bf16 logical element), the slot and the f32 accumulator, read and
// written at every step (8 B per C element per step, a term K3 does not
// have: at P = 4 ranks and 25088 x 256 it is 154 MB per ring, about
// 0.046 ms at 3.35 TB/s; chip_smoke reports it apart as design_bytes). A
// step is short (K = 256 at the ResNet-scale shard: four 64-deep k-steps)
// and its window narrow (6272 columns, 896 tiled): 128 x 128 tiles would
// give it 98 (tiled: 14) blocks for 132 SMs. Design: K3's sparse
// tensor-core tile (sp24_tile.cuh: mma.sp from the compressed window,
// cp.async ring), with the accumulator as the epilogue's c (beta = 1) and
// as its output, so a middle step adds in place; the wrapper picks the
// tile with K3's rule, which gives a step 196 blocks of 128 x 64 (tiled:
// 56 of 64 x 64, the smallest tile). The bf16 fast path runs when
// M, N and ldp are multiples of 8 and the operands aligned, the simple tile
// otherwise (f32 as plain FMAs, never TF32). The whole ring is replayed as
// one CUDA graph (parallel/ring_graph.py), so the host no longer queues each
// step. Keeping acc on chip across steps (a persistent kernel per rank),
// wgmma.sp and TMA are later work.
#include "sp24_tile.cuh"

namespace {

using smt::bf16;
using sp24::BM;

// acc and out carry no __restrict__: on a middle step they are one buffer.
template <typename T, typename O>
__global__ void __launch_bounds__(smt::kThreads)
ring24_kernel(const T* v0, const T* v1, const uint8_t* codes, const T* slot,
              const float* acc, O* out, int M, int N, int K4, int ldp) {
  sp24::simple_tile<T, O, false>(v0, v1, codes, slot, acc, out, M, N, 4 * K4,
                                 K4, ldp, 1.f, 1.f, false, N, blockIdx.x * BM,
                                 blockIdx.y * smt::kBN);
}

template <int BM_, int BN_, typename O>
__global__ void __launch_bounds__(sp24::SpShape<BM_, BN_>::THREADS,
                                  sp24::SpShape<BM_, BN_>::MIN_BLOCKS)
ring24_sp_kernel(const bf16* v0, const bf16* v1, const uint8_t* codes,
                 const bf16* slot, const float* acc, O* out, int M, int N,
                 int K4, int ldp) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  sp24::sparse_tile<BM_, BN_, O>(v0, v1, codes, slot, acc, out, M, N, 4 * K4,
                                 K4, ldp, false, 1.f, 1.f, false, N,
                                 blockIdx.x * BM_, blockIdx.y * BN_, smem_dyn);
}

#define SMT_RING_PARAMS                                                       \
  const void *v0, const void *v1, const void *codes, const void *slot,        \
      const float *acc, void *out, int M, int N, int K4, int ldp,             \
      cudaStream_t stream
#define SMT_RING_ARGS v0, v1, codes, slot, acc, out, M, N, K4, ldp, stream

template <typename O, int BM_, int BN_>
cudaError_t launch_sp(SMT_RING_PARAMS) {
  static bool ready[smt::kMaxDevices] = {};
  return sp24::launch_sparse<BM_, BN_>(
      ring24_sp_kernel<BM_, BN_, O>, ready, M, N, 1, stream,
      static_cast<const bf16*>(v0), static_cast<const bf16*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<const bf16*>(slot), acc,
      static_cast<O*>(out), M, N, K4, ldp);
}

template <typename T, typename O>
cudaError_t launch_simple(SMT_RING_PARAMS) {
  dim3 grid((M + BM - 1) / BM, (N + smt::kBN - 1) / smt::kBN);
  ring24_kernel<T, O><<<grid, smt::kThreads, 0, stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(v1),
      static_cast<const uint8_t*>(codes), static_cast<const T*>(slot), acc,
      static_cast<O*>(out), M, N, K4, ldp);
  return cudaGetLastError();
}

// tile: index into spmm24_kernel.SP_TILES (sp24::with_tile).
template <typename O>
cudaError_t launch_out(bool fast, int dtype, int tile, SMT_RING_PARAMS) {
  if (fast)
    return sp24::with_tile(tile, [&](auto bm, auto bn) {
      return launch_sp<O, decltype(bm)::value, decltype(bn)::value>(
          SMT_RING_ARGS);
    });
  if (dtype == smt::kBF16) return launch_simple<bf16, O>(SMT_RING_ARGS);
  if (dtype == smt::kF32) return launch_simple<float, O>(SMT_RING_ARGS);
  return cudaErrorInvalidValue;
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

}  // namespace

// M columns (rows of C) and N columns of B in this step's window; K4 groups
// in the k-slice; ldp the planes' row stride in elements. dtype is the type
// of the planes and the slot; out_dtype that of out (used on the last step);
// tile the sparse tile of the bf16 fast path.
extern "C" int ring24_launch(const void* v0, const void* v1, const void* codes,
                             const void* slot, void* acc, void* out, int M,
                             int N, int K4, int ldp, int first, int last,
                             int dtype, int out_dtype, int tile,
                             int device, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if ((!first || !last) && acc == nullptr) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K4 <= 0) return (int)cudaSuccess;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  const float* c = first ? nullptr : static_cast<const float*>(acc);
  void* dst = last ? out : acc;
  const int odt = last ? out_dtype : smt::kF32;
  const bool fast = dtype == smt::kBF16 && M % 8 == 0 && N % 8 == 0 &&
                    ldp % 8 == 0 && smt::aligned16(v0) &&
                    smt::aligned16(v1) && aligned8(codes) &&
                    smt::aligned16(slot) && smt::aligned16(dst) &&
                    (c == nullptr || smt::aligned16(c));
  if (odt == smt::kF32)
    return launch_out<float>(fast, dtype, tile, v0, v1, codes, slot, c, dst,
                             M, N, K4, ldp, s);
  if (odt == smt::kBF16)
    return launch_out<bf16>(fast, dtype, tile, v0, v1, codes, slot, c, dst,
                            M, N, K4, ldp, s);
  return (int)cudaErrorInvalidValue;
}
