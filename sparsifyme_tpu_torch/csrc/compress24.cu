// K2: 2:4 compress of a row-major matrix into k-major planes.
//
// Replaces sparsifyme_tpu/ops/kernels/prune_kernel.py: compress_24_pallas
// (body _compress_kernel), together with the transposed copy the JAX op
// makes before calling it; and prune_compress_24_pallas (:577, the fused
// prune+compress, fold=2 included through the [rows/2, 2*kp] view). The
// kernel ranks every group itself, and a kept element always outranks what
// pruning zeroes, so on unpruned input it writes the planes of the pruned
// matrix: one dense read, compact writes, no pruned copy.
//
// Input w [M, k] row-major. k is padded to kp = K4 * 4 (a multiple of 64)
// inside the kernel: padded positions read as zero. Each group of 4 keeps
// its top 2 by (|x|, position), later positions winning ties, so an
// all-zero group keeps positions 2 and 3 (code 11). Outputs v0, v1 [K4, M]
// in the input type (the kept values, lower position first) and codes
// [K4, M] uint8 = i0 * 4 + i1: bit-identical to the JAX compress_24.
//
// What bounds it on the H100: device-memory bytes (2 B read, 1.25 B
// written per bf16 element). The design keeps the reads 16 bytes wide and
// many of them in flight, and the writes 16 bytes wide and coalesced:
//   * A tile is R rows (a multiple of 8) by KT columns of w. Where k <=
//     kKMax the tile holds whole rows (KT = kp), so its R rows are one
//     contiguous span of R * k elements that starts 16-byte aligned
//     whatever k % 4 is (R * k * sizeof(T) is a multiple of 16): it is
//     copied with 16-byte cp.async chunks and a scalar tail. Deeper k is
//     cut into 64-column tiles, each row piece 16-byte chunks (k * sizeof(T)
//     % 16 == 0 at every ResNet depth; other depths take scalar loads).
//     R is picked by the wrapper (prune_kernel.compress_plan) so that a
//     tile reads about 16 KB and stores whole 128-byte lines of each plane
//     row.
//   * Blocks are persistent (as many as fit on the card, at most one a
//     tile: the launch sizes the grid) and walk their tiles through a ring of
//     two input buffers: the copies of the next tile are in flight while
//     one is ranked and stored, and the other blocks of the SM rank while
//     this one waits (blocks that each load, rank and store once move in
//     step: a wave loads, then ranks, and the memory idles meanwhile; a
//     deeper ring leaves fewer blocks an SM, and ranked slower).
//     Neighbouring blocks take neighbouring k-tiles of the same rows.
//   * Ranking: a thread takes one group of 8 consecutive rows, neighbouring
//     threads on neighbouring groups (conflict-free shared-memory reads),
//     and writes its 8 v0, 8 v1 and 8 codes as one 16-, 16- and 8-byte
//     store into a padded staging tile [groups][R]. Groups past ceil(k / 4)
//     get zeros and code 11 with no loads.
//   * The staging tile goes out with neighbouring threads on neighbouring 8
//     rows of one group: 16-byte stores of v0 and v1 (two for f32) and 8-byte
//     stores of codes, coalesced along M (scalar stores where M % 8 != 0).
// No transposed copy of w is made.
#include "compress24_tile.cuh"

extern "C" int compress24_launch(const void* w, void* v0, void* v1,
                                 void* codes, int M, int k, int K4, int R,
                                 int KT, int dtype, int device,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || 4 * K4 < k || K4 % 16 != 0 || R < 8 || R > kMaxRows ||
      R % 8 != 0 || !(KT == 4 * K4 || (KT == kKTile && k > kKMax)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  if (dtype == smt::kBF16)
    return launch<bf16>(w, v0, v1, codes, M, k, K4, R, KT, s);
  if (dtype == smt::kF32)
    return launch<float>(w, v0, v1, codes, M, k, K4, R, KT, s);
  return (int)cudaErrorInvalidValue;
}
