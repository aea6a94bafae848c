// Probes of K2's fused route: K2 (compress24_tile.cuh) with its work taken
// apart. bench/fused_probe.py times them; the port does not call them.
//
// Replaces experiments/tpu_fused_probe.py: run_variant with its kernels
// kernel_io, kernel_rank, kernel_dot1 and kernel_rm, the cost parts of the
// TPU's fused prune+compress (the copy floor, + the ranking, + one
// compacted plane, and the planes stored row-major). Each mode keeps K2's
// tiles (prune_kernel.compress_plan), its persistent grid, its two-buffer
// ring and its barriers; compress24_tile.cuh says what each computes. All of
// them are bound by device-memory bytes, as K2 is: 2 B read and 1.25 B
// written per bf16 element of w.
//
// bf16 only. mode: 1 kIo, 2 kRank, 3 kDot1 ([K4, M] planes), 4 kRm ([M, K4]
// planes, 16-byte aligned).
#include "compress24_tile.cuh"

extern "C" int compress_units_launch(const void* w, void* v0, void* v1,
                                     void* codes, int M, int k, int K4, int R,
                                     int KT, int mode, int device,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || 4 * K4 < k || K4 % 16 != 0 || R < 8 || R > kMaxRows ||
      R % 8 != 0 || !(KT == 4 * K4 || (KT == kKTile && k > kKMax)))
    return (int)cudaErrorInvalidValue;
  if (mode == kRm && !(smt::aligned16(v0) && smt::aligned16(v1) &&
                       smt::aligned16(codes)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  switch (mode) {
    case kIo: return launch<bf16, kIo>(w, v0, v1, codes, M, k, K4, R, KT, s);
    case kRank:
      return launch<bf16, kRank>(w, v0, v1, codes, M, k, K4, R, KT, s);
    case kDot1:
      return launch<bf16, kDot1>(w, v0, v1, codes, M, k, K4, R, KT, s);
    case kRm: return launch<bf16, kRm>(w, v0, v1, codes, M, k, K4, R, KT, s);
  }
  return (int)cudaErrorInvalidValue;
}
