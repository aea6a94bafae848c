// Probes of run_probe's tile on Hopper's wgmma.sp (sp24_wg_tile.cuh): the
// "wgmma_sp" design of bench/units_probe.py, beside K3's own tile
// (sp24_units.cu, the "mma_sp" design). The port does not call it.
//
// Replaces experiments/units.py: run_probe (body probe_kernel, modes dot,
// expand, both, parity and chain) with the modes and ring depths of
// sp24_units.cu: kFeed is `expand` (every stage's loads of the compressed
// values, metadata and B; no wgmma), kMma `dot` (wgmma.sp on the
// first STAGES stages, loaded once), kFull `both`; STAGES = 2 `parity`, 1
// `chain`. What bounds each: kFeed the bytes it streams, kMma the 2:4
// tensor-core rate, kFull the larger.
#include "sp24_wg_tile.cuh"

// C [M, N] bf16 from the packed A (units_probe.pack_wgmma_sp: 9 KB of values
// and metadata words a k-step and 128-row tile, [KTP, M / 128, 2304]) and B
// [K, N], on the plan (bn, splits, kps, grid) of units_probe.wg_plan; side
// [N / bn, M / 128] int32 (0 but in kFeed); ws f32 [splits, M, N] and parts
// int32 [splits, N / bn * M / 128] where splits > 1. mode: 0 kFull, 1 kFeed,
// 2 kMma.
extern "C" int wgsp_launch(const void* a, const void* b, void* out,
                           void* side, void* ws, void* parts, int M, int N,
                           int K, int KTP, int mode, int stages, int bn,
                           int splits, int kps, int grid, int device,
                           void* stream) {
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  return (int)sp24w::run(mode, stages, a, b, out, side, ws, parts, M, N, K,
                         KTP, bn, splits, kps, grid,
                         static_cast<cudaStream_t>(stream));
}
