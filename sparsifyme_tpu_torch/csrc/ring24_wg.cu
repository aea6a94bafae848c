// K7's wgmma_sp step: one step of the row-partitioned 2:4 ring SpMM on the
// persistent, TMA-fed wgmma.sp tile (sp24_wg_tile.cuh, mode kRing),
//   acc[cols] (+)= expand24(A)[k-slice, cols]^T @ slot,
// the contract of ring24.cu's step, on A packed once after compress.
//
// Replaces sparsifyme_tpu/parallel/ring_kernel.py: spmm_24_ring_pallas (:146,
// body _ring_kernel :58) and spmm_24_ring_tiled_pallas (:377, body
// _ring_kernel_tiled :231), beside ring24.cu's mma_sp step, which keeps the
// calls this one does not take (f32, ragged shapes, containers without the
// packed operand). Both ring routes launch it; the tiled route once per
// (m-tile, step).
//
// Operands: a is the wgmma_sp operand (spmm24_kernel.pack_wgmma_sp: [KTP,
// a_tiles, 2304] int32, 9 KB a 64-deep k-step and 128-row tile). The step's
// window of it is the k-steps kt0 .. kt0 + K / 64 (the k-slice of the held
// shard: K = 4 * k4s logical k) and the m-tiles mt0 .. mt0 + M / 128 (the
// step's columns); on a one-card mesh a is the whole container's operand
// and mt0 counts from its first column, not from the rank's. slot is the
// held B shard [K, N] bf16, row-major (TMA, 128-byte swizzle). acc is the
// rank's f32 accumulator window [M, N] and out its C window, both with row
// stride N:
//   first: the step writes acc instead of adding to it (acc is not read);
//   last:  the step writes acc + part to out in out_dtype (bf16 or f32) and
//          leaves acc alone.
// The plan (bn, splits, kps, grid) is ring_kernel.ring_wg_plan's
// (spmm24_kernel.wg_plan with the accumulator's bytes in its floor). With
// one split each unit loads its fragment of acc into registers before its
// k-steps (so the read's latency hides behind the loads and products),
// adds it to the product and writes the sum from its registers; with more,
// each split writes f32 partials to ws and ring24_wg_reduce sums them in
// split order, adds acc and writes out.
//
// What bounds it on the H100: the step's 2:4 operations at 1979 TFLOP/s
// against its bytes (A's window at 1.125 B a logical element as packed,
// the slot, and the accumulator: 8 B a C element on a middle step). At the
// ResNet-scale shard (6272 x 256 per rank, K = 256) a step is four k-steps
// of 98 units of 128 x 128 (tiled: 14 a window), one unit a block, so a
// unit's latency (its loads, four k-steps, the accumulator's read and
// write) sets a step's time; bench/ring_probe.py times a step alone and
// the rings. Unlike kFull, kRing retires each stage's products before the
// next stage's wait (sp24_wg_tile.cuh says why). Keeping acc on chip
// across a tile's P steps needs a persistent launch per (rank, m-tile)
// that waits in the kernel for each slot's arrival: later work (ROADMAP).
#include "sp24_wg_tile.cuh"

namespace {

using smt::bf16;

constexpr int kStages = 4;

template <int BN>
__global__ void __launch_bounds__(sp24w::kThreads, 1)
    ring24_wg_kernel(__grid_constant__ const sp24w::Params p) {
  sp24w::wgsp_tile<sp24w::kRing, kStages, BN>(p);
}

__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store4(bf16* out, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

// The second pass of split-k: out = the sum of the f32 partials [splits,
// mn] in split order + c (nullptr: nothing), 4 elements a thread. c and out
// carry no __restrict__: on a middle step both are the accumulator.
template <typename O>
__global__ void __launch_bounds__(256)
    ring24_wg_reduce(const float* __restrict__ ws, int splits, long long mn,
                     const float* c, O* out) {
  const long long step = 4ll * gridDim.x * blockDim.x;
  for (long long i = 4ll * (blockIdx.x * blockDim.x + threadIdx.x); i < mn;
       i += step) {
    float4 v = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < splits; ++s) {
      const float4 w = *reinterpret_cast<const float4*>(ws + s * mn + i);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    if (c != nullptr) {
      const float4 w = *reinterpret_cast<const float4*>(c + i);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    store4(out + i, v);
  }
}

// static, as sp24w::launch_kernel: the opt-in flags stay this library's own
template <int BN>
static cudaError_t launch_step(const sp24w::Params& p, int grid,
                               cudaStream_t stream) {
  using L = sp24w::Layout<BN, kStages>;
  auto kern = ring24_wg_kernel<BN>;
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  const cudaError_t e = smt::allow_smem(kern, L::BYTES, ready);
  if (e != cudaSuccess) return e;
  kern<<<grid, sp24w::kThreads, L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename O>
cudaError_t reduce(const void* ws, int splits, long long mn, const float* c,
                   void* out, cudaStream_t stream) {
  const long long blocks = (mn / 4 + 255) / 256;
  ring24_wg_reduce<O><<<(int)(blocks < 1024 ? blocks : 1024), 256, 0,
                        stream>>>(static_cast<const float*>(ws), splits, mn,
                                  c, static_cast<O*>(out));
  return cudaGetLastError();
}

}  // namespace

// One step on the window (k-steps kt0 .., m-tiles mt0 ..) of the operand a
// [a_ktp, a_tiles, 2304]: M rows (a multiple of 128), N columns (of bn), K
// logical k (a multiple of 64); acc and out point at the window's first
// row; ws f32 [splits, M, N] where splits > 1. out_dtype is that of out
// (used on the last step). Returns a cudaError_t; refuses (invalid value)
// anything the tile does not take.
extern "C" int ring24_wg_launch(const void* a, const void* slot, void* acc,
                                void* out, void* ws, int a_ktp, int a_tiles,
                                int kt0, int mt0, int M, int N, int K,
                                int first, int last, int out_dtype, int bn,
                                int splits, int kps, int grid, int device,
                                void* stream) {
  const int KT = K / sp24w::kKS;
  const bool f32 = !last || out_dtype == smt::kF32;
  const bool ok =
      M > 0 && M % sp24w::kBM == 0 && (bn == 64 || bn == 128) && N > 0 &&
      N % bn == 0 && K > 0 && K % sp24w::kKS == 0 && kt0 >= 0 &&
      kt0 + KT <= a_ktp && mt0 >= 0 && mt0 + M / sp24w::kBM <= a_tiles &&
      splits >= 1 && kps >= 1 && (splits - 1) * kps < KT &&
      splits * kps >= KT && grid >= 1 &&
      (out_dtype == smt::kF32 || out_dtype == smt::kBF16) &&
      ((first && last) || acc != nullptr) && smt::aligned16(a) &&
      smt::aligned16(slot) && smt::aligned16(last ? out : acc) &&
      (first || smt::aligned16(acc)) &&
      (splits == 1 || smt::aligned16(ws));
  if (!ok) return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  auto s = static_cast<cudaStream_t>(stream);
  const float* c = first ? nullptr : static_cast<const float*>(acc);
  void* dst = last ? out : acc;
  sp24w::Params p;
  cudaError_t e = ellt::make_map(&p.tb, slot, N, K, 64, sp24w::kKS,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  p.a = static_cast<const uint32_t*>(a);
  p.out = splits == 1 ? dst : ws;
  p.side = nullptr;
  p.M = M;
  p.N = N;
  p.KT = KT;
  p.KTP = a_ktp;
  p.n_tiles = N / bn;
  p.m_tiles = M / sp24w::kBM;
  p.splits = splits;
  p.kps = kps;
  p.units = p.m_tiles * p.n_tiles * splits;
  p.c = c;
  p.a_tiles = a_tiles;
  p.mt0 = mt0;
  p.kt0 = kt0;
  p.out_f32 = f32;
  e = bn == 128 ? launch_step<128>(p, grid, s) : launch_step<64>(p, grid, s);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)M * N;
  return (int)(f32 ? reduce<float>(ws, splits, mn, c, dst, s)
                   : reduce<bf16>(ws, splits, mn, c, dst, s));
}
