// The MoE layer's combine: each token's held expert rows, weighted, summed
// and added to its column of the residual stream, in one pass.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
// It is the last step of models/moe_transformer.py's MoE layer
// (moe_combine), whose plain version (ops/kernels/moe_kernel.py:
// moe_combine_plain) zeroes an f32 [T, H] accumulator, writes an f32 copy
// of y * w, scatters it with index_add_ and adds its transpose to h.
//
// Inputs: h [H, T] f32, feature-major; y [rows, H] bf16, token-major, one
// row a (token, held expert) pair in the dispatch's order; slot [T, top]
// int32, each (token, choice)'s row of y, or -1 where another card holds
// the expert; weight [rows] f32, each row's routing weight. Output out
// [H, T] f32, a new tensor (h is left as it was):
//   out[f, t] = h[f, t] + sum_j weight[slot[t, j]] * y[slot[t, j], f]
// over j < top with slot[t, j] >= 0, summed in f32 in choice order j from
// zero, each product rounded before it is added (as the plain version's
// y * w and index_add_), so a token with at most one held choice reads the
// plain version bit for bit and the result is the same on every run.
//
// What bounds it on the H100: device-memory bytes. h read once and out
// written once in f32 (8 B a feature of a token), each held row of y read
// once in bf16, the slot map and the weights. At MiMo-V2-Flash's prefill
// on one card (T 32768, H 4096, top 8, 32 of 256 experts held: about one
// held choice a token) that is 1.34 GB, 0.40 ms at 3.35 TB/s; the
// arithmetic is two operations a byte of y.
//
// Design: one block a tile of kTT tokens x kFT features, 256 threads, the
// tiles of one token tile launched together (they share its slot map).
//   1. Each thread loads its share of h's tile into registers first (32
//      values; a warp reads 32 consecutive tokens of one feature row, 128
//      bytes), so those loads are in flight through steps 2 and 3.
//   2. The first kTT threads each compact their token's held choices (row
//      of y, weight) into shared memory.
//   3. Each thread gathers 16-byte chunks (8 features) of held rows of y
//      for 4 tokens (16 threads cover a token's 128 features, 256 bytes of
//      one row), weights and sums them in registers, then stores the sums
//      into a shared-memory tile of kTT rows of kFT + 4 floats (the padding
//      keeps step 4's reads of 16 bytes free of bank conflicts).
//   4. Each thread reads 4-feature chunks of the tile for one token, adds
//      them to its h values and writes out, a warp on 32 consecutive tokens
//      of one feature row again.
// No accumulator in device memory, no f32 copy of y, no strided access and
// no atomics. Requires H % 8 == 0 (a chunk of y is whole) and y 16-byte
// aligned; T and H need not fill the tile (the edges are masked).
#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTT = 64;                         // tokens of a tile
constexpr int kFT = 128;                        // features of a tile
constexpr int kPad = kFT + 4;                   // floats a token's sum row
constexpr int kMaxTop = 16;                     // choices a token, at most
constexpr int kChunks = kFT / 8;                // 16-byte chunks of y a row
constexpr int kGather = kTT * kChunks / kThreads;  // (token, chunk) a thread
constexpr int kOut = kTT * (kFT / 4) / kThreads;   // (token, quad) a thread
static_assert(kGather == 4 && kOut == 8, "the tile's thread maps");

// acc[0..7] += w * the 8 bf16 values of v, each product rounded to f32 and
// then added (no fused multiply-add), as the plain version computes them.
__device__ __forceinline__ void add_row(float* acc, const uint4& v,
                                        float w) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(u[i] << 16);
    const float hi = __uint_as_float(u[i] & 0xffff0000u);
    acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(w, lo));
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(w, hi));
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    combine_kernel(const float* __restrict__ h, const uint4* __restrict__ y,
                   const int* __restrict__ slot,
                   const float* __restrict__ weight, float* __restrict__ out,
                   int T, int H, int top, int f_tiles) {
  __shared__ __align__(16) float sum[kTT * kPad];
  __shared__ int rows[kTT * kMaxTop];
  __shared__ float wts[kTT * kMaxTop];
  __shared__ int held[kTT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = (blockIdx.x % f_tiles) * kFT;
  const int t0 = (blockIdx.x / f_tiles) * kTT;

  // 1. h's tile: item r is token `tok`, features 4 * quad(r) .. + 3
  const int tok = (warp & 1) * 32 + lane;
  const bool t_ok = t0 + tok < T;
  float hv[kOut][4];
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int q = (warp >> 1) + 4 * r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 4 * q + i;
      hv[r][i] = t_ok && f < H ? __ldcs(h + (size_t)f * T + t0 + tok) : 0.f;
    }
  }

  // 2. each token's held choices, in choice order
  if (tid < kTT) {
    int n = 0;
    if (t0 + tid < T) {
      const int* s = slot + (size_t)(t0 + tid) * top;
      for (int j = 0; j < top; ++j) {
        const int row = __ldg(s + j);
        if (row >= 0) {
          rows[tid * kMaxTop + n] = row;
          wts[tid * kMaxTop + n] = __ldg(weight + row);
          ++n;
        }
      }
    }
    held[tid] = n;
  }
  __syncthreads();

  // 3. tokens g + 16 r, features f0 + 8 c .. + 7: their weighted sums
  const int c = tid % kChunks, g = tid / kChunks;
  const bool f_ok = f0 + 8 * c < H;
  const size_t row_chunks = H / 8;
  const uint4* yc = y + f0 / 8 + c;
  float acc[kGather][8];
  int n[kGather], most = 0;
#pragma unroll
  for (int r = 0; r < kGather; ++r) {
    n[r] = f_ok ? held[g + 16 * r] : 0;
    most = max(most, n[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }
  for (int q = 0; q < most; ++q) {
    uint4 v[kGather];
#pragma unroll
    for (int r = 0; r < kGather; ++r)
      if (q < n[r])
        v[r] = __ldg(yc + (size_t)rows[(g + 16 * r) * kMaxTop + q] *
                              row_chunks);
#pragma unroll
    for (int r = 0; r < kGather; ++r)
      if (q < n[r]) add_row(acc[r], v[r], wts[(g + 16 * r) * kMaxTop + q]);
  }
#pragma unroll
  for (int r = 0; r < kGather; ++r) {
    float4* dst =
        reinterpret_cast<float4*>(sum + (g + 16 * r) * kPad + 8 * c);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();

  // 4. out = h + the sums, the tile read across its rows
  if (!t_ok) return;
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int q = (warp >> 1) + 4 * r;
    const float4 s =
        *reinterpret_cast<const float4*>(sum + tok * kPad + 4 * q);
    const float a[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 4 * q + i;
      if (f < H)
        __stcs(out + (size_t)f * T + t0 + tok, __fadd_rn(hv[r][i], a[i]));
    }
  }
}

}  // namespace

extern "C" int moe_combine_launch(const void* h, const void* y,
                                  const void* slot, const void* weight,
                                  void* out, int T, int H, int top,
                                  int device, void* stream) {
  if (T < 0 || H <= 0 || H % 8 != 0 || top < 1 || top > kMaxTop ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long f_tiles = (H + kFT - 1) / kFT;
  const long long tiles = f_tiles * ((T + kTT - 1) / kTT);
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  combine_kernel<<<(unsigned)tiles, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const uint4*>(y),
      static_cast<const int*>(slot), static_cast<const float*>(weight),
      static_cast<float*>(out), T, H, top, (int)f_tiles);
  return (int)cudaGetLastError();
}
