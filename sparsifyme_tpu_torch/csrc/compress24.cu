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
// written per bf16 element). Design: a block stages a 64-row x 64-column
// tile of w in shared memory with reads coalesced along k (whole groups of
// 4 as one 8- or 16-byte load where k % 4 == 0), then each thread
// ranks one (row, group) pair with consecutive threads on consecutive rows,
// so the plane writes coalesce along M. No transposed copy of w is made.
#include "tile_mma.cuh"

namespace {

using smt::bf16;
constexpr int TR = 64;  // rows per tile
constexpr int TK = 64;  // k per tile: 16 groups

template <typename T>
struct alignas(4 * sizeof(T)) Group4 {
  T v[4];
};

// VEC: k % 4 == 0 and w 4-element aligned, so the tile loads move whole
// groups (8 or 16 bytes).
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
compress_kernel(const T* __restrict__ w, T* __restrict__ v0,
                T* __restrict__ v1, uint8_t* __restrict__ codes, int M, int k,
                int K4) {
  constexpr int LD = TK + 4;  // rows stay 8/16-byte aligned
  __shared__ __align__(16) unsigned char raw[TR * LD * sizeof(T)];
  auto tile = reinterpret_cast<T(*)[LD]>(raw);
  const int r0 = blockIdx.x * TR;
  const int c0 = blockIdx.y * TK;
  const T zero = smt::from_f<T>(0.f);
  if constexpr (VEC) {
    for (int idx = threadIdx.x; idx < TR * (TK / 4); idx += blockDim.x) {
      const int r = idx / (TK / 4), gq = idx % (TK / 4);
      const int gr = r0 + r, gc = c0 + gq * 4;
      Group4<T> g;
      if (gr < M && gc < k)
        g = *reinterpret_cast<const Group4<T>*>(w + (size_t)gr * k + gc);
      else
        g.v[0] = g.v[1] = g.v[2] = g.v[3] = zero;
      *reinterpret_cast<Group4<T>*>(&tile[r][gq * 4]) = g;
    }
  } else {
    for (int idx = threadIdx.x; idx < TR * TK; idx += blockDim.x) {
      const int r = idx / TK, cc = idx % TK;
      const int gr = r0 + r, gc = c0 + cc;
      tile[r][cc] = (gr < M && gc < k) ? w[(size_t)gr * k + gc] : zero;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TR * (TK / 4); idx += blockDim.x) {
    const int r = idx % TR, gl = idx / TR;
    const int gr = r0 + r, g = c0 / 4 + gl;
    if (gr >= M || g >= K4) continue;
    const Group4<T> x = *reinterpret_cast<const Group4<T>*>(&tile[r][gl * 4]);
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = fabsf(smt::to_f(x.v[j]));
    // Top two under the total order (|x|, position), later winning ties.
    auto better = [&](int i, int j) {
      return a[i] > a[j] || (a[i] == a[j] && i > j);
    };
    int b1 = 0;
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (better(j, b1)) b1 = j;
    int b2 = b1 == 0 ? 1 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j != b1 && better(j, b2)) b2 = j;
    const int i0 = b1 < b2 ? b1 : b2, i1 = b1 < b2 ? b2 : b1;
    // Select by comparison, not by a dynamic index (which would put x in
    // local memory).
    auto at = [&](int i) {
      return i == 0 ? x.v[0] : i == 1 ? x.v[1] : i == 2 ? x.v[2] : x.v[3];
    };
    const size_t off = (size_t)g * M + gr;
    v0[off] = at(i0);
    v1[off] = at(i1);
    codes[off] = (uint8_t)(i0 * 4 + i1);
  }
}

template <typename T>
cudaError_t launch(const void* w, void* v0, void* v1, void* codes, int M,
                   int k, int K4, cudaStream_t stream) {
  dim3 grid((M + TR - 1) / TR, (K4 * 4 + TK - 1) / TK);
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0;
  auto kern = vec ? compress_kernel<T, true> : compress_kernel<T, false>;
  kern<<<grid, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(v0), static_cast<T*>(v1),
      static_cast<uint8_t*>(codes), M, k, K4);
  return cudaGetLastError();
}

}  // namespace

extern "C" int compress24_launch(const void* w, void* v0, void* v1,
                                 void* codes, int M, int k, int K4, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || 4 * K4 < k) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  if (dtype == smt::kBF16) return launch<bf16>(w, v0, v1, codes, M, k, K4, s);
  if (dtype == smt::kF32) return launch<float>(w, v0, v1, codes, M, k, K4, s);
  return (int)cudaErrorInvalidValue;
}
