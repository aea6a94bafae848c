// K1: N:M magnitude prune along the last axis -> (pruned, mask).
//
// Replaces sparsifyme_tpu/ops/kernels/prune_kernel.py: prune_nm_pallas
// (body _prune_kernel).
//
// Input w [rows, k] row-major. Every contiguous group of m along k keeps its
// n largest members by (|x|, position), later positions winning ties;
// positions past k rank as magnitude 0, as the zero padding of the JAX op
// does, but nothing is padded in memory. Outputs pruned and mask [rows, k]
// in the input type (mask is 0/1).
//
// What bounds it on the H100: device-memory bytes (one read, two writes:
// 6 B per bf16 element); the ranking is m*(m-1) compares per group. Design:
// one thread per m-group, so a warp reads and writes 32 consecutive groups
// (contiguous memory), and the group lives in registers for the ranking.
// m is a template constant for the 2:4 and 2:8 patterns, so the group array
// stays in registers, and where k % m == 0 a group moves as one 8- or
// 16-byte vector; other m <= 32 take a generic instantiation.
#include "tile_mma.cuh"

namespace {

using smt::bf16;

// A whole group as one vector (8 or 16 bytes for the 2:4 pattern).
template <typename T, int MM>
struct alignas(sizeof(T) * MM) Group {
  T v[MM];
};

// VEC: k % m == 0 and aligned rows, so each group is one vector load and
// its two outputs one vector store each.
template <typename T, int MM, bool VEC>
__global__ void prune_kernel(const T* __restrict__ w, T* __restrict__ out,
                             T* __restrict__ mask, long long rows, int k,
                             int n, int m) {
  constexpr int CAP = MM > 0 ? MM : 32;
  const int mm = MM > 0 ? MM : m;
  const int gpr = (k + mm - 1) / mm;  // groups per row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * gpr) return;
  const long long row = t / gpr;
  const int base = (int)(t % gpr) * mm;
  const size_t off = (size_t)row * k + base;
  const T one = smt::from_f<T>(1.f), zero = smt::from_f<T>(0.f);
  T x[CAP];
  float a[CAP];
  if constexpr (VEC) {
    const Group<T, CAP> g = *reinterpret_cast<const Group<T, CAP>*>(w + off);
#pragma unroll
    for (int j = 0; j < CAP; ++j) x[j] = g.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j >= mm) break;
      x[j] = base + j < k ? w[off + j] : zero;
    }
  }
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    if (j >= mm) break;
    a[j] = fabsf(smt::to_f(x[j]));
  }
  bool keep[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    if (j >= mm) break;
    int beaten = 0;  // members that outrank j
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i >= mm) break;
      beaten += (a[i] > a[j]) || (a[i] == a[j] && i > j);
    }
    keep[j] = beaten < n;
  }
  if constexpr (VEC) {
    Group<T, CAP> go, gk;
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      go.v[j] = keep[j] ? x[j] : zero;
      gk.v[j] = keep[j] ? one : zero;
    }
    *reinterpret_cast<Group<T, CAP>*>(out + off) = go;
    *reinterpret_cast<Group<T, CAP>*>(mask + off) = gk;
    return;
  }
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    if (j >= mm || base + j >= k) break;
    out[off + j] = keep[j] ? x[j] : zero;
    mask[off + j] = keep[j] ? one : zero;
  }
}

template <typename T>
cudaError_t launch(const void* w, void* out, void* mask, long long rows,
                   int k, int n, int m, cudaStream_t stream) {
  const long long groups = rows * ((k + m - 1) / m);
  const int threads = 256;
  const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
  auto wp = static_cast<const T*>(w);
  auto op = static_cast<T*>(out);
  auto mp = static_cast<T*>(mask);
  const size_t gbytes = sizeof(T) * m;
  const bool vec = (m == 4 || m == 8) && k % m == 0 &&
                   reinterpret_cast<uintptr_t>(w) % gbytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % gbytes == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % gbytes == 0;
#define SMT_PRUNE(MMv, VECv)                                              \
  prune_kernel<T, MMv, VECv><<<blocks, threads, 0, stream>>>(wp, op, mp,  \
                                                             rows, k, n, m)
  if (m == 4 && vec)
    SMT_PRUNE(4, true);
  else if (m == 4)
    SMT_PRUNE(4, false);
  else if (m == 8 && vec)
    SMT_PRUNE(8, true);
  else if (m == 8)
    SMT_PRUNE(8, false);
  else
    SMT_PRUNE(0, false);
#undef SMT_PRUNE
  return cudaGetLastError();
}

}  // namespace

extern "C" int prune_nm_launch(const void* w, void* out, void* mask,
                               long long rows, int k, int n, int m, int dtype,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m < 1 || m > 32 || k <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  if (dtype == smt::kBF16) return launch<bf16>(w, out, mask, rows, k, n, m, s);
  if (dtype == smt::kF32) return launch<float>(w, out, mask, rows, k, n, m, s);
  return (int)cudaErrorInvalidValue;
}
