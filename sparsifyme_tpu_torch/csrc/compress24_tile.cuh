// The body of K2 (compress24.cu, whose header says what K2 replaces and how
// it is designed), with a compile-time MODE for the probes of
// bench/fused_probe.py (compress_units.cu). kFull is K2. The others keep
// K2's tiles, ring, grid and barriers, and take its work apart as
// experiments/tpu_fused_probe.py's kernels do on the TPU, per tile of R rows
// by KT columns (a k-tile: k-major plane rows [c0/4, c0/4 + KT/4) of columns
// [r0, r0 + R); rows past M are neither summed nor stored):
//   * kIo (kernel_io): the copy floor. v0 = v1 = the tile's f32 sum of
//     x[r0 .. r0+8, c0 .. c0+min(128, KT)] in the output type, codes 1;
//   * kRank (kernel_rank): + the ranking. v0 / v1 = the tile's f32 sum of
//     the first / second kept value of every group, codes 1;
//   * kDot1 (kernel_dot1): + one compacted plane. v0 = v1 = the first kept
//     value of each group, codes = uint8(int32(v0)) (wrapping: -1 is 255;
//     padded groups 0);
//   * kRm (kernel_rm): K2's planes stored row-major, [M, K4] (plane row g
//     of column m at m * K4 + g), straight from the ranking: a thread ranks
//     8 groups of one row and stores them as one 16-byte (codes 8-byte)
//     piece, neighbouring threads on neighbouring pieces of the row; no
//     staging tile.
#pragma once

#include "tile_mma.cuh"

namespace {

constexpr int kFull = 0, kIo = 1, kRank = 2, kDot1 = 3, kRm = 4;

using smt::bf16;
constexpr int kThreads = 256;
constexpr int kKMax = 160;          // whole-row tiles up to this k
constexpr int kKTile = 64;          // columns of a tile above it: 16 groups
constexpr int kMaxRows = 128;       // rows of a tile, at most
constexpr int kSmemMax = 96 * 1024; // the opt-in ceiling of this kernel
constexpr int kStages = 2;          // input buffers of a block's ring

template <typename T>
struct alignas(4 * sizeof(T)) Group4 {
  T v[4];
};

// Tile geometry, the same on host and device.
struct Geo {
  int R;       // rows of a tile
  int KT;      // columns of a tile (kp for whole rows)
  int ld;      // shared-memory row stride of the input tile, elements
  int in_el;   // elements of one input buffer (16-byte multiple)
  int sr;      // staging row stride of v0 / v1, elements (R + 16 bytes)
  int sc;      // staging row stride of codes, bytes (R + 8)
  bool span;   // whole rows: one contiguous span per tile

  __host__ __device__ int groups() const { return KT / 4; }
  template <typename T>
  __host__ __device__ int bytes() const {
    return kStages * in_el * (int)sizeof(T) +
           2 * groups() * sr * (int)sizeof(T) + groups() * sc;
  }
};

// The geometry of the wrapper's plan (prune_kernel.compress_plan): R rows
// and KT columns a tile, KT = kp for whole rows, else kKTile.
template <typename T>
Geo make_geo(int k, int K4, int R, int KT) {
  Geo g;
  g.span = KT == K4 * 4;
  g.KT = KT;
  g.ld = g.span ? k : kKTile;
  g.R = R;
  const int unit = 16 / (int)sizeof(T);
  g.in_el = (g.R * g.ld + unit - 1) / unit * unit;
  g.sr = g.R + unit;
  g.sc = g.R + 8;
  return g;
}

// The kept pair of a group, as the plain version ranks it: a member is
// kept when fewer than two members beat it under (|x|, position), later
// positions winning ties; i0 and i1 are the first and second kept
// positions (0 where there is none). Static indices only: a dynamic index
// into a[] would put it in local memory.
__device__ __forceinline__ void rank4(const float* a, int& i0, int& i1) {
  int cnt[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i != j) cnt[j] += a[i] > a[j] || (a[i] == a[j] && i > j);
  i0 = i1 = 0;
  int kept = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool keep = cnt[j] < 2;
    if (keep && kept == 0) i0 = j;
    if (keep && kept == 1) i1 = j;
    kept += keep;
  }
}

// rank4 on a group. For bf16 the order (|x|, position) is the integer
// order of key = magnitude bits << 2 | position (as integers the 15-bit
// magnitudes order like |x| as floats, and the position breaks ties to the
// later), so the kept pair is the top two keys: 7 min/max, unless one
// member is NaN, which only the float compares rank as the plain version
// does (a NaN key is the largest).
__device__ __forceinline__ void rank_group(const float* x, int& i0, int& i1) {
  const float a[4] = {fabsf(x[0]), fabsf(x[1]), fabsf(x[2]), fabsf(x[3])};
  rank4(a, i0, i1);
}
__device__ __forceinline__ void rank_group(const bf16* x, int& i0, int& i1) {
  uint32_t key[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    key[j] = (__bfloat16_as_ushort(x[j]) & 0x7fffu) << 2 | j;
  const uint32_t hi01 = max(key[0], key[1]), lo01 = min(key[0], key[1]);
  const uint32_t hi23 = max(key[2], key[3]), lo23 = min(key[2], key[3]);
  const uint32_t top = max(hi01, hi23);
  const uint32_t second = max(min(hi01, hi23), max(lo01, lo23));
  if (top > (0x7f80u << 2 | 3)) {  // a NaN
    const float a[4] = {fabsf(__bfloat162float(x[0])),
                        fabsf(__bfloat162float(x[1])),
                        fabsf(__bfloat162float(x[2])),
                        fabsf(__bfloat162float(x[3]))};
    rank4(a, i0, i1);
    return;
  }
  i0 = (int)min(top & 3u, second & 3u);
  i1 = (int)max(top & 3u, second & 3u);
}

// 8 values to shared or global memory as 16-byte stores.
__device__ __forceinline__ void put8(bf16* dst, const bf16* v) {
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    w[p] = (uint32_t)__bfloat16_as_ushort(v[2 * p]) |
           ((uint32_t)__bfloat16_as_ushort(v[2 * p + 1]) << 16);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void put8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T>
__device__ __forceinline__ void get8(T* v, const T* src) {
  if constexpr (sizeof(T) == 2) {
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      v[2 * p] = __ushort_as_bfloat16((unsigned short)(ws[p] & 0xffff));
      v[2 * p + 1] = __ushort_as_bfloat16((unsigned short)(ws[p] >> 16));
    }
  } else {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// Start the copies of tile (r0, c0) into `in` (rows past M and columns
// past k are not loaded; the ranking never reads them). vec: w is 16-byte
// aligned and, for k-tiles, k * sizeof(T) % 16 == 0.
template <typename T>
__device__ void load_tile(const Geo g, const T* __restrict__ w, T* in,
                          int M, int k, int r0, int c0, bool vec) {
  constexpr int U = 16 / sizeof(T);  // elements per 16-byte chunk
  const int rows = min(g.R, M - r0);
  if (rows <= 0) return;
  if (g.span) {
    const T* src = w + (size_t)r0 * k;
    const int count = rows * k;
    const int full = vec ? count / U : 0;
    for (int q = threadIdx.x; q < full; q += kThreads)
      smt::cp16(in + q * U, src + (size_t)q * U);
    for (int e = full * U + threadIdx.x; e < count; e += kThreads)
      in[e] = src[e];
    return;
  }
  constexpr int QR = kKTile / U;  // chunks of a row piece
  for (int idx = threadIdx.x; idx < rows * QR; idx += kThreads) {
    const int r = idx / QR, q = idx % QR;
    const int col = c0 + q * U;
    const T* src = w + (size_t)(r0 + r) * k + col;
    T* dst = in + r * g.ld + q * U;
    if (vec && col + U <= k) {
      smt::cp16(dst, src);
    } else {
      for (int u = 0; u < U && col + u < k; ++u) dst[u] = src[u];
    }
  }
}

// Rank the staged tile into the staging planes (kDot1: the first kept value
// into both, and its integer part as the code). rank_tile, rank_part and
// rank_store_rm each pick the kept pair in their own loop on purpose: with
// one per-group helper (padded groups included) called per row, K2 (kFull)
// compiled to other SASS and its fused route ran up to 9% slower, and kRank
// ran slower than K2 itself, so it no longer measured a part of K2 (one
// H100, bench/check_parent.py and bench/fused_probe.py).
template <typename T, int MODE = kFull>
__device__ void rank_tile(const Geo g, const T* in, T* s0, T* s1,
                          uint8_t* sc, int M, int k, int r0, int c0) {
  const T zero = smt::from_f<T>(0.f);
  const int G = g.groups(), octs = g.R / 8;
  const bool vec_rd = g.ld % 4 == 0;  // a group is one aligned 4-vector
  for (int it = threadIdx.x; it < G * octs; it += kThreads) {
    const int gl = it % G, oct = it / G;
    const int col = c0 + gl * 4;  // first column of the group in w
    T o0[8], o1[8];
    uint8_t oc[8];
    if (col >= k) {  // a padded group: zeros, code 11, nothing loaded
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o0[i] = o1[i] = zero;
        oc[i] = MODE == kDot1 ? 0 : 11;
      }
    } else {
      // rows past M are ranked from whatever the buffer holds and never
      // stored
      const bool whole = vec_rd && col + 4 <= k;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T* p = in + (oct * 8 + i) * g.ld + gl * 4;
        Group4<T> x;
        if (whole) {
          x = *reinterpret_cast<const Group4<T>*>(p);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) x.v[j] = col + j < k ? p[j] : zero;
        }
        int i0, i1;
        rank_group(x.v, i0, i1);
        // Select by comparison, not by a dynamic index (which would put x
        // in local memory).
        auto at = [&](int q) {
          return q == 0 ? x.v[0] : q == 1 ? x.v[1] : q == 2 ? x.v[2] : x.v[3];
        };
        o0[i] = at(i0);
        if constexpr (MODE == kDot1) {
          o1[i] = o0[i];
          oc[i] = (uint8_t)(int)smt::to_f(o0[i]);
        } else {
          o1[i] = at(i1);
          oc[i] = (uint8_t)(i0 * 4 + i1);
        }
      }
    }
    put8(s0 + gl * g.sr + oct * 8, o0);
    put8(s1 + gl * g.sr + oct * 8, o1);
    uint32_t c_lo = 0, c_hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c_lo |= (uint32_t)oc[i] << (8 * i);
      c_hi |= (uint32_t)oc[i + 4] << (8 * i);
    }
    *reinterpret_cast<uint2*>(sc + gl * g.sc + oct * 8) = make_uint2(c_lo,
                                                                     c_hi);
  }
}

// Store the staging planes to v0, v1, codes [K4, M] at rows r0.., groups
// from c0 / 4. vec: M % 8 == 0 and the planes 16-byte aligned.
template <typename T>
__device__ void store_tile(const Geo g, const T* s0, const T* s1,
                           const uint8_t* sc, T* __restrict__ v0,
                           T* __restrict__ v1, uint8_t* __restrict__ codes,
                           int M, int r0, int c0, bool vec) {
  const int G = g.groups(), octs = g.R / 8;
  for (int it = threadIdx.x; it < G * octs; it += kThreads) {
    const int oct = it % octs, gl = it / octs;
    const int row = r0 + oct * 8;
    if (row >= M) continue;
    const size_t off = (size_t)(c0 / 4 + gl) * M + row;
    const T* a0 = s0 + gl * g.sr + oct * 8;
    const T* a1 = s1 + gl * g.sr + oct * 8;
    const uint8_t* ac = sc + gl * g.sc + oct * 8;
    if (vec) {
      T t[8];
      get8(t, a0);
      put8(v0 + off, t);
      get8(t, a1);
      put8(v1 + off, t);
      *reinterpret_cast<uint2*>(codes + off) =
          *reinterpret_cast<const uint2*>(ac);
    } else {
      for (int i = 0; i < 8 && row + i < M; ++i) {
        v0[off + i] = a0[i];
        v1[off + i] = a1[i];
        codes[off + i] = ac[i];
      }
    }
  }
}

// Group gl (columns c0 + 4 gl ..) of tile row r, zero past k.
template <typename T>
__device__ __forceinline__ Group4<T> group_at(const Geo g, const T* in, int r,
                                              int gl, int col, int k) {
  const T* p = in + r * g.ld + gl * 4;
  Group4<T> x;
  if (g.ld % 4 == 0 && col + 4 <= k) {
    x = *reinterpret_cast<const Group4<T>*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x.v[j] = col + j < k ? p[j] : smt::from_f<T>(0.f);
  }
  return x;
}

// kIo: this thread's part of the tile's sum of x[0:8, 0:min(128, KT)].
template <typename T>
__device__ float io_part(const Geo g, const T* in, int M, int k, int r0,
                         int c0) {
  const int w = min(128, g.KT);
  float s = 0.f;
  for (int e = threadIdx.x; e < 8 * w; e += kThreads) {
    const int r = e / w, c = e % w;
    if (r0 + r < M && c0 + c < k) s += smt::to_f(in[r * g.ld + c]);
  }
  return s;
}

// kRank: this thread's part of the tile's sums of the first and the second
// kept value of each group (its groups and rows as in rank_tile).
template <typename T>
__device__ void rank_part(const Geo g, const T* in, int M, int k, int r0,
                          int c0, float* s) {
  const int G = g.groups(), octs = g.R / 8;
  for (int it = threadIdx.x; it < G * octs; it += kThreads) {
    const int gl = it % G, oct = it / G;
    const int col = c0 + gl * 4;
    if (col >= k) continue;  // a padded group: zeros
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = oct * 8 + i;
      if (r0 + r >= M) break;
      const Group4<T> x = group_at(g, in, r, gl, col, k);
      int i0, i1;
      rank_group(x.v, i0, i1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j == i0) s[0] += smt::to_f(x.v[j]);
        if (j == i1) s[1] += smt::to_f(x.v[j]);
      }
    }
  }
}

// The block's sums of each thread's s[0..N), in one order: each warp's
// butterfly, then the warps in turn. scratch: N * kThreads / 32 floats of
// shared memory that no thread touches until the barrier after this one.
template <int N>
__device__ void block_sum(float* s, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int W = kThreads / 32;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[n] += __shfl_xor_sync(~0u, s[n], o);
    if (lane == 0) scratch[n * W + warp] = s[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    s[n] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s[n] += scratch[n * W + w];
  }
}

// kIo / kRank: the tile of v0, v1, codes [K4, M] filled with a0, a1 and
// code, in store_tile's order.
template <typename T>
__device__ void store_const(const Geo g, T a0, T a1, uint8_t code,
                            T* __restrict__ v0, T* __restrict__ v1,
                            uint8_t* __restrict__ codes, int M, int r0,
                            int c0, bool vec) {
  const int G = g.groups(), octs = g.R / 8;
  T t0[8], t1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t0[i] = a0;
    t1[i] = a1;
  }
  const uint32_t c4 = code * 0x01010101u;
  for (int it = threadIdx.x; it < G * octs; it += kThreads) {
    const int oct = it % octs, gl = it / octs;
    const int row = r0 + oct * 8;
    if (row >= M) continue;
    const size_t off = (size_t)(c0 / 4 + gl) * M + row;
    if (vec) {
      put8(v0 + off, t0);
      put8(v1 + off, t1);
      *reinterpret_cast<uint2*>(codes + off) = make_uint2(c4, c4);
    } else {
      for (int i = 0; i < 8 && row + i < M; ++i) {
        v0[off + i] = a0;
        v1[off + i] = a1;
        codes[off + i] = code;
      }
    }
  }
}

// kRm: rank the staged tile and store its planes row-major, [M, K4], a
// thread 8 groups of one row (K4 and a tile's groups are multiples of 16,
// so each piece is one aligned 16-byte store of v0 and of v1 and 8 bytes of
// codes; the planes 16-byte aligned).
template <typename T>
__device__ void rank_store_rm(const Geo g, const T* in, T* __restrict__ v0,
                              T* __restrict__ v1, uint8_t* __restrict__ codes,
                              int M, int k, int K4, int r0, int c0) {
  const int pieces = g.groups() / 8;
  for (int it = threadIdx.x; it < g.R * pieces; it += kThreads) {
    const int p = it % pieces, r = it / pieces;
    if (r0 + r >= M) continue;
    T o0[8], o1[8];
    uint8_t oc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gl = p * 8 + j, col = c0 + gl * 4;
      if (col >= k) {  // a padded group
        o0[j] = o1[j] = smt::from_f<T>(0.f);
        oc[j] = 11;
        continue;
      }
      const Group4<T> x = group_at(g, in, r, gl, col, k);
      int i0, i1;
      rank_group(x.v, i0, i1);
      auto at = [&](int q) {
        return q == 0 ? x.v[0] : q == 1 ? x.v[1] : q == 2 ? x.v[2] : x.v[3];
      };
      o0[j] = at(i0);
      o1[j] = at(i1);
      oc[j] = (uint8_t)(i0 * 4 + i1);
    }
    const size_t off = (size_t)(r0 + r) * K4 + c0 / 4 + p * 8;
    put8(v0 + off, o0);
    put8(v1 + off, o1);
    uint32_t c_lo = 0, c_hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c_lo |= (uint32_t)oc[i] << (8 * i);
      c_hi |= (uint32_t)oc[i + 4] << (8 * i);
    }
    *reinterpret_cast<uint2*>(codes + off) = make_uint2(c_lo, c_hi);
  }
}

// A persistent block walks the units u = blockIdx.x + i * gridDim.x (u =
// row tile * ktiles + k-tile: neighbouring blocks read neighbouring pieces
// of the same rows) through a ring of kStages input buffers: the copies of
// the next kStages - 1 units are in flight while one unit is ranked and
// stored. MODE: K2 (kFull) or one of its probes.
template <typename T, int MODE = kFull>
__global__ void __launch_bounds__(kThreads)
compress_kernel(const T* __restrict__ w, T* __restrict__ v0,
                T* __restrict__ v1, uint8_t* __restrict__ codes, int M, int k,
                Geo g, int ktiles, long long units, bool vec_in,
                bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  T* s0 = in + kStages * g.in_el;
  T* s1 = s0 + g.groups() * g.sr;
  uint8_t* sc = reinterpret_cast<uint8_t*>(s1 + g.groups() * g.sr);
  const long long step = gridDim.x;
  auto fetch = [&](long long u, int stage) {
    if (u < units)
      load_tile(g, w, in + stage * g.in_el, M, k, (int)(u / ktiles) * g.R,
                (int)(u % ktiles) * g.KT, vec_in);
    smt::cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(blockIdx.x + s * step, s);
  int stage = 0;
  for (long long u = blockIdx.x; u < units; u += step) {
    fetch(u + (kStages - 1) * step, (stage + kStages - 1) % kStages);
    smt::cp_wait<kStages - 1>();
    __syncthreads();  // unit u has landed
    const int r0 = (int)(u / ktiles) * g.R, c0 = (int)(u % ktiles) * g.KT;
    const T* tile = in + stage * g.in_el;
    if constexpr (MODE == kFull || MODE == kDot1) {
      rank_tile<T, MODE>(g, tile, s0, s1, sc, M, k, r0, c0);
      __syncthreads();
      store_tile(g, s0, s1, sc, v0, v1, codes, M, r0, c0, vec_out);
    } else if constexpr (MODE == kRm) {
      rank_store_rm(g, tile, v0, v1, codes, M, k, ktiles * g.KT / 4, r0, c0);
      __syncthreads();
    } else {
      float s[2] = {0.f, 0.f};
      if constexpr (MODE == kIo)
        s[0] = s[1] = io_part(g, tile, M, k, r0, c0);
      else
        rank_part(g, tile, M, k, r0, c0, s);
      block_sum<2>(s, reinterpret_cast<float*>(sc));  // the second barrier
      store_const(g, smt::from_f<T>(s[0]), smt::from_f<T>(s[1]),
                  (uint8_t)1, v0, v1, codes, M, r0, c0, vec_out);
    }
    __syncthreads();  // the buffer and the staging tile are free again
    stage = (stage + 1) % kStages;
  }
}

template <typename T, int MODE = kFull>
cudaError_t launch(const void* w, void* v0, void* v1, void* codes, int M,
                   int k, int K4, int R, int KT, cudaStream_t stream) {
  const Geo g = make_geo<T>(k, K4, R, KT);
  const int smem = g.bytes<T>();
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = compress_kernel<T, MODE>;
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  const cudaError_t e = smt::allow_smem(kern, kSmemMax, ready);
  if (e != cudaSuccess) return e;
  // persistent: as many blocks as the card holds at once, at most one a
  // unit
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t q = cudaGetDevice(&dev);
  if (q == cudaSuccess)
    q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (q == cudaSuccess)
    q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (q != cudaSuccess) return q;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ktiles = K4 * 4 / g.KT;
  const long long units = ((long long)M + g.R - 1) / g.R * ktiles;
  const long long fit = (long long)sms * per_sm;
  const int grid = (int)(units < fit ? units : fit);
  const bool vec_in = smt::aligned16(w) &&
                      (g.span || (k * (int)sizeof(T)) % 16 == 0);
  const bool vec_out = M % 8 == 0 && smt::aligned16(v0) &&
                       smt::aligned16(v1) && smt::aligned16(codes);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(v0), static_cast<T*>(v1),
      static_cast<uint8_t*>(codes), M, k, g, ktiles, units, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

