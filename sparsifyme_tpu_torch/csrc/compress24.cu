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
#include "tile_mma.cuh"

namespace {

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

// Rank the staged tile into the staging planes.
template <typename T>
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
        oc[i] = 11;
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
        o1[i] = at(i1);
        oc[i] = (uint8_t)(i0 * 4 + i1);
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

// A persistent block walks the units u = blockIdx.x + i * gridDim.x (u =
// row tile * ktiles + k-tile: neighbouring blocks read neighbouring pieces
// of the same rows) through a ring of kStages input buffers: the copies of
// the next kStages - 1 units are in flight while one unit is ranked and
// stored.
template <typename T>
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
    rank_tile(g, in + stage * g.in_el, s0, s1, sc, M, k, r0, c0);
    __syncthreads();
    store_tile(g, s0, s1, sc, v0, v1, codes, M, r0, c0, vec_out);
    __syncthreads();  // the buffer and the staging tile are free again
    stage = (stage + 1) % kStages;
  }
}

template <typename T>
cudaError_t launch(const void* w, void* v0, void* v1, void* codes, int M,
                   int k, int K4, int R, int KT, cudaStream_t stream) {
  const Geo g = make_geo<T>(k, K4, R, KT);
  const int smem = g.bytes<T>();
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = compress_kernel<T>;
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
