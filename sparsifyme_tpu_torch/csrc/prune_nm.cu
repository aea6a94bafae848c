// K1: N:M magnitude prune along the last axis -> (pruned, mask).
//
// Replaces sparsifyme_tpu/ops/kernels/prune_kernel.py: prune_nm_pallas
// (body _prune_kernel).
//
// Input w [rows, k] row-major, bf16 or f32, 1 <= m <= 32, any n. Every
// contiguous group of m along k keeps its n largest members by (|x|,
// position), later positions winning ties; positions past k rank as
// magnitude 0, as the zero padding of the JAX op does, but nothing is
// padded in memory. Outputs pruned and mask [rows, k] in the input type:
// pruned is w * mask as the plain version computes it (a dropped member is
// x * 0: a zero of x's sign, NaN for an infinite or NaN x), mask is 0/1.
//
// What bounds it on the H100: device-memory bytes (one read, two writes:
// 6 B per bf16 element); the ranking is one compare per pair of members,
// m - 1 per element. The design keeps every global access 16 bytes wide
// whatever k % m or k % 8 is. The wrapper's plan (prune_kernel.prune_plan)
// picks one of two kernels:
//   * stream_kernel, where k % m == 0 and a 16-byte chunk holds whole
//     groups (the 2:4 pattern at every k % 4 == 0): no group crosses a row,
//     so w is a flat stream of 16-byte chunks, one a thread, ranked in
//     registers; neighbouring threads on neighbouring chunks.
//   * tile_kernel, everywhere else (conv1's k = 147, other m): a block
//     takes one tile of about 16 KB of w and copies it into shared memory
//     with 16-byte cp.async chunks and a scalar tail:
//       rows: R whole rows, R * k * sizeof(T) a multiple of 16 (R a
//             multiple of 8 for bf16 at odd k): one span that starts
//             16-byte aligned whatever k is; a row's short last group is
//             ranked with zeros past k;
//       cols: where such R rows do not fit, R row pieces of KT columns, KT
//             a multiple of lcm(m, 16 / sizeof(T)) (16-byte copies where
//             k * sizeof(T) % 16 == 0, else scalar).
//     A thread ranks one group at a time from shared memory (neighbouring
//     threads on neighbouring groups), writes the dropped members in place
//     and the mask into a staging buffer of the same layout, and the tile
//     goes out as the same span with 16-byte stores. A thread steps through
//     (row, group) by additions: no division per element, and no 64-bit
//     index arithmetic but a tile's origin.
// Both launch one block a unit of work (256 chunks; a tile) and loop over
// units with the grid's stride. On the H100 many small blocks kept the
// memory busier than persistent blocks (K2's design), whether these held
// several chunks in flight a thread or a ring of two to four tile buffers
// (PERF.md, K1's findings).
// w, out or mask not 16-byte aligned (a view at an odd storage offset):
// the same kernels with element-wide copies.
#include "tile_mma.cuh"

namespace {

using smt::bf16;
constexpr int kThreads = 256;
constexpr int kTileMax = 32 * 1024;  // input bytes of a tile, at most
constexpr int kSmemMax = 2 * kTileMax;  // the tile and its mask
// modes of the plan: tiles of whole rows or of row pieces (tile_kernel),
// or the stream route (stream_kernel)
constexpr int kRows = 0, kCols = 1, kStream = 2;

// Tile geometry, the same for every tile of a launch.
struct Geo {
  int mode;
  int R;         // rows of a tile
  int KT;        // columns of a tile: k (rows mode) or fewer (cols)
  int tile_el;   // elements of one buffer (a multiple of 16 bytes)
  int ktiles;    // column tiles of a row (cols), else 1
  long long units;

  template <typename T>
  int bytes() const {
    return 2 * tile_el * (int)sizeof(T);
  }
};

// One tile: nrows pieces of len elements, at base in w (row stride gld)
// and at the start of a buffer (row stride sld). A rows tile is one
// contiguous span (nrows * len elements).
struct Tile {
  long long base;
  int nrows, len, gld, sld;
};

__device__ __forceinline__ Tile tile_of(const Geo& g, long long u,
                                        long long rows, int k) {
  Tile t;
  const long long r0 = u / g.ktiles * g.R;
  const int c0 = (int)(u % g.ktiles) * g.KT;
  t.base = r0 * k + c0;
  t.nrows = (int)min((long long)g.R, rows - r0);
  t.len = min(g.KT, k - c0);
  t.gld = k;
  t.sld = g.KT;
  return t;
}

// Start the copies of tile t into `in`. vec: every piece starts 16-byte
// aligned in w.
template <typename T>
__device__ void load_tile(const Tile& t, const T* __restrict__ w, T* in,
                          bool span, bool vec) {
  constexpr int U = 16 / sizeof(T);  // elements per 16-byte chunk
  const T* src = w + t.base;
  if (span) {
    const int count = t.nrows * t.len;
    const int full = vec ? count / U : 0;
    for (int q = threadIdx.x; q < full; q += kThreads)
      smt::cp16(in + q * U, src + q * U);
    for (int e = full * U + threadIdx.x; e < count; e += kThreads)
      in[e] = src[e];
    return;
  }
  const int qr = (t.len + U - 1) / U;  // chunks of a row piece
  for (int idx = threadIdx.x; idx < t.nrows * qr; idx += kThreads) {
    const int r = idx / qr, c = (idx - r * qr) * U;
    const T* s = src + (size_t)r * t.gld + c;
    T* d = in + r * t.sld + c;
    if (vec && c + U <= t.len) {
      smt::cp16(d, s);
    } else {
      for (int e = 0; e < U && c + e < t.len; ++e) d[e] = s[e];
    }
  }
}

// A dropped member as the plain version's w * mask gives it: x * 0, a zero
// of x's sign (NaN where x is infinite or NaN).
template <typename T>
__device__ __forceinline__ T dropped(T x) {
  return smt::from_f<T>(smt::to_f(x) * 0.f);
}

// keep[j] for the mm members x[0..mm) of a group (mm <= CAP; registers,
// static indices only): fewer than n members outrank it, a member
// outranking j when its |x| is larger, or equal at a later position. A
// NaN neither outranks nor is outranked, as in the plain version's
// compares.
template <typename T, int CAP>
__device__ __forceinline__ void rank_members(const T* x, bool* keep, int mm,
                                             int n) {
  float a[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    if (j >= mm) break;
    a[j] = fabsf(smt::to_f(x[j]));
  }
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    if (j >= mm) break;
    int beaten = 0;
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i >= mm) break;
      if (i < j) beaten += a[i] > a[j];
      if (i > j) beaten += a[i] >= a[j];
    }
    keep[j] = beaten < n;
  }
}

// Rank every group of the staged tile: the pruned group in place in `buf`,
// the mask into `mk` (same layout).
template <typename T, int MM>
__device__ void rank_tile(const Tile& t, T* buf, T* mk, int n, int m) {
  constexpr int CAP = MM > 0 ? MM : 32;
  const int mm = MM > 0 ? MM : m;
  const T one = smt::from_f<T>(1.f), zero = smt::from_f<T>(0.f);
  const int gpr = (t.len + mm - 1) / mm;  // groups of a row piece
  const int ng = t.nrows * gpr;
  // (row, group) of item it = threadIdx.x + i * kThreads, by additions
  const int step_r = kThreads / gpr, step_g = kThreads - step_r * gpr;
  int r = threadIdx.x / gpr, g = threadIdx.x - r * gpr;
  for (int it = threadIdx.x; it < ng; it += kThreads) {
    const int col = g * mm;
    const int wd = min(mm, t.len - col);  // short only at a row's end
    T* p = buf + r * t.sld + col;
    T* q = mk + r * t.sld + col;
    T x[CAP];
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j >= mm) break;
      x[j] = j < wd ? p[j] : zero;
    }
    bool keep[CAP];
    rank_members<T, CAP>(x, keep, mm, n);
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j >= wd) break;
      if (!keep[j]) p[j] = dropped(x[j]);
      q[j] = keep[j] ? one : zero;
    }
    g += step_g;
    r += step_r;
    if (g >= gpr) {
      g -= gpr;
      ++r;
    }
  }
}

// Store the ranked tile: the pruned values from `buf`, the mask from `mk`.
// vec: every piece starts 16-byte aligned in out and mask.
template <typename T>
__device__ void store_tile(const Tile& t, const T* buf, const T* mk,
                           T* __restrict__ out, T* __restrict__ mask,
                           bool span, bool vec) {
  constexpr int U = 16 / sizeof(T);
  T* dst = out + t.base;
  T* dmk = mask + t.base;
  if (span) {
    const int count = t.nrows * t.len;
    const int full = vec ? count / U : 0;
    for (int q = threadIdx.x; q < full; q += kThreads) {
      reinterpret_cast<uint4*>(dst)[q] =
          reinterpret_cast<const uint4*>(buf)[q];
      reinterpret_cast<uint4*>(dmk)[q] =
          reinterpret_cast<const uint4*>(mk)[q];
    }
    for (int e = full * U + threadIdx.x; e < count; e += kThreads) {
      dst[e] = buf[e];
      dmk[e] = mk[e];
    }
    return;
  }
  const int qr = (t.len + U - 1) / U;
  for (int idx = threadIdx.x; idx < t.nrows * qr; idx += kThreads) {
    const int r = idx / qr, c = (idx - r * qr) * U;
    const size_t go = (size_t)r * t.gld + c;
    const int so = r * t.sld + c;
    if (vec && c + U <= t.len) {
      *reinterpret_cast<uint4*>(dst + go) =
          *reinterpret_cast<const uint4*>(buf + so);
      *reinterpret_cast<uint4*>(dmk + go) =
          *reinterpret_cast<const uint4*>(mk + so);
    } else {
      for (int e = 0; e < U && c + e < t.len; ++e) {
        dst[go + e] = buf[so + e];
        dmk[go + e] = mk[so + e];
      }
    }
  }
}

// Block b takes the tiles b, b + gridDim.x, ... (one each, as launched):
// load, rank, store.
template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ w, T* __restrict__ out,
            T* __restrict__ mask, long long rows, int k, int n, int m, Geo g,
            bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  T* mk = buf + g.tile_el;
  const bool span = g.mode != kCols;
  for (long long u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Tile t = tile_of(g, u, rows, k);
    load_tile(t, w, buf, span, vec_in);
    smt::cp_commit();
    smt::cp_wait<0>();
    __syncthreads();  // the tile has landed
    rank_tile<T, MM>(t, buf, mk, n, m);
    __syncthreads();
    store_tile(t, buf, mk, out, mask, span, vec_out);
    __syncthreads();  // the buffers are free again
  }
}

// 16 bytes as 16 / sizeof(T) values in registers, and back.
__device__ __forceinline__ void unpack(uint4 v, bf16* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    x[2 * p] = __ushort_as_bfloat16((unsigned short)(w[p] & 0xffff));
    x[2 * p + 1] = __ushort_as_bfloat16((unsigned short)(w[p] >> 16));
  }
}
__device__ __forceinline__ void unpack(uint4 v, float* x) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ uint4 pack(const bf16* x) {
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    w[p] = (uint32_t)__bfloat16_as_ushort(x[2 * p]) |
           ((uint32_t)__bfloat16_as_ushort(x[2 * p + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack(const float* x) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}

// The stream route: thread t of block b takes chunks c = b * kThreads + t,
// c + gridDim.x * kThreads, ... (one, as launched): one 16-byte load, the
// groups ranked in registers, one 16-byte store each of pruned and mask.
// The last chunk (total % (16 / sizeof(T)) elements), and every chunk
// where a pointer is not 16-byte aligned (vec false), is read and written
// element by element; members past total are ranked as zeros and never
// stored.
template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* __restrict__ w, T* __restrict__ out,
              T* __restrict__ mask, long long total, int n, bool vec) {
  constexpr int U = 16 / sizeof(T);
  static_assert(U % MM == 0, "a chunk holds whole groups");
  const T one = smt::from_f<T>(1.f), zero = smt::from_f<T>(0.f);
  const long long chunks = (total + U - 1) / U;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * kThreads) {
    const long long e0 = c * U;
    const bool whole = vec && e0 + U <= total;
    T x[U], o[U], mk[U];
    if (whole) {
      unpack(reinterpret_cast<const uint4*>(w)[c], x);
    } else {
#pragma unroll
      for (int e = 0; e < U; ++e) x[e] = e0 + e < total ? w[e0 + e] : zero;
    }
#pragma unroll
    for (int g = 0; g < U / MM; ++g) {
      bool keep[MM];
      rank_members<T, MM>(x + g * MM, keep, MM, n);
#pragma unroll
      for (int j = 0; j < MM; ++j) {
        o[g * MM + j] = keep[j] ? x[g * MM + j] : dropped(x[g * MM + j]);
        mk[g * MM + j] = keep[j] ? one : zero;
      }
    }
    if (whole) {
      reinterpret_cast<uint4*>(out)[c] = pack(o);
      reinterpret_cast<uint4*>(mask)[c] = pack(mk);
      continue;
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (e0 + e < total) {
        out[e0 + e] = o[e];
        mask[e0 + e] = mk[e];
      }
    }
  }
}

template <typename T, int MM>
cudaError_t run_stream(const T* w, T* out, T* mask, long long total, int n,
                       cudaStream_t stream) {
  constexpr int U = 16 / sizeof(T);
  const long long blocks = ((total + U - 1) / U + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = smt::aligned16(w) && smt::aligned16(out) &&
                   smt::aligned16(mask);
  stream_kernel<T, MM><<<(unsigned)blocks, kThreads, 0, stream>>>(
      w, out, mask, total, n, vec);
  return cudaGetLastError();
}

template <typename T, int MM>
cudaError_t run_tiles(const Geo& g, const T* w, T* out, T* mask,
                      long long rows, int k, int n, int m, bool vec_in,
                      bool vec_out, cudaStream_t stream) {
  const int smem = g.bytes<T>();
  auto kern = tile_kernel<T, MM>;
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  const cudaError_t e = smt::allow_smem(kern, kSmemMax, ready);
  if (e != cudaSuccess) return e;
  if (g.units > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)g.units, kThreads, smem, stream>>>(
      w, out, mask, rows, k, n, m, g, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w, void* out, void* mask, long long rows,
                   int k, int n, int m, int mode, int R, int KT,
                   cudaStream_t stream) {
  constexpr int U = 16 / sizeof(T);
  auto wp = static_cast<const T*>(w);
  auto op = static_cast<T*>(out);
  auto mp = static_cast<T*>(mask);
  if (mode == kStream) {
    if (m == 4) return run_stream<T, 4>(wp, op, mp, rows * k, n, stream);
    if constexpr (sizeof(T) == 2)
      return run_stream<T, 8>(wp, op, mp, rows * k, n, stream);
    return cudaErrorInvalidValue;
  }
  Geo g;
  g.mode = mode;
  g.R = R;
  g.KT = KT;
  g.tile_el = (R * KT + U - 1) / U * U;
  g.ktiles = mode == kCols ? (k + KT - 1) / KT : 1;
  g.units = (rows + R - 1) / R * g.ktiles;
  // 16-byte copies where every piece of a tile starts aligned: the plan
  // aligns rows tiles; a cols piece starts at r * k + c0
  const bool rows16 = mode != kCols || (k * (int)sizeof(T)) % 16 == 0;
  const bool vec_in = rows16 && smt::aligned16(w);
  const bool vec_out = rows16 && smt::aligned16(out) && smt::aligned16(mask);
  if (m == 4)
    return run_tiles<T, 4>(g, wp, op, mp, rows, k, n, m, vec_in,
                           vec_out, stream);
  if (m == 8)
    return run_tiles<T, 8>(g, wp, op, mp, rows, k, n, m, vec_in,
                           vec_out, stream);
  return run_tiles<T, 0>(g, wp, op, mp, rows, k, n, m, vec_in,
                           vec_out, stream);
}

// The plan's tiles, as prune_kernel.prune_plan makes them.
bool valid_plan(int k, int m, int mode, int R, int KT, int size) {
  const int U = 16 / size;
  if (mode == kStream)  // a chunk of 16 bytes holds whole groups
    return R == 1 && KT == U && k % m == 0 && (m == 4 || m == 8) &&
           U % m == 0;
  if (R < 1 || KT < 1 || (long long)R * KT * size > kTileMax) return false;
  if (mode == kRows) return KT == k && (R * k) % U == 0;
  if (mode == kCols) return KT % m == 0 && KT % U == 0;
  return false;
}

}  // namespace

extern "C" int prune_nm_launch(const void* w, void* out, void* mask,
                               long long rows, int k, int n, int m, int mode,
                               int R, int KT, int dtype, int device,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int size = dtype == smt::kBF16 ? 2 : dtype == smt::kF32 ? 4 : 0;
  if (m < 1 || m > 32 || k <= 0 || rows < 0 || size == 0 ||
      !valid_plan(k, m, mode, R, KT, size))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  if (dtype == smt::kBF16)
    return launch<bf16>(w, out, mask, rows, k, n, m, mode, R, KT, s);
  return launch<float>(w, out, mask, rows, k, n, m, mode, R, KT, s);
}
