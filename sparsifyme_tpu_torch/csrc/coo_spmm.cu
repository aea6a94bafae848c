// K6: segmented block-row COO SpMM over a batch that shares one sparse A,
//   out[t, i*bm + roff2[i,s], j] += vals2[i,s] * B[t, cols2[i,s], j]
// summed in f32 over every slot s of block-row i, for every batch t.
//
// Replaces sparsifyme_tpu/ops/kernels/coo_kernel.py: spmm_coo_pallas (the
// matmul-gather body _coo_kernel_mm and the slices-gather body _coo_kernel,
// two TPU formulations of this one function).
//
// Operands: the layout of coo_kernel.coo_layout, derived once from the
// planes of pack_coo_blockrows: per block-row i, vals (f32) and cols
// (int32) [mb, E] sorted stably by (k-chunk col / kc, row offset), and
// starts [mb, n_chunks * bm + 1] (int32), where the segment of (chunk c,
// row r) starts at starts[i, c * bm + r]; entries whose column lies
// outside [0, k) or whose row offset lies outside [0, bm), and zero-valued
// entries at the (row, column) of an earlier zero-valued one (the packer's
// padding repeats (row 0, column 0)), sit past starts[i, n_chunks * bm]:
// they add nothing. One padding entry is multiplied like any other. B [batch, k, n]
// row-major (f32 or bf16). Output [batch, m, n] f32; rows at or past m are
// not written. The batch is folded into the column axis through strides:
// column j of the N = batch * n columns is (j / n, j % n), so neither B nor
// C is copied into a [k, N] layout (the TPU wrapper copies B).
//
// What bounds it on the H100: 2 * nnz * N f32 operations on the CUDA cores
// (67 TFLOP/s) against B read once, C written once in f32 and 12 bytes per
// packed slot (3.35 TB/s); at the ResNet-101 shapes of BASELINE config 2
// the operations set the bound. Every multiply-add needs its B element
// from somewhere: one 2-byte L2 load per multiply-add binds a kernel at
// tens of times the bound (57x at 3136x128x1152, 90% sparse), so this one
// reads B from shared memory, each read feeding 8 multiply-adds.
//
// Design: a block owns (n-tile of 128 folded columns, row group of 128 rows
// of block-row i, range of k-chunks). Its 256 threads form 16 streams of 16
// threads; a stream owns 8 rows of the row group, a thread 8 adjacent
// columns, and the 8 x 8 f32 sums live in registers: no accumulator in
// shared memory, no atomics, every sum in slot order, so K6 is bitwise
// repeatable. For each k-chunk of kc rows of B (up to 128) the block
// stages, in a two-stage cp.async ring (the next chunk's copies in flight
// while this one is summed): the B tile [kc][128] (route "staged"), the
// chunk's entries of the row group (at most kWindow at a time; a longer
// chunk is walked in further windows) and the row starts of the group's
// rows. A stream then walks each of its rows' segments: one broadcast read
// of an entry and one 16-byte read of its B row piece (8 bf16, unpacked in
// registers) feed 8 FMAs. Route "gather" (very sparse A at depths over 512,
// where a staged B row would feed fewer than about three entries of the
// group; coo_kernel.STAGE_MIN_REUSE) stages no B tile and
// reads each entry's 8 columns from device memory / L2 with one 16-byte
// load. Where the units (row group x n-tile) are too few or too unequal
// for the card, the plan (coo_kernel.coo_plan) splits the k-chunks over
// `splits` blocks: each writes f32 partials to a workspace [splits, batch,
// m, n] and coo_reduce sums them in split order (deterministic). All
// offsets into B and C are 64-bit.
// What bounds this design: each entry is a chain of shared-memory reads
// (its row start, the entry, then its B piece) with a few entries per row
// and chunk, on 16 warps an SM; the SM runs well under its instruction
// rate. PERF.md gives the times against the bound and what taking the
// entry loop or the B reads out leaves (bench/coo_probe.py --ablate). One
// warp a stream (512 threads, 4 columns a thread) and one loop over a
// stream's rows with a running row sum were both slower.
#include "tile_mma.cuh"

namespace {

using smt::bf16;

constexpr int kThreads = 256;
constexpr int kLanes = 16;     // threads of a stream: 8 columns each
constexpr int kRows = 8;       // rows of a stream
constexpr int kRowGroup = 128; // rows of a block: 16 streams x 8
constexpr int kTileN = 128;    // folded columns of a block
constexpr int kWindow = 2816;  // entries staged at a time
constexpr int kMaxKc = 128;    // rows of B a staged k-chunk, at most
constexpr int kMaxRowsPerBm = 256;
constexpr int kMaxSplits = 8;

struct Params {
  const float* vals;
  const int* cols;
  const int* starts;
  const void* b;
  float* out;  // C, or the workspace of a split plan
  int E, bm, m, k, n, batch, kc, n_chunks, chunks_per_split, row_groups;
  long long N;  // batch * n
  bool vec;     // n % 8 == 0, B and C 16-byte aligned
};

// Shared memory of one stage: the B tile (route staged), the entries'
// values and columns, the row starts of the group's rows (+1). Two stages
// of a bf16 tile of 128 rows fit two blocks on an SM. A bf16 tile keeps
// its columns in order (an entry's 8 columns are one 16-byte read); an f32
// tile keeps column lane * 8 + h * 4 + e of a row at h * 64 + lane * 4 + e,
// so the 16 threads of a stream read 256 contiguous bytes per float4 (no
// bank conflict).
template <typename TB, bool STAGED>
__host__ __device__ constexpr int tile_bytes(int kc) {
  return STAGED ? kc * kTileN * (int)sizeof(TB) : 0;
}
template <typename TB, bool STAGED>
__host__ __device__ constexpr int stage_bytes(int kc) {
  return tile_bytes<TB, STAGED>(kc) + kWindow * 8 + (kRowGroup + 4) * 4;
}
constexpr int kSmemMax = 2 * stage_bytes<float, true>(kMaxKc);
static_assert(kSmemMax <= 232448, "one block's shared memory");

// Index of column cc of row r in an f32 tile.
__device__ __forceinline__ int f32_at(int r, int cc) {
  return r * kTileN + ((cc >> 2) & 1) * 64 + (cc >> 3) * 4 + (cc & 3);
}

// 8 consecutive bf16 B values as f32, from shared or global memory
// (16-byte aligned).
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(ws[q] << 16);
    v[2 * q + 1] = __uint_as_float(ws[q] & 0xffff0000u);
  }
}
// 4 + 4 f32 B values at p[0..3] and p[h..h+3].
__device__ __forceinline__ void load8(const float* p, float* v, int h) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + h);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// VEC: n % 8 == 0 and B, C 16-byte aligned (16-byte B pieces, float4
// stores); else every column is addressed on its own (odd n).
template <typename TB, bool STAGED, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) coo_kernel(Params p) {
  // entries whose B reads go out together (fewer for f32: registers)
  constexpr int kUnroll = sizeof(TB) == 2 ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int stream = tid / kLanes, lane = tid % kLanes;
  const int i = blockIdx.y / p.row_groups;
  const int rg0 = (blockIdx.y % p.row_groups) * kRowGroup;
  const int rg1 = min(p.bm, rg0 + kRowGroup);
  const int c0 = blockIdx.z * p.chunks_per_split;
  const int c1 = min(p.n_chunks, c0 + p.chunks_per_split);
  const long long j0 = (long long)blockIdx.x * kTileN;
  const long long jt = j0 + lane * 8;  // this thread's first column
  const bool live = jt < p.N;
  const int* st = p.starts + (size_t)i * ((size_t)p.n_chunks * p.bm + 1);
  const float* vals = p.vals + (size_t)i * p.E;
  const int* cols = p.cols + (size_t)i * p.E;
  const TB* B = static_cast<const TB*>(p.b);
  const size_t kn = (size_t)p.k * p.n;
  // B offset of this thread's columns (route gather, vec)
  const size_t bbase = live && VEC ? (size_t)(jt / p.n) * kn + jt % p.n
                                   : 0;
  // The 16-byte piece of every B tile row this thread copies (route
  // staged, vec): the same columns in every row, so their offset in B is
  // worked out once.
  constexpr int U = 16 / sizeof(TB);  // elements of a piece
  constexpr int QR = kTileN / U;      // pieces of a tile row
  const int piece = tid % QR;
  const long long jp = j0 + piece * U;
  const bool piece_ok = jp < p.N;
  const size_t poff = piece_ok ? (size_t)(jp / p.n) * kn + jp % p.n : 0;

  const int sbytes = stage_bytes<TB, STAGED>(p.kc);
  auto tile = [&](int s) {
    return reinterpret_cast<TB*>(smem + s * sbytes);
  };
  auto svals = [&](int s) {
    return reinterpret_cast<float*>(smem + s * sbytes +
                                    tile_bytes<TB, STAGED>(p.kc));
  };
  auto scols = [&](int s) {
    return reinterpret_cast<int*>(svals(s) + kWindow);
  };
  auto srows = [&](int s) { return scols(s) + kWindow; };

  // Stage chunk c into buffer s: its B tile, the entries [lo, lo +
  // kWindow) of [lo, hi), the row starts of the group.
  auto stage_chunk = [&](int s, int c, int lo, int hi) {
    if constexpr (STAGED) {
      TB* bs = tile(s);
      const int rows = min(p.kc, p.k - c * p.kc);
      const size_t k0 = (size_t)c * p.kc;
      // bf16 lands in column order; f32 in the f32 tile's order
      if constexpr (VEC) {
        const int at = sizeof(TB) == 2 ? piece * U : f32_at(0, piece * U);
        if (piece_ok)
          for (int r = tid / QR; r < rows; r += kThreads / QR)
            smt::cp16(bs + r * kTileN + at, B + poff + (k0 + r) * p.n);
      } else {
        for (int q = tid; q < rows * kTileN; q += kThreads) {
          const int r = q / kTileN, cc = q % kTileN;
          const long long j = j0 + cc;
          if (j < p.N)
            bs[sizeof(TB) == 2 ? q : f32_at(r, cc)] =
                B[(size_t)(j / p.n) * kn + (k0 + r) * p.n + j % p.n];
        }
      }
    }
    const int cnt = min(hi - lo, kWindow);
    for (int e = tid; e < cnt; e += kThreads) {
      smt::cp4(svals(s) + e, vals + lo + e);
      smt::cp4(scols(s) + e, cols + lo + e);
    }
    for (int r = tid; r <= kRowGroup; r += kThreads)
      smt::cp4(srows(s) + r, st + (size_t)c * p.bm + min(rg0 + r, p.bm));
  };

  // The stream's rows' sums, this thread's 8 columns.
  float acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  auto fetch = [&](const TB* bs, int c, int col, float* v) {
    if constexpr (STAGED && sizeof(TB) == 2) {
      load8(bs + (col - c * p.kc) * kTileN + lane * 8, v);
    } else if constexpr (STAGED) {
      load8(bs + (col - c * p.kc) * kTileN + lane * 4, v, 64);
    } else if constexpr (VEC && sizeof(TB) == 2) {
      load8(B + bbase + (size_t)col * p.n, v);
    } else if constexpr (VEC) {
      load8(B + bbase + (size_t)col * p.n, v, 4);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long j = jt + q;
        v[q] = j < p.N ? smt::to_f(B[(size_t)(j / p.n) * kn +
                                     (size_t)col * p.n + j % p.n])
                       : 0.f;
      }
    }
  };

  int lo = 0, hi = 0, lo_n = 0, hi_n = 0;
  if (c0 < c1) {
    lo = st[(size_t)c0 * p.bm + rg0];
    hi = st[(size_t)c0 * p.bm + rg1];
    stage_chunk(0, c0, lo, hi);
  }
  smt::cp_commit();
  if (c0 + 1 < c1) {
    lo_n = st[(size_t)(c0 + 1) * p.bm + rg0];
    hi_n = st[(size_t)(c0 + 1) * p.bm + rg1];
  }
  for (int c = c0; c < c1; ++c) {
    const int s = (c - c0) & 1;
    const int nlo = lo_n, nhi = hi_n;
    if (c + 1 < c1) stage_chunk(s ^ 1, c + 1, nlo, nhi);
    smt::cp_commit();
    if (c + 2 < c1) {  // read now, used when chunk c + 1 is staged
      lo_n = st[(size_t)(c + 2) * p.bm + rg0];
      hi_n = st[(size_t)(c + 2) * p.bm + rg1];
    }
    smt::cp_wait<1>();
    __syncthreads();  // chunk c has landed
    for (int w0 = lo;;) {
      const int w1 = min(hi, w0 + kWindow);
      if (live) {  // the stream's rows' segments within [w0, w1)
        const float* sv = svals(s);
        const int* sc = scols(s);
        const int* sr = srows(s);
        const TB* bs = tile(s);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          int a = max(sr[stream * kRows + r], w0);
          const int e = min(sr[stream * kRows + r + 1], w1);
          for (; a + kUnroll <= e; a += kUnroll) {
            float v[kUnroll], bv[kUnroll][8];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              v[u] = sv[a + u - w0];
              fetch(bs, c, sc[a + u - w0], bv[u]);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
#pragma unroll
              for (int q = 0; q < 8; ++q)
                acc[r][q] = fmaf(v[u], bv[u][q], acc[r][q]);
          }
          for (; a < e; ++a) {
            float bv[8];
            const float v = sv[a - w0];
            fetch(bs, c, sc[a - w0], bv);
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(v, bv[q], acc[r][q]);
          }
        }
      }
      if (w1 >= hi) break;
      // a chunk longer than a window: stage its next window in place
      __syncthreads();
      w0 = w1;
      const int cnt = min(hi - w0, kWindow);
      for (int e = tid; e < cnt; e += kThreads) {
        svals(s)[e] = vals[w0 + e];
        scols(s)[e] = cols[w0 + e];
      }
      __syncthreads();
    }
    __syncthreads();  // buffer s is free for chunk c + 2
    lo = nlo;
    hi = nhi;
  }

  if (!live) return;
  float* o = p.out + (size_t)blockIdx.z * p.batch * p.m * p.n;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lr = rg0 + stream * kRows + r;
    const long long row = (long long)i * p.bm + lr;
    if (lr >= rg1 || row >= p.m) continue;
    if constexpr (VEC) {
      float* d = o + ((size_t)(jt / p.n) * p.m + row) * p.n + jt % p.n;
      reinterpret_cast<float4*>(d)[0] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      reinterpret_cast<float4*>(d)[1] =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long j = jt + q;
        if (j < p.N)
          o[((size_t)(j / p.n) * p.m + row) * p.n + j % p.n] = acc[r][q];
      }
    }
  }
}

// out = the sum of the `splits` partial planes, in split order. vec: total
// % 4 == 0 and ws, out 16-byte aligned, so every plane starts aligned and
// is read as float4 (else plane s > 0 starts off a 16-byte boundary and
// every element is read on its own).
__global__ void coo_reduce(const float* __restrict__ ws,
                           float* __restrict__ out, long long total,
                           int splits, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long vecs = vec ? total / 4 : 0;
  for (long long v = t0; v < vecs; v += stride) {
    float4 a = reinterpret_cast<const float4*>(ws)[v];
    for (int s = 1; s < splits; ++s) {
      const float4 b = reinterpret_cast<const float4*>(ws + s * total)[v];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    reinterpret_cast<float4*>(out)[v] = a;
  }
  for (long long e = vecs * 4 + t0; e < total; e += stride) {
    float a = ws[e];
    for (int s = 1; s < splits; ++s) a += ws[s * total + e];
    out[e] = a;
  }
}

template <typename TB, bool STAGED, bool VEC>
cudaError_t launch3(const Params& p, dim3 grid, cudaStream_t stream) {
  auto kern = coo_kernel<TB, STAGED, VEC>;
  static bool ready[smt::kMaxDevices] = {};  // the opt-in is per card
  const cudaError_t e = smt::allow_smem(kern, kSmemMax, ready);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, 2 * stage_bytes<TB, STAGED>(p.kc), stream>>>(p);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch(const Params& p, bool staged, dim3 grid,
                   cudaStream_t stream) {
  if (staged)
    return p.vec ? launch3<TB, true, true>(p, grid, stream)
                 : launch3<TB, true, false>(p, grid, stream);
  return p.vec ? launch3<TB, false, true>(p, grid, stream)
               : launch3<TB, false, false>(p, grid, stream);
}

}  // namespace

// route: 0 staged, 1 gather. ws: f32 [splits, batch, m, n] when splits > 1.
// Launches on card `device`.
extern "C" int coo_spmm_launch(const void* vals, const void* cols,
                               const void* starts, const void* b, void* out,
                               void* ws, int mb, int E, int bm, int m, int k,
                               int n, int batch, int kc, int n_chunks,
                               int route, int splits, int chunks_per_split,
                               int bdtype, int device, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int row_groups = (bm + kRowGroup - 1) / kRowGroup;
  if (mb <= 0 || (long long)mb * row_groups > 65535 || E < 0 || bm <= 0 ||
      bm > kMaxRowsPerBm || m <= 0 || m > (long long)mb * bm || k < 0 ||
      n <= 0 || batch <= 0 || kc <= 0 || (route == 0 && kc > kMaxKc) ||
      n_chunks != (k + kc - 1) / kc + (k == 0) || splits < 1 ||
      splits > kMaxSplits || chunks_per_split < 1 ||
      (splits - 1) * chunks_per_split >= n_chunks ||
      (splits > 1 && ws == nullptr) || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.vals = static_cast<const float*>(vals);
  p.cols = static_cast<const int*>(cols);
  p.starts = static_cast<const int*>(starts);
  p.b = b;
  p.out = static_cast<float*>(splits > 1 ? ws : out);
  p.E = E; p.bm = bm; p.m = m; p.k = k; p.n = n; p.batch = batch;
  p.kc = kc; p.n_chunks = n_chunks; p.chunks_per_split = chunks_per_split;
  p.row_groups = row_groups;
  p.N = (long long)batch * n;
  p.vec = n % 8 == 0 && smt::aligned16(b) && smt::aligned16(p.out);
  const long long tiles = (p.N + kTileN - 1) / kTileN;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)(mb * row_groups),
                  (unsigned)splits);
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  cudaError_t e;
  if (bdtype == smt::kBF16)
    e = launch<bf16>(p, route == 0, grid, s);
  else if (bdtype == smt::kF32)
    e = launch<float>(p, route == 0, grid, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long total = (long long)batch * m * n;
  const bool vec = total % 4 == 0 && smt::aligned16(ws) &&
                   smt::aligned16(out);
  const long long blocks = ((vec ? total / 4 : total) + 255) / 256;
  coo_reduce<<<(unsigned)(blocks < 1056 ? (blocks > 0 ? blocks : 1) : 1056),
               256, 0, s>>>(static_cast<const float*>(ws),
                            static_cast<float*>(out), total, splits, vec);
  return (int)cudaGetLastError();
}
