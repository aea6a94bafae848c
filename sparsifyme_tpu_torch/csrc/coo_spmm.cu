// K6: segmented block-row COO SpMM over a batch that shares one sparse A,
//   out[t, i*bm + roff2[i,s], j] += vals2[i,s] * B[t, cols2[i,s], j]
// summed in f32 over every slot s of block-row i, for every batch t.
//
// Replaces sparsifyme_tpu/ops/kernels/coo_kernel.py: spmm_coo_pallas (the
// matmul-gather body _coo_kernel_mm and the slices-gather body _coo_kernel,
// two TPU formulations of this one function).
//
// Operands: vals2 [mb, E] (f32 or bf16), cols2 and roff2 [mb, E] int32, the
// planes of pack_coo_blockrows (block-row i's entries in slot order, padding
// entries value 0 at col 0, roff 0, multiplied like any other); B
// [batch, k, n] row-major (f32 or bf16). Output [batch, m, n] f32; rows at
// or past m are not written. The batch is folded into the column axis
// through strides: column j of the N = batch * n columns is (j / n, j % n),
// so neither B nor C is copied into a [k, N] layout (the TPU wrapper
// copies B). An entry whose column lies outside [0, k) or whose row offset
// lies outside [0, bm) contributes nothing: it adds into a scratch row of
// the accumulator that is never written out.
//
// What bounds it on the H100: 2 * nnz * N f32 operations on the CUDA cores
// (67 TFLOP/s) against B read once, C written once in f32 and 12 bytes per
// packed slot (3.35 TB/s); at the ResNet-101 shapes of BASELINE config 2
// the operations set the bound. Each multiply-add here also needs a
// gathered load of one B element, so in practice the loads bind it (see
// the end of the design note), not the FMA rate.
//
// Design: the TPU kernel scatters through a one-hot matrix because its
// matrix unit cannot address scattered rows; Hopper's threads can, so there
// is no one-hot product here. One thread block per (n-tile, block-row).
// Each of its kTile threads owns one column of the n-tile and that column
// of the f32 accumulator tile acc[bm + 1][kTile] in dynamic shared memory.
// The block stages its block-row's entries, kChunk at a time, in shared
// memory with coalesced loads; every thread then walks them in slot order,
// issuing kGroup B loads before it sums val * B. Entries of one row come
// one after another (the packer keeps the row-major order of a block-row),
// so a thread sums a run of equal row offsets in a register and adds the
// run into acc[roff][tid] only when the row offset changes: the shared-
// memory read-modify-write leaves the inner loop. The row offset is the
// same for every thread of the block, so the branch does not diverge.
// Neighbouring threads read neighbouring B addresses and distinct banks,
// and no two threads write the same word: no atomics, duplicates sum, and
// every run sums in the same order. The tile is then written to C, masked
// at m and at N. All offsets into B and C are 64-bit.
// The gathered B loads are L2 hits at these shapes (B is at most a few
// tens of MB); their latency and the L2 bandwidth (nnz * N * sizeof(B)
// bytes in all) bound this design. Keeping a B tile in shared memory would
// cut them, but needs entries grouped by column blocks: later work.
// Known limit: a block walks its whole block-row, so shapes with few
// block-rows and long segments (196 x 4608 at 50%: two block-rows of about
// 226k entries) run on few blocks. Splitting a segment across blocks needs
// a reduction across blocks: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 128;      // threads per block = columns of an n-tile
constexpr int kChunk = 512;     // entries staged in shared memory at a time
constexpr int kGroup = 16;      // B loads in flight per thread
constexpr int kQuantum = 8;     // E % kQuantum == 0 (the packer's GROUP)
constexpr int kMaxRows = 256;   // largest block-row edge (shared memory)
constexpr int kF32 = 0, kBF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct __align__(16) Entry {
  float v;
  int col;
  int roff;
  int pad;
};

// G entries of the staged chunk: G gathered B loads first, then the sums.
template <int G, typename TB>
__device__ __forceinline__ void walk(const Entry* ent, const TB* Bj, int n,
                                     float* acc, int tid, int& cur,
                                     float& run) {
  float bv[G];
#pragma unroll
  for (int u = 0; u < G; ++u) bv[u] = to_f(Bj[(long long)ent[u].col * n]);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const Entry e = ent[u];
    if (e.roff != cur) {
      acc[cur * kTile + tid] += run;
      run = 0.f;
      cur = e.roff;
    }
    run = fmaf(e.v, bv[u], run);
  }
}

template <typename TV, typename TB>
__global__ void __launch_bounds__(kTile)
coo_spmm_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ roff, const TB* __restrict__ B,
                float* __restrict__ out, int E, int bm, int m, int k, int n,
                long long N) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* ent = reinterpret_cast<Entry*>(smem);
  float* acc = reinterpret_cast<float*>(smem + kChunk * sizeof(Entry));

  const int tid = threadIdx.x;
  const int i = blockIdx.y;
  const long long j = (long long)blockIdx.x * kTile + tid;
  const bool live = j < N;
  const long long t = live ? j / n : 0;
  const int jn = live ? (int)(j % n) : 0;
  const TB* Bj = B + t * (long long)k * n + jn;
  for (int r = 0; r <= bm; ++r) acc[r * kTile + tid] = 0.f;
  int cur = bm;     // row offset of the running sum (bm: the scratch row)
  float run = 0.f;  // sum of the current run of one row offset

  const size_t row0 = (size_t)i * E;
  for (int base = 0; base < E; base += kChunk) {
    const int cnt = min(kChunk, E - base);
    __syncthreads();  // the previous chunk has been consumed
    for (int s = tid; s < cnt; s += kTile) {
      Entry e;
      e.v = to_f(vals[row0 + base + s]);
      e.col = cols[row0 + base + s];
      e.roff = roff[row0 + base + s];
      e.pad = 0;
      if ((unsigned)e.col >= (unsigned)k || (unsigned)e.roff >= (unsigned)bm) {
        e.col = 0;     // a safe address
        e.roff = bm;   // the scratch row
      }
      ent[s] = e;
    }
    __syncthreads();
    if (!live) continue;
    int s = 0;  // cnt is a multiple of kQuantum
    for (; s + kGroup <= cnt; s += kGroup)
      walk<kGroup>(ent + s, Bj, n, acc, tid, cur, run);
    for (; s < cnt; s += kQuantum)
      walk<kQuantum>(ent + s, Bj, n, acc, tid, cur, run);
  }
  if (!live) return;
  acc[cur * kTile + tid] += run;
  // Each thread reads back only its own column: no barrier needed.
  const int rows = min(bm, m - i * bm);
  float* o = out + t * (long long)m * n + (long long)i * bm * n + jn;
  for (int r = 0; r < rows; ++r) o[(long long)r * n] = acc[r * kTile + tid];
}

template <typename TV, typename TB>
cudaError_t launch(const void* vals, const void* cols, const void* roff,
                   const void* b, void* out, int mb, int E, int bm, int m,
                   int k, int n, long long N, cudaStream_t stream) {
  auto kern = coo_spmm_kernel<TV, TB>;
  const int smem =
      kChunk * (int)sizeof(Entry) + (bm + 1) * kTile * (int)sizeof(float);
  static int allowed = 48 * 1024;  // per instantiation
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  dim3 grid((unsigned)((N + kTile - 1) / kTile), (unsigned)mb);
  kern<<<grid, kTile, smem, stream>>>(
      static_cast<const TV*>(vals), static_cast<const int*>(cols),
      static_cast<const int*>(roff), static_cast<const TB*>(b),
      static_cast<float*>(out), E, bm, m, k, n, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int coo_spmm_launch(const void* vals, const void* cols,
                               const void* roff, const void* b, void* out,
                               int mb, int E, int bm, int m, int k, int n,
                               int batch, int vdtype, int bdtype,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (mb <= 0 || mb > 65535 || E < 0 || E % kQuantum != 0 || bm <= 0 ||
      bm > kMaxRows || m <= 0 || m > mb * bm || k < 0 || n <= 0 ||
      batch <= 0)
    return (int)cudaErrorInvalidValue;
  const long long N = (long long)batch * n;
  if ((N + kTile - 1) / kTile > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vdtype == kF32 && bdtype == kF32)
    return launch<float, float>(vals, cols, roff, b, out, mb, E, bm, m, k, n,
                                N, s);
  if (vdtype == kF32 && bdtype == kBF16)
    return launch<float, bf16>(vals, cols, roff, b, out, mb, E, bm, m, k, n,
                               N, s);
  if (vdtype == kBF16 && bdtype == kF32)
    return launch<bf16, float>(vals, cols, roff, b, out, mb, E, bm, m, k, n,
                               N, s);
  if (vdtype == kBF16 && bdtype == kBF16)
    return launch<bf16, bf16>(vals, cols, roff, b, out, mb, E, bm, m, k, n,
                              N, s);
  return (int)cudaErrorInvalidValue;
}
