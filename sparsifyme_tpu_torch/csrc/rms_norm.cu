// RMSNorm of a feature-major activation in one pass over it: the sum of
// squares of each token's column, then the column scaled by the token's
// rsqrt and the weight, rounded once to bf16, in the layouts its reader
// wants.
//
// Replaces no TPU kernel: the JAX package has no transformer. It is
// models/moe_transformer.py's rms_norm (and through it every RMSNorm of
// the MoE blocks and of models/mla.py), whose plain version
// (ops/kernels/norm_kernel.py: rms_norm_plain) makes four passes over an
// f32 [H, T]: vector_norm reads h, h * r writes an f32 temporary, mul_(w)
// reads and writes it, .to(bf16) reads it again.
//
// Inputs: h [H, T], feature-major and contiguous, f32 (the residual
// stream) or bf16 (a latent, read as it is); w [H] bf16. Outputs, either or
// both: out [H, T] bf16 feature-major, out_t [T, H] bf16 token-major.
//   r[t] = rsqrt(sum_f h[f, t]^2 / H + eps)
//   out[f, t] = out_t[t, f] = bf16((h[f, t] * r[t]) * w[f])
// with each product rounded to f32 (no fused multiply-add) and one
// round-to-nearest-even to bf16, as the plain version computes it; only
// the order of the f32 sum of squares differs. Every block of a cluster
// adds the cluster's partial sums in rank order, so a token's r is the
// same in every block and on every run.
//
// What bounds it on the H100: device-memory bytes. h read once, each
// output written once in bf16: at T 32768, 1.41 GB at H 7168 f32 (0.421
// ms at 3.35 TB/s), 0.81 GB at H 4096 f32 (0.240 ms), 0.20 GB at H 1536
// bf16, 0.07 GB at H 512 bf16. The arithmetic is a few operations a byte.
//
// Design: h leaves device memory once. A cluster of C blocks owns a strip
// of kW tokens (32 of f32, 64 of bf16: 8 threads of 16 bytes, so 128
// bytes of each feature row are read together; 64-byte rows read 20-30%
// slower on the H100) and all H features; block `rank` of it holds
// features rank * FB .. + FB - 1 of the strip in shared memory, FB / 32
// chunks of 16 bytes a thread (thread (tx, ty) holds rows ty + 32 r). The
// plan (norm_kernel.norm_plan) aims at 8 blocks a cluster of at least 256
// rows, and takes more blocks where a block's shared memory would not let
// three share an SM: f32 at 4096 -> 8 blocks of 512 rows, at 7168 -> 13
// of 576 (14 of 512 beside out_t's tiles); the bf16 latents at 1536 -> 6
// of 256, at 512 -> 2 of 256 (above 8 a cluster is of a non-portable
// size, which Hopper allows up to 16).
//   1. Each thread copies its chunks into shared memory with cp.async, all
//      in flight at once. Shared memory and not registers hold them, so
//      that 3-8 blocks share an SM and the blocks waiting at the cluster
//      barrier leave others loading and storing (with 2 register-bound
//      blocks an SM the barrier's wait cost a quarter of the time).
//   2. Sums of squares: a thread's rows, its warp's 4 rows of threads
//      (shuffles), the block's 8 warps in warp order, then, after a
//      cluster barrier, the cluster's blocks read over distributed shared
//      memory in rank order.
//   3. Each thread scales its chunks and writes out (8 or 16 bytes a row).
//      For out_t it stages them in a tile of 64 features x kW tokens, two
//      used in turn, which the block writes 128 contiguous bytes a token
//      row at a time (a thread a token row and 16 bytes each wrote 4x
//      slower: partial sectors in device memory).
// No temporary in device memory, no second read of h, no atomics. Requires
// H % 8 == 0 (a token-major chunk is whole) and H <= 16 * FB; T and the
// alignment of h are free (where h's chunks are not 16-byte aligned they
// are read element by element, synchronously).
#include <cooperative_groups.h>

#include "tile_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using smt::bf16;

constexpr int kThreads = 256;
constexpr int kTX = 8;                  // threads along the tokens
constexpr int kTY = kThreads / kTX;     // threads along the features
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;         // blocks of a cluster, at most
constexpr int kSmemMax = 227 * 1024 - 4096;  // dynamic, beside the static

__device__ __forceinline__ uint32_t word(const uint4& c, int k) {
  return k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
}

__device__ __forceinline__ void set_word(uint4& c, int k, uint32_t v) {
  if (k == 0) c.x = v;
  else if (k == 1) c.y = v;
  else if (k == 2) c.z = v;
  else c.w = v;
}

// Element i of a 16-byte chunk as f32 (exact for bf16).
template <bool BF16>
__device__ __forceinline__ float elem(const uint4& c, int i) {
  if constexpr (BF16) {
    const uint32_t u = word(c, i >> 1);
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  } else {
    return __uint_as_float(word(c, i));
  }
}

// The chunk of kVec tokens at element offset `off` of h, `left` of them
// inside the row (0 beyond it), element by element (h not aligned for
// cp.async).
template <bool BF16>
__device__ __forceinline__ uint4 load_chunk(const void* h, size_t off,
                                            int left) {
  constexpr int kVec = BF16 ? 8 : 4;
  uint4 c = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (i < left) {
      if constexpr (BF16) {
        const uint32_t b = static_cast<const uint16_t*>(h)[off + i];
        set_word(c, i >> 1, word(c, i >> 1) | ((i & 1) ? b << 16 : b));
      } else {
        set_word(c, i, static_cast<const uint32_t*>(h)[off + i]);
      }
    }
  return c;
}

// bf16 element i of packed pairs p (element 2k in the low half of p[k]).
__device__ __forceinline__ uint16_t half_of(const uint32_t* p, int i) {
  return (uint16_t)(p[i >> 1] >> (16 * (i & 1)));
}

template <int kVec>
__device__ __forceinline__ void store_chunk(bf16* dst, const uint32_t* p,
                                            int left, bool vec) {
  if (vec && left >= kVec) {
    if constexpr (kVec == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(p[0], p[1]);
    return;
  }
  uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (i < left) d[i] = half_of(p, i);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    norm_kernel(const void* __restrict__ h, const bf16* __restrict__ w,
                bf16* __restrict__ out, bf16* __restrict__ out_t, int H,
                int T, int FB, float eps, bool vec) {
  constexpr int kVec = BF16 ? 8 : 4;   // tokens of a thread's chunk
  constexpr int kW = kTX * kVec;       // tokens of the strip
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_ss[kWarps][kW];
  __shared__ float block_ss[kW];
  __shared__ float scale[kW];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int t0 = (int)(blockIdx.x / C) * kW;
  const int f0 = rank * FB;
  const int R = FB / kTY;  // chunks a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % kTX, ty = tid / kTX;
  const int tt = t0 + tx * kVec;
  const int left = T - tt;
  // the thread's chunk r is data[r * kThreads]
  uint4* data = reinterpret_cast<uint4*>(smem) + tid;
  // 1. the thread's R chunks of its kVec tokens into shared memory, every
  // copy in flight at once (zero past H and T)
  for (int r = 0; r < R; ++r) {
    const int f = f0 + ty + kTY * r;
    const size_t off = (size_t)f * T + tt;
    if (vec) {
      const bool ok = f < H && left > 0;
      smt::cp16(data + r * kThreads,
                ok ? static_cast<const char*>(h) + off * (BF16 ? 2 : 4) : h,
                ok);
    } else {
      data[r * kThreads] = f < H ? load_chunk<BF16>(h, off, left)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  smt::cp_commit();
  smt::cp_wait<0>();  // a thread reads back only the chunks it copied

  // 2. sums of squares: the thread's rows, the warp's 4 rows of threads
  // (lanes tx, tx + 8, ... hold the same tokens), the block's warps
  float ss[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) ss[i] = 0.f;
  for (int r = 0; r < R; ++r) {
    const uint4 v = data[r * kThreads];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float x = elem<BF16>(v, i);
      ss[i] = fmaf(x, x, ss[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i)
#pragma unroll
    for (int m = kTX; m < 32; m <<= 1)
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], m);
  if (lane < kTX)
#pragma unroll
    for (int i = 0; i < kVec; ++i) warp_ss[warp][lane * kVec + i] = ss[i];
  __syncthreads();
  if (tid < kW) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += warp_ss[k][tid];
    block_ss[tid] = s;
  }
  // the cluster's blocks, in rank order; the second arrive says this
  // block has read the others' sums, and its wait before the exit keeps
  // this block's sums alive until every block has read them
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" :::
               "memory");
  if (tid < kW) {
    float s = 0.f;
    for (int q = 0; q < C; ++q)
      s += *cluster.map_shared_rank(&block_ss[tid], q);
    scale[tid] = rsqrtf(__fdiv_rn(s, (float)H) + eps);
  }
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  __syncthreads();

  // 3. each thread scales its chunks, rounds once to bf16 and writes 8
  // or 16 bytes of each row of out; for out_t it also stages them in a
  // shared-memory tile of 64 features x kW tokens (two, used in turn),
  // which the block writes out after every second chunk, 128 contiguous
  // bytes a token (16-byte chunks swizzled: chunk k of token j at k ^ (j /
  // kVec) % 8, so that no bank is met twice by a warp's writes of 8 token
  // chunks x 4 features or by its reads along 4 token rows)
  uint16_t* tiles =
      reinterpret_cast<uint16_t*>(smem + (size_t)R * kThreads * 16);
  float sc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sc[i] = scale[tx * kVec + i];
  for (int r = 0; r < R; ++r) {
    const int fl = ty + kTY * r;  // the feature in this block
    uint16_t* tile = tiles + ((r >> 1) & 1) * kW * 64;
    if (f0 + fl < H) {
      const uint4 v = data[r * kThreads];
      const float wf = __bfloat162float(w[f0 + fl]);
      uint32_t p[kVec / 2];
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k) {
        const float y0 =
            __fmul_rn(__fmul_rn(elem<BF16>(v, 2 * k), sc[2 * k]), wf);
        const float y1 =
            __fmul_rn(__fmul_rn(elem<BF16>(v, 2 * k + 1), sc[2 * k + 1]), wf);
        const __nv_bfloat162 b = __floats2bfloat162_rn(y0, y1);
        p[k] = *reinterpret_cast<const uint32_t*>(&b);
      }
      if (out)
        store_chunk<kVec>(out + (size_t)(f0 + fl) * T + tt, p, left, vec);
      if (out_t) {
        const int col = ((((fl & 63) >> 3) ^ tx) << 3) + (fl & 7);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          tile[(tx * kVec + i) * 64 + col] = half_of(p, i);
      }
    }
    if (out_t && (r & 1)) {
      __syncthreads();  // the tile is whole; the other one free again
      const int g0 = f0 + kTY * (r - 1);  // its first feature
      for (int c = tid; c < kW * 8; c += kThreads) {
        const int j = c >> 3, k = c & 7;
        if (t0 + j < T && g0 + 8 * k < H)
          *reinterpret_cast<uint4*>(out_t + (size_t)(t0 + j) * H + g0 +
                                    8 * k) =
              *reinterpret_cast<const uint4*>(
                  tile + j * 64 + ((k ^ ((j / kVec) & 7)) << 3));
      }
    }
  }
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

template <bool BF16>
cudaError_t launch(const void* h, const bf16* w, bf16* out, bf16* out_t,
                   int H, int T, int FB, float eps, bool vec, int cluster,
                   cudaStream_t stream) {
  constexpr int kW = kTX * (BF16 ? 8 : 4);
  auto kern = norm_kernel<BF16>;
  // the block's chunks, and out_t's two tiles
  const int bytes =
      FB / kTY * kThreads * 16 + (out_t ? 2 * kW * 64 * 2 : 0);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  static bool ready[smt::kMaxDevices] = {};
  cudaError_t e = smt::allow_smem(kern, kSmemMax, ready);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {  // once per device, as allow_smem
    static bool wide[smt::kMaxDevices] = {};
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (!wide[dev]) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      wide[dev] = true;
    }
  }
  const long long blocks = (long long)cluster * ((T + kW - 1) / kW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, h, w, out, out_t, H, T, FB, eps,
                            vec);
}

}  // namespace

extern "C" int rms_norm_launch(const void* h, const void* w, void* out,
                               void* out_t, int H, int T, int in_bf16,
                               int FB, float eps, int device, void* stream) {
  if (H <= 0 || H % 8 != 0 || T < 0 || FB <= 0 || FB % 64 != 0 ||
      (!out && !out_t) || reinterpret_cast<uintptr_t>(out_t) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int cluster = (H + FB - 1) / FB;
  if (cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  const int vec_tokens = in_bf16 ? 8 : 4;
  const bool vec = T % vec_tokens == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* o = static_cast<bf16*>(out);
  bf16* ot = static_cast<bf16*>(out_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      in_bf16 ? launch<true>(h, wp, o, ot, H, T, FB, eps, vec, cluster, s)
              : launch<false>(h, wp, o, ot, H, T, FB, eps, vec, cluster, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
