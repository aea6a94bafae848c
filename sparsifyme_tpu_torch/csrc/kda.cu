// Kimi Delta Attention's chunked recurrence: the gated delta rule with a
// decay per channel, over chunks of 64 tokens, the state in f32.
//
// Replaces no TPU kernel: the JAX package has no transformer. It is the
// core of models/kda.py's block (kda_attention), whose plain version
// (ops/kernels/kda_kernel.py: kda_chunk_plain) computes the same chunked
// form in PyTorch.
//
// Per sequence and head, with d = 128 for q, k and v, and S_0 = 0 at each
// sequence's start:
//   S_t = (I - b_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + b_t k_t v_t^T
//   o_t = S_t^T q_t * scale
// In a chunk of C = 64 tokens, with Gam_r = g_1 + ... + g_r (per channel,
// from the chunk's start) and S_0 the state before it:
//   A[r][s]  = b_r sum_c k_r[c] k_s[c] exp(Gam_r[c] - Gam_s[c])   s < r
//   P[r][s]  = scale sum_c q_r[c] k_s[c] exp(Gam_r[c] - Gam_s[c])  s <= r
//   (I + A) [W1 | W2] = [b V | b (exp(Gam) . K)]          (the UT transform)
//   U   = W1 - W2 S_0                              (each token's new value)
//   O   = (scale exp(Gam) . Q) S_0 + P U
//   S_C = exp(Gam_C) . S_0 + (exp(Gam_C - Gam) . K)^T U
// Every exponent is a difference Gam_r - Gam_s with s <= r (or through a
// token m between them: Gam_r - Gam_m and Gam_m - Gam_s), or Gam_r, or
// Gam_C - Gam_r: never positive, since every g <= 0. So nothing overflows
// however strong the decay (a chunk of -1.6 a token sums to -102, past
// f32's exp range for exp(Gam_r) * exp(-Gam_s)); a factor that underflows
// is one whose true value is below f32's least.
//
// Inputs, feature-major like the model's activations: q, k, v bf16
// [H * 128, T] (q and k already L2-normed per head), g f32 [H * 128, T] (the
// log-decay), beta f32 [H, T]; T = B * S tokens, sequence b's at columns
// b * S .. b * S + S - 1, S % 64 == 0. Output o bf16 [H * 128, T].
//
// What bounds it on the H100: at Kimi Linear's prefill (B 8, S 4096, H 32)
// the work fixed by the block's inputs and outputs is 4 d^2 + 2 C (2 d)
// = 98 KFLOP a head-token, 103 GFLOP a layer (0.10 ms at 989 TFLOP/s);
// its bytes (q, k, v, the decay and o at 2 B, beta) are 1.35 GB a layer
// (0.40 ms at 3.35 TB/s). This kernel forms each chunk's transform in f32
// on the CUDA cores and keeps it in device memory between its two phases,
// so it runs well above that bound (PERF.md).
//
// Design: two launches on the stream.
//   1. kda_chunk_prep, one block a (sequence, head, chunk): the part of a
//      chunk that needs no state, in parallel over chunks. It stages q, k
//      (bf16) and the decay (f32, summed into Gam in place, a warp a
//      channel) in shared memory; 136 threads each form a 4 x 4 tile of A
//      and P on or below the diagonal, no warp both kinds (on it an exp a
//      pair and channel; below it two exps through the token before the
//      tile's rows, so 8 exps a channel give 16 pairs); 256 threads each
//      solve one column of the unit lower-triangular system by forward
//      substitution in registers (128 of bV, 128 of bK~). It writes the
//      chunk's transform to `work`: W2^T and (scale exp(Gam) . Q)^T
//      d-major, W1, (exp(Gam_C - Gam) . K), P^T and exp(Gam_C), 148 KB a
//      chunk and head.
//   2. kda_chunk_scan, one block a (sequence, head): the 64 chunks in
//      order, the state S [128 x 128] f32 in shared memory. Its three
//      products a chunk ([W2; Q~] S, P U, K^^T U) run on the tensor cores
//      at f32's accuracy (3xTF32 m16n8k8 MMAs), 16 warps each a 32 x 32
//      tile; each part of the next chunk's transform comes into shared
//      memory by cp.async as soon as its buffer is free, behind this
//      chunk's arithmetic.
// The columns of S evolve independently under the delta rule; this kernel
// keeps them in one block so that each chunk's transform is read once.
//
// The block's elementwise glue, each one pass over its tensors (f32 inside,
// one bf16 rounding), beside the recurrence in this library:
//   kda_conv: q, k, v = SiLU(causal depthwise conv of width 4 along each
//     sequence's positions), the first `normed` rows (q's and k's) then
//     L2-normed per head and token (x * rsqrt(sum x^2 + eps)); one block a
//     128-row head part and 64 tokens, the tile and the 3 tokens before it
//     (zeros at a sequence's start) staged in shared memory;
//   kda_decay: g = -exp(A_log[h]) * softplus(f + dt_bias), f32 from the bf16
//     low-rank product f (PyTorch's softplus: x past 20 is x);
//   kda_gate_norm: y = RMSNorm_128(o) * w * sigmoid(gate) per head and
//     token, bf16 out; one block a head and 64 tokens.
#include "tile_mma.cuh"

namespace {

using smt::bf16;

constexpr int kD = 128;  // head dim of q, k and v
constexpr int kC = 64;   // tokens a chunk

// a (chunk, head)'s transform in `work`, in floats
constexpr int kAt = 0;               // [kD][kD]: W2^T (r' < kC), Q~^T
constexpr int kW1 = kAt + kD * kD;   // [kC][kD]
constexpr int kKh = kW1 + kC * kD;   // [kC][kD]: exp(Gam_C - Gam) . K
constexpr int kAq = kKh + kC * kD;   // [kC][kC]: P^T, [s][r]
constexpr int kDec = kAq + kC * kC;  // [kD]: exp(Gam_C)
constexpr int kWork = kDec + kD;

// phase 1's shared memory
constexpr int kT1 = 256;
constexpr int kGS = kC + 1;  // Gam's row stride (f32): a thread a row
constexpr int kQS = kC + 2;  // q's and k's row stride (bf16)
constexpr int kAS = kC + 4;  // A's and P's row stride (f32, 16-byte rows)
constexpr int kBelow = (kC / 4) * (kC / 4 - 1) / 2;  // 120 tiles below
constexpr int kDiag = 128;  // the first thread of the diagonal tiles
constexpr size_t kSmem1 = sizeof(float) * kD * kGS + 2 * sizeof(bf16) * kD *
                          kQS + sizeof(float) * (2 * kC * kAS + kC);
static_assert(kBelow <= kDiag && kDiag + kC / 4 <= kT1 && 2 * kD == kT1,
              "phase 1's thread maps");

// phase 2's shared memory: rows of 128 floats padded to 136 and of 64 to
// 72, so that an MMA fragment's loads (8 rows of 4 apart, 4 columns) meet
// no bank twice
constexpr int kT2 = 512;  // 16 warps, a 32 x 32 tile of each product each
constexpr int kLS = kD + 8;
constexpr int kQL = kC + 8;
constexpr size_t kSmem2 =
    sizeof(float) * (2 * kD * kLS + 2 * kC * kLS + kC * kQL + kD);
static_assert(kT2 == 32 * (kD / 32) * (kD / 32), "phase 2's warp map");

__device__ __forceinline__ float lo_bf(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ float bf(const bf16 x) {
  return __bfloat162float(x);
}

__global__ void __launch_bounds__(kT1, 2)
    kda_chunk_prep(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ beta, float* __restrict__ work,
                   int H, int N, int T, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* G = reinterpret_cast<float*>(smem);
  bf16* Q = reinterpret_cast<bf16*>(G + kD * kGS);
  bf16* K = Q + kD * kQS;
  float* A = reinterpret_cast<float*>(K + kD * kQS);
  float* P = A + kC * kAS;
  float* bt = P + kC * kAS;

  const int tid = threadIdx.x;
  const int n = blockIdx.x % N, bh = blockIdx.x / N;
  const int h = bh % H, b = bh / H;
  const size_t col0 = (size_t)b * S + (size_t)n * kC;
  const size_t row0 = (size_t)h * kD;
  float* wk = work + (size_t)blockIdx.x * kWork;

  // 1. q and k (rows of 64 bf16: 8 chunks of 16 bytes), the decay (16
  //    chunks a row), beta; A and P zeroed
  for (int i = tid; i < kD * 8; i += kT1) {
    const int d = i >> 3, c = i & 7;
    const size_t off = (row0 + d) * T + col0 + c * 8;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(q + off));
    const uint4 e = __ldg(reinterpret_cast<const uint4*>(k + off));
    uint32_t* qd = reinterpret_cast<uint32_t*>(Q + d * kQS + c * 8);
    uint32_t* kd = reinterpret_cast<uint32_t*>(K + d * kQS + c * 8);
    qd[0] = a.x, qd[1] = a.y, qd[2] = a.z, qd[3] = a.w;
    kd[0] = e.x, kd[1] = e.y, kd[2] = e.z, kd[3] = e.w;
  }
  for (int i = tid; i < kD * 16; i += kT1) {
    const int d = i >> 4, c = i & 15;
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        g + (row0 + d) * T + col0 + c * 4));
    float* gd = G + d * kGS + c * 4;
    gd[0] = x.x, gd[1] = x.y, gd[2] = x.z, gd[3] = x.w;
  }
  if (tid < kC) bt[tid] = __ldg(beta + (size_t)h * T + col0 + tid);
  for (int i = tid; i < kC * kAS; i += kT1) A[i] = 0.f, P[i] = 0.f;
  __syncthreads();

  // 2. Gam: each channel's decay summed along the chunk, a warp a channel
  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < kD; d += kT1 / 32) {
    float a0 = G[d * kGS + lane], a1 = G[d * kGS + 32 + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t0 = __shfl_up_sync(0xffffffffu, a0, o);
      const float t1 = __shfl_up_sync(0xffffffffu, a1, o);
      if (lane >= o) a0 += t0, a1 += t1;
    }
    a1 += __shfl_sync(0xffffffffu, a0, 31);
    G[d * kGS + lane] = a0;
    G[d * kGS + 32 + lane] = a1;
  }
  __syncthreads();

  // 3. A and P, a 4 x 4 tile (rows r0.., columns s0..) a thread: the 120
  //    tiles below the diagonal on threads 0-119, the 16 on it on threads
  //    128-143, so that no warp runs both kinds. Below the diagonal,
  //    exp(Gam_r - Gam_s) = exp(Gam_r - Gam_m) * exp(Gam_m - Gam_s) with
  //    m = r0 - 1 the token before the tile's rows: s <= m < r, so both
  //    factors are at most 1 and 8 exps give 16 pairs. On it, each pair's
  //    own exp, the exponent clamped at 0 where s > r (masked below).
  const bool below = tid < kBelow;
  if (below || (tid >= kDiag && tid < kDiag + kC / 4)) {
    int tr = 0, ts = tid - kDiag;
    if (below) {
      while ((tr + 1) * (tr + 2) / 2 <= tid) ++tr;
      ts = tid - tr * (tr + 1) / 2, ++tr;
    } else {
      tr = ts;
    }
    const int r0 = 4 * tr, s0 = 4 * ts;
    float a[4][4], p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f, p[i][j] = 0.f;
    if (below) {
      for (int d = 0; d < kD; ++d) {
        const float* gd = G + d * kGS;
        const bf16* qd = Q + d * kQS;
        const bf16* kd = K + d * kQS;
        const float gm = gd[r0 - 1];
        float qr[4], kr[4], ks[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float er = __expf(fminf(gd[r0 + i] - gm, 0.f));
          qr[i] = bf(qd[r0 + i]) * er, kr[i] = bf(kd[r0 + i]) * er;
          ks[i] = bf(kd[s0 + i]) * __expf(fminf(gm - gd[s0 + i], 0.f));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[i][j] = fmaf(kr[i], ks[j], a[i][j]);
            p[i][j] = fmaf(qr[i], ks[j], p[i][j]);
          }
      }
    } else {
      for (int d = 0; d < kD; ++d) {
        const float* gd = G + d * kGS;
        const bf16* qd = Q + d * kQS;
        const bf16* kd = K + d * kQS;
        float gr[4], qr[4], kr[4], gs[4], ks[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gr[i] = gd[r0 + i], qr[i] = bf(qd[r0 + i]), kr[i] = bf(kd[r0 + i]);
          gs[i] = gd[s0 + i], ks[i] = bf(kd[s0 + i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float ke = ks[j] * __expf(fminf(gr[i] - gs[j], 0.f));
            a[i][j] = fmaf(kr[i], ke, a[i][j]);
            p[i][j] = fmaf(qr[i], ke, p[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + i, s = s0 + j;
        if (s < r) A[r * kAS + s] = a[i][j] * bt[r];
        if (s <= r) P[r * kAS + s] = p[i][j] * scale;
      }
  }
  __syncthreads();

  // 4. (I + A) X = R by forward substitution, a column of R a thread:
  //    thread d < 128 bV's column d (v's row d), thread 128 + d bK~'s
  const int d = tid & (kD - 1);
  const bool is_v = tid < kD;
  float x[kC];
  if (is_v) {
    const uint4* src =
        reinterpret_cast<const uint4*>(v + (row0 + d) * T + col0);
#pragma unroll
    for (int c = 0; c < kC / 8; ++c) {
      const uint4 u = __ldg(src + c);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[8 * c + 2 * i] = lo_bf(w[i]) * bt[8 * c + 2 * i];
        x[8 * c + 2 * i + 1] = hi_bf(w[i]) * bt[8 * c + 2 * i + 1];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kC; ++r)
      x[r] = bt[r] * bf(K[d * kQS + r]) * __expf(G[d * kGS + r]);
  }
#pragma unroll
  for (int r = 1; r < kC; ++r) {
    float acc = x[r];
    const float* ar = A + r * kAS;
#pragma unroll
    for (int s = 0; s < r; ++s) acc = fmaf(-ar[s], x[s], acc);
    x[r] = acc;
  }

  // 5. the transform: W1 (coalesced across d), W2^T and Q~^T (a row of
  //    At a thread), K^ (coalesced), exp(Gam_C), P^T
  const float* gd = G + d * kGS;
  const float last = gd[kC - 1];
  if (is_v) {
#pragma unroll
    for (int r = 0; r < kC; ++r) wk[kW1 + r * kD + d] = x[r];
    const bf16* qd = Q + d * kQS;
    float4* dst = reinterpret_cast<float4*>(wk + kAt + d * kD + kC);
#pragma unroll 4
    for (int c = 0; c < kC / 4; ++c) {
      float t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[i] = bf(qd[4 * c + i]) * __expf(gd[4 * c + i]) * scale;
      dst[c] = make_float4(t[0], t[1], t[2], t[3]);
    }
    wk[kDec + d] = __expf(last);
  } else {
    float4* dst = reinterpret_cast<float4*>(wk + kAt + d * kD);
#pragma unroll
    for (int c = 0; c < kC / 4; ++c)
      dst[c] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2],
                           x[4 * c + 3]);
    const bf16* kd = K + d * kQS;
#pragma unroll 4
    for (int r = 0; r < kC; ++r)
      wk[kKh + r * kD + d] = bf(kd[r]) * __expf(fminf(last - gd[r], 0.f));
  }
  for (int i = tid; i < kC * kC; i += kT1)
    wk[kAq + i] = P[(i % kC) * kAS + i / kC];
}

// 16-byte asynchronous copies of `rows` rows of `cols` floats (a multiple
// of 4) from global memory, rows back to back, into shared memory rows
// `stride` floats apart, by the block's kT2 threads; committed and waited
// for as groups.
__device__ __forceinline__ void copy_async(float* dst, int stride,
                                           const float* src, int rows,
                                           int cols, int tid) {
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int quads = cols / 4;
  for (int i = tid; i < rows * quads; i += kT2) {
    const int r = i / quads, q = i % quads;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 4 * (r * stride + 4 * q)),
                 "l"(src + 4 * i));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f32 products on the tensor cores at f32's accuracy (3xTF32): x = hi + lo
// with hi and lo TF32, and a * b taken as hi*hi + hi*lo + lo*hi, each an
// m16n8k8 MMA accumulating in f32 (the lo*lo term, about 2^-22 of the
// product, is left out).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's 32 x 32 tile of C += A B over K, 3xTF32. A's element (m, k) is
// at a[k * lda + m] (k-major, the warp's 32 rows from a), B's (k, n) at
// b[k * ldb + n] (its 32 columns from b). C is 2 x 4 m16n8 fragments: c[i][j]
// holds (row 16 i + g, column 8 j + 2 t, + 1) and (row 16 i + g + 8, the
// same columns), g = lane / 4, t = lane % 4.
template <int K>
__device__ __forceinline__ void warp_gemm(float (&c)[2][4][4],
                                          const float* a, int lda,
                                          const float* b, int ldb,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* ap = a + (k0 + t) * lda + 16 * i + g;
      split_tf32(ap[0], ah[i][0], al[i][0]);
      split_tf32(ap[8], ah[i][1], al[i][1]);
      split_tf32(ap[4 * lda], ah[i][2], al[i][2]);
      split_tf32(ap[4 * lda + 8], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* bp = b + (k0 + t) * ldb + 8 * j + g;
      split_tf32(bp[0], bh[j][0], bl[j][0]);
      split_tf32(bp[4 * ldb], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(c[i][j], al[i], bh[j]);
        mma_tf32(c[i][j], ah[i], bl[j]);
        mma_tf32(c[i][j], ah[i], bh[j]);
      }
  }
}

__global__ void __launch_bounds__(kT2, 1)
    kda_chunk_scan(const float* __restrict__ work, bf16* __restrict__ o,
                   int H, int N, int T, int S) {
  extern __shared__ __align__(16) float sm[];
  float* Ss = sm;                 // [kD][kLS]: the state, d-major
  float* At = Ss + kD * kLS;      // [kD][kLS]: W2^T (r' < 64), Q~^T
  float* Us = At + kD * kLS;      // [kC][kLS]: U
  float* Kh = Us + kC * kLS;      // [kC][kLS]: K^
  float* Aq = Kh + kC * kLS;      // [kC][kQL]: P^T
  float* dec = Aq + kC * kQL;     // [kD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 32 x 32 tile
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const float* wk0 = work + (size_t)bh * N * kWork;
  for (int i = tid; i < kD * kLS; i += kT2) Ss[i] = 0.f;
  copy_async(At, kLS, wk0 + kAt, kD, kD, tid);
  cp_async_commit();

  for (int n = 0; n < N; ++n) {
    const float* wk = wk0 + (size_t)n * kWork;
    // a. the chunk's K^, P^T and exp(Gam_C) on their way into shared
    //    memory (their buffers are free since the last chunk's step e);
    //    W2^T and Q~^T came in during the last chunk's steps d and e
    copy_async(Kh, kLS, wk + kKh, kC, kD, tid);
    copy_async(Aq, kQL, wk + kAq, kC, kC, tid);
    copy_async(dec, kD, wk + kDec, 1, kD, tid);
    cp_async_commit();
    // W1's share (the warps of rows 0-63), loaded behind step b
    float2 w1[2][4][2];
    if (wm < 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            w1[i][j][hf] = __ldg(reinterpret_cast<const float2*>(
                wk + kW1 + (32 * wm + 16 * i + g + 8 * hf) * kD + 32 * wn +
                8 * j + 2 * t));
    }
    cp_async_wait<1>();  // W2^T and Q~^T
    __syncthreads();

    // b. [W2; Q~] S: rows 32 wm.. of the product, columns 32 wn..
    float c[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
    warp_gemm<kD>(c, At + 32 * wm, kLS, Ss + 32 * wn, kLS, lane);

    // c. U = W1 - W2 S (the warps of rows 0-63) into shared memory
    if (wm < 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = 32 * wm + 16 * i + g + 8 * hf;
            const int col = 32 * wn + 8 * j + 2 * t;
            const float2 w = w1[i][j][hf];
            *reinterpret_cast<float2*>(Us + r * kLS + col) = make_float2(
                w.x - c[i][j][2 * hf], w.y - c[i][j][2 * hf + 1]);
          }
    }
    __syncthreads();
    // the next chunk's W2^T and Q~^T into At, behind steps d and e
    if (n + 1 < N) {
      copy_async(At, kLS, wk + kWork + kAt, kD, kD, tid);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's K^, P^T, exp(Gam_C)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // d. O = Q~ S + P U (the warps of rows 64-127), out feature-major
    if (wm >= 2) {
      warp_gemm<kC>(c, Aq + 32 * (wm - 2), kQL, Us + 32 * wn, kLS, lane);
      const size_t tok = (size_t)b * S + (size_t)n * kC + 32 * (wm - 2);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * i + g + 8 * (e >> 1);
            const int col = 32 * wn + 8 * j + 2 * t + (e & 1);
            o[(size_t)(h * kD + col) * T + tok + r] =
                __float2bfloat16(c[i][j][e]);
          }
    }
    // e. S = exp(Gam_C) . S + K^^T U: rows (d) 32 wm.., columns 32 wn..
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 32 * wm + 16 * i + g + 8 * (e >> 1);
          const int col = 32 * wn + 8 * j + 2 * t + (e & 1);
          c[i][j][e] = dec[d] * Ss[d * kLS + col];
        }
    warp_gemm<kC>(c, Kh + 32 * wm, kLS, Us + 32 * wn, kLS, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d = 32 * wm + 16 * i + g + 8 * hf;
          const int col = 32 * wn + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(Ss + d * kLS + col) =
              make_float2(c[i][j][2 * hf], c[i][j][2 * hf + 1]);
        }
    __syncthreads();
  }
}

constexpr int kTT = 64;   // tokens a tile of the glue kernels
constexpr int kTG = 256;  // their threads: a token and 32 rows each

__global__ void __launch_bounds__(kTG)
    kda_conv(const bf16* __restrict__ x, const bf16* __restrict__ w,
             bf16* __restrict__ out, int normed, int T, int S, float eps) {
  constexpr int kXS = kTT + 8;  // a staged row: 8 tokens before, 64 after
  __shared__ __align__(16) bf16 xs[kD * kXS];
  __shared__ float ws[kD * 4];
  __shared__ float ss[4 * kTT];
  const int tid = threadIdx.x, tiles = T / kTT;
  const int r0 = (blockIdx.x / tiles) * kD;
  const size_t t0 = (size_t)(blockIdx.x % tiles) * kTT;
  const bool first = t0 % S == 0;  // no tokens of this sequence before
  for (int i = tid; i < kD * 9; i += kTG) {
    const int r = i / 9, c = i % 9;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (c > 0 || !first)
      u = __ldg(reinterpret_cast<const uint4*>(
          x + (size_t)(r0 + r) * T + t0 - 8 + 8 * c));
    *reinterpret_cast<uint4*>(xs + r * kXS + 8 * c) = u;
  }
  for (int i = tid; i < kD * 4; i += kTG)
    ws[i] = __bfloat162float(w[(size_t)r0 * 4 + i]);
  __syncthreads();
  const int tt = tid & (kTT - 1), rg = tid >> 6;
  float y[32], sq = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = rg * 32 + i;
    const bf16* xr = xs + r * kXS + 8 + tt - 3;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = fmaf(ws[r * 4 + j], bf(xr[j]), acc);
    const float v = acc / (1.f + __expf(-acc));
    y[i] = v;
    sq = fmaf(v, v, sq);
  }
  if (r0 < normed) {  // the whole block's rows are q's or k's
    ss[rg * kTT + tt] = sq;
    __syncthreads();
    const float n = rsqrtf(ss[tt] + ss[kTT + tt] + ss[2 * kTT + tt] +
                           ss[3 * kTT + tt] + eps);
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] *= n;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out[(size_t)(r0 + rg * 32 + i) * T + t0 + tt] = __float2bfloat16(y[i]);
}

__global__ void __launch_bounds__(kTG)
    kda_decay(const bf16* __restrict__ f, const float* __restrict__ a_log,
              const float* __restrict__ dt_bias, float* __restrict__ g,
              long long n8, int T) {
  for (long long i = blockIdx.x * (long long)kTG + threadIdx.x; i < n8;
       i += (long long)gridDim.x * kTG) {
    const long long row = i * 8 / T;
    const float a = -__expf(__ldg(a_log + row / kD));
    const float bias = __ldg(dt_bias + row);
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(f) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = lo_bf(w[j]) + bias;
      o[2 * j + 1] = hi_bf(w[j]) + bias;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = a * (o[j] > 20.f ? o[j] : log1pf(__expf(o[j])));
    float4* dst = reinterpret_cast<float4*>(g) + 2 * i;
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

__global__ void __launch_bounds__(kTG)
    kda_gate_norm(const bf16* __restrict__ o, const bf16* __restrict__ gate,
                  const bf16* __restrict__ w, bf16* __restrict__ y, int T,
                  float eps) {
  __shared__ float ss[4 * kTT];
  const int tid = threadIdx.x, tiles = T / kTT;
  const int r0 = (blockIdx.x / tiles) * kD;
  const size_t t0 = (size_t)(blockIdx.x % tiles) * kTT;
  const int tt = tid & (kTT - 1), rg = tid >> 6;
  float v[32], sq = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    v[i] = bf(o[(size_t)(r0 + rg * 32 + i) * T + t0 + tt]);
    sq = fmaf(v[i], v[i], sq);
  }
  ss[rg * kTT + tt] = sq;
  __syncthreads();
  const float n = rsqrtf((ss[tt] + ss[kTT + tt] + ss[2 * kTT + tt] +
                          ss[3 * kTT + tt]) / kD + eps);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const size_t at = (size_t)(r0 + rg * 32 + i) * T + t0 + tt;
    const float s = 1.f / (1.f + __expf(-bf(gate[at])));
    y[at] = __float2bfloat16(v[i] * n * bf(w[rg * 32 + i]) * s);
  }
}

}  // namespace

extern "C" int kda_conv_launch(const void* x, const void* w, void* out,
                               int rows, int normed, int T, int S, float eps,
                               int device, void* stream) {
  if (rows <= 0 || rows % kD != 0 || normed < 0 || normed % kD != 0 ||
      T <= 0 || S <= 0 || S % kTT != 0 || T % S != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)(rows / kD) * (T / kTT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  kda_conv<<<(unsigned)blocks, kTG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), normed, T, S, eps);
  return (int)cudaGetLastError();
}

extern "C" int kda_decay_launch(const void* f, const void* a_log,
                                const void* dt_bias, void* g, int rows, int T,
                                int device, void* stream) {
  if (rows <= 0 || rows % kD != 0 || T <= 0 || T % 8 != 0 ||
      reinterpret_cast<uintptr_t>(f) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n8 = (long long)rows * T / 8;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  const long long blocks = (n8 + kTG - 1) / kTG;
  kda_decay<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), kTG, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(f), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<float*>(g), n8, T);
  return (int)cudaGetLastError();
}

extern "C" int kda_gate_norm_launch(const void* o, const void* gate,
                                    const void* w, void* y, int rows, int T,
                                    float eps, int device, void* stream) {
  if (rows <= 0 || rows % kD != 0 || T <= 0 || T % kTT != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)(rows / kD) * (T / kTT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  kda_gate_norm<<<(unsigned)blocks, kTG, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(gate),
      static_cast<const bf16*>(w), static_cast<bf16*>(y), T, eps);
  return (int)cudaGetLastError();
}

extern "C" int kda_chunk_launch(const void* q, const void* k, const void* v,
                                const void* g, const void* beta, void* work,
                                void* o, int H, int B, int S, float scale,
                                int device, void* stream) {
  if (H <= 0 || B <= 0 || S <= 0 || S % kC != 0)
    return (int)cudaErrorInvalidValue;
  const void* aligned[] = {q, k, v, g, work};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  const long long T = (long long)B * S, N = S / kC;
  if (T > 0x7fffffffLL || (long long)B * H * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const smt::OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  static bool ready1[smt::kMaxDevices] = {}, ready2[smt::kMaxDevices] = {};
  cudaError_t e = smt::allow_smem(kda_chunk_prep, (int)kSmem1, ready1);
  if (e != cudaSuccess) return (int)e;
  e = smt::allow_smem(kda_chunk_scan, (int)kSmem2, ready2);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kda_chunk_prep<<<(unsigned)(B * H * N), kT1, kSmem1, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<float*>(work), H, (int)N,
      (int)T, S, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kda_chunk_scan<<<(unsigned)(B * H), kT2, kSmem2, st>>>(
      static_cast<const float*>(work), static_cast<bf16*>(o), H, (int)N,
      (int)T, S);
  return (int)cudaGetLastError();
}

