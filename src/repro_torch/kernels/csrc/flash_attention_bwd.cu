// Flash attention backward, CUDA C++ for sm_90a (Hopper).
//
// Replaces no TPU kernel: it is the twin of the reference's blockwise jnp
// backward of its flash attention (src/repro/models/layers.py:_flash_bwd,
// the custom VJP of `_flash_core`), which the port's LM path runs in
// place of the TPU kernel src/repro/kernels/flash_attention.py (the
// forward, csrc/flash_attention.cu). Same function: from q, k, v [BH, S,
// D], the forward's out and its fp32 log-sum-exp lse [BH, Sq] (the
// forward kernel's optional output), and the cotangent dout,
//   delta = rowsum(dout * out)                       (fp32)
//   P     = exp(q.k * scale - lse), 0 where masked   (the reference's
//           jnp.where(mask, exp(s - lse), 0); causal keeps q_idx >= k_idx)
//   dV    = P^T dout
//   dS    = P * (dout V^T - delta) * scale
//   dK    = dS^T q,   dQ = dS K
// every product accumulated in fp32 and dq, dk, dv written in the inputs'
// dtype (float32 or bfloat16). Causal calls have Sq == Skv (the wrapper
// checks); full calls take any Sq and Skv, the ragged tails masked (keys
// past Skv get P = 0, rows past Sq are zero and not stored).
//
// Three kernels, no atomics: each output element has one writer and every
// sum is taken in a fixed order, so a run repeats bit for bit.
//   1. delta: one warp a row.
//   2. dK / dV: one block per (bh, key tile). The block keeps its K and V
//      tile in shared memory and dK, dV in registers, and walks the q
//      tiles in order (causal: from the diagonal tile on, the tiles above
//      it are wholly masked): per tile it recomputes S and dout V^T, forms
//      P and dS, and adds P^T dout and dS^T q.
//   3. dQ: one block per (bh, q tile), the longest (causal: last) tiles
//      first. It keeps its rows' q, dout, lse and delta and dQ, walks the
//      key tiles (causal: up to the diagonal), recomputes P and dS the
//      same way and adds dS K.
// Splitting dQ from dK / dV costs the second recompute of S and dout V^T:
// 7 products of 2 Sq Skv D operations a head instead of 5, 240.6 GFLOP at
// the qwen3-4b step (BH 64, S 2048, D 128, causal), 0.243 ms of tensor
// cores at 989 TFLOP/s bf16, against the 5 products' 171.9 GFLOP, 0.174
// ms. It keeps the kernel free of float atomics, whose order would change
// from run to run.
//
// bf16: wgmma fed by TMA, the forward's design (csrc/flash_attention.cu).
// Each block has three warpgroups: a producer and two consumers of 64
// keys (dK / dV) or 64 rows (dQ) each (setmaxnreg: 40 / 232 registers a
// thread). Every tile comes by cp.async.bulk.tensor from 3-D tensor maps
// over [BH, S, D] (dims D, S, BH: rows past S are zero-filled by the
// hardware and never read from the next bh), 128-byte swizzled, a D=128
// row as two 64-column boxes, K-major. The streamed tiles go through a
// ring of kBfStages stages with a full and an empty mbarrier per stage.
//   dK / dV (dkdv_bf16_kernel): a block per 128-key tile, K and V loaded
//   once. The producer's elected thread streams the 64-row tiles of q and
//   dout; a second producer warp copies the rows' lse (times log2 e) and
//   delta into the same stage, 0 past Sq. Computed transposed, a consumer
//   takes S^T = K_c q^T and dP^T = V_c dout^T with wgmma.m64n64k16 (both
//   operands K-major in shared memory), forms P^T and dS^T in fp32 on the
//   accumulator fragments and rounds them to bf16 straight into register
//   A fragments, then adds dV_c += P^T dout and dK_c += dS^T q with
//   wgmma.m64nDk16, q and dout read MN-major through the transpose bit.
//   dQ (dq_bf16_kernel): a block per 128-row q tile, q and dout loaded
//   once, each consumer's rows' lse and delta in registers. The producer
//   streams 64-key tiles of K and V; a consumer takes S = q_c K^T and dP
//   = dout_c V^T (both K-major), forms dS and adds dQ_c += dS K, K read
//   MN-major.
// Only the diagonal and ragged tiles compare indices (row < Sq, key <
// Skv, causal key <= row): a zero-filled row scores 0, and exp(0 - lse)
// is not 0. A consumer whose keys all lie above a tile's rows (causal)
// skips the tile's products.
// Registers. Each product is waited for before the next step: S^T, P^T
// in place in fp32, dP^T, dS^T in place, both A fragments, then the dV
// and dK products. A dK / dV consumer thread holds dK and dV (D / 2
// registers each), P^T and dP^T (32 each) and the fragments (16 each);
// the first k-step of each S or dP product only writes its accumulator,
// so the last tile's values hold no register while the next products
// run. ptxas grants the consumers setmaxnreg's registers only with a
// warp-uniform warpgroup index (read through __shfl_sync) and no trap
// path in their loop: without those it held them to the launch bound's
// 168, spilled dK / dV and serialized the wgmmas (ptxas remark C7512).
// Rounding: P and dS are rounded to bf16 as wgmma operands, where the
// reference keeps p and ds in fp32 (models/layers.py:_flash_bwd); S and
// dout V^T stay fp32, where the reference rounds them to bf16.
//
// fp32: fp32 FMAs on the CUDA cores. Every tile is staged in shared
// memory (rows padded by 4 floats: 16-byte loads of neighbouring rows
// fall on other banks); dK / dV a block per 64-key tile and dQ a block
// per 64-row q tile. Each thread owns a 4 x 4 micro-tile of S and dout
// V^T (rows 4 tr + i, keys tc + 16 j) and then 4 rows or keys x D / 16
// columns of its accumulators (float4 loads, 8 to 10 FMAs a shared-memory
// word).
//
// Bound. Five products of 2 Sq Skv D operations a head (halved when
// causal): at the qwen3-4b step 171.9 GFLOP, 0.174 ms at 989 TFLOP/s
// bf16 (H100 SXM; 5.1 ms for row 3's fp32 shape at 67 TFLOP/s); it moves
// q, k, v, out, dout read once, dq, dk, dv written, lse and delta: 0.27
// GB in bf16, 0.08 ms.
//
// Plain C entry point, bound from Python with ctypes
// (kernels/flash_attention.py). The tensor maps are encoded on the host
// with cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point lookup, so the library needs no -lcuda. Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// fp32
constexpr int kBlockQ = 64;   // q rows a tile
constexpr int kBlockK = 64;   // keys a tile
constexpr int kThreads = 256; // 16 x 16 micro-tiles of 4 x 4
constexpr int kPPad = kBlockK + 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive elements from global memory (16-byte aligned), widened
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 4 fp32 values to 4 consecutive elements of global memory
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// rows [r0, r0 + kRows) of a [s, D] matrix, widened to fp32, into
// dst[kRows][D + 4]; rows past s are zeros
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage(float (*dst)[D + 4], const T* src,
                                      int r0, int s) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    float v[8];
    if (r0 + r < s) {
      load8(src + (int64_t)(r0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    *reinterpret_cast<float4*>(&dst[r][c]) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&dst[r][c + 4]) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

// S = q k^T and dP = dout v^T for the thread's micro-tile: rows 4 tr + i,
// keys tc + 16 j of the staged tiles
template <int D>
__device__ __forceinline__ void scores(float (*q)[D + 4], float (*o)[D + 4],
                                       float (*k)[D + 4], float (*v)[D + 4],
                                       int tr, int tc, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 a[4], g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(&q[4 * tr + i][c]);
      g[i] = *reinterpret_cast<const float4*>(&o[4 * tr + i][c]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(&k[tc + 16 * j][c]);
      const float4 w = *reinterpret_cast<const float4*>(&v[tc + 16 * j][c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        dp[i][j] = fmaf(g[i].x, w.x, dp[i][j]);
        dp[i][j] = fmaf(g[i].y, w.y, dp[i][j]);
        dp[i][j] = fmaf(g[i].z, w.z, dp[i][j]);
        dp[i][j] = fmaf(g[i].w, w.w, dp[i][j]);
      }
    }
  }
}

// P and dS of the micro-tile, in place of s and dp: rows q0 + 4 tr + i,
// keys k0 + tc + 16 j; lse2 is the row's lse in log2 units
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse2, const float* delta,
                                      int q0, int k0, int tr, int tc, int sq,
                                      int skv, int causal, float scale) {
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    const float l2 = lse2[4 * tr + i], dl = delta[4 * tr + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tc + 16 * j;
      const bool keep = row < sq && key < skv && (!causal || key <= row);
      const float p = keep ? exp2f(fmaf(s[i][j], sl2, -l2)) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl) * scale;
    }
  }
}

// one row's lse (times log2 e) and delta into shared memory; rows past sq
// get 0 (their P is masked)
__device__ __forceinline__ void stage_rows(float* lse2, float* dl,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int sq) {
  for (int r = threadIdx.x; r < kBlockQ; r += kThreads) {
    const bool in = q0 + r < sq;
    lse2[r] = in ? lse[q0 + r] * kLog2e : 0.f;
    dl[r] = in ? delta[q0 + r] : 0.f;
  }
}

template <int D>
struct KvTiles {
  float k[kBlockK][D + 4];
  float v[kBlockK][D + 4];
  float q[kBlockQ][D + 4];
  float o[kBlockQ][D + 4];   // dout
  float p[kBlockQ][kPPad];   // P  [row][key]
  float ds[kBlockQ][kPPad];  // dS [row][key]
  float lse2[kBlockQ];
  float delta[kBlockQ];
};

template <int D>
struct QTiles {
  float q[kBlockQ][D + 4];
  float o[kBlockQ][D + 4];   // dout
  float k[kBlockK][D + 4];
  float v[kBlockK][D + 4];
  float dst[kBlockK][kPPad]; // dS transposed, [key][row]
  float lse2[kBlockQ];
  float delta[kBlockQ];
};

// delta[row] = sum_d out[row, d] * dout[row, d] in fp32, one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f(out[row * D + c]), to_f(dout[row * D + c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
            float scale, int causal) {
  constexpr int kCols = D / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  KvTiles<D>& sm = *reinterpret_cast<KvTiles<D>*>(smem);
  const int tid = threadIdx.x;
  // scores: rows 4 tr + i, keys tc + 16 j; sums: keys 4 kg + kk,
  // columns g * 64 + 4 dc + u
  const int tr = tid / 16, tc = tid % 16;
  const int kg = tid / 16, dc = tid % 16;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  stage<T, D, kBlockK>(sm.k, k + bh * skv * D, k0, skv);
  stage<T, D, kBlockK>(sm.v, v + bh * skv * D, k0, skv);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  const int n_q = (sq + kBlockQ - 1) / kBlockQ;
  // causal (Sq == Skv): q tiles above the key tile's first key are masked
  const int first = causal ? k0 / kBlockQ : 0;
  for (int t = first; t < n_q; ++t) {
    const int q0 = t * kBlockQ;
    stage<T, D, kBlockQ>(sm.q, q + bh * sq * D, q0, sq);
    stage<T, D, kBlockQ>(sm.o, dout + bh * sq * D, q0, sq);
    stage_rows(sm.lse2, sm.delta, lse + bh * sq, delta + bh * sq, q0, sq);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(sm.q, sm.o, sm.k, sm.v, tr, tc, s, dp);
    probs(s, dp, sm.lse2, sm.delta, q0, k0, tr, tc, sq, skv, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sm.p[4 * tr + i][tc + 16 * j] = s[i][j];
        sm.ds[4 * tr + i][tc + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // dV += P^T dout, dK += dS^T q over the tile's rows, in order
#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sm.p[r][4 * kg]);
      const float4 d4 = *reinterpret_cast<const float4*>(&sm.ds[r][4 * kg]);
      const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dk4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 o4 =
            *reinterpret_cast<const float4*>(&sm.o[r][g * 64 + 4 * dc]);
        const float4 q4 =
            *reinterpret_cast<const float4*>(&sm.q[r][g * 64 + 4 * dc]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_v[kk][4 * g + 0] = fmaf(pk[kk], o4.x, acc_v[kk][4 * g + 0]);
          acc_v[kk][4 * g + 1] = fmaf(pk[kk], o4.y, acc_v[kk][4 * g + 1]);
          acc_v[kk][4 * g + 2] = fmaf(pk[kk], o4.z, acc_v[kk][4 * g + 2]);
          acc_v[kk][4 * g + 3] = fmaf(pk[kk], o4.w, acc_v[kk][4 * g + 3]);
          acc_k[kk][4 * g + 0] = fmaf(dk4[kk], q4.x, acc_k[kk][4 * g + 0]);
          acc_k[kk][4 * g + 1] = fmaf(dk4[kk], q4.y, acc_k[kk][4 * g + 1]);
          acc_k[kk][4 * g + 2] = fmaf(dk4[kk], q4.z, acc_k[kk][4 * g + 2]);
          acc_k[kk][4 * g + 3] = fmaf(dk4[kk], q4.w, acc_k[kk][4 * g + 3]);
        }
      }
    }
    __syncthreads();  // the q, dout, P and dS tiles are consumed
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = k0 + 4 * kg + kk;
    if (key >= skv) continue;
    T* dkr = dk + (bh * skv + key) * D;
    T* dvr = dv + (bh * skv + key) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const int c = g * 64 + 4 * dc;
      store4(dkr + c, acc_k[kk][4 * g + 0], acc_k[kk][4 * g + 1],
             acc_k[kk][4 * g + 2], acc_k[kk][4 * g + 3]);
      store4(dvr + c, acc_v[kk][4 * g + 0], acc_v[kk][4 * g + 1],
             acc_v[kk][4 * g + 2], acc_v[kk][4 * g + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int skv, float scale, int causal) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  QTiles<D>& sm = *reinterpret_cast<QTiles<D>*>(smem);
  const int tid = threadIdx.x;
  // scores: rows 4 tr + i, keys tc + 16 j; sums: rows 4 rg + i,
  // columns g * 64 + 4 dc + u
  const int tr = tid / 16, tc = tid % 16;
  const int rg = tid / 16, dc = tid % 16;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest first
  stage<T, D, kBlockQ>(sm.q, q + bh * sq * D, q0, sq);
  stage<T, D, kBlockQ>(sm.o, dout + bh * sq * D, q0, sq);
  stage_rows(sm.lse2, sm.delta, lse + bh * sq, delta + bh * sq, q0, sq);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  // causal (Sq == Skv): key tiles past the q tile's last row are masked
  const int kv_end = causal ? min(skv, q0 + kBlockQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    stage<T, D, kBlockK>(sm.k, k + bh * skv * D, k0, skv);
    stage<T, D, kBlockK>(sm.v, v + bh * skv * D, k0, skv);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(sm.q, sm.o, sm.k, sm.v, tr, tc, s, dp);
    probs(s, dp, sm.lse2, sm.delta, q0, k0, tr, tc, sq, skv, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.dst[tc + 16 * j][4 * tr + i] = dp[i][j];
    __syncthreads();

    // dQ += dS K over the tile's keys, in order
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      const float4 d4 = *reinterpret_cast<const float4*>(&sm.dst[key][4 * rg]);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(&sm.k[key][g * 64 + 4 * dc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(dr[i], k4.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(dr[i], k4.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(dr[i], k4.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(dr[i], k4.w, acc[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();  // the K, V and dS tiles are consumed
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= sq) continue;
    T* dqr = dq + (bh * sq + row) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const int c = g * 64 + 4 * dc;
      store4(dqr + c, acc[i][4 * g + 0], acc[i][4 * g + 1],
             acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         long long bh, int sq, cudaStream_t stream) {
  const long long rows = bh * sq;
  const long long warps = kThreads / 32;
  delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                       stream>>>(static_cast<const T*>(out),
                                 static_cast<const T*>(dout),
                                 static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

// fp32: delta, dK / dV, dQ
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, long long bh,
                   int sq, int skv, float scale, int causal,
                   cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdl = static_cast<float*>(delta);

  cudaError_t err = launch_delta<T, D>(out, dout, delta, bh, sq, stream);
  if (err != cudaSuccess) return err;

  const int smem_kv = (int)sizeof(KvTiles<D>);
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)bh, (unsigned)((skv + kBlockK - 1) / kBlockK));
  dkdv_kernel<T, D><<<grid_kv, kThreads, smem_kv, stream>>>(
      tq, tk, tv, tdo, flse, fdl, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, skv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = (int)sizeof(QTiles<D>);
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)bh, (unsigned)((sq + kBlockQ - 1) / kBlockQ));
  dq_kernel<T, D><<<grid_q, kThreads, smem_q, stream>>>(
      tq, tk, tv, tdo, flse, fdl, static_cast<T*>(dq), sq, skv, scale,
      causal);
  return cudaGetLastError();
}


// ------------------------------------------------------------------ bf16
constexpr int kBfDkvBlockK = 128;  // keys a dK / dV block: 2 consumers x 64
constexpr int kBfDkvBlockQ = 64;   // q rows a tile of the dK / dV ring
constexpr int kBfDqBlockQ = 128;   // q rows a dQ block: 2 consumers x 64
constexpr int kBfDqBlockK = 64;    // keys a tile of the dQ ring
constexpr int kBfStages = 2;       // stages of a ring
constexpr int kBfThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kBox = 64;           // bf16 columns of a 128-byte swizzled box

// Shared memory of a block, from a 1024-byte aligned base (128-byte swizzle
// repeats every 8 rows of 128 B); a tile is [D / 64][rows][64].
// dK / dV: K, V [128 keys], then per stage q, dout [64 rows], then per
// stage the rows' lse (log2 units) and delta [64 each], then the barriers.
template <int D>
struct DkvLayout {
  static constexpr int kKvTile = kBfDkvBlockK * D * 2;  // one of K, V
  static constexpr int kRowTile = kBfDkvBlockQ * D * 2; // one of q, dout
  static constexpr int kK = 0;
  static constexpr int kV = kKvTile;
  static constexpr int kStage = 2 * kKvTile;
  static constexpr int kStageBytes = 2 * kRowTile;
  static constexpr int kRows = kStage + kBfStages * kStageBytes;
  static constexpr int kBars = kRows + kBfStages * 2 * kBfDkvBlockQ * 4;
  // K and V, full [stages], empty [stages]
  static constexpr int kBytes = kBars + (1 + 2 * kBfStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// dQ: q, dout [128 rows], then per stage K, V [64 keys], then the barriers
template <int D>
struct DqLayout {
  static constexpr int kRowTile = kBfDqBlockQ * D * 2;  // one of q, dout
  static constexpr int kKvTile = kBfDqBlockK * D * 2;   // one of K, V
  static constexpr int kQ = 0;
  static constexpr int kO = kRowTile;
  static constexpr int kStage = 2 * kRowTile;
  static constexpr int kStageBytes = 2 * kKvTile;
  static constexpr int kBars = kStage + kBfStages * kStageBytes;
  // q and dout, full [stages], empty [stages]
  static constexpr int kBytes = kBars + (1 + 2 * kBfStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// whether the barrier's phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_done(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A producer's wait: spin until the phase has completed; a wait that never
// ends (consumers stuck) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, int parity) {
  for (uint32_t spins = 0; !mbar_done(bar, parity); ++spins)
    if (spins == (1u << 30)) __trap();
}

// A consumer's wait, without the trap: a trap path inside the consumers'
// loop keeps ptxas from giving them the registers setmaxnreg grants (it
// spilled dK / dV and serialized the wgmmas). A lost copy still ends the
// kernel through the producer's trapping wait on the stage it would
// refill, where there is one.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory; the barrier's transaction count drops by the box's bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the D / 64 boxes of rows [r0, r0 + rows) of one bh into a tile at dst
template <int D, int kRows>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < D / kBox; ++c)
    tma_load_3d(dst + c * kRows * 128, map, bar, c * kBox, r0, bh);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | ((uint64_t)1 << 62);
}

// the descriptor offset (16-byte units) of k-step kk (16 columns of D) of a
// K-major tile whose 64-column boxes hold `rows` rows
__device__ __forceinline__ constexpr uint64_t kstep(int kk, int rows) {
  return (uint64_t)(((kk / 4) * rows * 128 + (kk % 4) * 32) / 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// two floats rounded to bf16; `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d[32] += A[64 x 16] * B[16 x 64], A and B K-major in shared memory
// (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[32] = A[64 x 16] * B[16 x 64], the first k-step of a product: d is
// only written, so its earlier values need no register while it runs
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// d[32] += A[64 x 16] * B[16 x 64], A in registers, B MN-major in shared
// memory (128-byte swizzle; the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A[64 x 16] * B[16 x 128], A in registers, B MN-major in shared
// memory (128-byte swizzle; the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait that retires it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Accumulator fragments of an m64nNk16 product, per warp w of the
// warpgroup, with g = lane / 4 and t = lane % 4: d[4 n + e] is row
// 16 w + g + 8 (e / 2), column 8 n + 2 t + e % 2. The register A fragment of
// a 16-column slice kk is {d[8 kk + 0, 1], d[8 kk + 2, 3], d[8 kk + 4, 5],
// d[8 kk + 6, 7]} packed in pairs: rows g, g + 8 at columns 2t, 2t + 8.
//
// The helpers below take a 64 x 64 tile in that layout; the thread's
// element (n, e) is row 8 (e / 2) of its pair, column 8 n + 2 t + e % 2.

// P in place of the scores s (raw q.k): exp2(s * sl2 - lse2(n, e)), 0
// where `keep(n, e)` fails (asked only when `edge`)
template <typename Lse, typename Keep>
__device__ __forceinline__ void probs(float (&s)[32], float sl2, bool edge,
                                      Lse lse2, Keep keep) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * n + e], sl2, -lse2(n, e)));
      s[4 * n + e] = edge && !keep(n, e) ? 0.f : p;
    }
}

// dS = P * (dP - delta(n, e)) * scale in place of dp
template <typename Delta>
__device__ __forceinline__ void dscores(const float (&p)[32], float (&dp)[32],
                                        float scale, Delta delta) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * n + e] = p[4 * n + e] * (dp[4 * n + e] - delta(n, e)) * scale;
}

// the tile rounded to bf16 register A fragments, one per 16-column slice
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_rn(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// dK / dV of one 128-key tile. Consumer cw owns keys k0 + 64 cw .. + 63;
// its products are transposed (keys as rows), so P^T and dS^T come out in
// the accumulator layout that is the A fragment of dV += P^T dout and
// dK += dS^T q.
template <int D>
__global__ void __launch_bounds__(kBfThreads, 1)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int sq, int skv,
                 float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int kRowBox = kBfDkvBlockQ * 128;  // bytes of a 64-column box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows_sm =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t kvbar = base + L::kBars, full = kvbar + 8;
  const uint32_t empty = full + 8 * kBfStages;
  // the warpgroup, warp-uniform as ptxas sees it (setmaxnreg needs that)
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBfDkvBlockK;
  const int n_q = (sq + kBfDkvBlockQ - 1) / kBfDkvBlockQ;
  // causal (Sq == Skv): q tiles above the key tile's first key are masked
  const int first = causal ? k0 / kBfDkvBlockQ : 0;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < kBfStages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);  // the copies' thread + the rows' warp
      mbar_init(empty + 8 * st, 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {  // every copy
      mbar_expect_tx(kvbar, 2 * L::kKvTile);
      tma_tile<D, kBfDkvBlockK>(base + L::kK, &kmap, kvbar, k0, bh);
      tma_tile<D, kBfDkvBlockK>(base + L::kV, &vmap, kvbar, k0, bh);
      for (int j = first; j < n_q; ++j) {
        const int st = (j - first) % kBfStages;
        const int round = (j - first) / kBfStages;
        // a stage's previous tile must be consumed first
        if (round > 0) mbar_wait_or_trap(empty + 8 * st, (round - 1) & 1);
        const uint32_t qs = base + L::kStage + st * L::kStageBytes;
        mbar_expect_tx(full + 8 * st, 2 * L::kRowTile);
        tma_tile<D, kBfDkvBlockQ>(qs, &qmap, full + 8 * st,
                                  j * kBfDkvBlockQ, bh);
        tma_tile<D, kBfDkvBlockQ>(qs + L::kRowTile, &omap, full + 8 * st,
                                  j * kBfDkvBlockQ, bh);
      }
    } else if (tid / 32 == 1) {  // the rows' lse (log2 units) and delta
      const int lane = tid % 32;
      const float* lb = lse + (int64_t)bh * sq;
      const float* db = delta + (int64_t)bh * sq;
      for (int j = first; j < n_q; ++j) {
        const int st = (j - first) % kBfStages;
        const int round = (j - first) / kBfStages;
        if (round > 0) mbar_wait_or_trap(empty + 8 * st, (round - 1) & 1);
        float* r = rows_sm + st * 2 * kBfDkvBlockQ;
#pragma unroll
        for (int h = 0; h < kBfDkvBlockQ / 32; ++h) {
          const int row = j * kBfDkvBlockQ + 32 * h + lane;
          const bool in = row < sq;  // rows past sq are masked
          r[32 * h + lane] = in ? lb[row] * kLog2e : 0.f;
          r[kBfDkvBlockQ + 32 * h + lane] = in ? db[row] : 0.f;
        }
        mbar_arrive(full + 8 * st);  // each lane: its stores are released
      }
    }
    return;
  }

  // ---- consumers: per q tile S^T, P^T, dP^T, dS^T, then the dV and dK
  // products, each product waited for before the next step
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  const int kc0 = k0 + 64 * cw;                  // the consumer's first key
  const int key0 = kc0 + 16 * warp + lane / 4;   // keys key0 and key0 + 8
  const float sl2 = scale * kLog2e;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[32], dp[32];  // written by the first k-step of each product
  uint32_t pa[4][4], da[4][4];  // P^T and dS^T of the tile, bf16 pairs
  mbar_wait(kvbar, 0);

  // Descriptors: the bases are made opaque before each product's
  // wgmma.fence and advanced by constant offsets, so no k-step's address
  // is computed inside the wgmma pipeline stage.
  const uint64_t kdesc = smem_desc(base + L::kK + cw * 64 * 128, 16, 1024);
  const uint64_t vdesc = smem_desc(base + L::kV + cw * 64 * 128, 16, 1024);
  for (int j = first; j < n_q; ++j) {
    const int st = (j - first) % kBfStages;
    const int parity = ((j - first) / kBfStages) & 1;
    const int r0 = j * kBfDkvBlockQ;
    mbar_wait(full + 8 * st, parity);
    if (causal && r0 + kBfDkvBlockQ - 1 < kc0) {  // every key above every row
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      continue;
    }
    const uint32_t qs = base + L::kStage + st * L::kStageBytes;
    const uint32_t os = qs + L::kRowTile;

    // S^T = K_c q^T: 64 keys x 64 rows, k-steps of 16 columns of D
    uint64_t kd = kdesc, qd = smem_desc(qs, 16, 1024);
    asm volatile("" : "+l"(kd), "+l"(qd));
    wgmma_fence();
    wgmma_ss_n64_first(s, kd, qd);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kd + kstep(kk, kBfDkvBlockK),
                   qd + kstep(kk, kBfDkvBlockQ));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // P^T: element (key0 + 8 (e / 2), row r0 + 8 n + 2 t + e % 2)
    const bool edge =  // the diagonal and ragged tiles
        r0 + kBfDkvBlockQ > sq || kc0 + 64 > skv || (causal && kc0 + 63 > r0);
    const float* rl = rows_sm + st * 2 * kBfDkvBlockQ;  // lse2, then delta
    probs(
        s, sl2, edge, [&](int n, int e) { return rl[8 * n + 2 * t + (e & 1)]; },
        [&](int n, int e) {
          const int key = key0 + 8 * (e >> 1);
          const int row = r0 + 8 * n + 2 * t + (e & 1);
          return row < sq && key < skv && (!causal || key <= row);
        });

    // dP^T = V_c dout^T
    uint64_t vd = vdesc, od = smem_desc(os, 16, 1024);
    asm volatile("" : "+l"(vd), "+l"(od));
    wgmma_fence();
    wgmma_ss_n64_first(dp, vd, od);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, vd + kstep(kk, kBfDkvBlockK),
                   od + kstep(kk, kBfDkvBlockQ));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dp);
    dscores(s, dp, scale, [&](int n, int e) {
      return rl[kBfDkvBlockQ + 8 * n + 2 * t + (e & 1)];
    });
    to_frags(s, pa);
    to_frags(dp, da);

    // dV_c += P^T dout, dK_c += dS^T q: dout and q MN-major, 16 rows (2 KB)
    // a k-step
    uint64_t ot = smem_desc(os, kRowBox, 1024);
    uint64_t qt = smem_desc(qs, kRowBox, 1024);
    asm volatile("" : "+l"(ot), "+l"(qt));
    reg_fence(dva);
    reg_fence(dka);
    reg_fence(pa);
    reg_fence(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBfDkvBlockQ / 16; ++kk)
      wgmma_rs(dva, pa[kk], ot + (uint64_t)(kk * 16 * 128 / 16));
#pragma unroll
    for (int kk = 0; kk < kBfDkvBlockQ / 16; ++kk)
      wgmma_rs(dka, da[kk], qt + (uint64_t)(kk * 16 * 128 / 16));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dva);
    reg_fence(dka);
    reg_fence(pa);
    reg_fence(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done
  }

  __nv_bfloat16* dkb = dk + (int64_t)bh * skv * D;
  __nv_bfloat16* dvb = dv + (int64_t)bh * skv * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= skv) continue;
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key * D + c) =
          pack_rn(dka[4 * n + 2 * h], dka[4 * n + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key * D + c) =
          pack_rn(dva[4 * n + 2 * h], dva[4 * n + 2 * h + 1]);
    }
  }
}

// dQ of one 128-row q tile. Consumer cw owns rows q0 + 64 cw .. + 63.
template <int D>
__global__ void __launch_bounds__(kBfThreads, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap omap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int sq, int skv, float scale,
               int causal) {
  using L = DqLayout<D>;
  constexpr int kKvBox = kBfDqBlockK * 128;  // bytes of a 64-column box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qbar = base + L::kBars, full = qbar + 8;
  const uint32_t empty = full + 8 * kBfStages;
  // the warpgroup, warp-uniform as ptxas sees it (setmaxnreg needs that)
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBfDqBlockQ;  // longest first
  // causal (Sq == Skv): key tiles past the q tile's last row are masked
  const int kv_end = causal ? min(skv, q0 + kBfDqBlockQ) : skv;
  const int n_tiles = (kv_end + kBfDqBlockK - 1) / kBfDqBlockK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kBfStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * L::kRowTile);
      tma_tile<D, kBfDqBlockQ>(base + L::kQ, &qmap, qbar, q0, bh);
      tma_tile<D, kBfDqBlockQ>(base + L::kO, &omap, qbar, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBfStages, round = j / kBfStages;
        if (round > 0) mbar_wait_or_trap(empty + 8 * st, (round - 1) & 1);
        const uint32_t ks = base + L::kStage + st * L::kStageBytes;
        mbar_expect_tx(full + 8 * st, 2 * L::kKvTile);
        tma_tile<D, kBfDqBlockK>(ks, &kmap, full + 8 * st, j * kBfDqBlockK,
                                 bh);
        tma_tile<D, kBfDqBlockK>(ks + L::kKvTile, &vmap, full + 8 * st,
                                 j * kBfDqBlockK, bh);
      }
    }
    return;
  }

  // ---- consumers: per key tile S, P, dP, dS, then dQ += dS K
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  const int row_lo = q0 + 64 * cw;
  const int r0 = row_lo + 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];  // rows past sq are masked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool in = row < sq;
    lse2[h] = in ? lse[(int64_t)bh * sq + row] * kLog2e : 0.f;
    dl[h] = in ? delta[(int64_t)bh * sq + row] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float s[32], dp[32];  // written by the first k-step of each product
  uint32_t da[4][4];  // dS of the tile, bf16 pairs
  mbar_wait(qbar, 0);

  const uint64_t qdesc = smem_desc(base + L::kQ + cw * 64 * 128, 16, 1024);
  const uint64_t odesc = smem_desc(base + L::kO + cw * 64 * 128, 16, 1024);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kBfStages, parity = (j / kBfStages) & 1;
    const int kt0 = j * kBfDqBlockK;
    mbar_wait(full + 8 * st, parity);
    if (causal && kt0 > row_lo + 63) {  // every key above every row
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      continue;
    }
    const uint32_t ks = base + L::kStage + st * L::kStageBytes;
    const uint32_t vs = ks + L::kKvTile;

    // S = q_c K^T: 64 rows x 64 keys
    uint64_t qd = qdesc, kd = smem_desc(ks, 16, 1024);
    asm volatile("" : "+l"(qd), "+l"(kd));
    wgmma_fence();
    wgmma_ss_n64_first(s, qd, kd);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64(s, qd + kstep(kk, kBfDqBlockQ),
                   kd + kstep(kk, kBfDqBlockK));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // P: element (row r0 + 8 (e / 2), key kt0 + 8 n + 2 t + e % 2)
    const bool edge = row_lo + 64 > sq || kt0 + kBfDqBlockK > skv ||
                      (causal && kt0 + kBfDqBlockK - 1 > row_lo);
    probs(
        s, sl2, edge, [&](int n, int e) { return lse2[e >> 1]; },
        [&](int n, int e) {
          const int row = r0 + 8 * (e >> 1);
          const int key = kt0 + 8 * n + 2 * t + (e & 1);
          return row < sq && key < skv && (!causal || key <= row);
        });

    // dP = dout_c V^T, then dS
    uint64_t od = odesc, vd = smem_desc(vs, 16, 1024);
    asm volatile("" : "+l"(od), "+l"(vd));
    wgmma_fence();
    wgmma_ss_n64_first(dp, od, vd);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, od + kstep(kk, kBfDqBlockQ),
                   vd + kstep(kk, kBfDqBlockK));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dp);
    dscores(s, dp, scale, [&](int n, int e) { return dl[e >> 1]; });
    to_frags(dp, da);

    // dQ_c += dS K: K MN-major, 16 keys (2 KB) a k-step
    uint64_t kt = smem_desc(ks, kKvBox, 1024);
    asm volatile("" : "+l"(kt));
    reg_fence(dqa);
    reg_fence(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBfDqBlockK / 16; ++kk)
      wgmma_rs(dqa, da[kk], kt + (uint64_t)(kk * 16 * 128 / 16));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dqa);
    reg_fence(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done
  }

  __nv_bfloat16* dqb = dq + (int64_t)bh * sq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < sq)
        *reinterpret_cast<uint32_t*>(dqb + (int64_t)row * D + c) =
            pack_rn(dqa[4 * n + 2 * h], dqa[4 * n + 2 * h + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's lookup (no
// -lcuda); null when the driver does not have it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [bh, s, d] bf16 tensor as a 3-D map (dims d, s, bh), boxes of 64
// columns x `rows` rows x 1, 128-byte swizzle; reads past s are zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long bh, int s,
                       int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {kBox, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        long long bh, int sq, int skv, float scale,
                        int causal, cudaStream_t stream) {
  cudaError_t err =
      launch_delta<__nv_bfloat16, D>(out, dout, delta, bh, sq, stream);
  // dK / dV: q and dout in 64-row boxes, K and V in 128-row boxes; dQ:
  // q and dout in 128-row boxes, K and V in 64-row boxes
  CUtensorMap q_kv, o_kv, k_kv, v_kv, q_q, o_q, k_q, v_q;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int s, rows;
  } maps[] = {{&q_kv, q, sq, kBfDkvBlockQ}, {&o_kv, dout, sq, kBfDkvBlockQ},
              {&k_kv, k, skv, kBfDkvBlockK}, {&v_kv, v, skv, kBfDkvBlockK},
              {&q_q, q, sq, kBfDqBlockQ}, {&o_q, dout, sq, kBfDqBlockQ},
              {&k_q, k, skv, kBfDqBlockK}, {&v_q, v, skv, kBfDqBlockK}};
  for (const auto& m : maps)
    if (err == cudaSuccess) err = tensor_map(m.map, m.ptr, bh, m.s, D, m.rows);
  if (err != cudaSuccess) return err;
  const float* flse = static_cast<const float*>(lse);
  const float* fdl = static_cast<const float*>(delta);

  const int smem_kv = DkvLayout<D>::kAlloc;
  err = cudaFuncSetAttribute(dkdv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)bh,
                     (unsigned)((skv + kBfDkvBlockK - 1) / kBfDkvBlockK));
  dkdv_bf16_kernel<D><<<grid_kv, kBfThreads, smem_kv, stream>>>(
      q_kv, o_kv, k_kv, v_kv, flse, fdl, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, skv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = DqLayout<D>::kAlloc;
  err = cudaFuncSetAttribute(dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)bh,
                    (unsigned)((sq + kBfDqBlockQ - 1) / kBfDqBlockQ));
  dq_bf16_kernel<D><<<grid_q, kBfThreads, smem_q, stream>>>(
      q_q, o_q, k_q, v_q, flse, fdl, static_cast<__nv_bfloat16*>(dq), sq, skv,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, out, dout, dq [bh, sq, d]; k, v,
// dk, dv [bh, skv, d]; lse and the scratch delta [bh, sq] float32; all
// contiguous and 16-byte aligned; d in {64, 128}; causal needs sq == skv.
// Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        long long bh, long long sq, long long skv, int d,
                        int dtype, int causal, float scale, void* stream) {
  // the grid's second dimension: dQ blocks of q rows, dK / dV blocks of
  // keys
  const int block_q = dtype == 0 ? kBlockQ : kBfDqBlockQ;
  const int block_k = dtype == 0 ? kBlockK : kBfDkvBlockK;
  if (bh <= 0 || sq <= 0 || skv <= 0 || bh > 0x7fffffffLL ||
      sq > 0x7fffffffLL || skv > 0x7fffffffLL ||
      (sq + block_q - 1) / block_q > 65535 ||
      (skv + block_k - 1) / block_k > 65535 || (causal && sq != skv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isq = (int)sq, iskv = (int)skv;
  if (dtype == 0 && d == 64)
    return (int)launch<float, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                  bh, isq, iskv, scale, causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch<float, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, bh, isq, iskv, scale, causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_bf16<64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                bh, isq, iskv, scale, causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 bh, isq, iskv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
