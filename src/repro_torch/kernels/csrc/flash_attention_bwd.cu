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
//   2. dK / dV: one block per (bh, 64-key tile). The block keeps its K
//      and V tile in shared memory and dK, dV in registers, and walks the
//      64-row q tiles in order (causal: from the diagonal tile on, the
//      tiles above it are wholly masked): it stages the tile's q, dout,
//      lse and delta, recomputes S and dout V^T, forms P and dS, and adds
//      P^T dout and dS^T q.
//   3. dQ: one block per (bh, 64-row q tile), the longest (causal: last)
//      tiles first. It keeps q, dout, lse and delta and dQ in registers,
//      walks the key tiles (causal: up to the diagonal), recomputes P and
//      dS the same way and adds dS K.
// Splitting dQ from dK / dV costs the second recompute of S and dout V^T
// (7 products of 2 Sq Skv D operations a head instead of 5) and keeps the
// kernel free of float atomics, whose order would change from run to run.
//
// Arithmetic. fp32 FMAs on the CUDA cores for both dtypes: every tile is
// widened to fp32 as it is staged in shared memory (rows padded by 4
// floats: 16-byte loads of neighbouring rows fall on other banks), and
// each thread owns a 4 x 4 micro-tile of S and dout V^T (rows 4 tr + i,
// keys tc + 16 j) and then 4 rows or keys x D / 16 columns of its
// accumulators (float4 loads, 8 to 10 FMAs a shared-memory word). Not
// the tensor cores: a first, simple version; `wgmma` is later work.
//
// Bound. Five products of 2 Sq Skv D operations a head (halved when
// causal): at the qwen3-4b step (BH 64, S 2048, D 128, causal) 172
// GFLOP, 0.17 ms at 989 TFLOP/s bf16 (H100 SXM; 2.6 ms at 67 TFLOP/s
// fp32, the units this version uses); it moves q, k, v, out, dout read
// once, dq, dk, dv written, lse and delta: 0.27 GB in bf16, 0.08 ms.
//
// Plain C entry point, bound from Python with ctypes
// (kernels/flash_attention.py). Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 fp32 values to 4 consecutive elements of global memory
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
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

  const long long rows = bh * sq;
  const long long warps = kThreads / 32;
  delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                       stream>>>(static_cast<const T*>(out), tdo, fdl, rows);
  cudaError_t err = cudaGetLastError();
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
  if (bh <= 0 || sq <= 0 || skv <= 0 || bh > 0x7fffffffLL ||
      sq > 0x7fffffffLL || skv > 0x7fffffffLL ||
      (sq + kBlockQ - 1) / kBlockQ > 65535 ||
      (skv + kBlockK - 1) / kBlockK > 65535 || (causal && sq != skv))
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
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, dout, lse, delta, dq,
                                          dk, dv, bh, isq, iskv, scale,
                                          causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, out, dout, lse, delta,
                                           dq, dk, dv, bh, isq, iskv, scale,
                                           causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
