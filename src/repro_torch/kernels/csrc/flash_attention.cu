// Flash attention forward (online softmax), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body `_flash_kernel`). Same function: over folded
// [BH, Sq, D] queries and [BH, Skv, D] keys and values, scores q.k * (the
// `scale` the wrapper passes, 1/sqrt(D)), masked to -1e30 above the
// diagonal (q_idx >= k_idx keeps a score) when `causal`, a running max,
// normaliser and accumulator in fp32, the unnormalised probabilities cast
// to v's dtype before the PV product, and out = acc / max(l, 1e-30) in q's
// dtype. Sq and Skv may be anything: the ragged tail of the last tile is
// masked (keys past Skv get probability 0, rows past Sq are not stored),
// where the TPU kernel asserts divisibility. The wrapper only passes causal
// calls with Sq == Skv (kernels/flash_attention.py).
//
// Design. One block per (q tile, bh); the q tiles run longest first, so the
// blocks that walk the most key tiles start first on the causal path. The
// block walks the key tiles in order, staging each K/V tile in shared
// memory, and keeps each row's running max, normaliser and output
// accumulator in registers. On the causal path the key tiles wholly above
// the block's last row are skipped: every score in them is masked, and a
// masked score adds exactly 0 once the first tile has given the row a real
// max (key 0 is never masked). No atomics: each output element has one
// writer, and runs repeat bit for bit.
//   - bf16: 4 warps x 16 rows, 64-key tiles. QK^T and PV run on the tensor
//     cores (mma.sync m16n8k16, fp32 accumulate). Q stays in registers as
//     A fragments; the QK^T accumulator fragments are, once exponentiated
//     and rounded to bf16, the A fragments of the PV product, so the
//     probabilities never leave registers.
//   - fp32: fp32 FMAs on the CUDA cores (never TF32). 16 x 16 threads, 64
//     rows x 32-key tiles; Q and K are staged transposed so a thread reads
//     its 4 rows and 2 keys as one float4 and one float2; the probabilities
//     go through shared memory (transposed) for the PV product.
//
// Bound. Causal prefill at qwen3-4b widths (BH 32, S 4096, D 128) does
// 4 * BH * S^2 * D / 2 = 137.4 GFLOP: compute-bound, 0.139 ms at 989
// TFLOP/s bf16 and 2.05 ms at 67 TFLOP/s fp32 (H100 SXM); it moves 4 * BH *
// S * D elements (q, k, v read, out written), 0.13 GB in bf16. This simple
// design has no TMA, no wgmma and no pipelining of the K/V loads behind the
// products: a later kernel's work.
//
// Plain C entry points, bound from Python with ctypes
// (kernels/flash_attention.py). Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's masked score

// ------------------------------------------------------------------ fp32
constexpr int kF32BlockQ = 64;
constexpr int kF32BlockK = 32;
constexpr int kF32Threads = 256;             // 16 (keys / cols) x 16 (rows)
constexpr int kF32StrideQ = kF32BlockQ + 4;  // transposed rows stay 16-B aligned
constexpr int kF32StrideK = kF32BlockK + 4;

template <int D>
struct F32Tiles {
  float qt[D][kF32StrideQ];          // q tile, transposed: qt[d][row]
  float kt[D][kF32StrideK];          // k tile, transposed: kt[d][key]
  float v[kF32BlockK][D];            // v tile
  float pt[kF32BlockK][kF32StrideQ]; // probabilities, transposed: pt[key][row]
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq,
                 int skv, float scale, int causal) {
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  F32Tiles<D>& sm = *reinterpret_cast<F32Tiles<D>*>(smem);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BlockQ;
  const int64_t bh = blockIdx.x;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * skv * D;
  const float* vb = v + bh * skv * D;

  for (int idx = tid; idx < kF32BlockQ * D / 4; idx += kF32Threads) {
    const int i = idx % kF32BlockQ, d = (idx / kF32BlockQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + i < sq)
      x = __ldg(reinterpret_cast<const float4*>(qb + (int64_t)(q0 + i) * D + d));
    sm.qt[d][i] = x.x;
    sm.qt[d + 1][i] = x.y;
    sm.qt[d + 2][i] = x.z;
    sm.qt[d + 3][i] = x.w;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kF32BlockQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kF32BlockK) {
    __syncthreads();  // the previous tile is consumed (q staged, first trip)
    for (int idx = tid; idx < kF32BlockK * D / 4; idx += kF32Threads) {
      const int j = idx % kF32BlockK, d = (idx / kF32BlockK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < skv)
        x = __ldg(reinterpret_cast<const float4*>(kb + (int64_t)(k0 + j) * D + d));
      sm.kt[d][j] = x.x;
      sm.kt[d + 1][j] = x.y;
      sm.kt[d + 2][j] = x.z;
      sm.kt[d + 3][j] = x.w;
    }
    for (int idx = tid; idx < kF32BlockK * D / 4; idx += kF32Threads) {
      const int j = idx / (D / 4), d = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < skv)
        x = __ldg(reinterpret_cast<const float4*>(vb + (int64_t)(k0 + j) * D + d));
      *reinterpret_cast<float4*>(&sm.v[j][d]) = x;
    }
    __syncthreads();

    // scores of rows ty*4 + r, keys tx*2 + c
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.qt[d][ty * 4]);
      const float2 b = *reinterpret_cast<const float2*>(&sm.kt[d][tx * 2]);
      s[0][0] = fmaf(a.x, b.x, s[0][0]);
      s[0][1] = fmaf(a.x, b.y, s[0][1]);
      s[1][0] = fmaf(a.y, b.x, s[1][0]);
      s[1][1] = fmaf(a.y, b.y, s[1][1]);
      s[2][0] = fmaf(a.z, b.x, s[2][0]);
      s[2][1] = fmaf(a.z, b.y, s[2][1]);
      s[3][0] = fmaf(a.w, b.x, s[3][0]);
      s[3][1] = fmaf(a.w, b.y, s[3][1]);
    }

    // online softmax; a row's 32 keys sit on the 16 lanes of a half warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + tx * 2 + c;
        float x = s[r][c] * scale;
        if (key >= skv) x = -INFINITY;  // past the end: not a key
        else if (causal && key > row) x = kMasked;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = expf(m[r] - mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[r][c] = expf(s[r][c] - mx);
        rs += s[r][c];
      }
      // a butterfly: every lane ends with the same sum
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[r] = l[r] * corr + rs;
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sm.pt[tx * 2][ty * 4 + r] = s[r][0];
      sm.pt[tx * 2 + 1][ty * 4 + r] = s[r][1];
    }
    __syncthreads();

    // acc[r][g*4 + u] += sum_j p[row r][j] * v[j][g*64 + tx*4 + u]
#pragma unroll 4
    for (int j = 0; j < kF32BlockK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&sm.pt[j][ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(&sm.v[j][g * 64 + tx * 4]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][g * 4 + 0] = fmaf(pr[r], w.x, acc[r][g * 4 + 0]);
          acc[r][g * 4 + 1] = fmaf(pr[r], w.y, acc[r][g * 4 + 1]);
          acc[r][g * 4 + 2] = fmaf(pr[r], w.z, acc[r][g * 4 + 2]);
          acc[r][g * 4 + 3] = fmaf(pr[r], w.w, acc[r][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);  // a divide, as the TPU kernel
    float* orow = out + (bh * sq + row) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(orow + g * 64 + tx * 4) = make_float4(
          acc[r][g * 4 + 0] / den, acc[r][g * 4 + 1] / den,
          acc[r][g * 4 + 2] / den, acc[r][g * 4 + 3] / den);
  }
}

// ------------------------------------------------------------------ bf16
constexpr int kBfBlockQ = 64;  // 4 warps x 16 rows
constexpr int kBfBlockK = 64;
constexpr int kBfThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16; `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// mma.sync m16n8k16 fragments, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major): regs {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//                                 (g+8, 2t+8..)}
//   B (16 x 8, k x n):      regs {(k 2t..2t+1, n g), (k 2t+8..2t+9, n g)}
//   C (16 x 8, fp32):       {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
template <int D>
__global__ void __launch_bounds__(kBfThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int sq, int skv,
                  float scale, int causal) {
  constexpr int kStride = D + 8;  // bf16 per staged row: conflict-free reads
  constexpr int kSteps = D / 16;  // k-steps of QK^T
  constexpr int kNd = D / 8;      // n-tiles of the output
  constexpr int kNk = kBfBlockK / 8;  // n-tiles of the scores
  __shared__ __align__(16) __nv_bfloat16 ks[kBfBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBfBlockK * kStride];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBfBlockQ;
  const int64_t bh = blockIdx.x;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * skv * D;
  const __nv_bfloat16* vb = v + bh * skv * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  uint32_t qa[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int c = st * 16 + 2 * t;
    const unsigned int* p0 = reinterpret_cast<const unsigned int*>(qb + (int64_t)r0 * D + c);
    const unsigned int* p1 = reinterpret_cast<const unsigned int*>(qb + (int64_t)r1 * D + c);
    qa[st][0] = r0 < sq ? __ldg(p0) : 0u;
    qa[st][1] = r1 < sq ? __ldg(p1) : 0u;
    qa[st][2] = r0 < sq ? __ldg(p0 + 4) : 0u;  // columns c + 8, c + 9
    qa[st][3] = r1 < sq ? __ldg(p1 + 4) : 0u;
  }

  float acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  const int kv_end = causal ? min(skv, q0 + kBfBlockQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBfBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBfBlockK * D / 8; idx += kBfThreads) {
      const int j = idx / (D / 8), c = (idx % (D / 8)) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + j < skv) {
        kx = __ldg(reinterpret_cast<const uint4*>(kb + (int64_t)(k0 + j) * D + c));
        vx = __ldg(reinterpret_cast<const uint4*>(vb + (int64_t)(k0 + j) * D + c));
      }
      *reinterpret_cast<uint4*>(ks + j * kStride + c) = kx;
      *reinterpret_cast<uint4*>(vs + j * kStride + c) = vx;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kNk][4];
#pragma unroll
    for (int n = 0; n < kNk; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int n = 0; n < kNk; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * kStride + st * 16 + 2 * t;
        mma_bf16(s[n], qa[st], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, running max (a row's keys sit on the 4 lanes of a group)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kNk; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (key >= skv) x = -INFINITY;  // past the end: not a key
        else if (causal && key > row) x = kMasked;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNk; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V, with P rounded to bf16 (the TPU kernel's p.astype(v.dtype))
#pragma unroll
    for (int kk = 0; kk < kBfBlockK / 16; ++kk) {
      const uint32_t pa[4] = {pack_rn(s[2 * kk][0], s[2 * kk][1]),
                              pack_rn(s[2 * kk][2], s[2 * kk][3]),
                              pack_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_rn(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        mma_bf16(acc[n], pa, pack_raw(vc[0], vc[kStride]),
                 pack_raw(vc[8 * kStride], vc[9 * kStride]));
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(out + (bh * sq + r0) * D + c) =
          pack_rn(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(out + (bh * sq + r1) * D + c) =
          pack_rn(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       long long bh, int sq, int skv, float scale, int causal,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)bh, (unsigned)((sq + kF32BlockQ - 1) / kF32BlockQ));
  const int smem = (int)sizeof(F32Tiles<D>);
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        long long bh, int sq, int skv, float scale, int causal,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)bh, (unsigned)((sq + kBfBlockQ - 1) / kBfBlockQ));
  flash_bf16_kernel<D><<<grid, kBfThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, skv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, out [bh, sq, d]; k, v [bh, skv, d],
// contiguous, 16-byte aligned; d in {64, 128}. Returns a cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    long long bh, long long sq, long long skv, int d,
                    int dtype, int causal, float scale, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || bh > 0x7fffffffLL ||
      sq > 0x7fffffffLL || skv > 0x7fffffffLL ||
      (sq + kF32BlockQ - 1) / kF32BlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isq = (int)sq, iskv = (int)skv;
  if (dtype == 0 && d == 64)
    return (int)launch_f32<64>(q, k, v, out, bh, isq, iskv, scale, causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch_f32<128>(q, k, v, out, bh, isq, iskv, scale, causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_bf16<64>(q, k, v, out, bh, isq, iskv, scale, causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128>(q, k, v, out, bh, isq, iskv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
