// Flash attention forward (online softmax), CUDA C++ for sm_90a (Hopper).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body `_flash_kernel`). Same function: over folded
// [BH, Sq, D] queries and [BH, Skv, D] keys and values, scores q.k * (the
// `scale` the wrapper passes, 1/sqrt(D)) accumulated in fp32, masked to
// -1e30 above the diagonal (q_idx >= k_idx keeps a score) when `causal`, a
// running max, normaliser and accumulator in fp32, the unnormalised
// probabilities rounded to v's dtype before the PV product, and out = acc /
// max(l, 1e-30) in q's dtype. Sq and Skv may be anything: the ragged tail
// of the last tile is masked (keys past Skv get probability 0, rows past Sq
// are not stored), where the TPU kernel asserts divisibility. The wrapper
// only passes causal calls with Sq == Skv (kernels/flash_attention.py).
// With a non-null `lse` the kernel also stores each row's fp32 log-sum-exp
// of its scaled scores, m + log(max(l, 1e-30)) (the reference's `lse_blk`,
// src/repro/models/layers.py:_flash_fwd_inner), which the backward kernel
// (csrc/flash_attention_bwd.cu) reads to recompute the probabilities; a
// null pointer skips the store.
//
// Common design. One block per (128-row q tile, bh); the q tiles run
// longest first, so the blocks that walk the most key tiles start first on
// the causal path. The block walks the key tiles in order and keeps each
// row's running max, normaliser and output accumulator in registers. On the
// causal path the key tiles wholly above the block's last row are skipped:
// every score in them is masked, and a masked score adds exactly 0 once the
// first tile has given the row a real max (key 0 is never masked). No
// atomics: each output element has one writer, the key tiles are folded in
// a fixed order, and runs repeat bit for bit.
//
// bf16: wgmma fed by TMA. Three warpgroups: a producer and two consumers
// of 64 rows each (setmaxnreg: 40 / 232 registers a thread). The
// producer's elected thread loads the q tile, then every 128-key K and V
// tile, with cp.async.bulk.tensor from 3-D tensor maps over [BH, S, D]
// (dims D, S, BH: rows past S are zero-filled by the hardware and never
// read from the next bh), 128-byte swizzled, a D=128 row as two 64-column
// boxes. K and V each go through a ring of two stages with a full and an
// empty mbarrier per stage, so the copies of the next tile are in flight
// while the consumers run this tile's products. A consumer computes S =
// Q K^T with wgmma.m64n128k16 (Q and K K-major in shared memory), the
// online softmax on the accumulator fragments (a row's values sit on the 4
// lanes of a quad; only the diagonal and ragged tiles compare indices),
// rounds the unnormalised probabilities to bf16 straight into wgmma's
// register A fragments (the fp32 accumulator layout of an m64nNk16 product
// is the A layout of each 16-column slice), and adds O += P V with
// wgmma.m64nDk16, V read MN-major (D contiguous) through the transpose bit.
// Each product is waited for before the next step, so a consumer thread
// holds O (D / 2 registers), S (64) and P (32) and nothing more: with a
// second P or S live while a product runs, ptxas spilled them, which
// serializes the wgmmas. The two consumers drift apart instead, so one's
// softmax runs while the other's products hold the tensor cores.
//
// fp32: fp32 FMAs on the CUDA cores, no tensor core in any form. 256
// threads, 64-key tiles; K and V double-buffered with 16-byte cp.async.cg
// (the next tile lands while this one is computed). QK^T: a half warp owns
// 8 rows; each thread an 8 x 8 score micro-tile over every other 4-column
// chunk of D, summed with its pair by one shuffle (8 + 8 float4 loads per
// 256 FMAs: 4 FMAs a shared word). PV: each thread 8 rows x D/16 columns;
// the probabilities come from the row owners by shuffle, V as float4 (8
// FMAs a shared word).
//
// Bound. Causal prefill at qwen3-4b widths (BH 32, S 4096, D 128) does
// 4 * BH * D * S (S + 1) / 2 = 137.5 GFLOP: compute-bound, 0.139 ms at 989
// TFLOP/s bf16 and 2.05 ms at 67 TFLOP/s fp32 (H100 SXM); it moves 4 * BH *
// S * D elements (q, k, v read, out written), 0.13 GB in bf16, 0.04 ms.
//
// Plain C entry points, bound from Python with ctypes
// (kernels/flash_attention.py). The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// lookup, so the library needs no -lcuda. Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's masked score
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ fp32
constexpr int kF32BlockQ = 128;
constexpr int kF32BlockK = 64;
constexpr int kF32Threads = 256;  // 16 half warps x 8 rows

template <int D>
struct F32Tiles {
  static constexpr int kPad = D + 8;  // a row shift of 32 B: no bank conflict
  float q[kF32BlockQ][kPad];
  float k[2][kF32BlockK][kPad];
  float v[2][kF32BlockK][D];
};

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a [s, D] matrix into dst[rows][stride], 16 B a
// copy; rows past s are zeros
template <int D, int kRows, int kStride>
__device__ __forceinline__ void stage_rows(float (*dst)[kStride],
                                           const float* src, int r0, int s,
                                           int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int idx = tid; idx < kRows * kChunks; idx += kF32Threads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool valid = r0 + r < s;
    cp_async16(&dst[r][c], src + (int64_t)(valid ? r0 + r : 0) * D + c, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, float scale,
                 int causal) {
  constexpr int kPad = F32Tiles<D>::kPad;
  constexpr int kGroups = D / 64;  // float4 column groups of a PV thread
  extern __shared__ __align__(16) unsigned char smem[];
  F32Tiles<D>& sm = *reinterpret_cast<F32Tiles<D>*>(smem);
  const int tid = threadIdx.x, lane = tid % 32;
  const int rg = tid / 16;   // row group: rows rg * 8 .. rg * 8 + 7
  const int h = tid % 16;    // QK^T: keys kg + 8 j, d chunks dh, dh + 2, ..
  const int kg = h >> 1, dh = h & 1;  // PV: columns g * 64 + h * 4 + 0..3
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BlockQ;
  const int64_t bh = blockIdx.x;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * skv * D;
  const float* vb = v + bh * skv * D;

  const int kv_end = causal ? min(skv, q0 + kF32BlockQ) : skv;
  const int n_tiles = (kv_end + kF32BlockK - 1) / kF32BlockK;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  stage_rows<D, kF32BlockQ, kPad>(sm.q, qb, q0, sq, tid);
  stage_rows<D, kF32BlockK, kPad>(sm.k[0], kb, 0, skv, tid);
  stage_rows<D, kF32BlockK, D>(sm.v[0], vb, 0, skv, tid);
  cp_async_commit();

  float m[8], l[8], acc[8][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * kF32BlockK;
    if (t + 1 < n_tiles) {  // the buffer was released at the end of t - 1
      stage_rows<D, kF32BlockK, kPad>(sm.k[buf ^ 1], kb, k0 + kF32BlockK,
                                      skv, tid);
      stage_rows<D, kF32BlockK, D>(sm.v[buf ^ 1], vb, k0 + kF32BlockK, skv,
                                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s[i][j]: row rg * 8 + i, key k0 + kg + 8 j, over this thread's half
    // of the d chunks, then summed with the other half (lane ^ 1)
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = dh * 4; c < D; c += 8) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sm.q[rg * 8 + i][c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(&sm.k[buf][kg + 8 * j][c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        }
      }
    }

    // online softmax in log2 units (x = q.k * scale * log2(e)); a row's 64
    // keys sit on the 8 lane pairs of its half warp (both lanes of a pair
    // hold the same values). Masked scores (compared on the diagonal and
    // ragged tiles only) get probability 0, as the TPU kernel's -1e30 gives
    // once a row has a real max (key 0 is never masked).
    const bool edge = k0 + kF32BlockK > skv ||
                      (causal && k0 + kF32BlockK - 1 > q0 + rg * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] += __shfl_xor_sync(kFull, s[i][j], 1);
        if (edge) {
          const int key = k0 + kg + 8 * j;
          if (key >= skv || (causal && key > q0 + rg * 8 + i))
            s[i][j] = -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 2; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      mx = fmaxf(m[i], mx * sl2);  // scale > 0 keeps the order
      const float corr = exp2f(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], sl2, -mx));
        rs += s[i][j];
      }
      // a butterfly: every lane of the half warp ends with the same sum
#pragma unroll
      for (int o = 2; o < 16; o <<= 1) rs += __shfl_xor_sync(kFull, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= corr;
    }

    // acc[i][g * 4 + u] += sum_key p[row i][key] * v[key][g * 64 + h * 4 + u];
    // p[.][kk + 8 jj] is s[.][jj] of lane pair kk of the half warp
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int src = (lane & 16) | (kk * 2);
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = __shfl_sync(kFull, s[i][jj], src);
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              &sm.v[buf][kk + 8 * jj][g * 64 + h * 4]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][g * 4 + 0] = fmaf(p[i], w.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p[i], w.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p[i], w.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p[i], w.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed: tile t + 2 may land in it
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + rg * 8 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);  // a divide, as the TPU kernel
    // m is in log2 units; every lane of the half warp holds the row's m, l
    if (lse != nullptr && h == 0) lse[bh * sq + row] = m[i] * kLn2 + logf(den);
    float* orow = out + (bh * sq + row) * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      *reinterpret_cast<float4*>(orow + g * 64 + h * 4) = make_float4(
          acc[i][g * 4 + 0] / den, acc[i][g * 4 + 1] / den,
          acc[i][g * 4 + 2] / den, acc[i][g * 4 + 3] / den);
  }
}

// ------------------------------------------------------------------ bf16
constexpr int kBfBlockQ = 128;  // two consumer warpgroups x 64 rows
constexpr int kBfBlockK = 128;
constexpr int kBfStages = 2;    // stages of the K ring and of the V ring
constexpr int kBfThreads = 384; // producer warpgroup + 2 consumers
constexpr int kBox = 64;        // bf16 columns of a 128-byte swizzled box

// shared memory of one block, from a 1024-byte aligned base (128-byte
// swizzle repeats every 8 rows of 128 B): q [D / 64][128 rows][64], then per
// stage k and v [D / 64][128 keys][64], then the barriers
template <int D>
struct BfLayout {
  static constexpr int kQBytes = kBfBlockQ * D * 2;
  static constexpr int kTileBytes = kBfBlockK * D * 2;  // one of k, v
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kBfStages * kTileBytes;
  static constexpr int kBars = kV + kBfStages * kTileBytes;
  // K full, K empty, V full, V empty [stages], q
  static constexpr int kBytes = kBars + (4 * kBfStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
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

// spin until the barrier's phase of parity `parity` has completed; a wait
// that never ends (a lost copy) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
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

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// two floats rounded to bf16; `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d[32] += A[64 x 16] * B[16 x 64], A in registers, B MN-major in shared
// memory (128-byte swizzle; the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
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

// d[64] += A[64 x 16] * B[16 x 128], A and B K-major in shared memory
// (128-byte swizzle); the sum is zeroed first when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] += A[64 x 16] * B[16 x 128], A in registers, B MN-major in shared
// memory (128-byte swizzle; the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
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

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n64(d, a, b);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n128(d, a, b);
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One consumer's online softmax over a tile's scores s (raw q.k; 64 rows
// of the warpgroup x kBfBlockK keys), in log2 units: x = s * scale * log2(e).
// Updates the running max m and normaliser l of the thread's two rows,
// returns the rescale factors of the accumulator in corr and the
// unnormalised probabilities, rounded to bf16, as register A fragments.
// Masked scores (only compared when `edge`) get probability 0, as the
// TPU kernel's -1e30 gives once a row has a real max (key 0 is never
// masked, and the first tile holds it).
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBfBlockK / 2], uint32_t (&pa)[kBfBlockK / 16][4],
    float (&m)[2], float (&l)[2], float (&corr)[2], float sl2, bool edge,
    int k0, int skv, int causal, int r0, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kBfBlockK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        if (key >= skv || (causal && key > r0 + 8 * (e >> 1)))
          s[4 * n + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
    }
  }
  float rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r] * sl2);  // scale > 0 keeps the order
    corr[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    rs[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kBfBlockK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * n + e] = exp2f(fmaf(s[4 * n + e], sl2, -mx[e >> 1]));
      rs[e >> 1] += s[4 * n + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
    rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
    l[r] = l[r] * corr[r] + rs[r];
  }
#pragma unroll
  for (int kk = 0; kk < kBfBlockK / 16; ++kk) {
    pa[kk][0] = pack_rn(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_rn(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_rn(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_rn(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Accumulator fragments of an m64nNk16 product, per warp w of the
// warpgroup, with g = lane / 4 and t = lane % 4: d[4 n + e] is row
// 16 w + g + 8 (e / 2), column 8 n + 2 t + e % 2. The register A fragment of
// a 16-column slice kk is {d[8 kk + 0, 1], d[8 kk + 2, 3], d[8 kk + 4, 5],
// d[8 kk + 6, 7]} packed in pairs: rows g, g + 8 at columns 2t, 2t + 8.
template <int D>
__global__ void __launch_bounds__(kBfThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int sq, int skv, float scale, int causal) {
  using L = BfLayout<D>;
  constexpr int kChunkQ = kBfBlockQ * 128;  // bytes of a 64-column box
  constexpr int kChunkK = kBfBlockK * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, ks = base + L::kK, vs = base + L::kV;
  // barriers: K full, K empty, V full, V empty (a ring each), q
  const uint32_t kfull = base + L::kBars, kempty = kfull + 8 * kBfStages;
  const uint32_t vfull = kempty + 8 * kBfStages;
  const uint32_t vempty = vfull + 8 * kBfStages;
  const uint32_t qbar = vempty + 8 * kBfStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBfBlockQ;
  const int bh = blockIdx.x;
  const int kv_end = causal ? min(skv, q0 + kBfBlockQ) : skv;
  const int n_tiles = (kv_end + kBfBlockK - 1) / kBfBlockK;

  if (tid == 0) {
    for (int st = 0; st < kBfStages; ++st) {
      mbar_init(kfull + 8 * st, 1);
      mbar_init(vfull + 8 * st, 1);
      mbar_init(kempty + 8 * st, 8);  // one arrival per consumer warp
      mbar_init(vempty + 8 * st, 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < D / kBox; ++c)
        tma_load_3d(qs + c * kChunkQ, &qmap, qbar, c * kBox, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBfStages, round = j / kBfStages;
        // a stage's previous tile (j - kBfStages) must be consumed first
        if (round > 0) mbar_wait(kempty + 8 * st, (round - 1) & 1);
        mbar_expect_tx(kfull + 8 * st, L::kTileBytes);
        for (int c = 0; c < D / kBox; ++c)
          tma_load_3d(ks + st * L::kTileBytes + c * kChunkK, &kmap,
                      kfull + 8 * st, c * kBox, j * kBfBlockK, bh);
        if (round > 0) mbar_wait(vempty + 8 * st, (round - 1) & 1);
        mbar_expect_tx(vfull + 8 * st, L::kTileBytes);
        for (int c = 0; c < D / kBox; ++c)
          tma_load_3d(vs + st * L::kTileBytes + c * kChunkK, &vmap,
                      vfull + 8 * st, c * kBox, j * kBfBlockK, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows q0 + 64 cw .. + 63. Per tile:
  // S = Q K^T, the softmax, O += P V, each product waited for before the
  // next step; the two warpgroups drift apart, so one's softmax runs while
  // the other's products hold the tensor cores.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  const int row_lo = q0 + 64 * cw;
  const int r0 = row_lo + 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float s[kBfBlockK / 2];  // the first k-step of each S product zeroes it
#pragma unroll
  for (int i = 0; i < kBfBlockK / 2; ++i) s[i] = 0.f;
  uint32_t pa[kBfBlockK / 16][4];  // P of the tile, bf16 pairs
  mbar_wait(qbar, 0);

  // Descriptors: one base per operand, advanced by constant offsets in the
  // address bits (16-byte units). The bases are made opaque before each
  // product's wgmma.fence, so the compiler keeps no k-step's descriptor
  // live across the loop and computes none inside the wgmma pipeline stage
  // (which would serialize the wgmmas).
  const uint64_t qdesc = smem_desc(qs + cw * 64 * 128, 16, 1024);
  const uint64_t kdesc = smem_desc(ks, 16, 1024);
  const uint64_t vdesc = smem_desc(vs, kChunkK, 1024);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kBfStages, parity = (j / kBfStages) & 1;
    const int k0 = j * kBfBlockK;
    // S = Q K^T: 64 rows x 128 keys, k-steps of 16 columns of D (32 B a
    // k-step inside a 64-column box)
    mbar_wait(kfull + 8 * st, parity);
    uint64_t qd = qdesc, kd = kdesc + (uint64_t)(st * L::kTileBytes / 16);
    asm volatile("" : "+l"(qd), "+l"(kd));
    reg_fence(s);  // every definition of an operand before the fence
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(
          s, qd + (uint64_t)(((kk / 4) * kChunkQ + (kk % 4) * 32) / 16),
          kd + (uint64_t)(((kk / 4) * kChunkK + (kk % 4) * 32) / 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(kempty + 8 * st);  // this warp is done with K

    const bool edge =  // the diagonal and ragged tiles
        k0 + kBfBlockK > skv || (causal && k0 + kBfBlockK - 1 > row_lo);
    float corr[2];
    softmax_tile(s, pa, m, l, corr, sl2, edge, k0, skv, causal, r0, t);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }

    // O += P V: V MN-major, 16 keys (2 KB) a k-step
    mbar_wait(vfull + 8 * st, parity);
    uint64_t vd = vdesc + (uint64_t)(st * L::kTileBytes / 16);
    asm volatile("" : "+l"(vd));
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBfBlockK / 16; ++kk)
      wgmma_rs(o, pa[kk], vd + (uint64_t)(kk * 16 * 128 / 16));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty + 8 * st);  // this warp is done with V
  }

  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  // m is in log2 units; the 4 lanes of a quad hold the same rows' m, l
  if (lse != nullptr && t == 0) {
    float* lb = lse + (int64_t)bh * sq;
    if (r0 < sq) lb[r0] = m[0] * kLn2 + logf(d0);
    if (r0 + 8 < sq) lb[r0 + 8] = m[1] * kLn2 + logf(d1);
  }
  __nv_bfloat16* ob = out + (int64_t)bh * sq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * D + c) =
          pack_rn(o[4 * n + 0] / d0, o[4 * n + 1] / d0);
    if (r0 + 8 < sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)(r0 + 8) * D + c) =
          pack_rn(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, long long bh, int sq, int skv, float scale,
                       int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)bh, (unsigned)((sq + kF32BlockQ - 1) / kF32BlockQ));
  const int smem = (int)sizeof(F32Tiles<D>);
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, skv, scale, causal);
  return cudaGetLastError();
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
// columns x 128 rows x 1, 128-byte swizzle; reads past s are zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long bh, int s,
                       int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {kBox, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        void* lse, long long bh, int sq, int skv, float scale,
                        int causal, cudaStream_t stream) {
  static_assert(kBfBlockQ == 128 && kBfBlockK == 128, "one box shape");
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = tensor_map(&qmap, q, bh, sq, D);
  if (err == cudaSuccess) err = tensor_map(&kmap, k, bh, skv, D);
  if (err == cudaSuccess) err = tensor_map(&vmap, v, bh, skv, D);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (unsigned)((sq + kBfBlockQ - 1) / kBfBlockQ));
  const int smem = BfLayout<D>::kAlloc;
  auto kernel = flash_bf16_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBfThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), sq, skv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, out [bh, sq, d]; k, v [bh, skv, d],
// contiguous, 16-byte aligned; d in {64, 128}; lse [bh, sq] float32 or
// null (no store). Returns a cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    void* lse, long long bh, long long sq, long long skv, int d,
                    int dtype, int causal, float scale, void* stream) {
  const int block_q = dtype == 0 ? kF32BlockQ : kBfBlockQ;
  if (bh <= 0 || sq <= 0 || skv <= 0 || bh > 0x7fffffffLL ||
      sq > 0x7fffffffLL || skv > 0x7fffffffLL ||
      (sq + block_q - 1) / block_q > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isq = (int)sq, iskv = (int)skv;
  if (dtype == 0 && d == 64)
    return (int)launch_f32<64>(q, k, v, out, lse, bh, isq, iskv, scale,
                               causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch_f32<128>(q, k, v, out, lse, bh, isq, iskv, scale,
                                causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_bf16<64>(q, k, v, out, lse, bh, isq, iskv, scale,
                                causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128>(q, k, v, out, lse, bh, isq, iskv, scale,
                                 causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
