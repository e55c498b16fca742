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
// past Skv get P = 0, rows past Sq are zero and not stored). A causal call
// may take a band W > 0 (P kept where 0 <= q_idx - k_idx < W, the
// reference's _block_mask): dK / dV stop their walk over q tiles at the
// last row that sees the key tile, dQ starts its walk over key tiles at
// the first row's first key, and only the tiles on the band's edge compare
// indices. The head dim d is 64, 80 or 128: d = 80 runs the D = 128
// kernels on tensor maps of inner dim 80, which zero-fill columns 80-127,
// and stores d columns (the forward's scheme, csrc/flash_attention.cu).
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
// fp32: 3xTF32 on the tensor cores (mma.sync), fed by TMA. The CUDA cores'
// fp32 FMAs cap the seven products at 67 TFLOP/s; the tensor cores run
// TF32 (10 mantissa bits) at 495. Each fp32 operand x is split in
// registers into big, x rounded to tf32 (to nearest, ties away: what
// cvt.rna.tf32.f32 computes, in two integer instructions where ptxas
// expands cvt.rna into four), and small = x - big, exact in fp32, of which
// the tensor cores read the top 10 mantissa bits. A product is small.big
// + big.small + big.big (CUTLASS's OpMultiplyAddFastF32 split; it drops
// small.small, about 2^-22 of the product): three TF32 passes, 165 TFLOP/s
// of fp32-accurate products at best.
// Why mma.sync.m16n8k8 and not wgmma: wgmma has its transpose operand only
// for 16-bit types; with .tf32 both shared-memory operands must be
// K-major. Three of the seven products read B the other way (dV += P^T
// dout, dK += dS^T q, dQ += dS K), and wgmma would need a big and a small
// copy of every operand in shared memory plus transposed copies for those
// three: past 227 KB for a dK / dV block at D 128. mma.sync gathers its
// fragments with shared loads in either orientation from one fp32 tile
// and splits them in registers.
// Layout. Tiles come by cp.async.bulk.tensor from fp32 tensor maps (32
// columns, 128 bytes, a box: a D 128 row is four boxes, 128-byte swizzle)
// through a ring of kF32Stages stages (full and empty mbarriers, as in
// bf16). A producer warpgroup (one thread issues the copies) and two
// consumer warpgroups: eight warps of 16 keys (dK / dV) or 16 rows (dQ).
// Every fragment load is 8 bytes and applies the swizzle's XOR; a warp's
// loads fall on 32 distinct banks per half-warp (`Offsets`).
//   dK / dV (dkdv_f32_kernel): a block per 128-key tile, K and V resident;
//   32-row q / dout tiles stream, their rows' lse (times log2 e) and delta
//   copied by the producer warp's lanes. A consumer takes S^T = K_w q^T
//   (16 keys x 32 rows), forms P^T, adds dV_w += P^T dout, then takes dP^T
//   = V_w dout^T, forms dS^T and adds dK_w += dS^T q.
//   dQ (dq_f32_kernel): a block per 128-row q tile (the longest first), q
//   and dout resident; 32-key K / V tiles stream. S = q_w K^T, dP =
//   dout_w V^T, dQ_w += dS K.
// The accumulator is the next product's A fragment without a shuffle: an
// m16n8k8 accumulator lane holds columns (2t, 2t + 1) where A's lane holds
// k-slots (t, t + 4), so k-slot t of a step is taken as column 2t and slot
// t + 4 as column 2t + 1, and the B fragment reads the same rows (the sum
// over a step is the same). The score products likewise take each k-step's
// 8 columns of D in an order that puts a lane's two elements side by side.
// Rounding: the tensor cores add a step into an fp32 accumulator without
// rounding to nearest (they may truncate), so no long chain is kept
// there. A score's two k-steps (16 columns of D) go into a fresh
// accumulator, small terms first, added to the score in fp32; dV, dK and
// dQ take a tile's 32 rows or keys into two fresh accumulators, one for
// the big.big passes and one for the small terms, both added in fp32.
// Sums are taken in a fixed order, so a run repeats bit for bit. Ragged
// and diagonal tiles mask by index as in bf16.
// Registers: setmaxnreg gives the consumers 240 a thread (the producers
// 24). A dK / dV consumer holds dK and dV (D / 2 registers each) and ptxas
// fills the rest with loads it moves early; to leave nothing to spill, no
// value lives through a tile that need not: the lane is read anew where
// it is used (`lane_id`), dQ's rows' lse and delta are read from shared
// memory at each tile, P^T is taken back from its fragments after dV
// (neither is held through dP^T), and each role computes its tile range
// after setmaxnreg. The row length (kLd: D, or 80 in D = 128) and the band
// (kBand) are template parameters of the fp32 kernels: a runtime row
// length in the epilogue, and the band's bounds held through the tile
// loop, each made ptxas spill at D = 128, so the band-free kernels
// compile as they did without a band, and dK / dV reads its band's row
// end and width anew from shared memory at each tile. At D = 128 (kLd
// 128) even that spilled (4-64 bytes in every form tried): the fp32
// backward takes no band there, and the route sends such a call to the
// plain math (models/layers.py attention_route; no model has one).
//
// Bound. Five products of 2 Sq Skv D operations a head (halved when
// causal): at the qwen3-4b step 171.9 GFLOP, 0.174 ms at 989 TFLOP/s
// bf16 (H100 SXM); fp32 takes three TF32 passes of each at 495 TFLOP/s,
// 2.083 ms at row 3's fp32 shape [1, 32, 4096, 128] causal (5.13 ms on the
// CUDA cores at 67 TFLOP/s). The bytes: q, k, v, out, dout read once, dq,
// dk, dv written, lse and delta: 0.27 GB in bf16, 0.08 ms.
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

constexpr int kThreads = 256;  // the delta kernel's block: a warp a row
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[row] = sum_c out[row, c] * dout[row, c] in fp32, one warp a row
// of d
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f(out[row * d + c]), to_f(dout[row * d + c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         long long bh, int sq, int d, cudaStream_t stream) {
  const long long rows = bh * sq;
  const long long warps = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                    stream>>>(static_cast<const T*>(out),
                              static_cast<const T*>(dout),
                              static_cast<float*>(delta), rows, d);
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
                 __nv_bfloat16* __restrict__ dv, int sq, int skv, int d,
                 float scale, int causal, int band) {
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
  // causal (Sq == Skv): q tiles above the key tile's first key are masked,
  // and with a band so are the rows past its last key's band
  const int first = causal ? k0 / kBfDkvBlockQ : 0;
  const int rows_end =
      causal ? min(sq, k0 + kBfDkvBlockK - 1 + min(band, sq)) : sq;
  const int n_q = (rows_end + kBfDkvBlockQ - 1) / kBfDkvBlockQ;

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
    // every key above every row, or every row past every key's band
    if (causal && (r0 + kBfDkvBlockQ - 1 < kc0 || r0 - (kc0 + 63) >= band)) {
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
    const bool edge =  // the diagonal, ragged and band-edge tiles
        r0 + kBfDkvBlockQ > sq || kc0 + 64 > skv ||
        (causal && (kc0 + 63 > r0 || r0 + kBfDkvBlockQ - 1 - kc0 >= band));
    const float* rl = rows_sm + st * 2 * kBfDkvBlockQ;  // lse2, then delta
    probs(
        s, sl2, edge, [&](int n, int e) { return rl[8 * n + 2 * t + (e & 1)]; },
        [&](int n, int e) {
          const int key = key0 + 8 * (e >> 1);
          const int row = r0 + 8 * n + 2 * t + (e & 1);
          return row < sq && key < skv &&
                 (!causal || (key <= row && row - key < band));
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

  // d columns of a row of d
  __nv_bfloat16* dkb = dk + (int64_t)bh * skv * d;
  __nv_bfloat16* dvb = dv + (int64_t)bh * skv * d;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= skv) continue;
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key * d + c) =
          pack_rn(dka[4 * n + 2 * h], dka[4 * n + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key * d + c) =
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
               __nv_bfloat16* __restrict__ dq, int sq, int skv, int d,
               float scale, int causal, int band) {
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
  // causal (Sq == Skv): key tiles past the q tile's last row are masked,
  // and with a band so are those below its first row's band: the tiles
  // [j0, j0 + n_tiles)
  const int kv_end = causal ? min(skv, q0 + kBfDqBlockQ) : skv;
  const int j0 = causal ? max(0, q0 - band + 1) / kBfDqBlockK : 0;
  const int n_tiles = (kv_end + kBfDqBlockK - 1) / kBfDqBlockK - j0;

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
        tma_tile<D, kBfDqBlockK>(ks, &kmap, full + 8 * st,
                                 (j0 + j) * kBfDqBlockK, bh);
        tma_tile<D, kBfDqBlockK>(ks + L::kKvTile, &vmap, full + 8 * st,
                                 (j0 + j) * kBfDqBlockK, bh);
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
    const int kt0 = (j0 + j) * kBfDqBlockK;
    mbar_wait(full + 8 * st, parity);
    // every key above every row, or below every row's band
    if (causal &&
        (kt0 > row_lo + 63 || row_lo - (kt0 + kBfDqBlockK - 1) >= band)) {
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
                      (causal && (kt0 + kBfDqBlockK - 1 > row_lo ||
                                  row_lo + 63 - kt0 >= band));
    probs(
        s, sl2, edge, [&](int n, int e) { return lse2[e >> 1]; },
        [&](int n, int e) {
          const int row = r0 + 8 * (e >> 1);
          const int key = kt0 + 8 * n + 2 * t + (e & 1);
          return row < sq && key < skv &&
                 (!causal || (key <= row && row - key < band));
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

  __nv_bfloat16* dqb = dq + (int64_t)bh * sq * d;  // d columns of d
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < sq)
        *reinterpret_cast<uint32_t*>(dqb + (int64_t)row * d + c) =
            pack_rn(dqa[4 * n + 2 * h], dqa[4 * n + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------ fp32
constexpr int kF32DkvBlockK = 128;  // keys a dK / dV block: 8 warps x 16
constexpr int kF32DkvBlockQ = 32;   // q rows a tile of the dK / dV ring
constexpr int kF32DqBlockQ = 128;   // q rows a dQ block: 8 warps x 16
constexpr int kF32DqBlockK = 32;    // keys a tile of the dQ ring
constexpr int kF32Stages = 3;       // stages of a ring
// pairs of 8-column blocks of D that `accumulate` takes together
constexpr int kDkvPairs = 1;        // dK / dV (dK and dV hold 128 registers)
constexpr int kDqPairs = 2;         // dQ
constexpr int kF32Threads = 384;    // producer warpgroup + 2 consumers
// setmaxnreg: 128 x 24 + 256 x 240 = 64,512, the launch bound's 168 a thread
constexpr int kF32ProducerRegs = 24;
constexpr int kF32ConsumerRegs = 240;
constexpr int kF32Box = 32;         // fp32 columns of a 128-byte swizzled box

// Shared memory of a block, from a 1024-byte aligned base; a tile is
// [D / 32][rows][32] fp32. dK / dV: K, V [128 keys], then per stage q,
// dout [32 rows], then per stage the rows' lse (log2 units) and delta,
// then the barriers.
template <int D>
struct DkvF32Layout {
  static constexpr int kKvTile = kF32DkvBlockK * D * 4;   // one of K, V
  static constexpr int kRowTile = kF32DkvBlockQ * D * 4;  // one of q, dout
  static constexpr int kK = 0;
  static constexpr int kV = kKvTile;
  static constexpr int kStage = 2 * kKvTile;
  static constexpr int kStageBytes = 2 * kRowTile;
  static constexpr int kRows = kStage + kF32Stages * kStageBytes;
  static constexpr int kBars = kRows + kF32Stages * 2 * kF32DkvBlockQ * 4;
  // K and V, full [stages], empty [stages]
  static constexpr int kBytes = kBars + (1 + 2 * kF32Stages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// dQ: q, dout [128 rows], then per stage K, V [32 keys], then the rows'
// lse and delta, then the barriers
template <int D>
struct DqF32Layout {
  static constexpr int kRowTile = kF32DqBlockQ * D * 4;  // one of q, dout
  static constexpr int kKvTile = kF32DqBlockK * D * 4;   // one of K, V
  static constexpr int kQ = 0;
  static constexpr int kO = kRowTile;
  static constexpr int kStage = 2 * kRowTile;
  static constexpr int kStageBytes = 2 * kKvTile;
  // the rows' lse (log2 units), then their delta
  static constexpr int kRows = kStage + kF32Stages * kStageBytes;
  static constexpr int kBars = kRows + 2 * kF32DqBlockQ * 4;
  // q and dout, full [stages], empty [stages]
  static constexpr int kBytes = kBars + (1 + 2 * kF32Stages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// the D / 32 boxes of rows [r0, r0 + kRows) of one bh into a tile at dst
template <int D, int kRows>
__device__ __forceinline__ void tma_tile_f32(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < D / kF32Box; ++c)
    tma_load_3d(dst + c * kRows * 128, map, bar, c * kF32Box, r0, bh);
}

// Per-lane word offsets into a tile as TMA wrote it ([D / 32][rows][32]
// fp32, a row's 16-byte chunks XORed with row % 8: the 128-byte swizzle),
// g = lane / 4, t = lane % 4. Each is one 8-byte load whose two words fall,
// over the warp, on 32 distinct banks per half-warp.
//   pair ^ (c << 2), c < 4: a score k-step's two columns of row g. k-step
//     4 b + c of D takes the chunks c and c + 4 of box b: slot t is column
//     32 b + 16 (t / 2) + 4 c + 2 (t % 2), slot t + 4 the next one.
//   col[i] ^ (h << 4): columns 16 h + 2 g and 16 h + 2 g + 1 of row 2 t + i
//     of a box (h < 2): the n-index g of two column blocks of 8 (the
//     accumulators' n-index m of block p holds column 16 (p / 2) + 2 m +
//     p % 2).
// Box b adds b * rows * 32 words, a row that is a multiple of 8 r * 32.
struct Offsets {
  int pair, col[2];
};

// the lane, read anew at each call: what is made from it is not kept live
// through a tile (ptxas spilled such values at the register cap)
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return lane;
}

// a shared-memory word read anew at each use: a value the tile loop reads
// this way holds no register through it (the band's bounds, held, were
// spilled at the register cap)
__device__ __forceinline__ int read_anew(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ Offsets lane_offsets() {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  Offsets o;
  o.pair = 32 * g + (((4 * (t >> 1)) ^ g) << 2) + 2 * (t & 1);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    o.col[i] =
        64 * t + 32 * i + (((g >> 1) ^ (2 * t + i)) << 2) + 2 * (g & 1);
  return o;
}

// the stage of the i-th tile, computed anew where it is needed (a stage
// address held through a tile was spilled at the register cap)
__device__ __forceinline__ int stage_of(int i) {
  asm volatile("" : "+r"(i));
  return i % kF32Stages;
}

// x as big + small: big is x rounded to tf32 (to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite value: half a tf32 ulp added,
// the 13 low bits cleared; ptxas expands cvt.rna into twice as many
// instructions), small = x - big, exact in fp32, of which the tensor cores
// read the top 10 mantissa bits (CUTLASS's OpMultiplyAddFastF32 split)
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    s.small[i] = __float_as_uint(x[i] - __uint_as_float(s.big[i]));
  }
  return s;
}

// d[4] += A[16 x 8] * B[8 x 8], tf32 operands, fp32 accumulator. Lane
// (g, t): a = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (t, g),
// (t + 4, g); d = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[4] = A * B: a fresh accumulator, C given as zeros
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// A 16 x 32 score tile of one warp: acc[n][e] = sum_d A[g + 8 (e / 2)][d]
// * B[8 n + 2 t + e % 2][d], A the warp's 16 rows of a tile of kRowsA rows,
// B a tile of 32. Two k-steps (16 columns of D) at a time go into a fresh
// accumulator, the small terms first, added to acc in fp32. The k-steps
// are a loop, not unrolled: fewer registers live, smaller code.
template <int D, int kRowsA>
__device__ __forceinline__ void scores(float (&acc)[4][4], const float* A,
                                       const float* B) {
  const Offsets o = lane_offsets();
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
  for (int k = 0; k < D / 8; k += 2) {  // k-steps k and k + 1 of box k / 4
    const float* ab = A + (k >> 2) * kRowsA * 32;
    const float* bb = B + (k >> 2) * 32 * 32;
    int off[2];
    Split<4> a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      off[h] = o.pair ^ (((k & 3) + h) << 2);
      const float2 lo = *reinterpret_cast<const float2*>(ab + off[h]);
      const float2 hi = *reinterpret_cast<const float2*>(ab + 256 + off[h]);
      const float ax[4] = {lo.x, hi.x, lo.y, hi.y};
      a[h] = split(ax);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      Split<2> b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 y =
            *reinterpret_cast<const float2*>(bb + off[h] + 256 * n);
        const float bx[2] = {y.x, y.y};
        b[h] = split(bx);
      }
      float d[4];
      mma_tf32_first(d, a[0].small, b[0].big);
      mma_tf32(d, a[0].big, b[0].small);
      mma_tf32(d, a[1].small, b[1].big);
      mma_tf32(d, a[1].big, b[1].small);
      mma_tf32(d, a[0].big, b[0].big);
      mma_tf32(d, a[1].big, b[1].big);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
    }
  }
}

// The A fragments of a 16 x 32 score tile x in its accumulator layout
// (P^T, dS^T or dS), split: k-step j takes column 8 j + 2 t of x as slot t
// and 8 j + 2 t + 1 as slot t + 4, so x[j] is its own fragment.
__device__ __forceinline__ void a_frags(const float (&x)[4][4],
                                        Split<4> (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float ax[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
    a[j] = split(ax);
  }
}

// x[n][e] of the fragments again: big + small is x exactly
__device__ __forceinline__ float a_value(const Split<4> (&a)[4], int n,
                                         int e) {
  const int i = (e & 1) * 2 + (e >> 1);  // e 0, 1, 2, 3 -> 0, 2, 1, 3
  return __uint_as_float(a[n].big[i]) + __uint_as_float(a[n].small[i]);
}

// acc[n] += X B over a tile's 32 rows (or keys): X as its A fragments
// (`a_frags`), B [32][D] a tile of 32 rows. 2 kPairs column blocks of 8
// (16 kPairs columns of D, `col` of Offsets) go together. Each takes the
// tile's big.big passes into a fresh accumulator and its small terms into
// another (two independent chains of tensor-core steps), both added to
// acc in fp32.
template <int D, int kPairs>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const Split<4> (&a)[4],
                                           const float* B) {
  constexpr int kBlocks = 2 * kPairs;
  const Offsets o = lane_offsets();
#pragma unroll
  for (int n = 0; n < D / 8; n += kBlocks) {
    float big[kBlocks][4], small[kBlocks][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int m = n + 2 * q;  // blocks m and m + 1
        const float* b0 = B + (m / 4) * 32 * 32 + 256 * j;
        const int h = ((m / 2) % 2) << 4;  // the box's second 16 columns
        const float2 lo =
            *reinterpret_cast<const float2*>(b0 + (o.col[0] ^ h));
        const float2 hi =
            *reinterpret_cast<const float2*>(b0 + (o.col[1] ^ h));
        const float bx[2][2] = {{lo.x, hi.x}, {lo.y, hi.y}};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 2 * q + i;
          const Split<2> b = split(bx[i]);
          if (j == 0) {
            mma_tf32_first(small[k], a[j].small, b.big);
            mma_tf32_first(big[k], a[j].big, b.big);
          } else {
            mma_tf32(small[k], a[j].small, b.big);
            mma_tf32(big[k], a[j].big, b.big);
          }
          mma_tf32(small[k], a[j].big, b.small);
        }
      }
#pragma unroll
    for (int k = 0; k < kBlocks; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n + k][e] += big[k][e] + small[k][e];
  }
}

// acc's rows r and r + 8 (the lane's g and g + 8) to a [rows][kLd] fp32
// matrix at `out` (row r of the lane; kLd <= D, a multiple of 16): blocks
// n, n + 1 of 8 columns give columns 16 (n / 2) + 4 t .. + 3 (see
// Offsets). The row length is a constant: a runtime one cost the epilogue
// registers that ptxas spilled.
template <int D, int kLd>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[D / 8][4],
                                           bool lo_in, bool hi_in) {
  const int t = lane_id() & 3;
#pragma unroll
  for (int n = 0; n < kLd / 8; n += 2)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r == 0 ? lo_in : hi_in)
        *reinterpret_cast<float4*>(out + 8 * r * kLd + 8 * n + 4 * t) =
            make_float4(acc[n][2 * r], acc[n + 1][2 * r], acc[n][2 * r + 1],
                        acc[n + 1][2 * r + 1]);
}

// dK / dV of one 128-key tile. Consumer warp cw owns keys k0 + 16 cw .. + 15;
// its products are transposed (keys as rows), so P^T and dS^T come out as
// the A fragments of dV += P^T dout and dK += dS^T q. kLd: the tensors'
// head dim (D, or 80 in D = 128). kBand: a causal call with a band (`band`
// < 2^30); without it the band's code compiles away.
template <int D, int kLd, bool kBand>
__global__ void __launch_bounds__(kF32Threads, 1)
dkdv_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap omap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int sq,
                int skv, float scale, int causal) {
  // `causal`: 0 for a full call, else the band (2^30: none), so the
  // parameters are those of the band-free kernel
  using L = DkvF32Layout<D>;
  const int band = causal;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = smem_raw + (base - raw);
  float* rows_sm =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t kvbar = base + L::kBars, full = kvbar + 8;
  const uint32_t empty = full + 8 * kF32Stages;
  // the warpgroup, warp-uniform as ptxas sees it (setmaxnreg needs that)
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kF32DkvBlockK;
  // the first q tile; causal (Sq == Skv): the tiles above the key tile's
  // first key are masked. Each role computes it after setmaxnreg (kept
  // live through it, ptxas spilled it).
  auto first_tile = [&]() { return causal ? k0 / kF32DkvBlockQ : 0; };
  // kBand: the end of the rows walked (those past the last key's band are
  // masked) and the band, in shared memory (`read_anew`)
  __shared__ int band_sm[2];

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);  // the copies' arrival + 32 lanes
      mbar_init(empty + 8 * st, 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kBand) {
      band_sm[0] = min(sq, k0 + kF32DkvBlockK - 1 + min(band, sq));
      band_sm[1] = band;
    }
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: warp 0; lane 0 the copies, a lane a row
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kF32ProducerRegs));
    if (tid >= 32) return;
    const int first = first_tile();
    int n_q = (sq + kF32DkvBlockQ - 1) / kF32DkvBlockQ;
    if constexpr (kBand)
      n_q = (read_anew(band_sm) + kF32DkvBlockQ - 1) / kF32DkvBlockQ;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::kKvTile);
      tma_tile_f32<D, kF32DkvBlockK>(base + L::kK, &kmap, kvbar, k0, bh);
      tma_tile_f32<D, kF32DkvBlockK>(base + L::kV, &vmap, kvbar, k0, bh);
    }
    const float* lb = lse + (int64_t)bh * sq;
    const float* db = delta + (int64_t)bh * sq;
    for (int j = first; j < n_q; ++j) {
      const int st = (j - first) % kF32Stages;
      const int round = (j - first) / kF32Stages;
      // a stage's previous tile must be consumed first
      if (round > 0) mbar_wait_or_trap(empty + 8 * st, (round - 1) & 1);
      if (lane == 0) {
        const uint32_t qs = base + L::kStage + st * L::kStageBytes;
        mbar_expect_tx(full + 8 * st, 2 * L::kRowTile);
        tma_tile_f32<D, kF32DkvBlockQ>(qs, &qmap, full + 8 * st,
                                       j * kF32DkvBlockQ, bh);
        tma_tile_f32<D, kF32DkvBlockQ>(qs + L::kRowTile, &omap, full + 8 * st,
                                       j * kF32DkvBlockQ, bh);
      }
      float* r = rows_sm + st * 2 * kF32DkvBlockQ;
      const int row = j * kF32DkvBlockQ + lane;
      const bool in = row < sq;  // rows past sq are masked
      r[lane] = in ? lb[row] * kLog2e : 0.f;
      r[kF32DkvBlockQ + lane] = in ? db[row] : 0.f;
      mbar_arrive(full + 8 * st);  // each lane: its stores are released
    }
    return;
  }

  // ---- consumers: per q tile S^T, P^T, dV, then dP^T, dS^T, dK
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(kF32ConsumerRegs));
  const int first = first_tile();
  const int cw = (tid - 128) / 32;
  const int kc0 = k0 + 16 * cw;  // the warp's first key; keys kc0 + g (+ 8)
  const float sl2 = scale * kLog2e;
  // the warp's 16 keys of K and V
  const float* kw = reinterpret_cast<const float*>(sm + L::kK) + 16 * cw * 32;
  const float* vw = reinterpret_cast<const float*>(sm + L::kV) + 16 * cw * 32;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  mbar_wait(kvbar, 0);

  // the i-th tile of the walk: q rows from r0 = (first + i) * 32, stage
  // i % kF32Stages
  for (int i = 0, r0 = first * kF32DkvBlockQ; r0 < sq;
       ++i, r0 += kF32DkvBlockQ) {
    if constexpr (kBand) {
      if (r0 >= read_anew(band_sm)) break;  // past every key's band
    }
    const int st = i % kF32Stages, parity = (i / kF32Stages) & 1;
    mbar_wait(full + 8 * st, parity);
    // no key of the warp, or every key above every row
    if (kc0 >= skv || (causal && r0 + kF32DkvBlockQ - 1 < kc0)) {
      __syncwarp();
      if (lane_id() == 0) mbar_arrive(empty + 8 * st);
      continue;
    }
    const float* qs =
        reinterpret_cast<const float*>(sm + L::kStage + st * L::kStageBytes);
    const float* os = qs + L::kRowTile / 4;
    const float* rl = rows_sm + st * 2 * kF32DkvBlockQ;  // lse2, then delta

    // S^T = K_w q^T, then P^T: element (key kc0 + g + 8 (e / 2), row r0 +
    // 8 n + 2 t + e % 2)
    float s[4][4], dp[4][4];
    scores<D, kF32DkvBlockK>(s, kw, qs);
    bool edge = r0 + kF32DkvBlockQ > sq || kc0 + 16 > skv ||
                (causal && kc0 + 15 > r0);
    int bnd = 0;  // kBand: the band's edge masks too
    if constexpr (kBand) {
      bnd = read_anew(band_sm + 1);
      edge = edge || r0 + kF32DkvBlockQ - 1 - kc0 >= bnd;
    }
    const int g = lane_id() >> 2, t = lane_id() & 3;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = 8 * n + 2 * t + (e & 1);
        const float p = exp2f(fmaf(s[n][e], sl2, -rl[ri]));
        const int key = kc0 + g + 8 * (e >> 1), row = r0 + ri;
        bool keep = row < sq && key < skv && (!causal || key <= row);
        if constexpr (kBand) keep = keep && row - key < bnd;
        s[n][e] = edge && !keep ? 0.f : p;
      }
    Split<4> a[4];
    a_frags(s, a);
    accumulate<D, kDkvPairs>(dva, a, os);  // dV_w += P^T dout
    // P^T again from its fragments, before dP^T: neither P^T nor its
    // fragments are held through dV and dP^T both (the register peak)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = a_value(a, n, e);
        asm volatile("" : "+f"(s[n][e]));
      }
    // dP^T = V_w dout^T, then dS^T = P^T (dP^T - delta) scale
    scores<D, kF32DkvBlockK>(dp, vw, os);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = 8 * n + 2 * t + (e & 1);
        dp[n][e] = s[n][e] * (dp[n][e] - rl[kF32DkvBlockQ + ri]) * scale;
      }
    a_frags(dp, a);
    accumulate<D, kDkvPairs>(dka, a, qs);  // dK_w += dS^T q
    __syncwarp();
    if (lane_id() == 0) mbar_arrive(empty + 8 * stage_of(i));  // warp done
  }

  const int key = kc0 + lane_id() / 4;  // and key + 8
  const int64_t at = ((int64_t)bh * skv + key) * kLd;
  store_rows<D, kLd>(dk + at, dka, key < skv, key + 8 < skv);
  store_rows<D, kLd>(dv + at, dva, key < skv, key + 8 < skv);
}

// dQ of one 128-row q tile. Consumer warp cw owns rows q0 + 16 cw .. + 15.
// kLd and kBand as in dkdv_f32_kernel.
template <int D, int kLd, bool kBand>
__global__ void __launch_bounds__(kF32Threads, 1)
dq_f32_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int skv, float scale,
              int causal) {
  using L = DqF32Layout<D>;  // `causal` as in dkdv_f32_kernel
  const int band = causal;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sm = smem_raw + (base - raw);
  const uint32_t qbar = base + L::kBars, full = qbar + 8;
  const uint32_t empty = full + 8 * kF32Stages;
  // the warpgroup, warp-uniform as ptxas sees it (setmaxnreg needs that)
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32DqBlockQ;  // longest first
  // the key tiles; causal (Sq == Skv): those past the q tile's last row are
  // masked, and with a band (kBand) those below its first row's band: the
  // tiles [first_tile(), first_tile() + tiles()). Each role computes it
  // after setmaxnreg.
  auto first_tile = [&]() {
    return kBand ? max(0, q0 - band + 1) / kF32DqBlockK : 0;
  };
  auto tiles = [&]() {
    const int kv_end = causal ? min(skv, q0 + kF32DqBlockQ) : skv;
    int n = (kv_end + kF32DqBlockK - 1) / kF32DqBlockK;
    if constexpr (kBand) n -= first_tile();
    return n;
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kF32ProducerRegs));
    if (tid == 0) {
      const int n_tiles = tiles(), j0 = first_tile();
      mbar_expect_tx(qbar, 2 * L::kRowTile);
      tma_tile_f32<D, kF32DqBlockQ>(base + L::kQ, &qmap, qbar, q0, bh);
      tma_tile_f32<D, kF32DqBlockQ>(base + L::kO, &omap, qbar, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kF32Stages, round = j / kF32Stages;
        if (round > 0) mbar_wait_or_trap(empty + 8 * st, (round - 1) & 1);
        const uint32_t ks = base + L::kStage + st * L::kStageBytes;
        mbar_expect_tx(full + 8 * st, 2 * L::kKvTile);
        tma_tile_f32<D, kF32DqBlockK>(ks, &kmap, full + 8 * st,
                                      (j0 + j) * kF32DqBlockK, bh);
        tma_tile_f32<D, kF32DqBlockK>(ks + L::kKvTile, &vmap, full + 8 * st,
                                      (j0 + j) * kF32DqBlockK, bh);
      }
    }
    return;
  }

  // ---- consumers: per key tile S, P, dP, dS, then dQ += dS K
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(kF32ConsumerRegs));
  const int n_tiles = tiles();
  const int cw = (tid - 128) / 32;
  const int rw0 = q0 + 16 * cw;  // the warp's first row; rows rw0 + g (+ 8)
  const float sl2 = scale * kLog2e;
  // the warp's rows' lse (log2 units) and delta, read at each tile from
  // shared memory (not held in registers through it); rows past sq are
  // masked
  float* rows_sm =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  {
    const int row = rw0 + lane % 16;
    const bool in = row < sq;
    rows_sm[kF32DqBlockQ * (lane / 16) + 16 * cw + lane % 16] =
        !in ? 0.f
        : lane < 16 ? lse[(int64_t)bh * sq + row] * kLog2e
                    : delta[(int64_t)bh * sq + row];
    __syncwarp();
  }
  // the warp's 16 rows of q and dout
  const float* qw = reinterpret_cast<const float*>(sm + L::kQ) + 16 * cw * 32;
  const float* ow = reinterpret_cast<const float*>(sm + L::kO) + 16 * cw * 32;
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kF32Stages, parity = (j / kF32Stages) & 1;
    int kt0 = j * kF32DqBlockK;
    if constexpr (kBand) kt0 += first_tile() * kF32DqBlockK;
    mbar_wait(full + 8 * st, parity);
    // no row of the warp, every key above every row, or (kBand) below every
    // row's band
    bool skip = rw0 >= sq || (causal && kt0 > rw0 + 15);
    if constexpr (kBand) skip = skip || rw0 - (kt0 + kF32DqBlockK - 1) >= band;
    if (skip) {
      __syncwarp();
      if (lane_id() == 0) mbar_arrive(empty + 8 * st);
      continue;
    }
    const float* ks =
        reinterpret_cast<const float*>(sm + L::kStage + st * L::kStageBytes);
    const float* vs = ks + L::kKvTile / 4;

    // S = q_w K^T, then P: element (row rw0 + g + 8 (e / 2), key kt0 + 8 n
    // + 2 t + e % 2)
    float s[4][4], dp[4][4];
    scores<D, kF32DqBlockQ>(s, qw, ks);
    bool edge = rw0 + 16 > sq || kt0 + kF32DqBlockK > skv ||
                (causal && kt0 + kF32DqBlockK - 1 > rw0);
    if constexpr (kBand) edge = edge || rw0 + 15 - kt0 >= band;
    const int g = lane_id() >> 2, t = lane_id() & 3;
    const float* rl = rows_sm + 16 * cw + g;  // lse2 of rows g, g + 8
    const float lse2[2] = {rl[0], rl[8]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], sl2, -lse2[e >> 1]));
        const int row = rw0 + g + 8 * (e >> 1);
        const int key = kt0 + 8 * n + 2 * t + (e & 1);
        bool keep = row < sq && key < skv && (!causal || key <= row);
        if constexpr (kBand) keep = keep && row - key < band;
        s[n][e] = edge && !keep ? 0.f : p;
      }
    // dP = dout_w V^T, then dS = P (dP - delta) scale
    scores<D, kF32DqBlockQ>(dp, ow, vs);
    const float dl[2] = {rl[kF32DqBlockQ], rl[kF32DqBlockQ + 8]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;
    Split<4> a[4];
    a_frags(dp, a);
    accumulate<D, kDqPairs>(dqa, a, ks);  // dQ_w += dS K
    __syncwarp();
    if (lane_id() == 0) mbar_arrive(empty + 8 * st);  // this warp is done
  }

  const int row = rw0 + lane_id() / 4;  // and row + 8
  store_rows<D, kLd>(dq + ((int64_t)bh * sq + row) * kLd, dqa, row < sq,
                     row + 8 < sq);
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

// a [bh, s, d] tensor of `elem` bytes (2: bf16, 4: fp32) as a 3-D map
// (dims d, s, bh), boxes of 128 bytes of columns x `rows` rows x 1,
// 128-byte swizzle; reads past s are zeros
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long bh, int s,
                       int d, int rows, int elem = 2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem,
                                 (cuuint64_t)s * d * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows, 1};
  const cuuint32_t elems[3] = {1, 1, 1};
  const CUresult rc = encode(
      map,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elems,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// D: the kernels' head dim (64 or 128); d: the tensors' (d <= D; the maps
// zero-fill columns d..D-1)
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        long long bh, int sq, int skv, int d, float scale,
                        int causal, int band, cudaStream_t stream) {
  cudaError_t err =
      launch_delta<__nv_bfloat16>(out, dout, delta, bh, sq, d, stream);
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
    if (err == cudaSuccess) err = tensor_map(m.map, m.ptr, bh, m.s, d, m.rows);
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
      static_cast<__nv_bfloat16*>(dv), sq, skv, d, scale, causal, band);
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
      d, scale, causal, band);
  return cudaGetLastError();
}

template <int D, int kLd, bool kBand>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, long long bh,
                       int sq, int skv, int d, float scale, int causal,
                       int band, cudaStream_t stream) {
  cudaError_t err = launch_delta<float>(out, dout, delta, bh, sq, d, stream);
  // dK / dV: q and dout in 32-row boxes, K and V in 128-row boxes; dQ:
  // q and dout in 128-row boxes, K and V in 32-row boxes
  CUtensorMap q_kv, o_kv, k_kv, v_kv, q_q, o_q, k_q, v_q;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int s, rows;
  } maps[] = {{&q_kv, q, sq, kF32DkvBlockQ}, {&o_kv, dout, sq, kF32DkvBlockQ},
              {&k_kv, k, skv, kF32DkvBlockK}, {&v_kv, v, skv, kF32DkvBlockK},
              {&q_q, q, sq, kF32DqBlockQ}, {&o_q, dout, sq, kF32DqBlockQ},
              {&k_q, k, skv, kF32DqBlockK}, {&v_q, v, skv, kF32DqBlockK}};
  for (const auto& m : maps)
    if (err == cudaSuccess)
      err = tensor_map(m.map, m.ptr, bh, m.s, d, m.rows, 4);
  if (err != cudaSuccess) return err;
  const float* flse = static_cast<const float*>(lse);
  const float* fdl = static_cast<const float*>(delta);

  const int smem_kv = DkvF32Layout<D>::kAlloc;
  err = cudaFuncSetAttribute(dkdv_f32_kernel<D, kLd, kBand>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)bh,
                     (unsigned)((skv + kF32DkvBlockK - 1) / kF32DkvBlockK));
  dkdv_f32_kernel<D, kLd, kBand><<<grid_kv, kF32Threads, smem_kv, stream>>>(
      q_kv, o_kv, k_kv, v_kv, flse, fdl, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, skv, scale, causal ? band : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = DqF32Layout<D>::kAlloc;
  err = cudaFuncSetAttribute(dq_f32_kernel<D, kLd, kBand>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)bh,
                    (unsigned)((sq + kF32DqBlockQ - 1) / kF32DqBlockQ));
  dq_f32_kernel<D, kLd, kBand><<<grid_q, kF32Threads, smem_q, stream>>>(
      q_q, o_q, k_q, v_q, flse, fdl, static_cast<float*>(dq), sq, skv, scale,
      causal ? band : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, out, dout, dq [bh, sq, d]; k, v,
// dk, dv [bh, skv, d]; lse and the scratch delta [bh, sq] float32; all
// contiguous and 16-byte aligned; d in {64, 80, 128}; causal needs sq ==
// skv; window: 0, or a causal call's band W > 0 (float32 at d 128: only
// W >= sq, a band that masks nothing). Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        long long bh, long long sq, long long skv, int d,
                        int dtype, int causal, int window, float scale,
                        void* stream) {
  // the grid's second dimension: dQ blocks of q rows, dK / dV blocks of
  // keys
  const int block_q = dtype == 0 ? kF32DqBlockQ : kBfDqBlockQ;
  const int block_k = dtype == 0 ? kF32DkvBlockK : kBfDkvBlockK;
  if (bh <= 0 || sq <= 0 || skv <= 0 || bh > 0x7fffffffLL ||
      sq > (1LL << 28) || skv > (1LL << 28) ||
      (sq + block_q - 1) / block_q > 65535 ||
      (skv + block_k - 1) / block_k > 65535 || (causal && sq != skv) ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isq = (int)sq, iskv = (int)skv;
  // a band of at least Sq masks nothing: the band-free kernels take it
  const bool banded = window > 0 && window < sq;
  const int band = banded ? window : (1 << 30);  // 2^30: no band
  // fp32: an instantiation by row length and band (see dkdv_f32_kernel);
  // none for a band at D 128, where the kernels run at the register cap
  // and the band's bounds made ptxas spill
  if (dtype == 0 && d == 128 && banded) return (int)cudaErrorInvalidValue;
#define F32_CALL(D, LD, BAND)                                                 \
  return (int)launch_f32<D, LD, BAND>(q, k, v, out, dout, lse, delta, dq, dk, \
                                      dv, bh, isq, iskv, d, scale, causal,    \
                                      band, s)
  if (dtype == 0 && d == 64 && !banded) F32_CALL(64, 64, false);
  if (dtype == 0 && d == 64) F32_CALL(64, 64, true);
  if (dtype == 0 && d == 80 && !banded) F32_CALL(128, 80, false);
  if (dtype == 0 && d == 80) F32_CALL(128, 80, true);
  if (dtype == 0 && d == 128) F32_CALL(128, 128, false);
#undef F32_CALL
  if (dtype == 1 && d == 64)
    return (int)launch_bf16<64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                bh, isq, iskv, d, scale, causal, band, s);
  if (dtype == 1 && (d == 80 || d == 128))
    return (int)launch_bf16<128>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 bh, isq, iskv, d, scale, causal, band, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
