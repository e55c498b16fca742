// Single-token decode attention over a KV cache, CUDA C++ for sm_90a
// (Hopper): split-K (flash-decoding) with K/V tiles streamed by bulk async
// copies into an mbarrier ring.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (body `_decode_kernel`). Same function: one query row
// per batch*head against a [BH, S, D] cache; scores q.k * (the `scale` the
// wrapper passes, 1/sqrt(D)); slots >= valid_len masked to -1e30; the
// online softmax's max, normaliser and accumulator in fp32; the
// unnormalised probabilities cast to v's dtype before the PV product; out =
// acc / max(l, 1e-30) in q's dtype. `valid_len` is read on the device (the
// counterpart of the TPU kernel's scalar prefetch), so a call needs no host
// sync.
//
// Masked slots. With valid_len >= 1 a masked slot adds exactly 0 to the
// normaliser and the accumulator (exp(-1e30 - m) underflows to 0 once m is
// a real score) and leaves the max alone, so the kernel walks only
// n = min(valid_len, S) slots and never reads the rest of the cache. With
// valid_len <= 0 every slot is masked to the same -1e30, every
// probability is exp(0) = 1, and the TPU kernel returns the mean of v over
// all S slots: the kernel then walks all n = S slots with that score.
//
// Bound. The kernel must read the walked slots' keys and values once (2 *
// BH * n * D elements: 3.93 GB in bf16 at BH 256, n 30000, D 128) and q
// and out, at 3.35 TB/s (H100 SXM): 1.17 ms bf16, 2.35 ms fp32. The
// products are 4 * BH * n * D flops, far below the compute bound. So the
// design keeps enough bytes in flight on every SM, whatever the compute
// takes, and spends few instructions a byte.
//
// Design.
// - Split the cache. The grid is BH x n_split blocks (block = bh * n_split
//   + split); n_split, the tile, the ring's depth and the shared memory
//   come from the launch plan the wrapper passes
//   (kernels/decode_attention.py:_launch_plan), which this entry checks.
//   Each block reads valid_len, takes n as above, and walks the tiles
//   [split * nt / n_split, (split + 1) * nt / n_split) of the nt =
//   ceil(n / TILE) tiles of [0, n): the shares are cut on tile
//   boundaries, only the last tile of [0, n) is ragged, and no block idles
//   on a masked tail. A split with no tile writes an empty partial (m =
//   -1e30, l = 0, acc = 0), which the merge weighs by exactly 0.
// - Stream K and V without registers. A producer warp's lane 0 issues one
//   1-D cp.async.bulk for each K tile and one for each V tile (TILE rows of
//   one bh are contiguous: TILE * D * sizeof(T) bytes, <= 16 KB; the ragged
//   last tile copies only its rows below n) into a ring of `stages` stages
//   (3 at the plan's sizes: 96 KB, two blocks an SM, up to 192 KB in
//   flight on an SM), each with a full mbarrier (the copies' transaction
//   bytes) and an empty one (one arrival per consumer warp).
// - Few shuffles a slot. Four consumer warps split each tile's rows; a
//   warp's four 8-lane groups each take one row at a time, a lane 16-byte
//   chunks of it (a quarter-warp reads 128 contiguous bytes: no bank
//   conflict), so a warp instruction covers 4 rows and a score needs 3
//   shuffle rounds. Each group keeps its own running (m, l) and its lanes
//   the D / 8 accumulator columns of their chunks: the PV product needs no
//   shuffle at all. A group folds its G = TILE / 16 rows of a tile at once
//   (one rescale of the accumulator a tile); p is rounded to the cache's
//   dtype before PV.
// - Merge in a fixed order. The 16 group states of a block merge through
//   shared memory in state order; with n_split > 1 each block writes its
//   (m, l, acc[D]) in fp32 to the workspace, and a second kernel folds a
//   bh's splits in split order and writes acc / max(l, 1e-30). With
//   n_split == 1 the first kernel writes the output itself. No float
//   atomics: runs repeat bit for bit.
//
// Head dims. d is 64, 80 or 128. d = 80 (h2o-danube) computes on the D =
// 128 lane layout (a lane's chunks as at 128) over rows of 80: a lane's
// chunks past column 80 load as zeros and are not stored, and its tile is
// the multiple of 16 rows (one per group state) nearest below 16 KB of K:
// 96 slots in bf16, 48 in fp32.
//
// Plain C entry points, bound from Python with ctypes
// (kernels/decode_attention.py). Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdecode_attention.so decode_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's masked score
constexpr int kConsumers = 4;      // consumer warps; one producer warp beside
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kGroups = 4;         // 8-lane groups of a warp
constexpr int kStates = kConsumers * kGroups;  // (m, l, acc) states a block
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxSplit = 1024;
constexpr int kTileBytes = 16384;   // a K (or V) tile

// cache slots a tile holds: at most 16 KB of K, a multiple of kStates rows
// (64 at D 128 bf16, 32 at D 128 fp32, 96 at D 80 bf16)
template <typename T, int D>
constexpr int kTile = kTileBytes / (D * (int)sizeof(T)) / kStates * kStates;

// the lane layout's head dim: D, or 128 for a row of 80
template <int D>
constexpr int kLanesD = D == 80 ? 128 : D;

// A block's dynamic shared memory (mirrored by
// kernels/decode_attention.py:_smem_bytes): the K ring, the V ring, the
// merge's m, l and acc of every state, a full and an empty barrier a stage.
constexpr int smem_bytes(int tile, int stages, int d, int b) {
  return 2 * stages * tile * d * b + kStates * (d + 2) * 4 + 2 * stages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
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
// of more than about two seconds (a lost copy) traps instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (4LL << 30)) __trap();
  }
}

// `bytes` contiguous bytes from global to shared memory; the barrier's
// transaction count drops by them when they have landed
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes as floats: 4 fp32 or 8 bf16
__device__ __forceinline__ void unpack16(const float* p, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* x) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// p as the PV product sees it: cast to the cache's dtype
__device__ __forceinline__ float as_dtype(float p, const float*) { return p; }
__device__ __forceinline__ float as_dtype(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// two blocks an SM, as the plan sizes the ring for (it also keeps ptxas
// from spilling around the barrier waits)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ valid_len,
             T* __restrict__ out, float* __restrict__ part, int s,
             int n_split, int stages, float scale) {
  constexpr int TILE = kTile<T, D>;
  constexpr int kStage = TILE * D * (int)sizeof(T);  // bytes of a K tile
  constexpr int PER = 16 / (int)sizeof(T);  // elements in 16 bytes
  constexpr int NV = kLanesD<D> / 8 / PER;  // 16-byte chunks a lane a row
  constexpr int E = kLanesD<D> / 8;         // columns a lane owns
  constexpr int kRows = TILE / kConsumers;  // a consumer warp's rows a tile
  constexpr int G = kRows / kGroups;        // a group's rows a tile
  static_assert(G >= 1 && NV >= 1 && kRows % kGroups == 0,
                "tile or head dim too small");

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = smem + stages * kStage;
  float* sm_m = reinterpret_cast<float*>(smem + 2 * stages * kStage);
  float* sm_l = sm_m + kStates;
  float* sm_acc = sm_l + kStates;
  const uint32_t full = smem_u32(sm_acc + kStates * D);
  const uint32_t empty = full + 8 * stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t bh = blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int valid = __ldg(valid_len);
  const int n = valid >= 1 ? min(valid, s) : s;  // slots walked
  const int nt = (n + TILE - 1) / TILE;
  const int t_lo = (int)((int64_t)split * nt / n_split);
  const int n_tiles = (int)((int64_t)(split + 1) * nt / n_split) - t_lo;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {  // ---- producer: lane 0 issues every copy
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % stages, round = j / stages;
        // the stage's previous tile (j - stages) must be consumed first
        if (round > 0) mbar_wait(empty + 8 * st, (round - 1) & 1);
        const int slot0 = (t_lo + j) * TILE;
        const uint32_t bytes =
            (uint32_t)min(TILE, n - slot0) * D * (uint32_t)sizeof(T);
        const int64_t off = (bh * s + slot0) * D;
        mbar_expect_tx(full + 8 * st, 2 * bytes);
        bulk_load(smem_u32(ks + st * kStage), k + off, bytes, full + 8 * st);
        bulk_load(smem_u32(vs + st * kStage), v + off, bytes, full + 8 * st);
      }
    }
    return;
  }

  // ---- consumers: group g of warp w takes rows w * kRows + i * 4 + g of a
  // tile (i < G); lane j of the group the 16-byte chunks c * 128 + j * 16
  // of a row (c < NV), i.e. columns (c * 128 + j * 16) / sizeof(T) + e;
  // a chunk past the row's D columns (D 80) is zeros
  const int g = lane / 8, jl = lane % 8;
  auto in_row = [&](int c) { return (c * 8 + jl) * PER < D; };
  float qv[E], acc[E];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (in_row(c)) {
      unpack16(q + bh * D + c * 8 * PER + jl * PER, qv + c * PER);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) qv[c * PER + e] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = kMasked, l = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % stages;
    mbar_wait(full + 8 * st, (t / stages) & 1);
    const int rows = min(TILE, n - (t_lo + t) * TILE);
    const T* kt = reinterpret_cast<const T*>(ks + st * kStage);
    const T* vt = reinterpret_cast<const T*>(vs + st * kStage);
    float sc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = warp * kRows + i * kGroups + g;
      float d = 0.f;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (!in_row(c)) continue;
          float x[PER];
          unpack16(kt + r * D + c * 8 * PER + jl * PER, x);
#pragma unroll
          for (int e = 0; e < PER; ++e) d = fmaf(qv[c * PER + e], x[e], d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      // past the ragged tile's rows: not a slot; valid_len <= 0: masked
      sc[i] = r >= rows ? -INFINITY : valid >= 1 ? d * scale : kMasked;
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < G; ++i) mx = fmaxf(mx, sc[i]);
    const float corr = expf(m - mx);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float p = expf(sc[i] - mx);
      ps += p;
      sc[i] = as_dtype(p, q);
    }
    l = l * corr + ps;
    m = mx;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = warp * kRows + i * kGroups + g;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (!in_row(c)) continue;
          float x[PER];
          unpack16(vt + r * D + c * 8 * PER + jl * PER, x);
#pragma unroll
          for (int e = 0; e < PER; ++e)
            acc[c * PER + e] = fmaf(sc[i], x[e], acc[c * PER + e]);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // the block's states merge in state order (consumer threads only)
  const int state = warp * kGroups + g;
  if (jl == 0) {
    sm_m[state] = m;
    sm_l[state] = l;
  }
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (!in_row(c)) continue;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      sm_acc[state * D + c * 8 * PER + jl * PER + e] = acc[c * PER + e];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
  for (int d = threadIdx.x; d < D; d += kConsumers * 32) {
    float big = sm_m[0];
#pragma unroll
    for (int i = 1; i < kStates; ++i) big = fmaxf(big, sm_m[i]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      const float f = expf(sm_m[i] - big);
      lsum += sm_l[i] * f;
      a += sm_acc[i * D + d] * f;
    }
    if (n_split == 1) {
      store(out + bh * D + d, a / fmaxf(lsum, 1e-30f));
    } else {  // this split's partial: (m, l, acc[D]) in fp32
      float* p = part + (bh * n_split + split) * (D + 2);
      if (d == 0) {
        p[0] = big;
        p[1] = lsum;
      }
      p[2 + d] = a;
    }
  }
}

// fold a bh's split partials in split order
template <typename T, int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ part, T* __restrict__ out,
             int n_split) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* p = part + bh * n_split * (D + 2);
  float big = p[0];
  for (int i = 1; i < n_split; ++i) big = fmaxf(big, p[i * (D + 2)]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float f = expf(p[i * (D + 2)] - big);
    lsum += p[i * (D + 2) + 1] * f;
    a += p[i * (D + 2) + 2 + d] * f;
  }
  store(out + bh * D + d, a / fmaxf(lsum, 1e-30f));
}

struct Call {
  const void *q, *k, *v, *valid_len;
  void *out, *part;
  long long bh;
  int s, n_split, stages, smem;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Call& c, int tile) {
  if (tile != kTile<T, D> ||
      c.smem != smem_bytes(tile, c.stages, D, (int)sizeof(T)))
    return cudaErrorInvalidValue;
  auto kernel = split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(c.bh * c.n_split), kThreads, c.smem, c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k),
      static_cast<const T*>(c.v), static_cast<const int32_t*>(c.valid_len),
      static_cast<T*>(c.out), static_cast<float*>(c.part), c.s, c.n_split,
      c.stages, c.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.n_split == 1) return err;
  merge_kernel<T, D><<<(unsigned)c.bh, D, 0, c.stream>>>(
      static_cast<const float*>(c.part), static_cast<T*>(c.out), c.n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, out [bh, d]; k, v [bh, s, d],
// contiguous, 16-byte aligned; valid_len one int32 on the device; d in
// {64, 80, 128}. The launch plan (kernels/decode_attention.py:_launch_plan):
// tile the kernel's kTile slots (at most 16 KB of K), stages in [1, 8], n_split
// >= 1 blocks a bh, smem the dynamic shared memory bytes (checked against
// the layout);
// workspace bh * n_split * (d + 2) floats on the device when n_split > 1.
// Returns a cudaError_t: cudaErrorInvalidValue for a plan it cannot run.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* valid_len, void* out, void* workspace,
                     long long bh, long long s, int d, int dtype, float scale,
                     int tile, int stages, int n_split, int smem,
                     void* stream) {
  if (bh <= 0 || s <= 0 || bh > 0x7fffffffLL || s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (stages < 1 || stages > kMaxStages || n_split < 1 ||
      n_split > kMaxSplit || bh * n_split > 0x7fffffffLL ||
      smem > kSmemLimit || (n_split > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const Call c{q,  k,       v,      valid_len, out,   workspace,
               bh, (int)s,  n_split, stages,   smem,  scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && d == 64) return (int)launch<float, 64>(c, tile);
  if (dtype == 0 && d == 80) return (int)launch<float, 80>(c, tile);
  if (dtype == 0 && d == 128) return (int)launch<float, 128>(c, tile);
  if (dtype == 1 && d == 64) return (int)launch<__nv_bfloat16, 64>(c, tile);
  if (dtype == 1 && d == 80) return (int)launch<__nv_bfloat16, 80>(c, tile);
  if (dtype == 1 && d == 128)
    return (int)launch<__nv_bfloat16, 128>(c, tile);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
