// Tiled segment-reduce (sum | max) for GNN aggregation, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py:segment_spmm
// (body `_segment_reduce_kernel`), both combiners. Same layout contract
// (kernels/tiling.py:prepare_tiled_edges): edges are blocked by row tile,
// every tile holds `per_tile` edges, `ldst` is the row id within the tile
// and pad edges carry ldst == tile_v (any ldst outside [0, tile_v) is a
// pad). out[t * tile_v + r] is the sum (init 0) or max (init -inf) of the
// messages of tile t's edges with ldst == r; rows no edge reaches keep the
// init value.
//
// Bound. The kernel is memory-bound. The bytes this run's data needs are
// the real edges' messages (real_edges * F * b, b = element bytes; a pad's
// message is never read), every ldst (4 * E_tiled) and every output row
// (rows * F * b), against 3.35 TB/s on an H100 SXM; it does one add or max
// per real edge and column. chip_smoke.py:check_kernel counts the bound so.
//
// Design: row-owner warps. A block takes one segment of `seg` slots of a
// row tile and one group of `cols` columns. Its warps split into "owner
// units" of `lanes` lanes (32 / lanes units a warp, G a block); unit u owns
// the tile's rows r with r % G == u, and each lane of it a VEC-column slice
// (16 bytes where F allows: one vector load a lane an edge, a warp reading
// 512 contiguous bytes of a message row at wide F). At narrow F a warp holds
// many units: at F=4 fp32 every lane owns rows of its own. Every output
// element has one owner (kernels/segment_spmm.py:_launch_plan picks the
// sizes in Python; tests/test_torch_kernels.py checks the ownership).
// Per stage of `stage` slots of the segment:
//   0. the stage's ldst arrives in shared memory by cp.async, issued two
//      stages ahead (three buffers);
//   a. each warp ranks the real slots of its part of the stage among those
//      of the same unit, with ballots over the unit's bits (a stable
//      counting sort; 128 slots of pads cost one vote, so the pad tail of
//      a tile is nearly free, and a pad's message is never read);
//   b. a block-wide prefix sum turns the counts into each unit's start;
//   c. the slots are scattered into `order`, unit by unit, each unit's in
//      slot order;
//   d. each unit walks its slots in order: it issues the message loads of
//      kBatch edges before it folds them, in order, into an fp32
//      accumulator ([tile_v, cols] in shared memory; a run of one row's
//      edges stays in registers).
// This breaks the dependent load chain of a walk by one thread per column:
// the loads of a batch are in flight together, and every lane has work.
// Tiles hold up to 5.7x the mean tile's real edges (hep100), so a tile is
// split into segments, one block each: each block folds its segment from
// the identity into an fp32 partial, and a second pass (merge_kernel)
// folds a tile's partials in segment order.
//
// Order. Each row is folded in layout order within a segment, from the
// identity; the segments' partials are then folded in order, from the
// identity. No float atomics anywhere: the same bits on every run, and an
// fp32 sum equals that same order of np.add.at folds bit for bit
// (chip_smoke.py:layout_fold); with one segment, the plain layout-order
// fold. Max is exact in any order. bf16 messages are folded in fp32 and
// rounded once on the way out.
//
// Plain C entry points, bound from Python with ctypes
// (kernels/segment_spmm.py). Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsegment_reduce.so segment_reduce.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kBatch = 16;       // edges of a unit whose loads are in flight
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// VEC elements of T as one load of 2, 4, 8 or 16 bytes
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int VEC>
struct Slice {
  using raw_t = typename Raw<VEC * (int)sizeof(T)>::type;
  static __device__ __forceinline__ raw_t load(const T* p) {
    return __ldg(reinterpret_cast<const raw_t*>(p));
  }
  static __device__ __forceinline__ void unpack(const raw_t& r, float* v) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    raw_t r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32(v[i]);
    *reinterpret_cast<raw_t*>(p) = r;
  }
  static __device__ __forceinline__ float to_f32(float x) { return x; }
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ T from_f32(float x) {
    if constexpr (sizeof(T) == 4) return x;
    else return __float2bfloat16_rn(x);
  }
};

// VEC fp32 values (of the accumulator, or of a partial), 16 bytes at a time
// where VEC allows
template <int VEC>
__device__ __forceinline__ void acc_load(const float* a, float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(v + i) =
          *reinterpret_cast<const float4*>(a + i);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = a[i];
  }
}
template <int VEC>
__device__ __forceinline__ void acc_store(float* a, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(a + i) =
          *reinterpret_cast<const float4*>(v + i);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = v[i];
  }
}

// cp.async of 4 bytes from device memory into shared memory
__device__ __forceinline__ void copy4_async(int32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n");
}
__device__ __forceinline__ void wait_async_but_one() {
  asm volatile("cp.async.wait_group 1;\n");
}

struct Plan {
  int64_t per_tile;
  int64_t seg;     // slots a segment (a multiple of stage)
  int n_splits;    // segments a tile
  int tile_v, f;
  int log2_lanes;  // lanes a unit (a power of two, <= 32)
  int log2_units;  // log2(G), units a block
  int n_col_groups;
  int stage;       // slots a stage (a multiple of 128, <= 65536)
};

// Shared memory of one block, in bytes: what a launch asks for
// (kernels/segment_spmm.py:_smem_bytes computes the same sum to plan).
__host__ __device__ inline int64_t smem_bytes(int tile_v, int cols, int stage,
                                              int warps, int units) {
  return (int64_t)tile_v * cols * 4 + 3LL * stage * 4 +
         ((int64_t)warps * units + units + 1 + 32) * 4 + 2LL * stage * 2;
}

// Block-wide exclusive prefix sum of one int a thread (blockDim.x threads,
// a multiple of 32); `scratch` holds 32 ints. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n = blockDim.x >> 5;
    int w = lane < n ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n) scratch[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  return incl - x + (warp > 0 ? scratch[warp - 1] : 0);
}

template <typename T, int VEC, bool kMax>
__global__ void __launch_bounds__(kMaxThreads)
segment_reduce_kernel(const T* __restrict__ msg,
                      const int32_t* __restrict__ ldst, T* __restrict__ out,
                      float* __restrict__ partial, Plan p) {
  using S = Slice<T, VEC>;
  using raw_t = typename S::raw_t;
  const int lanes = 1 << p.log2_lanes;
  const int cols = lanes * VEC;
  const int log2_upw = 5 - p.log2_lanes;  // units a warp, log2
  const int n_units = 1 << p.log2_units;
  const unsigned unit_mask = n_units - 1u;
  const int n_warps = blockDim.x >> 5;

  // acc [tile_v][cols] fp32 | 3 ldst stages | count [warps][units] |
  // unit_start [units + 1] | scan scratch [32] | rank [stage] |
  // order [stage]
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int32_t* sldst = reinterpret_cast<int32_t*>(acc + (size_t)p.tile_v * cols);
  int* count = sldst + 3 * p.stage;
  int* unit_start = count + n_warps * n_units;
  int* scratch = unit_start + n_units + 1;
  unsigned short* rank = reinterpret_cast<unsigned short*>(scratch + 32);
  unsigned short* order = rank + p.stage;

  const int cg = blockIdx.x % p.n_col_groups;
  const int64_t tile_seg = blockIdx.x / p.n_col_groups;  // tile * n_splits + k
  const int64_t tile = tile_seg / p.n_splits;
  const int64_t seg0 = (tile_seg % p.n_splits) * p.seg;  // first slot in tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = (warp << log2_upw) + (lane >> p.log2_lanes);
  const int lig = lane & (lanes - 1);            // lane within the unit
  const int col = cg * cols + lig * VEC;         // first column of the slice
  const bool col_ok = col < p.f;                 // VEC divides F
  const unsigned lanes_below = (1u << lane) - 1u;
  int* my_count = count + warp * n_units;
  const float init = kMax ? -INFINITY : 0.0f;

  for (int i = threadIdx.x; i < p.tile_v * cols; i += blockDim.x) acc[i] = init;

  const int64_t e0 = tile * p.per_tile + seg0;
  const int64_t seg_len =
      p.per_tile - seg0 < p.seg ? p.per_tile - seg0 : p.seg;
  const int n_stages = (int)((seg_len + p.stage - 1) / p.stage);
  auto stage_len = [&](int s) {  // slots of stage s
    const int64_t left = seg_len - (int64_t)s * p.stage;
    return (int)(left < p.stage ? left : p.stage);
  };
  auto ldst_buf = [&](int s) { return sldst + (s % 3) * p.stage; };
  auto issue_ldst = [&](int s) {
    if (s < n_stages) {
      const int32_t* src = ldst + e0 + (int64_t)s * p.stage;
      int32_t* dst = ldst_buf(s);
      for (int i = threadIdx.x, n = stage_len(s); i < n; i += blockDim.x)
        copy4_async(dst + i, src + i);
    }
    commit_async();
  };
  // three ldst buffers: stage s is read while s + 1 lands, and s + 2 is
  // issued once every warp is done with s - 1
  issue_ldst(0);
  issue_ldst(1);
  for (int s = 0; s < n_stages; ++s) {
    wait_async_but_one();  // stage s's ldst
    __syncthreads();  // ... visible, and every warp is done with stage s - 1
    issue_ldst(s + 2);
    const int len = stage_len(s);
    const int32_t* buf = ldst_buf(s);

    // (a) a stable counting sort of the stage's real slots by owner unit.
    // Warp w takes a contiguous range of slots and gives each real slot its
    // rank among the range's slots of the same unit, in slot order. Ballots
    // of the unit's bits find a slot's peers; 128 slots of pads cost one
    // vote.
    const int span = (len + 128 * n_warps - 1) / (128 * n_warps) * 128;
    const int lo = warp * span, hi = min(lo + span, len);
    for (int u = lane; u < n_units; u += 32) my_count[u] = 0;
    __syncwarp();
    bool any_real = false;
    for (int base = lo; base < hi; base += 128) {
      int d[4];
      bool any = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = base + 32 * k + lane;
        d[k] = off < hi ? buf[off] : p.tile_v;
        any |= (unsigned)d[k] < (unsigned)p.tile_v;
      }
      if (!__any_sync(kFull, any)) continue;
      any_real = true;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool real = (unsigned)d[k] < (unsigned)p.tile_v;
        const unsigned reals = __ballot_sync(kFull, real);
        if (!reals) continue;
        const int u = (int)((unsigned)d[k] & unit_mask);
        unsigned peers = reals;  // the real lanes of this lane's unit
        for (int b = 0; b < p.log2_units; ++b) {
          const unsigned ones = __ballot_sync(kFull, (u >> b) & 1);
          peers &= ((u >> b) & 1) ? ones : ~ones;
        }
        const int c = real ? my_count[u] : 0;
        __syncwarp();
        if (real) {
          const int r = __popc(peers & lanes_below);
          rank[base + 32 * k + lane] = (unsigned short)(c + r);
          if (r == 0) my_count[u] = c + __popc(peers);
        }
        __syncwarp();
      }
    }
    if (!__syncthreads_or(any_real)) continue;  // a stage of pads only

    // (b) where each (unit, warp range) starts in `order`: units in turn,
    // the warp ranges of a unit in slot order
    const int t = threadIdx.x;
    int total = 0;
    if (t < n_units)
      for (int w = 0; w < n_warps; ++w) total += count[w * n_units + t];
    const int start = block_exclusive_scan(total, scratch);
    if (t < n_units) {
      int run = start;
      for (int w = 0; w < n_warps; ++w) {
        const int c = count[w * n_units + t];
        count[w * n_units + t] = run;
        run += c;
      }
      unit_start[t] = start;
      if (t == n_units - 1) unit_start[n_units] = start + total;
    }
    __syncthreads();

    // (c) scatter: order[] lists the stage's real slots unit by unit, each
    // unit's in slot order
    for (int base = lo; base < hi; base += 32) {
      const int off = base + lane;
      const int d = off < hi ? buf[off] : p.tile_v;
      if ((unsigned)d < (unsigned)p.tile_v)
        order[my_count[(unsigned)d & unit_mask] + rank[off]] =
            (unsigned short)off;
    }
    __syncthreads();

    // (d) each unit folds its slots in order: the loads of kBatch edges are
    // issued before they are folded; a run of edges of one row is folded in
    // registers
    const int beg = unit_start[unit], end = unit_start[unit + 1];
    if (!col_ok || beg == end) continue;
    const T* mp = msg + (e0 + (int64_t)s * p.stage) * p.f + col;
    int cur = -1;
    float a[VEC];
    for (int i0 = beg; i0 < end; i0 += kBatch) {
      raw_t r[kBatch];
      int row[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        row[u] = -1;
        if (i0 + u < end) {
          const int off = order[i0 + u];
          row[u] = buf[off];
          r[u] = S::load(mp + (int64_t)off * p.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (row[u] < 0) break;
        if (row[u] != cur) {
          if (cur >= 0) acc_store<VEC>(acc + (size_t)cur * cols + lig * VEC, a);
          cur = row[u];
          acc_load<VEC>(acc + (size_t)cur * cols + lig * VEC, a);
        }
        float v[VEC];
        S::unpack(r[u], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          a[i] = kMax ? fmaxf(a[i], v[i]) : a[i] + v[i];
      }
    }
    acc_store<VEC>(acc + (size_t)cur * cols + lig * VEC, a);
  }
  __syncthreads();  // every fold is in the accumulator

  // one segment: the output rows; several: this segment's fp32 partial
  T* op = out + tile * p.tile_v * (int64_t)p.f;
  float* pp = partial + tile_seg * p.tile_v * (int64_t)p.f;
  const int slices = cols / VEC;
  for (int i = threadIdx.x; i < p.tile_v * slices; i += blockDim.x) {
    const int r = i / slices, c = cg * cols + (i % slices) * VEC;
    if (c >= p.f) continue;
    float v[VEC];
    acc_load<VEC>(acc + (size_t)r * cols + (i % slices) * VEC, v);
    if (p.n_splits == 1)
      S::store(op + (int64_t)r * p.f + c, v);
    else
      acc_store<VEC>(pp + (int64_t)r * p.f + c, v);
  }
}

// The second pass over split tiles: out = the fold, from the identity and
// in segment order, of a tile's n_splits fp32 partials, rounded once to T.
template <typename T, int VEC, bool kMax>
__global__ void merge_kernel(const float* __restrict__ partial,
                             T* __restrict__ out, int64_t n_tiles, int tile_v,
                             int f, int n_splits) {
  const int slices = f / VEC;
  const int64_t n = n_tiles * tile_v * slices;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / slices;  // tile * tile_v + r
    const int c = (int)(i % slices) * VEC;
    const int64_t tile = row / tile_v, r = row % tile_v;
    float a[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = kMax ? -INFINITY : 0.0f;
    for (int k = 0; k < n_splits; ++k) {
      float v[VEC];
      acc_load<VEC>(partial + ((tile * n_splits + k) * tile_v + r) * f + c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = kMax ? fmaxf(a[j], v[j]) : a[j] + v[j];
    }
    Slice<T, VEC>::store(out + row * f + c, a);
  }
}

template <typename T, bool kMax>
cudaError_t launch_vec(int vec, const void* msg, const void* ldst, void* out,
                       void* partial, const Plan& p, int64_t n_tiles,
                       int threads, int smem, cudaStream_t stream) {
  auto go = [&](auto vec_tag) {
    constexpr int V = decltype(vec_tag)::value;
    auto kernel = segment_reduce_kernel<T, V, kMax>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int64_t blocks = n_tiles * p.n_splits * p.n_col_groups;
    kernel<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        static_cast<const T*>(msg), static_cast<const int32_t*>(ldst),
        static_cast<T*>(out), static_cast<float*>(partial), p);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.n_splits == 1) return err;
    const int64_t work = n_tiles * p.tile_v * (p.f / V);
    const int64_t merge_blocks =
        std::min<int64_t>((work + 255) / 256, 0x7fffffffLL);
    merge_kernel<T, V, kMax><<<(unsigned)merge_blocks, 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<T*>(out), n_tiles,
        p.tile_v, p.f, p.n_splits);
    return cudaGetLastError();
  };
  using std::integral_constant;
  switch (vec) {
    case 1: return go(integral_constant<int, 1>{});
    case 2: return go(integral_constant<int, 2>{});
    case 4: return go(integral_constant<int, 4>{});
    case 8:
      if constexpr (sizeof(T) == 2) return go(integral_constant<int, 8>{});
      else return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

int log2_exact(int x) {  // log2 of a power of two, else -1
  if (x <= 0 || (x & (x - 1))) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; combiner: 0 = sum, 1 = max.
// msg [n_tiles * per_tile, f], ldst [n_tiles * per_tile] int32,
// out [n_tiles * tile_v, f] of the messages' dtype; with n_splits > 1,
// partial is fp32 scratch of n_tiles * n_splits * tile_v * f elements. The
// launch plan (vec, lanes, warps, stage, n_col_groups, n_splits, seg)
// comes from kernels/segment_spmm.py:_launch_plan; a plan this kernel
// cannot run is refused with cudaErrorInvalidValue, and one whose shared
// memory (smem_bytes) is over the card's limit fails at
// cudaFuncSetAttribute. Returns a cudaError_t.
int segment_reduce(const void* msg, const void* ldst, void* out,
                   void* partial, long long n_tiles, long long per_tile,
                   int tile_v, int f, int dtype, int combiner, int vec,
                   int lanes, int warps, int stage,
                   int n_col_groups, int n_splits, long long seg,
                   void* stream) {
  const int log2_lanes = log2_exact(lanes), log2_warps = log2_exact(warps);
  if (n_tiles <= 0 || per_tile <= 0 || tile_v <= 0 || f <= 0 ||
      (dtype != 0 && dtype != 1) || (combiner != 0 && combiner != 1) ||
      log2_lanes < 0 || log2_warps < 0 || log2_exact(vec) < 0 ||
      f % vec != 0 || warps * 32 > kMaxThreads || stage <= 0 ||
      stage % 128 != 0 || stage > 65536 || n_col_groups <= 0 ||
      (long long)n_col_groups * lanes * vec < f || n_splits <= 0 ||
      seg <= 0 || seg % stage != 0 || seg * n_splits < per_tile ||
      seg * (n_splits - 1) >= per_tile || (n_splits > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  const int64_t smem64 =
      smem_bytes(tile_v, lanes * vec, stage, warps, warps << (5 - log2_lanes));
  if (smem64 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem64;
  if (n_tiles * n_splits * n_col_groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Plan p{per_tile, seg, n_splits, tile_v, f, log2_lanes,
         log2_warps + 5 - log2_lanes, n_col_groups, stage};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;
  if (dtype == 0 && combiner == 0)
    return (int)launch_vec<float, false>(vec, msg, ldst, out, partial, p, n_tiles, threads, smem, s);
  if (dtype == 0 && combiner == 1)
    return (int)launch_vec<float, true>(vec, msg, ldst, out, partial, p, n_tiles, threads, smem, s);
  if (dtype == 1 && combiner == 0)
    return (int)launch_vec<__nv_bfloat16, false>(vec, msg, ldst, out, partial, p, n_tiles, threads, smem, s);
  return (int)launch_vec<__nv_bfloat16, true>(vec, msg, ldst, out, partial, p, n_tiles, threads, smem, s);
}

const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
