// Single-token decode attention over a KV cache, CUDA C++ for sm_90a.
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
// a real score) and leaves the max alone, so the kernel stops at
// min(valid_len, S) and never reads the rest of the cache. With
// valid_len <= 0 every slot is masked to the same -1e30, every
// probability is exp(0) = 1, and the TPU kernel returns the mean of v over
// all S slots: the kernel then walks all S slots with that score.
//
// Design. One block per bh, 8 warps. Warp w takes chunks of 8 consecutive
// slots, chunk w, w + 8, w + 16, ...: its 32 lanes load the chunk's 8 key
// rows and 8 value rows at once (D/32 contiguous elements each, 16 bytes
// per lane for fp32 at D = 128), reduce each row's dot product with a
// butterfly (every lane gets the same bits), and fold the chunk into the
// warp's own (m, l, acc[D]). At the end the warps merge in a fixed order
// through shared memory. No float atomics: runs repeat bit for bit. A
// split-K (flash-decoding) layout, several blocks per bh, is later work.
//
// Bound. Bytes: the valid slots' keys and values, read once (2 * BH *
// valid * D elements; 3.93 GB in bf16 at BH 256, valid 30000, D 128), plus
// q and out, at 3.35 TB/s (H100 SXM): 1.17 ms bf16, 2.35 ms fp32. The
// products are 4 * BH * valid * D flops, far below the compute bound.
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
constexpr int kWarps = 8;
constexpr int kChunk = 8;  // slots a warp has in flight

template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&x)[E]) {
  if constexpr (E == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[E]) {
  if constexpr (E == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    x[0] = __low2float(a); x[1] = __high2float(a);
    x[2] = __low2float(b); x[3] = __high2float(b);
  } else {
    const unsigned int t = __ldg(reinterpret_cast<const unsigned int*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t);
    x[0] = __low2float(a); x[1] = __high2float(a);
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ valid_len,
              T* __restrict__ out, int s, float scale) {
  constexpr int E = D / 32;  // elements per lane
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t bh = blockIdx.x;
  const int valid = __ldg(valid_len);
  const int n = valid >= 1 ? min(valid, s) : s;  // slots walked
  const T* kb = k + bh * s * D + lane * E;
  const T* vb = v + bh * s * D + lane * E;

  float qv[E];
  load_row<E>(q + bh * D + lane * E, qv);
  float m = kMasked, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int base = warp * kChunk; base < n; base += kWarps * kChunk) {
    float kr[kChunk][E], vr[kChunk][E];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (base + u < n) {
        load_row<E>(kb + (int64_t)(base + u) * D, kr[u]);
        load_row<E>(vb + (int64_t)(base + u) * D, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float sc[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qv[e], kr[u][e], d);
      sc[u] = d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int slot = base + u;
      float x = sc[u] * scale;
      if (slot >= n) x = -INFINITY;          // past the walk: not a slot
      else if (slot >= valid) x = kMasked;   // only when valid_len <= 0
      sc[u] = x;
      mx = fmaxf(mx, x);
    }
    const float corr = expf(m - mx);
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float p = expf(sc[u] - mx);
      ps += p;
      sc[u] = as_dtype(p, q);
    }
    l = l * corr + ps;
    m = mx;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float a = acc[e] * corr;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) a = fmaf(sc[u], vr[u][e], a);
      acc[e] = a;
    }
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float big = sm_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) big = fmaxf(big, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {  // a fixed order: the same bits every run
      const float f = expf(sm_m[w] - big);
      lsum += sm_l[w] * f;
      a += sm_acc[w][d] * f;
    }
    store(out + bh * D + d, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid_len, void* out, long long bh, int s,
                   float scale, cudaStream_t stream) {
  decode_kernel<T, D><<<(unsigned)bh, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(valid_len),
      static_cast<T*>(out), s, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, out [bh, d]; k, v [bh, s, d],
// contiguous, 16-byte aligned; valid_len one int32 on the device; d in
// {64, 128}. Returns a cudaError_t.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* valid_len, void* out, long long bh,
                     long long s, int d, int dtype, float scale,
                     void* stream) {
  if (bh <= 0 || s <= 0 || bh > 0x7fffffffLL || s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int is = (int)s;
  if (dtype == 0 && d == 64)
    return (int)launch<float, 64>(q, k, v, valid_len, out, bh, is, scale, st);
  if (dtype == 0 && d == 128)
    return (int)launch<float, 128>(q, k, v, valid_len, out, bh, is, scale, st);
  if (dtype == 1 && d == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, valid_len, out, bh, is, scale, st);
  if (dtype == 1 && d == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, valid_len, out, bh, is, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
