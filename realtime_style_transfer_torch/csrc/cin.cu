// cin: conditional instance norm of an NHWC (B, H, W, C) tensor, f32 or bf16,
// in two launches, as the TPU kernel's two pallas_calls.
//
// Replaces realtime_style_transfer_tpu/ops/pallas/cin.py: _stats_kernel (:52)
// and _normalize_kernel (:64) behind cin_pallas (:121).
//
//   stats      per (b, c): sum x and sum x^2 in f32 over the H*W pixels,
//              each scaled once by 1/(H*W) at the end -> (B, 2, C) f32
//              [mean, mean of squares].  (The TPU kernel adds sum * (1/HW)
//              per H tile; the two orders differ by a few f32 ulps.)  The sum
//              is taken in an order fixed by the grid, so two calls give the
//              same bits: a block owns ROWS pixels of one image; its threads
//              hold V channels each and step over the pixels by a fixed
//              stride; the block adds its threads' sums in lane order and
//              writes its [2, C] partial; the block that takes the image's
//              last integer ticket adds the partials in block order, scales
//              them and resets the ticket.
//   normalize  var = meansq - mean^2, inv = rsqrt(var + eps), s = inv *
//              scale, t = bias - mean * s, all f32 (a block folds them once
//              into shared memory); out = T(f32(x) * s + t), written to a
//              fresh tensor (autograd keeps x for the backward).
//
// Bound on the H100: bytes.  The function reads x once and writes out once;
// this design reads x twice (stats, then normalize), so it can reach 3/2 of
// that bound, the TPU kernel's own traffic.  Loads are 16 bytes a thread
// (8 bf16 or 4 f32 channels) where C allows, with neighbouring threads on
// neighbouring channels of one pixel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads a block
constexpr int ROWS = 512;   // pixels a stats block sums

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __bfloat162float(p[j]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// grid (ceil(HW / ROWS), B); partials [B][gridDim.x][2][C]; tickets [B], zero.
template <typename T, int V>
__global__ void __launch_bounds__(NT) cin_stats_kernel(
    const T* __restrict__ x, int HW, int C, float inv_n, float* __restrict__ partials,
    int* __restrict__ tickets, float* __restrict__ stats) {
  __shared__ float ssum[NT * V], ssq[NT * V];
  __shared__ int last;
  const int tid = threadIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int nvec = C / V, lanes = NT / nvec;
  const int vec = tid % nvec, lane = tid / nvec;
  if (lane < lanes) {
    float s[V], q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
    const int p0 = blockIdx.x * ROWS, p1 = min(p0 + ROWS, HW);
    const T* base = x + (size_t)b * HW * C + vec * V;
    // unrolled so that four loads are in flight before their adds, which
    // keep their order
#pragma unroll 4
    for (int pix = p0 + lane; pix < p1; pix += lanes) {
      float v[V];
      load_vec<V>(base + (size_t)pix * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] = __fadd_rn(s[j], v[j]);
        q[j] = __fadd_rn(q[j], __fmul_rn(v[j], v[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ssum[lane * C + vec * V + j] = s[j];
      ssq[lane * C + vec * V + j] = q[j];
    }
  }
  __syncthreads();
  float* mine = partials + ((size_t)b * nblk + blockIdx.x) * 2 * C;
  for (int c = tid; c < C; c += NT) {
    float s = 0.f, q = 0.f;
    for (int l = 0; l < lanes; ++l) {
      s += ssum[l * C + c];
      q += ssq[l * C + c];
    }
    mine[c] = s;
    mine[C + c] = q;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + b, 1) == nblk - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* first = partials + (size_t)b * nblk * 2 * C;
  for (int i = tid; i < 2 * C; i += NT) {
    float s = 0.f;
#pragma unroll 4
    for (int k = 0; k < nblk; ++k) s += __ldcg(first + (size_t)k * 2 * C + i);
    stats[(size_t)b * 2 * C + i] = __fmul_rn(s, inv_n);
  }
  if (tid == 0) tickets[b] = 0;
}

// grid (blocks, B); dynamic shared memory 2 * C floats.
template <typename T, int V>
__global__ void __launch_bounds__(NT) cin_normalize_kernel(
    const T* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ scale,
    const float* __restrict__ bias, float eps, T* __restrict__ out, int HW, int C) {
  extern __shared__ float st[];  // [s (C), t (C)]
  const int tid = threadIdx.x, b = blockIdx.y;
  for (int c = tid; c < C; c += NT) {
    const float mean = stats[(size_t)b * 2 * C + c];
    const float var = __fsub_rn(stats[(size_t)b * 2 * C + C + c], __fmul_rn(mean, mean));
    const float inv = rsqrtf(__fadd_rn(var, eps));
    const float s = __fmul_rn(inv, scale[(size_t)b * C + c]);
    st[c] = s;
    st[C + c] = __fsub_rn(bias[(size_t)b * C + c], __fmul_rn(mean, s));
  }
  __syncthreads();
  const int nvec = C / V;
  const long long total = (long long)HW * nvec;
  const T* xb = x + (size_t)b * HW * C;
  T* ob = out + (size_t)b * HW * C;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * NT + tid; i < total;
       i += (long long)gridDim.x * NT) {
    const int c0 = (int)(i % nvec) * V;
    const size_t off = (size_t)(i / nvec) * C + c0;
    float v[V];
    load_vec<V>(xb + off, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __fadd_rn(__fmul_rn(v[j], st[c0 + j]), st[C + c0 + j]);
    store_vec<V>(ob + off, v);
  }
}

template <typename T, int V>
cudaError_t stats_launch(const void* x, void* partials, void* tickets, void* stats, int B,
                         int HW, int C, float inv_n, int partials_cap, cudaStream_t s) {
  const int nblk = (HW + ROWS - 1) / ROWS;
  if (C / V > NT || (long long)B * nblk * 2 * C > partials_cap) return cudaErrorInvalidValue;
  cin_stats_kernel<T, V><<<dim3(nblk, B), NT, 0, s>>>(
      static_cast<const T*>(x), HW, C, inv_n, static_cast<float*>(partials),
      static_cast<int*>(tickets), static_cast<float*>(stats));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t normalize_launch(const void* x, const void* stats, const void* scale,
                             const void* bias, float eps, void* out, int B, int HW, int C,
                             cudaStream_t s) {
  if (C > 6144) return cudaErrorInvalidValue;  // 2 * C floats of shared memory
  const long long total = (long long)HW * (C / V);
  long long blocks = (total + NT - 1) / NT;
  const long long cap = (132 * 8 + B - 1) / B;  // about 8 blocks an SM in all
  if (blocks > cap) blocks = cap;
  cin_normalize_kernel<T, V><<<dim3((unsigned)blocks, B), NT, 2 * C * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias), eps,
      static_cast<T*>(out), HW, C);
  return cudaGetLastError();
}

}  // namespace

// x (B, HW, C) f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous and 16-byte
// aligned; stats (B, 2, C) f32; partials at least B * ceil(HW / 512) * 2 * C
// floats; tickets B ints, zero (the kernel leaves them zero).
extern "C" int rst_cin_stats(const void* x, int bf16, void* partials, void* tickets,
                             void* stats, int B, int HW, int C, float inv_n, int partials_cap,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = C % 8 == 0 ? stats_launch<__nv_bfloat16, 8>(x, partials, tickets, stats, B, HW, C,
                                                      inv_n, partials_cap, s)
                     : stats_launch<__nv_bfloat16, 1>(x, partials, tickets, stats, B, HW, C,
                                                      inv_n, partials_cap, s);
  else
    err = C % 4 == 0 ? stats_launch<float, 4>(x, partials, tickets, stats, B, HW, C, inv_n,
                                              partials_cap, s)
                     : stats_launch<float, 1>(x, partials, tickets, stats, B, HW, C, inv_n,
                                              partials_cap, s);
  return static_cast<int>(err);
}

// scale, bias (B, C) f32; out like x.
extern "C" int rst_cin_normalize(const void* x, int bf16, const void* stats, const void* scale,
                                 const void* bias, float eps, void* out, int B, int HW, int C,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = C % 8 == 0
              ? normalize_launch<__nv_bfloat16, 8>(x, stats, scale, bias, eps, out, B, HW, C, s)
              : normalize_launch<__nv_bfloat16, 1>(x, stats, scale, bias, eps, out, B, HW, C, s);
  else
    err = C % 4 == 0 ? normalize_launch<float, 4>(x, stats, scale, bias, eps, out, B, HW, C, s)
                     : normalize_launch<float, 1>(x, stats, scale, bias, eps, out, B, HW, C, s);
  return static_cast<int>(err);
}
