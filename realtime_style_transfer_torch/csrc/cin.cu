// cin: conditional instance norm of an NHWC (B, H, W, C) tensor, f32 or bf16,
// and its gradient, one launch each.
//
// Replaces realtime_style_transfer_tpu/ops/pallas/cin.py: _stats_kernel (:52)
// and _normalize_kernel (:64) behind cin_pallas (:121), two pallas_calls that
// read x twice.  The backward replaces no TPU kernel: the JAX package computes
// _cin_bwd (:134) in jnp.  Here it is a kernel of the same design.
//
//   forward   per (b, c): f32 sums of x and x^2 over the H*W pixels, each
//             scaled once by 1/(H*W) -> stats (B, 2, C) f32 [mean, mean of
//             squares]; var = meansq - mean^2, inv = rsqrt(var + eps),
//             s = inv * scale, t = bias - mean * s, all f32; out = T(f32(x) *
//             s + t) into a fresh tensor (autograd keeps x and the stats for
//             the backward).
//   backward  with the forward's saved moments: per (b, c) f32 sums of g and
//             of g * (x - mean); dbias = sum g, dscale = inv * sum g (x - mean),
//             dx = T(inv * scale * ((g - mean g) - (x - mean) * inv * mean(g
//             xhat))), the function of _cin_bwd.
//
// Bound on the H100: bytes.  The forward must read x once and write out once,
// the backward read x and g once and write dx once.  Every output of a (b, c)
// waits for a sum over all H*W pixels, so a launch that moves each byte once
// holds the pixels on chip until their sums are known: the training step's
// (4, 120, 240, 128) bf16 activation is 29.5 MB, and the card's 132 blocks of
// 227 KB of shared memory hold 30.7 MB.  Design: one cooperative launch of
// one block an SM, all resident at once.  Each image's pixels are cut into
// `parts` contiguous row ranges (items), B * parts of them, dealt to the
// blocks in turn (one each at the training shape: 873 rows, 223 KB).  Each
// block
//   1. loads its items' rows, all C channels, with 16-byte loads (8 bf16 or
//      4 f32 channels a thread where C allows, a block's threads on
//      consecutive 16 bytes, so each block streams one contiguous range), keeps
//      them in shared memory, and adds its threads' f32 sums;
//   2. adds them in a fixed order (shuffles over the threads of one channel
//      vector in a warp, then the warps one after another) and writes the
//      item's [2][C] partial to a scratch in global memory;
//   3. waits at a grid barrier, then adds its image's `parts` partials in
//      part order (a thread a channel, so a warp's loads of a part are one
//      line), so every block of an image holds the same bits and two calls
//      give the same bits; folds the coefficients in f32;
//   4. writes its outputs from shared memory with 16-byte stores.
// The rows past pix_sm (the backward's x and g, f32, larger images) are read
// from global memory a second time: the last rows a block loads, so the most
// likely to still be in the 50 MB L2, the more so as the rows kept in shared
// memory are loaded evict-first.  The outputs are stored evict-first too.
// What bounds a launch: its loads run at the memory's rate, sharing it with
// the write-back of the previous launch's outputs; the grid barrier, the fold
// and the stores, which go to L2, leave memory idle (halo_profile.py splits a
// block's time into these phases).
//
// Split mode (MODE SUMS, then MODE APPLY), for a frame whose rows are sharded
// over the ranks of a spatial group: a grid barrier cannot span ranks, so each
// pass is two launches with an all-reduce of the (B, 2, C) sums over the group
// between them, the shape of the TPU kernel's two pallas_calls.
//   forward sums    per (b, c) the unscaled f32 [sum x, sum x^2] over this
//                   launch's rows, in the one-launch kernel's order (items,
//                   then a grid barrier, then the parts added in order).
//   forward apply   from the group's sums and the group's pixel count n:
//                   mean = S / n, meansq = Q / n (a product with 1/n, as the
//                   one launch scales), the same fold, out = T(f32(x) * s + t)
//                   and the moments into stats.
//   backward sums   per (b, c) [sum g, sum g (x - mean)] over this launch's
//                   rows, from the forward's moments.
//   backward apply  dx from the group's sums, the fold of the one launch.
// Neither keeps rows in shared memory (pix_sm 0): the forward reads x twice
// and writes out once, the backward reads x and g twice and writes dx once.
// The sums launch is cooperative (its barrier is within the launch); the
// apply launch is a plain grid of the same blocks and items.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;             // threads a block
constexpr int NW = NT / 32;
constexpr int SMEM_CAP = 232448;    // the H100's shared memory a block (opt-in)
constexpr int AUX_FLOATS = 6;       // f32 a channel ahead of the rows: sums [2], coefficients [4]
// what a launch does: the one-launch kernel, or the two launches of the split
// mode (see the header)
constexpr int ONE = 0, SUMS = 1, APPLY = 2;

// V elements of T as one load: 16 bytes, or one element where C is not a
// multiple of V
template <typename T, int V>
using Raw = typename std::conditional<V * sizeof(T) == 16, uint4, T>::type;

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) v[0] = r;
    else v[0] = __bfloat162float(r);
  } else if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&v)[V]) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) r = v[0];
    else r = __float2bfloat16_rn(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    r = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                   __float_as_uint(v[3]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  }
  return r;
}

// a load with an L2 eviction hint: a value read for the last time goes first
// (ld.global.cs), so the rows a block keeps in shared memory leave L2 to the
// rows it reads again
template <typename R>
__device__ __forceinline__ R load(const R* p, bool last_use) {
  return last_use ? __ldcs(p) : __ldg(p);
}

__host__ __device__ constexpr int aux_bytes(int c) {
  return (AUX_FLOATS * 4 * c + 15) / 16 * 16;
}

struct Params {
  const void* x;          // (B, HW, C)
  const void* g;          // backward: the output's gradient, like x
  const float* stats_in;  // backward: (B, 2, C) the forward's moments
  const float* scale;     // (B, C)
  const float* bias;      // forward: (B, C)
  void* out;              // forward: the output; backward: dx; like x
  float* stats_out;       // forward: (B, 2, C)
  float* dscale;          // backward: (B, C)
  float* dbias;           // backward: (B, C)
  float* partials;        // (B * parts, 2, C) f32: each item's sums
  long long* counters;    // clock counters of a profiled build, or null
  float eps, inv_n;
  int b, hw, c;
  int parts;              // items of an image
  int ppb;                // rows an item: ceil(HW / parts)
  int pix_sm;             // rows a block keeps in shared memory, its items' in turn
  // split mode
  float* sums_out;        // SUMS: (B, 2, C) this launch's rows' sums
  const float* sums_in;   // APPLY: (B, 2, C) the group's sums
  int n_total;            // APPLY: the group's pixels an image
};

// grid: blocks, all resident (cooperative launch); block k takes items k,
// k + gridDim.x, ... of the B * parts.  Dynamic shared memory: aux_bytes(C),
// then pix_sm rows of x (backward: then pix_sm rows of g), a row C * sizeof(T).
template <typename T, int V, bool BWD, int MODE>
__global__ void __launch_bounds__(NT, 1) cin_kernel(const Params p) {
  using R = Raw<T, V>;
  constexpr int U = BWD ? 4 : 8;  // vectors a thread has in flight
  extern __shared__ __align__(16) unsigned char dyn[];
  float* acc = reinterpret_cast<float*>(dyn);  // [2][C]: the block's sums of an item
  float* coef = acc + 2 * p.c;                 // [4][C]: an item's folded coefficients
  const int nvec = p.c / V;                    // vectors a row (V divides C)
  R* sx = reinterpret_cast<R*>(dyn + aux_bytes(p.c));
  R* sg = sx + (size_t)p.pix_sm * nvec;

  const int tid = threadIdx.x, wid = tid >> 5;
  // thread (lane, vec) owns vector vec of rows lane, lane + lanes, ... of an
  // item; nvp, a power of two, divides NT
  const int nvp = nvec <= 1 ? 1 : 1 << (32 - __clz(nvec - 1));
  const int vec = tid & (nvp - 1), lane = tid / nvp, lanes = NT / nvp;
  const bool active = vec < nvec;
  const int items = p.b * p.parts;

  // ---- 1, 2. load each item's rows, keep them, add the sums ------------
  for (int j = 0, item = blockIdx.x; MODE != APPLY && item < items; ++j, item += gridDim.x) {
    const int b = item / p.parts, r0 = (item % p.parts) * p.ppb;
    const int nrows = max(0, min(p.ppb, p.hw - r0));
    const int n = active && lane < nrows ? (nrows - lane + lanes - 1) / lanes : 0;
    const size_t base = ((size_t)b * p.hw + r0) * p.c + vec * V;
    const T* xg = static_cast<const T*>(p.x) + base;
    const T* gg = static_cast<const T*>(p.g) + base;
    const int srow = j * p.ppb + lane;  // the thread's first row in shared memory
    float mean[V];                      // backward: the forward's means
#pragma unroll
    for (int k = 0; k < V; ++k)
      mean[k] = BWD && active ? p.stats_in[(size_t)b * 2 * p.c + vec * V + k] : 0.f;
    float s[V], q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
    for (int i0 = 0; i0 < n; i0 += U) {
      R rx[U], rg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < n) {
          const size_t off = (size_t)(lane + (i0 + u) * lanes) * p.c;
          const bool kept = srow + (i0 + u) * lanes < p.pix_sm;
          rx[u] = load(reinterpret_cast<const R*>(xg + off), kept);
          if constexpr (BWD) rg[u] = load(reinterpret_cast<const R*>(gg + off), kept);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < n) {
          const int row = srow + (i0 + u) * lanes;
          if (row < p.pix_sm) {
            sx[(size_t)row * nvec + vec] = rx[u];
            if constexpr (BWD) sg[(size_t)row * nvec + vec] = rg[u];
          }
          float v[V];
          unpack<T, V>(rx[u], v);
          if constexpr (BWD) {
            float w[V];
            unpack<T, V>(rg[u], w);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              s[k] = __fadd_rn(s[k], w[k]);
              q[k] = __fadd_rn(q[k], __fmul_rn(w[k], __fsub_rn(v[k], mean[k])));
            }
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              s[k] = __fadd_rn(s[k], v[k]);
              q[k] = __fadd_rn(q[k], __fmul_rn(v[k], v[k]));
            }
          }
        }
      }
    }
    // xor partners at distances >= nvp share vec; then lanes < nvp of each
    // warp hold its sums, distinct vectors, added warp by warp
#pragma unroll
    for (int k = 0; k < V; ++k) {
      for (int o = 16; o >= nvp; o >>= 1) {
        s[k] = __fadd_rn(s[k], __shfl_xor_sync(0xffffffffu, s[k], o));
        q[k] = __fadd_rn(q[k], __shfl_xor_sync(0xffffffffu, q[k], o));
      }
    }
    for (int c = tid; c < 2 * p.c; c += NT) acc[c] = 0.f;
    for (int w = 0; w < NW; ++w) {
      __syncthreads();
      if (wid == w && (tid & 31) < nvp && active) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc[vec * V + k] = __fadd_rn(acc[vec * V + k], s[k]);
          acc[p.c + vec * V + k] = __fadd_rn(acc[p.c + vec * V + k], q[k]);
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < 2 * p.c; c += NT) p.partials[(size_t)item * 2 * p.c + c] = acc[c];
    // PROFILE LAP 0
  }
  if constexpr (MODE != APPLY) cg::this_grid().sync();  // every item's partial is written
  // PROFILE LAP 1

  // ---- 3, 4. each item's coefficients from its image's partials; outputs ---
  for (int j = 0, item = blockIdx.x; item < items; ++j, item += gridDim.x) {
    const int b = item / p.parts, part = item % p.parts, r0 = part * p.ppb;
    for (int c = tid; c < p.c; c += NT) {
      const float* pp = p.partials + (size_t)b * p.parts * 2 * p.c + c;
      float S = 0.f, Q = 0.f;
      int k = 0;
      for (; MODE != APPLY && k + 16 <= p.parts; k += 16) {  // sixteen parts in flight, in order
        float a[16], e[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          a[u] = __ldcg(pp + (size_t)(k + u) * 2 * p.c);
          e[u] = __ldcg(pp + (size_t)(k + u) * 2 * p.c + p.c);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          S = __fadd_rn(S, a[u]);
          Q = __fadd_rn(Q, e[u]);
        }
      }
      for (; MODE != APPLY && k < p.parts; ++k) {
        S = __fadd_rn(S, __ldcg(pp + (size_t)k * 2 * p.c));
        Q = __fadd_rn(Q, __ldcg(pp + (size_t)k * 2 * p.c + p.c));
      }
      const size_t row = (size_t)b * p.c + c, st = (size_t)b * 2 * p.c + c;
      if constexpr (MODE == APPLY) {  // the group's sums, not this launch's partials
        S = p.sums_in[st];
        Q = p.sums_in[st + p.c];
      }
      if constexpr (MODE == SUMS) {
        if (part == 0) {
          p.sums_out[st] = S;
          p.sums_out[st + p.c] = Q;
        }
        continue;
      }
      if constexpr (!BWD) {
        const float mu = __fmul_rn(S, p.inv_n), musq = __fmul_rn(Q, p.inv_n);
        const float inv = rsqrtf(__fadd_rn(__fsub_rn(musq, __fmul_rn(mu, mu)), p.eps));
        const float sc = __fmul_rn(inv, p.scale[row]);
        coef[c] = sc;
        coef[p.c + c] = __fsub_rn(p.bias[row], __fmul_rn(mu, sc));
        if (part == 0) {
          p.stats_out[st] = mu;
          p.stats_out[st + p.c] = musq;
        }
      } else {
        const float mu = p.stats_in[st], musq = p.stats_in[st + p.c];
        const float inv = rsqrtf(__fadd_rn(__fsub_rn(musq, __fmul_rn(mu, mu)), p.eps));
        const float dscale = __fmul_rn(inv, Q);
        coef[c] = __fmul_rn(inv, p.scale[row]);                            // inv * scale
        coef[p.c + c] = __fmul_rn(S, p.inv_n);                             // mean of g
        coef[2 * p.c + c] = __fmul_rn(inv, __fmul_rn(dscale, p.inv_n));    // inv * mean(g xhat)
        coef[3 * p.c + c] = mu;
        if (MODE == ONE && part == 0) {
          p.dbias[row] = S;
          p.dscale[row] = dscale;
        }
      }
    }
    if constexpr (MODE == SUMS) continue;  // a sums launch writes no outputs
    __syncthreads();
    // PROFILE LAP 2
    float k0[V], k1[V], k2[V], k3[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ck = active ? vec * V + k : 0;
      k0[k] = coef[ck];
      k1[k] = coef[p.c + ck];
      k2[k] = BWD ? coef[2 * p.c + ck] : 0.f;
      k3[k] = BWD ? coef[3 * p.c + ck] : 0.f;
    }
    const int nrows = max(0, min(p.ppb, p.hw - r0));
    const int n = active && lane < nrows ? (nrows - lane + lanes - 1) / lanes : 0;
    const size_t base = ((size_t)b * p.hw + r0) * p.c + vec * V;
    const T* xg = static_cast<const T*>(p.x) + base;
    const T* gg = static_cast<const T*>(p.g) + base;
    T* og = static_cast<T*>(p.out) + base;
    const int srow = j * p.ppb + lane;
    for (int i0 = 0; i0 < n; i0 += U) {
      R rx[U], rg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < n) {
          const int row = srow + (i0 + u) * lanes;
          if (row < p.pix_sm) {
            rx[u] = sx[(size_t)row * nvec + vec];
            if constexpr (BWD) rg[u] = sg[(size_t)row * nvec + vec];
          } else {
            const size_t off = (size_t)(lane + (i0 + u) * lanes) * p.c;
            rx[u] = __ldcs(reinterpret_cast<const R*>(xg + off));
            if constexpr (BWD) rg[u] = __ldcs(reinterpret_cast<const R*>(gg + off));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < n) {
          float v[V];
          unpack<T, V>(rx[u], v);
          if constexpr (BWD) {
            float w[V];
            unpack<T, V>(rg[u], w);
#pragma unroll
            for (int k = 0; k < V; ++k)
              v[k] = __fmul_rn(k0[k], __fsub_rn(__fsub_rn(w[k], k1[k]),
                                                __fmul_rn(__fsub_rn(v[k], k3[k]), k2[k])));
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) v[k] = __fadd_rn(__fmul_rn(v[k], k0[k]), k1[k]);
          }
          const size_t off = (size_t)(lane + (i0 + u) * lanes) * p.c;
          __stcs(reinterpret_cast<R*>(og + off), pack<T, V>(v));
        }
      }
    }
    __syncthreads();  // the next item folds into coef
    // PROFILE LAP 3
  }
}

template <typename T, int V, bool BWD, int MODE>
cudaError_t launch(Params p, int blocks, cudaStream_t s) {
  if (p.b < 1 || p.hw < 1 || p.c < 1 || p.c % V || p.c / V > NT || p.parts < 1 ||
      p.parts > p.hw || blocks < 1 || blocks > p.b * p.parts || p.pix_sm < 0 ||
      (MODE != ONE && p.pix_sm != 0) || (MODE == APPLY && p.n_total < p.hw))
    return cudaErrorInvalidValue;
  p.ppb = (p.hw + p.parts - 1) / p.parts;
  const int per_block = (p.b * p.parts + blocks - 1) / blocks;
  const size_t smem = aux_bytes(p.c) + (size_t)p.pix_sm * p.c * sizeof(T) * (BWD ? 2 : 1);
  if ((long long)p.pix_sm > (long long)per_block * p.ppb || smem > SMEM_CAP)
    return cudaErrorInvalidValue;
  p.inv_n = 1.0f / (float)(MODE == APPLY ? p.n_total : p.hw);
  auto kernel = cin_kernel<T, V, BWD, MODE>;
  static bool configured = false;  // the attribute once per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // all blocks resident: the grid barrier
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == APPLY ? 0 : 1;  // an apply launch has no barrier
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BWD, int MODE = ONE>
int dispatch(const Params& p, int bf16, int blocks, cudaStream_t s) {
  cudaError_t err;
  if (bf16)
    err = p.c % 8 == 0 ? launch<__nv_bfloat16, 8, BWD, MODE>(p, blocks, s)
                       : launch<__nv_bfloat16, 1, BWD, MODE>(p, blocks, s);
  else
    err = p.c % 4 == 0 ? launch<float, 4, BWD, MODE>(p, blocks, s)
                       : launch<float, 1, BWD, MODE>(p, blocks, s);
  return static_cast<int>(err);
}

}  // namespace

// x (B, HW, C) f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous and 16-byte
// aligned; scale, bias (B, C) f32; out like x; stats (B, 2, C) f32; partials
// at least B * parts * 2 * C floats.  Each image in `parts` items of
// ceil(HW / parts) rows, dealt to `blocks` blocks (at most one an SM), which
// keep pix_sm rows each in shared memory (aux_bytes(C) + pix_sm * C *
// sizeof(T) <= 232448).  counters: null, or 8 int64 a block for a build with
// clock counters at the PROFILE LAP markers (halo_profile.py).
extern "C" int rst_cin_forward(const void* x, int bf16, const void* scale, const void* bias,
                               float eps, void* out, void* stats, void* partials,
                               void* counters, int B, int HW, int C, int parts, int blocks,
                               int pix_sm, void* stream) {
  Params p = {};
  p.x = x;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.stats_out = static_cast<float*>(stats);
  p.partials = static_cast<float*>(partials);
  p.counters = static_cast<long long*>(counters);
  p.eps = eps;
  p.b = B;
  p.hw = HW;
  p.c = C;
  p.parts = parts;
  p.pix_sm = pix_sm;
  return dispatch<false>(p, bf16, blocks, static_cast<cudaStream_t>(stream));
}

// g and dx like x; stats (B, 2, C) f32, the forward's; scale (B, C) f32;
// dscale, dbias (B, C) f32; the rest as above, pix_sm rows of x and of g.
extern "C" int rst_cin_backward(const void* x, const void* g, int bf16, const void* stats,
                                const void* scale, float eps, void* dx, void* dscale,
                                void* dbias, void* partials, void* counters, int B, int HW,
                                int C, int parts, int blocks, int pix_sm, void* stream) {
  Params p = {};
  p.x = x;
  p.g = g;
  p.stats_in = static_cast<const float*>(stats);
  p.scale = static_cast<const float*>(scale);
  p.out = dx;
  p.dscale = static_cast<float*>(dscale);
  p.dbias = static_cast<float*>(dbias);
  p.partials = static_cast<float*>(partials);
  p.counters = static_cast<long long*>(counters);
  p.eps = eps;
  p.b = B;
  p.hw = HW;
  p.c = C;
  p.parts = parts;
  p.pix_sm = pix_sm;
  return dispatch<true>(p, bf16, blocks, static_cast<cudaStream_t>(stream));
}

// The split mode (see the header).  Sums launches: x (and g) as above; sums
// (B, 2, C) f32, this launch's rows' [sum x, sum x^2] (backward: [sum g,
// sum g (x - mean)] from the forward's moments `stats`); partials at least
// B * parts * 2 * C floats.  Apply launches: sums the group's, n the group's
// pixels an image; the forward writes out and stats (B, 2, C) [mean, mean of
// squares], the backward dx.  No rows are kept in shared memory.
extern "C" int rst_cin_forward_sums(const void* x, int bf16, void* sums, void* partials, int B,
                                    int HW, int C, int parts, int blocks, void* stream) {
  Params p = {};
  p.x = x;
  p.sums_out = static_cast<float*>(sums);
  p.partials = static_cast<float*>(partials);
  p.b = B;
  p.hw = HW;
  p.c = C;
  p.parts = parts;
  return dispatch<false, SUMS>(p, bf16, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int rst_cin_forward_apply(const void* x, int bf16, const void* sums, int n,
                                     const void* scale, const void* bias, float eps, void* out,
                                     void* stats, int B, int HW, int C, int parts, int blocks,
                                     void* stream) {
  Params p = {};
  p.x = x;
  p.sums_in = static_cast<const float*>(sums);
  p.n_total = n;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.stats_out = static_cast<float*>(stats);
  p.eps = eps;
  p.b = B;
  p.hw = HW;
  p.c = C;
  p.parts = parts;
  return dispatch<false, APPLY>(p, bf16, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int rst_cin_backward_sums(const void* x, const void* g, int bf16, const void* stats,
                                     void* sums, void* partials, int B, int HW, int C,
                                     int parts, int blocks, void* stream) {
  Params p = {};
  p.x = x;
  p.g = g;
  p.stats_in = static_cast<const float*>(stats);
  p.sums_out = static_cast<float*>(sums);
  p.partials = static_cast<float*>(partials);
  p.b = B;
  p.hw = HW;
  p.c = C;
  p.parts = parts;
  return dispatch<true, SUMS>(p, bf16, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int rst_cin_backward_apply(const void* x, const void* g, int bf16, const void* stats,
                                      const void* sums, int n, const void* scale, float eps,
                                      void* dx, int B, int HW, int C, int parts, int blocks,
                                      void* stream) {
  Params p = {};
  p.x = x;
  p.g = g;
  p.stats_in = static_cast<const float*>(stats);
  p.sums_in = static_cast<const float*>(sums);
  p.n_total = n;
  p.scale = static_cast<const float*>(scale);
  p.out = dx;
  p.eps = eps;
  p.b = B;
  p.hw = HW;
  p.c = C;
  p.parts = parts;
  return dispatch<true, APPLY>(p, bf16, blocks, static_cast<cudaStream_t>(stream));
}
