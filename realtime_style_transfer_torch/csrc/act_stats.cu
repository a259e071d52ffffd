// act_stats: per-channel max |x'| of a conv stage's input and, under given
// int8 scales, the count of values the int8 engine would clip.
//
// Replaces the calibrate and check modes of FusedTransfer._kernel_impl
// (realtime_style_transfer_tpu/ops/pallas/fused_transfer.py:
// _kernel_fn_calibrate :929 and _kernel_fn_check :932, the reduction at
// :1365-1386).  x' is the value the consumer conv quantizes: the CIN affine
// (single or dual style), ReLU and skip of transform8, rounded to bf16; the
// stem reads the f4 frame pack and folds its 16 subpixels to the logical
// channels.  A value clips when |x'| * act_inv[c] > 127.5 (rint lands on 127
// below that).  Each input element is counted once.  The kernel maxes into
// and adds into rows the caller passes (one row of the caller's per-stage
// tables), so a calibrate or check run needs no fill and no copy per launch.
//
// A separate pass, where the TPU fuses it into the conv: it runs only while
// calibrating or checking, never per deploy frame; it counts each element
// once, which the conv stages' overlapping input tiles cannot; and it leaves
// the register-bound conv kernel alone.
//
// Bound on the H100: one read of the stage input (and skip, weight plane),
// a few f32 operations a value: bytes.  Design: a block owns a range of
// pixels (ops/kernels.py act_stats_plan sizes it: 2 blocks of 256 threads an
// SM where the input has the pixels; 4 an SM measured slower, since every
// block pays the fold and the flush); thread t reads vector v = t % V of
// every pixel it visits (V 16-byte vectors a pixel: Cin / 8 in NHWC, 2 * Cin
// of the stem's pack), so its 8 channels, their act_inv entries, and its
// maxima and clip counts stay in registers.  Its vectors (and skips) come
// by 16-byte cp.async copies into its own slots of a two-stage ring in
// shared memory, LOADS vectors a stage: both stages fly while the block
// folds its prologue, and each is refilled as soon as it is read, so a
// thread's next stage is in flight while it works.  The prologue rows sit
// in shared memory 9 floats a group of 8 channels apart, so transform8's
// reads of a warp's 16 groups hit 16 banks.  NHWC: lanes of a warp that
// share channels combine by shuffles, then one shared atomic a channel and
// warp.  The stem: logical channel (8v + j) % Cin, one flush of each
// thread's 8 pairs to shared memory at the end.  Then one global atomicMax
// (f32 bits, valid for non-negative floats) and one 64-bit atomicAdd a
// channel and block.  All index math is 32-bit.
#include "stage_common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_CIN = 128;
constexpr int LOADS = 4;   // 16-byte vectors (and skips) a thread copies a stage
constexpr int STAGES = 2;  // stages of a thread's ring in shared memory
// the prologue rows in shared memory: channel c at 9 * (c / 8) + c % 8, so
// the 16 groups of 8 channels a warp's lanes read start in 16 distinct banks
constexpr int ROW = MAX_CIN / 8 * 9;

struct Params {
  const __nv_bfloat16* x;
  const float* in_stats;
  const float* in_scale;
  const float* in_bias;
  const float* in_scale1;
  const float* in_bias1;
  const __nv_bfloat16* weight;
  float in_count;
  float eps;
  int in_affine;
  int in_relu;
  int dual;
  const __nv_bfloat16* skip_in;
  const float* act_inv;            // (Cin,) or null: no clip count
  unsigned int* max_out;           // (Cin,) f32 bits, maxed into
  unsigned long long* clips_out;   // (Cin,) int64, added into; null without act_inv
  long long* counters;             // clock counters of a profiled build, or null
  int Cin, pack_c, npix, pixels;   // pixels: a block's range
};

// The shared bytes of a block's ring: STAGES x LOADS 16-byte slots a thread
// for x, as many for the skip.
__host__ __device__ constexpr int ring_bytes(bool skip) {
  return STAGES * LOADS * (skip ? 2 : 1) * NTHREADS * 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// This thread's slot of vector u of ring stage s (x, then the skip's
// slots after all of x's): the block's threads side by side, so copies and
// reads touch 16 consecutive bytes a lane.
__device__ __forceinline__ uint4* slot(uint4* ring, int s, int u, bool skip) {
  return ring + ((skip ? STAGES * LOADS : 0) + s * LOADS + u) * NTHREADS + threadIdx.x;
}

// Copy the LOADS vectors of x (and of the skip) at pixels p0, p0 + ppb, ...
// below end (value offset px * stride + c0) into stage s of the thread's
// ring, as one cp.async group; the dual weights of those pixels go to wv.
__device__ __forceinline__ void issue(const Params& p, uint4* ring, int s, int p0, int ppb,
                                      int end, int stride, int c0, float (&wv)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int px = p0 + u * ppb;
    if (px < end) {
      const int off = px * stride + c0;
      cp_async16(slot(ring, s, u, false), p.x + off);
      if (p.skip_in) cp_async16(slot(ring, s, u, true), p.skip_in + off);
      wv[u] = p.dual ? __bfloat162float(p.weight[px]) : 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(NTHREADS, 2) act_stats_kernel(const Params p) {
  extern __shared__ uint4 ring[];
  __shared__ float sa[ROW], sb[ROW], sda[ROW], sdb[ROW];
  __shared__ unsigned int smax[MAX_CIN];
  __shared__ int scnt[MAX_CIN];
  const bool check = p.act_inv != nullptr;
  const int tid = threadIdx.x;
  const bool pack = p.pack_c > 0;
  const int nv = pack ? 2 * p.Cin : p.Cin / 8;  // vectors a pixel
  const int ppb = NTHREADS / nv;                // pixels the block reads at once
  const int v = tid % nv, q = tid / nv;
  const int start = blockIdx.x * p.pixels;
  const int end = min(start + p.pixels, p.npix);
  const int c0 = 8 * v;                        // the pack's or NHWC channel of value 0
  const int stride = pack ? p.pack_c : p.Cin;  // values between two pixels
  const int chunk = LOADS * ppb;               // pixels a stage
  const int first = q < ppb ? start + q : end;
  // this thread's channel of the prologue's moments and rows, and its act_inv
  // entries, are read first: queued behind the bulk copies they would wait
  // for them
  const bool folds = p.in_affine && tid < p.Cin;  // Cin <= NTHREADS
  float fold_in[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // stats[c], stats[C + c], rows
  if (folds) {
    fold_in[0] = p.in_stats[tid];
    fold_in[1] = p.in_stats[p.Cin + tid];
    fold_in[2] = p.in_scale[tid];
    fold_in[3] = p.in_bias[tid];
    if (p.dual) {
      fold_in[4] = p.in_scale1[tid];
      fold_in[5] = p.in_bias1[tid];
    }
  }
  int ch[8];  // each value's logical channel
  float inv[8], m[8];
  int k[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ch[j] = pack ? (c0 + j) % p.Cin : c0 + j;
    inv[j] = check ? p.act_inv[ch[j]] : 0.f;
    m[j] = 0.f;
    k[j] = 0;
  }
  // both stages' copies fly while the block folds its prologue
  float wv[STAGES][LOADS];
  issue(p, ring, 0, first, ppb, end, stride, c0, wv[0]);
  issue(p, ring, 1, first + chunk, ppb, end, stride, c0, wv[1]);
  if (folds) {
    // fold_cin on channel 0 of this thread's copies: channel tid's values
    float a, b, da, db;
    fold_cin(fold_in, fold_in + 2, fold_in + 3, fold_in + 4, fold_in + 5, 1, 0, p.in_count,
             p.eps, p.dual, a, b, da, db);
    const int r = tid + tid / 8;  // 9 * (c / 8) + c % 8
    sa[r] = a;
    sb[r] = b;
    if (p.dual) {
      sda[r] = da;
      sdb[r] = db;
    }
  }
  if (tid < p.Cin) {
    smax[tid] = 0u;
    scnt[tid] = 0;
  }
  __syncthreads();
  // PROFILE LAP 0
  const bool transform = p.in_affine || p.in_relu || p.skip_in != nullptr;
  for (int p0 = first; p0 < end; p0 += STAGES * chunk) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      const int pb = p0 + s * chunk;
      if (pb >= end) break;
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // stage s has landed
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (pb + u * ppb >= end) break;
        uint4 val = *slot(ring, s, u, false);
        if (transform) {
          const uint4 sv = p.skip_in ? *slot(ring, s, u, true) : make_uint4(0, 0, 0, 0);
          val = transform8(val, 9 * v, sa, sb, sda, sdb, wv[s][u], p.in_affine, p.dual,
                           p.in_relu,
                           p.skip_in ? reinterpret_cast<const __nv_bfloat16*>(&sv) : nullptr);
        }
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = fabsf(__bfloat162float(h[j]));
          m[j] = fmaxf(m[j], f);
          if (check && __fmul_rn(f, inv[j]) > 127.5f) ++k[j];
        }
      }
      // refill the stage just read (its values are in registers by now)
      issue(p, ring, s, pb + STAGES * chunk, ppb, end, stride, c0, wv[s]);
    }
  }
  // PROFILE LAP 1
  if (pack) {
    // one flush of this thread's 8 (max, count) pairs
    if (q < ppb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        atomicMax(&smax[ch[j]], __float_as_uint(m[j]));
        if (check && k[j]) atomicAdd(&scnt[ch[j]], k[j]);
      }
    }
  } else {
    // lanes nv, 2nv, ... apart hold the same channels (nv divides 32)
    for (int o = nv; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
        k[j] += __shfl_xor_sync(0xffffffffu, k[j], o);
      }
    }
    if ((tid & 31) < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        atomicMax(&smax[c0 + j], __float_as_uint(m[j]));
        if (check && k[j]) atomicAdd(&scnt[c0 + j], k[j]);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < p.Cin; c += NTHREADS) {
    if (smax[c]) atomicMax(&p.max_out[c], smax[c]);
    if (check && scnt[c]) atomicAdd(&p.clips_out[c], (unsigned long long)scnt[c]);
  }
  // PROFILE LAP 2
}

}  // namespace

// The grid (blocks, each owning `pixels` pixels) comes from ops/kernels.py
// act_stats_plan.
extern "C" int rst_act_stats(
    const void* x, const void* in_stats, const void* in_scale, const void* in_bias,
    const void* in_scale1, const void* in_bias1, const void* weight, float in_count,
    float eps, int in_affine, int in_relu, const void* skip_in, const void* act_inv,
    void* max_out, void* clips_out, void* counters, int H, int W, int Cin, int pack_c,
    int blocks, int pixels, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.in_stats = static_cast<const float*>(in_stats);
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_bias = static_cast<const float*>(in_bias);
  p.in_scale1 = static_cast<const float*>(in_scale1);
  p.in_bias1 = static_cast<const float*>(in_bias1);
  p.weight = static_cast<const __nv_bfloat16*>(weight);
  p.dual = weight != nullptr;
  p.in_count = in_count;
  p.eps = eps;
  p.in_affine = in_affine;
  p.in_relu = in_relu;
  p.skip_in = static_cast<const __nv_bfloat16*>(skip_in);
  p.act_inv = static_cast<const float*>(act_inv);
  p.max_out = static_cast<unsigned int*>(max_out);
  p.clips_out = static_cast<unsigned long long*>(clips_out);
  p.counters = static_cast<long long*>(counters);
  p.Cin = Cin;
  p.pack_c = pack_c;
  const bool pack = pack_c > 0;
  const long long npix = pack ? (long long)(H / 4) * (W / 4) : (long long)H * W;
  const long long values = npix * (pack ? pack_c : Cin);
  const bool bad_dual = (in_scale1 != nullptr) != p.dual ||
                        (in_bias1 != nullptr) != p.dual || (p.dual && !in_affine);
  const bool bad_pack = pack && (in_affine || in_relu || skip_in || 16 * Cin > pack_c ||
                                 pack_c % 8 || H % 4 || W % 4);
  const bool bad_nhwc = !pack && (Cin < 8 || Cin % 8 || 32 % (Cin / 8));
  if (bad_dual || bad_pack || bad_nhwc || Cin < 1 || Cin > MAX_CIN || !max_out ||
      (act_inv != nullptr) != (clips_out != nullptr) || values >= (1LL << 31) ||
      blocks < 1 || pixels < 1 || (long long)blocks * pixels < npix)
    return static_cast<int>(cudaErrorInvalidValue);
  p.npix = static_cast<int>(npix);
  p.pixels = pixels;
  const int smem = ring_bytes(skip_in != nullptr);
  static bool configured = false;  // the ring with skips takes more than 48 KB
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        act_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes(true));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  act_stats_kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
