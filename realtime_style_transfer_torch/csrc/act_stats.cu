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
// below that).  Each input element is counted once.
//
// A separate pass, where the TPU fuses it into the conv: it runs only while
// calibrating or checking, never per deploy frame; it counts each element
// once, which the gather path (one transform per tap) cannot; and it leaves
// the register-bound conv kernel alone.
//
// Bound on the H100: one read of the stage input (and skip, weight plane),
// a few f32 operations a value: bytes.  A thread of an NHWC pass keeps the
// same 8 channels for every vector it reads (Cin / 8 divides the thread
// stride), so maxima and counts stay in registers until one shared and one
// global atomic per channel and block; max uses atomicMax on the float bits,
// valid for non-negative floats.
#include "stage_common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_CIN = 128;
constexpr int MAX_BLOCKS = 132 * 2;  // few blocks: each adds 2 global atomics a channel

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
  const float* act_inv;      // (Cin,) or null: no clip count
  unsigned int* max_out;     // (Cin,) f32 bits, maxed into
  int* clips_out;            // (Cin,) added into, null without act_inv
  int H, W, Cin, pack_c;
};

__global__ void __launch_bounds__(NTHREADS) act_stats_kernel(const Params p) {
  __shared__ float sa[MAX_CIN], sb[MAX_CIN], sda[MAX_CIN], sdb[MAX_CIN], sinv[MAX_CIN];
  __shared__ unsigned int smax[MAX_CIN];
  __shared__ int scnt[MAX_CIN];
  const bool check = p.act_inv != nullptr;
  for (int c = threadIdx.x; c < p.Cin; c += NTHREADS) {
    if (p.in_affine) {
      float a, b, da, db;
      fold_cin(p.in_stats, p.in_scale, p.in_bias, p.in_scale1, p.in_bias1, p.Cin, c,
               p.in_count, p.eps, p.dual, a, b, da, db);
      sa[c] = a;
      sb[c] = b;
      if (p.dual) {
        sda[c] = da;
        sdb[c] = db;
      }
    }
    sinv[c] = check ? p.act_inv[c] : 0.f;
    smax[c] = 0u;
    scnt[c] = 0;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * NTHREADS;
  if (p.pack_c > 0) {
    // the stem's input: channel (dy*4 + dx)*Cin + c of packed pixel is
    // logical channel c; no prologue
    const int cp = 16 * p.Cin;
    const long long n = (long long)(p.H / 4) * (p.W / 4) * cp;
    for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n; i += stride) {
      const int ch = (int)(i % cp);
      const float f = fabsf(__bfloat162float(p.x[(i / cp) * p.pack_c + ch]));
      const int c = ch % p.Cin;
      atomicMax(&smax[c], __float_as_uint(f));
      if (check && __fmul_rn(f, sinv[c]) > 127.5f) atomicAdd(&scnt[c], 1);
    }
  } else {
    const bool transform = p.in_affine || p.in_relu || p.skip_in != nullptr;
    const int c8s = p.Cin / 8;
    const int c = (threadIdx.x % c8s) * 8;  // this thread's channels, every vector
    const long long n = (long long)p.H * p.W * c8s;
    float m[8];
    int k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[j] = 0.f;
      k[j] = 0;
    }
    for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n; i += stride) {
      const long long pix = i / c8s;
      const size_t off = (size_t)pix * p.Cin + c;
      uint4 v = *reinterpret_cast<const uint4*>(p.x + off);
      if (transform) {
        const float wv = p.dual ? __bfloat162float(p.weight[pix]) : 0.f;
        v = transform8(v, c, sa, sb, sda, sdb, wv, p.in_affine, p.dual, p.in_relu,
                       p.skip_in ? p.skip_in + off : nullptr);
      }
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = fabsf(__bfloat162float(h[j]));
        m[j] = fmaxf(m[j], f);
        if (check && __fmul_rn(f, sinv[c + j]) > 127.5f) ++k[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicMax(&smax[c + j], __float_as_uint(m[j]));
      if (check) atomicAdd(&scnt[c + j], k[j]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < p.Cin; c += NTHREADS) {
    atomicMax(&p.max_out[c], smax[c]);
    if (check) atomicAdd(&p.clips_out[c], scnt[c]);
  }
}

}  // namespace

extern "C" int rst_act_stats(
    const void* x, const void* in_stats, const void* in_scale, const void* in_bias,
    const void* in_scale1, const void* in_bias1, const void* weight, float in_count,
    float eps, int in_affine, int in_relu, const void* skip_in, const void* act_inv,
    void* max_out, void* clips_out, int H, int W, int Cin, int pack_c, void* stream) {
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
  p.clips_out = static_cast<int*>(clips_out);
  p.H = H; p.W = W; p.Cin = Cin; p.pack_c = pack_c;
  const bool bad_dual = (in_scale1 != nullptr) != p.dual ||
                        (in_bias1 != nullptr) != p.dual || (p.dual && !in_affine);
  const bool bad_pack = pack_c > 0 && (in_affine || in_relu || skip_in || 16 * Cin > pack_c ||
                                       H % 4 || W % 4);
  const bool bad_nhwc = pack_c == 0 && (Cin < 8 || Cin % 8 || NTHREADS % (Cin / 8));
  if (bad_dual || bad_pack || bad_nhwc || Cin < 1 || Cin > MAX_CIN || !max_out ||
      (act_inv != nullptr) != (clips_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = pack_c > 0 ? (long long)(H / 4) * (W / 4) * 16 * Cin
                                 : (long long)H * W * (Cin / 8);
  long long blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  act_stats_kernel<<<(unsigned)blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
