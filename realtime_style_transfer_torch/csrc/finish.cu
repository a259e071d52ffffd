// finish: the last CIN and the sigmoid, written into the packed output frame.
//
// Replaces run_pointwise of FusedTransfer._kernel_impl
// (realtime_style_transfer_tpu/ops/pallas/fused_transfer.py).  Each block
// folds a = scale * rsqrt(var + eps), b = bias - mean * a from the final
// stage's moments, then a grid-stride loop writes every element of the
// (H/4, W/4, out_c) bf16 output: channel ((dy*4 + dx) * C + c) of packed pixel
// (py, px) is sigmoid(f) of logical pixel (yy, xx) = (4py + dy, 4px + dx),
// with f = a*x + b, f32 arithmetic, and channels >= 16*C are zero.  Dual style
// also folds the second style's rows into the deltas da = a1 - a, db = b1 - b
// and blends per pixel, f = (x*a + b) + w*(x*da + db), with w the (H, W)
// weight plane at (yy, xx).
//
// Bound on the H100: one elementwise pass (read H*W*C bf16 and, dual, the
// H*W weight plane; write the packed frame) is bound by bytes; the design
// reads and writes each element once, with consecutive threads on
// consecutive output addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_C = 128;

__global__ void __launch_bounds__(NTHREADS) finish_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ scale1, const float* __restrict__ bias1,
    const __nv_bfloat16* __restrict__ weight, float count, float eps,
    __nv_bfloat16* __restrict__ out, int H, int W, int C, int out_c) {
  __shared__ float s_a[MAX_C], s_b[MAX_C], s_da[MAX_C], s_db[MAX_C];
  const bool dual = weight != nullptr;
  for (int c = threadIdx.x; c < C; c += NTHREADS) {
    const float mean = stats[c] / count;
    const float var = __fsub_rn(stats[C + c] / count, __fmul_rn(mean, mean));
    const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));
    const float a = __fmul_rn(scale[c], inv);
    const float b = __fsub_rn(bias[c], __fmul_rn(mean, a));
    s_a[c] = a;
    s_b[c] = b;
    if (dual) {
      const float a1 = __fmul_rn(scale1[c], inv);
      s_da[c] = __fsub_rn(a1, a);
      s_db[c] = __fsub_rn(__fsub_rn(bias1[c], __fmul_rn(mean, a1)), b);
    }
  }
  __syncthreads();
  const int wp = W / 4;
  const long long total = (long long)(H / 4) * wp * out_c;
  for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * NTHREADS) {
    const int ch = (int)(i % out_c);
    const long long q = i / out_c;
    const int px = (int)(q % wp), py = (int)(q / wp);
    float y = 0.f;
    if (ch < 16 * C) {
      const int sub = ch / C, c = ch - sub * C;
      const int yy = 4 * py + (sub >> 2), xx = 4 * px + (sub & 3);
      const size_t pix = (size_t)yy * W + xx;
      const float v = __bfloat162float(x[pix * C + c]);
      float z = __fadd_rn(__fmul_rn(v, s_a[c]), s_b[c]);
      if (dual) {
        const float wv = __bfloat162float(weight[pix]);
        z = __fadd_rn(z, __fmul_rn(wv, __fadd_rn(__fmul_rn(v, s_da[c]), s_db[c])));
      }
      y = 1.0f / (1.0f + expf(-z));
    }
    out[i] = __float2bfloat16_rn(y);
  }
}

}  // namespace

extern "C" int rst_finish(const void* x, const void* stats, const void* scale,
                          const void* bias, const void* scale1, const void* bias1,
                          const void* weight, float count, float eps, void* out,
                          int H, int W, int C, int out_c, void* stream) {
  // dual style needs both second-style rows and the weight plane
  if ((scale1 != nullptr) != (weight != nullptr) || (bias1 != nullptr) != (weight != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)(H / 4) * (W / 4) * out_c;
  long long blocks = (total + NTHREADS - 1) / NTHREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  finish_kernel<<<(unsigned)blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(scale1), static_cast<const float*>(bias1),
      static_cast<const __nv_bfloat16*>(weight), count, eps,
      static_cast<__nv_bfloat16*>(out), H, W, C, out_c);
  return static_cast<int>(cudaGetLastError());
}
