// finish: the last CIN and the sigmoid, written into the packed output frame.
//
// Replaces run_pointwise of FusedTransfer._kernel_impl
// (realtime_style_transfer_tpu/ops/pallas/fused_transfer.py).  Each block
// folds a = scale * rsqrt(var + eps), b = bias - mean * a from the final
// stage's moments, then a grid-stride loop writes every element of the
// (H/4, W/4, out_c) bf16 output: channel ((dy*4 + dx) * C + c) of packed pixel
// (py, px) is sigmoid(a*x + b) of logical pixel (4py + dy, 4px + dx), f32
// arithmetic, and channels >= 16*C are zero.
//
// Bound on the H100: one elementwise pass (read H*W*C bf16, write the packed
// frame) is bound by bytes; the design reads and writes each element once,
// with consecutive threads on consecutive output addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_C = 128;

__global__ void __launch_bounds__(NTHREADS) finish_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float count, float eps, __nv_bfloat16* __restrict__ out, int H, int W,
    int C, int out_c) {
  __shared__ float s_a[MAX_C], s_b[MAX_C];
  for (int c = threadIdx.x; c < C; c += NTHREADS) {
    const float mean = stats[c] / count;
    const float var = __fsub_rn(stats[C + c] / count, __fmul_rn(mean, mean));
    const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));
    const float a = __fmul_rn(scale[c], inv);
    s_a[c] = a;
    s_b[c] = __fsub_rn(bias[c], __fmul_rn(mean, a));
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
      const float v = __bfloat162float(x[((size_t)yy * W + xx) * C + c]);
      const float z = __fadd_rn(__fmul_rn(v, s_a[c]), s_b[c]);
      y = 1.0f / (1.0f + expf(-z));
    }
    out[i] = __float2bfloat16_rn(y);
  }
}

}  // namespace

extern "C" int rst_finish(const void* x, const void* stats, const void* scale,
                          const void* bias, float count, float eps, void* out,
                          int H, int W, int C, int out_c, void* stream) {
  const long long total = (long long)(H / 4) * (W / 4) * out_c;
  long long blocks = (total + NTHREADS - 1) / NTHREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  finish_kernel<<<(unsigned)blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias), count,
      eps, static_cast<__nv_bfloat16*>(out), H, W, C, out_c);
  return static_cast<int>(cudaGetLastError());
}
