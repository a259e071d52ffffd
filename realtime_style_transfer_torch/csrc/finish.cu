// finish: the last CIN and the sigmoid, written into the packed output frame.
//
// Replaces run_pointwise of FusedTransfer._kernel_impl
// (realtime_style_transfer_tpu/ops/pallas/fused_transfer.py).  Each block
// folds a = scale * rsqrt(var + eps), b = bias - mean * a from the final
// stage's moments, then writes its tile of the (H/4, W/4, out_c) bf16
// output: channel ((dy*4 + dx) * C + c) of packed pixel (py, px) is
// sigmoid(f) of logical pixel (yy, xx) = (4py + dy, 4px + dx), with
// f = a*x + b, f32 arithmetic, and channels >= 16*C are zero.  Dual style
// also folds the second style's rows into the deltas da = a1 - a,
// db = b1 - b and blends per pixel, f = (x*a + b) + w*(x*da + db), with w
// the (H, W) weight plane at (yy, xx).
//
// Bound on the H100: one elementwise pass (read H*W*C bf16 and, dual, the
// H*W weight plane; write the packed frame) is bound by bytes; 80 of the
// frame's 128 output lanes are zeros.  Design: a block owns tpx packed
// columns of one packed row (ops/kernels.py finish_plan sizes the tile and
// the grid; finish_map replays this index map in numpy).  Its 4 input rows,
// each a contiguous span of 4*tpx*C values (and, dual, 4*tpx weights), come
// into shared memory by 16-byte cp.async copies from the 16-byte boundary at
// or below the span's start (the span starts e0 % 8 values into its shared
// row).  While they fly, the block stores the zero vectors (channels at or
// above 16*C), which read nothing.  Then each thread owns one real 16-byte
// output vector (8 channels: v = tid % 2C) of every (256 / 2C)-th packed
// pixel, so its 8 shared offsets and affine rows stay fixed and every lane
// of a warp computes (tpx is a multiple of 256 / 2C); it reads 8 values from
// shared memory and stores 8 sigmoids at once.  All index math is 32-bit
// (the wrapper refuses frames whose offsets need more).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_C = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// Copy values [e0, e0 + n) of `src` into `dst` from the 16-byte boundary at
// or below e0 up to the one at or above e0 + n; returns e0's place in dst.
// 8-value granules; thread `tid` of the block takes granules tid, tid + 256...
__device__ __forceinline__ int stage_span(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int e0, int n, int tid) {
  const int a0 = e0 & ~7;
  const int granules = (e0 + n - a0 + 7) >> 3;
  for (int g = tid; g < granules; g += NTHREADS) cp_async16(dst + 8 * g, src + a0 + 8 * g);
  return e0 - a0;
}

__global__ void __launch_bounds__(NTHREADS) finish_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ scale1, const float* __restrict__ bias1,
    const __nv_bfloat16* __restrict__ weight, float count, float eps,
    __nv_bfloat16* __restrict__ out, int W, int C, int out_c, int tpx) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __shared__ float s_a[MAX_C], s_b[MAX_C], s_da[MAX_C], s_db[MAX_C];
  const bool dual = weight != nullptr;
  const int tid = threadIdx.x;
  const int wp = W >> 2;
  const int py = blockIdx.y, px0 = blockIdx.x * tpx;
  const int ncols = min(tpx, wp - px0);
  const int pitch = ((4 * tpx * C + 7) & ~7) + 16;  // a staged input row, values
  const int wpitch = ((4 * tpx + 7) & ~7) + 16;     // a staged weight row
  __nv_bfloat16* sx = smem;
  __nv_bfloat16* sw = smem + 4 * pitch;
  // this thread's channel of the moments and style rows first: queued behind
  // the bulk copies they would wait for them
  float sum = 0.f, sq = 0.f, sc = 0.f, bi = 0.f, sc1 = 0.f, bi1 = 0.f;
  if (tid < C) {  // C <= NTHREADS: channel tid
    sum = stats[tid];
    sq = stats[C + tid];
    sc = scale[tid];
    bi = bias[tid];
    if (dual) {
      sc1 = scale1[tid];
      bi1 = bias1[tid];
    }
  }
  // the block's 4 input rows (and weight rows), all copies in flight at once
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const int yy = 4 * py + dy;
    stage_span(sx + dy * pitch, x, (yy * W + 4 * px0) * C, 4 * ncols * C, tid);
    if (dual) stage_span(sw + dy * wpitch, weight, yy * W + 4 * px0, 4 * ncols, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < C) {
    const float mean = sum / count;
    const float var = __fsub_rn(sq / count, __fmul_rn(mean, mean));
    const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));
    const float a = __fmul_rn(sc, inv);
    const float b = __fsub_rn(bi, __fmul_rn(mean, a));
    s_a[tid] = a;
    s_b[tid] = b;
    if (dual) {
      const float a1 = __fmul_rn(sc1, inv);
      s_da[tid] = __fsub_rn(a1, a);
      s_db[tid] = __fsub_rn(__fsub_rn(bi1, __fmul_rn(mean, a1)), b);
    }
  }
  // the zero lanes first: they read nothing
  const int nvo = out_c >> 3, nreal = 2 * C, nzero = nvo - nreal;
  uint4* row = reinterpret_cast<uint4*>(out + (py * wp + px0) * out_c);
  if (nzero > 0) {
    const int pz = NTHREADS / nzero, qz = tid / nzero;
    if (qz < pz)
      for (int px = qz; px < ncols; px += pz)
        row[px * nvo + nreal + tid % nzero] = make_uint4(0, 0, 0, 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the real vectors: thread tid owns vector v of every p-th packed pixel
  const int p = NTHREADS / nreal, v = tid % nreal, q = tid / nreal;
  if (q >= p) return;
  int off[8], woff[8];
  float a[8], b[8], da[8], db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = 8 * v + j, sub = ch / C, c = ch - sub * C;
    const int dy = sub >> 2, dx = sub & 3;
    const int e0 = ((4 * py + dy) * W + 4 * px0);  // the staged row's first pixel
    off[j] = dy * pitch + ((e0 * C) & 7) + dx * C + c;
    woff[j] = dy * wpitch + (e0 & 7) + dx;
    a[j] = s_a[c];
    b[j] = s_b[c];
    da[j] = dual ? s_da[c] : 0.f;
    db[j] = dual ? s_db[c] : 0.f;
  }
  for (int px = q; px < ncols; px += p) {
    uint32_t y[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float s[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float xv = __bfloat162float(sx[off[j + i] + 4 * C * px]);
        float z = __fadd_rn(__fmul_rn(xv, a[j + i]), b[j + i]);
        if (dual) {
          const float wv = __bfloat162float(sw[woff[j + i] + 4 * px]);
          z = __fadd_rn(z, __fmul_rn(wv, __fadd_rn(__fmul_rn(xv, da[j + i]), db[j + i])));
        }
        s[i] = 1.0f / (1.0f + expf(-z));
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(s[0], s[1]);
      y[j / 2] = *reinterpret_cast<const uint32_t*>(&h);
    }
    row[px * nvo + v] = make_uint4(y[0], y[1], y[2], y[3]);
  }
}

}  // namespace

// The tile width tpx and the grid come from ops/kernels.py finish_plan.
extern "C" int rst_finish(const void* x, const void* stats, const void* scale,
                          const void* bias, const void* scale1, const void* bias1,
                          const void* weight, float count, float eps, void* out,
                          int H, int W, int C, int out_c, int tpx, void* stream) {
  const bool dual = weight != nullptr;
  // dual style needs both second-style rows and the weight plane
  if ((scale1 != nullptr) != dual || (bias1 != nullptr) != dual)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wp = W / 4;
  if (H % 4 || W % 4 || C < 1 || C > MAX_C || out_c % 8 || out_c < 16 * C ||
      out_c / 8 > NTHREADS || tpx < 1 ||
      (long long)H * W * C >= (1LL << 31) || (long long)(H / 4) * wp * out_c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * 4 * (((4 * tpx * C + 7) & ~7) + 16) +
                   (dual ? 2 * 4 * (((4 * tpx + 7) & ~7) + 16) : 0);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((wp + tpx - 1) / tpx, H / 4);
  finish_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(scale1), static_cast<const float*>(bias1),
      static_cast<const __nv_bfloat16*>(weight), count, eps,
      static_cast<__nv_bfloat16*>(out), W, C, out_c, tpx);
  return static_cast<int>(cudaGetLastError());
}
