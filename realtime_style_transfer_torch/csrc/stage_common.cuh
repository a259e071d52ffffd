// Device code shared by conv_stage.cu and act_stats.cu: the CIN fold
// (act_stats.cu), the consumer prologue on 8 channels, the int8 quantize and
// the tensor-core MMAs.  Every rounding point is explicit (__fmul_rn, __fadd_rn,
// __float2int_rn), so the plain PyTorch versions in ops/kernels.py, which
// round after each operation in the same order, give the same bits.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// bf16 x bf16 -> f32, one 16x8x16 tile.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s8 x s8 -> s32, one 16x8x32 tile.  Fragments (g = lane / 4, t4 = lane % 4):
// a0 = A[g][4t4..4t4+3], a1 = A[g+8][4t4..], a2 / a3 the same at k + 16;
// b0 = B[n=g][k=4t4..], b1 = B[n=g][k=16+4t4..]; the accumulator has the
// m16n8k16 f32 layout (c0, c1 in row g, c2, c3 in row g+8, columns 2t4, 2t4+1).
__device__ __forceinline__ void mma16832_s8(int (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fold channel c of the producer's moments and the style rows into a*x + b
// and, dual, the second style's affine minus the first's (da, db).
// conv_stage.cu's block_init holds the same steps written out.
__device__ __forceinline__ void fold_cin(const float* stats, const float* scale,
                                         const float* bias, const float* scale1,
                                         const float* bias1, int C, int c, float count,
                                         float eps, bool dual, float& a, float& b,
                                         float& da, float& db) {
  const float mean = stats[c] / count;
  const float var = __fsub_rn(stats[C + c] / count, __fmul_rn(mean, mean));
  const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));
  a = __fmul_rn(scale[c], inv);
  b = __fsub_rn(bias[c], __fmul_rn(mean, a));
  if (dual) {
    const float a1 = __fmul_rn(scale1[c], inv);
    da = __fsub_rn(a1, a);
    db = __fsub_rn(__fsub_rn(bias1[c], __fmul_rn(mean, a1)), b);
  }
}

// The prologue on 8 consecutive channels of one pixel, whose dual-style
// weight is wv: mul, add[, mul, add, mul, add], relu, add, round to bf16.
__device__ __forceinline__ uint4 transform8(uint4 v, int c, const float* sa,
                                            const float* sb, const float* sda,
                                            const float* sdb, float wv, bool affine,
                                            bool dual, bool relu,
                                            const __nv_bfloat16* skip) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  uint4 sv = make_uint4(0, 0, 0, 0);
  if (skip) sv = *reinterpret_cast<const uint4*>(skip);
  const __nv_bfloat162* hs = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    if (affine) {
      const float2 x = f;
      const int c0 = c + 2 * j, c1 = c0 + 1;
      f.x = __fadd_rn(__fmul_rn(x.x, sa[c0]), sb[c0]);
      f.y = __fadd_rn(__fmul_rn(x.y, sa[c1]), sb[c1]);
      if (dual) {
        f.x = __fadd_rn(f.x, __fmul_rn(wv, __fadd_rn(__fmul_rn(x.x, sda[c0]), sdb[c0])));
        f.y = __fadd_rn(f.y, __fmul_rn(wv, __fadd_rn(__fmul_rn(x.y, sda[c1]), sdb[c1])));
      }
    }
    if (relu) {
      f.x = fmaxf(f.x, 0.f);
      f.y = fmaxf(f.y, 0.f);
    }
    if (skip) {
      const float2 s = __bfloat1622float2(hs[j]);
      f.x = __fadd_rn(f.x, s.x);
      f.y = __fadd_rn(f.y, s.y);
    }
    h[j] = __floats2bfloat162_rn(f.x, f.y);
  }
  return v;
}

// One bf16 value to int8: clamp(rint(f32(x) * inv), -127, 127), ties to even.
__device__ __forceinline__ int quantize1(__nv_bfloat16 x, float inv) {
  const int q = __float2int_rn(__fmul_rn(__bfloat162float(x), inv));
  return max(-127, min(127, q));
}

// 8 bf16 channels c..c+7 to 8 int8 values, packed little-endian.
__device__ __forceinline__ uint2 quantize8(uint4 v, int c, const float* inv) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint32_t w[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      packed |= (uint32_t)(quantize1(h[4 * j + i], inv[c + 4 * j + i]) & 0xff) << (8 * i);
    w[j] = packed;
  }
  return make_uint2(w[0], w[1]);
}
