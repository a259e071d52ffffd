// probe_int8: does mma.sync int8 -> s32 run at about twice the bf16 -> f32
// rate at the residual conv's shapes on Hopper?
//
// Replaces the two pallas_calls of tools/probe_int8_mxu.py: the plain
// (2400, 128) x (128, 128) product (:48-62) and the band pattern of the
// residual conv (:100-145: a bf16 band quantized in the kernel, then 9 tap
// products at th = 10, wp = 240, cin = cout = 128).  One kernel template does
// both: KS = 1 is the plain product over a 1-row "band" of 2400 pixels, KS = 3
// the 3x3 band conv (input rows y..y+2, columns x-1..x+1, zero outside the
// width).  Each arm repeats its whole body (window fill, quantize, every tap)
// nrep times inside the launch and accumulates, so the result is nrep times
// the product and the timed window is long.
//
// The inner loop is conv_stage.cu's: a warp owns 16 output pixels x 128
// columns, fragments are 32-bit shared-memory loads, bf16 takes m16n8k16 per
// 16-wide K slice and int8 m16n8k32 per 32-wide one, so int8 issues half the
// MMAs and half the fragment loads per multiply-add.  Bound: operations
// (2 * 2400 * 128 * 128 * taps per repetition against ~1 MB of operands).
#include <type_traits>

#include "stage_common.cuh"

namespace {

constexpr int C = 128;       // K and N of every product
constexpr int TM = 64;       // output pixels a block: 4 warps x 16
constexpr int NTHREADS = 128;

template <bool Q> struct Op {
  using T = __nv_bfloat16;
  static constexpr int PITCH = C + 8;   // 272-byte rows
};
template <> struct Op<true> {
  using T = int8_t;
  static constexpr int PITCH = C + 16;  // 144-byte rows
};

template <bool Q, int KS>
constexpr int smem_bytes() {
  return (KS * (TM + KS - 1) + C) * Op<Q>::PITCH * (int)sizeof(typename Op<Q>::T);
}

// Q: int8 operands; QIN: the input is bf16 and is quantized in the kernel
// (otherwise it already has the operand type).
template <bool Q, bool QIN, int KS>
__global__ void __launch_bounds__(NTHREADS) probe_kernel(const void* x, const void* w,
                                                         const float* act_inv, void* out,
                                                         int width, int nrep) {
  using T = typename Op<Q>::T;
  using Acc = typename std::conditional<Q, int, float>::type;
  constexpr int P = Op<Q>::PITCH;
  constexpr int WC = TM + KS - 1;
  constexpr int EPV = 16 / sizeof(T);  // B elements per 16 bytes
  extern __shared__ __align__(16) unsigned char dyn[];
  T* win = reinterpret_cast<T*>(dyn);  // [KS][WC][P]
  T* Bs = win + KS * WC * P;           // [C n][P], k along the row
  __shared__ float inv[C];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles = (width + TM - 1) / TM;
  const int y = blockIdx.x / tiles, x0 = (blockIdx.x - y * tiles) * TM;
  if constexpr (QIN)
    for (int c = tid; c < C; c += NTHREADS) inv[c] = act_inv[c];

  Acc acc[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;

  for (int rep = 0; rep < nrep; ++rep) {
    __syncthreads();  // the previous repetition's reads are done
    for (int e = tid; e < KS * WC * (C / 8); e += NTHREADS) {
      const int c = (e % (C / 8)) * 8, q = e / (C / 8);
      const int j = q % WC, r = q / WC;
      const int ix = x0 - KS / 2 + j;
      const size_t off = ((size_t)(y + r) * width + ix) * C + c;
      const bool in = ix >= 0 && ix < width;
      if constexpr (Q && !QIN) {
        uint2 v = make_uint2(0, 0);
        if (in) v = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(x) + off);
        *reinterpret_cast<uint2*>(win + q * P + c) = v;
      } else {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (in) v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + off);
        if constexpr (QIN)
          *reinterpret_cast<uint2*>(win + q * P + c) = quantize8(v, c, inv);
        else
          *reinterpret_cast<uint4*>(win + q * P + c) = v;
      }
    }
    for (int tap = 0; tap < KS * KS; ++tap) {
      __syncthreads();  // window filled; the previous tap's B reads are done
      const T* wt = static_cast<const T*>(w) + (size_t)tap * C * C;
      for (int e = tid; e < C * (C / EPV); e += NTHREADS) {
        const int n = e / (C / EPV), kq = (e % (C / EPV)) * EPV;
        *reinterpret_cast<uint4*>(Bs + n * P + kq) =
            *reinterpret_cast<const uint4*>(wt + (size_t)n * C + kq);
      }
      __syncthreads();
      const int ty = tap / KS, tx = tap - ty * KS;
      const T* a_lo = win + (ty * WC + tx + warp * 16 + g) * P;
      const T* a_hi = a_lo + 8 * P;
      if constexpr (Q) {
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 32) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(a_lo + k0 + 4 * t4);
          a[1] = *reinterpret_cast<const uint32_t*>(a_hi + k0 + 4 * t4);
          a[2] = *reinterpret_cast<const uint32_t*>(a_lo + k0 + 4 * t4 + 16);
          a[3] = *reinterpret_cast<const uint32_t*>(a_hi + k0 + 4 * t4 + 16);
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt) {
            const T* b = Bs + (nt * 8 + g) * P + k0 + 4 * t4;
            mma16832_s8(acc[nt], a, *reinterpret_cast<const uint32_t*>(b),
                        *reinterpret_cast<const uint32_t*>(b + 16));
          }
        }
      } else {
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(a_lo + k0 + 2 * t4);
          a[1] = *reinterpret_cast<const uint32_t*>(a_hi + k0 + 2 * t4);
          a[2] = *reinterpret_cast<const uint32_t*>(a_lo + k0 + 2 * t4 + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(a_hi + k0 + 2 * t4 + 8);
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt) {
            const T* b = Bs + (nt * 8 + g) * P + k0 + 2 * t4;
            mma16816(acc[nt], a, *reinterpret_cast<const uint32_t*>(b),
                     *reinterpret_cast<const uint32_t*>(b + 8));
          }
        }
      }
    }
  }
  Acc* o = static_cast<Acc*>(out);
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = x0 + warp * 16 + g + 8 * h;
      if (px < width) {
        Acc* dst = o + ((size_t)y * width + px) * C + nt * 8 + 2 * t4;
        dst[0] = acc[nt][2 * h];
        dst[1] = acc[nt][2 * h + 1];
      }
    }
}

template <bool Q, bool QIN, int KS>
cudaError_t launch(const void* x, const void* w, const float* act_inv, void* out,
                   int rows_out, int width, int nrep, cudaStream_t stream) {
  auto kernel = probe_kernel<Q, QIN, KS>;
  constexpr int bytes = smem_bytes<Q, KS>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = rows_out * ((width + TM - 1) / TM);
  kernel<<<blocks, NTHREADS, bytes, stream>>>(x, w, act_inv, out, width, nrep);
  return cudaGetLastError();
}

}  // namespace

// x: (rows_out + ks - 1, width, 128), int8 for the plain int8 arm, else bf16;
// w: (ks * ks, 128 n, 128 k) int8 or bf16; act_inv: (128,) f32, the band's
// int8 arm only; out: (rows_out * width, 128) s32 (int8) or f32 (bf16).
extern "C" int rst_probe(const void* x, const void* w, const void* act_inv, void* out,
                         int quant, int ks, int rows_out, int width, int nrep,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* inv = static_cast<const float*>(act_inv);
  cudaError_t err = cudaErrorInvalidValue;
  if (rows_out < 1 || width < 1 || nrep < 1) return static_cast<int>(err);
  if (ks == 1 && !inv)
    err = quant ? launch<true, false, 1>(x, w, inv, out, rows_out, width, nrep, s)
                : launch<false, false, 1>(x, w, inv, out, rows_out, width, nrep, s);
  else if (ks == 3 && quant && inv)
    err = launch<true, true, 3>(x, w, inv, out, rows_out, width, nrep, s);
  else if (ks == 3 && !quant && !inv)
    err = launch<false, false, 3>(x, w, inv, out, rows_out, width, nrep, s);
  return static_cast<int>(err);
}
