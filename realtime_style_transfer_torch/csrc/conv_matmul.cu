// conv_matmul: VALID stride-1 conv of one (Hp, Wp, Cin) image by an HWIO
// (kh, kw, Cin, Cout) kernel as kh*kw tap matmuls, f32 accumulation, then an
// f32 epilogue (none, +bias, or the contract-block tail
// relu(relu(acc + bias) * scale + shift)), stored in the input's type.
//
// Replaces _kernel of realtime_style_transfer_tpu/ops/pallas/conv_matmul.py
// (:40, pallas_call :122), which the packed path runs at its stride-1 seams:
// the packed stem (5x5, 68 -> 128, contract) and the packed final conv (3x3,
// 256 -> 48 on rst-960, 512 -> 192 on rst-1920).
//
// Bound on the H100: operations.  The packed stem moves 46 MB for 50 GFLOP
// (rst-960) and the final conv 18 MB for 6.4 GFLOP, far above the ~295
// FLOP/byte at which bf16 tensor cores overtake HBM.  So the bf16 kernel
// keeps the MMAs fed from shared memory: a block owns a 16 x 8 output tile
// and BN = 8 * NT output channels, with eight warps (four along the pixels,
// two along Cout; a warp holds two m16 tiles, so each B fragment feeds two
// MMAs); for each 64-channel chunk of Cin it stages the tile's (16 + kh - 1)
// x (8 + kw - 1) input halo once, and for each tap the chunk's (64, BN)
// weight slice, read straight from the HWIO kernel (its rows are contiguous
// in Cout).  Both arrive by cp.async into a 2-stage ring, so the next step's
// copies run under this step's MMAs.  Fragments come from ldmatrix (the
// weight slice with .trans: it is k-major), the MMAs are mma.sync m16n8k16
// bf16 -> f32.  The TPU kernel's full-width row band (5 x 488 x 128 x 2 B =
// 624 KB for the packed stem) would not fit a block's 227 KB, hence the 2-D
// tile; the channel-chunked halo keeps the block at 66-104 KB on the path's
// launches whatever Cin is (2 x halo + 2 x weight slice), 2-3 blocks an SM.
// Cin is padded per tap to a multiple of 16 in shared memory (zeros), Cout to
// BN; loads are 16, 8 or 4 bytes wide as alignment allows, else scalar.
//
// f32 input runs an FMA kernel (one thread an output value, per-tap partial
// sums added in tap order, as the plain version adds its per-tap matmuls): no
// TF32 rounding, so it holds JAX's f32 tolerance.
#include "stage_common.cuh"

namespace {

constexpr int WM = 4, WN = 2;   // warps along the pixels and along Cout
constexpr int NTHREADS = 32 * WM * WN;
constexpr int TH = 4 * WM;      // output tile rows: warp row wm owns rows 4wm .. 4wm + 3
constexpr int TW = 8;           // output tile columns
constexpr int CK = 64;          // Cin chunk (a multiple of 16)
constexpr int WPITCH = CK + 8;  // halo pixel pitch in bf16: 144 bytes, ldmatrix conflict-free

struct Geo {
  int hp, wp, cin, kh, kw, cout, h, w;
  int wh, ww;      // halo tile: TH + kh - 1 rows, TW + kw - 1 columns
  int cin_k;       // Cin rounded up to 16
  int xbytes;      // bytes per copy of an input run: 16, 8, 4, or 0 for scalar copies
  int kbytes;      // the same for a kernel row run
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;  // src-size 0: the destination is zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

__device__ __forceinline__ float epilogue(float v, int n, int epi, const float* bias,
                                          const float* scale, const float* shift) {
  if (epi == 1) return __fadd_rn(v, bias[n]);
  if (epi == 2) {
    v = fmaxf(__fadd_rn(v, bias[n]), 0.f);
    return fmaxf(__fadd_rn(__fmul_rn(v, scale[n]), shift[n]), 0.f);
  }
  return v;
}

// Copy `count` runs of `run` elements (bf16) from global to shared memory by
// cp.async, `bytes` wide, or synchronously element by element when bytes is
// 0; run r goes from src_of(r) to dst_of(r), zero-filled where !valid(r).
template <typename Src, typename Dst, typename Valid>
__device__ __forceinline__ void stage_runs(int count, int run, int bytes, Src src_of,
                                           Dst dst_of, Valid valid) {
  if (bytes) {
    const int per = bytes / 2, pieces = run / per;
    for (int e = threadIdx.x; e < count * pieces; e += NTHREADS) {
      const int r = e / pieces, j = (e - r * pieces) * per;
      const bool ok = valid(r, j);
      cp_async(dst_of(r) + j, ok ? src_of(r) + j : src_of(0), bytes, ok);
    }
  } else {
    for (int e = threadIdx.x; e < count * run; e += NTHREADS) {
      const int r = e / run, j = e - r * run;
      dst_of(r)[j] = valid(r, j) ? src_of(r)[j] : __float2bfloat16(0.f);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
    conv_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
             const float* __restrict__ bias, const float* __restrict__ scale,
             const float* __restrict__ shift, __nv_bfloat16* __restrict__ out, Geo g, int epi) {
  static_assert(NT % WN == 0, "the block's n8 tiles split evenly between the warp columns");
  constexpr int BN = 8 * NT;
  constexpr int NTW = NT / WN;  // n8 tiles a warp
  constexpr int BPITCH = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = g.wh * g.ww * WPITCH;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][wh][ww][WPITCH]
  __nv_bfloat16* ws = win + 2 * halo;                             // [2][CK][BPITCH]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int tiles_x = (g.w + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int taps = g.kh * g.kw;
  const int steps = ((g.cin_k + CK - 1) / CK) * taps;

  // step s: Cin chunk s / taps, tap s % taps; the chunk's halo is staged
  // with its first tap
  auto issue = [&](int s) {
    const int chunk = s / taps, tap = s - chunk * taps;
    const int c0 = chunk * CK, cw = min(CK, g.cin_k - c0);
    if (tap == 0) {
      __nv_bfloat16* dst = win + (chunk & 1) * halo;
      stage_runs(
          g.wh * g.ww, cw, g.xbytes,
          [&](int q) {
            const int r = q / g.ww, c = q - r * g.ww;
            const int iy = min(ty0 + r, g.hp - 1), ix = min(tx0 + c, g.wp - 1);
            return x + ((size_t)iy * g.wp + ix) * g.cin + c0;
          },
          [&](int q) { return dst + q * WPITCH; },
          [&](int q, int j) {
            const int r = q / g.ww, c = q - r * g.ww;
            return ty0 + r < g.hp && tx0 + c < g.wp && c0 + j < g.cin;
          });
    }
    __nv_bfloat16* dst = ws + (s & 1) * CK * BPITCH;
    stage_runs(
        cw, BN, g.kbytes,
        [&](int r) {
          const int c = min(c0 + r, g.cin - 1);
          return k + ((size_t)tap * g.cin + c) * g.cout + n0;
        },
        [&](int r) { return dst + r * BPITCH; },
        [&](int r, int j) { return c0 + r < g.cin && n0 + j < g.cout; });
  };

  // two m16 tiles a warp: tile mt holds output rows 4wm + 2mt (fragment rows
  // 0-7) and 4wm + 2mt + 1 (rows 8-15), 8 pixels each
  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;

  issue(0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int chunk = s / taps, tap = s - chunk * taps;
    const int cw = min(CK, g.cin_k - chunk * CK);
    const int ty = tap / g.kw, tx = tap - ty * g.kw;
    const __nv_bfloat16* a_row =
        win + (chunk & 1) * halo + ((4 * wm + (mi & 1) + ty) * g.ww + r8 + tx) * WPITCH +
        (mi >> 1) * 8;
    const __nv_bfloat16* b_row = ws + (s & 1) * CK * BPITCH + ((mi & 1) * 8 + r8) * BPITCH +
                                 wn * NTW * 8 + (mi >> 1) * 8;
    for (int kk = 0; kk < cw; kk += 16) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, a_row + kk);
      ldsm_x4(a1, a_row + 2 * g.ww * WPITCH + kk);
#pragma unroll
      for (int j = 0; j + 1 < NTW; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, b_row + kk * BPITCH + j * 8);
        mma16816(acc[0][j], a0, b[0], b[1]);
        mma16816(acc[1][j], a1, b[0], b[1]);
        mma16816(acc[0][j + 1], a0, b[2], b[3]);
        mma16816(acc[1][j + 1], a1, b[2], b[3]);
      }
      if constexpr (NTW % 2) {
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, b_row + kk * BPITCH + (NTW - 1) * 8);
        mma16816(acc[0][NTW - 1], a0, b0, b1);
        mma16816(acc[1][NTW - 1], a1, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = n0 + (wn * NTW + nt) * 8 + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int oy = ty0 + 4 * wm + 2 * mt + hh, ox = tx0 + g8;
        if (oy >= g.h || ox >= g.w) continue;
        __nv_bfloat16* o = out + ((size_t)oy * g.w + ox) * g.cout + n;
        const float* a = acc[mt][nt];
        const float v0 = n < g.cout ? epilogue(a[2 * hh], n, epi, bias, scale, shift) : 0.f;
        const float v1 =
            n + 1 < g.cout ? epilogue(a[2 * hh + 1], n + 1, epi, bias, scale, shift) : 0.f;
        if (n + 1 < g.cout && (g.cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < g.cout) o[0] = __float2bfloat16(v0);
          if (n + 1 < g.cout) o[1] = __float2bfloat16(v1);
        }
      }
    }
}

// f32: one thread an output value; threadIdx.x walks 32 output channels (the
// kernel's rows are contiguous in Cout), threadIdx.y 8 output pixels.
__global__ void __launch_bounds__(256)
    conv_f32(const float* __restrict__ x, const float* __restrict__ k,
             const float* __restrict__ bias, const float* __restrict__ scale,
             const float* __restrict__ shift, float* __restrict__ out, Geo g, int epi) {
  const int n = blockIdx.y * 32 + threadIdx.x;
  const int p = blockIdx.x * 8 + threadIdx.y;
  if (n >= g.cout || p >= g.h * g.w) return;
  const int oy = p / g.w, ox = p - oy * g.w;
  float acc = 0.f;
  for (int ty = 0; ty < g.kh; ++ty)
    for (int tx = 0; tx < g.kw; ++tx) {
      const float* xp = x + ((size_t)(oy + ty) * g.wp + ox + tx) * g.cin;
      const float* kp = k + (size_t)(ty * g.kw + tx) * g.cin * g.cout + n;
      float part = 0.f;
      for (int c = 0; c < g.cin; ++c) part = fmaf(xp[c], kp[(size_t)c * g.cout], part);
      acc = __fadd_rn(acc, part);
    }
  out[(size_t)p * g.cout + n] = epilogue(acc, n, epi, bias, scale, shift);
}

int copy_bytes(const void* base, int run_elems, int elem_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  const int run = run_elems * elem_bytes;
  for (int v = 16; v >= 4; v /= 2)
    if (a % v == 0 && run % v == 0) return v;
  return 0;
}

template <int NT>
cudaError_t launch_mma(const void* x, const void* k, const float* bias, const float* scale,
                       const float* shift, void* out, const Geo& g, int epi, cudaStream_t s) {
  auto kernel = conv_mma<NT>;
  const int bytes = (2 * g.wh * g.ww * WPITCH + 2 * CK * (8 * NT + 8)) * 2;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid(((g.h + TH - 1) / TH) * ((g.w + TW - 1) / TW), (g.cout + 8 * NT - 1) / (8 * NT));
  kernel<<<grid, NTHREADS, bytes, s>>>(static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const __nv_bfloat16*>(k), bias, scale, shift,
                                       static_cast<__nv_bfloat16*>(out), g, epi);
  return cudaGetLastError();
}

}  // namespace

// x: (hp, wp, cin), kernel: (kh, kw, cin, cout), out: (hp-kh+1, wp-kw+1, cout),
// all bf16, or all f32 when f32 != 0; bias, scale, shift: (cout,) f32, read
// by epi 1 (bias) and 2 (contract), may be null for epi 0.
extern "C" int rst_conv_matmul(const void* x, const void* kernel, const void* bias,
                               const void* scale, const void* shift, void* out, int hp, int wp,
                               int cin, int kh, int kw, int cout, int epi, int f32,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo g;
  g.hp = hp, g.wp = wp, g.cin = cin, g.kh = kh, g.kw = kw, g.cout = cout;
  g.h = hp - kh + 1, g.w = wp - kw + 1;
  g.wh = TH + kh - 1, g.ww = TW + kw - 1;
  g.cin_k = (cin + 15) / 16 * 16;
  if (g.h < 1 || g.w < 1 || cin < 1 || cout < 1 || epi < 0 || epi > 2 ||
      (epi > 0 && (!bias || !scale || !shift)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (f32) {
    const dim3 grid((g.h * g.w + 7) / 8, (cout + 31) / 32);
    conv_f32<<<grid, dim3(32, 8), 0, s>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(kernel), b, sc, sh,
                                          static_cast<float*>(out), g, epi);
    return static_cast<int>(cudaGetLastError());
  }
  g.xbytes = copy_bytes(x, cin, 2);
  g.kbytes = copy_bytes(kernel, cout, 2);
  // Cout in at most 128-wide blocks of equal width, each a multiple of 16
  const int parts = (cout + 127) / 128;
  const int nt = ((cout + parts - 1) / parts + 7) / 8;
  cudaError_t err;
  if (nt <= 2) err = launch_mma<2>(x, kernel, b, sc, sh, out, g, epi, s);
  else if (nt <= 4) err = launch_mma<4>(x, kernel, b, sc, sh, out, g, epi, s);
  else if (nt <= 6) err = launch_mma<6>(x, kernel, b, sc, sh, out, g, epi, s);
  else if (nt <= 8) err = launch_mma<8>(x, kernel, b, sc, sh, out, g, epi, s);
  else if (nt <= 12) err = launch_mma<12>(x, kernel, b, sc, sh, out, g, epi, s);
  else err = launch_mma<16>(x, kernel, b, sc, sh, out, g, epi, s);
  return static_cast<int>(err);
}
