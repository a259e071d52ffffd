// conv_stage: one stage of the fused transfer net as an implicit-GEMM direct
// convolution on Hopper (sm_90a), bf16 operands, f32 accumulation.
//
// Replaces the conv stage of FusedTransfer._kernel_impl
// (realtime_style_transfer_tpu/ops/pallas/fused_transfer.py: run_conv /
// run_conv_direct, fold_cin_affine).  One launch computes one stage:
//
//   prologue  x' = bf16(relu?(f) + skip_in?) with f = a*x + b, a and b
//             folded per block from the producer's CIN moments and the style
//             row; dual style blends per pixel, f = (x*a + b) + w*(x*da + db),
//             with da, db the second style's fold minus the first's and w the
//             pixel's weight (the dual style of _kernel_impl: fold_cin_affine's
//             delta rows and the blend of the band transform).  Out-of-image
//             taps are zero AFTER the transform (the conv pads the normalised
//             activation).  The centre tap of a stride-1 stage writes x' to
//             skip_out, so each pixel is written once, by the block that owns
//             it as an output pixel.
//   GEMM      M = output pixels, N = output columns, K = (ty, tx, cin); A
//             comes from the input by one of the two paths below, B is the
//             (N, K_pad) bf16 weight matrix in 32-wide K slices; mma.sync
//             m16n8k16.
//   epilogue  f32: + bias, then contract relu(relu(v)*s + t) | relu | bias;
//             per-logical-channel sum and sum of squares of the f32 values
//             (before bf16 rounding) reduced in the block, then atomicAdd
//             into a [2, c_log] buffer; store bf16 (a transpose stage stores
//             its four parity column blocks through depth-to-space).
//
// Two A-operand paths.  Stages with more than 9 taps at stride 1 (the 9x9
// stem and final) take the window path: a block owns WR output rows x 64
// columns and loads the input window they read ((KH+WR-1) rows x (64+KW-1)
// columns x Cin, channels padded to a multiple of 16; for the stem straight
// from the f4 frame pack) into shared memory once, applying the prologue
// there once per element.  Each k16 slice then lies in one tap, so every MMA
// fragment is a 32-bit load from the window itself, and the WR row tiles of a
// warp share each B fragment.  The other stages gather 128x32 A tiles from
// global memory in 16-byte vectors through a per-stage K map, in blocks of
// 128 output pixels; their few taps do not repay a window (measured: 3x3
// windows cost residency).
//
// Bound on the H100: the residual convs and the stem are tensor-core work
// (about 127 GFLOP per 480x960 frame against ~0.35 GB of activations), so the
// stage is bound by operations.  What it meets first is L2 traffic: every
// block reads the whole weight matrix, so blocks are made as large as their
// registers allow (WR rows on the window path, 8 warps on the gather path).
// The K loop is plain mma.sync; wgmma/TMA pipelining is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output pixels per window row tile (4 warps x 16)
constexpr int BK = 32;        // reduction slice per shared-memory stage
constexpr int LDS = BK + 8;   // 80-byte rows: conflict-free fragment loads
constexpr int NTHREADS = 128;     // window path: 4 warps
constexpr int G_THREADS = 256;    // gather path: 8 warps ...
constexpr int G_BM = 128;         // ... of 16 output pixels each
constexpr int MAX_CIN = 128;  // widest input that takes a CIN prologue
constexpr int MAX_PACK_CIN = 32;  // size of the pack fill's subpixel table
constexpr int MAX_WINDOW_BYTES = 200 * 1024;  // dynamic shared memory cap

enum { EPI_CONTRACT = 0, EPI_RELU = 1, EPI_BIAS = 2 };

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;      // (N, K_pad) bf16, K = (ty * KW + tx) * cin_k + c
  const int* kmap;             // gather path: (ty << 20) | (tx << 10) | c, or -1
  const float* bias;           // (N,)
  const float* cscale;         // (N,) contract only
  const float* cshift;         // (N,) contract only
  const float* in_stats;       // (2, Cin) producer sums / sums of squares
  const float* in_scale;       // (Cin,) style scale row
  const float* in_bias;        // (Cin,) style bias row
  const float* in_scale1;      // (Cin,) second style's scale row, dual only
  const float* in_bias1;       // (Cin,) second style's bias row, dual only
  const __nv_bfloat16* weight; // (H, W) per-pixel weight of style 1, dual only
  float in_count;
  float eps;
  int in_affine;
  int in_relu;
  int dual;                       // 1: blend the two styles' affines by weight
  const __nv_bfloat16* skip_in;   // same shape as x, or null
  __nv_bfloat16* skip_out;        // same shape as x, or null
  __nv_bfloat16* out;
  float* stats_out;               // (2, c_log) or null
  int H, W, Cin;
  int pack_c;                     // > 0: x is the (H/4, W/4, pack_c) f4 pack
  int OH, OW, N, K_pad, KH, KW, S, pt, pl, c_log, transpose, epi;
  int cin_k;                      // channel stride of the K index
  int window;                     // 1: window path, 0: gather path
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The prologue on 8 consecutive channels of one pixel, whose dual-style
// weight is wv; every rounding point is explicit so the plain PyTorch version
// (mul, add[, mul, add, mul, add], relu, add, round) gives the same bits.
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

__device__ __forceinline__ size_t out_offset(const Params& p, int pix, int n) {
  if (!p.transpose) return (size_t)pix * p.N + n;
  const int cls = n / p.c_log, c = n - cls * p.c_log;
  const int oy = pix / p.OW, ox = pix - oy * p.OW;
  const int y = 2 * oy + (cls >> 1), x = 2 * ox + (cls & 1);
  return ((size_t)y * (2 * p.OW) + x) * p.c_log + c;
}

// Shared-memory state both paths keep besides their tiles.
template <int BN>
struct BlockState {
  float a[MAX_CIN], b[MAX_CIN];  // folded CIN affine of the input
  float da[MAX_CIN], db[MAX_CIN];  // dual: second style's affine minus the first's
  float sum[BN], sq[BN];         // the block's moments per output column
};

// Fold the producer's CIN moments and the style row into a*x + b (and, dual,
// the second style's rows into the deltas da, db); zero the block's moment
// sums.
template <int BN, int NT>
__device__ __forceinline__ void block_init(const Params& p, BlockState<BN>& st) {
  if (p.in_affine) {
    for (int c = threadIdx.x; c < p.Cin; c += NT) {
      const float mean = p.in_stats[c] / p.in_count;
      const float var = __fsub_rn(p.in_stats[p.Cin + c] / p.in_count,
                                  __fmul_rn(mean, mean));
      const float inv = 1.0f / sqrtf(__fadd_rn(var, p.eps));
      const float a = __fmul_rn(p.in_scale[c], inv);
      const float b = __fsub_rn(p.in_bias[c], __fmul_rn(mean, a));
      st.a[c] = a;
      st.b[c] = b;
      if (p.dual) {
        const float a1 = __fmul_rn(p.in_scale1[c], inv);
        st.da[c] = __fsub_rn(a1, a);
        st.db[c] = __fsub_rn(__fsub_rn(p.in_bias1[c], __fmul_rn(mean, a1)), b);
      }
    }
  }
  for (int i = threadIdx.x; i < BN; i += NT) st.sum[i] = st.sq[i] = 0.f;
}

// One B slice (BN weight rows x BK reduction columns) through registers: the
// window path loads slice k+1 while the MMAs of slice k run, then stores it
// to the other shared buffer; the gather path loads and stores in a row.
template <int BN, int NT>
struct BSlice {
  static constexpr int VECS = BN * (BK / 8);
  static constexpr int ITEMS = (VECS + NT - 1) / NT;
  uint4 v[ITEMS];

  __device__ __forceinline__ void load(const Params& p, int n0, int k0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int n = idx / (BK / 8), kq = (idx % (BK / 8)) * 8;
      v[i] = make_uint4(0, 0, 0, 0);
      if (idx < VECS && n0 + n < p.N)
        v[i] = *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + n) * p.K_pad + k0 + kq);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16 (*Bs)[LDS]) const {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx < VECS)
        *reinterpret_cast<uint4*>(&Bs[idx / (BK / 8)][(idx % (BK / 8)) * 8]) = v[i];
    }
  }
};

// Epilogue and store of one tile of 16 rows per warp; adds its moments into
// the block's.  Tile row r is output pixel pix0 + r, valid for r < rows;
// fragment (nt, h, e) is row warp*16 + g + 8h, column nt*8 + 2*t4 + e.
template <int BN>
__device__ __forceinline__ void epilogue_tile(const Params& p, const float (&acc)[BN / 8][4],
                                              int pix0, int rows, int n0,
                                              BlockState<BN>& st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = p.transpose ? (p.c_log % 2 == 0) : (p.N % 2 == 0);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    float psum[2] = {0.f, 0.f}, psq[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      const int pix = pix0 + r;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + 2 * t4 + e;
        float y = 0.f;
        if (n < p.N) {
          y = __fadd_rn(acc[nt][2 * h + e], p.bias[n]);
          if (p.epi == EPI_CONTRACT) {
            y = fmaxf(y, 0.f);
            y = fmaxf(__fadd_rn(__fmul_rn(y, p.cscale[n]), p.cshift[n]), 0.f);
          } else if (p.epi == EPI_RELU) {
            y = fmaxf(y, 0.f);
          }
        }
        v[e] = y;
        if (r < rows && n < p.N) {
          psum[e] += y;
          psq[e] += y * y;
        }
      }
      if (r < rows) {
        const int n = n0 + nt * 8 + 2 * t4;
        if (pairs && n + 1 < p.N) {
          *reinterpret_cast<__nv_bfloat162*>(p.out + out_offset(p, pix, n)) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < p.N) p.out[out_offset(p, pix, n + e)] = __float2bfloat16_rn(v[e]);
        }
      }
    }
    if (p.stats_out) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = psum[e], q = psq[e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          q += __shfl_xor_sync(0xffffffffu, q, o);
        }
        if (g == 0) {
          atomicAdd(&st.sum[nt * 8 + 2 * t4 + e], s);
          atomicAdd(&st.sq[nt * 8 + 2 * t4 + e], q);
        }
      }
    }
  }
}

// The block's moments into the frame's [2, c_log] buffer (the four parity
// columns of a transpose stage add into one logical channel).
template <int BN, int NT>
__device__ __forceinline__ void flush_moments(const Params& p, int n0, const BlockState<BN>& st) {
  if (!p.stats_out) return;
  __syncthreads();
  for (int i = threadIdx.x; i < BN; i += NT) {
    const int n = n0 + i;
    if (n < p.N) {
      const int lc = n % p.c_log;
      atomicAdd(p.stats_out + lc, st.sum[i]);
      atomicAdd(p.stats_out + p.c_log + lc, st.sq[i]);
    }
  }
}

// ---- gather path: A tiles gathered from global memory ----------------------

template <int BN>
__global__ void __launch_bounds__(G_THREADS) conv_gather_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[G_BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDS];
  __shared__ BlockState<BN> st;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = p.OH * p.OW;
  const int m0 = blockIdx.x * G_BM, n0 = blockIdx.y * BN;
  block_init<BN, G_THREADS>(p, st);

  // the two A rows this thread fills: tid/4 and tid/4 + 64
  int a_oy[2], a_ox[2];
  bool a_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pix = m0 + (tid >> 2) + 64 * j;
    a_ok[j] = pix < M;
    a_oy[j] = pix / p.OW;
    a_ox[j] = pix - a_oy[j] * p.OW;
  }
  const bool transform = p.in_affine || p.in_relu || p.skip_in != nullptr;
  __syncthreads();

  float acc[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < p.K_pad; k0 += BK) {
    const int kq = (tid & 3) * 8;
    const int km = __ldg(p.kmap + k0 + kq);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (km >= 0 && a_ok[j]) {
        const int ty = km >> 20, tx = (km >> 10) & 1023, c = km & 1023;
        const int iy = a_oy[j] * p.S - p.pt + ty;
        const int ix = a_ox[j] * p.S - p.pl + tx;
        if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
          const size_t off = ((size_t)iy * p.W + ix) * p.Cin + c;
          v = *reinterpret_cast<const uint4*>(p.x + off);
          if (transform) {
            const float wv = p.dual ? __bfloat162float(p.weight[(size_t)iy * p.W + ix]) : 0.f;
            v = transform8(v, c, st.a, st.b, st.da, st.db, wv, p.in_affine, p.dual,
                           p.in_relu, p.skip_in ? p.skip_in + off : nullptr);
          }
          // the centre tap of a stride-1 stage reads the block's own pixel
          if (p.skip_out && ty == p.pt && tx == p.pl && blockIdx.y == 0)
            *reinterpret_cast<uint4*>(p.skip_out + off) = v;
        }
      }
      *reinterpret_cast<uint4*>(&As[(tid >> 2) + 64 * j][kq]) = v;
    }
    BSlice<BN, G_THREADS> b;
    b.load(p, n0, k0);
    b.store(Bs);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const int ar = warp * 16 + g;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + 2 * t4]);
      a[1] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + 2 * t4]);
      a[2] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + 2 * t4 + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + 2 * t4 + 8]);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[nt * 8 + g][ks + 2 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[nt * 8 + g][ks + 2 * t4 + 8]);
        mma16816(acc[nt], a, b0, b1);
      }
    }
    __syncthreads();
  }
  epilogue_tile<BN>(p, acc, m0, M - m0, n0, st);
  flush_moments<BN, G_THREADS>(p, n0, st);
}

// ---- window path: MMA fragments straight from a shared-memory window -------

// Output rows per window block: as many as the accumulators allow.
__host__ __device__ constexpr int window_rows(int bn) { return bn <= 32 ? 4 : 1; }

// Channel stride of a window pixel: cin_k plus 8, so the rows of a fragment
// load fall in different banks.
__host__ __device__ __forceinline__ int window_pitch(int cin_k) { return cin_k + 8; }

__host__ __device__ __forceinline__ int window_bytes(int kh, int kw, int cin_k, int wr) {
  return (kh + wr - 1) * (BM + kw - 1) * window_pitch(cin_k) * 2;
}

template <int BN, bool PACK>
__global__ void __launch_bounds__(NTHREADS) conv_window_kernel(const Params p) {
  constexpr int WR = window_rows(BN);
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN][LDS];
  __shared__ BlockState<BN> st;
  __shared__ short sub_c[4 * MAX_PACK_CIN];  // pack channel -> (subpixel x, c)
  extern __shared__ __align__(16) unsigned char dyn[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(dyn);  // [wrows][wc][pitch]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = BM + p.KW - 1, wrows = p.KH + WR - 1, pitch = window_pitch(p.cin_k);
  const int tiles = (p.OW + BM - 1) / BM;
  const int by = blockIdx.x / tiles;
  const int oy0 = by * WR, ox0 = (blockIdx.x - by * tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int y0 = oy0 - p.pt, x0 = ox0 - p.pl;  // input pixel of window (0, 0)
  BSlice<BN, NTHREADS> b;
  b.load(p, n0, 0);  // in flight during the window fill
  block_init<BN, NTHREADS>(p, st);
  // channels [c_pad0, cin_k) of every window pixel start zero; the fill below
  // writes [0, Cin), zeros outside the image
  const int c_pad0 = (p.Cin / 8) * 8, pad_vecs = (p.cin_k - c_pad0) / 8;
  for (int e = tid; e < wrows * wc * pad_vecs; e += NTHREADS)
    *reinterpret_cast<uint4*>(win + (e / pad_vecs) * pitch + c_pad0 + (e % pad_vecs) * 8) =
        make_uint4(0, 0, 0, 0);
  if (PACK)
    for (int i = tid; i < 4 * p.Cin; i += NTHREADS)
      sub_c[i] = (short)(((i / p.Cin) << 8) | (i % p.Cin));
  __syncthreads();

  if (PACK) {
    // window row wy needs, from each packed pixel px of packed row iy/4, the
    // 4*Cin channels of subpixel row iy%4: contiguous and 8-byte aligned, read
    // 4 channels at a time and scattered to (ix = 4px + sub, c)
    const int px0 = x0 >> 2, npx = ((x0 + wc - 1) >> 2) - px0 + 1;
    const int wp = p.W >> 2;
    for (int u = tid; u < wrows * npx * p.Cin; u += NTHREADS) {
      const int m = u % p.Cin, q = u / p.Cin;
      const int pxi = q % npx, wy = q / npx;
      const int iy = y0 + wy, px = px0 + pxi;
      uint2 v = make_uint2(0, 0);
      if (iy >= 0 && iy < p.H && px >= 0 && px < wp)
        v = *reinterpret_cast<const uint2*>(
            p.x + ((size_t)(iy >> 2) * wp + px) * p.pack_c + (iy & 3) * 4 * p.Cin + m * 4);
      const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sc = sub_c[m * 4 + i];
        const int j = px * 4 + (sc >> 8) - x0;
        if (j >= 0 && j < wc) win[(wy * wc + j) * pitch + (sc & 255)] = vals[i];
      }
    }
  } else {
    const bool transform = p.in_affine || p.in_relu || p.skip_in != nullptr;
    const int c8s = p.Cin / 8;
    for (int e = tid; e < wrows * wc * c8s; e += NTHREADS) {
      const int c = (e % c8s) * 8, q = e / c8s;
      const int j = q % wc, wy = q / wc;
      const int iy = y0 + wy, ix = x0 + j;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
        const size_t off = ((size_t)iy * p.W + ix) * p.Cin + c;
        v = *reinterpret_cast<const uint4*>(p.x + off);
        if (transform) {
          const float wv = p.dual ? __bfloat162float(p.weight[(size_t)iy * p.W + ix]) : 0.f;
          v = transform8(v, c, st.a, st.b, st.da, st.db, wv, p.in_affine, p.dual,
                         p.in_relu, p.skip_in ? p.skip_in + off : nullptr);
        }
      }
      *reinterpret_cast<uint4*>(win + q * pitch + c) = v;
    }
  }
  b.store(Bs[0]);
  __syncthreads();

  // warp w holds the 16-column tile w of each of the WR output rows
  float acc[WR][BN / 8][4];
#pragma unroll
  for (int rr = 0; rr < WR; ++rr)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      acc[rr][i][0] = acc[rr][i][1] = acc[rr][i][2] = acc[rr][i][3] = 0.f;

  const int k_real = p.KH * p.KW * p.cin_k;  // a multiple of 16
  const int col = warp * 16 + g;
  int buf = 0;
  for (int k0 = 0; k0 < p.K_pad; k0 += BK) {
    // one barrier per slice: slice k+1 goes to the buffer every warp finished
    // reading before the previous barrier
    const bool more = k0 + BK < p.K_pad;
    if (more) b.load(p, n0, k0 + BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const int kk = k0 + ks;
      if (kk < k_real) {
        const int tap = kk / p.cin_k, c0 = kk - tap * p.cin_k;
        const int ty = tap / p.KW, tx = tap - ty * p.KW;
        uint32_t bf[BN / 8][2];
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[buf][nt * 8 + g][ks + 2 * t4]);
          bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[buf][nt * 8 + g][ks + 2 * t4 + 8]);
        }
#pragma unroll
        for (int rr = 0; rr < WR; ++rr) {
          // output (oy0 + rr, ox0 + col) reads window (ty + rr, col + tx)
          const __nv_bfloat16* a_lo =
              win + ((ty + rr) * wc + tx + col) * pitch + c0 + 2 * t4;
          const __nv_bfloat16* a_hi = a_lo + 8 * pitch;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(a_lo);
          a[1] = *reinterpret_cast<const uint32_t*>(a_hi);
          a[2] = *reinterpret_cast<const uint32_t*>(a_lo + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(a_hi + 8);
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) mma16816(acc[rr][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
    if (more) b.store(Bs[buf ^ 1]);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int rr = 0; rr < WR; ++rr)
    epilogue_tile<BN>(p, acc[rr], (oy0 + rr) * p.OW + ox0,
                      oy0 + rr < p.OH ? p.OW - ox0 : 0, n0, st);
  flush_moments<BN, NTHREADS>(p, n0, st);
}

template <int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int n_blocks_n = (p.N + BN - 1) / BN;
  if (!p.window) {
    if (p.pack_c > 0 || p.cin_k != p.Cin) return cudaErrorInvalidValue;
    const dim3 grid((p.OH * p.OW + G_BM - 1) / G_BM, n_blocks_n);
    conv_gather_kernel<BN><<<grid, G_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  constexpr int WR = window_rows(BN);
  const int bytes = window_bytes(p.KH, p.KW, p.cin_k, WR);
  if (p.S != 1 || p.skip_out || p.cin_k % 16 || bytes > MAX_WINDOW_BYTES ||
      (p.pack_c > 0 && p.Cin > MAX_PACK_CIN))
    return cudaErrorInvalidValue;
  const dim3 grid(((p.OH + WR - 1) / WR) * ((p.OW + BM - 1) / BM), n_blocks_n);
  auto kernel = p.pack_c > 0 ? conv_window_kernel<BN, true> : conv_window_kernel<BN, false>;
  static bool configured[2] = {false, false};
  bool& done = configured[p.pack_c > 0 ? 1 : 0];
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_WINDOW_BYTES);
    if (err != cudaSuccess) return err;
    done = true;
  }
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rst_conv_stage(
    const void* x, const void* w, const void* kmap, const void* bias,
    const void* cscale, const void* cshift, const void* in_stats,
    const void* in_scale, const void* in_bias, const void* in_scale1,
    const void* in_bias1, const void* weight, float in_count, float eps,
    int in_affine, int in_relu, const void* skip_in, void* skip_out, void* out,
    void* stats_out, int H, int W, int Cin, int pack_c, int OH, int OW, int N,
    int K_pad, int KH, int KW, int S, int pt, int pl, int c_log, int transpose,
    int epi, int cin_k, int window, int block_n, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.kmap = static_cast<const int*>(kmap);
  p.bias = static_cast<const float*>(bias);
  p.cscale = static_cast<const float*>(cscale);
  p.cshift = static_cast<const float*>(cshift);
  p.in_stats = static_cast<const float*>(in_stats);
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_bias = static_cast<const float*>(in_bias);
  p.in_scale1 = static_cast<const float*>(in_scale1);
  p.in_bias1 = static_cast<const float*>(in_bias1);
  p.weight = static_cast<const __nv_bfloat16*>(weight);
  p.dual = weight != nullptr;
  // dual style needs both second-style rows, a weight plane and a CIN prologue
  if ((in_scale1 != nullptr) != p.dual || (in_bias1 != nullptr) != p.dual ||
      (p.dual && !in_affine))
    return static_cast<int>(cudaErrorInvalidValue);
  p.in_count = in_count;
  p.eps = eps;
  p.in_affine = in_affine;
  p.in_relu = in_relu;
  p.skip_in = static_cast<const __nv_bfloat16*>(skip_in);
  p.skip_out = static_cast<__nv_bfloat16*>(skip_out);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats_out = static_cast<float*>(stats_out);
  p.H = H; p.W = W; p.Cin = Cin; p.pack_c = pack_c;
  p.OH = OH; p.OW = OW; p.N = N; p.K_pad = K_pad; p.KH = KH; p.KW = KW; p.S = S;
  p.pt = pt; p.pl = pl; p.c_log = c_log; p.transpose = transpose; p.epi = epi;
  p.cin_k = cin_k; p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (block_n) {
    case 8: err = launch<8>(p, s); break;
    case 16: err = launch<16>(p, s); break;
    case 32: err = launch<32>(p, s); break;
    case 64: err = launch<64>(p, s); break;
    case 128: err = launch<128>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
