// conv_stage: one stage of the fused transfer net as an implicit-GEMM direct
// convolution on Hopper (sm_90a), bf16 operands and f32 accumulation, or, for
// an int8 stage, int8 operands and int32 accumulation.
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
//             activation).  A stride-1 stage writes x' to skip_out, each
//             pixel once, by the block that owns it as an output pixel.
//   GEMM      M = output pixels, N = output columns, K = (ty, tx, cin); A
//             comes from the input by one of the three paths below, B is the
//             (N, K_pad) bf16 weight matrix in K slices; mma.sync m16n8k16
//             (wgmma on the halo path).
//   int8      (the quant='int8' engine, fused_transfer.py:755-783, :1391-1399,
//             :1450-1466) the same kernels templated on the operand type: x'
//             is quantized where it is made, q = clamp(rint(f32(x') *
//             act_inv[c]), -127, 127) (skip_out still gets the bf16 x'); B
//             is the (N, K_pad) int8 matrix with the activation scales folded
//             in; mma.sync m16n8k32 s8 -> s32 (wgmma s8 on the halo path), one
//             per 32-wide K slice, from tiles with a 48-byte row pitch
//             (fragment rows in distinct bank groups); the epilogue starts
//             with v = f32(acc) * dequant[n].
//             The int32 sums are exact, so an int8 stage equals its plain
//             version bit for bit given the same input and moments.  A window
//             stage pads cin_k to a multiple of 32 so each k32 slice lies in
//             one tap.
//   epilogue  f32: + bias, then contract relu(relu(v)*s + t) | relu | bias;
//             per-logical-channel sum and sum of squares of the f32 values
//             (before bf16 rounding) added to the frame's [2, c_log] buffer;
//             store bf16 (a transpose stage stores its four parity column
//             blocks through depth-to-space).
//   moments   reduced in an order fixed by the grid, never by scheduling, so
//             a stage repeats its output bit for bit (the TPU kernel sums in
//             grid order).  A warp adds its tiles into its own shared slot
//             (the slots reuse the bytes of the MMA tiles, free after the K
//             loop, so a block's shared memory does not grow); the block adds
//             the slots in warp order and writes its [2, BN]
//             partial to the stage's scratch.  Blocks form groups of GROUP
//             consecutive x indices; the block that takes a group's last
//             integer ticket adds the group's partials in block order, and
//             the block that takes the last group ticket adds the group sums
//             in group order (then the parity classes of a transpose stage in
//             class order) into the frame's buffer.  Each last block resets
//             its ticket, so a CUDA graph replays from zero.
//
// Three A-operand paths, chosen from the stage's geometry alone:
//   window  stride 1, more than 9 taps (the 9x9 stem and final): a block owns
//           WR output rows x 64 columns and loads the input window they read
//           ((KH+WR-1) rows x (64+KW-1) columns x Cin, channels padded to a
//           multiple of 16; for the stem straight from the f4 frame pack)
//           into shared memory once, applying the prologue there once per
//           element.  Each k16 slice then lies in one tap, so every MMA
//           fragment is a 32-bit load from the window itself, and the WR row
//           tiles of a warp share each B fragment.
//   halo    stride 1, at most 9 taps (the residual convs, res0a, and the
//           expands e0, e1, e2 as 2x2-tap convs on parity-packed weights):
//           see "halo path" below.
//   gather  stride 2 (c1, c2, c3): 128x32 A tiles gathered from global memory
//           in 16-byte vectors through a per-stage K map, in blocks of 128
//           output pixels.
//
// Bound on the H100: the residual convs and the stem are tensor-core work
// (about 127 GFLOP per 480x960 frame against ~0.35 GB of activations), so the
// stage is bound by operations.  What it meets first is L2 traffic: every
// block reads the whole weight matrix, so blocks are made as large as their
// registers allow (WR rows on the window path, 8 warps on the gather path).
//
// Halo path (replaces run_conv / run_conv_direct, fused_transfer.py:1024,
// :1190, for the stride-1 stages of at most 9 taps).  A residual conv is 8.5
// GFLOP on 7.4 MB of input, 0.0086 ms of bf16 tensor-core time on the H100,
// so its bound is operations.  The gather path ran it at 12x that: every
// input element loaded and transformed once per tap, B through registers
// with two barriers a slice, 16x128 warp tiles.  Measured on the card, what
// bounds a halo block is latency: the launch is one wave (225 blocks, two an
// SM), so a block's fill, prologue and epilogue leave the tensor cores idle,
// and the weight stream shares the load queue with the fragment loads.
// The design:
//   tile    a block of 8 warps owns HALO_TH x HALO_TW = 8 x 16 output pixels
//           and copies their input halo, (8+KH-1) x (16+KW-1) pixels x Cin,
//           into shared memory by cp.async (zero-filled outside the image).
//           One pass over it applies the prologue once per element (affine,
//           dual blend, ReLU, skip_in; a thread keeps one 8-channel chunk, its
//           affine in registers), writes skip_out for the tile's own pixels
//           and leaves zeros outside the image: the conv pads the normalised
//           activation.  An int8 stage lands the raw bf16 halo in the weight
//           ring's bytes and quantizes it into an int8 tile in the same pass.
//           A halo pixel takes an odd number of 16-byte units, so ldmatrix
//           rows fall in distinct bank groups.
//   ring    the weights, packed once by the wrapper into slices of
//           SLICE_BYTES of K for the block's BN columns in wgmma's core-matrix
//           order, stream through RING buffers by TMA bulk copies (one thread
//           issues one copy a slice; an mbarrier reports it), two slices
//           ahead: no load instruction of the warps carries weights.
//   MMA     wgmma (m64nBNk16 bf16, m64nBNk32 s8) with A from registers and B
//           from the ring by descriptor.  Warp w's A is tile row w, loaded by
//           ldmatrix straight from the halo at each tap's offset (an m16 tile
//           is one tile row of 16 pixels), so warpgroup v multiplies tile rows
//           4v..4v+3 by all BN columns.  One slice's wgmmas stay in flight
//           while the next slice's fragments load.
//   after   the sums go through an f32 tile in shared memory to a compact
//           epilogue loop (bias, contract or ReLU, coalesced bf16 stores,
//           moments in a fixed order), then flush_moments as on the other
//           paths.
#include <type_traits>

#include "stage_common.cuh"

namespace {

constexpr int BM = 64;        // output pixels per window row tile (4 warps x 16)
constexpr int BK = 32;        // reduction slice per shared-memory stage
constexpr int LDS = BK + 8;   // 80-byte rows: conflict-free fragment loads
constexpr int LDS_Q = BK + 16;  // int8 tiles: 48-byte rows, conflict-free too
constexpr int NTHREADS = 128;     // window path: 4 warps
constexpr int G_THREADS = 256;    // gather path: 8 warps ...
constexpr int G_BM = 128;         // ... of 16 output pixels each
constexpr int MAX_CIN = 128;  // widest input that takes a CIN prologue
constexpr int MAX_PACK_CIN = 32;  // size of the pack fill's subpixel table
constexpr int MAX_WINDOW_BYTES = 200 * 1024;  // dynamic shared memory cap
constexpr int GROUP = 32;     // blocks whose moment partials one block adds

enum { EPI_CONTRACT = 0, EPI_RELU = 1, EPI_BIAS = 2 };
enum { PATH_GATHER = 0, PATH_WINDOW = 1, PATH_HALO = 2 };

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
  int path;                       // PATH_GATHER, PATH_WINDOW or PATH_HALO
  // int8 stage (after the bf16 fields, which keep their offsets)
  const int8_t* wq;               // (N, K_pad) int8, the same layout as w
  const float* dequant;           // (N,) s_w / 127
  const float* act_inv;           // (Cin,) 127 / s_c
  int quant;
  // moments: block partials [blocks][2][BN], then group sums
  // [groups_y][groups_x][2][BN]; tickets [groups_y * groups_x] + 1, all zero
  // between launches
  float* partials;
  int* tickets;
  int partials_cap;               // floats in partials
  int tickets_cap;                // ints in tickets
};

// The A and B operand type of a stage and the row pitch of its shared tiles.
template <bool Q> struct Operand {
  using T = __nv_bfloat16;
  static constexpr int PITCH = LDS;
};
template <> struct Operand<true> {
  using T = int8_t;
  static constexpr int PITCH = LDS_Q;
};
template <bool Q> using AccT = typename std::conditional<Q, int, float>::type;

__device__ __forceinline__ size_t out_offset(const Params& p, int pix, int n) {
  if (!p.transpose) return (size_t)pix * p.N + n;
  const int cls = n / p.c_log, c = n - cls * p.c_log;
  const int oy = pix / p.OW, ox = pix - oy * p.OW;
  const int y = 2 * oy + (cls >> 1), x = 2 * ox + (cls & 1);
  return ((size_t)y * (2 * p.OW) + x) * p.c_log + c;
}

// Shared-memory state both paths keep besides their tiles: the folded CIN
// affine of the input; an int8 stage also holds its act_inv row.
template <bool Q> struct QuantRow {};
template <> struct QuantRow<true> { float inv[MAX_CIN]; };

template <bool Q = false>
struct BlockState : QuantRow<Q> {
  float a[MAX_CIN], b[MAX_CIN];  // folded CIN affine of the input
  float da[MAX_CIN], db[MAX_CIN];  // dual: second style's affine minus the first's
};

// The warps' moment slots, [sum, sum of squares][warp][column] f32, in the
// bytes of a kernel's MMA tiles once its K loop is done: zeroed here.
template <int NW, int BN, int NT>
__device__ __forceinline__ void zero_slots(const Params& p, float* slots) {
  if (!p.stats_out) return;
  for (int i = threadIdx.x; i < 2 * NW * BN; i += NT) slots[i] = 0.f;
  __syncthreads();
}

// Fold the producer's CIN moments and the style row into a*x + b (and, dual,
// the second style's rows into the deltas da, db); load an int8 stage's
// act_inv row.  The fold is stage_common.cuh's
// fold_cin written out: calling that helper here changes the machine code of
// the bf16 instantiations, which this copy leaves as they were.
template <int NT, bool Q>
__device__ __forceinline__ void block_init(const Params& p, BlockState<Q>& st) {
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
  if constexpr (Q)
    for (int c = threadIdx.x; c < p.Cin; c += NT) st.inv[c] = p.act_inv[c];
}

// One B slice (BN weight rows x BK reduction columns) through registers: the
// window path loads slice k+1 while the MMAs of slice k run, then stores it
// to the other shared buffer; the gather path loads and stores in a row.
template <int BN, int NT, bool Q = false>
struct BSlice {
  static constexpr int EPV = 16 / sizeof(typename Operand<Q>::T);  // per 16 bytes
  static constexpr int VECS = BN * (BK / EPV);
  static constexpr int ITEMS = (VECS + NT - 1) / NT;
  uint4 v[ITEMS];

  __device__ __forceinline__ void load(const Params& p, int n0, int k0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int n = idx / (BK / EPV), kq = (idx % (BK / EPV)) * EPV;
      v[i] = make_uint4(0, 0, 0, 0);
      if (idx < VECS && n0 + n < p.N) {
        if constexpr (Q)
          v[i] = *reinterpret_cast<const uint4*>(p.wq + (size_t)(n0 + n) * p.K_pad + k0 + kq);
        else
          v[i] = *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + n) * p.K_pad + k0 + kq);
      }
    }
  }

  __device__ __forceinline__ void store(
      typename Operand<Q>::T (*Bs)[Operand<Q>::PITCH]) const {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx < VECS)
        *reinterpret_cast<uint4*>(&Bs[idx / (BK / EPV)][(idx % (BK / EPV)) * EPV]) = v[i];
    }
  }
};

// Epilogue and store of one tile of 16 rows per warp; adds its moments into
// the warp's slot (one lane a column, so in the order of the calls).  Tile
// row r is output pixel pix0 + r, valid for r < rows; fragment (nt, h, e) is
// row warp*16 + g + 8h, column nt*8 + 2*t4 + e.  An int8 stage's int32 sums
// are dequantized first: v = f32(acc) * dequant[n].
template <int BN, int NW, bool Q>
__device__ __forceinline__ void epilogue_tile(const Params& p, const AccT<Q> (&acc)[BN / 8][4],
                                              int pix0, int rows, int n0, float* slots) {
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
          float v0;
          if constexpr (Q)
            v0 = __fmul_rn(__int2float_rn(acc[nt][2 * h + e]), p.dequant[n]);
          else
            v0 = acc[nt][2 * h + e];
          y = __fadd_rn(v0, p.bias[n]);
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
          slots[warp * BN + nt * 8 + 2 * t4 + e] += s;
          slots[(NW + warp) * BN + nt * 8 + 2 * t4 + e] += q;
        }
      }
    }
  }
}

// The block's moments into the frame's [2, c_log] buffer, in an order fixed
// by the grid (see "moments" at the top): the warp slots in warp order into
// the block's partial, a group's partials in block order, the group sums in
// group order, then the four parity columns of a transpose stage in class
// order into one logical channel.  Integer tickets (exact atomics) pick the
// block that adds each level; it resets its ticket for the next launch.
template <int BN, int NT>
__device__ __forceinline__ void flush_moments(const Params& p, const float* slots) {
  if (!p.stats_out) return;
  __shared__ int last;
  __syncthreads();
  const int nbx = gridDim.x, nby = gridDim.y;
  const int ngx = (nbx + GROUP - 1) / GROUP, gx = blockIdx.x / GROUP;
  const int g0 = gx * GROUP, gn = min(GROUP, nbx - g0);
  float* part = p.partials;  // [nby][nbx][2][BN]
  float* gsum = p.partials + (size_t)nbx * nby * 2 * BN;  // [nby][ngx][2][BN]
  {
    float* mine = part + ((size_t)blockIdx.y * nbx + blockIdx.x) * 2 * BN;
    for (int i = threadIdx.x; i < BN; i += NT) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        s += slots[w * BN + i];
        q += slots[(NT / 32 + w) * BN + i];
      }
      mine[i] = s;
      mine[BN + i] = q;
    }
  }
  __threadfence();
  __syncthreads();
  int* gticket = p.tickets + blockIdx.y * ngx + gx;
  if (threadIdx.x == 0) last = atomicAdd(gticket, 1) == gn - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  {
    const float* first = part + ((size_t)blockIdx.y * nbx + g0) * 2 * BN;
    float* out = gsum + ((size_t)blockIdx.y * ngx + gx) * 2 * BN;
    for (int i = threadIdx.x; i < 2 * BN; i += NT) {
      float s = 0.f;
#pragma unroll 4
      for (int b = 0; b < gn; ++b) s += __ldcg(first + (size_t)b * 2 * BN + i);
      out[i] = s;
    }
  }
  if (threadIdx.x == 0) *gticket = 0;
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + nby * ngx;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == nby * ngx - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int ncls = p.N / p.c_log;
  for (int lc = threadIdx.x; lc < p.c_log; lc += NT) {
    float s = 0.f, q = 0.f;
    for (int cls = 0; cls < ncls; ++cls) {
      const int n = cls * p.c_log + lc, by = n / BN, i = n - by * BN;
      const float* col = gsum + (size_t)by * ngx * 2 * BN + i;
      float cs = 0.f, cq = 0.f;
#pragma unroll 4
      for (int g = 0; g < ngx; ++g) {
        cs += __ldcg(col + (size_t)g * 2 * BN);
        cq += __ldcg(col + (size_t)g * 2 * BN + BN);
      }
      s += cs;
      q += cq;
    }
    p.stats_out[lc] += s;
    p.stats_out[p.c_log + lc] += q;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// ---- gather path: A tiles gathered from global memory ----------------------

template <int BN, bool Q>
__global__ void __launch_bounds__(G_THREADS) conv_gather_kernel(const Params p) {
  using T = typename Operand<Q>::T;
  constexpr int P = Operand<Q>::PITCH;
  constexpr int NW = G_THREADS / 32;
  // the A and B tiles; after the K loop the same bytes hold the moment slots
  constexpr int TILE_BYTES = (G_BM + BN) * P * (int)sizeof(T);
  static_assert(TILE_BYTES >= 2 * NW * BN * (int)sizeof(float), "moment slots");
  __shared__ __align__(16) unsigned char mma_tiles[TILE_BYTES];
  T (*As)[P] = reinterpret_cast<T (*)[P]>(mma_tiles);
  T (*Bs)[P] = reinterpret_cast<T (*)[P]>(mma_tiles + G_BM * P * sizeof(T));
  float* slots = reinterpret_cast<float*>(mma_tiles);
  __shared__ BlockState<Q> st;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = p.OH * p.OW;
  const int m0 = blockIdx.x * G_BM, n0 = blockIdx.y * BN;
  block_init<G_THREADS, Q>(p, st);

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

  AccT<Q> acc[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;

  for (int k0 = 0; k0 < p.K_pad; k0 += BK) {
    const int kq = (tid & 3) * 8;
    const int km = __ldg(p.kmap + k0 + kq);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4 v = make_uint4(0, 0, 0, 0);
      uint2 vq = make_uint2(0, 0);
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
          if constexpr (Q) vq = quantize8(v, c, st.inv);
        }
      }
      if constexpr (Q)
        *reinterpret_cast<uint2*>(&As[(tid >> 2) + 64 * j][kq]) = vq;
      else
        *reinterpret_cast<uint4*>(&As[(tid >> 2) + 64 * j][kq]) = v;
    }
    BSlice<BN, G_THREADS, Q> b;
    b.load(p, n0, k0);
    b.store(Bs);
    __syncthreads();
    const int ar = warp * 16 + g;
    if constexpr (Q) {
      // one k32 slice: 4 bytes a fragment register
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&As[ar][4 * t4]);
      a[1] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][4 * t4]);
      a[2] = *reinterpret_cast<const uint32_t*>(&As[ar][4 * t4 + 16]);
      a[3] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][4 * t4 + 16]);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[nt * 8 + g][4 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[nt * 8 + g][4 * t4 + 16]);
        mma16832_s8(acc[nt], a, b0, b1);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
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
    }
    __syncthreads();
  }
  zero_slots<NW, BN, G_THREADS>(p, slots);
  epilogue_tile<BN, NW, Q>(p, acc, m0, M - m0, n0, slots);
  flush_moments<BN, G_THREADS>(p, slots);
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

// int8 window: cin_k (a multiple of 32) plus 16 bytes a pixel, an odd number
// of 16-byte units, so rows g = 0..7 of a fragment load fall in distinct
// bank groups.
__host__ __device__ __forceinline__ int window_pitch_q(int cin_k) { return cin_k + 16; }

__host__ __device__ __forceinline__ int window_bytes_q(int kh, int kw, int cin_k, int wr) {
  return (kh + wr - 1) * (BM + kw - 1) * window_pitch_q(cin_k);
}

template <int BN, bool PACK, bool Q>
__global__ void __launch_bounds__(NTHREADS) conv_window_kernel(const Params p) {
  constexpr int WR = window_rows(BN);
  using T = typename Operand<Q>::T;
  constexpr int P = Operand<Q>::PITCH;
  constexpr int NW = NTHREADS / 32;
  // the two B buffers; after the K loop the same bytes hold the moment slots
  constexpr int TILE_BYTES = 2 * BN * P * (int)sizeof(T);
  static_assert(TILE_BYTES >= 2 * NW * BN * (int)sizeof(float), "moment slots");
  __shared__ __align__(16) unsigned char mma_tiles[TILE_BYTES];
  T (*Bs)[BN][P] = reinterpret_cast<T (*)[BN][P]>(mma_tiles);
  float* slots = reinterpret_cast<float*>(mma_tiles);
  __shared__ BlockState<Q> st;
  __shared__ short sub_c[4 * MAX_PACK_CIN];  // pack channel -> (subpixel x, c)
  extern __shared__ __align__(16) unsigned char dyn[];
  T* win = reinterpret_cast<T*>(dyn);  // [wrows][wc][pitch]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = BM + p.KW - 1, wrows = p.KH + WR - 1;
  const int pitch = Q ? window_pitch_q(p.cin_k) : window_pitch(p.cin_k);
  const int tiles = (p.OW + BM - 1) / BM;
  const int by = blockIdx.x / tiles;
  const int oy0 = by * WR, ox0 = (blockIdx.x - by * tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int y0 = oy0 - p.pt, x0 = ox0 - p.pl;  // input pixel of window (0, 0)
  BSlice<BN, NTHREADS, Q> b;
  b.load(p, n0, 0);  // in flight during the window fill
  block_init<NTHREADS, Q>(p, st);
  // channels [c_pad0, cin_k) of every window pixel start zero; the fill below
  // writes [0, Cin), zeros outside the image
  const int c_pad0 = (p.Cin / 8) * 8, pad_vecs = (p.cin_k - c_pad0) / 8;
  for (int e = tid; e < wrows * wc * pad_vecs; e += NTHREADS) {
    T* dst = win + (e / pad_vecs) * pitch + c_pad0 + (e % pad_vecs) * 8;
    if constexpr (Q)
      *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
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
        if (j >= 0 && j < wc) {
          if constexpr (Q)
            win[(wy * wc + j) * pitch + (sc & 255)] =
                static_cast<int8_t>(quantize1(vals[i], st.inv[sc & 255]));
          else
            win[(wy * wc + j) * pitch + (sc & 255)] = vals[i];
        }
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
      if constexpr (Q)  // zero quantizes to zero: the padding stays zero
        *reinterpret_cast<uint2*>(win + q * pitch + c) = quantize8(v, c, st.inv);
      else
        *reinterpret_cast<uint4*>(win + q * pitch + c) = v;
    }
  }
  b.store(Bs[0]);
  __syncthreads();

  // warp w holds the 16-column tile w of each of the WR output rows
  AccT<Q> acc[WR][BN / 8][4];
#pragma unroll
  for (int rr = 0; rr < WR; ++rr)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      acc[rr][i][0] = acc[rr][i][1] = acc[rr][i][2] = acc[rr][i][3] = 0;

  const int k_real = p.KH * p.KW * p.cin_k;  // a multiple of 16 (int8: of 32)
  const int col = warp * 16 + g;
  int buf = 0;
  for (int k0 = 0; k0 < p.K_pad; k0 += BK) {
    // one barrier per slice: slice k+1 goes to the buffer every warp finished
    // reading before the previous barrier
    const bool more = k0 + BK < p.K_pad;
    if (more) b.load(p, n0, k0 + BK);
    if constexpr (Q) {
      // one k32 slice, inside one tap
      if (k0 < k_real) {
        const int tap = k0 / p.cin_k, c0 = k0 - tap * p.cin_k;
        const int ty = tap / p.KW, tx = tap - ty * p.KW;
        uint32_t bf[BN / 8][2];
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[buf][nt * 8 + g][4 * t4]);
          bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[buf][nt * 8 + g][4 * t4 + 16]);
        }
#pragma unroll
        for (int rr = 0; rr < WR; ++rr) {
          const int8_t* a_lo = win + ((ty + rr) * wc + tx + col) * pitch + c0 + 4 * t4;
          const int8_t* a_hi = a_lo + 8 * pitch;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(a_lo);
          a[1] = *reinterpret_cast<const uint32_t*>(a_hi);
          a[2] = *reinterpret_cast<const uint32_t*>(a_lo + 16);
          a[3] = *reinterpret_cast<const uint32_t*>(a_hi + 16);
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt)
            mma16832_s8(acc[rr][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    } else {
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
    }
    if (more) b.store(Bs[buf ^ 1]);
    __syncthreads();
    buf ^= 1;
  }
  zero_slots<NW, BN, NTHREADS>(p, slots);
#pragma unroll
  for (int rr = 0; rr < WR; ++rr)
    epilogue_tile<BN, NW, Q>(p, acc[rr], (oy0 + rr) * p.OW + ox0,
                         oy0 + rr < p.OH ? p.OW - ox0 : 0, n0, slots);
  flush_moments<BN, NTHREADS>(p, slots);
}

// ---- halo path: a 2-D output tile over its input halo in shared memory -----

constexpr int HALO_TH = 8;        // output rows of a halo tile
constexpr int HALO_TW = 16;       // output columns of a halo tile: one m16 MMA tile
constexpr int H_THREADS = 256;    // 8 warps, two warpgroups ...
constexpr int HALO_ROWS = HALO_TH / (H_THREADS / 32);  // ... of one tile row each
constexpr int RING = 3;           // weight slices in shared memory
constexpr int SLICE_BYTES = 128;  // bytes of K a slice holds: 64 bf16 or 128 int8
constexpr int MAX_HALO_BYTES = 200 * 1024;  // dynamic shared memory cap

// Bytes of a halo pixel: cin_k operands rounded up to an odd number of
// 16-byte units, so the 8 rows of an ldmatrix fall in distinct bank groups.
__host__ __device__ constexpr int halo_pitch(int cin_k, int esize) {
  return 16 * (((cin_k * esize + 15) / 16) | 1);
}

__host__ __device__ constexpr int halo_pixels(int kh, int kw) {
  return (HALO_TH + kh - 1) * (HALO_TW + kw - 1);
}

// The block's dynamic shared memory: the halo tile (padded to 128 bytes),
// then the weight ring, which an int8 stage first uses to stage its raw bf16
// halo and which holds the moment slots after the K loop.
__host__ __device__ constexpr int halo_tile_bytes(int kh, int kw, int cin_k, int esize) {
  return (halo_pixels(kh, kw) * halo_pitch(cin_k, esize) + 127) / 128 * 128;
}

__host__ __device__ constexpr int halo_ring_bytes(int kh, int kw, int cin, int bn, bool q) {
  return q && halo_pixels(kh, kw) * cin * 2 > RING * bn * SLICE_BYTES
             ? halo_pixels(kh, kw) * cin * 2
             : RING * bn * SLICE_BYTES;
}

// After the K loop the same bytes hold the epilogue's f32 tile, [pixel][BN +
// 4], the moment partials of its threads (4 columns each), [2][4 x threads],
// and the moment slots, [2][warps][BN].
constexpr int HALO_PX = HALO_TH * HALO_TW;
__host__ __device__ constexpr int halo_epi_bytes(int bn) {
  return 4 * (HALO_PX * (bn + 4) + 2 * 4 * H_THREADS + 2 * (H_THREADS / 32) * bn);
}

__host__ __device__ constexpr int halo_bytes(int kh, int kw, int cin, int bn, bool q) {
  return halo_tile_bytes(kh, kw, cin, q ? 1 : 2) + halo_ring_bytes(kh, kw, cin, bn, q) >
                 halo_epi_bytes(bn)
             ? halo_tile_bytes(kh, kw, cin, q ? 1 : 2) + halo_ring_bytes(kh, kw, cin, bn, q)
             : halo_epi_bytes(bn);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, no registers on the way; zero-filled if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A weight slice (the wrapper packs them: ops/kernels.py halo_slices) is
// wgmma's K-major layout without swizzle: 8 x 16-byte core matrices of 128
// contiguous bytes, the SLICE_BYTES / 16 of one 8-row group of n next to each
// other (LBO 128 bytes), the groups SLICE_BYTES * 8 apart (SBO).
// The wgmma descriptor of B at shared address addr: no swizzle, LBO 128, SBO
// SLICE_BYTES * 8 (bits 0-13 address, 16-29 LBO, 32-45 SBO, all in 16 bytes).
__device__ __forceinline__ uint64_t slice_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((SLICE_BYTES * 8) >> 4) << 32);
}

// Makes this thread's generic-proxy writes to shared memory (cp.async)
// visible to the async proxy, through which wgmma reads its B operand.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transfer on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA bulk copy of `bytes` contiguous bytes global -> shared, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to v across an in-flight wgmma.
template <typename T, int N>
__device__ __forceinline__ void wgmma_fence_operand(T (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(v[i])::"memory");
    else
      asm volatile("" : "+r"(v[i])::"memory");
  }
}

// One wgmma of the warpgroup: a 64-row A tile from registers (warp w holds
// rows 16w..16w+15 in mma.sync's m16 fragment layout) times the N = BN
// columns of a 32-byte K step of B (k16 bf16, k32 s8), added into d, which
// has the m16n8 accumulator layout of each n8 tile in turn.
template <int N, bool Q> struct Wgmma;
template <> struct Wgmma<8, false> {
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, "
        " %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<16, false> {
  __device__ static __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, "
        " %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<32, false> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, "
        " %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<64, false> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, "
        " %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<128, false> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, "
        " %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<8, true> {
  __device__ static __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, "
        " %8, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<16, true> {
  __device__ static __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, "
        " %12, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<32, true> {
  __device__ static __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, "
        " %20, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<64, true> {
  __device__ static __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, "
        " %36, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<128, true> {
  __device__ static __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, "
        " %68, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// n / d for 0 <= n < 2^16 and 1 <= d < 2^16 by one multiply-high (exact in
// that range), for the index arithmetic of the hot loops.
struct FastDiv {
  uint32_t m;
  int d;
  __device__ explicit FastDiv(int d_) : m(d_ > 1 ? 0xFFFFFFFFu / d_ + 1 : 0), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return d > 1 ? (int)__umulhi((uint32_t)n, m) : n;
  }
};

// The geometry of the K index on a halo tile: K byte k = tap (ty, tx), then
// channel byte; a tap's A rows are the tile's pixels shifted by (ty, tx).
struct HaloK {
  FastDiv tap_bytes, kw;
  int taps, hc, pitch;
  // Byte offset in the halo of K byte k for tile pixel (0, 0).  Past the last
  // tap (the tail of a K that is not a multiple of 32 bytes, whose weights
  // are zero) it points at tap 0.
  __device__ __forceinline__ int offset(int k) const {
    int tap = tap_bytes.div(k), cb = k - tap * tap_bytes.d;
    if (tap >= taps) tap = cb = 0;
    const int ty = kw.div(tap);
    return (ty * hc + tap - ty * kw.d) * pitch + cb;
  }
};

// The A fragment of an int8 stage whose taps are 8 bytes (Cin = 8 mod 16),
// which split an ldmatrix row: four 4-byte loads, each inside one tap.
// (Built field by field: a make_uint4 of these words changed how NVVM lowers
// the bf16 window kernels' 16-byte zero stores.)
__device__ __noinline__ uint4 halo_a_words(const unsigned char* row, int kb, const HaloK& hk) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = *reinterpret_cast<const uint32_t*>(row + (g + 8 * (i & 1)) * hk.pitch +
                                              hk.offset(kb + 4 * t4 + 16 * (i >> 1)));
  uint4 v;
  v.x = a[0];
  v.y = a[1];
  v.z = a[2];
  v.w = a[3];
  return v;
}

// Two blocks an SM at BN = 128 (their shared memory allows no more); the
// narrower expands, many waves of small blocks, trade registers for blocks.
// "// PROFILE LAP i" marks the end of phase i for halo_profile.py, which
// turns each marker into a clock64 counter in a copy of this file.
template <int BN, bool Q>
__global__ void __launch_bounds__(H_THREADS, BN <= 32 ? 4 : BN <= 64 ? 3 : 2)
    conv_halo_kernel(const Params p) {
  constexpr int ES = Q ? 1 : 2;  // bytes an operand
  constexpr int NW = H_THREADS / 32;
  __shared__ BlockState<Q> st;
  __shared__ __align__(8) uint64_t full[RING];  // slice kt has landed in buffer kt % RING
  extern __shared__ __align__(16) unsigned char halo_dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hc = HALO_TW + p.KW - 1, npix = (HALO_TH + p.KH - 1) * hc;
  const int pitch = halo_pitch(p.cin_k, ES);
  unsigned char* tile = halo_dyn;
  unsigned char* ring = halo_dyn + halo_tile_bytes(p.KH, p.KW, p.cin_k, ES);
  const int tiles_x = (p.OW + HALO_TW - 1) / HALO_TW;
  const int by = blockIdx.x / tiles_x;
  const int oy0 = by * HALO_TH, ox0 = (blockIdx.x - by * tiles_x) * HALO_TW;
  const int n0 = blockIdx.y * BN;
  const int y0 = oy0 - p.pt, x0 = ox0 - p.pl;  // input pixel of halo (0, 0)
  // the block's column block of the packed weight slices, nk of BN x SLICE_BYTES
  const int nk = (p.K_pad * ES + SLICE_BYTES - 1) / SLICE_BYTES;
  const unsigned char* w = reinterpret_cast<const unsigned char*>(p.w) +
                           (size_t)blockIdx.y * nk * BN * SLICE_BYTES;

  // weight slice kt into ring buffer kt % RING by one TMA bulk copy (thread 0)
  auto load_slice = [&](int kt) {
    if (kt < nk) {
      mbar_expect_tx(&full[kt % RING], BN * SLICE_BYTES);
      bulk_copy(ring + (kt % RING) * (BN * SLICE_BYTES), w + (size_t)kt * BN * SLICE_BYTES,
                BN * SLICE_BYTES, &full[kt % RING]);
    }
  };
  if (tid == 0)
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);

  // The raw halo: a bf16 stage transforms it where it lands, an int8 stage
  // lands it in the ring's bytes and quantizes it into the tile.  A thread
  // keeps one 8-channel chunk c of every pstep-th halo pixel (threads past
  // pstep * c8 idle), so its affine rows stay in registers.
  const int c8 = p.Cin / 8, pstep = H_THREADS / c8;
  const int c = (tid % c8) * 8, q0 = tid / c8;
  unsigned char* raw = Q ? ring : tile;
  const int raw_pitch = Q ? p.Cin * 2 : pitch;
  const FastDiv hcd(hc);
#pragma unroll 4
  for (int q = q0; q0 < pstep && q < npix; q += pstep) {
    const int hy = hcd.div(q), iy = y0 + hy, ix = x0 + q - hy * hc;
    const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    cp_async16(raw + q * raw_pitch + c * 2,
               in ? p.x + ((size_t)iy * p.W + ix) * p.Cin + c : p.x, in);
  }
  cp_async_commit();
  block_init<H_THREADS, Q>(p, st);
  // PROFILE LAP 0
  if (!Q && tid == 0)
    for (int s = 0; s < RING - 1; ++s) load_slice(s);  // in flight during the transform
  cp_async_wait<0>();
  __syncthreads();
  // PROFILE LAP 1

  // the prologue, once per element; zeros stay zeros outside the image
  const bool transform = p.in_affine || p.in_relu || p.skip_in != nullptr;
  if ((Q || transform || p.skip_out) && q0 < pstep) {
    float ra[8], rb[8], rda[8], rdb[8], rinv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ra[j] = st.a[c + j];
      rb[j] = st.b[c + j];
      rda[j] = p.dual ? st.da[c + j] : 0.f;
      rdb[j] = p.dual ? st.db[c + j] : 0.f;
      if constexpr (Q) rinv[j] = st.inv[c + j];
    }
    const bool skip_out = p.skip_out != nullptr && blockIdx.y == 0;
#pragma unroll 4
    for (int q = q0; q < npix; q += pstep) {
      const int hy = hcd.div(q), hx = q - hy * hc;
      const int iy = y0 + hy, ix = x0 + hx;
      // no branch around the body, so unrolled iterations overlap: outside
      // the image the raw chunk is zero, the side loads read pixel 0, and
      // the result is zero
      const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const size_t px = in ? (size_t)iy * p.W + ix : 0;
      uint4 v = *reinterpret_cast<const uint4*>(raw + q * raw_pitch + c * 2);
      if (transform) {
        const float wv = p.dual ? __bfloat162float(p.weight[px]) : 0.f;
        v = transform8(v, 0, ra, rb, rda, rdb, wv, p.in_affine, p.dual, p.in_relu,
                       p.skip_in ? p.skip_in + px * p.Cin + c : nullptr);
        if (!in) v = make_uint4(0, 0, 0, 0);
      }
      // the tile's own pixels: each pixel once, by the block that outputs it
      if (skip_out && in && hy >= p.pt && hy < p.pt + HALO_TH && hx >= p.pl &&
          hx < p.pl + HALO_TW)
        *reinterpret_cast<uint4*>(p.skip_out + px * p.Cin + c) = v;
      if constexpr (Q)  // zero quantizes to zero
        *reinterpret_cast<uint2*>(tile + q * pitch + c) = quantize8(v, 0, rinv);
      else
        *reinterpret_cast<uint4*>(tile + q * pitch + c * 2) = v;
    }
  }
  __syncthreads();
  // PROFILE LAP 2
  if (Q && tid == 0) {  // the raw halo in the ring's bytes is done with
    fence_proxy_async();
    for (int s = 0; s < RING - 1; ++s) load_slice(s);
  }

  // warp w holds tile row w: warpgroup v's m64 tile is tile rows 4v..4v+3
  AccT<Q> acc[HALO_ROWS][BN / 2];
#pragma unroll
  for (int r = 0; r < HALO_ROWS; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0;

  const HaloK hk{FastDiv(p.cin_k * ES), FastDiv(p.KW), p.KH * p.KW, hc, pitch};
  const int k_real = hk.taps * hk.tap_bytes.d;
  // ldmatrix lanes: A row = tile column lane % 16, k half lane / 16
  const int a_col = lane & 15, a_half = (lane >> 4) * 16;
  // an int8 stage whose Cin is 8 mod 16 has taps of 8 bytes, which split an
  // ldmatrix row: its A fragments are 4-byte loads, each in one tap
  const bool words = Q && (hk.tap_bytes.d & 15);
  const unsigned char* a_base = tile + (warp * hc + a_col) * pitch;
  constexpr int STEPS = SLICE_BYTES / 32;  // wgmma K steps a slice

  // Slice kt: wait for its bytes, load its A fragments into a (the other
  // buffer than slice kt - 1's, whose wgmmas are still in flight), issue its
  // wgmmas as one group; then wait for slice kt - 1's group, so that once
  // every warp has, its ring buffer can take slice kt + 2.
  auto slice = [&](int kt, uint32_t (&a)[STEPS][HALO_ROWS][4]) {
    mbar_wait(&full[kt % RING], (kt / RING) & 1);
    const uint32_t bs = smem_addr(ring + (kt % RING) * (BN * SLICE_BYTES));
    uint64_t desc[STEPS];
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const int kb = kt * SLICE_BYTES + ks * 32;
      desc[ks] = slice_desc(bs + ks * 32 * 8);
      if (kb < k_real) {
        const int a_off = hk.offset(kb + a_half);
#pragma unroll
        for (int r = 0; r < HALO_ROWS; ++r) {
          if (words) {
            const uint4 v = halo_a_words(tile + (warp + NW * r) * hc * pitch, kb, hk);
            a[ks][r][0] = v.x;
            a[ks][r][1] = v.y;
            a[ks][r][2] = v.z;
            a[ks][r][3] = v.w;
          } else {
            ldsm_x4(a[ks][r], a_base + NW * r * hc * pitch + a_off);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < HALO_ROWS; ++r) wgmma_fence_operand(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks)
      if (kt * SLICE_BYTES + ks * 32 < k_real)
#pragma unroll
        for (int r = 0; r < HALO_ROWS; ++r) Wgmma<BN, Q>::mma(acc[r], a[ks][r], desc[ks]);
    wgmma_commit();
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0) load_slice(kt + RING - 1);
  };
  uint32_t a0[STEPS][HALO_ROWS][4], a1[STEPS][HALO_ROWS][4];
  for (int kt = 0; kt < nk; kt += 2) {
    slice(kt, a0);
    if (kt + 1 < nk) slice(kt + 1, a1);
  }
  wgmma_wait<0>();
  // PROFILE LAP 3
#pragma unroll
  for (int r = 0; r < HALO_ROWS; ++r) wgmma_fence_operand(acc[r]);
  __syncthreads();  // every warp is done with the tile and the ring

  // The epilogue.  The sums go to an f32 tile in shared memory (an int8
  // stage's dequantized there), then one compact loop applies the epilogue
  // to four columns of a pixel a thread, stores them
  // (a warp's 32 quads are one pixel's 256 bytes) and adds the moments in a
  // fixed order: each thread over its pixels in order, then the threads of a
  // column in order into slot 0 (flush_moments adds the other, zero, slots
  // after it).
  constexpr int EP = BN + 4;               // f32 pitch of a tile pixel
  constexpr int QUADS = BN / 4;            // column quads a pixel
  constexpr int TPC = H_THREADS / QUADS;   // threads a column quad
  float* tv = reinterpret_cast<float*>(halo_dyn);  // [HALO_PX][EP]
  float* part = tv + HALO_PX * EP;            // [2][TPC][BN]
  float* slots = part + 2 * TPC * BN;         // [2][NW][BN]
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int r = 0; r < HALO_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = j * 8 + 2 * t4;
          float2 v;
          if constexpr (Q) {
            v.x = __fmul_rn(__int2float_rn(acc[r][4 * j + 2 * h]),
                            p.dequant[min(n0 + col, p.N - 1)]);
            v.y = __fmul_rn(__int2float_rn(acc[r][4 * j + 2 * h + 1]),
                            p.dequant[min(n0 + col + 1, p.N - 1)]);
          } else {
            v = make_float2(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
          }
          *reinterpret_cast<float2*>(tv + ((warp + NW * r) * HALO_TW + g + 8 * h) * EP + col) = v;
        }
  }
  // PROFILE LAP 4
  __syncthreads();
  const int cq = tid % QUADS, phase = tid / QUADS;  // the thread's column quad, first pixel
  const int n = n0 + 4 * cq;
  // the quad's columns are contiguous in the output (one parity class)
  const bool quad = (p.transpose ? p.c_log % 4 == 0 : p.N % 4 == 0) && n + 3 < p.N;
  // out_offset without its divisions: column n of output pixel (oy, ox) is
  // row 2oy + dy, column 2ox + dx, channel c of a transpose stage's output
  const int cls = p.transpose ? n / p.c_log : 0, dy = cls >> 1, dx = cls & 1;
  const int cn = p.transpose ? n - cls * p.c_log : n;
  float bias[4], cs[4], csh[4], sum[4], sq[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ne = min(n + e, p.N - 1);
    bias[e] = p.bias[ne];
    cs[e] = p.epi == EPI_CONTRACT ? p.cscale[ne] : 0.f;
    csh[e] = p.epi == EPI_CONTRACT ? p.cshift[ne] : 0.f;
    sum[e] = sq[e] = 0.f;
  }
#pragma unroll 4
  for (int i = phase; i < HALO_PX; i += TPC) {
    const int oy = oy0 + i / HALO_TW, ox = ox0 + i % HALO_TW;
    if (oy >= p.OH || ox >= p.OW) continue;
    const float4 v = *reinterpret_cast<const float4*>(tv + i * EP + 4 * cq);
    float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = __fadd_rn(y[e], bias[e]);
      if (p.epi == EPI_CONTRACT) {
        y[e] = fmaxf(y[e], 0.f);
        y[e] = fmaxf(__fadd_rn(__fmul_rn(y[e], cs[e]), csh[e]), 0.f);
      } else if (p.epi == EPI_RELU) {
        y[e] = fmaxf(y[e], 0.f);
      }
      if (n + e < p.N) {
        sum[e] += y[e];
        sq[e] += y[e] * y[e];
      }
    }
    if (quad) {
      const size_t off = p.transpose
          ? ((size_t)(2 * oy + dy) * (2 * p.OW) + 2 * ox + dx) * p.c_log + cn
          : ((size_t)oy * p.OW + ox) * p.N + n;
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 w2;
      w2.x = *reinterpret_cast<uint32_t*>(&lo);
      w2.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p.out + off) = w2;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < p.N)
          p.out[out_offset(p, oy * p.OW + ox, n + e)] = __float2bfloat16_rn(y[e]);
    }
  }
  if (p.stats_out) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[phase * BN + 4 * cq + e] = sum[e];
      part[(TPC + phase) * BN + 4 * cq + e] = sq[e];
    }
    __syncthreads();
    for (int i = tid; i < BN; i += H_THREADS) {
      float s0 = 0.f, q0s = 0.f;
      for (int t = 0; t < TPC; ++t) {
        s0 += part[t * BN + i];
        q0s += part[(TPC + t) * BN + i];
      }
      slots[i] = s0;
      slots[NW * BN + i] = q0s;
      for (int w = 1; w < NW; ++w) slots[w * BN + i] = slots[(NW + w) * BN + i] = 0.f;
    }
  }
  // PROFILE LAP 5
  flush_moments<BN, H_THREADS>(p, slots);
  // PROFILE LAP 6
}

// Whether the stage's moment scratch holds what flush_moments writes for
// this grid.
template <int BN>
bool scratch_fits(const Params& p, const dim3& grid) {
  if (!p.stats_out) return true;
  const long long ngx = (grid.x + GROUP - 1) / GROUP;
  const long long floats = ((long long)grid.x * grid.y + ngx * grid.y) * 2 * BN;
  return p.partials && p.tickets && floats <= p.partials_cap &&
         ngx * grid.y + 1 <= p.tickets_cap;
}

template <int BN, bool Q>
cudaError_t launch_halo(const Params& p, cudaStream_t stream) {
  const int bytes = halo_bytes(p.KH, p.KW, p.Cin, BN, Q);
  if (p.pack_c > 0 || p.cin_k != p.Cin || p.Cin % 8 || p.Cin > 8 * H_THREADS ||
      bytes > MAX_HALO_BYTES ||
      ((p.in_affine || Q) && p.Cin > MAX_CIN) ||
      (p.skip_out && (p.OH != p.H || p.OW != p.W)))
    return cudaErrorInvalidValue;
  const dim3 grid(((p.OH + HALO_TH - 1) / HALO_TH) * ((p.OW + HALO_TW - 1) / HALO_TW),
                  (p.N + BN - 1) / BN);
  if (!scratch_fits<BN>(p, grid)) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_halo_kernel<BN, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_HALO_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_halo_kernel<BN, Q><<<grid, H_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, bool Q>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  // the path the caller chose must be the one the geometry picks
  const int path = p.S != 1 ? PATH_GATHER : p.KH * p.KW > 9 ? PATH_WINDOW : PATH_HALO;
  if (p.path != path) return cudaErrorInvalidValue;
  if (path == PATH_HALO) return launch_halo<BN, Q>(p, stream);
  const int n_blocks_n = (p.N + BN - 1) / BN;
  if (path == PATH_GATHER) {
    if (p.pack_c > 0 || p.cin_k != p.Cin) return cudaErrorInvalidValue;
    const dim3 grid((p.OH * p.OW + G_BM - 1) / G_BM, n_blocks_n);
    if (!scratch_fits<BN>(p, grid)) return cudaErrorInvalidValue;
    conv_gather_kernel<BN, Q><<<grid, G_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  constexpr int WR = window_rows(BN);
  const int bytes = Q ? window_bytes_q(p.KH, p.KW, p.cin_k, WR)
                      : window_bytes(p.KH, p.KW, p.cin_k, WR);
  if (p.skip_out || p.cin_k % (Q ? 32 : 16) || bytes > MAX_WINDOW_BYTES ||
      (p.pack_c > 0 && p.Cin > MAX_PACK_CIN))
    return cudaErrorInvalidValue;
  const dim3 grid(((p.OH + WR - 1) / WR) * ((p.OW + BM - 1) / BM), n_blocks_n);
  if (!scratch_fits<BN>(p, grid)) return cudaErrorInvalidValue;
  auto kernel = p.pack_c > 0 ? conv_window_kernel<BN, true, Q> : conv_window_kernel<BN, false, Q>;
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

template <int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.quant ? launch_typed<BN, true>(p, stream) : launch_typed<BN, false>(p, stream);
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
    int epi, int cin_k, int path, int block_n, const void* dequant,
    const void* act_inv, int quant, void* partials, void* tickets, int partials_cap,
    int tickets_cap, void* stream) {
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
  // an int8 stage needs its dequant and act_inv rows, a bf16 stage neither
  if ((dequant != nullptr) != (quant != 0) || (act_inv != nullptr) != (quant != 0))
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
  p.cin_k = cin_k; p.path = path;
  p.wq = static_cast<const int8_t*>(w);
  p.dequant = static_cast<const float*>(dequant);
  p.act_inv = static_cast<const float*>(act_inv);
  p.quant = quant;
  p.partials = static_cast<float*>(partials);
  p.tickets = static_cast<int*>(tickets);
  p.partials_cap = partials_cap;
  p.tickets_cap = tickets_cap;
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
