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
//             activation).  A stride-1 halo stage writes x' to skip_out, each
//             pixel once, by the block that owns it as an output pixel.
//   GEMM      M = output pixels, N = output columns, K = (ty, tx, cin); A
//             comes from an input tile in shared memory by one of the three
//             paths below; B, the weights, is packed once by the wrapper
//             (ops/kernels.py halo_slices) into slices of SLICE_BYTES of K in
//             wgmma's core-matrix order and streams through a ring of RING
//             slices by TMA bulk copies on mbarriers, so no load instruction
//             of the warps carries weights; wgmma m64nBNk16 (bf16) or
//             m64nBNk32 (s8) with A from registers, B by descriptor.
//   int8      (the quant='int8' engine, fused_transfer.py:755-783, :1391-1399,
//             :1450-1466) the same kernels templated on the operand type: x'
//             is quantized where it is made, q = clamp(rint(f32(x') *
//             act_inv[c]), -127, 127) (skip_out still gets the bf16 x'); B
//             is the int8 matrix with the activation scales folded in; the
//             epilogue starts with v = f32(acc) * dequant[n].  The int32 sums
//             are exact in any K order, so an int8 stage equals its plain
//             version bit for bit given the same input and moments.
//   epilogue  f32: + bias, then contract relu(relu(v)*s + t) | relu | bias;
//             per-logical-channel sum and sum of squares of the f32 values
//             (before bf16 rounding) added to the frame's [2, c_log] buffer;
//             store bf16 (a transpose stage stores its four parity column
//             blocks through depth-to-space).
//   moments   reduced in an order fixed by the grid, never by scheduling, so
//             a stage repeats its output bit for bit (the TPU kernel sums in
//             grid order).  A warp adds its tiles into its own shared slot
//             (the slots reuse the bytes of the tiles, free after the K
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
//   window   stride 1, more than 9 taps (the 9x9 stem and final): see
//            "window path" below.
//   halo     stride 1, at most 9 taps (the residual convs, res0a, and the
//            expands e0, e1, e2 as 2x2-tap convs on parity-packed weights):
//            see "halo path" below.
//   strided  stride 2 (the contracts c1, c2, c3): the halo path's kernel on
//            an input tile split by column parity; see "strided" below.
//
// Bound on the H100: the residual convs and the stem are tensor-core work
// (about 127 GFLOP per 480x960 frame against ~0.35 GB of activations), so
// those stages are bound by operations; the contracts c1..c3 (0.2-0.7 GFLOP
// on 4-30 MB) and the expands are bound by bytes.  Every path loads a
// block's input tile into shared memory once, applies the prologue there once
// per element, and feeds the tensor cores by wgmma from it, with the weights
// off the warps' load queue.
//
// Halo path (replaces run_conv / run_conv_direct, fused_transfer.py:1024,
// :1190, for the stride-1 stages of at most 9 taps).  A residual conv is 8.5
// GFLOP on 7.4 MB of input, 0.0086 ms of bf16 tensor-core time on the H100,
// so its bound is operations.  Measured on the card, what bounds a halo
// block is latency: the launch is one wave (225 blocks, two an SM), so a
// block's fill, prologue and epilogue leave the tensor cores idle.
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
//   ring    the weight slices stream through RING buffers, two slices ahead.
//   MMA     warp w's A is tile row w, loaded by ldmatrix straight from the
//           halo at each tap's offset (an m16 tile is one tile row of 16
//           pixels), so warpgroup v multiplies tile rows 4v..4v+3 by all BN
//           columns.  One slice's wgmmas stay in flight while the next
//           slice's fragments load.
//   after   the sums go through an f32 tile in shared memory to a compact
//           epilogue loop (bias, contract or ReLU, coalesced bf16 stores,
//           moments in a fixed order), then flush_moments.
//
// Strided (replaces run_conv / run_conv_direct over the space-to-depth grids
// of c1, c2, c3, fused_transfer.py:505-540).  c1 at rst-960 reads 29.5 MB and
// writes 3.7 MB for 0.4 GFLOP: bound by bytes, 0.0099 ms.  A gather of A
// tiles from global memory read each input element once per tap that reads
// it (9/4 times at stride 2) with one synchronous round trip per K slice in
// a one-wave launch.  The strided path is the halo kernel at S = 2: a block
// of 8 x 16 output pixels copies its input tile, (2*8+KH-2) x (2*16+KW-2)
// pixels, once by cp.async (each input byte read about 1.1 times), stored
// split by column parity: a tile row holds its even input columns, then its
// odd ones, each plane HALO_TW + (KW-1)/2 pixels wide.  Output column x of
// tap tx reads input column 2x + tx, which is pixel x + tx/2 of plane tx%2,
// so the 16 rows of an m16 A tile are consecutive pixels of one plane and
// ldmatrix takes them as on the stride-1 halo.  Weights, MMAs, epilogue
// and moments are the halo path's.
//
// Window path (replaces run_conv / run_conv_direct for the 9x9 stem on the
// f4 content grid, fused_transfer.py:494-501, and the final conv).  The stem
// at rst-960 is 40.6 GFLOP (17 channels x 81 taps = K 1377), 0.041 ms of bf16
// tensor-core time: bound by operations.  Padding each tap's 17 channels to
// 32 made K 2592, 47% of it zeros.  The design:
//   K       a tap is cp = cin rounded up to a 32-bit word in K (18 bf16, 20
//           int8 at cin 17; 16 at cin 16), and K runs along a window row as
//           (ty, tx * cp + c): the nine taps of a row are one contiguous run
//           of k_row = KW * cp operands rounded up to one wgmma K step (16
//           bf16, 32 int8).  The window is pixel-major, so the A fragment of
//           output pixel x at K offset kk of row ty is window[ty + oy][x * cp
//           + kk]: 4-byte loads (a pixel is not 16-byte aligned, so no
//           ldmatrix).  Where a tap is whole K steps (the final's 16 bf16
//           channels, 32 bytes) a window pixel takes 16 bytes more, which K
//           skips (window_pixel_bytes).  The weights hold zeros at the pad
//           channels and the tail of each run.  Stem K: 1584 bf16, 1728 int8.
//   banks   a fragment load reads 8 pixels, rows g of the m16 tile; at an odd
//           number of words a pixel (the stem) row g is pixel 4g + c of a
//           32-pixel block (row g + 8 the next pixel), so the 8 land 4 banks
//           apart: one wavefront a load, where 8 consecutive pixels took two.
//           Otherwise the rows are consecutive pixels, conflict-free at 4 mod
//           8 words (the final's 48-byte pixels).
//   block   8 warps, two warpgroups, own window_rows(BN) output rows x BM = 64
//           columns: warpgroup v's m64 tile is one output row, RW rows each;
//           two blocks an SM (three at BN <= 16, the final conv).
//   fill    the input rows by cp.async: a bf16 stage on an NHWC input (the
//           final) straight into the window's pixels; the pack stem and the
//           int8 stages into a staging area of raw bf16 (from the f4 pack 8
//           bytes at a time: a pack pixel's subpixel row is 4 input pixels x
//           cin, contiguous).  Then one pass writes each 32-bit word of the
//           window once, from the staged operands by a funnel shift, with the
//           prologue or the int8 quantization applied once per element (a
//           thread keeps one word's channels, their affine in registers),
//           zeros at the pad channels and outside the image.
//   MMA     as on the halo path: weight slices by TMA through a ring of
//           RING, wgmma with A from registers, one slice's group in flight;
//           at BN 8 (the final's 3 columns) mma.sync from the same slices.
//   after   as on the halo path: the sums through an f32 tile in shared
//           memory to tile_epilogue, then flush_moments.
//
// The frame graph (ops/fused_transfer.py FusedTransfer._capture_frame): one
// frame's launches recorded into a CUDA graph read the caller's frame pack in
// one node, the stem's, through Params::x.  rst_graph_input_node finds that
// node once, after the capture; rst_graph_set_input points it at another pack
// in the instantiated graph before a replay, so the graph reads every pack
// where it lies and holds no copy of it.
//
// "// PROFILE LAP i" marks the end of phase i of the halo and window kernels
// for halo_profile.py, which turns each marker into a clock64 counter in a
// copy of this file (the counters are written to Params::counters).
#include <vector>

#include "hopper.cuh"
#include "stage_common.cuh"

namespace {

constexpr int BM = 64;          // output columns of a window block: one m64 tile
constexpr int W_THREADS = 256;  // window path: 8 warps, two warpgroups
constexpr int MAX_CIN = 128;  // widest input that takes a CIN prologue
constexpr int MAX_DYN_BYTES = 200 * 1024;  // a block's dynamic shared memory cap
constexpr int GROUP = 32;     // blocks whose moment partials one block adds

enum { EPI_CONTRACT = 0, EPI_RELU = 1, EPI_BIAS = 2 };
enum { PATH_STRIDED = 0, PATH_WINDOW = 1, PATH_HALO = 2 };

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;      // the weight slices (ops/kernels.py halo_slices)
  long long* counters;         // null; halo_profile.py's clock64 counters
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
  int cin_k;                      // channel pitch of the K index
  int path;                       // PATH_STRIDED, PATH_WINDOW or PATH_HALO
  // int8 stage (after the bf16 fields, which keep their offsets)
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

// ---- halo path: a 2-D output tile over its input halo in shared memory -----

constexpr int HALO_TH = 8;        // output rows of a halo tile
constexpr int HALO_TW = 16;       // output columns of a halo tile: one m16 MMA tile
constexpr int H_THREADS = 256;    // 8 warps, two warpgroups ...
constexpr int HALO_ROWS = HALO_TH / (H_THREADS / 32);  // ... of one tile row each
constexpr int RING = 3;           // weight slices in shared memory
constexpr int SLICE_BYTES = 128;  // bytes of K a slice holds: 64 bf16 or 128 int8

// Bytes of a halo pixel: cin_k operands rounded up to an odd number of
// 16-byte units, so the 8 rows of an ldmatrix fall in distinct bank groups.
__host__ __device__ constexpr int halo_pitch(int cin_k, int esize) {
  return 16 * (((cin_k * esize + 15) / 16) | 1);
}

// Pixels of a halo tile.  Stride 2 (the strided path): (2*HALO_TH + kh - 2)
// rows of two parity planes, each halo_plane(kw) pixels wide.
__host__ __device__ constexpr int halo_plane(int kw) { return HALO_TW + (kw - 1) / 2; }

__host__ __device__ constexpr int halo_pixels(int kh, int kw, bool s2 = false) {
  return s2 ? (2 * HALO_TH + kh - 2) * 2 * halo_plane(kw) : (HALO_TH + kh - 1) * (HALO_TW + kw - 1);
}

// The block's dynamic shared memory: the halo tile (padded to 128 bytes),
// then the weight ring, which an int8 stage first uses to stage its raw bf16
// halo and which holds the moment slots after the K loop.
__host__ __device__ constexpr int halo_tile_bytes(int kh, int kw, int cin_k, int esize,
                                                  bool s2 = false) {
  return (halo_pixels(kh, kw, s2) * halo_pitch(cin_k, esize) + 127) / 128 * 128;
}

__host__ __device__ constexpr int halo_ring_bytes(int kh, int kw, int cin, int bn, bool q,
                                                  bool s2 = false) {
  return q && halo_pixels(kh, kw, s2) * cin * 2 > RING * bn * SLICE_BYTES
             ? halo_pixels(kh, kw, s2) * cin * 2
             : RING * bn * SLICE_BYTES;
}

// After the K loop the same bytes hold the epilogue's f32 tile of px pixels,
// [pixel][BN + 4], the moment partials of its 256 threads (4 columns each),
// [2][4 x threads], and the moment slots, [2][warps][BN] (tile_epilogue).
__host__ __device__ constexpr int epi_bytes(int px, int bn) {
  return 4 * (px * (bn + 4) + 2 * 4 * H_THREADS + 2 * (H_THREADS / 32) * bn);
}
constexpr int HALO_PX = HALO_TH * HALO_TW;
__host__ __device__ constexpr int halo_epi_bytes(int bn) { return epi_bytes(HALO_PX, bn); }

__host__ __device__ constexpr int halo_bytes(int kh, int kw, int cin, int bn, bool q,
                                             bool s2 = false) {
  return halo_tile_bytes(kh, kw, cin, q ? 1 : 2, s2) + halo_ring_bytes(kh, kw, cin, bn, q, s2) >
                 halo_epi_bytes(bn)
             ? halo_tile_bytes(kh, kw, cin, q ? 1 : 2, s2) + halo_ring_bytes(kh, kw, cin, bn, q, s2)
             : halo_epi_bytes(bn);
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
// channel byte; a tap's A rows are the tile's pixels shifted by (ty, tx).  At
// stride 2 (S2) a halo row is two parity planes of hc / 2 pixels: tap column
// tx lies in plane tx % 2, tx / 2 pixels in.
template <bool S2>
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
    if constexpr (S2) {
      const int tx = tap - ty * kw.d;
      return (ty * hc + (tx & 1) * (hc >> 1) + (tx >> 1)) * pitch + cb;
    }
    return (ty * hc + tap - ty * kw.d) * pitch + cb;
  }
};

// The input column, from the halo's first, of pixel r of a stride-2 halo row:
// the even columns come first (plane 0), then the odd ones (plane 1).
__device__ __forceinline__ int halo_col(int r, int pw) {
  const int odd = r >= pw;
  return 2 * (r - odd * pw) + odd;
}

// The A fragment of an int8 stage whose taps are 8 bytes (Cin = 8 mod 16),
// which split an ldmatrix row: four 4-byte loads, each inside one tap.
// (Built field by field: a make_uint4 of these words changed how NVVM lowers
// the bf16 window kernels' 16-byte zero stores.)
template <bool S2>
__device__ __noinline__ uint4 halo_a_words(const unsigned char* row, int kb, const HaloK<S2>& hk) {
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

// The epilogue from the f32 sums of a block's tile in shared memory, tv =
// [PX][BN + 4] with pixel i the output (oy0 + i / TW, ox0 + i % TW) (an
// int8 stage's already dequantized): one compact loop applies it to four
// columns of a pixel a thread, stores them (a warp's quads are consecutive
// pixels' bytes) and adds the moments in a fixed order: each thread over its
// pixels in order, then the threads of a column in order into slot 0 of the
// slots after tv (flush_moments adds the other, zero, slots after it), which
// it returns.
template <int BN, int NT, int PX, int TW>
__device__ __forceinline__ float* tile_epilogue(const Params& p, float* tv, int oy0, int ox0,
                                              int n0) {
  constexpr int NW = NT / 32;
  constexpr int EP = BN + 4;           // f32 pitch of a tile pixel
  constexpr int QUADS = BN / 4;        // column quads a pixel
  constexpr int TPC = NT / QUADS;      // threads a column quad
  float* part = tv + PX * EP;          // [2][TPC][BN]
  float* slots = part + 2 * TPC * BN;  // [2][NW][BN]
  const int tid = threadIdx.x;
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
  for (int i = phase; i < PX; i += TPC) {
    const int oy = oy0 + i / TW, ox = ox0 + i % TW;
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
    for (int i = tid; i < BN; i += NT) {
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
  return slots;
}

// Two blocks an SM at BN = 128 (their shared memory allows no more); the
// narrower expands, many waves of small blocks, trade registers for blocks.
// S2: the strided path, a stride-2 conv over a parity-split tile.
template <int BN, bool Q, bool S2 = false>
__global__ void __launch_bounds__(H_THREADS, S2 && Q && BN <= 32 ? 3 : BN <= 32 ? 4 : BN <= 64 ? 3 : 2)
    conv_halo_kernel(const Params p) {
  constexpr int ES = Q ? 1 : 2;  // bytes an operand
  constexpr int NW = H_THREADS / 32;
  __shared__ BlockState<Q> st;
  __shared__ __align__(8) uint64_t full[RING];  // slice kt has landed in buffer kt % RING
  extern __shared__ __align__(16) unsigned char halo_dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // hc: pixels of a halo row (S2: two parity planes of pw pixels each)
  const int pw = halo_plane(p.KW);
  const int hc = S2 ? 2 * pw : HALO_TW + p.KW - 1, npix = halo_pixels(p.KH, p.KW, S2);
  const int pitch = halo_pitch(p.cin_k, ES);
  unsigned char* tile = halo_dyn;
  unsigned char* ring = halo_dyn + halo_tile_bytes(p.KH, p.KW, p.cin_k, ES, S2);
  const int tiles_x = (p.OW + HALO_TW - 1) / HALO_TW;
  const int by = blockIdx.x / tiles_x;
  const int oy0 = by * HALO_TH, ox0 = (blockIdx.x - by * tiles_x) * HALO_TW;
  const int n0 = blockIdx.y * BN;
  constexpr int SY = S2 ? 2 : 1;  // the stride
  const int y0 = SY * oy0 - p.pt, x0 = SY * ox0 - p.pl;  // input pixel of halo (0, 0)
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
    const int hy = hcd.div(q), iy = y0 + hy;
    const int ix = S2 ? x0 + halo_col(q - hy * hc, pw) : x0 + q - hy * hc;
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
      const int hy = hcd.div(q), hx = S2 ? halo_col(q - hy * hc, pw) : q - hy * hc;
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

  // warp w holds tile row w: warpgroup v's m64 tile is tile rows 4v..4v+3;
  // tile row w reads halo rows SY*w + ty
  AccT<Q> acc[HALO_ROWS][BN / 2];
#pragma unroll
  for (int r = 0; r < HALO_ROWS; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0;

  const HaloK<S2> hk{FastDiv(p.cin_k * ES), FastDiv(p.KW), p.KH * p.KW, hc, pitch};
  const int k_real = hk.taps * hk.tap_bytes.d;
  // ldmatrix lanes: A row = tile column lane % 16, k half lane / 16
  const int a_col = lane & 15, a_half = (lane >> 4) * 16;
  // an int8 stage whose Cin is 8 mod 16 has taps of 8 bytes, which split an
  // ldmatrix row: its A fragments are 4-byte loads, each in one tap
  const bool words = Q && (hk.tap_bytes.d & 15);
  const unsigned char* a_base = tile + (SY * warp * hc + a_col) * pitch;
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
            const uint4 v = halo_a_words(tile + SY * (warp + NW * r) * hc * pitch, kb, hk);
            a[ks][r][0] = v.x;
            a[ks][r][1] = v.y;
            a[ks][r][2] = v.z;
            a[ks][r][3] = v.w;
          } else {
            ldsm_x4(a[ks][r], a_base + SY * NW * r * hc * pitch + a_off);
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

  // The epilogue: the sums go to an f32 tile in shared memory (an int8
  // stage's dequantized there), then tile_epilogue.
  constexpr int EP = BN + 4;  // f32 pitch of a tile pixel
  float* tv = reinterpret_cast<float*>(halo_dyn);  // [HALO_PX][EP]
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
  float* slots = tile_epilogue<BN, H_THREADS, HALO_PX, HALO_TW>(p, tv, oy0, ox0, n0);
  // PROFILE LAP 5
  flush_moments<BN, H_THREADS>(p, slots);
  // PROFILE LAP 6
}

// ---- window path: the 9x9 stages over a pixel-major input window -----------

// Output rows of a window block, half of them a warpgroup's: as many as the
// registers of two blocks an SM hold.
__host__ __device__ constexpr int window_rows(int bn) { return bn <= 32 ? 4 : 2; }

// Operands of a tap in K: cin rounded up to a 32-bit word (2 bf16, 4 int8),
// so every fragment register is an aligned load.
__host__ __device__ constexpr int window_pitch(int cin, bool q) {
  return q ? (cin + 3) / 4 * 4 : (cin + 1) / 2 * 2;
}

// Bytes of a window pixel: a tap's, and, where a tap is whole wgmma K steps
// (32 bytes), 16 more if that makes a multiple of 8 words, whose 8 fragment
// rows would take two bank wavefronts (see "banks"); a K step then lies in
// one pixel, so the padding stays out of K.
__host__ __device__ constexpr int window_pixel_bytes(int cin, bool q) {
  return window_pitch(cin, q) * (q ? 1 : 2) + (window_pitch(cin, q) * (q ? 1 : 2) % 32 ? 0 : 16);
}

// Operands of K a tap row: kw pixels, rounded up to a wgmma K step.
__host__ __device__ constexpr int window_k_row(int kw, int cin, bool q) {
  return q ? (kw * window_pitch(cin, q) + 31) / 32 * 32 : (kw * window_pitch(cin, q) + 15) / 16 * 16;
}

// Pixels of a window row: BM, plus the pixels the K run of the last output
// column reaches, rounded up to a pack pixel's 4.
__host__ __device__ constexpr int window_cols(int kw, int cin, bool q) {
  return (BM + (window_k_row(kw, cin, q) + window_pitch(cin, q) - 1) / window_pitch(cin, q) + 3) /
         4 * 4;
}

// Bytes of a window row: window_cols pixels, a multiple of 16 (a multiple of
// 4 pixels of whole words).
__host__ __device__ constexpr int window_row_bytes(int kw, int cin, bool q) {
  return window_cols(kw, cin, q) * window_pixel_bytes(cin, q);
}

// The raw bf16 input rows a fill stages, [rows][window_cols][cin]: none for
// a bf16 stage on an NHWC input, whose pixels land in the window itself.
__host__ __device__ constexpr int window_raw_bytes(int kh, int kw, int cin, int bn, bool q,
                                                   bool pack) {
  return q || pack ? ((window_rows(bn) + kh - 1) * window_cols(kw, cin, q) * cin * 2 + 127) /
                         128 * 128
                   : 0;
}

// The block's dynamic shared memory, each part padded to 128 bytes: the
// window, window_rows + kh - 1 rows; the raw input rows (window_raw_bytes);
// the weight ring.  After the K loop the bytes from the start hold the
// epilogue's (epi_bytes), if that is larger.
__host__ __device__ constexpr int window_fill_bytes(int kh, int kw, int cin, int bn, bool q,
                                                    bool pack) {
  return ((window_rows(bn) + kh - 1) * window_row_bytes(kw, cin, q) + 127) / 128 * 128 +
         window_raw_bytes(kh, kw, cin, bn, q, pack) + RING * bn * SLICE_BYTES;
}

__host__ __device__ constexpr int window_bytes(int kh, int kw, int cin, int bn, bool q, bool pack) {
  return window_fill_bytes(kh, kw, cin, bn, q, pack) > epi_bytes(window_rows(bn) * BM, bn)
             ? window_fill_bytes(kh, kw, cin, bn, q, pack)
             : epi_bytes(window_rows(bn) * BM, bn);
}

// 8 bytes global -> shared (cp.async.cg takes 16 only); zero-filled if !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

template <int BN, bool Q>
__global__ void __launch_bounds__(W_THREADS, BN <= 16 ? 3 : 2) conv_window_kernel(const Params p) {
  constexpr int ES = Q ? 1 : 2;            // bytes an operand
  constexpr int RB = window_rows(BN);      // output rows of the block ...
  constexpr int RW = RB / 2;               // ... and of a warpgroup
  constexpr int STEPS = SLICE_BYTES / 32;  // wgmma K steps a slice
  __shared__ BlockState<Q> st;
  __shared__ __align__(8) uint64_t full[RING];  // slice kt has landed in buffer kt % RING
  extern __shared__ __align__(16) unsigned char window_dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cin = p.Cin, cpb = p.cin_k * ES;  // bytes of a tap in K
  const int wpb = window_pixel_bytes(cin, Q);  // bytes of a window pixel
  const int wc = window_cols(p.KW, cin, Q), rb = window_row_bytes(p.KW, cin, Q);
  const int wrows = RB + p.KH - 1;
  // a bf16 stage on an NHWC input copies its pixels straight into the
  // window and applies the prologue there; the others stage them raw
  const bool direct = !Q && p.pack_c == 0;
  unsigned char* win = window_dyn;
  __nv_bfloat16* raw =
      reinterpret_cast<__nv_bfloat16*>(window_dyn + (wrows * rb + 127) / 128 * 128);
  unsigned char* ring = reinterpret_cast<unsigned char*>(raw) +
                        window_raw_bytes(p.KH, p.KW, cin, BN, Q, p.pack_c > 0);
  const int tiles_x = (p.OW + BM - 1) / BM;
  const int by = blockIdx.x / tiles_x;
  const int oy0 = by * RB, ox0 = (blockIdx.x - by * tiles_x) * BM;
  const int n0 = blockIdx.y * BN;
  const int y0 = oy0 - p.pt, x0 = ox0 - p.pl;  // input pixel of window (0, 0)
  // the block's column block of the weight slices, nk of BN x SLICE_BYTES
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
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);
    for (int s = 0; s < RING - 1; ++s) load_slice(s);  // in flight during the fill
  }

  // The raw input rows, [wrows][wc][cin] bf16, zero outside the image.  From
  // the f4 pack, 4 window pixels are one pack pixel's subpixel row, 4 * cin
  // contiguous bf16, copied 8 bytes at a time (x0 is a multiple of 4).
  if (p.pack_c > 0) {
    const int gx = wc / 4, wp = p.W / 4, px0 = x0 / 4;
    for (int e = tid; e < wrows * gx * cin; e += W_THREADS) {
      const int u = e / cin, i = e - u * cin;
      const int wy = u / gx, iy = y0 + wy, px = px0 + u - wy * gx;
      const bool in = iy >= 0 && iy < p.H && px >= 0 && px < wp;
      cp_async8(raw + (size_t)u * 4 * cin + 4 * i,
                in ? p.x + ((size_t)(iy >> 2) * wp + px) * p.pack_c + (iy & 3) * 4 * cin + 4 * i
                   : p.x,
                in);
    }
  } else {
    const int c8 = cin / 8;
    for (int e = tid; e < wrows * wc * c8; e += W_THREADS) {
      const int q = e / c8, c = (e - q * c8) * 8;
      const int wy = q / wc, iy = y0 + wy, ix = x0 + q - wy * wc;
      const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      cp_async16(direct ? win + q * wpb + 2 * c : reinterpret_cast<unsigned char*>(raw + q * cin + c),
                 in ? p.x + ((size_t)iy * p.W + ix) * cin + c : p.x, in);
    }
  }
  cp_async_commit();
  block_init<W_THREADS, Q>(p, st);
  // PROFILE LAP 0
  cp_async_wait<0>();
  __syncthreads();
  // PROFILE LAP 1

  // The window: wrows * wc pixels of wpb bytes (rb = wc * wpb), its
  // prologue (or int8 quantization) applied once per element, zeros at the
  // pad channels and outside the image (the conv pads x').  A direct fill
  // is transformed in place, as on the halo path: a thread keeps one
  // 16-byte chunk of every pstep-th pixel (8 channels), its affine in
  // registers.  A staged one is written a 32-bit word at a time: a thread
  // keeps one word k of every pstep-th pixel, channels c .. c + CW - 1, and
  // builds it from the staged operands by a funnel shift (consecutive
  // threads' words are consecutive: no bank conflicts).
  if (direct) {
    const int chunks = wpb / 16, pstep = W_THREADS / chunks;
    const int k = tid % chunks, q0 = tid / chunks, c = min(8 * k, MAX_CIN - 8);
    const bool transform = p.in_affine || p.in_relu;
    float sa[8], sb[8], sda[8], sdb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sa[i] = st.a[c + i];
      sb[i] = st.b[c + i];
      sda[i] = p.dual ? st.da[c + i] : 0.f;
      sdb[i] = p.dual ? st.db[c + i] : 0.f;
    }
    const FastDiv wcd(wc);
#pragma unroll 4
    for (int q = q0; q0 < pstep && q < wrows * wc; q += pstep) {
      const int wy = wcd.div(q), iy = y0 + wy, ix = x0 + q - wy * wc;
      const bool in = 8 * k < cin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      uint4* chunk = reinterpret_cast<uint4*>(win + q * wpb) + k;
      uint4 v = *chunk;
      if (transform) {
        const float wv =
            p.dual ? __bfloat162float(p.weight[in ? (size_t)iy * p.W + ix : 0]) : 0.f;
        v = transform8(v, 0, sa, sb, sda, sdb, wv, p.in_affine, p.dual, p.in_relu, nullptr);
      }
      if (!in) v = make_uint4(0, 0, 0, 0);
      *chunk = v;
    }
  } else {
    constexpr int CW = 4 / ES;  // channels a word
    const int words = wpb / 4, pstep = W_THREADS / words;
    const int k = tid % words, q0 = tid / words, c = k * CW;
    const bool transform = p.in_affine || p.in_relu;
    float sa[CW], sb[CW], sda[CW], sdb[CW], sinv[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const int ci = min(c + i, MAX_CIN - 1);
      sa[i] = st.a[ci];
      sb[i] = st.b[ci];
      sda[i] = p.dual ? st.da[ci] : 0.f;
      sdb[i] = p.dual ? st.db[ci] : 0.f;
      if constexpr (Q) sinv[i] = st.inv[ci];
    }
    const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(raw);
    const FastDiv wcd(wc);
    // no branch around the body, so unrolled iterations overlap: outside the
    // image the staged operands are zero, the weight plane is read at pixel
    // 0, and the word is zeroed after the transform
#pragma unroll 4
    for (int q = q0; q0 < pstep && q < wrows * wc; q += pstep) {
      const int wy = wcd.div(q), iy = y0 + wy, ix = x0 + q - wy * wc;
      const bool in = c < cin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int s = q * cin + c, sh = (s & 1) * 16;  // the staged operand, 2-byte aligned
      const uint32_t* r = raw32 + (s >> 1);
      uint32_t h[2];
      h[0] = __funnelshift_r(r[0], r[1], sh);
      h[1] = Q ? __funnelshift_r(r[1], r[2], sh) : 0u;
      uint32_t word = 0;
      if (!Q && !transform) {
        word = c + 1 < cin ? h[0] : h[0] & 0xffffu;
      } else {
        const float wv =
            p.dual ? __bfloat162float(p.weight[in ? (size_t)iy * p.W + ix : 0]) : 0.f;
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          __nv_bfloat16 v = __ushort_as_bfloat16((unsigned short)(h[i >> 1] >> (16 * (i & 1))));
          if (transform) {
            const float x = __bfloat162float(v);
            float f = x;
            if (p.in_affine) {
              f = __fadd_rn(__fmul_rn(x, sa[i]), sb[i]);
              if (p.dual) f = __fadd_rn(f, __fmul_rn(wv, __fadd_rn(__fmul_rn(x, sda[i]), sdb[i])));
            }
            if (p.in_relu) f = fmaxf(f, 0.f);
            v = __float2bfloat16_rn(f);
          }
          uint32_t bits;
          if constexpr (Q)
            bits = ((uint32_t)quantize1(v, sinv[i]) & 0xffu) << (8 * i);
          else
            bits = (uint32_t)__bfloat16_as_ushort(v) << (16 * i);
          if (c + i < cin) word |= bits;
        }
      }
      *reinterpret_cast<uint32_t*>(win + q * wpb + 4 * k) = in ? word : 0u;
    }
  }
  __syncthreads();
  // PROFILE LAP 2

  // Warpgroup v holds output rows v*RW .. v*RW + RW - 1, each one m64 tile
  // of the BM columns.  Warp w's m16 part: its rows g and g + 8 are columns
  // col and col + dcol, so that the 8 pixels of a fragment load fall in
  // distinct banks: at an odd number of words a pixel, col = 32*(w%4 / 2) +
  // 4g + 2*(w%2) and dcol = 1 (the 8 pixels 4 apart); otherwise col =
  // 16*(w%4) + g and dcol = 8 (the 8 consecutive, conflict-free at 4 mod 8
  // words, two-way at 0 mod 8).  Its fragment register i of row r is pixel
  // col + dcol*(i&1), K byte 4*t4 + 16*(i>>1) of the step, from window row
  // v*RW + r + ty.
  const int v = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const bool odd = (wpb / 4) & 1;
  const int col = odd ? 32 * ((warp & 3) >> 1) + 4 * g + 2 * (warp & 1) : 16 * (warp & 3) + g;
  const int dcol = odd ? 1 : 8, drow = dcol * wpb;
  // K byte kin of a tap row is window byte kin, or, where the pixels are
  // padded (wpb > cpb), byte kin % cpb of tap kin / cpb's pixel
  const FastDiv cpbd(cpb);
  const int run = window_k_row(p.KW, cin, Q) * ES;  // K bytes a tap row
  const int k_real = p.KH * run;
  const FastDiv rund(run);
  const unsigned char* a_base = win + v * RW * rb + col * wpb + 4 * t4;
  AccT<Q> acc[RW][BN / 2];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0;

  // Slice kt as on the halo path: wait for its bytes, load its A fragments
  // into a while slice kt - 1's wgmmas run, issue its group, wait for slice
  // kt - 1's, then refill that ring buffer.
  auto slice = [&](int kt, uint32_t (&a)[STEPS][RW][4]) {
    mbar_wait(&full[kt % RING], (kt / RING) & 1);
    const uint32_t bs = smem_addr(ring + (kt % RING) * (BN * SLICE_BYTES));
    uint64_t desc[STEPS];
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const int kb = kt * SLICE_BYTES + ks * 32;
      desc[ks] = slice_desc(bs + ks * 32 * 8);
      if (kb < k_real) {
        const int ty = rund.div(kb), kin = kb - ty * run, tx = cpbd.div(kin);
        const unsigned char* ak = a_base + ty * rb + kin + tx * (wpb - cpb);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const unsigned char* ar = ak + r * rb;
          a[ks][r][0] = *reinterpret_cast<const uint32_t*>(ar);
          a[ks][r][1] = *reinterpret_cast<const uint32_t*>(ar + drow);
          a[ks][r][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
          a[ks][r][3] = *reinterpret_cast<const uint32_t*>(ar + drow + 16);
        }
      }
    }
    if constexpr (BN == 8) {
      // one n8 column block (the final conv): mma.sync, its B fragment (n =
      // g, K bytes 4*t4 and 16 + 4*t4 of the step) from the slice's core
      // matrices, so no warpgroup fences or groups a slice: 6-8% faster
      // than wgmma m64n8 on the final, bf16 and int8 (PERF.md section 6)
#pragma unroll
      for (int ks = 0; ks < STEPS; ++ks)
        if (kt * SLICE_BYTES + ks * 32 < k_real) {
          const unsigned char* bk = ring + (kt % RING) * (BN * SLICE_BYTES) + ks * 256 + g * 16 + 4 * t4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bk);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bk + 128);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            if constexpr (Q)
              mma16832_s8(acc[r], a[ks][r], b0, b1);
            else
              mma16816(acc[r], a[ks][r], b0, b1);
          }
        }
    } else {
#pragma unroll
      for (int r = 0; r < RW; ++r) wgmma_fence_operand(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < STEPS; ++ks)
        if (kt * SLICE_BYTES + ks * 32 < k_real)
#pragma unroll
          for (int r = 0; r < RW; ++r) Wgmma<BN, Q>::mma(acc[r], a[ks][r], desc[ks]);
      wgmma_commit();
      wgmma_wait<1>();
    }
    __syncthreads();
    if (tid == 0) load_slice(kt + RING - 1);
  };
  uint32_t a0[STEPS][RW][4], a1[STEPS][RW][4];
  for (int kt = 0; kt < nk; kt += 2) {
    slice(kt, a0);
    if (kt + 1 < nk) slice(kt + 1, a1);
  }
  wgmma_wait<0>();
  // PROFILE LAP 3
#pragma unroll
  for (int r = 0; r < RW; ++r) wgmma_fence_operand(acc[r]);
  __syncthreads();  // every warp is done with the window: it takes the f32 tile

  // The sums to an f32 tile in shared memory, pixel (v*RW + r) * BM + col (+
  // dcol for rows g + 8), an int8 stage's dequantized there; then
  // tile_epilogue.
  constexpr int EP = BN + 4;  // f32 pitch of a tile pixel
  float* tv = reinterpret_cast<float*>(window_dyn);  // [RB * BM][EP]
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j * 8 + 2 * t4;
        float2 f;
        if constexpr (Q) {
          f.x = __fmul_rn(__int2float_rn(acc[r][4 * j + 2 * h]), p.dequant[min(n0 + n, p.N - 1)]);
          f.y = __fmul_rn(__int2float_rn(acc[r][4 * j + 2 * h + 1]),
                          p.dequant[min(n0 + n + 1, p.N - 1)]);
        } else {
          f = make_float2(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
        }
        *reinterpret_cast<float2*>(tv + ((v * RW + r) * BM + col + h * dcol) * EP + n) = f;
      }
  __syncthreads();
  float* slots = tile_epilogue<BN, W_THREADS, RB * BM, BM>(p, tv, oy0, ox0, n0);
  // PROFILE LAP 4
  flush_moments<BN, W_THREADS>(p, slots);
  // PROFILE LAP 5
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

template <int BN, bool Q, bool S2>
cudaError_t launch_halo(const Params& p, cudaStream_t stream) {
  const int bytes = halo_bytes(p.KH, p.KW, p.Cin, BN, Q, S2);
  if (p.pack_c > 0 || p.cin_k != p.Cin || p.Cin % 8 || p.Cin > 8 * H_THREADS ||
      bytes > MAX_DYN_BYTES ||
      ((p.in_affine || Q) && p.Cin > MAX_CIN) ||
      (p.skip_out && (S2 || p.OH != p.H || p.OW != p.W)))
    return cudaErrorInvalidValue;
  const dim3 grid(((p.OH + HALO_TH - 1) / HALO_TH) * ((p.OW + HALO_TW - 1) / HALO_TW),
                  (p.N + BN - 1) / BN);
  if (!scratch_fits<BN>(p, grid)) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_halo_kernel<BN, Q, S2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_DYN_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_halo_kernel<BN, Q, S2><<<grid, H_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, bool Q>
cudaError_t launch_window(const Params& p, cudaStream_t stream) {
  const int bytes = window_bytes(p.KH, p.KW, p.Cin, BN, Q, p.pack_c > 0);
  if (p.skip_in || p.skip_out || p.cin_k != window_pitch(p.Cin, Q) ||
      bytes > MAX_DYN_BYTES || ((p.in_affine || Q) && p.Cin > MAX_CIN) ||
      (p.pack_c > 0 ? p.pl % 4 || p.H % 4 || p.W % 4 || p.pack_c < 16 * p.Cin : p.Cin % 8))
    return cudaErrorInvalidValue;
  const dim3 grid(((p.OH + window_rows(BN) - 1) / window_rows(BN)) * ((p.OW + BM - 1) / BM),
                  (p.N + BN - 1) / BN);
  if (!scratch_fits<BN>(p, grid)) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_window_kernel<BN, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_DYN_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  conv_window_kernel<BN, Q><<<grid, W_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, bool Q>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  // the path the caller chose must be the one the geometry picks
  const int path = p.S == 2   ? PATH_STRIDED
                   : p.S != 1 ? -1
                   : p.KH * p.KW > 9 ? PATH_WINDOW
                                     : PATH_HALO;
  if (p.path != path) return cudaErrorInvalidValue;
  if (path == PATH_HALO) return launch_halo<BN, Q, false>(p, stream);
  if (path == PATH_STRIDED) return launch_halo<BN, Q, true>(p, stream);
  return launch_window<BN, Q>(p, stream);
}

template <int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.quant ? launch_typed<BN, true>(p, stream) : launch_typed<BN, false>(p, stream);
}
}  // namespace

extern "C" int rst_conv_stage(
    const void* x, const void* w, void* counters, const void* bias,
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
  p.counters = static_cast<long long*>(counters);
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

namespace {
// Whether a graph node's function is one of this file's kernels, whose one
// argument is a Params.
template <int BN>
bool is_kernel_bn(const void* f) {
  return f == (const void*)conv_halo_kernel<BN, false, false> ||
         f == (const void*)conv_halo_kernel<BN, true, false> ||
         f == (const void*)conv_halo_kernel<BN, false, true> ||
         f == (const void*)conv_halo_kernel<BN, true, true> ||
         f == (const void*)conv_window_kernel<BN, false> ||
         f == (const void*)conv_window_kernel<BN, true>;
}

bool is_conv_kernel(const void* f) {
  return is_kernel_bn<8>(f) || is_kernel_bn<16>(f) || is_kernel_bn<32>(f) ||
         is_kernel_bn<64>(f) || is_kernel_bn<128>(f);
}

// The parameters of a kernel node that launches one of this file's kernels;
// false for any other node.  A kernel of another library's runtime may not
// resolve here: its error is cleared, so that the next launch's
// cudaGetLastError does not report it.
bool conv_node_params(cudaGraphNode_t node, cudaKernelNodeParams* kp) {
  cudaGraphNodeType type;
  if (cudaGraphNodeGetType(node, &type) != cudaSuccess || type != cudaGraphNodeTypeKernel ||
      cudaGraphKernelNodeGetParams(node, kp) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return is_conv_kernel(kp->func);
}
}  // namespace

// The node of the captured graph `graph` that launches one of this file's
// kernels on the input x (Params::x) -> *node; *matches counts such nodes.
// cudaErrorInvalidValue unless exactly one matches.
extern "C" int rst_graph_input_node(void* graph, const void* x, void** node, int* matches) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  *matches = 0;
  for (cudaGraphNode_t nd : nodes) {
    cudaKernelNodeParams kp;
    if (conv_node_params(nd, &kp) && static_cast<const Params*>(kp.kernelParams[0])->x == x) {
      *node = nd;
      ++*matches;
    }
  }
  return static_cast<int>(*matches == 1 ? cudaSuccess : cudaErrorInvalidValue);
}

// Points the node found by rst_graph_input_node at the input x in the
// instantiated graph `exec`: its Params as recorded, with x replaced.  The
// update applies to launches of `exec` made after it.
extern "C" int rst_graph_set_input(void* exec, void* node, const void* x) {
  const cudaGraphNode_t nd = static_cast<cudaGraphNode_t>(node);
  cudaKernelNodeParams kp;
  if (!conv_node_params(nd, &kp)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = *static_cast<const Params*>(kp.kernelParams[0]);
  p.x = static_cast<const __nv_bfloat16*>(x);
  void* args[] = {&p};
  kp.kernelParams = args;
  kp.extra = nullptr;
  return static_cast<int>(
      cudaGraphExecKernelNodeSetParams(static_cast<cudaGraphExec_t>(exec), nd, &kp));
}
