// probe_rep: the repeated tap product of the two matmul probes on Hopper,
// shared by probe_int8.cu (its mm and band arms) and probe_smem.cu (its work
// arm).  The design note is at the head of probe_int8.cu.
//
// Roles: the output is out[px][n] = sum over taps and K of act[px'][k] *
// w[tap][n][k].  The weights are wgmma's A operand (M = the 128 output
// columns, one m64 half a warpgroup) and stay in registers for the whole
// launch; the activations (x or the band's window) are its B operand (N =
// 128 pixels of a tile), K-major in shared memory, read by descriptor.
//
// Shared memory holds 16-byte planes: plane p of a (rows, K) operand is
// bytes 16p..16p+15 of every row, the rows 16 bytes apart, so 8 consecutive
// rows of a plane are one 128-byte wgmma core matrix (LBO: the plane's
// size, SBO: 128).  TMA lands each plane as one box of a 4-d tensor map
// (elements of 16 bytes, planes, columns, rows), zero-filled outside the
// tensor.
#pragma once
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int REP_C = 128;        // K of a tap and N of every product
constexpr int REP_THREADS = 256;  // two consumer warpgroups: output columns 0..63, 64..127
constexpr int REP_TILE = 128;     // pixels of a tile: wgmma's N
constexpr int REP_WIN = REP_TILE + 2;  // pixels of a band window row: the tile and its two halo
constexpr int REP_PITCH = 136;    // pixels a band plane holds: REP_WIN, a multiple of 8 (128 bytes)
constexpr int REP_SLOT = 16 * REP_THREADS * 4;  // sums a partial: 128 pixels x 128 columns

enum { REP_MM = 0, REP_BAND = 1 };

struct RepParams {
  void* out;            // (rows_out * width, 128) f32, or s32 for int8
  void* partials;       // [slots][16][REP_THREADS][4] f32 or s32
  const float* act_inv;  // (128,) the band's int8 quantization, else null
  long long* counters;  // null; halo_profile.py's clock64 counters
  int width;            // pixels a row: mm the rows of x, band an output row's
  int nrep;
  int groups;           // groups a part: mm the tiles, band (output row, tile) pairs
  int tiles_x;          // tiles a row
  int bpp;              // blocks a part; part t owns blocks t * bpp ..
};

// The dynamic shared memory of an instantiation: the weights' staging, whose
// bytes are free once the weights are in registers.  mm: the two buffers of
// x tiles reuse them; the band: its three windows reuse them, and the two
// buffers of its bf16 input rows follow.
template <bool Q, int MODE, int T>
struct RepLayout {
  static constexpr int ES = Q ? 1 : 2;                  // bytes an operand
  static constexpr int KP = REP_C * ES / 16;            // 16-byte planes of K
  static constexpr int W_BYTES = T * REP_C * REP_C * ES;
  static constexpr int WIN_BYTES = MODE == REP_BAND ? KP * REP_PITCH * 16 : 0;
  static constexpr int X_BYTES = MODE == REP_BAND ? 16 * REP_PITCH * 16 : KP * REP_TILE * 16;
  static constexpr int X_OFF =
      MODE != REP_BAND ? 0 : W_BYTES > 3 * WIN_BYTES ? W_BYTES : 3 * WIN_BYTES;
  static constexpr int X_END = X_OFF + 2 * X_BYTES;
  static constexpr int BYTES = W_BYTES > X_END ? W_BYTES : X_END;
};

// The block of part-local unit u, where a part's `units` units are dealt to
// its bpp blocks in contiguous runs, block b taking [b * units / bpp, (b + 1)
// * units / bpp).
__device__ __forceinline__ int rep_block_of(long long u, long long units, int bpp) {
  return (int)(((u + 1) * bpp + units - 1) / units) - 1;
}

// 16 bf16 channels c..c+15 (two 16-byte planes) to 16 int8 values packed
// little-endian: clamp(rint(f32(x) * inv[c]), -127, 127), as
// stage_common.cuh's quantize8 gives them for finite x, on the FMA pipe
// instead of the converter (a quarter of its rate): the clamped product plus
// 1.5 * 2^23 rounds to an integer, ties to even, whose low byte is the int8
// value.
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi, const float* inv) {
  const uint32_t src[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t word[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t s = src[2 * j + (i >> 1)];
      const float x = __uint_as_float(i & 1 ? s & 0xffff0000u : s << 16);
      const float v = fminf(fmaxf(__fmul_rn(x, inv[4 * j + i]), -127.f), 127.f);
      b[i] = __float_as_uint(__fadd_rn(v, 12582912.f));
    }
    word[j] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                          0x5410);
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// Producer warps a block: the band's window fills run on a warpgroup of its
// own, beside the two consumer warpgroups that only issue wgmma (the fence
// that hands a fill to wgmma's async proxy, in the issuing warps, waited for
// their products in flight: measured, the fill did not overlap them).  The
// producers give registers to the consumers, who hold the weights.
constexpr int REP_PRODUCER_REGS = 72, REP_CONSUMER_REGS = 216;
__host__ __device__ constexpr int rep_producers(int mode) { return mode == REP_BAND ? 4 : 0; }

// One launch: every block computes its units, (group, repetition) pairs,
// and writes a partial sum a group it touched; after a grid barrier every
// block adds a share of the outputs' partials in a fixed order.
//   Q      int8 operands and s32 sums (bf16 and f32 otherwise)
//   MODE   REP_MM: x (width, 128) times T taps of weights, the same x for
//          every tap; REP_BAND: the 3x3 band conv, part dy's three taps
//   T      taps a block holds
//   TRANS  the weights are (T, k, n) (the work arm), read transposed
// Warps 0-7 are the consumers (two warpgroups); the band's producer warps
// follow them.
template <bool Q, int MODE, int T, bool TRANS>
__global__ void __launch_bounds__(REP_THREADS + 32 * rep_producers(MODE), 1)
    probe_rep_kernel(const RepParams p, const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap) {
  using L = RepLayout<Q, MODE, T>;
  using Acc = typename std::conditional<Q, int, float>::type;
  using Vec = typename std::conditional<Q, int4, float4>::type;
  constexpr bool BAND = MODE == REP_BAND;
  constexpr int KP = L::KP;
  constexpr int KSTEPS = KP / 2;  // wgmma K steps of a tap: k16 bf16, k32 s8
  constexpr int PT = 32 * rep_producers(MODE);  // producer threads
  constexpr int NT = REP_THREADS + PT;
  constexpr int CWARPS = REP_THREADS / 32;
  __shared__ __align__(8) uint64_t full_w, full_x[2];
  __shared__ __align__(8) uint64_t win_full[3];   // the producers filled window b
  __shared__ __align__(8) uint64_t win_empty[3];  // the consumers' products are done with it
  __shared__ __align__(8) uint64_t a_ready;       // the consumers hold the weights: the staging is free
  extern __shared__ __align__(128) unsigned char dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = blockIdx.x / p.bpp, lb = blockIdx.x - part * p.bpp;
  const long long units = (long long)p.groups * p.nrep;
  const long long u0 = lb * units / p.bpp, u1 = (lb + 1) * units / p.bpp;
  const int g_first = (int)(u0 / p.nrep);
  const int nseg = (int)((u1 - 1) / p.nrep) - g_first + 1;
  const CUtensorMap* xm = &xmap;
  // the repetitions of segment s: its group's units in [u0, u1)
  auto seg_count = [&](int s) {
    const long long gu = (long long)(g_first + s) * p.nrep;
    return (int)((u1 < gu + p.nrep ? u1 : gu + p.nrep) - (u0 > gu ? u0 : gu));
  };

  // segment s's x tile (mm) or input row (band) into buffer s % 2, by one warp
  auto load_x = [&](int s) {
    const int g = g_first + s;
    unsigned char* dst = dyn + L::X_OFF + (s & 1) * L::X_BYTES;
    if (lane == 0)
      mbar_expect_tx(&full_x[s & 1], BAND ? 16 * REP_WIN * 16 : KP * REP_TILE * 16);
    __syncwarp();
    if constexpr (BAND) {
      const int r = g / p.tiles_x, x0 = (g - r * p.tiles_x) * REP_TILE - 1;
      for (int pl = lane; pl < 16; pl += 32)
        tma_plane(dst + pl * REP_PITCH * 16, xm, pl, x0, r + part, &full_x[s & 1]);
    } else {
      for (int pl = lane; pl < KP; pl += 32)
        tma_plane(dst + pl * REP_TILE * 16, xm, pl, g * REP_TILE, 0, &full_x[s & 1]);
    }
  };

  if (tid == 0) {
    mbar_init(&full_w, 1);
    mbar_init(&full_x[0], 1);
    mbar_init(&full_x[1], 1);
    if constexpr (BAND)
      for (int b = 0; b < 3; ++b) {
        mbar_init(&win_full[b], PT);
        mbar_init(&win_empty[b], CWARPS);
      }
    mbar_init(&a_ready, CWARPS);
  }
  __syncthreads();
  // the first producer warp, else warp 0, issues the copies
  constexpr int LOADER = BAND ? CWARPS : 0;
  if (warp == LOADER) {
    // the block's taps, [tap][plane][128 rows][16 bytes]: the band's part dy
    // takes taps 3 dy .. 3 dy + 2
    if (lane == 0) mbar_expect_tx(&full_w, L::W_BYTES);
    __syncwarp();
    const int tap0 = BAND ? T * part : 0;
    for (int i = lane; i < T * KP; i += 32)
      tma_plane(dyn + (i / KP) * REP_C * REP_C * L::ES + (i % KP) * REP_C * 16, &wmap, i % KP,
                REP_C * (tap0 + i / KP), 0, &full_w);
    if constexpr (BAND) {
      load_x(0);
      if (nseg > 1) load_x(1);
    }
  }

  // A: warpgroup v's output columns 64v .. 64v + 63, warp w of it rows
  // 16w .. 16w + 15 of the m64 tile, every tap and K step, in registers; a
  // consumer warp's arrival on a_ready frees the staging (mm: the loader
  // then lands the first two x tiles there)
  const int v = warp >> 2, m0 = 64 * v + 16 * (warp & 3);
  uint32_t a[T][KSTEPS][4];
  auto load_a = [&]() {
    mbar_wait_or_trap(&full_w, 0);
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const unsigned char* wt = dyn + t * REP_C * REP_C * L::ES;
        if constexpr (TRANS)  // (k, n) planes of 8 n: matrix lane / 8 is n + 8 (bit 0), k + 8 (bit 1)
          ldsm_x4_trans(a[t][ks], wt + (m0 / 8 + ((lane >> 3) & 1)) * REP_C * 16 +
                                      (16 * ks + 8 * (lane >> 4) + (lane & 7)) * 16);
        else  // (n, k) planes of K: rows m0 + lane % 16, plane 2 ks + lane / 16
          ldsm_x4(a[t][ks], wt + (2 * ks + (lane >> 4)) * REP_C * 16 + (m0 + (lane & 15)) * 16);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&a_ready);
    if constexpr (!BAND)
      if (warp == LOADER) {
        mbar_wait_or_trap(&a_ready, 0);
        fence_proxy_async();  // the staging's reads before TMA's writes
        load_x(0);
        if (nseg > 1) load_x(1);
      }
  };

  // the segment's partial, from a consumer: slot (block + group), both
  // global, which no other (block, group) pair shares
  auto write_partial = [&](int s, const Acc (&acc)[64]) {
    Vec* slot = static_cast<Vec*>(p.partials) +
                (size_t)(blockIdx.x + part * p.groups + g_first + s) * (REP_SLOT / 4);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      Vec val;
      val.x = acc[4 * q];
      val.y = acc[4 * q + 1];
      val.z = acc[4 * q + 2];
      val.w = acc[4 * q + 3];
      slot[q * REP_THREADS + tid] = val;
    }
  };
  // Each output vector of 4 sums, (tile, n8 column tile q of its pixels,
  // consumer thread): the partials of every part's group of that tile,
  // parts in order, each part's blocks in order.
  auto reduce = [&]() {
    const int items = p.groups * (REP_SLOT / 4);
    const int parts = gridDim.x / p.bpp;
    Acc* out = static_cast<Acc*>(p.out);
    for (int it = blockIdx.x * NT + tid; it < items; it += gridDim.x * NT) {
      const int tile = it / (REP_SLOT / 4), rem = it - tile * (REP_SLOT / 4);
      const long long ua = (long long)tile * p.nrep;
      const int lo = rep_block_of(ua, units, p.bpp);
      const int hi = rep_block_of(ua + p.nrep - 1, units, p.bpp);
      Acc sum[4] = {0, 0, 0, 0};
      for (int pt = 0; pt < parts; ++pt)
        for (int b = lo; b <= hi; ++b) {
          const Vec val = __ldcg(static_cast<const Vec*>(p.partials) +
                                 (size_t)(pt * p.bpp + b + pt * p.groups + tile) *
                                     (REP_SLOT / 4) + rem);
          sum[0] += val.x;
          sum[1] += val.y;
          sum[2] += val.z;
          sum[3] += val.w;
        }
      // accumulator element 4q + i of thread th: column 64 v + 16 w + g (+ 8
      // for i >= 2), pixel 8 q + 2 t4 (+ 1 for odd i)
      const int q = rem / REP_THREADS, th = rem - q * REP_THREADS;
      const int col = 64 * (th >> 7) + 16 * ((th >> 5) & 3) + ((th & 31) >> 2);
      const int r = tile / p.tiles_x;
      const int px = (tile - r * p.tiles_x) * REP_TILE + 8 * q + 2 * (th & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (px + (i & 1) < p.width)
          out[((size_t)r * p.width + px + (i & 1)) * REP_C + col + 8 * (i >> 1)] = sum[i];
    }
  };

  // The band: every repetition refills (and for int8 quantizes) a window,
  // plane q, pixel x, from the segment's resident bf16 row.  The producers
  // fill window n % 3 for the block's n-th repetition once the consumers'
  // products of repetition n - 3 are done with it, while the consumers
  // multiply repetition n - 1's; they pass the grid barrier and add their
  // share of the outputs on their own.
  if (BAND && warp >= CWARPS) {
    if constexpr (BAND) {
      setmaxnreg_dec<REP_PRODUCER_REGS>();
      // producer thread pt keeps one window plane q, every PS-th pixel from
      // its first, and for int8 that plane's 16 act_inv values
      constexpr int PS = PT / KP;
      const int pt = tid - REP_THREADS, q = pt / PS, x0 = pt - q * PS;
      float rinv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) rinv[j] = Q ? p.act_inv[16 * q + j] : 0.f;
      mbar_wait_or_trap(&a_ready, 0);
      int n = 0;
      for (int s = 0; s < nseg; ++s) {
        mbar_wait_or_trap(&full_x[s & 1], (s >> 1) & 1);
        const uint4* row = reinterpret_cast<const uint4*>(dyn + L::X_OFF + (s & 1) * L::X_BYTES);
        for (int i = seg_count(s); i > 0; --i, ++n) {
          const int b = n % 3;
          if (n >= 3) mbar_wait_or_trap(&win_empty[b], (n / 3 - 1) & 1);
          uint4* win = reinterpret_cast<uint4*>(dyn + b * L::WIN_BYTES) + q * REP_PITCH;
#pragma unroll 1
          for (int x = x0; x < REP_WIN; x += PS)
            win[x] = Q ? quantize16(row[2 * q * REP_PITCH + x], row[(2 * q + 1) * REP_PITCH + x],
                                    rinv)
                       : row[q * REP_PITCH + x];
          fence_proxy_async();  // the window to wgmma's async proxy
          mbar_arrive(&win_full[b]);
        }
        // every producer is done with the row: its buffer takes segment s + 2's
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");
        if (warp == LOADER && s + 2 < nseg) load_x(s + 2);
      }
      cg::this_grid().sync();
      reduce();
    }
  } else {
    if constexpr (BAND) setmaxnreg_inc<REP_CONSUMER_REGS>();
    load_a();
    // PROFILE LAP 0
    Acc acc[64];
    const uint32_t x_base = smem_addr(dyn + L::X_OFF), win_base = smem_addr(dyn);
    int n = 0;  // the band: repetitions this block has multiplied
    for (int s = 0; s < nseg; ++s) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      if constexpr (BAND) {
        for (int i = seg_count(s), first = 1; i > 0; --i, ++n, first = 0) {
          const int b = n % 3;
          mbar_wait_suspended(&win_full[b], (n / 3) & 1);
          wgmma_fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < T; ++t)  // tap dx = t: the window shifted t pixels
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks)
              Wgmma<REP_C, Q>::mma(acc, a[t][ks],
                                   wgmma_desc(win_base + b * L::WIN_BYTES +
                                                  (2 * ks * REP_PITCH + t) * 16,
                                              REP_PITCH * 16, 128));
          wgmma_commit();
          wgmma_wait<1>();  // repetition n - 1's products are done with its window
          if (!first && lane == 0) mbar_arrive(&win_empty[(n + 2) % 3]);
        }
        wgmma_wait<0>();
        wgmma_fence_operand(acc);
        if (lane == 0) mbar_arrive(&win_empty[(n + 2) % 3]);  // the segment's last window
        write_partial(s, acc);
      } else {
        mbar_wait_or_trap(&full_x[s & 1], (s >> 1) & 1);
        const uint32_t xb = x_base + (s & 1) * L::X_BYTES;
        for (int i = seg_count(s); i > 0; --i) {
          wgmma_fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < T; ++t)  // every tap reads the same x
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks)
              Wgmma<REP_C, Q>::mma(acc, a[t][ks],
                                   wgmma_desc(xb + 2 * ks * REP_TILE * 16, REP_TILE * 16, 128));
          wgmma_commit();
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        wgmma_fence_operand(acc);
        write_partial(s, acc);
        fence_proxy_async();  // this segment's x tile is read: TMA may refill its buffer
        __syncthreads();
        if (warp == LOADER && s + 2 < nseg) load_x(s + 2);
      }
    }
    // PROFILE LAP 1
    cg::this_grid().sync();
    // PROFILE LAP 2
    reduce();
  }
  // PROFILE LAP 3
}

// A 4-d tensor map of 16-byte planes over a (rows, cols, planes * 16 bytes)
// tensor: dims (elements of 16 bytes, planes, cols, rows), a box one plane
// of box_cols columns of one row.
inline bool rep_plane_map(CUtensorMap* map, bool int8, const void* base, int planes, int cols,
                          int rows, int box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint32_t e = int8 ? 16 : 8;
  const cuuint64_t dims[4] = {e, (cuuint64_t)planes, (cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[3] = {16, (cuuint64_t)planes * 16, (cuuint64_t)cols * planes * 16};
  const cuuint32_t box[4] = {e, 1, (cuuint32_t)box_cols, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One cooperative launch of blocks (all resident: the grid barrier) with
// `bytes` of dynamic shared memory, at least the instantiation's own.
template <bool Q, int MODE, int T, bool TRANS>
cudaError_t launch_rep(const RepParams& p, const CUtensorMap& xmap, const CUtensorMap& wmap,
                       int blocks, int bytes, cudaStream_t s) {
  auto kernel = probe_rep_kernel<Q, MODE, T, TRANS>;
  if (bytes < RepLayout<Q, MODE, T>::BYTES) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(REP_THREADS + 32 * rep_producers(MODE));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p, xmap, wmap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
