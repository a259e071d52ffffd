// conv_matmul: VALID stride-1 conv of one (Hp, Wp, Cin) image by an HWIO
// (kh, kw, Cin, Cout) kernel as kh*kw tap matmuls, f32 accumulation, then an
// f32 epilogue (none, +bias, or the contract-block tail
// relu(relu(acc + bias) * scale + shift)), one rounding to the input's type.
//
// Replaces _kernel of realtime_style_transfer_tpu/ops/pallas/conv_matmul.py
// (:40, pallas_call :122), which the packed path runs at its stride-1 seams:
// the packed stem (5x5, 68 -> 128, contract) and the packed final conv (3x3,
// 256 -> 48 on rst-960, 512 -> 192 on rst-1920).
//
// Bound on the H100: operations.  The rst-960 packed stem is 50 GFLOP on 46
// MB, the rst-1920 final 51 GFLOP on 18 MB, far above the ~295 FLOP/byte at
// which bf16 tensor cores overtake HBM.  The bf16 path (conv_wgmma_kernel)
// keeps both wgmma operands in shared memory, so no warp loads or shuffles
// an MMA operand:
//   block   two consumer warpgroups and two producer warps own an output
//           tile of 8*RW rows x 16 columns: 2*RW m64 tiles of 8 x 8 pixels,
//           RW a warpgroup, each times all BN output columns (BN = Cout up to
//           256: wgmma m64nBNk16), so the tile's input is loaded once.
//   A       the tile's input, (8*RW + kh - 1) x (16 + kw - 1) pixels, lies in
//           shared memory plane-major: plane p holds channels 8p..8p+7 of
//           every pixel, 16 bytes a pixel, so 8 consecutive pixels of a plane
//           are one 128-byte wgmma core matrix.  The A operand of tap (ty,
//           tx) and channels 8p..8p+15 is then a descriptor: start at plane p,
//           pixel ty*tw + tx; the next 8 rows of the m64 tile (the next row of
//           8 pixels) tw * 16 bytes on (SBO); the next 8 channels one plane
//           on (LBO).  A chunk with an odd number of planes (the stem's 68
//           channels, zero-padded to 72 by the wrapper, are 9 planes, loaded
//           as 5 + 4) pairs its last plane across two taps in one k16 step:
//           the second core matrix is the other tap's, LBO its pixel offset,
//           so the stem's K is 1856 for 1700 values, not 2000.  Each k16
//           step's start and LBO come from a step table the wrapper builds
//           (ops/conv_matmul.py tap_plan).  A core matrix with zero weights
//           reads pixels of the same outputs' receptive field, or (a 1x1
//           kernel) the zero pixels kept after the tile in each plane, so no
//           value outside the field reaches a sum (0 x Inf).
//   chunks  Cin, a multiple of 8, comes in chunks of planes through one or
//           two buffers, so the next chunk loads under this one's MMAs: the
//           finals' 256 and 512 channels in chunks of 64, the stem's 72 as 5
//           + 4 planes.  The second producer warp loads them by TMA (a tensor
//           map of the input, one box a plane, zero-filled outside the
//           image), with a full and an empty mbarrier a buffer.
//   B       the weights, packed once by the wrapper in the step table's K
//           order into slices of 128 bytes of K (4 k16 steps) in wgmma's
//           core-matrix order, stream from global memory through a ring of
//           RING slices by TMA bulk copies (the first producer warp), with a
//           full and an empty mbarrier a slot: a slice's 4 x RW wgmmas run per
//           wait, and one slice's group stays in flight while the next is
//           issued.
//   after   the sums go through an f32 tile in shared memory to an epilogue
//           loop (bias, contract; a thread keeps four columns and their rows
//           in registers), coalesced bf16 stores.  No atomics: two calls give
//           the same bits.
// What a block of the finals waits for (PERF.md): weight slices from L2 (a
// 128-pixel block of the rst-1920 final streams all of its 4608 x 192
// weights) and chunks.  Two blocks an SM at BN 128 (RW 1: the stem) overlap
// one block's fill and epilogue with the other's MMAs.
// "// PROFILE LAP i" marks the end of phase i of conv_wgmma_kernel for
// halo_profile.py, which turns each marker into a clock64 counter in a copy
// of this file (written to Params::counters).
//
// f32 input runs an FMA kernel (conv_f32; one thread an output value,
// per-tap partial sums added in tap order, as the plain version adds its
// per-tap matmuls): no TF32 rounding, so it holds JAX's f32 tolerance.
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;           // two consumer warpgroups ...
constexpr int THREADS = CONSUMERS + 64;  // ... and two producer warps: weights, input
constexpr int RING = 4;                  // weight slices in shared memory
constexpr int SLICE_BYTES = 128;         // bytes of K a slice: 4 wgmma k16 steps
constexpr int KSTEPS = SLICE_BYTES / 32;
constexpr int BW = 16;                   // output columns of a block: two 8 x 8 tiles
constexpr int MAX_DYN_BYTES = 226 * 1024;  // a block's dynamic shared memory cap

// A step word: bits 0-13 the A start (bytes / 16) in the chunk buffer for
// output pixel (0, 0), bits 14-27 the LBO (bytes / 16), bit 28 set on the
// first step of a chunk (ops/conv_matmul.py tap_plan).
constexpr uint32_t STEP_FIELD = 0x3FFF;
constexpr int STEP_NEW_CHUNK = 28;

struct Params {
  const __nv_bfloat16* x;   // (hp, wp, cin)
  const unsigned char* slices;  // the weight slices: [column block][nk][BN x SLICE_BYTES]
  const uint32_t* steps;    // nk * KSTEPS step words
  const float* bias;        // (cout,), epi >= 1
  const float* scale;       // (cout,), epi 2
  const float* shift;       // (cout,), epi 2
  __nv_bfloat16* out;       // (h, w, cout)
  long long* counters;      // null; halo_profile.py's clock64 counters
  int hp, wp, cin, kh, kw, cout, h, w, epi;
  int nk;        // weight slices a column block
  int cp;        // planes a chunk
  int nchunks;   // chunks of Cin
  int nbuf;      // chunk buffers: 1 (one chunk) or 2
  int plane_px;  // pixels a plane holds: the tile's, then zeros
  int th, tw;    // input tile rows and columns
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Makes this thread's generic-proxy writes to shared memory (stores) visible to the async proxy, through which wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The two consumer warpgroups only: the producer warps have left.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete.  A wait that never ends (a
// broken pipeline) traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int i = 0; !mbar_try(bar, parity); ++i)
    if (i == (1 << 24)) __trap();
}

// TMA bulk copy of `bytes` contiguous bytes global -> shared, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One plane of an input chunk by TMA: the box (8 channels, tw columns, th
// rows) at (channel 8 * plane, column x, row y) of the input's tensor map,
// zero-filled outside the image, completing on bar.
__device__ __forceinline__ void tma_plane(void* dst, const CUtensorMap* map, int plane, int x,
                                          int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(plane), "r"(x),
        "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// A wgmma shared-memory descriptor without swizzle: start address, LBO (the
// next core matrix along K) and SBO (the next 8 rows), all in 16 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to v across an in-flight wgmma.
template <int N>
__device__ __forceinline__ void fence_operand(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

// One wgmma of the warpgroup, both operands in shared memory: the 64 x 16
// A tile of descriptor a times the 16 x N B tile of descriptor b, added into
// d (the m16n8 accumulator layout of each n8 tile in turn, warp w rows
// 16w..16w+15).
template <int N> struct WgmmaSS;
template <> struct WgmmaSS<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<48> {
  __device__ static __forceinline__ void mma(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct WgmmaSS<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ float epilogue(float v, int n, int epi, const float* bias,
                                          const float* scale, const float* shift) {
  if (epi == 1) return __fadd_rn(v, bias[n]);
  if (epi == 2) {
    v = fmaxf(__fadd_rn(v, bias[n]), 0.f);
    return fmaxf(__fadd_rn(__fmul_rn(v, scale[n]), shift[n]), 0.f);
  }
  return v;
}

// Bytes of the dynamic shared memory of a block: the chunk buffers and the
// weight ring, or the epilogue's f32 tile if that is larger.
__host__ __device__ constexpr int wgmma_bytes(int bn, int rw, int nbuf, int cp, int plane_px) {
  return nbuf * ((cp * plane_px * 16 + 127) / 128 * 128) + RING * bn * SLICE_BYTES >
                 8 * rw * BW * (bn + 4) * 4
             ? nbuf * ((cp * plane_px * 16 + 127) / 128 * 128) + RING * bn * SLICE_BYTES
             : 8 * rw * BW * (bn + 4) * 4;
}

template <int BN, int RW>
__global__ void __launch_bounds__(THREADS, RW * BN <= 128 ? 2 : 1)
    conv_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap map) {
  constexpr int BH = 8 * RW;  // output rows of the block
  constexpr int CWARPS = CONSUMERS / 32;
  __shared__ __align__(8) uint64_t full[RING];   // slice kt has landed in slot kt % RING
  __shared__ __align__(8) uint64_t empty[RING];  // the consumers are done with the slot
  __shared__ __align__(8) uint64_t chunk_full[2];   // chunk c has landed in buffer c % 2
  __shared__ __align__(8) uint64_t chunk_empty[2];  // the consumers are done with it
  extern __shared__ __align__(128) unsigned char dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (p.w + BW - 1) / BW;
  const int by = blockIdx.x / tiles_x;
  const int oy0 = by * BH, ox0 = (blockIdx.x - by * tiles_x) * BW;
  const int chunk_bytes = (p.cp * p.plane_px * 16 + 127) / 128 * 128;
  const int planes = p.cin / 8, npix = p.th * p.tw;
  unsigned char* ring = dyn + p.nbuf * chunk_bytes;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CWARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&chunk_full[i], 1);
      mbar_init(&chunk_empty[i], CWARPS);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == CWARPS) {
    // the weight producer: slice kt into slot kt % RING once the consumers
    // have released the slice RING before it
    if (lane == 0) {
      const unsigned char* w = p.slices + (size_t)blockIdx.y * p.nk * BN * SLICE_BYTES;
      for (int kt = 0; kt < p.nk; ++kt) {
        const int s = kt % RING;
        mbar_wait(&empty[s], ((kt / RING) & 1) ^ 1);
        mbar_expect_tx(&full[s], BN * SLICE_BYTES);
        bulk_copy(ring + s * (BN * SLICE_BYTES), w + (size_t)kt * BN * SLICE_BYTES,
                  BN * SLICE_BYTES, &full[s]);
      }
    }
    return;
  }
  if (warp == CWARPS + 1) {
    // the input producer: chunk c into buffer c % nbuf once the consumers
    // have released chunk c - nbuf, one box a plane
    if (lane == 0)
      for (int c = 0; c < p.nchunks; ++c) {
        const int b = c % p.nbuf, p0 = c * p.cp, pc = min(p.cp, planes - p0);
        mbar_wait(&chunk_empty[b], ((c / p.nbuf) & 1) ^ 1);
        mbar_expect_tx(&chunk_full[b], pc * npix * 16);
        for (int u = 0; u < pc; ++u)
          tma_plane(dyn + b * chunk_bytes + u * p.plane_px * 16, &map, p0 + u, ox0, oy0,
                    &chunk_full[b]);
      }
    return;
  }

  // The consumers.  The zero pixels after the tile in every plane.
  const int pad = p.plane_px - npix;
  for (int i = tid; i < p.nbuf * p.cp * pad; i += CONSUMERS)
    *reinterpret_cast<uint4*>(dyn + ((i / pad) * p.plane_px + npix + i % pad) * 16) =
        make_uint4(0, 0, 0, 0);
  // PROFILE LAP 0
  fence_proxy_async();  // the zero pixels to the async proxy
  consumer_sync();
  mbar_wait(&chunk_full[0], 0);
  // PROFILE LAP 1

  // Warpgroup v holds m64 tiles v*RW .. v*RW + RW - 1 of the block; tile i
  // is the 8 x 8 pixels at rows 8*(i/2), columns 8*(i%2) of the output tile.
  const int v = warp >> 2;
  const uint32_t sbo = p.tw * 16;
  uint32_t toff[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = v * RW + r;
    toff[r] = (8 * (i >> 1) * p.tw + 8 * (i & 1)) * 16;
  }
  const uint32_t dyn_base = smem_addr(dyn), ring_base = smem_addr(ring);
  float acc[RW][BN / 2];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  uint32_t word[KSTEPS];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) word[ks] = __ldg(p.steps + ks);
  int chunk = 0;
  for (int kt = 0; kt < p.nk; ++kt) {
    // the first slice of a chunk: its boxes, loaded under the chunk before,
    // have landed
    const bool first = kt == 0 || ((word[0] >> STEP_NEW_CHUNK) & 1);
    if (kt > 0 && first) {
      ++chunk;
      mbar_wait(&chunk_full[chunk % p.nbuf], (chunk / p.nbuf) & 1);
    }
    const uint32_t a_base = dyn_base + (chunk % p.nbuf) * chunk_bytes;
    mbar_wait(&full[kt % RING], (kt / RING) & 1);
    const uint32_t b_base = ring_base + (kt % RING) * (BN * SLICE_BYTES);
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_operand(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint64_t b = desc(b_base + ks * 256, 128, SLICE_BYTES * 8);
      const uint32_t a = a_base + (word[ks] & STEP_FIELD) * 16;
      const uint32_t lbo = ((word[ks] >> 14) & STEP_FIELD) * 16;
#pragma unroll
      for (int r = 0; r < RW; ++r) WgmmaSS<BN>::mma(acc[r], desc(a + toff[r], lbo, sbo), b);
    }
    wgmma_commit();
    if (kt + 1 < p.nk)
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) word[ks] = __ldg(p.steps + (kt + 1) * KSTEPS + ks);
    wgmma_wait<1>();  // slice kt - 1's group is done: release its slot
    if (kt > 0 && lane == 0) {
      mbar_arrive(&empty[(kt - 1) % RING]);
      // and, if it was the last of a chunk, that chunk's buffer
      if (first) mbar_arrive(&chunk_empty[(chunk - 1) % p.nbuf]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < RW; ++r) fence_operand(acc[r]);
  // PROFILE LAP 2
  consumer_sync();  // every warp is done with the chunks and the ring

  // The sums to an f32 tile in shared memory, pixel (row * BW + column) of
  // the output tile: warp w of a warpgroup holds rows 16w + g and 16w + g + 8
  // of each m64 tile, row j being pixel (j / 8, j % 8) of its 8 x 8 block.
  constexpr int EP = BN + 4;  // f32 pitch of a tile pixel
  float* tv = reinterpret_cast<float*>(dyn);
  {
    const int w4 = warp & 3, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = v * RW + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * w4 + g + 8 * h;
        const int px = (8 * (i >> 1) + (row >> 3)) * BW + 8 * (i & 1) + (row & 7);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(tv + px * EP + j * 8 + 2 * t4) =
              make_float2(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
      }
    }
  }
  consumer_sync();
  // PROFILE LAP 3

  // The epilogue: a thread keeps four columns, their rows in registers, and
  // walks every `stride`-th pixel; consecutive threads take consecutive
  // columns, then pixels, so a warp stores contiguous bytes.
  const int n0 = blockIdx.y * BN, quads = (min(BN, p.cout - n0) + 3) / 4;
  const int stride = CONSUMERS / quads, q = tid % quads, n = n0 + 4 * q;
  if (tid < stride * quads) {
    float b[4], sc[4], sh[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int nk = min(n + k, p.cout - 1);
      b[k] = p.epi >= 1 ? p.bias[nk] : 0.f;
      sc[k] = p.epi == 2 ? p.scale[nk] : 0.f;
      sh[k] = p.epi == 2 ? p.shift[nk] : 0.f;
    }
    const bool vec = (p.cout & 3) == 0;
#pragma unroll 4
    for (int px = tid / quads; px < BH * BW; px += stride) {
      const int oy = oy0 + px / BW, ox = ox0 + px % BW;
      if (oy >= p.h || ox >= p.w) continue;
      const float4 s = *reinterpret_cast<const float4*>(tv + px * EP + 4 * q);
      float y[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (p.epi >= 1) y[k] = __fadd_rn(y[k], b[k]);
        if (p.epi == 2) y[k] = fmaxf(__fadd_rn(__fmul_rn(fmaxf(y[k], 0.f), sc[k]), sh[k]), 0.f);
      }
      __nv_bfloat16* o = p.out + ((size_t)oy * p.w + ox) * p.cout + n;
      if (vec) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
        uint2 w2;
        w2.x = *reinterpret_cast<uint32_t*>(&lo);
        w2.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(o) = w2;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n + k < p.cout) o[k] = __float2bfloat16(y[k]);
      }
    }
  }
  // PROFILE LAP 4
}

// f32: one thread an output value; threadIdx.x walks 32 output channels (the
// kernel's rows are contiguous in Cout), threadIdx.y 8 output pixels.
__global__ void __launch_bounds__(256)
    conv_f32(const float* __restrict__ x, const float* __restrict__ k,
             const float* __restrict__ bias, const float* __restrict__ scale,
             const float* __restrict__ shift, float* __restrict__ out, int hp, int wp, int cin,
             int kh, int kw, int cout, int epi) {
  const int h = hp - kh + 1, w = wp - kw + 1;
  const int n = blockIdx.y * 32 + threadIdx.x;
  const int p = blockIdx.x * 8 + threadIdx.y;
  if (n >= cout || p >= h * w) return;
  const int oy = p / w, ox = p - oy * w;
  float acc = 0.f;
  for (int ty = 0; ty < kh; ++ty)
    for (int tx = 0; tx < kw; ++tx) {
      const float* xp = x + ((size_t)(oy + ty) * wp + ox + tx) * cin;
      const float* kp = k + (size_t)(ty * kw + tx) * cin * cout + n;
      float part = 0.f;
      for (int c = 0; c < cin; ++c) part = fmaf(xp[c], kp[(size_t)c * cout], part);
      acc = __fadd_rn(acc, part);
    }
  out[(size_t)p * cout + n] = epilogue(acc, n, epi, bias, scale, shift);
}

template <int BN, int RW>
cudaError_t launch_wgmma(const Params& p, const CUtensorMap& map, cudaStream_t s) {
  const int bytes = wgmma_bytes(BN, RW, p.nbuf, p.cp, p.plane_px);
  if (bytes > MAX_DYN_BYTES) return cudaErrorInvalidValue;
  static bool configured = false;  // the attribute once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_wgmma_kernel<BN, RW>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(((p.h + 8 * RW - 1) / (8 * RW)) * ((p.w + BW - 1) / BW),
                  (p.cout + BN - 1) / BN);
  conv_wgmma_kernel<BN, RW><<<grid, THREADS, bytes, s>>>(p, map);
  return cudaGetLastError();
}

}  // namespace

// The bf16 path.  x: (hp, wp, cin), cin a multiple of 8 and x 16-byte
// aligned (the TMA boxes), out: (hp-kh+1, wp-kw+1, cout), bf16;
// slices and steps: the packed weights and step table of
// ops/conv_matmul.py tap_plan for (kh, kw, cin, cout) at (bn, rw); bias,
// scale, shift: (cout,) f32, read by epi 1 (bias) and 2 (contract), may be
// null where not read; counters: null (halo_profile.py's clock64 counters).
extern "C" int rst_conv_matmul(const void* x, const void* slices, const void* steps,
                               const void* bias, const void* scale, const void* shift,
                               void* out, void* counters, int hp, int wp, int cin, int kh,
                               int kw, int cout, int epi, int bn, int rw, int nk, int cp,
                               int nchunks, int plane_px, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.slices = static_cast<const unsigned char*>(slices);
  p.steps = static_cast<const uint32_t*>(steps);
  p.bias = static_cast<const float*>(bias);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.counters = static_cast<long long*>(counters);
  p.hp = hp, p.wp = wp, p.cin = cin, p.kh = kh, p.kw = kw, p.cout = cout, p.epi = epi;
  p.h = hp - kh + 1, p.w = wp - kw + 1;
  p.nk = nk, p.cp = cp, p.nchunks = nchunks, p.nbuf = nchunks > 1 ? 2 : 1;
  p.plane_px = plane_px;
  p.th = 8 * rw + kh - 1, p.tw = BW + kw - 1;
  if (p.h < 1 || p.w < 1 || cin < 8 || cin % 8 || cout < 1 || epi < 0 || epi > 2 ||
      (epi > 0 && !bias) || (epi == 2 && (!scale || !shift)) || nk < 1 || cp < 1 ||
      nchunks < 1 || (nchunks - 1) * cp >= cin / 8 || nchunks * cp < cin / 8 ||
      plane_px < p.th * p.tw || plane_px % 8 || p.tw * 16 > 16 * STEP_FIELD ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // the input's tensor map: a box (8 channels, tw, th) a plane, its planes
  // 128-byte aligned in shared memory (plane_px a multiple of 8)
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorNotSupported);
  }
  CUtensorMap map = {};
  const cuuint64_t dims[4] = {8, (cuuint64_t)(cin / 8), (cuuint64_t)wp, (cuuint64_t)hp};
  const cuuint64_t strides[3] = {16, (cuuint64_t)cin * 2, (cuuint64_t)wp * cin * 2};
  const cuuint32_t box[4] = {8, 1, (cuuint32_t)p.tw, (cuuint32_t)p.th};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // the (bn, rw) instantiations ops/conv_matmul.py's ROWS picks from
  if (rw == 2) {
    switch (bn) {
      case 8: err = launch_wgmma<8, 2>(p, map, s); break;
      case 16: err = launch_wgmma<16, 2>(p, map, s); break;
      case 32: err = launch_wgmma<32, 2>(p, map, s); break;
      case 48: err = launch_wgmma<48, 2>(p, map, s); break;
      case 64: err = launch_wgmma<64, 2>(p, map, s); break;
      case 96: err = launch_wgmma<96, 2>(p, map, s); break;
    }
  } else if (rw == 1) {
    switch (bn) {
      case 128: err = launch_wgmma<128, 1>(p, map, s); break;
      case 192: err = launch_wgmma<192, 1>(p, map, s); break;
      case 256: err = launch_wgmma<256, 1>(p, map, s); break;
    }
  }
  return static_cast<int>(err);
}

// The f32 path: x (hp, wp, cin), kernel (kh, kw, cin, cout) HWIO, out f32.
extern "C" int rst_conv_matmul_f32(const void* x, const void* kernel, const void* bias,
                                   const void* scale, const void* shift, void* out, int hp,
                                   int wp, int cin, int kh, int kw, int cout, int epi,
                                   void* stream) {
  if (hp - kh + 1 < 1 || wp - kw + 1 < 1 || cin < 1 || cout < 1 || epi < 0 || epi > 2 ||
      (epi > 0 && !bias) || (epi == 2 && (!scale || !shift)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int h = hp - kh + 1, w = wp - kw + 1;
  const dim3 grid((h * w + 7) / 8, (cout + 31) / 32);
  conv_f32<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(kernel),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(out), hp, wp, cin, kh, kw, cout,
      epi);
  return static_cast<int>(cudaGetLastError());
}
