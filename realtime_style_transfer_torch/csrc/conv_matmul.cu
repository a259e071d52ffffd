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
// f32 input runs conv_fma_kernel, an implicit GEMM on the CUDA cores (M the
// output pixels, N Cout, K taps x Cin), f32 FMAs in a fixed order: no TF32
// rounding, so it holds JAX's f32 tolerance, and no atomics.  Bound on the
// H100: the f32 FMA rate (67 TFLOP/s; the rst-960 final is 6.4 GFLOP on 36
// MB).  The block, eight consumer warps and a producer warp, owns
// 16 output columns x TM / 2 rows x BN of Cout:
//   warps   warp w owns TM consecutive pixels of one output row; its lane
//           (g, ng) = (lane / NG, lane % NG) holds those TM pixels x the
//           4 * TQ columns 4 * (ng + NG * q) + 0..3 in registers (TM x 4 TQ
//           sums: 64 at the stem, 48 and 96 at the finals), and multiplies
//           channel quads g, g + 32 / NG, ... of each chunk: the warp's
//           32 / NG K-groups, summed by shuffles (a butterfly, the same bits
//           in every lane) at the end.  The K-groups keep a lane's tile
//           whole where Cout is narrow (the rst-960 final's 48) without
//           starving the card of warps.
//   A       a stage is one chunk of CC channels and one tap row ty: the
//           input box (CC channels, 16 + kw - 1 columns, TM / 2 rows) by
//           TMA (zero-filled outside the image), pixel-major in shared
//           memory (the wrapper pads Cin to a multiple of CC); a lane reads
//           its pixels' channel quad as float4, and the lanes of a warp
//           read consecutive quads of one pixel at a time, so no bank
//           conflicts.
//   B       the weights, packed once (ops/conv_matmul.py pack_fma) in the
//           stage order and, inside a stage, (tap, quad, channel, q, lane)
//           order, so a warp's 32 float4 loads of B are 512 contiguous
//           bytes; one TMA bulk copy a stage.
//   loop    a lane reads its TM pixels' quad afresh for each tap, or, at
//           the tiles and kw of ops/conv_matmul.py FMA_WINDOWS (the stem's
//           5x5, the rst-960 final's 3x3), once a quad into a window of TM +
//           kw - 1 pixels that the kw taps slide over.
//   ring    up to FMA_MAX_BUF stages in shared memory, a full and an empty
//           mbarrier each; the producer warp's lane 0 refills a stage once
//           the eight consumer warps have released it.  Wide chunks (fewer
//           stages) before more buffers: a stage costs a wait and a refill
//           of the loop (measured: PERF.md).
//   after   the sums of the K-groups, the epilogue, float4 stores.
// "// PROFILE LAP i" marks the phases of conv_fma_kernel as well.
#include <cuda_bf16.h>

#include "hopper.cuh"

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

// The two consumer warpgroups only: the producer warps have left.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// hopper.cuh's mbar_init without its fence: the kernels fence once after
// all their barriers.
__device__ __forceinline__ void mbar_init_unfenced(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
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
      mbar_init_unfenced(&full[i], 1);
      mbar_init_unfenced(&empty[i], CWARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init_unfenced(&chunk_full[i], 1);
      mbar_init_unfenced(&chunk_empty[i], CWARPS);
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
        mbar_wait_or_trap(&empty[s], ((kt / RING) & 1) ^ 1);
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
        mbar_wait_or_trap(&chunk_empty[b], ((c / p.nbuf) & 1) ^ 1);
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
  mbar_wait_or_trap(&chunk_full[0], 0);
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
      mbar_wait_or_trap(&chunk_full[chunk % p.nbuf], (chunk / p.nbuf) & 1);
    }
    const uint32_t a_base = dyn_base + (chunk % p.nbuf) * chunk_bytes;
    mbar_wait_or_trap(&full[kt % RING], (kt / RING) & 1);
    const uint32_t b_base = ring_base + (kt % RING) * (BN * SLICE_BYTES);
#pragma unroll
    for (int r = 0; r < RW; ++r) wgmma_fence_operand(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint64_t b = wgmma_desc(b_base + ks * 256, 128, SLICE_BYTES * 8);
      const uint32_t a = a_base + (word[ks] & STEP_FIELD) * 16;
      const uint32_t lbo = ((word[ks] >> 14) & STEP_FIELD) * 16;
#pragma unroll
      for (int r = 0; r < RW; ++r) WgmmaSS<BN>::mma(acc[r], wgmma_desc(a + toff[r], lbo, sbo), b);
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
  for (int r = 0; r < RW; ++r) wgmma_fence_operand(acc[r]);
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

// ---- the f32 path: conv_fma_kernel ----
constexpr int FMA_WARPS = 8;                       // consumer warps: TM pixels of a row each
constexpr int FMA_THREADS = 32 * (FMA_WARPS + 1);  // ... and the producer warp
constexpr int FMA_COLS = 16;                       // output columns of a block
constexpr int FMA_MAX_BUF = 4;                     // stage buffers at most

struct FmaParams {
  const float* slices;  // the packed weights: [column block][nchunks * kh stages][kw * cc * BN]
  const float* bias;    // (cout,), epi >= 1
  const float* scale;   // (cout,), epi 2
  const float* shift;   // (cout,), epi 2
  float* out;           // (h, w, cout)
  long long* counters;  // null; halo_profile.py's clock64 counters
  int kh, kw, cout, h, w, epi;
  int cc;       // channels a chunk; a stage is one chunk and one tap row
  int nchunks;  // chunks of Cin
  int nbuf;     // stage buffers, 2 .. FMA_MAX_BUF
};

// Bytes of a stage's input box (rows x (16 + kw - 1) pixels x cc channels)
// and of its weight slice (kw taps x cc channels x bn columns), each padded
// to 128 (the TMA boxes land 128-byte aligned).
__host__ __device__ constexpr int fma_in_bytes(int rows, int kw, int cc) {
  return (rows * (FMA_COLS + kw - 1) * cc * 4 + 127) / 128 * 128;
}
__host__ __device__ constexpr int fma_w_bytes(int bn, int kw, int cc) {
  return (kw * cc * bn * 4 + 127) / 128 * 128;
}

// acc[j][q] += the channel quad a[j] of pixel j x the 4 x 4 TQ weights of
// a lane at bp (channel kk, column quad q at (kk * TQ + q) * 128 floats):
// one FMA a product, channels in order.
template <int TM, int TQ>
__device__ __forceinline__ void fma_quad(float4 (&acc)[TM][TQ], const float4* a, const float* bp) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(bp + (kk * TQ + q) * 128);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float av = kk == 0 ? a[j].x : kk == 1 ? a[j].y : kk == 2 ? a[j].z : a[j].w;
        acc[j][q].x = fmaf(av, bv.x, acc[j][q].x);
        acc[j][q].y = fmaf(av, bv.y, acc[j][q].y);
        acc[j][q].z = fmaf(av, bv.z, acc[j][q].z);
        acc[j][q].w = fmaf(av, bv.w, acc[j][q].w);
      }
    }
}

// KW 0: any kw, each tap's TM pixels read anew; KW > 0: kw == KW, a
// sliding window of TM + KW - 1 pixels read once for the KW taps.
template <int TM, int TQ, int NG, int KW>
__global__ void __launch_bounds__(FMA_THREADS, 1)
    conv_fma_kernel(const FmaParams p, const __grid_constant__ CUtensorMap map) {
  constexpr int KGW = 32 / NG;        // K-groups a warp
  constexpr int BN = 4 * TQ * NG;     // output columns of a block
  constexpr int R = TM / 2;           // output rows of a block
  constexpr int WPR = FMA_COLS / TM;  // warps a row
  static_assert(R * WPR == FMA_WARPS && (TM % KGW == 0 || KGW % TM == 0),
                "eight warps of TM pixels; K-group g stores the pixels j with j % KGW == g");
  __shared__ __align__(8) uint64_t full[FMA_MAX_BUF];   // stage s has landed in buffer s % nbuf
  __shared__ __align__(8) uint64_t empty[FMA_MAX_BUF];  // the consumer warps are done with it
  extern __shared__ __align__(128) unsigned char dyn[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (p.w + FMA_COLS - 1) / FMA_COLS;
  const int by = blockIdx.x / tiles_x;
  const int oy0 = by * R, ox0 = (blockIdx.x - by * tiles_x) * FMA_COLS;
  const int twc = FMA_COLS + p.kw - 1;
  const int in_bytes = fma_in_bytes(R, p.kw, p.cc);
  const int w_floats = p.kw * p.cc * BN;
  const int stage_bytes = in_bytes + fma_w_bytes(BN, p.kw, p.cc);
  const int nst = p.nchunks * p.kh;

  if (tid == 0) {
    for (int i = 0; i < FMA_MAX_BUF; ++i) {
      mbar_init_unfenced(&full[i], 1);
      mbar_init_unfenced(&empty[i], FMA_WARPS);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == FMA_WARPS) {
    // the producer: stage s (chunk s / kh, tap row s % kh) into buffer
    // s % nbuf once the consumers have released stage s - nbuf
    if (lane == 0) {
      const float* wsl = p.slices + (size_t)blockIdx.y * nst * w_floats;
      for (int s = 0; s < nst; ++s) {
        const int b = s % p.nbuf, c = s / p.kh;
        unsigned char* st = dyn + b * stage_bytes;
        mbar_wait_or_trap(&empty[b], ((s / p.nbuf) & 1) ^ 1);
        mbar_expect_tx(&full[b], R * twc * p.cc * 4 + w_floats * 4);
        tma_plane(st, &map, c, ox0, oy0 + s - c * p.kh, &full[b]);
        bulk_copy(st + in_bytes, wsl + (size_t)s * w_floats, w_floats * 4, &full[b]);
      }
    }
    return;
  }

  // The consumers.  Warp w: row w / WPR of the block, columns c0 .. c0 + TM
  // - 1; lane (g, ng): channel quads g + KGW * i of each chunk, output
  // columns 4 * (ng + NG * q) + 0..3.
  const int g = lane / NG, ng = lane - g * NG;
  const int r = warp / WPR, c0 = (warp - r * WPR) * TM;
  const int ni = p.cc / (4 * KGW);  // channel quads a K-group reads a tap
  float4 acc[TM][TQ];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int q = 0; q < TQ; ++q) acc[j][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  mbar_wait_or_trap(&full[0], 0);
  // PROFILE LAP 0

  for (int s = 0; s < nst; ++s) {
    const int b = s % p.nbuf;
    mbar_wait_or_trap(&full[b], (s / p.nbuf) & 1);
    const float* in =
        reinterpret_cast<const float*>(dyn + b * stage_bytes) + (r * twc + c0) * p.cc + 4 * g;
    const float* wt = reinterpret_cast<const float*>(dyn + b * stage_bytes + in_bytes) + 4 * lane;
    // B of tap tx, quad i at (tx * ni + i) * 4 * TQ * 128 floats
    if (KW == 0) {
      // K order: tap, channel quad, channel
      for (int tx = 0; tx < p.kw; ++tx)
        for (int i = 0; i < ni; ++i) {
          const float* ap = in + tx * p.cc + 4 * KGW * i;
          float4 a[TM];
#pragma unroll
          for (int j = 0; j < TM; ++j) a[j] = *reinterpret_cast<const float4*>(ap + j * p.cc);
          fma_quad<TM, TQ>(acc, a, wt + (tx * ni + i) * (4 * TQ * 128));
        }
    } else {
      // K order: channel quad, tap, channel
      constexpr int WIN = TM + (KW > 0 ? KW : 1) - 1;
      for (int i = 0; i < ni; ++i) {
        const float* ap = in + 4 * KGW * i;
        float4 a[WIN];
#pragma unroll
        for (int j = 0; j < WIN; ++j) a[j] = *reinterpret_cast<const float4*>(ap + j * p.cc);
#pragma unroll
        for (int tx = 0; tx < KW; ++tx)
          fma_quad<TM, TQ>(acc, a + tx, wt + (tx * ni + i) * (4 * TQ * 128));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[b]);  // every lane's reads of the stage are done
  }
  // PROFILE LAP 1

  // The K-groups' sums: a butterfly over the lane bits of g in a fixed
  // order; fl(a + b) == fl(b + a), so every lane of a pixel group ends with
  // the same bits.
#pragma unroll
  for (int m = NG; m < 32; m <<= 1)
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        acc[j][q].x = __fadd_rn(acc[j][q].x, __shfl_xor_sync(0xffffffffu, acc[j][q].x, m));
        acc[j][q].y = __fadd_rn(acc[j][q].y, __shfl_xor_sync(0xffffffffu, acc[j][q].y, m));
        acc[j][q].z = __fadd_rn(acc[j][q].z, __shfl_xor_sync(0xffffffffu, acc[j][q].z, m));
        acc[j][q].w = __fadd_rn(acc[j][q].w, __shfl_xor_sync(0xffffffffu, acc[j][q].w, m));
      }
  // PROFILE LAP 2

  // The epilogue: K-group g stores pixels j = g, g + KGW, ...
  const int oy = oy0 + r;
  if (oy < p.h) {
    const bool vec = (p.cout & 3) == 0;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int ox = ox0 + c0 + j;
      if (j % KGW != g || ox >= p.w) continue;
      float* o = p.out + ((size_t)oy * p.w + ox) * p.cout;
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const int n = blockIdx.y * BN + 4 * (ng + NG * q);
        if (n >= p.cout) continue;
        float y[4] = {acc[j][q].x, acc[j][q].y, acc[j][q].z, acc[j][q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = epilogue(y[e], min(n + e, p.cout - 1), p.epi, p.bias, p.scale, p.shift);
        if (vec) {
          *reinterpret_cast<float4*>(o + n) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < p.cout) o[n + e] = y[e];
        }
      }
    }
  }
  // PROFILE LAP 3
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

// The f32 path's launch: the (bn, tm) instantiations ops/conv_matmul.py's
// FMA_TILES picks from, with the windows of FMA_WINDOWS.
template <int TM, int TQ, int NG, int KW>
cudaError_t launch_fma(const FmaParams& p, const CUtensorMap& map, cudaStream_t s) {
  constexpr int BN = 4 * TQ * NG, R = TM / 2;
  const int bytes = p.nbuf * (fma_in_bytes(R, p.kw, p.cc) + fma_w_bytes(BN, p.kw, p.cc));
  if (bytes > MAX_DYN_BYTES || p.cc % (128 / NG) || (KW > 0 && p.kw != KW))
    return cudaErrorInvalidValue;
  static bool configured = false;  // the attribute once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_fma_kernel<TM, TQ, NG, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_DYN_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(((p.h + R - 1) / R) * ((p.w + FMA_COLS - 1) / FMA_COLS), (p.cout + BN - 1) / BN);
  conv_fma_kernel<TM, TQ, NG, KW><<<grid, FMA_THREADS, bytes, s>>>(p, map);
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
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
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

// The f32 path.  x: (hp, wp, cin) f32, cin a multiple of cc (a multiple
// of 4) and x 16-byte aligned (the TMA boxes); slices: the weights of
// ops/conv_matmul.py pack_fma for (kh, kw, cin, cout) at (bn, tm, cc),
// 16-byte aligned; out: (hp-kh+1, wp-kw+1, cout) f32; bias, scale, shift as
// the bf16 path's; nbuf stage buffers; counters: null (halo_profile.py's
// clock64 counters).
extern "C" int rst_conv_matmul_f32(const void* x, const void* slices, const void* bias,
                                   const void* scale, const void* shift, void* out,
                                   void* counters, int hp, int wp, int cin, int kh, int kw,
                                   int cout, int epi, int bn, int tm, int cc, int nbuf,
                                   void* stream) {
  FmaParams p;
  p.slices = static_cast<const float*>(slices);
  p.bias = static_cast<const float*>(bias);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<float*>(out);
  p.counters = static_cast<long long*>(counters);
  p.kh = kh, p.kw = kw, p.cout = cout, p.epi = epi;
  p.h = hp - kh + 1, p.w = wp - kw + 1;
  p.cc = cc, p.nchunks = cc > 0 ? cin / cc : 0, p.nbuf = nbuf;
  if (p.h < 1 || p.w < 1 || kh < 1 || kw < 1 || cout < 1 || epi < 0 || epi > 2 ||
      (epi > 0 && !bias) || (epi == 2 && (!scale || !shift)) || cc < 4 || cc % 4 || cc > 256 ||
      cin < cc || cin % cc || nbuf < 2 || nbuf > FMA_MAX_BUF || FMA_COLS + kw - 1 > 256 ||
      tm < 4 || tm > 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(slices) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // the input's tensor map: (cc channels, cin / cc chunks, wp, hp), a box
  // (cc channels, one chunk, 16 + kw - 1 columns, tm / 2 rows) a stage,
  // pixel-major in shared memory
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map = {};
  const cuuint64_t dims[4] = {(cuuint64_t)cc, (cuuint64_t)(cin / cc), (cuuint64_t)wp,
                              (cuuint64_t)hp};
  const cuuint64_t strides[3] = {(cuuint64_t)cc * 4, (cuuint64_t)cin * 4,
                                 (cuuint64_t)wp * cin * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cc, 1, (cuuint32_t)(FMA_COLS + kw - 1),
                             (cuuint32_t)(tm / 2)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // the (bn, tm) instantiations of ops/conv_matmul.py's FMA_TILES, a
  // sliding window where FMA_WINDOWS names the tile's kw
  if (bn == 48 && tm == 4) err = kw == 3 ? launch_fma<4, 3, 4, 3>(p, map, s)
                                               : launch_fma<4, 3, 4, 0>(p, map, s);
  else if (bn == 96 && tm == 8) err = launch_fma<8, 3, 8, 0>(p, map, s);
  else if (bn == 128 && tm == 16) err = kw == 5 ? launch_fma<16, 1, 32, 5>(p, map, s)
                                                 : launch_fma<16, 1, 32, 0>(p, map, s);
  return static_cast<int>(err);
}
