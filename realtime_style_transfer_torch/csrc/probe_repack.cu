// probe_repack: what a row/column repack of a bf16 activation costs on Hopper
// as a memory pass of its own.
//
// Replaces the pallas_calls of tools/probe_repack_ops.py (run_case, :78),
// which asked which formulations of the grid-transition repacks of the TPU's
// divider-1 fused kernel (fold2 after c2, unfold2 after e1) Mosaic could
// lower.  The port runs every stage at true resolution, so its stage loop
// needs no repack; a later one-launch kernel that keeps activations on chip
// would, and this probe says what one pass costs.  Four functions, each on a
// batch of n independent inputs (the batch makes the timed window long and
// larger than L2):
//
//   deinterleave  (n, H, W, C)  -> (n, H/2, W, 2C): even rows, then odd rows,
//                 stacked on channels (deint_* of the probe, :33-53);
//   interleave    two (n, H, W, C) -> (n, 2H, W, C): rows of a, b in turn
//                 (int_*, :56-70);
//   fold2         (n, H, W, C)  -> (n, H/2, W/2, 4C): channel block 2p + q
//                 holds input pixel (2i + p, 2j + q) (:124-134);
//   unfold2       (n, H, W, 4Q) -> (n, 2H, 2W, OC): output pixel (2i + p,
//                 2j + q) takes channels [2pQ + qQ, 2pQ + qQ + Q) of input
//                 pixel (i, j); channels Q..OC-1 are zero (:136-161; with
//                 OC = Q it is the inverse of fold2).
//
// Every mapping keeps runs of at least 8 channels together, so a thread moves
// one 16-byte vector: it computes the source of its output vector and copies
// it, or writes zeros.  Bound: bytes (each input read once, each output
// written once); the index arithmetic is 32-bit within one batch item, which
// is blockIdx.y.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DEINTERLEAVE = 0, INTERLEAVE = 1, FOLD2 = 2, UNFOLD2 = 3 };
constexpr int NTHREADS = 256;
constexpr int VEC = 8;  // bf16 values a thread moves

struct Geo {
  int ih, iw, ic;  // input item (H, W, C)
  int oh, ow, oc;  // output item
};

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
    repack_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                  __nv_bfloat16* __restrict__ out, const Geo g) {
  const int item_vecs = g.oh * g.ow * (g.oc / VEC);
  const int v = blockIdx.x * NTHREADS + threadIdx.x;
  if (v >= item_vecs) return;
  const int c = (v % (g.oc / VEC)) * VEC, pix = v / (g.oc / VEC);
  const int x = pix % g.ow, y = pix / g.ow;
  const size_t in_item = (size_t)g.ih * g.iw * g.ic;
  const __nv_bfloat16* src = a;
  int iy, ix, ic;
  if (MODE == DEINTERLEAVE) {
    iy = 2 * y + c / g.ic;
    ix = x;
    ic = c % g.ic;
  } else if (MODE == INTERLEAVE) {
    src = (y & 1) ? b : a;
    iy = y >> 1;
    ix = x;
    ic = c;
  } else if (MODE == FOLD2) {
    const int blk = c / g.ic;
    iy = 2 * y + (blk >> 1);
    ix = 2 * x + (blk & 1);
    ic = c % g.ic;
  } else {
    const int q = g.ic / 4;
    if (c >= q) src = nullptr;
    iy = y >> 1;
    ix = x >> 1;
    ic = (y & 1) * 2 * q + (x & 1) * q + c;
  }
  uint4 val = make_uint4(0, 0, 0, 0);
  if (src)
    val = *reinterpret_cast<const uint4*>(src + blockIdx.y * in_item +
                                          ((size_t)iy * g.iw + ix) * g.ic + ic);
  const size_t out_item = (size_t)g.oh * g.ow * g.oc;
  *reinterpret_cast<uint4*>(out + blockIdx.y * out_item + (size_t)v * VEC) = val;
}

}  // namespace

// a, b: (n, ih, iw, ic) bf16 (b for interleave only); out: (n, oh, ow, oc)
// bf16.  The wrapper in ops/probe_repack.py checks the shapes; this checks
// what the kernel relies on: 8-channel runs and a grid the card takes.
extern "C" int rst_repack(const void* a, const void* b, void* out, int mode, int n, int ih,
                          int iw, int ic, int oh, int ow, int oc, void* stream) {
  const Geo g{ih, iw, ic, oh, ow, oc};
  const int run = mode == UNFOLD2 ? ic / 4 : ic;
  if (n < 1 || n > 65535 || ic % VEC || oc % VEC || run % VEC ||
      (mode == INTERLEAVE) != (b != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((oh * ow * (oc / VEC) + NTHREADS - 1) / NTHREADS, n);
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  auto* po = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, Geo);
  switch (mode) {
    case DEINTERLEAVE: kernel = repack_kernel<DEINTERLEAVE>; break;
    case INTERLEAVE: kernel = repack_kernel<INTERLEAVE>; break;
    case FOLD2: kernel = repack_kernel<FOLD2>; break;
    case UNFOLD2: kernel = repack_kernel<UNFOLD2>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, NTHREADS, 0, s>>>(pa, pb, po, g);
  return static_cast<int>(cudaGetLastError());
}
