// probe_int8: does int8 -> s32 run at about twice the bf16 -> f32 rate on
// Hopper's tensor cores at the residual conv's shapes, and does the band's
// per-repetition quantizing fill eat the gain?
//
// Replaces the two pallas_calls of tools/probe_int8_mxu.py: the plain
// (2400, 128) x (128, 128) product (:48-62) and the band pattern of the
// residual conv (:100-145: a bf16 band quantized in the kernel, then 9 tap
// products at th = 10, wp = 240, cin = cout = 128).  Each arm repeats its
// whole product nrep times in the launch and adds the repetitions, so the
// result is nrep times the product; a repetition of the band refills (and
// for int8 quantizes) its window, as the TPU band probe does.
//
// Bound on the H100: operations.  A repetition is 78.6 MFLOP (mm) or 707.8
// MFLOP (band) on 0.07-0.3 MB of operands that the launch reads once: 0.0795
// / 0.7157 us of bf16 tensor-core time, half that for int8.  A repetition's
// product is only 2400 x 128 outputs, 19 tiles of 128 pixels, so the design
// spreads the repetitions, not only the tiles, over the card, and judges
// each arm by its time a repetition (the slope between two repetition
// counts), which takes the launch, the fill of the first tile and the
// reduction out, as the TPU probes judge themselves.
//
// The kernel (probe_rep.cuh), one cooperative launch of one block an SM:
//   units     a (group, repetition) pair; a group is a tile of 128 pixels
//             (mm: 19 over the 2400 rows) or, for the band, a (tap row dy,
//             output row, tile) triple: the blocks are cut into three parts,
//             part dy holding taps 3 dy .. 3 dy + 2.  A part's units are
//             dealt to its blocks in contiguous runs (ops/probe_int8.py
//             rep_plan), so a block takes one or two groups, each for a run
//             of repetitions.
//   A         the weights: wgmma's A operand from registers, M = the 128
//             output columns (a warpgroup's m64 half), every tap and K step
//             (96 registers for the band's 3 bf16 taps), loaded once by TMA
//             and ldmatrix.  No weight byte moves after the first microseconds.
//   B         the activations, K-major in 16-byte planes in shared memory, by
//             descriptor: mm a 128-pixel tile of x by TMA (both of a block's
//             tiles at once, into the weights' staging once the weights are
//             in registers); the band's input row (130 pixels, zero columns
//             outside the width, by TMA) stays resident, and each repetition
//             copies it, or quantizes it (clamp(rint(f32(x) * act_inv), +-127),
//             on the FMA pipe: probe_rep.cuh quantize16), into a window; tap
//             dx is the window's descriptor dx pixels on.
//   fill      the band's windows are filled by a producer warpgroup of their
//             own, three windows in a ring on mbarriers, so repetition n's
//             fill runs under repetitions n - 1 and n - 2's products; the two
//             consumer warpgroups only issue wgmma.  (Filled by the issuing
//             warps, the proxy fence that hands a window to wgmma waited for
//             their products in flight, and the fill did not overlap them.)
//   MMA       wgmma m64n128k16 bf16 -> f32 or m64n128k32 s8 -> s32, a
//             repetition's taps back to back into one accumulator, one
//             repetition's group kept in flight.
//   sums      a block writes one partial (128 x 128 sums) a group it touched
//             to scratch; after a grid barrier every block adds a share of
//             the outputs' partials, parts in order, blocks in order, so two
//             calls give the same bits and no float is added atomically.
// The int8 sums are exact below the s32 limit: nrep at most 1040 (mm) and
// 115 (band), which ops/probe_int8.py enforces.
#include "probe_rep.cuh"

// x: mm (width, 128) int8 or bf16; band (rows_out + 2, width, 128) bf16.
// w: (ks * ks, 128 n, 128 k) of the arm's type; act_inv: (128,) f32, the
// band's int8 arm only; out: (rows_out * width, 128) s32 (int8) or f32
// (bf16); partials: at least ops/probe_int8.py rep_plan's slots x 16384
// words; blocks: the plan's (ks == 3: three parts, a multiple of 3);
// counters: null (halo_profile.py's clock64 counters).  x and w 16-byte
// aligned.
extern "C" int rst_probe(const void* x, const void* w, const void* act_inv, void* out,
                         void* partials, void* counters, int quant, int ks, int rows_out,
                         int width, int nrep, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RepParams p;
  p.out = out;
  p.partials = partials;
  p.act_inv = static_cast<const float*>(act_inv);
  p.counters = static_cast<long long*>(counters);
  p.width = width;
  p.nrep = nrep;
  p.tiles_x = (width + REP_TILE - 1) / REP_TILE;
  const int parts = ks == 3 ? 3 : 1;
  p.groups = (ks == 3 ? rows_out : 1) * p.tiles_x;
  p.bpp = blocks / parts;
  if (rows_out < 1 || width < 1 || nrep < 1 || blocks < parts || blocks % parts ||
      (long long)p.bpp > (long long)p.groups * nrep || (ks == 1 && rows_out != 1) ||
      (ks != 1 && ks != 3) || (ks == 3 && quant != (act_inv != nullptr)) ||
      (ks == 1 && act_inv))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  const bool q8 = quant != 0;
  const bool maps = ks == 1
      ? rep_plane_map(&xmap, q8, x, q8 ? 8 : 16, width, 1, REP_TILE)
      : rep_plane_map(&xmap, false, x, 16, width, rows_out + 2, REP_WIN);
  if (!maps || !rep_plane_map(&wmap, q8, w, q8 ? 8 : 16, ks * ks * REP_C, 1, REP_C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (ks == 1)
    err = q8 ? launch_rep<true, REP_MM, 1, false>(p, xmap, wmap, blocks,
                                                  RepLayout<true, REP_MM, 1>::BYTES, s)
             : launch_rep<false, REP_MM, 1, false>(p, xmap, wmap, blocks,
                                                   RepLayout<false, REP_MM, 1>::BYTES, s);
  else
    err = q8 ? launch_rep<true, REP_BAND, 3, false>(p, xmap, wmap, blocks,
                                                    RepLayout<true, REP_BAND, 3>::BYTES, s)
             : launch_rep<false, REP_BAND, 3, false>(p, xmap, wmap, blocks,
                                                     RepLayout<false, REP_BAND, 3>::BYTES, s);
  return static_cast<int>(err);
}
