// probe_smem: how far a block's dynamic shared memory can be raised on this
// card, and whether reserving more costs a fixed workload anything.
//
// Replaces the two pallas_calls of tools/probe_vmem_cap.py: _scratch_kernel
// via try_alloc (:53, :67-88), which asked whether a kernel with a scratch of
// about the raised scoped-VMEM cap builds and runs, and _work_kernel via
// work_time_ms (:91, :111-144), which timed a fixed band-realistic workload
// built under each cap.  The Hopper question is the opt-in dynamic
// shared-memory cap per block (cudaFuncAttributeMaxDynamicSharedMemorySize up
// to sharedMemPerBlockOptin):
//
// mode 0 (fill): set the attribute to `bytes`, launch `blocks` blocks that
//   fill the whole buffer with a per-block pattern and read it back in
//   another thread order; out[b] is the XOR of block b's words.  A size above
//   the opt-in cap is refused by cudaFuncSetAttribute or at launch.
// mode 1 (work): the TPU probe's workload, reps times sum_t x @ w[t], x
//   (2400, 128) bf16, w (3, 128 k, 128 n) bf16, f32 sums: probe_rep.cuh's
//   kernel (the design note is probe_int8.cu's), its three taps' weights
//   read transposed into registers (ldmatrix.trans), the same x tile the B
//   operand of every tap; one cooperative launch of one block an SM over
//   (tile, repetition) units, partials added in a fixed order.  A block
//   takes max(own, `bytes`) of shared memory, own being what the kernel uses
//   (its 96 KB of dynamic, the weights' staging that the x tiles reuse, and
//   its few static bytes), so a reservation is a cap raised over the
//   kernel's own use, as the TPU probe's vmem_limit_bytes was, and one at or
//   below own changes nothing; it can cost time only through blocks per SM
//   (info) and the L1 carve-out.  Bound:
//   operations (2 * 2400 * 128 * 128 * 3 a repetition, 0.2385 us of bf16
//   tensor-core time); the probe reads the time a repetition from two
//   repetition counts.
//
// info (host int[4]): the opt-in cap in bytes, blocks per SM at the launched
// bytes, the SM count, and the work kernel's own bytes (static and dynamic).
#include "probe_rep.cuh"

namespace {

constexpr int FILL_THREADS = 256;
constexpr int TAPS = 3;  // the work arm's taps

__device__ __forceinline__ uint32_t pattern(uint32_t i, uint32_t b) {
  return i * 2654435761u + b;
}

__global__ void __launch_bounds__(FILL_THREADS) fill_kernel(uint32_t* out, int words) {
  extern __shared__ uint32_t buf[];
  for (int i = threadIdx.x; i < words; i += FILL_THREADS) buf[i] = pattern(i, blockIdx.x);
  __syncthreads();
  uint32_t v = 0;
  for (int i = threadIdx.x; i < words; i += FILL_THREADS) v ^= buf[words - 1 - i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) atomicXor(out + blockIdx.x, v);
}

template <typename K>
cudaError_t reserve(K kernel, int bytes, int threads, int* info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[2], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel, threads, bytes);
  if (err != cudaSuccess) cudaGetLastError();  // a refusal is a result, not a sticky error
  return err;
}

}  // namespace

// mode 0: out (blocks,) uint32, zeroed by the caller; rows, x, w, partials
// unused.  mode 1: x (rows, 128) bf16, w (3, 128, 128) bf16 (tap, k, n), out
// (rows, 128) f32, partials ops/probe_smem.py work_plan's slots x 16384
// floats, blocks the plan's.
extern "C" int rst_probe_smem(int mode, int bytes, int blocks, int reps, int rows,
                              const void* x, const void* w, void* out, void* partials,
                              void* info, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  inf[0] = inf[1] = inf[2] = inf[3] = 0;
  if (bytes < 0 || blocks < 1 || (mode == 1 && (reps < 1 || rows < 1)) ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (mode == 0) {
    err = reserve(fill_kernel, bytes, FILL_THREADS, inf);
    if (err != cudaSuccess) return static_cast<int>(err);
    fill_kernel<<<blocks, FILL_THREADS, bytes, s>>>(static_cast<uint32_t*>(out), bytes / 4);
    return static_cast<int>(cudaGetLastError());
  }
  // a block's shared memory is the kernel's static bytes (its mbarriers)
  // and the dynamic bytes launched: own = static + RepLayout's bytes, and a
  // reservation of `bytes` launches max(own, bytes) - static dynamic bytes
  auto kernel = probe_rep_kernel<false, REP_MM, TAPS, true>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stat = static_cast<int>(attr.sharedSizeBytes);
  inf[3] = stat + RepLayout<false, REP_MM, TAPS>::BYTES;
  const int launched = (bytes > inf[3] ? bytes : inf[3]) - stat;
  err = reserve(kernel, launched, REP_THREADS, inf);
  if (err != cudaSuccess) return static_cast<int>(err);
  RepParams p;
  p.out = out;
  p.partials = partials;
  p.act_inv = nullptr;
  p.counters = nullptr;
  p.width = rows;
  p.nrep = reps;
  p.tiles_x = p.groups = (rows + REP_TILE - 1) / REP_TILE;
  p.bpp = blocks;
  CUtensorMap xmap, wmap;
  if ((long long)blocks > (long long)p.groups * reps ||
      !rep_plane_map(&xmap, false, x, 16, rows, 1, REP_TILE) ||
      !rep_plane_map(&wmap, false, w, 16, TAPS * REP_C, 1, REP_C))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_rep<false, REP_MM, TAPS, true>(p, xmap, wmap, blocks, launched, s));
}
