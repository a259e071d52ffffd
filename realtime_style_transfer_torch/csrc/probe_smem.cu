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
// mode 1 (work): the TPU probe's workload, (2400, 128) bf16 @ 3 x (128, 128)
//   bf16 tap matmuls accumulated in f32, `reps` times, one warp a 16-row
//   block (150 blocks), launched with `bytes` of dynamic shared memory
//   reserved and unused.  The reservation can cost time only through
//   occupancy (blocks per SM) and the L1 carve-out; info reports the former.
//   Bound: operations (2 * 2400 * 128 * 128 * 3 per repetition).
//
// info (host int[3]): the opt-in cap in bytes, blocks per SM at `bytes`, and
// the SM count.
#include "stage_common.cuh"

namespace {

constexpr int FILL_THREADS = 256;
constexpr int C = 128;  // K and N of the work products
constexpr int TAPS = 3;

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

// x: (m, 128) bf16 row-major; wt: (3, 128 n, 128 k) bf16 (each tap's weights
// transposed, so a B fragment's k pair is one 32-bit load); out: (m, 128) f32.
__global__ void __launch_bounds__(32) work_kernel(const __nv_bfloat16* __restrict__ x,
                                                  const __nv_bfloat16* __restrict__ wt,
                                                  float* __restrict__ out, int reps) {
  const int lane = threadIdx.x, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* xa = x + ((size_t)blockIdx.x * 16 + g) * C + 2 * t4;
  float acc[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int rep = 0; rep < reps; ++rep)
    for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xa + k0);
        a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * C + k0);
        a[2] = *reinterpret_cast<const uint32_t*>(xa + k0 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * C + k0 + 8);
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) {
          const __nv_bfloat16* b = wt + ((size_t)tap * C + nt * 8 + g) * C + k0 + 2 * t4;
          mma16816(acc[nt], a, *reinterpret_cast<const uint32_t*>(b),
                   *reinterpret_cast<const uint32_t*>(b + 8));
        }
      }
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = out + ((size_t)blockIdx.x * 16 + g + 8 * h) * C + nt * 8 + 2 * t4;
      o[0] = acc[nt][2 * h];
      o[1] = acc[nt][2 * h + 1];
    }
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

// mode 0: out (blocks,) uint32, zeroed by the caller; x, w unused.
// mode 1: x (m, 128) bf16 with m = 16 * blocks, w (3, 128, 128) bf16
// transposed per tap, out (m, 128) f32.
extern "C" int rst_probe_smem(int mode, int bytes, int blocks, int reps, const void* x,
                              const void* w, void* out, void* info, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  inf[0] = inf[1] = inf[2] = 0;
  if (bytes < 0 || blocks < 1 || (mode == 1 && reps < 1) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (mode == 0) {
    err = reserve(fill_kernel, bytes, FILL_THREADS, inf);
    if (err != cudaSuccess) return static_cast<int>(err);
    fill_kernel<<<blocks, FILL_THREADS, bytes, s>>>(static_cast<uint32_t*>(out), bytes / 4);
  } else {
    err = reserve(work_kernel, bytes, 32, inf);
    if (err != cudaSuccess) return static_cast<int>(err);
    work_kernel<<<blocks, 32, bytes, s>>>(static_cast<const __nv_bfloat16*>(x),
                                          static_cast<const __nv_bfloat16*>(w),
                                          static_cast<float*>(out), reps);
  }
  err = cudaGetLastError();
  return static_cast<int>(err);
}
