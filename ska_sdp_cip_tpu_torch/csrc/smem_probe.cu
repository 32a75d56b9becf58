// The largest dynamic shared memory one thread block can use (probe P3).
//
// Replaces the Pallas TPU probe kernel
//   scripts/vmem_probe.py:try_mib (the largest usable VMEM scratch),
// as the Hopper question it stands for: how much fast on-chip memory
// does one block get? B1 and B3 (csrc/grid.cu, csrc/degrid.cu) hold
// their 2G plane windows there (96 KiB at G = 2), so the answer bounds
// the plane group G.
//
// The kernel asks for `bytes` of dynamic shared memory (after
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes)), writes a pattern into every 32-bit word, and reads it back
// through other threads into `out` (bytes / 4 words). It is bound by
// nothing worth measuring: one block, a few hundred kilobytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pattern(uint32_t i) {
  return i * 2654435761u + 12345u;
}

__global__ void __launch_bounds__(kThreads)
smem_fill_read(uint32_t* __restrict__ out, int words) {
  extern __shared__ uint32_t buf[];
  for (int i = threadIdx.x; i < words; i += kThreads) buf[i] = pattern(i);
  __syncthreads();
  // Read back in the reverse thread order, so each word is read by
  // another thread than the one that wrote it.
  for (int i = kThreads - 1 - threadIdx.x; i < words; i += kThreads) {
    out[i] = buf[i];
  }
}

}  // namespace

// C entries (bound with ctypes by probes/smem.py). Return the CUDA
// error code (0 = ok); a request above the card's limit returns the
// error of cudaFuncSetAttribute or of the launch.
extern "C" int cip_smem_probe(int bytes, uint32_t* out, void* stream) {
  if (bytes < 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      smem_fill_read, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_fill_read<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      out, bytes / 4);
  return static_cast<int>(cudaGetLastError());
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device` into *bytes.
extern "C" int cip_smem_optin_bytes(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
