// Re-lay the fused first-axis pass's input into contiguous tiles
// (kernel B6).
//
// Replaces the Pallas TPU kernel
//   ska_sdp_cip_tpu/ops/fft_pallas.py:_pretile_kernel
//   (pretile_first_axis).
// Input: re/im (n1i * n2, m) row-major float32, row j1 * n2 + j2.
// Output: (NC, m / MB, n1i, C, MB) with j2 = ci * C + cc and
// col = bm * MB + mm:
//   out[ci, bm, j1, cc, mm] = in[j1 * n2 + ci * C + cc, bm * MB + mm],
// so every (n1i, C, MB) tile of the fused pass's tiled input mode
// (csrc/fft_fused.cu) is one contiguous run.
//
// What bounds it on Hopper: device-memory bandwidth. It moves every
// byte twice (read + write, 3.8 GB for re and im at the 15360^2
// production grid) and computes nothing. The design: one thread block
// per (j1, ci, bm) tile of C x MB floats, 16-byte loads and stores,
// neighbouring threads on neighbouring addresses on both sides (each
// input row segment is MB = 128 floats, 512 contiguous bytes); the
// TPU kernel's one-slab-per-grid-step DMA has no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// grid = (m / mb, n1i, 2 * nc); blockIdx.z picks re or im and ci.
__global__ void __launch_bounds__(kThreads)
pretile_kernel(const float4* __restrict__ re, const float4* __restrict__ im,
               float4* __restrict__ out_re, float4* __restrict__ out_im,
               int n1i, int n2, int c, int mb4, int64_t m4) {
  const int64_t bm = blockIdx.x;
  const int j1 = blockIdx.y;
  const int nc = gridDim.z / 2;
  const int part = blockIdx.z / nc;
  const int ci = blockIdx.z - part * nc;
  const float4* in = part ? im : re;
  float4* out = part ? out_im : out_re;
  const int64_t num_mb = gridDim.x;
  const int64_t tile = c * mb4;  // float4s per (C, MB) tile
  const int64_t out0 = ((ci * num_mb + bm) * n1i + j1) * tile;
  const int64_t row0 = static_cast<int64_t>(j1) * n2 + ci * c;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int cc = e / mb4;
    const int mm = e - cc * mb4;
    out[out0 + e] = in[(row0 + cc) * m4 + bm * mb4 + mm];
  }
}

}  // namespace

// C entry (bound with ctypes by ops/fft_cuda.py). Requires mb % 4 == 0,
// m % mb == 0, n2 % c == 0 and 16-byte-aligned pointers. Returns the
// CUDA error code (0 = ok).
extern "C" int cip_pretile_first_axis(const float* re, const float* im,
                                      float* out_re, float* out_im, int n1i,
                                      int n2, int c, int mb, int64_t m,
                                      void* stream) {
  if (c <= 0 || n2 % c != 0 || mb <= 0 || mb % 4 != 0 || m % mb != 0 ||
      n1i <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = n2 / c;
  const dim3 grid(static_cast<unsigned>(m / mb), static_cast<unsigned>(n1i),
                  static_cast<unsigned>(2 * nc));
  pretile_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(re), reinterpret_cast<const float4*>(im),
      reinterpret_cast<float4*>(out_re), reinterpret_cast<float4*>(out_im),
      n1i, n2, c, mb / 4, m / 4);
  return static_cast<int>(cudaGetLastError());
}
