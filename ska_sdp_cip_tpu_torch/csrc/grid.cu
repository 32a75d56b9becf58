// ES-kernel gridding of visibility blocks onto a group of G adjacent
// w-planes (kernel B1; B4 is its G = 1 case).
//
// Replaces the Pallas TPU kernels
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_grid_strip_group_kernel_factory
//     (built by build_grid_planes_pallas_group, G >= 2) and
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_grid_strip_kernel_factory
//     (built by build_grid_planes_pallas, G = 1).
// Both compute, for every block of B visibilities bound to one
// (patch_x, patch_y) patch at (block_ox, block_oy),
//   patch_p[r, c] += sum_k ax[r, k] * vis_k * amp_{p, k} * ay[c, k]
// with ax/ay the ES kernel of the patch-relative positions and amp the
// ES kernel of (w_p - |w|) masked by the block length.
//
// What bounds it on Hopper: the TPU computed the patch as a dense
// (patch_x, B) x (B, patch_y) matrix product because its MXU makes
// dense work cheap; only W of the patch_x rows and W of the patch_y
// columns of each visibility are nonzero, so the dense form spends
// ~(48 * 128) / (W * W) = 170x the useful multiply-adds at W = 6. Here
// each visibility scatters only its W x W footprint, and the bound is
// the shared-memory atomic adds (2G * W^2 per visibility) plus the
// flush of each patch into device memory. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W: 8.7 ms for one bench plane group (G = 2, 6961
// blocks of 1024 slots), against 117-156 ms for the dense plain
// version (ops/cuda_gridder.py:grid_planes_reference).
//
// Design (first version: simple and right, not yet fast):
//   * one thread block per (active block of the plane group); the list
//     is built on the host from the plan's active table;
//   * the 2G (re, im) patch accumulators live in dynamic shared memory
//     (2G * 48 * 128 * 4 B = 96 KiB at G = 2);
//   * one thread per visibility evaluates its ES factors (expf, sqrtf,
//     IEEE, no fast math) and adds its footprint with shared atomics;
//   * the patch is flushed with atomicAdd into the 2G zeroed
//     (nalloc_x, nalloc_y) planes, since patches of different blocks
//     overlap. Summation order therefore varies from run to run at the
//     float32 rounding level.
// The TPU kernel's strips, sentinels, carry rows, DMA rings and bf16x3
// split dots answer to VMEM and MXU limits and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Footprint candidates per axis: support <= 16 (kernel_support_for_epsilon)
// plus the two edge cells the ES evaluation itself zeroes.
constexpr int kMaxFoot = 18;

__device__ __forceinline__ float es_kernel(float z, float beta) {
  // Same op order as ops/kernels.py:es_kernel (t = 1 - z*z,
  // exp(beta*s - beta)); zero outside |z| < 1.
  const float t = 1.0f - z * z;
  if (!(t > 0.0f)) return 0.0f;
  return expf(beta * sqrtf(t) - beta);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
grid_planes_kernel(const float* __restrict__ xpos,
                   const float* __restrict__ ypos,
                   const float* __restrict__ ws,
                   const float* __restrict__ vis_re,
                   const float* __restrict__ vis_im,
                   const int32_t* __restrict__ block_len,
                   const int32_t* __restrict__ block_ox,
                   const int32_t* __restrict__ block_oy,
                   const int32_t* __restrict__ blocks,
                   const float* __restrict__ w_g,
                   float* __restrict__ out,
                   int block, int patch_x, int patch_y, int support,
                   float beta, float inv_half, float inv_whalf,
                   int wstacking, int64_t nalloc_x, int64_t nalloc_y) {
  extern __shared__ float patch[];  // [2G][patch_x][patch_y]
  const int b = blocks[blockIdx.x];
  if (b < 0) return;
  const int cells = patch_x * patch_y;
  for (int i = threadIdx.x; i < 2 * G * cells; i += blockDim.x) {
    patch[i] = 0.0f;
  }
  __syncthreads();

  const int len = block_len[b];
  const int64_t s0 = static_cast<int64_t>(b) * block;
  const float half = 0.5f * static_cast<float>(support);
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const float xp = xpos[s0 + k];
    const float yp = ypos[s0 + k];
    const float vr = vis_re[s0 + k];
    const float vi = vis_im[s0 + k];
    float amp_re[G], amp_im[G];
#pragma unroll
    for (int p = 0; p < G; ++p) {
      const float amp =
          wstacking ? es_kernel((w_g[p] - ws[s0 + k]) * inv_whalf, beta)
                    : 1.0f;
      amp_re[p] = vr * amp;
      amp_im[p] = vi * amp;
    }
    // Candidate footprint: every cell with |cell - pos| < W/2, padded
    // by one cell each side; the ES evaluation zeroes the extras and
    // the patch bounds clip what the dense TPU patch would not hold.
    const int r0 = max(0, static_cast<int>(floorf(xp - half)));
    const int c0 = max(0, static_cast<int>(floorf(yp - half)));
    const int foot = min(kMaxFoot, support + 2);
    const int nr = min(foot, patch_x - r0);
    const int nc = min(foot, patch_y - c0);
    float ax[kMaxFoot], ay[kMaxFoot];
    for (int i = 0; i < nr; ++i) {
      ax[i] = es_kernel((static_cast<float>(r0 + i) - xp) * inv_half, beta);
    }
    for (int j = 0; j < nc; ++j) {
      ay[j] = es_kernel((static_cast<float>(c0 + j) - yp) * inv_half, beta);
    }
    for (int i = 0; i < nr; ++i) {
      if (ax[i] == 0.0f) continue;
      float* row = patch + (r0 + i) * patch_y + c0;
      for (int j = 0; j < nc; ++j) {
        if (ay[j] == 0.0f) continue;
#pragma unroll
        for (int p = 0; p < G; ++p) {
          // ax * (vis * amp) first, then * ay: the TPU kernel's order.
          atomicAdd(row + (2 * p) * cells + j, ax[i] * amp_re[p] * ay[j]);
          atomicAdd(row + (2 * p + 1) * cells + j,
                    ax[i] * amp_im[p] * ay[j]);
        }
      }
    }
  }
  __syncthreads();

  const int64_t ox = block_ox[b];
  const int64_t oy = block_oy[b];
  const int64_t plane = nalloc_x * nalloc_y;
  for (int i = threadIdx.x; i < 2 * G * cells; i += blockDim.x) {
    const float v = patch[i];
    if (v == 0.0f) continue;
    const int q = i / cells;
    const int rc = i - q * cells;
    const int r = rc / patch_y;
    const int c = rc - r * patch_y;
    atomicAdd(out + q * plane + (ox + r) * nalloc_y + (oy + c), v);
  }
}

template <int G>
cudaError_t launch(const float* xpos, const float* ypos, const float* ws,
                   const float* vis_re, const float* vis_im,
                   const int32_t* block_len, const int32_t* block_ox,
                   const int32_t* block_oy, const int32_t* blocks,
                   int num_active, const float* w_g, float* out, int block,
                   int patch_x, int patch_y, int support, float beta,
                   float inv_half, float inv_whalf, int wstacking,
                   int64_t nalloc_x, int64_t nalloc_y,
                   cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(2 * G) * patch_x * patch_y * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grid_planes_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (num_active > 0) {
    grid_planes_kernel<G><<<num_active, kThreads, smem, stream>>>(
        xpos, ypos, ws, vis_re, vis_im, block_len, block_ox, block_oy,
        blocks, w_g, out, block, patch_x, patch_y, support, beta, inv_half,
        inv_whalf, wstacking, nalloc_x, nalloc_y);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry (bound with ctypes by ops/cuda_gridder.py). `out` holds 2G
// zeroed (nalloc_x, nalloc_y) float32 planes in the order re_0, im_0,
// re_1, im_1, ... Returns the CUDA error code of the launch (0 = ok);
// G other than 1 and 2 returns cudaErrorInvalidValue.
extern "C" int cip_grid_planes(
    const float* xpos, const float* ypos, const float* ws,
    const float* vis_re, const float* vis_im, const int32_t* block_len,
    const int32_t* block_ox, const int32_t* block_oy, const int32_t* blocks,
    int num_active, const float* w_g, int group, float* out, int block,
    int patch_x, int patch_y, int support, float beta, float inv_half,
    float inv_whalf, int wstacking, int64_t nalloc_x, int64_t nalloc_y,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch<1>(xpos, ypos, ws, vis_re, vis_im, block_len, block_ox,
                       block_oy, blocks, num_active, w_g, out, block,
                       patch_x, patch_y, support, beta, inv_half, inv_whalf,
                       wstacking, nalloc_x, nalloc_y, s);
    case 2:
      return launch<2>(xpos, ypos, ws, vis_re, vis_im, block_len, block_ox,
                       block_oy, blocks, num_active, w_g, out, block,
                       patch_x, patch_y, support, beta, inv_half, inv_whalf,
                       wstacking, nalloc_x, nalloc_y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
