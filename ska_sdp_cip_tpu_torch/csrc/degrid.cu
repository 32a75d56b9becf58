// ES-kernel degridding of a group of G adjacent w-planes at the
// visibility positions of the group's active blocks (kernel B3; B5 is
// its G = 1 case). The adjoint of grid.cu.
//
// Replaces the Pallas TPU kernels
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_degrid_strip_group_kernel_factory
//     (built by build_degrid_planes_pallas_group, G >= 2) and
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_degrid_strip_kernel_factory
//     (built by build_degrid_planes_pallas, G = 1).
// Both compute, for every slot s of a block bound to one
// (patch_x, patch_y) patch at (block_ox, block_oy),
//   con[s] = sum_p amp_p[s] * sum_{r,c} ax[r, s] * ay[c, s]
//                                       * plane_p[block_ox + r, block_oy + c]
// for the re and im planes, with ax/ay the ES kernel of the
// patch-relative positions and amp the ES kernel of (w_p - |w|) masked
// by the block length (ones without w-stacking). The caller adds con
// into a slot accumulator across plane groups.
//
// What bounds it on Hopper: the TPU read each patch once per block and
// contracted it densely on the MXU, (48 x 128) x (128 x B) then a
// weighted row sum, spending (48 * 128) / (W * W) = 170x the useful
// multiply-adds at W = 6. Here one thread per visibility sums only its
// W x W footprint (2G * W^2 shared-memory reads and FMAs), and the
// block's 2G windows are read from device memory once into shared
// memory (24 KiB per plane at 48 x 128; neighbouring blocks of one tile
// read the same windows, mostly from L2). Every slot belongs to exactly
// one block, so each thread adds its result into the accumulator
// without atomics; launches for successive plane groups are ordered by
// the stream.
//
// Design (first version: simple and right, not yet fast):
//   * one thread block per active block of the plane group, from the
//     host-built list the invert uses;
//   * the 2G windows in dynamic shared memory (96 KiB at G = 2), loaded
//     with coalesced reads along the lane axis;
//   * ES factors with the constants and operation order of grid.cu
//     (expf, sqrtf, IEEE, no fast math), so the result matches the
//     plain version (ops/cuda_gridder.py:degrid_planes_reference) to
//     float32 rounding;
//   * per visibility the rows are summed first (tmp[c] = sum_r ax[r] *
//     plane[r, c]), then the lanes (sum_c tmp[c] * ay[c]), then the
//     planes weighted by amp_p: the plain version's order.
// The TPU kernel's strips, step tables, DMA rings, packed-width steps
// and bf16x3 split dots answer to VMEM and MXU limits and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Footprint candidates per axis: support <= 16 (kernel_support_for_epsilon)
// plus the two edge cells the ES evaluation itself zeroes.
constexpr int kMaxFoot = 18;

__device__ __forceinline__ float es_kernel(float z, float beta) {
  // Same op order as ops/kernels.py:es_kernel and grid.cu.
  const float t = 1.0f - z * z;
  if (!(t > 0.0f)) return 0.0f;
  return expf(beta * sqrtf(t) - beta);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
degrid_planes_kernel(const float* __restrict__ xpos,
                     const float* __restrict__ ypos,
                     const float* __restrict__ ws,
                     const int32_t* __restrict__ block_len,
                     const int32_t* __restrict__ block_ox,
                     const int32_t* __restrict__ block_oy,
                     const int32_t* __restrict__ blocks,
                     const float* __restrict__ w_g,
                     const float* __restrict__ grids,
                     float* __restrict__ acc_re,
                     float* __restrict__ acc_im,
                     int block, int patch_x, int patch_y, int support,
                     float beta, float inv_half, float inv_whalf,
                     int wstacking, int64_t nalloc_x, int64_t nalloc_y) {
  extern __shared__ float patch[];  // [2G][patch_x][patch_y]
  const int b = blocks[blockIdx.x];
  if (b < 0) return;
  const int cells = patch_x * patch_y;
  const int64_t ox = block_ox[b];
  const int64_t oy = block_oy[b];
  const int64_t plane = nalloc_x * nalloc_y;
  for (int i = threadIdx.x; i < 2 * G * cells; i += blockDim.x) {
    const int q = i / cells;
    const int rc = i - q * cells;
    const int r = rc / patch_y;
    const int c = rc - r * patch_y;
    patch[i] = grids[q * plane + (ox + r) * nalloc_y + (oy + c)];
  }
  __syncthreads();

  const int len = block_len[b];
  const int64_t s0 = static_cast<int64_t>(b) * block;
  const float half = 0.5f * static_cast<float>(support);
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const float xp = xpos[s0 + k];
    const float yp = ypos[s0 + k];
    float amp[G];
#pragma unroll
    for (int p = 0; p < G; ++p) {
      amp[p] = wstacking
                   ? es_kernel((w_g[p] - ws[s0 + k]) * inv_whalf, beta)
                   : 1.0f;
    }
    // Candidate footprint as in grid.cu: every cell with
    // |cell - pos| < W/2, padded by one cell each side, clipped to the
    // patch.
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
    float sum_re[G], sum_im[G];
#pragma unroll
    for (int p = 0; p < G; ++p) {
      sum_re[p] = 0.0f;
      sum_im[p] = 0.0f;
    }
    for (int j = 0; j < nc; ++j) {
      if (ay[j] == 0.0f) continue;
      const float* col = patch + r0 * patch_y + c0 + j;
      float t_re[G], t_im[G];
#pragma unroll
      for (int p = 0; p < G; ++p) {
        t_re[p] = 0.0f;
        t_im[p] = 0.0f;
      }
      for (int i = 0; i < nr; ++i) {
        const float a = ax[i];
        const float* cell = col + i * patch_y;
#pragma unroll
        for (int p = 0; p < G; ++p) {
          t_re[p] += a * cell[(2 * p) * cells];
          t_im[p] += a * cell[(2 * p + 1) * cells];
        }
      }
#pragma unroll
      for (int p = 0; p < G; ++p) {
        sum_re[p] += t_re[p] * ay[j];
        sum_im[p] += t_im[p] * ay[j];
      }
    }
    float con_re = 0.0f, con_im = 0.0f;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      con_re += sum_re[p] * amp[p];
      con_im += sum_im[p] * amp[p];
    }
    acc_re[s0 + k] += con_re;
    acc_im[s0 + k] += con_im;
  }
}

template <int G>
cudaError_t launch(const float* xpos, const float* ypos, const float* ws,
                   const int32_t* block_len, const int32_t* block_ox,
                   const int32_t* block_oy, const int32_t* blocks,
                   int num_active, const float* w_g, const float* grids,
                   float* acc_re, float* acc_im, int block, int patch_x,
                   int patch_y, int support, float beta, float inv_half,
                   float inv_whalf, int wstacking, int64_t nalloc_x,
                   int64_t nalloc_y, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(2 * G) * patch_x * patch_y * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      degrid_planes_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (num_active > 0) {
    degrid_planes_kernel<G><<<num_active, kThreads, smem, stream>>>(
        xpos, ypos, ws, block_len, block_ox, block_oy, blocks, w_g, grids,
        acc_re, acc_im, block, patch_x, patch_y, support, beta, inv_half,
        inv_whalf, wstacking, nalloc_x, nalloc_y);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry (bound with ctypes by ops/cuda_gridder.py). `grids` holds 2G
// contiguous (nalloc_x, nalloc_y) float32 planes in the order re_0,
// im_0, re_1, im_1, ...; the group's contributions are ADDED into
// acc_re/acc_im (num_vis slots each). Returns the CUDA error code of
// the launch (0 = ok); G other than 1 and 2 returns
// cudaErrorInvalidValue.
extern "C" int cip_degrid_planes(
    const float* xpos, const float* ypos, const float* ws,
    const int32_t* block_len, const int32_t* block_ox,
    const int32_t* block_oy, const int32_t* blocks, int num_active,
    const float* w_g, int group, const float* grids, float* acc_re,
    float* acc_im, int block, int patch_x, int patch_y, int support,
    float beta, float inv_half, float inv_whalf, int wstacking,
    int64_t nalloc_x, int64_t nalloc_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch<1>(xpos, ypos, ws, block_len, block_ox, block_oy, blocks,
                       num_active, w_g, grids, acc_re, acc_im, block,
                       patch_x, patch_y, support, beta, inv_half, inv_whalf,
                       wstacking, nalloc_x, nalloc_y, s);
    case 2:
      return launch<2>(xpos, ypos, ws, block_len, block_ox, block_oy, blocks,
                       num_active, w_g, grids, acc_re, acc_im, block,
                       patch_x, patch_y, support, beta, inv_half, inv_whalf,
                       wstacking, nalloc_x, nalloc_y, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
