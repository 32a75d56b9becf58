// ES-kernel degridding of a group of G adjacent w-planes, read from the
// periodic N x N grid, at the visibility positions of the group's active
// blocks (kernel B3; B5 is its G = 1 case). The adjoint of grid.cu.
//
// Replaces the Pallas TPU kernels
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_degrid_strip_group_kernel_factory
//     (built by build_degrid_planes_pallas_group, G >= 2) and
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_degrid_strip_kernel_factory
//     (built by build_degrid_planes_pallas, G = 1),
// composed with the wrap unfold that precedes them (ops/gridder.py
// _unfold_wraps). Both compute, for every slot s of a block bound to
// one (patch_x, patch_y) patch at (block_ox, block_oy),
//   con[s] = sum_p amp_p[s] * sum_{r,c} ax[r, s] * ay[c, s]
//                                       * plane_p[block_ox + r, block_oy + c]
// for the re and im planes, with ax/ay the ES kernel of the
// patch-relative positions and amp the ES kernel of (w_p - |w|) masked
// by the block length (ones without w-stacking). Alloc row r is read
// from periodic row (r - W) mod N, and columns the same way. The caller
// adds con into a slot accumulator across plane groups.
//
// What bounds it on Hopper: the function reads each tile's 2G windows
// once and each slot's three floats and accumulator; at 3.35 TB/s that
// is 0.10 ms for the bench plan's largest group, 0.035 ms at
// production. The first design (a thread block per active block, one
// thread per visibility) read every block's 2G windows from device
// memory again, 684 MB per bench group against 157 MB of distinct
// windows, did not overlap the loads with compute (load alone 1.13 ms,
// compute alone 1.06 ms of its 1.80 ms a bench group), and read the
// footprint with lane-dependent shared addresses (bank conflicts). Here
// the loads are hidden; the per-visibility instructions (factor
// evaluation, shuffles, the sum) bound the kernel.
//
// Design:
//   * chunks of tile runs, (first, count) rows (ops/gridder.py
//     tile_chunks). A persistent thread block walks the chunks
//     blockIdx.x, blockIdx.x + gridDim.x, ... and loads the next
//     chunk's 2G 48 x 128 windows with cp.async into the second of two
//     shared buffers while it computes on the first (2 x 102 KiB at
//     G = 2). The window's rows and 16-byte column units are addressed
//     modulo N, so edge tiles need no other path; a row of the window
//     starts at the 16-byte unit holding its first column (N % 4 == 0),
//     else it is copied in 4-byte units. The chunk's batches of 32
//     visibilities are spread over all 32 warps;
//   * a visibility takes a group of CS lanes (8 for W <= 8, else 16),
//     one footprint column each, a warp 32 / CS visibilities at once:
//     the lanes evaluate the W candidate rows and columns, then each
//     sums its column over the rows (ax from the lane that evaluated
//     it, by __shfl_sync; consecutive lanes read consecutive columns,
//     rows patch_y + CS floats apart: no bank conflicts within a group),
//     weights it by ay and each plane's amp, and the group sums its
//     columns with butterfly shuffles in a fixed order. The lane holding
//     the visibility adds the sum into the accumulator without atomics:
//     a slot belongs to one block, a block to one chunk, and launches
//     for successive plane groups are ordered by the stream.
// ES factors use the constants and operation order of grid.cu (expf,
// sqrtf, IEEE, no fast math). The result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float es_kernel(float z, float beta) {
  // Same op order as ops/kernels.py:es_kernel and grid.cu.
  const float t = 1.0f - z * z;
  if (!(t > 0.0f)) return 0.0f;
  return expf(beta * sqrtf(t) - beta);
}

__device__ __forceinline__ int64_t wrap(int64_t x, int64_t n) {
  const int64_t r = x % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The column shift of a chunk's window: its first column sits this many
// floats into the window's first 16-byte unit (0 without vector copies).
__device__ __forceinline__ int window_shift(int64_t d0, bool vec) {
  return vec ? static_cast<int>(d0 & 3) : 0;
}

// Start the copies of chunk c's 2G windows into `win` ([2G][patch_x]
// [stride] floats): rows (ox + r - W) mod N, columns from
// (oy - W) mod N - shift on.
template <int G>
__device__ void load_windows(float* win, const float* __restrict__ grids,
                             const int32_t* __restrict__ block_ox,
                             const int32_t* __restrict__ block_oy, int b0,
                             int patch_x, int patch_y, int stride,
                             int support, int64_t n, bool vec) {
  const int64_t plane = n * n;
  const int64_t ox = block_ox[b0];
  const int64_t d0 = wrap(static_cast<int64_t>(block_oy[b0]) - support, n);
  const int pcells = patch_x * stride;
  if (vec) {
    // N % 4 == 0 and d0 - shift % 4 == 0: no 16-byte unit straddles
    // column N, so each unit's columns are (start + 4u) mod N on.
    const int64_t start = d0 - window_shift(d0, vec);
    const int units = (patch_y + 3) / 4 + 1;
    for (int it = threadIdx.x; it < 2 * G * patch_x * units;
         it += blockDim.x) {
      const int u = it % units;
      const int r = (it / units) % patch_x;
      const int q = it / (units * patch_x);
      const int64_t row = q * plane + wrap(ox + r - support, n) * n;
      cp_async16(win + q * pcells + r * stride + 4 * u,
                 grids + row + wrap(start + 4 * u, n));
    }
  } else {
    for (int it = threadIdx.x; it < 2 * G * patch_x * patch_y;
         it += blockDim.x) {
      const int c = it % patch_y;
      const int r = (it / patch_y) % patch_x;
      const int q = it / (patch_y * patch_x);
      const int64_t row = q * plane + wrap(ox + r - support, n) * n;
      cp_async4(win + q * pcells + r * stride + c,
                grids + row + wrap(d0 + c, n));
    }
  }
}

template <int G, int CS, int W>
__global__ void __launch_bounds__(kThreads, 1)
degrid_chunks_kernel(const float* __restrict__ xpos,
                     const float* __restrict__ ypos,
                     const float* __restrict__ ws,
                     const int32_t* __restrict__ block_len,
                     const int32_t* __restrict__ block_ox,
                     const int32_t* __restrict__ block_oy,
                     const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ chunks, int num_chunks,
                     const float* __restrict__ w_g,
                     const float* __restrict__ grids,
                     float* __restrict__ acc_re,
                     float* __restrict__ acc_im,
                     int block, int patch_x, int patch_y, int support,
                     float beta, float inv_half, float inv_whalf,
                     int wstacking, int ngrid) {
  extern __shared__ float smem[];  // [2 buffers][2G][patch_x][stride]
  const int stride = patch_y + CS;
  const int pcells = patch_x * stride;
  const int wcells = 2 * G * pcells;
  const int64_t n = ngrid;
  const bool vec = (ngrid & 3) == 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float half = 0.5f * static_cast<float>(support);
  const int kw = W > 0 ? W : support;  // W > 0: the support, unrolled
  // A visibility takes a group of CS lanes, one footprint column each,
  // one row an instruction; a warp takes kGroups visibilities at once.
  constexpr int kLanes = CS;
  constexpr int kGroups = 32 / kLanes;
  const int sub = lane / kLanes;
  const int sl = lane % kLanes;
  const int first_lane = sub * kLanes;

  int c = blockIdx.x;
  if (c >= num_chunks) return;
  load_windows<G>(smem, grids, block_ox, block_oy, blocks[chunks[2 * c]],
                  patch_x, patch_y, stride, support, n, vec);
  cp_async_commit();
  for (int it = 0; c < num_chunks; ++it, c += gridDim.x) {
    const int next = c + gridDim.x;
    if (next < num_chunks) {
      load_windows<G>(smem + ((it + 1) & 1) * wcells, grids, block_ox,
                      block_oy, blocks[chunks[2 * next]], patch_x, patch_y,
                      stride, support, n, vec);
    }
    cp_async_commit();
    cp_async_wait_one();  // this chunk's copies (the older group) landed
    __syncthreads();

    const float* win = smem + (it & 1) * wcells;
    const int first = chunks[2 * c];
    const int count = chunks[2 * c + 1];
    const int shift =
        window_shift(wrap(static_cast<int64_t>(block_oy[blocks[first]]) -
                          support, n), vec);
    // Batches of 32 visibilities spread over the warps as in grid.cu.
    for (int bi = 0, batches = 0; bi < count; ++bi) {
      const int b = blocks[first + bi];
      const int len = block_len[b];
      const int64_t s0 = static_cast<int64_t>(b) * block;
      const int t0 = ((warp - batches) % nwarps + nwarps) % nwarps;
      batches += (len + 31) / 32;
      for (int base = 32 * t0; base < len; base += nwarps * 32) {
        const int k = base + lane;
        float xp = 0.0f, yp = 0.0f, w = 0.0f;
        if (k < len) {
          xp = xpos[s0 + k];
          yp = ypos[s0 + k];
          w = ws[s0 + k];
        }
        float amp[G];
#pragma unroll
        for (int p = 0; p < G; ++p) {
          amp[p] = wstacking ? es_kernel((w_g[p] - w) * inv_whalf, beta)
                             : 1.0f;
        }
        float mine_re = 0.0f, mine_im = 0.0f;
        const int nv = min(32, len - base);
        for (int v0 = 0; v0 < nv; v0 += kGroups) {
          // Group `sub` takes visibility v0 + sub of the batch.
          const int v = (v0 + sub) & 31;
          const bool live = v0 + sub < nv;
          const float x = __shfl_sync(kFull, xp, v);
          const float y = __shfl_sync(kFull, yp, v);
          float am[G];
          bool any = false;
#pragma unroll
          for (int p = 0; p < G; ++p) {
            am[p] = __shfl_sync(kFull, amp[p], v);
            any = any || am[p] != 0.0f;
          }
          any = any && live;
          if (!__any_sync(kFull, any)) continue;  // all sums are zero
          // Candidate cells: the W after floor(pos - W/2), the only ones
          // with |cell - pos| < W/2 (ops/cuda_gridder.py checks that
          // float32(2/W) rounds up, so the cells either side evaluate
          // to exactly zero), clipped to the patch.
          const int r0 = static_cast<int>(floorf(x - half)) + 1;
          const int c0 = static_cast<int>(floorf(y - half)) + 1;
          const bool rx = any && sl < kw && r0 + sl >= 0 &&
                          r0 + sl < patch_x;
          const bool ry = any && sl < kw && c0 + sl >= 0 &&
                          c0 + sl < patch_y;
          const float ax = rx ? es_kernel(
              (static_cast<float>(r0 + sl) - x) * inv_half, beta) : 0.0f;
          const float ay = ry ? es_kernel(
              (static_cast<float>(c0 + sl) - y) * inv_half, beta) : 0.0f;
          // Lane sl sums column c0 + sl over the W candidate rows (ax from
          // the lane that evaluated it), then weights it by ay and by
          // each plane's amp.
          const float* column = win + r0 * stride + (c0 + sl + shift);
          float t_re[G], t_im[G];
#pragma unroll
          for (int p = 0; p < G; ++p) {
            t_re[p] = 0.0f;
            t_im[p] = 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kw; ++i) {
            const float a = __shfl_sync(kFull, ax, first_lane + i);
            if (a != 0.0f && ay != 0.0f) {
              const float* cell = column + i * stride;
#pragma unroll
              for (int p = 0; p < G; ++p) {
                t_re[p] += a * cell[(2 * p) * pcells];
                t_im[p] += a * cell[(2 * p + 1) * pcells];
              }
            }
          }
          float con_re = 0.0f, con_im = 0.0f;
#pragma unroll
          for (int p = 0; p < G; ++p) {
            con_re += t_re[p] * ay * am[p];
            con_im += t_im[p] * ay * am[p];
          }
          // The group's columns, in a fixed butterfly order.
#pragma unroll
          for (int off = 1; off < kLanes; off <<= 1) {
            con_re += __shfl_xor_sync(kFull, con_re, off);
            con_im += __shfl_xor_sync(kFull, con_im, off);
          }
          // Lane v0 + s keeps group s's sum.
          const int s = lane - v0;
          const int from = (s & (kGroups - 1)) * kLanes;
          const float got_re = __shfl_sync(kFull, con_re, from);
          const float got_im = __shfl_sync(kFull, con_im, from);
          if (s >= 0 && s < kGroups) {
            mine_re = got_re;
            mine_im = got_im;
          }
        }
        if (k < len) {
          acc_re[s0 + k] += mine_re;
          acc_im[s0 + k] += mine_im;
        }
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
}

template <int G, int CS, int W>
cudaError_t launch(const float* xpos, const float* ypos, const float* ws,
                   const int32_t* block_len, const int32_t* block_ox,
                   const int32_t* block_oy, const int32_t* blocks,
                   const int32_t* chunks, int num_chunks, const float* w_g,
                   const float* grids, float* acc_re, float* acc_im,
                   int block, int patch_x, int patch_y, int support,
                   float beta, float inv_half, float inv_whalf,
                   int wstacking, int ngrid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * 2 * G) * patch_x *
                      (patch_y + CS) * sizeof(float);
  auto kernel = degrid_chunks_kernel<G, CS, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (num_chunks > 0) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    const int grid = min(num_chunks, max(1, per_sm) * sms);
    kernel<<<grid, kThreads, smem, stream>>>(
        xpos, ypos, ws, block_len, block_ox, block_oy, blocks, chunks,
        num_chunks, w_g, grids, acc_re, acc_im, block, patch_x, patch_y,
        support, beta, inv_half, inv_whalf, wstacking, ngrid);
  }
  return cudaGetLastError();
}

// The kernel for this support: unrolled over W = 6 and 8 (the bench and
// production supports), CS = 8 lanes up to W = 8, else 16.
template <int G>
cudaError_t launch_cs(const float* xpos, const float* ypos, const float* ws,
                      const int32_t* block_len, const int32_t* block_ox,
                      const int32_t* block_oy, const int32_t* blocks,
                      const int32_t* chunks, int num_chunks,
                      const float* w_g, const float* grids, float* acc_re,
                      float* acc_im, int block, int patch_x, int patch_y,
                      int support, float beta, float inv_half,
                      float inv_whalf, int wstacking, int ngrid,
                      cudaStream_t stream) {
  auto run = [&](auto kernel_launch) {
    return kernel_launch(xpos, ypos, ws, block_len, block_ox, block_oy,
                         blocks, chunks, num_chunks, w_g, grids, acc_re,
                         acc_im, block, patch_x, patch_y, support, beta,
                         inv_half, inv_whalf, wstacking, ngrid, stream);
  };
  if (support == 6) return run(launch<G, 8, 6>);
  if (support == 8) return run(launch<G, 8, 8>);
  if (support < 8) return run(launch<G, 8, 0>);
  return run(launch<G, 16, 0>);
}

}  // namespace

// C entry (bound with ctypes by ops/cuda_gridder.py). `grids` holds 2G
// contiguous periodic (ngrid, ngrid) float32 planes in the order re_0,
// im_0, re_1, im_1, ...; `chunks` is the (first, count) table of
// ops/gridder.py:tile_chunks over `blocks`; the group's contributions
// are ADDED into acc_re/acc_im. Returns the CUDA error code of the
// launch (0 = ok);
// G other than 1 and 2 returns cudaErrorInvalidValue.
extern "C" int cip_degrid_planes(
    const float* xpos, const float* ypos, const float* ws,
    const int32_t* block_len, const int32_t* block_ox,
    const int32_t* block_oy, const int32_t* blocks, const int32_t* chunks,
    int num_chunks, const float* w_g, int group, const float* grids,
    float* acc_re, float* acc_im, int block, int patch_x, int patch_y,
    int support, float beta, float inv_half, float inv_whalf, int wstacking,
    int ngrid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch_cs<1>(xpos, ypos, ws, block_len, block_ox, block_oy,
                          blocks, chunks, num_chunks, w_g, grids, acc_re,
                          acc_im, block, patch_x, patch_y, support, beta,
                          inv_half, inv_whalf, wstacking, ngrid, s);
    case 2:
      return launch_cs<2>(xpos, ypos, ws, block_len, block_ox, block_oy,
                          blocks, chunks, num_chunks, w_g, grids, acc_re,
                          acc_im, block, patch_x, patch_y, support, beta,
                          inv_half, inv_whalf, wstacking, ngrid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
