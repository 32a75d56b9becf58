// ES-kernel gridding of visibility blocks onto a group of G adjacent
// w-planes, written onto the periodic N x N grid (kernel B1; B4 is its
// G = 1 case).
//
// Replaces the Pallas TPU kernels
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_grid_strip_group_kernel_factory
//     (built by build_grid_planes_pallas_group, G >= 2) and
//   ska_sdp_cip_tpu/ops/pallas_gridder.py:_grid_strip_kernel_factory
//     (built by build_grid_planes_pallas, G = 1),
// composed with the wrap fold that follows them (ops/gridder.py
// _fold_wraps). Both compute, for every block of B visibilities bound
// to one (patch_x, patch_y) patch at (block_ox, block_oy),
//   patch_p[r, c] += sum_k ax[r, k] * vis_k * amp_{p, k} * ay[c, k]
// with ax/ay the ES kernel of the patch-relative positions and amp the
// ES kernel of (w_p - |w|) masked by the block length. Here alloc row r
// lands on periodic row (r - W) mod N, and columns the same way, so the
// caller receives the folded planes the FFT reads.
//
// What bounds it on Hopper: the function reads each visibility's five
// floats once and writes 2G N x N planes once (the patches land in
// them); its arithmetic is 2G * W^2 multiply-adds a visibility. On an
// H100 (3.35 TB/s) that is 0.12 ms for the bench plan's largest plane
// group (6961 blocks, 6.06M visibilities, 4096^2 planes) and 1.13 ms
// at production (272k visibilities, 15360^2 planes: the planes
// alone). The first design
// (one thread block per active block, one thread per visibility walking
// its footprint, a scalar global-atomic flush of every block's patch
// into a padded frame that two torch passes then folded) took 8.6 ms a
// bench group, 93% of it in the scatter: a warp's 32 lanes were 32
// channels of one baseline whose footprints overlap, so their shared
// atomics collided. Shared-memory float atomics are compare-and-swap
// loops on this card (ATOMS.CAST.SPIN), which the scatter below still
// pays: it, not memory, bounds the kernel.
//
// Design:
//   * the unit of work is a chunk of a tile run: consecutive active
//     blocks with one patch origin, at most R of them (the host builds
//     the (first, count, flags) table, ops/gridder.py:tile_chunks, R =
//     CHUNK_BLOCKS). One thread block per chunk keeps the chunk's 2G
//     patches in dynamic shared memory across all its blocks and
//     flushes them once. The chunk's batches of 32 visibilities are
//     spread over all 16 warps, however short its blocks;
//   * a visibility takes a group of CS lanes (8 for W <= 8, else 16),
//     one footprint column each: the lanes evaluate its W candidate rows
//     and columns (expf, sqrtf, IEEE, no fast math), then walk the rows,
//     each row's ax from the lane that evaluated it by __shfl_sync. A
//     warp's 32 / CS groups take visibilities CS slots apart, so their
//     footprints seldom share a word. Patch rows are
//     patch_y + CS floats apart (CS banks mod 32): a group's lanes hit
//     distinct banks. The product order is ax * (vis * amp) * ay, the
//     TPU kernel's;
//   * the flush walks 16-byte units of the destination rows. Rows
//     [patch_x - tile_x, tile_x) of an unsplit run of an interior tile
//     belong to this thread block alone and are written with plain
//     float4 stores; the overlap rows, every row of a split run and every
//     row of an edge tile (one holding an alloc row or column in
//     [0, 2W) u [N, N + 2W), the wrap's sources and targets) are added
//     with float4 atomicAdd (global vector reductions, sm_90). Units
//     that stayed zero are skipped, so the planes must arrive zeroed.
// Sums still go through atomics, so the summation order, and the last
// bits of the result, change from run to run: not deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float es_kernel(float z, float beta) {
  // Same op order as ops/kernels.py:es_kernel (t = 1 - z*z,
  // exp(beta*s - beta)); zero outside |z| < 1.
  const float t = 1.0f - z * z;
  if (!(t > 0.0f)) return 0.0f;
  return expf(beta * sqrtf(t) - beta);
}

__device__ __forceinline__ int64_t wrap(int64_t x, int64_t n) {
  const int64_t r = x % n;
  return r < 0 ? r + n : r;
}

// CS: footprint columns a lane group covers (8 for W <= 8, else 16).
template <int G, int CS, int W>
__global__ void __launch_bounds__(kThreads, 2)
grid_chunks_kernel(const float* __restrict__ xpos,
                   const float* __restrict__ ypos,
                   const float* __restrict__ ws,
                   const float* __restrict__ vis_re,
                   const float* __restrict__ vis_im,
                   const int32_t* __restrict__ block_len,
                   const int32_t* __restrict__ block_ox,
                   const int32_t* __restrict__ block_oy,
                   const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ chunks,
                   const float* __restrict__ w_g,
                   float* __restrict__ out,
                   int block, int patch_x, int patch_y, int tile_x,
                   int support, float beta, float inv_half,
                   float inv_whalf, int wstacking, int ngrid) {
  extern __shared__ float patch[];  // [2G][patch_x][stride]
  const int stride = patch_y + CS;
  const int pcells = patch_x * stride;
  const int first = chunks[3 * blockIdx.x];
  const int count = chunks[3 * blockIdx.x + 1];
  const int flags = chunks[3 * blockIdx.x + 2];
  {
    float4* p4 = reinterpret_cast<float4*>(patch);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = threadIdx.x; i < 2 * G * pcells / 4; i += blockDim.x) {
      p4[i] = zero;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float half = 0.5f * static_cast<float>(support);
  const int kw = W > 0 ? W : support;  // W > 0: the support, unrolled
  // A visibility takes a group of CS lanes, one footprint column each,
  // one row an instruction; the warp's kGroups groups take visibilities
  // kStride slots apart (channels of one baseline lie side by side, and
  // footprints far apart collide less on the patch's words).
  constexpr int kLanes = CS;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kStride = 32 / kGroups;
  const int sub = lane / kLanes;
  const int sl = lane % kLanes;
  const int first_lane = sub * kLanes;
  // Batch t of 32 visibilities of the chunk's i-th block goes to warp
  // (batches of the blocks before it + t) mod nwarps: the chunk's
  // batches spread over all warps, however short its blocks.
  for (int bi = 0, batches = 0; bi < count; ++bi) {
    const int b = blocks[first + bi];
    const int len = block_len[b];
    const int64_t s0 = static_cast<int64_t>(b) * block;
    const int t0 = ((warp - batches) % nwarps + nwarps) % nwarps;
    batches += (len + 31) / 32;
    for (int base = 32 * t0; base < len; base += nwarps * 32) {
      // Lane k loads visibility base + k; the warp's lane groups then
      // grid the 32, a group each.
      const int k = base + lane;
      float xp = 0.0f, yp = 0.0f, vr = 0.0f, vi = 0.0f, w = 0.0f;
      if (k < len) {
        xp = xpos[s0 + k];
        yp = ypos[s0 + k];
        vr = vis_re[s0 + k];
        vi = vis_im[s0 + k];
        w = ws[s0 + k];
      }
      float amp_re[G], amp_im[G];
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const float amp =
            wstacking ? es_kernel((w_g[p] - w) * inv_whalf, beta) : 1.0f;
        amp_re[p] = vr * amp;
        amp_im[p] = vi * amp;
      }
      const int nv = min(32, len - base);
      for (int v0 = 0; v0 < min(nv, kStride); ++v0) {
        // Group `sub` takes visibility v0 + sub * kStride of the batch.
        const int v = v0 + sub * kStride;
        const bool live = v < nv;
        const float x = __shfl_sync(kFull, xp, v);
        const float y = __shfl_sync(kFull, yp, v);
        float are[G], aim[G];
        bool any = false;
#pragma unroll
        for (int p = 0; p < G; ++p) {
          are[p] = __shfl_sync(kFull, amp_re[p], v);
          aim[p] = __shfl_sync(kFull, amp_im[p], v);
          any = any || are[p] != 0.0f || aim[p] != 0.0f;
        }
        any = any && live;
        if (!__any_sync(kFull, any)) continue;  // adds only zeros
        // Candidate cells: the W after floor(pos - W/2), the only ones
        // with |cell - pos| < W/2 (ops/cuda_gridder.py checks that
        // float32(2/W) rounds up, so the cells either side evaluate to
        // exactly zero), clipped to the patch the TPU kernel holds.
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
        // Lane sl adds column c0 + sl, one row an instruction, with the
        // row's ax from the lane that evaluated it.
        float* column = patch + r0 * stride + (c0 + sl);
#pragma unroll
        for (int i = 0; i < kw; ++i) {
          const float a = __shfl_sync(kFull, ax, first_lane + i);
          if (a != 0.0f && ay != 0.0f) {
            float* cell = column + i * stride;
#pragma unroll
            for (int p = 0; p < G; ++p) {
              // ax * (vis * amp) first, then * ay: the TPU kernel's
              // order.
              atomicAdd(cell + (2 * p) * pcells, a * are[p] * ay);
              atomicAdd(cell + (2 * p + 1) * pcells, a * aim[p] * ay);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // Flush: destination row (ox + r - W) mod N, columns from
  // (oy - W) mod N, in at most two segments (the second only where an
  // edge tile wraps past column N), each walked in 16-byte units of the
  // destination.
  const int b0 = blocks[first];
  const int64_t n = ngrid;
  const int64_t plane = n * n;
  const int64_t ox = block_ox[b0];
  const int64_t d0 = wrap(static_cast<int64_t>(block_oy[b0]) - support, n);
  const int la = static_cast<int>(min(static_cast<int64_t>(patch_y), n - d0));
  const bool shared_rows = (flags & 3) != 0;  // split run or edge tile
  const int ex_lo = shared_rows ? patch_x : patch_x - tile_x;
  const int units = patch_y / 4 + 3;
  for (int it = threadIdx.x; it < 2 * G * patch_x * units;
       it += blockDim.x) {
    const int t = it % units;
    const int r = (it / units) % patch_x;
    const int q = it / (units * patch_x);
    const int64_t row = q * plane + wrap(ox + r - support, n) * n;
    // Segment A: patch columns [0, la) -> destination [d0, d0 + la).
    int64_t a = row + d0;
    int h = static_cast<int>(a & 3);
    int c_lo = 0, c_len = la, u = t;
    const int units_a = (h + la + 3) >> 2;
    if (t >= units_a) {
      // Segment B: patch columns [la, patch_y) -> destination [0, ...).
      a = row;
      h = static_cast<int>(a & 3);
      c_lo = la;
      c_len = patch_y - la;
      u = t - units_a;
      if (c_len <= 0 || u >= ((h + c_len + 3) >> 2)) continue;
    }
    const float* src = patch + q * pcells + r * stride;
    float v[4];
    bool whole = true, nonzero = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c_lo - h + 4 * u + e;
      const bool in = c >= c_lo && c < c_lo + c_len;
      v[e] = in ? src[c] : 0.0f;
      whole = whole && in;
      nonzero = nonzero || v[e] != 0.0f;
    }
    if (!nonzero) continue;
    float4* dst = reinterpret_cast<float4*>(out + (a - h + 4 * u));
    const float4 val = make_float4(v[0], v[1], v[2], v[3]);
    if (whole && r >= ex_lo && r < tile_x) {
      *dst = val;  // a row of this thread block's tile alone
    } else {
      atomicAdd(dst, val);
    }
  }
}

template <int G, int CS, int W>
cudaError_t launch(const float* xpos, const float* ypos, const float* ws,
                   const float* vis_re, const float* vis_im,
                   const int32_t* block_len, const int32_t* block_ox,
                   const int32_t* block_oy, const int32_t* blocks,
                   const int32_t* chunks, int num_chunks, const float* w_g,
                   float* out, int block, int patch_x, int patch_y,
                   int tile_x, int support, float beta, float inv_half,
                   float inv_whalf, int wstacking, int ngrid,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * G) * patch_x *
                      (patch_y + CS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grid_chunks_kernel<G, CS, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (num_chunks > 0) {
    grid_chunks_kernel<G, CS, W><<<num_chunks, kThreads, smem, stream>>>(
        xpos, ypos, ws, vis_re, vis_im, block_len, block_ox, block_oy,
        blocks, chunks, w_g, out, block, patch_x, patch_y, tile_x, support,
        beta, inv_half, inv_whalf, wstacking, ngrid);
  }
  return cudaGetLastError();
}

// The kernel for this support: unrolled over W = 6 and 8 (the bench and
// production supports), CS = 8 lanes up to W = 8, else 16.
template <int G>
cudaError_t launch_cs(int support, const float* xpos, const float* ypos,
                      const float* ws, const float* vis_re,
                      const float* vis_im, const int32_t* block_len,
                      const int32_t* block_ox, const int32_t* block_oy,
                      const int32_t* blocks, const int32_t* chunks,
                      int num_chunks, const float* w_g, float* out,
                      int block, int patch_x, int patch_y, int tile_x,
                      float beta, float inv_half, float inv_whalf,
                      int wstacking, int ngrid, cudaStream_t stream) {
  auto run = [&](auto kernel_launch) {
    return kernel_launch(xpos, ypos, ws, vis_re, vis_im, block_len, block_ox,
                         block_oy, blocks, chunks, num_chunks, w_g, out,
                         block, patch_x, patch_y, tile_x, support, beta,
                         inv_half, inv_whalf, wstacking, ngrid, stream);
  };
  if (support == 6) return run(launch<G, 8, 6>);
  if (support == 8) return run(launch<G, 8, 8>);
  if (support < 8) return run(launch<G, 8, 0>);
  return run(launch<G, 16, 0>);
}

}  // namespace

// C entry (bound with ctypes by ops/cuda_gridder.py). `out` holds 2G
// zeroed (ngrid, ngrid) float32 planes in the order re_0, im_0, re_1,
// im_1, ...; `chunks` holds num_chunks (first, count, flags) rows over
// `blocks` (flags: 1 = the run is split, 2 = edge tile). Returns the
// CUDA error code of the launch (0 = ok); G other than 1 and 2 returns
// cudaErrorInvalidValue.
extern "C" int cip_grid_planes(
    const float* xpos, const float* ypos, const float* ws,
    const float* vis_re, const float* vis_im, const int32_t* block_len,
    const int32_t* block_ox, const int32_t* block_oy, const int32_t* blocks,
    const int32_t* chunks, int num_chunks, const float* w_g, int group,
    float* out, int block, int patch_x, int patch_y, int tile_x,
    int support, float beta, float inv_half, float inv_whalf, int wstacking,
    int ngrid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch_cs<1>(support, xpos, ypos, ws, vis_re, vis_im, block_len,
                          block_ox, block_oy, blocks, chunks, num_chunks, w_g,
                          out, block, patch_x, patch_y, tile_x, beta,
                          inv_half, inv_whalf, wstacking, ngrid, s);
    case 2:
      return launch_cs<2>(support, xpos, ypos, ws, vis_re, vis_im, block_len,
                          block_ox, block_oy, blocks, chunks, num_chunks, w_g,
                          out, block, patch_x, patch_y, tile_x, beta,
                          inv_half, inv_whalf, wstacking, ngrid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
