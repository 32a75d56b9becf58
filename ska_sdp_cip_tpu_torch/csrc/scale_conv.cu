// The scale convolutions of the multiscale minor cycle (kernel S1): one
// image's S scale frames in one launch,
//   frames[s, pad + i, pad + j]
//       = sum_{a,b} f_s[a] f_s[b] image[i + a - r, j + b - r]
// (a SAME cross-correlation, zero outside the image), each frame in a
// zero margin of `pad` cells on every side.
//
// Replaces no TPU kernel: the JAX package leaves the convolutions to XLA
// (ska_sdp_cip_tpu/models/multiscale.py:_conv_same, lax.conv), and the
// port called cuDNN's conv2d with the full (2r + 1)^2 kernel, 4,489 taps
// a pixel at r = 33 for every scale, the delta of scale 0 included: four
// 10240^2 convolutions in ~0.81 s on an H100. The scale kernels are
// Gaussians truncated to a square window and normalised by their sum,
// which is the outer product f (x) f of a 1-D factor
// (models/multiscale.py:scale_factors derives f and refuses a kernel that
// is not), so the same operator is two passes of 2r + 1 taps each.
//
// What bounds it on Hopper: the FP32 multiply-adds. At 10240 px, S = 4,
// r = 33 the residual read once and the frames written once are ~2.8 GB
// (~0.85 ms at 3.35 TB/s); the passes take ~6.7e10 FMAs (~2.0 ms at
// 67 TFLOP/s), and shared memory must feed them without becoming the
// limit.
//
// Design:
//   * one block per (tile x tile) output tile, 256 threads; it stages the
//     tile's input with a halo of R = ksize / 2 (+ kValues of slack) once,
//     4-byte cp.async with zero fill outside the image (the SAME padding;
//     nothing is padded in device memory), row-major: in[y][x];
//   * for each scale, a row pass into a shared intermediate mid[x][y]
//     (column-major) of (tile + 2r) rows, then a column pass whose outputs
//     stay in registers and are stored straight into frame s at
//     (pad + i, pad + j), a warp's 32 neighbouring columns at a time
//     (coalesced); both passes slide a window of 2 kValues values in
//     registers along their own contiguous axis, so each shared value
//     loaded serves kValues multiply-adds at a fixed offset, and read the
//     taps as broadcast float4;
//   * the strides make every shared access of a warp touch 32 different
//     banks: in's is odd (a row pass's lanes take neighbouring rows), and
//     mid's is 4 modulo 8 so that the column pass, whose lanes take
//     neighbouring columns, reads its window as float4;
//   * each scale runs over its own radius: the block trims the factor's
//     zero taps at both ends (exactly zero in float32, so the sums are
//     unchanged), and a factor of one tap (scale 0's delta) is a scaled
//     copy, so scale 0's frame equals the image bit for bit;
//   * mirrored taps are not paired: f[r - k] (x + y) takes an add and a
//     multiply-add, as many instructions as two multiply-adds;
//   * blocks past the tiles write the frames' zero margins, so the frames
//     need no zeroing beforehand; S1 allocates nothing;
//   * offsets into the frames are 64-bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kValues = 8;  // outputs a thread keeps in registers
constexpr int kMaxScales = 8;
constexpr int kMarginRows = 16;  // frame rows a margin block zeroes

struct Geometry {
  int rows, cols;  // the image
  int num_scales, ksize, radius;  // radius R = ksize / 2
  int pad;
  int tile;  // a multiple of 32
  int tiles_x, num_tiles;
  int extent;      // staged square: tile + 2 R + kValues
  int in_stride;   // extent, made odd
  int taps_len;    // ksize rounded up to kValues
  int mid_stride;  // tile + taps_len, rounded up to 4 modulo 8
  int64_t frame_rows, frame_cols;
};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The least multiple of 4 >= n that is not a multiple of 8: float4 rows
// at this stride start in 8 different bank quads.
inline int quad_odd(int n) {
  const int m = round_up(n, 4);
  return m % 8 ? m : m + 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// kValues consecutive floats from shared memory into w, as two float4
// where src is 16-byte aligned (kVec).
template <bool kVec>
__device__ __forceinline__ void load_window(const float* src, float* w) {
  if (kVec) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else {
#pragma unroll
    for (int o = 0; o < kValues; ++o) w[o] = src[o];
  }
}

// acc[o] = sum_{k < n} taps[k] src[o + k] for o < kValues; n is a
// multiple of kValues, and src is finite up to n + kValues - 1.
template <bool kVec>
__device__ __forceinline__ void slide(const float* src, const float* taps,
                                      int n, float (&acc)[kValues]) {
  float w[2 * kValues];
#pragma unroll
  for (int o = 0; o < kValues; ++o) acc[o] = 0.0f;
  load_window<kVec>(src, w);
#pragma unroll 2
  for (int k0 = 0; k0 < n; k0 += kValues) {
    load_window<kVec>(src + k0 + kValues, w + kValues);
    const float4 t0 = *reinterpret_cast<const float4*>(taps + k0);
    const float4 t1 = *reinterpret_cast<const float4*>(taps + k0 + 4);
    const float t[kValues] = {t0.x, t0.y, t0.z, t0.w,
                              t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int kk = 0; kk < kValues; ++kk) {
#pragma unroll
      for (int o = 0; o < kValues; ++o) {
        acc[o] = fmaf(t[kk], w[o + kk], acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < kValues; ++o) w[o] = w[kValues + o];
  }
}

// Zero kMarginRows rows' worth of the frames' margins.
__device__ void zero_margins(float* __restrict__ frames, const Geometry& g,
                             int block) {
  const int64_t total = g.num_scales * g.frame_rows;
  const int64_t first = static_cast<int64_t>(block) * kMarginRows;
  const int64_t last = first + kMarginRows < total ? first + kMarginRows
                                                   : total;
  for (int64_t fr = first; fr < last; ++fr) {
    const int64_t y = fr % g.frame_rows;
    float* row = frames + fr * g.frame_cols;
    if (y < g.pad || y >= g.pad + g.rows) {
      for (int64_t c = threadIdx.x; c < g.frame_cols; c += kThreads) {
        row[c] = 0.0f;
      }
    } else {
      float* right = row + g.pad + g.cols;
      for (int c = threadIdx.x; c < g.pad; c += kThreads) {
        row[c] = 0.0f;
        right[c] = 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
scale_conv_kernel(const float* __restrict__ image,
                  const float* __restrict__ factors,
                  float* __restrict__ frames, Geometry g) {
  if (static_cast<int>(blockIdx.x) >= g.num_tiles) {
    zero_margins(frames, g, blockIdx.x - g.num_tiles);
    return;
  }
  extern __shared__ float4 smem4[];
  int* radius = reinterpret_cast<int*>(smem4);
  float* taps = reinterpret_cast<float*>(smem4) + kMaxScales;
  float* mid = taps + g.num_scales * g.taps_len;
  float* in = mid + g.tile * g.mid_stride;

  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / g.tiles_x) * g.tile;
  const int j0 = (blockIdx.x % g.tiles_x) * g.tile;
  const int R = g.radius;

  // The input square, rows i0 - R + y and columns j0 - R + x, at
  // in[y][x]; zero outside the image.
  const int warp = tid / 32, lane = tid % 32;
  for (int y = warp; y < g.extent; y += kThreads / 32) {
    const int gi = i0 - R + y;
    const bool row_in = gi >= 0 && gi < g.rows;
    for (int x = lane; x < g.extent; x += 32) {
      const int gj = j0 - R + x;
      const bool inside = row_in && gj >= 0 && gj < g.cols;
      const float* src =
          inside ? image + static_cast<int64_t>(gi) * g.cols + gj : image;
      cp_async4(in + y * g.in_stride + x, src, inside);
    }
  }

  // Each scale's radius (its outermost nonzero tap) and its taps, trimmed
  // to 2 r + 1 and zero-padded to a multiple of kValues; the raw factors
  // pass through mid, which is free until the first row pass.
  const int nf = g.num_scales * g.ksize;
  if (tid < kMaxScales) radius[tid] = 0;
  for (int e = tid; e < nf; e += kThreads) mid[e] = factors[e];
  __syncthreads();
  for (int e = tid; e < nf; e += kThreads) {
    if (mid[e] != 0.0f) {
      const int s = e / g.ksize;
      atomicMax(&radius[s], abs(e - s * g.ksize - R));
    }
  }
  __syncthreads();
  for (int e = tid; e < g.num_scales * g.taps_len; e += kThreads) {
    const int s = e / g.taps_len;
    const int k = e - s * g.taps_len;
    const int r = radius[s];
    taps[e] = k <= 2 * r ? mid[s * g.ksize + R - r + k] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int groups = g.tile / kValues;
  for (int s = 0; s < g.num_scales; ++s) {
    const int r = radius[s];
    const float* ts = taps + s * g.taps_len;
    float* out = frames + s * g.frame_rows * g.frame_cols +
                 (g.pad + i0) * g.frame_cols + g.pad + j0;
    if (r == 0) {
      // One tap: out = f * x, the image itself for scale 0's delta.
      const float c = ts[0];
      for (int item = tid; item < g.tile * groups; item += kThreads) {
        const int x = item % g.tile;
        const int y0 = item / g.tile * kValues;
        if (j0 + x >= g.cols) continue;
        const float* src = in + (R + y0) * g.in_stride + R + x;
#pragma unroll
        for (int o = 0; o < kValues; ++o) {
          if (i0 + y0 + o < g.rows) {
            out[(y0 + o) * g.frame_cols + x] =
                __fmul_rn(c, src[o * g.in_stride]);
          }
        }
      }
      continue;
    }
    const int n = round_up(2 * r + 1, kValues);
    const int off = R - r;

    // Row pass: mid[x][y] for output columns x < tile and the rows
    // i0 - r + y, y < tile + 2 r; a warp's lanes take neighbouring rows.
    const int mid_rows = g.tile + 2 * r;
    for (int item = tid; item < mid_rows * groups; item += kThreads) {
      const int x0 = item / mid_rows * kValues;
      const int y = item % mid_rows;
      float acc[kValues];
      slide<false>(in + (off + y) * g.in_stride + off + x0, ts, n, acc);
#pragma unroll
      for (int o = 0; o < kValues; ++o) {
        mid[(x0 + o) * g.mid_stride + y] = acc[o];
      }
    }
    // Rows tile + 2 r .. tile + n - 1 meet only zero taps in the column
    // pass, but must be finite.
    const int spare = n - 2 * r;
    for (int e = tid; e < g.tile * spare; e += kThreads) {
      mid[e / spare * g.mid_stride + mid_rows + e % spare] = 0.0f;
    }
    __syncthreads();

    // Column pass: kValues rows of one column a thread, stored by a warp
    // along 32 neighbouring columns.
    for (int item = tid; item < g.tile * groups; item += kThreads) {
      const int x = item % g.tile;
      const int y0 = item / g.tile * kValues;
      float acc[kValues];
      slide<true>(mid + x * g.mid_stride + y0, ts, n, acc);
      if (j0 + x >= g.cols) continue;
#pragma unroll
      for (int o = 0; o < kValues; ++o) {
        if (i0 + y0 + o < g.rows) {
          out[(y0 + o) * g.frame_cols + x] = acc[o];
        }
      }
    }
    __syncthreads();
  }
}

size_t shared_bytes(const Geometry& g) {
  return sizeof(float) *
         (static_cast<size_t>(kMaxScales) + g.num_scales * g.taps_len +
          static_cast<size_t>(g.extent) * g.in_stride +
          static_cast<size_t>(g.tile) * g.mid_stride);
}

}  // namespace

// C entry (bound with ctypes by ops/scale_conv_cuda.py). image is rows x
// cols row-major; factors S x ksize row-major (ksize odd, 1 <= S <= 8);
// frames S x (rows + 2 pad) x (cols + 2 pad), every cell written; tile is
// 32 or 64. Returns the CUDA error code (0 = ok).
extern "C" int cip_scale_conv(const float* image, const float* factors,
                              float* frames, int rows, int cols,
                              int num_scales, int ksize, int pad, int tile,
                              void* stream) {
  if (rows <= 0 || cols <= 0 || num_scales < 1 || num_scales > kMaxScales ||
      ksize < 1 || ksize % 2 == 0 || pad < 0 || (tile != 32 && tile != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.rows = rows;
  g.cols = cols;
  g.num_scales = num_scales;
  g.ksize = ksize;
  g.radius = ksize / 2;
  g.pad = pad;
  g.tile = tile;
  g.tiles_x = (cols + tile - 1) / tile;
  const int64_t tiles =
      static_cast<int64_t>(g.tiles_x) * ((rows + tile - 1) / tile);
  g.extent = tile + 2 * g.radius + kValues;
  g.in_stride = g.extent | 1;
  g.taps_len = round_up(ksize, kValues);
  g.mid_stride = quad_odd(tile + g.taps_len);
  g.frame_rows = rows + 2 * static_cast<int64_t>(pad);
  g.frame_cols = cols + 2 * static_cast<int64_t>(pad);
  const int64_t margin_blocks =
      pad > 0 ? (num_scales * g.frame_rows + kMarginRows - 1) / kMarginRows
              : 0;
  if (tiles + margin_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.num_tiles = static_cast<int>(tiles);

  const size_t smem = shared_bytes(g);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(scale_conv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  scale_conv_kernel<<<static_cast<unsigned>(tiles + margin_blocks), kThreads,
                      smem, s>>>(image, factors, frames, g);
  return static_cast<int>(cudaGetLastError());
}
