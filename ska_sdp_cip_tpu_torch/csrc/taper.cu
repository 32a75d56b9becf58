// The image-domain taper maps of the invert and the predict (kernel T1):
//   inv_corr[i, j] = 1 / (c(l_i) c(l_j) c(dw (n_ij - 1 - n_mid)) n_ij)
//   nm1s[i, j]     = n_ij - 1 - n_mid
// with c the ES kernel's Fourier-domain correction by its quadrature
// rule, c(k) = support * sum_q cos(pi support k node_q) folded_q, and
// without w-stacking inv_corr = 1 / (c(l_i) c(l_j)).
//
// Replaces no TPU kernel: the JAX package builds the maps with XLA
// inside its jitted invert and predict (ska_sdp_cip_tpu/ops/gridder.py:
// _geometry_maps). The port's plain version (ska_sdp_cip_tpu_torch/
// ops/gridder.py:_geometry_maps_reference) does the same in PyTorch:
// (rows, npix, Q) tensors of angles, cosines and products, ~1 GiB each
// a slab, and seven more npix^2 passes; 39 ms a map pair at 10240 px
// on an H100.
//
// What bounds it on Hopper: the cosines. The maps are 8 npix^2 bytes,
// written once (0.25 ms at 10240 px at 3.35 TB/s); a pixel takes Q = 24
// (support 8) precise cosf, some 25 instructions each: 2.5e9 cosines,
// ~1.9 ms at the FP32 rate, evaluated one pixel at a time, a quarter
// of that mirrored (below), an eighth for the octant l <-> m leaves,
// the least the maps need (then the bytes bound them). On an H100 at
// 10240 px: 0.88 ms a map pair mirrored, 2.93 ms one pixel at a time,
// the plain version 37.8 ms.
//
// Design:
//   * one launch (taper_axis_kernel) works out c(l) for the npix image
//     coordinates into a scratch vector; the second (taper_maps_kernel)
//     writes both maps, reading the quadrature rule from shared memory;
//   * the maps are even in l and in m: pixels (+-a, +-b) have the same
//     r2 = l^2 + m^2 bit for bit ((-x)^2 == x^2 in float), so the same
//     n - 1 and c_w. With kMirror a thread evaluates the pixel of
//     magnitudes (a, b) once and stores it at up to four places, each
//     with its own c(l_i) c(l_j) product, so every stored value has the
//     bits of the one-pixel-at-a-time evaluation (kMirror false): a
//     quarter of the cosines. A warp's 32 columns b..b+31 are stored
//     at h + b.. ascending and at h - b.. descending, both coalesced;
//   * the arithmetic is the plain version's, operation for operation
//     (each product, sum, square root and division rounded as PyTorch's
//     CUDA kernels round them; no contraction into fused multiply-adds
//     outside the quadrature sum), so T1 differs from the plain version
//     on the card only in the order of that sum: four accumulators of
//     fused multiply-adds, added in pairs. k = pix / ngrid is formed as
//     pix * fl(1 / ngrid), which is how PyTorch's CUDA division by a
//     scalar computes it;
//   * offsets are 64-bit; the grid is 2-D, one thread per pixel or per
//     magnitude pair, so no npix the planner makes overflows it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNodes = 64;  // a multiple of 4
constexpr int kAxisThreads = 256;
constexpr int kCols = 128;
constexpr int kRows = 2;

// The quadrature rule, zero-padded to a multiple of 4 nodes (a padded
// node adds fmaf(cos(0), 0, acc) == acc).
struct Rule {
  float node[kMaxNodes];
  float folded[kMaxNodes];
};

__device__ __forceinline__ void load_rule(Rule& rule, const float* nodes,
                                          const float* folded, int nq,
                                          int nq4) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int q = tid; q < nq4; q += blockDim.x * blockDim.y) {
    rule.node[q] = q < nq ? nodes[q] : 0.0f;
    rule.folded[q] = q < nq ? folded[q] : 0.0f;
  }
}

// c(k) = support * sum_q cos((ang * k) * node_q) * folded_q, with
// ang = float(pi * support).
__device__ __forceinline__ float correction(float k, const Rule& rule,
                                            int nq4, float ang,
                                            float support) {
  const float ak = __fmul_rn(ang, k);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int q = 0; q < nq4; q += 4) {
    a0 = fmaf(cosf(__fmul_rn(ak, rule.node[q])), rule.folded[q], a0);
    a1 = fmaf(cosf(__fmul_rn(ak, rule.node[q + 1])), rule.folded[q + 1], a1);
    a2 = fmaf(cosf(__fmul_rn(ak, rule.node[q + 2])), rule.folded[q + 2], a2);
    a3 = fmaf(cosf(__fmul_rn(ak, rule.node[q + 3])), rule.folded[q + 3], a3);
  }
  return __fmul_rn(support, __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)));
}

// cuv[c] = c((c - npix / 2) * inv_ngrid).
__global__ void __launch_bounds__(kAxisThreads)
taper_axis_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ folded, int nq, int nq4,
                  float* __restrict__ cuv, int npix, float inv_ngrid,
                  float ang, float support) {
  __shared__ Rule rule;
  load_rule(rule, nodes, folded, nq, nq4);
  __syncthreads();
  const int c = blockIdx.x * kAxisThreads + threadIdx.x;
  if (c >= npix) return;
  const float pix = static_cast<float>(c - npix / 2);
  cuv[c] = correction(__fmul_rn(pix, inv_ngrid), rule, nq4, ang, support);
}

struct Pixel {
  float nm1s;  // n - 1 - n_mid
  float n;     // (n - 1) + 1
  float cw;    // c(dw (n - 1 - n_mid)), 1 without w-stacking
};

// One pixel's w-part from its two axis coordinates.
__device__ __forceinline__ Pixel pixel(float ax_row, float ax_col,
                                       const Rule& rule, int nq4, float ang,
                                       float support, float dw, float n_mid,
                                       bool wstacking) {
  const float r2 = __fadd_rn(__fmul_rn(ax_row, ax_row),
                             __fmul_rn(ax_col, ax_col));
  const float root = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, r2), 0.0f));
  const float nm1 = __fdiv_rn(-r2, __fadd_rn(1.0f, root));
  Pixel p;
  p.nm1s = __fsub_rn(nm1, n_mid);
  p.n = __fadd_rn(nm1, 1.0f);
  p.cw = wstacking
             ? correction(__fmul_rn(dw, p.nm1s), rule, nq4, ang, support)
             : 1.0f;
  return p;
}

// inv_corr = 1 / ((c(l_row) c(l_col)) c_w n), in the plain version's
// order.
__device__ __forceinline__ void store(float* __restrict__ inv_corr,
                                      float* __restrict__ nm1s,
                                      const float* __restrict__ cuv,
                                      int64_t row, int64_t col, int64_t npix,
                                      const Pixel& p, bool wstacking) {
  float corr = __fmul_rn(cuv[row], cuv[col]);
  if (wstacking) corr = __fmul_rn(__fmul_rn(corr, p.cw), p.n);
  const int64_t at = row * npix + col;
  inv_corr[at] = __frcp_rn(corr);
  nm1s[at] = p.nm1s;
}

// kMirror: thread (b, a) takes the magnitudes a (row) and b (column),
// 0 <= a, b <= h = npix / 2, and stores the pixels (h +- a, h +- b)
// that lie in the image. Else thread (col, row) takes one pixel.
template <bool kMirror>
__global__ void __launch_bounds__(kCols * kRows)
taper_maps_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ folded, int nq, int nq4,
                  const float* __restrict__ cuv,
                  float* __restrict__ inv_corr, float* __restrict__ nm1s,
                  int npix, float pixel_size, float ang, float support,
                  float dw, float n_mid, int wstacking) {
  __shared__ Rule rule;
  load_rule(rule, nodes, folded, nq, nq4);
  __syncthreads();
  const int x = blockIdx.x * kCols + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  const int h = npix / 2;
  const int extent = kMirror ? h + 1 : npix;
  if (x >= extent || y >= extent) return;
  // |pix| of the row and the column: (-p) * s == -(p * s) exactly.
  const int a = kMirror ? y : abs(y - h);
  const int b = kMirror ? x : abs(x - h);
  const bool ws = wstacking != 0;
  const Pixel p = pixel(__fmul_rn(static_cast<float>(a), pixel_size),
                        __fmul_rn(static_cast<float>(b), pixel_size), rule,
                        nq4, ang, support, dw, n_mid, ws);
  const int64_t n = npix;
  if (!kMirror) {
    store(inv_corr, nm1s, cuv, y, x, n, p, ws);
    return;
  }
  const int rows[2] = {h + a, h - a};
  const int cols[2] = {h + b, h - b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if ((i == 1 && a == 0) || rows[i] >= npix) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if ((j == 1 && b == 0) || cols[j] >= npix) continue;
      store(inv_corr, nm1s, cuv, rows[i], cols[j], n, p, ws);
    }
  }
}

}  // namespace

// C entry (bound with ctypes by ops/taper_cuda.py). nodes and folded
// hold nq <= 64 float32 values; cuv is scratch of npix floats;
// inv_corr and nm1s are npix x npix row-major. ang = float(pi *
// support), inv_ngrid = float(1) / float(ngrid). Returns the CUDA error
// code (0 = ok).
extern "C" int cip_taper_maps(const float* nodes, const float* folded,
                              int nq, float* cuv, float* inv_corr,
                              float* nm1s, int npix, float inv_ngrid,
                              float pixel_size, float ang, float support,
                              float dw, float n_mid, int wstacking,
                              int mirror, void* stream) {
  if (nq <= 0 || nq > kMaxNodes || npix <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq4 = (nq + 3) / 4 * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  taper_axis_kernel<<<(npix + kAxisThreads - 1) / kAxisThreads,
                      kAxisThreads, 0, s>>>(nodes, folded, nq, nq4, cuv,
                                            npix, inv_ngrid, ang, support);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int extent = mirror ? npix / 2 + 1 : npix;
  const dim3 block(kCols, kRows);
  const dim3 grid((extent + kCols - 1) / kCols, (extent + kRows - 1) / kRows);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  if (mirror) {
    taper_maps_kernel<true><<<grid, block, 0, s>>>(
        nodes, folded, nq, nq4, cuv, inv_corr, nm1s, npix, pixel_size, ang,
        support, dw, n_mid, wstacking);
  } else {
    taper_maps_kernel<false><<<grid, block, 0, s>>>(
        nodes, folded, nq, nq4, cuv, inv_corr, nm1s, npix, pixel_size, ang,
        support, dw, n_mid, wstacking);
  }
  return static_cast<int>(cudaGetLastError());
}
