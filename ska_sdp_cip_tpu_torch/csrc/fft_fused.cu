// Centred, cropped DFT along the first axis of split (re, im) float32
// arrays, as a four-step transform (kernel B2).
//
// Replaces the Pallas TPU kernel
//   ska_sdp_cip_tpu/ops/fft_pallas.py:_kernel (fft_first_axis_fused).
// For n = n1 * n2 rows viewed as x[j1, j2, col] (row j1 * n2 + j2):
//   stage 1  y[k1, j2] = sum_j1 D1[k1, j1] x[j1, j2]      (complex)
//   twiddle  z[k1, j2] = y[k1, j2] * T[k1, j2]
//   stage 2  out[q, k1] = sum_j2 D2[q, j2] z[k1, j2]       (complex)
// and output row q * n1 + k1 - trim0 is kept when it lies in
// [0, size). The factors are read in the layouts that
// ops/fft_cuda.py:fused_pass_host_arrays emits (float32, sign folded):
//   m1  (2 n1, 2 n1i)          [[C, -sS], [sS, C]]
//   twc, tws (NC, n1, C, 1)    twiddle cos, sign * sin, j2 = ci * C + c
//   m2  (QB, NC, 2 QS, 2 C)    [[C2^T, -sS2^T], [sS2^T, C2^T]] per block
//
// Two launches, not one fused launch: for one column tile, stage 2
// needs stage 1's result for every j2, i.e. n1 * n2 complex values per
// column (4096 * 8 B = 32 KiB per column at the 4096-point bench
// transform). The TPU kernel held an (n1, C, 128-column) chunk and a
// (QS * n1, 128) accumulator in its megabytes of VMEM; within the
// 227 KiB of a Hopper block that leaves a handful of columns per block
// and 16-byte row segments from device memory. So stage 1 + twiddle
// writes z (n1 * n2, m) to device memory and stage 2 + crop reads it
// back: one extra write and read of the input's size (0.27 GB at the
// 4096^2 bench pass, 0.47 GB moved in all).
//
// What bounds it on Hopper: arithmetic. Each stage is a complex
// matrix product with a small (n1 or n2 = 64) contraction, batched over
// n2 (or n1) and over the columns: 4 real FMAs per complex MAC, 6.4 G
// FMAs for the first pass of a 4096^2 grid cropped to 2048 rows.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.79 ms for that pass,
// ~24% of the card's float32 FMA peak. The design: plain float32 FMA
// in a register-tiled product (64 x 64 output tile per block, 4 x 4
// complex outputs per thread, operands staged through shared memory).
// Tensor cores (wgmma with TMA) are later work; plain TF32 would not
// hold the float32 accuracy this pass needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;  // output rows per block
constexpr int kTN = 64;  // output columns per block
constexpr int kTK = 16;  // contraction chunk
constexpr int kThreads = 256;

struct Stage1 {
  // y = M1 x over j1, then * twiddle; batch index = j2.
  const float* m1;
  const float* twc;
  const float* tws;
  int n1, n1i, n2, c;
  __device__ int rows() const { return n1; }
  __device__ int depth() const { return n1i; }
  __device__ float f_re(int i, int j) const { return m1[i * 2 * n1i + j]; }
  __device__ float f_im(int i, int j) const {
    return m1[(n1 + i) * 2 * n1i + j];
  }
  __device__ int64_t in_row(int b, int j) const {
    return static_cast<int64_t>(j) * n2 + b;
  }
  __device__ void post(int i, int b, float& re, float& im) const {
    const int ci = b / c;
    const int idx = (ci * n1 + i) * c + (b - ci * c);
    const float tr = twc[idx];
    const float ti = tws[idx];
    const float yr = re;
    re = yr * tr - im * ti;
    im = yr * ti + im * tr;
  }
  __device__ int64_t out_row(int i, int b) const {
    return static_cast<int64_t>(i) * n2 + b;
  }
};

struct Stage2 {
  // out = M2 z over j2; batch index = k1; rows cropped to [0, size).
  const float* m2;
  int n1, n2, c, qb, qs, trim0, size;
  __device__ int rows() const { return qb * qs; }
  __device__ int depth() const { return n2; }
  __device__ int64_t m2_index(int i, int j, int part) const {
    const int nc = n2 / c;
    const int b = i / qs;
    const int q = i - b * qs;
    const int ci = j / c;
    const int cc = j - ci * c;
    return ((static_cast<int64_t>(b) * nc + ci) * 2 * qs + part * qs + q) *
               (2 * c) +
           cc;
  }
  __device__ float f_re(int i, int j) const { return m2[m2_index(i, j, 0)]; }
  __device__ float f_im(int i, int j) const { return m2[m2_index(i, j, 1)]; }
  __device__ int64_t in_row(int b, int j) const {
    return static_cast<int64_t>(b) * n2 + j;
  }
  __device__ void post(int, int, float&, float&) const {}
  __device__ int64_t out_row(int i, int b) const {
    const int64_t r = static_cast<int64_t>(i) * n1 + b - trim0;
    return (r >= 0 && r < size) ? r : -1;
  }
};

// out[out_row(i, b), col] = post(sum_j F[i, j] * in[in_row(b, j), col])
// for i < rows(), col < m; grid = (col tiles, row tiles, batch).
template <class Stage>
__global__ void __launch_bounds__(kThreads)
cgemm_rows(Stage st, const float* __restrict__ in_re,
           const float* __restrict__ in_im, float* __restrict__ out_re,
           float* __restrict__ out_im, int64_t m) {
  __shared__ float a_re[kTK][kTM + 1], a_im[kTK][kTM + 1];
  __shared__ float b_re[kTK][kTN], b_im[kTK][kTN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: cols tx + 16 * u
  const int ty = tid / 16;  // row group: rows ty + 16 * v
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTN;
  const int row0 = blockIdx.y * kTM;
  const int batch = blockIdx.z;
  const int rows = st.rows();
  const int depth = st.depth();

  float acc_re[4][4], acc_im[4][4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc_re[v][u] = 0.0f;
      acc_im[v][u] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < depth; k0 += kTK) {
    // Factor tile (kTM x kTK), stored k-major.
#pragma unroll
    for (int l = 0; l < (kTM * kTK) / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int i = e / kTK;
      const int k = e - i * kTK;
      const bool ok = (row0 + i < rows) && (k0 + k < depth);
      a_re[k][i] = ok ? st.f_re(row0 + i, k0 + k) : 0.0f;
      a_im[k][i] = ok ? st.f_im(row0 + i, k0 + k) : 0.0f;
    }
    // Input tile (kTK x kTN): row-gathered, coalesced along columns.
#pragma unroll
    for (int l = 0; l < (kTK * kTN) / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int k = e / kTN;
      const int cc = e - k * kTN;
      const bool ok = (k0 + k < depth) && (col0 + cc < m);
      const int64_t off = ok ? st.in_row(batch, k0 + k) * m + col0 + cc : 0;
      b_re[k][cc] = ok ? in_re[off] : 0.0f;
      b_im[k][cc] = ok ? in_im[off] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float ar[4], ai[4], br[4], bi[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        ar[v] = a_re[k][ty + 16 * v];
        ai[v] = a_im[k][ty + 16 * v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        br[u] = b_re[k][tx + 16 * u];
        bi[u] = b_im[k][tx + 16 * u];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc_re[v][u] += ar[v] * br[u] - ai[v] * bi[u];
          acc_im[v][u] += ar[v] * bi[u] + ai[v] * br[u];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int i = row0 + ty + 16 * v;
    if (i >= rows) continue;
    const int64_t r = st.out_row(i, batch);
    if (r < 0) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t col = col0 + tx + 16 * u;
      if (col >= m) continue;
      float re = acc_re[v][u];
      float im = acc_im[v][u];
      st.post(i, batch, re, im);
      out_re[r * m + col] = re;
      out_im[r * m + col] = im;
    }
  }
}

template <class Stage>
cudaError_t launch(const Stage& st, int rows, int batch,
                   const float* in_re, const float* in_im, float* out_re,
                   float* out_im, int64_t m, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kTN - 1) / kTN),
                  static_cast<unsigned>((rows + kTM - 1) / kTM),
                  static_cast<unsigned>(batch));
  cgemm_rows<Stage><<<grid, kThreads, 0, stream>>>(st, in_re, in_im,
                                                   out_re, out_im, m);
  return cudaGetLastError();
}

}  // namespace

// C entry (bound with ctypes by ops/fft_cuda.py). Inputs re/im are
// (n1i * n2, m) row-major float32; z_re/z_im are (n1 * n2, m) scratch;
// out_re/out_im are (size, m). Returns the CUDA error code (0 = ok).
extern "C" int cip_fft_first_axis_fused(
    const float* re, const float* im, const float* m1, const float* twc,
    const float* tws, const float* m2, float* z_re, float* z_im,
    float* out_re, float* out_im, int n1, int n1i, int n2, int c, int qb,
    int qs, int trim0, int size, int64_t m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 0 || n2 % c != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Stage1 s1{m1, twc, tws, n1, n1i, n2, c};
  cudaError_t err = launch(s1, n1, n2, re, im, z_re, z_im, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Stage2 s2{m2, n1, n2, c, qb, qs, trim0, size};
  return static_cast<int>(
      launch(s2, qb * qs, n1, z_re, z_im, out_re, out_im, m, s));
}
