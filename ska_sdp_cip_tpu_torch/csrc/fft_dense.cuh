// The first design of kernel B2: the four-step first-axis DFT as two
// dense float32 complex products (stage 1 + twiddle, then stage 2 +
// crop), one register-tiled product per launch. csrc/fft_fused.cu
// replaced it with shared-memory FFT stages; csrc/fft_probes.cu keeps
// it as the base of the probes P1 and P2, which measure the design the
// TPU probes measured.
//
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
// The input of stage 1 is the (n1i * n2, m) zero-padded window.
//
// What bounds it on Hopper: float32 FMA issue. Each stage is a complex
// matrix product with a small (n1 or n2) contraction, batched over n2
// (or n1) and the columns: 4 real FMAs per complex MAC, 64 x 64 output
// tiles, 4 x 4 complex outputs per thread, ragged edges masked to zero.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;  // output rows per block
constexpr int kTN = 64;  // output columns per block
constexpr int kTK = 16;  // contraction chunk
constexpr int kThreads = 256;

using ATile = float[kTM + 1];  // one k row of the factor tile
using BTile = float[kTN];      // one k row of the input tile

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
  // Input element (row j * n2 + b, col) of the row-major (n1i n2, m).
  __device__ int64_t in_offset(int b, int j, int64_t col, int64_t m) const {
    return (static_cast<int64_t>(j) * n2 + b) * m + col;
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
  __device__ int64_t in_offset(int b, int j, int64_t col, int64_t m) const {
    return (static_cast<int64_t>(b) * n2 + j) * m + col;
  }
  __device__ void post(int, int, float&, float&) const {}
  __device__ int64_t out_row(int i, int b) const {
    const int64_t r = static_cast<int64_t>(i) * n1 + b - trim0;
    return (r >= 0 && r < size) ? r : -1;
  }
};

// Factor tile (kTM x kTK, stored k-major) and input tile (kTK x kTN,
// coalesced along columns) of contraction chunk k0, zero outside.
template <class Stage>
__device__ __forceinline__ void load_chunk(
    const Stage& st, const float* __restrict__ in_re,
    const float* __restrict__ in_im, int64_t m, int64_t col0, int row0,
    int batch, int k0, ATile* a_re, ATile* a_im, BTile* b_re, BTile* b_im) {
  const int tid = threadIdx.x;
  const int rows = st.rows();
  const int depth = st.depth();
#pragma unroll
  for (int l = 0; l < (kTM * kTK) / kThreads; ++l) {
    const int e = tid + l * kThreads;
    const int i = e / kTK;
    const int k = e - i * kTK;
    const bool ok = (row0 + i < rows) && (k0 + k < depth);
    a_re[k][i] = ok ? st.f_re(row0 + i, k0 + k) : 0.0f;
    a_im[k][i] = ok ? st.f_im(row0 + i, k0 + k) : 0.0f;
  }
#pragma unroll
  for (int l = 0; l < (kTK * kTN) / kThreads; ++l) {
    const int e = tid + l * kThreads;
    const int k = e / kTN;
    const int cc = e - k * kTN;
    const bool ok = (k0 + k < depth) && (col0 + cc < m);
    const int64_t off = ok ? st.in_offset(batch, k0 + k, col0 + cc, m) : 0;
    b_re[k][cc] = ok ? in_re[off] : 0.0f;
    b_im[k][cc] = ok ? in_im[off] : 0.0f;
  }
}

// acc += A^T B over one chunk (complex), 4 x 4 outputs per thread.
__device__ __forceinline__ void mac_chunk(ATile* a_re, ATile* a_im,
                                          BTile* b_re, BTile* b_im,
                                          float (&acc_re)[4][4],
                                          float (&acc_im)[4][4]) {
  const int tx = threadIdx.x % 16;  // column group: cols tx + 16 * u
  const int ty = threadIdx.x / 16;  // row group: rows ty + 16 * v
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
}

__device__ __forceinline__ void zero_acc(float (&acc_re)[4][4],
                                         float (&acc_im)[4][4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc_re[v][u] = 0.0f;
      acc_im[v][u] = 0.0f;
    }
  }
}

// out[out_row(i, batch), col] = post(acc) for the thread's outputs.
template <class Stage>
__device__ __forceinline__ void store_tile(const Stage& st,
                                           float* __restrict__ out_re,
                                           float* __restrict__ out_im,
                                           int64_t m, int64_t col0, int row0,
                                           int batch, float (&acc_re)[4][4],
                                           float (&acc_im)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int rows = st.rows();
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

// out[out_row(i, b), col] = post(sum_j F[i, j] * in[(b, j), col])
// for i < rows(), col < m; grid = (col tiles, row tiles, batch).
template <class Stage>
__global__ void __launch_bounds__(kThreads)
cgemm_rows(Stage st, const float* __restrict__ in_re,
           const float* __restrict__ in_im, float* __restrict__ out_re,
           float* __restrict__ out_im, int64_t m) {
  __shared__ float a_re[kTK][kTM + 1], a_im[kTK][kTM + 1];
  __shared__ float b_re[kTK][kTN], b_im[kTK][kTN];

  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTN;
  const int row0 = blockIdx.y * kTM;
  const int batch = blockIdx.z;
  float acc_re[4][4], acc_im[4][4];
  zero_acc(acc_re, acc_im);
  for (int k0 = 0; k0 < st.depth(); k0 += kTK) {
    load_chunk(st, in_re, in_im, m, col0, row0, batch, k0, a_re, a_im, b_re,
               b_im);
    __syncthreads();
    mac_chunk(a_re, a_im, b_re, b_im, acc_re, acc_im);
    __syncthreads();
  }
  store_tile(st, out_re, out_im, m, col0, row0, batch, acc_re, acc_im);
}

inline dim3 gemm_grid(int rows, int batch, int64_t m) {
  return dim3(static_cast<unsigned>((m + kTN - 1) / kTN),
              static_cast<unsigned>((rows + kTM - 1) / kTM),
              static_cast<unsigned>(batch));
}

template <class Stage>
cudaError_t launch(const Stage& st, int rows, int batch,
                   const float* in_re, const float* in_im, float* out_re,
                   float* out_im, int64_t m, cudaStream_t stream) {
  cgemm_rows<Stage><<<gemm_grid(rows, batch, m), kThreads, 0, stream>>>(
      st, in_re, in_im, out_re, out_im, m);
  return cudaGetLastError();
}

// The whole pass: stage1() launches stage 1 of the geometry s1 (it
// writes z), then stage 2 + crop reads z. The probes pass their own
// stage-1 launches.
template <class Launch1>
cudaError_t launch_pass(Launch1 stage1, const Stage1& s1, const float* m2,
                        const float* z_re, const float* z_im, float* out_re,
                        float* out_im, int qb, int qs, int trim0, int size,
                        int64_t m, cudaStream_t s) {
  const cudaError_t err = stage1();
  if (err != cudaSuccess) return err;
  const Stage2 s2{m2, s1.n1, s1.n2, s1.c, qb, qs, trim0, size};
  return launch(s2, qb * qs, s1.n1, z_re, z_im, out_re, out_im, m, s);
}

}  // namespace
