// Centred, cropped DFT along the first axis of split (re, im) float32
// arrays: a four-step transform whose two stages are short FFTs run in
// shared memory (kernel B2).
//
// Replaces the Pallas TPU kernel
//   ska_sdp_cip_tpu/ops/fft_pallas.py:_kernel (fft_first_axis_fused),
// including its tiled input mode (tiled=True, the layout that
// pretile_first_axis writes; here csrc/pretile.cu).
//
// What it computes. For n = n1 * n2 rows viewed as x[j1, j2, col]
// (row j1 * n2 + j2) and the exponent sign s (+1 invert, -1 predict):
//   stage 1  y[k1, j2] = sum_j1 e^(i s 2 pi j1 k1 / n1) (-1)^(j1 n2) x[j1, j2]
//   twiddle  z[k1, j2] = y[k1, j2] * T[k1, j2]
//   stage 2  w[k2, k1] = (-1)^(n1 k2 + n / 2)
//                        sum_j2 e^(i s 2 pi j2 k2 / n2) (-1)^j2 z[k1, j2]
// and output row k2 * n1 + k1 - (k2a * n1 + trim0) is kept when it lies
// in [0, size). These are make_fft_plan(shifted=True)'s D1, T and D2
// (ops/fft.py) with their centring signs and constant written out; T is
// read from the twc/tws tables of fused_pass_host_arrays (sign folded,
// (NC, n1, C, 1), j2 = ci * C + c). An in-cropped pass's input holds
// in_rows rows starting at row pad_lo of the covering j1 window
// [j1a, j1a + n1i); every other row of x is zero.
//
// What bounds it on Hopper: bytes. A pass reads its input once, writes
// and reads back the intermediate z, and writes its output: at the
// 15360^2 production grid, m = 15360, out-cropped to 10240 rows, 1.89 +
// 2 x 1.89 + 1.26 = 6.9 GB, at least 2.07 ms at 3.35 TB/s (the input
// and output alone 0.94 ms). The arithmetic is an FFT's, ~5 log2(n)
// flops per complex element and pass, about 1% of the float32 rate in
// that time. The first design (two dense complex products) needed
// n1 + n2 complex MACs per element instead and was bound by float32
// FMA issue.
//
// The design:
// * Stage 1: one block per (j2, 32-column tile); stage 2: one block per
//   (k1, 32-column tile). The block first stages its whole input tile
//   (n rows of 32 columns, re and im: 30 KiB at n1 = 120) into shared
//   memory with cp.async, every 16-byte copy in flight at once, zero-
//   filling rows outside the window or the in-crop pad (the input needs
//   no padding in device memory). A first version read each butterfly's
//   rows straight into registers and so waited on its loads; staging
//   the tile made the pass about 1.6x faster at 15360^2 (PERF.md), and
//   the time left is the streaming of 128-byte row segments, not the
//   FFT.
// * The column is the lane: every warp access to shared memory touches
//   32 consecutive words of one row [row][32 columns], so no butterfly
//   stride has bank conflicts, and the last pass writes device memory
//   from registers as 128-byte row segments (stage 1 multiplies by T
//   and writes z; stage 2 applies its signs and writes only the rows
//   inside the crop). The 8 warps share the butterflies of a pass.
// * A sub-FFT longer than 454 does not fit two 32-column buffers in the
//   227 KiB of shared memory a block may have; its stage runs on 16, 8
//   or 4 columns a block (ops/fft_cuda.py:sub_fft_columns), groups of
//   that many threads sharing the butterflies, up to a length of 3632.
//   The planner meets such lengths only above a 206,116-row grid, or at
//   a grid with no divisor near its square root (156,250 = 250 x 625).
// * Each sub-FFT (length n1 or n2) is a Stockham autosort FFT with
//   radix-8, 4, 2, 3, 5 and 7 passes (ops/fft_cuda.py:sub_fft_radices;
//   n1 = 120 is 8 x 3 x 5, n2 = 128 is 8 x 8 x 2); pass p reads shared
//   buffer p % 2 and writes the other (61 KiB a block at n = 120, three
//   blocks an SM).
// * The twiddles between passes come from a host table built in float64
//   and rounded to float32 (ops/fft_cuda.py:sub_fft_twiddles, n - 1
//   entries per sub-FFT); the lanes of a warp read the same entry, one
//   broadcast load. The radix-3, 5, 7 butterfly constants are float64
//   values rounded to float32 as literals; radix 2, 4 and 8 multiply by
//   +-1, +-i and sqrt(1/2) only.
// * Two launches, not one: stage 2 needs every j2 of a column, which
//   stage-1 blocks all over the card produce. A single launch would hold
//   a column tile's n values in the distributed shared memory of a
//   thread-block cluster (later work, ROADMAP).
// * On the single-device invert and predict B2 runs one pass of each
//   plane's 2-D transform, along axis 0; the other runs along the last
//   axis in B2L (csrc/fft_last_axis.cu: the same arithmetic from this
//   kernel's stage code, with the w-screen and the image accumulation
//   in its loads and stores), so no plane is transposed. The TPU kernel
//   ran both passes along axis 0 with a transpose between them; the
//   distributed mode still does (ROADMAP).
//
// Tiled input: stage 1 reads the same values from B6's layout
// (NC, m / MB, n1i, C, MB), MB = 128, through a second base and row
// stride; the arithmetic and its order are the row-major pass's, so the
// two give equal results bit for bit.

// The stage code (staging, radix passes, each stage's input and output,
// the two stage kernels, the pass geometry, the launch) lives in
// fft_stages.cuh, which the probes of this kernel (fft_probes.cu)
// share; this file launches the stage kernels (run_pass).
#include "fft_stages.cuh"

namespace {

int run_pass(const float* re, const float* im, const float* twc,
             const float* tws, const float* tw1, const float* tw2,
             float* z_re, float* z_im, float* out_re, float* out_im, int n1,
             int n2, int c, int j1a, int n1i, int pad_lo, int64_t in_rows,
             int k2a, int trim0, int size, int sign, int64_t radices1,
             int64_t radices2, int cols1, int cols2, int num_mb, int64_t m,
             void* stream) {
  Pass p{};
  if (!fill_pass(p, re, im, tw1, tw2, z_re, z_im, n1, n2, c, j1a, n1i,
                 pad_lo, in_rows, k2a, trim0, size, sign, radices1, radices2,
                 cols1, cols2, num_mb, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b1 = static_cast<unsigned>(n2), b2 = static_cast<unsigned>(n1);
  const float* zr = z_re;
  const float* zi = z_im;
  cudaError_t err;
  switch (cols1) {
    case 32: err = launch<32>(stage1_kernel<32>, p.f1, b1, m, s, p, re, im,
                              twc, tws, z_re, z_im);
             break;
    case 16: err = launch<16>(stage1_kernel<16>, p.f1, b1, m, s, p, re, im,
                              twc, tws, z_re, z_im);
             break;
    case 8: err = launch<8>(stage1_kernel<8>, p.f1, b1, m, s, p, re, im, twc,
                            tws, z_re, z_im);
            break;
    default: err = launch<4>(stage1_kernel<4>, p.f1, b1, m, s, p, re, im,
                             twc, tws, z_re, z_im);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cols2) {
    case 32: err = launch<32>(stage2_kernel<32>, p.f2, b2, m, s, p, zr, zi,
                              out_re, out_im);
             break;
    case 16: err = launch<16>(stage2_kernel<16>, p.f2, b2, m, s, p, zr, zi,
                              out_re, out_im);
             break;
    case 8: err = launch<8>(stage2_kernel<8>, p.f2, b2, m, s, p, zr, zi,
                            out_re, out_im);
            break;
    default: err = launch<4>(stage2_kernel<4>, p.f2, b2, m, s, p, zr, zi,
                             out_re, out_im);
  }
  return static_cast<int>(err);
}

}  // namespace

// C entries (bound with ctypes by ops/fft_cuda.py). Inputs re/im are
// the pass's (in_rows, m) row-major float32 rows (in_rows = n1i * n2,
// or the in-cropped image's rows, placed at row pad_lo of the window),
// or, for the tiled entry, B6's (NC, m / mb, n1i, C, mb) layout of the
// whole window; twc/tws as fused_pass_host_arrays; tw1/tw2 the sub-FFT
// twiddle tables and radices1/radices2 the packed radix passes of n1
// and n2 (ops/fft_cuda.py:fused_pass_kernel_arrays, sub_fft_radices);
// cols1/cols2 each stage's columns per block, 32, 16, 8 or 4
// (ops/fft_cuda.py:sub_fft_columns); z_re/z_im are (n1 * n2, m)
// scratch; out_re/out_im are (size, m).
// Return the CUDA error code (0 = ok).
extern "C" int cip_fft_first_axis_fused(
    const float* re, const float* im, const float* twc, const float* tws,
    const float* tw1, const float* tw2, float* z_re, float* z_im,
    float* out_re, float* out_im, int n1, int n2, int c, int j1a, int n1i,
    int pad_lo, int64_t in_rows, int k2a, int trim0, int size, int sign,
    int64_t radices1, int64_t radices2, int cols1, int cols2, int64_t m,
    void* stream) {
  return run_pass(re, im, twc, tws, tw1, tw2, z_re, z_im, out_re, out_im, n1,
                  n2, c, j1a, n1i, pad_lo, in_rows, k2a, trim0, size, sign,
                  radices1, radices2, cols1, cols2, 0, m, stream);
}

extern "C" int cip_fft_first_axis_fused_tiled(
    const float* re, const float* im, const float* twc, const float* tws,
    const float* tw1, const float* tw2, float* z_re, float* z_im,
    float* out_re, float* out_im, int n1, int n2, int c, int j1a, int n1i,
    int pad_lo, int64_t in_rows, int k2a, int trim0, int size, int sign,
    int64_t radices1, int64_t radices2, int cols1, int cols2, int mb,
    int64_t m, void* stream) {
  if (mb != kTiledMB || m % mb != 0 || pad_lo != 0 ||
      in_rows != static_cast<int64_t>(n1i) * n2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_pass(re, im, twc, tws, tw1, tw2, z_re, z_im, out_re, out_im, n1,
                  n2, c, j1a, n1i, pad_lo, in_rows, k2a, trim0, size, sign,
                  radices1, radices2, cols1, cols2, static_cast<int>(m / mb),
                  m, stream);
}
