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
// that time. The first design (two dense complex products, now
// csrc/fft_dense.cuh, the probes' base) needed n1 + n2 complex MACs per
// element instead and was bound by float32 FMA issue.
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
//
// Tiled input: stage 1 reads the same values from B6's layout
// (NC, m / MB, n1i, C, MB), MB = 128, through a second base and row
// stride; the arithmetic and its order are the row-major pass's, so the
// two give equal results bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kMaxPasses = 8;
constexpr int kTiledMB = 128;  // column block of B6's tiled layout

// One sub-FFT: its length, radix passes and twiddle table (n - 1
// float2; pass p's twiddle (k, t) at ns_p - 1 + k * (R_p - 1) + t - 1).
struct SubFFT {
  int n;
  int passes;
  int radix[kMaxPasses];
  const float2* tw;
};

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = re;
  re = r * w.x - im * w.y;
  im = r * w.y + im * w.x;
}

// Asynchronous 16-byte (4-byte) copy global -> shared; zero-fills the
// destination and reads nothing when !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Length-4 DFT with exponent sign s, in place on four slots.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1,
                                     float& i1, float& r2, float& i2,
                                     float& r3, float& i3, float s) {
  const float t0r = r0 + r2, t0i = i0 + i2;
  const float t1r = r0 - r2, t1i = i0 - i2;
  const float t2r = r1 + r3, t2i = i1 + i3;
  const float t3r = r1 - r3, t3i = i1 - i3;
  r0 = t0r + t2r;
  i0 = t0i + t2i;
  r2 = t0r - t2r;
  i2 = t0i - t2i;
  r1 = t1r - s * t3i;  // t1 + i s t3
  i1 = t1i + s * t3r;
  r3 = t1r + s * t3i;  // t1 - i s t3
  i3 = t1i - s * t3r;
}

// (cos, sin)(2 pi q / R) for the odd radices, 1 <= q <= (R - 1) / 2:
// float64 values rounded to float32.
template <int R>
__device__ __forceinline__ float2 unit_root(int q) {
  if (R == 3) return make_float2(-0.5f, 0.866025403784438597f);
  if (R == 5) {
    return q == 1 ? make_float2(0.309016994374947452f, 0.951056516295153531f)
                  : make_float2(-0.809016994374947340f, 0.587785252292473248f);
  }
  return q == 1   ? make_float2(0.623489801858733594f, 0.781831482468029809f)
         : q == 2 ? make_float2(-0.222520933956314341f, 0.974927912181823607f)
                  : make_float2(-0.900968867902419015f, 0.433883739117558231f);
}

// y[k] = sum_t a[t] e^(i s 2 pi t k / R), in place.
template <int R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R],
                                    float s) {
  if constexpr (R == 2) {
    const float r = re[0] - re[1], i = im[0] - im[1];
    re[0] += re[1];
    im[0] += im[1];
    re[1] = r;
    im[1] = i;
  } else if constexpr (R == 4) {
    dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3], s);
  } else if constexpr (R == 8) {
    // E[k] = DFT4 of the even slots (left at slot 2k), O[k] of the odd
    // ones (slot 2k + 1); y[k] = E[k] + W^k O[k], y[k + 4] = E[k] - W^k O[k]
    // with W = e^(i s pi / 4).
    dft4(re[0], im[0], re[2], im[2], re[4], im[4], re[6], im[6], s);
    dft4(re[1], im[1], re[3], im[3], re[5], im[5], re[7], im[7], s);
    constexpr float h = 0.707106781186547524f;
    float r = re[3], i = im[3];
    re[3] = h * (r - s * i);  // * h (1 + i s)
    im[3] = h * (i + s * r);
    r = re[5];
    re[5] = -s * im[5];  // * i s
    im[5] = s * r;
    r = re[7];
    i = im[7];
    re[7] = -h * (r + s * i);  // * h (-1 + i s)
    im[7] = h * (s * r - i);
    float yr[8], yi[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      yr[k] = re[2 * k] + re[2 * k + 1];
      yi[k] = im[2 * k] + im[2 * k + 1];
      yr[k + 4] = re[2 * k] - re[2 * k + 1];
      yi[k + 4] = im[2 * k] - im[2 * k + 1];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      re[k] = yr[k];
      im[k] = yi[k];
    }
  } else {
    // Odd R: pair a[q] with a[R - q], y[k] = a[0] + sum_q cos(2 pi q k / R)
    // (a[q] + a[R - q]) + i s sin(2 pi q k / R) (a[q] - a[R - q]).
    constexpr int H = (R - 1) / 2;
    float pr[H], pi[H], mr[H], mi[H];
    float y0r = re[0], y0i = im[0];
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      pr[q - 1] = re[q] + re[R - q];
      pi[q - 1] = im[q] + im[R - q];
      mr[q - 1] = re[q] - re[R - q];
      mi[q - 1] = im[q] - im[R - q];
      y0r += pr[q - 1];
      y0i += pi[q - 1];
    }
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float cr = re[0], ci = im[0], sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int q = 1; q <= H; ++q) {
        int e = (q * k) % R;
        const float sg = e > H ? -1.0f : 1.0f;
        e = e > H ? R - e : e;
        const float2 w = unit_root<R>(e);
        cr += w.x * pr[q - 1];
        ci += w.x * pi[q - 1];
        sr += sg * w.y * mr[q - 1];
        si += sg * w.y * mi[q - 1];
      }
      re[k] = cr - s * si;
      im[k] = ci + s * sr;
      re[R - k] = cr + s * si;
      im[R - k] = ci - s * sr;
    }
    re[0] = y0r;
    im[0] = y0i;
  }
}

// A shared-memory buffer of the block: n rows of C re, then of im.
template <int C>
struct SmemRows {
  float* re;
  float* im;
  int lane;
  __device__ void load(int row, float& r, float& i) const {
    r = re[row * C + lane];
    i = im[row * C + lane];
  }
  __device__ void store(int row, float r, float i) const {
    re[row * C + lane] = r;
    im[row * C + lane] = i;
  }
};

// The staged input tile, read by the first pass with the stage's input
// sign (+-1, exact).
template <int C, class In>
struct SignedRows {
  SmemRows<C> rows;
  const In& in;
  __device__ void load(int row, float& r, float& i) const {
    rows.load(row, r, i);
    if (in.negate(row)) {
      r = -r;
      i = -i;
    }
  }
};

// Stage the block's n input rows of C columns into (re_s, im_s)
// [row][C] with cp.async, all copies in flight at once: 16-byte copies
// when in.vec4 (m % 4 == 0, 16-byte aligned re/im), else 4-byte ones;
// rows and columns outside the input are zero-filled.
template <int C, class In>
__device__ __forceinline__ void fetch_tile(const In& in, int n, float* re_s,
                                           float* im_s) {
  if (in.vec4) {
    constexpr int kQuads = C / 4;
    for (int e = threadIdx.x; e < n * kQuads; e += kThreads) {
      const int row = e / kQuads;
      const int q = (e - row * kQuads) * 4;
      int64_t off;
      const bool ok = in.locate(row, q, off);
      cp_async16(re_s + row * C + q, ok ? in.re + off : in.re, ok);
      cp_async16(im_s + row * C + q, ok ? in.im + off : in.im, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * C; e += kThreads) {
      const int row = e / C;
      const int q = e - row * C;
      int64_t off;
      const bool ok = in.locate(row, q, off);
      cp_async4(re_s + e, ok ? in.re + off : in.re, ok);
      cp_async4(im_s + e, ok ? in.im + off : in.im, ok);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// One Stockham pass of radix R over the block's C columns: butterfly j
// (of n / R) reads rows j + t n / R, multiplies by the twiddles of
// k = j mod ns (ns = product of the earlier radices; none in the first
// pass), runs the length-R DFT and writes rows (j - k) R + k + t ns.
// The kThreads / C groups of C threads share the butterflies.
template <int R, int C, class Src, class Dst>
__device__ __forceinline__ void radix_pass(const Src& src, const Dst& dst,
                                           int n, int ns,
                                           const float2* __restrict__ tw,
                                           float s) {
  const int nb = n / R;
  for (int j = threadIdx.x / C; j < nb; j += kThreads / C) {
    float re[R], im[R];
#pragma unroll
    for (int t = 0; t < R; ++t) src.load(j + t * nb, re[t], im[t]);
    const int k = j % ns;
    if (ns > 1) {
      const float2* w = tw + (ns - 1) + k * (R - 1);
#pragma unroll
      for (int t = 1; t < R; ++t) cmul(re[t], im[t], __ldg(w + t - 1));
    }
    dft<R>(re, im, s);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int t = 0; t < R; ++t) dst.store(base + t * ns, re[t], im[t]);
  }
}

// Pass p of P: the first reads the staged input (buffer 0) with its
// sign, the last writes `out`; pass p reads buffer p % 2 and writes
// buffer (p + 1) % 2.
template <int R, int C, class In, class Out>
__device__ __forceinline__ void any_pass(int p, int passes, const In& in,
                                         const Out& out,
                                         const SmemRows<C>& src,
                                         const SmemRows<C>& dst, int n,
                                         int ns, const float2* tw, float s) {
  const bool first = p == 0, last = p == passes - 1;
  const SignedRows<C, In> input{src, in};
  if (first && last) {
    radix_pass<R, C>(input, out, n, ns, tw, s);
  } else if (first) {
    radix_pass<R, C>(input, dst, n, ns, tw, s);
  } else if (last) {
    radix_pass<R, C>(src, out, n, ns, tw, s);
  } else {
    radix_pass<R, C>(src, dst, n, ns, tw, s);
  }
}

// The length-f.n FFT (exponent sign s) of each of the block's columns,
// from the input `in` (staged into buffer 0 first) to out.store(row).
template <int C, class In, class Out>
__device__ void sub_fft(const SubFFT& f, const In& in, const Out& out,
                        float* smem, float s) {
  const int lane = threadIdx.x % C;
  const int words = f.n * C;
  fetch_tile<C>(in, f.n, smem, smem + words);
  int ns = 1;
  for (int p = 0; p < f.passes; ++p) {
    float* a = smem + (p & 1) * 2 * words;
    float* b = smem + ((p + 1) & 1) * 2 * words;
    const SmemRows<C> src{a, a + words, lane};
    const SmemRows<C> dst{b, b + words, lane};
    const int n = f.n;
    switch (f.radix[p]) {
      case 2: any_pass<2>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
              break;
      case 3: any_pass<3>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
              break;
      case 4: any_pass<4>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
              break;
      case 5: any_pass<5>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
              break;
      case 7: any_pass<7>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
              break;
      default: any_pass<8>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
    }
    ns *= f.radix[p];
    if (p + 1 < f.passes) __syncthreads();
  }
}

// Stage 1's input x[j1, j2, col] of the block's (j2, column tile):
// window row jj = j1 - j1a of column col0 + q at base + jj * stride + q,
// which is input row jj * n2 + j2 - pad_lo; absent outside the window,
// the in_rows rows and the m columns. Its sign is (-1)^(j1 n2).
struct Stage1In {
  const float* re;
  const float* im;
  int64_t base, stride, in_rows, col0, m;
  int j1a, n1i, n2, row0;  // row0 = j2 - pad_lo
  bool odd_n2, vec4;
  __device__ bool locate(int j1, int q, int64_t& off) const {
    const int jj = j1 - j1a;
    const int64_t row = static_cast<int64_t>(jj) * n2 + row0;
    off = base + jj * stride + q;
    return jj >= 0 && jj < n1i && row >= 0 && row < in_rows && col0 + q < m;
  }
  __device__ bool negate(int j1) const { return odd_n2 && (j1 & 1); }
};

// Stage 1's output: z[k1 * n2 + j2, col] = y[k1] * T[k1, j2].
struct Stage1Out {
  float* __restrict__ z_re;
  float* __restrict__ z_im;
  const float* __restrict__ twc;
  const float* __restrict__ tws;
  int64_t base, stride;  // j2 * m + col, n2 * m
  int tw0, c;            // (ci * n1) * C + j2 - ci * C, C
  bool ok;
  __device__ void store(int k1, float r, float i) const {
    const int t = tw0 + k1 * c;
    const float tr = __ldg(twc + t), ti = __ldg(tws + t);
    if (ok) {
      const int64_t off = base + k1 * stride;
      z_re[off] = r * tr - i * ti;
      z_im[off] = r * ti + i * tr;
    }
  }
};

// Stage 2's input: z[k1 * n2 + j2, col0 + q] at base + j2 * m + q, with
// the sign (-1)^j2.
struct Stage2In {
  const float* re;
  const float* im;
  int64_t base, col0, m;  // base = (k1 * n2) * m + col0
  bool vec4;
  __device__ bool locate(int j2, int q, int64_t& off) const {
    off = base + j2 * m + q;
    return col0 + q < m;
  }
  __device__ bool negate(int j2) const { return j2 & 1; }
};

// Stage 2's output: (-1)^(n1 k2 + n / 2) w[k2] at row
// (k2 - k2a) n1 + k1 - trim0 when that lies in [0, size).
struct Stage2Out {
  float* __restrict__ out_re;
  float* __restrict__ out_im;
  int64_t m, col;
  int n1, k1, k2a, trim0, size;
  bool odd_n1, flip, ok;
  __device__ void store(int k2, float r, float i) const {
    const int row = (k2 - k2a) * n1 + k1 - trim0;
    if (!ok || row < 0 || row >= size) return;
    const bool neg = flip != (odd_n1 && (k2 & 1));
    out_re[row * m + col] = neg ? -r : r;
    out_im[row * m + col] = neg ? -i : i;
  }
};

// The geometry of one pass (host-filled, passed by value).
struct Pass {
  SubFFT f1, f2;
  int n1, n2, c, j1a, n1i, pad_lo, k2a, trim0, size;
  int64_t in_rows, m;
  int num_mb;  // m / MB for tiled input, 0 for row-major
  float s;
  bool vec4;   // 16-byte input copies: m % 4 == 0, aligned pointers
};

template <int C>
__global__ void __launch_bounds__(kThreads)
stage1_kernel(Pass p, const float* __restrict__ re,
              const float* __restrict__ im, const float* __restrict__ twc,
              const float* __restrict__ tws, float* __restrict__ z_re,
              float* __restrict__ z_im) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % C;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * C;
  const int64_t col = col0 + lane;
  const int j2 = blockIdx.y;
  const int ci = j2 / p.c;
  const int cc = j2 - ci * p.c;
  Stage1In in{re,   im,    0,     0,     p.in_rows,        col0,
              p.m,  p.j1a, p.n1i, p.n2,  j2 - p.pad_lo,    (p.n2 & 1) != 0,
              p.vec4};
  if (p.num_mb) {
    const int64_t bm = col0 / kTiledMB;
    in.base = ((ci * p.num_mb + bm) * p.n1i * p.c + cc) * kTiledMB +
              (col0 - bm * kTiledMB);
    in.stride = static_cast<int64_t>(p.c) * kTiledMB;
  } else {
    in.base = static_cast<int64_t>(j2 - p.pad_lo) * p.m + col0;
    in.stride = static_cast<int64_t>(p.n2) * p.m;
  }
  const Stage1Out out{z_re, z_im, twc, tws,
                      static_cast<int64_t>(j2) * p.m + col,
                      static_cast<int64_t>(p.n2) * p.m,
                      ci * p.n1 * p.c + cc, p.c, col < p.m};
  sub_fft<C>(p.f1, in, out, smem, p.s);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
stage2_kernel(Pass p, const float* __restrict__ z_re,
              const float* __restrict__ z_im, float* __restrict__ out_re,
              float* __restrict__ out_im) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % C;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * C;
  const int64_t col = col0 + lane;
  const int k1 = blockIdx.y;
  const Stage2In in{z_re, z_im, static_cast<int64_t>(k1) * p.n2 * p.m + col0,
                    col0, p.m, p.vec4};
  const Stage2Out out{out_re, out_im, p.m, col, p.n1, k1, p.k2a, p.trim0,
                      p.size, (p.n1 & 1) != 0,
                      ((p.n1 * p.n2 / 2) & 1) != 0, col < p.m};
  sub_fft<C>(p.f2, in, out, smem, p.s);
}

// Radix passes packed 4 bits each, first pass in the low bits.
bool unpack(int64_t packed, int n, const float* tw, SubFFT& f) {
  f.n = n;
  f.passes = 0;
  f.tw = reinterpret_cast<const float2*>(tw);
  int prod = 1;
  while (packed) {
    const int r = static_cast<int>(packed & 15);
    packed >>= 4;
    if (f.passes == kMaxPasses ||
        !(r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8)) {
      return false;
    }
    f.radix[f.passes++] = r;
    prod *= r;
  }
  return f.passes > 0 && prod == n;
}

// Dynamic shared memory of a sub-FFT on C columns: the staged input,
// and a second buffer when there is more than one pass.
size_t smem_bytes(const SubFFT& f, int c) {
  const int buffers = f.passes < 2 ? 1 : 2;
  return static_cast<size_t>(buffers) * 2 * f.n * c * sizeof(float);
}

template <int C, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const SubFFT& f, unsigned batch, int64_t m,
                   cudaStream_t stream, Args... args) {
  const size_t bytes = smem_bytes(f, C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m + C - 1) / C), batch);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

int run_pass(const float* re, const float* im, const float* twc,
             const float* tws, const float* tw1, const float* tw2,
             float* z_re, float* z_im, float* out_re, float* out_im, int n1,
             int n2, int c, int j1a, int n1i, int pad_lo, int64_t in_rows,
             int k2a, int trim0, int size, int sign, int64_t radices1,
             int64_t radices2, int cols1, int cols2, int num_mb, int64_t m,
             void* stream) {
  Pass p{};
  const auto tile = [](int cols) {
    return cols == 4 || cols == 8 || cols == 16 || cols == 32;
  };
  if (c <= 0 || n2 % c != 0 || (sign != 1 && sign != -1) || m <= 0 ||
      n1i <= 0 || j1a < 0 || j1a + n1i > n1 || !tile(cols1) ||
      !tile(cols2) || (num_mb && kTiledMB % cols1 != 0) ||
      !unpack(radices1, n1, tw1, p.f1) || !unpack(radices2, n2, tw2, p.f2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n1 = n1;
  p.n2 = n2;
  p.c = c;
  p.j1a = j1a;
  p.n1i = n1i;
  p.pad_lo = pad_lo;
  p.k2a = k2a;
  p.trim0 = trim0;
  p.size = size;
  p.in_rows = in_rows;
  p.m = m;
  p.num_mb = num_mb;
  p.s = static_cast<float>(sign);
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.vec4 = m % 4 == 0 && aligned(re) && aligned(im) && aligned(z_re) &&
           aligned(z_im);
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
