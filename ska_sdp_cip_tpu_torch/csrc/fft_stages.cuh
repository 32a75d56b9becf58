// The stage code of kernel B2 (csrc/fft_fused.cu), shared with its
// probes (csrc/fft_probes.cu): the cp.async staging of a tile, the
// Stockham radix passes of a sub-FFT, each stage's input and output,
// B2's two stage kernels, the pass geometry and the host side of a
// launch. fft_fused.cu launches the stage kernels; P2 (fft_probes.cu)
// launches the same kernels, and builds P1's persistent ring kernels
// and its load variants from the same pieces, so the probes load, sum
// and store exactly as B2 does. What B2 computes, and why it is built
// this way, is in fft_fused.cu. B2's kernels build their units in their
// own bodies and sub_fft keeps its own buffer arithmetic: written
// through helpers, the same arithmetic compiles to other instructions
// (cuobjdump -sass) and runs 1-5% slower, so P1 keeps its unit helpers
// and its ring's pass loop to itself (fft_probes.cu).

#pragma once

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

// Start the copies of the block's n input rows of C columns into
// (re_s, im_s) [row][C] with cp.async (not committed): 16-byte copies
// when in.vec4 (m % 4 == 0, 16-byte aligned re/im), else 4-byte ones;
// rows and columns outside the input are zero-filled.
template <int C, class In>
__device__ __forceinline__ void issue_tile(const In& in, int n, float* re_s,
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
}

// Stage the block's input tile (issue_tile), all copies in flight at
// once, and wait for every one of them.
template <int C, class In>
__device__ __forceinline__ void fetch_tile(const In& in, int n, float* re_s,
                                           float* im_s) {
  issue_tile<C>(in, n, re_s, im_s);
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

// Pass p of the sub-FFT f, at its radix (any_pass).
template <int C, class In, class Out>
__device__ __forceinline__ void pass_at(const SubFFT& f, int p, const In& in,
                                        const Out& out,
                                        const SmemRows<C>& src,
                                        const SmemRows<C>& dst, int ns,
                                        float s) {
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
    pass_at<C>(f, p, in, out, src, dst, ns, s);
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

// B2's stage kernels. Stage 1: one block per (C-column tile, j2),
// x -> z = y T (Out = Stage1Out; P2's s1 stores y instead); stage 2:
// one block per (C-column tile, k1), z -> the output rows in the crop.
// The block builds its unit's input and output here, in the kernel's
// own body: written through helpers, the same arithmetic compiles to
// other instructions and runs 1-5% slower (cuobjdump -sass).
template <int C, class Out = Stage1Out>
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
  const Out out{z_re, z_im, twc, tws,
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

// Fill a pass's geometry from the C entries' arguments (see
// fft_fused.cu); false when they are out of range.
bool fill_pass(Pass& p, const float* re, const float* im, const float* tw1,
               const float* tw2, const float* z_re, const float* z_im,
               int n1, int n2, int c, int j1a, int n1i, int pad_lo,
               int64_t in_rows, int k2a, int trim0, int size, int sign,
               int64_t radices1, int64_t radices2, int cols1, int cols2,
               int num_mb, int64_t m) {
  const auto tile = [](int cols) {
    return cols == 4 || cols == 8 || cols == 16 || cols == 32;
  };
  if (c <= 0 || n2 % c != 0 || (sign != 1 && sign != -1) || m <= 0 ||
      n1i <= 0 || j1a < 0 || j1a + n1i > n1 || !tile(cols1) ||
      !tile(cols2) || (num_mb && kTiledMB % cols1 != 0) ||
      !unpack(radices1, n1, tw1, p.f1) || !unpack(radices2, n2, tw2, p.f2)) {
    return false;
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
  return true;
}

// Dynamic shared memory of a sub-FFT on C columns: the staged input,
// and a second buffer when there is more than one pass.
size_t smem_bytes(const SubFFT& f, int c) {
  const int buffers = f.passes < 2 ? 1 : 2;
  return static_cast<size_t>(buffers) * 2 * f.n * c * sizeof(float);
}

// Opt `kernel` in to `bytes` of dynamic shared memory and to the
// largest shared-memory carveout.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// B2's grid: one block per (C-column tile, batch row), `bytes` of
// dynamic shared memory.
template <int C, class Kernel, class... Args>
cudaError_t launch_grid(Kernel kernel, size_t bytes, unsigned batch,
                        int64_t m, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m + C - 1) / C), batch);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// A B2 stage launch: its grid with its sub-FFT's buffers.
template <int C, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const SubFFT& f, unsigned batch, int64_t m,
                   cudaStream_t stream, Args... args) {
  return launch_grid<C>(kernel, smem_bytes(f, C), batch, m, stream, args...);
}

}  // namespace
