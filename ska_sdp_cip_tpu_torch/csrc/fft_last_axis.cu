// Centred, cropped DFT along the LAST axis of split (re, im) float32
// arrays (kernel B2L): B2's four-step transform (csrc/fft_fused.cu) with
// the rows of the array as its columns, and the w-screen and the image
// accumulation of a w-plane done in its loads and stores.
//
// Replaces, with B2 (the pass along axis 0), the second pass of each
// plane's 2-D transform that the Pallas TPU kernel
//   ska_sdp_cip_tpu/ops/fft_pallas.py:_kernel (fft_first_axis_fused)
// ran on a transposed plane, and the XLA ops around it: the transpose
// between a plane's two passes (ska_sdp_cip_tpu/ops/gridder.py
// _fft2_to_image_fused_t; fft_pallas.py fft2_from_image_fused), the
// invert's w-screen and accumulation (gridder.py:1086-1090) and
// predict's screen (gridder.py:1467-1470). On the TPU the lanes lie
// along the last axis, so its kernel transforms axis 0 and the plane is
// transposed between passes; on Hopper a pass along the contiguous last
// axis coalesces as well as one along axis 0, and none of that is
// needed.
//
// What it computes. For each of the R rows, of length n = n1 * n2 (or,
// in-cropped, in_size columns placed at column pad_lo of the covering
// j1 window [j1a, j1a + n1i)), exactly what B2 computes for one column
// of the transposed array: the same stages (make_fft_plan(shifted=True)'s
// D1, T and D2 with their centring signs), the same out-crop (k2a, trim0,
// size), the same radix passes and twiddle tables (fft_stages.cuh's
// radix_pass, dft and cmul; ops/fft_cuda.py:sub_fft_radices,
// sub_fft_twiddles) and the same operations on each element in the same
// order, so fft_last_axis(x) equals fft_first_axis(x^T)^T bit for bit.
// Only the addressing differs.
//
// Loads and stores (In / Out functors, as B2's):
// * stage 1 reads the plain input, or (predict) a real image img0 and
//   the screen argument nm1s into its two staging buffers and turns them
//   in place into img0 cos(theta) and img0 sin(theta), theta = coef nm1s;
// * stage 2 stores the output, or (invert) adds Re(e^(i theta) w) =
//   w_re cos(theta) - w_im sin(theta) into an image acc (theta = coef
//   nm1s), or (invert without w-stacking) adds w_re. coef (-+2 pi w,
//   rounded to float32 by the caller as the plain version rounds it) is
//   read from device memory: no host sync a plane. Every product, sum
//   and difference of the screen is rounded on its own (__fmul_rn,
//   __fsub_rn, __fadd_rn; cosf / sinf without fast-math), as the torch
//   ops of the plain version round them, so the image does not move.
//   Stage 2 writes each output element once, so the accumulation needs
//   no atomics and its order is the plane order.
//
// What bounds it on Hopper: bytes, as B2. A pass reads its input once,
// writes and reads back z and writes (or, accumulating, reads and
// writes) its output: at the production invert (R = 10240 rows of
// 15360, out-cropped to 10240) 1.26 + 2 x 1.26 + 0.84 (+0.42 nm1s, +0.42
// acc read) GB. The screen's cosf and sinf are ~40 instructions an
// output element, under 10% of the float32 rate in that time.
//
// The design:
// * Stage 1: one block per (row r, tile of C consecutive j2): the lane
//   is j2. Its input tile, x[r, j1 n2 + j2] for every j1, is n1 row
//   segments of C contiguous floats (128 bytes at C = 32), staged with
//   16-byte cp.async into [j1][lane] exactly as B2 stages its tile, and
//   its output z[r, k1 n2 + j2] leaves as 128-byte segments. The
//   twiddle T[k1, j2] is read from the plan's own (n1, n2) layout
//   (ops/fft_cuda.py:last_axis_kernel_arrays), so a warp's 32 j2 read
//   one contiguous 128 bytes (B2 reads one broadcast entry instead).
// * Stage 2: one block per (row r, tile of C consecutive k1): the lane
//   is k1. Its input tile, z[r, k1 n2 + j2] for C k1 and every j2, is
//   one contiguous range of C n2 floats, but the passes want it as
//   [j2][lane = k1]: the staging is a transpose. Each thread copies one
//   float with 4-byte cp.async (a warp reads 128 contiguous bytes) into
//   rows padded to C + 1 words, so the 32 j2 of a warp's copy land in 32
//   banks (an unpadded row of 32 would put them all in one). The passes
//   read and write [row * (C + 1) + lane], one row a warp access,
//   conflict-free too. The output w[k2, k1] leaves as C consecutive
//   columns of row r.
// * Accumulating, stage 2 first stages its tile of the image acc (and
//   of nm1s) into the buffer its last pass leaves free, every copy in
//   flight at once, so the last pass's stores read them from shared
//   memory: a first version loaded both in each store, and the
//   screened stage 2 took 2.17 ms a production plane against ~1.0 for
//   the plain store (PERF.md).
// * Columns per block from the shapes (ops/fft_cuda.py): stage 1 B2's
//   sub_fft_columns(n1), stage 2 last_axis_columns(n2) (the widest tile
//   whose padded buffers fit 227 KiB). A tile past n1 (n1 = 120: the
//   last k1 tile has 24 live lanes) or n2 zero-fills its dead lanes and
//   stores nothing from them.
// * Two launches, as B2: stage 2 needs every j2 of a row, which stage-1
//   blocks all over the card produce.
//
// B2's code is not touched: this file includes fft_stages.cuh for the
// shared arithmetic (dft, cmul, radix_pass, cp.async, unpack) and keeps
// its buffers, staging, pass loop and functors to itself.
#include "fft_stages.cuh"

namespace {

// A shared-memory buffer of the block with row stride P (P = C, or
// C + 1 to spread a transposing staging over the banks): n rows of re,
// then of im.
template <int P>
struct Rows {
  float* re;
  float* im;
  int lane;
  __device__ void load(int row, float& r, float& i) const {
    r = re[row * P + lane];
    i = im[row * P + lane];
  }
  __device__ void store(int row, float r, float i) const {
    re[row * P + lane] = r;
    im[row * P + lane] = i;
  }
};

// The staged input tile, read by the first pass with the stage's sign.
template <int P, class In>
struct SignedTile {
  Rows<P> rows;
  const In& in;
  __device__ void load(int row, float& r, float& i) const {
    rows.load(row, r, i);
    if (in.negate(row)) {
      r = -r;
      i = -i;
    }
  }
};

// Pass p of P (as fft_stages.cuh's any_pass, on Rows<P>).
template <int R, int C, int P, class In, class Out>
__device__ __forceinline__ void tile_pass(int p, int passes, const In& in,
                                          const Out& out,
                                          const Rows<P>& src,
                                          const Rows<P>& dst, int n, int ns,
                                          const float2* tw, float s) {
  const bool first = p == 0, last = p == passes - 1;
  const SignedTile<P, In> input{src, in};
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

template <int C, int P, class In, class Out>
__device__ __forceinline__ void tile_pass_at(const SubFFT& f, int p,
                                             const In& in, const Out& out,
                                             const Rows<P>& src,
                                             const Rows<P>& dst, int ns,
                                             float s) {
  const int n = f.n;
  switch (f.radix[p]) {
    case 2: tile_pass<2, C>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
            break;
    case 3: tile_pass<3, C>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
            break;
    case 4: tile_pass<4, C>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
            break;
    case 5: tile_pass<5, C>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
            break;
    case 7: tile_pass<7, C>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
            break;
    default: tile_pass<8, C>(p, f.passes, in, out, src, dst, n, ns, f.tw, s);
  }
}

// The length-f.n FFT of each of the block's C lanes: the input stages
// itself into buffer 0 (in.stage: copies issued, waited for, shared
// memory synced and, screened, turned in place), then the passes run
// from buffer to buffer and the last one hands its values to out. The
// last pass writes no buffer, so before it out may stage what its
// stores read into the one it leaves free, buffer f.passes % 2
// (out.stage; accumulating stores).
template <int C, int P, class In, class Out>
__device__ void tile_fft(const SubFFT& f, const In& in, const Out& out,
                         float* smem, float s) {
  const int lane = threadIdx.x % C;
  const int words = f.n * P;
  in.template stage<C, P>(f.n, smem, smem + words);
  int ns = 1;
  for (int p = 0; p < f.passes; ++p) {
    float* a = smem + (p & 1) * 2 * words;
    float* b = smem + ((p + 1) & 1) * 2 * words;
    const Rows<P> src{a, a + words, lane};
    const Rows<P> dst{b, b + words, lane};
    if (p == f.passes - 1) out.template stage<C, P>(f.n, b, b + words);
    tile_pass_at<C, P>(f, p, in, out, src, dst, ns, s);
    ns *= f.radix[p];
    if (p + 1 < f.passes) __syncthreads();
  }
}

// Stage 1's input of the block's (row, j2 tile): element (j1, lane q) is
// x[r, j1 n2 + j20 + q] of the logical row, at column (j1 - j1a) n2 +
// j20 + q - pad_lo of the input row (base = r * row_len); absent outside
// the window, the row and n2. Its sign is (-1)^(j1 n2). Screened, `re`
// is the image img0 and `im` the screen argument nm1s, and the staged
// pair becomes img0 cos(coef nm1s), img0 sin(coef nm1s).
template <bool kScreen>
struct Stage1LIn {
  const float* re;
  const float* im;
  const float* coef;
  int64_t base, row_len;
  int j1a, n1i, n2, j20, pad_lo;
  bool odd_n2, vec4;
  __device__ bool locate(int j1, int q, int64_t& off) const {
    const int jj = j1 - j1a;
    const int64_t col = static_cast<int64_t>(jj) * n2 + j20 + q - pad_lo;
    off = base + col;
    return jj >= 0 && jj < n1i && j20 + q < n2 && col >= 0 && col < row_len;
  }
  __device__ bool negate(int j1) const { return odd_n2 && (j1 & 1); }
  template <int C, int P>
  __device__ void stage(int n, float* re_s, float* im_s) const {
    if (vec4) {
      constexpr int kQuads = C / 4;
      for (int e = threadIdx.x; e < n * kQuads; e += kThreads) {
        const int row = e / kQuads;
        const int q = (e - row * kQuads) * 4;
        int64_t off;
        const bool ok = locate(row, q, off);
        cp_async16(re_s + row * P + q, ok ? re + off : re, ok);
        cp_async16(im_s + row * P + q, ok ? im + off : im, ok);
      }
    } else {
      for (int e = threadIdx.x; e < n * C; e += kThreads) {
        const int row = e / C;
        const int q = e - row * C;
        int64_t off;
        const bool ok = locate(row, q, off);
        cp_async4(re_s + row * P + q, ok ? re + off : re, ok);
        cp_async4(im_s + row * P + q, ok ? im + off : im, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kScreen) {
      const float c = __ldg(coef);
      for (int e = threadIdx.x; e < n * C; e += kThreads) {
        const int row = e / C;
        const int at = row * P + (e - row * C);
        const float x = re_s[at];
        const float theta = __fmul_rn(c, im_s[at]);
        re_s[at] = __fmul_rn(x, cosf(theta));
        im_s[at] = __fmul_rn(x, sinf(theta));
      }
      __syncthreads();
    }
  }
};

// Stage 1's output: z[r, k1 n2 + j2] = y[k1] T[k1, j2], T from the
// (n1, n2) tables twc / tws (sign folded) at k1 n2 + j2.
struct Stage1LOut {
  float* __restrict__ z_re;
  float* __restrict__ z_im;
  const float* __restrict__ twc;
  const float* __restrict__ tws;
  int64_t base;  // r * n + j2
  int j2, n2;
  bool ok;
  __device__ void store(int k1, float r, float i) const {
    if (!ok) return;
    const int t = k1 * n2 + j2;
    const float tr = __ldg(twc + t), ti = __ldg(tws + t);
    const int64_t off = base + static_cast<int64_t>(k1) * n2;
    z_re[off] = r * tr - i * ti;
    z_im[off] = r * ti + i * tr;
  }
  template <int C, int P>
  __device__ void stage(int, float*, float*) const {}
};

// Stage 2's input of the block's (row, k1 tile): z[r, k1 n2 + j2] for
// the `live` k1 of the tile, one contiguous range of live * n2 floats at
// base = r n + k10 n2, staged transposed into [j2][lane = k1 - k10] with
// 4-byte copies (each warp reads 128 contiguous bytes); sign (-1)^j2.
struct Stage2LIn {
  const float* re;
  const float* im;
  int64_t base;
  int live;
  __device__ bool negate(int j2) const { return j2 & 1; }
  template <int C, int P>
  __device__ void stage(int n, float* re_s, float* im_s) const {
    for (int e = threadIdx.x; e < C * n; e += kThreads) {
      const int k = e / n;
      const int at = (e - k * n) * P + k;
      const bool ok = k < live;
      cp_async4(re_s + at, ok ? re + base + e : re, ok);
      cp_async4(im_s + at, ok ? im + base + e : im, ok);
    }
    cp_async_wait_all();
    __syncthreads();
  }
};

// Stage 2's output (-1)^(n1 k2 + n / 2) w[k2, k1] at column c = (k2 -
// k2a) n1 + k1 - trim0 of row r when c lies in [0, size): stored
// (kMode 0), added screened into acc = out_re (1), or its real part
// added into acc (2). Accumulating, the block first stages its tile of
// acc (and nm1s) into the buffer the last pass leaves free, [k2][lane]
// as the passes lay out w, every copy in flight at once (a warp's 32
// lanes read 128 contiguous bytes of a row); read in each store, one
// element after another, they would wait on two loads a store.
enum { kStore = 0, kScreenAccumulate = 1, kAccumulate = 2 };

template <int kMode>
struct Stage2LOut {
  float* __restrict__ out_re;
  float* __restrict__ out_im;
  const float* __restrict__ nm1s;
  const float* stash;  // the free buffer: nm1s [k2][stride], then acc
  float coef;
  int64_t base;  // r * size
  int n1, k10, lane, k2a, trim0, size, stride, words;
  bool odd_n1, flip, ok;
  __device__ int column(int k2, int q) const {
    return (k2 - k2a) * n1 + k10 + q - trim0;
  }
  template <int C, int P>
  __device__ void stage(int n, float* nm_s, float* acc_s) const {
    if constexpr (kMode != kStore) {
      for (int e = threadIdx.x; e < n * C; e += kThreads) {
        const int k2 = e / C;
        const int q = e - k2 * C;
        const int c = column(k2, q);
        const bool live = k10 + q < n1 && c >= 0 && c < size;
        if constexpr (kMode == kScreenAccumulate) {
          cp_async4(nm_s + k2 * P + q, live ? nm1s + base + c : nm1s, live);
        }
        cp_async4(acc_s + k2 * P + q, live ? out_re + base + c : out_re,
                  live);
      }
      cp_async_wait_all();
      __syncthreads();
    }
  }
  __device__ void store(int k2, float r, float i) const {
    const int c = column(k2, lane);
    if (!ok || c < 0 || c >= size) return;
    const bool neg = flip != (odd_n1 && (k2 & 1));
    const float sr = neg ? -r : r;
    const float si = neg ? -i : i;
    const int64_t off = base + c;
    if constexpr (kMode == kStore) {
      out_re[off] = sr;
      out_im[off] = si;
    } else {
      const int at = k2 * stride + lane;
      float d = sr;
      if constexpr (kMode == kScreenAccumulate) {
        const float theta = __fmul_rn(coef, stash[at]);
        d = __fsub_rn(__fmul_rn(sr, cosf(theta)), __fmul_rn(si, sinf(theta)));
      }
      out_re[off] = __fadd_rn(stash[words + at], d);
    }
  }
};

// The geometry of one B2L pass (host-filled, passed by value).
struct LPass {
  SubFFT f1, f2;
  int n1, n2, j1a, n1i, pad_lo, k2a, trim0, size, tiles1, tiles2;
  int64_t n, row_len;
  float s;
  bool vec4;  // 16-byte stage-1 copies
};

template <int C, bool kScreen>
__global__ void __launch_bounds__(kThreads)
last_stage1_kernel(LPass p, const float* __restrict__ re,
                   const float* __restrict__ im,
                   const float* __restrict__ coef,
                   const float* __restrict__ twc,
                   const float* __restrict__ tws, float* __restrict__ z_re,
                   float* __restrict__ z_im) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % C;
  const int64_t r = blockIdx.x / p.tiles1;
  const int j20 = static_cast<int>(blockIdx.x - r * p.tiles1) * C;
  const int j2 = j20 + lane;
  const Stage1LIn<kScreen> in{re,    im,    coef,     r * p.row_len,
                              p.row_len, p.j1a, p.n1i, p.n2, j20, p.pad_lo,
                              (p.n2 & 1) != 0, p.vec4};
  const Stage1LOut out{z_re, z_im, twc, tws, r * p.n + j2, j2, p.n2,
                       j2 < p.n2};
  tile_fft<C, C>(p.f1, in, out, smem, p.s);
}

template <int C, int kMode>
__global__ void __launch_bounds__(kThreads)
last_stage2_kernel(LPass p, const float* __restrict__ z_re,
                   const float* __restrict__ z_im, float* __restrict__ out_re,
                   float* __restrict__ out_im,
                   const float* __restrict__ nm1s,
                   const float* __restrict__ coef) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % C;
  const int64_t r = blockIdx.x / p.tiles2;
  const int k10 = static_cast<int>(blockIdx.x - r * p.tiles2) * C;
  const int k1 = k10 + lane;
  const Stage2LIn in{z_re, z_im, r * p.n + static_cast<int64_t>(k10) * p.n2,
                     min(C, p.n1 - k10)};
  const int words = p.n2 * (C + 1);
  const Stage2LOut<kMode> out{
      out_re, out_im, nm1s, smem + (p.f2.passes & 1) * 2 * words,
      kMode == kScreenAccumulate ? __ldg(coef) : 0.0f, r * p.size, p.n1,
      k10, lane, p.k2a, p.trim0, p.size, C + 1, words, (p.n1 & 1) != 0,
      ((p.n1 * p.n2 / 2) & 1) != 0, k1 < p.n1};
  tile_fft<C, C + 1>(p.f2, in, out, smem, p.s);
}

// Dynamic shared memory of a stage on C lanes with row stride P: the
// staged input, and a second buffer when there is more than one pass or
// the stores stage their tile (accumulating).
size_t tile_smem_bytes(const SubFFT& f, int p, bool stash = false) {
  const int buffers = f.passes < 2 && !stash ? 1 : 2;
  return static_cast<size_t>(buffers) * 2 * f.n * p * sizeof(float);
}

// One launch: rows x tiles blocks of kThreads, `bytes` of shared memory.
template <class Kernel, class... Args>
cudaError_t launch_rows(Kernel kernel, size_t bytes, int64_t blocks,
                        cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      args...);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_stage1(const LPass& p, int64_t rows, bool screen,
                          cudaStream_t s, const float* re, const float* im,
                          const float* coef, const float* twc,
                          const float* tws, float* z_re, float* z_im) {
  const size_t bytes = tile_smem_bytes(p.f1, C);
  const int64_t blocks = rows * p.tiles1;
  if (screen) {
    return launch_rows(last_stage1_kernel<C, true>, bytes, blocks, s, p, re,
                       im, coef, twc, tws, z_re, z_im);
  }
  return launch_rows(last_stage1_kernel<C, false>, bytes, blocks, s, p, re,
                     im, coef, twc, tws, z_re, z_im);
}

template <int C>
cudaError_t launch_stage2(const LPass& p, int64_t rows, int mode,
                          cudaStream_t s, const float* z_re,
                          const float* z_im, float* out_re, float* out_im,
                          const float* nm1s, const float* coef) {
  const size_t bytes = tile_smem_bytes(p.f2, C + 1, mode != kStore);
  const int64_t blocks = rows * p.tiles2;
  switch (mode) {
    case kScreenAccumulate:
      return launch_rows(last_stage2_kernel<C, kScreenAccumulate>, bytes,
                         blocks, s, p, z_re, z_im, out_re, out_im, nm1s,
                         coef);
    case kAccumulate:
      return launch_rows(last_stage2_kernel<C, kAccumulate>, bytes, blocks,
                         s, p, z_re, z_im, out_re, out_im, nm1s, coef);
    default:
      return launch_rows(last_stage2_kernel<C, kStore>, bytes, blocks, s, p,
                         z_re, z_im, out_re, out_im, nm1s, coef);
  }
}

bool tile_ok(int cols) {
  return cols == 4 || cols == 8 || cols == 16 || cols == 32;
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

// C entry (bound with ctypes by ops/fft_cuda.py:fft_last_axis_fused).
// re/im: the (rows, row_len) row-major input (row_len = n, or the
// in-cropped in_size columns placed at column pad_lo of the j1 window
// [j1a, j1a + n1i)); screen_in = 1: re is img0, im is unused and nm1s
// (rows, row_len) and coef (one float) give the screen. twc/tws: the
// (n1, n2) twiddle tables (ops/fft_cuda.py:last_axis_kernel_arrays);
// tw1/tw2, radices1/radices2: B2's sub-FFT tables and packed radix
// passes; cols1/cols2 each stage's lanes per block (sub_fft_columns(n1),
// last_axis_columns(n2)); z_re/z_im (rows, n) scratch; out_re/out_im
// (rows, size). out_mode 1 / 2: out_re is the image acc (rows, size)
// added into (screened with nm1s (rows, size) and coef, or not), out_im
// unused. Return the CUDA error code (0 = ok).
extern "C" int cip_fft_last_axis_fused(
    const float* re, const float* im, const float* twc, const float* tws,
    const float* tw1, const float* tw2, float* z_re, float* z_im,
    float* out_re, float* out_im, const float* nm1s, const float* coef,
    int screen_in, int out_mode, int n1, int n2, int j1a, int n1i,
    int pad_lo, int64_t row_len, int k2a, int trim0, int size, int sign,
    int64_t radices1, int64_t radices2, int cols1, int cols2, int64_t rows,
    void* stream) {
  LPass p{};
  const bool screen = screen_in != 0;
  if ((sign != 1 && sign != -1) || rows <= 0 || row_len <= 0 || size <= 0 ||
      n1i <= 0 || j1a < 0 || j1a + n1i > n1 || pad_lo < 0 ||
      !tile_ok(cols1) || !tile_ok(cols2) || out_mode < 0 || out_mode > 2 ||
      ((screen || out_mode == kScreenAccumulate) &&
       (nm1s == nullptr || coef == nullptr)) ||
      !unpack(radices1, n1, tw1, p.f1) || !unpack(radices2, n2, tw2, p.f2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n1 = n1;
  p.n2 = n2;
  p.j1a = j1a;
  p.n1i = n1i;
  p.pad_lo = pad_lo;
  p.k2a = k2a;
  p.trim0 = trim0;
  p.size = size;
  p.tiles1 = (n2 + cols1 - 1) / cols1;
  p.tiles2 = (n1 + cols2 - 1) / cols2;
  p.n = static_cast<int64_t>(n1) * n2;
  p.row_len = row_len;
  p.s = static_cast<float>(sign);
  const float* in_im = screen ? nm1s : im;
  p.vec4 = row_len % 4 == 0 && pad_lo % 4 == 0 && n2 % 4 == 0 &&
           aligned16(re) && aligned16(in_im);
  if (rows * p.tiles1 > 0x7fffffff || rows * p.tiles2 > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cols1) {
    case 32: err = launch_stage1<32>(p, rows, screen, s, re, in_im, coef,
                                     twc, tws, z_re, z_im);
             break;
    case 16: err = launch_stage1<16>(p, rows, screen, s, re, in_im, coef,
                                     twc, tws, z_re, z_im);
             break;
    case 8: err = launch_stage1<8>(p, rows, screen, s, re, in_im, coef, twc,
                                   tws, z_re, z_im);
            break;
    default: err = launch_stage1<4>(p, rows, screen, s, re, in_im, coef,
                                    twc, tws, z_re, z_im);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cols2) {
    case 32: err = launch_stage2<32>(p, rows, out_mode, s, z_re, z_im,
                                     out_re, out_im, nm1s, coef);
             break;
    case 16: err = launch_stage2<16>(p, rows, out_mode, s, z_re, z_im,
                                     out_re, out_im, nm1s, coef);
             break;
    case 8: err = launch_stage2<8>(p, rows, out_mode, s, z_re, z_im, out_re,
                                   out_im, nm1s, coef);
            break;
    default: err = launch_stage2<4>(p, rows, out_mode, s, z_re, z_im,
                                    out_re, out_im, nm1s, coef);
  }
  return static_cast<int>(err);
}
