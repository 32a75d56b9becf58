// Probes of kernel B2 (csrc/fft_fused.cu) as it runs: B2's own stage
// code (fft_stages.cuh: the staging, the radix passes, each stage's
// input and output), rearranged to ask where its time goes.
//
// Replaces two Pallas TPU probe kernels, as Hopper probes of the same
// questions:
//
// * P1, scripts/fft_split_fetch_probe.py (pallas_call :171): does the
//   pass go faster with more of its input in flight? The TPU probe split
//   the input into K BlockSpecs (2K DMAs in flight). Here each stage is
//   a persistent kernel: about (SMs x the blocks that fit one SM)
//   blocks, each walking its stage's (row, 32-column tile) units in
//   B2's grid order, unit u = blockIdx.x + i * gridDim.x. An S-deep ring
//   of input slots keeps the fetch of unit u + S - 1 in flight while
//   unit u's radix passes run: the passes ping-pong between the unit's
//   slot and one work buffer, (S + 1) x 2 x n x 32 x 4 bytes a block
//   (ops/fft_cuda.py:ring_geometry says which S fit). Two copy engines,
//   each a compile-time variant:
//     cp_async  B2's own 16-byte cp.async copies, one commit group a
//               unit, cp.async.wait_group S - 1 before a unit's passes;
//     bulk      Hopper's bulk copy unit: one cp.async.bulk of a row's
//               128-byte segment (re or im) per row, completing on the
//               slot's mbarrier, which thread 0 arms with the unit's
//               bytes (expect_tx); every thread waits on its phase.
//   The bulk engine copies row segments rather than a TMA tensor tile
//   (a box of 32 columns x n rows): the segments are exactly the bytes
//   B2's cp.async copies move, so the two engines differ only in who
//   moves them and how completion is signalled; and a tensor map would
//   need libcuda's cuTensorMapEncodeTiled on the host, one map a
//   stage and part, where these libraries link the runtime only. The
//   loads, the radix passes and their order are B2's, so every (engine,
//   S) output equals B2's bit for bit; S = 1 with cp.async is B2's
//   schedule made persistent.
//
// * P2, scripts/fft_ablation_probe.py (pallas_call :164): where does
//   B2's time go? B2's two stage kernels (fft_stages.cuh) launched on
//   B2's grid and shared memory, alone, together or cut down:
//     load   stage 1's grid: each tile staged by B2's fetch_tile, then
//            written straight back (the output is the input);
//     load2  the same on stage 2's grid, over z (the output is z);
//     s1     B2's stage-1 kernel storing y with no twiddle
//            (stage1_kernel<32, Stage1YOut>);
//     s1tw   B2's first launch (stage1_kernel<32>, z);
//     s2     B2's second launch (stage2_kernel<32>), on a given z;
//     full   both launches (B2 at a 32-column tile).
//   The TPU probe's s1twtr (its in-VMEM transpose between the stages)
//   has no counterpart: the two-launch design writes z to device memory
//   and stage 2 reads it in the layout stage 1 wrote.
//
// What bounds them on Hopper: bytes, as B2 (fft_fused.cu); the probes
// exist to split B2's time against that bound (PERF.md). The kernels
// are built for B2's 32-column tile only (every sub-FFT up to 454); a
// pass whose stage takes narrower tiles is refused.

#include "fft_stages.cuh"

namespace {

enum Engine { kCpAsync = 0, kBulk = 1 };
enum Variant { kLoad = 0, kLoad2 = 1, kS1 = 2, kS1Tw = 3, kS2 = 4, kFull = 5 };

constexpr int kCols = 32;  // the probes' column tile (B2's up to n = 454)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's generic-proxy accesses of shared memory before
// later async-proxy (bulk copy) writes to it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start the bulk copies of a unit's input tile into (re_s, im_s)
// [row][C]: one per row and part, the row's C-column segment (fewer
// columns in a ragged last tile, still a multiple of 4), all completing
// on `bar`, which thread 0 arms with their bytes. Every row of the tile
// lies in the input (the out-cropped pass; the host checks).
template <int C, class In>
__device__ __forceinline__ void issue_bulk(const In& in, int n, float* re_s,
                                           float* im_s, uint64_t* bar) {
  const int64_t left = in.m - in.col0;
  const unsigned seg =
      static_cast<unsigned>((left < C ? left : C) * sizeof(float));
  if (threadIdx.x == 0) mbar_expect_tx(bar, 2u * n * seg);
  for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
    const bool imag = e >= n;
    const int row = imag ? e - n : e;
    int64_t off;
    in.locate(row, 0, off);
    bulk_copy((imag ? im_s : re_s) + row * C, (imag ? in.im : in.re) + off,
              seg, bar);
  }
}

// Stage 1's y with no twiddle, at z's place: y[k1 * n2 + j2, col]. It
// takes Stage1Out's fields (stage1_kernel builds it as it builds
// Stage1Out) and ignores the twiddle's.
struct Stage1YOut : Stage1Out {
  __device__ void store(int k1, float r, float i) const {
    if (ok) {
      const int64_t off = base + k1 * stride;
      z_re[off] = r;
      z_im[off] = i;
    }
  }
};

// Stage 1's unit (column tile `tile`, j2): its input and its output, as
// B2's stage1_kernel builds them.
template <int C>
__device__ __forceinline__ Stage1In stage1_in(const Pass& p, const float* re,
                                              const float* im, int tile,
                                              int j2) {
  const int64_t col0 = static_cast<int64_t>(tile) * C;
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
  return in;
}

template <int C>
__device__ __forceinline__ Stage1Out stage1_out(const Pass& p, float* z_re,
                                                float* z_im, const float* twc,
                                                const float* tws, int tile,
                                                int j2) {
  const int64_t col = static_cast<int64_t>(tile) * C + threadIdx.x % C;
  const int ci = j2 / p.c;
  const int cc = j2 - ci * p.c;
  return Stage1Out{z_re, z_im, twc, tws,
                   static_cast<int64_t>(j2) * p.m + col,
                   static_cast<int64_t>(p.n2) * p.m,
                   ci * p.n1 * p.c + cc, p.c, col < p.m};
}

// Stage 2's unit (column tile `tile`, k1), as B2's stage2_kernel builds it.
template <int C>
__device__ __forceinline__ Stage2In stage2_in(const Pass& p, const float* z_re,
                                              const float* z_im, int tile,
                                              int k1) {
  const int64_t col0 = static_cast<int64_t>(tile) * C;
  return Stage2In{z_re, z_im, static_cast<int64_t>(k1) * p.n2 * p.m + col0,
                  col0, p.m, p.vec4};
}

template <int C>
__device__ __forceinline__ Stage2Out stage2_out(const Pass& p, float* out_re,
                                                float* out_im, int tile,
                                                int k1) {
  const int64_t col = static_cast<int64_t>(tile) * C + threadIdx.x % C;
  return Stage2Out{out_re, out_im, p.m, col, p.n1, k1, p.k2a, p.trim0,
                   p.size, (p.n1 & 1) != 0,
                   ((p.n1 * p.n2 / 2) & 1) != 0, col < p.m};
}

// The radix passes of a unit staged in `slot`: pass p reads the slot
// (p even) or the work buffer and writes the other, B2's two-buffer
// ping-pong with the slot as buffer 0.
template <int C, class In, class Out>
__device__ __forceinline__ void ring_passes(const SubFFT& f, const In& in,
                                            const Out& out, float* slot,
                                            float* work, float s) {
  const int lane = threadIdx.x % C;
  const int words = f.n * C;
  int ns = 1;
  for (int p = 0; p < f.passes; ++p) {
    float* a = (p & 1) ? work : slot;
    float* b = (p & 1) ? slot : work;
    const SmemRows<C> src{a, a + words, lane};
    const SmemRows<C> dst{b, b + words, lane};
    pass_at<C>(f, p, in, out, src, dst, ns, s);
    ns *= f.radix[p];
    if (p + 1 < f.passes) __syncthreads();
  }
}

// A unit of stage `Stage` (column tile, row = j2 or k1): its input and
// its output, as B2's stage kernel builds them.
template <int C, int Stage>
__device__ __forceinline__ auto unit_in(const Pass& p, const float* x_re,
                                        const float* x_im, int tile,
                                        int row) {
  if constexpr (Stage == 1) {
    return stage1_in<C>(p, x_re, x_im, tile, row);
  } else {
    return stage2_in<C>(p, x_re, x_im, tile, row);
  }
}

template <int C, int Stage>
__device__ __forceinline__ auto unit_out(const Pass& p, const float* twc,
                                         const float* tws, float* y_re,
                                         float* y_im, int tile, int row) {
  if constexpr (Stage == 1) {
    return stage1_out<C>(p, y_re, y_im, twc, tws, tile, row);
  } else {
    return stage2_out<C>(p, y_re, y_im, tile, row);
  }
}

// P1: one stage of B2 as a persistent kernel with an S-deep ring of
// input slots filled by engine E. Shared memory: S slots and the work
// buffer (2 x n x C floats each), then S mbarriers (bulk only).
template <int C, int S, int E, int Stage>
__global__ void __launch_bounds__(kThreads)
ring_kernel(Pass p, const float* __restrict__ x_re,
            const float* __restrict__ x_im, const float* __restrict__ twc,
            const float* __restrict__ tws, float* __restrict__ y_re,
            float* __restrict__ y_im) {
  extern __shared__ __align__(16) float smem[];
  const SubFFT& f = Stage == 1 ? p.f1 : p.f2;
  const int words = f.n * C;
  float* work = smem + S * 2 * words;
  uint64_t* bars = reinterpret_cast<uint64_t*>(work + 2 * words);
  const int tiles = static_cast<int>((p.m + C - 1) / C);
  const int units = tiles * (Stage == 1 ? p.n2 : p.n1);
  if constexpr (E == kBulk) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < S; ++k) mbar_init(bars + k, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // Start the fetch of this block's i-th unit into slot i % S.
  const auto issue = [&](int i) {
    const int u = blockIdx.x + i * gridDim.x;
    if (u >= units) return;
    float* slot = smem + (i % S) * 2 * words;
    const auto in = unit_in<C, Stage>(p, x_re, x_im, u % tiles, u / tiles);
    if constexpr (E == kCpAsync) {
      issue_tile<C>(in, f.n, slot, slot + words);
    } else {
      issue_bulk<C>(in, f.n, slot, slot + words, bars + i % S);
    }
  };
  for (int i = 0; i < S - 1; ++i) {
    issue(i);
    if constexpr (E == kCpAsync) cp_async_commit();
  }
  for (int i = 0; blockIdx.x + i * gridDim.x < units; ++i) {
    issue(i + S - 1);  // slot (i - 1) % S, freed by the last iteration
    if constexpr (E == kCpAsync) {
      cp_async_commit();
      cp_async_wait<S - 1>();  // unit i's group has landed
    } else {
      mbar_wait(bars + i % S, (i / S) & 1);
    }
    __syncthreads();
    const int u = blockIdx.x + i * gridDim.x;
    const int tile = u % tiles, row = u / tiles;
    float* slot = smem + (i % S) * 2 * words;
    ring_passes<C>(f, unit_in<C, Stage>(p, x_re, x_im, tile, row),
                   unit_out<C, Stage>(p, twc, tws, y_re, y_im, tile, row),
                   slot, work, p.s);
    if constexpr (E == kBulk) fence_proxy_async();
    __syncthreads();  // slot i % S and the work buffer are free
  }
}

// Dynamic shared memory of a ring: S slots, the work buffer and, for
// the bulk engine, S mbarriers.
size_t ring_bytes(int n, int stages, int engine) {
  return static_cast<size_t>(stages + 1) * 2 * n * kCols * sizeof(float) +
         (engine == kBulk ? stages * sizeof(uint64_t) : 0);
}

// Launch a ring stage on min(units, SMs x blocks an SM) blocks; info
// receives (blocks an SM, blocks).
template <int S, int E, int Stage>
cudaError_t launch_ring(const Pass& p, const float* x_re, const float* x_im,
                        const float* twc, const float* tws, float* y_re,
                        float* y_im, cudaStream_t stream, int* info) {
  const auto kernel = ring_kernel<kCols, S, E, Stage>;
  const size_t bytes = ring_bytes(Stage == 1 ? p.n1 : p.n2, S, E);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t units =
      (p.m + kCols - 1) / kCols * (Stage == 1 ? p.n2 : p.n1);
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  const int grid = static_cast<int>(units < most ? units : most);
  info[0] = per_sm;
  info[1] = grid;
  kernel<<<grid, kThreads, bytes, stream>>>(p, x_re, x_im, twc, tws, y_re,
                                            y_im);
  return cudaGetLastError();
}

// Stage 1 (which & 1: x -> z) and stage 2 (which & 2: z -> out).
template <int S, int E>
cudaError_t run_ring(const Pass& p, int which, const float* re,
                     const float* im, const float* twc, const float* tws,
                     float* z_re, float* z_im, float* out_re, float* out_im,
                     cudaStream_t stream, int* info) {
  cudaError_t err = cudaSuccess;
  if (which & 1) {
    err = launch_ring<S, E, 1>(p, re, im, twc, tws, z_re, z_im, stream,
                               info);
  }
  if (err == cudaSuccess && (which & 2)) {
    err = launch_ring<S, E, 2>(p, z_re, z_im, nullptr, nullptr, out_re,
                               out_im, stream, info + 2);
  }
  return err;
}

// Write the staged tile (re_s, im_s) [row][C] back to out at the
// offsets it was read from (out has the input's layout).
template <int C, class In>
__device__ __forceinline__ void write_back(const In& in, int n,
                                           const float* re_s,
                                           const float* im_s, float* out_re,
                                           float* out_im) {
  const int lane = threadIdx.x % C;
  for (int row = threadIdx.x / C; row < n; row += kThreads / C) {
    int64_t off;
    if (in.locate(row, lane, off)) {
      out_re[off] = re_s[row * C + lane];
      out_im[off] = im_s[row * C + lane];
    }
  }
}

// P2's load variants: a unit's tile staged by B2's fetch_tile, then
// written back where it was read (load: stage 1's grid over the input;
// load2: stage 2's grid over z).
template <int C, int Stage>
__global__ void __launch_bounds__(kThreads)
load_kernel(Pass p, const float* __restrict__ x_re,
            const float* __restrict__ x_im, float* __restrict__ y_re,
            float* __restrict__ y_im) {
  extern __shared__ __align__(16) float smem[];
  const SubFFT& f = Stage == 1 ? p.f1 : p.f2;
  const int words = f.n * C;
  const auto in = unit_in<C, Stage>(p, x_re, x_im, blockIdx.x, blockIdx.y);
  fetch_tile<C>(in, f.n, smem, smem + words);
  write_back<C>(in, f.n, smem, smem + words, y_re, y_im);
}

// B2's grid for a P2 kernel; info receives (blocks an SM, blocks).
template <class Kernel, class... Args>
cudaError_t launch_variant(Kernel kernel, size_t bytes, unsigned batch,
                           int64_t m, cudaStream_t stream, int* info,
                           Args... args) {
  cudaError_t err =
      launch_grid<kCols>(kernel, bytes, batch, m, stream, args...);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  info[0] = per_sm;
  info[1] = static_cast<int>((m + kCols - 1) / kCols * batch);
  return err;
}

// One staged tile without the second buffer (the load variants).
size_t tile_bytes(const SubFFT& f) {
  return static_cast<size_t>(2) * f.n * kCols * sizeof(float);
}

bool fill_probe_pass(Pass& p, const float* re, const float* im,
                     const float* tw1, const float* tw2, const float* z_re,
                     const float* z_im, int n1, int n2, int c, int j1a,
                     int n1i, int pad_lo, int64_t in_rows, int k2a,
                     int trim0, int size, int sign, int64_t radices1,
                     int64_t radices2, int cols1, int cols2, int64_t m) {
  return cols1 == kCols && cols2 == kCols &&
         fill_pass(p, re, im, tw1, tw2, z_re, z_im, n1, n2, c, j1a, n1i,
                   pad_lo, in_rows, k2a, trim0, size, sign, radices1,
                   radices2, cols1, cols2, 0, m);
}

}  // namespace

// C entries (bound with ctypes by probes/fft_async_fetch.py and
// probes/fft_ablation.py). The arguments from re to cols2 are B2's
// (fft_fused.cu's cip_fft_first_axis_fused), then m, info (int[4],
// receives (blocks an SM, blocks) of the stage-1 and the stage-2
// launch; zero for a stage not launched) and the stream. cols1 and
// cols2 must be 32. Return the CUDA error code (0 = ok).
//
// P1: engine (0 cp_async, 1 bulk), stages S (1, 2, 3) and which
// stages run (1: re/im -> z, 2: z -> out, 3: both; a z-input launch
// passes z as re/im too). Needs the out-cropped pass (every input row
// present), m % 4 == 0 and 16-byte-aligned re/im/z; a ring that does
// not fit shared memory is refused by the runtime.
extern "C" int cip_fft_async_fetch(
    int engine, int stages, int which, const float* re, const float* im,
    const float* twc, const float* tws, const float* tw1, const float* tw2,
    float* z_re, float* z_im, float* out_re, float* out_im, int n1, int n2,
    int c, int j1a, int n1i, int pad_lo, int64_t in_rows, int k2a,
    int trim0, int size, int sign, int64_t radices1, int64_t radices2,
    int cols1, int cols2, int64_t m, int* info, void* stream) {
  Pass p{};
  if (!fill_probe_pass(p, re, im, tw1, tw2, z_re, z_im, n1, n2, c, j1a, n1i,
                       pad_lo, in_rows, k2a, trim0, size, sign, radices1,
                       radices2, cols1, cols2, m) ||
      !p.vec4 || which < 1 || which > 3 || j1a != 0 || n1i != n1 ||
      pad_lo != 0 || in_rows != static_cast<int64_t>(n1) * n2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 4; ++k) info[k] = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (engine * 4 + stages) {
    case kCpAsync * 4 + 1:
      err = run_ring<1, kCpAsync>(p, which, re, im, twc, tws, z_re, z_im,
                                  out_re, out_im, s, info);
      break;
    case kCpAsync * 4 + 2:
      err = run_ring<2, kCpAsync>(p, which, re, im, twc, tws, z_re, z_im,
                                  out_re, out_im, s, info);
      break;
    case kCpAsync * 4 + 3:
      err = run_ring<3, kCpAsync>(p, which, re, im, twc, tws, z_re, z_im,
                                  out_re, out_im, s, info);
      break;
    case kBulk * 4 + 1:
      err = run_ring<1, kBulk>(p, which, re, im, twc, tws, z_re, z_im,
                               out_re, out_im, s, info);
      break;
    case kBulk * 4 + 2:
      err = run_ring<2, kBulk>(p, which, re, im, twc, tws, z_re, z_im,
                               out_re, out_im, s, info);
      break;
    case kBulk * 4 + 3:
      err = run_ring<3, kBulk>(p, which, re, im, twc, tws, z_re, z_im,
                               out_re, out_im, s, info);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// P2: one variant. load reads re/im and writes out (the input's shape);
// s1 and s1tw read re/im and write z; load2 and s2 read z (passed as
// re/im too) and write out (z's shape, or (size, m)); full reads re/im
// and writes z, then out.
extern "C" int cip_fft_ablation(
    int variant, const float* re, const float* im, const float* twc,
    const float* tws, const float* tw1, const float* tw2, float* z_re,
    float* z_im, float* out_re, float* out_im, int n1, int n2, int c,
    int j1a, int n1i, int pad_lo, int64_t in_rows, int k2a, int trim0,
    int size, int sign, int64_t radices1, int64_t radices2, int cols1,
    int cols2, int64_t m, int* info, void* stream) {
  Pass p{};
  if (!fill_probe_pass(p, re, im, tw1, tw2, z_re, z_im, n1, n2, c, j1a, n1i,
                       pad_lo, in_rows, k2a, trim0, size, sign, radices1,
                       radices2, cols1, cols2, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 4; ++k) info[k] = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b1 = static_cast<unsigned>(n2);
  const unsigned b2 = static_cast<unsigned>(n1);
  const float* zr = z_re;
  const float* zi = z_im;
  cudaError_t err;
  switch (variant) {
    case kLoad:
      err = launch_variant(load_kernel<kCols, 1>, tile_bytes(p.f1), b1, m, s,
                           info, p, re, im, out_re, out_im);
      break;
    case kLoad2:
      err = launch_variant(load_kernel<kCols, 2>, tile_bytes(p.f2), b2, m, s,
                           info + 2, p, zr, zi, out_re, out_im);
      break;
    case kS1:
      err = launch_variant(stage1_kernel<kCols, Stage1YOut>,
                           smem_bytes(p.f1, kCols), b1, m, s, info, p, re,
                           im, twc, tws, z_re, z_im);
      break;
    case kS1Tw:
    case kFull:
      err = launch_variant(stage1_kernel<kCols>, smem_bytes(p.f1, kCols), b1,
                           m, s, info, p, re, im, twc, tws, z_re, z_im);
      if (err != cudaSuccess || variant == kS1Tw) break;
      [[fallthrough]];
    case kS2:
      err = launch_variant(stage2_kernel<kCols>, smem_bytes(p.f2, kCols), b2,
                           m, s, info + 2, p, zr, zi, out_re, out_im);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
