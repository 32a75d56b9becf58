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
// floats once and writes 2G N x N planes once; its arithmetic is
// 2G * W^2 multiply-adds a visibility. On an H100 (3.35 TB/s) that is
// 0.12 ms for the bench plan's largest plane group (6961 blocks, 6.06M
// visibilities, 4096^2 planes) and 1.13 ms at production (272k
// visibilities, 15360^2 planes: the planes alone). The first design
// (a thread block per active block, shared and global float atomics)
// took 8.6 ms a bench group; the second (a thread block per chunk of a
// tile run, shared-memory float atomics, which are compare-and-swap
// loops on this card, ATOMS.CAST.SPIN, and global float4 atomic adds
// for every row another chunk shared) 1.9 ms, and its sums ran in an
// order that changed from run to run. This design has no atomics:
// every cell's sum runs in an order fixed by the plan and the work
// list, so two runs on the same inputs give the same bits. At bench
// size the per-visibility steps bound it: their bookkeeping and the
// latency of each step's shared load, add and store, not the
// multiply-adds (B4, G = 1, takes as long as G = 2); at production the
// planes' writes do.
//
// Design:
//   * the unit of work is a chunk of the host's work list
//     (ops/gridder.py:grid_chunks): a destination rectangle of the
//     periodic grid, at most tile_x rows by 64 columns where runs reach
//     it, and the tile runs whose patches reach it after the fold, in
//     run order. The rectangles partition the grid, so each cell is
//     written once, with a plain store, by the one thread block that
//     owns it (the caller need not zero the planes). A chunk that no
//     run reaches is filled with zeros. Heavy rectangles are cut into
//     column pieces, so the uv centre's tiles spread over thread blocks;
//   * a thread block keeps its rectangle's 2G planes in shared memory
//     and walks its runs' blocks in order, 1024 slots at a time: a
//     ballot per 32 slots and a prefix over the ballots select, in slot
//     order, the slots whose footprint (the W cells after
//     floor(pos - W/2)) meets the rectangle after the fold. The selected
//     are staged 128 at a time, a thread each: its W + W ES factors
//     (expf, sqrtf, IEEE, no fast math) and 2G vis * amp, skipped if
//     the amps are all zero. Two staging buffers: a batch's loads are
//     issued before the previous batch's steps and its factors written
//     after them, so a batch costs one barrier;
//   * warp w owns rows [w * H, w * H + H) of the rectangle, H = 32 / W
//     (5 at W = 6, 4 at W = 8). It takes the staged visibilities that
//     reach its rows in slot order, one at a time (a ballot of 32, then
//     its set bits lowest first); lane (i, j) adds footprint column j
//     to its row i with a plain shared load, add and store. A cell is
//     added to only by its row's warp, one visibility after the other
//     in slot order, so no order depends on warp timing. Rows are
//     64 + W floats apart: the lanes of one step hit distinct banks.
//     The product order is ax * (vis * amp) * ay, the TPU kernel's;
//   * rows and columns are addressed modulo N, so footprints that cross
//     the periodic edge, and tiles whose patch wraps, need no other
//     path.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWindow = 1024;  // slots of a block selected at a time
constexpr int kBatch = 128;  // selected visibilities staged at a time
constexpr int kMaxThreads = 512;  // a warp a band: tile_x <= 40 rows
constexpr int kHead = 4;  // row0, nrows, col0, ncols; then (first, count)s
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float es_kernel(float z, float beta) {
  // Same op order as ops/kernels.py:es_kernel (t = 1 - z*z,
  // exp(beta*s - beta)); zero outside |z| < 1.
  const float t = 1.0f - z * z;
  if (!(t > 0.0f)) return 0.0f;
  return expf(beta * sqrtf(t) - beta);
}

// x mod n, for x in [-n, 2n).
__device__ __forceinline__ int wrap(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
}

// The rectangle-local start of a footprint from its start modulo n, in
// (-W, n - W]: starts within W - 1 cells below n are footprints that
// wrap past the periodic edge into the rectangle's first rows or
// columns.
__device__ __forceinline__ int signed_start(int x, int kw, int n) {
  return x > n - kw ? x - n : x;
}

// The 2G values vis * amp_p of a staged visibility (re_0, im_0, re_1,
// im_1), stored and loaded as one vector.
__device__ __forceinline__ float2 pack(const float (&a)[2]) {
  return make_float2(a[0], a[1]);
}
__device__ __forceinline__ float4 pack(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void unpack(float2 v, float (&a)[2]) {
  a[0] = v.x;
  a[1] = v.y;
}
__device__ __forceinline__ void unpack(float4 v, float (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
template <int G>
using AmpsOf = typename std::conditional<G == 1, float2, float4>::type;

// Shared memory, in floats: two staging buffers (kBatch footprint
// starts, 2G vis * amps and W + W factors each), the window's selected
// slots, ballots and their offsets, and the 2G planes of the rectangle.
struct Layout {
  int pos, amps, fac, sel, masks, offs, planes, total;
  __host__ __device__ Layout(int G, int kw, int max_rows, int stride) {
    amps = 0;  // first: 16-byte vectors
    pos = amps + 2 * kBatch * 2 * G;
    fac = pos + 2 * kBatch;
    sel = fac + 2 * kBatch * (2 * kw + 1);
    masks = sel + kWindow;
    offs = masks + kWindow / 32;
    planes = offs + kWindow / 32 + 1;
    total = planes + 2 * G * max_rows * stride;
  }
};

// W > 0: the support, unrolled; W = 0: any support up to 16.
template <int G, int W>
__global__ void __launch_bounds__(kMaxThreads)
grid_chunks_kernel(const float* __restrict__ xpos,
                   const float* __restrict__ ypos,
                   const float* __restrict__ ws,
                   const float* __restrict__ vis_re,
                   const float* __restrict__ vis_im,
                   const int32_t* __restrict__ block_len,
                   const int32_t* __restrict__ block_ox,
                   const int32_t* __restrict__ block_oy,
                   const int32_t* __restrict__ blocks,
                   const int32_t* __restrict__ chunks, int chunk_width,
                   const float* __restrict__ w_g,
                   float* __restrict__ out,
                   int block, int patch_x, int patch_y, int max_rows,
                   int max_cols, int support, float beta, float inv_half,
                   float inv_whalf, int wstacking, int ngrid) {
  using AmpsT = AmpsOf<G>;
  const int kw = W > 0 ? W : support;
  const int band = 32 / kw;  // rows a warp owns
  const int stride = max_cols + kw;  // a row's pitch: no bank conflicts
  const int pcells = max_rows * stride;
  const int fac_len = 2 * kw + 1;  // odd: staging hits no bank twice
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ float smem[];
  const Layout lay(G, kw, max_rows, stride);
  AmpsT* amps = reinterpret_cast<AmpsT*>(smem + lay.amps);  // [2][kBatch]
  int* pos = reinterpret_cast<int*>(smem + lay.pos);  // [2][kBatch]
  float* fac = smem + lay.fac;  // [2][kBatch][fac_len]
  int* sel = reinterpret_cast<int*>(smem + lay.sel);  // [kWindow]
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  int* offs = reinterpret_cast<int*>(smem + lay.offs);  // [kWindow/32 + 1]
  float* planes = smem + lay.planes;  // [2G][max_rows][stride]

  const int32_t* chunk =
      chunks + static_cast<int64_t>(blockIdx.x) * chunk_width;
  const int row0 = chunk[0], nrows = chunk[1];
  const int col0 = chunk[2], ncols = chunk[3];
  const int64_t plane = static_cast<int64_t>(ngrid) * ngrid;
  float* dst = out + static_cast<int64_t>(row0) * ngrid + col0;
  if (chunk[kHead + 1] == 0) {
    // No run reaches this rectangle: zeros, a warp a row.
    for (int qr = warp; qr < 2 * G * nrows; qr += nwarps) {
      float* row = dst + (qr / nrows) * plane +
                   static_cast<int64_t>(qr % nrows) * ngrid;
      for (int c = lane; c < ncols; c += 32) row[c] = 0.0f;
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * G * pcells; i += blockDim.x) {
    planes[i] = 0.0f;
  }

  // Warp w owns rows [w * band, w * band + band) of the rectangle; lane
  // (li, lj) adds footprint column lj to row li of them.
  const int wrow = warp * band;
  const int wrows = min(band, nrows - wrow);  // <= 0: the warp owns none
  const int li = lane / kw;
  const int lj = lane - li * kw;
  const int my_row = wrow + li;
  const bool lane_on = li < wrows;
  const float half = 0.5f * static_cast<float>(support);
  const int nsrc = (chunk_width - kHead) / 2;
  for (int s = 0; s < nsrc; ++s) {
    const int first = chunk[kHead + 2 * s];
    const int count = chunk[kHead + 2 * s + 1];
    if (count == 0) break;
    // The rectangle-local row and column of the run's patch cell (0, 0),
    // modulo N: alloc row r lands on periodic (r - W) mod N.
    const int b_first = blocks[first];
    const int prow = wrap((block_ox[b_first] - support - row0) % ngrid,
                          ngrid);
    const int pcol = wrap((block_oy[b_first] - support - col0) % ngrid,
                          ngrid);
    for (int bi = 0; bi < count; ++bi) {
      const int b = blocks[first + bi];
      const int len = block_len[b];
      const int64_t s0 = static_cast<int64_t>(b) * block;
      for (int wbase = 0; wbase < len; wbase += kWindow) {
        // The window's slots whose footprint meets the rectangle, in slot
        // order: a ballot a 32 slots, a prefix over the ballots, and
        // each selected slot's offset written to sel at its rank.
        float xs[kWindow / 256], ys[kWindow / 256];
#pragma unroll
        for (int i = 0; i < kWindow / 256; ++i) {
          const int e = threadIdx.x + i * blockDim.x;
          const bool in = e < kWindow && wbase + e < len;
          xs[i] = in ? xpos[s0 + wbase + e] : 0.0f;
          ys[i] = in ? ypos[s0 + wbase + e] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kWindow / 256; ++i) {
          const int e = threadIdx.x + i * blockDim.x;
          if (e < kWindow) {  // whole warps
            // Candidate cells: the W after floor(pos - W/2), the only
            // ones with |cell - pos| < W/2 (ops/cuda_gridder.py checks
            // that float32(2/W) rounds up, so the cells either side
            // evaluate to exactly zero).
            const int lr = signed_start(
                wrap(prow + static_cast<int>(floorf(xs[i] - half)) + 1,
                     ngrid), kw, ngrid);
            const int lc = signed_start(
                wrap(pcol + static_cast<int>(floorf(ys[i] - half)) + 1,
                     ngrid), kw, ngrid);
            const unsigned m = __ballot_sync(
                kFull, wbase + e < len && lr < nrows && lc < ncols);
            if (lane == 0) masks[e >> 5] = m;
          }
        }
        __syncthreads();
        if (warp == 0) {
          const int c = __popc(masks[lane]);
          int incl = c;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += up;
          }
          offs[lane] = incl - c;
          if (lane == 31) offs[32] = incl;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kWindow; e += blockDim.x) {
          const unsigned m = masks[e >> 5];
          const unsigned below = m & ((1u << (e & 31)) - 1u);
          if ((m >> (e & 31)) & 1u) sel[offs[e >> 5] + __popc(below)] = e;
        }
        __syncthreads();
        const int nsel = offs[32];
        // Staging of batch `base` into buffer `buf`: the loads first
        // (issued before the previous batch's steps), then the factors.
        float x = 0.0f, y = 0.0f, vr = 0.0f, vi = 0.0f, w = 0.0f;
        auto load = [&](int base) {
          const int t = base + threadIdx.x;
          if (threadIdx.x < kBatch && t < nsel) {
            const int64_t slot = s0 + wbase + sel[t];
            x = xpos[slot];
            y = ypos[slot];
            vr = vis_re[slot];
            vi = vis_im[slot];
            w = ws[slot];
          }
        };
        auto stage = [&](int base, int buf) {
          const int t = threadIdx.x;
          if (t >= kBatch) return;
          int p = -1;
          if (base + t < nsel) {
            const int r0 = static_cast<int>(floorf(x - half)) + 1;
            const int c0 = static_cast<int>(floorf(y - half)) + 1;
            float a[2 * G];
            bool any = false;
#pragma unroll
            for (int q = 0; q < G; ++q) {
              const float amp =
                  wstacking ? es_kernel((w_g[q] - w) * inv_whalf, beta)
                            : 1.0f;
              a[2 * q] = vr * amp;
              a[2 * q + 1] = vi * amp;
              any = any || a[2 * q] != 0.0f || a[2 * q + 1] != 0.0f;
            }
            if (any) {
              // The factors, clipped to the patch the TPU kernel holds.
              amps[buf * kBatch + t] = pack(a);
              float* f = fac + (buf * kBatch + t) * fac_len;
#pragma unroll
              for (int i = 0; i < kw; ++i) {
                const int rr = r0 + i, cc = c0 + i;
                f[i] = rr >= 0 && rr < patch_x
                           ? es_kernel((static_cast<float>(rr) - x) *
                                           inv_half, beta)
                           : 0.0f;
                f[kw + i] = cc >= 0 && cc < patch_y
                                ? es_kernel((static_cast<float>(cc) - y) *
                                                inv_half, beta)
                                : 0.0f;
              }
              const int lr = signed_start(wrap(prow + r0, ngrid), kw, ngrid);
              const int lc = signed_start(wrap(pcol + c0, ngrid), kw, ngrid);
              p = (lr + kw) << 16 | (lc + kw);
            }
          }
          pos[buf * kBatch + t] = p;
        };
        load(0);
        stage(0, 0);
        __syncthreads();
        for (int base = 0, buf = 0; base < nsel; base += kBatch, buf ^= 1) {
          load(base + kBatch);
          if (wrows > 0) {
            const int nv = min(kBatch, nsel - base);
            const int* bpos = pos + buf * kBatch;
            for (int v0 = 0; v0 < nv; v0 += 32) {
              const int pl = v0 + lane < nv ? bpos[v0 + lane] : -1;
              const int lr_l = (pl >> 16) - kw;
              unsigned todo = __ballot_sync(
                  kFull, pl >= 0 && lr_l < wrow + wrows && lr_l + kw > wrow);
              while (todo) {
                // The staged visibilities that reach this warp's rows, in
                // slot order: lane (li, lj) adds the one cell it owns.
                const int v = __ffs(todo) - 1;
                todo &= todo - 1;
                const int pv = __shfl_sync(kFull, pl, v);
                const int i = my_row - ((pv >> 16) - kw);
                const int c = (pv & 0xffff) - kw + lj;
                if (lane_on && i >= 0 && i < kw && c >= 0 && c < ncols) {
                  const float* f = fac + (buf * kBatch + v0 + v) * fac_len;
                  const float ax = f[i];
                  const float ay = f[kw + lj];
                  float a[2 * G];
                  unpack(amps[buf * kBatch + v0 + v], a);
                  float* cell = planes + my_row * stride + c;
                  float old[2 * G];
#pragma unroll
                  for (int q = 0; q < 2 * G; ++q) old[q] = cell[q * pcells];
#pragma unroll
                  for (int q = 0; q < 2 * G; ++q) {
                    // ax * (vis * amp) first, then * ay: the TPU
                    // kernel's order.
                    cell[q * pcells] = old[q] + ax * a[q] * ay;
                  }
                }
              }
            }
          }
          stage(base + kBatch, buf ^ 1);
          __syncthreads();
        }
      }
    }
  }
  __syncthreads();  // a chunk whose runs staged nothing still zeroed
  for (int qr = warp; qr < 2 * G * nrows; qr += nwarps) {
    const int q = qr / nrows, r = qr % nrows;
    float* row = dst + q * plane + static_cast<int64_t>(r) * ngrid;
    const float* src = planes + q * pcells + r * stride;
    for (int c = lane; c < ncols; c += 32) row[c] = src[c];
  }
}

template <int G, int W>
cudaError_t launch(const float* xpos, const float* ypos, const float* ws,
                   const float* vis_re, const float* vis_im,
                   const int32_t* block_len, const int32_t* block_ox,
                   const int32_t* block_oy, const int32_t* blocks,
                   const int32_t* chunks, int num_chunks, int chunk_width,
                   const float* w_g, float* out, int block, int patch_x,
                   int patch_y, int max_rows, int max_cols, int support,
                   float beta, float inv_half, float inv_whalf, int wstacking,
                   int ngrid, cudaStream_t stream) {
  const int kw = W > 0 ? W : support;
  const int band = 32 / kw;
  // A warp a band, and at least 256 threads (the window's selection
  // loads kWindow / 256 slots a thread).
  const int threads = 32 * max((max_rows + band - 1) / band, kWindow / 256 * 2);
  if (kw < 1 || kw > 16 || threads > kMaxThreads ||
      chunk_width < kHead + 2 || ngrid < max(max_rows, max_cols) + 2 * kw ||
      ngrid >= (1 << 15)) {
    return cudaErrorInvalidValue;
  }
  const Layout lay(G, kw, max_rows, max_cols + kw);
  const size_t smem = sizeof(float) * lay.total;
  cudaError_t err = cudaFuncSetAttribute(
      grid_chunks_kernel<G, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (num_chunks > 0) {
    grid_chunks_kernel<G, W><<<num_chunks, threads, smem, stream>>>(
        xpos, ypos, ws, vis_re, vis_im, block_len, block_ox, block_oy,
        blocks, chunks, chunk_width, w_g, out, block, patch_x, patch_y,
        max_rows, max_cols, support, beta, inv_half, inv_whalf, wstacking,
        ngrid);
  }
  return cudaGetLastError();
}

// The kernel for this support: unrolled at W = 6 and 8 (the bench and
// production supports), else the generic one.
template <int G>
cudaError_t launch_w(int support, const float* xpos, const float* ypos,
                     const float* ws, const float* vis_re,
                     const float* vis_im, const int32_t* block_len,
                     const int32_t* block_ox, const int32_t* block_oy,
                     const int32_t* blocks, const int32_t* chunks,
                     int num_chunks, int chunk_width, const float* w_g,
                     float* out, int block, int patch_x, int patch_y,
                     int max_rows, int max_cols, float beta, float inv_half,
                     float inv_whalf, int wstacking, int ngrid,
                     cudaStream_t stream) {
  auto run = [&](auto kernel_launch) {
    return kernel_launch(xpos, ypos, ws, vis_re, vis_im, block_len, block_ox,
                         block_oy, blocks, chunks, num_chunks, chunk_width,
                         w_g, out, block, patch_x, patch_y, max_rows,
                         max_cols, support, beta, inv_half, inv_whalf,
                         wstacking, ngrid, stream);
  };
  if (support == 6) return run(launch<G, 6>);
  if (support == 8) return run(launch<G, 8>);
  return run(launch<G, 0>);
}

}  // namespace

// C entry (bound with ctypes by ops/cuda_gridder.py). `out` receives
// 2G (ngrid, ngrid) float32 planes in the order re_0, im_0, re_1, im_1,
// ...; every cell is written, so it need not be zeroed. `chunks` holds
// num_chunks rows of chunk_width int32 (ops/gridder.py:grid_chunks):
// (row0, nrows, col0, ncols) of a destination rectangle, nrows at most
// max_rows and, where a run reaches it, ncols at most max_cols, then
// (first, count) over `blocks` of each run that reaches it, count 0 past
// the last. Returns the CUDA error code of the launch
// (0 = ok); G other than 1 and 2 returns cudaErrorInvalidValue.
extern "C" int cip_grid_planes(
    const float* xpos, const float* ypos, const float* ws,
    const float* vis_re, const float* vis_im, const int32_t* block_len,
    const int32_t* block_ox, const int32_t* block_oy, const int32_t* blocks,
    const int32_t* chunks, int num_chunks, int chunk_width, const float* w_g,
    int group, float* out, int block, int patch_x, int patch_y,
    int max_rows, int max_cols, int support, float beta, float inv_half,
    float inv_whalf, int wstacking, int ngrid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch_w<1>(support, xpos, ypos, ws, vis_re, vis_im, block_len,
                         block_ox, block_oy, blocks, chunks, num_chunks,
                         chunk_width, w_g, out, block, patch_x, patch_y,
                         max_rows, max_cols, beta, inv_half, inv_whalf,
                         wstacking, ngrid, s);
    case 2:
      return launch_w<2>(support, xpos, ypos, ws, vis_re, vis_im, block_len,
                         block_ox, block_oy, blocks, chunks, num_chunks,
                         chunk_width, w_g, out, block, patch_x, patch_y,
                         max_rows, max_cols, beta, inv_half, inv_whalf,
                         wstacking, ngrid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
