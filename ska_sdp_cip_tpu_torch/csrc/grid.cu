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
// order that changed from run to run. The third had no atomics: warp w
// owned rows [w * H, w * H + H) of the rectangle and took the
// visibilities that reached them one at a time, each lane adding one
// cell with a shared load, add and store; along a tile run, whose
// consecutive slots are one baseline's channels and mostly share a
// footprint start, every step waited on the shared read-after-write of
// the step before. On the cycle cell's invert (116 M visibilities, a
// 15360^2 grid, five plane groups) it took 429 ms: 147.7 ms (34%) of it
// window selection and staging, 74.6 ms of that selection alone (its
// steps cut out; PERF.md). This design takes 160 ms there, with the
// same selection and staging now beside the steps, and is bound by its
// issue rate and latencies at three thread blocks an SM (two: 50 ms a
// group, three: 38; no arithmetic unit is busy: the sums' multiply-adds
// cut out, the time does not move). On sparse plans, where neighbouring
// slots rarely share a start, it takes about what the third took (the
// snapshot's 258k visibilities: 5.4 against 6.1 ms) and up to 1.6 times
// as long (the bench group: 3.6 against 2.2 ms).
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
//     column pieces (ops/gridder.py:grid_chunk_blocks: few in a dense
//     group, many in a sparse one);
//   * owners: thread oi * W + oj owns every cell of the rectangle whose
//     rectangle-local (row mod W, column mod W) is (oi, oj), in all 2G
//     planes: of each footprint (the W x W cells after floor(pos -
//     W/2)), exactly one cell. It walks the chunk's staged visibilities
//     in slot order and keeps its cell's 2G sums in registers while the
//     cell stays the same (a footprint that moves one cell moves the
//     cells of only W of the W^2 owners), adding ax * (vis * amp) * ay,
//     the TPU kernel's product order. When its cell changes, and at the
//     chunk's end, it adds the sums to the cell in the rectangle's
//     shared planes (a shared load, add and store) and starts again
//     from zero. Each cell has one writer, which adds in slot order, so
//     a cell's value is a sum of partial sums in an order fixed by the
//     plan and the work list: repeat runs give the same bits, with no
//     atomics. Four staged visibilities that share the owner's last
//     start are taken together, their loads issued first;
//   * stagers: the kBatch threads after the owners walk the runs'
//     blocks in order, 1024 slots at a time: a ballot per 32 slots and
//     a prefix over the ballots select, in slot order, the slots whose
//     footprint meets the rectangle after the fold; each selected slot
//     is staged by a thread: its W + W ES factors (expf, sqrtf, IEEE,
//     no fast math), 2G vis * amp, and its rectangle-local start with
//     (-start) mod W in one word, or -1 if the amps are all zero. The
//     staged fill a ring of two buffers of kBatch in slot order, handed
//     over with named barriers (a full and an empty one a buffer), so
//     the next batch is selected and staged while the owners step
//     through this one;
//   * rows and columns are addressed modulo N, so footprints that cross
//     the periodic edge, and tiles whose patch wraps, need no other
//     path. A footprint's start is kept rectangle-local, in (-W, nrows)
//     x (-W, ncols): a start within W - 1 cells below N is one that wraps
//     into the rectangle's first rows or columns. That is exact because
//     no rectangle spans more than N - W + 1 rows or columns, so no
//     footprint meets one on both sides (the work list's rule). Grid
//     offsets are 64-bit, and the byte fields of a staged start hold
//     rectangle-local values, so N is bounded by the card's memory
//     only. A grid narrower than a patch (N < max(tile_x, patch_y))
//     takes the generic kernel with a true modulo (kMod), where a
//     patch-relative offset reaches 2N and beyond.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWindow = 1024;  // slots of a block selected at a time
constexpr int kBatch = 128;  // selected visibilities staged at a time
constexpr int kRun = 4;  // staged visibilities an owner takes at a time
constexpr int kMaxThreads = 16 * 16 + kBatch;  // the most owners, stagers
// Named barriers: the stagers' own, and a full and an empty barrier for
// each of the ring's two buffers (0 is __syncthreads').
constexpr int kStagerBar = 1, kFullBar = 2, kEmptyBar = 4;
constexpr int kHead = 4;  // row0, nrows, col0, ncols; then (first, count)s
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float es_kernel(float z, float beta) {
  // Same op order as ops/kernels.py:es_kernel (t = 1 - z*z,
  // exp(beta*s - beta)); zero outside |z| < 1.
  const float t = 1.0f - z * z;
  if (!(t > 0.0f)) return 0.0f;
  return expf(beta * sqrtf(t) - beta);
}

// bar.sync / bar.arrive on named barrier `id` of `n` threads (whole
// warps). An arrive orders the arriving thread's earlier shared-memory
// accesses before the accesses that follow the matching sync.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// x mod n: for x in [-n, 2n), or with kMod for any x >= -n.
template <bool kMod>
__device__ __forceinline__ int wrap(int x, int n) {
  if (kMod) return x < 0 ? x + n : x % n;
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

// Shared memory, in floats: the ring's two staging buffers (kBatch
// packed footprint starts, 2G vis * amps and W + W factors each), the
// window's selected slots, ballots and their offsets, the ring's fills
// and last flags, and the 2G planes of the rectangle.
struct Layout {
  int pos, amps, fac, sel, masks, offs, ring, planes, total;
  __host__ __device__ Layout(int G, int kw, int max_rows, int stride) {
    amps = 0;  // first: 16-byte vectors
    pos = amps + 2 * kBatch * 2 * G;
    fac = pos + 2 * kBatch;
    sel = fac + 2 * kBatch * (2 * kw + 1);
    masks = sel + kWindow;
    offs = masks + kWindow / 32;
    ring = offs + kWindow / 32 + 1;
    planes = ring + 4;
    total = planes + 2 * G * max_rows * stride;
  }
};

// The owners' threads, W^2 rounded up to whole warps; the kBatch
// stagers follow them.
__host__ __device__ constexpr int owner_threads(int kw) {
  return (kw * kw + 31) / 32 * 32;
}

// The threads of a launch at support W > 0, and the thread blocks it
// asks the compiler to fit on an SM (registers for three: the rectangle
// and the ring hold 73 KB of shared memory at W = 8, G = 2); at W = 0,
// the most threads any support takes.
template <int W>
struct Bounds {
  static constexpr int threads =
      W > 0 ? owner_threads(W) + kBatch : kMaxThreads;
  static constexpr int blocks = W > 0 ? 3 : 1;
};

// W > 0: the support, unrolled; W = 0: any support up to 16. kMod: a
// grid narrower than a patch (true modulo wraps).
template <int G, int W, bool kMod>
__global__ void __launch_bounds__(Bounds<W>::threads, Bounds<W>::blocks)
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
  const int stride = max_cols + kw;  // a row's pitch
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
  int* ring = reinterpret_cast<int*>(smem + lay.ring);  // fill[2], last[2]
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
  __syncthreads();

  // The first owner_threads() threads are the owners' warps: owner
  // t = oi * W + oj < W^2 holds the 2G planes of every cell of the
  // rectangle whose (row mod W, column mod W) is (oi, oj), the one cell
  // of each footprint with that residue. The kBatch threads after them
  // are the stagers. The two meet at a ring of two staging buffers:
  // named barrier kFullBar + b says buffer b is staged, kEmptyBar + b
  // that its owners are done with it.
  const int nthreads = blockDim.x;
  const int stager = threadIdx.x - owner_threads(kw);
  if (stager >= 0) {
    // ---- Stagers: select each window's slots, stage them in order. ----
    const int t = stager;
    const float half = 0.5f * static_cast<float>(support);
    int b = 0, n = 0;  // the buffer being staged and its entries
    bool pending[2] = {false, false};  // published, not yet released
    auto publish = [&](bool end) {
      if (t == 0) {
        ring[b] = n;
        ring[2 + b] = end;
      }
      bar_arrive(kFullBar + b, nthreads);
      pending[b] = true;
      b ^= 1;
      n = 0;
      if (pending[b]) {
        bar_sync(kEmptyBar + b, nthreads);
        pending[b] = false;
      }
    };
    const int nsrc = (chunk_width - kHead) / 2;
    for (int s = 0; s < nsrc; ++s) {
      const int first = chunk[kHead + 2 * s];
      const int count = chunk[kHead + 2 * s + 1];
      if (count == 0) break;
      // The rectangle-local row and column of the run's patch cell
      // (0, 0), modulo N: alloc row r lands on periodic (r - W) mod N.
      const int b_first = blocks[first];
      const int prow = wrap<false>(
          (block_ox[b_first] - support - row0) % ngrid, ngrid);
      const int pcol = wrap<false>(
          (block_oy[b_first] - support - col0) % ngrid, ngrid);
      for (int bi = 0; bi < count; ++bi) {
        const int blk = blocks[first + bi];
        const int len = block_len[blk];
        const int64_t s0 = static_cast<int64_t>(blk) * block;
        for (int wbase = 0; wbase < len; wbase += kWindow) {
          // The window's slots whose footprint meets the rectangle, in
          // slot order: a ballot a 32 slots, a prefix over the ballots,
          // and each selected slot's offset written to sel at its rank.
          float xs[kWindow / kBatch], ys[kWindow / kBatch];
#pragma unroll
          for (int i = 0; i < kWindow / kBatch; ++i) {
            const int e = t + i * kBatch;
            const bool inw = wbase + e < len;
            xs[i] = inw ? xpos[s0 + wbase + e] : 0.0f;
            ys[i] = inw ? ypos[s0 + wbase + e] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kWindow / kBatch; ++i) {
            const int e = t + i * kBatch;
            // Candidate cells: the W after floor(pos - W/2), the only
            // ones with |cell - pos| < W/2 (ops/cuda_gridder.py checks
            // that float32(2/W) rounds up, so the cells either side
            // evaluate to exactly zero).
            const int lr = signed_start(
                wrap<kMod>(prow + static_cast<int>(floorf(xs[i] - half)) + 1,
                           ngrid), kw, ngrid);
            const int lc = signed_start(
                wrap<kMod>(pcol + static_cast<int>(floorf(ys[i] - half)) + 1,
                           ngrid), kw, ngrid);
            const unsigned m = __ballot_sync(
                kFull, wbase + e < len && lr < nrows && lc < ncols);
            if (lane == 0) masks[e >> 5] = m;
          }
          bar_sync(kStagerBar, kBatch);
          if (t < 32) {
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
          bar_sync(kStagerBar, kBatch);
#pragma unroll
          for (int i = 0; i < kWindow / kBatch; ++i) {
            const int e = t + i * kBatch;
            const unsigned m = masks[e >> 5];
            const unsigned below = m & ((1u << (e & 31)) - 1u);
            if ((m >> (e & 31)) & 1u) sel[offs[e >> 5] + __popc(below)] = e;
          }
          bar_sync(kStagerBar, kBatch);
          const int nsel = offs[32];
          // The selected, appended to the ring in slot order: each its
          // W + W ES factors (clipped to the patch the TPU kernel
          // holds), its 2G vis * amp and its packed start, or -1 where
          // the amps are all zero.
          for (int i0 = 0; i0 < nsel;) {
            const int take = min(kBatch - n, nsel - i0);
            if (t < take) {
              const int64_t slot = s0 + wbase + sel[i0 + t];
              const float x = xpos[slot], y = ypos[slot];
              const float vr = vis_re[slot], vi = vis_im[slot];
              const float w = ws[slot];
              const int e = b * kBatch + n + t;
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
              int packed_start = -1;
              if (any) {
                amps[e] = pack(a);
                float* f = fac + e * fac_len;
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
                const int lr =
                    signed_start(wrap<kMod>(prow + r0, ngrid), kw, ngrid);
                const int lc =
                    signed_start(wrap<kMod>(pcol + c0, ngrid), kw, ngrid);
                // Selected: lr in (-W, nrows), lc in (-W, ncols), and
                // the work list keeps rectangles that runs reach within
                // tile_x x grid_piece_cols, so lr + W and lc + W fit a
                // byte (the launch checks). With them, (-lr) mod W and
                // (-lc) mod W, from which each owner finds its cell.
                const int rm = (kw - (lr + kw) % kw) % kw;
                const int cm = (kw - (lc + kw) % kw) % kw;
                packed_start =
                    rm << 24 | cm << 16 | (lr + kw) << 8 | (lc + kw);
              }
              pos[e] = packed_start;
            }
            n += take;
            i0 += take;
            if (n == kBatch) publish(false);
          }
        }
      }
    }
    publish(true);
    for (int k = 0; k < 2; ++k) {
      if (pending[k]) bar_sync(kEmptyBar + k, nthreads);
    }
  } else {
    // ---- Owners: each buffer's entries in slot order. ----
    const bool owner = threadIdx.x < kw * kw;
    const int oi = threadIdx.x / kw;
    const int oj = threadIdx.x % kw;
    int cur = -1;  // the owner's cell (row * stride + column), or none
    float sum[2 * G] = {};
    // Adds the sums to the owner's cell and starts them again at zero.
    auto flush = [&]() {
#pragma unroll
      for (int q = 0; q < 2 * G; ++q) {
        if (cur >= 0) planes[q * pcells + cur] += sum[q];
        sum[q] = 0.0f;
      }
    };
    // The last footprint start the owner saw (as staged), the footprint
    // row and column of its cell there, and whether that cell lies in
    // the rectangle.
    int last = -1, di = 0, dj = 0;
    bool in = false;
    for (int b = 0;; b ^= 1) {
      bar_sync(kFullBar + b, nthreads);
      const int nv = ring[b];
      const bool done = ring[2 + b];
      if (owner) {
        // kRun entries at a time: where all of them share the owner's
        // last footprint start (the common case along a tile run),
        // their loads are issued together and only the sums move.
        const int* bpos = pos + b * kBatch;
        const float* bfac = fac + b * kBatch * fac_len;
        const AmpsT* bamps = amps + b * kBatch;
        for (int v0 = 0; v0 < nv; v0 += kRun) {
          int p[kRun];
          bool same = true;
#pragma unroll
          for (int u = 0; u < kRun; ++u) {
            p[u] = v0 + u < nv ? bpos[v0 + u] : -1;
            same = same && p[u] == last;
          }
          if (same) {
            if (in) {
              float ax[kRun], ay[kRun], a[kRun][2 * G];
#pragma unroll
              for (int u = 0; u < kRun; ++u) {
                const float* f = bfac + (v0 + u) * fac_len;
                ax[u] = f[di];
                ay[u] = f[kw + dj];
                unpack(bamps[v0 + u], a[u]);
              }
#pragma unroll
              for (int u = 0; u < kRun; ++u) {
#pragma unroll
                for (int q = 0; q < 2 * G; ++q) {
                  // ax * (vis * amp) first, then * ay: the TPU kernel's
                  // order.
                  sum[q] = sum[q] + ax[u] * a[u][q] * ay[u];
                }
              }
            }
            continue;
          }
#pragma unroll
          for (int u = 0; u < kRun; ++u) {
            if (p[u] < 0) continue;  // amps all zero, or past nv
            if (p[u] != last) {
              // A new start: the owner's cell is (lr + di, lc + dj),
              // di = (oi - lr) mod W, dj = (oj - lc) mod W.
              last = p[u];
              di = oi + (last >> 24);
              di -= di >= kw ? kw : 0;
              dj = oj + ((last >> 16) & 0xff);
              dj -= dj >= kw ? kw : 0;
              const int r = ((last >> 8) & 0xff) - kw + di;
              const int c = (last & 0xff) - kw + dj;
              in = static_cast<unsigned>(r) < static_cast<unsigned>(nrows) &&
                   static_cast<unsigned>(c) < static_cast<unsigned>(ncols);
              if (in && r * stride + c != cur) {
                flush();
                cur = r * stride + c;
              }
            }
            if (in) {
              const float* f = bfac + (v0 + u) * fac_len;
              const float ax = f[di];
              const float ay = f[kw + dj];
              float a[2 * G];
              unpack(bamps[v0 + u], a);
#pragma unroll
              for (int q = 0; q < 2 * G; ++q) sum[q] = sum[q] + ax * a[q] * ay;
            }
          }
        }
      }
      bar_arrive(kEmptyBar + b, nthreads);
      if (done) break;
    }
    if (owner) flush();
  }
  __syncthreads();
  for (int qr = warp; qr < 2 * G * nrows; qr += nwarps) {
    const int q = qr / nrows, r = qr % nrows;
    float* row = dst + q * plane + static_cast<int64_t>(r) * ngrid;
    const float* src = planes + q * pcells + r * stride;
    for (int c = lane; c < ncols; c += 32) row[c] = src[c];
  }
}

template <int G, int W, bool kMod>
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
  // A footprint's W cells are distinct cells of the period; a staged
  // start's rectangle-local fields take a byte each.
  if (kw < 1 || kw > 16 || chunk_width < kHead + 2 || ngrid < kw ||
      max_rows + kw > 255 || max_cols + kw > 255) {
    return cudaErrorInvalidValue;
  }
  const int threads = owner_threads(kw) + kBatch;
  const Layout lay(G, kw, max_rows, max_cols + kw);
  const size_t smem = sizeof(float) * lay.total;
  cudaError_t err = cudaFuncSetAttribute(
      grid_chunks_kernel<G, W, kMod>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (num_chunks > 0) {
    grid_chunks_kernel<G, W, kMod><<<num_chunks, threads, smem, stream>>>(
        xpos, ypos, ws, vis_re, vis_im, block_len, block_ox, block_oy,
        blocks, chunks, chunk_width, w_g, out, block, patch_x, patch_y,
        max_rows, max_cols, support, beta, inv_half, inv_whalf, wstacking,
        ngrid);
  }
  return cudaGetLastError();
}

// The kernel for this support and grid: unrolled at W = 6 and 8 (the
// bench and production supports), else the generic one; a grid
// narrower than a patch takes the generic one with a true modulo.
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
  if (ngrid < max(max_rows, patch_y)) return run(launch<G, 0, true>);
  if (support == 6) return run(launch<G, 6, false>);
  if (support == 8) return run(launch<G, 8, false>);
  return run(launch<G, 0, false>);
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
