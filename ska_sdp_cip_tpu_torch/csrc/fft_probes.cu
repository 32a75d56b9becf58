// Probes of the fused first-axis pass (kernel B2) in its first design:
// two dense float32 complex products (csrc/fft_dense.cuh, the helpers
// B2 was built from before csrc/fft_fused.cu became shared-memory FFT
// stages). The probes keep measuring the design the TPU probes measured.
//
// Replaces two Pallas TPU probe kernels, as Hopper probes of the same
// questions:
//
// * P1, scripts/fft_split_fetch_probe.py (kernel :71): does the pass
//   go faster with more input fetches in flight? The TPU probe split
//   the input into K BlockSpecs (2K DMAs in flight). Here stage 1 is
//   cgemm_rows with its factor and input tiles streamed through an
//   S-deep ring of shared-memory buffers by cp.async (16-byte
//   cp.async.cg for the input rows, 4-byte cp.async.ca for the
//   transposed factor tile), S in {1, 2, 4}: chunk t + S - 1 is in
//   flight while chunk t is multiplied. Stage 2 is the dense pass's.
//   The loaded values, the multiply-adds and their order are the dense
//   pass's, so the output equals P2 `full` bit for bit.
//
// * P2, scripts/fft_ablation_probe.py (make_kernel :63): where does the
//   dense pass's time go? Compile-time variants of the same kernel with
//   later stages switched off:
//     load  stage 1's tiles loaded into shared memory and written
//           straight back (row-tile 0 writes; the output is the input);
//     s1    the stage-1 product only (no twiddle);
//     s1tw  stage 1 + twiddle, i.e. z (the first launch);
//     s2    stage 2 + crop on a given z (the second launch);
//     full  both launches (the dense pass).
//   The TPU probe's s1twtr variant (plus the in-VMEM transpose between
//   the stages) has no counterpart: the two-launch design writes z to
//   device memory and stage 2 reads it in its own layout.
//
// What bounds them on Hopper: the probes exist to measure that (PERF.md
// has the split); `load` is bound by device-memory reads, the product
// variants by float32 FMA issue.

#include "fft_dense.cuh"

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (4) bytes global -> shared, or zero-fill when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One ring slot: the factor tile and the input tile of one chunk.
constexpr int kSlotFloats = 2 * kTK * (kTM + 1) + 2 * kTK * kTN;

struct Slot {
  ATile* a_re;
  ATile* a_im;
  BTile* b_re;
  BTile* b_im;
  __device__ explicit Slot(float* base)
      : a_re(reinterpret_cast<ATile*>(base)),
        a_im(reinterpret_cast<ATile*>(base + kTK * (kTM + 1))),
        b_re(reinterpret_cast<BTile*>(base + 2 * kTK * (kTM + 1))),
        b_im(reinterpret_cast<BTile*>(base + 2 * kTK * (kTM + 1) +
                                      kTK * kTN)) {}
};

// Issue chunk k0's copies into ``slot``: load_chunk's values, async.
// Needs m % 4 == 0 and col0 + kTN <= m (whole column tiles).
__device__ __forceinline__ void issue_chunk(const Stage1& st,
                                            const float* in_re,
                                            const float* in_im, int64_t m,
                                            int64_t col0, int row0, int batch,
                                            int k0, const Slot& slot) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int l = 0; l < (kTM * kTK) / kThreads; ++l) {
    const int e = tid + l * kThreads;
    const int i = e / kTK;
    const int k = e - i * kTK;
    const bool ok = (row0 + i < st.rows()) && (k0 + k < st.depth());
    const int64_t re_at = ok ? (row0 + i) * 2 * st.n1i + k0 + k : 0;
    const int64_t im_at = ok ? (st.n1 + row0 + i) * 2 * st.n1i + k0 + k : 0;
    cp_async4(&slot.a_re[k][i], st.m1 + re_at, ok);
    cp_async4(&slot.a_im[k][i], st.m1 + im_at, ok);
  }
  // kTK x kTN floats = kThreads copies of 4 floats, one per thread.
  const int k = tid / (kTN / 4);
  const int cc = (tid - k * (kTN / 4)) * 4;
  const bool ok = k0 + k < st.depth();
  const int64_t off = ok ? st.in_offset(batch, k0 + k, col0 + cc, m) : 0;
  cp_async16(&slot.b_re[k][cc], in_re + off, ok);
  cp_async16(&slot.b_im[k][cc], in_im + off, ok);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
stage1_ring(Stage1 st, const float* __restrict__ in_re,
            const float* __restrict__ in_im, float* __restrict__ out_re,
            float* __restrict__ out_im, int64_t m) {
  extern __shared__ __align__(16) float ring[];
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTN;
  const int row0 = blockIdx.y * kTM;
  const int batch = blockIdx.z;
  const int chunks = (st.depth() + kTK - 1) / kTK;
  float acc_re[4][4], acc_im[4][4];
  zero_acc(acc_re, acc_im);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < chunks) {
      issue_chunk(st, in_re, in_im, m, col0, row0, batch, s * kTK,
                  Slot(ring + s * kSlotFloats));
    }
    cp_async_commit();
  }
  for (int t = 0; t < chunks; ++t) {
    const int next = t + S - 1;
    if (next < chunks) {
      issue_chunk(st, in_re, in_im, m, col0, row0, batch, next * kTK,
                  Slot(ring + (next % S) * kSlotFloats));
    }
    cp_async_commit();
    cp_async_wait<S - 1>();  // chunk t has landed
    __syncthreads();
    const Slot slot(ring + (t % S) * kSlotFloats);
    mac_chunk(slot.a_re, slot.a_im, slot.b_re, slot.b_im, acc_re, acc_im);
    __syncthreads();  // slot t % S is free for chunk t + S
  }
  store_tile(st, out_re, out_im, m, col0, row0, batch, acc_re, acc_im);
}

template <int S>
cudaError_t launch_ring(const Stage1& st, const float* re, const float* im,
                        float* z_re, float* z_im, int64_t m,
                        cudaStream_t stream) {
  const int bytes = S * kSlotFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      stage1_ring<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  stage1_ring<S><<<gemm_grid(st.n1, st.n2, m), kThreads, bytes, stream>>>(
      st, re, im, z_re, z_im, m);
  return cudaGetLastError();
}

// Stage 1 without the twiddle (the `s1` variant).
struct Stage1Raw : Stage1 {
  __device__ void post(int, int, float&, float&) const {}
};

// Stage 1's loads only: each chunk's input tile goes through shared
// memory and back to out at its own place (row tile 0 writes).
__global__ void __launch_bounds__(kThreads)
load_only(Stage1 st, const float* __restrict__ in_re,
          const float* __restrict__ in_im, float* __restrict__ out_re,
          float* __restrict__ out_im, int64_t m) {
  __shared__ float a_re[kTK][kTM + 1], a_im[kTK][kTM + 1];
  __shared__ float b_re[kTK][kTN], b_im[kTK][kTN];
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTN;
  const int row0 = blockIdx.y * kTM;
  const int batch = blockIdx.z;
  for (int k0 = 0; k0 < st.depth(); k0 += kTK) {
    load_chunk(st, in_re, in_im, m, col0, row0, batch, k0, a_re, a_im, b_re,
               b_im);
    __syncthreads();
    if (blockIdx.y == 0) {
#pragma unroll
      for (int l = 0; l < (kTK * kTN) / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int k = e / kTN;
        const int cc = e - k * kTN;
        if (k0 + k < st.depth() && col0 + cc < m) {
          const int64_t off = st.in_offset(batch, k0 + k, col0 + cc, m);
          out_re[off] = b_re[k][cc];
          out_im[off] = b_im[k][cc];
        }
      }
    }
    __syncthreads();
  }
}

enum Variant { kLoad = 0, kS1 = 1, kS1Tw = 2, kS2 = 3, kFull = 4 };

}  // namespace

// C entries (bound with ctypes by probes/fft_async_fetch.py and
// probes/fft_ablation.py): re/im, the dense factors m1/twc/tws/m2
// (fused_pass_host_arrays), z scratch, out, then n1, n1i, n2, C, QB,
// QS, trim0, size, m and the stream. Return the CUDA error code (0 =
// ok).
//
// The pass with stage 1 through an S-deep cp.async ring (S = 1, 2, 4).
// Needs m % 64 == 0 and 16-byte-aligned re/im.
extern "C" int cip_fft_async_fetch(
    int stages, const float* re, const float* im, const float* m1,
    const float* twc, const float* tws, const float* m2, float* z_re,
    float* z_im, float* out_re, float* out_im, int n1, int n1i, int n2,
    int c, int qb, int qs, int trim0, int size, int64_t m, void* stream) {
  if (c <= 0 || n2 % c != 0 || m % kTN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Stage1 s1{m1, twc, tws, n1, n1i, n2, c};
  const auto ring = [&]() -> cudaError_t {
    switch (stages) {
      case 1: return launch_ring<1>(s1, re, im, z_re, z_im, m, s);
      case 2: return launch_ring<2>(s1, re, im, z_re, z_im, m, s);
      case 4: return launch_ring<4>(s1, re, im, z_re, z_im, m, s);
      default: return cudaErrorInvalidValue;
    }
  };
  return static_cast<int>(launch_pass(ring, s1, m2, z_re, z_im, out_re,
                                      out_im, qb, qs, trim0, size, m, s));
}

// One ablation variant. in/out per variant: load (n1i n2, m) ->
// (n1i n2, m); s1 and s1tw (n1i n2, m) -> (n1 n2, m); s2 (n1 n2, m) z ->
// (size, m); full (n1i n2, m) -> z scratch -> (size, m).
extern "C" int cip_fft_ablation(
    int variant, const float* re, const float* im, const float* m1,
    const float* twc, const float* tws, const float* m2, float* z_re,
    float* z_im, float* out_re, float* out_im, int n1, int n1i, int n2,
    int c, int qb, int qs, int trim0, int size, int64_t m, void* stream) {
  if (c <= 0 || n2 % c != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Stage1 s1{m1, twc, tws, n1, n1i, n2, c};
  const Stage2 s2{m2, n1, n2, c, qb, qs, trim0, size};
  switch (variant) {
    case kLoad:
      load_only<<<gemm_grid(n1, n2, m), kThreads, 0, s>>>(s1, re, im, out_re,
                                                          out_im, m);
      return static_cast<int>(cudaGetLastError());
    case kS1:
      return static_cast<int>(launch(Stage1Raw{s1}, n1, n2, re, im, out_re,
                                     out_im, m, s));
    case kS1Tw:
      return static_cast<int>(launch(s1, n1, n2, re, im, out_re, out_im, m,
                                     s));
    case kS2:
      return static_cast<int>(launch(s2, qb * qs, n1, re, im, out_re, out_im,
                                     m, s));
    case kFull:
      return static_cast<int>(launch_pass(
          [&] { return launch(s1, n1, n2, re, im, z_re, z_im, m, s); }, s1,
          m2, z_re, z_im, out_re, out_im, qb, qs, trim0, size, m, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
