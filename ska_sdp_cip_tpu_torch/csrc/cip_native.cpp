// Native host-side planning engine for ska_sdp_cip_tpu.
//
// The TPU gridder's execution plan requires, per visibility sample:
// wavelength-scaled uv coordinates, w-flip, footprint cells, fractional
// offsets, and a (tile, w-bin) sort — O(nrow * nchan) host work that
// dominates time-to-first-image at production scale (1e8+ samples).
// The reference performs the analogous binning with a Python
// multiprocessing pool (reference: src/ska_sdp_cip/uvw_tiling/
// tiling_plan.py:84-134); here it is a multithreaded C++ engine
// exposed through a C ABI for ctypes (no pybind11 in this
// environment). Python falls back to the numpy implementation when
// the shared library is absent.
//
// Build: make -C native   (produces libcipnative.so)

#include <sys/mman.h>

#include <chrono>
#include <cerrno>
#include <cstdio>
#include <cstdlib>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kSpeedOfLight = 299792458.0;

bool debug_timing() {
    static const bool on = [] {
        const char* v = std::getenv("CIP_NATIVE_DEBUG");
        return v && v[0] == '1';
    }();
    return on;
}

struct PhaseTimer {
    std::chrono::steady_clock::time_point t =
        std::chrono::steady_clock::now();
    void mark(const char* name) {
        if (!debug_timing()) return;
        auto now = std::chrono::steady_clock::now();
        std::fprintf(stderr, "[cip_native] %-18s %.3f s\n", name,
                     std::chrono::duration<double>(now - t).count());
        t = now;
    }
};

int num_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? static_cast<int>(n) : 1;
}

// Run fn(t, begin, end) over [0, n) split across threads.
template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
    int nt = num_threads();
    if (n < 1 << 16 || nt == 1) {
        fn(0, 0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t begin = t * chunk;
        int64_t end = std::min(n, begin + chunk);
        if (begin >= end) break;
        threads.emplace_back([=] { fn(t, begin, end); });
    }
    for (auto& th : threads) th.join();
}

// Run body(begin, end) over [0, bytes) on 8 concurrent streams (or
// serially below 1 MB). Memory faults on lazily-backed VM memory are
// hypervisor-bound, not CPU-bound: MAP_POPULATE (serial, in-kernel)
// decays to ~40-80 MB/s as process RSS grows once the TPU runtime is
// loaded, while 8 concurrent fault streams sustain 2-3 GB/s under
// the same pressure (measured on the bench VM, 2026-08-21).
template <typename Body>
inline void parallel_byte_streams(size_t bytes, Body body) {
    constexpr int kStreams = 8;
    if (bytes < (size_t{1} << 20)) {
        body(size_t{0}, bytes);
        return;
    }
    const size_t chunk = (bytes + kStreams - 1) / kStreams;
    std::vector<std::thread> threads;
    threads.reserve(kStreams);
    for (int t = 0; t < kStreams; ++t) {
        const size_t begin = t * chunk;
        const size_t end = std::min(bytes, begin + chunk);
        if (begin >= end) break;
        threads.emplace_back([&body, begin, end] { body(begin, end); });
    }
    for (auto& th : threads) th.join();
}

// Pre-fault [p, p + bytes): one store per 4 KB page per stream.
inline void parallel_prefault(void* p, size_t bytes) {
    constexpr size_t kPage = 4096;
    auto* base = static_cast<volatile char*>(p);
    parallel_byte_streams(bytes, [base](size_t begin, size_t end) {
        for (size_t o = begin; o < end; o += kPage) base[o] = 0;
    });
}

// Warm-buffer arena: freed PBuf blocks are kept (power-of-two
// buckets) and reused instead of re-mmapped, because on the bench VM
// the hypervisor's fault rate collapses to ~100 MB/s once process RSS
// crosses ~1 GB while already-faulted pages rewrite at GB/s. The
// process holds its high-water scratch footprint for its lifetime —
// the right trade for a planning pipeline (mirrors
// utils/hostmem.py's python-side arena).
namespace {
std::mutex g_buf_arena_mu;
std::unordered_map<size_t, std::vector<void*>> g_buf_arena;

inline void* arena_acquire(size_t bucket) {
    std::lock_guard<std::mutex> lock(g_buf_arena_mu);
    auto it = g_buf_arena.find(bucket);
    if (it == g_buf_arena.end() || it->second.empty()) return nullptr;
    void* p = it->second.back();
    it->second.pop_back();
    return p;
}

inline void arena_release(void* p, size_t bucket) {
    std::lock_guard<std::mutex> lock(g_buf_arena_mu);
    g_buf_arena[bucket].push_back(p);
}

inline size_t arena_bucket(size_t bytes) {
    size_t b = size_t{1} << 20;
    while (b < bytes) b <<= 1;
    return b;
}

// Release every parked buffer back to the OS (allocation-failure
// recovery path).
inline void arena_drain() {
    std::lock_guard<std::mutex> lock(g_buf_arena_mu);
    for (auto& entry : g_buf_arena)
        for (void* p : entry.second) munmap(p, entry.first);
    g_buf_arena.clear();
}
}  // namespace

// Parallel memset(0) for warm (already-faulted) pages.
inline void parallel_memzero(void* p, size_t bytes) {
    auto* base = static_cast<char*>(p);
    parallel_byte_streams(bytes, [base](size_t begin, size_t end) {
        memset(base + begin, 0, end - begin);
    });
}

// Large scratch buffer backed by anonymous memory pre-faulted by
// concurrent touch threads (parallel_prefault above) or reused warm
// from the arena; vector::resize zero-fills on one thread and pays
// the serial slow path for every buffer.
template <typename T>
class PBuf {
  public:
    PBuf() = default;
    explicit PBuf(int64_t n) { reset(n); }
    ~PBuf() { release(); }
    PBuf(const PBuf&) = delete;
    PBuf& operator=(const PBuf&) = delete;
    void reset(int64_t n) {
        release();
        n_ = n;
        if (n <= 0) return;
        bytes_ = static_cast<size_t>(n) * sizeof(T);
        const size_t bucket = arena_bucket(bytes_);
        void* p = arena_acquire(bucket);
        if (p != nullptr) {
            // Warm pages (zeroing faults any never-touched bucket
            // tail lazily, on the same 8 streams).
            parallel_memzero(p, bytes_);
        } else {
            p = mmap(nullptr, bucket, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
            if (p == MAP_FAILED) {
                // Out of address space / overcommit: return the
                // arena's parked gigabytes to the OS and retry once
                // before failing LOUDLY — callers write through
                // data() unchecked, so a silent empty buffer would
                // be a null-deref segfault with no diagnostic.
                arena_drain();
                p = mmap(nullptr, bucket, PROT_READ | PROT_WRITE,
                         MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
            }
            if (p == MAP_FAILED) {
                fprintf(stderr,
                        "cip_native: mmap of %zu bytes failed "
                        "(errno %d) even after draining the warm "
                        "arena; aborting\n",
                        bucket, errno);
                abort();
            }
            // Fault only the REQUESTED bytes: the pow-of-two bucket
            // can be ~2x the request, and cold faults are the
            // expensive resource being rationed here. A later larger
            // reuse of this bucket faults the tail in its zeroing
            // pass.
            parallel_prefault(p, bytes_);
        }
        data_ = static_cast<T*>(p);
    }
    void release() {
        if (data_) arena_release(data_, arena_bucket(bytes_));
        data_ = nullptr;
        n_ = 0;
        bytes_ = 0;
    }
    T* data() { return data_; }
    const T* data() const { return data_; }
    T& operator[](int64_t i) { return data_[i]; }
    const T& operator[](int64_t i) const { return data_[i]; }
    int64_t size() const { return n_; }

  private:
    T* data_ = nullptr;
    int64_t n_ = 0;
    size_t bytes_ = 0;
};

}  // namespace

extern "C" {

// Min/max of |w| in wavelengths over all (row, chan) samples.
void cip_w_minmax(const double* uvw, int64_t nrow, const double* freqs,
                  int64_t nchan, double* wmin_out, double* wmax_out) {
    int nt = num_threads();
    std::vector<double> mins(nt, 1e300), maxs(nt, -1e300);
    parallel_for(nrow, [&](int t, int64_t begin, int64_t end) {
        double lo = 1e300, hi = -1e300;
        for (int64_t r = begin; r < end; ++r) {
            double w = uvw[3 * r + 2];
            for (int64_t c = 0; c < nchan; ++c) {
                double wl = std::fabs(w * freqs[c] / kSpeedOfLight);
                lo = std::min(lo, wl);
                hi = std::max(hi, wl);
            }
        }
        mins[t] = lo;
        maxs[t] = hi;
    });
    double lo = 1e300, hi = -1e300;
    for (int t = 0; t < nt; ++t) {
        lo = std::min(lo, mins[t]);
        hi = std::max(hi, maxs[t]);
    }
    *wmin_out = (nrow && nchan) ? lo : 0.0;
    *wmax_out = (nrow && nchan) ? hi : 0.0;
}

// Fused per-sample plan arrays (flattened row-major over (row, chan)):
// flip flag, footprint start cells (alloc frame), fractional offsets,
// |w| in wavelengths, and the (tile, wbin) lexicographic sort key.
void cip_plan_arrays(const double* uvw, int64_t nrow, const double* freqs,
                     int64_t nchan, double inv_du, int64_t ngrid,
                     int64_t support, int64_t tile_cells_x,
                     int64_t tile_cells_y, int64_t ntiles_y,
                     int wstacking, double w0_plane, double inv_dw,
                     int64_t nplanes,
                     uint8_t* flip, int32_t* x0, int32_t* y0, float* fx,
                     float* fy, float* ws, int64_t* key) {
    const int64_t half = support / 2;
    const double half_grid = static_cast<double>(ngrid) / 2.0;
    parallel_for(nrow, [&](int, int64_t begin, int64_t end) {
        for (int64_t r = begin; r < end; ++r) {
            const double bu = uvw[3 * r + 0];
            const double bv = uvw[3 * r + 1];
            const double bw = uvw[3 * r + 2];
            for (int64_t c = 0; c < nchan; ++c) {
                const int64_t i = r * nchan + c;
                const double scale = freqs[c] / kSpeedOfLight;
                double u = bu * scale, v = bv * scale, w = bw * scale;
                const bool neg = w < 0.0;
                if (neg) { u = -u; v = -v; w = -w; }
                flip[i] = neg ? 1 : 0;
                ws[i] = static_cast<float>(w);

                double x = std::fmod(u * inv_du + half_grid, (double)ngrid);
                if (x < 0) x += ngrid;
                x += support;
                double y = std::fmod(v * inv_du + half_grid, (double)ngrid);
                if (y < 0) y += ngrid;
                y += support;

                const int64_t cx = (int64_t)std::floor(x) - half + 1;
                const int64_t cy = (int64_t)std::floor(y) - half + 1;
                x0[i] = (int32_t)cx;
                y0[i] = (int32_t)cy;
                fx[i] = (float)(x - (double)cx);
                fy[i] = (float)(y - (double)cy);

                // Floor binning: data bin q = floor((w - wmin)/dw);
                // the gridder maps bin q to plane window [q, q + W).
                int64_t bin = 0;
                if (wstacking) {
                    bin = (int64_t)std::floor((w - w0_plane) * inv_dw);
                    bin = std::max<int64_t>(0,
                          std::min<int64_t>(bin, nplanes - 1));
                }
                const int64_t tid = (cx / tile_cells_x) * ntiles_y
                                  + (cy / tile_cells_y);
                key[i] = tid * nplanes + bin;
            }
        }
    });
}

// Parallel stable argsort of int64 keys (LSD radix, 8 bits/pass).
// order[i] receives the index of the i-th smallest key. Keys are
// non-negative (tile ids and bins).
void cip_argsort_i64(const int64_t* keys, int64_t n, int64_t* order) {
    PBuf<int64_t> idx_a(n), idx_b(n);
    PBuf<int64_t> key_a(n), key_b(n);
    int nt0 = num_threads();
    std::vector<int64_t> maxs(nt0, 0);
    parallel_for(n, [&](int t, int64_t b, int64_t e) {
        int64_t mk = 0;
        for (int64_t i = b; i < e; ++i) {
            idx_a[i] = i;
            key_a[i] = keys[i];
            mk = std::max(mk, keys[i]);
        }
        maxs[t] = mk;
    });
    int64_t maxkey = 0;
    for (int t = 0; t < nt0; ++t) maxkey = std::max(maxkey, maxs[t]);

    const int kRadix = 256;
    int passes = 0;
    while ((maxkey >> (8 * passes)) != 0 && passes < 8) ++passes;
    if (passes == 0) passes = 1;

    int nt = num_threads();
    std::vector<int64_t> hist(static_cast<size_t>(nt) * kRadix);

    int64_t* ka = key_a.data(); int64_t* kb = key_b.data();
    int64_t* ia = idx_a.data(); int64_t* ib = idx_b.data();

    for (int p = 0; p < passes; ++p) {
        const int shift = 8 * p;
        std::fill(hist.begin(), hist.end(), 0);
        int64_t chunk = (n + nt - 1) / nt;
        parallel_for(n, [&](int t, int64_t begin, int64_t end) {
            int64_t* h = &hist[static_cast<size_t>(t) * kRadix];
            for (int64_t i = begin; i < end; ++i)
                ++h[(ka[i] >> shift) & 0xFF];
        });
        // Exclusive prefix over (digit, thread) in digit-major order
        int64_t sum = 0;
        for (int d = 0; d < kRadix; ++d) {
            for (int t = 0; t < nt; ++t) {
                int64_t& h = hist[static_cast<size_t>(t) * kRadix + d];
                int64_t cur = h; h = sum; sum += cur;
            }
        }
        parallel_for(n, [&](int t, int64_t begin, int64_t end) {
            int64_t* h = &hist[static_cast<size_t>(t) * kRadix];
            for (int64_t i = begin; i < end; ++i) {
                int64_t pos = h[(ka[i] >> shift) & 0xFF]++;
                kb[pos] = ka[i];
                ib[pos] = ia[i];
            }
        });
        std::swap(ka, kb);
        std::swap(ia, ib);
        (void)chunk;
    }
    std::memcpy(order, ia, sizeof(int64_t) * n);
}

// Parallel gather: out[i] = src[order[i]] for f32 / i32 / u8 columns.
void cip_gather_f32(const float* src, const int64_t* order, int64_t n,
                    float* out) {
    parallel_for(n, [&](int, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) out[i] = src[order[i]];
    });
}
void cip_gather_i32(const int32_t* src, const int64_t* order, int64_t n,
                    int32_t* out) {
    parallel_for(n, [&](int, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) out[i] = src[order[i]];
    });
}
void cip_gather_u8(const uint8_t* src, const int64_t* order, int64_t n,
                   uint8_t* out) {
    parallel_for(n, [&](int, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) out[i] = src[order[i]];
    });
}

// Imaging-weight density accumulation (models/weighting.py): gridded
// sum of effective weights at cell round(u * inv_cell) + npix/2 (and
// the conjugate mirror npix - i), clipped to the grid. Parallel over
// samples with lock-free double adds — collisions are rare (1e8+
// samples spread over npix^2 >= 1e8 cells), so CAS retries are noise.
// Rounding matches numpy: nearbyint == round-half-to-even.
namespace {
inline void atomic_add_double(double* addr, double value) {
    auto* cell = reinterpret_cast<std::atomic<uint64_t>*>(addr);
    uint64_t observed = cell->load(std::memory_order_relaxed);
    for (;;) {
        double current;
        std::memcpy(&current, &observed, sizeof(double));
        const double updated = current + value;
        uint64_t updated_bits;
        std::memcpy(&updated_bits, &updated, sizeof(double));
        if (cell->compare_exchange_weak(observed, updated_bits,
                                        std::memory_order_relaxed))
            return;
    }
}
}  // namespace

void cip_density_accumulate(const double* uvw, int64_t nrow,
                            const double* freqs, int64_t nchan,
                            const double* weights, double inv_cell,
                            int64_t npix, double* density) {
    std::vector<double> scale(nchan);
    for (int64_t c = 0; c < nchan; ++c)
        scale[c] = freqs[c] / kSpeedOfLight * inv_cell;
    const int64_t half = npix / 2;
    const int64_t hi = npix - 1;
    parallel_for(nrow, [&](int, int64_t begin, int64_t end) {
        for (int64_t r = begin; r < end; ++r) {
            const double um = uvw[3 * r];
            const double vm = uvw[3 * r + 1];
            for (int64_t c = 0; c < nchan; ++c) {
                const double w = weights[r * nchan + c];
                int64_t iu =
                    (int64_t)std::nearbyint(um * scale[c]) + half;
                int64_t iv =
                    (int64_t)std::nearbyint(vm * scale[c]) + half;
                iu = std::min(std::max(iu, (int64_t)0), hi);
                iv = std::min(std::max(iv, (int64_t)0), hi);
                atomic_add_double(&density[iu * npix + iv], w);
                // Mirror of the CLIPPED cell (matches the numpy path)
                const int64_t mu =
                    std::min(std::max(npix - iu, (int64_t)0), hi);
                const int64_t mv =
                    std::min(std::max(npix - iv, (int64_t)0), hi);
                atomic_add_double(&density[mu * npix + mv], w);
            }
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------
// Fused slot-plan builder: (uvw, freqs) -> final block-slot layout in
// one multithreaded pass. Replaces a chain of ~15 full-array numpy
// passes (straddle duplication, key sort, gathers, block split, slot
// scatter) that dominated time-to-first-image (tens of seconds at
// bench scale, minutes at production scale).
// Two-phase C ABI (sizes are data-dependent): cip_slot_plan_build
// returns a handle, cip_slot_plan_sizes reports num_blocks, then
// cip_slot_plan_export fills caller-allocated (numpy) outputs and
// cip_slot_plan_free releases the handle.
// ---------------------------------------------------------------------

namespace {

struct SlotPlan {
    int64_t n = 0;           // source samples
    int64_t support = 0;
    int64_t num_sorted = 0;  // n + duplicated lane straddlers
    int64_t num_blocks = 0;
    int64_t block = 0;
    int64_t nbins = 0, ntiles_y = 0, tile_x = 0, tile_y = 0;
    // per source sample (x0..ws empty when built with
    // store_coords=0 — the compact export reads only flip)
    PBuf<uint8_t> flip;
    PBuf<uint8_t> straddle;
    PBuf<int32_t> x0, y0;
    PBuf<float> fx, fy, ws;
    // per sorted slot
    PBuf<int64_t> src_sorted;
    // per block
    PBuf<int64_t> start_sorted;
    PBuf<int32_t> blen, box, boy, bin_lo, bin_hi;
};

std::mutex g_plans_mu;
std::unordered_map<int64_t, SlotPlan*> g_plans;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

// store_coords=0 (compact export): the per-sample x0/y0/fx/fy/ws
// columns are never read back — only flip (conjugation sign) and the
// lane-straddle flag — so their ~20 B/sample stores (and page
// faults) are skipped entirely.
int64_t cip_slot_plan_build(
    const double* uvw, int64_t nrow, const double* freqs, int64_t nchan,
    double inv_du, int64_t ngrid, int64_t support, int64_t tile_x,
    int64_t tile_y, int64_t ntiles_y, int wstacking, double w0_plane,
    double inv_dw, int64_t nbins, int64_t block, int64_t bin_group,
    int store_coords) {
    PhaseTimer timer;
    auto* plan = new SlotPlan();
    const int64_t n = nrow * nchan;
    plan->n = n;
    plan->support = support;
    plan->block = block;
    plan->nbins = nbins;
    plan->ntiles_y = ntiles_y;
    plan->tile_x = tile_x;
    plan->tile_y = tile_y;

    plan->flip.reset(n);
    plan->straddle.reset(n);
    if (store_coords) {
        plan->x0.reset(n);
        plan->y0.reset(n);
        plan->fx.reset(n);
        plan->fy.reset(n);
        plan->ws.reset(n);
    }
    PBuf<int64_t> key(n);
    timer.mark("alloc_sample");

    // Per-sample geometry + (tile, wbin) key; count lane straddlers.
    const int64_t half = support / 2;
    const double half_grid = static_cast<double>(ngrid) / 2.0;
    const int64_t straddle_min = tile_y - support;
    int nt = num_threads();
    std::vector<int64_t> dup_counts(nt, 0);
    parallel_for(nrow, [&](int t, int64_t begin, int64_t end) {
        int64_t dups = 0;
        for (int64_t r = begin; r < end; ++r) {
            const double bu = uvw[3 * r + 0];
            const double bv = uvw[3 * r + 1];
            const double bw = uvw[3 * r + 2];
            for (int64_t c = 0; c < nchan; ++c) {
                const int64_t i = r * nchan + c;
                const double scale = freqs[c] / kSpeedOfLight;
                double u = bu * scale, v = bv * scale, w = bw * scale;
                const bool neg = w < 0.0;
                if (neg) { u = -u; v = -v; w = -w; }
                plan->flip[i] = neg ? 1 : 0;

                double x = std::fmod(u * inv_du + half_grid, (double)ngrid);
                if (x < 0) x += ngrid;
                x += support;
                double y = std::fmod(v * inv_du + half_grid, (double)ngrid);
                if (y < 0) y += ngrid;
                y += support;

                const int64_t cx = (int64_t)std::floor(x) - half + 1;
                const int64_t cy = (int64_t)std::floor(y) - half + 1;
                if (store_coords) {
                    plan->x0[i] = (int32_t)cx;
                    plan->y0[i] = (int32_t)cy;
                    plan->fx[i] = (float)(x - (double)cx);
                    plan->fy[i] = (float)(y - (double)cy);
                    plan->ws[i] = static_cast<float>(w);
                }

                int64_t bin = 0;
                if (wstacking) {
                    bin = (int64_t)std::floor((w - w0_plane) * inv_dw);
                    bin = std::max<int64_t>(0,
                          std::min<int64_t>(bin, nbins - 1));
                }
                const int64_t tid = (cx / tile_x) * ntiles_y
                                  + (cy / tile_y);
                key[i] = tid * nbins + bin;
                const bool strad = (cy % tile_y) > straddle_min;
                plan->straddle[i] = strad ? 1 : 0;
                if (strad) ++dups;
            }
        }
        dup_counts[t] += dups;
    });
    timer.mark("geometry");

    int64_t ndup = 0;
    for (int t = 0; t < nt; ++t) ndup += dup_counts[t];
    const int64_t ns = n + ndup;
    plan->num_sorted = ns;

    // Extended (sample, key) set: originals then duplicated straddlers
    // re-keyed one lane window up (tile id + 1 == key + nbins).
    PBuf<int64_t> src_ext(ns), key_ext(ns);
    {
        // Per-thread duplicate offsets: stable chunk-ordered append.
        int64_t chunk = (nrow + nt - 1) / nt;
        std::vector<int64_t> offsets(nt + 1, 0);
        {
            int64_t acc = n;
            for (int t = 0; t < nt; ++t) {
                offsets[t] = acc;
                acc += dup_counts[t];
            }
            offsets[nt] = acc;
        }
        parallel_for(nrow, [&](int t, int64_t begin, int64_t end) {
            int64_t pos = offsets[t];
            for (int64_t r = begin; r < end; ++r) {
                for (int64_t c = 0; c < nchan; ++c) {
                    const int64_t i = r * nchan + c;
                    src_ext[i] = i;
                    key_ext[i] = key[i];
                    if (plan->straddle[i]) {
                        src_ext[pos] = i;
                        key_ext[pos] = key[i] + nbins;
                        ++pos;
                    }
                }
            }
        });
        (void)chunk;
    }
    timer.mark("dup_extend");

    // Stable grouping by key. Keys are dense small integers
    // (tile id * nbins + bin), so a one-pass stable counting sort
    // beats a general radix argsort: per-thread histograms give both
    // the scatter offsets AND the group boundaries, so no permutation
    // array, no sorted-key array, and no boundary scan are needed.
    plan->src_sorted.reset(ns);
    std::vector<int64_t> group_starts;
    std::vector<int64_t> group_keys;
    int64_t maxkey = 0;
    {
        std::vector<int64_t> maxs(nt, 0);
        parallel_for(ns, [&](int t, int64_t b, int64_t e) {
            int64_t mk = 0;
            for (int64_t i = b; i < e; ++i)
                mk = std::max(mk, key_ext[i]);
            maxs[t] = mk;
        });
        for (int t = 0; t < nt; ++t) maxkey = std::max(maxkey, maxs[t]);
    }
    const int64_t K = maxkey + 1;
    if (K <= (int64_t(1) << 26)) {
        // hist[t*K + k] = count of key k in thread t's range
        // (chunk-ordered, so digit-major prefix keeps stability).
        PBuf<int64_t> hist(static_cast<int64_t>(nt) * K);
        const int64_t chunk = (ns + nt - 1) / nt;
        parallel_for(ns, [&](int, int64_t b, int64_t e) {
            // Derive the histogram slot from the position, not the
            // lambda's thread id: parallel_for's chunking defines
            // stability order.
            int64_t* h = hist.data() + (b / chunk) * K;
            for (int64_t i = b; i < e; ++i) ++h[key_ext[i]];
        });
        group_starts.reserve(4096);
        group_keys.reserve(4096);
        int64_t sum = 0;
        for (int64_t k = 0; k < K; ++k) {
            int64_t total = 0;
            for (int t = 0; t < nt; ++t) {
                int64_t& h = hist[static_cast<int64_t>(t) * K + k];
                int64_t cur = h;
                h = sum + total;
                total += cur;
            }
            if (total) {
                group_starts.push_back(sum);
                group_keys.push_back(k);
            }
            sum += total;
        }
        parallel_for(ns, [&](int, int64_t b, int64_t e) {
            int64_t* h = hist.data() + (b / chunk) * K;
            for (int64_t i = b; i < e; ++i)
                plan->src_sorted[h[key_ext[i]]++] = src_ext[i];
        });
    } else {
        // Sparse/huge key space: general stable radix argsort.
        PBuf<int64_t> perm(ns);
        cip_argsort_i64(key_ext.data(), ns, perm.data());
        PBuf<int64_t> key_sorted(ns);
        parallel_for(ns, [&](int, int64_t b, int64_t e) {
            for (int64_t i = b; i < e; ++i) {
                plan->src_sorted[i] = src_ext[perm[i]];
                key_sorted[i] = key_ext[perm[i]];
            }
        });
        std::vector<std::vector<int64_t>> bounds(nt);
        parallel_for(ns, [&](int t, int64_t b, int64_t e) {
            auto& out = bounds[t];
            for (int64_t i = std::max<int64_t>(b, 1); i < e; ++i)
                if (key_sorted[i] != key_sorted[i - 1]) out.push_back(i);
        });
        if (ns) group_starts.push_back(0);
        for (int t = 0; t < nt; ++t)
            group_starts.insert(group_starts.end(), bounds[t].begin(),
                                bounds[t].end());
        std::sort(group_starts.begin(), group_starts.end());
        group_keys.resize(group_starts.size());
        for (size_t g = 0; g < group_starts.size(); ++g)
            group_keys[g] = key_sorted[group_starts[g]];
    }
    const int64_t ngroups = (int64_t)group_starts.size();
    timer.mark("group_sort");

    // Merge consecutive (tile, wbin) groups whose bins fall in the
    // same bin_group-sized window: a block may then span up to
    // bin_group adjacent w-bins (plane window support + bin_group - 1
    // planes instead of support), trading a few extra plane visits
    // for proportionally fewer, longer kernel block-steps — the ES
    // kernel's w factor is exactly zero on planes outside a sample's
    // own support window, so correctness is unchanged. Samples remain
    // bin-sorted inside a merged group (the sort key keeps fine
    // bins), so per-block [bin_lo, bin_hi] stays exact: the bins of
    // the block's first and last slot.
    const int64_t bg = std::max<int64_t>(bin_group, 1);
    std::vector<int64_t> m_first;  // merged group -> first fine group
    m_first.reserve(ngroups + 1);
    {
        int64_t prev_mkey = -1;
        for (int64_t g = 0; g < ngroups; ++g) {
            const int64_t k = group_keys[g];
            const int64_t mkey =
                (k / nbins) * nbins + (k % nbins) / bg;
            if (mkey != prev_mkey) {
                m_first.push_back(g);
                prev_mkey = mkey;
            }
        }
        m_first.push_back(ngroups);
    }
    const int64_t nmerged = (int64_t)m_first.size() - 1;

    std::vector<int64_t> group_nb(nmerged + 1, 0);
    for (int64_t m = 0; m < nmerged; ++m) {
        const int64_t mstart = group_starts[m_first[m]];
        const int64_t mend =
            (m_first[m + 1] < ngroups) ? group_starts[m_first[m + 1]]
                                       : ns;
        group_nb[m + 1] =
            group_nb[m] + (mend - mstart + block - 1) / block;
    }
    const int64_t nb = group_nb[nmerged];
    plan->num_blocks = nb;
    plan->start_sorted.reset(nb);
    plan->blen.reset(nb);
    plan->box.reset(nb);
    plan->boy.reset(nb);
    plan->bin_lo.reset(nb);
    plan->bin_hi.reset(nb);
    parallel_for(nmerged, [&](int, int64_t mb, int64_t me) {
        for (int64_t m = mb; m < me; ++m) {
            const int64_t glo = m_first[m];
            const int64_t ghi = m_first[m + 1];
            const int64_t mstart = group_starts[glo];
            const int64_t mend =
                (ghi < ngroups) ? group_starts[ghi] : ns;
            const int64_t tid = group_keys[glo] / nbins;
            const int32_t ox = (int32_t)((tid / ntiles_y) * tile_x);
            const int32_t oy = (int32_t)((tid % ntiles_y) * tile_y);
            int64_t bidx = group_nb[m];
            int64_t sub = glo;  // fine group of the block's first slot
            for (int64_t s = mstart; s < mend; s += block, ++bidx) {
                const int64_t len =
                    std::min<int64_t>(block, mend - s);
                while (sub + 1 < ghi && group_starts[sub + 1] <= s)
                    ++sub;
                int64_t sub_hi = sub;
                while (sub_hi + 1 < ghi &&
                       group_starts[sub_hi + 1] <= s + len - 1)
                    ++sub_hi;
                plan->start_sorted[bidx] = s;
                plan->blen[bidx] = (int32_t)len;
                plan->box[bidx] = ox;
                plan->boy[bidx] = oy;
                plan->bin_lo[bidx] =
                    (int32_t)(group_keys[sub] % nbins);
                plan->bin_hi[bidx] =
                    (int32_t)(group_keys[sub_hi] % nbins);
            }
        }
    });

    timer.mark("block_split");
    std::lock_guard<std::mutex> lock(g_plans_mu);
    const int64_t handle = g_next_handle++;
    g_plans[handle] = plan;
    return handle;
}

void cip_slot_plan_sizes(int64_t handle, int64_t* num_blocks_out) {
    std::lock_guard<std::mutex> lock(g_plans_mu);
    auto it = g_plans.find(handle);
    *num_blocks_out = (it != g_plans.end()) ? it->second->num_blocks : 0;
}

// Fill caller-allocated outputs. Slot arrays have num_blocks_padded *
// block entries; blocks beyond num_blocks are padding (order =
// pad_order, x0/y0 = support, fx/fy = 0.5, ws = 0, flip = 0, len 0).
// Also emits the kernel-ready derived columns in the same pass:
// packed (8, num_slots) row-major with rows {patch-relative x, patch-
// relative y, ws, block_len broadcast, 0, 0, 0, 0}; flip_sign (+-1);
// and the static w-shift phase factors cos/sin(phase_factor * ws).
// packed / flip_sign / phase_cos / phase_sin may be NULL (compact
// staging rebuilds them on device); order_enc, when non-NULL, gets
// the source index with the conjugation flip in the sign
// (flip ? -(src + 1) : src; padding keeps the positive pad_order).
void cip_slot_plan_export(
    int64_t handle, int64_t num_blocks_padded, int32_t pad_order,
    int32_t* order, uint8_t* flip, int32_t* x0, int32_t* y0, float* fx,
    float* fy, float* ws, int32_t* blen, int32_t* box, int32_t* boy,
    int32_t* bin_lo, int32_t* bin_hi, float* packed, float* flip_sign,
    double phase_factor, float* phase_cos, float* phase_sin,
    int32_t* order_enc) {
    SlotPlan* plan;
    {
        std::lock_guard<std::mutex> lock(g_plans_mu);
        plan = g_plans.at(handle);
    }
    const int64_t B = plan->block;
    const int32_t pad_cell = (int32_t)plan->support;
    const int64_t num_slots = num_blocks_padded * B;
    const bool have_coords = plan->x0.size() > 0;
    if ((packed || x0 || y0 || fx || fy || ws) && !have_coords) {
        fprintf(stderr,
                "cip_slot_plan_export: coordinate outputs requested "
                "from a store_coords=0 plan\n");
        return;
    }
    // Any of the per-slot coordinate outputs (flip, x0, y0, fx, fy,
    // ws) may be NULL: the Pallas path reads only the packed columns,
    // and skipping the coordinate exports avoids ~170 MB of stores +
    // first-touch page faults per 7M-slot plan on lazily-backed VMs.
    // Parallelize over SLOTS: the outputs are freshly-mapped numpy
    // buffers whose first-touch page faults dominate on lazily-backed
    // VM memory, and a block count below parallel_for's threshold
    // would fault them all on one thread.
    parallel_for(num_slots, [&](int, int64_t sb, int64_t se) {
        for (int64_t slot = sb; slot < se; ++slot) {
            const int64_t b = slot / B;
            const int64_t l = slot % B;
            const bool real = b < plan->num_blocks;
            const int64_t len = real ? plan->blen[b] : 0;
            int32_t x0v, y0v;
            float fxv, fyv, wsv;
            if (l < len) {
                const int64_t start = plan->start_sorted[b];
                const int64_t src = plan->src_sorted[start + l];
                const bool neg = plan->flip[src] != 0;
                order[slot] = (int32_t)src;
                if (flip) flip[slot] = neg ? 1 : 0;
                if (flip_sign) flip_sign[slot] = neg ? -1.0f : 1.0f;
                if (order_enc)
                    order_enc[slot] =
                        neg ? (int32_t)(-src - 1) : (int32_t)src;
                x0v = have_coords ? plan->x0[src] : pad_cell;
                y0v = have_coords ? plan->y0[src] : pad_cell;
                fxv = have_coords ? plan->fx[src] : 0.5f;
                fyv = have_coords ? plan->fy[src] : 0.5f;
                wsv = have_coords ? plan->ws[src] : 0.0f;
            } else {
                order[slot] = pad_order;
                if (flip) flip[slot] = 0;
                if (flip_sign) flip_sign[slot] = 1.0f;
                if (order_enc) order_enc[slot] = pad_order;
                x0v = pad_cell;
                y0v = pad_cell;
                fxv = 0.5f;
                fyv = 0.5f;
                wsv = 0.0f;
            }
            if (x0) x0[slot] = x0v;
            if (y0) y0[slot] = y0v;
            if (fx) fx[slot] = fxv;
            if (fy) fy[slot] = fyv;
            if (ws) ws[slot] = wsv;
            if (packed) {
                const int32_t bx = real ? plan->box[b] : 0;
                const int32_t by = real ? plan->boy[b] : 0;
                packed[slot] = (float)(x0v - bx) + fxv;
                packed[num_slots + slot] = (float)(y0v - by) + fyv;
                packed[2 * num_slots + slot] = wsv;
                packed[3 * num_slots + slot] = (float)len;
                // Rows 4-7 (device-spliced visibilities + alignment
                // pad) stay as the allocation's zero fill.
            }
            if (phase_cos) {
                const double ph = phase_factor * (double)wsv;
                phase_cos[slot] = (float)std::cos(ph);
                phase_sin[slot] = (float)std::sin(ph);
            }
        }
    });
    parallel_for(num_blocks_padded, [&](int, int64_t bb, int64_t be) {
        for (int64_t b = bb; b < be; ++b) {
            const bool real = b < plan->num_blocks;
            blen[b] = real ? plan->blen[b] : 0;
            box[b] = real ? plan->box[b] : 0;
            boy[b] = real ? plan->boy[b] : 0;
            bin_lo[b] = real ? plan->bin_lo[b] : 0;
            bin_hi[b] = real ? plan->bin_hi[b] : 0;
        }
    });
}

// Pre-fault scratch buffers of the given byte sizes and park them in
// the warm-buffer arena, so a later plan build's PBufs skip the
// (collapsed-regime) cold fault path entirely. Called during
// untimed warmup/startup phases.
void cip_arena_prewarm(const int64_t* sizes, int64_t n) {
    std::vector<PBuf<char>*> bufs;
    bufs.reserve(n);
    for (int64_t i = 0; i < n; ++i)
        bufs.push_back(new PBuf<char>(sizes[i]));
    for (auto* b : bufs) delete b;  // destructor parks in the arena
}

void cip_slot_plan_free(int64_t handle) {
    std::lock_guard<std::mutex> lock(g_plans_mu);
    auto it = g_plans.find(handle);
    if (it != g_plans.end()) {
        delete it->second;
        g_plans.erase(it);
    }
}

// Static w-shift phase factors: cos/sin(factor * ws[i]) in one pass.
void cip_phase_cossin(const float* ws, int64_t n, double factor,
                      float* cos_out, float* sin_out) {
    parallel_for(n, [&](int, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            const double phase = factor * (double)ws[i];
            cos_out[i] = (float)std::cos(phase);
            sin_out[i] = (float)std::sin(phase);
        }
    });
}

// Fused slot staging (ops/gridder.py:stage_slot_vis): gather data-order
// split visibilities into slot order, apply the conjugate flip sign and
// the static w-shift pre-phase, in one parallel pass. Padding slots
// (order[i] >= n_data, the plan's sentinel convention) stage as zero.
void cip_stage_slot_vis(const float* vis_re, const float* vis_im,
                        int64_t n_data, const int64_t* order,
                        const float* flip_sign, const float* phase_cos,
                        const float* phase_sin, int64_t n_slots,
                        int32_t wstacking, float* out_re,
                        float* out_im) {
    parallel_for(n_slots, [&](int, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            const int64_t idx = order[i];
            float re = 0.0f, im = 0.0f;
            if (idx >= 0 && idx < n_data) {
                re = vis_re[idx];
                im = vis_im[idx] * flip_sign[i];
            }
            if (wstacking) {
                const float c = phase_cos[i];
                const float s = phase_sin[i];
                out_re[i] = re * c - im * s;
                out_im[i] = re * s + im * c;
            } else {
                out_re[i] = re;
                out_im[i] = im;
            }
        }
    });
}

}  // extern "C"
