// The port's host resampler: a copy of the separable resampler of
// imaginary_tpu/native/codecs.cpp (its "separable resampler" section and
// `py_resize_separable`), built as the module _itpu_torch_resample
// (native/build.py `build_resample`). The host interpreter
// (engine/host_exec.py) calls it for resizes that cv2 cannot run as the
// device does: mixed shrink/enlarge and pure enlarge.
//
// Interface:
//   resize_separable(buf, h, w, c, dst_h, dst_w, kernel) -> bytes
//   arena_stats() -> {reuses, misses, evictions, bytes, cap_bytes}
//   set_arena_cap(mb)        per-thread scratch budget, 0 = unlimited
// The Python shim (codecs/native_backend.py) wraps the bytes in numpy.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------ codec scratch arena -------
//
// The reference's codec arena (imaginary_tpu/native/codecs.cpp), kept to
// the resampler's slots: each worker thread resizes one image at a time,
// so its buffers settle at their high-water size and later calls reuse
// them. The counters are this module's, process-wide (relaxed atomics);
// the cap is per thread, checked after each call: an over-cap arena drops
// all its capacity (an eviction). Cap 0 = unlimited.

std::atomic<uint64_t> g_arena_reuses{0};
std::atomic<uint64_t> g_arena_misses{0};
std::atomic<uint64_t> g_arena_evictions{0};
std::atomic<uint64_t> g_arena_bytes{0};  // live capacity, summed over threads
std::atomic<uint64_t> g_arena_cap{0};    // per-thread byte budget, 0 = off

struct CodecArena {
  std::vector<float> mid, wpair, wT;
  std::vector<uint8_t> rgba, plane, oplane;

  size_t footprint() const {
    return (mid.capacity() + wpair.capacity() + wT.capacity()) * sizeof(float)
         + rgba.capacity() + plane.capacity() + oplane.capacity();
  }
  ~CodecArena() {
    g_arena_bytes.fetch_sub(footprint(), std::memory_order_relaxed);
  }
};

thread_local CodecArena t_arena;

// Size a slot for this call. Capacity (not size) decides reuse vs miss.
// resize() value-initialises growth only: callers that depend on zeroed
// regions (the pad margins) clear them explicitly.
template <typename T>
std::vector<T>& arena_slot(std::vector<T>& slot, size_t n) {
  const size_t before = slot.capacity() * sizeof(T);
  if (before >= n * sizeof(T))
    g_arena_reuses.fetch_add(1, std::memory_order_relaxed);
  else
    g_arena_misses.fetch_add(1, std::memory_order_relaxed);
  slot.resize(n);
  const size_t after = slot.capacity() * sizeof(T);
  if (after > before)
    g_arena_bytes.fetch_add(after - before, std::memory_order_relaxed);
  return slot;
}

void arena_trim() {
  const uint64_t cap = g_arena_cap.load(std::memory_order_relaxed);
  if (cap == 0) return;
  const size_t fp = t_arena.footprint();
  if ((uint64_t)fp <= cap) return;
  std::vector<float>().swap(t_arena.mid);
  std::vector<float>().swap(t_arena.wpair);
  std::vector<float>().swap(t_arena.wT);
  std::vector<uint8_t>().swap(t_arena.rgba);
  std::vector<uint8_t>().swap(t_arena.plane);
  std::vector<uint8_t>().swap(t_arena.oplane);
  g_arena_bytes.fetch_sub(fp, std::memory_order_relaxed);
  g_arena_evictions.fetch_add(1, std::memory_order_relaxed);
}

// ---------------------------------------------- separable resampler ---------
//
// Host analogue of the device's sampling-matrix resize (ops/stages.py
// sample_matrix): per-axis precomputed integer taps, kernel stretched by
// max(1, in/out) on each axis independently so a mixed shrink/enlarge
// chain antialiases the minified axis exactly like the device path.
// Two passes (vertical then horizontal) over a float32 intermediate,
// final round-half-up to uint8 (the device's rounding). Runs with the
// GIL released — the whole point of a native spill path.

constexpr double kResamplePi = 3.14159265358979323846;

double resample_kernel_radius(const std::string& kind) {
  if (kind == "lanczos3") return 3.0;
  if (kind == "lanczos2" || kind == "cubic") return 2.0;
  if (kind == "linear") return 1.0;
  return 0.5;  // nearest
}

double resample_kernel_eval(const std::string& kind, double d) {
  const double ad = std::fabs(d);
  if (kind == "lanczos3" || kind == "lanczos2") {
    const double a = (kind == "lanczos3") ? 3.0 : 2.0;
    if (ad >= a) return 0.0;
    if (ad < 1e-8) return 1.0;
    const double pd = kResamplePi * d;
    // sinc(d) * sinc(d/a) with numpy's normalized sinc convention
    return (std::sin(pd) / pd) * (std::sin(pd / a) / (pd / a));
  }
  if (kind == "cubic") {  // Catmull-Rom-family, a = -0.5 (matches _np_kernel)
    const double a = -0.5;
    if (ad <= 1.0) return (a + 2.0) * ad * ad * ad - (a + 3.0) * ad * ad + 1.0;
    if (ad < 2.0)
      return a * ad * ad * ad - 5.0 * a * ad * ad + 8.0 * a * ad - 4.0 * a;
    return 0.0;
  }
  if (kind == "linear") return std::max(0.0, 1.0 - ad);
  return (d >= -0.5 && d < 0.5) ? 1.0 : 0.0;  // nearest
}

struct TapTable {
  int ntaps = 0;
  std::vector<int32_t> idx;  // [out_n * ntaps], clamped into [0, in_n)
  std::vector<int32_t> k0;   // [out_n] first (unclamped) tap per output
  std::vector<float> wts;    // [out_n * ntaps], rows sum to 1 (or all-zero)
};

// Same weight math as ops/stages.sample_matrix: centre = (y+0.5)/scale-0.5,
// stretch = max(1, 1/scale), taps outside the source get zero weight and
// each row renormalizes over what remains (edge-clamp behavior).
TapTable build_taps(int out_n, int in_n, const std::string& kind) {
  TapTable t;
  const double scale = (double)out_n / (double)in_n;
  const double stretch = std::max(1.0, 1.0 / scale);
  const double support = resample_kernel_radius(kind) * stretch;
  t.ntaps = (int)std::ceil(2.0 * support) + 1;
  t.idx.assign((size_t)out_n * t.ntaps, 0);
  t.k0.assign((size_t)out_n, 0);
  t.wts.assign((size_t)out_n * t.ntaps, 0.0f);
  for (int y = 0; y < out_n; y++) {
    const double centre = (y + 0.5) / scale - 0.5;
    const int k0 = (int)std::floor(centre - support) + 1;
    t.k0[(size_t)y] = k0;
    double sum = 0.0;
    std::vector<double> row((size_t)t.ntaps, 0.0);
    for (int j = 0; j < t.ntaps; j++) {
      const int k = k0 + j;
      if (k < 0 || k >= in_n) continue;
      // evaluate at float32 precision like the numpy tap table: kernels
      // with a hard support cutoff (nearest's box, lanczos' |d| >= a)
      // must make the SAME in/out call on boundary taps, and the f64 vs
      // f32 rounding of d decides it when d lands exactly on the edge
      const double w = resample_kernel_eval(
          kind, (double)(float)((k - centre) / stretch));
      row[j] = w;
      sum += w;
    }
    for (int j = 0; j < t.ntaps; j++) {
      const int k = std::min(std::max(k0 + j, 0), in_n - 1);
      t.idx[(size_t)y * t.ntaps + j] = k;
      t.wts[(size_t)y * t.ntaps + j] =
          (sum > 1e-6) ? (float)(row[j] / sum) : 0.0f;
    }
  }
  // Zero out numerically-negligible weights before trimming: an
  // integer-aligned lanczos tap evaluates to ~1e-17, not exactly 0 (f64
  // sin(pi*k) rounding), so without this an IDENTITY axis pass — scale 1,
  // weight 1 at k=y — would still carry the kernel's full tap count of
  // do-nothing FMAs. Contribution bound: 255 * 1e-7 * ntaps, orders below
  // the uint8 rounding step.
  for (auto& wv : t.wts)
    if (std::fabs(wv) < 1e-7f) wv = 0.0f;
  // Trim to the true nonzero window: the conservative allocation above
  // overshoots by one tap for most kernels (lanczos3's open |d|<3 support
  // admits at most 6 integers, not ceil(6)+1 = 7), and every pass below
  // pays per allocated tap. Shift each row so its first nonzero weight
  // sits at tap 0, then cut the table at the widest row.
  int max_width = 1;
  std::vector<int> first((size_t)out_n, 0);
  for (int y = 0; y < out_n; y++) {
    int f = -1, l = 0;
    for (int j = 0; j < t.ntaps; j++) {
      if (t.wts[(size_t)y * t.ntaps + j] != 0.0f) {
        if (f < 0) f = j;
        l = j;
      }
    }
    if (f < 0) f = 0;
    first[(size_t)y] = f;
    max_width = std::max(max_width, l - f + 1);
  }
  if (max_width < t.ntaps) {
    TapTable s;
    s.ntaps = max_width;
    s.idx.assign((size_t)out_n * max_width, 0);
    s.k0.assign((size_t)out_n, 0);
    s.wts.assign((size_t)out_n * max_width, 0.0f);
    for (int y = 0; y < out_n; y++) {
      const int f = first[(size_t)y];
      const int nk0 = t.k0[(size_t)y] + f;
      s.k0[(size_t)y] = nk0;
      for (int j = 0; j < max_width; j++) {
        if (f + j < t.ntaps) {
          s.idx[(size_t)y * max_width + j] = t.idx[(size_t)y * t.ntaps + f + j];
          s.wts[(size_t)y * max_width + j] = t.wts[(size_t)y * t.ntaps + f + j];
        } else {
          s.idx[(size_t)y * max_width + j] =
              std::min(std::max(nk0 + j, 0), in_n - 1);
        }
      }
    }
    return s;
  }
  return t;
}

// src: HWC uint8. Vertical pass into a float32 buffer, horizontal pass out
// of it, rounding into dst (dh*dw*c uint8). Templated on the channel count
// so the per-pixel accumulator lives in registers and the tap loop
// vectorizes — the difference between ~135 ms and ~35 ms on a 1080p->1440p
// lanczos3 enlarge (measured, 1-CPU host, g++ -O3).
template <int C>
void resize_separable_impl(const uint8_t* src, int h, int w, int dh, int dw,
                           const TapTable& tv, const TapTable& th,
                           uint8_t* dst) {
  const size_t row_elems = (size_t)w * C;
  const int pad = th.ntaps;  // window overhang at either edge
  std::vector<float>& mid_row =
      arena_slot(t_arena.mid, ((size_t)w + 2 * pad) * C);
  // the pad margins must read as zero (out-of-range taps carry zero
  // weight); the reused buffer may hold a previous call's values
  std::memset(mid_row.data(), 0, (size_t)pad * C * sizeof(float));
  std::memset(mid_row.data() + ((size_t)pad + w) * C, 0,
              (size_t)pad * C * sizeof(float));
  for (int y = 0; y < dh; y++) {
    // vertical: blend source rows for this output row only (no dh*w*C
    // intermediate — better cache locality and a fraction of the memory).
    // Contiguous FMA over w*C elements. __restrict__ is load-bearing:
    // uint8_t aliases every type, so without it the compiler must assume
    // in_row overlaps mrow and the loop stays scalar.
    float* __restrict__ mrow = mid_row.data() + (size_t)pad * C;
    std::memset(mrow, 0, row_elems * sizeof(float));
    const float* wrow = tv.wts.data() + (size_t)y * tv.ntaps;
    const int32_t* irow = tv.idx.data() + (size_t)y * tv.ntaps;
    for (int j = 0; j < tv.ntaps; j++) {
      const float wv = wrow[j];
      if (wv == 0.0f) continue;
      const uint8_t* __restrict__ in_row = src + (size_t)irow[j] * row_elems;
      for (size_t i = 0; i < row_elems; i++) mrow[i] += wv * in_row[i];
    }
    // horizontal: every tap window is one CONTIGUOUS interleaved run
    // starting at k0[x]*C — the pad rows above hold zeros and out-of-range
    // taps carry zero weight (build_taps), so the loop stays branch-free;
    // the C accumulators give the compiler independent FMA chains.
    uint8_t* __restrict__ out_row = dst + (size_t)y * dw * C;
    for (int x = 0; x < dw; x++) {
      const float* __restrict__ wx = th.wts.data() + (size_t)x * th.ntaps;
      const float* __restrict__ px = mrow + (std::ptrdiff_t)th.k0[(size_t)x] * C;
      float acc[C] = {};
      for (int j = 0; j < th.ntaps; j++) {
        const float wv = wx[j];
        for (int ch = 0; ch < C; ch++) acc[ch] += wv * px[(size_t)j * C + ch];
      }
      for (int ch = 0; ch < C; ch++) {
        const float v = acc[ch] + 0.5f;  // device rounding
        out_row[(size_t)x * C + ch] =
            (uint8_t)(v <= 0.0f ? 0 : (v >= 255.0f ? 255 : (int)v));
      }
    }
  }
}

#if defined(__x86_64__) && defined(__GNUC__)
#define ITPU_AVX2_DISPATCH 1
#include <immintrin.h>

bool cpu_has_avx2_fma() {
  return __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
}

// AVX2+FMA specialization for 3/4-channel images — the serving hot shape.
// Internally RGBA: a 4-float channel group is exactly half a YMM lane, so
// the horizontal pass computes TWO output pixels per FMA (each 128-bit
// half holds one pixel's running RGBA accumulator). The portable template
// above measured ~46 ms on a 1080p->1440p lanczos3 enlarge; this runs the
// same taps in ~15 ms. Compiled with a target attribute and dispatched at
// runtime, so the module loads and serves on any x86-64.
__attribute__((target("avx2,fma")))
void resize_separable_avx2(const uint8_t* src, int h, int w, int c, int dh,
                           int dw, const TapTable& tv, const TapTable& th,
                           uint8_t* dst) {
  const uint8_t* s4 = src;
  if (c == 3) {  // one up-front 3->4 expand keeps every later row load aligned to pixels
    std::vector<uint8_t>& rgba = arena_slot(t_arena.rgba, (size_t)h * w * 4);
    const size_t n = (size_t)h * w;
    size_t i = 0;
    // pshufb 4 pixels per step (12 source bytes -> 16, alpha lanes zeroed
    // by the -1 indices): the scalar expand below costs ~5 ms of a 28 ms
    // 1080p->1440p call, this runs it at shuffle speed. The bound keeps
    // the 16-byte load inside the buffer (needs 3i+16 <= 3n).
    const __m128i shuf = _mm_setr_epi8(0, 1, 2, -1, 3, 4, 5, -1,
                                       6, 7, 8, -1, 9, 10, 11, -1);
    for (; i + 6 <= n; i += 4) {
      const __m128i v =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i * 3));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(rgba.data() + i * 4),
                       _mm_shuffle_epi8(v, shuf));
    }
    for (; i < n; i++) {
      rgba[i * 4 + 0] = src[i * 3 + 0];
      rgba[i * 4 + 1] = src[i * 3 + 1];
      rgba[i * 4 + 2] = src[i * 3 + 2];
      rgba[i * 4 + 3] = 0;
    }
    s4 = rgba.data();
  }
  const int pad = th.ntaps;
  const size_t row4 = (size_t)w * 4;
  std::vector<float>& mid = arena_slot(t_arena.mid, ((size_t)w + 2 * pad) * 4);
  std::memset(mid.data(), 0, (size_t)pad * 4 * sizeof(float));
  std::memset(mid.data() + ((size_t)pad + w) * 4, 0,
              (size_t)pad * 4 * sizeof(float));
  float* mrow = mid.data() + (size_t)pad * 4;
  // pair-expanded horizontal weights: [pair][tap][w0 w0 w0 w0 w1 w1 w1 w1]
  // — one unaligned 256-bit load per tap, no in-loop shuffles
  const int npairs = dw / 2;
  std::vector<float>& wpair =
      arena_slot(t_arena.wpair, (size_t)npairs * th.ntaps * 8);
  for (int p = 0; p < npairs; p++) {
    for (int j = 0; j < th.ntaps; j++) {
      const float w0 = th.wts[(size_t)(2 * p) * th.ntaps + j];
      const float w1 = th.wts[(size_t)(2 * p + 1) * th.ntaps + j];
      float* o = wpair.data() + ((size_t)p * th.ntaps + j) * 8;
      o[0] = o[1] = o[2] = o[3] = w0;
      o[4] = o[5] = o[6] = o[7] = w1;
    }
  }
  const __m256 vhalf = _mm256_set1_ps(0.5f);
  const __m256 vmax = _mm256_set1_ps(255.0f);
  for (int y = 0; y < dh; y++) {
    std::memset(mrow, 0, row4 * sizeof(float));
    const float* wv = tv.wts.data() + (size_t)y * tv.ntaps;
    const int32_t* iv = tv.idx.data() + (size_t)y * tv.ntaps;
    for (int j = 0; j < tv.ntaps; j++) {
      const float wj = wv[j];
      if (wj == 0.0f) continue;
      const uint8_t* in = s4 + (size_t)iv[j] * row4;
      // explicit widen+FMA (8 u8 lanes -> f32): the scalar form can't
      // auto-vectorize here — uint8_t aliases float, so the compiler
      // must assume `in` overlaps `mrow` and reloads every element
      const __m256 vw = _mm256_set1_ps(wj);
      size_t i = 0;
      for (; i + 8 <= row4; i += 8) {
        const __m256 f = _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(
            _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + i))));
        _mm256_storeu_ps(mrow + i,
                         _mm256_fmadd_ps(f, vw, _mm256_loadu_ps(mrow + i)));
      }
      for (; i < row4; i++) mrow[i] += wj * in[i];
    }
    uint8_t* out_row = dst + (size_t)y * dw * c;
    for (int p = 0; p < npairs; p++) {
      const int x = 2 * p;
      const float* b0 = mrow + (std::ptrdiff_t)th.k0[(size_t)x] * 4;
      const float* b1 = mrow + (std::ptrdiff_t)th.k0[(size_t)x + 1] * 4;
      const float* wp = wpair.data() + (size_t)p * th.ntaps * 8;
      // two accumulator chains over even/odd taps: a single chain is
      // FMA-LATENCY-bound (~4-5 cycles x ntaps per pair dominates the
      // whole pass); splitting it overlaps the dependent adds
      __m256 acc0 = _mm256_setzero_ps();
      __m256 acc1 = _mm256_setzero_ps();
      int j = 0;
      for (; j + 2 <= th.ntaps; j += 2) {
        const __m256 v0 = _mm256_insertf128_ps(
            _mm256_castps128_ps256(_mm_loadu_ps(b0 + (size_t)j * 4)),
            _mm_loadu_ps(b1 + (size_t)j * 4), 1);
        acc0 = _mm256_fmadd_ps(v0, _mm256_loadu_ps(wp + (size_t)j * 8), acc0);
        const __m256 v1 = _mm256_insertf128_ps(
            _mm256_castps128_ps256(_mm_loadu_ps(b0 + (size_t)(j + 1) * 4)),
            _mm_loadu_ps(b1 + (size_t)(j + 1) * 4), 1);
        acc1 = _mm256_fmadd_ps(v1, _mm256_loadu_ps(wp + (size_t)(j + 1) * 8),
                               acc1);
      }
      if (j < th.ntaps) {
        const __m256 v = _mm256_insertf128_ps(
            _mm256_castps128_ps256(_mm_loadu_ps(b0 + (size_t)j * 4)),
            _mm_loadu_ps(b1 + (size_t)j * 4), 1);
        acc0 = _mm256_fmadd_ps(v, _mm256_loadu_ps(wp + (size_t)j * 8), acc0);
      }
      __m256 acc = _mm256_add_ps(acc0, acc1);
      // device rounding: +0.5, clamp, truncate (matches the scalar path)
      acc = _mm256_add_ps(acc, vhalf);
      acc = _mm256_min_ps(_mm256_max_ps(acc, _mm256_setzero_ps()), vmax);
      const __m256i i32 = _mm256_cvttps_epi32(acc);
      const __m128i p16 = _mm_packus_epi32(_mm256_castsi256_si128(i32),
                                           _mm256_extracti128_si256(i32, 1));
      const __m128i p8 = _mm_packus_epi16(p16, p16);
      alignas(16) uint8_t tmp[16];
      _mm_storeu_si128(reinterpret_cast<__m128i*>(tmp), p8);
      if (c == 4) {
        std::memcpy(out_row + (size_t)x * 4, tmp, 8);
      } else {
        out_row[(size_t)x * 3 + 0] = tmp[0];
        out_row[(size_t)x * 3 + 1] = tmp[1];
        out_row[(size_t)x * 3 + 2] = tmp[2];
        out_row[(size_t)x * 3 + 3] = tmp[4];
        out_row[(size_t)x * 3 + 4] = tmp[5];
        out_row[(size_t)x * 3 + 5] = tmp[6];
      }
    }
    for (int x = npairs * 2; x < dw; x++) {  // odd-width tail
      const float* wx = th.wts.data() + (size_t)x * th.ntaps;
      const float* px = mrow + (std::ptrdiff_t)th.k0[(size_t)x] * 4;
      float acc[4] = {};
      for (int j = 0; j < th.ntaps; j++) {
        const float wj = wx[j];
        for (int ch = 0; ch < 4; ch++) acc[ch] += wj * px[(size_t)j * 4 + ch];
      }
      for (int ch = 0; ch < c; ch++) {
        const float v = acc[ch] + 0.5f;
        out_row[(size_t)x * c + ch] =
            (uint8_t)(v <= 0.0f ? 0 : (v >= 255.0f ? 255 : (int)v));
      }
    }
  }
}
// Planar (1-channel) AVX2 kernel — the packed-YUV420 spill path resizes
// Y/U/V planes one at a time, so this shape is as hot as interleaved RGB.
// Vertical pass is the same contiguous widen+FMA as the RGBA kernel; the
// horizontal pass does 8 output pixels per iteration with one
// i32gather per tap (indices k0[x..x+7]+j) against weights transposed
// to [tap][x] so each tap's 8 weights are one contiguous load.
__attribute__((target("avx2,fma")))
void resize_separable_avx2_1(const uint8_t* src, int h, int w, int dh, int dw,
                             const TapTable& tv, const TapTable& th,
                             uint8_t* dst) {
  const int pad = th.ntaps;
  std::vector<float>& mid = arena_slot(t_arena.mid, (size_t)w + 2 * pad);
  std::memset(mid.data(), 0, (size_t)pad * sizeof(float));
  std::memset(mid.data() + (size_t)pad + w, 0, (size_t)pad * sizeof(float));
  float* mrow = mid.data() + pad;
  std::vector<float>& wT = arena_slot(t_arena.wT, (size_t)th.ntaps * dw);
  for (int x = 0; x < dw; x++)
    for (int j = 0; j < th.ntaps; j++)
      wT[(size_t)j * dw + x] = th.wts[(size_t)x * th.ntaps + j];
  const __m256 vhalf = _mm256_set1_ps(0.5f);
  const __m256 vmax = _mm256_set1_ps(255.0f);
  const int ngroups = dw / 8;
  for (int y = 0; y < dh; y++) {
    std::memset(mrow, 0, (size_t)w * sizeof(float));
    const float* wv = tv.wts.data() + (size_t)y * tv.ntaps;
    const int32_t* iv = tv.idx.data() + (size_t)y * tv.ntaps;
    for (int j = 0; j < tv.ntaps; j++) {
      const float wj = wv[j];
      if (wj == 0.0f) continue;
      const uint8_t* in = src + (size_t)iv[j] * w;
      const __m256 vw = _mm256_set1_ps(wj);
      size_t i = 0;
      for (; i + 8 <= (size_t)w; i += 8) {
        const __m256 f = _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(
            _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + i))));
        _mm256_storeu_ps(mrow + i,
                         _mm256_fmadd_ps(f, vw, _mm256_loadu_ps(mrow + i)));
      }
      for (; i < (size_t)w; i++) mrow[i] += wj * in[i];
    }
    uint8_t* out_row = dst + (size_t)y * dw;
    for (int g = 0; g < ngroups; g++) {
      const int x = g * 8;
      const __m256i k0 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(th.k0.data() + x));
      __m256 acc = _mm256_setzero_ps();
      for (int j = 0; j < th.ntaps; j++) {
        // windows may start in the left pad (k0 < 0, zero weight): mrow's
        // pad rows keep the gather in-bounds, same invariant as the
        // interleaved kernel's k0*4 loads
        const __m256 v = _mm256_i32gather_ps(
            mrow, _mm256_add_epi32(k0, _mm256_set1_epi32(j)), 4);
        acc = _mm256_fmadd_ps(
            v, _mm256_loadu_ps(wT.data() + (size_t)j * dw + x), acc);
      }
      acc = _mm256_add_ps(acc, vhalf);
      acc = _mm256_min_ps(_mm256_max_ps(acc, _mm256_setzero_ps()), vmax);
      const __m256i i32 = _mm256_cvttps_epi32(acc);
      const __m128i p16 = _mm_packus_epi32(_mm256_castsi256_si128(i32),
                                           _mm256_extracti128_si256(i32, 1));
      _mm_storel_epi64(reinterpret_cast<__m128i*>(out_row + x),
                       _mm_packus_epi16(p16, p16));
    }
    for (int x = ngroups * 8; x < dw; x++) {  // narrow-plane tail
      const float* wx = th.wts.data() + (size_t)x * th.ntaps;
      const float* px = mrow + (std::ptrdiff_t)th.k0[(size_t)x];
      float a = 0.0f;
      for (int j = 0; j < th.ntaps; j++) a += wx[j] * px[j];
      const float v = a + 0.5f;
      out_row[x] = (uint8_t)(v <= 0.0f ? 0 : (v >= 255.0f ? 255 : (int)v));
    }
  }
}
#endif  // __x86_64__ && __GNUC__

void resize_plane_u8(const uint8_t* src, int h, int w, int dh, int dw,
                     const TapTable& tv, const TapTable& th, uint8_t* dst) {
#ifdef ITPU_AVX2_DISPATCH
  if (cpu_has_avx2_fma())
    return resize_separable_avx2_1(src, h, w, dh, dw, tv, th, dst);
#endif
  resize_separable_impl<1>(src, h, w, dh, dw, tv, th, dst);
}

void resize_separable_u8(const uint8_t* src, int h, int w, int c, int dh,
                         int dw, const std::string& kind, uint8_t* dst) {
  const TapTable tv = build_taps(dh, h, kind);
  const TapTable th = build_taps(dw, w, kind);
#ifdef ITPU_AVX2_DISPATCH
  if ((c == 3 || c == 4) && cpu_has_avx2_fma())
    return resize_separable_avx2(src, h, w, c, dh, dw, tv, th, dst);
#endif
  if (c == 1) return resize_plane_u8(src, h, w, dh, dw, tv, th, dst);
  if (c == 3) return resize_separable_impl<3>(src, h, w, dh, dw, tv, th, dst);
  if (c == 4) return resize_separable_impl<4>(src, h, w, dh, dw, tv, th, dst);
  // arbitrary channel count: plane-at-a-time through the 1-channel kernel
  std::vector<uint8_t>& plane = arena_slot(t_arena.plane, (size_t)h * w);
  std::vector<uint8_t>& oplane = arena_slot(t_arena.oplane, (size_t)dh * dw);
  for (int ch = 0; ch < c; ch++) {
    for (size_t i = 0, n = (size_t)h * w; i < n; i++)
      plane[i] = src[i * c + ch];
    resize_plane_u8(plane.data(), h, w, dh, dw, tv, th, oplane.data());
    for (size_t i = 0, n = (size_t)dh * dw; i < n; i++)
      dst[i * c + ch] = oplane[i];
  }
}

PyObject* py_resize_separable(PyObject*, PyObject* args) {
  Py_buffer view;
  int h, w, c, dh, dw;
  const char* kernel;
  if (!PyArg_ParseTuple(args, "y*iiiiis", &view, &h, &w, &c, &dh, &dw,
                        &kernel))
    return nullptr;
  if (h <= 0 || w <= 0 || c <= 0 || dh <= 0 || dw <= 0 ||
      (Py_ssize_t)((size_t)h * w * c) != view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "buffer size does not match h*w*c");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)((size_t)dh * dw * c));
  if (!out) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  const uint8_t* src = static_cast<const uint8_t*>(view.buf);
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  std::string kind(kernel);
  Py_BEGIN_ALLOW_THREADS
  resize_separable_u8(src, h, w, c, dh, dw, kind, dst);
  arena_trim();
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  return out;
}

PyObject* py_arena_stats(PyObject*, PyObject*) {
  return Py_BuildValue(
      "{s:K,s:K,s:K,s:K,s:K}",
      "reuses", (unsigned long long)g_arena_reuses.load(std::memory_order_relaxed),
      "misses", (unsigned long long)g_arena_misses.load(std::memory_order_relaxed),
      "evictions", (unsigned long long)g_arena_evictions.load(std::memory_order_relaxed),
      "bytes", (unsigned long long)g_arena_bytes.load(std::memory_order_relaxed),
      "cap_bytes", (unsigned long long)g_arena_cap.load(std::memory_order_relaxed));
}

PyObject* py_set_arena_cap(PyObject*, PyObject* args) {
  double mb;
  if (!PyArg_ParseTuple(args, "d", &mb)) return nullptr;
  if (mb < 0.0) mb = 0.0;
  g_arena_cap.store((uint64_t)(mb * 1024.0 * 1024.0), std::memory_order_relaxed);
  Py_RETURN_NONE;
}

PyMethodDef resample_methods[] = {
    {"resize_separable", py_resize_separable, METH_VARARGS,
     "resize_separable(buf, h, w, c, dst_h, dst_w, kernel) -> bytes"},
    {"arena_stats", py_arena_stats, METH_NOARGS,
     "arena_stats() -> {reuses, misses, evictions, bytes, cap_bytes}"},
    {"set_arena_cap", py_set_arena_cap, METH_VARARGS,
     "set_arena_cap(mb): per-thread scratch-arena budget (0 = unlimited)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef resample_moduledef = {
    PyModuleDef_HEAD_INIT, "_itpu_torch_resample", nullptr, -1, resample_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__itpu_torch_resample(void) {
  return PyModule_Create(&resample_moduledef);
}
