// K13: the two passes of the W-sharded Gaussian blur, around a halo
// exchange.
//
// Replaces: imaginary_tpu/parallel/spatial.py:56-124 (`sharded_blur`'s
// shard-local program: the vertical pass, the R-wide halo exchange by
// `ppermute`, the horizontal pass and the normalisation).
//
// One shard holds columns [col0, col0 + lw) of a [B, Hb, Wb, C] batch
// (C = 1..4) with per-image valid dims h, w (int32 [Bl]), per-image sigma
// (f32 [Bl]) and a static radius R <= 64. With the taps k[t] of K6
// (Gaussian, or the delta where sigma <= 0):
//
//   pass V: x_s [Bl, Hb, lw, C] (uint8 or f32) -> buf [Bl, Hb, lw + 2R, C]
//           f32, whose core columns [R, R + lw) hold conv_v(x * m) on the
//           valid rows and 0 elsewhere, m = (y < h) & (col0 + x < w); the
//           kernel writes 0 into the halo columns [0, R) and [R + lw,
//           lw + 2R);
//   (the caller copies the neighbours' last and first R core columns
//    into the left and right halo; the outer halos of the first and last
//    shard stay 0, the reference's `edge` masking of wrapped strips)
//   pass H: buf -> out [Bl, Hb, lw, C] f32,
//           sum_t k[t] * buf[y, R + x + t] / max(rowden[y] * colden[col0 + x],
//           1e-6) inside the valid region, 0 outside it.
//
// Only pixels cross the seams. rowden[y] sums k[t] over 0 <= y + t < h and
// colden[g] sums k[s] over 0 <= g + s < min(w, Wb), over GLOBAL columns, so
// the normaliser equals the reference's exchanged conv_h(conv_v(mask)) in
// exact arithmetic (the identity K6 uses, csrc/blur.cu). Both passes run
// K6's loops in K6's order, so on the same image the gathered shards equal
// K6's output.
//
// Bound on the H100: memory at small radii (a shard's input read once, its
// output written once), arithmetic at r = 64 (2 flops per vertical tap and
// 3 per horizontal tap on every valid element).
//
// Design: K6's, one thread per element of a row (neighbouring threads on
// neighbouring addresses), each block computing its image's taps into
// shared memory; pass H's tap loop is clipped to the valid global columns,
// which all lie inside [col0 - R, col0 + lw + R) and so inside the shard's
// buffer. A simple kernel that is right; fusing the passes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 64;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

// The image's normalised taps k[0 .. 2r] (tap t at index t + r). Every
// thread of the block must call it.
__device__ void load_taps(float* taps, float* total, float sigma, int r) {
  const int n = 2 * r + 1;
  const bool gauss = sigma > 0.0f;
  const float s = fmaxf(sigma, 1e-3f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float t = (float)(i - r);
    if (gauss) {
      const float q = t / s;
      taps[i] = expf(-0.5f * (q * q));
    } else {
      taps[i] = fabsf(t) < 0.5f ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int i = 0; i < n; ++i) sum += taps[i];
    *total = sum;
  }
  __syncthreads();
  if (gauss)
    for (int i = threadIdx.x; i < n; i += blockDim.x) taps[i] = taps[i] / *total;
  __syncthreads();
}

// grid: x = ceil((lw + 2r) * C / kThreads), y = Hb, z = Bl; block: kThreads.
template <typename TIn>
__global__ void halo_vertical(const TIn* __restrict__ in,
                              float* __restrict__ buf,
                              const int32_t* __restrict__ h,
                              const int32_t* __restrict__ w,
                              const float* __restrict__ sigma, int r, int Hb,
                              int lw, int C, int col0) {
  __shared__ float taps[kMaxTaps];
  __shared__ float total;
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  load_taps(taps, &total, sigma[b], r);
  const int in_len = lw * C;
  const int buf_len = (lw + 2 * r) * C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= buf_len) return;
  const int xb = e / C - r;  // the shard-local column, -r .. lw + r - 1
  const int hh = min(h[b], Hb);
  float acc = 0.0f;
  if (xb >= 0 && xb < lw && y < hh && col0 + xb < w[b]) {
    const int t0 = max(-r, -y);
    const int t1 = min(r, hh - 1 - y);
    const TIn* col = in + ((size_t)b * Hb + y) * in_len + (e - r * C);
    for (int t = t0; t <= t1; ++t)
      acc += taps[t + r] * load(col + (long long)t * in_len);
  }
  buf[((size_t)b * Hb + y) * buf_len + e] = acc;
}

// grid: x = ceil(lw * C / kThreads), y = Hb, z = Bl; block: kThreads.
__global__ void halo_horizontal(const float* __restrict__ buf,
                                float* __restrict__ out,
                                const int32_t* __restrict__ h,
                                const int32_t* __restrict__ w,
                                const float* __restrict__ sigma, int r,
                                int Hb, int lw, int C, int col0, int Wb) {
  __shared__ float taps[kMaxTaps];
  __shared__ float total;
  __shared__ float rowden;
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  load_taps(taps, &total, sigma[b], r);
  const int hh = min(h[b], Hb);
  const int ww = min(w[b], Wb);
  if (threadIdx.x == 0) {
    float d = 0.0f;
    if (y < hh)
      for (int t = max(-r, -y); t <= min(r, hh - 1 - y); ++t) d += taps[t + r];
    rowden = d;
  }
  __syncthreads();
  const int out_len = lw * C;
  const int buf_len = (lw + 2 * r) * C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= out_len) return;
  const int g = col0 + e / C;  // the global column
  float v = 0.0f;
  if (y < hh && g < ww) {
    const int s0 = max(-r, -g);
    const int s1 = min(r, ww - 1 - g);
    const float* row = buf + ((size_t)b * Hb + y) * buf_len + (e + r * C);
    float acc = 0.0f;
    float colden = 0.0f;
    for (int s = s0; s <= s1; ++s) {
      acc += taps[s + r] * row[s * C];
      colden += taps[s + r];
    }
    v = acc / fmaxf(rowden * colden, 1e-6f);
  }
  out[((size_t)b * Hb + y) * out_len + e] = v;
}

}  // namespace

// Pass V of K13: in [Bl, Hb, lw, C] (uint8 if in_u8, else f32) -> buf
// [Bl, Hb, lw + 2 * radius, C] f32, halo columns zeroed. h, w: int32 [Bl]
// valid dims (w global); sigma: f32 [Bl]; radius 0..64; col0: the shard's
// first global column. Returns the launch's CUDA error code.
extern "C" int itpu_blur_halo_v(const void* in, int in_u8, float* buf,
                                const int32_t* h, const int32_t* w,
                                const float* sigma, int radius, int Bl,
                                int Hb, int lw, int C, int col0,
                                void* stream) {
  if (radius < 0 || radius > kMaxRadius || C < 1 || C > 4 || col0 < 0)
    return (int)cudaErrorInvalidValue;
  if ((size_t)Bl * Hb * lw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(((lw + 2 * radius) * C + kThreads - 1) / kThreads, Hb, Bl);
  if (in_u8)
    halo_vertical<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), buf, h, w, sigma, radius, Hb, lw, C,
        col0);
  else
    halo_vertical<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(in), buf, h, w, sigma, radius, Hb, lw, C,
        col0);
  return (int)cudaGetLastError();
}

// Pass H of K13: buf [Bl, Hb, lw + 2 * radius, C] f32 with its halos
// filled -> out [Bl, Hb, lw, C] f32. Wb: the global bucket width. Returns
// the launch's CUDA error code.
extern "C" int itpu_blur_halo_h(const float* buf, float* out,
                                const int32_t* h, const int32_t* w,
                                const float* sigma, int radius, int Bl,
                                int Hb, int lw, int C, int col0, int Wb,
                                void* stream) {
  if (radius < 0 || radius > kMaxRadius || C < 1 || C > 4 || col0 < 0 ||
      col0 + lw > Wb)
    return (int)cudaErrorInvalidValue;
  if ((size_t)Bl * Hb * lw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((lw * C + kThreads - 1) / kThreads, Hb, Bl);
  halo_horizontal<<<grid, kThreads, 0, s>>>(buf, out, h, w, sigma, radius, Hb,
                                            lw, C, col0, Wb);
  return (int)cudaGetLastError();
}
