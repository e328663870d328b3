// K6: separable Gaussian blur, normalised against each image's valid mask.
//
// Replaces: imaginary_tpu/ops/stages.py:237-280 (`BlurSpec.apply`).
//
// Function, for x [B, Hb, Wb, C] (C = 1..4) with per-image valid dims h, w
// (int32 [B]), per-image sigma (f32 [B]) and a static radius r <= 64:
//   k[t]  = exp(-0.5 * (t / max(sigma, 1e-3))^2) / sum over t in [-r, r],
//           or the delta (k[0] = 1) where sigma <= 0;
//   m     = (y < h) & (x < w), the validity mask;
//   out   = conv_h(conv_v(x * m)) / max(conv_h(conv_v(m)), 1e-6) inside
//           the valid (h, w), and 0 outside it, bucket padding included,
// where conv_v and conv_h are the 2r+1-tap correlations with k along rows
// and columns with zero padding beyond the bucket ("SAME"). The vertical
// pass runs first, then the horizontal one. Unlike the orientation kernel,
// the padding is zeroed, not copied.
//
// m is the outer product of a row indicator and a column indicator, so
// conv_h(conv_v(m))[y, x] = rowden[y] * colden[x] with
//   rowden[y] = sum of k[t] over 0 <= y + t < h,
//   colden[x] = sum of k[s] over 0 <= x + s < w.
// The kernel computes those two 1-D tap sums instead of convolving a mask
// image (equal in exact arithmetic; within a few f32 ulps of the
// reference's order of sums).
//
// Bound on the H100: memory for small radii, arithmetic for large ones.
// At config 3's f32 [1, 736, 1280, 3] with r = 4 the input and output are
// 11.3 MB each (6.7 us at 3.35 TB/s) against 36 flops per element (1.5 us
// at 67 TFLOP/s); at r = 64 the 516 flops per element (22 us) bound it.
//
// Design: two launches with an f32 intermediate [B, Hb, Wb, C] the
// wrapper allocates. Pass 0 (vertical) gives one thread per element of a
// row (Wb * C elements, neighbouring threads on neighbouring addresses),
// so the 2r+1 rows it reads for a tap loop are coalesced and reused
// through L1/L2 by the neighbouring row blocks. Pass 1 (horizontal) reads
// the intermediate along the row at a stride of C, again one thread per
// element. Each block computes its image's taps into shared memory
// (summed in order by one thread, then divided) and pass 1 its row's
// rowden; tap loops are clipped to the valid rows or columns, since the
// masked terms are zero. The intermediate holds 0 outside the valid
// region. uint8 input (blur as the RGB transport's first stage) is cast
// on load, and a uint8 output applies the chain's clip(x + 0.5) epilogue
// on store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 64;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

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

// grid: x = ceil(Wb * C / kThreads), y = Hb, z = B; block: kThreads.
template <typename TIn>
__global__ void blur_vertical(const TIn* __restrict__ in,
                              float* __restrict__ tmp,
                              const int32_t* __restrict__ h,
                              const int32_t* __restrict__ w,
                              const float* __restrict__ sigma, int r, int Hb,
                              int Wb, int C) {
  __shared__ float taps[kMaxTaps];
  __shared__ float total;
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  load_taps(taps, &total, sigma[b], r);
  const int row_len = Wb * C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= row_len) return;
  const int hh = min(h[b], Hb);
  const int ww = min(w[b], Wb);
  const size_t at = ((size_t)b * Hb + y) * row_len + e;
  float acc = 0.0f;
  if (y < hh && e / C < ww) {
    const int t0 = max(-r, -y);
    const int t1 = min(r, hh - 1 - y);
    const TIn* col = in + at;
    for (int t = t0; t <= t1; ++t)
      acc += taps[t + r] * load(col + (long long)t * row_len);
  }
  tmp[at] = acc;
}

// grid: x = ceil(Wb * C / kThreads), y = Hb, z = B; block: kThreads.
template <typename TOut>
__global__ void blur_horizontal(const float* __restrict__ tmp,
                                TOut* __restrict__ out,
                                const int32_t* __restrict__ h,
                                const int32_t* __restrict__ w,
                                const float* __restrict__ sigma, int r,
                                int Hb, int Wb, int C) {
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
  const int row_len = Wb * C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= row_len) return;
  const size_t at = ((size_t)b * Hb + y) * row_len + e;
  const int x = e / C;
  float v = 0.0f;
  if (y < hh && x < ww) {
    const int s0 = max(-r, -x);
    const int s1 = min(r, ww - 1 - x);
    const float* row = tmp + at;
    float acc = 0.0f;
    float colden = 0.0f;
    for (int s = s0; s <= s1; ++s) {
      acc += taps[s + r] * row[s * C];
      colden += taps[s + r];
    }
    v = acc / fmaxf(rowden * colden, 1e-6f);
  }
  store(out + at, v);
}

}  // namespace

// One pass of K6. vertical = 1: in [B, Hb, Wb, C] (uint8 if in_u8, else
// f32) -> out, the f32 intermediate. vertical = 0: in, the f32
// intermediate -> out (uint8 with the epilogue if out_u8, else f32). h, w:
// int32 [B] valid dims; sigma: f32 [B]; radius 0..64. Returns the launch's
// CUDA error code.
extern "C" int itpu_blur_pass(const void* in, int in_u8, void* out,
                              int out_u8, const int32_t* h, const int32_t* w,
                              const float* sigma, int radius, int vertical,
                              int B, int Hb, int Wb, int C, void* stream) {
  if (radius < 0 || radius > kMaxRadius || C < 1 || C > 4)
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((Wb * C + kThreads - 1) / kThreads, Hb, B);
  if (vertical) {
    float* tmp = static_cast<float*>(out);
    if (in_u8)
      blur_vertical<uint8_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(in), tmp, h, w, sigma, radius, Hb, Wb, C);
    else
      blur_vertical<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(in), tmp, h, w, sigma, radius, Hb, Wb, C);
  } else {
    const float* tmp = static_cast<const float*>(in);
    if (out_u8)
      blur_horizontal<uint8_t><<<grid, kThreads, 0, s>>>(
          tmp, static_cast<uint8_t*>(out), h, w, sigma, radius, Hb, Wb, C);
    else
      blur_horizontal<float><<<grid, kThreads, 0, s>>>(
          tmp, static_cast<float*>(out), h, w, sigma, radius, Hb, Wb, C);
  }
  return (int)cudaGetLastError();
}
