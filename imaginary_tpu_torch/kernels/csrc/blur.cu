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
// 11.3 MB each (6.7 us at 3.35 TB/s) against 38 flops per element (1.6 us
// at 67 TFLOP/s: 2 a tap each way, 2 for the normalisation); at r = 64 the
// up to 518 flops per element (500 on average over the valid 720 x 1280,
// 21 us) bound it.
//
// Design: one launch, no intermediate in device memory. A block owns a
// strip of `strip` output columns (all C channels) and kRows = 8 output
// rows of one image. Its prologue builds the tables once: the image's
// taps (exp in parallel, then each thread that normalises a tap sums all
// of them in ascending order itself, so no thread waits on a serial loop
// of another), rowden for its rows and colden for its columns (one thread
// per entry, ascending tap sums). Then:
//   1. the vertical sums of the 8 rows at the valid columns in [x0 - r,
//      x0 + strip + r) go into shared memory. A thread owns one element
//      (neighbouring threads on neighbouring addresses) and sums all 8
//      rows at once: a window of 8 input values slides down one row a
//      tap, so each tap and each of the 8 + 2r input rows is loaded once
//      for 8 outputs;
//   2. one barrier;
//   3. the horizontal sums read the shared rows and their r-column halos,
//      again 8 rows a thread (one tap load for 8 outputs), divide by
//      rowden * colden and store f32, or uint8 with the chain's
//      clip(x + 0.5) epilogue, straight to the output.
// Rows and columns outside the valid region store 0 without summing.
// Every output element takes the arithmetic of the two-pass design in the
// same order (taps as in `load_taps` of csrc/blur_halo.cu; vertical sums
// over ascending t, horizontal ones over ascending s, as fused
// multiply-adds from 0; rowden and colden as ascending sums), so the
// result equals that design's, and K13's, bit for bit: the window takes
// rows outside the valid ones as 0 where that design skipped their taps,
// and adding +0 leaves a sum as it was (only a sum of -0 turns +0).
// uint8 input is cast on load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 64;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kRows = 8;  // output rows a thread sums at once
constexpr int kMinBlocks = 4;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)__ldg(p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// Shared memory, in floats: raw and normalised taps, rowden [kRows],
// colden [strip], then kRows rows of vertical sums [(strip + 2r) * C].
inline int smem_floats(int strip, int r, int C) {
  return 2 * kMaxTaps + kRows + strip + kRows * (strip + 2 * r) * C;
}

// grid: x = ceil(Wb / strip), y = ceil(Hb / kRows), z = B; block: kThreads.
// At least kMinBlocks blocks an SM: ptxas keeps to 64 registers a thread
// (left alone it unrolls the tap loops to ~100 and halves the blocks).
template <typename TIn, typename TOut, int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    blur_fused(const TIn* __restrict__ in, TOut* __restrict__ out,
               const int32_t* __restrict__ h, const int32_t* __restrict__ w,
               const float* __restrict__ sigma, int r, int Hb, int Wb,
               int strip) {
  extern __shared__ float smem[];
  float* raw = smem;
  float* taps = raw + kMaxTaps;
  float* rowden = taps + kMaxTaps;
  float* colden = rowden + kRows;
  float* vs = colden + strip;
  const int ext = (strip + 2 * r) * C;  // one row of vertical sums

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * strip;
  const int yb = blockIdx.y * kRows;
  const int hh = min(h[b], Hb);
  const int ww = min(w[b], Wb);
  const int n = 2 * r + 1;
  const int tid = threadIdx.x;

  // the image's taps: tap t at index t + r
  const float sg = sigma[b];
  const bool gauss = sg > 0.0f;
  const float s = fmaxf(sg, 1e-3f);
  for (int i = tid; i < n; i += kThreads) {
    const float t = (float)(i - r);
    if (gauss) {
      const float q = t / s;
      raw[i] = expf(-0.5f * (q * q));
    } else {
      raw[i] = fabsf(t) < 0.5f ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  if (tid < n) {
    float v = raw[tid];
    if (gauss) {
      float total = 0.0f;
      for (int i = 0; i < n; ++i) total += raw[i];
      v = v / total;
    }
    taps[tid] = v;
  }
  __syncthreads();
  // rowden of the block's rows, colden of its columns
  for (int i = tid; i < kRows + strip; i += kThreads) {
    float d = 0.0f;
    if (i < kRows) {
      const int y = yb + i;
      if (y < hh)
        for (int t = max(-r, -y); t <= min(r, hh - 1 - y); ++t) d += taps[t + r];
      rowden[i] = d;
    } else {
      const int x = x0 + i - kRows;
      if (x < ww)
        for (int t = max(-r, -x); t <= min(r, ww - 1 - x); ++t) d += taps[t + r];
      colden[i - kRows] = d;
    }
  }
  __syncthreads();

  const long long row_len = (long long)Wb * C;
  const TIn* img = in + (size_t)b * Hb * row_len;
  TOut* oimg = out + (size_t)b * Hb * row_len + (size_t)x0 * C;
  const int nout = min(strip, Wb - x0) * C;  // output elements of a row
  const int xe0 = x0 - r;                    // first column of a sums row
  const int ca = max(xe0, 0);                // valid columns [ca, cb)
  const int cb = min(x0 + strip + r, ww);
  const int nv = (cb - ca) * C;
  const int nrow = min(kRows, Hb - yb);  // the block's rows in the bucket
  if (yb >= hh || x0 >= ww) {  // uniform over the block: zeros only
    for (int k = 0; k < nrow; ++k)
      for (int e = tid; e < nout; e += kThreads)
        store(oimg + (size_t)(yb + k) * row_len + e, 0.0f);
    return;
  }
  // vertical sums of rows yb .. yb + kRows - 1: for ascending t, each row
  // k adds taps[t + r] * x[yb + k + t]; the window d holds x[yb + k + t]
  // (0 outside the valid rows) and slides down one row a tap
  const TIn* src = img + (size_t)ca * C;
  float* dst = vs + (ca - xe0) * C;
  for (int e = tid; e < nv; e += kThreads) {
    const TIn* p = src + e;
    float d[kRows], acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int yi = yb + k - r;
      d[k] = (yi >= 0 && yi < hh) ? load(p + yi * row_len) : 0.0f;
      acc[k] = 0.0f;
    }
    for (int t = -r; t <= r; ++t) {
      const float tap = taps[t + r];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = fmaf(tap, d[k], acc[k]);
#pragma unroll
      for (int k = 0; k < kRows - 1; ++k) d[k] = d[k + 1];
      const int yi = yb + kRows + t;
      d[kRows - 1] = (yi >= 0 && yi < hh) ? load(p + yi * row_len) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) dst[k * ext + e] = acc[k];
  }
  __syncthreads();
  // horizontal sums, the normalisation and the store, kRows rows a
  // thread: one tap load serves them all
  for (int e = tid; e < nout; e += kThreads) {
    const int xl = e / C;
    const int x = x0 + xl;
    float acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
    if (x < ww) {
      const int s0 = max(-r, -x);
      const int s1 = min(r, ww - 1 - x);
      const float* q = vs + e + r * C;  // column x of sums row 0
      for (int t = s0; t <= s1; ++t) {
        const float tap = taps[t + r];
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k] = fmaf(tap, q[k * ext + t * C], acc[k]);
      }
    }
    const float cd = colden[xl];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nrow) {
        const int y = yb + k;
        const float v = (x < ww && y < hh) ? acc[k] / fmaxf(rowden[k] * cd, 1e-6f) : 0.0f;
        store(oimg + (size_t)y * row_len + e, v);
      }
    }
  }
}

template <typename TIn, typename TOut, int C>
int launch(const void* in, void* out, const int32_t* h, const int32_t* w,
           const float* sigma, int r, int B, int Hb, int Wb, int strip,
           cudaStream_t s) {
  // the wrapper's strips (BLUR_EXT) keep this under 35 KB, inside the
  // 48 KB a launch gets without opting in
  const size_t smem = sizeof(float) * smem_floats(strip, r, C);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((Wb + strip - 1) / strip, (Hb + kRows - 1) / kRows, B);
  blur_fused<TIn, TOut, C><<<grid, kThreads, smem, s>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), h, w, sigma, r,
      Hb, Wb, strip);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_c(int C, const void* in, void* out, const int32_t* h,
             const int32_t* w, const float* sigma, int r, int B, int Hb,
             int Wb, int strip, cudaStream_t s) {
  switch (C) {
    case 1: return launch<TIn, TOut, 1>(in, out, h, w, sigma, r, B, Hb, Wb, strip, s);
    case 2: return launch<TIn, TOut, 2>(in, out, h, w, sigma, r, B, Hb, Wb, strip, s);
    case 3: return launch<TIn, TOut, 3>(in, out, h, w, sigma, r, B, Hb, Wb, strip, s);
    default: return launch<TIn, TOut, 4>(in, out, h, w, sigma, r, B, Hb, Wb, strip, s);
  }
}

}  // namespace

// K6 in one launch: in [B, Hb, Wb, C] (uint8 if in_u8, else f32) -> out
// (uint8 with the epilogue if out_u8, else f32). h, w: int32 [B] valid
// dims; sigma: f32 [B]; radius 0..64; a block makes 8 rows of a strip
// `strip` columns wide (the wrapper picks it). Returns the launch's CUDA
// error code.
extern "C" int itpu_blur(const void* in, int in_u8, void* out, int out_u8,
                         const int32_t* h, const int32_t* w,
                         const float* sigma, int radius, int B, int Hb,
                         int Wb, int C, int strip, void* stream) {
  if (radius < 0 || radius > kMaxRadius || C < 1 || C > 4 || strip < 1)
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch_c<uint8_t, uint8_t>(C, in, out, h, w, sigma, radius, B, Hb, Wb, strip, s);
  if (in_u8)
    return launch_c<uint8_t, float>(C, in, out, h, w, sigma, radius, B, Hb, Wb, strip, s);
  if (out_u8)
    return launch_c<float, uint8_t>(C, in, out, h, w, sigma, radius, B, Hb, Wb, strip, s);
  return launch_c<float, float>(C, in, out, h, w, sigma, radius, B, Hb, Wb, strip, s);
}
