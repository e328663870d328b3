// The fused masked Gaussian blur that K6 (csrc/blur.cu) and K13
// (csrc/blur_halo.cu) both launch: one block makes kRows = 8 output rows
// of a strip of `strip` columns (all C channels) of one image. Design and
// arithmetic are described in csrc/blur.cu.
//
// The block reads the input columns [x0 - r, x0 + strip + r) around its
// strip. For K6 they all lie in the image (`in`, lw = Wb, col0 = 0). For
// K13 (kHalo) the image is one W-shard holding global columns [col0,
// col0 + lw): columns left of it come from `left` [B, Hb, r, C], columns
// right of it from `right` [B, Hb, r, C], the neighbouring shards' input
// columns copied there by the halo exchange. Validity, the tap ranges
// and colden are taken over GLOBAL columns (col0 + x against the image's
// w and the bucket's Wb), so every output of a shard takes the same
// arithmetic in the same order as K6's output at that global column: the
// gathered shards equal K6 bit for bit. Halo columns outside [0, w) are
// never read, so the first shard's `left` and the last shard's `right`
// may be null.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blur_fused {

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

// grid: x = ceil(lw / strip), y = ceil(Hb / kRows), z = B; block: kThreads.
// At least kMinBlocks blocks an SM: ptxas keeps to 64 registers a thread
// (left alone it unrolls the tap loops to ~100 and halves the blocks).
template <typename TIn, typename TOut, int C, bool kHalo>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    blur_fused(const TIn* __restrict__ in, const TIn* __restrict__ left,
               const TIn* __restrict__ right, TOut* __restrict__ out,
               const int32_t* __restrict__ h, const int32_t* __restrict__ w,
               const float* __restrict__ sigma, int r, int Hb, int lw,
               int col0, int Wb, int strip) {
  extern __shared__ float smem[];
  float* raw = smem;
  float* taps = raw + kMaxTaps;
  float* rowden = taps + kMaxTaps;
  float* colden = rowden + kRows;
  float* vs = colden + strip;
  const int ext = (strip + 2 * r) * C;  // one row of vertical sums

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * strip;  // the strip's first column in the shard
  const int g0 = col0 + x0;           // ... and in the image
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
  // rowden of the block's rows, colden of its (global) columns
  for (int i = tid; i < kRows + strip; i += kThreads) {
    float d = 0.0f;
    if (i < kRows) {
      const int y = yb + i;
      if (y < hh)
        for (int t = max(-r, -y); t <= min(r, hh - 1 - y); ++t) d += taps[t + r];
      rowden[i] = d;
    } else {
      const int x = g0 + i - kRows;
      if (x < ww)
        for (int t = max(-r, -x); t <= min(r, ww - 1 - x); ++t) d += taps[t + r];
      colden[i - kRows] = d;
    }
  }
  __syncthreads();

  const long long row_len = (long long)lw * C;
  const TIn* img = in + (size_t)b * Hb * row_len;
  TOut* oimg = out + (size_t)b * Hb * row_len + (size_t)x0 * C;
  const int nout = min(strip, lw - x0) * C;  // output elements of a row
  const int xe0 = x0 - r;                    // first column of a sums row
  // valid columns [ca, cb), shard-local: inside the image, and (K13)
  // inside the shard and its two halos
  const int ca = max(xe0, -col0);
  const int cb = min(min(x0 + strip + r, lw + r), ww - col0);
  const int nv = (cb - ca) * C;
  const int nrow = min(kRows, Hb - yb);  // the block's rows in the bucket
  if (yb >= hh || g0 >= ww) {  // uniform over the block: zeros only
    for (int k = 0; k < nrow; ++k)
      for (int e = tid; e < nout; e += kThreads)
        store(oimg + (size_t)(yb + k) * row_len + e, 0.0f);
    return;
  }
  // vertical sums of rows yb .. yb + kRows - 1: for ascending t, each row
  // k adds taps[t + r] * x[yb + k + t]; the window d holds x[yb + k + t]
  // (0 outside the valid rows) and slides down one row a tap
  float* dst = vs + (ca - xe0) * C;
  for (int e = tid; e < nv; e += kThreads) {
    const TIn* p = img + (size_t)ca * C + e;
    long long pitch = row_len;
    if (kHalo) {
      const int pos = ca + e / C;  // the column, -r .. lw + r - 1
      const int ch = e - (e / C) * C;
      if (pos < 0) {
        p = left + (size_t)b * Hb * r * C + (pos + r) * C + ch;
        pitch = (long long)r * C;
      } else if (pos >= lw) {
        p = right + (size_t)b * Hb * r * C + (pos - lw) * C + ch;
        pitch = (long long)r * C;
      }
    }
    float d[kRows], acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int yi = yb + k - r;
      d[k] = (yi >= 0 && yi < hh) ? load(p + yi * pitch) : 0.0f;
      acc[k] = 0.0f;
    }
    for (int t = -r; t <= r; ++t) {
      const float tap = taps[t + r];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = fmaf(tap, d[k], acc[k]);
#pragma unroll
      for (int k = 0; k < kRows - 1; ++k) d[k] = d[k + 1];
      const int yi = yb + kRows + t;
      d[kRows - 1] = (yi >= 0 && yi < hh) ? load(p + yi * pitch) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) dst[k * ext + e] = acc[k];
  }
  __syncthreads();
  // horizontal sums, the normalisation and the store, kRows rows a
  // thread: one tap load serves them all
  for (int e = tid; e < nout; e += kThreads) {
    const int xl = e / C;
    const int x = g0 + xl;  // the global column
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

template <typename TIn, typename TOut, int C, bool kHalo>
int launch(const void* in, const void* left, const void* right, void* out,
           const int32_t* h, const int32_t* w, const float* sigma, int r,
           int B, int Hb, int lw, int col0, int Wb, int strip,
           cudaStream_t s) {
  // the wrapper's strips (BLUR_EXT) keep this under 35 KB, inside the
  // 48 KB a launch gets without opting in
  const size_t smem = sizeof(float) * smem_floats(strip, r, C);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((lw + strip - 1) / strip, (Hb + kRows - 1) / kRows, B);
  blur_fused<TIn, TOut, C, kHalo><<<grid, kThreads, smem, s>>>(
      static_cast<const TIn*>(in), static_cast<const TIn*>(left),
      static_cast<const TIn*>(right), static_cast<TOut*>(out), h, w, sigma,
      r, Hb, lw, col0, Wb, strip);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, bool kHalo>
int launch_c(int C, const void* in, const void* left, const void* right,
             void* out, const int32_t* h, const int32_t* w, const float* sigma,
             int r, int B, int Hb, int lw, int col0, int Wb, int strip,
             cudaStream_t s) {
  switch (C) {
    case 1:
      return launch<TIn, TOut, 1, kHalo>(in, left, right, out, h, w, sigma, r,
                                         B, Hb, lw, col0, Wb, strip, s);
    case 2:
      return launch<TIn, TOut, 2, kHalo>(in, left, right, out, h, w, sigma, r,
                                         B, Hb, lw, col0, Wb, strip, s);
    case 3:
      return launch<TIn, TOut, 3, kHalo>(in, left, right, out, h, w, sigma, r,
                                         B, Hb, lw, col0, Wb, strip, s);
    default:
      return launch<TIn, TOut, 4, kHalo>(in, left, right, out, h, w, sigma, r,
                                         B, Hb, lw, col0, Wb, strip, s);
  }
}

// One launch over the four (input, output) dtype pairs: uint8 input if
// in_u8, else f32; uint8 output with the epilogue if out_u8, else f32.
template <bool kHalo>
int launch_any(int in_u8, int out_u8, int C, const void* in, const void* left,
               const void* right, void* out, const int32_t* h,
               const int32_t* w, const float* sigma, int r, int B, int Hb,
               int lw, int col0, int Wb, int strip, cudaStream_t s) {
  if (in_u8 && out_u8)
    return launch_c<uint8_t, uint8_t, kHalo>(C, in, left, right, out, h, w, sigma,
                                             r, B, Hb, lw, col0, Wb, strip, s);
  if (in_u8)
    return launch_c<uint8_t, float, kHalo>(C, in, left, right, out, h, w, sigma,
                                           r, B, Hb, lw, col0, Wb, strip, s);
  if (out_u8)
    return launch_c<float, uint8_t, kHalo>(C, in, left, right, out, h, w, sigma,
                                           r, B, Hb, lw, col0, Wb, strip, s);
  return launch_c<float, float, kHalo>(C, in, left, right, out, h, w, sigma, r,
                                       B, Hb, lw, col0, Wb, strip, s);
}

}  // namespace blur_fused
