// A variant of K5 (imaginary_tpu_torch/kernels/csrc/orient.cu) with 16-byte
// vector loads and stores, f32 in and out, timed against the kernel the
// program ships by scripts/orient_vec_ab.py. The program does not use it.
// Same function and modes (t, fy, fx) as orient.cu; Wb % 4 == 0, and
// Hb C % 4 == 0 when t, so every row of the input and the output starts
// 16-byte aligned.
//
// - Modes that keep the axes (`rows_vec`): a thread moves kG groups of 4
//   pixels (C float4 each), every load issued before the first store. A
//   group whose source is 4 whole pixels from a 16-byte aligned offset (the
//   same columns, the padding, or a mirrored run inside the valid width
//   whose first source pixel is aligned) loads as C float4, its pixel order
//   reversed in registers where mirrored; a group that straddles w or
//   starts unaligned loads element by element. Stores are C float4.
//   `rows_smem` is the other form: a block takes kSegP pixels of one
//   output row; its source is at most two ranges (the mirrored columns
//   inside w, and the rest in place), each loaded as 16-byte aligned float4
//   with lanes on consecutive vectors into shared memory; each thread then
//   gathers 4 output floats from there (the pixel order reversed) and
//   stores them as one float4, lanes on consecutive vectors.
// - Modes that transpose (`tiles_vec`): tiles of 32 input rows by 64 input
//   pixels, staged in output order, tile[i][r C + c] with a row stride of
//   32 C + 4 floats, so a store reads one float4 of the tile and writes one
//   float4 of the output. A tile row's 64 source pixels (in order, or
//   mirrored inside ho where the range lies inside it and starts aligned)
//   load as 16 C float4; other tiles load element by element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kG = 2;  // rows_vec: 4-pixel groups a thread
constexpr int kSegP = 1024;  // rows_smem: pixels of a block's segment
constexpr int kTR = 32;  // tiles_vec: output columns (input rows)
constexpr int kTP = 64;  // and output rows (input pixels)

__device__ __forceinline__ int mirror(int on, int v, int n) {
  return on && v < n ? n - 1 - v : v;
}

__device__ __forceinline__ float& el(float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// grid: x = B * Hb output rows times `segs` segments of kThreads * kG
// groups a row.
template <int C>
__global__ void __launch_bounds__(kThreads)
rows_vec(const float* __restrict__ in, float* __restrict__ out,
         const int32_t* __restrict__ h, const int32_t* __restrict__ w, int fy,
         int fx, int Hb, int Wb, int segs) {
  await_previous_kernel();
  const int ng = Wb / 4;
  const int row = blockIdx.x / segs;  // b * Hb + y
  const int g0 = (blockIdx.x - row * segs) * (kThreads * kG) + threadIdx.x;
  const int b = row / Hb;
  const int y = row - b * Hb;
  const int ww = w[b];
  const float* src = in + ((size_t)b * Hb + mirror(fy, y, h[b])) * Wb * C;
  float* dst = out + (size_t)row * Wb * C;
  float4 v[kG][C];
#pragma unroll
  for (int u = 0; u < kG; ++u) {
    const int g = g0 + u * kThreads;
    if (g >= ng) continue;
    const int x0 = 4 * g;
    const bool same = !fx || x0 >= ww;
    const int s0 = ww - 4 - x0;  // a mirrored group's first source pixel
    if (same || (x0 + 4 <= ww && (s0 * C) % 4 == 0)) {
      const float4* p = reinterpret_cast<const float4*>(src + (same ? x0 : s0) * C);
      float4 t[C];
#pragma unroll
      for (int k = 0; k < C; ++k) t[k] = p[k];
      if (same) {
#pragma unroll
        for (int k = 0; k < C; ++k) v[u][k] = t[k];
      } else {
#pragma unroll
        for (int q = 0; q < 4 * C; ++q) {
          const int sq = (3 - q / C) * C + q % C;  // pixel 3 - q / C
          el(v[u][q / 4], q % 4) = el(t[sq / 4], sq % 4);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4 * C; ++q)
        el(v[u][q / 4], q % 4) = src[mirror(fx, x0 + q / C, ww) * C + q % C];
    }
  }
#pragma unroll
  for (int u = 0; u < kG; ++u) {
    const int g = g0 + u * kThreads;
    if (g >= ng) continue;
    float4* p = reinterpret_cast<float4*>(dst + 4 * g * C);
#pragma unroll
    for (int k = 0; k < C; ++k) p[k] = v[u][k];
  }
}

// grid: x = B * Hb output rows times `segs` segments of kSegP pixels a row.
template <int C>
__global__ void __launch_bounds__(kThreads)
rows_smem(const float* __restrict__ in, float* __restrict__ out,
          const int32_t* __restrict__ h, const int32_t* __restrict__ w, int fy,
          int fx, int Hb, int Wb, int segs) {
  constexpr int kSegF = kSegP * C;                        // floats a segment
  constexpr int kBuf = kSegF + 16;                        // both ranges, aligned out
  constexpr int kLoadV = (kSegF / 4 + 4 + kThreads - 1) / kThreads;
  constexpr int kStoreV = (kSegF / 4 + kThreads - 1) / kThreads;
  __shared__ __align__(16) float buf[kBuf];
  await_previous_kernel();
  const int row = blockIdx.x / segs;  // b * Hb + y
  const int x0 = (blockIdx.x - row * segs) * kSegP;
  const int n = min(kSegP, Wb - x0);
  const int b = row / Hb;
  const int y = row - b * Hb;
  const int ww = w[b];
  const float* src = in + ((size_t)b * Hb + mirror(fy, y, h[b])) * Wb * C;
  float* dst = out + (size_t)row * Wb * C;
  // output pixels [x0, xm) read mirrored source pixels [ww - xm, ww - x0);
  // pixels [xm, x0 + n) read themselves
  const int xm = fx ? max(x0, min(x0 + n, ww)) : x0;
  const int a0 = ((ww - xm) * C) & ~3, a1 = ((ww - x0) * C + 3) & ~3;
  const int na = xm > x0 ? (a1 - a0) / 4 : 0;  // float4 of the mirrored range
  const int p0 = (xm * C) & ~3, p1 = ((x0 + n) * C + 3) & ~3;
  const int np = xm < x0 + n ? (p1 - p0) / 4 : 0;
  const int boff = na * 4;  // the in-place range's place in buf
  float4 v[kLoadV];
#pragma unroll
  for (int k = 0; k < kLoadV; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < na) v[k] = reinterpret_cast<const float4*>(src + a0)[j];
    else if (j < na + np) v[k] = reinterpret_cast<const float4*>(src + p0)[j - na];
  }
#pragma unroll
  for (int k = 0; k < kLoadV; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < na + np) reinterpret_cast<float4*>(buf)[j] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kStoreV; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j * 4 < n * C) {
      const int e0 = x0 * C + 4 * j;  // first float of the output row
      float4 o;
      if (e0 >= xm * C) {  // in place: one aligned float4 of buf
        o = reinterpret_cast<const float4*>(buf + boff)[(e0 - p0) / 4];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = e0 + q;
          const int x = e / C, c = e - x * C;
          el(o, q) = x < xm ? buf[(ww - 1 - x) * C + c - a0] : buf[boff + e - p0];
        }
      }
      reinterpret_cast<float4*>(dst + x0 * C)[j] = o;
    }
  }
}

// grid: x = ceil(Hb / kTR) tiles along the output's columns, y =
// ceil(Wb / kTP) along its rows, z = B.
template <int C>
__global__ void __launch_bounds__(kThreads)
tiles_vec(const float* __restrict__ in, float* __restrict__ out,
          const int32_t* __restrict__ h, const int32_t* __restrict__ w, int fy,
          int fx, int Hb, int Wb) {
  constexpr int kS = kTR * C + 4;                   // tile row stride (floats)
  constexpr int kRowV = kTP * C / 4;                // float4 of a source range
  constexpr int kLoadV = kTR * kRowV / kThreads;    // a thread's loads
  constexpr int kOutV = kTR * C / 4;                // float4 of an output row
  constexpr int kStoreV = kTP * kOutV / kThreads;   // a thread's stores
  __shared__ __align__(16) float tile[kTP * kS];
  await_previous_kernel();
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTR, y0 = blockIdx.y * kTP;
  const int nr = min(kTR, Hb - x0), np = min(kTP, Wb - y0);
  const int ho = w[b], wo = h[b];
  const float* img = in + (size_t)b * Hb * Wb * C;
  const bool whole = nr == kTR && np == kTP;
  const bool mirrored = fy && y0 < ho;
  const int s0 = mirrored ? ho - y0 - kTP : y0;  // the range's first pixel
  if (whole && (!mirrored || (y0 + kTP <= ho && (s0 * C) % 4 == 0))) {
    float4 v[kLoadV];
#pragma unroll
    for (int k = 0; k < kLoadV; ++k) {
      const int f = threadIdx.x + k * kThreads;
      const int r = f / kRowV;
      v[k] = reinterpret_cast<const float4*>(
          img + (size_t)mirror(fx, x0 + r, wo) * Wb * C + s0 * C)[f - r * kRowV];
    }
#pragma unroll
    for (int k = 0; k < kLoadV; ++k) {
      const int f = threadIdx.x + k * kThreads;
      const int r = f / kRowV, j = f - r * kRowV;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * j + q;  // float of the source range
        const int p = e / C;
        const int i = mirrored ? kTP - 1 - p : p;
        tile[i * kS + r * C + (e - p * C)] = el(v[k], q);
      }
    }
  } else {
    for (int f = threadIdx.x; f < nr * np * C; f += kThreads) {
      const int r = f / (np * C), k = f - r * (np * C);
      const int i = k / C;
      tile[i * kS + r * C + (k - i * C)] =
          img[(size_t)mirror(fx, x0 + r, wo) * Wb * C + mirror(fy, y0 + i, ho) * C +
              (k - i * C)];
    }
  }
  __syncthreads();
  float* dst = out + ((size_t)b * Wb + y0) * Hb * C + (size_t)x0 * C;
  if (whole) {
#pragma unroll
    for (int k = 0; k < kStoreV; ++k) {
      const int f = threadIdx.x + k * kThreads;
      const int i = f / kOutV, j = f - i * kOutV;
      reinterpret_cast<float4*>(dst + (size_t)i * Hb * C)[j] =
          *reinterpret_cast<const float4*>(&tile[i * kS + 4 * j]);
    }
  } else {
    for (int f = threadIdx.x; f < np * nr * C; f += kThreads) {
      const int i = f / (nr * C), e = f - i * (nr * C);
      dst[(size_t)i * Hb * C + e] = tile[i * kS + e];
    }
  }
}

template <int C>
cudaError_t launch_c(const float* in, float* out, const int32_t* h,
                     const int32_t* w, int t, int fy, int fx, int B, int Hb,
                     int Wb, int rows_form, cudaStream_t s) {
  if (!t && rows_form) {
    const int segs = (Wb + kSegP - 1) / kSegP;
    return launch_pdl(rows_smem<C>, dim3((unsigned)(B * Hb * segs)), dim3(kThreads),
                      0, s, in, out, h, w, fy, fx, Hb, Wb, segs);
  }
  if (!t) {
    const int segs = (Wb / 4 + kThreads * kG - 1) / (kThreads * kG);
    return launch_pdl(rows_vec<C>, dim3((unsigned)(B * Hb * segs)), dim3(kThreads),
                      0, s, in, out, h, w, fy, fx, Hb, Wb, segs);
  }
  const dim3 grid((Hb + kTR - 1) / kTR, (Wb + kTP - 1) / kTP, B);
  return launch_pdl(tiles_vec<C>, grid, dim3(kThreads), 0, s, in, out, h, w, fy,
                    fx, Hb, Wb);
}

}  // namespace

// itpu_orient's f32 form (orient.cu), on rows that start 16-byte aligned;
// rows_form picks the modes that keep the axes' kernel (0 rows_vec, 1
// rows_smem). Returns the launch's CUDA error code.
extern "C" int itpu_orient_vec(const float* in, float* out, const int32_t* h,
                               const int32_t* w, int t, int fy, int fx, int B,
                               int Hb, int Wb, int C, int rows_form,
                               void* stream) {
  if (C < 1 || C > 4 || (t | fy | fx) & ~1 || Wb % 4 || (t && Hb * C % 4))
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 1: err = launch_c<1>(in, out, h, w, t, fy, fx, B, Hb, Wb, rows_form, s); break;
    case 2: err = launch_c<2>(in, out, h, w, t, fy, fx, B, Hb, Wb, rows_form, s); break;
    case 3: err = launch_c<3>(in, out, h, w, t, fy, fx, B, Hb, Wb, rows_form, s); break;
    default: err = launch_c<4>(in, out, h, w, t, fy, fx, B, Hb, Wb, rows_form, s); break;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
