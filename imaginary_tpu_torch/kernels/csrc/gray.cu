// K8: Rec.709 luma broadcast over RGB (colorspace=bw), alpha kept.
//
// Replaces: imaginary_tpu/ops/stages.py:625-635 (`GraySpec.apply`).
//
// Function, for x [B, Hb, Wb, C] (C = 3 or 4), at every pixel of the
// bucket:
//   lum = (0.2126 * R + 0.7152 * G) + 0.0722 * B   (summed in that order)
//   out = (lum, lum, lum) and, where C = 4, x's alpha unchanged.
// The sum is written with round-to-nearest intrinsics, so nvcc does not
// contract it into fused multiply-adds and it rounds as the reference's
// separate multiplies and adds do.
//
// Bound on the H100: memory; five flops a pixel. At the bw /resize's f32
// [1, 368, 640, 3] it reads and writes 2.83 MB each: 1.7 us at 3.35 TB/s.
// Where the next stage is K3 (JPEG out on the yuv420 transport), K3 applies
// this luma itself as it loads (yuv420_pack.cu, `luma`) and this kernel
// does not run.
//
// Design: the batch is one flat run of pixels, cut into groups of G
// pixels whose input and output both fill whole 16-byte vectors (f32
// C = 3: three float4 in and out make four pixels; C = 4: one float4 a
// pixel; uint8 in or out: uint4, 16 pixels at C = 3, 4 at C = 4). A warp
// takes a tile of 32 groups: its lanes load the tile's input vectors
// side by side (each load instruction reads 512 contiguous bytes), pass
// them through shared memory so that each lane holds its own group,
// compute it, and pass the output back the same way to store it side by
// side. All of a lane's loads are issued before the first is used. The
// groups after the last whole tile, and the pixels after the last whole
// group, take a scalar tail. A view that is not 16-byte aligned (its
// output is a fresh, aligned buffer, so no head could align both) runs
// every pixel through the scalar form. The grid is at most one full wave
// of resident blocks on every SM, walked in a grid-stride loop over
// tiles, and the launch is a programmatic dependent of the kernel before
// it (launch.cuh). uint8 input (the chain's first stage) is cast on load,
// and a uint8 output applies the chain's clip(x + 0.5) epilogue on store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kWarps = 4;  // a block's warps, one tile each at a time
constexpr int kThreads = 32 * kWarps;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// One pixel: src and dst point at its first channel.
template <typename TIn, typename TOut, int C>
__device__ __forceinline__ void gray_px(const TIn* src, TOut* dst) {
  const float lum = __fadd_rn(
      __fadd_rn(__fmul_rn(0.2126f, load(src)), __fmul_rn(0.7152f, load(src + 1))),
      __fmul_rn(0.0722f, load(src + 2)));
  store(dst, lum);
  store(dst + 1, lum);
  store(dst + 2, lum);
  if (C == 4) store(dst + 3, load(src + 3));
}

// The fewest pixels whose C channels of TIn and of TOut both fill whole
// 16-byte vectors.
template <typename TIn, typename TOut, int C>
__host__ __device__ constexpr int group_pixels() {
  int g = 1;
  while ((g * C * (int)sizeof(TIn)) % 16 || (g * C * (int)sizeof(TOut)) % 16) g++;
  return g;
}

template <typename TIn, typename TOut, int C>
struct Group {
  static constexpr int G = group_pixels<TIn, TOut, C>();
  static constexpr int NI = G * C * (int)sizeof(TIn) / 16;   // input vectors
  static constexpr int NO = G * C * (int)sizeof(TOut) / 16;  // output vectors
  // a lane's slots in the warp's shared tile: odd, so the 16-byte reads
  // of a quarter warp at this stride fall in distinct banks
  static constexpr int S = (NI > NO ? NI : NO) | 1;
  static constexpr int kSmem = kWarps * 32 * S * 16;
  // blocks resident on an SM: by threads (2048), by shared memory (227 KB
  // less 1 KB reserved a block)
  static constexpr int kPerSm =
      2048 / kThreads < 227 * 1024 / (kSmem + 1024) ? 2048 / kThreads
                                                     : 227 * 1024 / (kSmem + 1024);
};

// Vector v of a tile whose groups are N vectors each -> its shared slot.
template <int N, int S>
__device__ __forceinline__ int slot(int v) { return (v / N) * S + v % N; }

template <typename TIn, typename TOut, int C>
__global__ void __launch_bounds__(kThreads)
    gray(const TIn* __restrict__ in, TOut* __restrict__ out, long long pixels,
         long long tiles) {
  using Gr = Group<TIn, TOut, C>;
  constexpr int G = Gr::G, NI = Gr::NI, NO = Gr::NO, S = Gr::S;
  __shared__ uint4 tile_smem[kWarps][32 * S];  // Gr::kSmem bytes
  await_previous_kernel();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* sm = tile_smem[warp];
  const long long wstride = (long long)gridDim.x * kWarps;
  for (long long t = blockIdx.x * (long long)kWarps + warp; t < tiles; t += wstride) {
    const uint4* src = reinterpret_cast<const uint4*>(in) + t * 32 * NI;
    uint4 r[NI];
#pragma unroll
    for (int k = 0; k < NI; k++) r[k] = __ldg(src + 32 * k + lane);
#pragma unroll
    for (int k = 0; k < NI; k++) sm[slot<NI, S>(32 * k + lane)] = r[k];
    __syncwarp();
    union {
      uint4 v[NI];
      TIn e[G * C];
    } a;
    union {
      uint4 v[NO];
      TOut e[G * C];
    } o;
#pragma unroll
    for (int k = 0; k < NI; k++) a.v[k] = sm[lane * S + k];
#pragma unroll
    for (int p = 0; p < G; p++) gray_px<TIn, TOut, C>(a.e + p * C, o.e + p * C);
#pragma unroll
    for (int k = 0; k < NO; k++) sm[lane * S + k] = o.v[k];
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out) + t * 32 * NO;
#pragma unroll
    for (int k = 0; k < NO; k++) dst[32 * k + lane] = sm[slot<NO, S>(32 * k + lane)];
    __syncwarp();  // the tile's slots are free for the next tile
  }
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = tiles * 32 * G + t0; p < pixels; p += stride)
    gray_px<TIn, TOut, C>(in + p * C, out + p * C);
}

template <typename TIn, typename TOut, int C>
int launch(const void* in, void* out, long long pixels, cudaStream_t s) {
  using Gr = Group<TIn, TOut, C>;
  constexpr int G = Gr::G;
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long tiles = vec ? pixels / (32LL * G) : 0;
  const long long tail = pixels - tiles * 32 * G;
  // enough blocks for a warp a tile and a thread a tail pixel, at most a
  // full wave
  const long long by_tiles = (tiles + kWarps - 1) / kWarps;
  const long long by_tail = (tail + kThreads - 1) / kThreads;
  long long blocks = by_tiles > by_tail ? by_tiles : by_tail;
  const long long wave = (long long)sm_count() * Gr::kPerSm;
  if (wave > 0 && blocks > wave) blocks = wave;
  return (int)launch_pdl(gray<TIn, TOut, C>, dim3((unsigned)blocks), dim3(kThreads), 0, s,
                         static_cast<const TIn*>(in), static_cast<TOut*>(out), pixels, tiles);
}

template <typename TIn, typename TOut>
int launch_c(const void* in, void* out, long long pixels, int C, cudaStream_t s) {
  return C == 3 ? launch<TIn, TOut, 3>(in, out, pixels, s)
                : launch<TIn, TOut, 4>(in, out, pixels, s);
}

}  // namespace

// in: [pixels, C] (uint8 if in_u8 else f32), the batch flattened; out: the
// same shape (uint8 with the epilogue if out_u8, else f32). Returns the
// launch's CUDA error code.
extern "C" int itpu_gray(const void* in, int in_u8, void* out, int out_u8,
                         long long pixels, int C, void* stream) {
  if (C != 3 && C != 4) return (int)cudaErrorInvalidValue;
  if (pixels <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8) return launch_c<uint8_t, uint8_t>(in, out, pixels, C, s);
  if (in_u8) return launch_c<uint8_t, float>(in, out, pixels, C, s);
  if (out_u8) return launch_c<float, uint8_t>(in, out, pixels, C, s);
  return launch_c<float, float>(in, out, pixels, C, s);
}
