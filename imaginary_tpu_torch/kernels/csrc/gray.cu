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
// Bound on the H100: memory; five flops a pixel. At config 3's f32
// [1, 736, 1280, 3] it reads and writes 11.3 MB each: 6.7 us at 3.35 TB/s.
//
// Design: one thread per pixel, a grid-stride loop over the flattened
// batch; a warp's C-strided reads and writes fall in a few contiguous
// 128-byte segments. uint8 input (the chain's first stage) is cast on
// load, and a uint8 output applies the chain's clip(x + 0.5) epilogue on
// store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

template <typename TIn, typename TOut>
__global__ void gray(const TIn* __restrict__ in, TOut* __restrict__ out,
                     long long pixels, int C) {
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < pixels; p += (long long)gridDim.x * blockDim.x) {
    const TIn* src = in + p * C;
    TOut* dst = out + p * C;
    const float lum = __fadd_rn(
        __fadd_rn(__fmul_rn(0.2126f, load(src)), __fmul_rn(0.7152f, load(src + 1))),
        __fmul_rn(0.0722f, load(src + 2)));
    store(dst, lum);
    store(dst + 1, lum);
    store(dst + 2, lum);
    if (C == 4) store(dst + 3, load(src + 3));
  }
}

template <typename TIn, typename TOut>
int launch(const void* in, void* out, long long pixels, int C, cudaStream_t s) {
  const long long want = (pixels + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  gray<TIn, TOut><<<blocks, kThreads, 0, s>>>(static_cast<const TIn*>(in),
                                              static_cast<TOut*>(out), pixels, C);
  return (int)cudaGetLastError();
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
  if (in_u8 && out_u8) return launch<uint8_t, uint8_t>(in, out, pixels, C, s);
  if (in_u8) return launch<uint8_t, float>(in, out, pixels, C, s);
  if (out_u8) return launch<float, uint8_t>(in, out, pixels, C, s);
  return launch<float, float>(in, out, pixels, C, s);
}
