// K7: alpha-blend an RGBA overlay block over a batch of padded images
// (text and image watermarks), tiled or placed once.
//
// Replaces: imaginary_tpu/ops/stages.py:283-327 (`CompositeSpec.apply`).
//
// Function, for x [B, Hb, Wb, C] (C = 3 or 4), the overlay f32
// [B, BHb, BWb, 4] (RGBA, 0..255) holding a (bh, bw) block per image, and
// per-image top, left, bh, bw (int32 [B]) and opacity (f32 [B]), at EVERY
// pixel of the bucket (the reference does not mask by the valid h, w, and
// a later stage may read the padding):
//   replicate: gy = (y - top) mod max(bh, 1), gx = (x - left) mod max(bw, 1)
//              with a floored remainder (y < top wraps upward, as
//              jnp.remainder does; CUDA's % truncates);
//   placed:    gy = clip(y - top, 0, BHb - 1), gx = clip(x - left, 0, BWb - 1)
//              and the canvas is 0 unless 0 <= y - top < bh and
//              0 <= x - left < bw;
//   canvas   = overlay[b, gy, gx] where gy < bh and gx < bw, else 0 (the
//              overlay masked to its own block; gather indices clamp into
//              the block bucket as XLA's gather does);
//   alpha    = canvas.a / 255 * clip(opacity, 0, 1);
//   rgb      = x.rgb * (1 - alpha) + canvas.rgb * alpha;  x.a passes through.
// The blend is written with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, ...), so nvcc does not contract it into fused multiply-adds
// and it rounds as the reference's separate multiplies and adds do.
//
// Bound on the H100: memory. Per pixel it reads C input values and at
// most four overlay values (the overlay block, 24 x 48 x 4 f32 for a text
// watermark, stays in L1/L2) and writes C values, with a dozen flops. At
// config 3's f32 [1, 736, 1280, 3] that is 11.3 MB each way: 6.7 us at
// 3.35 TB/s.
//
// Design: one thread per pixel, a block per 128 pixels of one row, so the
// C-strided reads and writes of a warp fall in a few contiguous 128-byte
// segments. uint8 input (the chain's first stage) is cast on load, and a
// uint8 output applies the chain's clip(x + 0.5) epilogue on store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

// grid: x = ceil(Wb / kThreads), y = Hb, z = B; block: kThreads.
template <typename TIn, typename TOut>
__global__ void composite(const TIn* __restrict__ in, TOut* __restrict__ out,
                          const float* __restrict__ overlay,
                          const int32_t* __restrict__ top,
                          const int32_t* __restrict__ left,
                          const float* __restrict__ opacity,
                          const int32_t* __restrict__ block_h,
                          const int32_t* __restrict__ block_w, int replicate,
                          int Hb, int Wb, int C, int BHb, int BWb) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Wb) return;
  const int bh = block_h[b];
  const int bw = block_w[b];
  int gy, gx;
  bool on;
  if (replicate) {
    gy = min(floor_mod(y - top[b], max(bh, 1)), BHb - 1);
    gx = min(floor_mod(x - left[b], max(bw, 1)), BWb - 1);
    on = true;
  } else {
    const int ry = y - top[b];
    const int rx = x - left[b];
    on = ry >= 0 && ry < bh && rx >= 0 && rx < bw;
    gy = min(max(ry, 0), BHb - 1);
    gx = min(max(rx, 0), BWb - 1);
  }
  on = on && gy < bh && gx < bw;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
  if (on) {
    const float* o = overlay + (((size_t)b * BHb + gy) * BWb + gx) * 4;
    cr = o[0];
    cg = o[1];
    cb = o[2];
    ca = o[3];
  }
  const float op = fminf(fmaxf(opacity[b], 0.0f), 1.0f);
  const float alpha = __fmul_rn(__fdiv_rn(ca, 255.0f), op);
  const float keep = __fsub_rn(1.0f, alpha);
  const size_t at = (((size_t)b * Hb + y) * Wb + x) * C;
  const TIn* src = in + at;
  TOut* dst = out + at;
  store(dst + 0, __fadd_rn(__fmul_rn(load(src + 0), keep), __fmul_rn(cr, alpha)));
  store(dst + 1, __fadd_rn(__fmul_rn(load(src + 1), keep), __fmul_rn(cg, alpha)));
  store(dst + 2, __fadd_rn(__fmul_rn(load(src + 2), keep), __fmul_rn(cb, alpha)));
  if (C == 4) store(dst + 3, load(src + 3));
}

template <typename TIn, typename TOut>
int launch(const void* in, void* out, const float* overlay,
           const int32_t* top, const int32_t* left, const float* opacity,
           const int32_t* bh, const int32_t* bw, int replicate, int B, int Hb,
           int Wb, int C, int BHb, int BWb, cudaStream_t s) {
  dim3 grid((Wb + kThreads - 1) / kThreads, Hb, B);
  composite<TIn, TOut><<<grid, kThreads, 0, s>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), overlay, top, left,
      opacity, bh, bw, replicate, Hb, Wb, C, BHb, BWb);
  return (int)cudaGetLastError();
}

}  // namespace

// in: [B, Hb, Wb, C] (uint8 if in_u8 else f32); out: the same shape
// (uint8 with the epilogue if out_u8, else f32); overlay: f32
// [B, BHb, BWb, 4]; top, left, block_h, block_w: int32 [B]; opacity: f32
// [B]; replicate: 0 placed, 1 tiled. Returns the launch's CUDA error code.
extern "C" int itpu_composite(const void* in, int in_u8, void* out,
                              int out_u8, const float* overlay,
                              const int32_t* top, const int32_t* left,
                              const float* opacity, const int32_t* block_h,
                              const int32_t* block_w, int replicate, int B,
                              int Hb, int Wb, int C, int BHb, int BWb,
                              void* stream) {
  if ((C != 3 && C != 4) || BHb < 1 || BWb < 1)
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch<uint8_t, uint8_t>(in, out, overlay, top, left, opacity,
                                    block_h, block_w, replicate, B, Hb, Wb, C,
                                    BHb, BWb, s);
  if (in_u8)
    return launch<uint8_t, float>(in, out, overlay, top, left, opacity,
                                  block_h, block_w, replicate, B, Hb, Wb, C,
                                  BHb, BWb, s);
  if (out_u8)
    return launch<float, uint8_t>(in, out, overlay, top, left, opacity,
                                  block_h, block_w, replicate, B, Hb, Wb, C,
                                  BHb, BWb, s);
  return launch<float, float>(in, out, overlay, top, left, opacity, block_h,
                              block_w, replicate, B, Hb, Wb, C, BHb, BWb, s);
}
