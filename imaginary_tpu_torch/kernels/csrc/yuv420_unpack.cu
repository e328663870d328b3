// K2: packed YUV 4:2:0 planes (uint8) -> RGB (f32).
//
// Replaces: imaginary_tpu/ops/stages.py:344-423 (`FromYuv420Spec.apply`
// with `_yuv420_to_rgb`, `_chroma_up_indices` and `_ycc_to_rgb`) plus the
// uint8 -> f32 cast that opens every chain (imaginary_tpu/ops/chain.py:113).
//
// Bound on the H100: memory. Per output pixel it reads 1.5 bytes of planes
// and writes 12 bytes of f32 RGB, for ~30 FLOPs: at [B,480,512,1] ->
// [B,320,512,3] the write dominates (1.97 MB per image).
//
// Design: one thread per output pixel. The packed bytes are read directly
// (the cast is fused; no f32 copy of the planes ever exists). Each thread
// recomputes its centred 2x chroma taps (1/4-3/4, libjpeg's fancy
// upsampling) for its row and column, clamps them to the valid chroma
// extent exactly as `_chroma_up_indices` does, blends rows first and then
// columns (the reference's order), and applies the BT.601 full-range
// transform and clip. Neighbouring threads share chroma samples through L1,
// so each plane byte comes from device memory about once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// (i0, i1, t) of `_chroma_up_indices` for luma position r.
__device__ __forceinline__ void up_taps(int r, int cn, int chroma_b, int* i0,
                                        int* i1, float* t) {
  const float pos = (float)r * 0.5f - 0.25f;
  const float i0f = floorf(pos);
  *t = pos - i0f;
  const int hi = max(cn - 1, 0);
  const int base = (int)i0f;
  *i0 = min(max(base, 0), hi);
  *i1 = min(min(max(base + 1, 0), hi), chroma_b - 1);
}

__device__ __forceinline__ float up2(const uint8_t* plane, int stride, int i0,
                                     int i1, float t, int j0, int j1, float s) {
  const float a0 = (float)plane[i0 * stride + j0] * (1.0f - t) +
                   (float)plane[i1 * stride + j0] * t;
  const float a1 = (float)plane[i0 * stride + j1] * (1.0f - t) +
                   (float)plane[i1 * stride + j1] * t;
  return a0 * (1.0f - s) + a1 * s;
}

__global__ void yuv420_to_rgb(const uint8_t* __restrict__ in,
                              float* __restrict__ out,
                              const int32_t* __restrict__ h,
                              const int32_t* __restrict__ w, int B, int hb,
                              int wb) {
  const size_t n = (size_t)B * hb * wb;
  const size_t stride_grid = (size_t)gridDim.x * blockDim.x;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride_grid) {
    const int x = (int)(p % wb);
    const int r = (int)((p / wb) % hb);
    const int b = (int)(p / ((size_t)wb * hb));
    const uint8_t* img = in + (size_t)b * (hb + hb / 2) * wb;
    const int ch = (h[b] + 1) / 2;
    const int cw = (w[b] + 1) / 2;
    int i0, i1, j0, j1;
    float t, s;
    up_taps(r, ch, hb / 2, &i0, &i1, &t);
    up_taps(x, cw, wb / 2, &j0, &j1, &s);
    const uint8_t* uplane = img + (size_t)hb * wb;
    const uint8_t* vplane = uplane + wb / 2;
    const float y = (float)img[(size_t)r * wb + x];
    const float uu = up2(uplane, wb, i0, i1, t, j0, j1, s) - 128.0f;
    const float vv = up2(vplane, wb, i0, i1, t, j0, j1, s) - 128.0f;
    const float rr = y + 1.402f * vv;
    const float gg = y - 0.344136f * uu - 0.714136f * vv;
    const float bb = y + 1.772f * uu;
    float* o = out + p * 3;
    o[0] = fminf(fmaxf(rr, 0.0f), 255.0f);
    o[1] = fminf(fmaxf(gg, 0.0f), 255.0f);
    o[2] = fminf(fmaxf(bb, 0.0f), 255.0f);
  }
}

}  // namespace

// in: uint8 [B, hb + hb/2, wb] packed planes; out: f32 [B, hb, wb, 3];
// h, w: int32 [B] valid luma dims. Returns the launch's CUDA error code.
extern "C" int itpu_yuv420_to_rgb(const uint8_t* in, float* out,
                                  const int32_t* h, const int32_t* w, int B,
                                  int hb, int wb, void* stream) {
  const size_t n = (size_t)B * hb * wb;
  if (n == 0) return 0;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535u * 32u) blocks = 65535u * 32u;
  yuv420_to_rgb<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in, out, h, w, B, hb,
                                                       wb);
  return (int)cudaGetLastError();
}
