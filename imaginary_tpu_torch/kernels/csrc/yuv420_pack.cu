// K3: RGB (f32) -> packed YUV 4:2:0 planes (uint8), epilogue fused.
//
// Replaces: imaginary_tpu/ops/stages.py:521-552 (`ToYuv420Spec.apply`) and
// the uint8 epilogue of `_run_chain` (imaginary_tpu/ops/chain.py:112-124,
// clip(x + 0.5, 0, 255) -> uint8).
//
// Bound on the H100: memory. It reads 12 bytes of f32 RGB per pixel and
// writes 1.5 bytes; at [B,208,304,3] -> [B,312,304,1] that is 0.76 MB read
// and 0.09 MB written per image, for ~20 FLOPs per pixel.
//
// Design: one thread per 2x2 block. It reads its four RGB pixels once,
// writes four Y bytes (Y is computed for every pixel, bucket padding
// included, as the reference does) and one U and one V byte, each pooled
// over the valid pixels of the block only (128 where none is valid). The
// f32 planes the reference materialises before its epilogue never exist:
// the clip(x + 0.5) and the truncating cast happen in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t to_u8(float v) {
  // clip then truncate == jnp .astype(uint8) after the clip
  return (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

__global__ void rgb_to_yuv420(const float* __restrict__ in,
                              uint8_t* __restrict__ out,
                              const int32_t* __restrict__ h,
                              const int32_t* __restrict__ w, int B, int hb,
                              int wb) {
  const int hc = hb / 2, wc = wb / 2;
  const size_t n = (size_t)B * hc * wc;
  const size_t stride_grid = (size_t)gridDim.x * blockDim.x;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride_grid) {
    const int j = (int)(p % wc);
    const int i = (int)((p / wc) % hc);
    const int b = (int)(p / ((size_t)wc * hc));
    const float* img = in + (size_t)b * hb * wb * 3;
    uint8_t* o = out + (size_t)b * (hb + hc) * wb;
    const int hv = h[b], wv = w[b];
    float scb = 0.0f, scr = 0.0f, cnt = 0.0f;
    for (int dy = 0; dy < 2; dy++) {
      for (int dx = 0; dx < 2; dx++) {
        const int r = 2 * i + dy, c = 2 * j + dx;
        const float* px = img + ((size_t)r * wb + c) * 3;
        const float R = fminf(fmaxf(px[0], 0.0f), 255.0f);
        const float G = fminf(fmaxf(px[1], 0.0f), 255.0f);
        const float Bl = fminf(fmaxf(px[2], 0.0f), 255.0f);
        const float y = 0.299f * R + 0.587f * G + 0.114f * Bl;
        o[(size_t)r * wb + c] = to_u8(y);
        const float m = (r < hv && c < wv) ? 1.0f : 0.0f;
        const float cb = -0.168736f * R - 0.331264f * G + 0.5f * Bl + 128.0f;
        const float cr = 0.5f * R - 0.418688f * G - 0.081312f * Bl + 128.0f;
        scb += cb * m;
        scr += cr * m;
        cnt += m;
      }
    }
    const float u = cnt > 0.0f ? scb / fmaxf(cnt, 1.0f) : 128.0f;
    const float v = cnt > 0.0f ? scr / fmaxf(cnt, 1.0f) : 128.0f;
    uint8_t* crow = o + (size_t)(hb + i) * wb;
    crow[j] = to_u8(u);
    crow[wc + j] = to_u8(v);
  }
}

}  // namespace

// in: f32 [B, hb, wb, 3]; out: uint8 [B, hb + hb/2, wb] packed planes;
// h, w: int32 [B] valid dims. Returns the launch's CUDA error code.
extern "C" int itpu_rgb_to_yuv420(const float* in, uint8_t* out,
                                  const int32_t* h, const int32_t* w, int B,
                                  int hb, int wb, void* stream) {
  const size_t n = (size_t)B * (hb / 2) * (wb / 2);
  if (n == 0) return 0;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535u * 32u) blocks = 65535u * 32u;
  rgb_to_yuv420<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in, out, h, w, B, hb,
                                                       wb);
  return (int)cudaGetLastError();
}
