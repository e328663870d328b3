// K4: per-image index-map gather with mask fill (embed / extract / shrink).
//
// Replaces: imaginary_tpu/ops/stages.py:151-198 (`EmbedSpec.apply` with
// `_axis_indices`), :119-148 (`ExtractSpec.apply` with `_window_gather`)
// and :330-341 (`ShrinkBucketSpec.apply`).
//
// Bound on the H100: memory; it does no arithmetic beyond index math. At
// [B,192,320,3] -> [B,208,304,3] f32 it reads at most the input once and
// writes 0.76 MB per image.
//
// Design: one thread per output element; neighbouring threads write
// neighbouring addresses, and reads stay row-contiguous wherever the index
// map is (mirror and clamp maps are monotone runs). Each thread derives its
// row and column source index from the per-image offset and valid size, so
// no index vector is materialised:
//   mode 0 (window): i = clamp(pos + off, 0, in_b - 1), each index on its
//          own (not lax.dynamic_slice's whole-window clamp). Extract passes
//          off = (top, left); ShrinkBucket passes no offsets (identity).
//   mode 1 (clamp):  rel = pos - off, i = clamp(rel, 0, max(size,1) - 1)
//          (Embed with COPY / LAST and the colour fills).
//   mode 2 (mirror): rel = pos - off, i = floored rel mod 2*size folded
//          back (jnp.remainder is floored; CUDA's % truncates, hence
//          ((a % p) + p) % p).
// With a fill vector, canvas pixels outside [0, size) on either axis take
// fill[b, c]. uint8 input (the RGB transport's first stage) and a uint8
// output with the chain's clip(x + 0.5) epilogue (its last stage) are fused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// Source index along one axis; *inside reports whether pos maps onto the
// image (only meaningful for modes 1 and 2).
__device__ __forceinline__ int axis_index(int pos, int off, int size, int in_b,
                                          int mode, bool* inside) {
  if (mode == 0) {
    *inside = true;
    return min(max(pos + off, 0), in_b - 1);
  }
  const int sz = max(size, 1);
  const int rel = pos - off;
  *inside = rel >= 0 && rel < sz;
  int idx;
  if (mode == 2) {
    const int period = 2 * sz;
    const int m = ((rel % period) + period) % period;
    idx = m < sz ? m : period - 1 - m;
  } else {
    idx = min(max(rel, 0), sz - 1);
  }
  // an index past the bucket clamps, like every XLA gather
  return min(max(idx, 0), in_b - 1);
}

template <typename TIn, typename TOut>
__global__ void gather(const TIn* __restrict__ in, TOut* __restrict__ out,
                       const int32_t* __restrict__ off_y,
                       const int32_t* __restrict__ off_x,
                       const int32_t* __restrict__ size_h,
                       const int32_t* __restrict__ size_w,
                       const float* __restrict__ fill, int mode, int B,
                       int in_hb, int in_wb, int C, int out_hb, int out_wb) {
  const size_t n = (size_t)B * out_hb * out_wb * C;
  const size_t stride_grid = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride_grid) {
    const int c = (int)(e % C);
    const size_t pix = e / C;
    const int x = (int)(pix % out_wb);
    const int y = (int)((pix / out_wb) % out_hb);
    const int b = (int)(pix / ((size_t)out_wb * out_hb));
    const int oy = off_y ? off_y[b] : 0;
    const int ox = off_x ? off_x[b] : 0;
    const int sh = size_h ? size_h[b] : in_hb;
    const int sw = size_w ? size_w[b] : in_wb;
    bool in_y, in_x;
    const int iy = axis_index(y, oy, sh, in_hb, mode, &in_y);
    const int ix = axis_index(x, ox, sw, in_wb, mode, &in_x);
    float v;
    if (fill != nullptr && !(in_y && in_x)) {
      v = fill[(size_t)b * C + c];
    } else {
      v = load(in + (((size_t)b * in_hb + iy) * in_wb + ix) * C + c);
    }
    store(out + e, v);
  }
}

template <typename TIn, typename TOut>
int launch(const void* in, void* out, const int32_t* off_y,
           const int32_t* off_x, const int32_t* size_h, const int32_t* size_w,
           const float* fill, int mode, int B, int in_hb, int in_wb, int C,
           int out_hb, int out_wb, cudaStream_t stream) {
  const size_t n = (size_t)B * out_hb * out_wb * C;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535u * 32u) blocks = 65535u * 32u;
  gather<TIn, TOut><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), off_y, off_x,
      size_h, size_w, fill, mode, B, in_hb, in_wb, C, out_hb, out_wb);
  return (int)cudaGetLastError();
}

}  // namespace

// in: [B, in_hb, in_wb, C] (uint8 if in_u8 else f32); out: [B, out_hb,
// out_wb, C] (uint8 with the epilogue if out_u8 else f32). off_y/off_x,
// size_h/size_w: int32 [B] or null; fill: f32 [B, C] or null.
// Returns the launch's CUDA error code.
extern "C" int itpu_gather(const void* in, int in_u8, void* out, int out_u8,
                           const int32_t* off_y, const int32_t* off_x,
                           const int32_t* size_h, const int32_t* size_w,
                           const float* fill, int mode, int B, int in_hb,
                           int in_wb, int C, int out_hb, int out_wb,
                           void* stream) {
  if ((size_t)B * out_hb * out_wb * C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch<uint8_t, uint8_t>(in, out, off_y, off_x, size_h, size_w,
                                    fill, mode, B, in_hb, in_wb, C, out_hb,
                                    out_wb, s);
  if (in_u8)
    return launch<uint8_t, float>(in, out, off_y, off_x, size_h, size_w, fill,
                                  mode, B, in_hb, in_wb, C, out_hb, out_wb, s);
  if (out_u8)
    return launch<float, uint8_t>(in, out, off_y, off_x, size_h, size_w, fill,
                                  mode, B, in_hb, in_wb, C, out_hb, out_wb, s);
  return launch<float, float>(in, out, off_y, off_x, size_h, size_w, fill,
                              mode, B, in_hb, in_wb, C, out_hb, out_wb, s);
}
