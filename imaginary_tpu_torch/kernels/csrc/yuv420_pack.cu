// K3: RGB (f32) -> packed YUV 4:2:0 planes (uint8), epilogue fused; with
// `luma`, K8's luma applied to each pixel first (K8 + K3 in one launch).
//
// Replaces: imaginary_tpu/ops/stages.py:521-552 (`ToYuv420Spec.apply`) and
// the uint8 epilogue of `_run_chain` (imaginary_tpu/ops/chain.py:112-124,
// clip(x + 0.5, 0, 255) -> uint8); with `luma`, also the `GraySpec.apply`
// (stages.py:625-635) right before it on a colorspace=bw chain.
//
// Bound on the H100: memory. It reads 12 bytes of f32 RGB per pixel and
// writes 1.5 bytes; at [B,208,304,3] -> [B,312,304,1] that is 0.76 MB read
// and 0.09 MB written per image, for ~20 FLOPs per pixel. At B = 1 the
// launch itself (about 2 us) outweighs both.
//
// Design: a block takes `band` row pairs (one a warp) of one image over a
// chunk of 128 columns, so that even one small image spreads over every
// SM (config 1's 208x304 gives 312 blocks). A warp loads its two rows of
// the chunk as 16-byte vectors (coalesced; all of a lane's loads issued
// before the first is used, beside the block's one read of its image's
// valid dims) into shared memory, then each lane packs four columns: two
// 2x2 blocks, written as one 4-byte Y store a row and one 2-byte store
// each of U and V. Y is computed for every pixel, bucket padding included,
// as the reference does; U and V are pooled over the valid pixels of
// their block only (128 where none is valid), with the arithmetic, sum
// order ((dy, dx)) and division of the first version of this kernel, so
// the output is bit-equal to it. A bucket whose width is not a multiple
// of 4, or an input that is not 16-byte aligned, takes the same path with
// scalar loads and byte stores. The launch is a programmatic dependent
// of the kernel before it in the stream (launch.cuh).
//
// W-shard form (the spatial route): `in` holds one shard's columns
// [col0, col0 + wb) of the image (col0 even, wb the local width) and the
// output is the shard's own packed buffer at that width, Y over wb
// columns and U and V over wb/2 each; only the valid mask reads col0, so
// every 2x2 block pools exactly as in the whole image (one past the valid
// width pools to 128) and the host places the shard's planes at their
// global columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kChunk = 128;  // columns of a block, four a lane
constexpr int kRowFloats = kChunk * 3;
constexpr int kMaxBand = 8;  // row pairs of a block, one a warp

__device__ __forceinline__ uint8_t to_u8(float v) {
  // clip then truncate == jnp .astype(uint8) after the clip
  return (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// The clamped RGB of one pixel; with LUMA, K8's luma (gray.cu, in its
// rounding order) on all three channels, as K8's f32 output holds it.
template <bool LUMA>
__device__ __forceinline__ void rgb_at(const float* px, float& R, float& G, float& Bl) {
  float r = px[0], g = px[1], b = px[2];
  if (LUMA) {
    const float lum = __fadd_rn(__fadd_rn(__fmul_rn(0.2126f, r), __fmul_rn(0.7152f, g)),
                                __fmul_rn(0.0722f, b));
    r = g = b = lum;
  }
  R = fminf(fmaxf(r, 0.0f), 255.0f);
  G = fminf(fmaxf(g, 0.0f), 255.0f);
  Bl = fminf(fmaxf(b, 0.0f), 255.0f);
}

// The 2x2 block whose top-left pixel is (r, c): its four Y bytes, and U
// and V pooled over its valid pixels. top and bot point at the block's
// first pixel in its two rows.
template <bool LUMA>
__device__ __forceinline__ void pack_block(const float* top, const float* bot, int r, int c,
                                           int hv, int wv, uint8_t (&y)[2][2], uint8_t& u,
                                           uint8_t& v) {
  float scb = 0.0f, scr = 0.0f, cnt = 0.0f;
  for (int dy = 0; dy < 2; dy++) {
    for (int dx = 0; dx < 2; dx++) {
      float R, G, Bl;
      rgb_at<LUMA>((dy ? bot : top) + 3 * dx, R, G, Bl);
      const float yv = 0.299f * R + 0.587f * G + 0.114f * Bl;
      y[dy][dx] = to_u8(yv);
      const float m = (r + dy < hv && c + dx < wv) ? 1.0f : 0.0f;
      const float cb = -0.168736f * R - 0.331264f * G + 0.5f * Bl + 128.0f;
      const float cr = 0.5f * R - 0.418688f * G - 0.081312f * Bl + 128.0f;
      scb += cb * m;
      scr += cr * m;
      cnt += m;
    }
  }
  u = to_u8(cnt > 0.0f ? scb / fmaxf(cnt, 1.0f) : 128.0f);
  v = to_u8(cnt > 0.0f ? scr / fmaxf(cnt, 1.0f) : 128.0f);
}

// grid (chunks, ceil(hb/2 / band), B), 32 * band threads, dynamic shared
// memory band * 2 rows of kRowFloats. VEC: wb % 4 == 0 and `in` 16-byte
// aligned (so every row of a chunk starts on a 16-byte boundary and every
// store below is aligned).
template <bool LUMA, bool VEC>
__global__ void __launch_bounds__(32 * kMaxBand)
    rgb_to_yuv420(const float* __restrict__ in, uint8_t* __restrict__ out,
                  const int32_t* __restrict__ h, const int32_t* __restrict__ w, int hb,
                  int wb, int col0, int band) {
  extern __shared__ float4 smem[];
  __shared__ int dims[2];
  // a lane's share of its warp's two chunk rows: at most 3 float4 (or 12
  // floats) a row, all loaded before any is used
  constexpr int kPer = VEC ? 3 : 12;
  using Elem = typename std::conditional<VEC, float4, float>::type;
  await_previous_kernel();
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hc = hb >> 1;
  const int i = blockIdx.y * band + warp;  // this warp's row pair
  const int c0 = blockIdx.x * kChunk;
  const int cols = min(kChunk, wb - c0);
  const int n = VEC ? cols * 3 / 4 : cols * 3;  // Elems in a chunk row
  if (threadIdx.x == 0) {
    dims[0] = h[b];
    dims[1] = w[b];
  }
  Elem r[2][kPer];
  if (i < hc) {
    const Elem* src = reinterpret_cast<const Elem*>(in + (((size_t)b * hb + 2 * i) * wb + c0) * 3);
    const size_t row = VEC ? (size_t)wb * 3 / 4 : (size_t)wb * 3;
#pragma unroll
    for (int dy = 0; dy < 2; dy++)
#pragma unroll
      for (int k = 0; k < kPer; k++)
        if (lane + 32 * k < n) r[dy][k] = __ldg(src + dy * row + lane + 32 * k);
  }
  __syncthreads();  // dims
  const int hv = dims[0], wv = dims[1];
  if (i >= hc) return;
  float* rows = reinterpret_cast<float*>(smem) + (size_t)warp * 2 * kRowFloats;
#pragma unroll
  for (int dy = 0; dy < 2; dy++)
#pragma unroll
    for (int k = 0; k < kPer; k++)
      if (lane + 32 * k < n)
        reinterpret_cast<Elem*>(rows + dy * kRowFloats)[lane + 32 * k] = r[dy][k];
  __syncwarp();
  const int cl = 4 * lane;  // this lane's first column in the chunk
  if (cl >= cols) return;
  // the lane's four pixels of each row, as three 16-byte reads (a quarter
  // warp's reads fall in distinct banks); past `cols` they are not used
  float px[2][12];
  for (int dy = 0; dy < 2; dy++) {
    const float4* r4 = reinterpret_cast<const float4*>(rows + dy * kRowFloats + cl * 3);
    for (int k = 0; k < 3; k++) {
      const float4 t = r4[k];
      px[dy][4 * k] = t.x;
      px[dy][4 * k + 1] = t.y;
      px[dy][4 * k + 2] = t.z;
      px[dy][4 * k + 3] = t.w;
    }
  }
  uint8_t y[2][4], u[2], v[2];
  const int nblk = (VEC || cl + 2 < cols) ? 2 : 1;  // cols is even
#pragma unroll
  for (int k = 0; k < 2; k++) {
    if (k < nblk) {
      uint8_t yb[2][2];
      pack_block<LUMA>(px[0] + 6 * k, px[1] + 6 * k, 2 * i, col0 + c0 + cl + 2 * k, hv, wv,
                       yb, u[k], v[k]);
      y[0][2 * k] = yb[0][0];
      y[0][2 * k + 1] = yb[0][1];
      y[1][2 * k] = yb[1][0];
      y[1][2 * k + 1] = yb[1][1];
    }
  }
  uint8_t* o = out + (size_t)b * (hb + hc) * wb;
  uint8_t* crow = o + (size_t)(hb + i) * wb;
  const int c = c0 + cl;
  if (VEC) {
    for (int dy = 0; dy < 2; dy++)
      *reinterpret_cast<uchar4*>(o + (size_t)(2 * i + dy) * wb + c) =
          make_uchar4(y[dy][0], y[dy][1], y[dy][2], y[dy][3]);
    *reinterpret_cast<uchar2*>(crow + c / 2) = make_uchar2(u[0], u[1]);
    *reinterpret_cast<uchar2*>(crow + wb / 2 + c / 2) = make_uchar2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 2; k++) {
      if (k < nblk) {
        for (int dy = 0; dy < 2; dy++) {
          o[(size_t)(2 * i + dy) * wb + c + 2 * k] = y[dy][2 * k];
          o[(size_t)(2 * i + dy) * wb + c + 2 * k + 1] = y[dy][2 * k + 1];
        }
        crow[c / 2 + k] = u[k];
        crow[wb / 2 + c / 2 + k] = v[k];
      }
    }
  }
}

template <bool LUMA>
cudaError_t launch(bool vec, dim3 grid, int band, cudaStream_t s, const float* in,
                   uint8_t* out, const int32_t* h, const int32_t* w, int hb, int wb,
                   int col0) {
  const size_t smem = (size_t)band * 2 * kRowFloats * sizeof(float);
  if (vec)
    return launch_pdl(rgb_to_yuv420<LUMA, true>, grid, dim3(32 * band), smem, s, in, out, h,
                      w, hb, wb, col0, band);
  return launch_pdl(rgb_to_yuv420<LUMA, false>, grid, dim3(32 * band), smem, s, in, out, h, w,
                    hb, wb, col0, band);
}

}  // namespace

// in: f32 [B, hb, wb, 3]; out: uint8 [B, hb + hb/2, wb] packed planes;
// h, w: int32 [B] valid dims; luma: apply K8's luma to each pixel first;
// col0: the global column of `in`'s first (a W-shard's, even; 0 for a
// whole image). hb and wb even. Returns the launch's CUDA error code.
extern "C" int itpu_rgb_to_yuv420(const float* in, uint8_t* out, const int32_t* h,
                                  const int32_t* w, int B, int hb, int wb, int luma,
                                  int col0, void* stream) {
  const int hc = hb / 2;
  if (B <= 0 || hc <= 0 || wb <= 0) return 0;
  if (hb % 2 || wb % 2 || col0 % 2 || col0 < 0) return (int)cudaErrorInvalidValue;
  const bool vec = wb % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int chunks = (wb + kChunk - 1) / kChunk;
  // the tallest band that still gives every SM two blocks
  const long long want = 2LL * sm_count();
  int band = 1;
  for (int g = kMaxBand; g > 1; g >>= 1) {
    if ((long long)B * ((hc + g - 1) / g) * chunks >= want) {
      band = g;
      break;
    }
  }
  const dim3 grid(chunks, (hc + band - 1) / band, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = luma ? launch<true>(vec, grid, band, s, in, out, h, w, hb, wb, col0)
                             : launch<false>(vec, grid, band, s, in, out, h, w, hb, wb, col0);
  return (int)e;
}
