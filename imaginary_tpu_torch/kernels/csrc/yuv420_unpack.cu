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
// Design: one block per output row of one image. The packed bytes are
// read directly (the cast is fused; no f32 copy of the planes ever
// exists). The block works out the row's centred 2x chroma taps (i0, i1,
// t) (1/4-3/4, libjpeg's fancy upsampling, clamped to the valid chroma
// rows exactly as `_chroma_up_indices` does) once, then blends the two
// chroma rows of both planes once per chroma column into shared memory,
// P[i0, j] * (1 - t) + P[i1, j] * t. Each thread then makes 4 consecutive
// pixels: one 4-byte luma load, the four shared chroma columns of its
// group per plane (the taps from the pixel index by shifts, no division),
// the column blend, BT.601 full range and the clip. A warp's 48-byte
// groups go out through a per-warp shared slot as 16-byte stores of
// contiguous 512-byte runs, streamed past L2 (the 12-byte f32 pixels are
// what bound the kernel). The expressions are those of the per-pixel
// design (rows first, then columns), so the output is the same bit for
// bit. A row whose output or luma start is not 16- or 4-byte aligned
// (possible where wb % 4 == 2) makes its first two pixels and its last
// ragged ones one at a time, and reads luma a byte at a time where the
// 4-byte load would be unaligned.
//
// W-shard form (the spatial route, SHARD = true): the input is one
// shard's own packed buffer at its local width lw (its Y columns
// [col0, col0 + lw), col0 even, and lw/2 chroma columns of U and of V),
// with a one-column chroma halo on each side in `left` and `right`
// ([B, hb/2, 2]: U then V a row). The host fills every chroma column of
// the shard and its halos by the clamped index the whole image's pixels
// read, so the shard's window column k (0 the left halo) holds chroma
// column clamp(col0/2 - 1 + k, 0, hi) and pixel x reads window columns
// ((x - 1) >> 1) + 1 and the one after, unclamped: the same bytes, the
// same expressions, so the shard equals the whole image's columns bit for
// bit, bucket padding included, even where the clamp reaches past the
// shard.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlot = 96;  // float4s of a warp's staged output: 32 x 48 bytes

// The clamped chroma index of `_chroma_up_indices`: into [0, hi].
__device__ __forceinline__ int clampc(int j, int hi) { return min(max(j, 0), hi); }

// One chroma column blended over the row's two chroma rows.
__device__ __forceinline__ float blend(uint8_t p0, uint8_t p1, float t) {
  return (float)p0 * (1.0f - t) + (float)p1 * t;
}

// BT.601 full range and the clip of one pixel, from its luma and the
// column blend of the row-blended chroma (rows first, then columns:
// `_yuv420_to_rgb`'s order and expressions).
__device__ __forceinline__ void ycc(float y, float u0, float u1, float v0,
                                    float v1, float s, float* o) {
  const float uu = (u0 * (1.0f - s) + u1 * s) - 128.0f;
  const float vv = (v0 * (1.0f - s) + v1 * s) - 128.0f;
  const float rr = y + 1.402f * vv;
  const float gg = y - 0.344136f * uu - 0.714136f * vv;
  const float bb = y + 1.772f * uu;
  o[0] = fminf(fmaxf(rr, 0.0f), 255.0f);
  o[1] = fminf(fmaxf(gg, 0.0f), 255.0f);
  o[2] = fminf(fmaxf(bb, 0.0f), 255.0f);
}

// Pixel x's column taps: floor(x / 2 - 1/4) is (x - 1) >> 1, and s is
// 3/4 at even x and 1/4 at odd x; jofs is 1 on a W-shard, whose shared
// columns start at its left halo.
__device__ __forceinline__ void pixel(float y, const float* ru, const float* rv,
                                      int x, int jofs, int hi, float* o) {
  const int j0 = clampc(((x - 1) >> 1) + jofs, hi);
  const int j1 = clampc(((x - 1) >> 1) + jofs + 1, hi);
  ycc(y, ru[j0], ru[j1], rv[j0], rv[j1], (x & 1) ? 0.25f : 0.75f, o);
}

// grid: x = hb, y = B; block: kThreads; shared: wb floats (wb + 4 on a
// W-shard, whose wb is its local width).
template <bool SHARD>
__global__ void __launch_bounds__(kThreads)
    yuv420_to_rgb(const uint8_t* __restrict__ in, const uint8_t* __restrict__ left,
                  const uint8_t* __restrict__ right, float* __restrict__ out,
                  const int32_t* __restrict__ h, const int32_t* __restrict__ w,
                  int hb, int wb) {
  extern __shared__ float rb[];  // U then V, ncs columns each
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int cwb = wb / 2;
  const int ncs = SHARD ? cwb + 2 : cwb;
  const int jofs = SHARD ? 1 : 0;
  const uint8_t* img = in + (size_t)b * (hb + hb / 2) * wb;
  const uint8_t* uplane = img + (size_t)hb * wb;
  const uint8_t* vplane = uplane + cwb;

  // the row's taps: floor(r / 2 - 1/4) is (r - 1) >> 1, t 3/4 or 1/4; the
  // clamps keep every index inside the chroma buffer (a shard's columns
  // were clamped on the host: all ncs of them are read)
  const int chi = min(max((h[b] + 1) / 2 - 1, 0), hb / 2 - 1);
  const int hi = SHARD ? ncs - 1 : min(max((w[b] + 1) / 2 - 1, 0), cwb - 1);
  const int ibase = (r - 1) >> 1;
  const int i0 = clampc(ibase, chi);
  const int i1 = clampc(ibase + 1, chi);
  const float t = (r & 1) ? 0.25f : 0.75f;
  float* ru = rb;
  float* rv = rb + ncs;
  const uint8_t* u0 = uplane + (size_t)i0 * wb;
  const uint8_t* u1 = uplane + (size_t)i1 * wb;
  const uint8_t* v0 = vplane + (size_t)i0 * wb;
  const uint8_t* v1 = vplane + (size_t)i1 * wb;
  const int ncol = hi + 1;  // the chroma columns any pixel reads
  if (SHARD) {
    // window column 0 is the left halo, ncol - 1 the right one
    const size_t hrow = (size_t)b * (hb / 2);
    const uint8_t* l0 = left + (hrow + i0) * 2;
    const uint8_t* l1 = left + (hrow + i1) * 2;
    const uint8_t* r0 = right + (hrow + i0) * 2;
    const uint8_t* r1 = right + (hrow + i1) * 2;
    for (int j = threadIdx.x; j < ncol; j += kThreads) {
      if (j == 0) {
        ru[j] = blend(l0[0], l1[0], t);
        rv[j] = blend(l0[1], l1[1], t);
      } else if (j == ncol - 1) {
        ru[j] = blend(r0[0], r1[0], t);
        rv[j] = blend(r0[1], r1[1], t);
      } else {
        ru[j] = blend(u0[j - 1], u1[j - 1], t);
        rv[j] = blend(v0[j - 1], v1[j - 1], t);
      }
    }
  } else {
    for (int j = threadIdx.x; j < ncol; j += kThreads) {
      ru[j] = blend(u0[j], u1[j], t);
      rv[j] = blend(v0[j], v1[j], t);
    }
  }
  __syncthreads();

  const uint8_t* luma = img + (size_t)r * wb;
  float* orow = out + ((size_t)b * hb + r) * wb * 3;
  // pixels [head, head + 4 * groups) go four at a time: the output of
  // pixel head must start on 16 bytes (12 * x is, for x a multiple of 4)
  const size_t opix = ((size_t)b * hb + r) * wb;
  const int head = (int)((4 - (opix & 3)) & 3);  // 0 or 2: wb is even
  const int groups = (wb - head) / 4;
  const bool luma4 = ((((size_t)luma + head) & 3) == 0);
  // a warp makes 32 groups (128 pixels, 1536 bytes) at a time, stages
  // them in its own shared slots and stores them as 16-byte vectors, lane
  // i the i-th of each 512 contiguous bytes; the output is streamed
  // (evict-first): nothing reads it back from L2
  __shared__ float4 stage[kThreads / 32][kSlot];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* slot = stage[warp];
  for (int g0 = warp * 32; g0 < groups; g0 += kThreads) {
    const int g = g0 + lane;
    if (g < groups) {
      const int x = head + 4 * g;
      float ys[4];
      if (luma4) {
        const uchar4 q = *reinterpret_cast<const uchar4*>(luma + x);
        ys[0] = q.x; ys[1] = q.y; ys[2] = q.z; ys[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) ys[k] = luma[x + k];
      }
      // x is even: pixels x .. x + 3 blend chroma columns (x - 2) / 2 + m,
      // m = (0, 1), (1, 2), (1, 2), (2, 3), at s = 3/4, 1/4, 3/4, 1/4
      const int jb = ((x - 1) >> 1) + jofs;
      float cu[4], cv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = clampc(jb + m, hi);
        cu[m] = ru[j];
        cv[m] = rv[j];
      }
      float o[12];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = (k + 1) >> 1;
        ycc(ys[k], cu[m], cu[m + 1], cv[m], cv[m + 1], (k & 1) ? 0.25f : 0.75f,
            o + 3 * k);
      }
      slot[lane * 3 + 0] = make_float4(o[0], o[1], o[2], o[3]);
      slot[lane * 3 + 1] = make_float4(o[4], o[5], o[6], o[7]);
      slot[lane * 3 + 2] = make_float4(o[8], o[9], o[10], o[11]);
    }
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(orow + (size_t)(head + 4 * g0) * 3);
    const int nvec = 3 * min(32, groups - g0);
    for (int q = lane; q < nvec; q += 32) __stcs(dst + q, slot[q]);
    __syncwarp();
  }
  // the head and the ragged tail, one pixel a thread
  const int tail0 = head + 4 * groups;
  const int nrest = head + (wb - tail0);
  for (int k = threadIdx.x; k < nrest; k += kThreads) {
    const int x = k < head ? k : tail0 + (k - head);
    pixel((float)luma[x], ru, rv, x, jofs, hi, orow + (size_t)x * 3);
  }
}

template <bool SHARD>
int launch(const uint8_t* in, const uint8_t* left, const uint8_t* right, float* out,
           const int32_t* h, const int32_t* w, int B, int hb, int wb, void* stream) {
  if (hb % 2 || wb % 2 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((size_t)B * hb * wb == 0) return 0;
  // dynamic: the blended chroma rows; static: the warps' output slots
  const size_t smem = sizeof(float) * (size_t)(SHARD ? wb + 4 : wb);
  const size_t stage = sizeof(float4) * (kThreads / 32) * kSlot;
  if (smem + stage > 48 * 1024) {  // buckets over 9216 wide
    const cudaError_t e = cudaFuncSetAttribute(
        yuv420_to_rgb<SHARD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  yuv420_to_rgb<SHARD><<<dim3(hb, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, left, right, out, h, w, hb, wb);
  return (int)cudaGetLastError();
}

}  // namespace

// in: uint8 [B, hb + hb/2, wb] packed planes; out: f32 [B, hb, wb, 3];
// h, w: int32 [B] valid luma dims; hb and wb even. With `left` and `right`
// (uint8 [B, hb/2, 2] each) `in` is one W-shard's packed buffer at its
// local width wb and they are its chroma halos (the W-shard form above);
// both null for a whole image. Returns the launch's CUDA error code.
extern "C" int itpu_yuv420_to_rgb(const uint8_t* in, const uint8_t* left,
                                  const uint8_t* right, float* out, const int32_t* h,
                                  const int32_t* w, int B, int hb, int wb, void* stream) {
  if ((left == nullptr) != (right == nullptr)) return (int)cudaErrorInvalidValue;
  if (left != nullptr) return launch<true>(in, left, right, out, h, w, B, hb, wb, stream);
  return launch<false>(in, left, right, out, h, w, B, hb, wb, stream);
}
