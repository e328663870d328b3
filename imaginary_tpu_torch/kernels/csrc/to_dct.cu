// K12: RGB -> quantized JPEG coefficients (forward DCT egress).
//
// Replaces: imaginary_tpu/ops/stages.py:555-622 (`ToDctSpec.apply`) and
// the int16 drain that ends such a chain (imaginary_tpu/ops/chain.py:116-120:
// round half to even, clamp to int16).
//
// Bound on the H100: memory. At a 1088x1920 output it reads 12 bytes of f32
// RGB and writes 3 bytes of int16 coefficients a pixel (1.5 samples of 2
// bytes); the 8x8 forward DCT is 16 multiply-adds a sample, separable.
// Design: one launch, one thread block per 16x16 MCU of one image. Each of
// its 256 threads loads one pixel with clamped indices (valid pixels
// replicate outward over the bucket padding, as the reference's gathers
// do), clips it to 0-255 and converts it to Y, Cb, Cr with the reference's
// constants and operation order (no contraction). Chroma is the plain
// mean of each full 2x2 block after replication (not masked, unlike K3's
// pool). The four Y blocks and the two chroma blocks then go through the
// separable FDCT in IEEE f32 with the basis of `_idct_basis(8)` computed
// with cosf, are divided by the image's qy / qc step (__fdiv_rn, not a
// multiply by the reciprocal), rounded with rintf (half to even, as
// jnp.round) and clamped to int16, into the yuv420-shaped packing: Y
// above, U | V side by side below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979f;

// stages.py:_idct_basis(8)[u, x] in f32 (its sqrt(8/8) factor is 1).
__device__ __forceinline__ float basis8(int u, int x) {
  const float beta = u == 0 ? sqrtf(__fdiv_rn(1.0f, 8.0f))
                            : sqrtf(__fdiv_rn(2.0f, 8.0f));
  const float arg = __fdiv_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(2.0f, (float)x), 1.0f),
                          (float)u),
                kPi),
      16.0f);
  return __fmul_rn(__fmul_rn(beta, cosf(arg)), sqrtf(__fdiv_rn(8.0f, 8.0f)));
}

__global__ void to_dct(const float* __restrict__ in, int16_t* __restrict__ out,
                       const int32_t* __restrict__ h,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ qy,
                       const float* __restrict__ qc, int hb, int wb) {
  // six 8x8 planes: Y blocks (0,0) (0,1) (1,0) (1,1), then Cb, Cr
  __shared__ float blk[6][8][8];
  __shared__ float tmp[6][8][8];
  __shared__ float cb[16][16], cr[16][16];
  __shared__ float bs[8][8];
  const int b = blockIdx.z, my = blockIdx.y, mx = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  if (tid < 64) bs[tid >> 3][tid & 7] = basis8(tid >> 3, tid & 7);
  const int iy = min(my * 16 + ty, max(h[b] - 1, 0));
  const int ix = min(mx * 16 + tx, max(w[b] - 1, 0));
  const float* p = in + (((size_t)b * hb + iy) * wb + ix) * 3;
  const float r = fminf(fmaxf(p[0], 0.0f), 255.0f);
  const float g = fminf(fmaxf(p[1], 0.0f), 255.0f);
  const float bl = fminf(fmaxf(p[2], 0.0f), 255.0f);
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                            __fmul_rn(0.114f, bl));
  cb[ty][tx] = __fadd_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(-0.168736f, r), __fmul_rn(0.331264f, g)),
                __fmul_rn(0.5f, bl)),
      128.0f);
  cr[ty][tx] = __fadd_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.418688f, g)),
                __fmul_rn(0.081312f, bl)),
      128.0f);
  blk[(ty >> 3) * 2 + (tx >> 3)][ty & 7][tx & 7] = __fsub_rn(y, 128.0f);
  __syncthreads();
  if (tid < 128) {
    const int c = tid >> 6, i = (tid >> 3) & 7, j = tid & 7;
    float (*pl)[16] = c == 0 ? cb : cr;
    const float s = __fadd_rn(__fadd_rn(__fadd_rn(pl[2 * i][2 * j],
                                                  pl[2 * i][2 * j + 1]),
                                        pl[2 * i + 1][2 * j]),
                              pl[2 * i + 1][2 * j + 1]);
    blk[4 + c][i][j] = __fsub_rn(__fdiv_rn(s, 4.0f), 128.0f);
  }
  __syncthreads();
  // rows: tmp[k][x][v] = sum_z blk[k][x][z] * bs[v][z]
  for (int e = tid; e < 384; e += blockDim.x) {
    const int k = e >> 6, x = (e >> 3) & 7, v = e & 7;
    float acc = 0.0f;
    for (int z = 0; z < 8; ++z)
      acc = __fadd_rn(acc, __fmul_rn(blk[k][x][z], bs[v][z]));
    tmp[k][x][v] = acc;
  }
  __syncthreads();
  // columns: coef[k][u][v] = sum_x bs[u][x] * tmp[k][x][v]; quantize
  for (int e = tid; e < 384; e += blockDim.x) {
    const int k = e >> 6, u = (e >> 3) & 7, v = e & 7;
    float acc = 0.0f;
    for (int x = 0; x < 8; ++x)
      acc = __fadd_rn(acc, __fmul_rn(bs[u][x], tmp[k][x][v]));
    const float q = (k < 4 ? qy : qc)[(size_t)b * 64 + u * 8 + v];
    const float vq = fminf(fmaxf(rintf(__fdiv_rn(acc, q)), -32768.0f), 32767.0f);
    int row, col;
    if (k < 4) {
      row = my * 16 + (k >> 1) * 8 + u;
      col = mx * 16 + (k & 1) * 8 + v;
    } else {
      row = hb + my * 8 + u;
      col = (k == 5 ? wb / 2 : 0) + mx * 8 + v;
    }
    out[((size_t)b * (hb + hb / 2) + row) * wb + col] = (int16_t)vq;
  }
}

}  // namespace

// in: f32 [B, hb, wb, 3] RGB, hb and wb multiples of 16; out: int16
// [B, hb + hb/2, wb]; h, w: int32 [B] valid dims; qy, qc: f32 [B, 8, 8]
// quantization steps, natural order. One launch.
extern "C" int itpu_to_dct(const float* in, int16_t* out, const int32_t* h,
                           const int32_t* w, const float* qy, const float* qc,
                           int B, int hb, int wb, void* stream) {
  if (B == 0) return 0;
  if (hb % 16 || wb % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid(wb / 16, hb / 16, B);
  to_dct<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w,
                                                               qy, qc, hb, wb);
  return (int)cudaGetLastError();
}
