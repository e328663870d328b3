// K11: scaled k-point IDCT of packed JPEG coefficients, chroma upsample and
// YCbCr -> RGB.
//
// Replaces: imaginary_tpu/ops/stages.py:425-518 (`FromDctSpec.apply` with
// `_idct_basis`, and its tails `_yuv420_to_rgb`, `_yuv422_to_rgb`,
// `_ycc_to_rgb`) plus the int16 -> f32 cast that opens the chain
// (imaginary_tpu/ops/chain.py:113).
//
// Bound on the H100: memory. At 1080p 4:2:0, k = 8 it reads 2 bytes of
// int16 coefficients and writes 12 bytes of f32 RGB a pixel; the IDCT is
// 2k multiply-adds an output sample (separable), far below the card's
// f32 rate. Design: two launches.
//   pass 1 (`idct_blocks`): the input's planes are up to three regions of
//     the packed array (a row range, a column range and a channel), each
//     cut into kv x kh blocks. A thread block takes one band of kv rows and
//     128 columns of one region of one image: it casts the int16
//     coefficients into shared memory, builds the kv- and kh-point bases
//     with cosf in f32 from the reference's formula, runs the horizontal
//     then the vertical contraction in IEEE f32 (no TF32, no half types:
//     dequantized coefficients reach +-4k, stages.py:483-488) and writes
//     the block's samples + 128 into an f32 array of the input's shape.
//   pass 2 (`dct_color`): one thread per output pixel reads those planes:
//     4:2:0 at k = 8 upsamples chroma 2x both ways (K2's centred taps,
//     clamped to the valid chroma extent), 4:2:2 at k = 8 horizontally
//     only, every other layout and k has all planes at the output size;
//     then BT.601 (or gray broadcast) and the clip, with the reference's
//     operation order and no contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;  // columns of a region per IDCT block
constexpr float kPi = 3.14159265358979f;

struct Region {
  int r0, rows, c0, cols, ch, kv, kh;
};

struct Regions {
  Region r[3];
  int n;
};

// stages.py:_idct_basis(k)[u, x] in f32.
__device__ __forceinline__ float basis(int k, int u, int x) {
  const float kf = (float)k;
  const float beta = u == 0 ? sqrtf(__fdiv_rn(1.0f, kf))
                            : sqrtf(__fdiv_rn(2.0f, kf));
  const float arg = __fdiv_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(2.0f, (float)x), 1.0f),
                          (float)u),
                kPi),
      __fmul_rn(2.0f, kf));
  return __fmul_rn(__fmul_rn(beta, cosf(arg)), sqrtf(__fdiv_rn(kf, 8.0f)));
}

__global__ void idct_blocks(const int16_t* __restrict__ src,
                            float* __restrict__ dst, int R, int W, int C,
                            Regions regs) {
  __shared__ float bv[8][8], bh[8][8];
  __shared__ float coef[8][kCols];
  __shared__ float tmp[8][kCols];
  const int reg = blockIdx.z % regs.n, b = blockIdx.z / regs.n;
  // a constant index into the parameter struct keeps it out of local memory
  const Region g = reg == 0 ? regs.r[0] : reg == 1 ? regs.r[1] : regs.r[2];
  const int kv = g.kv, kh = g.kh;
  const int row0 = blockIdx.y * kv;
  const int col0 = blockIdx.x * kCols;
  if (row0 >= g.rows || col0 >= g.cols) return;
  const int ncols = min(kCols, g.cols - col0);
  const int tid = threadIdx.x;
  if (tid < 64) {
    const int u = tid >> 3, x = tid & 7;
    if (u < kv && x < kv) bv[u][x] = basis(kv, u, x);
    if (u < kh && x < kh) bh[u][x] = basis(kh, u, x);
  }
  const size_t img = (size_t)b * R * W;
  for (int i = tid; i < kv * ncols; i += blockDim.x) {
    const int u = i / ncols, j = i - u * ncols;
    const size_t p = img + (size_t)(g.r0 + row0 + u) * W + g.c0 + col0 + j;
    coef[u][j] = (float)src[p * C + g.ch];
  }
  __syncthreads();
  // horizontal: tmp[u][j] = sum_v coef[u][tile + v] * bh[v][j % kh]
  for (int i = tid; i < kv * ncols; i += blockDim.x) {
    const int u = i / ncols, j = i - u * ncols;
    const int z = j % kh, t0 = j - z;
    float acc = 0.0f;
    for (int v = 0; v < kh; ++v)
      acc = __fadd_rn(acc, __fmul_rn(coef[u][t0 + v], bh[v][z]));
    tmp[u][j] = acc;
  }
  __syncthreads();
  // vertical: out[x][j] = sum_u bv[u][x] * tmp[u][j], + 128
  for (int i = tid; i < kv * ncols; i += blockDim.x) {
    const int x = i / ncols, j = i - x * ncols;
    float acc = 0.0f;
    for (int u = 0; u < kv; ++u)
      acc = __fadd_rn(acc, __fmul_rn(bv[u][x], tmp[u][j]));
    const size_t p = img + (size_t)(g.r0 + row0 + x) * W + g.c0 + col0 + j;
    dst[p * C + g.ch] = __fadd_rn(acc, 128.0f);
  }
}

// (i0, i1, t) of `_chroma_up_indices` for luma position r (K2's taps).
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

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// mode 0: 4:2:0 at k = 8, planes [hb + hb/2, wb]; 1: 4:2:2 at k = 8,
// planes [2 hb, wb]; 2: three planes at the output size, [hb, wb, 3];
// 3: gray, [hb, wb, 1].
__global__ void dct_color(const float* __restrict__ planes,
                          float* __restrict__ out,
                          const int32_t* __restrict__ h,
                          const int32_t* __restrict__ w, int mode, int B,
                          int hb, int wb) {
  const size_t n = (size_t)B * hb * wb;
  const size_t stride_grid = (size_t)gridDim.x * blockDim.x;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride_grid) {
    const int x = (int)(p % wb);
    const int r = (int)((p / wb) % hb);
    const int b = (int)(p / ((size_t)wb * hb));
    float y, uu, vv;
    float* o = out + p * 3;
    if (mode == 3) {
      y = clip255(planes[p]);
      o[0] = y;
      o[1] = y;
      o[2] = y;
      continue;
    }
    if (mode == 2) {
      const float* q = planes + p * 3;
      y = q[0];
      uu = __fsub_rn(q[1], 128.0f);
      vv = __fsub_rn(q[2], 128.0f);
    } else {
      const int rows = mode == 0 ? hb + hb / 2 : 2 * hb;
      const float* img = planes + (size_t)b * rows * wb;
      const float* up = img + (size_t)hb * wb;
      const float* vp = up + wb / 2;
      y = img[(size_t)r * wb + x];
      int j0, j1;
      float s;
      up_taps(x, (w[b] + 1) / 2, wb / 2, &j0, &j1, &s);
      if (mode == 0) {
        int i0, i1;
        float t;
        up_taps(r, (h[b] + 1) / 2, hb / 2, &i0, &i1, &t);
        uu = lerp(lerp(up[i0 * wb + j0], up[i1 * wb + j0], t),
                  lerp(up[i0 * wb + j1], up[i1 * wb + j1], t), s);
        vv = lerp(lerp(vp[i0 * wb + j0], vp[i1 * wb + j0], t),
                  lerp(vp[i0 * wb + j1], vp[i1 * wb + j1], t), s);
      } else {
        uu = lerp(up[(size_t)r * wb + j0], up[(size_t)r * wb + j1], s);
        vv = lerp(vp[(size_t)r * wb + j0], vp[(size_t)r * wb + j1], s);
      }
      uu = __fsub_rn(uu, 128.0f);
      vv = __fsub_rn(vv, 128.0f);
    }
    o[0] = clip255(__fadd_rn(y, __fmul_rn(1.402f, vv)));
    o[1] = clip255(__fsub_rn(__fsub_rn(y, __fmul_rn(0.344136f, uu)),
                             __fmul_rn(0.714136f, vv)));
    o[2] = clip255(__fadd_rn(y, __fmul_rn(1.772f, uu)));
  }
}

}  // namespace

// src: int16 [B, R, W, C] packed coefficients; planes: f32 scratch of the
// same shape; out: f32 [B, hb, wb, 3]; regs: n rows of 7 ints
// (r0, rows, c0, cols, ch, kv, kh); mode: see dct_color. Two launches.
extern "C" int itpu_from_dct(const int16_t* src, float* planes, float* out,
                             const int32_t* h, const int32_t* w,
                             const int32_t* regs, int nreg, int mode, int B,
                             int R, int W, int C, int hb, int wb,
                             void* stream) {
  if (B == 0) return 0;
  if (nreg < 1 || nreg > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Regions rg{};
  rg.n = nreg;
  int bands = 0, chunks = 0;
  for (int i = 0; i < nreg; ++i) {
    const int* q = regs + 7 * i;
    rg.r[i] = Region{q[0], q[1], q[2], q[3], q[4], q[5], q[6]};
    if (rg.r[i].kv < 1 || rg.r[i].kv > 8 || rg.r[i].kh < 1 ||
        rg.r[i].kh > 8)
      return (int)cudaErrorInvalidValue;
    bands = max(bands, rg.r[i].rows / rg.r[i].kv);
    chunks = max(chunks, (rg.r[i].cols + kCols - 1) / kCols);
  }
  const dim3 grid(chunks, bands, B * nreg);
  idct_blocks<<<grid, kThreads, 0, s>>>(src, planes, R, W, C, rg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * hb * wb;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535u * 32u) blocks = 65535u * 32u;
  dct_color<<<(unsigned)blocks, kThreads, 0, s>>>(planes, out, h, w, mode, B,
                                                   hb, wb);
  return (int)cudaGetLastError();
}
