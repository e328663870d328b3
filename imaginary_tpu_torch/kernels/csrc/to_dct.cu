// K12: RGB -> quantized JPEG coefficients (forward DCT egress).
//
// Replaces: imaginary_tpu/ops/stages.py:555-622 (`ToDctSpec.apply`) and
// the int16 drain that ends such a chain (imaginary_tpu/ops/chain.py:116-120:
// round half to even, clamp to int16).
//
// Bound on the H100: memory. At a 1088x1920 output it reads 12 bytes of f32
// RGB and writes 3 bytes of int16 coefficients a pixel (1.5 samples of 2
// bytes); the 8x8 forward DCT is 16 multiply-adds a sample, separable.
//
// Design: one launch; a block of 128 threads takes a band of 16 rows by
// 32 columns (2 MCUs) of one image.
//   - Loads: a thread takes 2 pixels of two neighbouring rows, each row as
//     three 8-byte loads (edge pixels, where valid pixels replicate outward
//     over the bucket padding as the reference's gathers do, by the clamped
//     index one float at a time). It clips them to 0-255, converts them to
//     Y, Cb, Cr with the reference's constants and operation order (no
//     contraction) and makes its 2x2 block's chroma samples in registers:
//     the plain mean ((a + b) + c) + d, / 4 (as * 0.25, the same number),
//     after replication (not masked, unlike K3's pool), then - 128 like Y.
//   - Row pass: a thread takes one 8-sample row of an 8x8 block (two
//     16-byte shared loads) and makes 4 of its 8 sums, sum over z of
//     blk[x][z] * bs[v][z] (`_idct_basis(8)`'s f32 words, dct_basis.cuh).
//   - Column pass: a thread takes one output row u of a block: it reads
//     the block's 64 row sums (the 8 threads of a block as broadcasts) and
//     makes coef[u][v] = sum over x of bs[u][x] * t[x][v] for v = 0..7,
//     divides by the image's qy / qc step (__fdiv_rn, not a multiply by
//     the reciprocal), rounds with rintf (half to even, as jnp.round),
//     clamps to int16 and stores the row as one 16-byte store, into the
//     yuv420-shaped packing: Y above, U | V side by side below.
//   - IEEE f32 throughout, every product and sum rounded on its own, in
//     the reference's order; index math is 32-bit inside one image; the
//     grid is the bands.
//   - W-shard form (`itpu_to_dct_shard`, the spatial route): the bands
//     cover the whole MCUs that hold the shard's columns, read from a
//     window of the input (each column clamped to the valid width, as the
//     whole image replicates its edge); an MCU that straddles two shards
//     is computed whole by both and each stores only its own coefficient
//     columns, into K3's shard packing (Y's columns, then U's and V's
//     halves side by side).
// Wider bands (4 or 8 MCUs), 4-pixel loads and whole 8-sum rows a thread
// were slower at every measured shape on the H100 (more registers a
// thread, fewer blocks in flight; PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct_basis.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;                     // a band: one MCU row
constexpr int kMcus = 2;                      // MCUs a band
constexpr int kCols = 16 * kMcus;             // its columns
constexpr int kBlk = kCols / 8;               // 8-column blocks of a Y row
constexpr int kItems = 3 * kRows * kBlk / 2;  // 8-sample rows of the band
static_assert(kThreads == kRows / 2 * kCols / 2, "a thread a 2x2 pixel block");

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// 2 pixels (6 floats) of one row from global pixel x0, as 8-byte vectors
// (row: the row's pixel k0); the pixels past xmax replicate pixel xmax.
// kShard: the row may start off an 8-byte boundary (a window of odd
// width), so the vector path also checks the address.
template <bool kShard>
__device__ __forceinline__ void load2(const float* row, int x0, int xmax, int k0,
                                      float* a) {
  const float* p0 = row + (x0 - k0) * 3;
  if (x0 + 1 <= xmax && (!kShard || (reinterpret_cast<uintptr_t>(p0) & 7) == 0)) {
    const float2* p = reinterpret_cast<const float2*>(p0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 v = __ldg(p + i);
      a[2 * i] = v.x;
      a[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = row + (min(x0 + i, xmax) - k0) * 3;
      a[3 * i] = __ldg(p);
      a[3 * i + 1] = __ldg(p + 1);
      a[3 * i + 2] = __ldg(p + 2);
    }
  }
}

// A shard's store of one 8-coefficient block row whose first column is
// column `at` of the shard's plane row d (n columns wide): only the
// columns inside [0, n), as one 16-byte store when the whole row is
// inside and aligned.
__device__ __forceinline__ void store_part(int16_t* d, int at, int n, const uint32_t* wd) {
  if (at >= 0 && at + 8 <= n && (reinterpret_cast<uintptr_t>(d + at) & 15) == 0) {
    *reinterpret_cast<uint4*>(d + at) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (at + e >= 0 && at + e < n) d[at + e] = (int16_t)(uint16_t)(wd[e >> 1] >> (16 * (e & 1)));
}

// grid: (bands across, bands down, B); hb and wb multiples of 16.
//
// kShard: the W-shard form. It writes the shard's own coefficient columns,
// Y's [col0, col0 + lw), then U's and V's [col0/2, (col0 + lw)/2) side by
// side below ([B, hb + hb/2, lw]); its bands cover the whole MCUs [m0,
// m1) that hold them (a straddling MCU is computed whole and stored in
// part), and `in` holds the global columns [k0, k0 + kw) of every row
// (each column the MCUs read, after the clamp to the valid width). The
// whole image is kShard false: col0 = m0 = k0 = 0 and lw = m1 = kw = wb.
template <bool kShard>
__device__ __forceinline__ void to_dct_band(
    const float* __restrict__ in, int16_t* __restrict__ out,
    const int32_t* __restrict__ h, const int32_t* __restrict__ w,
    const float* __restrict__ qy, const float* __restrict__ qc, int hb, int wb,
    int col0, int lw, int m0, int m1, int k0, int kw) {
  // Y - 128 [16][32], Cb, Cr - 128 [8][16] each; the row pass writes its
  // sums into ty, tc
  __shared__ __align__(16) float sy[kRows][kCols], ty[kRows][kCols];
  __shared__ __align__(16) float sc[2][kRows / 2][kCols / 2];
  __shared__ __align__(16) float tc[2][kRows / 2][kCols / 2];
  __shared__ float bs[8][8];
  __shared__ float qs[2][64];
  const int tid = threadIdx.x;
  const int X0 = (kShard ? m0 : 0) + blockIdx.x * kCols, R0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int tw = min(kCols, (kShard ? m1 : wb) - X0);
  const int iw = kShard ? kw : wb;  // the input's row width
  const float* img = in + (size_t)b * hb * iw * 3;

  // rows 2 rp and 2 rp + 1, pixels 2 g and 2 g + 1 of the band
  const int rp = tid / (kCols / 2), g = tid % (kCols / 2);
  const bool has = 2 * g < tw;
  float a0[6], a1[6];
  if (has) {
    const int ymax = max(h[b] - 1, 0), xmax = max(w[b] - 1, 0);
    const int kk = kShard ? k0 : 0;
    load2<kShard>(img + min(R0 + 2 * rp, ymax) * iw * 3, X0 + 2 * g, xmax, kk, a0);
    load2<kShard>(img + min(R0 + 2 * rp + 1, ymax) * iw * 3, X0 + 2 * g, xmax, kk, a1);
  }
  if (tid < 64) bs[tid >> 3][tid & 7] = idct_basis(3, tid >> 3, tid & 7);
  qs[tid >> 6][tid & 63] = (tid < 64 ? qy : qc)[b * 64 + (tid & 63)];

  if (has) {
    float cb[4], cr[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* a = j == 0 ? a0 : a1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float r = clip255(a[3 * i]);
        const float gg = clip255(a[3 * i + 1]);
        const float bl = clip255(a[3 * i + 2]);
        sy[2 * rp + j][2 * g + i] = __fsub_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, gg)),
                      __fmul_rn(0.114f, bl)),
            128.0f);
        cb[2 * j + i] = __fadd_rn(
            __fadd_rn(__fsub_rn(__fmul_rn(-0.168736f, r),
                                __fmul_rn(0.331264f, gg)),
                      __fmul_rn(0.5f, bl)),
            128.0f);
        cr[2 * j + i] = __fadd_rn(
            __fsub_rn(__fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.418688f, gg)),
                      __fmul_rn(0.081312f, bl)),
            128.0f);
      }
    }
    sc[0][rp][g] = __fsub_rn(
        __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(cb[0], cb[1]), cb[2]), cb[3]), 0.25f),
        128.0f);
    sc[1][rp][g] = __fsub_rn(
        __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(cr[0], cr[1]), cr[2]), cr[3]), 0.25f),
        128.0f);
  }
  __syncthreads();

  // rows: t[x][v] = sum_z blk[x][z] * bs[v][z]; items: Y (row, block),
  // then Cb, Cr (plane, row, block), each in two halves of 4 sums
  for (int i = tid; i < 2 * kItems; i += kThreads) {
    const int it = i >> 1, v0 = (i & 1) * 4;
    const float* p;
    float* d;
    if (it < kRows * kBlk) {
      const int r = it / kBlk, c0 = (it % kBlk) * 8;
      if (c0 >= tw) continue;
      p = &sy[r][c0];
      d = &ty[r][c0];
    } else {
      const int j = it - kRows * kBlk;  // < 2 * 8 * kMcus
      const int pl = j / (8 * kMcus), r = (j / kMcus) % 8, c0 = (j % kMcus) * 8;
      if (c0 >= tw / 2) continue;
      p = &sc[pl][r][c0];
      d = &tc[pl][r][c0];
    }
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    const float blk[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float t[4];
#pragma unroll
    for (int vv = 0; vv < 4; ++vv) {
      float acc = 0.0f;
#pragma unroll
      for (int z = 0; z < 8; ++z) acc = __fadd_rn(acc, __fmul_rn(blk[z], bs[v0 + vv][z]));
      t[vv] = acc;
    }
    *reinterpret_cast<float4*>(d + v0) = make_float4(t[0], t[1], t[2], t[3]);
  }
  __syncthreads();

  // columns, one output row of a block a thread: coef[u][v] = sum_x
  // bs[u][x] * t[x][v] for v = 0..7, quantized and stored as one 16-byte
  // row; items: Y (block, u), then Cb, Cr (plane, block, u)
  const int ow = kShard ? lw : wb;  // the output's row width
  int16_t* oimg = out + (size_t)b * (hb + hb / 2) * ow;
  for (int i = tid; i < kItems; i += kThreads) {
    const int u = i & 7, nb = i >> 3;
    const float* p;
    const float* q;
    int16_t* d;
    int stride, at, n;  // the block row's first column in d's row, d's width
    if (nb < 2 * kBlk) {
      const int br = nb / kBlk, c0 = (nb % kBlk) * 8;
      if (c0 >= tw) continue;
      p = &ty[br * 8][c0];
      stride = kCols;
      q = qs[0] + u * 8;
      d = oimg + (R0 + br * 8 + u) * ow;
      at = X0 + c0 - (kShard ? col0 : 0);
      n = ow;
    } else {
      const int j = nb - 2 * kBlk;  // < 2 * kMcus
      const int pl = j / kMcus, c0 = (j % kMcus) * 8;
      if (c0 >= tw / 2) continue;
      p = &tc[pl][0][c0];
      stride = kCols / 2;
      q = qs[1] + u * 8;
      d = oimg + (hb + R0 / 2 + u) * ow + pl * (ow / 2);
      at = X0 / 2 + c0 - (kShard ? col0 / 2 : 0);
      n = ow / 2;
    }
    float bu[8], acc[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      bu[x] = bs[u][x];
      acc[x] = 0.0f;
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const float4 lo = reinterpret_cast<const float4*>(p + x * stride)[0];
      const float4 hi = reinterpret_cast<const float4*>(p + x * stride)[1];
      const float t[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(bu[x], t[v]));
    }
    uint32_t wd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = fminf(fmaxf(rintf(__fdiv_rn(acc[2 * e], q[2 * e])), -32768.0f),
                             32767.0f);
      const float hi = fminf(fmaxf(rintf(__fdiv_rn(acc[2 * e + 1], q[2 * e + 1])), -32768.0f),
                             32767.0f);
      wd[e] = (uint32_t)(uint16_t)(int16_t)lo | ((uint32_t)(uint16_t)(int16_t)hi << 16);
    }
    if (kShard)
      store_part(d, at, n, wd);
    else
      *reinterpret_cast<uint4*>(d + at) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    to_dct(const float* __restrict__ in, int16_t* __restrict__ out,
           const int32_t* __restrict__ h, const int32_t* __restrict__ w,
           const float* __restrict__ qy, const float* __restrict__ qc, int hb, int wb) {
  to_dct_band<false>(in, out, h, w, qy, qc, hb, wb, 0, wb, 0, wb, 0, wb);
}

__global__ void __launch_bounds__(kThreads)
    to_dct_shard(const float* __restrict__ in, int16_t* __restrict__ out,
                 const int32_t* __restrict__ h, const int32_t* __restrict__ w,
                 const float* __restrict__ qy, const float* __restrict__ qc, int hb,
                 int wb, int col0, int lw, int m0, int m1, int k0, int kw) {
  to_dct_band<true>(in, out, h, w, qy, qc, hb, wb, col0, lw, m0, m1, k0, kw);
}

}  // namespace

// in: f32 [B, hb, wb, 3] RGB, 8-byte aligned, hb and wb multiples of 16;
// out: int16 [B, hb + hb/2, wb], 16-byte aligned; h, w: int32 [B] valid dims; qy, qc:
// f32 [B, 8, 8] quantization steps, natural order. One launch.
extern "C" int itpu_to_dct(const float* in, int16_t* out, const int32_t* h,
                           const int32_t* w, const float* qy, const float* qc,
                           int B, int hb, int wb, void* stream) {
  if (B == 0) return 0;
  if (hb % 16 || wb % 16 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(in) & 7) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((wb + kCols - 1) / kCols, hb / kRows, B);
  to_dct<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w, qy,
                                                                   qc, hb, wb);
  return (int)cudaGetLastError();
}

// The W-shard form: the shard's output columns [col0, col0 + lw) of a
// bucket wb wide (col0 and lw even). in: f32 [B, hb, kw, 3], the global
// columns [k0, k0 + kw) of the input, which must hold every column
// min(x, w - 1) for x in the whole MCUs [16 floor(col0 / 16), 16 ceil((col0
// + lw) / 16)); out: int16 [B, hb + hb/2, lw], the shard's Y columns, then
// its U and V columns side by side, equal to the whole image's K12 at
// those columns bit for bit. One launch.
extern "C" int itpu_to_dct_shard(const float* in, int16_t* out, const int32_t* h,
                                 const int32_t* w, const float* qy, const float* qc,
                                 int B, int hb, int wb, int col0, int lw, int k0, int kw,
                                 void* stream) {
  if (B == 0) return 0;
  if (hb % 16 || wb % 16 || B > 65535 || lw <= 0 || lw % 2 || col0 % 2 || col0 < 0 ||
      col0 + lw > wb || kw <= 0 || k0 < 0 || k0 + kw > wb)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(in) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 1) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int m0 = col0 & ~15, m1 = (col0 + lw + 15) & ~15;
  const dim3 grid((m1 - m0 + kCols - 1) / kCols, hb / kRows, B);
  to_dct_shard<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, h, w, qy, qc, hb, wb, col0, lw, m0, m1, k0, kw);
  return (int)cudaGetLastError();
}
