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
// f32 rate.
//
// Design: one launch; a block makes a tile of 16 output rows by 128
// columns of one image, and no IDCT sample leaves shared memory.
//   - Loads: a thread takes 8 consecutive coefficients of one coefficient
//     row (one 16-byte load) or, in the three-plane layouts, 8 pixels of
//     all three channels (three 16-byte loads, split by channel). 8 holds
//     whole blocks of every plane at every k. The loads are issued before
//     the block copies the kv- and kh-point bases (the reference's f32
//     words, dct_basis.cuh) into shared memory and waits at its first
//     barrier.
//   - IDCT: the horizontal pass runs in registers on those 8 values and
//     writes 8 sums to shared memory; the vertical pass runs down one
//     column of shared memory a thread, in place, + 128. IEEE f32 with
//     every product and sum rounded on its own (no FMA contraction, no
//     TF32: dequantized coefficients reach +-4k, stages.py:483-488), in the
//     order the reference's einsum names: sum over v, then over u.
//   - Chroma halo: at 4:2:0 and 4:2:2, k = 8, the centred 2x upsample
//     (libjpeg's 1/4-3/4 taps, clamped to the valid chroma extent per
//     image) of the tile's edge pixels reads one chroma row and column past
//     the tile. The block works out its chroma window from the same taps
//     (so a tile past an image's valid dims reads only the clamped
//     samples), transforms the 8-row, 8-column blocks that hold the window
//     and runs the vertical pass only for the window's rows.
//   - Colour: a thread makes one 16-byte store of the tile's f32 RGB rows
//     (4 floats: parts of 2 pixels) from the shared samples: the upsample,
//     BT.601 (or the gray broadcast) and the clip, in the reference's
//     operation order; so a warp writes 512 contiguous bytes a store.
//   - Index math is 32-bit inside one image; the grid is the tiles.
//   - W-shard form (`itpu_from_dct_shard`, the spatial route): the same
//     tile code on a shard's own coefficient columns, its taps and clamps
//     on global columns. At 4:2:0 and 4:2:2, k = 8, a chroma sample next
//     to the shard needs its block's whole IDCT row, so the shard also
//     takes one whole 8x8 chroma block of U and of V on each side: the
//     neighbour, or the block holding the valid chroma edge when the
//     clamp reaches past it (a shard past the valid width reads that
//     column alone). The loads map each global chroma block to the buffer
//     that holds it; nothing else differs, so a shard's samples equal the
//     whole image's at its columns bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct_basis.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // output rows of a tile
constexpr int kCols = 128;  // output columns of a tile
constexpr int kRuns = kCols / 8;
// the chroma window of a k = 8 4:2:0 / 4:2:2 tile: up to 3 block rows (24
// coefficient rows) by 10 blocks (80 columns) of each of U and V
constexpr int kCRows = 24;
constexpr int kCBlocks = 10;
constexpr int kCCols = 8 * kCBlocks;

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

__device__ __forceinline__ void ycc(float y, float uu, float vv, float* o) {
  o[0] = clip255(__fadd_rn(y, __fmul_rn(1.402f, vv)));
  o[1] = clip255(__fsub_rn(__fsub_rn(y, __fmul_rn(0.344136f, uu)),
                           __fmul_rn(0.714136f, vv)));
  o[2] = clip255(__fadd_rn(y, __fmul_rn(1.772f, uu)));
}

// 8 consecutive int16 (16 bytes; p is 16-byte aligned)
__device__ __forceinline__ uint4 load8(const int16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(uint4 q, float* c) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = (float)(int16_t)(w[i] & 0xffffu);
    c[2 * i + 1] = (float)(int16_t)(w[i] >> 16);
  }
}

// horizontal pass over 8 coefficients of one row, K-point blocks:
// o[t0 + z] = sum_v c[t0 + v] * bh[v][z]
template <int K>
__device__ __forceinline__ void hrow_k(const float* c, const float (*bh)[8],
                                       float* o) {
#pragma unroll
  for (int t0 = 0; t0 < 8; t0 += K) {
#pragma unroll
    for (int z = 0; z < K; ++z) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < K; ++v)
        acc = __fadd_rn(acc, __fmul_rn(c[t0 + v], bh[v][z]));
      o[t0 + z] = acc;
    }
  }
}

// the horizontal pass of 8 coefficients into 8 floats of shared memory
__device__ __forceinline__ void hrow(const float* c, int k,
                                     const float (*bas)[8][8], float* dst) {
  float o[8];
  switch (k) {
    case 8: hrow_k<8>(c, bas[3], o); break;
    case 4: hrow_k<4>(c, bas[2], o); break;
    case 2: hrow_k<2>(c, bas[1], o); break;
    default: hrow_k<1>(c, bas[0], o); break;
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// vertical pass down one column (stride floats apart) of nblk K-row
// blocks, in place: out[x] = sum_u bv[u][x] * t[u], + 128
template <int K>
__device__ __forceinline__ void vcol_k(float* col, int stride, int nblk,
                                       const float (*bv)[8]) {
  for (int bi = 0; bi < nblk; ++bi) {
    float* p = col + bi * K * stride;
    float t[K];
#pragma unroll
    for (int u = 0; u < K; ++u) t[u] = p[u * stride];
#pragma unroll
    for (int x = 0; x < K; ++x) {
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < K; ++u)
        acc = __fadd_rn(acc, __fmul_rn(bv[u][x], t[u]));
      p[x * stride] = __fadd_rn(acc, 128.0f);
    }
  }
}

__device__ __forceinline__ void vcol(float* col, int stride, int nrows, int k,
                                     const float (*bas)[8][8]) {
  switch (k) {
    case 8: vcol_k<8>(col, stride, nrows >> 3, bas[3]); break;
    case 4: vcol_k<4>(col, stride, nrows >> 2, bas[2]); break;
    case 2: vcol_k<2>(col, stride, nrows >> 1, bas[1]); break;
    default: vcol_k<1>(col, stride, nrows, bas[0]); break;
  }
}

// mode 0: 4:2:0 at k = 8, input [hb + hb/2, wb, 1] (Y above, U | V
// below); 1: 4:2:2 at k = 8, [2 hb, wb, 1]; 2: three planes at the output
// size, [hb, wb, 3], Y in k x k blocks and chroma in kcv x kch; 3: gray,
// [hb, wb, 1] in k x k blocks. grid: (tiles across, tiles down, B).
//
// kShard: the W-shard form. src then holds output columns [col0, col0 +
// wb) of an image whose bucket is gwb wide (col0 a multiple of 16 in
// modes 0 and 1, of 8 otherwise), and, in modes 0 and 1, lh and rh hold
// one 8-column chroma block of U then of V a chroma row ([B, crows, 16]):
// the blocks `kernels.dct_halo_blocks` picks, so that every clamped chroma
// column the shard's taps read lies in a block of the window. Taps and
// clamps use global columns; only the loads map a global chroma block to
// the buffer that holds it. The whole image is kShard false, col0 0 and
// gwb = wb.
template <bool kShard>
__device__ __forceinline__ void from_dct_tile(
    const int16_t* __restrict__ src, const int16_t* __restrict__ lh,
    const int16_t* __restrict__ rh, float* __restrict__ out,
    const int32_t* __restrict__ h, const int32_t* __restrict__ w, int mode, int k,
    int kcv, int kch, int hb, int wb, int col0, int gwb) {
  // modes 0, 1, 3: Y [kRows][kCols], then (0, 1) U, V [kCRows][kCCols];
  // mode 2: Y, U, V [kRows][kCols]
  __shared__ __align__(16) float sm[3 * kRows * kCols];
  __shared__ float bas[4][8][8];  // the n-point basis at [log2 n]
  __shared__ float4 stage[kThreads / 32][3 * 32];  // a warp's output row
  const int tid = threadIdx.x;
  const int X0 = blockIdx.x * kCols, R0 = blockIdx.y * kRows;
  const int GX0 = kShard ? col0 + X0 : X0;  // the tile's first global column
  const int b = blockIdx.z;
  const int tw = min(kCols, wb - X0), th = min(kRows, hb - R0);
  const int C = mode == 2 ? 3 : 1;
  const int W = wb;
  const int R = mode == 0 ? hb + hb / 2 : mode == 1 ? 2 * hb : hb;
  const int16_t* img = src + (size_t)b * R * W * C;
  float* oimg = out + (size_t)b * hb * wb * 3;
  float* sy = sm;
  float* sc = sm + kRows * kCols;

  // the chroma window (mode 0, 1): chroma rows [rlo, rhi] and columns
  // [clo, chi] that the tile's taps read, in blocks [brlo, +nbr) x
  // [bclo, +nbc); the valid chroma extent is clamped into the buffer
  const int cwb = (kShard ? gwb : wb) >> 1, chb = hb >> 1;
  const int cnw = min((w[b] + 1) / 2, cwb);
  const int cnh = min((h[b] + 1) / 2, chb);
  int rlo = 0, rhi = 0, clo = 0, chi = 0, brlo = 0, nbr = 0, bclo = 0, nbc = 0;
  if (mode <= 1) {
    int i;
    float t;
    up_taps(GX0, cnw, cwb, &clo, &i, &t);
    up_taps(GX0 + tw - 1, cnw, cwb, &i, &chi, &t);
    if (mode == 0) {
      up_taps(R0, cnh, chb, &rlo, &i, &t);
      up_taps(R0 + th - 1, cnh, chb, &i, &rhi, &t);
    } else {
      rlo = R0;
      rhi = R0 + th - 1;
    }
    brlo = rlo >> 3;
    nbr = (rhi >> 3) - brlo + 1;
    bclo = clo >> 3;
    nbc = (chi >> 3) - bclo + 1;
  }

  // issue the loads: the thread's 8 luma (or 8-pixel, 3-channel) values,
  // and up to two 8-coefficient runs of the chroma window
  const int q = tid >> 4, run = tid & (kRuns - 1);
  const bool has_y = q < th && run * 8 < tw;
  uint4 ly[3];
  if (has_y) {
    const int16_t* p = img + ((R0 + q) * W + X0 + run * 8) * C;
    ly[0] = load8(p);
    if (C == 3) {
      ly[1] = load8(p + 8);
      ly[2] = load8(p + 16);
    }
  }
  uint4 lc[2];
  int cdst[2] = {-1, -1};
  if (mode <= 1) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = tid + m * kThreads;  // < 2 * kCRows * kCBlocks
      const int bc = i % kCBlocks, rq = i / kCBlocks;
      const int pl = rq / kCRows, cq = rq - pl * kCRows;
      if (pl < 2 && bc < nbc && cq < nbr * 8) {
        // the chroma planes start at row hb; a shard's blocks left and
        // right of its own columns are its halo blocks
        const int gb = bclo + bc, crow = brlo * 8 + cq;
        const int16_t* p;
        if (!kShard) {
          p = img + (hb + crow) * W + pl * cwb + gb * 8;
        } else {
          const int own0 = col0 >> 4, own1 = (col0 + wb) >> 4;
          const size_t hrow = ((size_t)b * (R - hb) + crow) * 16 + pl * 8;
          p = gb < own0   ? lh + hrow
              : gb < own1 ? img + (hb + crow) * W + pl * (W >> 1) + (gb - own0) * 8
                          : rh + hrow;
        }
        lc[m] = load8(p);
        cdst[m] = (pl * kCRows + cq) * kCCols + bc * 8;
      }
    }
  }

  {
    const int li = tid >> 6, u = (tid >> 3) & 7, x = tid & 7;
    const int n = 1 << li;
    if (u < n && x < n) bas[li][u][x] = idct_basis(li, u, x);
  }
  __syncthreads();

  // horizontal pass into shared memory
  if (has_y) {
    float c[8];
    if (C == 3) {
      float a[24];
      unpack8(ly[0], a);
      unpack8(ly[1], a + 8);
      unpack8(ly[2], a + 16);
      float cu[8], cv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = a[3 * i];
        cu[i] = a[3 * i + 1];
        cv[i] = a[3 * i + 2];
      }
      const int o = q * kCols + run * 8;
      hrow(c, k, bas, sm + o);
      hrow(cu, kch, bas, sm + kRows * kCols + o);
      hrow(cv, kch, bas, sm + 2 * kRows * kCols + o);
    } else {
      unpack8(ly[0], c);
      hrow(c, mode == 3 ? k : 8, bas, sy + q * kCols + run * 8);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (cdst[m] >= 0) {
      float c[8];
      unpack8(lc[m], c);
      hrow(c, 8, bas, sc + cdst[m]);
    }
  }
  __syncthreads();

  // vertical pass, in place: a thread a column of a plane
  if (mode == 2) {
    for (int i = tid; i < 3 * kCols; i += kThreads) {
      const int pl = i / kCols, col = i - pl * kCols;
      if (col < tw)
        vcol(sm + pl * kRows * kCols + col, kCols, th, pl == 0 ? k : kcv, bas);
    }
  } else {
    if (tid < kCols) {
      if (tid < tw) vcol(sy + tid, kCols, th, mode == 3 ? k : 8, bas);
    } else if (mode <= 1) {
      // the chroma window's columns; only the window's rows of each block
      const float (*bv)[8] = bas[3];
      for (int i = tid - kCols; i < 2 * kCCols; i += kThreads - kCols) {
        const int pl = i / kCCols, cc = i - pl * kCCols;
        const int col = bclo * 8 + cc;
        if (col < clo || col > chi) continue;
        for (int bi = 0; bi < nbr; ++bi) {
          const int r0 = (brlo + bi) * 8;
          const int xlo = max(rlo - r0, 0), xhi = min(rhi - r0, 7);
          float* p = sc + (pl * kCRows + bi * 8) * kCCols + cc;
          float t[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) t[u] = p[u * kCCols];
          for (int x = xlo; x <= xhi; ++x) {
            float acc = 0.0f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              acc = __fadd_rn(acc, __fmul_rn(bv[u][x], t[u]));
            p[x * kCCols] = __fadd_rn(acc, 128.0f);
          }
        }
      }
    }
  }
  __syncthreads();

  // colour: a warp makes a tile row, a lane 4 pixels. Pixel x reads
  // chroma columns (x - 1) >> 1 and the next at s = 3/4 (even x) or 1/4
  // (odd x), `up_taps`' values in integers as K2 has them, so the 4
  // pixels of a lane share 4 columns and each column's row blend is made
  // once. The lane's 48 bytes are staged in the warp's shared slot and
  // the row goes out as 16-byte stores of one contiguous run.
  const int lane = tid & 31, warp = tid >> 5;
  const int x = 4 * lane;
  const int nvec = 3 * tw / 4;
  float4* slot = stage[warp];
  for (int r = warp; r < th; r += kThreads / 32) {
    if (x < tw) {
      float o[12];
      if (mode <= 1) {
        int i0 = r, i1 = r;  // mode 1: window row r is output row r
        float t = 0.0f;
        if (mode == 0) {
          up_taps(R0 + r, cnh, chb, &i0, &i1, &t);
          i0 -= brlo * 8;
          i1 -= brlo * 8;
        }
        const float* up = sc;
        const float* vp = sc + kCRows * kCCols;
        const int hiw = max(cnw - 1, 0);
        const int jb = (GX0 + x - 1) >> 1;
        float cu[4], cv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = min(max(jb + m, 0), hiw) - bclo * 8;
          if (mode == 0) {
            cu[m] = lerp(up[i0 * kCCols + j], up[i1 * kCCols + j], t);
            cv[m] = lerp(vp[i0 * kCCols + j], vp[i1 * kCCols + j], t);
          } else {
            cu[m] = up[i0 * kCCols + j];
            cv[m] = vp[i0 * kCCols + j];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = (e + 1) >> 1;
          const float sw = (e & 1) ? 0.25f : 0.75f;
          ycc(sy[r * kCols + x + e], __fsub_rn(lerp(cu[m], cu[m + 1], sw), 128.0f),
              __fsub_rn(lerp(cv[m], cv[m + 1], sw), 128.0f), o + 3 * e);
        }
      } else if (mode == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = r * kCols + x + e;
          ycc(sm[q], __fsub_rn(sm[kRows * kCols + q], 128.0f),
              __fsub_rn(sm[2 * kRows * kCols + q], 128.0f), o + 3 * e);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = clip255(sy[r * kCols + x + e]);
          o[3 * e] = y;
          o[3 * e + 1] = y;
          o[3 * e + 2] = y;
        }
      }
      slot[3 * lane] = make_float4(o[0], o[1], o[2], o[3]);
      slot[3 * lane + 1] = make_float4(o[4], o[5], o[6], o[7]);
      slot[3 * lane + 2] = make_float4(o[8], o[9], o[10], o[11]);
    }
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(oimg + ((R0 + r) * wb + X0) * 3);
    for (int q = lane; q < nvec; q += 32) dst[q] = slot[q];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    from_dct(const int16_t* __restrict__ src, float* __restrict__ out,
             const int32_t* __restrict__ h, const int32_t* __restrict__ w,
             int mode, int k, int kcv, int kch, int hb, int wb) {
  from_dct_tile<false>(src, nullptr, nullptr, out, h, w, mode, k, kcv, kch, hb, wb, 0,
                       wb);
}

__global__ void __launch_bounds__(kThreads, 3)
    from_dct_shard(const int16_t* __restrict__ src, const int16_t* __restrict__ lh,
                   const int16_t* __restrict__ rh, float* __restrict__ out,
                   const int32_t* __restrict__ h, const int32_t* __restrict__ w,
                   int mode, int k, int kcv, int kch, int hb, int lw, int col0,
                   int gwb) {
  from_dct_tile<true>(src, lh, rh, out, h, w, mode, k, kcv, kch, hb, lw, col0, gwb);
}

}  // namespace

// src: int16 packed coefficients, 16-byte aligned: [B, hb + hb/2, wb, 1]
// (mode 0), [B, 2 hb, wb, 1] (mode 1), [B, hb, wb, 3] (mode 2) or
// [B, hb, wb, 1] (mode 3); out: f32 [B, hb, wb, 3], 16-byte aligned; h, w:
// int32 [B] valid dims; k: the luma block size, kcv x kch the chroma
// blocks of mode 2. wb is a multiple of 8 (of 16 in modes 0 and 1), hb of
// every block height (of 16 in mode 0). One launch; returns its CUDA
// error code.
extern "C" int itpu_from_dct(const int16_t* src, float* out, const int32_t* h,
                             const int32_t* w, int mode, int k, int kcv,
                             int kch, int B, int hb, int wb, void* stream) {
  if (B == 0) return 0;
  const bool pow2 = (k == 1 || k == 2 || k == 4 || k == 8) &&
                    (kcv == 1 || kcv == 2 || kcv == 4 || kcv == 8) &&
                    (kch == 1 || kch == 2 || kch == 4 || kch == 8);
  if (mode < 0 || mode > 3 || !pow2 || wb % 8 || hb % k ||
      (mode == 2 && hb % kcv) || (mode <= 1 && (k != 8 || wb % 16)) ||
      (mode == 0 && hb % 16) || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(src) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((wb + kCols - 1) / kCols, (hb + kRows - 1) / kRows, B);
  from_dct<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, out, h, w, mode, k, kcv, kch, hb, wb);
  return (int)cudaGetLastError();
}

// The W-shard form: src holds output columns [col0, col0 + lw) of an image
// whose bucket is wb wide, in the layout of the whole image's entry at
// width lw ([B, hb + hb/2, lw, 1] in mode 0: Y's lw columns, then U's and
// V's lw/2 chroma columns side by side); in modes 0 and 1, left and right
// are int16 [B, hb/2 (mode 0) or hb (mode 1), 16]: the chroma blocks
// `kernels.dct_halo_blocks` names, U's 8 columns then V's (ignored, and
// may be null, in modes 2 and 3). out: f32 [B, hb, lw, 3], equal to the
// whole image's K11 at those columns bit for bit. col0 and lw: multiples
// of 16 in modes 0 and 1, of 8 and of every plane's block width
// otherwise. One launch; returns its CUDA error code.
extern "C" int itpu_from_dct_shard(const int16_t* src, const int16_t* left,
                                   const int16_t* right, float* out, const int32_t* h,
                                   const int32_t* w, int mode, int k, int kcv, int kch,
                                   int B, int hb, int lw, int col0, int wb,
                                   void* stream) {
  if (B == 0) return 0;
  const bool pow2 = (k == 1 || k == 2 || k == 4 || k == 8) &&
                    (kcv == 1 || kcv == 2 || kcv == 4 || kcv == 8) &&
                    (kch == 1 || kch == 2 || kch == 4 || kch == 8);
  const int step = mode <= 1 ? 16 : 8;
  if (mode < 0 || mode > 3 || !pow2 || lw <= 0 || lw % step || col0 % step ||
      col0 < 0 || col0 + lw > wb || wb % step || hb % k ||
      (mode == 2 && (hb % kcv || lw % kch)) || (mode <= 1 && k != 8) ||
      (mode == 0 && hb % 16) || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (mode <= 1 && (left == nullptr || right == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(src) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(left) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(right) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((lw + kCols - 1) / kCols, (hb + kRows - 1) / kRows, B);
  from_dct_shard<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, left, right, out, h, w, mode, k, kcv, kch, hb, lw, col0, wb);
  return (int)cudaGetLastError();
}
