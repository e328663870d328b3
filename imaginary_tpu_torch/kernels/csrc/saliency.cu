// K9: saliency map + 2-D integral image, and K10: masked window argmax.
//
// Replaces: imaginary_tpu/ops/saliency.py:20-53 (`_saliency_map` and the
// integral image of `smart_offsets`) and saliency.py:55-69
// (`smart_offsets.one`, the per-image argmax over every window), the
// device work of `SmartExtractSpec.apply` (ops/stages.py:638-654) before
// its window gather (K4).
//
// K9 bound on the H100: memory. It reads the image once (12 bytes a pixel
// in f32 RGB) and writes the f32 integral image (4 bytes a pixel); about
// 40 FLOPs and one expf a pixel. Design: two launches.
//   rows: a block of 256 threads takes a band of G rows of one image (G =
//     8, 4, 2 or 1: the largest that leaves at least two blocks an SM and
//     fits shared memory). Its first pass reads each pixel of the band's
//     rows and of the rows above and below it (clamped at the *bucket*
//     edge: the reference's edge replication reads the padding next to
//     the valid region) once, f32 RGB as three 16-byte vectors for four
//     pixels where the row allows, and keeps in shared memory each
//     pixel's Rec.709 luma and, for the band's own rows, the saturation
//     and skin terms. The second pass adds the edge term from the
//     neighbours' luma. Then the G rows are scanned at once, each with the
//     same tree: contiguous segments of ceil(Wb / 256) columns summed
//     serially, a warp scan and a scan of the 8 warp totals, then each
//     segment's running sums from its exclusive prefix. Writes
//     ii[b, y+1, 1:] and the zero ii[b, y+1, 0].
//   columns: 256 threads take a strip of 16 columns of one image, each
//     column cut into 16 row chunks of ceil(Hb / 16) rows, one thread a
//     chunk. A thread issues the loads of its chunk (up to kColBatch at a
//     time) before its first sum and keeps them in registers, sums them,
//     the 16 chunk totals are exchanged in shared memory, and it rewrites
//     its chunk as running sums from its chunk's prefix (the totals above
//     it, summed in ascending order from 0). Row 0 is zeros.
// Both sum orders are fixed by those trees, so the result does not depend
// on the band height or the grid. The sums run along W first, then H; the
// reference sums H first. The result therefore matches it to a relative
// tolerance, not exactly. Every rounding is an explicit __f*_rn intrinsic
// (no FMA contraction). At /smartcrop's shapes latency, not bytes, sets
// the time: one pass of the rows and one of the columns is the fewest
// launches without a grid-wide barrier (a cooperative single launch with
// cg::this_grid().sync() measured slower than the two), and every kernel
// here is launched as a programmatic dependent of the one before it
// (Hopper's griddepcontrol), so its blocks are resident and waiting when
// the kernel ahead of it in the stream ends.
//
// K10 bound: launch latency at config 4's shapes (it reads ii, 0.8 MB an
// image, once from L2). Design: one launch of one thread-block cluster of
// kCluster blocks per image (cudaLaunchKernelEx with a cluster
// dimension). Only candidates (t, l) whose window stays inside the valid
// region are scored, each block a contiguous band of the items (a
// candidate row t and a run of kArgSpan columns), a warp an item: lanes
// walk l with coalesced loads of ii rows t and min(t + win_h, Hb), no
// integer division per candidate. The score is the reference's exact f32
// expression (subtractions only, so nothing is contracted) and the key
// is the order-preserving bits of the score above ~index, so equal scores
// keep the smallest index, as jnp.argmax keeps the first maximum. Every
// masked candidate scores -1, so of them only the first in row-major
// order can win; its key is added from the valid limits without a load.
// Warps, then the block, reduce their keys; each block writes its best
// into rank 0's shared memory (distributed shared memory; a split cluster
// barrier, arrived at on entry, makes sure every block has started), and
// after cluster.sync() rank 0 writes top = i / Wb and left = i % Wb. No
// global scratch, no atomics.
//
// W-shard forms (the spatial route; kernels of their own, so the
// whole-image launches do not change). Shard j holds input columns [c0,
// c1) of a bucket Wb wide, and the shards' results equal the whole
// image's bit for bit:
//   rows (`itpu_saliency_rows_shard`): a block a row; each pixel's
//     saliency recomputed from its own and its four neighbours' RGB with
//     the functions above (luma is a function of the pixel alone), over
//     the shard's columns and per - 1 past each edge (per = ceil(Wb /
//     256), the whole row scan's segment width), reading input halos of
//     per columns from the neighbouring shards; then the serial total of
//     every segment that starts in the shard's columns (a segment may run
//     into the next shard's columns, which the extension holds).
//   scan (`itpu_saliency_scan_shard`, two launches): once every shard's
//     totals are exchanged, a block a row scans all of them with the
//     whole row kernel's tree (`scan_rows`) and writes the running sums of
//     the shard's own columns from its segments' exclusive prefixes (a
//     segment that starts in the left neighbour is rerun from there over
//     the extension); then `saliency_cols` on the shard's ii columns [c0 +
//     1, c1 + 1), which is column-local.
//   argmax (`itpu_window_argmax_shard`): K10 over the candidates whose
//     left lies in [c0, c1), from a window of ii columns (exchanged up to
//     the last candidate's left + win_w) of only the rows K10 reads: the
//     candidates' tops [0, nr) and bottoms [win_h, win_h + nr), two bands
//     of nr rows stacked; keyed by the global index, it writes the shard's
//     best key, and K4's shard form reduces the n keys.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kScan = 256;  // threads of a row block, the lanes of a row's scan
constexpr int kWarpTots = kScan / 32;
constexpr int kMaxG = 8;  // rows a band, at most one a warp
constexpr int kColW = 16;       // columns of a column block
constexpr int kColChunks = 16;  // row chunks per column
constexpr int kColThreads = kColW * kColChunks;
constexpr int kColBatch = 24;   // loads a thread keeps in flight
constexpr size_t kSmemMax = 232448;      // a block's shared memory
constexpr size_t kSmemBand = 96 * 1024;  // a band's, for two blocks an SM
constexpr int kArgThreads = 256;
constexpr int kArgWarps = kArgThreads / 32;
constexpr int kCluster = 8;  // blocks per image (the portable maximum)
constexpr int kArgPer = 4;   // candidates a lane scores per item
constexpr int kArgSpan = 32 * kArgPer;
constexpr int kMaxDevices = 64;

// Programmatic dependent launch: every kernel here is launched so that it
// may start before the kernel ahead of it in the stream has finished. It
// waits for that kernel's completion (and its memory) before it touches
// global memory, then lets the kernel behind it start.
__device__ __forceinline__ void await_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  return (float)(*p);
}

__device__ __forceinline__ float unit(float v) { return __fdiv_rn(v, 255.0f); }

// Rec.709 luma on the 0-1 scale, with the reference's operation order.
__device__ __forceinline__ float luma(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.2126f, r), __fmul_rn(0.7152f, g)),
                   __fmul_rn(0.0722f, b));
}

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

// The saturation term 1 * sat of the saliency sum.
__device__ __forceinline__ float sat_term(float r, float g, float b) {
  return __fmul_rn(1.0f, __fsub_rn(fmaxf(fmaxf(r, g), b), fminf(fminf(r, g), b)));
}

// The skin term 1.5 * skin of the saliency sum.
__device__ __forceinline__ float skin_term(float r, float g, float b) {
  const float d2 = __fadd_rn(__fadd_rn(sq(__fsub_rn(r, 0.78f)),
                                       sq(__fsub_rn(g, 0.57f))),
                             sq(__fsub_rn(b, 0.44f)));
  return __fmul_rn(1.5f, expf(__fdiv_rn(-d2, 0.025f)));
}

// (4 * edges + 1 * sat) + 1.5 * skin from the neighbours' luma.
__device__ __forceinline__ float saliency(float sat, float skin, float up,
                                          float down, float lf, float rt) {
  const float dy = fabsf(__fsub_rn(down, up));
  const float dx = fabsf(__fsub_rn(rt, lf));
  return __fadd_rn(__fadd_rn(__fmul_rn(4.0f, __fadd_rn(dx, dy)), sat), skin);
}

// Inclusive scans of G rows at once, one value of each a thread, over the
// block's kScan threads: a warp scan, then warp g scans row g's warp
// totals. Every thread of the block calls it (two block barriers).
template <int G>
__device__ __forceinline__ void scan_rows(float (&v)[G], float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float n = __shfl_up_sync(0xffffffffu, v[g], o);
      if (lane >= o) v[g] = __fadd_rn(v[g], n);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int g = 0; g < G; ++g) warp_tot[g * kWarpTots + warp] = v[g];
  }
  __syncthreads();
  if (warp < G) {
    float t = lane < kWarpTots ? warp_tot[warp * kWarpTots + lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = __fadd_rn(t, n);
    }
    if (lane < kWarpTots) warp_tot[warp * kWarpTots + lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      v[g] = __fadd_rn(v[g], warp_tot[g * kWarpTots + warp - 1]);
  }
}

// Shared memory of a band of G rows at bucket width wb: G + 2 luma rows,
// G rows each of the saturation term (then the saliency, then its running
// sums) and of the skin term, the warp totals and the segment sums.
__host__ __device__ __forceinline__ size_t band_smem(int G, int wb) {
  return ((size_t)(3 * G + 2) * wb + (size_t)G * (kWarpTots + kScan)) *
         sizeof(float);
}

// One block a band of G rows of one image; `vec`: f32 RGB rows read as
// 16-byte vectors (C == 3, wb % 4 == 0, `in` 16-byte aligned).
template <typename T, int G>
__global__ void __launch_bounds__(kScan)
    saliency_rows(const T* __restrict__ in, float* __restrict__ ii,
                  const int32_t* __restrict__ h, const int32_t* __restrict__ w,
                  int hb, int wb, int c, int vec) {
  extern __shared__ __align__(16) float smem[];
  await_previous_kernel();
  float* lum = smem;                 // [G + 2][wb]: rows y0 - 1 .. y0 + G
  float* sat = lum + (G + 2) * wb;   // [G][wb]
  float* skn = sat + G * wb;         // [G][wb]
  float* warp_tot = skn + G * wb;    // [G][kWarpTots]
  float* seg_incl = warp_tot + G * kWarpTots;  // [G][kScan]
  const int nbands = (hb + G - 1) / G;
  const int b = blockIdx.x / nbands;
  const int y0 = (blockIdx.x - b * nbands) * G;
  const int tid = threadIdx.x;
  const size_t ld = wb + 1;
  float* out0 = ii + ((size_t)b * (hb + 1) + y0 + 1) * ld;  // row y0 + 1
  const int ylim = min(h[b], hb), vw = w[b];
  const int rows = min(G, hb - y0);
  if (y0 >= ylim) {  // no valid row: the band's ii rows are zeros
    for (int i = tid; i < rows * (int)ld; i += kScan) out0[i] = 0.0f;
    return;
  }
  const T* img = in + (size_t)b * hb * wb * c;
  // the columns the valid pixels read (their right neighbour reaches
  // column vw) and the rows the band's valid rows read
  const int xl = min(vw + 1, wb);
  const int lrows = min(G + 2, ylim - y0 + 2);
  const int vcols = min(vw, wb);
  bool done = false;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int ng = (xl + 3) >> 2;
      const int n = lrows * ng;
      for (int base = tid; base < n; base += 2 * kScan) {
        float4 px[2][3];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int it = base + u * kScan;
          if (it < n) {
            const int j = it / ng, q = it - j * ng;
            const int yl = min(max(y0 - 1 + j, 0), hb - 1);
            const float4* p = reinterpret_cast<const float4*>(
                img + ((size_t)yl * wb + 4 * q) * 3);
            px[u][0] = __ldg(p);
            px[u][1] = __ldg(p + 1);
            px[u][2] = __ldg(p + 2);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int it = base + u * kScan;
          if (it < n) {
            const int j = it / ng, q = it - j * ng;
            const float v[12] = {px[u][0].x, px[u][0].y, px[u][0].z, px[u][0].w,
                                 px[u][1].x, px[u][1].y, px[u][1].z, px[u][1].w,
                                 px[u][2].x, px[u][2].y, px[u][2].z, px[u][2].w};
            float r[4], g[4], bl[4], l4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              r[k] = unit(v[3 * k]);
              g[k] = unit(v[3 * k + 1]);
              bl[k] = unit(v[3 * k + 2]);
              l4[k] = luma(r[k], g[k], bl[k]);
            }
            *reinterpret_cast<float4*>(lum + j * wb + 4 * q) =
                make_float4(l4[0], l4[1], l4[2], l4[3]);
            if (j >= 1 && j <= G && y0 + j - 1 < ylim && 4 * q < vcols) {
              float s4[4], k4[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                s4[k] = sat_term(r[k], g[k], bl[k]);
                k4[k] = skin_term(r[k], g[k], bl[k]);
              }
              *reinterpret_cast<float4*>(sat + (j - 1) * wb + 4 * q) =
                  make_float4(s4[0], s4[1], s4[2], s4[3]);
              *reinterpret_cast<float4*>(skn + (j - 1) * wb + 4 * q) =
                  make_float4(k4[0], k4[1], k4[2], k4[3]);
            }
          }
        }
      }
      done = true;
    }
  }
  if (!done) {  // a pixel a thread, four pixels' loads in flight
    const int n = lrows * xl;
    for (int base = tid; base < n; base += 4 * kScan) {
      float px[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kScan;
        if (it < n) {
          const int j = it / xl, x = it - j * xl;
          const int yl = min(max(y0 - 1 + j, 0), hb - 1);
          const T* p = img + ((size_t)yl * wb + x) * c;
          px[u][0] = load_f(p);
          px[u][1] = load_f(p + 1);
          px[u][2] = load_f(p + 2);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kScan;
        if (it < n) {
          const int j = it / xl, x = it - j * xl;
          const float r = unit(px[u][0]), g = unit(px[u][1]), bl = unit(px[u][2]);
          lum[j * wb + x] = luma(r, g, bl);
          if (j >= 1 && j <= G && y0 + j - 1 < ylim && x < vcols) {
            sat[(j - 1) * wb + x] = sat_term(r, g, bl);
            skn[(j - 1) * wb + x] = skin_term(r, g, bl);
          }
        }
      }
    }
  }
  __syncthreads();
  // the saliency of each band pixel, into the sat rows
  for (int it = tid; it < G * wb; it += kScan) {
    const int gr = it / wb, x = it - gr * wb;
    float s = 0.0f;
    if (y0 + gr < ylim && x < vcols) {
      const float* M = lum + (gr + 1) * wb;
      s = saliency(sat[it], skn[it], M[x - wb], M[x + wb], M[max(x - 1, 0)],
                   M[min(x + 1, wb - 1)]);
    }
    sat[it] = s;
  }
  __syncthreads();
  // the G rows' scans
  const int per = (wb + kScan - 1) / kScan;
  const int x0 = min(tid * per, wb), x1 = min(x0 + per, wb);
  float v[G];
#pragma unroll
  for (int gr = 0; gr < G; ++gr) {
    const float* row = sat + gr * wb;
    float tot = 0.0f;
    for (int x = x0; x < x1; ++x) tot = __fadd_rn(tot, row[x]);
    v[gr] = tot;
  }
  scan_rows<G>(v, warp_tot);
#pragma unroll
  for (int gr = 0; gr < G; ++gr) seg_incl[gr * kScan + tid] = v[gr];
  __syncthreads();
#pragma unroll
  for (int gr = 0; gr < G; ++gr) {
    // exclusive prefix of this segment: the previous segment's inclusive sum
    float run = tid > 0 ? seg_incl[gr * kScan + tid - 1] : 0.0f;
    float* row = sat + gr * wb;
    for (int x = x0; x < x1; ++x) {
      run = __fadd_rn(run, row[x]);
      row[x] = run;
    }
  }
  __syncthreads();
  for (int gr = 0; gr < rows; ++gr) {
    float* out = out0 + (size_t)gr * ld;
    const float* row = sat + gr * wb;
    for (int x = tid; x < wb; x += kScan) out[x + 1] = row[x];
    if (tid == 0) out[0] = 0.0f;
  }
}

// One block a strip of kColW columns of one image (blockIdx.y).
__global__ void __launch_bounds__(kColThreads)
    saliency_cols(float* __restrict__ ii, int hb, int wb) {
  __shared__ float tot[kColChunks][kColW];
  await_previous_kernel();
  const int cx = threadIdx.x % kColW, c = threadIdx.x / kColW;
  const int x = blockIdx.x * kColW + cx;
  const bool on = x <= wb;
  const int per = (hb + kColChunks - 1) / kColChunks;
  const int y0 = 1 + c * per, y1 = min(y0 + per, hb + 1);
  const size_t stride = wb + 1;
  float* col = ii + (size_t)blockIdx.y * (hb + 1) * stride + x;
  float v[kColBatch];
  float acc = 0.0f;
  if (on) {
    for (int base = y0; base < y1; base += kColBatch) {
#pragma unroll
      for (int k = 0; k < kColBatch; ++k)
        v[k] = base + k < y1 ? col[(size_t)(base + k) * stride] : 0.0f;
#pragma unroll
      for (int k = 0; k < kColBatch; ++k)
        if (base + k < y1) acc = __fadd_rn(acc, v[k]);
    }
  }
  tot[c][cx] = acc;
  __syncthreads();
  if (!on) return;
  if (c == 0) col[0] = 0.0f;
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < kColChunks - 1; ++k)
    if (k < c) run = __fadd_rn(run, tot[k][cx]);
  if (per <= kColBatch) {  // the chunk is still in v
#pragma unroll
    for (int k = 0; k < kColBatch; ++k) {
      if (y0 + k < y1) {
        run = __fadd_rn(run, v[k]);
        col[(size_t)(y0 + k) * stride] = run;
      }
    }
    return;
  }
  for (int base = y0; base < y1; base += kColBatch) {
#pragma unroll
    for (int k = 0; k < kColBatch; ++k)
      v[k] = base + k < y1 ? col[(size_t)(base + k) * stride] : 0.0f;
#pragma unroll
    for (int k = 0; k < kColBatch; ++k) {
      if (base + k < y1) {
        run = __fadd_rn(run, v[k]);
        col[(size_t)(base + k) * stride] = run;
      }
    }
  }
}

// Rec.709 luma of the pixel at p (0-1 scale), as the row kernel loads it.
template <typename T>
__device__ __forceinline__ float luma_at(const T* p) {
  return luma(unit(load_f(p)), unit(load_f(p + 1)), unit(load_f(p + 2)));
}

// The pixel at global column gx of row y of image b, from the shard x
// (columns [c0, c0 + lw)) or its halos (r columns each side).
template <typename T>
__device__ __forceinline__ const T* shard_px(const T* x, const T* left,
                                             const T* right, int b, int y,
                                             int gx, int hb, int lw, int r,
                                             int c, int c0) {
  if (gx < c0) return left + (((size_t)b * hb + y) * r + (gx - (c0 - r))) * c;
  if (gx >= c0 + lw) return right + (((size_t)b * hb + y) * r + (gx - c0 - lw)) * c;
  return x + (((size_t)b * hb + y) * lw + (gx - c0)) * c;
}

// The rows' shard form: grid (hb, B), kScan threads, ew floats of shared
// memory. sal: [B, hb, ew] over global columns [c0 - e, c0 + lw + e), e =
// per - 1 (0 outside the bucket); totals: [B, hb, nt], the segments g in
// [ceil(c0 / per), ceil((c0 + lw) / per)).
template <typename T>
__global__ void __launch_bounds__(kScan)
    saliency_rows_shard(const T* __restrict__ x, const T* __restrict__ left,
                        const T* __restrict__ right, float* __restrict__ sal,
                        float* __restrict__ totals,
                        const int32_t* __restrict__ h,
                        const int32_t* __restrict__ w, int hb, int lw, int c,
                        int c0, int wb, int per) {
  extern __shared__ float row[];
  await_previous_kernel();
  const int y = blockIdx.x, b = blockIdx.y;
  const int e = per - 1, ew = lw + 2 * e, r = per;
  const int ylim = min(h[b], hb), vcols = min(w[b], wb);
  const int yu = max(y - 1, 0), yd = min(y + 1, hb - 1);
  for (int k = threadIdx.x; k < ew; k += kScan) {
    const int gx = c0 - e + k;
    float s = 0.0f;
    if (y < ylim && gx >= 0 && gx < vcols) {
      const T* p = shard_px(x, left, right, b, y, gx, hb, lw, r, c, c0);
      const float rr = unit(load_f(p)), gg = unit(load_f(p + 1)),
                  bb = unit(load_f(p + 2));
      const float up = luma_at(shard_px(x, left, right, b, yu, gx, hb, lw, r, c, c0));
      const float dn = luma_at(shard_px(x, left, right, b, yd, gx, hb, lw, r, c, c0));
      const float lf = luma_at(shard_px(x, left, right, b, y, max(gx - 1, 0), hb,
                                        lw, r, c, c0));
      const float rt = luma_at(shard_px(x, left, right, b, y, min(gx + 1, wb - 1),
                                        hb, lw, r, c, c0));
      s = saliency(sat_term(rr, gg, bb), skin_term(rr, gg, bb), up, dn, lf, rt);
    }
    row[k] = s;
    sal[((size_t)b * hb + y) * ew + k] = s;
  }
  __syncthreads();
  const int g0 = (c0 + per - 1) / per, g1 = (c0 + lw + per - 1) / per;
  float* tot = totals + ((size_t)b * hb + y) * (g1 - g0);
  for (int g = g0 + threadIdx.x; g < g1; g += kScan) {
    const int x0 = g * per, x1 = min(x0 + per, wb);
    float t = 0.0f;
    for (int gx = x0; gx < x1; ++gx) t = __fadd_rn(t, row[gx - (c0 - e)]);
    tot[g - g0] = t;
  }
}

// The scan's shard form: grid (hb, B), kScan threads (thread g: segment
// g). totals: [B, hb, nt], every segment's; ii: [B, hb + 1, lw], rows 1..hb
// written here (global ii columns [c0 + 1, c0 + lw + 1)).
__global__ void __launch_bounds__(kScan)
    saliency_scan_shard(const float* __restrict__ sal,
                        const float* __restrict__ totals, float* __restrict__ ii,
                        int hb, int lw, int c0, int wb, int per, int nt) {
  __shared__ float warp_tot[kWarpTots];
  __shared__ float seg_incl[kScan];
  await_previous_kernel();
  const int y = blockIdx.x, b = blockIdx.y, g = threadIdx.x;
  const int e = per - 1, ew = lw + 2 * e;
  float v[1] = {g < nt ? totals[((size_t)b * hb + y) * nt + g] : 0.0f};
  scan_rows<1>(v, warp_tot);
  seg_incl[g] = v[0];
  __syncthreads();
  const int x0 = g * per, x1 = min(x0 + per, min(wb, c0 + lw));
  if (x1 <= c0) return;  // the segment ends before the shard's columns
  const float* srow = sal + ((size_t)b * hb + y) * ew - (c0 - e);
  float* out = ii + ((size_t)b * (hb + 1) + y + 1) * lw - c0;
  float run = g > 0 ? seg_incl[g - 1] : 0.0f;
  for (int gx = x0; gx < x1; ++gx) {
    run = __fadd_rn(run, srow[gx]);
    if (gx >= c0) out[gx] = run;
  }
}

__device__ __forceinline__ unsigned long long score_key(float s, int i) {
  if (s == 0.0f) s = 0.0f;  // -0 and +0 compare equal, as in the reference
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(~(unsigned int)i);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long n = __shfl_down_sync(0xffffffffu, v, o);
    v = n > v ? n : v;
  }
  return v;
}

// Launched with a cluster of kCluster blocks along x per image (blockIdx.y).
__global__ void __launch_bounds__(kArgThreads)
    window_argmax(const float* __restrict__ ii, const int32_t* __restrict__ h,
                  const int32_t* __restrict__ w,
                  const int32_t* __restrict__ win_h,
                  const int32_t* __restrict__ win_w, int32_t* __restrict__ top,
                  int32_t* __restrict__ left, int hb, int wb) {
  __shared__ unsigned long long warp_best[kArgWarps];
  __shared__ unsigned long long block_best[kCluster];  // rank 0's: each rank's
  cg::cluster_group cluster = cg::this_cluster();
  await_previous_kernel();
  // arrive now, wait before the first write to rank 0's shared memory: no
  // block writes there before every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* I = ii + (size_t)b * (hb + 1) * (wb + 1);
  const size_t ld = wb + 1;
  const int wh = win_h[b], wl = win_w[b];
  const int lim_t = h[b] - wh, lim_l = w[b] - wl;
  // the valid candidates: t <= lim_t, l <= lim_l inside the bucket
  const int nrows = lim_t < 0 ? 0 : min(lim_t, hb - 1) + 1;
  const int ncols = lim_l < 0 ? 0 : min(lim_l, wb - 1) + 1;
  const int nch = (ncols + kArgSpan - 1) / kArgSpan;
  const int items = nrows * nch;
  const int per = (items + kCluster - 1) / kCluster;
  const int i0 = min(rank * per, items), i1 = min(i0 + per, items);
  unsigned long long best = 0ull;
  for (int it = i0 + warp; it < i1; it += kArgWarps) {
    const int t = it / nch;
    const int l0 = (it - t * nch) * kArgSpan + lane;
    const float* rt = I + (size_t)t * ld;
    const float* rb = I + (size_t)min(max(t + wh, 0), hb) * ld;
    float rt_l[kArgPer], rt_r[kArgPer], rb_l[kArgPer], rb_r[kArgPer];
#pragma unroll
    for (int k = 0; k < kArgPer; ++k) {
      const int l = l0 + 32 * k;
      if (l < ncols) {
        const int right = min(max(l + wl, 0), wb);
        rt_l[k] = rt[l];
        rt_r[k] = rt[right];
        rb_l[k] = rb[l];
        rb_r[k] = rb[right];
      }
    }
#pragma unroll
    for (int k = 0; k < kArgPer; ++k) {
      const int l = l0 + 32 * k;
      if (l < ncols) {
        const float s = __fsub_rn(__fsub_rn(rb_r[k], rt_r[k]),
                                  __fsub_rn(rb_l[k], rt_l[k]));
        const unsigned long long key = score_key(s, t * wb + l);
        best = key > best ? key : best;
      }
    }
  }
  best = warp_max(best);
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    best = warp_max(lane < kArgWarps ? warp_best[lane] : 0ull);
    if (lane == 0) *cluster.map_shared_rank(&block_best[rank], 0) = best;
  }
  cluster.sync();  // every rank's best is in rank 0's shared memory
  if (rank == 0 && warp == 0) {
    best = warp_max(lane < kCluster ? block_best[lane] : 0ull);
    if (lane == 0) {
      // the first masked candidate in row-major order, if there is one
      int m = -1;
      if (lim_t < 0 || lim_l < 0) m = 0;
      else if (lim_l + 1 < wb) m = lim_l + 1;
      else if (lim_t + 1 < hb) m = (lim_t + 1) * wb;
      if (m >= 0) {
        const unsigned long long key = score_key(-1.0f, m);
        best = key > best ? key : best;
      }
      const int i = (int)(~(unsigned int)(best & 0xffffffffull));
      top[b] = i / wb;
      left[b] = i % wb;
    }
  }
}

// ii column g of a window holding ii columns [k0, k0 + kw); column 0 is
// zeros (a window starts at column 1 at the earliest).
__device__ __forceinline__ float ii_at(const float* row, int g, int k0) {
  return g < k0 ? 0.0f : row[g - k0];
}

// K10's shard form, launched as K10 is; the candidates whose left lies in
// [c0, c1), each keyed by its global index; rank 0 writes the best key.
// The window holds ii rows [0, nr) then [win_h, win_h + nr): candidate
// row t's top at row t, its bottom at row nr + t.
__global__ void __launch_bounds__(kArgThreads)
    window_argmax_shard(const float* __restrict__ iiw,
                        const int32_t* __restrict__ h,
                        const int32_t* __restrict__ w,
                        const int32_t* __restrict__ win_h,
                        const int32_t* __restrict__ win_w,
                        unsigned long long* __restrict__ keys, int hb, int wb,
                        int nr, int k0, int kw, int c0, int c1) {
  __shared__ unsigned long long warp_best[kArgWarps];
  __shared__ unsigned long long block_best[kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  await_previous_kernel();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* I = iiw + (size_t)b * 2 * nr * kw;
  const int wh = win_h[b], wl = win_w[b];
  const int lim_t = h[b] - wh, lim_l = w[b] - wl;
  const int nrows = lim_t < 0 ? 0 : min(min(lim_t, hb - 1) + 1, nr);
  const int ncols = lim_l < 0 ? 0 : min(lim_l, wb - 1) + 1;
  const int nloc = max(min(c1, ncols) - c0, 0);
  const int nch = (nloc + kArgSpan - 1) / kArgSpan;
  const int items = nrows * nch;
  const int per = (items + kCluster - 1) / kCluster;
  const int i0 = min(rank * per, items), i1 = min(i0 + per, items);
  unsigned long long best = 0ull;
  for (int it = i0 + warp; it < i1; it += kArgWarps) {
    const int t = it / nch;
    const int l0 = c0 + (it - t * nch) * kArgSpan + lane;
    const float* rt = I + (size_t)t * kw;
    const float* rb = I + (size_t)(nr + t) * kw;
    float rt_l[kArgPer], rt_r[kArgPer], rb_l[kArgPer], rb_r[kArgPer];
#pragma unroll
    for (int k = 0; k < kArgPer; ++k) {
      const int l = l0 + 32 * k;
      if (l < c0 + nloc) {
        const int right = min(max(l + wl, 0), wb);
        rt_l[k] = ii_at(rt, l, k0);
        rt_r[k] = ii_at(rt, right, k0);
        rb_l[k] = ii_at(rb, l, k0);
        rb_r[k] = ii_at(rb, right, k0);
      }
    }
#pragma unroll
    for (int k = 0; k < kArgPer; ++k) {
      const int l = l0 + 32 * k;
      if (l < c0 + nloc) {
        const float s = __fsub_rn(__fsub_rn(rb_r[k], rt_r[k]),
                                  __fsub_rn(rb_l[k], rt_l[k]));
        const unsigned long long key = score_key(s, t * wb + l);
        best = key > best ? key : best;
      }
    }
  }
  best = warp_max(best);
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    best = warp_max(lane < kArgWarps ? warp_best[lane] : 0ull);
    if (lane == 0) *cluster.map_shared_rank(&block_best[rank], 0) = best;
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
    best = warp_max(lane < kCluster ? block_best[lane] : 0ull);
    if (lane == 0) {
      // the whole image's first masked candidate, added by every shard
      int m = -1;
      if (lim_t < 0 || lim_l < 0) m = 0;
      else if (lim_l + 1 < wb) m = lim_l + 1;
      else if (lim_t + 1 < hb) m = (lim_t + 1) * wb;
      if (m >= 0) {
        const unsigned long long key = score_key(-1.0f, m);
        best = key > best ? key : best;
      }
      keys[b] = best;
    }
  }
}

// The launch attributes of every kernel here: programmatic stream
// serialization, and the cluster dimension when `cluster` > 1.
struct Launch {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  Launch(dim3 grid, int threads, size_t smem, cudaStream_t s, int cluster = 1) {
    cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.numAttrs = 1;
    if (cluster > 1) {
      attr[1].id = cudaLaunchAttributeClusterDimension;
      attr[1].val.clusterDim.x = cluster;
      attr[1].val.clusterDim.y = 1;
      attr[1].val.clusterDim.z = 1;
      cfg.numAttrs = 2;
    }
  }
};

std::mutex g_mu;
int g_sms[kMaxDevices];         // the card's SMs, 0 until read
int g_cluster_ok[kMaxDevices];  // 0 unknown, 1 a cluster fits, -1 not
int g_shard_cluster_ok[kMaxDevices];  // the same for K10's shard form

// Whether a cluster of `kernel` fits on the current card (cached in ok[]).
int cluster_fits(const void* kernel, const cudaLaunchConfig_t& cfg, int* ok) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (ok[dev] == 0) {
    cudaLaunchConfig_t one = cfg;
    one.gridDim = dim3(kCluster, 1);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &one);
    if (e != cudaSuccess) return (int)e;
    ok[dev] = clusters > 0 ? 1 : -1;
  }
  return ok[dev] < 0 ? (int)cudaErrorLaunchOutOfResources : 0;
}

template <typename T, int G>
int launch_rows(const T* in, float* ii, const int32_t* h, const int32_t* w,
                int B, int hb, int wb, int c, int vec, cudaStream_t s, int dev) {
  const size_t smem = band_smem(G, wb);
  if (smem > 48 * 1024) {  // above the default limit: raise it once
    static int raised[kMaxDevices];
    std::lock_guard<std::mutex> lock(g_mu);
    if (!raised[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          (const void*)saliency_rows<T, G>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = 1;
    }
  }
  const int bands = B * ((hb + G - 1) / G);
  Launch l(dim3(bands), kScan, smem, s);
  return (int)cudaLaunchKernelEx(&l.cfg, saliency_rows<T, G>, in, ii, h, w, hb,
                                 wb, c, vec);
}

template <typename T>
int rows_for(const T* in, float* ii, const int32_t* h, const int32_t* w,
             int B, int hb, int wb, int c, int vec, cudaStream_t s, int dev) {
  const int sms = g_sms[dev];
  // the tallest band that fits kSmemBand and still gives two blocks an
  // SM; else one row a band
  int G = 1;
  for (int g = kMaxG; g > 1; g >>= 1) {
    if (band_smem(g, wb) <= kSmemBand && B * ((hb + g - 1) / g) >= 2 * sms) {
      G = g;
      break;
    }
  }
  if (band_smem(G, wb) > kSmemMax) return (int)cudaErrorInvalidValue;
  switch (G) {
    case 8: return launch_rows<T, 8>(in, ii, h, w, B, hb, wb, c, vec, s, dev);
    case 4: return launch_rows<T, 4>(in, ii, h, w, B, hb, wb, c, vec, s, dev);
    case 2: return launch_rows<T, 2>(in, ii, h, w, B, hb, wb, c, vec, s, dev);
    default: return launch_rows<T, 1>(in, ii, h, w, B, hb, wb, c, vec, s, dev);
  }
}

}  // namespace

// in: [B, hb, wb, c] (uint8 when in_u8, else f32), c >= 3; ii: f32
// [B, hb + 1, wb + 1]; h, w: int32 [B] valid dims. Two launches: the rows,
// then the columns.
extern "C" int itpu_saliency_ii(const void* in, int in_u8, float* ii,
                                const int32_t* h, const int32_t* w, int B,
                                int hb, int wb, int c, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_sms[dev]) {
      e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
    }
  }
  const int vec = !in_u8 && c == 3 && wb % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const int err = in_u8 ? rows_for(static_cast<const uint8_t*>(in), ii, h, w, B,
                                   hb, wb, c, 0, s, dev)
                        : rows_for(static_cast<const float*>(in), ii, h, w, B,
                                   hb, wb, c, vec, s, dev);
  if (err != 0) return err;
  Launch l(dim3((wb + kColW) / kColW, B), kColThreads, 0, s);
  return (int)cudaLaunchKernelEx(&l.cfg, saliency_cols, ii, hb, wb);
}

// ii: f32 [B, hb + 1, wb + 1]; h, w, win_h, win_w: int32 [B]; top, left:
// int32 [B] outputs. One launch of B clusters; returns an error, and
// launches nothing, when a cluster cannot be resident on the card.
extern "C" int itpu_window_argmax(const float* ii, const int32_t* h,
                                  const int32_t* w, const int32_t* win_h,
                                  const int32_t* win_w, int32_t* top,
                                  int32_t* left, int B, int hb, int wb,
                                  void* stream) {
  if (B == 0) return 0;
  Launch l(dim3(kCluster, B), kArgThreads, 0, static_cast<cudaStream_t>(stream),
           kCluster);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (g_cluster_ok[dev] == 0) {
      cudaLaunchConfig_t one = l.cfg;
      one.gridDim = dim3(kCluster, 1);
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)window_argmax,
                                         &one);
      if (e != cudaSuccess) return (int)e;
      g_cluster_ok[dev] = clusters > 0 ? 1 : -1;
    }
    if (g_cluster_ok[dev] < 0) return (int)cudaErrorLaunchOutOfResources;
  }
  return (int)cudaLaunchKernelEx(&l.cfg, window_argmax, ii, h, w, win_h, win_w,
                                 top, left, hb, wb);
}

// K9's row pass on a W-shard. in: [B, hb, lw, c] (uint8 when in_u8, else
// f32), c >= 3, global columns [c0, c0 + lw) of a bucket wb wide; left,
// right: [B, hb, per, c] in in's dtype, the per columns past each edge
// (null outside the bucket); sal: f32 [B, hb, lw + 2 (per - 1)]; totals:
// f32 [B, hb, ceil((c0 + lw) / per) - ceil(c0 / per)]; per = ceil(wb /
// 256). One launch.
extern "C" int itpu_saliency_rows_shard(const void* in, int in_u8,
                                        const void* left, const void* right,
                                        float* sal, float* totals,
                                        const int32_t* h, const int32_t* w,
                                        int B, int hb, int lw, int c, int c0,
                                        int wb, int per, void* stream) {
  if (B == 0 || hb == 0) return 0;
  if (B > 65535 || per < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(lw + 2 * (per - 1)) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  Launch l(dim3(hb, B), kScan, smem, static_cast<cudaStream_t>(stream));
  if (in_u8)
    return (int)cudaLaunchKernelEx(
        &l.cfg, saliency_rows_shard<uint8_t>, static_cast<const uint8_t*>(in),
        static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
        sal, totals, h, w, hb, lw, c, c0, wb, per);
  return (int)cudaLaunchKernelEx(
      &l.cfg, saliency_rows_shard<float>, static_cast<const float*>(in),
      static_cast<const float*>(left), static_cast<const float*>(right), sal,
      totals, h, w, hb, lw, c, c0, wb, per);
}

// K9's scan and column pass on a W-shard. sal: the row pass's; totals: f32
// [B, hb, nt], every shard's segment totals side by side; ii: f32 [B, hb +
// 1, lw]. Two launches: the scan, then the columns.
extern "C" int itpu_saliency_scan_shard(const float* sal, const float* totals,
                                        float* ii, int B, int hb, int lw,
                                        int c0, int wb, int per, int nt,
                                        void* stream) {
  if (B == 0 || hb == 0) return 0;
  if (B > 65535 || nt > kScan || per < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Launch l(dim3(hb, B), kScan, 0, s);
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, saliency_scan_shard, sal,
                                           totals, ii, hb, lw, c0, wb, per, nt);
  if (e != cudaSuccess) return (int)e;
  // the columns of [B, hb + 1, lw] as an ii of width lw - 1
  Launch lc(dim3((lw - 1 + kColW) / kColW, B), kColThreads, 0, s);
  return (int)cudaLaunchKernelEx(&lc.cfg, saliency_cols, ii, hb, lw - 1);
}

// K10 on a W-shard. iiw: f32 [B, 2 nr, kw], ii columns [k0, k0 + kw) of an
// image bucket hb x wb (k0 >= 1; column 0 reads 0), ii rows [0, nr) then
// [win_h, win_h + nr); the candidates' lefts [c0, c1); keys: uint64 [B],
// the shard's best. One launch of B clusters.
extern "C" int itpu_window_argmax_shard(const float* iiw, const int32_t* h,
                                        const int32_t* w, const int32_t* win_h,
                                        const int32_t* win_w,
                                        unsigned long long* keys, int B, int hb,
                                        int wb, int nr, int k0, int kw, int c0,
                                        int c1, void* stream) {
  if (B == 0) return 0;
  if (k0 < 1 || nr < 1) return (int)cudaErrorInvalidValue;
  Launch l(dim3(kCluster, B), kArgThreads, 0, static_cast<cudaStream_t>(stream),
           kCluster);
  const int err = cluster_fits((const void*)window_argmax_shard, l.cfg,
                               g_shard_cluster_ok);
  if (err != 0) return err;
  return (int)cudaLaunchKernelEx(&l.cfg, window_argmax_shard, iiw, h, w, win_h,
                                 win_w, keys, hb, wb, nr, k0, kw, c0, c1);
}
