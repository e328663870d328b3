// K1: separable resample, both axes in one launch.
//
// Replaces: imaginary_tpu/ops/stages.py:46-116 (`sample_matrix` +
// `SampleSpec.apply`), which builds a dense [B, out, in] weight matrix per
// axis and contracts it with two batched einsums (H first, then W), and
// the Pallas `resample_rows` / `resample_2d` that once fused the same
// function (imaginary_tpu/ops/pallas_kernels.py:136/:151 before commit
// 6fc8717).
//
// Bound on the H100: memory. At config 3's 4K shape it reads 31.5 MB of
// uint8 and writes 11.3 MB of f32, against ~0.46 GFLOP of f32 FMA: far
// below the ~20 FLOP/byte where the CUDA cores' f32 rate would take over,
// so the work stays on the CUDA cores in IEEE f32 (no tensor cores).
//
// Design: a block walks a contiguous range of TH x TW tiles of output
// rows x columns (two resident blocks an SM, every block an equal share),
// and the H-contracted intermediate never leaves the SM.
//  - Tap tables: each tile's row and column taps (k_lo, k_hi, centre and
//    the renormalisation sum, one warp a position, summed in a fixed
//    order) and each position's normalised weights, evaluated once, in
//    shared memory (positions with more than NTAP taps, an extreme
//    downscale, evaluate them again where a chunk needs them). Tiles are
//    walked column tile first, then row tile, then image, and a table
//    (with the band's transposed row weights, and a lone column chunk's
//    weights) is kept while its position and its image's dims stay the
//    same. Weights
//    are f32 in the JAX order (dst/src, then (o+0.5)/scale-0.5, then
//    (k-centre)/stretch), which is what keeps nearest's half-open
//    [-0.5, 0.5) box deciding exactly like the reference; the kept taps
//    are exactly the dense matrix's non-zero set (|k - centre| inside the
//    support plus a one-tap margin, each tap re-testing the kernel's own
//    condition, k < src, o < dst).
//  - The input band a tile needs (the union of its taps, valid pixels
//    only: taps at k >= src are never read) is walked in chunks of at
//    most KW input columns and as many whole rows as fill a stage buffer,
//    so shared memory stays bounded at any scale (an extreme downscale's
//    band spans the whole image). Each chunk is copied as it is, in
//    coalesced 16-byte vectors (cp.async), into shared memory while the
//    block reduces the chunk before it; the uint8 cast is fused into the
//    reads of the H contraction.
//  - H contraction: a warp owns four output rows, a lane every 64th of
//    the chunk's columns, in registers across every row chunk; per
//    input row that reaches any of the four rows, one staged value a
//    column times the four rows' weights (zero outside a row's own taps,
//    so adding it leaves a sum unchanged, and each sum runs over
//    ascending k). The sums go to shared memory once per column chunk;
//    the W contraction then adds that chunk's taps, in ascending k, into
//    registers: a lane owns one output column, two rows and their C
//    channels, all sharing one tap range.
//  - Rows and columns at or past dst (and positions whose weights sum to
//    at most 1e-6) are written as 0; the chain's clip(x + 0.5) uint8
//    epilogue is fused into the store; the tile at the origin of each
//    image writes int32(dst_h) and int32(dst_w) as the stage's output
//    dims.
//  - W-shard form (the spatial route, ops/chain.py `launch_spatial`): the
//    output may be columns [out_x0, out_x0 + out_wb) of an output bucket
//    out_wg wide, and the input columns [in_x0, in_x0 + in_w) of an input
//    bucket in_wg wide (the union of those columns' taps, staged alone).
//    Taps, weights and sums are computed on global columns exactly as
//    for the whole image, and each output's sums run over ascending k, so
//    a shard's columns equal the unsharded kernel's bit for bit. A tile
//    that overhangs the shard's last column gives the overhang no taps,
//    so no tile reads input past the window.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kEps = 1e-6f;
constexpr int TH = 16;   // output rows a tile
constexpr int TW = 32;   // output columns a tile
constexpr int KRMAX = 64;  // input rows a staged chunk, at most
constexpr int WYROWS = 128;  // input rows whose row weights wyT holds
constexpr int SBUF = 22 * 1024;  // bytes a stage buffer
constexpr int KW = 128;  // input columns a staged chunk
constexpr int NT = 256;  // threads a block
constexpr int MAXC = 4;
constexpr int NTAP = 64; // taps a position whose weights the prologue keeps
static_assert(TW * 8 == NT, "column weights: eight threads a column");
constexpr int HI = KW * MAXC / 64;  // chunk columns a lane, at most
static_assert(TH == 16 && NT == 256, "H contraction: four rows a warp, two warps a row group");
static_assert(TW == 32 && 2 * (NT / 32) == TH, "W contraction: a lane a column, two rows a warp");

enum Kind { LANCZOS3 = 0, LANCZOS2 = 1, CUBIC = 2, LINEAR = 3, NEAREST = 4 };

__device__ __forceinline__ float sinc(float x) {
  // jnp.sinc: normalised, sinc(0) = 1
  if (x == 0.0f) return 1.0f;
  const float px = kPi * x;
  return sinf(px) / px;
}

__device__ __forceinline__ float kernel_weight(int kind, float d) {
  const float ad = fabsf(d);
  switch (kind) {
    case LANCZOS3:
      return ad < 3.0f ? sinc(d) * sinc(d / 3.0f) : 0.0f;
    case LANCZOS2:
      return ad < 2.0f ? sinc(d) * sinc(d / 2.0f) : 0.0f;
    case CUBIC: {
      const float a = -0.5f;
      const float ad2 = ad * ad, ad3 = ad2 * ad;
      if (ad <= 1.0f) return (a + 2.0f) * ad3 - (a + 3.0f) * ad2 + 1.0f;
      if (ad < 2.0f) return a * ad3 - 5.0f * a * ad2 + 8.0f * a * ad - 4.0f * a;
      return 0.0f;
    }
    case LINEAR:
      return fmaxf(0.0f, 1.0f - ad);
    default:  // NEAREST: the tap whose cell holds the centre
      return (d >= -0.5f && d < 0.5f) ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ float support(int kind) {
  switch (kind) {
    case LANCZOS3: return 3.0f;
    case LANCZOS2:
    case CUBIC: return 2.0f;
    case LINEAR: return 1.0f;
    default: return 0.5f;
  }
}

// One output position's taps: [lo, hi] (hi < lo: none, the position is
// written as 0), its centre and its weights' sum.
struct Taps {
  int lo, hi;
  float centre, norm;
};

__device__ __forceinline__ float tap_weight(int kind, int k, const Taps& t,
                                            float stretch) {
  return kernel_weight(kind, ((float)k - t.centre) / stretch) /
         fmaxf(t.norm, kEps);
}

// Fills t[0, N) for output positions o0 + i along one axis, a warp for
// every eighth position, and tab[i * NTAP + k - lo] with the normalised
// weights of positions with at most NTAP taps; returns the axis' stretch
// (every thread computes it). A warp's positions run interleaved: lane l
// holds taps lo + l, lo + l + 32, ... of each, summed in that order.
template <int N>
__device__ float axis_taps(Taps* t, float* tab, int o0, int src, float dst,
                           int in_n, int out_n, int kind) {
  constexpr int PW = N / (NT / 32);
  const float srcf = fmaxf((float)src, 1.0f);
  const float dstf = fmaxf(dst, 1.0f);
  const float scale = dstf / srcf;
  const float stretch = fmaxf(1.0f, 1.0f / scale);
  const float reach = support(kind) * stretch;
  const int last = min(in_n, (int)srcf) - 1;  // taps at k >= src weigh 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float centre[PW], part[PW];
  int lo[PW], hi[PW];
#pragma unroll
  for (int p = 0; p < PW; p++) {
    const int o = o0 + warp + p * (NT / 32);
    centre[p] = ((float)o + 0.5f) / scale - 0.5f;
    // one tap of margin each side; each tap re-tests the exact condition
    lo[p] = max((int)floorf(centre[p] - reach) - 1, 0);
    hi[p] = min((int)ceilf(centre[p] + reach) + 1, last);
    if (!((float)o < dstf) || o >= out_n) hi[p] = lo[p] - 1;
    part[p] = 0.0f;
  }
#pragma unroll
  for (int p = 0; p < PW; p++) {
    float* row = tab + (warp + p * (NT / 32)) * NTAP - lo[p];
    const bool keep_w = hi[p] - lo[p] < NTAP;
    for (int k = lo[p] + lane; k <= hi[p]; k += 32) {
      const float wv = kernel_weight(kind, ((float)k - centre[p]) / stretch);
      if (keep_w) row[k] = wv;
      part[p] += wv;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int p = 0; p < PW; p++) part[p] += __shfl_xor_sync(0xffffffffu, part[p], off);
#pragma unroll
  for (int p = 0; p < PW; p++) {
    const int i = warp + p * (NT / 32);
    if (!(part[p] > kEps)) hi[p] = lo[p] - 1;
    if (hi[p] - lo[p] < NTAP) {  // each lane normalises the weights it wrote
      float* row = tab + i * NTAP - lo[p];
      for (int k = lo[p] + lane; k <= hi[p]; k += 32) row[k] = row[k] / fmaxf(part[p], kEps);
    }
    if (lane == 0) t[i] = Taps{lo[p], hi[p], centre[p], part[p]};
  }
  return stretch;
}

// Normalised weight of tap k of a position (its table entry, or evaluated
// again for a position with more than NTAP taps).
__device__ __forceinline__ float weight_of(const Taps& t, const float* row,
                                           int kind, int k, float stretch) {
  return t.hi - t.lo < NTAP ? row[k - t.lo] : tap_weight(kind, k, t, stretch);
}

// 16 bytes from global to shared memory without passing through
// registers (sm_80+), completed by cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
// exact for 0..255: the byte as the mantissa of 2^23, minus 2^23 (no I2F)
__device__ __forceinline__ float to_f32(uint8_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// Dynamic shared memory: two stage buffers of SBUF bytes (rows of the
// input, in its own type), then f32 mid [TH, KW*C + 1], wx [TW, KW + 1],
// wyT [WYROWS, TH], tabY [TH, NTAP], tabX [TW, NTAP].
//
// A block walks a contiguous range of tiles, numbered column tile first,
// then row tile, then image, so that consecutive tiles share a column
// tile (and, across the images of a batch with equal dims, a row tile):
// the tap tables and the band are kept while their position and dims
// stay. A tile's band is cut into chunks of whole rows that fill a stage
// buffer (column chunk, then row chunk), run as a two-stage pipeline:
// chunk c + 1 is copied with cp.async while chunk c is reduced.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(NT, 2)
resample_tiles(const TIn* __restrict__ in, TOut* __restrict__ out,
               const int32_t* __restrict__ src_h, const int32_t* __restrict__ src_w,
               const float* __restrict__ dst_h, const float* __restrict__ dst_w,
               int32_t* __restrict__ h_out, int32_t* __restrict__ w_out,
               int B, int in_h, int in_w, int out_hb, int out_wb, int C, int kind,
               int tiles_y, int n_tiles, int in_x0, int in_wg, int out_x0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SZ = (int)sizeof(TIn);
  const int KWC = KW * C, MS = KWC + 1, WS = KW + 1;
  unsigned char* stage = smem_raw;  // two buffers of SBUF bytes
  float* mid = reinterpret_cast<float*>(smem_raw + 2 * SBUF);
  float* wx = mid + TH * MS;
  float* wyT = wx + TW * WS;
  float* tabY = wyT + WYROWS * TH;
  float* tabX = tabY + TH * NTAP;
  __shared__ Taps rows[TH], cols[TW];
  __shared__ int s_band[4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // H contraction: rows 4g..4g+3, chunk columns j = jbase + 64 i
  const int g = warp & 3, jbase = (warp >> 2) * 32 + lane;
  // W contraction: column tx, rows ty_a and ty_b, C channels
  const int tx = lane, ty_a = warp, ty_b = warp + TH / 2;
  // byte offset from one input row to the next, modulo a 16-byte vector
  const int pitch16 = (int)(((size_t)in_w * C * SZ) & 15u);

  const int t_begin = (int)((long long)n_tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)n_tiles * (blockIdx.x + 1) / gridDim.x);
  int key_ry = -1, key_sh = 0, key_cx = -1, key_sw = 0;
  float key_dh = 0.0f, key_dw = 0.0f, sty = 1.0f, stx = 1.0f;
  int ry_lo = 0, ry_hi = -1, cx_lo = 0, cx_hi = -1, glo = INT_MAX, ghi = -1;
  // wyT holds the whole row band's weights, wx the one column chunk's,
  // while the tables they came from stay
  bool wy_kept = false, wx_kept = false;
  int nb = t_begin < t_end ? t_begin % B : 0;  // the next tile's image and dims
  int n_sh = 0, n_sw = 0;
  float n_dh = 0.0f, n_dw = 0.0f;
  if (t_begin < t_end) {
    n_sh = src_h[nb]; n_sw = src_w[nb]; n_dh = dst_h[nb]; n_dw = dst_w[nb];
  }
  for (int t = t_begin; t < t_end; t++) {
    const int cx = t / (tiles_y * B);
    const int rem = t - cx * tiles_y * B;
    const int ry = rem / B, b = rem - ry * B;
    const int y0 = ry * TH, x0 = cx * TW;
    const int sh = n_sh, sw = n_sw;
    const float dh = n_dh, dw = n_dw;
    if (t + 1 < t_end) {  // prefetch the next tile's dims
      nb = (t + 1) % B;
      n_sh = src_h[nb]; n_sw = src_w[nb]; n_dh = dst_h[nb]; n_dw = dst_w[nb];
    }
    if (cx == 0 && ry == 0 && tid == 0) {
      h_out[b] = (int32_t)dh;
      w_out[b] = (int32_t)dw;
    }
    // the previous tile ended on a barrier, so the tables are free
    const bool new_rows = ry != key_ry || sh != key_sh || dh != key_dh;
    const bool new_cols = cx != key_cx || sw != key_sw || dw != key_dw;
    if (new_rows) {
      sty = axis_taps<TH>(rows, tabY, y0, sh, dh, in_h, out_hb, kind);
      key_ry = ry; key_sh = sh; key_dh = dh;
      wy_kept = false;
    }
    if (new_cols) {
      // columns past the shard's end take no taps, so the band stays
      // inside the staged input window
      stx = axis_taps<TW>(cols, tabX, out_x0 + x0, sw, dw, in_wg, out_x0 + out_wb, kind);
      key_cx = cx; key_sw = sw; key_dw = dw;
      wx_kept = false;
    }
    if (new_rows || new_cols) {
      __syncthreads();
      if (warp < 2) {  // the tile's input band: the union of its taps
        const Taps tp = warp == 0 ? rows[lane & (TH - 1)] : cols[lane];
        const bool ok = tp.hi >= tp.lo && (warp == 1 || lane < TH);
        const int lo = __reduce_min_sync(0xffffffffu, ok ? tp.lo : INT_MAX);
        const int hi = __reduce_max_sync(0xffffffffu, ok ? tp.hi : -1);
        if (lane == 0) {
          s_band[2 * warp] = lo;
          s_band[2 * warp + 1] = hi;
        }
      }
      __syncthreads();
      ry_lo = s_band[0]; ry_hi = s_band[1];
      cx_lo = s_band[2]; cx_hi = s_band[3];
      glo = INT_MAX; ghi = -1;  // input rows that reach group g's rows
#pragma unroll
      for (int q = 0; q < 4; q++) {
        const Taps tp = rows[4 * g + q];
        if (tp.hi >= tp.lo) {
          glo = min(glo, tp.lo);
          ghi = max(ghi, tp.hi);
        }
      }
    }
    const bool any = ry_hi >= ry_lo && cx_hi >= cx_lo;
    // a chunk's rows: as many as fill a stage buffer with the widest
    // column chunk (each row holds its aligned 16-byte vectors)
    const int rowb = any ? ((min(KW, cx_hi - cx_lo + 1) * C * SZ + 30) & ~15) : 16;
    const int krc = min(KRMAX, SBUF / rowb);
    const int nry = any ? (ry_hi - ry_lo + krc) / krc : 0;
    const int ncx = (cx_hi - cx_lo + KW) / KW;
    const int n_chunks = any ? nry * ncx : 0;
    // the row weights of the whole band when it fits, else of each chunk
    const bool wy_whole = ry_hi - ry_lo < WYROWS;

    // chunk c: columns from kx0 (nc of them), rows from ky0 (nr of them)
    auto copy_chunk = [&](int c) {
      const int kx0 = cx_lo + (c / nry) * KW, ky0 = ry_lo + (c % nry) * krc;
      const int nc = min(KW, cx_hi - kx0 + 1), nr = min(krc, ry_hi - ky0 + 1);
      const int nbytes = nc * C * SZ;
      unsigned char* buf = stage + (c & 1) * SBUF;
      for (int r = warp; r < nr; r += NT / 32) {
        const TIn* p = in + (((size_t)b * in_h + ky0 + r) * in_w + kx0 - in_x0) * C;
        const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
        const int lead = (int)(pa & 15u);
        const unsigned char* a0 = reinterpret_cast<const unsigned char*>(pa - lead);
        const int nvec = (lead + nbytes + 15) >> 4;
        for (int v = lane; v < nvec; v += 32) cp_async16(buf + r * rowb + 16 * v, a0 + 16 * v);
      }
      cp_async_commit();
    };

    float oa[MAXC] = {0.0f, 0.0f, 0.0f, 0.0f}, ob[MAXC] = {0.0f, 0.0f, 0.0f, 0.0f};
    float h[HI][4];
    if (n_chunks > 0) copy_chunk(0);
    for (int c = 0; c < n_chunks; c++) {
      const int ryi = c % nry;
      const int kx0 = cx_lo + (c / nry) * KW, ky0 = ry_lo + ryi * krc;
      const int nc = min(KW, cx_hi - kx0 + 1), nr = min(krc, ry_hi - ky0 + 1);
      const int nkxc = nc * C;
      if (ryi == 0) {  // a new column chunk
        if (!wx_kept) {  // its weights, eight threads a column
          const int c8 = tid >> 3;
          const Taps tp = cols[c8];
          const float* row = tabX + c8 * NTAP;
          const int k1 = min(tp.hi, kx0 + nc - 1);
          for (int k = max(tp.lo, kx0) + (tid & 7); k <= k1; k += 8)
            wx[c8 * WS + (k - kx0)] = weight_of(tp, row, kind, k, stx);
          wx_kept = ncx == 1;
        }
#pragma unroll
        for (int i = 0; i < HI; i++)
#pragma unroll
          for (int q = 0; q < 4; q++) h[i][q] = 0.0f;
      }
      // row weights from input row wy_k0 on, transposed, zero outside each
      // row's taps (a thread's entries share a row)
      const int wy_k0 = wy_whole ? ry_lo : ky0;
      if (!wy_kept) {
        const int n_wy = wy_whole ? ry_hi - ry_lo + 1 : nr;
        const Taps tp = rows[tid % TH];
        const float* row = tabY + (tid % TH) * NTAP;
        for (int e = tid; e < n_wy * TH; e += NT) {
          const int k = wy_k0 + e / TH;
          wyT[e] = (k >= tp.lo && k <= tp.hi) ? weight_of(tp, row, kind, k, sty) : 0.0f;
        }
        wy_kept = wy_whole;
      }
      const float* wy = wyT + (ky0 - wy_k0) * TH;
      if (c + 1 < n_chunks) {
        copy_chunk(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c's stage, wy and wx are in place
      // H contraction: the chunk's rows that reach group g, ascending k
      const unsigned char* buf = stage + (c & 1) * SBUF;
      const int lead0 = (int)(reinterpret_cast<uintptr_t>(
                                  in + (((size_t)b * in_h + ky0) * in_w + kx0 - in_x0) * C) &
                                  15u);
      const int r0 = max(glo, ky0) - ky0, r1 = min(ghi, ky0 + nr - 1) - ky0;
#pragma unroll 2
      for (int r = r0; r <= r1; r++) {
        const TIn* srow = reinterpret_cast<const TIn*>(
            buf + r * rowb + ((lead0 + r * pitch16) & 15));
        const float4 w = reinterpret_cast<const float4*>(wy + r * TH)[g];
#pragma unroll
        for (int i = 0; i < HI; i++) {
          const int j = jbase + 64 * i;
          if (j < nkxc) {
            const float v = to_f32(srow[j]);
            h[i][0] += w.x * v; h[i][1] += w.y * v;
            h[i][2] += w.z * v; h[i][3] += w.w * v;
          }
        }
      }
      if (ryi == nry - 1) {  // the column chunk's last row chunk
#pragma unroll
        for (int i = 0; i < HI; i++) {
          const int j = jbase + 64 * i;
#pragma unroll
          for (int q = 0; q < 4; q++)
            if (j < nkxc) mid[(4 * g + q) * MS + j] = h[i][q];
        }
        __syncthreads();  // mid is complete
        // W contraction of the column chunk, ascending k
        const Taps tp = cols[tx];
        const int k0 = max(tp.lo, kx0), k1 = min(tp.hi, kx0 + nc - 1);
        const float* w = wx + tx * WS - kx0;
        const float* ma = mid + ty_a * MS - kx0 * C;
        const float* mb = mid + ty_b * MS - kx0 * C;
#pragma unroll 4
        for (int k = k0; k <= k1; k++) {
          const float wv = w[k];
#pragma unroll
          for (int ch = 0; ch < MAXC; ch++) {
            if (ch < C) {
              oa[ch] += wv * ma[k * C + ch];
              ob[ch] += wv * mb[k * C + ch];
            }
          }
        }
      }
      __syncthreads();  // chunk c's buffers, mid and wx are free again
    }

    const int x = x0 + tx;
    const bool col_live = cols[tx].hi >= cols[tx].lo;
#pragma unroll
    for (int second = 0; second < 2; second++) {
      const int ty = second ? ty_b : ty_a;
      const int y = y0 + ty;
      if (y >= out_hb || x >= out_wb) continue;
      const bool live = col_live && rows[ty].hi >= rows[ty].lo;
      TOut* q = out + (((size_t)b * out_hb + y) * out_wb + x) * C;
#pragma unroll
      for (int ch = 0; ch < MAXC; ch++)
        if (ch < C) store(q + ch, live ? (second ? ob[ch] : oa[ch]) : 0.0f);
    }
    __syncthreads();  // the next tile may rewrite the tables
  }
}

constexpr int MAXDEV = 64;  // devices whose SM count the host caches

// Dynamic shared memory a block takes for C channels.
constexpr size_t smem_bytes(int C) {
  return 2 * (size_t)SBUF +
         sizeof(float) * ((size_t)TH * (KW * C + 1) + (size_t)TW * (KW + 1) +
                          (size_t)WYROWS * TH + (size_t)(TH + TW) * NTAP);
}

// Each device's SM count, read on its first launch (0: not read yet).
std::atomic<int> g_sms[MAXDEV];

template <typename TIn, typename TOut>
int launch(const void* in, void* out, const int32_t* src_h,
           const int32_t* src_w, const float* dst_h, const float* dst_w,
           int32_t* h_out, int32_t* w_out, int B, int in_h, int in_w,
           int out_hb, int out_wb, int C, int kind, int in_x0, int in_wg,
           int out_x0, cudaStream_t stream) {
  // whether this instance's shared-memory ceiling is raised on each device
  static std::atomic<bool> smem_set[MAXDEV];
  const int tiles_x = (out_wb + TW - 1) / TW, tiles_y = (out_hb + TH - 1) / TH;
  const long long n_tiles = (long long)tiles_x * tiles_y * B;
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAXDEV) return (int)cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  auto fn = resample_tiles<TIn, TOut>;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    // once a device, at the most any C takes (over the default 48 KB)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(MAXC));
    if (e != cudaSuccess) return (int)e;
    smem_set[dev].store(true, std::memory_order_release);
  }
  // two resident blocks an SM, each walking an equal share of the tiles
  const int grid = (int)std::min<long long>(n_tiles, 2LL * sms);
  const size_t smem = smem_bytes(C);
  fn<<<grid, NT, smem, stream>>>(static_cast<const TIn*>(in),
                                 static_cast<TOut*>(out), src_h, src_w, dst_h,
                                 dst_w, h_out, w_out, B, in_h, in_w, out_hb,
                                 out_wb, C, kind, tiles_y, (int)n_tiles, in_x0,
                                 in_wg, out_x0);
  return (int)cudaGetLastError();
}

}  // namespace

// in [B, in_h, in_w, C] (uint8 if in_u8 else f32), out [B, out_hb,
// out_wb, C] (uint8 with the epilogue if out_u8 else f32), C 1 to 4.
// src_h, src_w: int32 [B] valid input dims; dst_h, dst_w: f32 [B] target
// dims; h_out, w_out: int32 [B] receiving int(dst). W-shard form: `in`
// holds input columns [in_x0, in_x0 + in_w) of a bucket in_wg wide and
// `out` output columns [out_x0, out_x0 + out_wb) of a bucket out_wg wide
// (the whole image: 0, in_w, 0, out_wb); the caller makes the input
// columns cover every tap of those outputs. Returns the CUDA error code
// of the launch (0 = launched).
extern "C" int itpu_resample(const void* in, int in_u8, void* out, int out_u8,
                             const int32_t* src_h, const int32_t* src_w,
                             const float* dst_h, const float* dst_w,
                             int32_t* h_out, int32_t* w_out, int B, int in_h,
                             int in_w, int out_hb, int out_wb, int C, int kind,
                             int in_x0, int in_wg, int out_x0, int out_wg,
                             void* stream) {
  if (B <= 0 || in_h <= 0 || in_w <= 0 || out_hb <= 0 || out_wb <= 0) return 0;
  if (C < 1 || C > MAXC || in_x0 < 0 || in_x0 + in_w > in_wg || out_x0 < 0 ||
      out_x0 + out_wb > out_wg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch<uint8_t, uint8_t>(in, out, src_h, src_w, dst_h, dst_w, h_out,
                                    w_out, B, in_h, in_w, out_hb, out_wb, C,
                                    kind, in_x0, in_wg, out_x0, s);
  if (in_u8)
    return launch<uint8_t, float>(in, out, src_h, src_w, dst_h, dst_w, h_out,
                                  w_out, B, in_h, in_w, out_hb, out_wb, C, kind,
                                  in_x0, in_wg, out_x0, s);
  if (out_u8)
    return launch<float, uint8_t>(in, out, src_h, src_w, dst_h, dst_w, h_out,
                                  w_out, B, in_h, in_w, out_hb, out_wb, C, kind,
                                  in_x0, in_wg, out_x0, s);
  return launch<float, float>(in, out, src_h, src_w, dst_h, dst_w, h_out, w_out,
                              B, in_h, in_w, out_hb, out_wb, C, kind, in_x0,
                              in_wg, out_x0, s);
}
