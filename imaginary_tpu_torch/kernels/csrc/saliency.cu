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
//   pass 1 (rows): one block per (image, row) computes the row's saliency
//     from luma rows y-1, y and y+1, clamped at the *bucket* edge (the
//     reference's edge replication reads the padding next to the valid
//     region), into shared memory, then scans it (each thread a contiguous
//     segment, then a block scan of the segment totals) and writes
//     ii[b, y+1, 1:] plus the zero ii[b, y+1, 0].
//   pass 2 (columns): scans down the columns of ii in place, a warp across
//     32 neighbouring columns so its reads and writes are coalesced; each
//     column is cut into 16 row chunks (one thread each) whose totals are
//     scanned in shared memory, and row 0 is written as zeros.
// The sums run along W first, then H; the reference sums H first. The
// result therefore matches it to a relative tolerance, not exactly.
//
// K10 bound: launch latency at config 4's shapes (it reads ii, 0.8 MB an
// image, four times from L2). Design: one launch; each block scores a
// chunk of candidate offsets (t, l) in row-major order with the
// reference's exact f32 expression (subtractions only, so nothing is
// contracted), masks candidates whose window leaves the valid region to
// -1, and keeps the largest 64-bit key: the order-preserving bits of the
// score above ~index, so equal scores keep the smallest index, as
// jnp.argmax keeps the first maximum. Blocks merge with atomicMax into a
// per-image key; the last block of each image (an atomic counter) writes
// top = i / Wb and left = i % Wb and clears the key and counter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kColW = 32;       // columns per column-pass block
constexpr int kColChunks = 16;  // row chunks per column
constexpr int kArgThreads = 256;
constexpr int kChunk = 4096;  // candidates per K10 block

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  return (float)(*p);
}

// Rec.709 luma of pixel p (channels 0..2), on the 0-1 scale, with the
// reference's operation order and no contraction.
template <typename T>
__device__ __forceinline__ float luma(const T* p) {
  const float r = __fdiv_rn(load_f(p), 255.0f);
  const float g = __fdiv_rn(load_f(p + 1), 255.0f);
  const float b = __fdiv_rn(load_f(p + 2), 255.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(0.2126f, r), __fmul_rn(0.7152f, g)),
                   __fmul_rn(0.0722f, b));
}

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

template <typename T>
__device__ __forceinline__ float saliency_at(const T* img, int y, int x,
                                             int hb, int wb, int c) {
  const T* p = img + ((size_t)y * wb + x) * c;
  const float r = __fdiv_rn(load_f(p), 255.0f);
  const float g = __fdiv_rn(load_f(p + 1), 255.0f);
  const float b = __fdiv_rn(load_f(p + 2), 255.0f);
  const int ym = max(y - 1, 0), yp = min(y + 1, hb - 1);
  const int xm = max(x - 1, 0), xp = min(x + 1, wb - 1);
  const float dy = fabsf(__fsub_rn(luma(img + ((size_t)yp * wb + x) * c),
                                   luma(img + ((size_t)ym * wb + x) * c)));
  const float dx = fabsf(__fsub_rn(luma(img + ((size_t)y * wb + xp) * c),
                                   luma(img + ((size_t)y * wb + xm) * c)));
  const float edges = __fadd_rn(dx, dy);
  const float sat = __fsub_rn(fmaxf(fmaxf(r, g), b), fminf(fminf(r, g), b));
  const float d2 = __fadd_rn(__fadd_rn(sq(__fsub_rn(r, 0.78f)),
                                       sq(__fsub_rn(g, 0.57f))),
                             sq(__fsub_rn(b, 0.44f)));
  const float skin = expf(__fdiv_rn(-d2, 0.025f));
  return __fadd_rn(__fadd_rn(__fmul_rn(4.0f, edges), __fmul_rn(1.0f, sat)),
                   __fmul_rn(1.5f, skin));
}

// Inclusive block scan of one float per thread (kRowThreads threads).
__device__ __forceinline__ float block_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = __fadd_rn(v, n);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRowThreads / 32 ? warp_tot[lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = __fadd_rn(t, n);
    }
    if (lane < kRowThreads / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  return warp > 0 ? __fadd_rn(v, warp_tot[warp - 1]) : v;
}

template <typename T>
__global__ void saliency_rows(const T* __restrict__ in,
                              float* __restrict__ ii,
                              const int32_t* __restrict__ h,
                              const int32_t* __restrict__ w, int hb, int wb,
                              int c) {
  extern __shared__ float row[];  // wb floats
  __shared__ float warp_tot[kRowThreads / 32];
  __shared__ float seg_incl[kRowThreads];
  const int y = blockIdx.x, b = blockIdx.y;
  const T* img = in + (size_t)b * hb * wb * c;
  const int vh = h[b], vw = w[b];
  for (int x = threadIdx.x; x < wb; x += blockDim.x)
    row[x] = (y < vh && x < vw) ? saliency_at(img, y, x, hb, wb, c) : 0.0f;
  __syncthreads();
  const int per = (wb + kRowThreads - 1) / kRowThreads;
  const int x0 = min((int)threadIdx.x * per, wb), x1 = min(x0 + per, wb);
  float tot = 0.0f;
  for (int x = x0; x < x1; ++x) tot = __fadd_rn(tot, row[x]);
  seg_incl[threadIdx.x] = block_scan(tot, warp_tot);
  __syncthreads();
  // exclusive prefix of this segment: the previous segment's inclusive sum
  float run = threadIdx.x > 0 ? seg_incl[threadIdx.x - 1] : 0.0f;
  float* out = ii + ((size_t)b * (hb + 1) + y + 1) * (wb + 1);
  for (int x = x0; x < x1; ++x) {
    run = __fadd_rn(run, row[x]);
    row[x] = run;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < wb; x += blockDim.x) out[x + 1] = row[x];
  if (threadIdx.x == 0) out[0] = 0.0f;
}

// Blocks of kColW columns x kColChunks row chunks: each thread sums its
// chunk of one column, the chunk totals are scanned down the column in
// shared memory, and each thread rewrites its chunk as running sums from
// its chunk's prefix, so a column's serial depth is a chunk, not Hb.
__global__ void saliency_cols(float* __restrict__ ii, int hb, int wb) {
  __shared__ float tot[kColChunks][kColW];
  const int x = blockIdx.x * kColW + threadIdx.x;
  const int c = threadIdx.y, b = blockIdx.y;
  const int per = (hb + kColChunks - 1) / kColChunks;
  const int y0 = 1 + c * per, y1 = min(y0 + per, hb + 1);
  const size_t stride = wb + 1;
  float* col = ii + (size_t)b * (hb + 1) * stride + x;
  float acc = 0.0f;
  if (x <= wb) {
    for (int y = y0; y < y1; ++y) acc = __fadd_rn(acc, col[y * stride]);
  }
  tot[c][threadIdx.x] = acc;
  __syncthreads();
  if (x > wb) return;
  if (c == 0) col[0] = 0.0f;
  float run = 0.0f;
  for (int k = 0; k < c; ++k) run = __fadd_rn(run, tot[k][threadIdx.x]);
  for (int y = y0; y < y1; ++y) {
    run = __fadd_rn(run, col[y * stride]);
    col[y * stride] = run;
  }
}

__device__ __forceinline__ unsigned long long score_key(float s, int i) {
  if (s == 0.0f) s = 0.0f;  // -0 and +0 compare equal, as in the reference
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(~(unsigned int)i);
}

__global__ void window_argmax(const float* __restrict__ ii,
                              const int32_t* __restrict__ h,
                              const int32_t* __restrict__ w,
                              const int32_t* __restrict__ win_h,
                              const int32_t* __restrict__ win_w,
                              unsigned long long* keys, unsigned int* counts,
                              int32_t* __restrict__ top,
                              int32_t* __restrict__ left, int hb, int wb) {
  __shared__ unsigned long long warp_best[kArgThreads / 32];
  const int b = blockIdx.y;
  const float* I = ii + (size_t)b * (hb + 1) * (wb + 1);
  const size_t ld = wb + 1;
  const int wh = win_h[b], wl = win_w[b];
  const int lim_t = h[b] - wh, lim_l = w[b] - wl;
  const int n = hb * wb;
  const int i0 = blockIdx.x * kChunk, i1 = min(i0 + kChunk, n);
  unsigned long long best = 0ull;
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int t = i / wb, l = i - t * wb;
    float s = -1.0f;
    if (t <= lim_t && l <= lim_l) {
      const int bot = min(max(t + wh, 0), hb);
      const int right = min(max(l + wl, 0), wb);
      const float rb_r = I[bot * ld + right], rt_r = I[t * ld + right];
      const float rb_l = I[bot * ld + l], rt_l = I[t * ld + l];
      s = __fsub_rn(__fsub_rn(rb_r, rt_r), __fsub_rn(rb_l, rt_l));
    }
    const unsigned long long k = score_key(s, i);
    best = k > best ? k : best;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long n2 = __shfl_down_sync(0xffffffffu, best, o);
    best = n2 > best ? n2 : best;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kArgThreads / 32; ++k)
      best = warp_best[k] > best ? warp_best[k] : best;
    atomicMax(&keys[b], best);
    __threadfence();
    const unsigned int done = atomicAdd(&counts[b], 1u);
    if (done == gridDim.x - 1) {  // the image's last block: every max is in
      const unsigned long long k = atomicMax(&keys[b], 0ull);
      const int i = (int)(~(unsigned int)(k & 0xffffffffull));
      top[b] = i / wb;
      left[b] = i % wb;
      keys[b] = 0ull;
      counts[b] = 0u;
    }
  }
}

}  // namespace

// in: [B, hb, wb, c] (uint8 when in_u8, else f32), c >= 3; ii: f32
// [B, hb + 1, wb + 1]; h, w: int32 [B] valid dims. Two launches.
extern "C" int itpu_saliency_ii(const void* in, int in_u8, float* ii,
                                const int32_t* h, const int32_t* w, int B,
                                int hb, int wb, int c, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // wb <= 8192 on the bucket ladder: the row fits the default 48 KB
  const size_t smem = (size_t)wb * sizeof(float);
  const dim3 rows(hb, B);
  if (in_u8)
    saliency_rows<uint8_t><<<rows, kRowThreads, smem, s>>>(
        static_cast<const uint8_t*>(in), ii, h, w, hb, wb, c);
  else
    saliency_rows<float><<<rows, kRowThreads, smem, s>>>(
        static_cast<const float*>(in), ii, h, w, hb, wb, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 cols((wb + 1 + kColW - 1) / kColW, B);
  saliency_cols<<<cols, dim3(kColW, kColChunks), 0, s>>>(ii, hb, wb);
  return (int)cudaGetLastError();
}

// ii: f32 [B, hb + 1, wb + 1]; h, w, win_h, win_w: int32 [B]; scratch:
// 2 * B zeroed 64-bit words (the keys, then the block counters); top,
// left: int32 [B] outputs. One launch; it leaves the scratch zeroed.
extern "C" int itpu_window_argmax(const float* ii, const int32_t* h,
                                  const int32_t* w, const int32_t* win_h,
                                  const int32_t* win_w, void* scratch,
                                  int32_t* top, int32_t* left, int B, int hb,
                                  int wb, void* stream) {
  if (B == 0) return 0;
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  unsigned int* counts = reinterpret_cast<unsigned int*>(keys + B);
  const dim3 grid((hb * wb + kChunk - 1) / kChunk, B);
  window_argmax<<<grid, kArgThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ii, h, w, win_h, win_w, keys, counts, top, left, hb, wb);
  return (int)cudaGetLastError();
}
