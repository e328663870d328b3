// K5: orientation of a batch of padded images (flip, flop, transpose).
//
// Replaces: imaginary_tpu/ops/stages.py:201-234 (`FlipSpec.apply`,
// `FlopSpec.apply`, `TransposeSpec.apply`).
//
// Function, for x [B, Hb, Wb, C] (C = 1..4) with per-image valid dims
// h, w (int32 [B]):
//   mode 0 flip:      out[b, y, x] = x[b, y < h ? h - 1 - y : y, x]
//   mode 1 flop:      out[b, y, x] = x[b, y, x < w ? w - 1 - x : x]
//   mode 2 transpose: out[b, x, y] = x[b, y, x], out is [B, Wb, Hb, C]
// Flip and flop mirror inside each image's own valid height or width and
// copy the bucket padding beyond it unchanged (not zeroed): a later stage
// may read that padding (the packed 4:2:0 pack computes Y over the whole
// bucket). Transpose swaps the whole bucket, padding included.
//
// Bound on the H100: memory. The kernel does no arithmetic; every element
// is read once and written once. On the /rotate path at 1080p, f32
// [1, 1152, 2048, 3] reads and writes 28.31 MB each: 16.9 us per image at
// 3.35 TB/s, 0.54 ms at B = 32 (f32 [1, 1088, 1920, 3]: 25.07 MB each way,
// 15.0 us, 0.48 ms at B = 32).
//
// Design:
// - flip and flop: one block row per image row, one thread per element of
//   the row (Wb * C elements). Reads and writes stay row-contiguous: flip
//   reads another whole row, flop reads the same row with the pixel order
//   reversed inside it, so a warp's reads stay within the same few
//   128-byte segments as its writes.
// - transpose: 32 x 32-pixel tiles (times C channels) staged through
//   shared memory as f32, the tile row padded by one element, so both the
//   global reads (along x) and the global writes (along y of the input)
//   are contiguous runs of 32 * C elements.
// - uint8 input (the RGB transport's first stage) is cast on load, and a
//   uint8 output (a chain's last stage) applies the chain's clip(x + 0.5)
//   epilogue on store, as in the gather kernel, so neither needs a launch
//   of its own.
//
// W-shard form of the flop (`itpu_flop_shard`, the spatial route), a
// kernel of its own so the whole-image launches do not change: a shard
// writes output columns [col0, col0 + lw) from the in_wl columns it holds
// (its window, exchanged from the shards that hold them: the mirrored
// input columns from in_col0, then the shard's own padding columns, which
// end the window); global column g reads w - 1 - g inside the valid width
// and g in the padding, as the whole image's flop does. The flip's shard form is the whole
// kernel on the shard (column-local); the transpose's is the whole kernel
// on the row band the shard assembled from every shard.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kRows = 8;
constexpr int kMaxC = 4;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// grid: x = B * Hb rows, y = ceil(Wb * C / kThreads); block: kThreads.
template <typename TIn, typename TOut>
__global__ void mirror(const TIn* __restrict__ in, TOut* __restrict__ out,
                       const int32_t* __restrict__ h,
                       const int32_t* __restrict__ w, int flop, int Hb,
                       int Wb, int C) {
  const int row = blockIdx.x;
  const int b = row / Hb;
  const int y = row - b * Hb;
  const int row_len = Wb * C;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= row_len) return;
  int src_y = y;
  int src_e = e;
  if (flop) {
    const int ww = w[b];
    const int x = e / C;
    if (x < ww) src_e = (ww - 1 - x) * C + (e - x * C);
  } else {
    const int hh = h[b];
    if (y < hh) src_y = hh - 1 - y;
  }
  const TIn* src = in + ((size_t)b * Hb + src_y) * row_len;
  store(out + (size_t)row * row_len + e, load(src + src_e));
}

// The flop's shard form. grid: x = B * Hb rows, y = ceil(lw * C /
// kThreads); block: kThreads.
template <typename TIn, typename TOut>
__global__ void flop_shard(const TIn* __restrict__ in, TOut* __restrict__ out,
                           const int32_t* __restrict__ w, int Hb, int in_wl,
                           int lw, int C, int col0, int in_col0) {
  const int row = blockIdx.x;
  const int b = row / Hb;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= lw * C) return;
  const int x = e / C;
  const int g = col0 + x;
  const int ww = w[b];
  // a padding column sits lw - x columns before the window's end
  const int src = g < ww ? ww - 1 - g - in_col0 : in_wl - lw + x;
  const TIn* p = in + (size_t)row * in_wl * C + (size_t)src * C + (e - x * C);
  store(out + (size_t)row * lw * C + e, load(p));
}

// grid: x = ceil(Wb / kTile), y = ceil(Hb / kTile), z = B;
// block: (kTile, kRows).
template <typename TIn, typename TOut>
__global__ void transpose(const TIn* __restrict__ in, TOut* __restrict__ out,
                          int Hb, int Wb, int C) {
  __shared__ float tile[kTile][kTile * kMaxC + 1];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tw = min(kTile, Wb - x0);  // pixels of this tile along x
  const int th = min(kTile, Hb - y0);  // and along y
  const TIn* src = in + (size_t)b * Hb * Wb * C;
  const int run_in = tw * C;
  for (int r = threadIdx.y; r < th; r += kRows) {
    const TIn* row = src + ((size_t)(y0 + r) * Wb + x0) * C;
    for (int e = threadIdx.x; e < run_in; e += kTile) tile[r][e] = load(row + e);
  }
  __syncthreads();
  TOut* dst = out + (size_t)b * Wb * Hb * C;
  const int run_out = th * C;
  for (int r = threadIdx.y; r < tw; r += kRows) {  // output row x0 + r
    TOut* row = dst + ((size_t)(x0 + r) * Hb + y0) * C;
    for (int e = threadIdx.x; e < run_out; e += kTile) {
      const int yy = e / C;
      store(row + e, tile[yy][r * C + (e - yy * C)]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* in, void* out, const int32_t* h, const int32_t* w,
           int mode, int B, int Hb, int Wb, int C, cudaStream_t stream) {
  const TIn* x = static_cast<const TIn*>(in);
  TOut* y = static_cast<TOut*>(out);
  if (mode == 2) {
    dim3 grid((Wb + kTile - 1) / kTile, (Hb + kTile - 1) / kTile, B);
    transpose<TIn, TOut><<<grid, dim3(kTile, kRows), 0, stream>>>(x, y, Hb,
                                                                  Wb, C);
  } else {
    dim3 grid((unsigned)B * Hb, (Wb * C + kThreads - 1) / kThreads);
    mirror<TIn, TOut><<<grid, kThreads, 0, stream>>>(x, y, h, w, mode == 1,
                                                     Hb, Wb, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in: [B, Hb, Wb, C] (uint8 if in_u8 else f32); out: [B, Hb, Wb, C], or
// [B, Wb, Hb, C] for the transpose (uint8 with the epilogue if out_u8,
// else f32). h, w: int32 [B] valid dims (read by flip and flop). mode:
// 0 flip, 1 flop, 2 transpose. Returns the launch's CUDA error code.
extern "C" int itpu_orient(const void* in, int in_u8, void* out, int out_u8,
                           const int32_t* h, const int32_t* w, int mode,
                           int B, int Hb, int Wb, int C, void* stream) {
  if (C < 1 || C > kMaxC || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch<uint8_t, uint8_t>(in, out, h, w, mode, B, Hb, Wb, C, s);
  if (in_u8)
    return launch<uint8_t, float>(in, out, h, w, mode, B, Hb, Wb, C, s);
  if (out_u8)
    return launch<float, uint8_t>(in, out, h, w, mode, B, Hb, Wb, C, s);
  return launch<float, float>(in, out, h, w, mode, B, Hb, Wb, C, s);
}

// The flop's W-shard form. in: [B, Hb, in_wl, C], the mirrored input
// columns from in_col0, then the shard's padding columns; out: [B, Hb, lw, C], output columns [col0, col0 + lw)
// (uint8 with the epilogue if out_u8, else f32); w: int32 [B] valid widths.
// Returns the launch's CUDA error code.
extern "C" int itpu_flop_shard(const void* in, int in_u8, void* out, int out_u8,
                               const int32_t* w, int B, int Hb, int in_wl,
                               int lw, int C, int col0, int in_col0,
                               void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * lw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)B * Hb, (lw * C + kThreads - 1) / kThreads);
  if (in_u8 && out_u8)
    flop_shard<uint8_t, uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), w, Hb,
        in_wl, lw, C, col0, in_col0);
  else if (in_u8)
    flop_shard<uint8_t, float><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), w, Hb,
        in_wl, lw, C, col0, in_col0);
  else if (out_u8)
    flop_shard<float, uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(in), static_cast<uint8_t*>(out), w, Hb,
        in_wl, lw, C, col0, in_col0);
  else
    flop_shard<float, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), w, Hb, in_wl,
        lw, C, col0, in_col0);
  return (int)cudaGetLastError();
}
