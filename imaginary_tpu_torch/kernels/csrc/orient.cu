// K5: orientation of a batch of padded images, any run of flip, flop and
// transpose stages in one launch (the eight symmetries of the square, D4).
//
// Replaces: imaginary_tpu/ops/stages.py:201-234 (`FlipSpec.apply`,
// `FlopSpec.apply`, `TransposeSpec.apply`), applied in the sequences
// imaginary_tpu/ops/plan.py:296-340 emits (rotate=90: transpose, flop;
// rotate=180: flip, flop; EXIF 7: transpose, flip, flop; ...).
//
// Function, for x [B, Hb, Wb, C] (C = 1..4) with per-image valid dims h, w
// (int32 [B]) and a mode (t, fy, fx), each a bit:
//   out is [B, Ho, Wo, C] = t ? [B, Wb, Hb, C] : [B, Hb, Wb, C], with valid
//   dims (ho, wo) = t ? (w, h) : (h, w);
//   my(y) = fy && y < ho ? ho - 1 - y : y   (rows mirrored inside ho)
//   mx(x) = fx && x < wo ? wo - 1 - x : x   (columns mirrored inside wo)
//   out[b, y, x] = t ? x[b, mx(x), my(y)] : x[b, my(y), mx(x)]
// Padding beyond the valid dims is copied as it is (not zeroed): a later
// stage may read it (the packed 4:2:0 pack computes Y over the whole
// bucket). The transpose swaps the whole bucket, padding included.
// flip is (0, 1, 0), flop (0, 0, 1), transpose (1, 0, 0). A run of stages
// composes into one mode (`reference.compose_orient`): a flip toggles fy,
// a flop toggles fx, a transpose toggles t and swaps fy and fx (a mirror
// pushed past the transpose lands on the other axis). Two mirrors on one
// axis cancel, so (0, 0, 0) is a copy.
//
// Bound on the H100: memory. No arithmetic; every mode reads each input
// element once and writes each output element once, B * Hb * Wb * C
// elements each way. On the /rotate path at 1080p, f32 [1, 1152, 2048, 3]
// moves 28.31 MB each way: 16.9 us per image at 3.35 TB/s, 0.5409 ms at
// B = 32, for rotate=90 (1, 0, 1) and rotate=180 (0, 1, 1) alike. Run as
// two launches (the stages one by one), the same rotation writes its f32
// intermediate and reads it back: twice the bytes, 1.082 ms at B = 32.
//
// What held the earlier kernel back, and what each path does about it:
// - It ran each stage as a launch of its own (above); a run is one launch.
// - Its mirror moved one 4-byte element a thread, in blocks that each moved
//   1 KB of one row (884,736 blocks at B = 32): a thread had one load in
//   flight, ~8 KB an SM, under what HBM3 needs to stay busy, and each flop
//   element paid an integer division by a runtime C.
// - Its transpose staged 32 x 32-pixel tiles with one load a thread in
//   flight, and read its tile [32][32 C + 1] with 2- to 3-way bank
//   conflicts at C = 3.
//
// Design. C is a template parameter (divisions by it are multiplies), and
// both kernels are programmatic dependents of the kernel before them
// (launch.cuh), so their launch latency overlaps its tail.
// - Modes that do not transpose (`orient_rows`; flip, flop, rotate=180 and
//   the copy): an output row reads one source row, my(y), with its columns
//   mirrored inside the valid width. A block takes a segment of kSeg
//   elements of one output row; each thread issues all kU of its loads
//   (lanes on consecutive elements, so a warp's loads fall in the same
//   128-byte lines as its stores, reversed inside the mirror) before its
//   first store: 8 KB in flight a block, up to 64 KB an SM. The grid has
//   one block a segment. (On an H100 80GB HBM3 at /rotate's B = 32, a
//   persistent grid of one wave of resident blocks, each walking segments
//   in a loop, reached 72-79 % of the bound: a thread's next loads wait
//   for its last ones to be stored. This grid reaches 90 %, the
//   transposing tiles 87-89 %.)
// - Modes that transpose (`orient_tiles`; transpose, rotate=90 and 270,
//   EXIF 5-8): tiles of kTR output columns (input rows) by kTP output rows
//   (input pixels). The mirrors fold into which input row each tile row
//   reads (mx) and which input pixel each tile column holds (my): the tile
//   is staged in output order, tile[r][i * C + c] = x[mx(x0 + r), my(y0 +
//   i), c], so a tile that straddles a valid edge needs no path of its own.
//   Each warp loads four tile rows, lanes on consecutive elements, every
//   load issued before the first is stored (96 bytes in flight a thread at
//   f32 C = 3); then each warp writes output rows, lanes on consecutive
//   elements, reading tile[e / C][i * C + e % C]. The tile's row stride is
//   65 C floats, congruent to C modulo the 32 banks, so that read touches
//   word e + i C + const (32 lanes, 32 banks) and the loads' writes
//   consecutive words: no bank conflicts for C = 1..4. At C = 4 the tile
//   takes 33.3 KB of the SM's shared memory.
// - uint8 input (the RGB transport's first stage) is cast on load, and a
//   uint8 output (a chain's last stage) applies the chain's clip(x + 0.5)
//   epilogue on store, as in the gather kernel, so neither needs a launch
//   of its own.
//
// Why 4-byte loads and stores, not 16-byte vectors. scripts/orient_vec.cu
// holds f32 variants with float4 loads and stores (scripts/orient_vec_ab.py
// times them against this kernel in turns). On an H100 80GB HBM3 (700 W)
// at /rotate's f32 [32, 1152, 2048, 3]: a segment loaded as float4 into
// shared memory, reversed there and stored as float4 took 0.5972-0.5983 ms
// against this kernel's 0.5977-0.5991 (B = 1: 0.0195-0.0198 against
// 0.0201-0.0208); groups of 4 pixels in registers, C float4 a thread with
// lanes 16 C bytes apart, 0.6846-0.6884 (15 % slower); tiles loaded and
// stored as float4 0.6083-0.6181 against 0.6100-0.6133. One library copy of
// the same bytes (`Tensor.copy_`) takes 0.5952 ms, 91 % of the bound: the
// modes that keep the axes are within 0.5 % of it and the transposing ones
// within 3 %, so the vectors buy no time here, and would need a second path
// for rows that are not 16-byte aligned, uint8 and the shard form.
//
// W-shard form of the flop (`itpu_flop_shard`, the spatial route): the rows
// kernel with the shard's column offsets. A shard writes output columns
// [col0, col0 + lw) from the in_wl columns it holds (its window, exchanged
// from the shards that hold them: the mirrored input columns from in_col0,
// then the shard's own padding columns, which end the window); global
// column g reads w - 1 - g inside the valid width and g in the padding, as
// the whole image's flop does. The flip's shard form is the whole kernel
// on the shard (column-local); the transpose's is the whole kernel on the
// row band the shard assembled from every shard. The spatial route keeps
// one launch a stage on its shards.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 4;
// orient_rows: loads in flight a thread, and a block's segment of a row
constexpr int kU = 8;
constexpr int kSeg = kThreads * kU;
// orient_tiles: output columns (input rows) and output rows (input pixels)
// of a tile; tile rows a warp loads
constexpr int kTR = 32;
constexpr int kTP = 64;
constexpr int kRowsPerWarp = kTR / kWarps;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

__device__ __forceinline__ int mirror(int on, int v, int n) {
  return on && v < n ? n - 1 - v : v;
}

// Modes without the transpose, and the flop's shard form. grid: x = B * Hb
// output rows (out_wl pixels each; the source rows are in_wl pixels) times
// `segs` segments of kSeg elements a row, one a block. Output column x
// (global column g = col0 + x) reads source column w - 1 - g - in_col0
// where fx mirrors it, else x + pad_shift (the whole image: col0 = in_col0
// = pad_shift = 0).
template <typename TIn, typename TOut, int C>
__global__ void __launch_bounds__(kThreads)
orient_rows(const TIn* __restrict__ in, TOut* __restrict__ out,
            const int32_t* __restrict__ h, const int32_t* __restrict__ w,
            int fy, int fx, int Hb, int in_wl, int out_wl, int col0,
            int in_col0, int pad_shift, int segs) {
  await_previous_kernel();
  const int row_len = out_wl * C;
  const int row = blockIdx.x / segs;  // b * Hb + y
  const int e0 = (blockIdx.x - row * segs) * kSeg + threadIdx.x;
  const int b = row / Hb;
  const int y = row - b * Hb;
  const int ww = w[b];
  const TIn* src = in + ((size_t)b * Hb + mirror(fy, y, h[b])) * in_wl * C;
  TOut* dst = out + (size_t)row * row_len;
  float v[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = e0 + u * kThreads;
    if (e < row_len) {
      const int x = e / C;
      const int g = col0 + x;
      const int sx = fx && g < ww ? ww - 1 - g - in_col0 : x + pad_shift;
      v[u] = load(src + sx * C + (e - x * C));
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = e0 + u * kThreads;
    if (e < row_len) store(dst + e, v[u]);
  }
}

// Modes with the transpose. grid: x = ceil(Hb / kTR) tiles along the
// output's columns, y = ceil(Wb / kTP) along its rows, z = B.
template <typename TIn, typename TOut, int C>
__global__ void __launch_bounds__(kThreads)
orient_tiles(const TIn* __restrict__ in, TOut* __restrict__ out,
             const int32_t* __restrict__ h, const int32_t* __restrict__ w,
             int fy, int fx, int Hb, int Wb) {
  constexpr int kStride = (kTP + 1) * C;  // == C (mod 32)
  constexpr int kLoads = kTP * C / 32;    // a lane's loads of one tile row
  constexpr int kStores = kTR * C / 32;   // and stores of one output row
  __shared__ float tile[kTR * kStride];
  await_previous_kernel();
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTR;  // output columns (input rows)
  const int y0 = blockIdx.y * kTP;  // output rows (input pixels)
  const int nr = min(kTR, Hb - x0);
  const int np = min(kTP, Wb - y0);
  const int ho = w[b], wo = h[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const TIn* img = in + (size_t)b * Hb * Wb * C;
  float v[kRowsPerWarp][kLoads];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
    if (r < nr) {
      const TIn* src = img + (size_t)mirror(fx, x0 + r, wo) * Wb * C;
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        const int k = lane + 32 * m;
        if (k < np * C) {
          const int i = k / C;
          v[j][m] = load(src + mirror(fy, y0 + i, ho) * C + (k - i * C));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int k = lane + 32 * m;
      if (r < nr && k < np * C) tile[r * kStride + k] = v[j][m];
    }
  }
  __syncthreads();
  TOut* dst = out + ((size_t)b * Wb + y0) * Hb * C + (size_t)x0 * C;
  for (int i = warp; i < np; i += kWarps) {
    TOut* row = dst + (size_t)i * Hb * C;
#pragma unroll
    for (int m = 0; m < kStores; ++m) {
      const int e = lane + 32 * m;
      if (e < nr * C) {
        const int r = e / C;
        store(row + e, tile[r * kStride + i * C + (e - r * C)]);
      }
    }
  }
}

template <typename TIn, typename TOut, int C>
cudaError_t launch_rows(const void* in, void* out, const int32_t* h,
                        const int32_t* w, int fy, int fx, int B, int Hb,
                        int in_wl, int out_wl, int col0, int in_col0,
                        int pad_shift, cudaStream_t s) {
  const int segs = (out_wl * C + kSeg - 1) / kSeg;
  const long long blocks = (long long)B * Hb * segs;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return launch_pdl(orient_rows<TIn, TOut, C>, dim3((unsigned)blocks),
                    dim3(kThreads), 0, s, static_cast<const TIn*>(in),
                    static_cast<TOut*>(out), h, w, fy, fx, Hb, in_wl, out_wl,
                    col0, in_col0, pad_shift, segs);
}

template <typename TIn, typename TOut, int C>
cudaError_t launch_c(const void* in, void* out, const int32_t* h,
                     const int32_t* w, int t, int fy, int fx, int B, int Hb,
                     int Wb, cudaStream_t s) {
  if (!t)
    return launch_rows<TIn, TOut, C>(in, out, h, w, fy, fx, B, Hb, Wb, Wb, 0,
                                     0, 0, s);
  const dim3 grid((Hb + kTR - 1) / kTR, (Wb + kTP - 1) / kTP, B);
  return launch_pdl(orient_tiles<TIn, TOut, C>, grid, dim3(kThreads), 0, s,
                    static_cast<const TIn*>(in), static_cast<TOut*>(out), h, w,
                    fy, fx, Hb, Wb);
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* in, void* out, const int32_t* h,
                   const int32_t* w, int t, int fy, int fx, int B, int Hb,
                   int Wb, int C, cudaStream_t s) {
  switch (C) {
    case 1: return launch_c<TIn, TOut, 1>(in, out, h, w, t, fy, fx, B, Hb, Wb, s);
    case 2: return launch_c<TIn, TOut, 2>(in, out, h, w, t, fy, fx, B, Hb, Wb, s);
    case 3: return launch_c<TIn, TOut, 3>(in, out, h, w, t, fy, fx, B, Hb, Wb, s);
    default: return launch_c<TIn, TOut, 4>(in, out, h, w, t, fy, fx, B, Hb, Wb, s);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_shard(const void* in, void* out, const int32_t* w, int B,
                         int Hb, int in_wl, int lw, int C, int col0,
                         int in_col0, cudaStream_t s) {
  const int pad = in_wl - lw;  // the padding columns end the window
  switch (C) {
    case 1: return launch_rows<TIn, TOut, 1>(in, out, w, w, 0, 1, B, Hb, in_wl, lw, col0, in_col0, pad, s);
    case 2: return launch_rows<TIn, TOut, 2>(in, out, w, w, 0, 1, B, Hb, in_wl, lw, col0, in_col0, pad, s);
    case 3: return launch_rows<TIn, TOut, 3>(in, out, w, w, 0, 1, B, Hb, in_wl, lw, col0, in_col0, pad, s);
    default: return launch_rows<TIn, TOut, 4>(in, out, w, w, 0, 1, B, Hb, in_wl, lw, col0, in_col0, pad, s);
  }
}

}  // namespace

// in: [B, Hb, Wb, C] (uint8 if in_u8 else f32); out: [B, Hb, Wb, C], or
// [B, Wb, Hb, C] when t (uint8 with the epilogue if out_u8, else f32).
// h, w: int32 [B] valid dims of the input. t, fy, fx: the mode (0 or 1
// each; see the top). Returns the launch's CUDA error code.
extern "C" int itpu_orient(const void* in, int in_u8, void* out, int out_u8,
                           const int32_t* h, const int32_t* w, int t, int fy,
                           int fx, int B, int Hb, int Wb, int C, void* stream) {
  if (C < 1 || C > kMaxC || (t | fy | fx) & ~1) return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_u8 && out_u8)
    err = launch<uint8_t, uint8_t>(in, out, h, w, t, fy, fx, B, Hb, Wb, C, s);
  else if (in_u8)
    err = launch<uint8_t, float>(in, out, h, w, t, fy, fx, B, Hb, Wb, C, s);
  else if (out_u8)
    err = launch<float, uint8_t>(in, out, h, w, t, fy, fx, B, Hb, Wb, C, s);
  else
    err = launch<float, float>(in, out, h, w, t, fy, fx, B, Hb, Wb, C, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The flop's W-shard form. in: [B, Hb, in_wl, C], the mirrored input
// columns from in_col0, then the shard's padding columns; out: [B, Hb, lw,
// C], output columns [col0, col0 + lw) (uint8 with the epilogue if out_u8,
// else f32); w: int32 [B] valid widths. Returns the launch's CUDA error
// code.
extern "C" int itpu_flop_shard(const void* in, int in_u8, void* out, int out_u8,
                               const int32_t* w, int B, int Hb, int in_wl,
                               int lw, int C, int col0, int in_col0,
                               void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * lw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_u8 && out_u8)
    err = launch_shard<uint8_t, uint8_t>(in, out, w, B, Hb, in_wl, lw, C, col0, in_col0, s);
  else if (in_u8)
    err = launch_shard<uint8_t, float>(in, out, w, B, Hb, in_wl, lw, C, col0, in_col0, s);
  else if (out_u8)
    err = launch_shard<float, uint8_t>(in, out, w, B, Hb, in_wl, lw, C, col0, in_col0, s);
  else
    err = launch_shard<float, float>(in, out, w, B, Hb, in_wl, lw, C, col0, in_col0, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
