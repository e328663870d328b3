// K4: per-image index-map gather with mask fill (embed / extract / shrink),
// as a row copy.
//
// Replaces: imaginary_tpu/ops/stages.py:151-198 (`EmbedSpec.apply` with
// `_axis_indices`), :119-148 (`ExtractSpec.apply` with `_window_gather`)
// and :330-341 (`ShrinkBucketSpec.apply`).
//
// Bound on the H100: memory; it does no arithmetic beyond index math. At
// /rotate's shrink ([32, 2048, 1152, 3] -> [32, 1920, 1088, 3] f32) it
// reads and writes 0.80 GB.
//
// Design: one block owns one output row (b, y). It derives the row's
// source row iy and the row bases once (64-bit only there), then walks
// the row with 32-bit column math. Index maps, each axis on its own:
//   mode 0 (window): i = clamp(pos + off, 0, in_b - 1) (not
//          lax.dynamic_slice's whole-window clamp). Extract passes
//          off = (top, left); ShrinkBucket passes no offsets (identity).
//          A row's source is one contiguous run, clamped only at its ends:
//          the run is copied with 16-byte loads and stores wherever the
//          source and destination are congruent mod 16 (a scalar head and
//          tail around them), element by element where they are not or
//          where the types differ; the clamped ends repeat the edge pixel.
//   mode 1 (clamp):  rel = pos - off, i = clamp(rel, 0, max(size,1) - 1)
//          (Embed with COPY / LAST and the colour fills).
//   mode 2 (mirror): rel = pos - off, i = floored rel mod 2*size folded
//          back (jnp.remainder is floored; CUDA's % truncates, hence
//          ((a % p) + p) % p, in 32 bits).
//   In modes 1 and 2 a thread owns a pixel and its C channels.
// With a fill vector, canvas pixels outside [0, size) on either axis take
// fill[b, c] (modes 1 and 2). uint8 input (the RGB transport's first
// stage) and a uint8 output with the chain's clip(x + 0.5) epilogue (its
// last stage) are fused; uint8 to uint8 is an exact copy.
//
// W-shard form (`itpu_gather_shard`, the spatial route): a kernel of its
// own, so the whole-image launch above is unchanged. A shard writes output
// columns [col0, col0 + out_wl) of the out_wb-wide bucket from the input
// columns [in_col0, in_col0 + in_wl) it holds (its window, exchanged from
// the shards that hold them); every index map is the whole image's on
// global columns, then moved into the window, so the shards equal the
// whole image's columns bit for bit. With `keys` (K10's shard form, int64
// [B, nkeys] order-preserving score keys) the window's offsets are the
// best of the keys, decoded on the card as K10 decodes its own: no host
// round trip.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// Source index along one axis; *inside reports whether pos maps onto the
// image (only meaningful for modes 1 and 2).
__device__ __forceinline__ int axis_index(int pos, int off, int size, int in_b,
                                          int mode, bool* inside) {
  if (mode == 0) {
    *inside = true;
    return min(max(pos + off, 0), in_b - 1);
  }
  const int sz = max(size, 1);
  const int rel = pos - off;
  *inside = rel >= 0 && rel < sz;
  int idx;
  if (mode == 2) {
    const int period = 2 * sz;
    const int m = ((rel % period) + period) % period;
    idx = m < sz ? m : period - 1 - m;
  } else {
    idx = min(max(rel, 0), sz - 1);
  }
  // an index past the bucket clamps, like every XLA gather
  return min(max(idx, 0), in_b - 1);
}

// n contiguous elements from s to d by the block's threads.
template <typename TIn, typename TOut>
__device__ __forceinline__ void copy_run(const TIn* __restrict__ s,
                                         TOut* __restrict__ d, int n) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if constexpr (std::is_same<TIn, TOut>::value) {
    constexpr int V = 16 / sizeof(TIn);
    const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
    const uintptr_t da = reinterpret_cast<uintptr_t>(d);
    if (((sa ^ da) & 15u) == 0) {
      const int head = min(n, (int)(((16u - (da & 15u)) & 15u) / sizeof(TIn)));
      const int nv = (n - head) / V;
      const int4* sv = reinterpret_cast<const int4*>(s + head);
      int4* dv = reinterpret_cast<int4*>(d + head);
      for (int i = tid; i < nv; i += nthr) dv[i] = sv[i];
      for (int i = tid; i < head; i += nthr) d[i] = s[i];
      for (int i = head + nv * V + tid; i < n; i += nthr) d[i] = s[i];
      return;
    }
    for (int i = tid; i < n; i += nthr) d[i] = s[i];
  } else {
    for (int i = tid; i < n; i += nthr) store(d + i, load(s + i));
  }
}

// grid (out_hb, B), one block per output row.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
gather_rows(const TIn* __restrict__ in, TOut* __restrict__ out,
            const int32_t* __restrict__ off_y, const int32_t* __restrict__ off_x,
            const int32_t* __restrict__ size_h, const int32_t* __restrict__ size_w,
            const float* __restrict__ fill, int mode, int in_hb, int in_wb,
            int C, int out_hb, int out_wb) {
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int oy = off_y ? off_y[b] : 0;
  const int ox = off_x ? off_x[b] : 0;
  const int sh = size_h ? size_h[b] : in_hb;
  const int sw = size_w ? size_w[b] : in_wb;
  bool in_y;
  const int iy = axis_index(y, oy, sh, in_hb, mode, &in_y);
  const int row_in = in_wb * C, row_out = out_wb * C;
  const TIn* __restrict__ src = in + ((size_t)b * in_hb + iy) * (size_t)row_in;
  TOut* __restrict__ dst = out + ((size_t)b * out_hb + y) * (size_t)row_out;

  if (mode == 0) {
    // columns [x0, x1) read the contiguous run from x0 + ox; those left of
    // it clamp to column 0, those right of it to column in_wb - 1
    const int x0 = min(max(-ox, 0), out_wb);
    const int x1 = min(max(in_wb - ox, x0), out_wb);
    if (x1 > x0) copy_run(src + (x0 + ox) * C, dst + x0 * C, (x1 - x0) * C);
    const int nedge = x0 + (out_wb - x1);
    for (int k = threadIdx.x; k < nedge; k += blockDim.x) {
      const bool left = k < x0;
      const int x = left ? k : x1 + (k - x0);
      const TIn* p = src + (left ? 0 : (in_wb - 1) * C);
      for (int c = 0; c < C; c++) store(dst + x * C + c, load(p + c));
    }
    return;
  }
  const float* fb = fill ? fill + (size_t)b * C : nullptr;
  for (int x = threadIdx.x; x < out_wb; x += blockDim.x) {
    bool in_x;
    const int ix = axis_index(x, ox, sw, in_wb, mode, &in_x);
    TOut* q = dst + x * C;
    if (fb != nullptr && !(in_y && in_x)) {
      for (int c = 0; c < C; c++) store(q + c, fb[c]);
    } else {
      const TIn* p = src + ix * C;
      for (int c = 0; c < C; c++) store(q + c, load(p + c));
    }
  }
}

// The shard form; grid (out_hb, B), one block per output row.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
gather_rows_shard(const TIn* __restrict__ in, TOut* __restrict__ out,
                  const int32_t* __restrict__ off_y,
                  const int32_t* __restrict__ off_x,
                  const int32_t* __restrict__ size_h,
                  const int32_t* __restrict__ size_w,
                  const float* __restrict__ fill,
                  const unsigned long long* __restrict__ keys, int nkeys,
                  int key_wb, int mode, int in_hb, int in_wb, int in_col0,
                  int in_wl, int C, int out_hb, int out_wl, int col0) {
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  int oy, ox;
  if (keys != nullptr) {
    // the largest key: the best score, then the smallest index
    unsigned long long best = 0ull;
    for (int k = 0; k < nkeys; ++k) {
      const unsigned long long v = keys[(size_t)b * nkeys + k];
      best = v > best ? v : best;
    }
    const int i = best ? (int)(~(unsigned int)(best & 0xffffffffull)) : 0;
    oy = i / key_wb;
    ox = i % key_wb;
  } else {
    oy = off_y ? off_y[b] : 0;
    ox = off_x ? off_x[b] : 0;
  }
  const int sh = size_h ? size_h[b] : in_hb;
  const int sw = size_w ? size_w[b] : in_wb;
  bool in_y;
  const int iy = axis_index(y, oy, sh, in_hb, mode, &in_y);
  const int row_in = in_wl * C, row_out = out_wl * C;
  // the window's row, indexed by global column less in_col0
  const TIn* __restrict__ src = in + ((size_t)b * in_hb + iy) * (size_t)row_in;
  TOut* __restrict__ dst = out + ((size_t)b * out_hb + y) * (size_t)row_out;

  if (mode == 0) {
    // local column x reads global column clamp(col0 + x + ox): the run
    // [x0, x1) unclamped, the columns left of it global 0, right of it
    // global in_wb - 1
    const int gx = col0 + ox;
    const int x0 = min(max(-gx, 0), out_wl);
    const int x1 = min(max(in_wb - gx, x0), out_wl);
    if (x1 > x0)
      copy_run(src + (x0 + gx - in_col0) * C, dst + x0 * C, (x1 - x0) * C);
    const int nedge = x0 + (out_wl - x1);
    for (int k = threadIdx.x; k < nedge; k += blockDim.x) {
      const bool left = k < x0;
      const int x = left ? k : x1 + (k - x0);
      const TIn* p = src + ((left ? 0 : in_wb - 1) - in_col0) * C;
      for (int c = 0; c < C; c++) store(dst + x * C + c, load(p + c));
    }
    return;
  }
  const float* fb = fill ? fill + (size_t)b * C : nullptr;
  for (int x = threadIdx.x; x < out_wl; x += blockDim.x) {
    bool in_x;
    const int ix = axis_index(col0 + x, ox, sw, in_wb, mode, &in_x);
    TOut* q = dst + x * C;
    if (fb != nullptr && !(in_y && in_x)) {
      for (int c = 0; c < C; c++) store(q + c, fb[c]);
    } else {
      const TIn* p = src + (ix - in_col0) * C;
      for (int c = 0; c < C; c++) store(q + c, load(p + c));
    }
  }
}

template <typename TIn, typename TOut>
int launch_shard(const void* in, void* out, const int32_t* off_y,
                 const int32_t* off_x, const int32_t* size_h,
                 const int32_t* size_w, const float* fill,
                 const unsigned long long* keys, int nkeys, int key_wb,
                 int mode, int B, int in_hb, int in_wb, int in_col0, int in_wl,
                 int C, int out_hb, int out_wl, int col0, cudaStream_t stream) {
  dim3 grid((unsigned)out_hb, (unsigned)B);
  gather_rows_shard<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), off_y, off_x,
      size_h, size_w, fill, keys, nkeys, key_wb, mode, in_hb, in_wb, in_col0,
      in_wl, C, out_hb, out_wl, col0);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch(const void* in, void* out, const int32_t* off_y,
           const int32_t* off_x, const int32_t* size_h, const int32_t* size_w,
           const float* fill, int mode, int B, int in_hb, int in_wb, int C,
           int out_hb, int out_wb, cudaStream_t stream) {
  dim3 grid((unsigned)out_hb, (unsigned)B);
  gather_rows<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), off_y, off_x,
      size_h, size_w, fill, mode, in_hb, in_wb, C, out_hb, out_wb);
  return (int)cudaGetLastError();
}

}  // namespace

// in: [B, in_hb, in_wb, C] (uint8 if in_u8 else f32); out: [B, out_hb,
// out_wb, C] (uint8 with the epilogue if out_u8 else f32). off_y/off_x,
// size_h/size_w: int32 [B] or null; fill: f32 [B, C] or null.
// Returns the launch's CUDA error code.
extern "C" int itpu_gather(const void* in, int in_u8, void* out, int out_u8,
                           const int32_t* off_y, const int32_t* off_x,
                           const int32_t* size_h, const int32_t* size_w,
                           const float* fill, int mode, int B, int in_hb,
                           int in_wb, int C, int out_hb, int out_wb,
                           void* stream) {
  if ((size_t)B * out_hb * out_wb * C == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch<uint8_t, uint8_t>(in, out, off_y, off_x, size_h, size_w,
                                    fill, mode, B, in_hb, in_wb, C, out_hb,
                                    out_wb, s);
  if (in_u8)
    return launch<uint8_t, float>(in, out, off_y, off_x, size_h, size_w, fill,
                                  mode, B, in_hb, in_wb, C, out_hb, out_wb, s);
  if (out_u8)
    return launch<float, uint8_t>(in, out, off_y, off_x, size_h, size_w, fill,
                                  mode, B, in_hb, in_wb, C, out_hb, out_wb, s);
  return launch<float, float>(in, out, off_y, off_x, size_h, size_w, fill,
                              mode, B, in_hb, in_wb, C, out_hb, out_wb, s);
}

// The W-shard form. in: [B, in_hb, in_wl, C], input columns [in_col0,
// in_col0 + in_wl) of an in_wb-wide bucket; out: [B, out_hb, out_wl, C],
// output columns [col0, col0 + out_wl). keys: uint64 [B, nkeys] or null
// (then off_y/off_x as above); key_wb: the bucket width the keys' indices
// run over. The caller makes the window cover every column the shard
// reads. Returns the launch's CUDA error code.
extern "C" int itpu_gather_shard(const void* in, int in_u8, void* out,
                                 int out_u8, const int32_t* off_y,
                                 const int32_t* off_x, const int32_t* size_h,
                                 const int32_t* size_w, const float* fill,
                                 const unsigned long long* keys, int nkeys,
                                 int key_wb, int mode, int B, int in_hb,
                                 int in_wb, int in_col0, int in_wl, int C,
                                 int out_hb, int out_wl, int col0,
                                 void* stream) {
  if ((size_t)B * out_hb * out_wl * C == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (keys != nullptr && (nkeys < 1 || key_wb < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch_shard<uint8_t, uint8_t>(
        in, out, off_y, off_x, size_h, size_w, fill, keys, nkeys, key_wb,
        mode, B, in_hb, in_wb, in_col0, in_wl, C, out_hb, out_wl, col0, s);
  if (in_u8)
    return launch_shard<uint8_t, float>(
        in, out, off_y, off_x, size_h, size_w, fill, keys, nkeys, key_wb,
        mode, B, in_hb, in_wb, in_col0, in_wl, C, out_hb, out_wl, col0, s);
  if (out_u8)
    return launch_shard<float, uint8_t>(
        in, out, off_y, off_x, size_h, size_w, fill, keys, nkeys, key_wb,
        mode, B, in_hb, in_wb, in_col0, in_wl, C, out_hb, out_wl, col0, s);
  return launch_shard<float, float>(
      in, out, off_y, off_x, size_h, size_w, fill, keys, nkeys, key_wb, mode,
      B, in_hb, in_wb, in_col0, in_wl, C, out_hb, out_wl, col0, s);
}
