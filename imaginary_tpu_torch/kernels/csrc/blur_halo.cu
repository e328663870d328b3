// K13: the W-sharded Gaussian blur, one launch a shard over exchanged
// input halos.
//
// Replaces: imaginary_tpu/parallel/spatial.py:56-124 (`sharded_blur`'s
// shard-local program: the vertical pass, the R-wide halo exchange by
// `ppermute`, the horizontal pass and the normalisation), and the blur
// stage of the chain run under the spatial sharding
// (imaginary_tpu/engine/executor.py:569-572, ops/chain.py:112-124).
//
// One shard holds columns [col0, col0 + lw) of a [B, Hb, Wb, C] image
// batch (C = 1..4) with per-image valid dims h, w (int32 [Bl], w global),
// per-image sigma (f32 [Bl]) and a static radius R <= 64. Beside its own
// columns x_s [Bl, Hb, lw, C] it reads two halos [Bl, Hb, R, C], in the
// input's dtype: `left` holds global columns [col0 - R, col0), `right`
// [col0 + lw, col0 + lw + R), copied from the neighbouring shards' input
// by the halo exchange (parallel/spatial.py). The first shard's left halo
// and the last shard's right halo lie outside the image and are never
// read (they may be null). Only input pixels cross the seams; the
// vertical sums of the halo columns are made again by each shard.
//
// out [Bl, Hb, lw, C] is K6's function of the whole image at the shard's
// columns: conv_h(conv_v(x * m)) / max(rowden[y] * colden[col0 + x],
// 1e-6) inside the valid region and 0 outside it, f32 or uint8 with the
// chain's clip(x + 0.5) epilogue, with colden over GLOBAL columns.
//
// Bound on the H100: as K6 (csrc/blur.cu), memory at small radii and
// arithmetic at r = 64; the halos add 2R columns of reads a shard.
//
// Design: K6's fused kernel (csrc/blur_fused.cuh, instantiated with
// kHalo): 8 rows by a strip a block, vertical sums in shared memory, one
// barrier, horizontal sums and the normalisation. A block whose strip
// reaches past the shard's edge loads those columns' input from the halo
// tensors. Every output takes K6's arithmetic in K6's order, so the
// gathered shards equal K6's output bit for bit.

#include "blur_fused.cuh"

// K13 on one shard: in [Bl, Hb, lw, C] and the halos left, right
// [Bl, Hb, radius, C] (uint8 if in_u8, else f32; either halo may be null
// where it lies outside the image) -> out [Bl, Hb, lw, C] (uint8 with the
// epilogue if out_u8, else f32). h, w: int32 [Bl] valid dims of the whole
// image; sigma: f32 [Bl]; radius 0..64; col0: the shard's first global
// column; Wb: the image's bucket width; strip: as K6's. Returns the
// launch's CUDA error code.
extern "C" int itpu_blur_halo(const void* in, const void* left, const void* right,
                              int in_u8, void* out, int out_u8, const int32_t* h,
                              const int32_t* w, const float* sigma, int radius,
                              int Bl, int Hb, int lw, int C, int col0, int Wb,
                              int strip, void* stream) {
  if (radius < 0 || radius > blur_fused::kMaxRadius || C < 1 || C > 4 || strip < 1 ||
      col0 < 0 || col0 + lw > Wb)
    return (int)cudaErrorInvalidValue;
  if ((size_t)Bl * Hb * lw == 0) return 0;
  return blur_fused::launch_any<true>(in_u8, out_u8, C, in, left, right, out, h, w,
                                      sigma, radius, Bl, Hb, lw, col0, Wb, strip,
                                      static_cast<cudaStream_t>(stream));
}
