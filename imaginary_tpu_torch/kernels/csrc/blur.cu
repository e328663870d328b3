// K6: separable Gaussian blur, normalised against each image's valid mask.
//
// Replaces: imaginary_tpu/ops/stages.py:237-280 (`BlurSpec.apply`).
//
// Function, for x [B, Hb, Wb, C] (C = 1..4) with per-image valid dims h, w
// (int32 [B]), per-image sigma (f32 [B]) and a static radius r <= 64:
//   k[t]  = exp(-0.5 * (t / max(sigma, 1e-3))^2) / sum over t in [-r, r],
//           or the delta (k[0] = 1) where sigma <= 0;
//   m     = (y < h) & (x < w), the validity mask;
//   out   = conv_h(conv_v(x * m)) / max(conv_h(conv_v(m)), 1e-6) inside
//           the valid (h, w), and 0 outside it, bucket padding included,
// where conv_v and conv_h are the 2r+1-tap correlations with k along rows
// and columns with zero padding beyond the bucket ("SAME"). The vertical
// pass runs first, then the horizontal one. Unlike the orientation kernel,
// the padding is zeroed, not copied.
//
// m is the outer product of a row indicator and a column indicator, so
// conv_h(conv_v(m))[y, x] = rowden[y] * colden[x] with
//   rowden[y] = sum of k[t] over 0 <= y + t < h,
//   colden[x] = sum of k[s] over 0 <= x + s < w.
// The kernel computes those two 1-D tap sums instead of convolving a mask
// image (equal in exact arithmetic; within a few f32 ulps of the
// reference's order of sums).
//
// Bound on the H100: memory for small radii, arithmetic for large ones.
// At config 3's f32 [1, 736, 1280, 3] with r = 4 the input and output are
// 11.3 MB each (6.7 us at 3.35 TB/s) against 38 flops per element (1.6 us
// at 67 TFLOP/s: 2 a tap each way, 2 for the normalisation); at r = 64 the
// up to 518 flops per element (500 on average over the valid 720 x 1280,
// 21 us) bound it.
//
// Design (the kernel is in csrc/blur_fused.cuh, shared with K13): one
// launch, no intermediate in device memory. A block owns a
// strip of `strip` output columns (all C channels) and kRows = 8 output
// rows of one image. Its prologue builds the tables once: the image's
// taps (exp in parallel, then each thread that normalises a tap sums all
// of them in ascending order itself, so no thread waits on a serial loop
// of another), rowden for its rows and colden for its columns (one thread
// per entry, ascending tap sums). Then:
//   1. the vertical sums of the 8 rows at the valid columns in [x0 - r,
//      x0 + strip + r) go into shared memory. A thread owns one element
//      (neighbouring threads on neighbouring addresses) and sums all 8
//      rows at once: a window of 8 input values slides down one row a
//      tap, so each tap and each of the 8 + 2r input rows is loaded once
//      for 8 outputs;
//   2. one barrier;
//   3. the horizontal sums read the shared rows and their r-column halos,
//      again 8 rows a thread (one tap load for 8 outputs), divide by
//      rowden * colden and store f32, or uint8 with the chain's
//      clip(x + 0.5) epilogue, straight to the output.
// Rows and columns outside the valid region store 0 without summing.
// Every output element takes a fixed order of arithmetic (taps exp'd,
// then normalised by their ascending sum; vertical sums over ascending t,
// horizontal ones over ascending s, as fused multiply-adds from 0; rowden
// and colden as ascending sums). It equals the order of the separate
// vertical and horizontal passes this kernel replaced, so the result
// equals theirs bit for bit: the window takes rows outside the valid ones
// as 0 where those passes skipped their taps, and adding +0 leaves a sum
// as it was (only a sum of -0 turns +0). K13 runs the same kernel on
// W-shards, so its gathered shards equal this kernel's output bit for bit.
// uint8 input is cast on load.

#include "blur_fused.cuh"

// K6 in one launch: in [B, Hb, Wb, C] (uint8 if in_u8, else f32) -> out
// (uint8 with the epilogue if out_u8, else f32). h, w: int32 [B] valid
// dims; sigma: f32 [B]; radius 0..64; a block makes 8 rows of a strip
// `strip` columns wide (the wrapper picks it). Returns the launch's CUDA
// error code.
extern "C" int itpu_blur(const void* in, int in_u8, void* out, int out_u8,
                         const int32_t* h, const int32_t* w,
                         const float* sigma, int radius, int B, int Hb,
                         int Wb, int C, int strip, void* stream) {
  if (radius < 0 || radius > blur_fused::kMaxRadius || C < 1 || C > 4 || strip < 1)
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * Hb * Wb == 0) return 0;
  return blur_fused::launch_any<false>(in_u8, out_u8, C, in, nullptr, nullptr,
                                       out, h, w, sigma, radius, B, Hb, Wb, 0,
                                       Wb, strip, static_cast<cudaStream_t>(stream));
}
