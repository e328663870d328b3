// K1: separable resample, one axis per launch (H pass, then W pass).
//
// Replaces: imaginary_tpu/ops/stages.py:46-116 (`sample_matrix` +
// `SampleSpec.apply`), which builds a dense [B, out, in] weight matrix per
// axis and contracts it with two batched einsums, and the Pallas
// `resample_rows` / `resample_2d` that once fused the same function
// (imaginary_tpu/ops/pallas_kernels.py:136/:151 before commit 6fc8717).
//
// Bound on the H100: memory. At the serving shapes a pass reads the input
// once (f32 [B,320,512,3] = 1.97 MB per image) and writes its output once,
// and does ~2 * taps FLOPs per output element (taps ~ 6..40), far below the
// ~20 FLOP/byte where the card's f32 rate would take over.
//
// Design: the dense matrix is never built. One block owns one output
// position `o` of the resampled axis for one image: it evaluates that
// row's tap weights on the fly over the kernel's support (|k - centre| <
// R * stretch, intersected with k < src, plus a one-tap margin; every tap
// re-tests the kernel's own `where` condition, so the kept set is exactly
// the dense matrix's non-zero set), sums them for the renormalisation in
// shared memory in a fixed order, and then every thread contracts the
// weights against a strided run of the input. Tensors are viewed as
// [B, outer, n, inner]: the H pass is (outer 1, inner W*C), so threads
// read whole contiguous rows; the W pass is (outer out_hb, inner C).
// Weight math is f32 in the JAX order (dst/src, then (y+0.5)/scale-0.5,
// then (k-centre)/stretch), which is what keeps nearest's half-open
// [-0.5, 0.5) box deciding exactly like the reference.
//
// The first pass may read uint8 (the RGB transport's cast is fused) and the
// second may write uint8 (the chain's clip(x+0.5) epilogue is fused). Block
// 0 of each image also writes int32(dst) as the stage's output dims.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kEps = 1e-6f;
constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ float load(const T* p) { return (float)(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(v + 0.5f, 0.0f), 255.0f);
}

// grid (out_n, B); dynamic shared memory: in_n floats of weights.
template <typename TIn, typename TOut>
__global__ void resample_pass(const TIn* __restrict__ in, TOut* __restrict__ out,
                              const int32_t* __restrict__ src_n,
                              const float* __restrict__ dst_n,
                              int32_t* __restrict__ dims_out, int outer,
                              int in_n, int out_n, int inner, int kind) {
  extern __shared__ float wts[];
  __shared__ float red[kThreads / 32];
  __shared__ float s_norm;
  const int o = blockIdx.x;
  const int b = blockIdx.y;
  const float srcf = fmaxf((float)src_n[b], 1.0f);
  const float dstf = fmaxf(dst_n[b], 1.0f);
  if (o == 0 && threadIdx.x == 0 && dims_out != nullptr)
    dims_out[b] = (int32_t)dst_n[b];

  const float scale = dstf / srcf;
  const float centre = ((float)o + 0.5f) / scale - 0.5f;
  const float stretch = fmaxf(1.0f, 1.0f / scale);
  const float reach = support(kind) * stretch;
  // one tap of margin each side; each tap re-tests the exact condition
  int k_lo = (int)floorf(centre - reach) - 1;
  int k_hi = (int)ceilf(centre + reach) + 1;  // inclusive
  if (k_lo < 0) k_lo = 0;
  if (k_hi > in_n - 1) k_hi = in_n - 1;
  const bool row_valid = (float)o < dstf;
  const int ntaps = row_valid ? max(0, k_hi - k_lo + 1) : 0;

  for (int j = threadIdx.x; j < ntaps; j += blockDim.x) {
    const int k = k_lo + j;
    float wv = 0.0f;
    if ((float)k < srcf) wv = kernel_weight(kind, ((float)k - centre) / stretch);
    wts[j] = wv;
  }
  __syncthreads();
  // renormalisation over exactly the kept taps, in a fixed order
  float part = 0.0f;
  for (int j = threadIdx.x; j < ntaps; j += blockDim.x) part += wts[j];
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float n = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); i++) n += red[i];
    s_norm = n;
  }
  __syncthreads();
  const float norm = s_norm;
  const bool keep = norm > kEps;
  for (int j = threadIdx.x; j < ntaps; j += blockDim.x)
    wts[j] = keep ? wts[j] / fmaxf(norm, kEps) : 0.0f;
  __syncthreads();

  const int total = outer * inner;
  const size_t in_img = (size_t)outer * in_n * inner;
  const size_t out_img = (size_t)outer * out_n * inner;
  const TIn* src = in + (size_t)b * in_img;
  TOut* dst = out + (size_t)b * out_img;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int q = e / inner;
    const int i = e - q * inner;
    const TIn* p = src + ((size_t)q * in_n + k_lo) * inner + i;
    float acc = 0.0f;
    if (keep) {
      for (int j = 0; j < ntaps; j++) acc += wts[j] * load(p + (size_t)j * inner);
    }
    store(dst + ((size_t)q * out_n + o) * inner + i, acc);
  }
}

template <typename TIn, typename TOut>
int launch(const void* in, void* out, const int32_t* src_n, const float* dst_n,
           int32_t* dims_out, int B, int outer, int in_n, int out_n, int inner,
           int kind, cudaStream_t stream) {
  dim3 grid((unsigned)out_n, (unsigned)B);
  const size_t smem = (size_t)in_n * sizeof(float);
  auto fn = resample_pass<TIn, TOut>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<grid, kThreads, smem, stream>>>(static_cast<const TIn*>(in),
                                       static_cast<TOut*>(out), src_n, dst_n,
                                       dims_out, outer, in_n, out_n, inner,
                                       kind);
  return (int)cudaGetLastError();
}

}  // namespace

// Layout: in [B, outer, in_n, inner], out [B, outer, out_n, inner].
// src_n: int32 [B] valid input length; dst_n: f32 [B] target length;
// dims_out: optional int32 [B] receiving int(dst_n). Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int itpu_resample_pass(const void* in, int in_u8, void* out,
                                  int out_u8, const int32_t* src_n,
                                  const float* dst_n, int32_t* dims_out, int B,
                                  int outer, int in_n, int out_n, int inner,
                                  int kind, void* stream) {
  if (B <= 0 || outer <= 0 || in_n <= 0 || out_n <= 0 || inner <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8 && out_u8)
    return launch<uint8_t, uint8_t>(in, out, src_n, dst_n, dims_out, B, outer,
                                    in_n, out_n, inner, kind, s);
  if (in_u8)
    return launch<uint8_t, float>(in, out, src_n, dst_n, dims_out, B, outer,
                                  in_n, out_n, inner, kind, s);
  if (out_u8)
    return launch<float, uint8_t>(in, out, src_n, dst_n, dims_out, B, outer,
                                  in_n, out_n, inner, kind, s);
  return launch<float, float>(in, out, src_n, dst_n, dims_out, B, outer, in_n,
                              out_n, inner, kind, s);
}
