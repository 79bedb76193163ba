// Bilinear 1D resample of the augmentation warp for Hopper (sm_90a).
//
// Replaces the TPU kernel ball_action_spotting_tpu/ops/pallas_warp.py
// (resample_last_axis_pallas -> _resample_kernel), which builds a (W, W)
// interpolation matrix per 32-row block in VMEM and multiplies the block by
// it on the MXU. That matrix has two nonzeros per column, so this kernel
// computes the same function as a direct two-tap pass:
//
//   grid = scale[n] * t + off_c[n, blk]        (no FMA: __fmul_rn, __fadd_rn)
//   j0 = floor(grid), f = grid - j0
//   w0 = (1 - f) * [0 <= j0 < len],  w1 = f * [0 <= j0 + 1 < len]
//   out = w0 * img[j0] + w1 * img[j0 + 1]     (taps clamped for the read only)
//
// off_c holds the offset at each block's center row, as the TPU kernel's
// scalar prefetch does. In bf16 mode the weights and the image are rounded to
// bf16 (the TPU kernel casts its matrix and the block to bf16) and the two
// products are summed in f32; the output is cast to the image's dtype.
//
// Two modes over an (n, H, W) image:
//   axis 2 (rows):    t = x, the block is the row's (r / block), taps along W;
//   axis 1 (columns): t = y, the block is the column's (x / block), taps
//                     along H at stride W. This is the V pass without the
//                     two transposes of the JAX path.
//
// Bound on an H100 SXM: memory. At the flagship train step (60 frames of
// 736 x 1280 bf16) a pass must read 113 MB and write 113 MB, 0.067 ms at
// 3.35 TB/s; its ~6 operations per element are far below the arithmetic
// rate. Design: one block of 256 threads per output row, threads on
// neighbouring output columns. In row mode neighbouring threads read
// neighbouring taps (|scale| is near 1); in column mode a warp's 32 columns
// share one block offset, so the whole warp reads two contiguous row
// segments. Every output element is written once; each input element is read
// about twice, mostly from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const T* __restrict__ img, T* __restrict__ out,
                const float* __restrict__ scale, const float* __restrict__ off_c,
                int h, int w, int block, int nb, int axis, int bf16_math) {
  const int64_t row = blockIdx.x;  // output row over (n, H)
  const int n = (int)(row / h);
  const int r = (int)(row % h);
  const float s = __ldg(scale + n);
  const float* offs = off_c + (int64_t)n * nb;
  const T* base = img + (int64_t)n * h * w;
  T* dst = out + row * w;
  const int len = axis == 2 ? w : h;
  const float row_off = axis == 2 ? __ldg(offs + r / block) : 0.f;

  for (int x = threadIdx.x; x < w; x += kThreads) {
    const int t = axis == 2 ? x : r;
    const float off = axis == 2 ? row_off : __ldg(offs + x / block);
    const float grid = __fadd_rn(__fmul_rn(s, (float)t), off);
    // clamping j0 to [-2, len] keeps the int cast defined and changes
    // neither tap's validity
    const float j0f = fminf(fmaxf(floorf(grid), -2.f), (float)len);
    const float f = __fsub_rn(grid, floorf(grid));
    const int j0 = (int)j0f;
    float w0 = (j0 >= 0 && j0 <= len - 1) ? __fsub_rn(1.f, f) : 0.f;
    float w1 = (j0 + 1 >= 0 && j0 + 1 <= len - 1) ? f : 0.f;
    const int j0c = min(max(j0, 0), len - 1);
    const int j1c = min(max(j0 + 1, 0), len - 1);
    float a, b;
    if (axis == 2) {
      a = load_f32(base + (int64_t)r * w + j0c);
      b = load_f32(base + (int64_t)r * w + j1c);
    } else {
      a = load_f32(base + (int64_t)j0c * w + x);
      b = load_f32(base + (int64_t)j1c * w + x);
    }
    if (bf16_math) {
      w0 = round_bf16(w0);
      w1 = round_bf16(w1);
      a = round_bf16(a);
      b = round_bf16(b);
    }
    store(dst + x, __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)));
  }
}

}  // namespace

// img and out (n, h, w) contiguous, same dtype (0 float32, 1 bfloat16);
// scale (n,) and off_c (n, nb) float32 on the device. axis 2 resamples along
// W with blocks of rows, axis 1 along H with blocks of columns.
// Returns cudaGetLastError().
extern "C" int warp_resample(const void* img, void* out, const float* scale,
                             const float* off_c, int n, int h, int w, int block,
                             int nb, int axis, int dtype, int bf16_math,
                             void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || block <= 0 || nb <= 0 ||
      (axis != 1 && axis != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = (int64_t)n * h;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      resample_kernel<float><<<(unsigned)rows, kThreads, 0, s>>>(
          (const float*)img, (float*)out, scale, off_c, h, w, block, nb, axis,
          bf16_math);
      break;
    case 1:
      resample_kernel<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, s>>>(
          (const __nv_bfloat16*)img, (__nv_bfloat16*)out, scale, off_c, h, w,
          block, nb, axis, bf16_math);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
