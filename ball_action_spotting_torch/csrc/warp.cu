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
// off_c[n, blk] is the offset at the block's center row (or column),
// offsets[n, min(blk * block + block / 2, len - 1)], as the TPU kernel's
// scalar prefetch reads it; the kernel reads it from the full (n, len)
// offsets itself. In bf16 mode the weights and the image are rounded to bf16
// (the TPU kernel casts its matrix and the block to bf16) and the two
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
// rate. So the design keeps many 16-byte accesses in flight per SM:
// - V pass (resample_cols_wide): a thread owns one output row and 8 (bf16,
//   fp16) or 4 (f32) neighbouring columns inside one column block, so grid,
//   taps and weights are computed once for the vector; it reads one 16-byte
//   vector from each of the two tap rows and writes one.
// - H pass (resample_rows_wide): a block stages kRowsH whole input rows in
//   shared memory with 16-byte cp.async copies; each thread computes a
//   vector of neighbouring outputs from the staged row (any scale, flips
//   included) and writes it with one 16-byte store.
// Where W * itemsize is not a multiple of 16, a pointer is not 16-byte
// aligned, the V pass's block is not a multiple of the vector or the H
// pass's row does not fit shared memory, resample_narrow does one element
// per thread (the wrapper ops/warp.py decides, and this file checks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsH = 8;                       // rows staged by an H-pass block
constexpr int kSmemH = 227 * 1024;              // most shared memory of one block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A 16-byte vector of kN elements of T, widened to float.
template <typename T> struct Vec {
  static constexpr int kN = 16 / (int)sizeof(T);
  __device__ __forceinline__ static void unpack(uint4 u, float (&v)[kN]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = to_f32(e[i]);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[kN]) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kN; ++i) e[i] = from_f32<T>(v[i]);
    return u;
  }
};

// The two taps and weights of output coordinate t, see the header.
struct Taps {
  int j0c, j1c;
  float w0, w1;
};

template <bool kRound>
__device__ __forceinline__ Taps taps_at(float s, int t, float off, int len) {
  const float grid = __fadd_rn(__fmul_rn(s, (float)t), off);
  // clamping j0 to [-2, len] keeps the int cast defined and changes
  // neither tap's validity
  const float j0f = fminf(fmaxf(floorf(grid), -2.f), (float)len);
  const float f = __fsub_rn(grid, floorf(grid));
  const int j0 = (int)j0f;
  Taps k;
  k.w0 = (j0 >= 0 && j0 <= len - 1) ? __fsub_rn(1.f, f) : 0.f;
  k.w1 = (j0 + 1 >= 0 && j0 + 1 <= len - 1) ? f : 0.f;
  if (kRound) {
    k.w0 = round_bf16(k.w0);
    k.w1 = round_bf16(k.w1);
  }
  k.j0c = min(max(j0, 0), len - 1);
  k.j1c = min(max(j0 + 1, 0), len - 1);
  return k;
}

// A tap's value in f32; bf16 mode rounds it to bf16, which a bf16 image
// already is.
template <typename T, bool kRound>
__device__ __forceinline__ float tap(float v) {
  if constexpr (kRound && !std::is_same_v<T, __nv_bfloat16>) {
    return round_bf16(v);
  } else {
    return v;
  }
}

__device__ __forceinline__ float blend(const Taps& k, float a, float b) {
  return __fadd_rn(__fmul_rn(k.w0, a), __fmul_rn(k.w1, b));
}

__device__ __forceinline__ float center_offset(const float* offs, int blk, int block,
                                               int len) {
  return __ldg(offs + min(blk * block + block / 2, len - 1));
}

// V pass, 16-byte path: one thread per (image, output row y, vector of kN
// columns); the vector lies in one column block (block % kN == 0), so it
// shares the offset, the taps and the weights.
template <typename T, bool kRound>
__global__ void __launch_bounds__(kThreads)
resample_cols_wide(const T* __restrict__ img, T* __restrict__ out,
                   const float* __restrict__ scale, const float* __restrict__ offsets,
                   int n, int h, int w, int block) {
  using V = Vec<T>;
  const int vecs = w / V::kN;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n * h * vecs) return;
  const int64_t row = i / vecs;  // over (n, H)
  const int x = (int)(i - row * vecs) * V::kN;
  const int b = (int)(row / h);
  const int y = (int)(row - (int64_t)b * h);
  const float off = center_offset(offsets + (int64_t)b * w, x / block, block, w);
  const Taps k = taps_at<kRound>(__ldg(scale + b), y, off, h);
  const T* base = img + (int64_t)b * h * w + x;
  float a[V::kN], c[V::kN], o[V::kN];
  V::unpack(__ldg(reinterpret_cast<const uint4*>(base + (int64_t)k.j0c * w)), a);
  V::unpack(__ldg(reinterpret_cast<const uint4*>(base + (int64_t)k.j1c * w)), c);
#pragma unroll
  for (int e = 0; e < V::kN; ++e) {
    o[e] = blend(k, tap<T, kRound>(a[e]), tap<T, kRound>(c[e]));
  }
  *reinterpret_cast<uint4*>(out + row * w + x) = V::pack(o);
}

// A staged element in f32, from its 32-bit shared-memory address.
__device__ __forceinline__ float lds_f32(unsigned addr, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float lds_f32(unsigned addr, __nv_bfloat16) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return __uint_as_float((unsigned)v << 16);  // a bf16 is the upper half of its float
}
__device__ __forceinline__ float lds_f32(unsigned addr, __half) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return __half2float(__ushort_as_half(v));
}

// H pass, 16-byte path: a block stages `rows` (at most kRowsH) whole input
// rows of one image in shared memory with their center offsets, then each
// thread computes vectors of kN neighbouring outputs from them and stores
// each with one 16-byte store. A thread steps through the block's (row,
// vector) items by kThreads without dividing.
template <typename T, bool kRound>
__global__ void __launch_bounds__(kThreads)
resample_rows_wide(const T* __restrict__ img, T* __restrict__ out,
                   const float* __restrict__ scale, const float* __restrict__ offsets,
                   int h, int w, int block, int rows) {
  using V = Vec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float row_off[kRowsH];
  T* staged = reinterpret_cast<T*>(smem_raw);  // [rows][w]
  const int tiles = (h + rows - 1) / rows;
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - b * tiles) * rows;
  const int nrows = min(rows, h - r0);
  const int vecs = w / V::kN;
  const T* src = img + ((int64_t)b * h + r0) * w;
  for (int i = threadIdx.x; i < nrows * vecs; i += kThreads) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(staged + (int64_t)i * V::kN);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src + (int64_t)i * V::kN) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (threadIdx.x < nrows) {
    row_off[threadIdx.x] =
        center_offset(offsets + (int64_t)b * h, (r0 + threadIdx.x) / block, block, h);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float s = __ldg(scale + b);
  const unsigned staged_addr = (unsigned)__cvta_generic_to_shared(staged);
  T* dst = out + ((int64_t)b * h + r0) * w;
  const int step_r = kThreads / vecs;             // rows and vectors a step
  const int step_x = kThreads - step_r * vecs;    // advances the item by
  int rr = threadIdx.x / vecs;
  int xv = threadIdx.x - rr * vecs;
  while (rr < nrows) {
    const float off = row_off[rr];
    const unsigned line = staged_addr + (unsigned)(rr * w) * (unsigned)sizeof(T);
    const int x0 = xv * V::kN;
    float o[V::kN];
#pragma unroll
    for (int e = 0; e < V::kN; ++e) {
      const Taps k = taps_at<kRound>(s, x0 + e, off, w);
      o[e] = blend(k, tap<T, kRound>(lds_f32(line + k.j0c * (unsigned)sizeof(T), T())),
                   tap<T, kRound>(lds_f32(line + k.j1c * (unsigned)sizeof(T), T())));
    }
    *reinterpret_cast<uint4*>(dst + (int64_t)rr * w + x0) = V::pack(o);
    xv += step_x;
    rr += step_r;
    if (xv >= vecs) {
      xv -= vecs;
      ++rr;
    }
  }
}

// Any shape: one block of kThreads per output row, one element per thread.
template <typename T, bool kRound>
__global__ void __launch_bounds__(kThreads)
resample_narrow(const T* __restrict__ img, T* __restrict__ out,
                const float* __restrict__ scale, const float* __restrict__ offsets,
                int h, int w, int block, int axis) {
  const int64_t row = blockIdx.x;  // output row over (n, H)
  const int b = (int)(row / h);
  const int r = (int)(row % h);
  const float s = __ldg(scale + b);
  const int len = axis == 2 ? w : h;
  const float* offs = offsets + (int64_t)b * (axis == 2 ? h : w);
  const T* base = img + (int64_t)b * h * w;
  T* dst = out + row * w;
  const float row_off = axis == 2 ? center_offset(offs, r / block, block, h) : 0.f;
  for (int x = threadIdx.x; x < w; x += kThreads) {
    const int t = axis == 2 ? x : r;
    const float off = axis == 2 ? row_off : center_offset(offs, x / block, block, w);
    const Taps k = taps_at<kRound>(s, t, off, len);
    float a, c;
    if (axis == 2) {
      a = to_f32(base[(int64_t)r * w + k.j0c]);
      c = to_f32(base[(int64_t)r * w + k.j1c]);
    } else {
      a = to_f32(base[(int64_t)k.j0c * w + x]);
      c = to_f32(base[(int64_t)k.j1c * w + x]);
    }
    dst[x] = from_f32<T>(blend(k, tap<T, kRound>(a), tap<T, kRound>(c)));
  }
}

template <typename T>
int h_rows(int w) {
  const size_t row_bytes = (size_t)w * sizeof(T);
  const size_t rows = row_bytes * kRowsH <= 24 * 1024 ? kRowsH : 24 * 1024 / row_bytes;
  return rows >= 1 ? (int)rows : (row_bytes <= (size_t)kSmemH ? 1 : 0);
}

template <typename T, bool kRound>
int launch(const void* img, void* out, const float* scale, const float* offsets, int n,
           int h, int w, int block, int axis, int wide, cudaStream_t stream) {
  const T* x = (const T*)img;
  T* y = (T*)out;
  if (!wide) {
    const int64_t rows = (int64_t)n * h;
    if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
    resample_narrow<T, kRound><<<(unsigned)rows, kThreads, 0, stream>>>(
        x, y, scale, offsets, h, w, block, axis);
    return (int)cudaGetLastError();
  }
  constexpr int kN = Vec<T>::kN;
  if (w % kN || (uintptr_t)img % 16 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  if (axis == 1) {
    if (block % kN) return (int)cudaErrorInvalidValue;
    const int64_t blocks = ((int64_t)n * h * (w / kN) + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    resample_cols_wide<T, kRound><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, scale, offsets, n, h, w, block);
    return (int)cudaGetLastError();
  }
  const int rows = h_rows<T>(w);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * w * sizeof(T);
  const int64_t blocks = (int64_t)n * ((h + rows - 1) / rows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_rows_wide<T, kRound>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  resample_rows_wide<T, kRound><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, scale, offsets, h, w, block, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mode(const void* img, void* out, const float* scale, const float* offsets, int n,
                int h, int w, int block, int axis, int bf16_math, int wide,
                cudaStream_t stream) {
  return bf16_math
             ? launch<T, true>(img, out, scale, offsets, n, h, w, block, axis, wide, stream)
             : launch<T, false>(img, out, scale, offsets, n, h, w, block, axis, wide, stream);
}

}  // namespace

// img and out (n, h, w) contiguous, same dtype (0 float32, 1 bfloat16,
// 2 float16); scale (n,) and offsets (n, h) for axis 2 or (n, w) for axis 1,
// float32 on the device. axis 2 resamples along W with blocks of rows, axis 1
// along H with blocks of columns. wide 1 takes the 16-byte path, which needs
// w * itemsize % 16 == 0, img and out 16-byte aligned and, for axis 1,
// block a multiple of 16 / itemsize. Returns cudaGetLastError().
extern "C" int warp_resample(const void* img, void* out, const float* scale,
                             const float* offsets, int n, int h, int w, int block,
                             int axis, int dtype, int bf16_math, int wide, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || block <= 0 || (axis != 1 && axis != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_mode<float>(img, out, scale, offsets, n, h, w, block, axis, bf16_math,
                                wide, s);
    case 1:
      return launch_mode<__nv_bfloat16>(img, out, scale, offsets, n, h, w, block, axis,
                                        bf16_math, wide, s);
    case 2:
      return launch_mode<__half>(img, out, scale, offsets, n, h, w, block, axis, bf16_math,
                                 wide, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
