// GeM pooling forward for Hopper (sm_90a): y[b, c] = mean_hw(max(x, eps)^p)^(1/p).
//
// Replaces the TPU kernel ball_action_spotting_tpu/ops/pallas_gem.py
// (gem_pool -> _gem_forward -> _gem_kernel), which does one VMEM pass per
// (batch row, 128-channel tile) block.
//
// Bound on an H100 SXM: memory. At the flagship head shape
// (640, 23, 40, 256) bf16 the kernel must read 301 MB once and write 655 KB,
// about 0.09 ms at 3.35 TB/s; its two transcendentals per element
// (x^p = exp(p*log x)) are far below the card's arithmetic rate.
//
// Design: each block owns one batch row and a tile of 32 channels. A warp
// runs along C, where channels-last rows are contiguous, so each warp load
// covers whole 32-byte sectors; the block's 8 warps split the H*W loop and
// meet in shared memory for the final sum. Every element is read once,
// clamped, raised to p and summed in f32; one thread per channel then takes
// exp(log(mean)/p). p is read from device memory, never from the host.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 32;  // channels per block: one warp along C
constexpr int kRows = 8;    // warps per block, splitting the H*W loop

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
gem_forward_kernel(const T* __restrict__ x, const float* __restrict__ p_ptr,
                   float* __restrict__ out, int hw, int c, float eps) {
  __shared__ float partial[kRows][kTileC];
  const int b = blockIdx.x;
  const int ch = blockIdx.y * kTileC + threadIdx.x;
  const float p = __ldg(p_ptr);
  float acc = 0.f;
  if (ch < c) {
    const T* base = x + (size_t)b * hw * c + ch;
    for (int i = threadIdx.y; i < hw; i += kRows) {
      const float v = fmaxf(to_f32(base[(size_t)i * c]), eps);
      acc += expf(p * logf(v));
    }
  }
  partial[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) sum += partial[r][threadIdx.x];
    out[(size_t)b * c + ch] = expf(logf(sum / (float)hw) / p);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. x is (b, hw, c) contiguous,
// p one float on the device, out (b, c) float32. Returns cudaGetLastError().
extern "C" int gem_forward(const void* x, const float* p, float* out, int b,
                           int hw, int c, float eps, int dtype, void* stream) {
  if (b <= 0 || hw <= 0 || c <= 0 || (c + kTileC - 1) / kTileC > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(b, (c + kTileC - 1) / kTileC);
  const dim3 block(kTileC, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      gem_forward_kernel<float><<<grid, block, 0, s>>>(
          (const float*)x, p, out, hw, c, eps);
      break;
    case 1:
      gem_forward_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          (const __nv_bfloat16*)x, p, out, hw, c, eps);
      break;
    case 2:
      gem_forward_kernel<__half><<<grid, block, 0, s>>>(
          (const __half*)x, p, out, hw, c, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
