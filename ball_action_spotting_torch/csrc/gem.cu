// GeM pooling forward for Hopper (sm_90a): y[b, c] = mean_hw(max(x, eps)^p)^(1/p).
//
// Replaces the TPU kernel ball_action_spotting_tpu/ops/pallas_gem.py
// (gem_pool -> _gem_forward -> _gem_kernel), which does one VMEM pass per
// (batch row, 128-channel tile) block.
//
// Bound on an H100 SXM: memory. At the flagship head shape with hflip TTA
// (1280, 23, 40, 256) bf16 the kernel must read 603 MB once and write 1.3 MB,
// 0.18 ms at 3.35 TB/s. Its two transcendentals per element go to the
// special-function unit: x^p = ex2.approx(p * lg2.approx(x)) after the clamp,
// 2 x 301.5 M at 16 per clock per SM is ~0.14 ms, under the byte bound;
// full-precision logf/expf would cost ~35 instructions per element and bind
// on issue instead.
//
// Design: a block owns one batch row, a tile of channels and a share of the
// H*W positions. A lane loads 16 bytes per position (8 bf16 or fp16
// channels, 4 float32) and keeps one f32 sum per channel, so a warp covers a
// 256-channel (bf16) tile of one position; the block's kWarps warps split
// the positions and meet in shared memory, summed in a fixed order. Each
// lane unrolls four positions so that four 16-byte loads are in flight.
// Where C * itemsize is not a multiple of 16 or x is not 16-byte aligned, a
// lane loads one channel (kVec = 1) and a warp covers 32 channels.
// Where batch rows x channel tiles give fewer than about two blocks per SM
// (the train head, 4 x 5 tiles), the wrapper splits H*W over `splits` blocks:
// each writes its f32 partial sums to a scratch (splits, b, c), and a second
// launch sums the splits in order and takes the root. No float atomics: the
// result is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // warps per block, splitting the positions
constexpr int kUnroll = 4;   // positions in flight per lane
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// kVec channels of T from one load: 16 bytes, or one element where kVec = 1.
template <typename T, int kVec> struct Load;
template <int kVec> struct Load<float, kVec> {
  static_assert(kVec == 4 || kVec == 1, "float32 loads 4 or 1");
  __device__ __forceinline__ static void run(const float* p, float (&v)[kVec]) {
    if constexpr (kVec == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
      v[0] = __ldg(p);
    }
  }
};
template <int kVec> struct Load<__nv_bfloat16, kVec> {
  static_assert(kVec == 8 || kVec == 1, "bf16 loads 8 or 1");
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float (&v)[kVec]) {
    if constexpr (kVec == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its float
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
      v[0] = __bfloat162float(__ldg(p));
    }
  }
};
template <int kVec> struct Load<__half, kVec> {
  static_assert(kVec == 8 || kVec == 1, "fp16 loads 8 or 1");
  __device__ __forceinline__ static void run(const __half* p, float (&v)[kVec]) {
    if constexpr (kVec == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __half22float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      v[0] = __half2float(__ldg(p));
    }
  }
};

// grid: b * tiles * splits blocks, block (split, tile, b) at
// ((b * tiles + tile) * splits + split); kWarps warps of 32 lanes.
// splits == 1 writes y to out; else the sums to partial[split, b, c].
template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
gem_partial_kernel(const T* __restrict__ x, const float* __restrict__ p_ptr,
                   float* __restrict__ out, float* __restrict__ partial, int b_len,
                   int hw, int c, int splits, float eps) {
  constexpr int kTile = 32 * kVec;
  __shared__ float sums[kWarps][kTile];
  const int tiles = (c + kTile - 1) / kTile;
  const int split = blockIdx.x % splits;
  const int tile = (blockIdx.x / splits) % tiles;
  const int b = blockIdx.x / (splits * tiles);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ch = tile * kTile + lane * kVec;  // this lane's first channel
  const int begin = (int)((int64_t)hw * split / splits);
  const int end = (int)((int64_t)hw * (split + 1) / splits);
  const float p = __ldg(p_ptr);

  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  if (ch < c) {  // c % kVec == 0: a lane's channels are all in range or all out
    const T* base = x + (size_t)b * hw * c + ch;
    int i = begin + warp;
    for (; i + (kUnroll - 1) * kWarps < end; i += kUnroll * kWarps) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Load<T, kVec>::run(base + (size_t)(i + u * kWarps) * c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += ex2(p * lg2(fmaxf(v[u][e], eps)));
      }
    }
    for (; i < end; i += kWarps) {
      float v[kVec];
      Load<T, kVec>::run(base + (size_t)i * c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += ex2(p * lg2(fmaxf(v[e], eps)));
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) sums[warp][lane * kVec + e] = acc[e];
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kWarps * 32) {
    const int cj = tile * kTile + j;
    if (cj >= c) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sums[w][j];
    if (splits == 1) {
      out[(size_t)b * c + cj] = ex2(lg2(sum / (float)hw) / p);
    } else {
      partial[((size_t)split * b_len + b) * c + cj] = sum;
    }
  }
}

// y[b, c] from the splits' partial sums, added in split order.
__global__ void __launch_bounds__(kFinishThreads)
gem_finish_kernel(const float* __restrict__ partial, const float* __restrict__ p_ptr,
                  float* __restrict__ out, int64_t bc, int hw, int splits) {
  const int64_t i = (int64_t)blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= bc) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[s * bc + i];
  out[i] = ex2(lg2(sum / (float)hw) / __ldg(p_ptr));
}

template <typename T, int kVec>
int launch(const void* x, const float* p, float* out, float* partial, int b, int hw, int c,
           int splits, float eps, cudaStream_t stream) {
  constexpr int kTile = 32 * kVec;
  if (kVec > 1 && (c % kVec || (uintptr_t)x % 16)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)b * ((c + kTile - 1) / kTile) * splits;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gem_partial_kernel<T, kVec><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const T*)x, p, out, partial, b, hw, c, splits, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t bc = (int64_t)b * c;
  gem_finish_kernel<<<(unsigned)((bc + kFinishThreads - 1) / kFinishThreads),
                      kFinishThreads, 0, stream>>>(partial, p, out, bc, hw, splits);
  return (int)cudaGetLastError();
}

template <typename T, int kWideVec>
int launch_width(const void* x, const float* p, float* out, float* partial, int b, int hw,
                 int c, int splits, float eps, int wide, cudaStream_t stream) {
  return wide ? launch<T, kWideVec>(x, p, out, partial, b, hw, c, splits, eps, stream)
              : launch<T, 1>(x, p, out, partial, b, hw, c, splits, eps, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. x is (b, hw, c) contiguous,
// p one float on the device, out (b, c) float32. wide 1 takes the 16-byte
// loads (c * itemsize % 16 == 0 and x 16-byte aligned). splits > 1 splits
// hw over that many blocks per channel tile and needs partial, a float32
// scratch of (splits, b, c); it is two launches. Returns cudaGetLastError().
extern "C" int gem_forward(const void* x, const float* p, float* out, float* partial, int b,
                           int hw, int c, float eps, int dtype, int wide, int splits,
                           void* stream) {
  if (b <= 0 || hw <= 0 || c <= 0 || splits <= 0 || splits > hw ||
      (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_width<float, 4>(x, p, out, partial, b, hw, c, splits, eps, wide, s);
    case 1:
      return launch_width<__nv_bfloat16, 8>(x, p, out, partial, b, hw, c, splits, eps, wide,
                                            s);
    case 2:
      return launch_width<__half, 8>(x, p, out, partial, b, hw, c, splits, eps, wide, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
