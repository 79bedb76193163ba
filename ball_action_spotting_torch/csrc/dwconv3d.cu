// Depthwise 3x3x3 SAME convolution for Hopper (sm_90a), channels-last.
//
// Replaces the TPU kernel ball_action_spotting_tpu/ops/pallas_dwconv3d.py
// (dwconv3d -> _dw_kernel): out[n,t,h,w,c] = sum over the 27 taps of
// x[n, t+dt-1, h+dh-1, w+dw-1, c] * k[dt,dh,dw,c], zero outside the clip in
// T, H and W, summed in f32 and stored in x's type.
//
// Bound on an H100 SXM: memory. At the flagship shape (128, 5, 23, 40, 576)
// bf16 one launch must read 678 MB and write 678 MB, about 0.41 ms at
// 3.35 TB/s; its 54 flops per element are far below the card's rate.
//
// Design: each block owns one (n, t), a tile of `rows` output rows and a
// tile of 64 channels, one warp per output row; each lane holds a pair of
// neighbouring channels, so a warp moves 128 contiguous bytes of a
// channels-last row at a time. The block stages the 3 x (rows+2) x W halo
// of its channels in shared memory with cp.async, which zero-fills every
// position outside the clip in T and H (the clip's first and last frame
// included, where the TPU kernel masks the taps instead) and keeps many
// copies in flight without holding registers. Each warp then slides along
// its row: every input column, read once from shared memory, feeds the
// three outputs it touches (w-1, w, w+1), whose f32 sums live in registers
// with the channel pair's 27 taps; W's zero padding is the absent column
// before the first and after the last. Unlike the TPU kernel there is no
// fallback for large frames: a width the shared memory cannot stage, or an
// odd channel count, is refused.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                 // channel pairs per block: one warp
constexpr int kMaxRows = 8;                // warps (output rows) per block
constexpr int kSmemBudget = 113 * 1024;    // halo bytes: two blocks per SM

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_float2(__half2 v) { return __half22float2(v); }

template <typename T2> __device__ __forceinline__ T2 from_float2(float2 v);
template <> __device__ __forceinline__ float2 from_float2<float2>(float2 v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat162 from_float2<__nv_bfloat162>(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}
template <> __device__ __forceinline__ __half2 from_float2<__half2>(float2 v) {
  return __floats2half2_rn(v.x, v.y);
}

// cp.async of one T2 into shared memory; src_bytes 0 writes zeros instead
template <typename T2>
__device__ __forceinline__ void copy_async(T2* dst, const T2* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? (int)sizeof(T2) : 0;
  if constexpr (sizeof(T2) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void fma2(float2& acc, float2 v, float2 k) {
  acc.x = fmaf(v.x, k.x, acc.x);
  acc.y = fmaf(v.y, k.y, acc.y);
}

// grid: (row tiles * channel tiles, t, n); block: (kLanes, rows)
template <typename T2>
__global__ void __launch_bounds__(kLanes * kMaxRows)
dwconv3d_kernel(const T2* __restrict__ x, const float* __restrict__ taps,
                T2* __restrict__ out, int t_len, int h_len, int w_len, int c_pairs,
                int rows, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* halo = reinterpret_cast<T2*>(smem_raw);  // [3][rows + 2][w_len][kLanes]
  const int lane = threadIdx.x;
  const int row_tile = blockIdx.x % row_tiles;
  const int c_tile = blockIdx.x / row_tiles;
  const int t = blockIdx.y;
  const int n = blockIdx.z;
  const int h0 = row_tile * rows;
  const int cp = c_tile * kLanes + lane;  // this lane's channel pair
  const bool cp_ok = cp < c_pairs;
  const int hp = rows + 2;

  // stage the halo row by row, (dt, rr), one channel pair per lane; the
  // warps split each row's columns
  for (int dt = 0; dt < 3; ++dt) {
    const int ts = t + dt - 1;
    for (int rr = 0; rr < hp; ++rr) {
      const int hs = h0 + rr - 1;
      const bool valid = cp_ok && ts >= 0 && ts < t_len && hs >= 0 && hs < h_len;
      const T2* src = valid
          ? x + (((size_t)n * t_len + ts) * h_len + hs) * w_len * c_pairs + cp
          : x;
      T2* dst = halo + (size_t)(dt * hp + rr) * w_len * kLanes + lane;
      for (int w = threadIdx.y; w < w_len; w += blockDim.y) {
        copy_async(dst + w * kLanes, valid ? src + (size_t)w * c_pairs : x, valid);
      }
    }
  }

  float2 k[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    k[i] = cp_ok ? make_float2(taps[(size_t)i * 2 * c_pairs + 2 * cp],
                               taps[(size_t)i * 2 * c_pairs + 2 * cp + 1])
                 : make_float2(0.f, 0.f);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int r = threadIdx.y;
  const int h = h0 + r;
  if (!cp_ok || h >= h_len) return;
  T2* out_row = out + ((((size_t)n * t_len + t) * h_len + h) * w_len) * c_pairs + cp;
  const T2* in_col = halo + (size_t)r * w_len * kLanes + lane;
  const int dh_stride = w_len * kLanes;
  const int dt_stride = hp * dh_stride;
  // prev, cur, next: the sums of outputs w-1, w, w+1 while column w streams in
  float2 prev = make_float2(0.f, 0.f), cur = prev, next = prev;
  for (int w = 0; w < w_len; ++w, in_col += kLanes) {
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const float2 v = to_float2(in_col[dt * dt_stride + dh * dh_stride]);
        const int tap = (dt * 3 + dh) * 3;
        fma2(prev, v, k[tap + 2]);  // column w is output w-1's right neighbour
        fma2(cur, v, k[tap + 1]);
        fma2(next, v, k[tap + 0]);  // ... and output w+1's left neighbour
      }
    }
    if (w > 0) out_row[(size_t)(w - 1) * c_pairs] = from_float2<T2>(prev);
    prev = cur;
    cur = next;
    next = make_float2(0.f, 0.f);
  }
  out_row[(size_t)(w_len - 1) * c_pairs] = from_float2<T2>(prev);
}

template <typename T2>
int launch(const void* x, const float* taps, void* out, int n, int t, int h,
           int w, int c, cudaStream_t stream) {
  const int c_pairs = c / 2;
  const size_t row_bytes = (size_t)3 * w * kLanes * sizeof(T2);
  int rows = (int)(kSmemBudget / row_bytes) - 2;
  if (rows < 1) return (int)cudaErrorInvalidValue;  // W too wide to stage
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows > h) rows = h;
  const size_t smem = row_bytes * (rows + 2);
  const int row_tiles = (h + rows - 1) / rows;
  const long long blocks_x = (long long)row_tiles * ((c_pairs + kLanes - 1) / kLanes);
  if (blocks_x > 2147483647LL || t > 65535 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dwconv3d_kernel<T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_x, t, n);
  const dim3 block(kLanes, rows);
  dwconv3d_kernel<T2><<<grid, block, smem, stream>>>(
      (const T2*)x, taps, (T2*)out, t, h, w, c_pairs, rows, row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. x and out are (n, t, h, w, c)
// contiguous with c even, taps (27, c) float32 in (dt, dh, dw) order.
// Returns cudaGetLastError().
extern "C" int dwconv3d_forward(const void* x, const float* taps, void* out,
                                int n, int t, int h, int w, int c, int dtype,
                                void* stream) {
  if (n <= 0 || t <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float2>(x, taps, out, n, t, h, w, c, s);
    case 1: return launch<__nv_bfloat162>(x, taps, out, n, t, h, w, c, s);
    case 2: return launch<__half2>(x, taps, out, n, t, h, w, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
