// Depthwise 3x3x3 SAME convolution for Hopper (sm_90a), channels-last.
//
// Replaces the TPU kernel ball_action_spotting_tpu/ops/pallas_dwconv3d.py
// (dwconv3d -> _dw_kernel): out[n,t,h,w,c] = sum over the 27 taps of
// x[n, t+dt-1, h+dh-1, w+dw-1, c] * k[dt,dh,dw,c], zero outside the clip in
// T, H and W, summed in f32 and stored in x's type.
//
// Bound on an H100 SXM. At the TTA-on shape (256, 5, 23, 40, 576) bf16 one
// launch must read 1.36 GB and write 1.36 GB, 0.81 ms at 3.35 TB/s; its 27
// float32 FMAs per output element, 18.3 G FMAs, take 0.55 ms at 67 TFLOP/s.
// With the shared loads and the bf16 -> f32 conversions on top, bytes and
// instructions are close to balanced, so the design cuts wasted
// instructions as well as wasted bytes.
//
// Design. A block owns a tile of `rows` output rows and 64 channels (32
// lanes, one channel pair each) of one clip n and walks T itself: the grid
// is (row tiles x channel tiles, n).
// - Re-staging. Shared memory holds a ring of three slice slots, each the
//   (rows + 2) halo rows x W positions x 32 pairs of one input slice,
//   [row][w][lane]. Before the loop the block stages slice 0 and zeroes the
//   slot of slice -1; at step t it stages slice t + 1 into the slot that
//   slice t - 2 held (slice T is zeros), waits, and computes output slice t
//   from the slots of t - 1, t and t + 1. Each input slice is staged
//   (rows + 2) / rows times (1.4x at the flagship shape), not
//   3 (rows + 2) / rows as when every block staged three slices for one t.
//   Positions outside the clip in T and H are zero-filled by the copy itself
//   (src-size 0), where the TPU kernel zeroes the edge taps instead.
// - Copies. Staging uses 16-byte cp.async.cg copies spread over all the
//   block's threads where C * itemsize is a multiple of 16 and x is 16-byte
//   aligned, else one pair per 4- or 8-byte copy (the kWide template
//   parameter, chosen by the launcher; the staged layout is the same).
// - Occupancy. Two warps compute each output row, each sliding along half
//   of W; rows = 5 at bf16 W = 40 gives 10 warps and 105 KB of ring a
//   block, and the launch bounds hold the registers to 96 so that an SM
//   runs two blocks, 20 warps, one computing while the other waits on its
//   copies. `rows` is the most output rows an SM can hold: two blocks per
//   SM where the ring fits 113 KB, else one block of up to 227 KB (float32
//   at W = 40). A fourth slot, so that slice t + 2 loads while output t is
//   computed, was timed slower at either two blocks of 3 rows or one block
//   of 8 (dwconv3d_timing.py, kSlots = 4).
// - Instructions. Every input column, read once from shared memory, feeds
//   the three outputs it touches (w-1, w, w+1), whose f32 sums live in
//   registers with the lane's 27 taps. The three sums rotate roles from
//   column to column, unrolled by three so that no register is copied;
//   the sum of w+1 starts with a
//   multiply instead of a zeroed register, and bf16 widens by a shift or a
//   mask. W's zero padding is the absent column before the first and after
//   the last.
// A width the ring cannot stage at rows = 1, or an odd channel count, is
// refused (ops/dwconv3d.py routes the first to the grouped conv and pads the
// second); more than 65535 clips run as several launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                   // channel pairs per block: one warp
constexpr int kSlots = 3;                    // slice slots in the ring
constexpr int kMaxRows = 5;                  // output rows per block
constexpr int kMaxThreads = 2 * kMaxRows * kLanes;  // two warps per row
constexpr int kMinBlocks = 2;                // blocks per SM: at most 96 registers
constexpr int kSmemTwoBlocks = 113 * 1024;   // ring bytes with two blocks per SM
constexpr int kSmemOneBlock = 227 * 1024;    // ring bytes with one block per SM
constexpr int kMaxGridY = 65535;             // clips per launch

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
// a bf16 is the upper half of its float: one shift or mask per value
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  const unsigned u = *reinterpret_cast<const unsigned*>(&v);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 to_float2(__half2 v) { return __half22float2(v); }

template <typename T2> __device__ __forceinline__ T2 from_float2(float2 v);
template <> __device__ __forceinline__ float2 from_float2<float2>(float2 v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat162 from_float2<__nv_bfloat162>(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}
template <> __device__ __forceinline__ __half2 from_float2<__half2>(float2 v) {
  return __floats2half2_rn(v.x, v.y);
}

// cp.async of kBytes into shared memory; valid false writes zeros instead
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else {
    static_assert(kBytes == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void fma2(float2& acc, float2 v, float2 k) {
  acc.x = fmaf(v.x, k.x, acc.x);
  acc.y = fmaf(v.y, k.y, acc.y);
}

// Stage input slice ts of clip x_n into slot ([rows + 2][w_len][kLanes]
// pairs): halo rows h0 - 1 .. h0 + rows, the pairs cp0 .. cp0 + 31. Each
// position's 32 pairs are kChunks copies of kPairs pairs, spread over all
// the block's threads; rows outside H, slices outside T and pairs past C are
// zero-filled.
template <typename T2, bool kWide>
__device__ __forceinline__ void stage_slice(T2* slot, const T2* x_n, int ts, int t_len,
                                            int h0, int rows, int h_len, int w_len,
                                            int c_pairs, int cp0) {
  constexpr int kBytes = kWide ? 16 : (int)sizeof(T2);
  constexpr int kPairs = kBytes / (int)sizeof(T2);
  constexpr int kChunks = kLanes / kPairs;
  const int per_row = w_len * kChunks;
  const bool t_ok = ts >= 0 && ts < t_len;
  for (int rr = 0; rr < rows + 2; ++rr) {
    const int hs = h0 + rr - 1;
    const bool row_ok = t_ok && hs >= 0 && hs < h_len;
    const T2* src_row =
        row_ok ? x_n + ((size_t)ts * h_len + hs) * w_len * c_pairs + cp0 : x_n;
    T2* dst_row = slot + (size_t)rr * w_len * kLanes;
    for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
      const int w = i / kChunks;
      const int p = (i % kChunks) * kPairs;
      const bool ok = row_ok && cp0 + p < c_pairs;
      copy_async<kBytes>(dst_row + w * kLanes + p,
                         ok ? src_row + (size_t)w * c_pairs + p : x_n, ok);
    }
  }
}

// The 27 taps of one input column: in[off[dt * 3 + dh]] is its value in
// input slice t + dt - 1, row h + dh - 1. Column w adds to output w - 1
// (left) and w (mid) and starts output w + 1 (right).
template <typename T2>
__device__ __forceinline__ void column(const T2* in, const int (&off)[9],
                                       const float2 (&k)[27], float2& left, float2& mid,
                                       float2& right) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float2 v = to_float2(in[off[i]]);
    fma2(left, v, k[3 * i + 2]);  // column w is output w-1's right neighbour
    fma2(mid, v, k[3 * i + 1]);
    if (i == 0) {
      right = make_float2(v.x * k[0].x, v.y * k[0].y);
    } else {
      fma2(right, v, k[3 * i]);  // ... and output w+1's left neighbour
    }
  }
}

// grid: (row tiles * channel tiles, n); block: 2 * rows warps, two per
// output row, each over half of W
template <typename T2, bool kWide>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
dwconv3d_kernel(const T2* __restrict__ x, const float* __restrict__ taps,
                T2* __restrict__ out, int t_len, int h_len, int w_len, int c_pairs,
                int rows, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T2* ring = reinterpret_cast<T2*>(smem_raw);  // [kSlots][rows + 2][w_len][kLanes]
  const int slot_len = (rows + 2) * w_len * kLanes;
  const int row_tile = blockIdx.x % row_tiles;
  const int c_tile = blockIdx.x / row_tiles;
  const int n = blockIdx.y;
  const int h0 = row_tile * rows;
  const int cp0 = c_tile * kLanes;
  const size_t slice_len = (size_t)h_len * w_len * c_pairs;
  const T2* x_n = x + (size_t)n * t_len * slice_len;

  // slice s lives in slot (s + 1) % kSlots; the ring starts with slices
  // -1 .. kSlots - 3 in flight, one commit group each
  for (int s = -1; s <= kSlots - 3; ++s) {
    stage_slice<T2, kWide>(ring + (s + 1) * slot_len, x_n, s, t_len, h0, rows, h_len,
                           w_len, c_pairs, cp0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int r = warp / 2;
  const int h = h0 + r;
  const int cp = cp0 + lane;  // this lane's channel pair
  const int half_w = (w_len + 1) / 2;
  const int w_begin = warp % 2 ? half_w : 0;  // this warp's outputs [w_begin, w_end)
  const int w_end = warp % 2 ? w_len : half_w;
  const bool active = cp < c_pairs && h < h_len && w_begin < w_end;
  // the input columns that reach them, inside the clip
  const int col_first = w_begin > 0 ? w_begin - 1 : 0;
  const int col_last = w_end < w_len ? w_end : w_len - 1;

  float2 k[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    k[i] = cp < c_pairs ? make_float2(taps[(size_t)i * 2 * c_pairs + 2 * cp],
                                      taps[(size_t)i * 2 * c_pairs + 2 * cp + 1])
                        : make_float2(0.f, 0.f);
  }
  const int dh_stride = w_len * kLanes;
  const T2* col0 = ring + r * dh_stride + col_first * kLanes + lane;
  T2* out_n = out + (size_t)n * t_len * slice_len + (size_t)h * w_len * c_pairs + cp;

  for (int t = 0; t < t_len; ++t) {
    // slice t + kSlots - 2 into the slot that slice t - 2 held; then wait
    // for slice t + 1 (the newest group may stay in flight)
    const int s = t + kSlots - 2;
    stage_slice<T2, kWide>(ring + ((s + 1) % kSlots) * slot_len, x_n, s, t_len, h0, rows,
                           h_len, w_len, c_pairs, cp0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kSlots - 3) : "memory");
    __syncthreads();

    if (active) {
      // slices t - 1, t, t + 1 are in slots t, t + 1, t + 2 (mod kSlots)
      int off[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        off[i] = ((t + i / 3) % kSlots) * slot_len + (i % 3) * dh_stride;
      }
      T2* out_row = out_n + (size_t)t * slice_len;
      // a, b, c: the sums of outputs w-1, w, w+1 while column w streams in,
      // their roles rotating by one each column
      float2 a = make_float2(0.f, 0.f), b = a, c = a;
      int w = col_first;
      const T2* in = col0;  // column w
      for (; w + 2 <= col_last; w += 3, in += 3 * kLanes) {
        column(in, off, k, a, b, c);
        if (w - 1 >= w_begin) out_row[(size_t)(w - 1) * c_pairs] = from_float2<T2>(a);
        column(in + kLanes, off, k, b, c, a);
        if (w >= w_begin) out_row[(size_t)w * c_pairs] = from_float2<T2>(b);
        column(in + 2 * kLanes, off, k, c, a, b);
        out_row[(size_t)(w + 1) * c_pairs] = from_float2<T2>(c);
      }
      // the last one or two columns; `last` ends as the sum of output w_len - 1
      float2 last = a;
      if (w <= col_last) {
        column(in, off, k, a, b, c);
        if (w - 1 >= w_begin) out_row[(size_t)(w - 1) * c_pairs] = from_float2<T2>(a);
        last = b;
        if (w + 1 <= col_last) {
          column(in + kLanes, off, k, b, c, a);
          if (w >= w_begin) out_row[(size_t)w * c_pairs] = from_float2<T2>(b);
          last = c;
        }
      }
      // at the clip's right edge the last output has no column after it
      if (w_end == w_len) out_row[(size_t)(w_len - 1) * c_pairs] = from_float2<T2>(last);
    }
    __syncthreads();  // every warp is done with slice t - 1's slot before it is refilled
  }
}

template <typename T2, bool kWide>
int launch_tiled(const void* x, const float* taps, void* out, int n, int t, int h,
                 int w, int c, cudaStream_t stream) {
  const int c_pairs = c / 2;
  // one halo row of the ring: the same row in each slot
  const size_t row_bytes = (size_t)kSlots * w * kLanes * sizeof(T2);
  // output rows per block: the most rows an SM holds, two blocks per SM
  // unless one block of up to 227 KB holds more
  int rows = 0, per_sm = 0;
  const int budgets[2][2] = {{kSmemTwoBlocks, 2}, {kSmemOneBlock, 1}};
  for (const auto& budget : budgets) {
    int r = (int)(budget[0] / row_bytes) - 2;
    if (r > kMaxRows) r = kMaxRows;
    if (r > h) r = h;
    if (r >= 1 && r * budget[1] > per_sm) {
      rows = r;
      per_sm = r * budget[1];
    }
  }
  if (rows < 1) return (int)cudaErrorInvalidValue;  // W too wide to stage
  const int row_tiles = (h + rows - 1) / rows;
  rows = (h + row_tiles - 1) / row_tiles;  // even tiles: no more of them, less halo
  const size_t smem = row_bytes * (rows + 2);
  const long long blocks_x = (long long)row_tiles * ((c_pairs + kLanes - 1) / kLanes);
  if (blocks_x > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dwconv3d_kernel<T2, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the grid's y holds at most 65535 clips: larger n goes in slices, each
  // its own launch on the same stream (a clip's offset keeps x's alignment)
  const size_t clip_len = (size_t)t * h * w * c_pairs;
  for (int n0 = 0; n0 < n; n0 += kMaxGridY) {
    const int nn = n - n0 < kMaxGridY ? n - n0 : kMaxGridY;
    const dim3 grid((unsigned)blocks_x, nn);
    dwconv3d_kernel<T2, kWide><<<grid, 2 * rows * kLanes, smem, stream>>>(
        (const T2*)x + n0 * clip_len, taps, (T2*)out + n0 * clip_len, t, h, w, c_pairs,
        rows, row_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T2>
int launch(const void* x, const float* taps, void* out, int n, int t, int h, int w,
           int c, cudaStream_t stream) {
  // 16-byte copies need every position's channel tile on a 16-byte boundary
  const bool wide = (c * sizeof(T2) / 2) % 16 == 0 && (uintptr_t)x % 16 == 0;
  return wide ? launch_tiled<T2, true>(x, taps, out, n, t, h, w, c, stream)
              : launch_tiled<T2, false>(x, taps, out, n, t, h, w, c, stream);
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
