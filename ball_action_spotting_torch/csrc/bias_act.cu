// The folded BatchNorm's inference epilogue for Hopper (sm_90a), one pass:
//   y = act(round(x + bias[c]))          act: SiLU or none
//   y = round(y + residual)              where a residual is given
// over a dense tensor viewed as (rows, C, inner): the channel axis innermost
// (inner = 1; the encoder's channels-last NCHW maps, as NHWC, and the 3D
// head's (N, T, H, W, C)) or a plane of `inner` elements per channel (an
// NCHW map in contiguous memory, inner = H * W, which the serving engines'
// stem hands over), so that the output keeps the input's layout.
//
// Replaces no TPU kernel: XLA fuses the folded BN's bias, the activation and
// the residual add into the conv's epilogue on the TPU, while PyTorch ran
// them as two or three elementwise passes over every conv output (the bias
// add broadcast off its vectorized path, SiLU, the residual add), about 232
// GB a chunk of whole-match prediction at 256 images of 1280x736. Added so
// that each conv output is read once and written once.
//
// Bound on an H100 SXM: the bytes. A bf16 element costs 4 bytes with SiLU
// (read, write) and 6 with a residual; at the prediction chunk's shapes that
// is 120.5 GB, 36 ms at 3.35 TB/s. The byte rate leaves an SM some 35-40
// instructions per element; SiLU's exact expf and IEEE division with the
// roundings take most of them, which holds the SiLU passes near three
// quarters of the byte bound and the bias + skip pass nearer nine tenths.
//
// Bit for bit the unfused PyTorch sequence, which rounds at each step:
//   1. x + bias.to(dtype) summed in float32, rounded to the dtype (RN);
//   2. SiLU of that value in float32 as ATen's CUDA kernel computes it,
//      v / (1 + expf(-v)), with the full-precision expf and the IEEE
//      division (no fast math), rounded to the dtype;
//   3. the residual added to the rounded output in float32, rounded.
// float32 tensors take the same steps with no rounding between them.
//
// Design: a thread owns one vector of channels (16 bytes: 8 bf16 or fp16, 4
// float32) and keeps their biases in registers as floats. The grid is one
// wave of kBlocksPerSm blocks on every SM; its threads split into `groups`
// vector columns (C / vector) times `step` rows, so that thread t starts at
// vector t, consecutive lanes read consecutive 16 bytes, and each thread
// walks down the rows `step` at a time with kUnroll rows (and their
// residuals) in flight. Loads take the read-only path (ld.global.nc) and
// stores are plain: streaming loads and stores (ld/st.global.cs) measured
// 1-2 % slower at the stem's and the head's shapes. Where
// C * itemsize is not a multiple of 16 or a pointer is not 16-byte aligned,
// a thread owns one channel (kVec = 1) instead; the prediction path never
// takes that route. Planes (inner > 1) take a plainer grid: blocks along a
// plane's vectors times blocks over the planes, each plane one bias.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // 1024 threads an SM; __launch_bounds__ caps registers at 64
constexpr int kUnroll = 4;       // rows in flight per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// The value the unfused path stores, read back as a float.
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return to_float(from_float<T>(v));
}

// The raw word a vector of kBytes is loaded and stored as.
template <int kBytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

template <typename T, int kVec> struct Pack {
  T v[kVec];
  using raw = typename Raw<sizeof(T) * kVec>::type;

  __device__ __forceinline__ static Pack load(const T* p) {
    const raw r = __ldg(reinterpret_cast<const raw*>(p));
    Pack out;
    memcpy(&out, &r, sizeof(raw));
    return out;
  }
  __device__ __forceinline__ void store(T* p) const {
    raw r;
    memcpy(&r, this, sizeof(raw));
    *reinterpret_cast<raw*>(p) = r;
  }
};

template <typename T, int kVec, bool kSilu, bool kResidual>
__device__ __forceinline__ Pack<T, kVec> epilogue(const Pack<T, kVec>& x, const float (&b)[kVec],
                                                  const Pack<T, kVec>& r) {
  Pack<T, kVec> y;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float v = rounded<T>(to_float(x.v[j]) + b[j]);
    if constexpr (kSilu) v = rounded<T>(v / (1.0f + expf(-v)));
    if constexpr (kResidual) v = v + to_float(r.v[j]);
    y.v[j] = from_float<T>(v);
  }
  return y;
}

// x, residual, out: rows * groups vectors of kVec elements; bias: C = groups
// * kVec elements. Thread t < step * groups owns column t % groups from row
// t / groups on, `step` rows at a time.
template <typename T, int kVec, bool kSilu, bool kResidual>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                const T* __restrict__ residual, T* __restrict__ out, int64_t rows, int groups,
                int64_t step) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= step * groups) return;
  const int column = static_cast<int>(t % groups);
  float b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) b[j] = to_float(bias[column * kVec + j]);

  using P = Pack<T, kVec>;
  const int64_t total = rows * groups;  // vectors
  const int64_t stride = step * groups;
  int64_t v = t;
  for (; v + (kUnroll - 1) * stride < total; v += kUnroll * stride) {
    P xs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xs[u] = P::load(x + (v + u * stride) * kVec);
      if constexpr (kResidual) rs[u] = P::load(residual + (v + u * stride) * kVec);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const P y = epilogue<T, kVec, kSilu, kResidual>(xs[u], b, rs[u]);
      y.store(out + (v + u * stride) * kVec);
    }
  }
  for (; v < total; v += stride) {
    P xs = P::load(x + v * kVec), rs;
    if constexpr (kResidual) rs = P::load(residual + v * kVec);
    epilogue<T, kVec, kSilu, kResidual>(xs, b, rs).store(out + v * kVec);
  }
}

// x, residual, out: planes * inner_vecs vectors of kVec elements, plane p
// holding channel p % channels; blocks along x walk a plane's vectors,
// blocks along y the planes.
template <typename T, int kVec, bool kSilu, bool kResidual>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bias_act_planes_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                       const T* __restrict__ residual, T* __restrict__ out, int64_t planes,
                       int channels, int64_t inner_vecs) {
  using P = Pack<T, kVec>;
  for (int64_t p = blockIdx.y; p < planes; p += gridDim.y) {
    const float bv = to_float(bias[p % channels]);
    float b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) b[j] = bv;
    const int64_t base = p * inner_vecs;
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; v < inner_vecs;
         v += static_cast<int64_t>(gridDim.x) * kThreads) {
      P xs = P::load(x + (base + v) * kVec), rs;
      if constexpr (kResidual) rs = P::load(residual + (base + v) * kVec);
      epilogue<T, kVec, kSilu, kResidual>(xs, b, rs).store(out + (base + v) * kVec);
    }
  }
}

template <typename T, int kVec, bool kSilu, bool kResidual>
cudaError_t launch_planes_with(const void* x, const void* bias, const void* residual, void* out,
                               int64_t planes, int channels, int64_t inner, int sms,
                               cudaStream_t stream) {
  const int64_t inner_vecs = inner / kVec;
  // about two waves in all: a plane's vectors first, then as many planes
  const int64_t wave = static_cast<int64_t>(sms) * kBlocksPerSm;
  int64_t bx = (inner_vecs + kThreads - 1) / kThreads;
  if (bx > wave) bx = wave;
  int64_t by = (2 * wave + bx - 1) / bx;
  if (by > planes) by = planes;
  if (by > 65535) by = 65535;
  bias_act_planes_kernel<T, kVec, kSilu, kResidual>
      <<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<const T*>(residual),
          static_cast<T*>(out), planes, channels, inner_vecs);
  return cudaGetLastError();
}

template <typename T, int kVec, bool kSilu, bool kResidual>
cudaError_t launch_with(const void* x, const void* bias, const void* residual, void* out,
                        int64_t rows, int channels, int sms, cudaStream_t stream) {
  const int groups = channels / kVec;
  const int64_t vectors = rows * groups;
  // one wave, fewer blocks where the tensor is small, never fewer threads than a row
  const int64_t wave = static_cast<int64_t>(sms) * kBlocksPerSm;
  int64_t blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  const int64_t least = (groups + kThreads - 1) / kThreads;
  if (blocks < least) blocks = least;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t step = blocks * kThreads / groups;
  const unsigned grid = static_cast<unsigned>(blocks);
  bias_act_kernel<T, kVec, kSilu, kResidual><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<const T*>(residual),
      static_cast<T*>(out), rows, groups, step);
  return cudaGetLastError();
}

template <typename T, int kVec, bool kSilu, bool kResidual>
cudaError_t launch_layout(const void* x, const void* bias, const void* residual, void* out,
                          int64_t rows, int channels, int64_t inner, int sms,
                          cudaStream_t stream) {
  return inner == 1
      ? launch_with<T, kVec, kSilu, kResidual>(x, bias, residual, out, rows, channels, sms,
                                               stream)
      : launch_planes_with<T, kVec, kSilu, kResidual>(x, bias, residual, out, rows * channels,
                                                      channels, inner, sms, stream);
}

template <typename T, int kVec>
cudaError_t launch_vec(const void* x, const void* bias, const void* residual, void* out,
                       int64_t rows, int channels, int64_t inner, int act, int sms,
                       cudaStream_t stream) {
  if (act == 1)
    return residual ? launch_layout<T, kVec, true, true>(x, bias, residual, out, rows, channels,
                                                         inner, sms, stream)
                    : launch_layout<T, kVec, true, false>(x, bias, residual, out, rows,
                                                          channels, inner, sms, stream);
  return residual ? launch_layout<T, kVec, false, true>(x, bias, residual, out, rows, channels,
                                                        inner, sms, stream)
                  : launch_layout<T, kVec, false, false>(x, bias, residual, out, rows, channels,
                                                         inner, sms, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* bias, const void* residual, void* out,
                   int64_t rows, int channels, int64_t inner, int act, int sms,
                   cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  // a vector lies within one row of channels, or within one plane
  const bool wide = (inner == 1 ? channels : inner) % kWide == 0 && aligned16(x) &&
                    aligned16(out) && (residual == nullptr || aligned16(residual));
  return wide ? launch_vec<T, kWide>(x, bias, residual, out, rows, channels, inner, act, sms,
                                     stream)
              : launch_vec<T, 1>(x, bias, residual, out, rows, channels, inner, act, sms,
                                 stream);
}

}  // namespace

// x, residual (or null), out: rows x channels x inner, dense (inner = 1:
// channels innermost), of dtype 0 float32, 1 bfloat16, 2 float16; bias:
// channels of the same dtype. act: 0 none, 1 SiLU. Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int bias_act_forward(const void* x, const void* bias, const void* residual,
                                void* out, long long rows, int channels, long long inner,
                                int dtype, int act, void* stream) {
  if (rows <= 0 || channels <= 0 || inner <= 0 || act < 0 || act > 1)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, bias, residual, out, rows, channels, inner, act, sms, s);
    case 1:
      return launch<__nv_bfloat16>(x, bias, residual, out, rows, channels, inner, act, sms, s);
    case 2: return launch<__half>(x, bias, residual, out, rows, channels, inner, act, sms, s);
    default: return cudaErrorInvalidValue;
  }
}
