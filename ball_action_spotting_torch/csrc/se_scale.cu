// The squeeze-excite gate multiply for Hopper (sm_90a), one pass:
//   out[n, r, c] = round(float(x[n, r, c]) * float(gate[n, c]))
// over a dense tensor of `images` images, each either rows of C values with
// the channel axis innermost (the encoder's channels-last NCHW maps, as NHWC,
// and the 3D head's (N, T, H, W, C): rows = H * W or T * H * W) or a plane
// of `rows` values per channel (an NCHW map in contiguous memory, as the
// space-to-depth stem's encoder keeps its maps), so that the output keeps the
// input's layout. The gate, (images, C) in x's dtype, is
// the sigmoid of the excite convs over the image's mean, which PyTorch
// computes beforehand.
//
// Replaces no TPU kernel: XLA fuses the SE scale into its neighbours on the
// TPU, while PyTorch ran it as a broadcast multiply whose (N, C, 1, 1)
// operand, stride 0 over a channels-last map, puts it on ATen's generic,
// unvectorized elementwise path at about 42 % of its byte bound. Added so
// that the map is read and written at the card's rate.
//
// Bound on an H100 SXM: the bytes. A bf16 element costs 4 (read, write);
// a chunk of whole-match prediction (256 images of 1280x736) moves 24.1 GB in
// the encoder's 16 SE blocks and 10.9 GB (15 frames) or 23.9 GB (33 frames)
// in the 3D head's four, 10.5 or 14.3 ms at 3.35 TB/s. One multiply and two
// conversions an element leave the SMs idle most of the time.
//
// Bit for bit ATen's `mul`: reduced types are widened to float32, multiplied
// once and rounded to the dtype (RN); float32 multiplies as it is.
//
// Design: a thread owns one vector of channels (16 bytes: 8 bf16 or fp16, 4
// float32) and keeps their gate values in registers as floats while it walks
// down the rows of one image, `step` rows at a time with kUnroll rows in
// flight. The grid is blocks along an image times images; the threads of one
// image's blocks split into `groups` vector columns (C / vector) times `step`
// rows, so that consecutive lanes read consecutive 16 bytes, no block
// straddles two images and no element needs an index division. An image gets
// as many blocks as give each thread about kUnroll rows: many short blocks,
// dozens of waves at the prediction chunk's 256 images and several at a
// serving tick's 16, so that the last wave's tail is short. On an H100 SXM
// that measured 0.837 ms at (256, 3680, 672), ATen's copy of the same map 0.834,
// against 0.919 with four waves of long-running blocks and 1.72 for ATen's
// broadcast multiply. Loads take the read-only path (ld.global.nc) and stores
// are plain: streaming loads (ld.global.cs) and evict-first stores
// (st.global.cs) measured 0.5-1.5 % slower. Where C * itemsize is not a
// multiple of 16 or a pointer is not 16-byte aligned, a thread owns one
// channel (kVec = 1) instead; the prediction path never takes that route.
// Planes take a plainer grid: blocks along a plane's vectors times blocks
// over the planes, each plane one gate value.

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

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> scaled(const Pack<T, kVec>& x, const float (&g)[kVec]) {
  Pack<T, kVec> y;
#pragma unroll
  for (int j = 0; j < kVec; ++j) y.v[j] = from_float<T>(to_float(x.v[j]) * g[j]);
  return y;
}

// x, out: images * rows * groups vectors of kVec elements; gate: images *
// groups * kVec elements. Thread t < step * groups of an image's blocks
// (blockIdx.x) owns column t % groups from row t / groups on, `step` rows at
// a time, in images blockIdx.y, blockIdx.y + gridDim.y, ...
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
se_scale_kernel(const T* __restrict__ x, const T* __restrict__ gate, T* __restrict__ out,
                int64_t images, int64_t rows, int groups, int64_t step) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= step * groups) return;
  const int column = static_cast<int>(t % groups);
  const int64_t first = t / groups;
  using P = Pack<T, kVec>;
  for (int64_t n = blockIdx.y; n < images; n += gridDim.y) {
    float g[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) g[j] = to_float(gate[(n * groups + column) * kVec + j]);
    const int64_t base = n * rows * groups + column;  // vectors
    int64_t r = first;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      P xs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        xs[u] = P::load(x + (base + (r + u * step) * groups) * kVec);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        scaled<T, kVec>(xs[u], g).store(out + (base + (r + u * step) * groups) * kVec);
    }
    for (; r < rows; r += step)
      scaled<T, kVec>(P::load(x + (base + r * groups) * kVec), g)
          .store(out + (base + r * groups) * kVec);
  }
}

// x, out: planes * inner_vecs vectors of kVec elements, plane p scaled by
// gate[p]; blocks along x walk a plane's vectors, blocks along y the planes.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
se_scale_planes_kernel(const T* __restrict__ x, const T* __restrict__ gate, T* __restrict__ out,
                       int64_t planes, int64_t inner_vecs) {
  using P = Pack<T, kVec>;
  for (int64_t p = blockIdx.y; p < planes; p += gridDim.y) {
    float g[kVec];
    const float gv = to_float(gate[p]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) g[j] = gv;
    const int64_t base = p * inner_vecs;
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; v < inner_vecs;
         v += static_cast<int64_t>(gridDim.x) * kThreads)
      scaled<T, kVec>(P::load(x + (base + v) * kVec), g).store(out + (base + v) * kVec);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, int kVec>
cudaError_t launch_rows(const void* x, const void* gate, void* out, int64_t images, int64_t rows,
                        int channels, cudaStream_t stream) {
  const int groups = channels / kVec;
  // about kUnroll rows a thread, and a thread for every column
  int64_t per_image = ceil_div(rows * groups, static_cast<int64_t>(kThreads) * kUnroll);
  const int64_t least = ceil_div(groups, kThreads);
  if (per_image < least) per_image = least;
  if (per_image > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t step = per_image * kThreads / groups;
  const unsigned gy = static_cast<unsigned>(images < 65535 ? images : 65535);
  se_scale_kernel<T, kVec><<<dim3(static_cast<unsigned>(per_image), gy), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate), static_cast<T*>(out), images, rows,
      groups, step);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_planes(const void* x, const void* gate, void* out, int64_t planes,
                          int64_t inner, int sms, cudaStream_t stream) {
  const int64_t inner_vecs = inner / kVec;
  // about two waves in all: a plane's vectors first, then as many planes
  const int64_t wave = static_cast<int64_t>(sms) * kBlocksPerSm;
  int64_t bx = ceil_div(inner_vecs, kThreads);
  if (bx > wave) bx = wave;
  int64_t by = ceil_div(2 * wave, bx);
  if (by > planes) by = planes;
  if (by > 65535) by = 65535;
  se_scale_planes_kernel<T, kVec>
      <<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(gate), static_cast<T*>(out), planes,
          inner_vecs);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* gate, void* out, int64_t images, int64_t rows,
                   int channels, bool planes, int sms, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  // a vector lies within one row of channels, or within one plane
  const bool wide = (planes ? rows : channels) % kWide == 0 && aligned16(x) && aligned16(out);
  if (planes)
    return wide ? launch_planes<T, kWide>(x, gate, out, images * channels, rows, sms, stream)
                : launch_planes<T, 1>(x, gate, out, images * channels, rows, sms, stream);
  return wide ? launch_rows<T, kWide>(x, gate, out, images, rows, channels, stream)
              : launch_rows<T, 1>(x, gate, out, images, rows, channels, stream);
}

}  // namespace

// x, out: images x rows x channels (planes = 0: channels innermost) or images
// x channels x rows (planes = 1: a plane of `rows` per channel), dense, of
// dtype 0 float32, 1 bfloat16, 2 float16; gate: images x channels of the same
// dtype. Launches on `stream`; returns the launch's cudaError_t.
extern "C" int se_scale_forward(const void* x, const void* gate, void* out, long long images,
                                long long rows, int channels, int planes, int dtype,
                                void* stream) {
  if (images <= 0 || rows <= 0 || channels <= 0 || planes < 0 || planes > 1)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p = planes == 1;
  switch (dtype) {
    case 0: return launch<float>(x, gate, out, images, rows, channels, p, sms, s);
    case 1: return launch<__nv_bfloat16>(x, gate, out, images, rows, channels, p, sms, s);
    case 2: return launch<__half>(x, gate, out, images, rows, channels, p, sms, s);
    default: return cudaErrorInvalidValue;
  }
}
