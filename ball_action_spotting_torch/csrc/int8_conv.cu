// s8 x s8 -> s32 convolution for Hopper (sm_90a), with the dequantizing
// epilogue of the int8 encoder convs (models/quantize.py::QuantConv).
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA's s8
// convolution (ball_action_spotting_tpu/models/quantize.py:92-95,
// conv_general_dilated with preferred_element_type=int32); PyTorch has no
// int8 convolution on CUDA, and the unfolded input of the flagship's first
// k x k conv (blocks_0_0.conv, 32 -> 16 channels at 368 x 640, K = 288) would
// take 17.4 GB for a TTA-on chunk of 256 stacks, so the k x k convs need this
// kernel. The 1 x 1 convs go to torch._int_mm where it takes the shape.
//
// out[n, oy, ox, o] = f(sum_{dy, dx, c} x[n, oy*s - pt + dy, ox*s - pl + dx, c]
//                                      * w[o, dy, dx, c])
// with x int8 NHWC (zero outside the image: TF SAME padding, the extra row
// and column at the bottom and right), w int8 OHWI, and f either the int32
// sum itself (out_code 3) or float32(sum) * scale[o] rounded to nearest
// into float32, bfloat16 or float16 (out_code 0, 1, 2): JAX's
// (y.astype(f32) * (s_x * s_w)).astype(dtype) in the same order, so that the
// plain version and the kernel agree bit for bit.
//
// Bound on an H100 SXM: the bytes. At the flagship's five k x k shapes for a
// TTA-on chunk (batch 256) the int8 input and bf16 output take 0.43-1.30 ms
// at 3.35 TB/s, against 0.14-0.56 ms of s8 operations at 1979 TOP/s.
//
// Design, the simple first one: an implicit GEMM with M = output pixels,
// N = output channels and K = k*k*C. A block of 128 threads (4 warps) owns a
// 4 x 32 tile of output pixels of one image and a tile of 16, 32 or 64
// output channels (by C_out). The input rows and columns the tile reads,
// (3*s + k) x (31*s + k) positions, are staged once in shared memory with
// 16-byte cp.async copies (zeros outside the image), so each input byte is
// read from global memory about once per tile, not k*k times; the weights
// of the channel tile are staged beside them. K is walked in 16-byte
// segments (16 channels of one tap), two segments per
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: the A fragment of a warp's 16
// pixels is one ldmatrix.x4 whose lanes point at each pixel's tap and
// segment, so a C of 16 (blocks_1_0) pairs two taps in one k32 step and a C
// of 48 splits a step across taps; an odd count of segments ends on a zero
// segment. C is staged 64 channels at a time, so any C (a multiple of 16:
// the wrapper pads) fits. Pixel and weight rows are an odd number of 16-byte
// units apart in shared memory, so that ldmatrix reads 8 rows without bank
// conflicts (2-way at stride 2). s32 sums live in registers; the epilogue
// dequantizes and writes two channels per store.
//
// Later work: a pipelined ring of stages (TMA, wgmma), quantizing the
// float input inside the kernel instead of a separate pass.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 4;                  // output rows of a block's tile
constexpr int kTileW = 32;                 // output columns
constexpr int kWarps = 4;                  // each warp: 32 pixels x all channels of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSegments = 4;            // 16-channel segments staged per pass (64 channels)
constexpr int kSmemLimit = 227 * 1024;     // one block's shared memory on an H100

struct Geometry {
  int n, h, w, c;       // input NHWC; c a multiple of 16
  int o, k, s;          // output channels, kernel size, stride
  int pt, pl;           // top and left padding
  int ho, wo;           // output size
  int tiles_y, tiles_x; // tiles over the output
  int rh, rw;           // staged input rows and columns of a tile
  int segments;         // segments staged per pass
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory to shared memory; bytes = 0 fills zeros.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared memory of one pass over `segments` segments: the staged input
// (an odd unit count per position), one zero unit, the weights (an odd unit
// count per channel row) and the per-segment offset table.
__host__ __device__ inline int pass_units_a(const Geometry& g, int segments) {
  return g.rh * g.rw * (segments | 1);
}
__host__ __device__ inline int pass_segments_even(const Geometry& g, int segments) {
  int total = g.k * g.k * segments;
  return total + (total & 1);
}
inline size_t pass_bytes(const Geometry& g, int segments, int bn) {
  int s2 = pass_segments_even(g, segments);
  return (size_t)pass_units_a(g, segments) * 16 + 16 + (size_t)bn * (s2 + 1) * 16 +
         (size_t)s2 * 4;
}

// Two channels of one pixel from their sums: the raw sums, or the scaled
// and rounded values. `pair`: both channels exist and the pair is aligned.
__device__ __forceinline__ void store2(void* out, size_t idx, int v0, int v1, int o, int o_total,
                                       const float* __restrict__ scale, int out_code) {
  const bool second = o + 1 < o_total;
  const bool pair = (o_total & 1) == 0;  // o is even, so o + 1 < o_total too
  if (out_code == 3) {
    int* p = static_cast<int*>(out) + idx;
    if (pair) {
      *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
      p[0] = v0;
      if (second) p[1] = v1;
    }
    return;
  }
  const float f0 = __fmul_rn(__int2float_rn(v0), scale[o]);
  const float f1 = second ? __fmul_rn(__int2float_rn(v1), scale[o + 1]) : 0.0f;
  if (out_code == 0) {
    float* p = static_cast<float*>(out) + idx;
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(f0, f1);
    } else {
      p[0] = f0;
      if (second) p[1] = f1;
    }
  } else if (out_code == 1) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + idx;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __halves2bfloat162(__float2bfloat16_rn(f0), __float2bfloat16_rn(f1));
    } else {
      p[0] = __float2bfloat16_rn(f0);
      if (second) p[1] = __float2bfloat16_rn(f1);
    }
  } else {
    __half* p = static_cast<__half*>(out) + idx;
    if (pair) {
      *reinterpret_cast<__half2*>(p) = __halves2half2(__float2half_rn(f0), __float2half_rn(f1));
    } else {
      p[0] = __float2half_rn(f0);
      if (second) p[1] = __float2half_rn(f1);
    }
  }
}

// kGroups: 16-channel groups of output channels per block (BN = 16 kGroups).
template <int kGroups>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale, void* __restrict__ out, Geometry g,
                 int out_code, int o_tile_first) {
  constexpr int kBN = 16 * kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int tile = blockIdx.x;
  const int tile_x = tile % g.tiles_x;
  tile /= g.tiles_x;
  const int tile_y = tile % g.tiles_y;
  const int n = tile / g.tiles_y;
  const int oy0 = tile_y * kTileH, ox0 = tile_x * kTileW;
  const int iy0 = oy0 * g.s - g.pt, ix0 = ox0 * g.s - g.pl;
  const int o_base = (o_tile_first + blockIdx.y) * kBN;
  const int taps = g.k * g.k;

  int acc[2][2 * kGroups][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nb = 0; nb < 2 * kGroups; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nb][r] = 0;

  // ldmatrix.x4: lane l addresses row (l & 7) of matrix (l >> 3).
  const int mat = lane >> 3, row = lane & 7;

  for (int c0 = 0; c0 < g.c; c0 += 16 * g.segments) {
    const int segs = min(g.segments, (g.c - c0) / 16);
    const int pu = segs | 1;  // units per staged position
    const int total = taps * segs;
    const int total2 = total + (total & 1);
    const int qu = total2 + 1;  // units per weight row
    unsigned char* a_s = smem;
    unsigned char* zero = a_s + (size_t)g.rh * g.rw * pu * 16;
    unsigned char* b_s = zero + 16;
    int* table = reinterpret_cast<int*>(b_s + (size_t)kBN * qu * 16);

    __syncthreads();  // the previous pass's reads are done
    const int positions = g.rh * g.rw;
    for (int i = tid; i < positions * segs; i += kThreads) {
      const int pos = i / segs, seg = i - pos * segs;
      const int ry = pos / g.rw, rx = pos - ry * g.rw;
      const int iy = iy0 + ry, ix = ix0 + rx;
      const bool inside = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const int8_t* src =
          inside ? x + ((((size_t)n * g.h + iy) * g.w + ix) * g.c + c0 + seg * 16) : x;
      copy16(smem_addr(a_s + ((size_t)pos * pu + seg) * 16), src, inside ? 16 : 0);
    }
    for (int i = tid; i < kBN * total2; i += kThreads) {
      const int ol = i / total2, j = i - ol * total2;
      const int o = o_base + ol;
      const bool inside = o < g.o && j < total;
      const int tap = j / segs, seg = j - tap * segs;
      const int8_t* src =
          inside ? wq + (((size_t)o * taps + tap) * g.c + c0 + seg * 16) : wq;
      copy16(smem_addr(b_s + ((size_t)ol * qu + j) * 16), src, inside ? 16 : 0);
    }
    if (tid < 4) reinterpret_cast<int*>(zero)[tid] = 0;
    for (int j = tid; j < total2; j += kThreads) {
      int off = -1;  // the zero unit
      if (j < total) {
        const int tap = j / segs, seg = j - tap * segs;
        const int dy = tap / g.k, dx = tap - dy * g.k;
        off = ((dy * g.rw + dx) * pu + seg) * 16;
      }
      table[j] = off;
    }
    copies_done();
    __syncthreads();

    // A: this lane's pixel (row + 8 (mat & 1) of each m16 tile); matrices
    // 2 and 3 read the step's second segment. B: channel row + 8 (mat >> 1)
    // of each 16-channel group; matrices 1 and 3 read the second segment.
    uint32_t a_pix[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = warp * 32 + mi * 16 + row + 8 * (mat & 1);
      const int ty = m / kTileW, tx = m - ty * kTileW;
      a_pix[mi] = smem_addr(a_s) + (uint32_t)((ty * g.s * g.rw + tx * g.s) * pu * 16);
    }
    const uint32_t zero_addr = smem_addr(zero);
    const uint32_t b_lane = smem_addr(b_s) + (uint32_t)(((row + 8 * (mat >> 1)) * qu +
                                                         (mat & 1)) * 16);
    const int a_half = mat >> 1;
    for (int j0 = 0; j0 < total2; j0 += 2) {
      const int off = table[j0 + a_half];
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(off >= 0 ? a_pix[mi] + (uint32_t)off : zero_addr, a[mi]);
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
        uint32_t b[4];
        ldmatrix_x4(b_lane + (uint32_t)((grp * 16 * qu + j0) * 16), b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * grp], a[mi], b[0], b[1]);
          mma_s8(acc[mi][2 * grp + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // Epilogue: sums (row g, channels 2t and 2t + 1) and (row g + 8, ...) of
  // each m16 x n8 tile.
  const int gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp * 32 + mi * 16 + gid + 8 * half;
      const int ty = m / kTileW, tx = m - ty * kTileW;
      const int oy = oy0 + ty, ox = ox0 + tx;
      if (oy >= g.ho || ox >= g.wo) continue;
      const size_t pix = ((size_t)n * g.ho + oy) * g.wo + ox;
#pragma unroll
      for (int nb = 0; nb < 2 * kGroups; ++nb) {
        const int o = o_base + nb * 8 + 2 * t;
        if (o >= g.o) continue;
        store2(out, pix * g.o + o, acc[mi][nb][2 * half], acc[mi][nb][2 * half + 1], o, g.o,
               scale, out_code);
      }
    }
  }
}

template <int kGroups>
cudaError_t launch(const int8_t* x, const int8_t* wq, const float* scale, void* out,
                   const Geometry& g, int out_code, int o_tile_first, int o_tiles,
                   cudaStream_t stream) {
  constexpr int kBN = 16 * kGroups;
  Geometry geo = g;
  geo.segments = 0;
  size_t bytes = 0;
  for (int segs = min(kMaxSegments, g.c / 16); segs >= 1; --segs) {
    bytes = pass_bytes(g, segs, kBN);
    if (bytes <= (size_t)kSmemLimit) {
      geo.segments = segs;
      break;
    }
  }
  if (geo.segments == 0) return cudaErrorInvalidValue;  // a kernel size too large to stage
  const long long blocks = (long long)g.n * g.tiles_y * g.tiles_x;
  if (blocks > INT_MAX || o_tiles < 1 || o_tiles > 65535) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<kGroups>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)blocks, (unsigned)o_tiles);
  int8_conv_kernel<kGroups><<<grid, kThreads, bytes, stream>>>(x, wq, scale, out, geo, out_code,
                                                              o_tile_first);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_conv_forward(const void* x, const void* wq, const void* scale, void* out,
                                 int n, int h, int w, int c, int o, int k, int s, int pt,
                                 int pl, int ho, int wo, int out_code, int o_tile_first,
                                 int o_tiles, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 16 || c % 16 || o < 1 || k < 1 || s < 1 || ho < 1 ||
      wo < 1 || out_code < 0 || out_code > 3)
    return cudaErrorInvalidValue;
  Geometry g{};
  g.n = n;
  g.h = h;
  g.w = w;
  g.c = c;
  g.o = o;
  g.k = k;
  g.s = s;
  g.pt = pt;
  g.pl = pl;
  g.ho = ho;
  g.wo = wo;
  g.tiles_y = (ho + kTileH - 1) / kTileH;
  g.tiles_x = (wo + kTileW - 1) / kTileW;
  g.rh = (kTileH - 1) * s + k;
  g.rw = (kTileW - 1) * s + k;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the channel tile by C_out, as ops/int8_conv.py::channel_tile gives it
  if (o <= 16) return launch<1>(xp, wp, sp, out, g, out_code, o_tile_first, o_tiles, st);
  if (o <= 32) return launch<2>(xp, wp, sp, out, g, out_code, o_tile_first, o_tiles, st);
  return launch<4>(xp, wp, sp, out, g, out_code, o_tile_first, o_tiles, st);
}
