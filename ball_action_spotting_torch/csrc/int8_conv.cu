// s8 x s8 -> s32 convolutions for Hopper (sm_90a) that quantize their
// compute-dtype input while staging it and dequantize in their epilogue: the
// int8 encoder's k x k convs (models/quantize.py::QuantConv), one launch a
// conv.
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA's s8
// convolution (ball_action_spotting_tpu/models/quantize.py:92-95,
// conv_general_dilated with preferred_element_type=int32) and its quantize
// and dequantize to XLA's fused elementwise code; PyTorch has neither an int8
// convolution on CUDA nor that fusion. int8_conv_forward takes the k x k
// convs and the 1 x 1 convs that csrc/int8_gemm.cu does not (stride 2, 16
// pixels or fewer, an odd C_out, rows TMA cannot read:
// ops/int8_conv.py::gemm_takes). The tile is kWM rows of 32 output pixels of
// one image.
//
// out[n, oy, ox, o] = f(sum_{dy, dx, c} q(x[n, oy*s - pt + dy, ox*s - pl + dx, c])
//                                      * w[o, dy, dx, c])
// with x float32, bfloat16 or float16 NHWC (zero outside the image: TF SAME
// padding, the extra row and column at the bottom and right),
// q(v) = int8(clamp(rint(float(v) / s_x), -127, 127)), w int8 OHWI, and f
// either the int32 sum itself (out_code 3) or float32(sum) * (s_x * s_w[o])
// rounded into float32, bfloat16 or float16 (out_code 0, 1, 2). s_x is read
// from the device (the 0-dim tensor of models/quantize.py::activation_scale):
// never copied to the host, so no layer waits for the host.
//
// Exactness: the JAX package's arithmetic as XLA compiles it, which the plain
// version (ops/int8_conv.py: quantize, the s8 sums, dequantize) repeats, bit
// for bit:
//  - float(v) / s_x is IEEE division (__fdiv_rn; this file is compiled
//    without --use_fast_math), never __fdividef nor a product with 1 / s_x:
//    XLA keeps the division by the traced scale. bf16 and f16 -> float is
//    exact.
//  - rint rounds half to even, as torch.round and jnp.round do: a float t in
//    [-127, 127] plus 1.5 * 2^23 is rounded to an integer, ties to even, and
//    the low byte of its bits is rint(t) as int8. Clamping before rounding
//    gives what clamping after gives, the bounds being integers.
//  - The sums are s32. float32(sum) is exact below 2^22 in magnitude (the
//    same constant), else cvt.rn, as torch's int32 -> float32.
//  - s_x * s_w[o] is one float32 product (__fmul_rn), as models/quantize.py
//    takes it, then float32(sum) times it, rounded once into the output type
//    (__float2bfloat16_rn, __float2half_rn).
//
// Bound on an H100 SXM: the bytes. At the flagship's convs for a TTA-on
// chunk (batch 256) the compute-dtype input read once and the output written
// once take 0.54-1.73 ms at 3.35 TB/s, against at most 0.56 ms of s8
// operations at 1979 TOP/s.
//
// Design. An implicit GEMM: M = output pixels, N = output channels, K =
// k*k*C, on mma.sync.m16n8k32.s32.s8.s8.s32. A block of 8 warps (kWM along
// the pixels, 32 each; kWN along the channels, 16*kG each) walks its tiles
// of pixels persistently (blockIdx.x, + gridDim.x, ...; as many blocks as fit
// on the card) and, over each tile, every channel tile of C_out (BN =
// 16*kG*kWN: 16, 32, 64, 96 or 128 by C_out), so
// that each input byte is quantized once a tile however wide C_out is. A
// step is one pass over C of one channel tile: it stages the tile's input
// rows and columns (up to 4 segments of 16 channels a pass) with 16-byte
// cp.async copies of the raw compute-dtype
// bytes into a ring of kStages slots (zeros outside the image and past C;
// rows that are not 16-byte aligned are copied byte by byte), so that the
// next step's loads are in flight while this one is quantized and
// multiplied. cp.async copies bytes and cannot convert, so a step that
// brings new input then quantizes its slot into the int8 tile that ldmatrix
// reads, each thread 16 raw bytes at a time; where one pass covers C, the
// other channel tiles' steps reuse that int8 tile. The weights stay in
// shared memory for the block's life where one pass covers C and they fit,
// else they ride in the ring beside the input. The host picks the segments
// a pass and where the weights live by what leaves room for two blocks an
// SM. K is walked in 16-byte segments (16 channels of one tap), two per k32
// step: the A fragment of 16 pixels is one ldmatrix.x4 whose lanes point at
// each pixel's tap and segment (walked unit by unit), so a C of 16 pairs
// two taps in one step and a C of 48 splits a step across taps; an odd
// count of segments ends on a zero segment. Pixel and weight rows are an
// odd number of 16-byte units apart in shared memory, so that ldmatrix
// reads 8 rows without bank conflicts (2-way at stride 2). The s32 sums
// live in registers; the epilogue dequantizes with s_x * s_w of every
// channel staged in shared memory, 16 channels at a time: each warp stages
// them for its 32 pixels and writes each pixel's 16 channels as whole
// 16-byte pieces (two channels a store where C_out leaves a part group or
// rows off 16 bytes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                 // ring slots of staged input
constexpr int kConvSegments = 4;           // 16-channel segments a pass
constexpr int kSmemLimit = 227 * 1024;     // one block's shared memory on an H100
constexpr int kTwoBlocks = 113 * 1024;     // a block's share when two fit on an SM

struct Geometry {
  int n, h, w, c;         // input NHWC
  int o, k, s;            // output channels, kernel size, stride
  int pt, pl;             // top and left padding
  int ho, wo;             // output size
  int tiles_y, tiles_x;   // tiles over one image's output
  int tiles;              // over the batch
  int o_tiles;            // channel tiles over C_out
  int rh, rw;             // staged input rows and columns of a tile
  int segments, passes;   // segments staged a pass; passes over C
  int esize, in_code;     // input element bytes; 0 float32, 1 bfloat16, 2 float16
  int out_code;           // 0 float32, 1 bfloat16, 2 float16, 3 int32 sums
  int oes;                // output element bytes
  int fast_x, fast_w;     // rows 16-byte aligned: asynchronous 16-byte copies
  int w_resident;         // every channel tile's weights staged once (one pass)
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline int even(int v) { return v + (v & 1); }

// Shared memory: kStages raw slots (a position's segments * 16 channels of
// input), the int8 tile (an odd count of 16-byte units a position) and its
// zero unit, the weights (one area a channel tile where they stay resident,
// else one a slot; an odd count of units a channel row), the epilogue's
// scales for every channel, and each warp's output staging (32 pixels by
// 16 channels).
struct Layout {
  size_t raw_bytes, q, w, w_bytes, scale, epi, total;
};

__host__ __device__ inline Layout layout(const Geometry& g, int bn) {
  Layout L;
  const size_t positions = static_cast<size_t>(g.rh) * g.rw;
  const int units = even(g.k * g.k * g.segments);
  L.raw_bytes = align16(positions * g.segments * 16 * g.esize);
  L.q = kStages * L.raw_bytes;
  L.w = L.q + positions * (g.segments | 1) * 16 + 16;
  L.w_bytes = static_cast<size_t>(bn) * (units + 1) * 16;
  L.scale = L.w + (g.w_resident ? g.o_tiles : kStages) * L.w_bytes;
  L.epi = L.scale + static_cast<size_t>(g.o_tiles) * bn * 4;
  L.total = L.epi + static_cast<size_t>(kWarps) * 32 * 16 * g.oes;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory: the first `bytes` from src, zeros after;
// asynchronously (cp.async) where `fast`, else byte by byte.
__device__ __forceinline__ void stage16(unsigned char* dst, const unsigned char* src, int bytes,
                                        bool fast) {
  if (fast) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b) dst[b] = b < bytes ? src[b] : 0;
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// q(v) in the low byte: IEEE division, clamp, then + 1.5 * 2^23 rounds to
// the nearest integer, ties to even (module note).
__device__ __forceinline__ uint32_t quantize1(float v, float sx) {
  const float t = fminf(fmaxf(__fdiv_rn(v, sx), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// The low bytes of four words, in order.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The two 16-bit values of a word as floats: bfloat16 (kIn 1) or float16.
template <int kIn>
__device__ __forceinline__ float lo_half(uint32_t v) {
  return kIn == 1 ? __uint_as_float(v << 16)
                  : __half2float(__ushort_as_half(static_cast<unsigned short>(v & 0xffffu)));
}

template <int kIn>
__device__ __forceinline__ float hi_half(uint32_t v) {
  return kIn == 1 ? __uint_as_float(v & 0xffff0000u)
                  : __half2float(__ushort_as_half(static_cast<unsigned short>(v >> 16)));
}

// 16 raw bytes of input (4 float32 or 8 bfloat16 / float16 channels; kIn
// 0, 1, 2) to their int8 values at dst (4 or 8 bytes).
template <int kIn>
__device__ __forceinline__ void quantize16(const uint4 v, float sx, unsigned char* dst) {
  if (kIn == 0) {
    *reinterpret_cast<uint32_t*>(dst) =
        pack4(quantize1(__uint_as_float(v.x), sx), quantize1(__uint_as_float(v.y), sx),
              quantize1(__uint_as_float(v.z), sx), quantize1(__uint_as_float(v.w), sx));
    return;
  }
  uint2 r;
  r.x = pack4(quantize1(lo_half<kIn>(v.x), sx), quantize1(hi_half<kIn>(v.x), sx),
              quantize1(lo_half<kIn>(v.y), sx), quantize1(hi_half<kIn>(v.y), sx));
  r.y = pack4(quantize1(lo_half<kIn>(v.z), sx), quantize1(hi_half<kIn>(v.z), sx),
              quantize1(lo_half<kIn>(v.w), sx), quantize1(hi_half<kIn>(v.w), sx));
  *reinterpret_cast<uint2*>(dst) = r;
}

// A step's raw chunks into the int8 tile: this thread's chunk `ch` of every
// sweep-th position from `pos` (chunk i of a position at raw i * 16; its
// int8 bytes at unit ch >> lg of the position, part ch & (2^lg - 1)).
template <int kIn>
__device__ __forceinline__ void quantize_chunks(const unsigned char* raw, unsigned char* q,
                                                int pos, int ch, int chunks, int sweep,
                                                int positions, int pu, float sx) {
  constexpr int kLg = kIn == 0 ? 2 : 1;  // a segment is 2^kLg chunks
  const unsigned char* src = raw + (static_cast<size_t>(pos) * chunks + ch) * 16;
  unsigned char* dst = q + (static_cast<size_t>(pos) * pu + (ch >> kLg)) * 16 +
                       (ch & ((1 << kLg) - 1)) * (16 >> kLg);
  const size_t src_step = static_cast<size_t>(sweep) * chunks * 16;
  const size_t dst_step = static_cast<size_t>(sweep) * pu * 16;
  for (; pos < positions; pos += sweep, src += src_step, dst += dst_step)
    quantize16<kIn>(*reinterpret_cast<const uint4*>(src), sx, dst);
}

// float32(v), rounded to nearest even as torch's int32 -> float32: exact by
// the 1.5 * 2^23 constant below 2^22 in magnitude, else the conversion.
__device__ __forceinline__ float sum_to_float(int v) {
  if (static_cast<unsigned>(v + (1 << 22)) < (1u << 23))
    return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
  return __int2float_rn(v);
}

// Two channels' output values from their sums, as out_code's bytes at dst:
// the raw sums, or the scaled and rounded values (`scale`: the channels'
// s_x * s_w).
__device__ __forceinline__ void put2(unsigned char* dst, int v0, int v1, float2 scale,
                                     int out_code) {
  if (out_code == 3) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
    return;
  }
  const float f0 = __fmul_rn(sum_to_float(v0), scale.x);
  const float f1 = __fmul_rn(sum_to_float(v1), scale.y);
  if (out_code == 0)
    *reinterpret_cast<float2*>(dst) = make_float2(f0, f1);
  else if (out_code == 1)
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __halves2bfloat162(__float2bfloat16_rn(f0), __float2bfloat16_rn(f1));
  else
    *reinterpret_cast<__half2*>(dst) = __halves2half2(__float2half_rn(f0), __float2half_rn(f1));
}

// Two channels o, o + 1 of one pixel from their sums: the raw sums, or the
// scaled and rounded values (`scale`: the two channels' s_x * s_w). `pair`:
// both channels exist and the pair is aligned.
__device__ __forceinline__ void store2(void* out, size_t idx, int v0, int v1, int o, int o_total,
                                       float2 scale, int out_code) {
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
  const float f0 = __fmul_rn(sum_to_float(v0), scale.x);
  const float f1 = second ? __fmul_rn(sum_to_float(v1), scale.y) : 0.0f;
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

// Where a block's steps stand: the tile (image n, tile row ty, tile column
// tx), its channel tile ot and the pass over C. A step is one pass of one
// channel tile of one tile; the block's tiles are blockIdx.x, + gridDim.x,
// ..., so moving on to the next tile adds gridDim.x = gq * tiles_x + gx.
struct Cursor {
  int n, ty, tx, ot, pass;

  __device__ Cursor(const Geometry& g) : ot(0), pass(0) {
    const int t = static_cast<int>(blockIdx.x) / g.tiles_x;
    tx = static_cast<int>(blockIdx.x) - t * g.tiles_x;
    ty = t % g.tiles_y;
    n = t / g.tiles_y;
  }

  // Input is staged and quantized at a step that starts a channel tile's
  // pass over new channels: every pass, or only the first channel tile's
  // where one pass covers C (the int8 tile then serves every channel tile).
  __device__ bool new_input(const Geometry& g) const { return ot == 0 || g.passes > 1; }
  __device__ bool last_pass(const Geometry& g) const { return pass == g.passes - 1; }

  __device__ void advance(const Geometry& g, int gq, int gx) {
    if (++pass < g.passes) return;
    pass = 0;
    if (++ot < g.o_tiles) return;
    ot = 0;
    tx += gx;
    ty += gq;
    if (tx >= g.tiles_x) {
      tx -= g.tiles_x;
      ++ty;
    }
    while (ty >= g.tiles_y) {
      ty -= g.tiles_y;
      ++n;
    }
  }
};

// kWM warps along the pixels (32 each), kWN along the channels (16 kG
// each); the tile is kWM rows of 32 pixels. Three blocks an SM where the
// channel tile is 16 (its sums need few registers), else two.
template <int kWM, int kWN, int kG>
__global__ void __launch_bounds__(kThreads, 16 * kG * kWN <= 16 ? 3 : 2)
int8_kernel(const unsigned char* __restrict__ x, const float* __restrict__ sx_ptr,
            const int8_t* __restrict__ wq, const float* __restrict__ s_w, void* __restrict__ out,
            Geometry g) {
  static_assert(kWM * kWN == kWarps, "eight warps");
  constexpr int kTileH = kWM;
  constexpr int kTileW = 32;
  constexpr int kBN = 16 * kG * kWN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g, kBN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int taps = g.k * g.k;
  const int positions = g.rh * g.rw;
  const long long row_bytes = static_cast<long long>(g.c) * g.esize;
  const float sx = *sx_ptr;
  unsigned char* q = smem + L.q;
  float* scales = reinterpret_cast<float*>(smem + L.scale);
  for (int i = tid; i < g.o_tiles * kBN; i += kThreads)
    scales[i] = i < g.o ? __fmul_rn(sx, s_w[i]) : 0.0f;

  const int gq = static_cast<int>(gridDim.x) / g.tiles_x;
  const int gx = static_cast<int>(gridDim.x) - gq * g.tiles_x;
  const int steps = (g.tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x) * g.o_tiles * g.passes;

  // The weights of channel tile ot for channels [c0, c0 + 16 segs): row ol,
  // unit j = tap * segs + seg; zeros past C_out, past C and in the odd tail
  // unit.
  auto stage_weights = [&](unsigned char* dst, int ot, int c0, int segs) {
    const int units = segs * taps, units2 = even(units), qu = units2 + 1;
    const unsigned char* w8 = reinterpret_cast<const unsigned char*>(wq);
    for (int i = tid; i < kBN * units2; i += kThreads) {
      const int ol = i / units2, j = i - ol * units2;
      const int o = ot * kBN + ol, tap = j / segs, c = c0 + (j - tap * segs) * 16;
      const int bytes = o < g.o && j < units ? max(0, min(16, g.c - c)) : 0;
      const unsigned char* src =
          bytes > 0 ? w8 + (static_cast<size_t>(o) * taps + tap) * g.c + c : w8;
      stage16(dst + (static_cast<size_t>(ol) * qu + j) * 16, src, bytes, g.fast_w);
    }
  };
  // A step's copies into ring slot `slot`: its new input (each position's
  // 16 segs channels as 16-byte chunks, zeros outside the image and past C)
  // and, unless they stay resident, its channel tile's weights.
  auto stage = [&](const Cursor& cur, int slot) {
    const int c0 = cur.pass * g.segments * 16;
    const int segs = min(g.segments, (g.c - c0 + 15) / 16);
    if (cur.new_input(g)) {
      unsigned char* raw = smem + slot * L.raw_bytes;
      const int iy0 = cur.ty * kTileH * g.s - g.pt, ix0 = cur.tx * kTileW * g.s - g.pl;
      const long long base = (static_cast<long long>(cur.n) * g.h + iy0) * g.w + ix0;
      // this thread's chunk ch (channels c..c + 16 / esize) of every
      // sweep-th position
      const int chunks = segs * g.esize, sweep = kThreads / chunks;
      if (tid < sweep * chunks) {
        const int ch = tid % chunks, c = c0 + ch * (16 / g.esize);
        const int bytes = c < g.c ? min(16, (g.c - c) * g.esize) : 0;
        const int dry = sweep / g.rw, drx = sweep - dry * g.rw;
        int pos = tid / chunks, ry = pos / g.rw, rx = pos - ry * g.rw;
        unsigned char* dst = raw + (static_cast<size_t>(pos) * chunks + ch) * 16;
        for (; pos < positions; pos += sweep, dst += sweep * chunks * 16) {
          const bool inside = bytes > 0 &&
                              static_cast<unsigned>(iy0 + ry) < static_cast<unsigned>(g.h) &&
                              static_cast<unsigned>(ix0 + rx) < static_cast<unsigned>(g.w);
          const unsigned char* src =
              inside ? x + (base + ry * g.w + rx) * row_bytes + c * g.esize : x;
          stage16(dst, src, inside ? bytes : 0, g.fast_x);
          rx += drx;
          ry += dry;
          if (rx >= g.rw) {
            rx -= g.rw;
            ++ry;
          }
        }
      }
    }
    if (!g.w_resident) stage_weights(smem + L.w + slot * L.w_bytes, cur.ot, c0, segs);
  };

  int acc[2][2 * kG][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nb = 0; nb < 2 * kG; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nb][r] = 0;

  // ldmatrix.x4: lane l addresses row (l & 7) of matrix (l >> 3). A: this
  // lane's pixel (row + 8 (mat & 1) of each m16 tile of the warp's 32);
  // matrices 2 and 3 read the k32 step's second segment. B: channel row + 8
  // (mat >> 1) of each 16-channel group; matrices 1 and 3 read the second
  // segment.
  const int mat = lane >> 3, row = lane & 7, a_half = mat >> 1;
  int a_pos[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = wm * 32 + mi * 16 + row + 8 * (mat & 1);
    const int ty = m / kTileW, tx = m - ty * kTileW;
    a_pos[mi] = ty * g.s * g.rw + tx * g.s;
  }

  if (g.w_resident)
    for (int ot = 0; ot < g.o_tiles; ++ot)
      stage_weights(smem + L.w + ot * L.w_bytes, ot, 0, g.segments);
  Cursor ahead(g), cur(g);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) stage(ahead, i);
    commit();
    ahead.advance(g, gq, gx);
  }
  for (int st = 0; st < steps; ++st, cur.advance(g, gq, gx)) {
    // Step st's copies have landed (each thread waits for its own, the
    // barrier for everyone's), and every warp is done with step st - 1's
    // int8 tile and weight slot, and with the ring slot refilled next.
    wait_groups<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < steps) stage(ahead, (st + kStages - 1) % kStages);
    commit();
    ahead.advance(g, gq, gx);

    const int segs = min(g.segments, (g.c - cur.pass * g.segments * 16 + 15) / 16);
    const int pu = segs | 1;  // units a position in the int8 tile
    if (cur.new_input(g)) {
      const unsigned char* raw = smem + (st % kStages) * L.raw_bytes;
      const int chunks = segs * g.esize, sweep = kThreads / chunks;
      if (tid < sweep * chunks) {
        const int pos = tid / chunks, ch = tid - pos * chunks;
        if (g.in_code == 0)
          quantize_chunks<0>(raw, q, pos, ch, chunks, sweep, positions, pu, sx);
        else if (g.in_code == 1)
          quantize_chunks<1>(raw, q, pos, ch, chunks, sweep, positions, pu, sx);
        else
          quantize_chunks<2>(raw, q, pos, ch, chunks, sweep, positions, pu, sx);
      }
      if (tid < 4) reinterpret_cast<int*>(q + static_cast<size_t>(positions) * pu * 16)[tid] = 0;
      __syncthreads();
    }

    const int units2 = even(segs * taps), qu = units2 + 1;
    const unsigned char* w_s =
        smem + L.w + (g.w_resident ? cur.ot : st % kStages) * L.w_bytes;
    const uint32_t q_addr = smem_addr(q);
    const uint32_t zero_addr = q_addr + static_cast<uint32_t>(positions * pu * 16);
    const uint32_t a_pix[2] = {q_addr + static_cast<uint32_t>(a_pos[0] * pu * 16),
                               q_addr + static_cast<uint32_t>(a_pos[1] * pu * 16)};
    const uint32_t b_lane =
        smem_addr(w_s) +
        static_cast<uint32_t>(((wn * 16 * kG + row + 8 * (mat >> 1)) * qu + (mat & 1)) * 16);
    // Unit j = j0 + a_half of the pass: tap (dy, dx), segment seg, at byte
    // `off` from a pixel's first unit; the zero unit past the last one.
    const int units = segs * taps;
    int seg = a_half, dx = 0, dy = 0, off = a_half * 16;
    if (seg >= segs) {  // segs 1: unit 1 is tap 1's
      seg -= segs;
      off += (pu - segs) * 16;
      if (++dx == g.k) {
        dx = 0;
        ++dy;
        off += (g.rw - g.k) * pu * 16;
      }
    }
    for (int j0 = 0; j0 < units2; j0 += 2) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(j0 + a_half < units ? a_pix[mi] + static_cast<uint32_t>(off) : zero_addr,
                    a[mi]);
#pragma unroll
      for (int grp = 0; grp < kG; ++grp) {
        uint32_t b[4];
        ldmatrix_x4(b_lane + static_cast<uint32_t>((grp * 16 * qu + j0) * 16), b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * grp], a[mi], b[0], b[1]);
          mma_s8(acc[mi][2 * grp + 1], a[mi], b[2], b[3]);
        }
      }
      seg += 2;  // the next k32 step: two units on
      off += 32;
      while (seg >= segs) {
        seg -= segs;
        off += (pu - segs) * 16;
        if (++dx == g.k) {
          dx = 0;
          ++dy;
          off += (g.rw - g.k) * pu * 16;
        }
      }
    }
    if (!cur.last_pass(g)) continue;

    // Epilogue: sums (row gid, channels 2t and 2t + 1) and (row gid + 8,
    // ...) of each m16 x n8 tile, 16 channels at a time. Where the 16
    // channels exist and output rows are 16-byte aligned, the warp stages
    // them (32 pixels by 16 channels) and writes each pixel's 16 channels as
    // whole 16-byte pieces; else two channels a store. Then the sums start
    // again.
    const int gid = lane >> 2, t = lane & 3;
    const int o_w = cur.ot * kBN + wn * 16 * kG;  // the warp's first channel
    unsigned char* wst = smem + L.epi + warp * 32 * 16 * g.oes;
    const bool rows16 = (g.o * g.oes) % 16 == 0;
#pragma unroll
    for (int grp = 0; grp < kG; ++grp) {
      const int og = o_w + grp * 16;
      const bool staged = rows16 && og + 16 <= g.o;
      const float2 sc0 = *reinterpret_cast<const float2*>(scales + og + 2 * t);
      const float2 sc1 = *reinterpret_cast<const float2*>(scales + og + 8 + 2 * t);
      if (staged) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            unsigned char* row_s = wst + (mi * 16 + gid + 8 * half) * 16 * g.oes;
            put2(row_s + 2 * t * g.oes, acc[mi][2 * grp][2 * half], acc[mi][2 * grp][2 * half + 1],
                 sc0, g.out_code);
            put2(row_s + (8 + 2 * t) * g.oes, acc[mi][2 * grp + 1][2 * half],
                 acc[mi][2 * grp + 1][2 * half + 1], sc1, g.out_code);
          }
        __syncwarp();
        for (int k = lane; k < 32 * g.oes; k += 32) {  // a row is oes 16-byte pieces
          const int r = k / g.oes, part = k - r * g.oes;
          const int m = wm * 32 + r;
          const int ty = m / kTileW, tx = m - ty * kTileW;
          const int oy = cur.ty * kTileH + ty, ox = cur.tx * kTileW + tx;
          if (oy < g.ho && ox < g.wo)
            *reinterpret_cast<uint4*>(
                static_cast<unsigned char*>(out) +
                ((static_cast<size_t>(cur.n * g.ho + oy) * g.wo + ox) * g.o + og) * g.oes +
                part * 16) = *reinterpret_cast<const uint4*>(wst + k * 16);
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = wm * 32 + mi * 16 + gid + 8 * half;
            const int ty = m / kTileW, tx = m - ty * kTileW;
            const int oy = cur.ty * kTileH + ty, ox = cur.tx * kTileW + tx;
            const size_t idx = (static_cast<size_t>(cur.n * g.ho + oy) * g.wo + ox) * g.o;
            const bool in = oy < g.ho && ox < g.wo;
            if (in && og + 2 * t < g.o)
              store2(out, idx + og + 2 * t, acc[mi][2 * grp][2 * half],
                     acc[mi][2 * grp][2 * half + 1], og + 2 * t, g.o, sc0, g.out_code);
            if (in && og + 8 + 2 * t < g.o)
              store2(out, idx + og + 8 + 2 * t, acc[mi][2 * grp + 1][2 * half],
                     acc[mi][2 * grp + 1][2 * half + 1], og + 8 + 2 * t, g.o, sc1, g.out_code);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < 2 * kG; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][nb][r] = 0;
  }
}

// Choose how a block stages C (module note): one pass with every channel
// tile's weights resident, else one pass with the weights in the ring, else
// passes of as many segments as fit; first within the shared memory that
// leaves room for two blocks an SM, then within one block's, except that
// one pass in one block's room comes before several passes where the
// channel tiles would quantize the input again each. Then size the grid to
// the blocks that fit on the card, and launch.
template <int kWM, int kWN, int kG>
cudaError_t launch(const void* x, const float* sx, const int8_t* wq, const float* s_w, void* out,
                   Geometry g, cudaStream_t stream) {
  constexpr int kTileH = kWM;
  constexpr int kTileW = 32;
  constexpr int kBN = 16 * kG * kWN;
  g.tiles_y = (g.ho + kTileH - 1) / kTileH;
  g.tiles_x = (g.wo + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(g.n) * g.tiles_y * g.tiles_x;
  if (tiles > INT_MAX / 2) return cudaErrorInvalidConfiguration;
  g.tiles = static_cast<int>(tiles);
  g.o_tiles = (g.o + kBN - 1) / kBN;
  g.rh = (kTileH - 1) * g.s + g.k;
  g.rw = (kTileW - 1) * g.s + g.k;
  const int all = (g.c + 15) / 16;
  const int most = min(all, kConvSegments);
  // (budget, segments, resident weights), in order of preference
  struct Plan { size_t budget; int segs; int resident; };
  Plan plans[6 + 2 * kConvSegments];
  int count = 0;
  const bool one_pass = most == all;
  auto single = [&](size_t budget) {
    plans[count++] = {budget, all, 1};
    plans[count++] = {budget, all, 0};
  };
  auto several = [&](size_t budget) {
    for (int segs = one_pass ? all - 1 : most; segs >= 1; --segs) plans[count++] = {budget, segs, 0};
  };
  if (one_pass) single(kTwoBlocks);
  if (one_pass && g.o_tiles > 1) single(kSmemLimit);
  several(kTwoBlocks);
  if (one_pass && g.o_tiles == 1) single(kSmemLimit);
  several(kSmemLimit);
  size_t bytes = 0;
  g.segments = 0;
  for (int i = 0; i < count && g.segments == 0; ++i) {
    Geometry t = g;
    t.segments = plans[i].segs;
    t.passes = (all + t.segments - 1) / t.segments;
    t.w_resident = plans[i].resident;
    const size_t need = layout(t, kBN).total;
    if (need <= plans[i].budget) {
      g = t;
      bytes = need;
    }
  }
  if (g.segments == 0) return cudaErrorInvalidValue;  // a tile too large to stage
  const auto kernel = int8_kernel<kWM, kWN, kG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(g.tiles, per_sm * sms);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const unsigned char*>(x), sx, wq, s_w, out,
                                            g);
  return cudaGetLastError();
}

// The channel tile by C_out: 16, 32, 64, 96 or 128; past 128, 96 where
// C_out is a multiple of it (192: two tiles) and else 128.
cudaError_t dispatch(const void* x, const void* sx, const void* wq, const void* s_w, void* out,
                     Geometry g, void* stream) {
  const float* sxp = static_cast<const float*>(sx);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const float* swp = static_cast<const float*>(s_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  g.esize = g.in_code == 0 ? 4 : 2;
  g.oes = g.out_code == 0 || g.out_code == 3 ? 4 : 2;
  g.fast_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (g.c * g.esize) % 16 == 0;
  g.fast_w = reinterpret_cast<uintptr_t>(wq) % 16 == 0 && g.c % 16 == 0;
  if (g.o <= 16) return launch<8, 1, 1>(x, sxp, wp, swp, out, g, st);
  if (g.o <= 32) return launch<8, 1, 2>(x, sxp, wp, swp, out, g, st);
  if (g.o <= 64) return launch<8, 1, 4>(x, sxp, wp, swp, out, g, st);
  if (g.o <= 96) return launch<4, 2, 3>(x, sxp, wp, swp, out, g, st);
  if (g.o <= 128) return launch<4, 2, 4>(x, sxp, wp, swp, out, g, st);
  if (g.o % 96 == 0) return launch<4, 2, 3>(x, sxp, wp, swp, out, g, st);
  return launch<4, 2, 4>(x, sxp, wp, swp, out, g, st);
}

bool valid_codes(int in_code, int out_code) {
  return in_code >= 0 && in_code <= 2 && out_code >= 0 && out_code <= 3;
}

}  // namespace

// The k x k conv: x (n, h, w, c) in the compute dtype, s_x a float32 on the
// device, wq int8 (o, k, k, c), s_w float32 (o,), out (n, ho, wo, o).
extern "C" int int8_conv_forward(const void* x, const void* s_x, const void* wq, const void* s_w,
                                 void* out, int n, int h, int w, int c, int o, int k, int s,
                                 int pt, int pl, int ho, int wo, int in_code, int out_code,
                                 void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || o < 1 || k < 1 || s < 1 || pt < 0 || pl < 0 ||
      ho < 1 || wo < 1 || !valid_codes(in_code, out_code))
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
  g.in_code = in_code;
  g.out_code = out_code;
  return dispatch(x, s_x, wq, s_w, out, g, stream);
}
