// The int8 encoder's 3 x 3 convs (models/quantize.py::QuantConv) for Hopper
// (sm_90a): quantize the compute-dtype input on its way to the tensor
// cores, the s8 x s8 -> s32 product on wgmma, dequantize in the epilogue,
// one launch a conv. The five k x k convs of the b0 flagship take it
// through ops/int8_conv.py::conv3x3_takes; csrc/int8_conv.cu takes the
// shapes it refuses.
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA's s8
// convolution (ball_action_spotting_tpu/models/quantize.py:92-95,
// conv_general_dilated with preferred_element_type=int32) and its quantize
// and dequantize to XLA's fused elementwise code.
//
// out[n, oy, ox, o] = f(sum_{dy, dx, c} q(x[n, oy*s - pt + dy, ox*s - pl + dx, c])
//                                      * w[o, dy, dx, c])
// over a 3 x 3 window at stride s 1 or 2, x float32, bfloat16 or float16
// NHWC (zero outside the image: TF SAME padding, the extra row and column
// at the bottom and right), q(v) = int8(clamp(rint(float(v) / s_x), -127,
// 127)), w int8 OHWI, and f the int32 sum itself (out_code 3) or
// float32(sum) * (s_x * s_w[o]) rounded once into float32, bfloat16 or
// float16 (out_code 0, 1, 2). s_x is read on the device. Exactness, and the
// quantize filter that spares most elements the IEEE division:
// csrc/int8_hopper.cuh, shared with csrc/int8_gemm.cu.
//
// Bound on an H100 SXM: the bytes. At the flagship's five convs of a TTA-on
// chunk (batch 256) the compute-dtype x read once and the output written
// once take 0.54-1.73 ms at 3.35 TB/s, the s8 operations at most 0.56 ms at
// 1979 TOP/s; quantizing takes some 9 operations an input element and the
// epilogue some 5 an output element, which is why the kernel quantizes each
// staged element once a tile and overlaps it with the copies and products.
//
// Design: an implicit GEMM, M = a tile's output pixels, N = every output
// channel (16, 64, 128 or 192: C_out rounded up, zero weights past it), K =
// the 9 taps times C in 16-byte units (unit j = tap j / CS, channels 16 (j %
// CS).. of it, CS = C / 16 rounded up), two units a k32 step: with C 16 a
// step pairs two taps, with C 48 a step spans two. A persistent block on
// each SM: kC consumer warpgroups and kC producer warps, each producer
// feeding one consumer through its own ring of stages in shared memory,
// completion on mbarriers; a consumer walks its own tiles (tile kC
// blockIdx.x + its index, then + kC gridDim.x, ...), so that the
// consumers' quantizing, products and epilogues overlap. Each consumer runs
// its three phases in turn, each latency-bound, so more consumers hide more:
// kC is 3 where N is 16 or 128, whose sums leave room in the 128 registers
// a thread of 480 gets, and three rings of two stages fit; else 2 (and 168
// registers). A tile is 16 output columns by 4 kMB rows of one image, kMB
// m64 blocks: 4 (N 16, three consumers), 2 (N <= 64) or 1. A stage is the
// tile's input box, the raw compute-dtype x: rows (4 kMB - 1) s + 3 by
// columns 15 s + 3 by 16 CS channels, one TMA tiled load of a 4-D map (N,
// H, W, C) whose zero fill outside the image (negative starts too) and past
// C is the SAME padding. The halo columns and rows neighbouring tiles read
// again come from L2 as a rule (a 16 x 16 tile reads 1.27 times its pixels'
// input, a 4 x 16 tile 1.69 times). TMA cannot convert, so the consumer
// quantizes the stage, each element once, two 16-byte pieces a thread at a
// time, by the filter (a warp-voted branch to the division), into an int8
// tile of its own (positions an odd number of 16-byte units apart, so that
// ldmatrix's eight rows of a matrix, eight neighbouring pixels at stride 1,
// fall in eight bank groups; two-way at stride 2), and releases the stage.
// Then wgmma.mma_async.m64nNk32.s32.s8.s8 with A from registers (RS): each
// step's A fragments are one ldmatrix.x4 per m64 block whose lanes point at
// their pixel's tap and unit in the int8 tile (per-lane offsets of every
// step computed once), so stride 2 and tiles that span rows are address
// arithmetic; the steps go in groups of kG, the next group's fragments
// loaded while the last group's products run. The sums are zeroed just
// before, so that they are dead while the consumer quantizes (else ptxas
// spilled). B, the int8 weights K-major in 64-byte swizzled rows, stays in
// shared memory for the block's life, copied once in the K order above from
// the OHWI weights (which are that order where C is a multiple of 16),
// zeros past C, C_out and the last unit. Every wgmma is issued
// unconditionally (a predicated one makes ptxas serialize them all). The
// epilogue: s_x * s_w of every channel in a table in shared memory, the
// sums to float by the 1.5 * 2^23 constant where a warp's all fit, packed
// 16-bit conversions, out_code a template parameter (a runtime one, and a
// branch for each 8 channels, cost 1.3 ms at blocks_1_1); each warp writes
// its 16 pixels (a row of the tile) of up to 128 bytes of channels into one
// of three staging buffers of its own, in the swizzle of the output's 4-D
// TMA map, and its lane 0 writes them by one TMA store, pixels and channels
// past the output clipped: no barrier across the warpgroup (those cost
// 1.2 ms at blocks_1_1 in the first design, with a store for 64 pixels).

#include <limits.h>

#include "int8_hopper.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 227 * 1024;  // one block's shared memory on an H100
constexpr int kTaps = 9;                // 3 x 3
constexpr int kTileW = 16;              // output columns of a tile: an m64 block is 4 rows
constexpr int kWarpBufs = 3;            // epilogue staging buffers of each warp

// The bytes of a warp's staging buffer in an instance of kN channels: its
// 16 pixels of kN 4-byte channels, at most 128 bytes a pixel.
__host__ __device__ constexpr int warp_buf(int n) { return 16 * (n * 4 < 128 ? n * 4 : 128); }

struct Conv {
  int n, h, w, c, o, s, pt, pl, ho, wo;
  int tiles_y, tiles_x, tiles;  // tiles over an image's output rows and columns; over the batch
  int rh, rw;                   // input rows and columns a tile reads
  int stages;                   // ring slots of each consumer
  int in_code, out_code, oes;   // output element bytes
  uint32_t box_bytes, stage_bytes, q_bytes, q_off, staging_off, scale_off, bar_off, ring_off,
      smem_bytes;
};

__host__ __device__ constexpr uint32_t round1k(uint32_t v) { return (v + 1023u) & ~1023u; }

// d (64 x N s32 sums of the warpgroup) += a (64 x 32 int8, registers) * b
// (32 x N int8 at `desc`); d = a * b where scale_d is 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// Stores to shared memory that the compiler may move other loads across:
// what reads them (ldmatrix behind a barrier, a TMA store behind a fence)
// is an asm volatile statement too, which keeps its place after them.
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v));
}

__device__ __forceinline__ void sts64(uint32_t a, uint32_t v0, uint32_t v1) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(a), "r"(v0), "r"(v1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// A stage's raw input (its positions' 16 kCS channels, dense, as TMA wrote
// them) into the consumer's int8 tile (positions kCS | 1 units of 16 bytes
// apart), 16 raw bytes a thread at a time, two pieces an iteration so that
// their loads and filters overlap, each value by the filter and, where a
// warp holds an undecided one, by the division in a branch.
template <int kIn, int kCS>
__device__ __forceinline__ void quantize_stage(uint32_t raw, uint32_t q, int positions, int t,
                                               float sx, float r, float limit) {
  constexpr int kVals = kIn == 0 ? 4 : 8;    // values a 16-byte piece
  constexpr int kParts = kCS * 16 / kVals;  // pieces a position
  constexpr int kPU = kCS | 1;
  const int total = positions * kParts;
  for (int i0 = 0; i0 < total; i0 += 256) {
    // a thread past the end repeats the last piece: the same bytes to the
    // same place, and every lane takes part in the vote
    int i[2];
    float v[2][kVals];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      i[p] = min(i0 + 128 * p + t, total - 1);
      const uint4 u = lds128(raw + static_cast<uint32_t>(i[p]) * 16);
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (kIn == 0) {
          v[p][k] = __uint_as_float(words[k]);
        } else {
          v[p][2 * k] = lo_half<kIn>(words[k]);
          v[p][2 * k + 1] = hi_half<kIn>(words[k]);
        }
      }
    }
    uint32_t w[2][kVals];
    bool undecided = false;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < kVals; ++e) {
        bool ok;
        w[p][e] = quantize_fast(v[p][e], r, limit, ok);
        undecided |= !ok;
      }
    if (__any_sync(0xffffffffu, undecided)) {
      if (undecided) {
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < kVals; ++e) {
            bool ok;
            quantize_fast(v[p][e], r, limit, ok);
            if (!ok) w[p][e] = quantize_div(v[p][e], sx);
          }
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int pos = i[p] / kParts, part = i[p] - pos * kParts;
      const uint32_t dst = q + static_cast<uint32_t>(pos * (kPU * 16) + part * kVals);
      if (kVals == 8)
        sts64(dst, pack4(w[p][0], w[p][1], w[p][2], w[p][3]),
              pack4(w[p][4], w[p][5], w[p][6], w[p][7]));
      else
        sts32(dst, pack4(w[p][0], w[p][1], w[p][2], w[p][3]));
    }
  }
}

// The s32 sums of a consumer's tile: the K steps in groups of kG, each
// group's A fragments (one ldmatrix.x4 an m64 block and step, at the
// lane's pixel `pix` plus the step's offset `koff`) loaded into one of two
// register sets while the group before runs, then its wgmmas over every
// channel, B at `wts` (chunk st / 2 of 64 K bytes, half st % 2).
template <int kCS, int kN, int kMB, int kG, int kSteps>
__device__ __forceinline__ void products(int (&acc)[kMB][kN / 2], uint32_t q,
                                         const uint32_t (&pix)[kMB],
                                         const uint32_t (&koff)[kSteps], uint32_t wts) {
  uint32_t a[2][kG][kMB][4];
  // Zero here, although the first wgmma ignores the sums (scale_d 0): their
  // "+r" operands would keep the last tile's sums live through the
  // quantize, which then spills.
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      acc[mb][i] = 0;
      fence_operand(acc[mb][i]);
    }
#pragma unroll
  for (int g0 = 0; g0 < kSteps; g0 += kG) {
    const int b = (g0 / kG) & 1;
    if (g0 >= 2 * kG) wgmma_wait<1>();  // the group that last used set b is done
#pragma unroll
    for (int i = 0; i < kG; ++i)
      if (g0 + i < kSteps)
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) ldmatrix_x4(q + pix[mb] + koff[g0 + i], a[b][i][mb]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int st = g0 + i;
      if (st < kSteps) {
        const uint64_t desc = b_desc(wts + (st >> 1) * (kN * 64) + (st & 1) * 32);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) Wgmma<kN>::mma(acc[mb], a[b][i][mb], desc, st > 0);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) fence_operand(acc[mb][i]);
}

// The next of the warp's kWarpBufs staging buffers of kBytes (a shared
// address), once the TMA store that read it kWarpBufs stores before is done
// reading.
template <int kBytes>
__device__ __forceinline__ uint32_t next_buffer(uint32_t staging, uint32_t& slot, int lane) {
  const uint32_t buf = staging + (slot++ % kWarpBufs) * kBytes;
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kWarpBufs - 1) : "memory");
  __syncwarp();
  return buf;
}

// Two channels' output values from their sums into shared memory at
// `addr`, as out_code kOut's bytes (csrc/int8_hopper.cuh's put2).
template <int kOut, bool kSmall>
__device__ __forceinline__ void put2_shared(uint32_t addr, int v0, int v1, float2 scale) {
  if (kOut == 3) {
    sts64(addr, static_cast<uint32_t>(v0), static_cast<uint32_t>(v1));
    return;
  }
  const float2 f = make_float2(__fmul_rn(sum_to_float<kSmall>(v0), scale.x),
                               __fmul_rn(sum_to_float<kSmall>(v1), scale.y));
  if (kOut == 0) {
    sts64(addr, __float_as_uint(f.x), __float_as_uint(f.y));
  } else if (kOut == 1) {
    const __nv_bfloat162 b = __float22bfloat162_rn(f);
    sts32(addr, *reinterpret_cast<const uint32_t*>(&b));
  } else {
    const __half2 b = __float22half2_rn(f);
    sts32(addr, *reinterpret_cast<const uint32_t*>(&b));
  }
}

// A warp's 16 pixels of an m64 block (one output row of the tile: oy,
// columns ox0..ox0 + 15) from their sums `d` into out_code kOut, in units
// of kSpan bytes of channels (kN channels' bytes, at most 128): 8 channels
// at a time (the sums of rows gid and gid + 8, channels 2 t and 2 t + 1)
// into a staging buffer of the warp's, in the swizzle of the output's map,
// then lane 0 writes the unit by one TMA store, clipped to the output (a
// unit may reach past C_out: zero weights and scales there). A unit's code
// has no branch, so that its groups' loads and conversions overlap.
// kSmall: every sum of the warp lies within 2^22.
template <int kN, int kOut, bool kSmall>
__device__ __forceinline__ void epilogue_row(const int (&d)[kN / 2], uint32_t staging,
                                             uint32_t& slot, const float* table,
                                             const CUtensorMap* tmap_out, int o, int n, int oy,
                                             int ox0, int lane) {
  constexpr int kOes = kOut == 1 || kOut == 2 ? 2 : 4;
  constexpr int kSpan = kN * kOes < 128 ? kN * kOes : 128;
  constexpr int kGroups = kSpan / (8 * kOes);  // 8-channel groups a unit
  const int gid = lane >> 2, t = lane & 3;
  // Lane bytes: row gid's (row gid + 8 is 8 kSpan bytes on), the lane's
  // bytes within its 16-byte piece, and the piece's swizzle: group p's
  // piece (p or 2 p, plus t / 2 for 4-byte outputs) XORed with the row's
  // address bits 7.., which rows gid and gid + 8 share.
  const uint32_t row_bits = (static_cast<uint32_t>(gid * kSpan) >> 7) & (kSpan / 16 - 1);
  const uint32_t lane_piece = (kOes == 2 ? 0u : static_cast<uint32_t>(t >> 1)) ^ row_bits;
  const uint32_t lane_bytes = static_cast<uint32_t>(gid * kSpan) +
                              (kOes == 2 ? 4u * t : 8u * (t & 1));
  const float* scales = table + 2 * t;
#pragma unroll
  for (int u = 0; u < kN / 8 / kGroups; ++u) {
    if (8 * kGroups * u >= o) break;  // a unit wholly past C_out; within one, no branch
    const uint32_t buf = next_buffer<warp_buf(kN)>(staging, slot, lane);  // 1024-byte aligned
    const uint32_t row = buf + lane_bytes;
#pragma unroll
    for (int p = 0; p < kGroups; ++p) {
      const int j = u * kGroups + p;
      const float2 sc = *reinterpret_cast<const float2*>(scales + 8 * j);
      const uint32_t addr = row | ((static_cast<uint32_t>(p * kOes / 2) ^ lane_piece) << 4);
      put2_shared<kOut, kSmall>(addr, d[4 * j], d[4 * j + 1], sc);
      put2_shared<kOut, kSmall>(addr + 8 * kSpan, d[4 * j + 2], d[4 * j + 3], sc);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) tma_store_4d(tmap_out, buf, 8 * kGroups * u, ox0, oy, n);
  }
}

// The epilogue of a consumer's tile: warp w's row of each m64 block (4 rows
// of 16 pixels), by the 1.5 * 2^23 constant where all the warp's sums of
// the block fit.
template <int kN, int kMB, int kOut>
__device__ __forceinline__ void epilogue(const int (&acc)[kMB][kN / 2], uint32_t staging,
                                         uint32_t& slot, const float* table,
                                         const CUtensorMap* tmap_out, int o, int n, int oy0,
                                         int ox0, int w, int lane) {
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    bool small = true;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i)
      small &= static_cast<unsigned>(acc[mb][i] + (1 << 22)) < (1u << 23);
    const int oy = oy0 + 4 * mb + w;
    if (__all_sync(0xffffffffu, small))
      epilogue_row<kN, kOut, true>(acc[mb], staging, slot, table, tmap_out, o, n, oy, ox0, lane);
    else
      epilogue_row<kN, kOut, false>(acc[mb], staging, slot, table, tmap_out, o, n, oy, ox0, lane);
  }
}

template <int kCS, int kN, int kMB, int kG, int kC>
__global__ void __launch_bounds__(kC * 160, 1)
int8_conv3x3_kernel(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_out,
                    const unsigned char* __restrict__ wq, const float* __restrict__ sx_ptr,
                    const float* __restrict__ s_w, const Conv g) {
  constexpr int kTileH = 64 * kMB / kTileW;
  constexpr int kPU = kCS | 1;
  constexpr int kUnits = kTaps * kCS;
  constexpr int kSteps = (kUnits + 1) / 2;
  constexpr int kChunks = (kSteps + 1) / 2;
  constexpr int kThreads = kC * 160;  // kC consumer warpgroups and kC producer warps
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // full[c][s] at bar_off + (c * kMaxStages + s) * 8, empty after all fulls
  const uint32_t full0 = base + g.bar_off;
  const uint32_t empty0 = full0 + kC * kMaxStages * 8;
  if (tid == 0) {
    for (int i = 0; i < kC * kMaxStages; ++i) {
      mbar_init(full0 + i * 8, 1);
      mbar_init(empty0 + i * 8, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* table = reinterpret_cast<float*>(smem + g.scale_off);
  const float sx = *sx_ptr;
  for (int i = tid; i < kN; i += kThreads) table[i] = i < g.o ? __fmul_rn(sx, s_w[i]) : 0.0f;
  // The resident weights at offset 0, every thread: chunk ch (units 4 ch..4
  // ch + 3, 64 K bytes) of kN rows, in the 64-byte swizzle; unit j holds
  // channels 16 (j % kCS).. of tap j / kCS, zeros past C, C_out and unit
  // kUnits.
  for (int u = tid; u < kChunks * kN * 4; u += kThreads) {
    const int ch = u / (kN * 4), rest = u - ch * kN * 4;
    const int row = rest >> 2, j = ch * 4 + (rest & 3);
    const int tap = j / kCS, c0 = (j - tap * kCS) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < g.o && j < kUnits && c0 < g.c) {
      const unsigned char* src = wq + (static_cast<size_t>(row) * kTaps + tap) * g.c + c0;
      const int bytes = min(16, g.c - c0);
      if (bytes == 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t word[4] = {0, 0, 0, 0};
        for (int i = 0; i < bytes; ++i) word[i >> 2] |= static_cast<uint32_t>(src[i]) << (8 * (i & 3));
        v = make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    *reinterpret_cast<uint4*>(smem + static_cast<size_t>(ch) * kN * 64 +
                              swz64(static_cast<uint32_t>(rest) * 16)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int workers = kC * static_cast<int>(gridDim.x);
  if (warp >= 4 * kC) {
    // Producer warp of consumer c: lane 0 keeps the ring full.
    const int c = warp - 4 * kC;
    if (lane != 0) return;
    const uint32_t ring = base + g.ring_off + c * g.stages * g.stage_bytes;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = kC * static_cast<int>(blockIdx.x) + c; tile < g.tiles;
         tile += workers) {
      const int tx = tile % g.tiles_x, rest = tile / g.tiles_x;
      const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
      mbar_wait(empty0 + (c * kMaxStages + stage) * 8, phase ^ 1);
      const uint32_t full = full0 + (c * kMaxStages + stage) * 8;
      mbar_expect(full, g.box_bytes);
      tma_load_4d(ring + stage * g.stage_bytes, &tmap_x, full, 0, tx * kTileW * g.s - g.pl,
                  ty * kTileH * g.s - g.pt, n);
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumer warpgroup c: warp w holds pixels 16 w..16 w + 15 of each m64
  // block of a tile.
  const int c = warp >> 2, w = warp & 3, wg_thread = tid & 127, bar = 1 + c;
  const uint32_t ring = base + g.ring_off + c * g.stages * g.stage_bytes;
  const uint32_t q = base + g.q_off + c * g.q_bytes;
  const uint32_t staging = base + g.staging_off + warp * kWarpBufs * warp_buf(kN);
  const float r = __fdiv_rn(1.0f, sx);
  const float limit = filter_limit(r);
  const int positions = g.rh * g.rw;
  // ldmatrix.x4: lane l gives the address of row l & 7 of matrix l >> 3,
  // that is of pixel 16 w + (l & 7) + 8 ((l >> 3) & 1) of each m64 block
  // (pix: its first unit in the int8 tile) and of unit 2 st + (l >> 4) of
  // step st (koff: the unit's offset from a pixel's first, tap (dy, dx)
  // dy rows and dx columns on; any unit past K, whose weights are zero).
  uint32_t pix[kMB];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    const int m = 64 * mb + 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
    pix[mb] = static_cast<uint32_t>(((m / kTileW) * g.rw + m % kTileW) * g.s * (kPU * 16));
  }
  uint32_t koff[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int j = 2 * st + (lane >> 4);
    const int tap = j < kUnits ? j / kCS : 0, seg = j < kUnits ? j - tap * kCS : 0;
    koff[st] = static_cast<uint32_t>((((tap / 3) * g.rw + tap % 3) * kPU + seg) * 16);
  }
  int stage = 0;
  uint32_t phase = 0, slot = 0;
  int acc[kMB][kN / 2];
  for (int tile = kC * static_cast<int>(blockIdx.x) + c; tile < g.tiles;
       tile += workers) {
    const int tx = tile % g.tiles_x, rest = tile / g.tiles_x;
    const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
    mbar_wait(full0 + (c * kMaxStages + stage) * 8, phase);
    const uint32_t raw = ring + stage * g.stage_bytes;
    if (g.in_code == 0)
      quantize_stage<0, kCS>(raw, q, positions, wg_thread, sx, r, limit);
    else if (g.in_code == 1)
      quantize_stage<1, kCS>(raw, q, positions, wg_thread, sx, r, limit);
    else
      quantize_stage<2, kCS>(raw, q, positions, wg_thread, sx, r, limit);
    mbar_arrive(empty0 + (c * kMaxStages + stage) * 8);
    if (++stage == g.stages) {
      stage = 0;
      phase ^= 1;
    }
    // The int8 tile is whole. (Every warp's ldmatrix reads of the last one
    // ended before its wgmmas, which completed before any warp's epilogue.)
    warpgroup_sync(bar);
    products<kCS, kN, kMB, kG, kSteps>(acc, q, pix, koff, base);
    const int oy0 = ty * kTileH, ox0 = tx * kTileW;
    if (g.out_code == 0)
      epilogue<kN, kMB, 0>(acc, staging, slot, table, &tmap_out, g.o, n, oy0, ox0, w, lane);
    else if (g.out_code == 1)
      epilogue<kN, kMB, 1>(acc, staging, slot, table, &tmap_out, g.o, n, oy0, ox0, w, lane);
    else if (g.out_code == 2)
      epilogue<kN, kMB, 2>(acc, staging, slot, table, &tmap_out, g.o, n, oy0, ox0, w, lane);
    else
      epilogue<kN, kMB, 3>(acc, staging, slot, table, &tmap_out, g.o, n, oy0, ox0, w, lane);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 4-D map of a dense (dims[3], dims[2], dims[1], dims[0]) tensor of
// `esize`-byte elements, boxes of `box`.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            const cuuint64_t (&dims)[4], uint64_t esize, const cuuint32_t (&box)[4],
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t strides[3] = {dims[0] * esize, dims[0] * dims[1] * esize,
                                 dims[0] * dims[1] * dims[2] * esize};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Plan the shared memory of a (kCS, kN, kMB) instance, 1024-byte aligned
// parts: the resident weights, each consumer's int8 tile and staging
// buffers, the s_x * s_w table, the mbarriers, then each consumer's ring of
// input boxes, as many as fit up to kMaxStages. False where two a consumer
// do not fit. ops/int8_conv.py::conv3x3_stages is the same sum.
template <int kCS, int kN, int kMB, int kC>
bool plan(Conv& g, int esize) {
  constexpr int kTileH = 64 * kMB / kTileW;
  constexpr uint32_t kSteps = (kTaps * kCS + 1) / 2, kChunks = (kSteps + 1) / 2;
  g.rh = (kTileH - 1) * g.s + 3;
  g.rw = (kTileW - 1) * g.s + 3;
  g.box_bytes = static_cast<uint32_t>(g.rh * g.rw * 16 * kCS * esize);
  g.stage_bytes = round1k(g.box_bytes);
  g.q_bytes = round1k(static_cast<uint32_t>(g.rh * g.rw * (kCS | 1) * 16));
  g.q_off = kChunks * kN * 64;
  g.staging_off = g.q_off + kC * g.q_bytes;
  g.scale_off = g.staging_off + kC * 4 * kWarpBufs * warp_buf(kN);
  g.bar_off = g.scale_off + round1k(kN * 4);
  g.ring_off = g.bar_off + 1024;
  const long long room = static_cast<long long>(kSmemLimit) - 1024 - g.ring_off;
  g.stages = static_cast<int>(
      min(static_cast<long long>(kMaxStages), room / (kC * g.stage_bytes)));
  if (g.stages < 2) return false;
  g.smem_bytes = 1024 + g.ring_off + kC * g.stages * g.stage_bytes;
  return true;
}

// Plan an instance and launch it on one block an SM.
template <int kCS, int kN, int kMB, int kG, int kC>
cudaError_t launch(const void* x, const void* wq, const void* sx, const void* s_w, void* out,
                   Conv g, cudaStream_t stream) {
  constexpr int kTileH = 64 * kMB / kTileW;
  const int esize = g.in_code == 0 ? 4 : 2;
  if (!plan<kCS, kN, kMB, kC>(g, esize)) return cudaErrorInvalidValue;
  g.tiles_y = (g.ho + kTileH - 1) / kTileH;
  g.tiles_x = (g.wo + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(g.n) * g.tiles_y * g.tiles_x;
  if (tiles > INT_MAX / 2) return cudaErrorInvalidConfiguration;
  g.tiles = static_cast<int>(tiles);

  CUtensorMap tx{}, to{};
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(g.c), static_cast<cuuint64_t>(g.w),
                                static_cast<cuuint64_t>(g.h), static_cast<cuuint64_t>(g.n)};
  const cuuint32_t x_box[4] = {static_cast<cuuint32_t>(16 * kCS), static_cast<cuuint32_t>(g.rw),
                               static_cast<cuuint32_t>(g.rh), 1};
  if (!encode(&tx, g.in_code == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
              x, x_dims, esize, x_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const cuuint64_t o_dims[4] = {static_cast<cuuint64_t>(g.o), static_cast<cuuint64_t>(g.wo),
                                static_cast<cuuint64_t>(g.ho), static_cast<cuuint64_t>(g.n)};
  const int span = min(128, kN * g.oes);  // epilogue_row's kSpan
  const cuuint32_t o_box[4] = {static_cast<cuuint32_t>(span / g.oes), kTileW, 1, 1};
  const CUtensorMapSwizzle o_swizzle = span == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                       : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode(&to, g.oes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_UINT32,
              out, o_dims, g.oes, o_box, o_swizzle))
    return cudaErrorInvalidValue;

  const auto kernel = int8_conv3x3_kernel<kCS, kN, kMB, kG, kC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem_bytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int grid = min(sms, (g.tiles + kC - 1) / kC);
  kernel<<<grid, kC * 160, g.smem_bytes, stream>>>(tx, to, static_cast<const unsigned char*>(wq),
                                                   static_cast<const float*>(sx),
                                                   static_cast<const float*>(s_w), g);
  return cudaGetLastError();
}

// The instance by C_out (kN, kMB, kG, kC), three consumers where their
// rings of two stages fit and the registers leave room for a third, else
// two: 16 (4 m64 blocks, 16 x 16 tiles, steps in groups of 2, 3
// consumers; else 2, 4, 2), 64 (2, 2, 2), 128 (1, 2, 3; else 1, 4, 2), 192
// (1, 2, 2).
template <int kCS>
cudaError_t dispatch(const void* x, const void* wq, const void* sx, const void* s_w, void* out,
                     const Conv& g, cudaStream_t stream) {
  const int esize = g.in_code == 0 ? 4 : 2;
  Conv three = g;
  if (g.o <= 16) {
    if constexpr (kCS < 3) {  // at C above 32 three rings of 16 x 16 tiles never fit
      if (plan<kCS, 16, 4, 3>(three, esize))
        return launch<kCS, 16, 4, 2, 3>(x, wq, sx, s_w, out, g, stream);
    }
    return launch<kCS, 16, 2, 4, 2>(x, wq, sx, s_w, out, g, stream);
  }
  if (g.o <= 64) return launch<kCS, 64, 2, 2, 2>(x, wq, sx, s_w, out, g, stream);
  if (g.o <= 128) {
    if (plan<kCS, 128, 1, 3>(three, esize))
      return launch<kCS, 128, 1, 2, 3>(x, wq, sx, s_w, out, g, stream);
    return launch<kCS, 128, 1, 4, 2>(x, wq, sx, s_w, out, g, stream);
  }
  return launch<kCS, 192, 1, 2, 2>(x, wq, sx, s_w, out, g, stream);
}

}  // namespace

// The 3 x 3 conv at stride 1 or 2: x (n, h, w, c) in the compute dtype
// (16-byte aligned, c at most 48 with rows a multiple of 16 bytes), s_x a
// float32 on the device, wq int8 (o, 3, 3, c), o a multiple of 8 up to 192,
// s_w float32 (o,), out (n, ho, wo, o), 16-byte aligned.
extern "C" int int8_conv3x3_forward(const void* x, const void* s_x, const void* wq,
                                    const void* s_w, void* out, int n, int h, int w, int c, int o,
                                    int s, int pt, int pl, int ho, int wo, int in_code,
                                    int out_code, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || c > 48 || o < 8 || o > 192 || o % 8 != 0 ||
      (s != 1 && s != 2) || pt < 0 || pl < 0 || ho < 1 || wo < 1 || in_code < 0 || in_code > 2 ||
      out_code < 0 || out_code > 3)
    return cudaErrorInvalidValue;
  const int esize = in_code == 0 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || (c * esize) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  Conv g{};
  g.n = n;
  g.h = h;
  g.w = w;
  g.c = c;
  g.o = o;
  g.s = s;
  g.pt = pt;
  g.pl = pl;
  g.ho = ho;
  g.wo = wo;
  g.in_code = in_code;
  g.out_code = out_code;
  g.oes = out_code == 0 || out_code == 3 ? 4 : 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 16) return dispatch<1>(x, wq, s_x, s_w, out, g, st);
  if (c <= 32) return dispatch<2>(x, wq, s_x, s_w, out, g, st);
  return dispatch<3>(x, wq, s_x, s_w, out, g, st);
}
