// The s8 x s8 -> s32 product of a 1 x 1 conv at stride 1 without padding for
// Hopper (sm_90a): quantize the compute-dtype input on its way to the tensor
// cores, dequantize in the epilogue, one launch a conv. The 36 1 x 1 convs of
// the int8 encoder (models/quantize.py::QuantConv) take it through
// ops/int8_conv.py::gemm_takes.
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA's s8
// convolution (ball_action_spotting_tpu/models/quantize.py:92-95) and its
// quantize and dequantize to XLA's fused elementwise code.
//
// out[m, o] = f(sum_c q(x[m, c]) * w[o, c]) over the (M = N*H*W) x (K = C)
// rows of x in float32, bfloat16 or float16, w int8 (O, K), with
// q(v) = int8(clamp(rint(float(v) / s_x), -127, 127)) and f the int32 sum
// itself (out_code 3) or float32(sum) * (s_x * s_w[o]) rounded once into
// float32, bfloat16 or float16 (out_code 0, 1, 2). s_x is read on the device.
//
// Exactness, and the quantize filter that spares most elements the IEEE
// division: csrc/int8_hopper.cuh, shared with csrc/int8_conv3x3.cu.
//
// Bound on an H100 SXM: the bytes. At the flagship's 1 x 1 shapes of a
// TTA-on chunk (batch 256) the compute-dtype x read once and the output
// written once take 0.19-1.44 ms at 3.35 TB/s (12.5 ms over all 36), the s8
// operations at most a fifth of that at 1979 TOP/s; quantizing takes some 8
// float operations an element, a third of the byte time at K 1152.
//
// Design. A persistent block on each SM (320 threads): two consumer
// warpgroups and two producer warps, each producer feeding one consumer
// through its own ring of stages in shared memory, completion on
// mbarriers. A consumer warpgroup walks its own tiles (tile blockIdx.x * 2
// + its index, then + 2 * gridDim.x, ...), so the two run out of step: one's
// epilogue runs while the other's products run (ping-pong). A tile is 64
// kMB rows by every channel, in N sub-tiles of 32 kNB channels: by C_out,
// kNB x kMB is 1 x 2 (to 32 channels), 2 x 2 (64), else 4 x 1 (sub-tiles of
// 128), so that the s32 sums (16 kNB kMB a thread) fit beside the A
// fragments in the 168 registers a thread of 320 gets. A stage holds 64 K
// of x for the tile's rows, raw, by TMA (cp.async.bulk.tensor, one or two
// 128-byte boxes a row, 128-byte swizzle, zeros past M and K): TMA cannot
// convert, so the consumer threads read their A fragments' x values from
// the stage, quantize them in registers by the filter and feed
// wgmma.mma_async.m64n32k32.s32.s8.s8 with A from registers (RS), kNB kMB
// products a k32 step. B, the int8 weights K-major in shared memory
// (64-byte swizzle): resident for the block's life where their 64-K chunks
// of every sub-tile's rows take at most 96 KB (copied once by every
// thread), else in the ring beside x by TMA, one sub-tile's rows a stage.
// Where a tile has several N sub-tiles and K is at most 256, it quantizes x
// once and its A fragments stay in registers over every sub-tile (C_out
// 1152: nine sub-tiles on one read of x), else x rides the ring again for
// each sub-tile. A stage is released once the products that read it are
// done (wgmma.wait_group 1 behind the next chunk's). Every wgmma is issued
// unconditionally (a sub-tile past C_out multiplies zero weights): a
// predicated one makes ptxas serialize them all. The epilogue dequantizes
// with s_x * s_w (a table in shared memory) in float arithmetic (the sums
// to float by the 1.5 * 2^23 constant where a warp's all fit, the int32 ->
// float32 conversion running at an eighth of the float rate; two 16-bit
// outputs a packed conversion) into staging rows of 128 bytes (32 channels
// of 4 bytes, two blocks of 2), 64 rows a store unit, one of three buffers
// a warpgroup, and one thread writes each unit by one TMA store (rows and
// channels past the output clipped), so the stores are asynchronous and the
// warpgroup goes on to the next unit.

#include "int8_hopper.cuh"

namespace {

constexpr int kConsumers = 2;                    // consumer warpgroups, each with a producer warp
constexpr int kThreads = kConsumers * (128 + 32);
constexpr int kChunk = 64;                       // K of a stage
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 227 * 1024;           // one block's shared memory on an H100
constexpr int kResidentLimit = 96 * 1024;        // ops/int8_conv.py GEMM_RESIDENT_BYTES
constexpr int kStageBuf = 64 * 128;              // epilogue staging: 64 rows of 128 bytes
constexpr int kStageBufs = 3;                    // staging buffers of each consumer warpgroup
constexpr int kStaging = kConsumers * kStageBufs * kStageBuf;
constexpr int kScaleLimit = 8 * 1024;            // the s_x * s_w table's bytes at most

struct Gemm {
  int m, k, n;
  int tiles;        // tiles of 64 kMB rows over m
  int chunks;       // ceil(k / 64)
  int n_sub;        // N sub-tiles of 32 kNB channels over n
  int n_pad;        // weight rows: n_sub sub-tiles
  int stages;       // ring slots of each consumer
  int streamed;     // the weights ride the ring (else resident)
  int keep_a;       // A stays in registers over the N sub-tiles
  int x_boxes;      // 128-byte boxes of x a stage row (esize / 2)
  int out_code, oes;
  int rows16;       // output rows are whole 16-byte pieces
  int w_vec;        // weight rows 16-byte aligned: 16-byte copies
  int scale_table;  // s_x * s_w of every channel in shared memory
  uint32_t x_bytes, stage_bytes, ring_off, staging_off, scale_off, bar_off, smem_bytes;
};

// d (64 x 32 s32 sums of the warpgroup) += a (64 x 32 int8, registers) * b
// (32 x 32 int8 at `desc`); d = a * b where scale_d is 0.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// This thread's A fragment of one k32 step of one m64 block: the x values
// of rows row and row + 8, elements e..e + 3 and e + 16..e + 19 of the
// stage's 64 (boxes of 128-byte rows, box_bytes apart), quantized into the
// four A registers. The filter decides each value; where it leaves one
// undecided anywhere in the warp (about 2 delta of the values), the warp
// takes the division for the undecided ones, so the division is a branch
// and not a select.
template <int kIn>
__device__ __forceinline__ void quantize_a(uint32_t stage, uint32_t box_bytes, int row, int e,
                                           float sx, float r, float limit, uint32_t (&a)[4]) {
  float v[4][4];
  uint32_t q[4][4], undecided = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = row + 8 * (j & 1), ee = e + 16 * (j >> 1);
    if (kIn == 0) {
      const uint4 u = lds128(stage + (ee >> 5) * box_bytes + swz128(rr * 128 + (ee & 31) * 4));
      v[j][0] = __uint_as_float(u.x);
      v[j][1] = __uint_as_float(u.y);
      v[j][2] = __uint_as_float(u.z);
      v[j][3] = __uint_as_float(u.w);
    } else {
      const uint2 u = lds64(stage + swz128(rr * 128 + ee * 2));
      v[j][0] = lo_half<kIn>(u.x);
      v[j][1] = hi_half<kIn>(u.x);
      v[j][2] = lo_half<kIn>(u.y);
      v[j][3] = hi_half<kIn>(u.y);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok;
      q[j][i] = quantize_fast(v[j][i], r, limit, ok);
      undecided |= static_cast<uint32_t>(!ok) << (4 * j + i);
    }
  }
  if (__any_sync(0xffffffffu, undecided != 0)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (undecided & (1u << (4 * j + i))) q[j][i] = quantize_div(v[j][i], sx);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = pack4(q[j][0], q[j][1], q[j][2], q[j][3]);
}

// The dequantizing scales s_x * s_w of this thread's channels (col0 + 8 j
// + 2 t and the next) of a 32-channel block, 0 past the output: from the
// block's table where it has one.
__device__ __forceinline__ void block_scales(const float* __restrict__ s_w, const float* table,
                                             float sx, int col0, int lane, const Gemm& g,
                                             float2 (&sc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
    if (g.scale_table)
      sc[j] = *reinterpret_cast<const float2*>(table + col);
    else
      sc[j] = make_float2(col < g.n ? __fmul_rn(sx, __ldg(s_w + col)) : 0.0f,
                          col + 1 < g.n ? __fmul_rn(sx, __ldg(s_w + col + 1)) : 0.0f);
  }
}

// The epilogue of a consumer warpgroup's 64 rows of an m64 block, in store
// units of 128-byte rows (32 channels of 4 bytes, or two 32-channel blocks
// of 2): each warp dequantizes its 16 rows of a unit into one of the
// warpgroup's kStageBufs staging buffers (64 rows in the 128-byte swizzle
// of the output's TMA map), and one thread writes the unit by one TMA
// store, rows and channels past the output clipped, where output rows are
// whole 16-byte pieces; else the 128 threads write it a 4-byte word at a
// time (an element at a time at an odd edge). A buffer is written again
// once the store that read it kStageBufs units before is done reading.
__device__ __forceinline__ unsigned char* next_buffer(unsigned char* staging, uint32_t& slot,
                                                      int wg_thread, int bar, const Gemm& g) {
  unsigned char* buf = staging + (slot++ % kStageBufs) * kStageBuf;
  if (g.rows16 && wg_thread == 0)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStageBufs - 1) : "memory");
  warpgroup_sync(bar);
  return buf;
}

// One 32-channel block's sums of the warp's 16 rows (from `row` on within
// the unit), dequantized by `sc`, into half `half` of a unit's rows.
__device__ __forceinline__ void stage_block(const int (&d)[16], const float2 (&sc)[4],
                                            unsigned char* buf, int row, int half, int lane,
                                            const Gemm& g) {
  const int gid = lane >> 2, t = lane & 3;
  bool small = true;
#pragma unroll
  for (int i = 0; i < 16; ++i) small &= static_cast<unsigned>(d[i] + (1 << 22)) < (1u << 23);
  if (__all_sync(0xffffffffu, small)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put2<true>(buf + swz128((row + gid + 8 * h) * 128 + (half * 32 + 8 * j + 2 * t) * g.oes),
                   d[4 * j + 2 * h], d[4 * j + 2 * h + 1], sc[j], g.out_code);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put2<false>(buf + swz128((row + gid + 8 * h) * 128 + (half * 32 + 8 * j + 2 * t) * g.oes),
                    d[4 * j + 2 * h], d[4 * j + 2 * h + 1], sc[j], g.out_code);
  }
}

// A unit's staging rows to the output at (row0, col0).
__device__ __forceinline__ void flush_unit(unsigned char* buf, const CUtensorMap* tmap_out,
                                           void* out, int row0, int col0, int wg_thread, int bar,
                                           const Gemm& g) {
  if (g.rows16) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(bar);
    if (wg_thread == 0) tma_store(tmap_out, smem_addr(buf), col0, row0);
    return;
  }
  warpgroup_sync(bar);
  const int cols = 16 / g.oes;  // channels a 16-byte piece
  for (int i = wg_thread; i < 64 * 8; i += 128) {
    const int r = i >> 3, p = i & 7;
    const int row = row0 + r, col = col0 + p * cols;
    if (row >= g.m || col >= g.n) continue;
    const unsigned char* src = buf + swz128(r * 128 + p * 16);
    unsigned char* dst =
        static_cast<unsigned char*>(out) + (static_cast<size_t>(row) * g.n + col) * g.oes;
    const int bytes = min(cols, g.n - col) * g.oes;
    if ((g.n * g.oes) % 4 == 0) {
      for (int b = 0; b < bytes; b += 4)
        *reinterpret_cast<uint32_t*>(dst + b) = *reinterpret_cast<const uint32_t*>(src + b);
    } else {
      for (int b = 0; b < bytes; ++b) dst[b] = src[b];
    }
  }
}

template <int kIn, int kNB, int kMB>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tmap_x,
                 const __grid_constant__ CUtensorMap tmap_w,
                 const __grid_constant__ CUtensorMap tmap_out, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx_ptr, const float* __restrict__ s_w,
                 void* __restrict__ out, const Gemm g) {
  constexpr int kBN = 32 * kNB;                 // channels of an N sub-tile
  constexpr int kTile = 64 * kMB;               // rows of a tile
  constexpr int kSuper = kNB == 4 ? 4 : 2;      // chunks whose A fragments stay in registers
  constexpr uint32_t kBox = kTile * 128;        // one x box: the tile's rows of 128 bytes
  constexpr uint32_t kB = kBN * kChunk;         // a stage's weights
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // full[c][s] at bar_off + (c * kMaxStages + s) * 8, empty after all fulls
  const uint32_t full0 = base + g.bar_off;
  const uint32_t empty0 = full0 + kConsumers * kMaxStages * 8;
  if (tid == 0) {
    for (int i = 0; i < kConsumers * kMaxStages; ++i) {
      mbar_init(full0 + i * 8, 1);
      mbar_init(empty0 + i * 8, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (g.scale_table) {
    float* table = reinterpret_cast<float*>(smem + g.scale_off);
    const float sx = *sx_ptr;
    for (int i = tid; i < g.n_pad; i += kThreads) table[i] = i < g.n ? __fmul_rn(sx, s_w[i]) : 0.0f;
  }
  if (!g.streamed) {
    // The resident weights, every thread: chunk c's rows (n_pad of them) of
    // 64 K bytes, zeros past K and N, in the 64-byte swizzle.
    const int units = g.chunks * g.n_pad * 4;
    const unsigned char* w8 = reinterpret_cast<const unsigned char*>(wq);
    for (int u = tid; u < units; u += kThreads) {
      const int c = u / (g.n_pad * 4), rest = u - c * g.n_pad * 4;
      const int row = rest >> 2, k0 = c * kChunk + (rest & 3) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < g.n && k0 < g.k) {
        const unsigned char* src = w8 + static_cast<size_t>(row) * g.k + k0;
        if (g.w_vec) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (k0 + i < g.k) word[i >> 2] |= static_cast<uint32_t>(src[i]) << (8 * (i & 3));
          v = make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
      *reinterpret_cast<uint4*>(smem + static_cast<size_t>(c) * g.n_pad * kChunk +
                                swz64(static_cast<uint32_t>(rest) * 16)) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int workers = kConsumers * static_cast<int>(gridDim.x);
  if (warp >= 4 * kConsumers) {
    // Producer warp of consumer c: lane 0 keeps the ring full.
    const int c = warp - 4 * kConsumers;
    if (lane != 0) return;
    const uint32_t ring = base + g.ring_off + c * g.stages * g.stage_bytes;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = kConsumers * static_cast<int>(blockIdx.x) + c; tile < g.tiles;
         tile += workers) {
      for (int nt = 0; nt < g.n_sub; ++nt) {
        const bool load_x = nt == 0 || !g.keep_a;
        if (!load_x && !g.streamed) continue;
        for (int ch = 0; ch < g.chunks; ++ch) {
          mbar_wait(empty0 + (c * kMaxStages + stage) * 8, phase ^ 1);
          const uint32_t full = full0 + (c * kMaxStages + stage) * 8;
          const uint32_t st = ring + stage * g.stage_bytes;
          mbar_expect(full, (load_x ? g.x_bytes : 0u) + (g.streamed ? kB : 0u));
          if (load_x)
            for (int b = 0; b < g.x_boxes; ++b)
              tma_load(st + b * kBox, &tmap_x, full, ch * kChunk + b * (kChunk / g.x_boxes),
                       tile * kTile);
          if (g.streamed) tma_load(st + g.x_bytes, &tmap_w, full, ch * kChunk, nt * kBN);
          if (++stage == g.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: warp w holds rows 16 w..16 w + 15 of each m64
  // block of a tile.
  const int c = warp >> 2, w = warp & 3;
  const uint32_t ring = base + g.ring_off + c * g.stages * g.stage_bytes;
  unsigned char* staging = smem + g.staging_off + c * kStageBufs * kStageBuf;
  const int wg_thread = tid & 127, bar = 1 + c;  // named barrier 1 + c: the warpgroup's
  const float* table = reinterpret_cast<const float*>(smem + g.scale_off);
  uint32_t slot = 0;
  const float sx = *sx_ptr;
  const float r = __fdiv_rn(1.0f, sx);
  const float limit = filter_limit(r);
  const int row_a = 16 * w + (lane >> 2);  // this thread's A rows: row_a, row_a + 8
  const int e_a = 4 * (lane & 3);           // and elements e_a.., e_a + 16.. of a k32 step
  int stage = 0;
  uint32_t phase = 0;
  uint32_t a[kMB][2 * kSuper][4];
  int acc[kMB][kNB][16];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int s = 0; s < 2 * kSuper; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[mb][s][i] = 0;

  for (int tile = kConsumers * static_cast<int>(blockIdx.x) + c; tile < g.tiles;
       tile += workers) {
    for (int nt = 0; nt < g.n_sub; ++nt) {
      const bool load_x = nt == 0 || !g.keep_a;
      const bool staged = load_x || g.streamed;
      int prev = -1;
      for (int ch0 = 0; ch0 < g.chunks; ch0 += kSuper) {
#pragma unroll
        for (int cc = 0; cc < kSuper; ++cc) {
          const int ch = ch0 + cc;
          if (ch < g.chunks) {
            uint32_t st = 0;
            if (staged) {
              mbar_wait(full0 + (c * kMaxStages + stage) * 8, phase);
              st = ring + stage * g.stage_bytes;
            }
            if (load_x) {
#pragma unroll
              for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
                for (int s = 0; s < 2; ++s)
                  quantize_a<kIn>(st, kBox, 64 * mb + row_a, 32 * s + e_a, sx, r, limit,
                                  a[mb][2 * cc + s]);
            }
            const uint32_t b0 =
                g.streamed ? st + g.x_bytes : base + (ch * g.n_pad + nt * kBN) * kChunk;
#pragma unroll
            for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
              for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
                for (int i = 0; i < 16; ++i) fence_operand(acc[mb][nb][i]);
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
                for (int nb = 0; nb < kNB; ++nb)
                  wgmma_n32(acc[mb][nb], a[mb][2 * cc + s], b_desc(b0 + nb * 32 * kChunk + s * 32),
                            (ch | s) != 0);
            wgmma_commit();
            if (staged) {
              if (prev >= 0) {
                wgmma_wait<1>();
                mbar_arrive(empty0 + (c * kMaxStages + prev) * 8);
              }
              prev = stage;
              if (++stage == g.stages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int i = 0; i < 16; ++i) fence_operand(acc[mb][nb][i]);
      if (prev >= 0) mbar_arrive(empty0 + (c * kMaxStages + prev) * 8);
      const int per = g.oes == 2 ? 2 : 1;  // 32-channel blocks a store unit
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const int row0 = tile * kTile + 64 * mb;
        unsigned char* buf = staging;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          const int col0 = nt * kBN + nb * 32;
          if (col0 < g.n) {
            const int half = nb % per;
            if (half == 0) buf = next_buffer(staging, slot, wg_thread, bar, g);
            float2 sc[4];
            block_scales(s_w, table, sx, col0, lane, g, sc);
            stage_block(acc[mb][nb], sc, buf, 16 * w, half, lane, g);
            if (half == per - 1 || nb == kNB - 1 || col0 + 32 >= g.n)
              flush_unit(buf, &tmap_out, out, row0, col0 - 32 * half, wg_thread, bar, g);
          }
        }
      }
    }
  }
  if (g.rows16 && wg_thread == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 2-D map of rows of `inner` elements (`pitch` bytes apart), boxes of
// box_inner x box_outer.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
            uint64_t outer, uint64_t pitch, uint32_t box_inner, uint32_t box_outer,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Plan the shared memory of a (kNB, kMB) instance (module note) and launch
// it on one block an SM.
template <int kIn, int kNB, int kMB>
cudaError_t launch(const void* x, const void* wq, const void* sx, const void* s_w, void* out,
                   Gemm g, int esize, cudaStream_t stream) {
  constexpr int kBN = 32 * kNB, kTile = 64 * kMB;
  g.tiles = static_cast<int>((static_cast<long long>(g.m) + kTile - 1) / kTile);
  g.n_sub = (g.n + kBN - 1) / kBN;
  g.n_pad = g.n_sub * kBN;
  g.keep_a = g.k <= (kNB == 4 ? 4 : 2) * kChunk;
  const long long resident = static_cast<long long>(g.chunks) * kChunk * g.n_pad;
  g.streamed = resident > kResidentLimit;
  if (g.streamed && !g.w_vec) return cudaErrorInvalidValue;  // TMA takes the weights
  g.x_bytes = g.x_boxes * kTile * 128;
  g.stage_bytes = g.x_bytes + (g.streamed ? kBN * kChunk : 0);
  g.ring_off = g.streamed ? 0 : static_cast<uint32_t>(resident);
  const uint32_t table = g.n_pad * 4 <= kScaleLimit ? g.n_pad * 4 : 0;
  g.scale_table = table > 0;
  const uint32_t fixed = 1024 + g.ring_off + kStaging + table + 2 * kConsumers * kMaxStages * 8;
  g.stages = min(kMaxStages,
                 static_cast<int>((kSmemLimit - fixed) / (kConsumers * g.stage_bytes)));
  if (g.stages < 2) return cudaErrorInvalidValue;
  g.staging_off = g.ring_off + kConsumers * g.stages * g.stage_bytes;
  g.scale_off = g.staging_off + kStaging;
  g.bar_off = g.scale_off + table;
  g.smem_bytes = 1024 + g.bar_off + 2 * kConsumers * kMaxStages * 8;

  CUtensorMap tx{}, tw{}, to{};
  const CUtensorMapDataType x_type =
      kIn == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16;
  if (!encode(&tx, x_type, x, g.k, g.m, static_cast<uint64_t>(g.k) * esize, 128 / esize, kTile,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (g.streamed && !encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, g.k, g.n, g.k, kChunk, kBN,
                            CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  if (g.rows16 && !encode(&to, g.oes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                          : CU_TENSOR_MAP_DATA_TYPE_UINT32,
                          out, g.n, g.m, static_cast<uint64_t>(g.n) * g.oes, 128 / g.oes, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;

  const auto kernel = int8_gemm_kernel<kIn, kNB, kMB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem_bytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int grid = min(sms, (g.tiles + kConsumers - 1) / kConsumers);
  kernel<<<grid, kThreads, g.smem_bytes, stream>>>(tx, tw, to, static_cast<const int8_t*>(wq),
                                                   static_cast<const float*>(sx),
                                                   static_cast<const float*>(s_w), out, g);
  return cudaGetLastError();
}

// The instance by C_out: n32 products a k32 step (kNB, a sub-tile of 32 kNB
// channels) and m64 blocks a tile (kMB): 1 x 2 to 32 channels, 2 x 2 to
// 64, else 4 x 1 (N sub-tiles of 128).
template <int kIn>
cudaError_t dispatch(const void* x, const void* wq, const void* sx, const void* s_w, void* out,
                     const Gemm& g, int esize, cudaStream_t stream) {
  if (g.n <= 32) return launch<kIn, 1, 2>(x, wq, sx, s_w, out, g, esize, stream);
  if (g.n <= 64) return launch<kIn, 2, 2>(x, wq, sx, s_w, out, g, esize, stream);
  return launch<kIn, 4, 1>(x, wq, sx, s_w, out, g, esize, stream);
}

}  // namespace

// x (m, c) rows in the compute dtype (16-byte aligned, rows a multiple of 16
// bytes), s_x a float32 on the device, wq int8 (o, c) (16-byte aligned with c
// a multiple of 16 where the weights do not stay resident), s_w float32
// (o,), out (m, o).
extern "C" int int8_gemm_forward(const void* x, const void* s_x, const void* wq, const void* s_w,
                                 void* out, int m, int c, int o, int in_code, int out_code,
                                 void* stream) {
  if (m < 1 || c < 1 || o < 1 || in_code < 0 || in_code > 2 || out_code < 0 || out_code > 3)
    return cudaErrorInvalidValue;
  const int esize = in_code == 0 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || (static_cast<long long>(c) * esize) % 16 != 0)
    return cudaErrorInvalidValue;
  Gemm g{};
  g.m = m;
  g.k = c;
  g.n = o;
  g.chunks = (c + kChunk - 1) / kChunk;
  g.x_boxes = esize / 2;
  g.out_code = out_code;
  g.oes = out_code == 0 || out_code == 3 ? 4 : 2;
  g.rows16 = (static_cast<long long>(o) * g.oes) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.w_vec = reinterpret_cast<uintptr_t>(wq) % 16 == 0 && c % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_code == 0) return dispatch<0>(x, wq, s_x, s_w, out, g, esize, st);
  if (in_code == 1) return dispatch<1>(x, wq, s_x, s_w, out, g, esize, st);
  return dispatch<2>(x, wq, s_x, s_w, out, g, esize, st);
}
