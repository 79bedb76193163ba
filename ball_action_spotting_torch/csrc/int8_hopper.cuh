// What csrc/int8_gemm.cu (the 1 x 1 convs) and csrc/int8_conv3x3.cu (the
// 3 x 3 convs) share: the quantize filter and the Hopper (sm_90a)
// primitives both are built from (TMA, mbarriers, wgmma, the dequantizing
// epilogue's stores). native.py hashes this header into both libraries'
// names, so an edit here rebuilds both.
//
// Exactness: the JAX package's arithmetic as XLA compiles it, which the plain
// version (ops/int8_conv.py: quantize, the s8 sums, dequantize) repeats, bit
// for bit, as csrc/int8_conv.cu states it: float(v) / s_x is IEEE division,
// rint rounds half to even (a float t in [-127, 127] plus 1.5 * 2^23, whose
// low byte is then rint(t) as int8; clamping before rounding gives what
// clamping after gives), float32(sum) is exact below 2^22 in magnitude and
// else cvt.rn, and s_x * s_w[o] is one float32 product before the one
// product with float32(sum).
//
// The quantize filter. Most elements skip the division: with r = RN(1 / s_x)
// taken once and t = RN(v * r), |t - RN(v / s_x)| <= |v / s_x| (3 * 2^-24 +
// 2^-48): RN(v / s_x) is v / s_x within a relative 2^-24, r is 1 / s_x within
// 2^-24 and t is v * r within 2^-24. Where t (clamped to [-127, 127]) lies
// within 127 of zero that is below 127.0001 * 3 * 2^-24 < 2.3e-5 < delta =
// 2^-15. So where the clamped t lies more than delta from every half-integer,
// that is |t - rint(t)| < 0.5 - delta, rint(clamp(t)) is rint(clamp(RN(v /
// s_x))); a t clamped to +-127 has |v / s_x| > 126.99998 and gives +-127 both
// ways. NaN clamps to -127 and +-inf to +-127 both ways. Elsewhere (about
// 2 delta of the elements) the element takes the IEEE division, in a branch
// that a warp enters where one of its values is undecided: a warp-voted
// branch, never a select, which would cost every element the division. The
// filter needs r finite and normal (a subnormal r has a larger relative
// error, an infinite one turns 0 into NaN): else every element takes the
// division (filter_limit).
// Its products and sums are __fmul_rn, __fadd_rn and __fsub_rn, which nvcc
// never contracts into a fused multiply-add. ops/int8_conv.py::
// quantize_filtered is the same rule in float32 PyTorch, held to quantize
// bit for bit over every bfloat16 and float16 pattern on the CPU.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMagic = 12582912.0f;            // 1.5 * 2^23
constexpr float kSafe = 0.5f - 1.0f / 32768.0f;  // 0.5 - delta, delta = 2^-15

// The filter's bound for the reciprocal r of s_x: kSafe where r is finite
// and normal, else -1, which leaves every value to the division.
__device__ __forceinline__ float filter_limit(float r) {
  return isfinite(r) && fabsf(r) >= 1.17549435e-38f ? kSafe : -1.0f;
}

// The filter's word for v (note above), whose low byte is q(v) where the
// filter decides it (`ok`), else the division must.
__device__ __forceinline__ uint32_t quantize_fast(float v, float r, float limit, bool& ok) {
  const float t = fminf(fmaxf(__fmul_rn(v, r), -127.0f), 127.0f);
  const float w = __fadd_rn(t, kMagic);
  ok = fabsf(__fsub_rn(t, __fsub_rn(w, kMagic))) < limit;
  return __float_as_uint(w);
}

// q(v) by IEEE division: clamp, then + 1.5 * 2^23 rounds half to even.
__device__ __forceinline__ uint32_t quantize_div(float v, float sx) {
  const float u = fminf(fmaxf(__fdiv_rn(v, sx), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(u, kMagic));
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offsets within 1024-byte aligned tiles of 128- and 64-byte rows, as
// TMA's 128B and 64B swizzles and wgmma's descriptors place them.
__device__ __forceinline__ uint32_t swz128(uint32_t a) { return a ^ ((a >> 3) & 0x70u); }
__device__ __forceinline__ uint32_t swz64(uint32_t a) { return a ^ ((a >> 3) & 0x30u); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A copy that never
// lands (a fault) stops the kernel with a trap after some ten seconds
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptor of a K-major int8 B tile in 64-byte swizzled rows, 8-row
// groups 512 bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// float32(v), rounded to nearest even as torch's int32 -> float32: exact by
// the 1.5 * 2^23 constant below 2^22 in magnitude (kSmall), else the
// conversion, which runs at an eighth of the float rate.
template <bool kSmall>
__device__ __forceinline__ float sum_to_float(int v) {
  if (kSmall) return __fsub_rn(__int_as_float(0x4B400000 + v), kMagic);
  return __int2float_rn(v);
}

// Two channels' output values from their sums, as out_code's bytes at dst:
// the raw sums, or the scaled and rounded values (`scale`: the channels'
// s_x * s_w; one packed conversion for two 16-bit values).
template <bool kSmall>
__device__ __forceinline__ void put2(unsigned char* dst, int v0, int v1, float2 scale,
                                     int out_code) {
  if (out_code == 3) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
    return;
  }
  const float2 f = make_float2(__fmul_rn(sum_to_float<kSmall>(v0), scale.x),
                               __fmul_rn(sum_to_float<kSmall>(v1), scale.y));
  if (out_code == 0)
    *reinterpret_cast<float2*>(dst) = f;
  else if (out_code == 1)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __float22bfloat162_rn(f);
  else
    *reinterpret_cast<__half2*>(dst) = __float22half2_rn(f);
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// bar.sync on named barrier `id` for the 128 threads of a warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which these libraries do not
// link (ops/_cuda.py: the CUDA runtime alone), so it is looked up once at
// run time.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace
