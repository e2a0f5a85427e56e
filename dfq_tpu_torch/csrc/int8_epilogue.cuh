// Shared device helpers for the int8 kernels: the requant epilogues.
//
// Each helper mirrors one floating-point form that XLA:CPU compiles the
// JAX reference (dfq_tpu/ops/pallas_int8.py run in interpret mode) into.
// The sources are built with --fmad=false, so nothing is contracted
// unless written here as __fmaf_rn, and every other f32 operation is an
// explicitly rounded intrinsic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dfq {

// the devices a process may launch on: per-device state of the entry points
// (the opt-in shared-memory attribute) is kept in arrays of this length
constexpr int MAX_DEVICES = 64;

// f32(acc) * scale + bias: XLA:CPU contracts the multiply-add into one
// FMA. The int32 -> f32 conversion rounds to nearest even, as XLA's
// convert does.
__device__ __forceinline__ float dequant_fma(int acc, float scale, float bias) {
  return __fmaf_rn(__int2float_rn(acc), scale, bias);
}

// jnp.clip(f, lo, hi) == minimum(maximum(f, lo), hi)
__device__ __forceinline__ float clampf(float f, float lo, float hi) {
  return fminf(fmaxf(f, lo), hi);
}

// K1/K2 epilogue: clip(rint(f * inv) + zp, -128, 127). `inv` is
// f32(1.0 / s_out) with the division done in float64 on the host, which
// is what the Pallas kernels bake in (pallas_int8.py:133, :355).
__device__ __forceinline__ int quant_recip(float f, float inv, float zp) {
  float q = __fadd_rn(rintf(__fmul_rn(f, inv)), zp);
  return __float2int_rn(clampf(q, -128.f, 127.f));
}

// The same value as quant_recip(clampf(f, lo, hi), inv, zp) on fewer and
// faster operations, for the kernels whose time is their instruction
// stream (on H100 rintf and float-to-int conversion run at 16 a clock
// and SM, min, max and add at 64 or 128).
// g(f) = rint(f * inv) + zp is non-decreasing in f (a product by the
// positive inv, rint and a sum each are), so g(clampf(f, lo, hi)) =
// clamp(g(f), g(lo), g(hi)), and the outer clip to [-128, 127] folds into
// those bounds: q = clamp(g(f), qlo, qhi) with qlo = quant_recip(lo) and
// qhi = quant_recip(hi). The bounds are integers, so the clip moves
// inside the rounding, clamp(rint(v), L, H) = rint(clamp(v, L, H)) with
// v = f * inv, L = qlo - zp, H = qhi - zp; and |clamp(v, L, H)| <= 256, so
// adding 1.5 * 2^23 rounds it to nearest even exactly as rintf does and
// leaves the integer in the low mantissa bits. The zero point is added in
// the integers. The bounds are made once per thread.
struct QuantBounds {
  float lo, hi;  // qlo - zp, qhi - zp
  int add;       // zp less the bit pattern of 1.5 * 2^23
};

constexpr float kRoundMagic = 12582912.f;  // 1.5 * 2^23 = 0x4B400000

__device__ __forceinline__ QuantBounds quant_bounds(float lo, float hi, float inv, float zp_f) {
  QuantBounds b;
  const int zp = __float2int_rn(zp_f);
  b.lo = __int2float_rn(quant_recip(lo, inv, zp_f) - zp);
  b.hi = __int2float_rn(quant_recip(hi, inv, zp_f) - zp);
  b.add = zp - 0x4B400000;
  return b;
}

__device__ __forceinline__ int quant_recip_clamped(float f, float inv, const QuantBounds& b) {
  const float v = clampf(__fmul_rn(f, inv), b.lo, b.hi);
  return __float_as_int(__fadd_rn(v, kRoundMagic)) + b.add;
}

// Engine / K3 quantize: (clip(rint(f * r) + (zp + 128), lo, hi) - 128).
// XLA rewrites `f / s` by a constant into f * f32(1 / f32(s)); the host
// passes that `r`. lo/hi are in the +128 (uint8) domain.
__device__ __forceinline__ int quant_u8(float f, float r, float zp128, float lo,
                                        float hi) {
  float q = __fadd_rn(rintf(__fmul_rn(f, r)), zp128);
  return __float2int_rn(clampf(q, lo, hi)) - 128;
}

// The same value as quant_u8 on fewer and faster operations, for integer
// zp128, lo <= hi (all three are integers in [0, 255] held as floats).
// With v = f * r and R = rint(v): if |R| < 2^23 the sum R + zp128 is exact
// in f32, so clip(R + zp128, lo, hi) = clip(R, lo - zp128, hi - zp128) +
// zp128; if |R| >= 2^23 both sides sit on the same bound (R + zp128 keeps
// R's sign and is far outside [lo, hi]). The bounds L = lo - zp128 and
// H = hi - zp128 are integers, so the clip moves inside the rounding,
// clip(rint(v), L, H) = rint(clip(v, L, H)), and |clip(v, L, H)| <= 255, so
// adding 1.5 * 2^23 rounds it to nearest even exactly as rintf does and
// leaves the integer in the low mantissa bits. zp128 - 128 is added in the
// integers. A NaN takes the lower bound in both forms (fmaxf drops it).
struct QuantU8 {
  float lo, hi;  // lo - zp128, hi - zp128
  int add;       // zp128 - 128 less the bit pattern of 1.5 * 2^23
};

__device__ __forceinline__ QuantU8 quant_u8_bounds(float zp128, float lo, float hi) {
  QuantU8 b;
  b.lo = __fsub_rn(lo, zp128);
  b.hi = __fsub_rn(hi, zp128);
  b.add = __float2int_rn(zp128) - 128 - 0x4B400000;
  return b;
}

__device__ __forceinline__ int quant_u8_clamped(float f, float r, const QuantU8& b) {
  const float v = clampf(__fmul_rn(f, r), b.lo, b.hi);
  return __float_as_int(__fadd_rn(v, kRoundMagic)) + b.add;
}

// quant_u8 once more for the grids whose lower bound is their zero point
// (lo == zp128: the floor of a ReLU, K3's e and d grids), with one
// operation on the integer pipe less than quant_u8_clamped, which its
// callers are bound by. With v = f * r the value is
// clip(rint(v), 0, H) + zp128 - 128, H = hi - zp128 an integer in [0, 255].
// - s = sat(f * (r * 2^-8)) is one multiply whose result the hardware
//   clamps to [0, 1] (a NaN gives 0, the lower bound as in quant_u8).
//   Scaling by 2^-8 is exact on r and on the rounded product (an underflow
//   can only happen where |v| < 2^-118, and then both forms give 0), so
//   s = clip(v, 0, 256) / 256 exactly;
// - t = fma(s, 256, 1.5 * 2^23) rounds clip(v, 0, 256) to nearest even as
//   rintf does (256 s is exact inside the fma) and leaves the integer, 0
//   .. 256, in the low mantissa bits;
// - the upper clip is an integer minimum against the bits of 1.5 * 2^23 +
//   H: rint is monotone and H <= 255 < 256, so min(rint(clip(v, 0, 256)),
//   H) = clip(rint(v), 0, H); the zero point is added in the integers.
struct QuantRelu {
  float r256;  // r * 2^-8
  int top;     // the bit pattern of 1.5 * 2^23 + H
  int add;     // zp128 - 128 less the bit pattern of 1.5 * 2^23
};

__device__ __forceinline__ QuantRelu quant_relu_bounds(float r, float zp128, float hi) {
  QuantRelu b;
  b.r256 = __fmul_rn(r, 0.00390625f);
  b.top = 0x4B400000 + __float2int_rn(__fsub_rn(hi, zp128));
  b.add = __float2int_rn(zp128) - 128 - 0x4B400000;
  return b;
}

__device__ __forceinline__ int quant_relu(float f, const QuantRelu& b) {
  float s;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(s) : "f"(f), "f"(b.r256));
  return min(__float_as_int(__fmaf_rn(s, 256.f, kRoundMagic)), b.top) + b.add;
}

// Grid-to-grid int8 requant (engine _requant_i8, K3 :452-453):
// (q - zp) * ratio + (zp' + 128) is one FMA under XLA:CPU, ratio is the
// host's float64 s/s' rounded once to f32.
__device__ __forceinline__ int requant(int q, int zp_from, float ratio,
                                       float zp_to128) {
  float r = __fmaf_rn(__int2float_rn(q - zp_from), ratio, zp_to128);
  return __float2int_rn(clampf(rintf(r), 0.f, 255.f)) - 128;
}

// The same value as requant without rintf and the conversion: the bounds
// 0 and 255 are integers, so the clip moves inside the rounding, and the
// clipped value rounds by the add of 1.5 * 2^23.
__device__ __forceinline__ int requant_clamped(int q, int zp_from, float ratio,
                                               float zp_to128) {
  const float r = clampf(__fmaf_rn(__int2float_rn(q - zp_from), ratio, zp_to128), 0.f, 255.f);
  return __float_as_int(__fadd_rn(r, kRoundMagic)) - (0x4B400000 + 128);
}

__device__ __forceinline__ int8_t byte_of(uint32_t w, int i) {
  return (int8_t)((w >> (8 * i)) & 0xff);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

}  // namespace dfq
