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

// Engine / K3 quantize: (clip(rint(f * r) + (zp + 128), lo, hi) - 128).
// XLA rewrites `f / s` by a constant into f * f32(1 / f32(s)); the host
// passes that `r`. lo/hi are in the +128 (uint8) domain.
__device__ __forceinline__ int quant_u8(float f, float r, float zp128, float lo,
                                        float hi) {
  float q = __fadd_rn(rintf(__fmul_rn(f, r)), zp128);
  return __float2int_rn(clampf(q, lo, hi)) - 128;
}

// Grid-to-grid int8 requant (engine _requant_i8, K3 :452-453):
// (q - zp) * ratio + (zp' + 128) is one FMA under XLA:CPU, ratio is the
// host's float64 s/s' rounded once to f32.
__device__ __forceinline__ int requant(int q, int zp_from, float ratio,
                                       float zp_to128) {
  float r = __fmaf_rn(__int2float_rn(q - zp_from), ratio, zp_to128);
  return __float2int_rn(clampf(rintf(r), 0.f, 255.f)) - 128;
}

__device__ __forceinline__ int8_t byte_of(uint32_t w, int i) {
  return (int8_t)((w >> (8 * i)) & 0xff);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

}  // namespace dfq
