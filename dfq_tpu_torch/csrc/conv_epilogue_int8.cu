// The epilogue of the fused engine's glue convs: an exact int8 conv's
// accumulator to the step's output, in one pass.
//
// It replaces no Pallas kernel: on the TPU, XLA fused this epilogue into
// its int8 conv (dfq_tpu/engine/int8_fused.py, the convs no Pallas kernel
// takes). The port computes those convs' products with cuDNN or
// torch._int_mm (dfq_tpu_torch/engine/int8.py), which leave the
// accumulator in device memory, and its torch epilogue then ran a dozen
// elementwise launches over it, each writing a full-size temporary.
//
//   a = acc[n,h,w,c] - zp_in * wsum[c]                  (int32)
//   f = fma(f32(a), comb[c], bias[c])   or   f32(a) * comb[c] without a bias
//   out = clip(rint(f * r_out) + (zp_out + 128), 0, 255) - 128 as s8,
//         or f as f32 where the output carries no grid
//
// with r_out = f32(1) / f32(s_out) (the glue's reciprocal form, XLA's
// rewrite of x / s) and each operation in the float form that
// int8_epilogue.cuh gives the glue (dequant_fma, quant_u8_clamped).
//
// What bounds it on H100: bytes. It reads 4 bytes of accumulator and
// writes 1 byte of code (or 4 of f32) for each output element, against
// some ten float operations, so one pass over the accumulator at the
// memory rate is the bound (e.g. 136 M elements, 0.68 GB: ~0.2 ms at
// 3.35 TB/s). What the design does about that:
//
// - it reads the accumulator where the product's route leaves it, through
//   its strides, so no copy runs before it: the torch._int_mm routes leave
//   int32 rows [M, Np] of which the first C columns are the output (the
//   row pitch Np > C is a stride), the cuDNN route an f32 conv output whose
//   values are exact integers (|acc| < 2^24), channels-last on the card;
// - rows_vec variant (channels contiguous, 16-byte aligned rows): a thread
//   owns one group of 16 channels and walks pixels grid-stride, so its
//   per-channel constants are loaded once into registers; per pixel it
//   makes four 16-byte loads and one 16-byte int8 store (or four f32
//   ones);
// - the scalar rows variant takes whatever else (ragged or unaligned
//   channel rows, any strides, an NCHW output): one element a load.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_epilogue.cuh"

// the layout of EpilogueArgs in dfq_tpu_torch/ops/conv_epilogue.py
// (one per site and accumulator layout; the two tensors come with each call)
struct EpilogueArgs {
  const int* zpw;      // [C] zp_in * wsum
  const float* comb;   // [C]
  const float* bias;   // [C] (zeros where has_bias is 0)
  long long sb, sh, sw, sc;  // strides of acc, in elements
  int B, H, W, C;
  float r_out, zp128;
  int has_bias, in_f32, out_f32, variant;  // variant: 0 rows_vec, 1 rows
  int tx, ty, grid_x, grid_y;
};

namespace {

using namespace dfq;

constexpr int THREADS = 256;
constexpr int GROUP = 16;        // channels a thread owns

__device__ __forceinline__ int acc_int(int v) { return v; }
// an f32 conv's output holds exact integers: the conversion is exact
__device__ __forceinline__ int acc_int(float v) { return __float2int_rz(v); }

__device__ __forceinline__ float epi(int acc, int zpw, float comb, float bias, bool has_bias) {
  const int a = acc - zpw;
  return has_bias ? dequant_fma(a, comb, bias) : __fmul_rn(__int2float_rn(a), comb);
}

// rows variants: thread (threadIdx.x, blockIdx.y) owns channel group g,
// (threadIdx.y, blockIdx.x) a pixel stride
template <typename In, bool OUT_F32, bool VEC>
__global__ void __launch_bounds__(THREADS) conv_epilogue_rows_kernel(EpilogueArgs a,
                                                                     const In* __restrict__ acc,
                                                                     void* __restrict__ out_) {
  const int G = (a.C + GROUP - 1) / GROUP;
  const int g = blockIdx.y * a.tx + threadIdx.x;
  if (g >= G) return;
  const int c0 = g * GROUP;
  const int nch = min(GROUP, a.C - c0);
  const bool has_bias = a.has_bias != 0;
  int zpw[GROUP];
  float comb[GROUP], bias[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const bool in = j < nch;
    zpw[j] = in ? a.zpw[c0 + j] : 0;
    comb[j] = in ? a.comb[c0 + j] : 0.f;
    bias[j] = in ? a.bias[c0 + j] : 0.f;
  }
  const QuantU8 qb = quant_u8_bounds(a.zp128, 0.f, 255.f);
  const long long HW = (long long)a.H * a.W;
  const long long P = HW * a.B;
  for (long long p = (long long)blockIdx.x * a.ty + threadIdx.y; p < P;
       p += (long long)a.grid_x * a.ty) {
    const long long b = p / HW;
    const long long rem = p - b * HW;
    const long long h = rem / a.W;
    const long long w = rem - h * a.W;
    const In* src = acc + b * a.sb + h * a.sh + w * a.sw + c0 * a.sc;
    int v[GROUP];
    if (VEC) {
#pragma unroll
      for (int q = 0; q < GROUP / 4; ++q) {
        if (4 * q < nch) {
          if constexpr (std::is_same<In, float>::value) {
            const float4 t = reinterpret_cast<const float4*>(src)[q];
            v[4 * q] = acc_int(t.x); v[4 * q + 1] = acc_int(t.y);
            v[4 * q + 2] = acc_int(t.z); v[4 * q + 3] = acc_int(t.w);
          } else {
            const int4 t = reinterpret_cast<const int4*>(src)[q];
            v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
          }
        } else {
          v[4 * q] = v[4 * q + 1] = v[4 * q + 2] = v[4 * q + 3] = 0;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) v[j] = j < nch ? acc_int(src[j * a.sc]) : 0;
    }
    const long long o = p * a.C + c0;
    if (OUT_F32) {
      float* out = static_cast<float*>(out_) + o;
      float f[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) f[j] = epi(v[j], zpw[j], comb[j], bias[j], has_bias);
      if (VEC) {
#pragma unroll
        for (int q = 0; q < GROUP / 4; ++q)
          if (4 * q < nch)
            reinterpret_cast<float4*>(out)[q] =
                make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (j < nch) out[j] = f[j];
      }
    } else {
      int8_t* out = static_cast<int8_t*>(out_) + o;
      int q[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        q[j] = quant_u8_clamped(epi(v[j], zpw[j], comb[j], bias[j], has_bias), a.r_out, qb);
      if (VEC) {
        uint32_t word[GROUP / 4];
#pragma unroll
        for (int k = 0; k < GROUP / 4; ++k)
          word[k] = pack4(q[4 * k], q[4 * k + 1], q[4 * k + 2], q[4 * k + 3]);
        if (a.C % GROUP == 0) {
          *reinterpret_cast<uint4*>(out) = make_uint4(word[0], word[1], word[2], word[3]);
        } else {
#pragma unroll
          for (int k = 0; k < GROUP / 4; ++k)
            if (4 * k < nch) reinterpret_cast<uint32_t*>(out)[k] = word[k];
        }
      } else {
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (j < nch) out[j] = (int8_t)q[j];
      }
    }
  }
}

template <typename In>
cudaError_t launch_rows(const EpilogueArgs& a, const void* acc, void* out, cudaStream_t s) {
  const dim3 grid(a.grid_x, a.grid_y), block(a.tx, a.ty);
  const In* in = static_cast<const In*>(acc);
  if (a.variant == 0) {
    if (a.out_f32) conv_epilogue_rows_kernel<In, true, true><<<grid, block, 0, s>>>(a, in, out);
    else conv_epilogue_rows_kernel<In, false, true><<<grid, block, 0, s>>>(a, in, out);
  } else {
    if (a.out_f32) conv_epilogue_rows_kernel<In, true, false><<<grid, block, 0, s>>>(a, in, out);
    else conv_epilogue_rows_kernel<In, false, false><<<grid, block, 0, s>>>(a, in, out);
  }
  return cudaGetLastError();
}

}  // namespace

// acc: the accumulator (int32 or f32 by in_f32), logical [B, H, W, C]
// through the strides; out: [B, H, W, C] contiguous, int8 or f32
extern "C" int dfq_conv_epilogue(const EpilogueArgs* args, const void* acc, void* out,
                                 void* stream) {
  const EpilogueArgs& a = *args;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.B < 1 || a.H < 1 || a.W < 1 || a.C < 1 || a.grid_x < 1 || a.grid_y < 1 ||
      (a.variant != 0 && a.variant != 1) || a.tx * a.ty > THREADS ||
      (a.variant == 0 && (a.sc != 1 || a.C % 4 != 0 || (uintptr_t)acc % 16 != 0 ||
                          (uintptr_t)out % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  return (int)(a.in_f32 ? launch_rows<float>(a, acc, out, s) : launch_rows<int>(a, acc, out, s));
}
