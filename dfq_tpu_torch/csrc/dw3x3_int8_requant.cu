// K2: NHWC depthwise 3x3, stride 1, padding 1, with the fused requant
// epilogue.
//
// Replaces dfq_tpu/ops/pallas_int8.py:dw3x3_int8_requant (:304-387,
// pallas_call at :359; body _dw_flat_kernel :165-278):
//
//   acc[n,h,w,c] = sum_{ky,kx} (x[n,h+ky-1,w+kx-1,c] - zp_in) * taps[ky*3+kx, c]
//   (out-of-image taps contribute 0: the padding holds zp_in)
//   f = fma(f32(acc), scale[c], bias[c]); f = clip(f, lo, hi)
//   out = clip(rint(f * inv) + zp_out, -128, 127) as s8, or f as f32
//
// What bounds it on H100: 9 MACs per output byte, so it is memory-bound
// (each input byte read once, each output byte written once at best).
//
// The simple design: one thread per output pixel and 4 contiguous
// channels (one 32-bit word of NHWC int8), reading its 9 taps straight
// from global memory and relying on L1/L2 for the 9x reuse of each input
// word; the MAC is int32 (the Pallas kernel's f32 MAC is exact, so the
// two agree). Channel counts that are not a multiple of 4 take a
// one-channel-per-thread variant. The flat [rows, S, 128] layout,
// pltpu.roll taps and halo DMAs of the TPU kernel are TPU layout devices
// and are not reproduced.

#include "int8_epilogue.cuh"

namespace {

constexpr int THREADS = 256;

template <int V, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
dw3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ taps,
             const float* __restrict__ scale, const float* __restrict__ bias,
             void* __restrict__ out, int N, int H, int W, int C, int zp_in, float inv,
             float zp_out, float lo, float hi) {
  const int CV = C / V;
  const long long total = (long long)N * H * W * CV;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    int cv = (int)(idx % CV);
    long long pix = idx / CV;
    int w = (int)(pix % W);
    int h = (int)((pix / W) % H);
    int n = (int)(pix / ((long long)W * H));
    int c = cv * V;
    int acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      int hh = h + ky - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        int ww = w + kx - 1;
        if (ww < 0 || ww >= W) continue;
        const int8_t* px = x + (((size_t)n * H + hh) * W + ww) * C + c;
        const int8_t* pt = taps + (size_t)(ky * 3 + kx) * C + c;
        if constexpr (V == 4) {
          uint32_t xv = *reinterpret_cast<const uint32_t*>(px);
          uint32_t tv = __ldg(reinterpret_cast<const unsigned int*>(pt));
#pragma unroll
          for (int l = 0; l < V; ++l)
            acc[l] += ((int)dfq::byte_of(xv, l) - zp_in) * (int)dfq::byte_of(tv, l);
        } else {
#pragma unroll
          for (int l = 0; l < V; ++l) acc[l] += ((int)px[l] - zp_in) * (int)pt[l];
        }
      }
    }
    size_t o = (size_t)pix * C + c;
    int q[V];
    float f[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      f[l] = dfq::clampf(dfq::dequant_fma(acc[l], scale[c + l], bias[c + l]), lo, hi);
      q[l] = dfq::quant_recip(f[l], inv, zp_out);
    }
    if constexpr (OUT_F32) {
#pragma unroll
      for (int l = 0; l < V; ++l) static_cast<float*>(out)[o + l] = f[l];
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) =
          dfq::pack4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) static_cast<int8_t*>(out)[o + l] = (int8_t)q[l];
    }
  }
}

template <int V>
void launch(const int8_t* x, const int8_t* taps, const float* scale, const float* bias,
            void* out, int N, int H, int W, int C, int zp_in, float inv, float zp_out,
            float lo, float hi, int out_f32, cudaStream_t stream) {
  long long total = (long long)N * H * W * (C / V);
  long long blocks = (total + THREADS - 1) / THREADS;
  int grid = (int)(blocks < (1LL << 30) ? blocks : (1LL << 30));
  if (grid < 1) grid = 1;
  if (out_f32)
    dw3x3_kernel<V, true><<<grid, THREADS, 0, stream>>>(
        x, taps, scale, bias, out, N, H, W, C, zp_in, inv, zp_out, lo, hi);
  else
    dw3x3_kernel<V, false><<<grid, THREADS, 0, stream>>>(
        x, taps, scale, bias, out, N, H, W, C, zp_in, inv, zp_out, lo, hi);
}

}  // namespace

extern "C" int dfq_dw3x3_int8_requant(const void* x, const void* taps, const void* scale,
                                      const void* bias, void* out, int N, int H, int W,
                                      int C, int zp_in, float inv, float zp_out,
                                      float lo, float hi, int out_f32, void* stream) {
  bool vec = (C % 4 == 0) && ((uintptr_t)x % 4 == 0) && ((uintptr_t)taps % 4 == 0) &&
             ((uintptr_t)out % 4 == 0);
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const int8_t*>(x);
  auto ti = static_cast<const int8_t*>(taps);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (vec)
    launch<4>(xi, ti, sc, bi, out, N, H, W, C, zp_in, inv, zp_out, lo, hi, out_f32, s);
  else
    launch<1>(xi, ti, sc, bi, out, N, H, W, C, zp_in, inv, zp_out, lo, hi, out_f32, s);
  return (int)cudaGetLastError();
}
