// K1: int8 GEMM with the fused requant epilogue.
//
// Replaces dfq_tpu/ops/pallas_int8.py:matmul_int8_requant (:73-158,
// pallas_call at :137; bodies _mm_kernel :52-64 and the f32-out variant
// :121-128). It carries every pointwise conv and the classifier of the
// fused engine:
//
//   acc = x[M,K] s8 . w[N,K]^T s8 (int32)
//   acc -= zp_in * wsum[n]
//   f = fma(f32(acc), scale[n], bias[n]); f = clip(f, lo, hi)
//   out = clip(rint(f * inv) + zp_out, -128, 127) as s8, or f as f32
//
// What bounds it on H100: on the main path K is 16..1280 and N 16..1280,
// so most shapes move far more bytes (the M x N int8 output) than they
// compute; the large-M pointwise convs are memory-bound, the
// classifier (M = batch) is latency-bound.
//
// The simple design: one 64 x 64 output tile per 256-thread block, x and
// w tiles of 32 bytes of K staged in shared memory as 32-bit words, and
// __dp4a (4 int8 MACs into int32) with a 4 x 4 register tile per thread.
// The accumulator is int32: K reaches 1280 and 1280 * 2^14 > 2^24, so an
// f32 sum would not be exact. Ragged M, N and K are masked in the
// kernel (zero-filled tiles), so no operand is padded on the host. The
// epilogue runs in registers and writes the int8 tile once. Tensor-core
// MMA and a pipelined load are for a later, faster version.

#include "int8_epilogue.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;            // bytes of K per stage
constexpr int BKW = BK / 4;       // 32-bit words of K per stage
constexpr int LDW = BKW + 1;      // padded row pitch (words) of the smem tiles
constexpr int THREADS = 256;

// Stage rows [r0, r0 + 64) x bytes [k0, k0 + 32) of a row-major [R, K]
// int8 matrix into tile[64][LDW] words; out-of-range bytes are zero.
template <bool VEC>
__device__ __forceinline__ void load_tile(uint32_t (*tile)[LDW], const int8_t* a,
                                          int R, int K, int r0, int k0) {
  for (int i = threadIdx.x; i < BM * BKW; i += THREADS) {
    int r = i / BKW, kw = i % BKW;
    int row = r0 + r, k = k0 + kw * 4;
    uint32_t v = 0;
    if (row < R) {
      const int8_t* p = a + (size_t)row * K + k;
      if constexpr (VEC) {
        // K % 4 == 0 and a 4-byte aligned base: a word is all in or all out
        if (k < K) v = *reinterpret_cast<const uint32_t*>(p);
      } else {
        int b0 = k < K ? p[0] : 0, b1 = k + 1 < K ? p[1] : 0;
        int b2 = k + 2 < K ? p[2] : 0, b3 = k + 3 < K ? p[3] : 0;
        v = dfq::pack4(b0, b1, b2, b3);
      }
    }
    tile[r][kw] = v;
  }
}

template <bool VEC, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
mm_int8_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const int* __restrict__ wsum, void* __restrict__ out, int M,
                       int N, int K, int zp_in, float inv, float zp_out, float lo,
                       float hi) {
  __shared__ uint32_t xs[BM][LDW];
  __shared__ uint32_t ws[BN][LDW];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<VEC>(xs, x, M, K, m0, k0);
    load_tile<VEC>(ws, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = (int)xs[ty * 4 + i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = (int)ws[tx * 4 + j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float sc[4], bi[4];
  int zw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int n = n0 + tx * 4 + j;
    bool ok = n < N;
    sc[j] = ok ? scale[n] : 0.f;
    bi[j] = ok ? bias[n] : 0.f;
    zw[j] = ok ? zp_in * wsum[n] : 0;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    int q[4];
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j] = dfq::clampf(dfq::dequant_fma(acc[i][j] - zw[j], sc[j], bi[j]), lo, hi);
      q[j] = dfq::quant_recip(f[j], inv, zp_out);
    }
    int nb = n0 + tx * 4;
    if constexpr (OUT_F32) {
      float* o = static_cast<float*>(out) + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nb + j < N) o[nb + j] = f[j];
    } else {
      int8_t* o = static_cast<int8_t*>(out) + (size_t)m * N;
      if (N % 4 == 0 && nb + 3 < N) {
        *reinterpret_cast<uint32_t*>(o + nb) = dfq::pack4(q[0], q[1], q[2], q[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nb + j < N) o[nb + j] = (int8_t)q[j];
      }
    }
  }
}

template <bool VEC>
void launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
            const int* wsum, void* out, int M, int N, int K, int zp_in, float inv,
            float zp_out, float lo, float hi, int out_f32, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (out_f32)
    mm_int8_requant_kernel<VEC, true><<<grid, THREADS, 0, stream>>>(
        x, w, scale, bias, wsum, out, M, N, K, zp_in, inv, zp_out, lo, hi);
  else
    mm_int8_requant_kernel<VEC, false><<<grid, THREADS, 0, stream>>>(
        x, w, scale, bias, wsum, out, M, N, K, zp_in, inv, zp_out, lo, hi);
}

}  // namespace

extern "C" int dfq_matmul_int8_requant(const void* x, const void* w, const void* scale,
                                       const void* bias, const void* wsum, void* out,
                                       int M, int N, int K, int zp_in, float inv,
                                       float zp_out, float lo, float hi, int out_f32,
                                       void* stream) {
  auto xi = static_cast<const int8_t*>(x);
  auto wi = static_cast<const int8_t*>(w);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto ws = static_cast<const int*>(wsum);
  auto s = static_cast<cudaStream_t>(stream);
  if ((K % 4 == 0) && ((uintptr_t)x % 4 == 0) && ((uintptr_t)w % 4 == 0))
    launch<true>(xi, wi, sc, bi, ws, out, M, N, K, zp_in, inv, zp_out, lo, hi, out_f32, s);
  else
    launch<false>(xi, wi, sc, bi, ws, out, M, N, K, zp_in, inv, zp_out, lo, hi, out_f32, s);
  return (int)cudaGetLastError();
}
