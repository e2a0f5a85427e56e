// K3: one whole inverted-residual block in one kernel:
// expand 1x1 -> relu(6) -> depthwise 3x3 s1 -> relu(6) -> project 1x1
// [-> residual add], int8 in and int8 (or f32) out.
//
// Replaces dfq_tpu/ops/pallas_int8.py:fused_block_int8 (:520-640,
// pallas_call at :607; body _fused_block_kernel :429-517; the budget
// check fused_block_fits/_fused_block_vmem :390-412).
//
// What bounds it on H100: the expanded tensor (6x the block width) is
// what the unfused engine would write and read back through device
// memory four times; kept on chip, only the narrow input and output
// cross device memory, and the block is bound by its int8 MACs (expand
// and project GEMMs) on the SM's integer units.
//
// The simple design: one 256-thread block per (image, slab of bh output
// rows). It stages the bh+2 input rows in shared memory (requanted to
// the expand conv's grid), expands them into a shared int8 tile
// [bh+2][W+2][E] whose W-pad columns and out-of-image halo rows hold
// zp_e (f = 0 quantizes exactly to zp_e), runs the int32 depthwise MAC
// into a shared [bh][W][E] int8 tile, then projects per pixel with the
// residual and output epilogue in registers. Both GEMMs use __dp4a with
// a 4-pixel x 4-channel register tile and weights pre-packed on the host
// as 32-bit words of 4 input channels ([C/4][E] and [E/4][C2]), read
// through the read-only cache. bh comes from the shared-memory budget
// (<= 227 KB per block), not the TPU's VMEM budget. Channel counts must
// be multiples of 4; fused_block_fits() says no otherwise and the engine
// runs the block unfused.

#include <mutex>

#include "int8_epilogue.cuh"

// Launch arguments, passed by pointer from the host (a ctypes.Structure
// of the same layout in dfq_tpu_torch/ops/cuda_int8.py).
struct FusedBlockArgs {
  const int8_t* x;       // [N, H, W, C] on the x grid
  const uint32_t* w1;    // [C/4][E] words of 4 input channels
  const float* sc1;      // [E] s_c1 * s_w1
  const float* b1;       // [E]
  const int* ws1;        // [E] column sums of w1
  const int8_t* wd;      // [9][E] depthwise taps
  const float* scd;      // [E]
  const float* bd;       // [E]
  const uint32_t* w2;    // [E/4][C2] words of 4 input channels
  const float* sc2;      // [C2]
  const float* b2;       // [C2]
  const int* ws2;        // [C2]
  void* out;             // [N, H, W, C2] int8 on the out grid, or f32
  int N, H, W, C, E, C2, bh;
  int off_e, off_d, smem;  // shared-memory layout, from fused_block_smem()
  int req_c1;            // x grid != c1 grid
  int zp_x;
  float ratio_c1;        // f32(s_x / s_c1)
  float zp_c1_128;       // zp_c1 + 128
  int zp_c1;
  float r_e, lo_e, hi_e;  // f32(1/f32(s_e)); clamp [zp_e+128, act1_q+128]
  int zp_e;
  float r_d, lo_d, hi_d;
  int zp_d;
  int res;               // residual add fused
  int req_r;             // x grid != res grid
  float ratio_r, zp_r_128, s_r, c_r;  // c_r = -f32(zp_r * s_r)
  float r_p, zp_p_128, s_p, c_p;      // c_p = -f32(zp_p * s_p)
  int out_f32;
  float r_o, zp_o_128;
};

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) fused_block_kernel(const FusedBlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, E = a.E, C2 = a.C2, bh = a.bh;
  const int C4 = C / 4, E4 = E / 4, C24 = C2 / 4;
  const int n_h = (H + bh - 1) / bh;
  const int n = blockIdx.x / n_h;
  const int r0 = (blockIdx.x % n_h) * bh;
  const int R = bh + 2;  // staged rows: image rows r0 - 1 .. r0 + bh

  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);            // [R][W][C4]
  uint32_t* es = reinterpret_cast<uint32_t*>(smem + a.off_e);  // [R][W+2][E4]
  uint32_t* ds = reinterpret_cast<uint32_t*>(smem + a.off_d);  // [bh][W][E4]
  const int8_t* ximg = a.x + (size_t)n * H * W * C;

  // 1. stage the input rows on the expand conv's input grid
  for (int i = threadIdx.x; i < R * W * C4; i += THREADS) {
    int h = r0 - 1 + i / (W * C4);
    if (h < 0 || h >= H) continue;
    uint32_t v = reinterpret_cast<const uint32_t*>(ximg + (size_t)h * W * C)[i % (W * C4)];
    if (a.req_c1) {
      int q[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        q[l] = dfq::requant(dfq::byte_of(v, l), a.zp_x, a.ratio_c1, a.zp_c1_128);
      v = dfq::pack4(q[0], q[1], q[2], q[3]);
    }
    xs[i] = v;
  }
  // W-pad columns and out-of-image halo rows of the expanded tile: zp_e
  const uint32_t zpe4 = dfq::pack4(a.zp_e, a.zp_e, a.zp_e, a.zp_e);
  for (int i = threadIdx.x; i < R * (W + 2) * E4; i += THREADS) {
    int rr = i / ((W + 2) * E4);
    int col = (i / E4) % (W + 2);
    int h = r0 - 1 + rr;
    if (col == 0 || col == W + 1 || h < 0 || h >= H) es[i] = zpe4;
  }
  __syncthreads();

  // 2. expand 1x1 + epilogue, quantized onto the dw input grid (e)
  const int P = R * W;
  for (int it = threadIdx.x; it < ((P + 3) / 4) * E4; it += THREADS) {
    const int eg = it % E4, p0 = (it / E4) * 4;
    const int h_first = r0 - 1 + p0 / W;
    const int h_last = r0 - 1 + min(p0 + 3, P - 1) / W;
    if (h_last < 0 || h_first >= H) continue;  // all four pixels are halo
    int pi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pi[i] = min(p0 + i, P - 1) * C4;
    int acc[4][4] = {};
    for (int c4 = 0; c4 < C4; ++c4) {
      uint4 wv = __ldg(reinterpret_cast<const uint4*>(a.w1 + (size_t)c4 * E) + eg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int xv = (int)xs[pi[i] + c4];
        acc[i][0] = __dp4a(xv, (int)wv.x, acc[i][0]);
        acc[i][1] = __dp4a(xv, (int)wv.y, acc[i][1]);
        acc[i][2] = __dp4a(xv, (int)wv.z, acc[i][2]);
        acc[i][3] = __dp4a(xv, (int)wv.w, acc[i][3]);
      }
    }
    float sc[4], bi[4];
    int zw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int e = eg * 4 + j;
      sc[j] = a.sc1[e];
      bi[j] = a.b1[e];
      zw[j] = a.zp_c1 * a.ws1[e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int p = p0 + i;
      if (p >= P) break;
      int rr = p / W, w = p % W, h = r0 - 1 + rr;
      if (h < 0 || h >= H) continue;  // halo rows already hold zp_e
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = dfq::quant_u8(dfq::dequant_fma(acc[i][j] - zw[j], sc[j], bi[j]), a.r_e,
                             (float)(a.zp_e + 128), a.lo_e, a.hi_e);
      es[((size_t)rr * (W + 2) + w + 1) * E4 + eg] = dfq::pack4(q[0], q[1], q[2], q[3]);
    }
  }
  __syncthreads();

  // 3. depthwise 3x3 (int32 MAC on q - zp_e) + epilogue onto the d grid
  for (int it = threadIdx.x; it < bh * W * E4; it += THREADS) {
    const int eg = it % E4, pix = it / E4;
    const int r = pix / W, w = pix % W;
    if (r0 + r >= H) continue;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t v = es[((size_t)(r + ky) * (W + 2) + w + kx) * E4 + eg];
        uint32_t t = __ldg(reinterpret_cast<const unsigned int*>(a.wd + (ky * 3 + kx) * E) + eg);
#pragma unroll
        for (int l = 0; l < 4; ++l)
          acc[l] += ((int)dfq::byte_of(v, l) - a.zp_e) * (int)dfq::byte_of(t, l);
      }
    int q[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int e = eg * 4 + l;
      q[l] = dfq::quant_u8(dfq::dequant_fma(acc[l], a.scd[e], a.bd[e]), a.r_d,
                           (float)(a.zp_d + 128), a.lo_d, a.hi_d);
    }
    ds[(size_t)pix * E4 + eg] = dfq::pack4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();

  // 4. project 1x1 + epilogue [+ residual through the add's site grids]
  const int PO = bh * W;
  for (int it = threadIdx.x; it < ((PO + 3) / 4) * C24; it += THREADS) {
    const int cg = it % C24, p0 = (it / C24) * 4;
    if (r0 + p0 / W >= H) continue;
    int pi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pi[i] = min(p0 + i, PO - 1) * E4;
    int acc[4][4] = {};
    for (int e4 = 0; e4 < E4; ++e4) {
      uint4 wv = __ldg(reinterpret_cast<const uint4*>(a.w2 + (size_t)e4 * C2) + cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int dv = (int)ds[pi[i] + e4];
        acc[i][0] = __dp4a(dv, (int)wv.x, acc[i][0]);
        acc[i][1] = __dp4a(dv, (int)wv.y, acc[i][1]);
        acc[i][2] = __dp4a(dv, (int)wv.z, acc[i][2]);
        acc[i][3] = __dp4a(dv, (int)wv.w, acc[i][3]);
      }
    }
    float sc[4], bi[4];
    int zw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = cg * 4 + j;
      sc[j] = a.sc2[c];
      bi[j] = a.b2[c];
      zw[j] = a.zp_d * a.ws2[c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int p = p0 + i;
      if (p >= PO) break;
      int h = r0 + p / W, w = p % W;
      if (h >= H) break;
      size_t pix = ((size_t)n * H + h) * W + w;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = dfq::dequant_fma(acc[i][j] - zw[j], sc[j], bi[j]);
        if (a.res) {
          // engine: the project output is quantized onto the add:in site
          // grid, then both operands are dequantized and added in f32;
          // q * s - zp * s is one FMA under XLA:CPU
          float q2 = (float)dfq::quant_u8(f[j], a.r_p, a.zp_p_128, 0.f, 255.f);
          float bf = __fmaf_rn(q2, a.s_p, a.c_p);
          int xq = (int)a.x[pix * C + cg * 4 + j];
          if (a.req_r) xq = dfq::requant(xq, a.zp_x, a.ratio_r, a.zp_r_128);
          float af = __fmaf_rn((float)xq, a.s_r, a.c_r);
          f[j] = __fadd_rn(af, bf);
        }
      }
      if (a.out_f32) {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + pix * C2 + cg * 4) =
            make_float4(f[0], f[1], f[2], f[3]);
      } else {
        int q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = dfq::quant_u8(f[j], a.r_o, a.zp_o_128, 0.f, 255.f);
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out) + pix * C2 + cg * 4) =
            dfq::pack4(q[0], q[1], q[2], q[3]);
      }
    }
  }
}

}  // namespace

extern "C" int dfq_fused_block_int8(const FusedBlockArgs* args, void* stream) {
  const FusedBlockArgs& a = *args;
  // once per process: let the kernel take up to the device's opt-in
  // maximum of dynamic shared memory; each launch asks for a.smem of it
  static std::once_flag once;
  static cudaError_t set_err = cudaSuccess;
  std::call_once(once, [] {
    int dev = 0, optin = 0;
    set_err = cudaGetDevice(&dev);
    if (set_err == cudaSuccess)
      set_err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (set_err == cudaSuccess)
      set_err = cudaFuncSetAttribute(fused_block_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  });
  if (set_err != cudaSuccess) return (int)set_err;
  int n_h = (a.H + a.bh - 1) / a.bh;
  fused_block_kernel<<<a.N * n_h, THREADS, a.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
