// K2: NHWC depthwise 3x3, stride 1 or 2, padding 1, with the fused
// requant epilogue.
//
// Stride 1 replaces dfq_tpu/ops/pallas_int8.py:dw3x3_int8_requant
// (:304-387, pallas_call at :359; body _dw_flat_kernel :165-278):
//
//   acc[n,h,w,c] = sum_{ky,kx} (x[n,h+ky-1,w+kx-1,c] - zp_in) * taps[ky*3+kx, c]
//   (out-of-image taps contribute 0: the padding holds zp_in)
//   f = fma(f32(acc), scale[c], bias[c]); f = clip(f, lo, hi)
//   out = clip(rint(f * inv) + zp_out, -128, 127) as s8, or f as f32
//
// What bounds it on H100: the card could do it at the memory rate (each
// input byte read once, each output byte written once; 9 MACs and one
// requant per output byte), so what a kernel must keep down is its own
// instruction stream. One thread per output word that unpacks bytes,
// subtracts the zero point per tap and reads every input word and tap
// nine times spends some 45 integer operations per output byte, ten
// times the memory time; and rintf and float-to-int conversions run at
// a quarter of the rate of plain integer and float operations.
//
// The strip variant (channel counts that are whole 32-bit words, aligned
// operands) does three things about that:
//
// - the zero point leaves the inner loop: sum (x - zp) * t =
//   sum x * t - zp * sum t, with out-of-image positions read as zp_in (so
//   a border needs no per-tap branch) and zp_in * tapsum[c] packed once on
//   the host (Dw3x3Requant.zp_tapsum);
// - three MACs are one instruction and nothing is unpacked: a thread owns
//   one channel word (4 channels) of a strip of STRIP = 4 output pixels
//   along W. It transposes the words of the 6 input pixels of a row with
//   byte permutes, so that one word holds 4 W-neighbours of ONE channel;
//   a second permute slides a 4-byte window along them, and one
//   __dp4a(window, (t[ky][0], t[ky][1], t[ky][2], 0), acc) is a whole
//   3-tap row sum, exact in int32: 3 dp4a and 3 permutes per output byte
//   where one-MAC-per-dp4a took 9 dp4a, on two different pipes;
// - every input word is loaded and transposed once per thread, not nine
//   times: the thread slides a window of three transposed rows, held in
//   registers, down a slab of `rows` output rows, loading each row one
//   output row ahead of its use (the row loop is kept rolled and the
//   window shifted by register moves: unrolled over the rows it spilled).
//   The caller picks `rows`: tall slabs re-read fewer halo rows, short
//   ones make enough threads at small batch. Taps, scale, bias and
//   zp * tapsum are read once per thread, which is once per
//   STRIP * rows * 4 output bytes; the thread's position is worked out
//   once, with 32-bit divisions, and a load costs one multiply-add of
//   its address; the grid's y dimension walks the images.
//
// The epilogue is the form of int8_epilogue.cuh that gives the same bits
// without rintf and float-to-int conversions. The general variant (any
// channel count, any alignment) is one thread per output byte, as simple
// as can be.
//
// Stride 2 replaces no TPU kernel: the JAX engine runs those convs as XLA
// int8 convs with its glue epilogue, and so, bit for bit, does this one
// (see the stride-2 section below).

#include "int8_epilogue.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STRIP = 4;  // output pixels along W per thread: one word of 4 neighbours

// The words of PIX neighbouring pixels of one input row (stride 1: w0-1 ..
// w0+4); `p` points at the first (it may lie outside the tensor: nothing
// outside is read), bit i of `cols` says that the i-th is in the image.
// Positions outside the image read as the zero point.
template <int PIX>
__device__ __forceinline__ void load_row(uint32_t (&raw)[PIX], const uint32_t* __restrict__ p,
                                         bool row_in, int cols, int CW, uint32_t zp4) {
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    raw[i] = (row_in && ((cols >> i) & 1)) ? __ldg(p + i * CW) : zp4;
}

// Six pixel words (4 channels each) -> per channel c the 4 W-neighbours
// a[c] = (p0[c], p1[c], p2[c], p3[c]) and b[c] = (p4[c], p5[c], -, -).
__device__ __forceinline__ void transpose_row(uint32_t (&a)[4], uint32_t (&b)[4],
                                              const uint32_t (&p)[6]) {
  const uint32_t t0 = __byte_perm(p[0], p[1], 0x5140), t1 = __byte_perm(p[2], p[3], 0x5140);
  const uint32_t t2 = __byte_perm(p[0], p[1], 0x7362), t3 = __byte_perm(p[2], p[3], 0x7362);
  a[0] = __byte_perm(t0, t1, 0x5410);
  a[1] = __byte_perm(t0, t1, 0x7632);
  a[2] = __byte_perm(t2, t3, 0x5410);
  a[3] = __byte_perm(t2, t3, 0x7632);
  b[0] = __byte_perm(p[4], p[5], 0x0040);
  b[1] = __byte_perm(p[4], p[5], 0x0051);
  b[2] = __byte_perm(p[4], p[5], 0x0062);
  b[3] = __byte_perm(p[4], p[5], 0x0073);
}

// acc[j] += sum_kx x[j + kx] * t[kx] for the 4 outputs j of one channel:
// (a, b) hold its inputs 0..5, `t` the row's taps (t0, t1, t2, 0).
__device__ __forceinline__ void mac_row(int (&acc)[4], uint32_t a, uint32_t b, int t) {
  acc[0] = __dp4a((int)a, t, acc[0]);
  acc[1] = __dp4a((int)__byte_perm(a, b, 0x4321), t, acc[1]);
  acc[2] = __dp4a((int)__byte_perm(a, b, 0x5432), t, acc[2]);
  acc[3] = __dp4a((int)__byte_perm(a, b, 0x6543), t, acc[3]);
}

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS, 4)
dw3x3_strip_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ taps,
                   const float4* __restrict__ scale, const float4* __restrict__ bias,
                   const int4* __restrict__ zp_tapsum, void* __restrict__ out, int N,
                   int H, int W, int CW, int strips, int rows, int items, int zp_in,
                   float inv, float zp_out, float lo, float hi) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= items) return;
  const int cw = idx % CW;
  const int rest = idx / CW;
  const int w0 = (rest % strips) * STRIP;
  const int h0 = (rest / strips) * rows;
  const int h_end = min(h0 + rows, H);

  // tap[c][ky] = (t[3 ky][c], t[3 ky + 1][c], t[3 ky + 2][c], 0)
  int tap[4][3];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const uint32_t t0 = __ldg(taps + (3 * ky) * CW + cw);
    const uint32_t t1 = __ldg(taps + (3 * ky + 1) * CW + cw);
    const uint32_t t2 = __ldg(taps + (3 * ky + 2) * CW + cw);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t u = __byte_perm(t0, t1, c | ((4 + c) << 4));
      tap[c][ky] = (int)(__byte_perm(u, t2, 0x0010 | ((4 + c) << 8)) & 0x00ffffffu);
    }
  }
  const float4 sc4 = __ldg(scale + cw), bi4 = __ldg(bias + cw);
  const int4 zt4 = __ldg(zp_tapsum + cw);
  const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
  const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
  const int zt[4] = {zt4.x, zt4.y, zt4.z, zt4.w};
  const uint32_t zp4 = (uint32_t)(zp_in & 0xff) * 0x01010101u;
  const dfq::QuantBounds qb = dfq::quant_bounds(lo, hi, inv, zp_out);
  int cols = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) cols |= ((unsigned)(w0 - 1 + i) < (unsigned)W) << i;
  const long long row_words = (long long)W * CW;

  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const size_t image = (size_t)n * H * W * CW;
    // the word of pixel (h0 - 1, w0 - 1), this thread's channels
    const uint32_t* p = x + image + cw + ((long long)(h0 - 1) * W + (w0 - 1)) * CW;
    // the window: transposed input rows h-1, h, h+1 of the output row h in
    // hand, and the raw row after them, loaded one output row ahead
    uint32_t top_a[4], top_b[4], mid_a[4], mid_b[4], bot_a[4], bot_b[4], ahead[6];
    load_row(ahead, p, h0 > 0, cols, CW, zp4);
    transpose_row(mid_a, mid_b, ahead);
    load_row(ahead, p + row_words, true, cols, CW, zp4);
    transpose_row(bot_a, bot_b, ahead);
    p += 2 * row_words;
    load_row(ahead, p, h0 + 1 < H, cols, CW, zp4);
#pragma unroll 1
    for (int h = h0; h < h_end; ++h) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        top_a[c] = mid_a[c];
        top_b[c] = mid_b[c];
        mid_a[c] = bot_a[c];
        mid_b[c] = bot_b[c];
      }
      transpose_row(bot_a, bot_b, ahead);
      p += row_words;
      if (h + 1 < h_end) load_row(ahead, p, h + 2 < H, cols, CW, zp4);

      int acc[4][4];  // [channel][output pixel]
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = -zt[c];
        mac_row(acc[c], top_a[c], top_b[c], tap[c][0]);
        mac_row(acc[c], mid_a[c], mid_b[c], tap[c][1]);
        mac_row(acc[c], bot_a[c], bot_b[c], tap[c][2]);
      }
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        if (w0 + j < W) {
          float f[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) f[c] = dfq::dequant_fma(acc[c][j], sc[c], bi[c]);
          // one channel word of int8, or its four floats
          const size_t o = image + ((size_t)h * W + (w0 + j)) * CW + cw;
          if constexpr (OUT_F32) {
            static_cast<float4*>(out)[o] =
                make_float4(dfq::clampf(f[0], lo, hi), dfq::clampf(f[1], lo, hi),
                            dfq::clampf(f[2], lo, hi), dfq::clampf(f[3], lo, hi));
          } else {
            // the low bytes of the four values, side by side: three byte permutes
            const uint32_t q01 = __byte_perm(dfq::quant_recip_clamped(f[0], inv, qb),
                                             dfq::quant_recip_clamped(f[1], inv, qb), 0x0040);
            const uint32_t q23 = __byte_perm(dfq::quant_recip_clamped(f[2], inv, qb),
                                             dfq::quant_recip_clamped(f[3], inv, qb), 0x0040);
            static_cast<uint32_t*>(out)[o] = __byte_perm(q01, q23, 0x5410);
          }
        }
      }
    }
  }
}

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
dw3x3_general_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ taps,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     void* __restrict__ out, int N, int H, int W, int C, int zp_in,
                     float inv, float zp_out, float lo, float hi) {
  const long long total = (long long)N * H * W * C;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    int c = (int)(idx % C);
    long long pix = idx / C;
    int w = (int)(pix % W);
    int h = (int)((pix / W) % H);
    int n = (int)(pix / ((long long)W * H));
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      int hh = h + ky - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        int ww = w + kx - 1;
        if (ww < 0 || ww >= W) continue;
        acc += ((int)x[(((size_t)n * H + hh) * W + ww) * C + c] - zp_in) *
               (int)taps[(size_t)(ky * 3 + kx) * C + c];
      }
    }
    float f = dfq::clampf(dfq::dequant_fma(acc, scale[c], bias[c]), lo, hi);
    if constexpr (OUT_F32)
      static_cast<float*>(out)[idx] = f;
    else
      static_cast<int8_t*>(out)[idx] = (int8_t)dfq::quant_recip(f, inv, zp_out);
  }
}

// ---------------------------------------------------------------------------
// Stride 2. Output (h, w) reads input rows 2h-1 .. 2h+1 and columns 2w-1 ..
// 2w+1, so the input is 4 times the output, and reading it bounds the
// call. The strip variant keeps its instruction stream under that by K2's
// three means:
//
// - the zero point leaves the inner loop as zp_in * tapsum, with
//   out-of-image positions read as zp_in;
// - a thread owns one channel word of a strip of STRIP = 4 output pixels,
//   whose windows span the 9 input columns 2w0-1 .. 2w0+7 of a row. Two 4x4
//   byte transposes turn the first 8 pixel words into, per channel, lo =
//   (x0, x1, x2, x3) and hi = (x4, x5, x6, x7); the 9th word stays as it is
//   (its byte c is channel c's x8). The windows of outputs 0 and 2 are lo
//   and hi themselves, those of outputs 1 and 3 one byte permute each
//   ((x2, x3, x4) from lo and hi, (x6, x7, x8) from hi and the 9th word),
//   and each is one __dp4a against the row's taps (t0, t1, t2, 0);
// - every input word is loaded and transposed once per thread: walking down
//   a slab of `rows` output rows, input row 2h+1, the bottom of output row
//   h, is kept transposed as the top of row h+1, so each output row loads
//   two new input rows, one output row ahead of their use.
//
// The epilogue is the one the fused engine's glue gives a conv without a
// kernel (engine/int8_fused.py, the conv step), so that these convs keep
// the JAX engine's outputs bit for bit: f = fma(f32(acc), in_scale *
// w_scale, bias), then the quantize onto the uint8 grid with r = f32(1 /
// f32(s_out)) (dfq::quant_u8, and its fast form in the strip variant), and
// no activation clamp (the graph's activation op follows).

// one input row of a stride-2 strip, transposed: per channel c, lo[c] =
// (x0, x1, x2, x3), hi[c] = (x4, x5, x6, x7); byte c of x8 is channel c's x8
struct RowS2 {
  uint32_t lo[4], hi[4], x8;
};

// four pixel words (4 channels each) -> per channel c its 4 neighbours
__device__ __forceinline__ void transpose4(uint32_t (&a)[4], uint32_t p0, uint32_t p1,
                                           uint32_t p2, uint32_t p3) {
  const uint32_t t0 = __byte_perm(p0, p1, 0x5140), t1 = __byte_perm(p2, p3, 0x5140);
  const uint32_t t2 = __byte_perm(p0, p1, 0x7362), t3 = __byte_perm(p2, p3, 0x7362);
  a[0] = __byte_perm(t0, t1, 0x5410);
  a[1] = __byte_perm(t0, t1, 0x7632);
  a[2] = __byte_perm(t2, t3, 0x5410);
  a[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ RowS2 transpose_row_s2(const uint32_t (&p)[9]) {
  RowS2 r;
  transpose4(r.lo, p[0], p[1], p[2], p[3]);
  transpose4(r.hi, p[4], p[5], p[6], p[7]);
  r.x8 = p[8];
  return r;
}

// acc[j] += sum_kx x[2 j + kx] * t[kx] for the 4 outputs j of channel c,
// `t` the row's taps (t0, t1, t2, 0)
__device__ __forceinline__ void mac_row_s2(int (&acc)[4], const RowS2& r, int c, int t) {
  acc[0] = __dp4a((int)r.lo[c], t, acc[0]);
  acc[1] = __dp4a((int)__byte_perm(r.lo[c], r.hi[c], 0x5432), t, acc[1]);
  acc[2] = __dp4a((int)r.hi[c], t, acc[2]);
  acc[3] = __dp4a((int)__byte_perm(r.hi[c], r.x8, 0x0032 | ((4 + c) << 8)), t, acc[3]);
}

__global__ void __launch_bounds__(THREADS, 4)
dw3x3_s2_strip_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ taps,
                      const float4* __restrict__ scale, const float4* __restrict__ bias,
                      const int4* __restrict__ zp_tapsum, uint32_t* __restrict__ out, int N,
                      int H, int W, int OH, int OW, int CW, int strips, int rows, int items,
                      int zp_in, float r_out, float zp_out128) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= items) return;
  const int cw = idx % CW;
  const int rest = idx / CW;
  const int w0 = (rest % strips) * STRIP;  // output columns w0 .. w0 + 3
  const int h0 = (rest / strips) * rows;
  const int h_end = min(h0 + rows, OH);

  // tap[c][ky] = (t[3 ky][c], t[3 ky + 1][c], t[3 ky + 2][c], 0)
  int tap[4][3];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const uint32_t t0 = __ldg(taps + (3 * ky) * CW + cw);
    const uint32_t t1 = __ldg(taps + (3 * ky + 1) * CW + cw);
    const uint32_t t2 = __ldg(taps + (3 * ky + 2) * CW + cw);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t u = __byte_perm(t0, t1, c | ((4 + c) << 4));
      tap[c][ky] = (int)(__byte_perm(u, t2, 0x0010 | ((4 + c) << 8)) & 0x00ffffffu);
    }
  }
  const float4 sc4 = __ldg(scale + cw), bi4 = __ldg(bias + cw);
  const int4 zt4 = __ldg(zp_tapsum + cw);
  const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
  const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
  const int zt[4] = {zt4.x, zt4.y, zt4.z, zt4.w};
  const uint32_t zp4 = (uint32_t)(zp_in & 0xff) * 0x01010101u;
  const dfq::QuantU8 qb = dfq::quant_u8_bounds(zp_out128, 0.f, 255.f);
  int cols = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) cols |= ((unsigned)(2 * w0 - 1 + i) < (unsigned)W) << i;
  const long long row_words = (long long)W * CW;

  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    // the word of input pixel (2 h0 - 1, 2 w0 - 1), this thread's channels
    const uint32_t* p =
        x + (size_t)n * H * W * CW + cw + ((long long)(2 * h0 - 1) * W + (2 * w0 - 1)) * CW;
    uint32_t* o = out + (size_t)n * OH * OW * CW + cw;
    // the raw input rows 2h and 2h + 1 of the output row h in hand, loaded
    // one output row ahead; 2h < H for every output row h
    uint32_t even[9], odd[9];
    load_row(even, p, h0 > 0, cols, CW, zp4);
    RowS2 top = transpose_row_s2(even);
    p += row_words;
    load_row(even, p, true, cols, CW, zp4);
    load_row(odd, p + row_words, 2 * h0 + 1 < H, cols, CW, zp4);
#pragma unroll 1
    for (int h = h0; h < h_end; ++h) {
      const RowS2 mid = transpose_row_s2(even), bot = transpose_row_s2(odd);
      p += 2 * row_words;
      if (h + 1 < h_end) {
        load_row(even, p, true, cols, CW, zp4);
        load_row(odd, p + row_words, 2 * h + 3 < H, cols, CW, zp4);
      }
      int acc[4][4];  // [channel][output pixel]
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = -zt[c];
        mac_row_s2(acc[c], top, c, tap[c][0]);
        mac_row_s2(acc[c], mid, c, tap[c][1]);
        mac_row_s2(acc[c], bot, c, tap[c][2]);
      }
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        if (w0 + j < OW) {
          int q[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            q[c] = dfq::quant_u8_clamped(dfq::dequant_fma(acc[c][j], sc[c], bi[c]), r_out, qb);
          // the low bytes of the four values, side by side: three byte permutes
          o[((size_t)h * OW + (w0 + j)) * CW] =
              __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040),
                          0x5410);
        }
      }
      top = bot;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dw3x3_s2_general_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ taps,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        int8_t* __restrict__ out, int N, int H, int W, int OH, int OW, int C,
                        int zp_in, float r_out, float zp_out128) {
  const long long total = (long long)N * OH * OW * C;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    int c = (int)(idx % C);
    long long pix = idx / C;
    int w = (int)(pix % OW);
    int h = (int)((pix / OW) % OH);
    int n = (int)(pix / ((long long)OW * OH));
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      int hh = 2 * h + ky - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        int ww = 2 * w + kx - 1;
        if (ww < 0 || ww >= W) continue;
        acc += ((int)x[(((size_t)n * H + hh) * W + ww) * C + c] - zp_in) *
               (int)taps[(size_t)(ky * 3 + kx) * C + c];
      }
    }
    out[idx] = (int8_t)dfq::quant_u8(dfq::dequant_fma(acc, scale[c], bias[c]), r_out, zp_out128,
                                     0.f, 255.f);
  }
}

}  // namespace

// `strip`: 1 launches the strip variant on a grid planned by the caller
// (ops/cuda_int8.py:dw3x3_plan) for strips of `strip_w` pixels, which must
// be this source's STRIP, and slabs of `slab_h` rows; 0 launches the
// general variant. The caller picks by shape and alignment only.
extern "C" int dfq_dw3x3_int8_requant(const void* x, const void* taps, const void* scale,
                                      const void* bias, const void* zp_tapsum, void* out,
                                      int N, int H, int W, int C, int zp_in, float inv,
                                      float zp_out, float lo, float hi, int out_f32,
                                      int strip, int strip_w, int slab_h, int grid_x,
                                      int grid_y, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (strip) {
    static_assert(STRIP == 4, "the strip is one word of 4 W-neighbours");
    if (strip_w != STRIP || slab_h < 1 || C % 4 != 0) return (int)cudaErrorInvalidValue;
    const int CW = C / 4;
    const int strips = (W + STRIP - 1) / STRIP;
    const int items = ((H + slab_h - 1) / slab_h) * strips * CW;
    if (grid_x != (items + THREADS - 1) / THREADS || grid_y < 1)
      return (int)cudaErrorInvalidValue;
    auto xw = static_cast<const uint32_t*>(x);
    auto tw = static_cast<const uint32_t*>(taps);
    auto sc = static_cast<const float4*>(scale);
    auto bi = static_cast<const float4*>(bias);
    auto zt = static_cast<const int4*>(zp_tapsum);
    dim3 grid(grid_x, grid_y);
    if (out_f32)
      dw3x3_strip_kernel<true><<<grid, THREADS, 0, s>>>(
          xw, tw, sc, bi, zt, out, N, H, W, CW, strips, slab_h, items, zp_in, inv, zp_out, lo,
          hi);
    else
      dw3x3_strip_kernel<false><<<grid, THREADS, 0, s>>>(
          xw, tw, sc, bi, zt, out, N, H, W, CW, strips, slab_h, items, zp_in, inv, zp_out, lo,
          hi);
    return (int)cudaGetLastError();
  }
  auto xi = static_cast<const int8_t*>(x);
  auto ti = static_cast<const int8_t*>(taps);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (out_f32)
    dw3x3_general_kernel<true><<<grid_x, THREADS, 0, s>>>(
        xi, ti, sc, bi, out, N, H, W, C, zp_in, inv, zp_out, lo, hi);
  else
    dw3x3_general_kernel<false><<<grid_x, THREADS, 0, s>>>(
        xi, ti, sc, bi, out, N, H, W, C, zp_in, inv, zp_out, lo, hi);
  return (int)cudaGetLastError();
}

// Stride 2, output ceil(H / 2) x ceil(W / 2) x C int8: `strip` as above
// (ops/cuda_int8.py:dw3x3_plan at stride 2), 0 launches the general
// variant. `r_out` is f32(1 / f32(s_out)), `zp_out128` the output zero
// point + 128.
extern "C" int dfq_dw3x3_s2_int8_requant(const void* x, const void* taps, const void* scale,
                                         const void* bias, const void* zp_tapsum, void* out,
                                         int N, int H, int W, int C, int zp_in, float r_out,
                                         float zp_out128, int strip, int strip_w, int slab_h,
                                         int grid_x, int grid_y, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  if (strip) {
    if (strip_w != STRIP || slab_h < 1 || C % 4 != 0) return (int)cudaErrorInvalidValue;
    const int CW = C / 4;
    const int strips = (OW + STRIP - 1) / STRIP;
    const int items = ((OH + slab_h - 1) / slab_h) * strips * CW;
    if (grid_x != (items + THREADS - 1) / THREADS || grid_y < 1)
      return (int)cudaErrorInvalidValue;
    dw3x3_s2_strip_kernel<<<dim3(grid_x, grid_y), THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(taps),
        static_cast<const float4*>(scale), static_cast<const float4*>(bias),
        static_cast<const int4*>(zp_tapsum), static_cast<uint32_t*>(out), N, H, W, OH, OW, CW,
        strips, slab_h, items, zp_in, r_out, zp_out128);
    return (int)cudaGetLastError();
  }
  dw3x3_s2_general_kernel<<<grid_x, THREADS, 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(taps),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), N, H, W, OH, OW, C, zp_in, r_out, zp_out128);
  return (int)cudaGetLastError();
}
