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
// cross device memory, and the block's two GEMMs are a few microseconds
// of tensor-core time per site. What a kernel must keep down is its own
// instruction stream (two requant epilogues and nine MACs per expanded
// value) and the serial chain of one thread block where a site has few.
//
// The tensor-core variant (C and C2 multiples of 8, 16-byte aligned x and
// out, a plan that fits: ops/cuda_int8.py:fused_block_plan) rests on one
// observation: E is the N of the expand GEMM, the channel axis of the
// depthwise conv and the K of the project GEMM. A block of 16 warps owns
// (image, slab of bh output rows, share of the output columns) and walks
// over E in chunks of Ec channels, never holding more than one chunk of
// the expanded tensor:
//
// - the x slab [(bh+2) rows][WX pixels][C] is staged once by cp.async and
//   requanted to the expand conv's grid in place, image rows padded to
//   WX = a multiple of 8 pixels, so that an 8-pixel MMA tile never crosses
//   an image row, and K zero-padded to 32 in shared memory only;
// - the project accumulators [bh * WX pixels, C2] live in registers over
//   the whole E loop (a WM x WN block of m16n8 tiles per warp) and start
//   at -zp_d * ws2;
// - per chunk, the weights (w1 rows, the per-channel constants, the
//   depthwise taps, w2 rows) arrive as one flat image, packed on the host
//   in the shared-memory layout, by cp.async into one of two buffers
//   while the previous chunk is computed;
// - expand: mma.sync.m16n8k32 with the CHANNELS as M and the pixels as N
//   (A = w1 rows, B = x rows, both K-major, the 8-byte fragment loads and
//   the 32-mod-64 pitch of K1), so that a thread's accumulator pair is two
//   W-neighbours of one channel. After the epilogue they go as one 16-bit
//   store into the e tile [row][channel][WP bytes]: a channel's pixels of
//   one image row are consecutive bytes, one word of padding on the left
//   and two on the right hold zp_e for good (the row pitch is an odd
//   number of words: 32 channels are 32 banks); rows outside the image
//   hold zp_e too (the engine's f = 0) and no tile is computed for them.
//   Pixels W .. WX - 1 of a row get values of no meaning;
// - depthwise: a thread owns one channel, a strip of 4 output pixels and
//   a run of rows. Three words of an input row hold its 6 inputs; three
//   byte permutes slide the windows (pixel W reads as zp_e) and one __dp4a
//   against (t0, t1, t2, 0) is a 3-tap row sum, exact in int32. The zero
//   point leaves the loop: sum (e - zp_e) t = sum e t - zp_e * tapsum, the
//   accumulator's start.
//   Nothing is transposed: the expand wrote the layout the strip wants.
//   The result goes byte by byte into the d tile [pixel][Ec], K-major for
//   the project (32 lanes are 32 consecutive channels: one store);
// - project: mma.sync with the pixels as M, A = d tile, B = w2 rows of the
//   chunk, accumulated into the registers; after the last chunk f = acc *
//   sc2 + b2 is staged in shared memory and a second pass does the
//   residual and the output quantize on whole words, x read and out
//   written by neighbouring threads;
// - all e and d values are quantized by quant_relu (int8_epilogue.cuh):
//   no rintf, no float-to-int conversion, and of its 4 operations 2 run on
//   the float pipe; the accumulators start at 1.5 * 2^23 as an integer
//   where that makes the int -> float conversion a float subtraction.
//
// E is padded to a multiple of Ec with channels whose weights, constants
// and taps are zero: their e is zp_e, their d is zp_d, and their rows of
// w2 are zero, so they add nothing. Integer sums are exact in any order,
// so chunking E changes no bit.
//
// The general variant takes every other shape fused_block_fits() admits
// (channels multiples of 4): one block per (image, slab of bh rows), the
// whole expanded tile [bh+2][W+2][E] and the depthwise tile [bh][W][E] in
// shared memory, both GEMMs on __dp4a with a 4 x 4 register tile and
// weights packed as 32-bit words of 4 input channels ([C/4][E] and
// [E/4][C2]) read through the read-only cache. The caller picks by shape
// and alignment only.

#include <mutex>
#include <type_traits>

#include "int8_epilogue.cuh"

// Launch arguments, passed by pointer from the host (a ctypes.Structure
// of the same layout in dfq_tpu_torch/ops/cuda_int8.py).
struct FusedBlockArgs {
  const int8_t* x;       // [N, H, W, C] on the x grid
  const uint32_t* w1;    // [C/4][E] words of 4 input channels (general variant)
  const float* sc1;      // [E] s_c1 * s_w1
  const float* b1;       // [E]
  const int* ws1;        // [E] column sums of w1
  const int8_t* wd;      // [9][E] depthwise taps
  const float* scd;      // [E]
  const float* bd;       // [E]
  const uint32_t* w2;    // [E/4][C2] words of 4 input channels (general variant)
  const float* sc2;      // [C2]
  const float* b2;       // [C2]
  const int* ws2;        // [C2]
  void* out;             // [N, H, W, C2] int8 on the out grid, or f32
  const int8_t* wimg;    // the tensor-core variant's weights: nk chunk images
  const int* zw2;        // [C2] zp_d * ws2
  int N, H, W, C, E, C2, bh;
  int off_e, off_d, smem;  // shared-memory layout, from the caller's plan
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
  // the tensor-core variant's plan (mma = 0: the general variant)
  int mma;
  int ec, nk;            // channels of E per chunk, chunks
  int wx, wp;            // pixels per staged image row; bytes per e-tile row
  int p1, p2;            // bytes per staged row of K = C and of K = ec
  int mt, ntb;           // m16 pixel tiles and n8 column tiles of one block
  int csplit;            // blocks sharing the columns of one slab (grid y)
  int wm, wn, wgm;       // m x n tiles per warp; warps along m
  int dr;                // output rows per depthwise item
  int off_t;             // the table of pixel tiles
  int off_w, wbuf;       // the two weight buffers: offset, bytes of one
  int fpitch;            // floats per pixel of the staged project output
  int img_c, img_w2, img_stride;  // chunk image: constants, w2 rows, bytes
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

// ---------------------------------------------------------------------------
// the tensor-core variant

constexpr int EXP_NT = 4;  // n8 pixel tiles per expand item: one A fragment feeds all
// The block's table of the pixel tiles whose image row is inside the
// image, padded to whole items with tiles that read x row 0 and write a
// spare row of the e tile. An entry: bits 0..19 the byte offset of the
// tile's first pixel in the e tile (of channel 0), bits 20.. its index
// among the 8-row tiles of the x slab.
constexpr int TILE_OFFSET = (1 << 20) - 1;
constexpr int TILE_X_SHIFT = 20;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D += A (16 x 32, row) . B (32 x 8, col), int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The windows of the 4 outputs of a strip over one input row of one
// channel: w0, w1, w2 are the words at pixels 4s-4, 4s, 4s+4; output j
// needs pixels 4s+j-1 .. 4s+j+1 in bytes 0..2 (byte 3 meets a zero tap).
// `keep` and `put` patch the word that holds pixel W (ones and zeros where
// the strip has none): w = (w & keep) | put.
__device__ __forceinline__ void strip_windows(uint32_t (&win)[4], const uint32_t* p,
                                              const uint2 keep, const uint2 put) {
  const uint32_t w0 = p[0], w1 = (p[1] & keep.x) | put.x, w2 = (p[2] & keep.y) | put.y;
  win[0] = __byte_perm(w0, w1, 0x6543);
  win[1] = w1;
  win[2] = __byte_perm(w1, w2, 0x4321);
  win[3] = __byte_perm(w1, w2, 0x5432);
}

// 16 warps a block, one block an SM: 128 registers a thread, of which the
// project accumulators take 4 * WM * WN.
constexpr int NW = 16;

template <int WM, int WN>
__global__ void __launch_bounds__(NW * 32, 1) fused_block_mma_kernel(const FusedBlockArgs a) {
  constexpr int THREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, C2 = a.C2, bh = a.bh;
  const int Ec = a.ec, WX = a.wx, WP = a.wp, P1 = a.p1, P2 = a.p2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_h = (H + bh - 1) / bh;
  const int n = blockIdx.x / n_h;
  const int r0 = (blockIdx.x % n_h) * bh;
  const int R = bh + 2;  // staged rows: image rows r0 - 1 .. r0 + bh
  const int n0 = blockIdx.y * a.ntb * 8;     // this block's first output column
  const int nvb = min(a.ntb * 8, C2 - n0);   // and how many, a multiple of 8
  const int KP = (C + 31) / 32 * 32;

  unsigned char* const xs = smem;              // [R * WX][P1]
  unsigned char* const es = smem + a.off_e;    // [R][Ec][WP]
  unsigned char* const ds = smem + a.off_d;    // [mt * 16][P2]
  unsigned char* const wb = smem + a.off_w;    // 2 x chunk image
  int* const tiles = reinterpret_cast<int*>(smem + a.off_t);
  const uint32_t wb_sa = static_cast<uint32_t>(__cvta_generic_to_shared(wb));
  const int8_t* ximg = a.x + (size_t)n * H * W * C;

  // start the copy of chunk k's image into buffer k & 1: the part every
  // block takes, then this block's rows of w2
  auto copy_chunk = [&](int k) {
    const int8_t* src = a.wimg + (size_t)k * a.img_stride;
    const uint32_t dst = wb_sa + (k & 1) * a.wbuf;
    for (int i = tid * 16; i < a.img_w2; i += THREADS * 16) cp_async16(dst + i, src + i);
    const int8_t* src2 = src + a.img_w2 + n0 * P2;
    for (int i = tid * 16; i < nvb * P2; i += THREADS * 16)
      cp_async16(dst + a.img_w2 + i, src2 + i);
    cp_commit();
  };
  copy_chunk(0);

  // the x slab: zeros (the K pad, the pixels past W, rows outside the
  // image), then the image rows
  for (int i = tid * 16; i < a.off_e; i += THREADS * 16)
    *reinterpret_cast<uint4*>(xs + i) = make_uint4(0u, 0u, 0u, 0u);
  // what holds zp_e for good: the e tile's padding (the word left of
  // pixel 0 and the two words right of pixel WX - 1 of every (row,
  // channel)) and its rows outside the image (the engine's f = 0 there is
  // exactly zp_e). Pixels W .. WX - 1 are written by the expand with values
  // of no meaning; the depthwise puts zp_e in the place of pixel W, the
  // only one of them a valid output reads.
  const uint32_t zpe4 = (uint32_t)(a.zp_e & 0xff) * 0x01010101u;
  const int ra = max(0, 1 - r0), rb = min(R, H + 1 - r0);  // staged rows inside the image
  const int wp4 = WP / 4;
  {
    uint32_t* const ew = reinterpret_cast<uint32_t*>(es);
    for (int i = tid; i < ra * Ec * wp4; i += THREADS) ew[i] = zpe4;
    for (int i = rb * Ec * wp4 + tid; i < R * Ec * wp4; i += THREADS) ew[i] = zpe4;
    for (int i = ra * Ec + tid; i < rb * Ec; i += THREADS) {
      ew[i * wp4] = zpe4;
      ew[i * wp4 + wp4 - 2] = zpe4;
      ew[i * wp4 + wp4 - 1] = zpe4;
    }
  }
  const int nt_row = WX / 8;          // n8 pixel tiles per staged image row
  const int NTI = (rb - ra) * nt_row; // pixel tiles inside the image
  const int ngroups = (NTI + EXP_NT - 1) / EXP_NT;
  for (int i = tid; i < ngroups * EXP_NT; i += THREADS) {
    const int nt = ra * nt_row + i;
    const int r = nt / nt_row, w0 = (nt - r * nt_row) * 8;
    tiles[i] = i < NTI ? (nt << TILE_X_SHIFT) | (r * Ec * WP + 4 + w0) : R * Ec * WP + 4;
  }
  __syncthreads();
  {
    // the image rows of the slab, raw, as asynchronous 8-byte copies; the
    // copies run under the work above and below, and the chunk loop's first
    // barrier waits for them
    const int C8 = C / 8, row_pieces = W * C8;  // 8-byte pieces of one image row
    const uint32_t inv_c8 = 0xffffffffu / C8 + 1;  // j / C8 = umulhi(j, inv_c8) for j < 2^32 / C8
    const uint32_t xs_sa = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
    for (int r = ra; r < rb; ++r)
      for (int j = tid; j < row_pieces; j += THREADS) {
        const int w = C8 == 1 ? j : (int)__umulhi((uint32_t)j, inv_c8), pc = j - w * C8;
        cp_async8(xs_sa + (r * WX + w) * P1 + pc * 8,
                  ximg + (size_t)(r0 - 1 + r) * W * C + j * 8);
      }
    cp_commit();
  }
  // the project accumulators: warp (wmi, wni) of a wgm x wgn grid owns m
  // tiles [mb, mb + WM) and n tiles [nb, nb + WN); they start at -zp_d * ws2
  const int wgn = NW / a.wgm;
  const int mb = (warp / wgn) * WM, nb = (warp % wgn) * WN;
  int acc[WM][WN][4];
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    int2 zw = make_int2(0, 0);
    if ((nb + j) * 8 < nvb)
      zw = *reinterpret_cast<const int2*>(a.zw2 + n0 + (nb + j) * 8 + tig * 2);
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      acc[i][j][0] = acc[i][j][2] = -zw.x;
      acc[i][j][1] = acc[i][j][3] = -zw.y;
    }
  }

  // the e and d grids' lower bounds are their zero points (the launcher checks)
  const dfq::QuantRelu qe = dfq::quant_relu_bounds(a.r_e, (float)(a.zp_e + 128), a.hi_e);
  const dfq::QuantRelu qd = dfq::quant_relu_bounds(a.r_d, (float)(a.zp_d + 128), a.hi_d);
  const int MTE = Ec / 16;            // m16 channel tiles of a chunk: 2, 4 or 8
  const int exp_g0 = warp / MTE, exp_step = NW / MTE;  // this warp's expand items
  const int S = (W + 3) / 4;          // strips of 4 output pixels per row
  const int nseg = (bh + a.dr - 1) / a.dr;
  const int e_row_words = Ec * WP / 4;

  for (int k = 0; k < a.nk; ++k) {
    cp_wait_all();
    __syncthreads();  // chunk k's image has landed; everyone is past project k - 1
    if (k + 1 < a.nk) copy_chunk(k + 1);
    if (k == 0 && a.req_c1) {
      // x has landed too: onto the expand conv's input grid, in place
      const int C8 = C / 8;
      for (int i = ra * WX + tid; i < rb * WX; i += THREADS) {
        uint2* const px = reinterpret_cast<uint2*>(xs + (size_t)i * P1);
        for (int pc = 0; pc < C8; ++pc) {
          const uint2 v = px[pc];
          int q[8];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            q[l] = dfq::requant_clamped(dfq::byte_of(v.x, l), a.zp_x, a.ratio_c1, a.zp_c1_128);
            q[4 + l] =
                dfq::requant_clamped(dfq::byte_of(v.y, l), a.zp_x, a.ratio_c1, a.zp_c1_128);
          }
          px[pc] = make_uint2(dfq::pack4(q[0], q[1], q[2], q[3]),
                              dfq::pack4(q[4], q[5], q[6], q[7]));
        }
      }
      __syncthreads();
    }
    const unsigned char* img = wb + (k & 1) * a.wbuf;
    const unsigned char* w1s = img;                                   // [Ec][P1]
    const float* sc1 = reinterpret_cast<const float*>(img + a.img_c);  // [Ec] each:
    const float* b1 = sc1 + Ec;
    const int* zw1 = reinterpret_cast<const int*>(b1 + Ec);   // zp_c1 * ws1
    const float* scd = reinterpret_cast<const float*>(zw1 + Ec);
    const float* bd = scd + Ec;
    const int* ztd = reinterpret_cast<const int*>(bd + Ec);   // zp_e * tapsum
    const uint32_t* taps = reinterpret_cast<const uint32_t*>(ztd + Ec);  // [3][Ec]
    const unsigned char* w2s = img + a.img_w2;                        // [nvb][P2]

    // 1. expand: e^T[channel, pixel] = w1^T . x^T, epilogue, into the e tile.
    // A warp keeps one m16 channel tile (MTE divides NW) and walks groups
    // of EXP_NT pixel tiles of the table; what depends on its channels
    // alone is made once per chunk.
    {
      const int c_lo = (warp & (MTE - 1)) * 16 + gid;
      const float sc[2] = {sc1[c_lo], sc1[c_lo + 8]};
      const float bi[2] = {b1[c_lo], b1[c_lo + 8]};
      const unsigned char* wa = w1s + c_lo * P1 + tig * 8;
      const unsigned char* xa = xs + gid * P1 + tig * 8;
      unsigned char* const eb = es + c_lo * WP + tig * 2;
      const int hi_off = 8 * WP, xtile = 8 * P1;
      // Where |sum| < 2^22 for every input (C <= 128: 255 * 128 * C), the
      // accumulators start at 1.5 * 2^23 as an integer, their bits are the
      // float 1.5 * 2^23 + sum, and one float subtraction is the exact int
      // -> float conversion, off the integer pipe the epilogue is bound by.
      auto items = [&](auto magic) {
        constexpr bool MAGIC = decltype(magic)::value;
        const int z_lo = (MAGIC ? 0x4B400000 : 0) - zw1[c_lo];
        const int z_hi = (MAGIC ? 0x4B400000 : 0) - zw1[c_lo + 8];
        for (int ng = exp_g0; ng < ngroups; ng += exp_step) {
          int tf[EXP_NT];  // the tiles' entries of the table
          int ac[EXP_NT][4];
#pragma unroll
          for (int j = 0; j < EXP_NT; ++j) {
            tf[j] = tiles[ng * EXP_NT + j];
            ac[j][0] = ac[j][1] = z_lo;
            ac[j][2] = ac[j][3] = z_hi;
          }
#pragma unroll 1
          for (int ks = 0; ks < KP; ks += 32) {
            const uint2 lo8 = *reinterpret_cast<const uint2*>(wa + ks);           // channel c_lo
            const uint2 hi8 = *reinterpret_cast<const uint2*>(wa + 8 * P1 + ks);  // c_lo + 8
#pragma unroll
            for (int j = 0; j < EXP_NT; ++j) {
              const uint2 b = *reinterpret_cast<const uint2*>(
                  xa + (tf[j] >> TILE_X_SHIFT) * xtile + ks);
              mma_s8(ac[j], lo8.x, hi8.x, lo8.y, hi8.y, b.x, b.y);
            }
          }
          // lane (gid, tig) holds channels c_lo, c_lo + 8 of pixels w, w + 1
#pragma unroll
          for (int j = 0; j < EXP_NT; ++j) {
            int q[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float fv = MAGIC ? __fsub_rn(__int_as_float(ac[j][v]), dfq::kRoundMagic)
                                     : __int2float_rn(ac[j][v]);
              q[v] = dfq::quant_relu(__fmaf_rn(fv, sc[v >> 1], bi[v >> 1]), qe);
            }
            unsigned char* ep = eb + (tf[j] & TILE_OFFSET);
            *reinterpret_cast<uint16_t*>(ep) = (uint16_t)__byte_perm(q[0], q[1], 0x0040);
            *reinterpret_cast<uint16_t*>(ep + hi_off) =
                (uint16_t)__byte_perm(q[2], q[3], 0x0040);
          }
        }
      };
      if (C <= 128)
        items(std::true_type{});
      else
        items(std::false_type{});
    }
    __syncthreads();

    // 2. depthwise 3x3: (channel, strip of 4 pixels, run of dr rows) per thread
    for (int it = tid; it < Ec * S * nseg; it += THREADS) {
      const int c = it & (Ec - 1), rest = it / Ec;
      const int s = rest % S, seg = rest / S;
      const int rr0 = seg * a.dr;
      const int rr1 = min(min(rr0 + a.dr, bh), H - r0);
      if (rr0 >= rr1) continue;
      const int t0 = (int)taps[c], t1 = (int)taps[Ec + c], t2 = (int)taps[2 * Ec + c];
      const float sd = scd[c], bb = bd[c];
      // the accumulator starts at 1.5 * 2^23 as an integer: |sum| <=
      // 9 * 255 * 128 < 2^22, so its bits are the float 1.5 * 2^23 + sum, and
      // one float subtraction is the exact int -> float conversion
      const int z = 0x4B400000 - ztd[c];
      // e-tile row rr is image row r0 - 1 + rr: the top row of output row rr
      const uint32_t* ep = reinterpret_cast<const uint32_t*>(es + (rr0 * Ec + c) * WP) + s;
      unsigned char* dp = ds + (rr0 * WX + 4 * s) * P2 + c;
      // one output row: the windows of its bottom input row are made, the
      // other two are in hand; three steps rotate the three window sets
      // pixel W, where the expand wrote a value of no meaning, reads as zp_e:
      // it is byte W % 4 of word 1 + W / 4 of the row, which is this strip's
      // second or third word or neither
      uint2 keep = make_uint2(~0u, ~0u), put = make_uint2(0u, 0u);
      if (W < WX) {
        const uint32_t m = 0xffu << (8 * (W & 3));
        if (s == W / 4) keep.x = ~m, put.x = zpe4 & m;
        if (s + 1 == W / 4) keep.y = ~m, put.y = zpe4 & m;
      }
      auto row = [&](const uint32_t (&top)[4], const uint32_t (&mid)[4], uint32_t (&bot)[4]) {
        strip_windows(bot, ep, keep, put);
        ep += e_row_words;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int v = __dp4a((int)top[j], t0, z);
          v = __dp4a((int)mid[j], t1, v);
          v = __dp4a((int)bot[j], t2, v);
          const float fv = __fsub_rn(__int_as_float(v), dfq::kRoundMagic);
          dp[j * P2] = (unsigned char)dfq::quant_relu(__fmaf_rn(fv, sd, bb), qd);
        }
        dp += WX * P2;
      };
      uint32_t wa[4], wb_[4], wc[4];
      strip_windows(wa, ep, keep, put);
      strip_windows(wb_, ep + e_row_words, keep, put);
      ep += 2 * e_row_words;
#pragma unroll 1
      for (int rr = rr0; rr < rr1; rr += 3) {
        row(wa, wb_, wc);
        if (rr + 1 < rr1) row(wb_, wc, wa);
        if (rr + 2 < rr1) row(wc, wa, wb_);
      }
    }
    __syncthreads();

    // 3. project: acc += d tile [pixels, Ec] . w2 rows [columns, Ec]^T
    for (int ks = 0; ks < Ec; ks += 32) {
      const unsigned char* da = ds + ((mb * 16 + gid) * P2 + ks + tig * 8);
      const unsigned char* wj = w2s + ((nb * 8 + gid) * P2 + ks + tig * 8);
      if constexpr (WM > WN) {
        // the fewer fragments stay in registers: here the WN of w2
        uint2 bf[WN];
#pragma unroll
        for (int j = 0; j < WN; ++j)
          if ((nb + j) * 8 < nvb) bf[j] = *reinterpret_cast<const uint2*>(wj + j * 8 * P2);
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          if (mb + i < a.mt) {
            const uint2 lo8 = *reinterpret_cast<const uint2*>(da + i * 16 * P2);
            const uint2 hi8 = *reinterpret_cast<const uint2*>(da + (i * 16 + 8) * P2);
#pragma unroll
            for (int j = 0; j < WN; ++j)
              if ((nb + j) * 8 < nvb)
                mma_s8(acc[i][j], lo8.x, hi8.x, lo8.y, hi8.y, bf[j].x, bf[j].y);
          }
        }
      } else {
        uint2 alo[WM], ahi[WM];
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          if (mb + i < a.mt) {
            alo[i] = *reinterpret_cast<const uint2*>(da + i * 16 * P2);
            ahi[i] = *reinterpret_cast<const uint2*>(da + (i * 16 + 8) * P2);
          }
        }
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          if ((nb + j) * 8 < nvb) {
            const uint2 b = *reinterpret_cast<const uint2*>(wj + j * 8 * P2);
#pragma unroll
            for (int i = 0; i < WM; ++i)
              if (mb + i < a.mt)
                mma_s8(acc[i][j], alo[i].x, ahi[i].x, alo[i].y, ahi[i].y, b.x, b.y);
          }
        }
      }
    }
  }

  // The project epilogue, in two passes through shared memory (all of it
  // is free now), so that x is read and out written in whole words that
  // neighbouring threads take from neighbouring addresses. Pass 1: lane
  // (gid, tig) holds pixels p, p + 8 of columns c, c + 1 of each tile;
  // f = acc * sc2 + b2 goes to fs[pixel of the slab in image order][column
  // of the block], a pitch of 8 mod 32 floats apart (no bank conflicts).
  __syncthreads();
  float* const fs = reinterpret_cast<float*>(smem);
  const int FP = a.fpitch;
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    if (mb + i >= a.mt) continue;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int p = (mb + i) * 16 + gid + 8 * h2;
      const int rr = p / WX, w = p - rr * WX;
      if (rr >= bh || r0 + rr >= H || w >= W) continue;
      float* const fp = fs + (size_t)(rr * W + w) * FP + tig * 2;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if ((nb + j) * 8 >= nvb) continue;
        const int c = (nb + j) * 8;
        const float2 sc = *reinterpret_cast<const float2*>(a.sc2 + n0 + c + tig * 2);
        const float2 bi = *reinterpret_cast<const float2*>(a.b2 + n0 + c + tig * 2);
        *reinterpret_cast<float2*>(fp + c) =
            make_float2(dfq::dequant_fma(acc[i][j][2 * h2], sc.x, bi.x),
                        dfq::dequant_fma(acc[i][j][2 * h2 + 1], sc.y, bi.y));
      }
    }
  }
  __syncthreads();
  // Pass 2: a thread per word of 4 columns of one pixel [+ residual
  // through the add's site grids] -> out.
  const dfq::QuantU8 qp = dfq::quant_u8_bounds(a.zp_p_128, 0.f, 255.f);
  const dfq::QuantU8 qo = dfq::quant_u8_bounds(a.zp_o_128, 0.f, 255.f);
  const int words = nvb / 4;  // of one pixel
  const uint32_t inv_words = 0xffffffffu / words + 1;  // words >= 2
  const int npix = min(bh, H - r0) * W;
  const size_t pix0 = ((size_t)n * H + r0) * W;
  for (int idx = tid; idx < npix * words; idx += THREADS) {
    const int q = (int)__umulhi((uint32_t)idx, inv_words), cw = idx - q * words;
    const float4 f4 = *reinterpret_cast<const float4*>(fs + (size_t)q * FP + cw * 4);
    float f[4] = {f4.x, f4.y, f4.z, f4.w};
    const size_t o = (pix0 + q) * C2 + n0 + cw * 4;
    if (a.res) {
      // the project output is quantized onto the add:in site grid, then
      // both operands are dequantized and added in f32 (each q * s - zp * s
      // is one FMA); C == C2 here
      const uint32_t xv = *reinterpret_cast<const uint32_t*>(a.x + o);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float q2 = __int2float_rn(dfq::quant_u8_clamped(f[l], a.r_p, qp));
        const float bf = __fmaf_rn(q2, a.s_p, a.c_p);
        int xq = (int)dfq::byte_of(xv, l);
        if (a.req_r) xq = dfq::requant_clamped(xq, a.zp_x, a.ratio_r, a.zp_r_128);
        f[l] = __fadd_rn(__fmaf_rn(__int2float_rn(xq), a.s_r, a.c_r), bf);
      }
    }
    if (a.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
          make_float4(f[0], f[1], f[2], f[3]);
    } else {
      int qv[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) qv[l] = dfq::quant_u8_clamped(f[l], a.r_o, qo);
      *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out) + o) =
          __byte_perm(__byte_perm(qv[0], qv[1], 0x0040), __byte_perm(qv[2], qv[3], 0x0040),
                      0x5410);
    }
  }
}

// the (WM, WN) blocks of accumulator tiles a warp can own (FB_WARP_TILES
// in ops/cuda_int8.py)
template <typename F>
cudaError_t for_each_instance(F f) {
  cudaError_t e = f(fused_block_mma_kernel<2, 4>);
  if (e == cudaSuccess) e = f(fused_block_mma_kernel<4, 3>);
  if (e == cudaSuccess) e = f(fused_block_mma_kernel<2, 6>);
  return e;
}

}  // namespace

extern "C" int dfq_fused_block_int8(const FusedBlockArgs* args, void* stream) {
  const FusedBlockArgs& a = *args;
  // once per device (a function attribute is the current device's): let
  // every kernel take up to the device's opt-in maximum of dynamic shared
  // memory; each launch asks for a.smem of it
  static std::once_flag once[dfq::MAX_DEVICES];
  static cudaError_t set_err[dfq::MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= dfq::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    auto set = [&](auto kernel) {
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    };
    if (e == cudaSuccess) e = set(fused_block_kernel);
    if (e == cudaSuccess) e = for_each_instance(set);
    set_err[dev] = e;
  });
  if (set_err[dev] != cudaSuccess) return (int)set_err[dev];
  auto s = static_cast<cudaStream_t>(stream);
  const int n_h = (a.H + a.bh - 1) / a.bh;
  if (!a.mma) {
    fused_block_kernel<<<a.N * n_h, THREADS, a.smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int wgn = a.wgm > 0 && NW % a.wgm == 0 ? NW / a.wgm : 0;
  if (wgn == 0 || a.lo_e != (float)(a.zp_e + 128) || a.lo_d != (float)(a.zp_d + 128) ||
      a.hi_e < a.lo_e || a.hi_d < a.lo_d || a.C % 8 || a.C2 % 8 || (a.ec != 32 && a.ec != 64 && a.ec != 128) ||
      a.nk * a.ec < a.E ||
      a.off_d < a.off_e + (a.bh + 3) * a.ec * a.wp ||
      a.off_t + ((a.bh + 2) * (a.wx / 8) + EXP_NT - 1) / EXP_NT * EXP_NT * 4 > a.off_w ||
      (a.bh + 3) * a.ec * a.wp > TILE_OFFSET || (a.bh + 2) * (a.wx / 8) >= 1 << (31 - TILE_X_SHIFT) ||
      a.wx % 8 || a.wx < a.W || a.wp != a.wx + 12 || a.p1 % 64 != 32 || a.p1 < a.C ||
      a.p2 % 64 != 32 || a.p2 < a.ec || a.mt * 16 < a.bh * a.wx || a.mt > a.wgm * a.wm ||
      a.ntb > wgn * a.wn || a.csplit < 1 || a.csplit * a.ntb * 8 < a.C2 || a.dr < 1 ||
      a.img_c != a.ec * a.p1 || a.img_w2 != a.img_c + 36 * a.ec ||
      a.img_stride != a.img_w2 + a.C2 * a.p2 || a.wbuf < a.img_w2 + a.ntb * 8 * a.p2 ||
      a.off_w + 2 * a.wbuf > a.smem || a.fpitch % 32 != 8 || a.fpitch < a.ntb * 8 ||
      a.bh * a.W * a.fpitch * 4 > a.smem)
    return (int)cudaErrorInvalidValue;
  dim3 grid(a.N * n_h, a.csplit);
#define DFQ_LAUNCH(M_, N_)                                                         \
  if (a.wm == M_ && a.wn == N_) {                                                  \
    fused_block_mma_kernel<M_, N_><<<grid, NW * 32, a.smem, s>>>(a);               \
    return (int)cudaGetLastError();                                                \
  }
  DFQ_LAUNCH(2, 4)
  DFQ_LAUNCH(4, 3)
  DFQ_LAUNCH(2, 6)
#undef DFQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}
