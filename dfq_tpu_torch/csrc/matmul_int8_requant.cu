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
// What bounds it on H100: on the main path the pointwise convs are tall
// and skinny (M up to 1.6 M rows, K and N of 16..1280), so ten of eleven
// sites are bound by the bytes of the M x K read and the M x N write; the
// weight matrix is 0.5 KB..1.3 MB. Only the last 1x1 conv (K = 320,
// N = 1280) comes near the int8 operations bound, and the classifier
// (M = batch) is latency-bound. Elsewhere in the model zoo:
// - N not a multiple of 8 (SSD class heads, N = 126; DeepLab's
//   classifier, N = 21) are bound by the bytes of x and of the output, as
//   the main path's sites are;
// - K past ~1.8k: the K = 2048 pointwise convs of the DeepLab backbones
//   (M = 1-17 k rows, N = 256, 512) come near the operations bound
//   (2 M N K at the int8 peak, within 1.4x of the bytes);
// - the batch-row GEMVs (AlexNet's classifier, M = batch, K = 9216 and
//   4096) are bound by the bytes of the weights: 58.6 MB read once.
//
// The weights are packed with N padded to Np, a multiple of 8, by zero
// rows (zero scale, bias and wsum), as the Pallas wrapper pads N; the
// output is [M, N]. Both tensor-core variants take every shape with K a
// multiple of 8 and 16-byte aligned operands.
//
// The resident variant (one column tile and one whole-K x tile fit
// shared memory) is a streaming GEMM:
//
// - weights resident: a block loads its bn columns of w ([bn, K], all of
//   N where the caller's plan says so) and their scale / bias /
//   zp_in * wsum into shared memory once, then walks over many 128-row
//   tiles of x (tile blockIdx.x + i * gridDim.x), so x is read once per
//   column tile and w once per block;
// - a ring of x tiles filled by cp.async (16-byte pieces; 8-byte where
//   rows are only 8-byte aligned, K = 24), `stages` deep, so the loads of
//   later tiles run under the math and the stores of this one. Rows keep
//   a pitch of 32 bytes mod 64 in shared memory, K zero-padded to the
//   MMA's depth there and nowhere else;
// - each of the 8 warps owns 16 rows of every tile from the copy to the
//   store (its own cp.async groups, __syncwarp, no block barrier after
//   the weights have landed), so the warps drift out of step and the
//   epilogue arithmetic of one, the largest cost at wide N, runs under
//   the loads and stores of the others;
// - mma.sync.m16n8k32 (s8 x s8 -> s32) over the warp's 16 rows and all bn
//   columns, in chunks of 64 columns of accumulators. x and w are both
//   K-major, so a fragment is a plain 8-byte shared load: lane (g, t)
//   reads bytes [8t, 8t+8) of its row and uses the halves as the
//   instruction's k-slots [4t, 4t+4) and [16+4t, 16+4t+4) -- the same
//   permutation of k on both operands, which a dot product does not
//   see -- and the pitch makes those loads free of bank conflicts;
// - the epilogue runs on the accumulator fragment (which starts at
//   -zp_in * wsum), in the form of int8_epilogue.cuh that gives the same
//   bits on fewer and faster operations, writes the warp's rows
//   to shared memory, and the warp stores them in 16-byte pieces (whole
//   rows of the output where bn = N, so they are one run). Loops that run
//   once per 16 rows carry no integer division;
// - where N is not a multiple of 8 (RAGGED) an output row is N * ES bytes
//   and starts at any byte, so the warp stages only the real columns, each
//   byte at its destination's address mod 16, and stores its 16 rows as
//   one run of 16 N ES bytes where the block holds all N columns (the
//   heads and the classifier at their larger batches), else a run a row:
//   16-byte pieces between the run's 16-byte boundaries, single bytes at
//   its ends (store_runs), nothing past row M or column N.
//
// The streamed variant takes K whose 128-row x tile does not fit shared
// memory (one tile of K = 2048 is 266 KB): x and w stream in K slices of
// 128 bytes (256 at a GEMV) through a cp.async ring with zeros past every
// end, and each warp keeps its 16 x 64 int32 accumulators in registers
// across the slices. Blocks are (row tile, column tile, K part), column
// tiles of one row tile in neighbouring blocks so that x is read from
// memory once and again from L2. A block's 8 warps are as many 16-row
// strips as cover M (one at M <= 16, where seven would idle) and split
// each slice between the warps of a strip, which add their partial sums
// in shared memory. Where the tiles leave SMs idle (the GEMVs: 64 column
// tiles of AlexNet's 4096) K is split over blocks too, so every SM
// streams its share of the weights; the parts add their sums into a
// zeroed int32 workspace by atomicAdd, and the last part of a tile (a
// counter per tile) runs the epilogue. Integer addition is associative,
// so the sum is exact and the same in any order: |acc| <= K * 2^14 <
// 2^31 for K up to 2^17.
//
// The dp4a variant takes K that is not a multiple of 8 and operands off
// their 16-byte boundary (no model of the repository has either): a
// 64 x 64 tile per 256-thread block, 32 bytes of K per step staged as
// 32-bit words, __dp4a with a 4 x 4 register tile, ragged M, N and K
// masked in the kernel. The caller picks by shape and alignment only
// (ops/cuda_int8.py:matmul_plan). All accumulate in int32: K reaches 9216
// and 9216 * 2^14 > 2^24, so an f32 sum would not be exact.

#include <mutex>

#include "int8_epilogue.cuh"

// The arguments every variant reads, and the resident variant's kernel
// parameter: 128 bytes, as a larger parameter is read through its address
// inside the loops (ptxas then reloads fields the loops need).
struct MatmulArgs {
  const int8_t* x;
  const int8_t* w;     // [Np, K]: N padded to Np, a multiple of 8, with zero rows
  const float* scale;  // [Np], zeros in the pad (bias, wsum alike)
  const float* bias;
  const int* wsum;
  void* out;           // [M, N]
  int M, N, K;
  int zp_in;
  float inv, zp_out, lo, hi;
  int out_f32;
  int variant;  // 0 = dp4a, 1 = mma (weights resident), 2 = stream
  int bn;       // columns per block
  int stages;   // ring stages: x tiles (mma), K slices of x and w (stream)
  int pitch;    // bytes per staged row of x and w
  int opitch;   // bytes per row of the staged output tile
  int off_x, off_o, off_c;  // shared-memory offsets: ring, output tile, constants
  int smem;     // dynamic shared memory, bytes
  int grid_x, grid_y;
};

// The streamed variant's own arguments (its second kernel parameter).
struct StreamArgs {
  int Np;  // the packed weight's rows
  int grid_z;
  // bytes of K per slice, row warps and K warps of a block, bytes of K per
  // block (grid_z blocks share a tile), bytes per ring stage and the offset
  // of the w rows in a stage
  int ks, wr, wk, kchunk, stage, off_w;
  int* ws;  // K split over blocks: M x Np int32 sums, then a counter per
            // output tile, all zero at launch
};

// Layout of _MatmulArgs in ops/cuda_int8.py: the entry point's argument.
struct MatmulLaunch {
  MatmulArgs a;
  StreamArgs l;
};

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// the tensor-core variant

constexpr int TM = 128;     // rows of x per tile: 8 warps x 16
constexpr int NCHUNK = 4;   // n8 column tiles per accumulator chunk
// resident blocks per SM the registers must allow (MM_BLOCKS_PER_SM in
// ops/cuda_int8.py): what the kernel executes per output value, not
// memory, sets its time at the wide sites, and more warps keep the
// schedulers busy
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool wide) {
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A walk over the pieces of a tile of `per_row` pieces a row, piece
// first, first + step, ...: (r, c) of each without a division in the loop
// (an integer division is some twenty dependent operations, and the
// loops that use this run once per 16 rows).
struct PieceWalk {
  int r0, c0, dr, dc, per_row;
  __device__ __forceinline__ PieceWalk(int first, int step, int per_row_)
      : r0(first / per_row_), c0(first % per_row_), dr(step / per_row_),
        dc(step % per_row_), per_row(per_row_) {}
  __device__ __forceinline__ void next(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
};

// Start the copy of `rows` rows of K bytes of a row-major matrix into
// shared rows of `pitch` bytes, in pieces of g = 16 or 8 bytes, by the
// threads of walk `pw`.
__device__ __forceinline__ void copy_rows(uint32_t dst, const int8_t* __restrict__ src,
                                          int rows, int K, int pitch, int g,
                                          const PieceWalk& pw) {
  for (int r = pw.r0, c = pw.c0; r < rows; pw.next(r, c))
    cp_async(dst + r * pitch + c * g, src + (size_t)r * K + c * g, g == 16);
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

// cp.async of one 16- or 8-byte piece that writes zeros where `ok` is
// false (src-size 0: nothing is read, `src` need only be a valid address)
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool wide,
                                               bool ok) {
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 8 : 0)
                 : "memory");
}

// Rows of any byte width (N not a multiple of 8: int8 rows of 21 bytes
// start at odd addresses). A warp stages its output rows so that every
// byte sits at the same address mod 16 as its destination, then stores
// `nrun` runs of `len` bytes, run i to g + i * gstride from s + i * sstride
// (+ the run's shift): 16-byte pieces from the run's first 16-byte
// boundary, single bytes for the head before it and the tail after the
// last whole piece. Where the block holds all N columns the warp's rows
// are one run of rows * N * ES bytes, stored as such; else a run a row.
// Nothing past the run is written. s and sstride are multiples of 16.
__device__ __forceinline__ int run_shift(const uint8_t* g) {
  return (int)(reinterpret_cast<uintptr_t>(g) & 15);
}

__device__ __forceinline__ void store_runs(uint8_t* g, size_t gstride, const uint8_t* s,
                                           int sstride, int nrun, int len, int lane) {
  for (int i = 0; i < nrun; ++i) {
    uint8_t* const gi = g + i * gstride;
    const int sh = run_shift(gi);
    const uint8_t* const si = s + i * sstride + sh;
    const int head = min(len, (16 - sh) & 15);
    const int body = (len - head) >> 4;
    const int tail = (len - head) & 15;
    if (lane < head) gi[lane] = si[lane];
    for (int p = lane; p < body; p += 32)
      *reinterpret_cast<uint4*>(gi + head + 16 * p) =
          *reinterpret_cast<const uint4*>(si + head + 16 * p);
    if (lane < tail) gi[head + 16 * body + lane] = si[head + 16 * body + lane];
  }
}

// Where row r of a warp's output rows is staged (from the warp's staging
// base): one run (`whole`) keeps rows back to back at the run's shift,
// else each row at its own pitch and shift. g is the warp's first output
// byte in global memory.
__device__ __forceinline__ int staged_row(const uint8_t* g, int r, bool whole,
                                          size_t row_bytes, int opitch) {
  return whole ? run_shift(g) + r * (int)row_bytes
               : r * opitch + run_shift(g + r * row_bytes);
}

// Stage two neighbouring output values at o (columns c, c + 1 of a row,
// each written only where it is a real column): f32 as they are, int8
// requantized. Single stores: o may be at any byte.
template <bool OUT_F32>
__device__ __forceinline__ void stage_pair(uint8_t* o, float f0, float f1, bool ok0, bool ok1,
                                           float lo, float hi, float inv,
                                           const dfq::QuantBounds& qb) {
  if constexpr (OUT_F32) {
    if (ok0) *reinterpret_cast<float*>(o) = dfq::clampf(f0, lo, hi);
    if (ok1) *reinterpret_cast<float*>(o + 4) = dfq::clampf(f1, lo, hi);
  } else {
    if (ok0) o[0] = (uint8_t)dfq::quant_recip_clamped(f0, inv, qb);
    if (ok1) o[1] = (uint8_t)dfq::quant_recip_clamped(f1, inv, qb);
  }
}

template <bool OUT_F32, bool RAGGED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mm_mma_kernel(const MatmulArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  // [bn rows of w | stages x TM rows of x], all of `pitch` bytes
  uint8_t* const w_s = smem;
  uint8_t* const x_s = smem + a.off_x;
  uint8_t* const o_s = smem + a.off_o;
  float* const sc_s = reinterpret_cast<float*>(smem + a.off_c);
  float* const bi_s = sc_s + a.bn;
  int* const zw_s = reinterpret_cast<int*>(bi_s + a.bn);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // this warp's rows of every tile
  const int n0 = blockIdx.y * a.bn;
  // this block's columns, a multiple of 8 (the packed weight's: N is padded
  // to Np only where it is RAGGED)
  const int nv = min(a.bn, (RAGGED ? (a.N + 7) & ~7 : a.N) - n0);
  const int m_tiles = (a.M + TM - 1) / TM;
  const int g = (a.K % 16 == 0) ? 16 : 8;
  const int kp = (a.K + 31) / 32 * 32;
  const uint32_t w_sa = static_cast<uint32_t>(__cvta_generic_to_shared(w_s));
  const uint32_t x_sa = static_cast<uint32_t>(__cvta_generic_to_shared(x_s)) + wrow * a.pitch;
  const int stage_bytes = TM * a.pitch;

  // A warp owns its 16 rows of every tile from the copy to the store, so
  // the warps of a block run out of step and one's epilogue overlaps the
  // others' loads and stores. It starts the copy of its rows of tile t
  // into ring stage s (nothing past the end of x).
  const PieceWalk in_walk(lane, 32, a.K / g);
  auto fetch = [&](int t, int s) {
    if (t < m_tiles) {
      const int m = t * TM + wrow;
      copy_rows(x_sa + s * stage_bytes, a.x + (size_t)m * a.K, min(16, a.M - m), a.K,
                a.pitch, g, in_walk);
    }
    cp_commit();  // a group even when empty: every thread counts alike
  };

  // the first copy group: this block's weights, by all its threads
  copy_rows(w_sa, a.w + (size_t)n0 * a.K, nv, a.K, a.pitch, g,
            PieceWalk(tid, THREADS, a.K / g));
  cp_commit();
  for (int s = 0; s < a.stages - 1; ++s) fetch(blockIdx.x + s * gridDim.x, s);
  for (int i = tid; i < nv; i += THREADS) {
    sc_s[i] = a.scale[n0 + i];
    bi_s[i] = a.bias[n0 + i];
    zw_s[i] = a.zp_in * a.wsum[n0 + i];
  }
  // bytes [K, kp) of every staged row are zeros for good: no copy writes them
  if (kp > a.K) {
    const int pad8 = (kp - a.K) / 8;
    const int total = (a.bn + a.stages * TM) * pad8;
    for (int i = tid; i < total; i += THREADS) {
      int r = i / pad8;
      int c = (i - r * pad8) * 8;
      *reinterpret_cast<uint2*>(smem + (size_t)r * a.pitch + a.K + c) = make_uint2(0u, 0u);
    }
  }
  cp_wait(a.stages - 1);
  __syncthreads();  // w, the constants and the zero pad are in place for all

  constexpr int ES = OUT_F32 ? 4 : 1;
  const dfq::QuantBounds qb = dfq::quant_bounds(a.lo, a.hi, a.inv, a.zp_out);
  const int gs = (OUT_F32 || (a.N % 16 == 0 && a.bn % 16 == 0)) ? 16 : 8;
  const PieceWalk out_walk(lane, 32, nv * ES / gs);
  const size_t row_bytes = (size_t)a.N * ES;
  uint8_t* const ow = o_s + wrow * a.opitch;  // this warp's rows of the output tile

  // tile t is in ring stage s; the stage freed by the previous tile takes
  // the tile stages - 1 ahead
  int s = 0, s_ahead = a.stages - 1;
  for (int t = blockIdx.x; t < m_tiles; t += gridDim.x) {
    fetch(t + (a.stages - 1) * gridDim.x, s_ahead);
    cp_wait(a.stages - 1);
    __syncwarp();  // this warp's rows of tile t have landed, for all its lanes
    const uint8_t* xa = x_s + s * stage_bytes + (wrow + gid) * a.pitch + tig * 8;
    s_ahead = s;  // the next tile's stage, and the stage that one frees
    s = (s + 1 == a.stages) ? 0 : s + 1;
    const int m0 = t * TM + wrow;
    const int rows = min(16, a.M - m0);
    if (rows <= 0) continue;

    for (int nc0 = 0; nc0 < nv; nc0 += NCHUNK * 8) {
      // the accumulators start at -zp_in * wsum of their columns
      int acc[NCHUNK][4];
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        if (nc0 + j * 8 < nv) {
          const int2 zw = *reinterpret_cast<const int2*>(zw_s + nc0 + j * 8 + tig * 2);
          acc[j][0] = acc[j][2] = -zw.x;
          acc[j][1] = acc[j][3] = -zw.y;
        }
      }
      const uint8_t* wb = w_s + (nc0 + gid) * a.pitch + tig * 8;
      for (int ks = 0; ks < kp; ks += 32) {
        const uint2 lo8 = *reinterpret_cast<const uint2*>(xa + ks);                // row gid
        const uint2 hi8 = *reinterpret_cast<const uint2*>(xa + 8 * a.pitch + ks);  // gid + 8
#pragma unroll
        for (int j = 0; j < NCHUNK; ++j) {
          if (nc0 + j * 8 < nv) {
            const uint2 b = *reinterpret_cast<const uint2*>(wb + j * 8 * a.pitch + ks);
            mma_s8(acc[j], lo8.x, hi8.x, lo8.y, hi8.y, b.x, b.y);
          }
        }
      }
      // the epilogue on the fragment: lane (gid, tig) holds rows gid and
      // gid + 8 of columns 2 tig and 2 tig + 1 of each n8 tile
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        if (nc0 + j * 8 < nv) {
          const int col = nc0 + j * 8 + tig * 2;
          const float2 sc = *reinterpret_cast<const float2*>(sc_s + col);
          const float2 bi = *reinterpret_cast<const float2*>(bi_s + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float f0 = dfq::dequant_fma(acc[j][2 * h], sc.x, bi.x);
            const float f1 = dfq::dequant_fma(acc[j][2 * h + 1], sc.y, bi.y);
            if constexpr (RAGGED) {
              // the block's real columns, whether they are whole rows (one
              // run a warp) and where the row is staged, made here: kept
              // across the MMA loop they cost registers the loop needs
              const int nvr = min(a.bn, a.N - n0);
              const uint8_t* og = static_cast<uint8_t*>(a.out) + ((size_t)m0 * a.N + n0) * ES;
              const int ro = staged_row(og, gid + 8 * h, n0 == 0 && nvr == a.N, row_bytes,
                                        a.opitch);
              stage_pair<OUT_F32>(ow + ro + col * ES, f0, f1, col < nvr, col + 1 < nvr, a.lo,
                                  a.hi, a.inv, qb);
            } else {
              uint8_t* o = ow + (gid + 8 * h) * a.opitch + col * ES;
              if constexpr (OUT_F32) {
                *reinterpret_cast<float2*>(o) =
                    make_float2(dfq::clampf(f0, a.lo, a.hi), dfq::clampf(f1, a.lo, a.hi));
              } else {
                const int q0 = dfq::quant_recip_clamped(f0, a.inv, qb);
                const int q1 = dfq::quant_recip_clamped(f1, a.inv, qb);
                // the low bytes of q0 and q1, side by side
                *reinterpret_cast<uint16_t*>(o) = (uint16_t)__byte_perm(q0, q1, 0x0040);
              }
            }
          }
        }
      }
    }
    __syncwarp();  // the warp's output rows are whole; its x rows are free

    uint8_t* og = static_cast<uint8_t*>(a.out) + ((size_t)m0 * a.N + n0) * ES;
    if constexpr (RAGGED) {
      const int nvr = min(a.bn, a.N - n0);
      const bool whole = n0 == 0 && nvr == a.N;
      store_runs(og, row_bytes, ow, a.opitch, whole ? 1 : rows,
                 whole ? rows * (int)row_bytes : nvr * ES, lane);
    } else {
      for (int r = out_walk.r0, c = out_walk.c0; r < rows; out_walk.next(r, c)) {
        if (gs == 16)
          *reinterpret_cast<uint4*>(og + r * row_bytes + c * 16) =
              *reinterpret_cast<const uint4*>(ow + r * a.opitch + c * 16);
        else
          *reinterpret_cast<uint2*>(og + r * row_bytes + c * 8) =
              *reinterpret_cast<const uint2*>(ow + r * a.opitch + c * 8);
      }
    }
  }
  cp_wait(0);
}

// ---------------------------------------------------------------------------
// the streamed variant

constexpr int SNT = 8;  // n8 tiles of accumulators a warp: bn <= 64 (MM_STREAM_BN)
// resident blocks per SM the registers must allow (MM_STREAM_BLOCKS_PER_SM)
constexpr int STREAM_BLOCKS = 2;

// One block per (row tile, column tile, K part): the 8 warps are wr
// strips of 16 rows times wk warps that split every K slice of a strip.
// x and w stream through a ring of K slices by cp.async, zeros past the
// ends (rows past M, weight rows past Np, K past the block's part), and
// the accumulators stay in registers across the slices. The K warps of a
// strip reduce their int32 partial sums in shared memory; the K parts of
// a tile add theirs into the zeroed workspace by atomicAdd, and the last
// part to arrive (a counter per tile) runs the epilogue. Integer addition
// is associative: the result is exact and the same in any order.
template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS, STREAM_BLOCKS)
    mm_stream_kernel(const MatmulArgs a, const StreamArgs l) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_part;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r = warp & (l.wr - 1);              // this warp's strip of 16 rows
  const int kg = warp >> (__ffs(l.wr) - 1);     // and its share of each slice
  const int tm = 16 * l.wr;
  const int n_tiles = (l.Np + a.bn - 1) / a.bn;
  const int mt = blockIdx.x / n_tiles;          // column tiles fastest: the
  const int m0 = mt * tm;                       // blocks of a row tile run
  const int n0 = (blockIdx.x - mt * n_tiles) * a.bn;  // together, x stays in L2
  const int nv = min(a.bn, l.Np - n0);          // columns computed, a multiple of 8
  const int k_beg = blockIdx.z * l.kchunk;
  const int k_end = min(a.K, k_beg + l.kchunk);
  const int n_slices = (k_end - k_beg + l.ks - 1) / l.ks;
  const int g = (a.K % 16 == 0) ? 16 : 8;
  const int per_row = l.ks / g;                 // a power of two
  const int row_shift = __ffs(per_row) - 1;
  const int pieces = (tm + a.bn) * per_row;
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // start the copy of slice i into stage st: tm rows of x, then bn rows of
  // w, one array of rows of `pitch` bytes
  auto load = [&](int i, int st) {
    if (i < n_slices) {
      const int k0 = k_beg + i * l.ks;
      const uint32_t dst0 = s_base + st * l.stage;
      for (int p = tid; p < pieces; p += THREADS) {
        const int row = p >> row_shift;
        const int k = k0 + (p & (per_row - 1)) * g;
        const bool is_x = row < tm;
        const int m = is_x ? m0 + row : n0 + row - tm;
        const bool ok = m < (is_x ? a.M : l.Np) && k < k_end;
        const int8_t* src = (is_x ? a.x : a.w) + (ok ? (size_t)m * a.K + k : 0);
        cp_async_zfill(dst0 + row * a.pitch + (k - k0), src, g == 16, ok);
      }
    }
    cp_commit();  // a group even when empty: every thread counts alike
  };

  int acc[SNT][4];
#pragma unroll
  for (int j = 0; j < SNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int i = 0; i < a.stages - 1; ++i) load(i, i);
  const int steps = l.ks / 32;
  int st = 0, st_ahead = a.stages - 1;
  for (int i = 0; i < n_slices; ++i) {
    cp_wait(a.stages - 2);
    __syncthreads();  // slice i has landed for all; slice i - 1's stage is free
    load(i + a.stages - 1, st_ahead);
    const uint8_t* const xa = smem + st * l.stage + (r * 16 + gid) * a.pitch + tig * 8;
    const uint8_t* const wb = smem + st * l.stage + l.off_w + gid * a.pitch + tig * 8;
    st_ahead = st;
    st = (st + 1 == a.stages) ? 0 : st + 1;
    for (int kk = kg; kk < steps; kk += l.wk) {
      // all of a step's fragments are loaded before its first MMA: a load
      // guarded next to the MMA that takes it would wait out each load's
      // latency in turn
      const int k = kk * 32;
      const uint2 lo8 = *reinterpret_cast<const uint2*>(xa + k);                // row gid
      const uint2 hi8 = *reinterpret_cast<const uint2*>(xa + 8 * a.pitch + k);  // gid + 8
      uint2 b[SNT];
#pragma unroll
      for (int j = 0; j < SNT; ++j)
        b[j] = j * 8 < nv ? *reinterpret_cast<const uint2*>(wb + j * 8 * a.pitch + k)
                          : make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < SNT; ++j)
        if (j * 8 < nv) mma_s8(acc[j], lo8.x, hi8.x, lo8.y, hi8.y, b[j].x, b[j].y);
    }
  }
  cp_wait(0);
  __syncthreads();  // the ring is free: the partial sums take its place

  // the K warps of a strip: all but the first leave their fragments, the
  // first adds them (lane-major int4s, free of bank conflicts)
  if (l.wk > 1) {
    int4* const red = reinterpret_cast<int4*>(smem);
    if (kg > 0) {
#pragma unroll
      for (int j = 0; j < SNT; ++j)
        if (j * 8 < nv)
          red[(((kg - 1) * l.wr + r) * SNT + j) * 32 + lane] =
              make_int4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();
    if (kg == 0) {
      for (int q = 1; q < l.wk; ++q) {
#pragma unroll
        for (int j = 0; j < SNT; ++j) {
          if (j * 8 < nv) {
            const int4 v = red[(((q - 1) * l.wr + r) * SNT + j) * 32 + lane];
            acc[j][0] += v.x;
            acc[j][1] += v.y;
            acc[j][2] += v.z;
            acc[j][3] += v.w;
          }
        }
      }
    }
  }

  const int m0w = m0 + r * 16;  // this strip's first row
  // the K parts of the tile: sums in the workspace, the last part goes on
  if (gridDim.z > 1) {
    int* const sums = l.ws;
    if (kg == 0) {
#pragma unroll
      for (int j = 0; j < SNT; ++j) {
        if (j * 8 < nv) {
          const int col = n0 + j * 8 + tig * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0w + gid + 8 * h;
            if (m < a.M) {
              atomicAdd(sums + (size_t)m * l.Np + col, acc[j][2 * h]);
              atomicAdd(sums + (size_t)m * l.Np + col + 1, acc[j][2 * h + 1]);
            }
          }
        }
      }
    }
    __threadfence();  // this part's sums are visible before its count
    __syncthreads();
    if (tid == 0)
      last_part = atomicAdd(sums + (size_t)a.M * l.Np + blockIdx.x, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!last_part) return;
    __threadfence();
    if (kg == 0) {
#pragma unroll
      for (int j = 0; j < SNT; ++j) {
        if (j * 8 < nv) {
          const int col = n0 + j * 8 + tig * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0w + gid + 8 * h;
            if (m < a.M) {  // from L2, where the atomics are
              acc[j][2 * h] = __ldcg(sums + (size_t)m * l.Np + col);
              acc[j][2 * h + 1] = __ldcg(sums + (size_t)m * l.Np + col + 1);
            }
          }
        }
      }
    }
  }
  if (kg != 0) return;
  const int rows = min(16, a.M - m0w);
  if (rows <= 0) return;

  // the epilogue on the fragment, staged at any byte width, then stored
  constexpr int ES = OUT_F32 ? 4 : 1;
  const dfq::QuantBounds qb = dfq::quant_bounds(a.lo, a.hi, a.inv, a.zp_out);
  const int nvr = min(a.bn, a.N - n0);
  const bool whole = n0 == 0 && nvr == a.N;
  const size_t row_bytes = (size_t)a.N * ES;
  uint8_t* const og = static_cast<uint8_t*>(a.out) + ((size_t)m0w * a.N + n0) * ES;
  uint8_t* const ow = smem + a.off_o + r * 16 * a.opitch;
  const int ro0 = staged_row(og, gid, whole, row_bytes, a.opitch);
  const int ro1 = staged_row(og, gid + 8, whole, row_bytes, a.opitch);
#pragma unroll
  for (int j = 0; j < SNT; ++j) {
    if (j * 8 < nv) {
      const int col = j * 8 + tig * 2;
      const int c = n0 + col;
      const float sc0 = a.scale[c], sc1 = a.scale[c + 1];
      const float bi0 = a.bias[c], bi1 = a.bias[c + 1];
      const int zw0 = a.zp_in * a.wsum[c], zw1 = a.zp_in * a.wsum[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float f0 = dfq::dequant_fma(acc[j][2 * h] - zw0, sc0, bi0);
        const float f1 = dfq::dequant_fma(acc[j][2 * h + 1] - zw1, sc1, bi1);
        stage_pair<OUT_F32>(ow + (h ? ro1 : ro0) + col * ES, f0, f1, col < nvr,
                            col + 1 < nvr, a.lo, a.hi, a.inv, qb);
      }
    }
  }
  __syncwarp();
  store_runs(og, row_bytes, ow, a.opitch, whole ? 1 : rows,
             whole ? rows * (int)row_bytes : nvr * ES, lane);
}

// ---------------------------------------------------------------------------
// the dp4a variant

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;            // bytes of K per stage
constexpr int BKW = BK / 4;       // 32-bit words of K per stage
constexpr int LDW = BKW + 1;      // padded row pitch (words) of the smem tiles

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
mm_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const int* __restrict__ wsum, void* __restrict__ out, int M, int N, int K,
               int zp_in, float inv, float zp_out, float lo, float hi) {
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
void launch_dp4a(const MatmulArgs& a, cudaStream_t stream) {
  dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  if (a.out_f32)
    mm_dp4a_kernel<VEC, true><<<grid, THREADS, 0, stream>>>(
        a.x, a.w, a.scale, a.bias, a.wsum, a.out, a.M, a.N, a.K, a.zp_in, a.inv, a.zp_out,
        a.lo, a.hi);
  else
    mm_dp4a_kernel<VEC, false><<<grid, THREADS, 0, stream>>>(
        a.x, a.w, a.scale, a.bias, a.wsum, a.out, a.M, a.N, a.K, a.zp_in, a.inv, a.zp_out,
        a.lo, a.hi);
}

}  // namespace

namespace {

// once per device (a function attribute is the current device's): let
// the tensor-core instances take up to the device's opt-in maximum of
// dynamic shared memory; each launch asks for a.smem of it
cudaError_t allow_smem() {
  static std::once_flag once[dfq::MAX_DEVICES];
  static cudaError_t set_err[dfq::MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= dfq::MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const void* kernels[] = {
        (const void*)mm_mma_kernel<false, false>, (const void*)mm_mma_kernel<true, false>,
        (const void*)mm_mma_kernel<false, true>, (const void*)mm_mma_kernel<true, true>,
        (const void*)mm_stream_kernel<false>, (const void*)mm_stream_kernel<true>};
    for (const void* k : kernels) {
      // the opt-in maximum counts a kernel's static shared memory too
      cudaFuncAttributes attr;
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
    }
    set_err[dev] = e;
  });
  return set_err[dev];
}

}  // namespace

extern "C" int dfq_matmul_int8_requant(const MatmulLaunch* launch, void* stream) {
  const MatmulArgs& a = launch->a;
  const StreamArgs& l = launch->l;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.variant == 0) {
    if ((a.K % 4 == 0) && ((uintptr_t)a.x % 4 == 0) && ((uintptr_t)a.w % 4 == 0))
      launch_dp4a<true>(a, s);
    else
      launch_dp4a<false>(a, s);
    return (int)cudaGetLastError();
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (a.K % 8 || l.Np != (a.N + 7) / 8 * 8 || a.N < 1 || a.bn % 8 || a.bn < 8 || a.M < 1 ||
      a.grid_x < 1)
    return (int)cudaErrorInvalidValue;
  const bool ragged = a.N != l.Np;
  if (a.variant == 1) {
    if (a.stages < 1 || a.stages > 8 || a.pitch % 64 != 32 || a.pitch < a.K ||
        a.off_x != a.bn * a.pitch || a.grid_y != (l.Np + a.bn - 1) / a.bn || l.grid_z != 1 ||
        (ragged && a.opitch % 16))
      return (int)cudaErrorInvalidValue;
    dim3 grid(a.grid_x, a.grid_y);
    if (a.out_f32 && ragged)
      mm_mma_kernel<true, true><<<grid, THREADS, a.smem, s>>>(a);
    else if (a.out_f32)
      mm_mma_kernel<true, false><<<grid, THREADS, a.smem, s>>>(a);
    else if (ragged)
      mm_mma_kernel<false, true><<<grid, THREADS, a.smem, s>>>(a);
    else
      mm_mma_kernel<false, false><<<grid, THREADS, a.smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.variant != 2) return (int)cudaErrorInvalidValue;
  // the streamed variant: row and K warps fill the block, slices of whole
  // 32-byte steps that are whole copy pieces, the K parts cover K
  const int per_row = l.ks / ((a.K % 16 == 0) ? 16 : 8);
  if (a.bn > SNT * 8 || (l.wr != 1 && l.wr != 2 && l.wr != 4 && l.wr != 8) ||
      l.wr * l.wk != THREADS / 32 || l.ks % 32 || l.ks / 32 < l.wk ||
      (per_row & (per_row - 1)) || a.pitch % 64 != 32 || a.pitch < l.ks ||
      l.off_w != 16 * l.wr * a.pitch || l.stage < l.off_w + a.bn * a.pitch || a.stages < 2 ||
      a.stages > 8 || l.kchunk % l.ks || l.grid_z < 1 || l.grid_z > 65535 ||
      (long long)(l.grid_z - 1) * l.kchunk >= a.K || (long long)l.grid_z * l.kchunk < a.K ||
      a.grid_x != ((a.M + 16 * l.wr - 1) / (16 * l.wr)) * ((l.Np + a.bn - 1) / a.bn) ||
      a.opitch % 16 || a.opitch < a.bn * (a.out_f32 ? 4 : 1) + 16 || a.off_o % 16 ||
      a.off_o < a.stages * l.stage || a.off_o < (l.wk - 1) * l.wr * SNT * 512 ||
      a.smem < a.off_o + 16 * l.wr * a.opitch || (l.grid_z > 1 && !l.ws))
    return (int)cudaErrorInvalidValue;
  dim3 grid(a.grid_x, 1, l.grid_z);
  if (a.out_f32)
    mm_stream_kernel<true><<<grid, THREADS, a.smem, s>>>(a, l);
  else
    mm_stream_kernel<false><<<grid, THREADS, a.smem, s>>>(a, l);
  return (int)cudaGetLastError();
}
