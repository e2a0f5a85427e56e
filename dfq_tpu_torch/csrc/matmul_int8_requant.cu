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
// (M = batch) is latency-bound.
//
// The tensor-core variant (K and N multiples of 8, 16-byte aligned
// operands, one tile fits shared memory) is a streaming GEMM:
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
//   once per 16 rows carry no integer division.
//
// The dp4a variant takes every other shape: a 64 x 64 tile per 256-thread
// block, 32 bytes of K per step staged as 32-bit words, __dp4a with a
// 4 x 4 register tile, ragged M, N and K masked in the kernel. The caller
// picks by shape and alignment only (ops/cuda_int8.py:matmul_plan).
// Both accumulate in int32: K reaches 1280 and 1280 * 2^14 > 2^24, so an
// f32 sum would not be exact.

#include <mutex>

#include "int8_epilogue.cuh"

// Layout of MatmulArgs in ops/cuda_int8.py.
struct MatmulArgs {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  const int* wsum;
  void* out;
  int M, N, K;
  int zp_in;
  float inv, zp_out, lo, hi;
  int out_f32;
  // the tensor-core variant's plan (0 = the dp4a variant)
  int mma;
  int bn;       // columns per block
  int stages;   // x tiles in the ring
  int pitch;    // bytes per staged row of x and w
  int opitch;   // bytes per row of the staged output tile
  int off_x, off_o, off_c;  // shared-memory offsets: ring, output tile, constants
  int smem;     // dynamic shared memory, bytes
  int grid_x, grid_y;
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

template <bool OUT_F32>
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
  const int nv = min(a.bn, a.N - n0);  // this block's columns, a multiple of 8
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
    __syncwarp();  // the warp's output rows are whole; its x rows are free

    uint8_t* og = static_cast<uint8_t*>(a.out) + ((size_t)m0 * a.N + n0) * ES;
    for (int r = out_walk.r0, c = out_walk.c0; r < rows; out_walk.next(r, c)) {
      if (gs == 16)
        *reinterpret_cast<uint4*>(og + r * row_bytes + c * 16) =
            *reinterpret_cast<const uint4*>(ow + r * a.opitch + c * 16);
      else
        *reinterpret_cast<uint2*>(og + r * row_bytes + c * 8) =
            *reinterpret_cast<const uint2*>(ow + r * a.opitch + c * 8);
    }
  }
  cp_wait(0);
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

extern "C" int dfq_matmul_int8_requant(const MatmulArgs* args, void* stream) {
  const MatmulArgs& a = *args;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.mma) {
    // once per device (a function attribute is the current device's): let
    // both instances take up to the device's opt-in maximum of dynamic
    // shared memory; each launch asks for a.smem of it
    static std::once_flag once[dfq::MAX_DEVICES];
    static cudaError_t set_err[dfq::MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= dfq::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    std::call_once(once[dev], [dev] {
      int optin = 0;
      cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(mm_mma_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(mm_mma_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      set_err[dev] = e;
    });
    if (set_err[dev] != cudaSuccess) return (int)set_err[dev];
    if (a.K % 8 || a.N % 8 || a.bn % 8 || a.bn < 8 || a.stages < 1 || a.stages > 8 ||
        a.pitch % 64 != 32 || a.pitch < a.K || a.off_x != a.bn * a.pitch || a.grid_x < 1 ||
        a.grid_y != (a.N + a.bn - 1) / a.bn)
      return (int)cudaErrorInvalidValue;
    dim3 grid(a.grid_x, a.grid_y);
    if (a.out_f32)
      mm_mma_kernel<true><<<grid, THREADS, a.smem, s>>>(a);
    else
      mm_mma_kernel<false><<<grid, THREADS, a.smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if ((a.K % 4 == 0) && ((uintptr_t)a.x % 4 == 0) && ((uintptr_t)a.w % 4 == 0))
    launch_dp4a<true>(a, s);
  else
    launch_dp4a<false>(a, s);
  return (int)cudaGetLastError();
}
