// Rates of the operations the int8 kernels' inner loops are made of,
// measured on the card in hand: every thread of a full grid runs 8
// independent chains of one operation, and the rate is thread-operations
// per clock and SM at the clock given on the command line. Built and run
// by pipe_rates.py; it tells what a kernel's epilogue can afford (on H100
// rintf and float-to-int run at a quarter of the rate of dp4a, integer
// and min/max operations, float multiply-adds at twice), and the warp-wide
// mma.sync.m16n8k32 s8 rate that the tensor-core variants' inner loops
// can reach.

#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

template <int OP>
__global__ void chains(int* out, int a0, int b0, float f0, int iters) {
  int a[8];
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = a0 + threadIdx.x + i;
    f[i] = f0 + threadIdx.x + i;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (OP == 0) a[i] = __dp4a(a[i], b0, a[i]);
      if (OP == 1) a[i] = a[i] * b0 + a[i];
      if (OP == 2) f[i] = __fmaf_rn(f[i], f0, f[i]);
      if (OP == 3) f[i] = __int2float_rn(__float_as_int(f[i]));
      if (OP == 4) a[i] = __float2int_rn(__int_as_float(a[i]));
      if (OP == 5) a[i] = __byte_perm(a[i], b0, a[i] & 0x7777);
      if (OP == 6) a[i] = max(a[i], b0) + 1;
      if (OP == 7) f[i] = rintf(f[i]) + f0;
      if (OP == 8) f[i] = fmaxf(f[i], f0) + f0;
    }
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += a[i] + __float_as_int(f[i]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 8 independent accumulator fragments a warp, one mma.sync.m16n8k32 s8 on each
__global__ void mma_chains(int* out, unsigned a0, int iters) {
  int d[8][4] = {};
  const unsigned a = a0 + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])
          : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(a + i), "r"(a));
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

void run_mma(int sms, double mhz, int* out) {
  const int blocks = sms * 4, threads = 256, iters = 4096;  // 32 warps an SM
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_chains<<<blocks, threads>>>(out, 1, 16);
  cudaEventRecord(e0);
  mma_chains<<<blocks, threads>>>(out, 1, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)blocks * (threads / 32) * 8 * iters;
  printf("%-14s %6.3f warp instructions/clock/SM (8192 int8 operations each: %.0f TOP/s), "
         "%.3f ms\n", "mma.m16n8k32", mmas / (ms * 1e-3) / sms / (mhz * 1e6),
         mmas * 8192 / (ms * 1e-3) / 1e12, ms);
}

template <int OP>
void run(const char* name, int per_link, int sms, double mhz, int* out) {
  const int blocks = sms * 8, threads = 1024, iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chains<OP><<<blocks, threads>>>(out, 1, 3, 1.5f, 16);
  cudaEventRecord(e0);
  chains<OP><<<blocks, threads>>>(out, 1, 3, 1.5f, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ops = (double)blocks * threads * 8 * iters;
  printf("%-14s %6.1f links/clock/SM (%d operation%s a link), %.3f ms\n", name,
         ops / (ms * 1e-3) / sms / (mhz * 1e6), per_link, per_link > 1 ? "s" : "", ms);
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: pipe_rates <SM clock in MHz>\n");
    return 2;
  }
  const double mhz = atof(argv[1]);
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) return 1;
  const int sms = prop.multiProcessorCount;
  int* out = nullptr;
  if (cudaMalloc(&out, (size_t)sms * 8 * 1024 * sizeof(int)) != cudaSuccess) return 1;
  printf("%s, %d SMs, rates at %.0f MHz\n", prop.name, sms, mhz);
  run<0>("dp4a", 1, sms, mhz, out);
  run<1>("imad", 1, sms, mhz, out);
  run<2>("ffma", 1, sms, mhz, out);
  run<3>("i2f", 1, sms, mhz, out);
  run<4>("f2i", 1, sms, mhz, out);
  run<5>("and+prmt", 2, sms, mhz, out);
  run<6>("imax+iadd", 2, sms, mhz, out);
  run<7>("rintf+fadd", 2, sms, mhz, out);
  run<8>("fmax+fadd", 2, sms, mhz, out);
  run_mma(sms, mhz, out);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
