// The kernel microbench's feature probes for Hopper (sm_90a): what the
// card does with int4, byte bitcasts and integer dots. They replace the
// four Pallas probes of bench_probe in tools/kbench.py (k4, kb, ki, k8;
// pallas_call at lines 148, 179, 202 and 225).
//
// * int4 (k4): packed signed nibbles (low nibble column 2j, high 2j + 1)
//   -> bf16 2 * v, a thread a byte. Bound: bytes (32 KB in, 128 KB out at
//   the probe's [256, 256]).
// * bitcast (kb): four consecutive bytes of a column as one little-endian
//   int32, & 0xF, as bf16. The JAX probe's intent (its body cannot trace).
// * i32dot (ki): int8 widened to int32, a scalar int32 multiply-add a
//   (row, column) pair: Hopper has no int32 tensor-core product, so this
//   is the CUDA-core path.
// * i8dot (k8): int8 x int8 -> int32 on the tensor cores with
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, a warp an 8-column
//   tile, rows past M zero; the probe the int8-activation redesign needs.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;

__global__ void int4_kernel(const uint8_t* __restrict__ w, bf16* __restrict__ out,
                            int R, int C) {
  const int C2 = C / 2;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= R * C2) return;
  const int r = i / C2, j = i % C2;
  const int b = w[i];
  const int lo = (int)(int8_t)(uint8_t)(b << 4) >> 4;
  const int hi = (int)(int8_t)(uint8_t)b >> 4;
  out[(size_t)r * C + 2 * j] = __float2bfloat16(2.f * (float)lo);
  out[(size_t)r * C + 2 * j + 1] = __float2bfloat16(2.f * (float)hi);
}

__global__ void bitcast_kernel(const uint8_t* __restrict__ w, bf16* __restrict__ out,
                               int R, int C) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= R * C) return;
  const int r = i / C, c = i % C;
  const uint8_t* col = w + (size_t)4 * r * C + c;
  const uint32_t word = (uint32_t)col[0] | ((uint32_t)col[C] << 8) |
                        ((uint32_t)col[2 * C] << 16) | ((uint32_t)col[3 * C] << 24);
  out[i] = __float2bfloat16((float)(int)(word & 0xFu));
}

__global__ void i32dot_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                              float* __restrict__ out, int M, int N, int K) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i % N;
  int acc = 0;
  for (int k = 0; k < K; ++k) acc += (int)x[(size_t)m * K + k] * (int)w[(size_t)k * N + n];
  out[i] = (float)acc;
}

__device__ inline uint32_t row4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four bytes down a column: w[k..k+3][n], the first in the low byte
__device__ inline uint32_t col4(const int8_t* w, int k, int n, int N) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(w) + (size_t)k * N + n;
  return (uint32_t)p[0] | ((uint32_t)p[N] << 8) | ((uint32_t)p[2 * N] << 16) |
         ((uint32_t)p[3 * N] << 24);
}

__global__ void i8dot_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                             float* __restrict__ out, int M, int N, int K) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = warp * 8;
  if (n0 >= N) return;  // uniform across the warp
  const int g = lane >> 2, t = lane & 3;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    // A (16 x 32, row-major): rows g and g + 8, columns 4t.. and 16 + 4t..
    const uint32_t a0 = g < M ? row4(x + (size_t)g * K + k0 + 4 * t) : 0u;
    const uint32_t a1 = g + 8 < M ? row4(x + (size_t)(g + 8) * K + k0 + 4 * t) : 0u;
    const uint32_t a2 = g < M ? row4(x + (size_t)g * K + k0 + 16 + 4 * t) : 0u;
    const uint32_t a3 =
        g + 8 < M ? row4(x + (size_t)(g + 8) * K + k0 + 16 + 4 * t) : 0u;
    // B (32 x 8, column-major): column g, rows 4t.. and 16 + 4t..
    const uint32_t b0 = col4(w, k0 + 4 * t, n0 + g, N);
    const uint32_t b1 = col4(w, k0 + 16 + 4 * t, n0 + g, N);
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  // C: c0, c1 at row g, columns 2t and 2t + 1; c2, c3 at row g + 8
  const int n = n0 + 2 * t;
  if (g < M) {
    out[(size_t)g * N + n] = (float)c0;
    out[(size_t)g * N + n + 1] = (float)c1;
  }
  if (g + 8 < M) {
    out[(size_t)(g + 8) * N + n] = (float)c2;
    out[(size_t)(g + 8) * N + n + 1] = (float)c3;
  }
}

int blocks(long long threads) { return (int)((threads + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// probe: 0 int4 (a: uint8 [rows, cols/2] -> bf16 [rows, cols]), 1 bitcast
// (a: int8 [4 rows, cols] -> bf16 [rows, cols]), 2 i32dot and 3 i8dot (a:
// int8 [rows, depth], b: int8 [depth, cols] -> f32 [rows, cols]; i8dot
// needs rows <= 16, depth % 32 == 0, cols % 8 == 0).
int kbench_probe(const void* a, const void* b, void* out, int probe, int rows,
                 int cols, int depth, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ai = static_cast<const int8_t*>(a);
  auto bi = static_cast<const int8_t*>(b);
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case 0:
      if (cols % 2) return (int)cudaErrorInvalidValue;
      int4_kernel<<<blocks((long long)rows * cols / 2), THREADS, 0, st>>>(
          static_cast<const uint8_t*>(a), static_cast<bf16*>(out), rows, cols);
      break;
    case 1:
      bitcast_kernel<<<blocks((long long)rows * cols), THREADS, 0, st>>>(
          static_cast<const uint8_t*>(a), static_cast<bf16*>(out), rows, cols);
      break;
    case 2:
      i32dot_kernel<<<blocks((long long)rows * cols), THREADS, 0, st>>>(
          ai, bi, static_cast<float*>(out), rows, cols, depth);
      break;
    case 3:
      if (rows > 16 || depth % 32 || cols % 8) return (int)cudaErrorInvalidValue;
      i8dot_kernel<<<blocks((long long)cols / 8 * 32), THREADS, 0, st>>>(
          ai, bi, static_cast<float*>(out), rows, cols, depth);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
