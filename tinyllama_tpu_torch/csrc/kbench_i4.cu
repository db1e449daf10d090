// The kernel microbench's native-int4 small-M matmul for Hopper (sm_90a):
// x bf16 [M, K] (M <= 8) times signed int4 weights in [-7, 7], packed two
// a byte along N (uint8 [K, N/2], low nibble column 2j, high nibble 2j +
// 1), with f32 scales a 32-row block [K/32, N], into f32 [M, N].
//
// Replaces `kernel` of bench_i4 in tools/kbench.py (pallas_call at line
// 653), both bodies as a template flag:
//   blockdot: each block's 32-deep dot of x with the integer values in
//     f32, scaled by the block's scale after the dot;
//   tiledeq: w * s rounded to bf16 first, then the dot.
// Bound: the packed weight and scale bytes over the memory rate (the
// five decode shapes read 1.0-41 MB for 16 x-row products a byte).
// Design: a thread a byte column (two output columns), 32 of them a warp
// so a byte row is one 32-byte read; the block's 8 warps split each
// 256-row window of K (a 32-row block each), x's window staged once in
// shared memory for all of them, and sum their partials in shared memory
// at the end. Nibbles sign-extend by (int8)(b << 4) >> 4 and (int8)b >> 4;
// the ragged last column group is masked. The TPU tool's (bn, bk) tiles
// change no value here and are not taken.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 8;
constexpr int BLK = 32;            // rows a scale block
constexpr int WIN = BLK * WARPS;   // K rows a staged window

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool TILEDEQ>
__global__ void __launch_bounds__(THREADS)
i4_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ s, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) bf16 xs[MAX_M * WIN];
  __shared__ float red[WARPS][MAX_M][32][2];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int N2 = N / 2;
  const int j = blockIdx.x * 32 + tx;
  const bool valid = j < N2;
  float acc[MAX_M][2];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) acc[m][0] = acc[m][1] = 0.f;

  for (int k0 = 0; k0 < K; k0 += WIN) {
    __syncthreads();
    for (int i = threadIdx.x; i < M * WIN / 8; i += THREADS) {
      const int m = i / (WIN / 8), c = (i % (WIN / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + m * WIN + c) =
          *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c);
    }
    __syncthreads();
    if (!valid) continue;
    const int kb = k0 + BLK * ty;  // this warp's block
    const float2 sc = *reinterpret_cast<const float2*>(s + (size_t)(kb / BLK) * N + 2 * j);
    float p0[MAX_M], p1[MAX_M];
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) p0[m] = p1[m] = 0.f;
    const uint8_t* col = w + (size_t)kb * N2 + j;
    const bf16* xw = xs + BLK * ty;
    int wb[BLK];  // the block's 32 byte rows, all loads in flight at once
#pragma unroll
    for (int r = 0; r < BLK; ++r) wb[r] = col[(size_t)r * N2];
#pragma unroll
    for (int r = 0; r < BLK; ++r) {
      const int b = wb[r];
      float v0 = (float)((int)(int8_t)(uint8_t)(b << 4) >> 4);
      float v1 = (float)((int)(int8_t)(uint8_t)b >> 4);
      if (TILEDEQ) {
        v0 = round_bf16(v0 * sc.x);
        v1 = round_bf16(v1 * sc.y);
      }
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) {
        if (m < M) {
          const float xv = __bfloat162float(xw[m * WIN + r]);
          p0[m] += xv * v0;
          p1[m] += xv * v1;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) {
      if (TILEDEQ) {
        acc[m][0] += p0[m];
        acc[m][1] += p1[m];
      } else {
        acc[m][0] += __fmul_rn(p0[m], sc.x);
        acc[m][1] += __fmul_rn(p1[m], sc.y);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    red[ty][m][tx][0] = acc[m][0];
    red[ty][m][tx][1] = acc[m][1];
  }
  __syncthreads();
  if (ty != 0 || !valid) return;
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = 0.f;
#pragma unroll
      for (int y = 0; y < WARPS; ++y) v += red[y][m][tx][c];
      if (2 * j + c < N) out[(size_t)m * N + 2 * j + c] = v;
    }
  }
}

}  // namespace

extern "C" {

// body: 0 blockdot, 1 tiledeq. Requires 1 <= M <= 8, K % 256 == 0, N
// even, 16-byte-aligned x rows.
int kbench_i4(const void* x, const void* w, const void* s, void* out, int body,
              int M, int K, int N, void* stream) {
  if (M < 1 || M > MAX_M || K < WIN || K % WIN || N < 2 || N % 2 || body < 0 ||
      body > 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N / 2 + 31) / 32);
  auto xb = static_cast<const bf16*>(x);
  auto wb = static_cast<const uint8_t*>(w);
  auto sb = static_cast<const float*>(s);
  auto ob = static_cast<float*>(out);
  if (body)
    i4_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, sb, ob, M, K, N);
  else
    i4_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, sb, ob, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
