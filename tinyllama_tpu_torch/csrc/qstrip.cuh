// The wo strip walk of K8 (fused_attn_out, attn_out_fused.cu), its one
// user; the other weight kernels (K1, K5-K7) walk their weights on
// fused_walk.cuh:
// out[n0:n0+32] = x @ dequant(w)[:, n0:n0+32] for the one row x of a
// batch-1 decode step, with x staged in shared memory by the caller and
// the result handed to the caller's epilogue (K8 adds the residual).
//
// The weight is the port's "kn" QTensor (qkind.cuh): q8 int8 [K, N], or
// 4-bit (q4, q4g) uint8 [K/2, N] whose byte-rows each pack two K-rows of
// a 32-row block, with fp16 block scales [K >> sshift, N] (the caller
// offsets both to its layer). The walk is a template on the bits (8 or
// 4); q4 and q4g differ only in the scale row a 32-row block reads. A
// 256-thread block owns 32 columns: 8 column groups read a row of the
// strip as 4-byte words (one 32-byte sector) and 32 K slices walk 32-row
// blocks (32 word rows at q8, 16 at 4 bits), so the weight streams
// exactly once. x is staged as f32 1024 rows of K at a time, eight values
// a thread, one pad float per 32-block so the slices hit distinct banks.
// The TPU's m = 1 blockdot body (ffn_fused.py _block_dot_q, which
// attn_out_fused.py shares): f32 FMAs on the CUDA cores, a 4-bit value
// dequantized to (v - 7) in f32 first (exact), each 32-block's dot scaled
// by its fp16 scale after the dot; the slices are summed in shared memory
// in a fixed order.
//
// The caller's dynamic shared memory holds SMEM_FLOATS floats.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qkind.cuh"

namespace qstrip {

constexpr int QBLOCK = 32;
constexpr int THREADS = 256;
constexpr int COLS = 32;                  // output columns per strip
constexpr int CG = COLS / 4;              // column groups (4 bytes each)
constexpr int KS = THREADS / CG;          // K slices
constexpr int KCHUNK = KS * QBLOCK;       // rows of x staged per pass
constexpr int XLD = KCHUNK + KS;          // f32 row: a pad float per 32-block
constexpr int SMEM_FLOATS = XLD;          // the staged row, then the slice sums
static_assert(KS * COLS <= XLD, "the slice sums reuse the staged row");

using bf16 = __nv_bfloat16;

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Fill the staged chunk [k0, k0 + kc) of the row, eight values at a time:
// load8(k, v) writes x[k .. k+8) (k a multiple of 8).
template <class Load8>
__device__ inline void stage_row(float* buf, int k0, int kc, Load8 load8) {
  for (int k = threadIdx.x * 8; k < kc; k += THREADS * 8) {
    float v[8];
    load8(k0 + k, v);
    float* d = buf + k + k / QBLOCK;
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = v[j];
  }
}

// Eight f32 values at p (16-byte aligned) rounded to bf16, read through
// L2 (__ldcg): for workspaces written by other blocks of the same launch.
__device__ inline void load_l2_f32x8(const float* p, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = round_bf16(f[j]);
}

// One 32-column strip [n0, n0 + 32) of w (BITS-bit data, scale rows of
// 1 << sshift K-rows) against the staged row. stage(buf, k0, kc) fills
// the chunk (see stage_row); epi(n, v) gets the f32 sum of column n.
// Every thread of the block must call it (it synchronizes the block).
template <int BITS, class Stage, class Epi>
__device__ inline void strip_matmul(float* buf, const uint8_t* __restrict__ w,
                                    const __half* __restrict__ s, int K, int N,
                                    int n0, int sshift, Stage stage, Epi epi) {
  const int tc = threadIdx.x % CG, ks = threadIdx.x / CG;
  const int n = n0 + tc * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    const int kc = min(KCHUNK, K - k0);
    __syncthreads();
    stage(buf, k0, kc);
    __syncthreads();
    const int kb = ks * QBLOCK;
    if (kb < kc) {
      const float* xs = buf + ks * (QBLOCK + 1);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (BITS == 8) {
        const int8_t* wp = reinterpret_cast<const int8_t*>(w) + (size_t)(k0 + kb) * N + n;
        char4 q[QBLOCK];  // all 32 rows' loads first, in flight together
#pragma unroll
        for (int r = 0; r < QBLOCK; ++r)
          q[r] = *reinterpret_cast<const char4*>(wp + (size_t)r * N);
#pragma unroll
        for (int r = 0; r < QBLOCK; ++r) {
          const float xv = xs[r];
          part[0] += xv * (float)q[r].x;
          part[1] += xv * (float)q[r].y;
          part[2] += xv * (float)q[r].z;
          part[3] += xv * (float)q[r].w;
        }
      } else {
        // word j: K-rows j (high nibbles) and j + 16 (low) of 4 columns
        const uint8_t* wp = w + (size_t)((k0 + kb) / 2) * N + n;
        uint32_t q[QBLOCK / 2];
#pragma unroll
        for (int j = 0; j < QBLOCK / 2; ++j)
          q[j] = *reinterpret_cast<const uint32_t*>(wp + (size_t)j * N);
#pragma unroll
        for (int j = 0; j < QBLOCK / 2; ++j) {
          const float xh = xs[j], xl = xs[j + QBLOCK / 2];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[c] += xh * qkind::hi4(q[j] >> (8 * c)) + xl * qkind::lo4(q[j] >> (8 * c));
        }
      }
      const __half2* sp = reinterpret_cast<const __half2*>(
          s + (size_t)((k0 + kb) >> sshift) * N + n);
      const float2 s01 = __half22float2(sp[0]), s23 = __half22float2(sp[1]);
      const float sc[4] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += part[j] * sc[j];
    }
  }

  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) buf[ks * COLS + tc * 4 + j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < COLS; c += THREADS) {
    float v = 0.f;
    for (int t = 0; t < KS; ++t) v += buf[t * COLS + c];
    epi(n0 + c, v);
  }
}

// How many blocks of `kernel` the card holds at once (a cooperative
// launch's grid barrier needs every block resident). Callers keep the
// answer in a static: it depends on the kernel and its shared memory.
template <class Kern>
__host__ inline cudaError_t resident_blocks(Kern kernel, int bytes, int* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                        bytes);
  if (err) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *n = per_sm * sms;
  return cudaSuccess;
}

// Launch with the cooperative attribute (all blocks co-resident, so
// cooperative_groups::this_grid().sync() is legal; capturable in a CUDA
// graph as a cooperative kernel node).
template <class... Params, class... Args>
__host__ inline cudaError_t launch_cooperative(void (*kernel)(Params...), int grid,
                                               int bytes, cudaStream_t st,
                                               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace qstrip
