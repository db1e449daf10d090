// The weight strip walk of K6 (fused_out_residual, decode_fused.cu) and
// K8 (fused_attn_out, attn_out_fused.cu), its remaining users; K5 and K7
// walk their weights on fused_walk.cuh:
// out[m, n0:n0+32] = x[m, :] @ dequant(w)[:, n0:n0+32] for m < MT <= 32,
// with x staged in shared memory by the caller and the result handed to
// the caller's epilogue, so each kernel adds its own epilogue (a
// residual) around the same weight stream.
//
// The weight is the port's "kn" QTensor (qkind.cuh): q8 int8 [K, N], or
// 4-bit (q4, q4g) uint8 [K/2, N] whose byte-rows each pack two K-rows of
// a 32-row block, with fp16 block scales [K >> sshift, N] (the caller
// offsets both to its layer). The walk is a template on the bits (8 or
// 4); q4 and q4g differ only in the scale row a 32-row block reads. As in
// K1 (qmatmul.cu), a 256-thread block owns 32 columns: 8 column groups
// read a row of the strip as 4-byte words (one 32-byte sector) and 32 K
// slices walk 32-row blocks (32 word rows at q8, 16 at 4 bits), so the
// weight streams exactly once. x is staged 1024 rows of K at a time,
// eight values a thread from one 16-byte load: at M = 32, staging one
// element a thread cost more than the weights. The slices are summed in
// shared memory in a fixed order.
//
// The two bodies follow the TPU kernels' two dot bodies (ffn_fused.py
// _block_dot_q / _tile_dot_q, which decode_fused.py and attn_out_fused.py
// share, with their q8 and q4/q4g branches):
// - MT <= 8 (latency): x staged as f32, one pad float per 32-block so
//   the slices hit distinct banks; f32 FMAs on the CUDA cores, a 4-bit
//   value dequantized to (v - 7) in f32 first (exact), each 32-block's
//   dot scaled by its fp16 scale after the dot (exact dequantization),
//   as K1 does;
// - MT > 8 (serving): x is staged as bf16, and each warp in turn
//   dequantizes one 32 x 32 block of the strip to bf16 in its own shared
//   tile and multiplies it on the tensor cores (nvcuda::wmma, f32
//   accumulators), as the tile-dequantizing body rounds every weight to
//   the compute dtype before one MXU dot. At q8 a lane dequantizes one
//   weight row; at 4 bits a lane takes half of a byte-row (16 columns)
//   and writes its two K-rows. The 8 warps' partial sums are added in
//   shared memory in a fixed order.
//
// The caller's dynamic shared memory holds smem_floats(MT) floats, at a
// 128-byte aligned base (the tensor cores' tiles need 32 bytes); it does
// not depend on the bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "qkind.cuh"

namespace qstrip {

constexpr int QBLOCK = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 32;                  // output columns per strip
constexpr int CG = COLS / 4;              // column groups (4 bytes each)
constexpr int KS = THREADS / CG;          // K slices
constexpr int KCHUNK = KS * QBLOCK;       // rows of x staged per pass
constexpr int XLD = KCHUNK + KS;          // f32 rows: a pad float per 32-block
constexpr int XLDH = KCHUNK + 8;          // bf16 rows of the tensor-core body
constexpr int BLD = COLS + 8;             // bf16 rows of a dequantized block
constexpr int MAX_M = 32;

// Floats of dynamic shared memory that row tile MT needs: the staged
// rows (and a dequantized 32 x 32 block per warp above MT = 8); the
// partial sums of the epilogue reuse the staged rows.
__host__ __device__ constexpr int smem_floats(int MT) {
  return MT <= 8 ? MT * XLD : (MT * XLDH + WARPS * QBLOCK * BLD) / 2;
}
static_assert(KS * COLS <= XLD, "the slice sums reuse the staged rows");
static_assert(WARPS * COLS * 2 <= XLDH, "the warp sums reuse the staged rows");

using bf16 = __nv_bfloat16;

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fill rows [0, MT) of the staged chunk [k0, k0 + kc), eight values at
// a time: load8(m, k, v) writes x[m, k .. k+8) (k a multiple of 8) for
// m < M; the pad rows up to MT are zeros. f32 rows up to MT = 8, bf16
// rows (exact: the values are already rounded to bf16) above.
template <int MT, class Load8>
__device__ inline void stage_rows(float* buf, int M, int k0, int kc, Load8 load8) {
  const int vpr = kc / 8;  // 8-value vectors a row
  for (int i = threadIdx.x; i < MT * vpr; i += THREADS) {
    const int m = i / vpr, k = (i % vpr) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < M) load8(m, k0 + k, v);
    if constexpr (MT > 8) {
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        h[e] = *reinterpret_cast<const uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(buf) + m * XLDH + k) =
          make_uint4(h[0], h[1], h[2], h[3]);
    } else {
      float* d = buf + m * XLD + k + k / QBLOCK;
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = v[j];
    }
  }
}

// Eight bf16 values at p (16-byte aligned) as floats, one 16-byte load.
__device__ inline void load_bf16x8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
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

// Rows [kb, kb + 32) of the strip [n0, n0 + 32) dequantized to bf16 into
// a warp's tile (row stride BLD): q * scale, or (v - 7) * scale, in f32,
// rounded once. q8: one weight row a lane. 4 bits: lane l reads 16
// columns (half l / 16) of byte-row l % 16 and writes K-rows l % 16 and
// l % 16 + 16.
template <int BITS>
__device__ inline void dequant_block(bf16* tile, const uint8_t* __restrict__ w,
                                     const __half* __restrict__ s, int N, int n0,
                                     int kb, int sshift) {
  const int lane = threadIdx.x % 32;
  const __half* srow = s + (size_t)(kb >> sshift) * N + n0;
  if constexpr (BITS == 8) {
    const int4* wr = reinterpret_cast<const int4*>(w + (size_t)(kb + lane) * N + n0);
    const int4* sr = reinterpret_cast<const int4*>(srow);
    const int4 q[2] = {wr[0], wr[1]};
    const int8_t* qb = reinterpret_cast<const int8_t*>(q);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + lane * BLD);
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 8 columns a 16-byte scale load
      const int4 sv = sr[c];
      const __half2* sh = reinterpret_cast<const __half2*>(&sv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __half22float2(sh[e]);
        const int j = 8 * c + 2 * e;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn((float)qb[j] * f.x, (float)qb[j + 1] * f.y);
        dst[j / 2] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  } else {
    const int j = lane % 16, c0 = (lane / 16) * 16;
    const int4 q = *reinterpret_cast<const int4*>(w + (size_t)(kb / 2 + j) * N + n0 + c0);
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(&q);
    const int4* sr = reinterpret_cast<const int4*>(srow + c0);
    uint32_t* hi = reinterpret_cast<uint32_t*>(tile + j * BLD + c0);
    uint32_t* lo = reinterpret_cast<uint32_t*>(tile + (j + QBLOCK / 2) * BLD + c0);
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // 8 columns a 16-byte scale load
      const int4 sv = sr[c];
      const __half2* sh = reinterpret_cast<const __half2*>(&sv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __half22float2(sh[e]);
        const int b = 8 * c + 2 * e;
        const __nv_bfloat162 h = __floats2bfloat162_rn(qkind::hi4(qb[b]) * f.x,
                                                       qkind::hi4(qb[b + 1]) * f.y);
        const __nv_bfloat162 l = __floats2bfloat162_rn(qkind::lo4(qb[b]) * f.x,
                                                       qkind::lo4(qb[b + 1]) * f.y);
        hi[b / 2] = *reinterpret_cast<const uint32_t*>(&h);
        lo[b / 2] = *reinterpret_cast<const uint32_t*>(&l);
      }
    }
  }
}

// The latency body (MT <= 8): f32 FMAs, post-dot block scales.
template <int MT, int BITS, class Stage, class Epi>
__device__ inline void strip_fma(float* buf, const uint8_t* __restrict__ w,
                                 const __half* __restrict__ s, int K, int N,
                                 int n0, int sshift, Stage stage, Epi epi) {
  const int tc = threadIdx.x % CG, ks = threadIdx.x / CG;
  const int n = n0 + tc * 4;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    const int kc = min(KCHUNK, K - k0);
    __syncthreads();
    stage(buf, k0, kc);
    __syncthreads();
    const int kb = ks * QBLOCK;
    if (kb < kc) {
      const float* xs = buf + ks * (QBLOCK + 1);
      float part[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
      if constexpr (BITS == 8) {
        const int8_t* wp = reinterpret_cast<const int8_t*>(w) + (size_t)(k0 + kb) * N + n;
        char4 q[QBLOCK];  // all 32 rows' loads first, in flight together
#pragma unroll
        for (int r = 0; r < QBLOCK; ++r)
          q[r] = *reinterpret_cast<const char4*>(wp + (size_t)r * N);
#pragma unroll
        for (int r = 0; r < QBLOCK; ++r) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xs[m * XLD + r];
            part[m][0] += xv * (float)q[r].x;
            part[m][1] += xv * (float)q[r].y;
            part[m][2] += xv * (float)q[r].z;
            part[m][3] += xv * (float)q[r].w;
          }
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
          float hv[4], lv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            hv[c] = qkind::hi4(q[j] >> (8 * c));
            lv[c] = qkind::lo4(q[j] >> (8 * c));
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xh = xs[m * XLD + j], xl = xs[m * XLD + j + QBLOCK / 2];
#pragma unroll
            for (int c = 0; c < 4; ++c) part[m][c] += xh * hv[c] + xl * lv[c];
          }
        }
      }
      const __half2* sp = reinterpret_cast<const __half2*>(
          s + (size_t)((k0 + kb) >> sshift) * N + n);
      const float2 s01 = __half22float2(sp[0]), s23 = __half22float2(sp[1]);
      const float sc[4] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += part[m][j] * sc[j];
    }
  }

  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      buf[(ks * MT + m) * COLS + tc * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    float v = 0.f;
    for (int t = 0; t < KS; ++t) v += buf[(t * MT + m) * COLS + c];
    epi(m, n0 + c, v);
  }
}

// The serving body (MT = 16, 32): bf16 weight blocks on the tensor cores.
template <int MT, int BITS, class Stage, class Epi>
__device__ inline void strip_mma(float* buf, const uint8_t* __restrict__ w,
                                 const __half* __restrict__ s, int K, int N,
                                 int n0, int sshift, Stage stage, Epi epi) {
  using namespace nvcuda;
  static_assert(MT % 16 == 0, "the tensor-core body takes 16-row tiles");
  const int warp = threadIdx.x / 32;
  const bf16* xh = reinterpret_cast<const bf16*>(buf);
  bf16* tile = reinterpret_cast<bf16*>(buf) + MT * XLDH + warp * QBLOCK * BLD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[MT / 16][2];
#pragma unroll
  for (int i = 0; i < MT / 16; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    const int kc = min(KCHUNK, K - k0);
    __syncthreads();
    stage(buf, k0, kc);
    __syncthreads();
    for (int kb = warp * QBLOCK; kb < kc; kb += WARPS * QBLOCK) {
      dequant_block<BITS>(tile, w, s, N, n0, k0 + kb, sshift);
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < QBLOCK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], tile + kk * BLD + 16 * j, BLD);
#pragma unroll
        for (int i = 0; i < MT / 16; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, xh + 16 * i * XLDH + kb + kk, XLDH);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a, b[j], c[i][j]);
        }
      }
      __syncwarp();
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT / 16; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(buf + (warp * MT + 16 * i) * COLS + 16 * j, c[i][j],
                              COLS, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < MT * COLS; i += THREADS) {
    const int m = i / COLS, cc = i % COLS;
    float v = 0.f;
    for (int t = 0; t < WARPS; ++t) v += buf[(t * MT + m) * COLS + cc];
    epi(m, n0 + cc, v);
  }
}

// One 32-column strip [n0, n0 + 32) of w (BITS-bit data, scale rows of
// 1 << sshift K-rows) against the staged rows. stage(buf, k0, kc) fills
// the chunk (see stage_rows); epi(m, n, v) gets the f32 sum of every row
// m < MT (pad rows included) and column n. Every thread of the block must
// call it (it synchronizes the block).
template <int MT, int BITS, class Stage, class Epi>
__device__ inline void strip_matmul(float* buf, const uint8_t* __restrict__ w,
                                    const __half* __restrict__ s, int K, int N,
                                    int n0, int sshift, Stage stage, Epi epi) {
  if constexpr (MT > 8)
    strip_mma<MT, BITS>(buf, w, s, K, N, n0, sshift, stage, epi);
  else
    strip_fma<MT, BITS>(buf, w, s, K, N, n0, sshift, stage, epi);
}

// Call f(std::integral_constant<int, MT>{}) with the row tile MT that
// covers M (1 <= M <= 32): M itself up to 2, then 4, 8, 16, 32. Tiles
// above 8 take the tile-dequantizing rounding, as M > 8 does on the TPU.
template <class F>
__host__ inline int with_row_tile(int M, F f) {
  if (M == 1) return f(std::integral_constant<int, 1>{});
  if (M == 2) return f(std::integral_constant<int, 2>{});
  if (M <= 4) return f(std::integral_constant<int, 4>{});
  if (M <= 8) return f(std::integral_constant<int, 8>{});
  if (M <= 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

// Raise the kernel's dynamic shared memory limit to what tile MT needs,
// once per kernel (a host call, kept out of graph capture by the first
// eager launch).
template <class Kern>
__host__ inline cudaError_t allow_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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
