// The kernel microbench's q4 small-M variant sweep for Hopper (sm_90a):
// x bf16 [M, K] (M <= 8) times JAX's planar q4 weight, int8 data [K/2, N]
// (byte row 32g + j holds K-row 64g + j in its high nibble and
// 64g + 32 + j in its low one; or pre-tiled [N/bn, K/2, bn]) with f32
// "scales" [K/32, N] (or [N/bn, K/32, bn]), into f32 [M, N].
//
// Replaces `body` (25 variants) and `run_manual` of bench_sweep in
// tools/kbench.py (pallas_call at lines 1421, 1469 and 1485). Each
// variant computes what its TPU body computes, step by step over the K
// tiles of bk (the output sums the steps), so the tile-dependent
// ablations (stream, overlap, dotsraw, unpackonly) give the TPU's values.
// Bound: the data and scale bytes over the memory rate (16 x-row
// products a data byte at M = 8).
//
// Design: a thread a column, 32 columns a block, so a warp reads a byte
// row as one 32-byte sector; the block's 8 warps split the 64-row groups
// of each K step and sum their partials in shared memory at the end.
// x's bk window (or, with -x, all of K once) is staged in shared memory
// as bf16 with its 32-row block sums in f32, shared by the 32 columns.
// Every variant first loads a group's 32 byte rows into registers, all
// in flight at once, then the variants differ as instruction schedules:
//   cur         32-bit shift and mask a byte, unpack fused into the dot;
//   i8shift     four bytes packed into a word (prmt), both nibble planes
//               masked four at a time, bytes taken out with prmt;
//   i16shift    two bytes a word in 16-bit lanes, masked two at a time;
//   ilp4        cur into four rotating accumulators; tree: each group's
//               two planes summed before the accumulator;
//   fullunpack  a group's 64 values unpacked into registers first, then
//               the dot; dq: dequantized (v - 7) * s to bf16 first;
//   corrdot(nm) the offset correction as one product of the x block sums
//               with the scales a step (nm: high nibble unmasked);
//   dot3 / dotsraw / unpackonly / biasand / nosum / noand / dotsonly /
//   g128 / g128d2 / g256 / g256presum / g256dots / g256fma1 / dqbias /
//   overlap     the TPU tool's cost ablations, term for term;
//   stream      reads every byte of every data and scale tile (folded into
//               a value stored only under a flag the caller never sets, so
//               no load is dead) and adds the TPU body's touch of the
//               first 8 byte rows, the first scale row and x's row sums;
//   manual      cur fed by a two-stage cp.async ring of (bk/2 x 32) data
//               and (bk/32 x 32) scale tiles in shared memory, x staged
//               whole: the counterpart of run_manual's double-buffered
//               DMA. Needs N % 32 == 0.
// -v sets the kernel's dynamic shared-memory limit to the card's most;
// without it a launch needing over 48 KB is refused. Products fold into
// f32 accumulators; the scale arithmetic that the TPU body rounds apart
// (dqbias's tile dequantization) uses __fmul_rn / __fadd_rn.
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
constexpr int BLK = 32;     // K rows a scale row
constexpr int GROUP = 64;   // K rows a packing group (32 byte rows)
constexpr int SMEM_MAX = 232448 - WARPS * MAX_M * 32 * 4;  // dynamic, with -v

// the variant codes, in the order of VARIANTS in ops/kernels/kbench_sweep.py
enum {
  CUR, I8SHIFT, I16SHIFT, ILP4, TREE, FULLUNPACK, DQ, CORRDOT, CORRDOTNM,
  DOT3, DOTSRAW, UNPACKONLY, BIASAND, NOSUM, NOAND, DOTSONLY, G128, G128D2,
  G256, G256PRESUM, G256DOTS, G256FMA1, DQBIAS, OVERLAP, STREAM, MANUAL
};

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ inline int align16(int v) { return (v + 15) / 16 * 16; }

// x[:, k0:k0+W] into xs (bf16 [M][W]) and its 32-row block sums into
// bsum (f32 [M][W/32]); ends with the block synchronized.
__device__ void stage_x(const bf16* __restrict__ x, bf16* xs, float* bsum, int M,
                        int K, int k0, int W) {
  for (int i = threadIdx.x; i < M * W / 8; i += THREADS) {
    const int m = i / (W / 8), c = (i % (W / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + m * W + c) =
        *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * (W / BLK); i += THREADS) {
    const int m = i / (W / BLK), b = i % (W / BLK);
    float t = 0.f;
    for (int r = 0; r < BLK; ++r) t += __bfloat162float(xs[m * W + BLK * b + r]);
    bsum[i] = t;
  }
  __syncthreads();
}

// the block's partial sums over its warps -> out; the ragged columns masked
__device__ void finish(float (&acc)[MAX_M], float (*red)[MAX_M][32], float* out,
                       int M, int N, int n, bool valid) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) red[ty][m][tx] = acc[m];
  __syncthreads();
  if (ty != 0 || !valid) return;
  for (int m = 0; m < M; ++m) {
    float v = 0.f;
#pragma unroll
    for (int y = 0; y < WARPS; ++y) v += red[y][m][tx];
    out[(size_t)m * N + n] = v;
  }
}

// byte value b (signed) -> its two nibbles as the cur body takes them
__device__ inline float nib_hi(int b) { return (float)((b >> 4) & 0x0F); }
__device__ inline float nib_lo(int b) { return (float)(b & 0x0F); }

template <int V>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ s, float* __restrict__ out, int M, int K,
             int N, int bn, int bk, int tiled, int xfull, int never) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS][MAX_M][32];
  const int W = xfull ? K : bk;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* bsum = reinterpret_cast<float*>(smem + (size_t)M * W * 2);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + tx;
  const bool valid = n < N;
  const int nc = valid ? n : N - 1;
  // this column's data and scale planes, row strides apart
  const int8_t* wcol;
  const float* scol;
  size_t wstride, sstride;
  if (tiled) {
    const int nt = nc / bn, c = nc % bn;
    wcol = w + (size_t)nt * (K / 2) * bn + c;
    scol = s + (size_t)nt * (K / BLK) * bn + c;
    wstride = sstride = bn;
  } else {
    wcol = w + nc;
    scol = s + nc;
    wstride = sstride = N;
  }
  const int XB = W / BLK;  // block sums a staged row
  float acc[MAX_M];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) acc[m] = 0.f;
  float acc4[4][MAX_M];  // ilp4's rotating accumulators
  if constexpr (V == ILP4) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) acc4[a][m] = 0.f;
  }
  float corr[MAX_M];  // corrdot's offset correction
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) corr[m] = 0.f;
  uint32_t sink = 0;  // stream's fold of every byte it reads

  for (int k0 = 0; k0 < K; k0 += bk) {
    if (!xfull || k0 == 0) {
      __syncthreads();
      stage_x(x, xs, bsum, M, K, xfull ? 0 : k0, W);
    }
    if (!valid) continue;
    const bf16* xw = xs + (xfull ? k0 : 0);
    const float* bw = bsum + (xfull ? k0 / BLK : 0);
    const int8_t* wr = wcol + (size_t)(k0 / 2) * wstride;
    const float* sr = scol + (size_t)(k0 / BLK) * sstride;
    auto X = [&](int m, int k) { return __bfloat162float(xw[m * W + k]); };
    auto BS = [&](int m, int b) { return bw[m * XB + b]; };
    auto B = [&](int i) { return (int)wr[(size_t)i * wstride]; };
    auto S = [&](int j) { return sr[(size_t)j * sstride]; };
    // 32 byte rows from row i0 into registers, all loads issued before use
    auto load32 = [&](int (&wb)[32], int i0) {
#pragma unroll
      for (int j = 0; j < 32; ++j) wb[j] = B(i0 + j);
    };
    const int bkr = bk / 2;

    if constexpr (V == STREAM) {
#pragma unroll 16
      for (int i = ty; i < bkr; i += WARPS) sink ^= (uint32_t)(uint8_t)B(i);
      for (int j = ty; j < bk / BLK; j += WARPS) sink ^= __float_as_uint(S(j));
      if (ty == 0) {
        float wsum = 0.f;
        for (int r = 0; r < 8; ++r) wsum += (float)B(r);
        const float head = wsum + S(0);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
          if (m >= M) break;
          float xsum = 0.f;
          for (int b = 0; b < bk / BLK; ++b) xsum += BS(m, b);
          acc[m] += head + round_bf16(xsum);
        }
      }
    } else if constexpr (V == OVERLAP) {
      for (int i = ty; i < 16; i += WARPS) {
        for (int j = 0; j < BLK; ++j) {
          const float x0 = X(0, BLK * i + j);
#pragma unroll
          for (int m = 0; m < MAX_M; ++m)
            if (m < M) acc[m] += X(m, BLK * i + j) * x0;
        }
      }
      if (ty == 0) {
        const float touch = (float)B(0);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) acc[m] += touch;
      }
    } else if constexpr (V == DOTSRAW) {
      for (int g = ty; g < bkr / BLK; g += WARPS) {
        float p[MAX_M];
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) p[m] = 0.f;
        int wb[32];
        load32(wb, BLK * g);
#pragma unroll
        for (int j = 0; j < BLK; ++j) {
          const float v = (float)wb[j];
#pragma unroll
          for (int m = 0; m < MAX_M; ++m)
            if (m < M) p[m] += X(m, BLK * g + j) * v;
        }
        const float sc = S(g);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) acc[m] += p[m] * sc;
      }
    } else if constexpr (V == G128 || V == G128D2) {
      for (int g = ty; g < bk / 128; g += WARPS) {
        float ph[MAX_M], pl[MAX_M];
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) ph[m] = pl[m] = 0.f;
        for (int c = 0; c < 64; c += 32) {
          int wb[32];
          load32(wb, 64 * g + c);
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int b = wb[jj], j = c + jj;
            const float hi16 = (float)(b & -16), lo = nib_lo(b);
#pragma unroll
            for (int m = 0; m < MAX_M; ++m) {
              if (m < M) {
                // g128 scales x's high window by 1/16 (exact in bf16)
                const float xh = V == G128 ? X(m, 128 * g + j) * 0.0625f
                                           : X(m, 128 * g + j);
                ph[m] += xh * hi16;
                pl[m] += X(m, 128 * g + 64 + j) * lo;
              }
            }
          }
        }
        const float sc = S(2 * g);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
          if (m >= M) break;
          const float sumh = BS(m, 4 * g) + BS(m, 4 * g + 1);
          const float suml = BS(m, 4 * g + 2) + BS(m, 4 * g + 3);
          if constexpr (V == G128) {
            acc[m] += (ph[m] + pl[m] + sumh - 7.f * suml) * sc;
          } else {
            acc[m] += ph[m] * (sc * 0.0625f);
            acc[m] += (pl[m] + sumh - 7.f * suml) * sc;
          }
        }
      }
    } else if constexpr (V == G256 || V == G256PRESUM || V == G256DOTS ||
                         V == G256FMA1) {
      for (int g = ty; g < bk / 256; g += WARPS) {
        float ph[MAX_M], pl[MAX_M];
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) ph[m] = pl[m] = 0.f;
        for (int c = 0; c < 128; c += 32) {
          int wb[32];
          load32(wb, 128 * g + c);
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int b = wb[jj], j = c + jj;
            const float hi16 = (float)(b & -16), lo = nib_lo(b);
#pragma unroll
            for (int m = 0; m < MAX_M; ++m) {
              if (m < M) {
                ph[m] += X(m, 256 * g + j) * hi16;
                pl[m] += X(m, 256 * g + 128 + j) * lo;
              }
            }
          }
        }
        const float sa = S(4 * g), sb = S(4 * g + 2);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
          if (m >= M) break;
          if constexpr (V == G256) {
            float sumh = 0.f, suml = 0.f;
            for (int b = 0; b < 4; ++b) {
              sumh += BS(m, 8 * g + b);
              suml += BS(m, 8 * g + 4 + b);
            }
            acc[m] += (ph[m] * 0.0625f + sumh) * sa;
            acc[m] += (pl[m] - 7.f * suml) * sb;
          } else if constexpr (V == G256PRESUM) {
            acc[m] += (ph[m] * 0.0625f + 1.f) * sa;
            acc[m] += (pl[m] - 7.f) * sb;
          } else if constexpr (V == G256DOTS) {
            acc[m] += ph[m] + pl[m];
          } else {
            acc[m] += (ph[m] + pl[m] + 1.f) * sa;
          }
        }
      }
    } else {
      // the 64-row groups: byte j of a group holds K-rows 64g + j (high
      // nibble) and 64g + 32 + j (low)
      for (int g = ty; g < bkr / 32; g += WARPS) {
        const int kh = GROUP * g, kl = GROUP * g + 32;
        int wb[32];
        load32(wb, 32 * g);
        const float sh = S(2 * g), sl = S(2 * g + 1);
        float ph[MAX_M], pl[MAX_M];
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) ph[m] = pl[m] = 0.f;

        if constexpr (V == UNPACKONLY) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int b = wb[j];
            acc[j % 8] += (float)(((b >> 4) & 0x0F) + (b & 0x0F));
          }
          continue;
        } else if constexpr (V == DQ || V == DQBIAS) {
          float wd[64];
          const float sh16 = __fmul_rn(sh, 0.0625f);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int b = wb[j];
            if constexpr (V == DQ) {
              wd[j] = round_bf16(((float)((b >> 4) & 0x0F) - 7.f) * sh);
              wd[32 + j] = round_bf16(((float)(b & 0x0F) - 7.f) * sl);
            } else {
              wd[j] = round_bf16(__fadd_rn(__fmul_rn((float)(b & -16), sh16), sh));
              wd[32 + j] = round_bf16(
                  __fsub_rn(__fmul_rn((float)(b & 0x0F), sl), __fmul_rn(7.f, sl)));
            }
          }
#pragma unroll
          for (int m = 0; m < MAX_M; ++m) {
            if (m >= M) break;
            float p = 0.f;
#pragma unroll
            for (int j = 0; j < 64; ++j) p += X(m, kh + j) * wd[j];
            acc[m] += p;
          }
          continue;
        } else if constexpr (V == FULLUNPACK) {
          float hv[32], lv[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int b = wb[j];
            hv[j] = nib_hi(b);
            lv[j] = nib_lo(b);
          }
#pragma unroll
          for (int j = 0; j < 32; ++j)
#pragma unroll
            for (int m = 0; m < MAX_M; ++m)
              if (m < M) {
                ph[m] += X(m, kh + j) * hv[j];
                pl[m] += X(m, kl + j) * lv[j];
              }
        } else if constexpr (V == I8SHIFT) {
#pragma unroll
          for (int j = 0; j < 32; j += 4) {
            const uint32_t w01 = __byte_perm((uint32_t)wb[j],
                                             (uint32_t)wb[j + 1], 0x0040);
            const uint32_t w23 = __byte_perm((uint32_t)wb[j + 2],
                                             (uint32_t)wb[j + 3], 0x0040);
            const uint32_t word = __byte_perm(w01, w23, 0x5410);
            const uint32_t his = (word >> 4) & 0x0F0F0F0Fu, los = word & 0x0F0F0F0Fu;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float hi = (float)__byte_perm(his, 0, 0x4440 + q);
              const float lo = (float)__byte_perm(los, 0, 0x4440 + q);
#pragma unroll
              for (int m = 0; m < MAX_M; ++m)
                if (m < M) {
                  ph[m] += X(m, kh + j + q) * hi;
                  pl[m] += X(m, kl + j + q) * lo;
                }
            }
          }
        } else if constexpr (V == I16SHIFT) {
#pragma unroll
          for (int j = 0; j < 32; j += 2) {
            const uint32_t word = ((uint32_t)wb[j] & 0xFFu) |
                                  (((uint32_t)wb[j + 1] & 0xFFu) << 16);
            const uint32_t his = (word >> 4) & 0x000F000Fu, los = word & 0x000F000Fu;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float hi = (float)((his >> (16 * q)) & 0xFFFFu);
              const float lo = (float)((los >> (16 * q)) & 0xFFFFu);
#pragma unroll
              for (int m = 0; m < MAX_M; ++m)
                if (m < M) {
                  ph[m] += X(m, kh + j + q) * hi;
                  pl[m] += X(m, kl + j + q) * lo;
                }
            }
          }
        } else if constexpr (V == DOT3) {
          float pc[MAX_M], pb[MAX_M];
#pragma unroll
          for (int m = 0; m < MAX_M; ++m) pc[m] = pb[m] = 0.f;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int b = wb[j];
            const float h = nib_hi(b), raw = (float)b;
#pragma unroll
            for (int m = 0; m < MAX_M; ++m)
              if (m < M) {
                ph[m] += X(m, kh + j) * h;   // A
                pc[m] += X(m, kl + j) * h;   // C
                pb[m] += X(m, kl + j) * raw; // B
              }
          }
#pragma unroll
          for (int m = 0; m < MAX_M; ++m) {
            if (m >= M) break;
            acc[m] += (ph[m] - 7.f * BS(m, 2 * g)) * sh;
            acc[m] += (pb[m] - 16.f * pc[m] - 7.f * BS(m, 2 * g + 1)) * sl;
          }
          continue;
        } else {
          // cur, ilp4, tree, corrdot(nm), biasand, nosum, noand, dotsonly
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int b = wb[j];
            float hi, lo;
            if constexpr (V == BIASAND || V == NOSUM || V == DOTSONLY) {
              hi = (float)(b & -16);
              lo = nib_lo(b);
            } else if constexpr (V == NOAND) {
              hi = lo = (float)b;
            } else if constexpr (V == CORRDOTNM) {
              hi = (float)(b >> 4);
              lo = nib_lo(b);
            } else {
              hi = nib_hi(b);
              lo = nib_lo(b);
            }
#pragma unroll
            for (int m = 0; m < MAX_M; ++m)
              if (m < M) {
                ph[m] += X(m, kh + j) * hi;
                pl[m] += X(m, kl + j) * lo;
              }
          }
        }

        // the group's two planes into the accumulators
        if constexpr (V != UNPACKONLY && V != DQ && V != DQBIAS && V != DOT3) {
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
          if (m >= M) break;
          const float bh = BS(m, 2 * g), bl = BS(m, 2 * g + 1);
          if constexpr (V == CORRDOT || V == CORRDOTNM) {
            acc[m] += ph[m] * sh;
            acc[m] += pl[m] * sl;
            corr[m] += (bh * 7.f) * sh + (bl * 7.f) * sl;
          } else if constexpr (V == BIASAND || V == NOAND || V == NOSUM) {
            const float sumh = V == NOSUM ? 1.f : bh, suml = V == NOSUM ? 1.f : bl;
            acc[m] += ph[m] * (sh * 0.0625f) + sumh * sh;
            acc[m] += (pl[m] - 7.f * suml) * sl;
          } else if constexpr (V == DOTSONLY) {
            acc[m] += ph[m] * (sh * 0.0625f);
            acc[m] += pl[m] * sl;
          } else if constexpr (V == ILP4) {  // parts 2g, 2g + 1 -> (2g) % 4, ..
            if (g & 1) {
              acc4[2][m] += (ph[m] - 7.f * bh) * sh;
              acc4[3][m] += (pl[m] - 7.f * bl) * sl;
            } else {
              acc4[0][m] += (ph[m] - 7.f * bh) * sh;
              acc4[1][m] += (pl[m] - 7.f * bl) * sl;
            }
          } else if constexpr (V == TREE) {
            acc[m] += (ph[m] - 7.f * bh) * sh + (pl[m] - 7.f * bl) * sl;
          } else {  // cur, i8shift, i16shift, fullunpack
            acc[m] += (ph[m] - 7.f * bh) * sh;
            acc[m] += (pl[m] - 7.f * bl) * sl;
          }
        }
        }
      }
    }
  }

  if constexpr (V == ILP4) {
#pragma unroll
    for (int m = 0; m < MAX_M; ++m)
      acc[m] = (acc4[0][m] + acc4[1][m]) + (acc4[2][m] + acc4[3][m]);
  }
  if constexpr (V == CORRDOT || V == CORRDOTNM) {
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) acc[m] -= corr[m];
  }
  if constexpr (V == STREAM) {
    if (never) out[nc] = __uint_as_float(sink);
  }
  finish(acc, red, out, M, N, n, valid);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N_PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING));
}

// shared memory of the manual pipeline: x and its block sums, then the
// two-stage ring
__host__ __device__ inline int manual_ring_offset(int M, int K) {
  return align16(M * K * 2 + M * (K / BLK) * 4);
}
__host__ __device__ inline int manual_stage_bytes(int bk) {
  return (bk / 2) * 32 + (bk / BLK) * 32 * 4;
}

__global__ void __launch_bounds__(THREADS)
sweep_manual_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s, float* __restrict__ out, int M,
                    int K, int N, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS][MAX_M][32];
  const int bkr = bk / 2, nbs = bk / BLK, nk = K / bk;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* bsum = reinterpret_cast<float*>(smem + (size_t)M * K * 2);
  unsigned char* ring = smem + manual_ring_offset(M, K);
  const int stage = manual_stage_bytes(bk);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int n0 = blockIdx.x * 32;

  auto issue = [&](int slot, int ki) {
    unsigned char* dw = ring + slot * stage;
    float* ds = reinterpret_cast<float*>(dw + bkr * 32);
    for (int i = threadIdx.x; i < bkr * 2; i += THREADS) {
      const int r = i / 2, c = (i % 2) * 16;
      cp_async16(dw + r * 32 + c, w + (size_t)(ki * bkr + r) * N + n0 + c);
    }
    for (int i = threadIdx.x; i < nbs * 8; i += THREADS) {
      const int r = i / 8, c = (i % 8) * 4;
      cp_async16(ds + r * 32 + c, s + (size_t)(ki * nbs + r) * N + n0 + c);
    }
    cp_async_commit();
  };

  issue(0, 0);
  stage_x(x, xs, bsum, M, K, 0, K);  // while the first tiles land
  float acc[MAX_M];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) acc[m] = 0.f;
  const int XB = K / BLK;
  for (int ki = 0; ki < nk; ++ki) {
    const int slot = ki & 1;
    if (ki + 1 < nk) {
      issue(slot ^ 1, ki + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* tw = reinterpret_cast<const int8_t*>(ring + slot * stage);
    const float* ts = reinterpret_cast<const float*>(ring + slot * stage + bkr * 32);
    const int k0 = ki * bk;
    for (int g = ty; g < bkr / 32; g += WARPS) {
      float ph[MAX_M], pl[MAX_M];
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) ph[m] = pl[m] = 0.f;
      for (int j = 0; j < 32; ++j) {
        const int b = tw[(32 * g + j) * 32 + tx];
        const float hi = nib_hi(b), lo = nib_lo(b);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m)
          if (m < M) {
            ph[m] += __bfloat162float(xs[m * K + k0 + GROUP * g + j]) * hi;
            pl[m] += __bfloat162float(xs[m * K + k0 + GROUP * g + 32 + j]) * lo;
          }
      }
      const float sh = ts[(2 * g) * 32 + tx], sl = ts[(2 * g + 1) * 32 + tx];
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) {
        if (m >= M) break;
        acc[m] += (ph[m] - 7.f * bsum[m * XB + k0 / BLK + 2 * g]) * sh;
        acc[m] += (pl[m] - 7.f * bsum[m * XB + k0 / BLK + 2 * g + 1]) * sl;
      }
    }
    __syncthreads();  // the slot is refilled next step
  }
  finish(acc, red, out, M, N, n0 + tx, true);
}

template <int V>
int launch(dim3 grid, int smem, int vmem, cudaStream_t st, const bf16* x,
           const int8_t* w, const float* s, float* out, int M, int K, int N, int bn,
           int bk, int tiled, int xfull) {
  if (vmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_kernel<V><<<grid, THREADS, smem, st>>>(x, w, s, out, M, K, N, bn, bk, tiled,
                                               xfull, 0);
  return 0;
}

template <int... Vs>
struct Dispatch;

template <>
struct Dispatch<> {
  template <class... A>
  static int run(int, A...) { return (int)cudaErrorInvalidValue; }
};

template <int V, int... Vs>
struct Dispatch<V, Vs...> {
  template <class... A>
  static int run(int code, A... a) {
    return code == V ? launch<V>(a...) : Dispatch<Vs...>::run(code, a...);
  }
};

}  // namespace

extern "C" {

// variant: the index in VARIANTS (ops/kernels/kbench_sweep.py), 25 =
// manual. Requires 1 <= M <= 8, K % bk == 0, bk % 64 == 0, with tiled the
// [N/bn, .., bn] planes (N % bn == 0), for manual N % 32 == 0; smem is
// the launch's dynamic shared memory (kbench_sweep.smem_bytes).
int kbench_sweep(const void* x, const void* w, const void* s, void* out,
                 int variant, int M, int K, int N, int bn, int bk, int tiled,
                 int xfull, int vmem, int smem, void* stream) {
  if (M < 1 || M > MAX_M || bk < GROUP || bk % GROUP || K % bk || N < 1 || bn < 1 ||
      (tiled && N % bn) || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto wb = static_cast<const int8_t*>(w);
  auto sb = static_cast<const float*>(s);
  auto ob = static_cast<float*>(out);
  const dim3 grid((N + 31) / 32);
  if (variant == MANUAL) {
    const int need = manual_ring_offset(M, K) + 2 * manual_stage_bytes(bk);
    if (N % 32 || smem < need) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_manual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sweep_manual_kernel<<<grid, THREADS, smem, st>>>(xb, wb, sb, ob, M, K, N, bk);
    return (int)cudaGetLastError();
  }
  const int W = xfull ? K : bk;
  if (smem < M * W * 2 + M * (W / BLK) * 4) return (int)cudaErrorInvalidValue;
  const int err = Dispatch<CUR, I8SHIFT, I16SHIFT, ILP4, TREE, FULLUNPACK, DQ,
                           CORRDOT, CORRDOTNM, DOT3, DOTSRAW, UNPACKONLY, BIASAND,
                           NOSUM, NOAND, DOTSONLY, G128, G128D2, G256, G256PRESUM,
                           G256DOTS, G256FMA1, DQBIAS, OVERLAP, STREAM>::
      run(variant, grid, smem, vmem, st, xb, wb, sb, ob, M, K, N, bn, bk, tiled,
          xfull);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
