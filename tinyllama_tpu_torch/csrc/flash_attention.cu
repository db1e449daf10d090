// Causal grouped-query attention over the stacked KV cache for Hopper
// (sm_90a), bf16 queries and cache, f32 softmax and accumulation.
//
// The cache is [L, B, Kh, S, d] with the new tokens' k/v already written;
// the layer and the positions are read from device memory, so no layer
// is sliced and a decode step stays capturable. Head h attends kv head
// h / G (G = H / Kh). Scores are scaled by 1/sqrt(d); a key at cache
// position s is visible to a query at absolute position p iff s <= p.
// Probabilities feed the weighted sum of V as bf16, the normalizer sums
// them in f32, and the output is acc / l, as in the TPU kernels. The
// (m, l, acc) step is online_softmax_update (online_softmax.cuh).
//
// K3 flash_prefill replaces _flash_attn_kernel in
//   tinyllama_tpu/ops/pallas/flash_prefill.py. Bound: at prefill the
//   QK^T and PV products (4*d operations per visible (query, key) pair)
//   over the bf16 tensor-core rate. Design: one block per (batch row, kv
//   head, 64 query rows), where query rows flatten (token, group member)
//   so the G query heads of a token share every K/V tile, as the TPU
//   kernel's flattened rows do. The block walks 64-key tiles only up to
//   the causal frontier of its last row: tiles above the diagonal are
//   neither loaded nor computed. Both products run on nvcuda::wmma bf16
//   tensor cores; each warp owns 16 rows through scores, softmax and PV,
//   so only the tile loads synchronize the block.
//
// K4 flash_decode_heads replaces _decode_heads_kernel (same file). Bound:
//   the bytes of the pos+1 cached keys and values over the memory rate.
//   Design: one block per (batch row, kv head) with one warp per query
//   head of the group; the block walks ceil((pos+1)/64) key tiles and
//   stops there. Scores and PV are warp-level f32 dot products from
//   shared memory (K rows padded so a lane per key hits its own bank).
//   At batch 1 this fills Kh blocks of the 132 SMs: splitting the key
//   walk across blocks is the kernel's later work.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64;  // head dim taken by both kernels

__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------- K3 ----

constexpr int PF_THREADS = 128;    // 4 warps x 16 query rows
constexpr int PF_BR = 64;          // query rows per block
constexpr int PF_BS = 64;          // keys per tile
constexpr int T_LD = D + 8;        // bf16 row stride of the Q/K/V tiles
constexpr int S_LD = PF_BS + 4;    // f32 row stride of scores and PV rows
constexpr int P_LD = 2 * S_LD;     // bf16 probabilities over the score rows
static_assert(S_LD >= D + 4, "PV rows reuse the score rows");

__global__ void __launch_bounds__(PF_THREADS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                     const bf16* __restrict__ vc, const int* __restrict__ layer,
                     const int* __restrict__ pos, bf16* __restrict__ out,
                     int T, int H, int Kh, int S, size_t layer_stride) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 Qs[PF_BR * T_LD];
  __shared__ __align__(32) bf16 Ks[PF_BS * T_LD];
  __shared__ __align__(32) bf16 Vs[PF_BS * T_LD];
  __shared__ __align__(32) float Ss[PF_BR * S_LD];
  __shared__ float m_s[PF_BR], l_s[PF_BR], a_s[PF_BR];

  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * PF_BR;
  const int G = H / Kh, TG = T * G;
  const int p0 = pos[b];
  const size_t kv_off =
      (size_t)layer[0] * layer_stride + ((size_t)b * Kh + kh) * S * D;
  const bf16* kb = kc + kv_off;
  const bf16* vb = vc + kv_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // query row r -> token r / G, head kh * G + r % G; rows past TG are 0
  for (int i = threadIdx.x; i < PF_BR * (D / 8); i += PF_THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, rr = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (rr < TG) {
      const int t = rr / G, h = kh * G + rr % G;
      v = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * H + h) * D + c);
    }
    *reinterpret_cast<uint4*>(&Qs[r * T_LD + c]) = v;
  }
  if (threadIdx.x < PF_BR) {
    m_s[threadIdx.x] = TL_NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }

  // each lane accumulates half of one output row
  const int orow = warp * 16 + lane / 2, ocol = (lane % 2) * (D / 2);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const float scale = 1.f / sqrtf((float)D);
  const int r_last = min(r0 + PF_BR, TG) - 1;
  const int n_tiles = (p0 + r_last / G) / PF_BS + 1;  // causal frontier
  float* Sw = Ss + warp * 16 * S_LD;
  bf16* Pw = reinterpret_cast<bf16*>(Sw);

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    for (int i = threadIdx.x; i < PF_BS * (D / 8); i += PF_THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const size_t g = (size_t)(j * PF_BS + r) * D + c;
      *reinterpret_cast<uint4*>(&Ks[r * T_LD + c]) =
          *reinterpret_cast<const uint4*>(kb + g);
      *reinterpret_cast<uint4*>(&Vs[r * T_LD + c]) =
          *reinterpret_cast<const uint4*>(vb + g);
    }
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys: Q K^T
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(a[kk], Qs + warp * 16 * T_LD + kk * 16, T_LD);
#pragma unroll
      for (int nt = 0; nt < PF_BS / 16; ++nt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + nt * 16 * T_LD + kk * 16, T_LD);
          wmma::mma_sync(c, a[kk], kf, c);
        }
        wmma::store_matrix_sync(Sw + nt * 16, c, S_LD, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax row by row; bf16 probabilities overwrite the row
    for (int i = 0; i < 16; ++i) {
      const int row = warp * 16 + i;
      const int qpos = p0 + min(r0 + row, TG - 1) / G;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = lane + 32 * e;
        s[e] = Sw[i * S_LD + key] * scale;
        ok[e] = j * PF_BS + key <= qpos;
      }
      float m = m_s[row], l = l_s[row];
      __syncwarp();
      const float alpha = online_softmax_update(s, ok, m, l);
      Pw[i * P_LD + lane] = __float2bfloat16(s[0]);
      Pw[i * P_LD + lane + 32] = __float2bfloat16(s[1]);
      if (lane == 0) {
        m_s[row] = m;
        l_s[row] = l;
        a_s[row] = alpha;
      }
    }
    __syncwarp();

    // this tile's P V for the warp's rows, then acc = acc * alpha + P V
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[PF_BS / 16];
#pragma unroll
      for (int kk = 0; kk < PF_BS / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], Pw + kk * 16, P_LD);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[D / 16];
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::fill_fragment(c[dt], 0.f);
#pragma unroll
        for (int kk = 0; kk < PF_BS / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + kk * 16 * T_LD + dt * 16, T_LD);
          wmma::mma_sync(c[dt], pa[kk], vf, c[dt]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
        wmma::store_matrix_sync(Sw + dt * 16, c[dt], S_LD, wmma::mem_row_major);
    }
    __syncwarp();
    const float alpha = a_s[orow];
    const float* pv = Ss + orow * S_LD + ocol;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = o[i] * alpha + pv[i];
  }

  const int rr = r0 + orow;
  if (rr < TG) {
    const float l = l_s[orow];
    const float den = l > 0.f ? l : 1.f;
    const int t = rr / G, h = kh * G + rr % G;
    bf16* op = out + (((size_t)b * T + t) * H + h) * D + ocol;
#pragma unroll
    for (int i = 0; i < D / 2; i += 8) {
      alignas(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(o[i + e] / den);
      *reinterpret_cast<uint4*>(op + i) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---------------------------------------------------------------- K4 ----

constexpr int DEC_BS = 64;     // keys per tile
constexpr int K_LD = D + 2;    // padded K rows: 33 words, a bank per key

template <int G>
__global__ void __launch_bounds__(G * 32)
flash_decode_heads_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                          const bf16* __restrict__ vc,
                          const int* __restrict__ layer,
                          const int* __restrict__ pos, bf16* __restrict__ out,
                          int Kh, int S, size_t layer_stride) {
  __shared__ __align__(16) bf16 Ks[DEC_BS * K_LD];
  __shared__ __align__(16) bf16 Vs[DEC_BS * D];
  __shared__ float qs[G][D];
  __shared__ float ps[G][DEC_BS];
  const int b = blockIdx.y, kh = blockIdx.x, H = Kh * G;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos[b];
  const size_t kv_off =
      (size_t)layer[0] * layer_stride + ((size_t)b * Kh + kh) * S * D;
  const bf16* kb = kc + kv_off;
  const bf16* vb = vc + kv_off;
  const size_t qo = ((size_t)b * H + kh * G + g) * D;
  qs[g][lane] = __bfloat162float(q[qo + lane]);
  qs[g][lane + 32] = __bfloat162float(q[qo + lane + 32]);

  float m = TL_NEG_INF, l = 0.f, o0 = 0.f, o1 = 0.f;  // dims 2*lane, 2*lane+1
  const float scale = 1.f / sqrtf((float)D);
  const int n_tiles = p / DEC_BS + 1;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < DEC_BS * (D / 8); i += G * 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const size_t gi = (size_t)(t * DEC_BS + r) * D + c;
      const uint4 kv = *reinterpret_cast<const uint4*>(kb + gi);
      uint32_t* kd = reinterpret_cast<uint32_t*>(&Ks[r * K_LD + c]);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(&Vs[r * D + c]) =
          *reinterpret_cast<const uint4*>(vb + gi);
    }
    __syncthreads();

    float s[2];
    bool ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = lane + 32 * e;
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(&Ks[key * K_LD]);
      float acc = 0.f;
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) {
        const float2 kf = __bfloat1622float2(kr[dd]);
        acc += qs[g][2 * dd] * kf.x + qs[g][2 * dd + 1] * kf.y;
      }
      s[e] = acc * scale;
      ok[e] = t * DEC_BS + key <= p;
    }
    const float alpha = online_softmax_update(s, ok, m, l);
    ps[g][lane] = round_bf16(s[0]);
    ps[g][lane + 32] = round_bf16(s[1]);
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    const __nv_bfloat162* vcol = reinterpret_cast<const __nv_bfloat162*>(Vs) + lane;
#pragma unroll 8
    for (int key = 0; key < DEC_BS; ++key) {
      const float pk = ps[g][key];
      const float2 vf = __bfloat1622float2(vcol[key * (D / 2)]);
      a0 += pk * vf.x;
      a1 += pk * vf.y;
    }
    o0 = o0 * alpha + a0;
    o1 = o1 * alpha + a1;
  }
  const float den = l > 0.f ? l : 1.f;
  reinterpret_cast<__nv_bfloat162*>(out + qo)[lane] =
      __floats2bfloat162_rn(o0 / den, o1 / den);
}

}  // namespace

extern "C" {

// q, out: [B, T, H, d]; k, v: [L, B, Kh, S, d]; layer: [1]; pos: [B].
// Requires d == 64, H % Kh == 0 and S % 64 == 0; pos[b] + T <= S.
int flash_prefill(const void* q, const void* k, const void* v, const void* layer,
                  const void* pos, void* out, int B, int T, int H, int Kh,
                  int S, int d, void* stream) {
  if (d != D || Kh < 1 || H % Kh || S % PF_BS || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int TG = T * (H / Kh);
  const dim3 grid((TG + PF_BR - 1) / PF_BR, Kh, B);
  flash_prefill_kernel<<<grid, PF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(layer),
      static_cast<const int*>(pos), static_cast<bf16*>(out), T, H, Kh, S,
      (size_t)B * Kh * S * D);
  return (int)cudaGetLastError();
}

// q, out: [B, 1, H, d]; k, v: [L, B, Kh, S, d]; layer: [1]; pos: [B].
// Requires d == 64, H / Kh in {4, 8} and S % 64 == 0; pos[b] < S.
int flash_decode_heads(const void* q, const void* k, const void* v,
                       const void* layer, const void* pos, void* out, int B,
                       int H, int Kh, int S, int d, void* stream) {
  if (d != D || Kh < 1 || H % Kh || S % DEC_BS || B < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Kh, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto qb = static_cast<const bf16*>(q);
  auto kb = static_cast<const bf16*>(k);
  auto vb = static_cast<const bf16*>(v);
  auto lb = static_cast<const int*>(layer);
  auto pb = static_cast<const int*>(pos);
  auto ob = static_cast<bf16*>(out);
  const size_t layer_stride = (size_t)B * Kh * S * D;
  switch (H / Kh) {
    case 4:
      flash_decode_heads_kernel<4><<<grid, 4 * 32, 0, st>>>(
          qb, kb, vb, lb, pb, ob, Kh, S, layer_stride);
      break;
    case 8:
      flash_decode_heads_kernel<8><<<grid, 8 * 32, 0, st>>>(
          qb, kb, vb, lb, pb, ob, Kh, S, layer_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
