// The kernel microbench's flash-attention ablations for Hopper (sm_90a):
// causal grouped-query attention of q bf16 [B, Kh, T*G, 64] (a token's G
// = 8 query heads flattened into rows, row r at position pos + r / 8)
// over int8 K/V [B, Kh, S, 64] with per-key f32 scales [B, Kh, S] (for
// flipTpre one interleaved [B, Kh, S, 2]), into f32 [B, Kh, T*G, 64], or
// [B, Kh, 64, T*G] for the flipT variants.
//
// Replaces body, body_flip and body_flip_pre of bench_flash in
// tools/kbench.py (pallas_call at lines 495 and 559): one template over
// the 11 variants (kbench_flash.VARIANTS). Each computes what its TPU
// body computes over the TPU tool's tiles: a 512-row query tile visits
// the 512-key tiles s with s * 512 <= pos + (its last row) / 8, and the
// running max moves once a key tile, so the ablations (noexp, nomask,
// nomax, nosum, dots), wrong by design, give the TPU's values.
// Bound: full's QK^T and PV products, 4 * 64 operations a visible (query,
// key) pair, over the bf16 tensor-core rate; stream's bytes.
//
// Design: a block per (batch row, kv head, 32 query rows) and 8 warps.
// Each visited key tile is staged whole in shared memory, K as bf16
// (exact from int8; the flipT variants fold the scales in first and
// round), then Q K^T for the 32 x 512 scores on nvcuda::wmma bf16 tensor
// cores into f32; a warp a row takes the tile's max, exp and sum, and
// writes the bf16 probabilities over its scores; V is staged over K and
// P V runs on the tensor cores again; the f32 accumulator lives in
// registers, 8 values a thread, rescaled by the row's alpha. stream reads
// every visited K, V and (all heads') scale tile, as the TPU's BlockSpecs
// bring them in, folds the words into a value stored only under a flag
// never set, and writes zeros (the TPU body's final acc / max(l, 1) of an
// untouched accumulator). ~154 KB of shared memory: one block an SM.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int D = 64;
constexpr int G = 8;
constexpr int BTG = 512;    // the TPU tool's query tile
constexpr int BS = 512;     // and key tile
constexpr int QR = 32;      // query rows a block
constexpr int T_LD = D + 8;         // bf16 row stride of Q and the K/V tile
constexpr int S_LD = BS + 4;        // f32 row stride of the scores
constexpr int P_LD = 2 * S_LD;      // bf16 probabilities over the scores
constexpr int O_LD = D + 4;         // f32 row stride of the PV rows
// -0.7 * FLT_MAX computed in double and rounded once, as the TPU tool's
// Python constant becomes an f32 operand
constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

enum { FULL, NOEXP, NOMASK, NOMAX, NOSUM, DOTS, STREAM, FLIPT, FLIPTTR,
       FLIPTNOSCALE, FLIPTPRE };

constexpr int SMEM_Q = QR * T_LD * 2;
constexpr int SMEM_KV = BS * T_LD * 2;
constexpr int SMEM_S = QR * S_LD * 4;
constexpr int SMEM_O = QR * O_LD * 4;
constexpr int SMEM_BYTES = SMEM_Q + SMEM_KV + SMEM_S + SMEM_O + 2 * BS * 4 + 3 * QR * 4;

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 int8 values of a row -> bf16, scaled by `scale` first when `scaled`
__device__ inline void stage16(const int8_t* src, bf16* dst, bool scaled, float scale) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float f = (float)v[i];
    o[i] = __float2bfloat16(scaled ? f * scale : f);
  }
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(o)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(o)[1];
}

template <int V>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kc,
             const int8_t* __restrict__ vc, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ pos,
             float* __restrict__ out, int Kh, int TG, int S, int never) {
  using namespace nvcuda;
  constexpr bool FLIP = V >= FLIPT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = reinterpret_cast<bf16*>(smem + SMEM_Q);
  float* Ss = reinterpret_cast<float*>(smem + SMEM_Q + SMEM_KV);
  bf16* Ps = reinterpret_cast<bf16*>(Ss);
  float* Os = reinterpret_cast<float*>(smem + SMEM_Q + SMEM_KV + SMEM_S);
  float* ksm = Os + QR * O_LD;
  float* vsm = ksm + BS;
  float* m_s = vsm + BS;
  float* l_s = m_s + QR;
  float* a_s = l_s + QR;

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * QR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = pos[b];
  const size_t bh = (size_t)b * Kh + h;
  const int8_t* kb = kc + bh * S * D;
  const int8_t* vb = vc + bh * S * D;
  // the scales of this head: [S] planes, or [S, 2] interleaved (flipTpre)
  const int sstep = V == FLIPTPRE ? 2 : 1;
  const float* kscale = V == FLIPTPRE ? ksc + bh * S * 2 : ksc + bh * S;
  const float* vscale = V == FLIPTPRE ? ksc + bh * S * 2 + 1 : vsc + bh * S;

  for (int i = threadIdx.x; i < QR * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * T_LD + c]) =
        *reinterpret_cast<const uint4*>(q + (bh * TG + r0 + r) * D + c);
  }
  if (threadIdx.x < QR) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  const int orow = threadIdx.x / 8, ocol = (threadIdx.x % 8) * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  // the TPU query tile's frontier decides which key tiles are visited
  const int t_max = p0 + ((r0 / BTG) * BTG + BTG - 1) / G;
  const int n_tiles = min(S / BS, t_max / BS + 1);
  uint32_t sink = 0;

  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * BS;
    if constexpr (V == STREAM) {
      for (int i = threadIdx.x; i < BS * D / 16; i += THREADS) {
        const int4 kw = reinterpret_cast<const int4*>(kb + (size_t)s0 * D)[i];
        const int4 vw = reinterpret_cast<const int4*>(vb + (size_t)s0 * D)[i];
        sink ^= (uint32_t)(kw.x ^ kw.y ^ kw.z ^ kw.w ^ vw.x ^ vw.y ^ vw.z ^ vw.w);
      }
      for (int i = threadIdx.x; i < Kh * BS; i += THREADS) {
        const size_t si = ((size_t)b * Kh + i / BS) * S + s0 + i % BS;
        sink ^= __float_as_uint(ksc[si]) ^ __float_as_uint(vsc[si]);
      }
      continue;
    }
    __syncthreads();
    // K tile (and the scales the non-flip scores need)
    for (int i = threadIdx.x; i < BS * (D / 16); i += THREADS) {
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      float sc = 1.f;
      if constexpr (V == FLIPT) sc = round_bf16(kscale[(size_t)(s0 + r) * sstep]);
      if constexpr (V == FLIPTTR || V == FLIPTPRE) sc = kscale[(size_t)(s0 + r) * sstep];
      stage16(kb + (size_t)(s0 + r) * D + c, KV + r * T_LD + c,
              FLIP && V != FLIPTNOSCALE, sc);
    }
    if constexpr (!FLIP) {
      for (int j = threadIdx.x; j < BS; j += THREADS) {
        ksm[j] = kscale[s0 + j];
        vsm[j] = vscale[s0 + j];
      }
    }
    __syncthreads();

    // scores: the 32 x 512 Q K^T, a warp 16 rows x 128 keys
    {
      const int rt = warp / 4, kt0 = (warp % 4) * 8;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(a[kk], Qs + rt * 16 * T_LD + kk * 16, T_LD);
      for (int kt = kt0; kt < kt0 + 8; ++kt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, KV + kt * 16 * T_LD + kk * 16, T_LD);
          wmma::mma_sync(c, a[kk], bk, c);
        }
        wmma::store_matrix_sync(Ss + rt * 16 * S_LD + kt * 16, c, S_LD,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // the online step of the TPU body: a warp a row, 16 keys a lane
    for (int r = warp; r < QR; r += THREADS / 32) {
      const int t_abs = p0 + (r0 + r) / G;
      float s[BS / 32];
#pragma unroll
      for (int i = 0; i < BS / 32; ++i) {
        const int j = lane + 32 * i;
        float v = Ss[r * S_LD + j] * 0.125f;
        if constexpr (!FLIP) v = v * ksm[j];
        if constexpr (V != DOTS && V != NOMASK)
          if (s0 + j > t_abs) v = NEG_INF;
        s[i] = v;
      }
      __syncwarp();
      const float m_old = m_s[r];
      float m_new = 0.f, alpha = 1.f;
      if constexpr (V != DOTS && V != NOMAX) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < BS / 32; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
        for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        m_new = fmaxf(m_old, mx);
        alpha = expf(m_old - m_new);
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BS / 32; ++i) {
        float p = s[i];
        if constexpr (V == NOEXP) p = (s[i] - m_new) * 0.5f;
        else if constexpr (V != DOTS) p = expf(s[i] - m_new);
        sum += p;
        if constexpr (!FLIP && V != DOTS) p = p * vsm[lane + 32 * i];
        Ps[r * P_LD + lane + 32 * i] = __float2bfloat16(p);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        if constexpr (V != DOTS) {
          m_s[r] = m_new;
          if constexpr (V != NOSUM) l_s[r] = l_s[r] * alpha + sum;
        }
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // V tile over K
    for (int i = threadIdx.x; i < BS * (D / 16); i += THREADS) {
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      float sc = 1.f;
      if constexpr (V == FLIPT) sc = round_bf16(vscale[(size_t)(s0 + r) * sstep]);
      if constexpr (V == FLIPTTR || V == FLIPTPRE) sc = vscale[(size_t)(s0 + r) * sstep];
      stage16(vb + (size_t)(s0 + r) * D + c, KV + r * T_LD + c,
              FLIP && V != FLIPTNOSCALE, sc);
    }
    __syncthreads();

    // P V: 32 x 64, a warp one 16 x 16 tile over the 512 keys
    {
      const int rt = warp / 4, ct = warp % 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < BS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + rt * 16 * P_LD + kk, P_LD);
        wmma::load_matrix_sync(bv, KV + kk * T_LD + ct * 16, T_LD);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(Os + rt * 16 * O_LD + ct * 16, c, O_LD,
                              wmma::mem_row_major);
    }
    __syncthreads();
    const float al = a_s[orow];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] * al + Os[orow * O_LD + ocol + i];
  }

  // out = acc / max(l, 1), NaN kept as jnp.maximum keeps it
  const float l = l_s[orow];
  const float den = l != l ? l : fmaxf(l, 1.f);
  float res[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) res[i] = V == STREAM ? 0.f : acc[i] / den;
  if constexpr (V == STREAM) {
    if (never) out[0] = __uint_as_float(sink);
  }
  if constexpr (FLIP) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) Os[orow * O_LD + ocol + i] = res[i];
    __syncthreads();
    for (int i = threadIdx.x; i < QR * D; i += THREADS) {
      const int c = i / QR, r = i % QR;
      out[(bh * D + c) * TG + r0 + r] = Os[r * O_LD + c];
    }
  } else {
    float4* dst = reinterpret_cast<float4*>(out + (bh * TG + r0 + orow) * D + ocol);
    dst[0] = make_float4(res[0], res[1], res[2], res[3]);
    dst[1] = make_float4(res[4], res[5], res[6], res[7]);
  }
}

template <int V>
int launch(dim3 grid, cudaStream_t st, const bf16* q, const int8_t* k,
           const int8_t* v, const float* ks, const float* vs, const int* pos,
           float* out, int Kh, int TG, int S) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  flash_kernel<V><<<grid, THREADS, SMEM_BYTES, st>>>(q, k, v, ks, vs, pos, out, Kh,
                                                     TG, S, 0);
  return 0;
}

}  // namespace

extern "C" {

// variant: the index in kbench_flash.VARIANTS. q bf16 [B, Kh, TG, 64],
// k/v int8 [B, Kh, S, 64], ks/vs f32 [B, Kh, S] (flipTpre: ks the
// interleaved [B, Kh, S, 2], vs unused), pos int32 [B]. Requires TG % 512
// == 0 and S % 512 == 0.
int kbench_flash(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, void* out, int variant, int B,
                 int Kh, int TG, int S, void* stream) {
  if (B < 1 || Kh < 1 || TG < BTG || TG % BTG || S < BS || S % BS)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(TG / QR, Kh, B);
  auto qb = static_cast<const bf16*>(q);
  auto kb = static_cast<const int8_t*>(k);
  auto vb = static_cast<const int8_t*>(v);
  auto ksb = static_cast<const float*>(ks);
  auto vsb = static_cast<const float*>(vs);
  auto pb = static_cast<const int*>(pos);
  auto ob = static_cast<float*>(out);
  int err;
  switch (variant) {
#define KF_CASE(V) \
  case V: err = launch<V>(grid, st, qb, kb, vb, ksb, vsb, pb, ob, Kh, TG, S); break;
    KF_CASE(FULL) KF_CASE(NOEXP) KF_CASE(NOMASK) KF_CASE(NOMAX) KF_CASE(NOSUM)
    KF_CASE(DOTS) KF_CASE(STREAM) KF_CASE(FLIPT) KF_CASE(FLIPTTR)
    KF_CASE(FLIPTNOSCALE) KF_CASE(FLIPTPRE)
#undef KF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
