// Causal grouped-query attention of new tokens over the stacked KV cache
// for Hopper (sm_90a), bf16 queries, a bf16, f16, f32 or int8 cache
// (kvkind.cuh: int8 with f32 scales [L, B, Kh, S]), f32 softmax and
// accumulation, at head dim D = 32 (the tiny configurations), 64
// (TinyLlama) or 128 (Llama-3), a template parameter.
//
// The cache is [L, B, Kh, S, d] with the new tokens' k/v already written;
// the layer and the positions are read from device memory, so no layer
// is sliced and a prefill stays capturable. Head h attends kv head h / G
// (G = H / Kh). Scores are scaled by 1/sqrt(d); a key at cache position s
// is visible to a query at absolute position p iff s <= p. Probabilities
// feed the weighted sum of V as bf16, the normalizer sums them in f32,
// and the output is acc / l, as in the TPU kernels (online_softmax.cuh
// holds what the attention kernels' recurrences share).
//
// K3 flash_prefill replaces _flash_attn_kernel in
//   tinyllama_tpu/ops/pallas/flash_prefill.py. Bound: the QK^T and PV
//   products, 4 d operations a visible (query, key) pair, over the bf16
//   tensor-core rate (at T = 512 about 100 operations a cache byte read,
//   at T = 2,048 about 400). Design, FlashAttention-3 style:
//   * one block, one warpgroup, per (batch row, kv head, 64 query rows),
//     where rows flatten (token, group member) so a token's G heads share
//     every K/V tile, as the TPU kernel's rows do; row blocks run in
//     reverse, so the longest causal walks start first and the tail of
//     the grid is short walks;
//   * S = Q K^T as D / 16 wgmma.m64n64k16 from shared memory (Q loaded
//     once). A bf16 tile of 64 rows is DP / 64 column blocks of 64 values
//     (DP = max(D, 64)), each 64 rows of 128 bytes under the 128-byte
//     swizzle (8 KB, the swizzle's atom column), the second 8 KB after the
//     first: at D = 128 a row's 256 bytes span both and k16 steps 4..7
//     start one block on. At D = 32 a row is padded to 64 values in
//     shared memory only (the cache is read as it lies): its 4 chunks are
//     chunks 0-3 of the 128-byte row, S takes the 2 k16 steps over them
//     and never reads the other 4, and P V runs one m64n64 product whose
//     columns 32-63 (from the unwritten half of V's rows) are dropped, so
//     nothing there reaches the output and nothing is zeroed;
//     The online softmax runs on the accumulator registers, each thread
//     holding 16 scores of each of two rows, their max and sum two quad
//     shuffles; the bf16 probabilities are the A operand of the P V
//     wgmmas from registers (one m64n64 a column block of V, so the
//     output takes D / 2 f32 registers a thread beside the scores' 32), V
//     the MN-major B operand in shared memory;
//   * an asynchronous ring of key tiles (3 stages; 2 for f32, and for
//     bf16 at D = 128, where a third would leave one block an SM): 16-byte
//     cp.async copies that arrive on the stage's mbarrier, so tiles j + 1
//     and j + 2 land while tile j is computed. A bf16 tile lands swizzled
//     and is used as it lands; an int8, f16 or f32 tile lands raw and the
//     block converts it once into a bf16 K and V tile (int8 as (k * ks)
//     rounded to bf16, as the TPU kernel dequantizes; f16 and f32 rounded
//     to nearest even);
//   * causal work only: tiles above the block's last row are neither
//     loaded nor computed, and only tiles that cross the diagonal are
//     masked.
//   Shared memory at D = 64: 57 KB (bf16), 52 KB (int8), 73 KB (f16),
//   89 KB (f32), so at least two blocks an SM; at D = 128: 81 KB (bf16),
//   100 KB (int8), two blocks an SM; 145 KB (f16), 177 KB (f32), one; at
//   D = 32: 57 KB (bf16; the padded tiles), 40 KB (int8), 49 KB (f16),
//   57 KB (f32).
//
// K4 flash_decode_heads (T = 1), which replaces _decode_heads_kernel of
//   the same file, shares one split-key template with K10 in
//   decode_split.cu.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "kvkind.cuh"
#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int PF_THREADS = 128;  // one warpgroup
constexpr int PF_BR = 64;        // query rows a block
constexpr int PF_BS = 64;        // keys a tile
constexpr int ATOM = 64 * 128;   // a 64-row column block of 64 bf16 values

// The ring for a KV element type at head dim D: NS stages, each the K and
// V tiles of PF_BS rows (bf16: swizzled at the padded width DP, read by
// the products as they are; else raw), then (int8) the tile's key and
// value scales.
template <class KV, int D>
struct PfTile {
  static_assert(D == 32 || D == 64 || D == 128, "the kernel's head dims");
  static constexpr bool I8 = kvkind::is_i8<KV>;
  static constexpr bool RAW = !std::is_same<KV, bf16>::value;
  static constexpr int DP = D < 64 ? 64 : D;       // a bf16 tile's row
  static constexpr int BF_TILE = PF_BS * DP * 2;   // a bf16 Q, K or V tile
  static constexpr int ROW = D * (int)sizeof(KV);  // bytes of a raw row
  static constexpr int BYTES = PF_BS * ROW;        // a raw K or V tile
  static constexpr int PLANE = RAW ? BYTES : BF_TILE;  // K's or V's in a stage
  static constexpr int STAGE = (2 * PLANE + (I8 ? 2 * PF_BS * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int NS = sizeof(KV) == 4 || (D == 128 && !RAW) ? 2 : 3;
  // Q, the converted K and V (not bf16), the ring, its barriers, slack
  // for the 1024-byte alignment
  static constexpr int SMEM = BF_TILE + (RAW ? 2 * BF_TILE : 0) + NS * STAGE + 8 * NS + 1024;
};

// Byte offset of 16-byte chunk c (of D / 8) of row r in a 64-row bf16
// tile: column block c / 8, then the 128-byte swizzle inside it.
__device__ inline int tswz(int r, int c) {
  return (c >> 3) * ATOM + hopper::swz(r, c & 7);
}

template <class KV>
struct PfArgs {
  const bf16* q;
  const KV* k;
  const KV* v;
  const float* ks;
  const float* vs;
  const int* layer;
  const int* pos;
  bf16* out;
  int T, H, Kh, S, G;
  size_t layer_stride;  // elements of one layer of a plane
};

// Issue the copies of key tile jt of the slab at kv_off into a ring slot.
template <int D, class KV>
__device__ inline void pf_issue(const PfArgs<KV>& a, size_t kv_off, int jt,
                                unsigned char* slot) {
  using T = PfTile<KV, D>;
  const unsigned char* kg =
      reinterpret_cast<const unsigned char*>(a.k + kv_off + (size_t)jt * PF_BS * D);
  const unsigned char* vg =
      reinterpret_cast<const unsigned char*>(a.v + kv_off + (size_t)jt * PF_BS * D);
  constexpr int CHUNKS = T::BYTES / 16;  // of one plane
#pragma unroll 4
  for (int u = threadIdx.x; u < 2 * CHUNKS; u += PF_THREADS) {
    const int plane = u / CHUNKS, o = u % CHUNKS;
    const unsigned char* src = (plane ? vg : kg) + o * 16;
    unsigned char* dst = slot + plane * T::PLANE;
    hopper::cp_async16(T::RAW ? dst + o * 16 : dst + tswz(o / (D / 8), o % (D / 8)), src);
  }
  if constexpr (T::I8) {
    if (threadIdx.x < 2 * PF_BS / 4) {  // 16 chunks of f32 scales a plane
      const int plane = threadIdx.x / (PF_BS / 4), o = threadIdx.x % (PF_BS / 4);
      const float* src = (plane ? a.vs : a.ks) + kv_off / D + (size_t)jt * PF_BS + o * 4;
      hopper::cp_async16(slot + 2 * T::PLANE + plane * PF_BS * 4 + o * 16, src);
    }
  }
}

// A landed raw tile to the bf16 K and V tiles (swizzled), once a block.
template <int D, class KV>
__device__ inline void pf_convert(const unsigned char* slot, unsigned char* kb,
                                  unsigned char* vb) {
  using T = PfTile<KV, D>;
  constexpr int CR = D / 8;  // 8-value chunks a row
  const float* sc = reinterpret_cast<const float*>(slot + 2 * T::PLANE);
#pragma unroll 4
  for (int u = threadIdx.x; u < 2 * PF_BS * CR; u += PF_THREADS) {
    const int plane = u / (PF_BS * CR), r = (u / CR) % PF_BS, c = u % CR;
    const KV* src = reinterpret_cast<const KV*>(slot + plane * T::BYTES + r * T::ROW) + 8 * c;
    uint4 val;
    if constexpr (T::I8)
      val = kvkind::load8_scaled(src, sc[plane * PF_BS + r]);
    else
      val = kvkind::load8(src);
    *reinterpret_cast<uint4*>((plane ? vb : kb) + tswz(r, c)) = val;
  }
}

template <int D, class KV>
__global__ void __launch_bounds__(PF_THREADS, 2) flash_prefill_kernel(const PfArgs<KV> a) {
  using T = PfTile<KV, D>;
  constexpr int BF_TILE = T::BF_TILE;
  constexpr int NB = T::DP / 64;  // column blocks of 64 values
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* qs = smem;                                  // Q, swizzled
  unsigned char* cvt = smem + BF_TILE;                       // bf16 K, V
  unsigned char* ring = cvt + (T::RAW ? 2 * BF_TILE : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::NS * T::STAGE);

  const int b = blockIdx.z, kh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * PF_BR;  // longest walks first
  const int G = a.G, TG = a.T * G;
  const int p0 = a.pos[b];
  const size_t kv_off = (size_t)a.layer[0] * a.layer_stride + ((size_t)b * a.Kh + kh) * a.S * D;
  const int r_last = min(r0 + PF_BR, TG) - 1;
  const int n_tiles = (p0 + r_last / G) / PF_BS + 1;  // causal frontier
  const int q_first = p0 + r0 / G;                    // the block's first row

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < T::NS; ++i) hopper::mbar_init(&full[i], PF_THREADS);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Q rows r -> token (r0 + r) / G, head kh * G + (r0 + r) % G; rows past
  // TG are zeros. Its copies arrive with tile 0's.
#pragma unroll
  for (int i = 0; i < PF_BR * (D / 8) / PF_THREADS; ++i) {
    const int u = threadIdx.x + i * PF_THREADS, r = u / (D / 8), c = u % (D / 8);
    const int rr = r0 + r;
    const bool in = rr < TG;
    const bf16* src = in ? a.q + (((size_t)b * a.T + rr / G) * a.H + kh * G + rr % G) * D + c * 8
                         : a.q;
    hopper::cp_async16(qs + tswz(r, c), src, in ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < T::NS - 1; ++i) {
    if (i < n_tiles) {
      pf_issue<D>(a, kv_off, i, ring + i * T::STAGE);
      hopper::cp_async_arrive(&full[i]);
    }
  }

  // Each thread: rows 16 w + l / 4 and that + 8 of the block, their query
  // positions (padding rows take the last real row's)
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = p0 + min(r0 + 16 * w + lane / 4 + 8 * i, TG - 1) / G;
  // scores in log2 units: exp(x / sqrt(d)) = 2^(x log2(e) / sqrt(d))
  const float scale = 1.4426950408889634f / sqrtf((float)D);
  float m[2] = {TL_NEG_INF, TL_NEG_INF}, l[2] = {0.f, 0.f};
  float o[NB][32];  // the output, a column block of 64 dims each
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  const uint32_t q_addr = hopper::smem_u32(qs);

  for (int j = 0; j < n_tiles; ++j) {
    const int nx = j + T::NS - 1;  // into the slot that tile j - 1 freed
    if (nx < n_tiles) {
      pf_issue<D>(a, kv_off, nx, ring + (nx % T::NS) * T::STAGE);
      hopper::cp_async_arrive(&full[nx % T::NS]);
    }
    unsigned char* slot = ring + (j % T::NS) * T::STAGE;
    hopper::mbar_wait(&full[j % T::NS], (j / T::NS) & 1);
    unsigned char *kt = slot, *vt = slot + BF_TILE;
    if constexpr (T::RAW) {
      pf_convert<D, KV>(slot, cvt, cvt + BF_TILE);
      kt = cvt;
      vt = cvt + BF_TILE;
      hopper::fence_proxy_async();
      __syncthreads();
    } else {
      hopper::fence_proxy_async();
    }

    // S = Q K^T over d: D / 16 k16 steps of 32 bytes along the rows, the
    // fifth on in the next column block (D = 32: the padded rows' first 2)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_addr = hopper::smem_u32(kt);
    hopper::reg_fence(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      hopper::wgmma_m64n64_ss(s, hopper::desc_k(q_addr + off),
                              hopper::desc_k(k_addr + off));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::reg_fence(s);

    // online softmax on the registers: s[4 c + 2 i + e] is row i's key
    // j * 64 + 8 c + 2 (lane % 4) + e
    const bool masked = j * PF_BS + PF_BS - 1 > q_first;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = TL_NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * c + 2 * i + e];
          x *= scale;
          if (masked && j * PF_BS + 8 * c + 2 * (lane % 4) + e > qpos[i]) x = -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * c + 2 * i + e];
          x = exp2f(x - m_new);  // a masked key: exp2(-inf) = 0
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          o[h][4 * c + 2 * i] *= alpha;
          o[h][4 * c + 2 * i + 1] *= alpha;
        }
    }
    // the bf16 probabilities as the A operand: keys 16 kk .. 16 kk + 15
    uint32_t p[PF_BS / 16][4];
#pragma unroll
    for (int kk = 0; kk < PF_BS / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        p[kk][h] = hopper::pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);

    // O += P V, V MN-major: k16 steps of 16 key rows (2048 bytes), one
    // m64n64 product a column block of V's dims
    const uint32_t v_addr = hopper::smem_u32(vt);
#pragma unroll
    for (int h = 0; h < NB; ++h) hopper::reg_fence(o[h]);
    hopper::wgmma_fence();
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int kk = 0; kk < PF_BS / 16; ++kk)
        hopper::wgmma_m64n64_rs_mn(o[h], p[kk],
                                   hopper::desc_mn(v_addr + h * ATOM + kk * 2048, BF_TILE));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
#pragma unroll
    for (int h = 0; h < NB; ++h) hopper::reg_fence(o[h]);
    hopper::reg_fence(p);
    __syncthreads();  // the slot (and converted tiles) are free
  }

  // o[h][4 c + 2 i + e]: row i, dim 64 h + 8 c + 2 (lane % 4) + e (dims
  // past D, the padding's, dropped)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r0 + 16 * w + lane / 4 + 8 * i;
    if (rr >= TG) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    bf16* op = a.out + (((size_t)b * a.T + rr / G) * a.H + kh * G + rr % G) * D + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int c = 0; c < (D < 64 ? D / 8 : 8); ++c)
        *reinterpret_cast<uint32_t*>(op + 64 * h + 8 * c) =
            hopper::pack_bf16(o[h][4 * c + 2 * i] / den, o[h][4 * c + 2 * i + 1] / den);
  }
}

template <int D, class KV>
int launch_prefill(const PfArgs<KV>& a, int B, cudaStream_t st) {
  constexpr int SMEM = PfTile<KV, D>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.T * a.G + PF_BR - 1) / PF_BR, a.Kh, B);
  flash_prefill_kernel<D, KV><<<grid, PF_THREADS, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [B, T, H, d] bf16; k, v: [L, B, Kh, S, d] of the KV kind
// (kvkind.cuh: 0 bf16, 1 int8, 2 f16, 3 f32); ks, vs: [L, B, Kh, S] f32
// scales (int8, 16-byte aligned; null for the others); layer: [1]; pos:
// [B]. Requires d in {32, 64, 128}, H % Kh == 0 and S % 64 == 0; pos[b]
// + T <= S.
int flash_prefill(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* layer, const void* pos, void* out,
                  int kv_kind, int B, int T, int H, int Kh, int S, int d,
                  void* stream) {
  if (!kvkind::valid(kv_kind) || (d != 32 && d != 64 && d != 128) || Kh < 1 || H % Kh ||
      S % PF_BS ||
      T < 1 || B < 1 || B > 65535 || Kh > 65535)
    return (int)cudaErrorInvalidValue;
  return kvkind::with_type(kv_kind, [&](auto tag) {
    using KV = decltype(tag);
    const PfArgs<KV> a{static_cast<const bf16*>(q), static_cast<const KV*>(k),
                       static_cast<const KV*>(v), static_cast<const float*>(ks),
                       static_cast<const float*>(vs), static_cast<const int*>(layer),
                       static_cast<const int*>(pos), static_cast<bf16*>(out),
                       T, H, Kh, S, H / Kh, (size_t)B * Kh * S * d};
    auto st = static_cast<cudaStream_t>(stream);
    if (d == 32) return launch_prefill<32, KV>(a, B, st);
    return d == 64 ? launch_prefill<64, KV>(a, B, st) : launch_prefill<128, KV>(a, B, st);
  });
}

}  // extern "C"
