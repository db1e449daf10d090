// Fused batch-1 decode attention + output projection + residual for
// Hopper (sm_90a), one launch:
//   out = residual + attention(q, cache layer, keys 0..pos) @ dequant(wo)
// q [H, 64] bf16 of the one new token; the stacked cache [L, 1, Kh, S,
// 64], bf16, f16, f32, or int8 with f32 scales [L, 1, Kh, S]
// (kvkind.cuh), with the token's k/v already written; wo the
// layer-stacked "kn" weight [L, H*64, N] (q8, or q4 / q4g as [L, H*32, N]
// nibble data; qkind.cuh); the layer index and pos read from device
// memory.
//
// K8 replaces the kernel of _run_attn_out in
//   tinyllama_tpu/ops/pallas/attn_out_fused.py. Bound: the bytes of wo
//   (4.46 MB at TinyLlama's 2048 x 2048 in q8, 2.36 MB in q4) plus the
//   visible keys and values, 1,024 * (pos + 1) bytes in bf16 and f16,
//   2,048 * (pos + 1) in f32 or 544 * (pos + 1) in int8 with its scales,
//   over the memory rate. Design: the TPU
//   kernel walks one sequential grid, the attention's online softmax into
//   VMEM scratch first, then wo's tiles against that scratch. On Hopper
//   the attention runs once per launch, not once per wo strip, and is
//   handed to the wo phase inside the launch, by two grid-wide barriers of
//   a cooperative launch:
//   - attention: one (kv head, 64-key tile) pair per block, grid-strided
//     over Kh * (pos/64 + 1) pairs, so the key walk is split across
//     blocks; one warp per query head of the group runs one step of
//     online_softmax.cuh on the tile and writes its partial (max, sum,
//     weighted V) to a global workspace;
//   - barrier; one warp per head merges its tiles' partials (rescaled to
//     the common max) and writes the head's result, rounded to bf16 as
//     the TPU kernel casts its scratch, to a [H * 64] workspace (4 KB);
//   - barrier; wo strips of qstrip.cuh at one row (exact dequantization, the
//     TPU's m = 1 blockdot) stage that result through L2 (__ldcg: written
//     by other SMs in this launch), and the residual joins the f32 sum.
//   The grid is capped at the blocks the card holds at once, counted for
//   each (bits, KV kind) instantiation. An int8 cache's rows are staged
//   as exact bf16 and its scales folded into each tile's scores and
//   probabilities (kvkind.cuh), so the merge and the wo phase are shared.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>

#include "kvkind.cuh"
#include "online_softmax.cuh"
#include "qstrip.cuh"

namespace {

using qstrip::bf16;
using qstrip::COLS;
using qstrip::THREADS;

constexpr int D = 64;                  // head dim
constexpr int TILE = 64;               // keys per tile
constexpr int K_LD = D + 2;            // padded K rows: a bank per key
constexpr int MAX_G = THREADS / 32;    // query heads per kv head
constexpr int PART = 2 + D;            // a tile's (max, sum, weighted V)

template <int BITS, class KV>
__global__ void __launch_bounds__(THREADS)
fused_attn_out_kernel(const bf16* __restrict__ q, const KV* __restrict__ kc,
                      const KV* __restrict__ vc, const float* __restrict__ ksc,
                      const float* __restrict__ vsc, const int* __restrict__ layer,
                      const int* __restrict__ pos, const uint8_t* __restrict__ w,
                      const __half* __restrict__ s, const bf16* __restrict__ res,
                      float* part, float* attn, bf16* __restrict__ out, int H,
                      int Kh, int S, int N, int sshift) {
  extern __shared__ __align__(128) float buf[];
  __shared__ __align__(16) bf16 Ks[TILE * K_LD];
  __shared__ __align__(16) bf16 Vs[TILE * D];
  __shared__ float qs[MAX_G][D];
  __shared__ float ps[MAX_G][TILE];
  __shared__ float kss[TILE], vss[TILE];  // int8: the tile's scales
  constexpr bool I8 = kvkind::is_i8<KV>;
  auto grid = cooperative_groups::this_grid();
  const int li = layer[0], p = pos[0];
  const int G = H / Kh, n_tiles = p / TILE + 1, t_max = S / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = 1.f / sqrtf((float)D);

  // attention: partial softmax of one (kv head, key tile) per step
  for (int it = blockIdx.x; it < Kh * n_tiles; it += gridDim.x) {
    const int kh = it / n_tiles, t = it % n_tiles;
    const size_t kv_off = ((size_t)li * Kh + kh) * S * D + (size_t)t * TILE * D;
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const uint4 kv = kvkind::load8(kc + kv_off + r * D + c);
      uint32_t* kd = reinterpret_cast<uint32_t*>(&Ks[r * K_LD + c]);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(&Vs[r * D + c]) =
          kvkind::load8(vc + kv_off + r * D + c);
    }
    if constexpr (I8) {  // THREADS >= 2 * TILE
      const int r = threadIdx.x % TILE;
      if (threadIdx.x < TILE) kss[r] = ksc[kv_off / D + r];
      else if (threadIdx.x < 2 * TILE) vss[r] = vsc[kv_off / D + r];
    }
    if (warp < G) {
      const bf16* qh = q + (size_t)(kh * G + warp) * D;
      qs[warp][lane] = __bfloat162float(qh[lane]);
      qs[warp][lane + 32] = __bfloat162float(qh[lane + 32]);
    }
    __syncthreads();
    if (warp < G) {
      float sc[2];
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
          acc += qs[warp][2 * dd] * kf.x + qs[warp][2 * dd + 1] * kf.y;
        }
        sc[e] = acc * scale;
        if constexpr (I8) sc[e] *= kss[key];
        ok[e] = t * TILE + key <= p;
      }
      float m = TL_NEG_INF, l = 0.f;
      online_softmax_update(sc, ok, m, l);
      ps[warp][lane] = qstrip::round_bf16(sc[0]);
      ps[warp][lane + 32] = qstrip::round_bf16(sc[1]);
      if constexpr (I8) {  // after l has summed them (kvkind.cuh)
        ps[warp][lane] *= vss[lane];
        ps[warp][lane + 32] *= vss[lane + 32];
      }
      __syncwarp();
      float a0 = 0.f, a1 = 0.f;
      const __nv_bfloat162* vcol = reinterpret_cast<const __nv_bfloat162*>(Vs) + lane;
#pragma unroll 8
      for (int key = 0; key < TILE; ++key) {
        const float pk = ps[warp][key];
        const float2 vf = __bfloat1622float2(vcol[key * (D / 2)]);
        a0 += pk * vf.x;
        a1 += pk * vf.y;
      }
      float* pp = part + (((size_t)kh * t_max + t) * G + warp) * PART;
      if (lane == 0) {
        pp[0] = m;
        pp[1] = l;
      }
      pp[2 + 2 * lane] = a0;
      pp[3 + 2 * lane] = a1;
    }
  }
  grid.sync();

  // merge the tiles of each head: one warp a head
  for (int h = blockIdx.x * MAX_G + warp; h < H; h += gridDim.x * MAX_G) {
    const int kh = h / G, g = h % G;
    const float* ph = part + ((size_t)kh * t_max * G + g) * PART;
    const size_t step = (size_t)G * PART;
    float mx = TL_NEG_INF;
    for (int t = 0; t < n_tiles; ++t) mx = fmaxf(mx, __ldcg(ph + t * step));
    float l = 0.f, o0 = 0.f, o1 = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const float* pt = ph + t * step;
      const float e = expf(__ldcg(pt) - mx);
      l += __ldcg(pt + 1) * e;
      o0 += __ldcg(pt + 2 + 2 * lane) * e;
      o1 += __ldcg(pt + 3 + 2 * lane) * e;
    }
    const float den = l > 0.f ? l : 1.f;
    attn[(size_t)h * D + 2 * lane] = qstrip::round_bf16(o0 / den);
    attn[(size_t)h * D + 2 * lane + 1] = qstrip::round_bf16(o1 / den);
  }
  grid.sync();

  // wo strips against the merged result, plus the residual
  const int K = H * D;
  w += (size_t)li * qkind::plane_bytes(BITS, K, N);
  s += (size_t)li * (K >> sshift) * N;
  for (int j = blockIdx.x * COLS; j < N; j += gridDim.x * COLS) {
    qstrip::strip_matmul<BITS>(
        buf, w, s, K, N, j, sshift,
        [&](float* b, int k0, int kc_) {
          qstrip::stage_row(b, k0, kc_, [&](int k, float(&v)[8]) {
            qstrip::load_l2_f32x8(attn + k, v);
          });
        },
        [&](int n, float v) { out[n] = __float2bfloat16(__bfloat162float(res[n]) + v); });
  }
}

}  // namespace

extern "C" {

// q: [H, 64] bf16; k, v: [L, 1, Kh, S, 64] of kv_kind (0 bf16, 1 int8,
// 2 f16, 3 f32); ks, vs: [L, 1, Kh, S] f32 scales (int8; else null); layer, pos: [1]
// int32; kind: 0 q8, 1 q4, 2 q4g; w, s: [L, H*64, N] int8 (or [L, H*32, N] uint8)
// and [L, H*64/32 (or /128), N] fp16; res, out: [N] bf16; part:
// [H * S/64 * 66] f32 and attn: [H * 64] f32 workspaces. Requires
// H / Kh <= 8, S % 64 == 0, N % 32 == 0 and pos < S.
int fused_attn_out(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* layer, const void* pos,
                   const void* w, const void* s, const void* res, void* part,
                   void* attn, void* out, int kind, int kv_kind, int H, int Kh,
                   int S, int N, void* stream) {
  if (!qkind::valid(kind) || !kvkind::valid(kv_kind) || Kh < 1 || H % Kh || H / Kh > MAX_G || S < TILE ||
      S % TILE || N < COLS || N % COLS || (H * D) % qkind::scale_rows(kind))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int bytes = qstrip::SMEM_FLOATS * sizeof(float);
  int want = Kh * (S / TILE);
  if (N / COLS > want) want = N / COLS;
  if ((H + MAX_G - 1) / MAX_G > want) want = (H + MAX_G - 1) / MAX_G;
  return qkind::with_bits(kind, [&](auto bits) {
    return kvkind::with_type(kv_kind, [&](auto tag) {
      using KV = decltype(tag);
      auto kernel = fused_attn_out_kernel<decltype(bits)::value, KV>;
      static int resident = 0;
      static const cudaError_t occ =
          qstrip::resident_blocks(kernel, bytes, &resident);
      if (occ) return (int)occ;
      const int grid = want < resident ? want : resident;
      const cudaError_t err = qstrip::launch_cooperative(
          kernel, grid, bytes, st, static_cast<const bf16*>(q),
          static_cast<const KV*>(k), static_cast<const KV*>(v),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const int*>(layer), static_cast<const int*>(pos),
          static_cast<const uint8_t*>(w), static_cast<const __half*>(s),
          static_cast<const bf16*>(res), static_cast<float*>(part),
          static_cast<float*>(attn), static_cast<bf16*>(out), H, Kh, S, N,
          qkind::scale_shift(kind));
      cudaError_t last = cudaGetLastError();
      return (int)(err ? err : last);
    });
  });
}

}  // extern "C"
