// Single-token grouped-query attention of a staged decode chunk for
// Hopper (sm_90a): bf16 queries, bf16, f16, f32 or int8 keys and values
// (kvkind.cuh), f32 softmax and accumulation.
//
// One kernel body walks a row's keys below the chunk's base from one of
// two sources, then the chunk's staged tail [L, B, Kh, Cs, d] at slots
// < ntail = pos[b] - base[b] + 1:
//
// K9  flash_staged replaces _flash_staged_kernel in
//     tinyllama_tpu/ops/pallas/flash_prefill.py: the monolithic cache
//     [L, B, Kh, S, d] below npool = base[b].
// K11 flash_paged_staged replaces _flash_paged_staged_kernel in
//     tinyllama_tpu/ops/pallas/flash_paged.py: the page pool
//     [L, NP, Kh, P, d] through the row's page table [B, J], below
//     npool = base[b].
//
// Bound: the bytes of the keys and values a row attends (its fill, not
// max_ctx) over the memory rate; the arithmetic is 4 * d operations a
// (query head, key) pair. Design: one block per (batch row, kv head) with
// one warp per query head of the group. The block stages each 64-key
// tile of K and V in shared memory once, and the G warps of the group
// share it; each warp computes its head's scores (a lane per key) and its
// part of P V (a lane per two output dims) in f32, through
// online_softmax_update. A page is a whole number of key tiles, so a tile
// never straddles pages and its page comes from one table read. The
// layer, pos, base and the table are read on the card; the walk stops at
// each row's own fill. Nothing is allocated and nothing synchronizes with
// the host, so the kernels capture in a CUDA graph. At batch 1 the grid
// is Kh blocks walking their tiles one after another; the split key walk
// and tile ring of decode_split.cu (K4, K10) would take a tail source. An
// int8 pool and tail halve the bytes a key costs: rows are staged as
// exact bf16, each tile's scales beside them (read through the same index
// as the data: the row's slab, the page through the table, or the tail
// slot), and folded into the scores and the probabilities as the TPU
// kernels fold them.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kvkind.cuh"
#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64;         // head dim
constexpr int BS = 64;        // keys per tile
constexpr int K_LD = D + 2;   // padded K rows: 33 words, a bank per key

// KV: bf16, int8_t, __half or float. Every scale plane is its data
// plane's shape less D (f32; int8 only, else null), so a tile's scales sit
// at its data offset over D.
template <class KV>
struct Args {
  const bf16* q;      // [B, 1, H, D]
  const KV* k;        // dense [L, B, Kh, S, D] or pool [L, NP, Kh, P, D]
  const KV* v;
  const KV* sk;       // staged [L, B, Kh, Cs, D]
  const KV* sv;
  const float* ks;    // scales of k, v, sk, sv
  const float* vs;
  const float* sks;
  const float* svs;
  const int* layer;   // [1]
  const int* pos;     // [B]
  const int* base;    // [B]
  const int* table;   // [B, J] (K11 only)
  bf16* out;          // [B, 1, H, D]
  int B, Kh;
  int S;              // dense: positions a row; paged: page size P
  int n_pages, J;     // paged: pool pages, table width
  int Cs;             // staged slots
};

template <int G>
struct Smem {
  bf16 k[BS * K_LD];
  bf16 v[BS * D];
  float q[G][D];
  float p[G][BS];
  float ks[BS];  // int8: the tile's key and value scales
  float vs[BS];
};

__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage n <= BS rows of k and v ([n, D] row-major) in the tile, and for
// int8 their scales (kps, vps: n floats); rows past n are zero, so a
// masked key adds 0 * 0 to the weighted sum.
template <int G, class KV>
__device__ void load_tile(Smem<G>& sm, const KV* kp, const KV* vp,
                          const float* kps, const float* vps, int n) {
  if constexpr (kvkind::is_i8<KV>) {  // G * 32 >= 2 * BS threads
    const int r = threadIdx.x % BS;
    if (threadIdx.x < BS) sm.ks[r] = r < n ? kps[r] : 0.f;
    else if (threadIdx.x < 2 * BS) sm.vs[r] = r < n ? vps[r] : 0.f;
  }
  for (int i = threadIdx.x; i < BS * (D / 8); i += G * 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < n) {
      kv = kvkind::load8(kp + (size_t)r * D + c);
      vv = kvkind::load8(vp + (size_t)r * D + c);
    }
    uint32_t* kd = reinterpret_cast<uint32_t*>(&sm.k[r * K_LD + c]);
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
    *reinterpret_cast<uint4*>(&sm.v[r * D + c]) = vv;
  }
}

// One warp's online-softmax step over the staged tile: keys < n_ok are
// visible. o0, o1 accumulate dims 2 * lane and 2 * lane + 1. I8 folds the
// tile's scales: k-scales into the scores, v-scales into the
// probabilities after l has summed them.
template <int G, bool I8>
__device__ void attend_tile(Smem<G>& sm, int g, int lane, int n_ok, float& m,
                            float& l, float& o0, float& o1) {
  const float scale = 1.f / sqrtf((float)D);
  float s[2];
  bool ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = lane + 32 * e;
    const __nv_bfloat162* kr =
        reinterpret_cast<const __nv_bfloat162*>(&sm.k[key * K_LD]);
    float acc = 0.f;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) {
      const float2 kf = __bfloat1622float2(kr[dd]);
      acc += sm.q[g][2 * dd] * kf.x + sm.q[g][2 * dd + 1] * kf.y;
    }
    s[e] = acc * scale;
    if (I8) s[e] *= sm.ks[key];
    ok[e] = key < n_ok;
  }
  const float alpha = online_softmax_update(s, ok, m, l);
  sm.p[g][lane] = round_bf16(s[0]);
  sm.p[g][lane + 32] = round_bf16(s[1]);
  if (I8) {  // after l has summed them (kvkind.cuh)
    sm.p[g][lane] *= sm.vs[lane];
    sm.p[g][lane + 32] *= sm.vs[lane + 32];
  }
  __syncwarp();
  float a0 = 0.f, a1 = 0.f;
  const __nv_bfloat162* vcol = reinterpret_cast<const __nv_bfloat162*>(sm.v) + lane;
#pragma unroll 8
  for (int key = 0; key < BS; ++key) {
    const float pk = sm.p[g][key];
    const float2 vf = __bfloat1622float2(vcol[key * (D / 2)]);
    a0 += pk * vf.x;
    a1 += pk * vf.y;
  }
  o0 = o0 * alpha + a0;
  o1 = o1 * alpha + a1;
}

template <int G, bool PAGED, class KV>
__global__ void __launch_bounds__(G * 32) serve_attention_kernel(Args<KV> a) {
  constexpr bool I8 = kvkind::is_i8<KV>;
  __shared__ __align__(16) Smem<G> sm;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = a.layer[0], p = a.pos[b];
  const size_t qo = ((size_t)b * a.Kh * G + kh * G + g) * D;
  sm.q[g][lane] = __bfloat162float(a.q[qo + lane]);
  sm.q[g][lane + 32] = __bfloat162float(a.q[qo + lane + 32]);

  // pool keys [0, npool): below the chunk base, never past the row's
  // capacity (a chunk may run past max_ctx)
  const int cap = PAGED ? a.J * a.S : a.S;
  const int npool = max(0, min(a.base[b], cap));
  float m = TL_NEG_INF, l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int t = 0; t * BS < npool; ++t) {
    size_t off;
    if (PAGED) {
      const int key0 = t * BS;
      const int page = a.table[(size_t)b * a.J + key0 / a.S];
      off = (((size_t)li * a.n_pages + page) * a.Kh + kh) * a.S * D +
            (size_t)(key0 % a.S) * D;
    } else {
      off = (((size_t)li * a.B + b) * a.Kh + kh) * a.S * D + (size_t)t * BS * D;
    }
    __syncthreads();
    load_tile<G>(sm, a.k + off, a.v + off, I8 ? a.ks + off / D : nullptr,
                 I8 ? a.vs + off / D : nullptr, BS);
    __syncthreads();
    attend_tile<G, I8>(sm, g, lane, npool - t * BS, m, l, o0, o1);
  }
  const int ntail = max(0, min(p - a.base[b] + 1, a.Cs));
  const size_t tail = (((size_t)li * a.B + b) * a.Kh + kh) * a.Cs * D;
  for (int t = 0; t * BS < ntail; ++t) {
    const size_t off = tail + (size_t)t * BS * D;
    __syncthreads();
    load_tile<G>(sm, a.sk + off, a.sv + off, I8 ? a.sks + off / D : nullptr,
                 I8 ? a.svs + off / D : nullptr, min(BS, a.Cs - t * BS));
    __syncthreads();
    attend_tile<G, I8>(sm, g, lane, ntail - t * BS, m, l, o0, o1);
  }
  const float den = l > 0.f ? l : 1.f;
  reinterpret_cast<__nv_bfloat162*>(a.out + qo)[lane] =
      __floats2bfloat162_rn(o0 / den, o1 / den);
}

template <bool PAGED, class KV>
int launch(const Args<KV>& a, int G, void* stream) {
  if (a.B < 1 || a.Kh < 1 || a.S < BS || a.S % BS || a.Cs < 1 || a.Cs % 32 ||
      (PAGED && a.J < 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.Kh, a.B);
  auto st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 4:
      serve_attention_kernel<4, PAGED, KV><<<grid, 4 * 32, 0, st>>>(a);
      break;
    case 8:
      serve_attention_kernel<8, PAGED, KV><<<grid, 8 * 32, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The pointers of one call as Args of the kind's element type: k, v, sk,
// sv as KV; ks, vs, sks, svs the f32 scales (null for bf16); nullptr
// where a kernel takes no such operand.
struct Ptrs {
  const void *q, *k, *v, *sk, *sv, *ks, *vs, *sks, *svs, *layer, *pos, *base,
      *table;
  void* out;
};

template <bool PAGED>
int dispatch(int kv_kind, const Ptrs& p, int B, int H, int Kh, int S,
             int n_pages, int J, int Cs, int d, void* stream) {
  if (!kvkind::valid(kv_kind) || d != D || Kh < 1 || H % Kh)
    return (int)cudaErrorInvalidValue;
  return kvkind::with_type(kv_kind, [&](auto tag) {
    using KV = decltype(tag);
    Args<KV> a{static_cast<const bf16*>(p.q), static_cast<const KV*>(p.k),
               static_cast<const KV*>(p.v), static_cast<const KV*>(p.sk),
               static_cast<const KV*>(p.sv), static_cast<const float*>(p.ks),
               static_cast<const float*>(p.vs), static_cast<const float*>(p.sks),
               static_cast<const float*>(p.svs), static_cast<const int*>(p.layer),
               static_cast<const int*>(p.pos), static_cast<const int*>(p.base),
               static_cast<const int*>(p.table), static_cast<bf16*>(p.out),
               B, Kh, S, n_pages, J, Cs};
    return launch<PAGED>(a, H / Kh, stream);
  });
}

}  // namespace

extern "C" {

// kv_kind (kvkind.cuh): 0 bf16, 2 f16 or 3 f32 planes, null scales; 1 int8
// planes with f32 scale planes of their shape less d.

// K9. q, out: [B, 1, H, d] bf16; k, v: [L, B, Kh, S, d]; sk, sv: [L, B,
// Kh, Cs, d]; ks, vs, sks, svs: their scales; layer [1]; pos, base [B].
// Requires d == 64, H / Kh in {4, 8}, S % 64 == 0 and Cs % 32 == 0.
int flash_staged(const void* q, const void* k, const void* v, const void* sk,
                 const void* sv, const void* ks, const void* vs,
                 const void* sks, const void* svs, const void* layer,
                 const void* pos, const void* base, void* out, int kv_kind,
                 int B, int H, int Kh, int S, int Cs, int d, void* stream) {
  const Ptrs p{q, k, v, sk, sv, ks, vs, sks, svs, layer, pos, base, nullptr, out};
  return dispatch<false>(kv_kind, p, B, H, Kh, S, 0, 0, Cs, d, stream);
}

// K11. q, out: [B, 1, H, d]; k, v: [L, NP, Kh, P, d]; sk, sv: [L, B, Kh,
// Cs, d]; ks, vs, sks, svs: their scales; table [B, J]; layer [1]; pos,
// base [B]. Requires d == 64, H / Kh in {4, 8}, P % 64 == 0 and Cs % 32
// == 0.
int flash_paged_staged(const void* q, const void* k, const void* v,
                       const void* sk, const void* sv, const void* ks,
                       const void* vs, const void* sks, const void* svs,
                       const void* layer, const void* pos, const void* base,
                       const void* table, void* out, int kv_kind, int B, int H,
                       int Kh, int n_pages, int P, int J, int Cs, int d,
                       void* stream) {
  const Ptrs p{q, k, v, sk, sv, ks, vs, sks, svs, layer, pos, base, table, out};
  return dispatch<true>(kv_kind, p, B, H, Kh, P, n_pages, J, Cs, d, stream);
}

}  // extern "C"
