// Single-token grouped-query attention over a long KV cache for Hopper
// (sm_90a), with the key walk split across the card's SMs: bf16 queries,
// a bf16, f16, f32 or int8 cache (kvkind.cuh), f32 softmax and sums.
//
// One kernel template serves two TPU kernels, which differ only in how
// key tile t of batch row b is addressed:
//
// K4  flash_decode_heads replaces _decode_heads_kernel in
//     tinyllama_tpu/ops/pallas/flash_prefill.py: the row's slab of the
//     monolithic cache [L, B, Kh, S, d], tile t at key t * 64.
// K10 flash_paged replaces _flash_paged_kernel in
//     tinyllama_tpu/ops/pallas/flash_paged.py: the page pool
//     [L, NP, Kh, P, d], tile t in page table[b, t * 64 / P] (a page is a
//     whole number of tiles).
//
// Head h attends kv head h / G; scores are scaled by 1/sqrt(d); a key at
// position s is visible iff s <= pos[b]. The layer, pos and the table
// are read on the card, nothing is allocated and nothing synchronizes
// with the host, so both kernels capture in a CUDA graph.
//
// Bound: the bytes of the pos+1 keys and values each (row, kv head)
// attends over the memory rate. The arithmetic is 4 * d * G operations a
// key against 2 * d * sizeof(KV) bytes: G operations a byte in bf16, far
// below the ~295 at which the tensor cores would bound it. So the design
// is about parallelism and overlap, not products:
//
// * Split. The grid is (n_split, Kh, B). n_split is chosen on the host
//   from host-known sizes only (ops/kernels/decode_split.py:
//   decode_splits, ~2 blocks an SM, at most 32 and the row's capacity in
//   tiles), never from pos, so a captured step replays at any position.
//   Block (split, kh, b) reads pos[b], takes n_tiles = min(pos / 64 + 1,
//   capacity), share = ceil(n_tiles / n_split), and walks tiles [split *
//   share, (split + 1) * share) of them: at batch 1 and pos 1500 one
//   64-key tile a block over 96 blocks, where a block a (row, kv head)
//   walked 24 tiles one after another on 4 SMs. A row of at most
//   SOLO_TILES = 2 tiles is one block's (share = n_tiles): on the card a
//   second tile in the ring cost about what a merge costs (chosen there).
//   The live splits are 0 .. n_live - 1 (n_live = ceil(n_tiles / share));
//   a block past them returns at once and writes nothing.
// * Ring. Inside a block the tiles go through a ring of NS stages in
//   shared memory (3; 2 for f32, so two 80 KB blocks fit an SM), filled
//   by 16-byte cp.async copies of the raw cache bytes (and an int8 tile's
//   f32 scales): tile t + NS - 1 is in flight while tile t is computed;
//   the page number of a tile is read as its copies are issued. bf16 K
//   rows are stored with an XOR swizzle of their 16-byte chunks (chunk c
//   of row r at c ^ (r & 7)), so the copies stay 16-byte aligned and the
//   lane-per-key score loop reads the 8 rows of a quarter warp from 8
//   distinct bank groups. An int8, f16 or f32 tile
//   lands raw and is converted once, by the whole block, into a bf16 K
//   (swizzled) and V tile beside the ring: int8 exact (its scales folded
//   into the scores, and into the probabilities after l has summed them),
//   f16 and f32 rounded to bf16, as the TPU kernels cast a tile. Scores
//   and P V are f32 FMAs from shared memory, a lane a key and a lane two
//   output dims, with two independent sums each.
// * Merge, in the same launch. A group with one live block writes its
//   output directly. Otherwise each live block writes (m, l, acc[64]) in
//   f32 a query head to a workspace [B, H, n_split, 66] from torch.empty
//   (slots past n_live are never written or read), fences, and takes a
//   ticket from its group's arrival count; the block that takes the last
//   merges, a warp a head and a lane a partial: M = max m_i, then
//   sum(exp(m_i - M) acc_i) / sum(exp(m_i - M) l_i) as bf16 (l > 0, else
//   1). Its atomicInc wraps the count back to 0, so nothing is zeroed
//   between launches or graph replays. A second, merging launch was the
//   first design: on the card it held every call near 9.5 us (PERF.md);
//   the ticket costs a fence, an atomic and one L2 round trip instead.
//
// Within a split the recurrence is online_softmax_update: probabilities
// unnormalized against the split's running max, rounded to bf16 before
// P V, as the TPU kernels feed the MXU.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kvkind.cuh"
#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 64;            // head dim
constexpr int BS = 64;           // keys per tile
constexpr int WS = D + 2;        // floats of one partial: m, l, acc[D]
constexpr int MAX_SPLITS = 32;   // a warp merges them, a lane a partial
constexpr int SOLO_TILES = 2;    // a row of <= this many tiles: one block
constexpr int BF_ROW = 2 * D;    // bytes of a bf16 row
constexpr int BF_TILE = BS * BF_ROW;

// The ring for a KV element type: NS stages, each the raw K and V tiles
// of BS rows, then (int8) the tile's BS key scales and BS value scales.
// Kinds other than bf16 are converted once a tile, into a bf16 K and V
// tile beside the ring, before the warps read them.
template <class KV>
struct Tile {
  static constexpr bool I8 = kvkind::is_i8<KV>;
  static constexpr bool RAW = !std::is_same<KV, bf16>::value;
  static constexpr int ROW = D * (int)sizeof(KV);  // bytes of a raw row
  static constexpr int CPR = ROW / 16;              // 16-byte chunks a row
  static constexpr int BYTES = BS * ROW;            // one raw K or V tile
  static constexpr int STAGE = 2 * BYTES + (I8 ? 2 * BS * 4 : 0);
  static constexpr int NS = sizeof(KV) == 4 ? 2 : 3;  // stages
  static constexpr int SMEM = NS * STAGE + (RAW ? 2 * BF_TILE : 0);
};

// Where 16-byte chunk c of bf16 K row r sits in a tile: at c ^ (r & 7) of
// its row, so the 8 rows a quarter warp reads at once (a lane a key) land
// in 8 distinct bank groups and every copy stays 16-byte aligned.
__device__ inline int kchunk(int r, int c) { return r * 8 + (c ^ (r & 7)); }

__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N_PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING) : "memory");
}

// Eight bf16 values (a 16-byte chunk) as floats.
__device__ inline void bf16x8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// One call's operands. KV: bf16, int8_t, __half or float; the scale
// planes (int8 only, else null) have the data's shape less D.
template <class KV>
struct Args {
  const bf16* q;       // [B, 1, H, D]
  const KV* k;         // dense [L, B, Kh, S, D] or pool [L, NP, Kh, P, D]
  const KV* v;
  const float* ks;
  const float* vs;
  const int* layer;    // [1]
  const int* pos;      // [B]
  const int* table;    // [B, J] (paged only)
  float* ws;           // [B, H, n_split, WS]
  bf16* out;           // [B, 1, H, D]
  int B, Kh;
  int rows;            // dense: S; paged: page size P
  int n_pages, J;      // paged only
  int cap_tiles;       // a row's capacity in tiles: S / BS or J * P / BS
  int n_split;
};

// Element offset of tile t (keys t * BS ...) of row b, kv head kh.
template <bool PAGED, class KV>
__device__ inline size_t tile_offset(const Args<KV>& a, int li, int b, int kh,
                                     int t) {
  if (PAGED) {
    const int key0 = t * BS;
    const int page = a.table[(size_t)b * a.J + key0 / a.rows];
    return (((size_t)li * a.n_pages + page) * a.Kh + kh) * a.rows * D +
           (size_t)(key0 % a.rows) * D;
  }
  return (((size_t)li * a.B + b) * a.Kh + kh) * (size_t)a.rows * D +
         (size_t)t * BS * D;
}

// Issue the copies of the tile at element offset `off` into a stage: bf16
// K rows swizzled (kchunk), everything else as it lies.
template <int NT, class KV>
__device__ inline void issue_tile(unsigned char* stage, const Args<KV>& a,
                                  size_t off) {
  using T = Tile<KV>;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(a.k + off);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(a.v + off);
  for (int i = threadIdx.x; i < BS * T::CPR; i += NT) {
    const int kd = T::RAW ? i : kchunk(i / T::CPR, i % T::CPR);
    cp_async16(stage + kd * 16, kg + i * 16);
    cp_async16(stage + T::BYTES + i * 16, vg + i * 16);
  }
  if constexpr (T::I8) {  // 16 chunks of key scales, then 16 of value scales
    const int i = threadIdx.x;
    const size_t s = off / D;
    if (i < 16) cp_async16(stage + 2 * T::BYTES + i * 16, a.ks + s + 4 * i);
    else if (i < 32)
      cp_async16(stage + 2 * T::BYTES + BS * 4 + (i - 16) * 16,
                 a.vs + s + 4 * (i - 16));
  }
}

// A raw stage's K and V as bf16 tiles (K swizzled): int8 exact, f16 and
// f32 rounded to nearest even (kvkind::load8), each value once a block.
template <int NT, class KV>
__device__ inline void convert_tile(const unsigned char* stage,
                                    unsigned char* bk, unsigned char* bv) {
  using T = Tile<KV>;
  for (int o = threadIdx.x; o < 2 * BS * 8; o += NT) {
    const int plane = o / (BS * 8), r = (o / 8) % BS, c = o % 8;
    const KV* src = reinterpret_cast<const KV*>(stage + plane * T::BYTES +
                                                r * T::ROW) + 8 * c;
    unsigned char* dst = plane ? bv + o % (BS * 8) * 16 : bk + kchunk(r, c) * 16;
    *reinterpret_cast<uint4*>(dst) = kvkind::load8(src);
  }
}

// Arrival counts of the (row, kv head) groups of one launch: the live
// blocks of a group take tickets, and the one that takes the last merges
// and leaves the count at 0 (atomicInc wraps), so no launch needs it
// zeroed. Launches on one device run one at a time, as the port's do.
constexpr int MAX_GROUPS = 1 << 16;
__device__ unsigned int g_tickets[MAX_GROUPS];

// Block (split, kh, b), one warp a query head of the group: the split's
// share of row b's visible tiles. The group's live blocks are splits 0 ..
// n_live - 1, each with `share` tiles (the last fewer); a block past them
// returns at once. One live block writes the output itself; otherwise
// each writes its partial and the last to arrive merges them.
// Two blocks an SM (at most 128 registers a thread at G = 8), so a batch of
// rows fits the card in one wave.
template <int G, bool PAGED, class KV>
__global__ void __launch_bounds__(G * 32, 2) decode_split_kernel(Args<KV> a) {
  using T = Tile<KV>;
  constexpr int NT = G * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float ps[G][BS];  // each warp's probabilities
  __shared__ unsigned int ticket;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = kh * G + g;
  const size_t row = (size_t)b * a.Kh * G + h;  // (b, h) of q, out, ws

  // the head's query in registers, f32 (its loads overlap pos's)
  float qf[D];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(a.q + row * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      float f[8];
      bf16x8(qp[c], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[8 * c + j] = f[j];
    }
  }
  const int li = a.layer[0], p = a.pos[b];
  const int n_tiles = min(p / BS + 1, a.cap_tiles);
  // a short row is one block's: its tiles cost less than a merge
  const int share = n_tiles <= SOLO_TILES
                        ? n_tiles
                        : (n_tiles + a.n_split - 1) / a.n_split;
  const int n_live = (n_tiles + share - 1) / share;
  if (split >= n_live) return;
  const int t0 = split * share, t1 = min(t0 + share, n_tiles);

#pragma unroll
  for (int s = 0; s < T::NS - 1; ++s) {
    if (t0 + s < t1)
      issue_tile<NT>(smem + s * T::STAGE, a,
                     tile_offset<PAGED>(a, li, b, kh, t0 + s));
    cp_async_commit();  // empty groups keep the count uniform
  }

  unsigned char* bk = smem + T::NS * T::STAGE;  // converted tiles (RAW)
  unsigned char* bv = bk + BF_TILE;
  const float scale = 1.f / sqrtf((float)D);
  float m = TL_NEG_INF, l = 0.f, o0 = 0.f, o1 = 0.f;  // dims 2 lane, 2 lane + 1
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    if (t + T::NS - 1 < t1)
      issue_tile<NT>(smem + ((i + T::NS - 1) % T::NS) * T::STAGE, a,
                     tile_offset<PAGED>(a, li, b, kh, t + T::NS - 1));
    cp_async_commit();
    cp_async_wait<T::NS - 1>();  // this thread's copies of tile t landed
    __syncthreads();              // and everyone's
    const unsigned char* st = smem + (i % T::NS) * T::STAGE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * T::BYTES);
    const float* vsc = ksc + BS;
    const unsigned char* kt = st;
    const unsigned char* vt = st + T::BYTES;
    if constexpr (T::RAW) {
      convert_tile<NT, KV>(st, bk, bv);
      __syncthreads();
      kt = bk;
      vt = bv;
    }
    const int n_ok = min(BS, p + 1 - t * BS);  // visible keys, >= 1

    // scores: a lane per key, keys lane and lane + 32, two partial sums
    // each
    float s[2];
    bool ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = lane + 32 * e;
      const uint4* kr = reinterpret_cast<const uint4*>(kt);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float f[8];
        bf16x8(kr[kchunk(r, c)], f);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          acc0 = fmaf(qf[8 * c + j], f[j], acc0);
          acc1 = fmaf(qf[8 * c + j + 1], f[j + 1], acc1);
        }
      }
      s[e] = (acc0 + acc1) * scale;
      if constexpr (T::I8) s[e] *= ksc[r];
      ok[e] = r < n_ok;
    }
    const float alpha = online_softmax_update(s, ok, m, l);
    float p0 = round_bf16(s[0]), p1 = round_bf16(s[1]);
    if constexpr (T::I8) {  // after l has summed them (kvkind.cuh)
      p0 *= vsc[lane];
      p1 *= vsc[lane + 32];
    }
    ps[g][lane] = p0;
    ps[g][lane + 32] = p1;
    __syncwarp();

    // P V: a lane per two output dims, four keys a step (their
    // probabilities one broadcast read), two sums for even and odd keys;
    // masked keys are skipped, not multiplied by 0
    const __nv_bfloat162* vc = reinterpret_cast<const __nv_bfloat162*>(vt) + lane;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    const int n4 = n_ok & ~3;
#pragma unroll 2
    for (int j = 0; j < n4; j += 4) {
      const float4 pk = *reinterpret_cast<const float4*>(&ps[g][j]);
      const float2 v0 = __bfloat1622float2(vc[(j + 0) * (D / 2)]);
      const float2 v1 = __bfloat1622float2(vc[(j + 1) * (D / 2)]);
      const float2 v2 = __bfloat1622float2(vc[(j + 2) * (D / 2)]);
      const float2 v3 = __bfloat1622float2(vc[(j + 3) * (D / 2)]);
      a0 = fmaf(pk.x, v0.x, a0);
      a1 = fmaf(pk.x, v0.y, a1);
      b0 = fmaf(pk.y, v1.x, b0);
      b1 = fmaf(pk.y, v1.y, b1);
      a0 = fmaf(pk.z, v2.x, a0);
      a1 = fmaf(pk.z, v2.y, a1);
      b0 = fmaf(pk.w, v3.x, b0);
      b1 = fmaf(pk.w, v3.y, b1);
    }
    for (int j = n4; j < n_ok; ++j) {
      const float2 vf = __bfloat1622float2(vc[j * (D / 2)]);
      a0 = fmaf(ps[g][j], vf.x, a0);
      a1 = fmaf(ps[g][j], vf.y, a1);
    }
    o0 = o0 * alpha + (a0 + b0);
    o1 = o1 * alpha + (a1 + b1);
    __syncthreads();  // the stage, the bf16 tiles and ps are free again
  }

  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(a.out + row * D);
  if (n_live == 1) {  // the whole walk was this block's
    const float den = l > 0.f ? l : 1.f;
    out[lane] = __floats2bfloat162_rn(o0 / den, o1 / den);
    return;
  }
  float* ws = a.ws + row * a.n_split * WS;  // this head's partials
  if (lane == 0) {
    ws[split * WS] = m;
    ws[split * WS + 1] = l;
  }
  reinterpret_cast<float2*>(ws + split * WS + 2)[lane] = make_float2(o0, o1);
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0)
    ticket = atomicInc(&g_tickets[b * a.Kh + kh], n_live - 1);
  __syncthreads();
  if (ticket != n_live - 1) return;

  // the last block: merge the group's n_live <= 32 partials, lane i holding
  // partial i's (m, l) and every lane loading its two dims of each acc
  // (past the L1, which may hold nothing of them: the writers fenced)
  float mp = TL_NEG_INF, lp = 0.f;
  if (lane < n_live) {
    mp = __ldcg(ws + lane * WS);
    lp = __ldcg(ws + lane * WS + 1);
  }
  float2 acc[MAX_SPLITS];
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i)
    if (i < n_live)
      acc[i] = __ldcg(reinterpret_cast<const float2*>(ws + i * WS + 2) + lane);
  const float M = tl_warp_max(mp);
  const float c = lane < n_live ? expf(mp - M) : 0.f;
  const float den_sum = tl_warp_sum(c * lp);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) {
    if (i < n_live) {
      const float ci = __shfl_sync(0xffffffffu, c, i);
      a0 = fmaf(ci, acc[i].x, a0);
      a1 = fmaf(ci, acc[i].y, a1);
    }
  }
  const float den = den_sum > 0.f ? den_sum : 1.f;
  out[lane] = __floats2bfloat162_rn(a0 / den, a1 / den);
}

template <int G, bool PAGED, class KV>
int launch_g(const Args<KV>& a, cudaStream_t st) {
  constexpr int SMEM = Tile<KV>::SMEM;  // f16: 64 KB, f32: 80 KB, above 48
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<G, PAGED, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  decode_split_kernel<G, PAGED, KV>
      <<<dim3(a.n_split, a.Kh, a.B), G * 32, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

struct Ptrs {
  const void *q, *k, *v, *ks, *vs, *layer, *pos, *table;
  void *ws, *out;
};

template <bool PAGED>
int dispatch(int kv_kind, const Ptrs& p, int B, int H, int Kh, int rows,
             int n_pages, int J, int d, int n_split, void* stream) {
  if (!kvkind::valid(kv_kind) || d != D || B < 1 || Kh < 1 || H % Kh ||
      rows < BS || rows % BS || (PAGED && (J < 1 || n_pages < 1)))
    return (int)cudaErrorInvalidValue;
  const int cap_tiles = PAGED ? J * (rows / BS) : rows / BS;
  if (n_split < 1 || n_split > min(cap_tiles, MAX_SPLITS) ||
      (long long)B * Kh > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return kvkind::with_type(kv_kind, [&](auto tag) {
    using KV = decltype(tag);
    Args<KV> a{static_cast<const bf16*>(p.q), static_cast<const KV*>(p.k),
               static_cast<const KV*>(p.v), static_cast<const float*>(p.ks),
               static_cast<const float*>(p.vs), static_cast<const int*>(p.layer),
               static_cast<const int*>(p.pos), static_cast<const int*>(p.table),
               static_cast<float*>(p.ws), static_cast<bf16*>(p.out),
               B, Kh, rows, n_pages, J, cap_tiles, n_split};
    switch (H / Kh) {
      case 4: return launch_g<4, PAGED, KV>(a, st);
      case 8: return launch_g<8, PAGED, KV>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

}  // namespace

extern "C" {

// kv_kind (kvkind.cuh): 0 bf16, 2 f16 or 3 f32 planes with null scales; 1
// int8 planes with f32 scale planes of their shape less d. ws: f32 [B, H,
// n_split, 66], written whole before it is read (never zeroed);
// 1 <= n_split <= min(32, the row's capacity in 64-key tiles); B * Kh <=
// 65536. One launch: the split walk, its last block a group merging.

// K4. q, out: [B, 1, H, d] bf16; k, v: [L, B, Kh, S, d]; ks, vs: [L, B,
// Kh, S]; layer [1]; pos [B] (pos[b] < S). Requires d == 64, H / Kh in
// {4, 8} and S % 64 == 0.
int flash_decode_heads(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* layer,
                       const void* pos, void* ws, void* out, int kv_kind, int B,
                       int H, int Kh, int S, int d, int n_split, void* stream) {
  const Ptrs p{q, k, v, ks, vs, layer, pos, nullptr, ws, out};
  return dispatch<false>(kv_kind, p, B, H, Kh, S, 0, 0, d, n_split, stream);
}

// K10. q, out: [B, 1, H, d]; k, v: [L, NP, Kh, P, d]; ks, vs: [L, NP, Kh,
// P]; table [B, J]; layer [1]; pos [B]. Requires d == 64, H / Kh in {4, 8}
// and P % 64 == 0.
int flash_paged(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* layer, const void* pos,
                const void* table, void* ws, void* out, int kv_kind, int B,
                int H, int Kh, int n_pages, int P, int J, int d, int n_split,
                void* stream) {
  const Ptrs p{q, k, v, ks, vs, layer, pos, table, ws, out};
  return dispatch<true>(kv_kind, p, B, H, Kh, P, n_pages, J, d, n_split, stream);
}

}  // extern "C"
