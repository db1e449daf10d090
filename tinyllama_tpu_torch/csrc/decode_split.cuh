// The split-key single-token attention of the port, for Hopper (sm_90a):
// one kernel template, bf16 queries against a bf16, f16, f32 or int8
// cache (kvkind.cuh), f32 softmax and sums, at head dim D = 32, 64 or 128
// (a template parameter: the tiny configurations' 32, TinyLlama's 64,
// Llama-3's 128) and any G = H / Kh from 1 to 8 query heads a kv head (a
// runtime argument: the products hold a group's heads as their 8
// columns, heads past G zero, so one instantiation serves every G and
// the count grows with D and the KV kind only). Its users:
// * K4, K9, K10 and K11 (decode_split.cu), which differ only in how key
//   tile t of batch row b is addressed (the PAGED and STAGED flags);
// * K8 fused_attn_out (attn_out_fused.cu): K4's addressing at B = 1, its
//   result the x of the wo walk (fused_walk.cuh) that runs as the next,
//   programmatic dependent, launch; the TRIGGER flag lets that launch
//   start once a block's first copies are issued.
//
// Every tile copies only its visible keys (n_ok of its 64) and their
// scales; the stage's other rows are zero-filled by copies that read
// nothing. So no copy reads past a tail's Cs slots, and a stale or
// non-finite value past a row's visible keys (a page not yet written, a
// cache from torch.empty) never reaches P V, which multiplies a masked
// key by p = 0.
//
// Head h attends kv head h / G; scores are scaled by 1/sqrt(d); a key at
// position s is visible iff s <= pos[b]. The layer, pos, base and the
// table are read on the card, nothing is allocated and nothing
// synchronizes with the host, so every user captures in a CUDA graph.
//
// Bound: the bytes of the keys and values each (row, kv head) attends
// (K4, K10: pos + 1; K9, K11: npool + ntail) over the memory rate. The
// arithmetic is 4 * d * G operations a key against 2 * d * sizeof(KV)
// bytes: G operations a byte in bf16, far below the ~295 at which the
// tensor cores would bound it, but not below the CUDA cores' rate once
// each head's warp converts every value it reads: the first version of
// this template, a warp a head computing scores and P V in f32 FMAs,
// took ~1.8 us a tile on the card. So both products run on the tensor
// cores, and the design is otherwise about parallelism and overlap:
//
// * Split. The grid is (Kh, B, n_split). n_split is chosen on the host
//   from host-known sizes only (ops/kernels/decode_split.py:
//   decode_splits, ~1 block an SM, at most 32 and half the row's capacity
//   in tiles, a staged tail's tiles counted), never from pos or base, so
//   a captured step replays at any position and in any chunk. Block
//   (split, kh, b) reads pos[b] (and base[b]), takes its row's n_tiles
//   (K4, K10: min(pos / 64 + 1, capacity); K9, K11: n_pool + n_tail),
//   share = ceil(n_tiles / n_split), and walks tiles [split * share,
//   (split + 1) * share) of them: at batch 1 and pos 1500 two 64-key tiles
//   a block over 48 blocks, where a block a (row, kv head) walked 24 tiles
//   one after another on 4 SMs. A row of at most SOLO_TILES = 7 tiles is one
//   block's (share = n_tiles): on the card a merge costs about what 3-4
//   more tiles of a walk cost, and at B = 32 (128 groups, about one an
//   SM) splitting a row of 5 or 7 tiles only added merges (chosen there,
//   PERF.md; it was 2 when the products were f32 FMAs). The live splits
//   are 0 .. n_live - 1 (n_live = ceil(n_tiles / share)); a block past
//   them returns at once and writes nothing. A row with no visible key
//   (staged: base 0 and pos < 0) takes no tile: its split 0 writes zeros,
//   as JAX's denominator of 1 gives.
// * Ring. Inside a block the tiles go through a ring of NS stages in
//   shared memory (3; 2 for f32, so two 80 KB blocks fit an SM at D = 64;
//   at D = 128 a stage doubles: 2 blocks an SM in bf16 and int8, 1 in f16
//   and f32), filled
//   by 16-byte cp.async copies of the raw cache bytes (and an int8 tile's
//   f32 scales): tile t + NS - 1 is in flight while tile t is computed;
//   the page number of a tile is read as its copies are issued. bf16 K
//   and V rows (D / 8 chunks of 16 bytes) are stored with an XOR swizzle
//   of their chunks (kchunk: chunk c of row r at c ^ (r & 7), at D = 128
//   the low three bits of c, so a chunk stays in its half of the row; at
//   D = 32 a row is 4 chunks and two rows share a 128-byte line, so c ^
//   ((r >> 1) & 3)), so the copies stay 16-byte aligned and the 8 rows of
//   an ldmatrix come from 8 distinct bank groups. An
//   int8, f16 or f32 tile lands raw and is converted once, by the whole
//   block, into swizzled bf16 K and V tiles beside the ring: f16 and f32
//   rounded to bf16, as the TPU kernels cast a tile; int8 K and V times
//   their scales rounded to bf16, as the plain versions and K3 dequantize
//   them (kvkind.cuh).
// * Products. A block is NW = 4 warps whatever G; warp w takes keys 16 w
//   .. 16 w + 15 of every tile for all G heads of the group, as its own
//   sub-split with its own running (m, l, acc). Scores S^T [16 keys x 8
//   heads] are D / 16 mma.sync.m16n8k16 (K rows by ldmatrix from the
//   swizzled tile, the group's queries held as B fragments; heads past G
//   are zero columns); the online softmax runs in the accumulators, a
//   head's 16 keys over the 8 lanes that hold its column; the bf16
//   probabilities are transposed in registers (movmatrix) into the B
//   operand of O^T [D dims x 8 heads] += V^T P^T, D / 16 more mma.sync
//   with V^T by ldmatrix.trans. At the end of the walk the four warps'
//   partials merge in shared memory (after the ring, G heads' worth) into
//   the block's.
// * Merge, in the same launch. A group with one live block writes its
//   output directly. Otherwise each live block writes (m, l, acc[64]) in
//   f32 a query head to a workspace [B, H, n_split, D + 2] from torch.empty
//   (slots past n_live are never written or read), fences, and takes a
//   ticket from its group's arrival count; the block that takes the last
//   merges, a warp a head and a lane a partial (then, ceil(D / 64) times,
//   two dims a lane, lanes past D / 2 idle at D = 32): M = max m_i, then
//   sum(exp(m_i - M) acc_i) / sum(exp(m_i - M) l_i) as bf16 (l > 0, else
//   1). Its atomicInc wraps the count back to 0, so nothing is zeroed
//   between launches or graph replays. A second, merging launch was the
//   first design: on the card it held every call near 9.5 us (PERF.md);
//   the ticket costs a fence, an atomic and one L2 round trip instead.
//
// Within a sub-split the recurrence is online_softmax.cuh's: probabilities
// unnormalized against the running max, summed into l in f32, rounded to
// bf16 for P V, as the TPU kernels feed the MXU.
//
// Internal linkage, as fused_walk.cuh: decode_split.cu and
// attn_out_fused.cu each instantiate the kernel, its launcher and the
// merge's arrival counts into their own library, and the libraries live in
// one process.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "kvkind.cuh"
#include "online_softmax.cuh"

namespace dsplit {
namespace {

using bf16 = __nv_bfloat16;
constexpr int BS = 64;           // keys per tile
constexpr int NW = 4;            // warps a block: 16 keys of a tile each
constexpr int NT = NW * 32;      // threads a block
constexpr int GMAX = 8;          // heads of the products' N = 8 columns
constexpr int MAX_SPLITS = 32;   // a warp merges them, a lane a partial
constexpr int SOLO_TILES = 7;    // a row of <= this many tiles: one block

// The ring for a KV element type at head dim D: NS stages, each the raw K
// and V tiles of BS rows, then (int8) the tile's BS key scales and BS
// value scales. Kinds other than bf16 are converted once a tile, into
// bf16 K and V tiles beside the ring, before the warps read them. The
// warps' partials follow, G heads of WS floats a warp (part_bytes).
template <class KV, int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "the template's head dims");
  static constexpr bool I8 = kvkind::is_i8<KV>;
  static constexpr bool RAW = !std::is_same<KV, bf16>::value;
  static constexpr int WS = D + 2;                  // floats of a partial
  static constexpr int BF_TILE = BS * 2 * D;        // a bf16 K or V tile
  static constexpr int ROW = D * (int)sizeof(KV);  // bytes of a raw row
  static constexpr int CPR = ROW / 16;              // 16-byte chunks a row
  static constexpr int BYTES = BS * ROW;            // one raw K or V tile
  static constexpr int STAGE = 2 * BYTES + (I8 ? 2 * BS * 4 : 0);
  static constexpr int NS = sizeof(KV) == 4 ? 2 : 3;  // stages
  static constexpr int SMEM = NS * STAGE + (RAW ? 2 * BF_TILE : 0);
  // the warps' partials of G heads, after the ring and the bf16 tiles
  static constexpr int part_bytes(int G) { return NW * G * WS * 4; }
};

// Where 16-byte chunk c of bf16 row r (D / 8 chunks) sits in a tile: at
// c ^ (r & 7) of its row (D >= 64), or at c ^ ((r >> 1) & 3) of a 4-chunk
// row (D = 32, two rows a 128-byte line), so the 8 rows of an ldmatrix
// matrix (one chunk each) land in 8 distinct bank groups and every copy
// stays 16-byte aligned.
template <int D>
__device__ inline int kchunk(int r, int c) {
  return D >= 64 ? r * (D / 8) + (c ^ (r & 7)) : r * (D / 8) + (c ^ ((r >> 1) & 3));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N_PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING) : "memory");
}

// An 8 x 8 matrix of 16-bit elements, transposed across the warp: lane l
// holds row l / 4, columns 2 (l % 4) and that + 1 (low half first) of it,
// before and after.
__device__ inline uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// One call's operands (D the head dim of the launch). KV: bf16, int8_t,
// __half or float; the scale planes (int8 only, else null) have the
// data's shape less D.
template <class KV>
struct Args {
  const bf16* q;       // [B, 1, H, D]
  const KV* k;         // dense [L, B, Kh, S, D] or pool [L, NP, Kh, P, D]
  const KV* v;
  const KV* sk;        // staged tail [L, B, Kh, Cs, D] (staged only)
  const KV* sv;
  const float* ks;     // scales of k, v, sk, sv
  const float* vs;
  const float* sks;
  const float* svs;
  const int* layer;    // [1]
  const int* pos;      // [B]
  const int* base;     // [B] (staged only)
  const int* table;    // [B, J] (paged only)
  float* ws;           // [B, H, n_split, D + 2]
  bf16* out;           // [B, 1, H, D]
  int B, Kh;
  int G;               // query heads a kv head, 1 .. GMAX
  int rows;            // dense: S; paged: page size P
  int n_pages, J;      // paged only
  int Cs;              // staged slots (staged only)
  int cap_tiles;       // a row's capacity in tiles: S / BS or J * P / BS
  int n_split;
};

// Visible keys of tile t (>= 1): of the npool in the slab or pool below
// n_pool tiles, else of the ntail tail slots (at most Cs - 64 (t -
// n_pool), the slots that exist).
template <bool STAGED>
__device__ inline int tile_keys(int t, int n_pool, int npool, int ntail) {
  return !STAGED || t < n_pool ? min(BS, npool - t * BS)
                               : min(BS, ntail - (t - n_pool) * BS);
}

// Where tile t of row b, kv head kh lies: the element offset of its first
// row in its source, pool (or slab) tile t below n_pool, else tail tile
// t - n_pool.
template <int D, bool PAGED, bool STAGED, class KV>
__device__ inline size_t tile_offset(const Args<KV>& a, int li, int b, int kh,
                                     int t, int n_pool) {
  if (STAGED && t >= n_pool) {
    const int slot0 = (t - n_pool) * BS;
    return ((((size_t)li * a.B + b) * a.Kh + kh) * a.Cs + slot0) * D;
  }
  if (PAGED) {
    const int key0 = t * BS;
    const int page = a.table[(size_t)b * a.J + key0 / a.rows];
    return (((size_t)li * a.n_pages + page) * a.Kh + kh) * a.rows * D +
           (size_t)(key0 % a.rows) * D;
  }
  return (((size_t)li * a.B + b) * a.Kh + kh) * (size_t)a.rows * D +
         (size_t)t * BS * D;
}

// Issue the copies of a tile at element offset `off` of planes k, v
// (int8: scales ks, vs) into a stage: bf16 rows swizzled (kchunk),
// everything else as it lies. Only the first `rows` rows (the tile's
// visible keys) and their scales are read; the stage's rows and scales
// past them are filled with zeros (a copy's bytes past its source size
// are zeros, and a copy of source size 0 reads nothing), since the
// tensor-core P V multiplies every key of a warp's 16, a masked one by
// p = 0.
template <int D, class KV>
__device__ inline void issue_tile(unsigned char* stage, const KV* k,
                                  const KV* v, const float* ks,
                                  const float* vs, size_t off, int rows) {
  using T = Tile<KV, D>;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + off);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + off);
  for (int i = threadIdx.x; i < BS * T::CPR; i += NT) {
    const int sd = T::RAW ? i : kchunk<D>(i / T::CPR, i % T::CPR);
    const bool in = i < rows * T::CPR;
    hopper::cp_async16(stage + sd * 16, kg + (in ? i * 16 : 0), in ? 16 : 0);
    hopper::cp_async16(stage + T::BYTES + sd * 16, vg + (in ? i * 16 : 0),
                       in ? 16 : 0);
  }
  if constexpr (T::I8) {  // 16 chunks of 4 key scales, then 16 of value
    const int i = threadIdx.x % 16, n = min(4, max(0, rows - 4 * i));
    const float* src = (threadIdx.x < 16 ? ks : vs) + off / D;
    if (threadIdx.x < 32)
      hopper::cp_async16(stage + 2 * T::BYTES + (threadIdx.x / 16) * BS * 4 +
                             i * 16,
                         src + (n ? 4 * i : 0), 4 * n);
  }
}

// Issue tile t of row b, kv head kh into a stage (tile_offset's source),
// its visible keys only.
template <int D, bool PAGED, bool STAGED, class KV>
__device__ inline void issue(unsigned char* stage, const Args<KV>& a, int li,
                             int b, int kh, int t, int n_pool, int npool,
                             int ntail) {
  const size_t off = tile_offset<D, PAGED, STAGED>(a, li, b, kh, t, n_pool);
  const int rows = tile_keys<STAGED>(t, n_pool, npool, ntail);
  if (STAGED && t >= n_pool)
    issue_tile<D>(stage, a.sk, a.sv, a.sks, a.svs, off, rows);
  else
    issue_tile<D>(stage, a.k, a.v, a.ks, a.vs, off, rows);
}

// Eight int8 values (8 bytes, 8-byte aligned) times s as eight bf16, each
// product rounded once: kvkind::load8_scaled's values, but each byte is
// widened by a byte permute into the f32 2^23 + 128 + x and one add,
// where an int-to-float conversion runs at a quarter of the FMA rate.
__device__ inline uint4 i8x8_bf16(const int8_t* p, float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  float f[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = (h ? raw.y : raw.x) ^ 0x80808080u;  // x + 128, unsigned
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * h + j] =
          (__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + j)) - 8388736.f) * s;
  }
  return make_uint4(kvkind::bf16x2(f[0], f[1]), kvkind::bf16x2(f[2], f[3]),
                    kvkind::bf16x2(f[4], f[5]), kvkind::bf16x2(f[6], f[7]));
}

// A raw stage's K and V as swizzled bf16 tiles, each value once a block:
// f16 and f32 rounded to nearest even (kvkind::load8); int8 K and V times
// their row's scale (sc[r] and sc[BS + r]) rounded (as
// kvkind::load8_scaled). A thread
// converts CPT 8-value chunks a pass (8, or 4 at D = 32; D / 64 passes,
// one at D = 32), every load of a pass issued before its first store (one
// shared-memory latency, not CPT of them).
template <int D, class KV>
__device__ inline void convert_tile(const unsigned char* stage,
                                    unsigned char* bk, unsigned char* bv,
                                    const float* sc) {
  using T = Tile<KV, D>;
  constexpr int CR = D / 8;  // 8-value chunks a row
  constexpr int ALL = 2 * BS * CR;  // chunks of the K and V tiles
  constexpr int CPT = ALL / NT < 8 ? ALL / NT : 8;
#pragma unroll
  for (int pass = 0; pass < ALL / (NT * CPT); ++pass) {
    uint4 x[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = threadIdx.x + (pass * CPT + j) * NT;
      const int plane = o / (BS * CR), r = (o / CR) % BS, c = o % CR;
      const KV* src = reinterpret_cast<const KV*>(stage + plane * T::BYTES +
                                                  r * T::ROW) + 8 * c;
      if constexpr (T::I8)
        x[j] = i8x8_bf16(src, sc[plane * BS + r]);
      else
        x[j] = kvkind::load8(src);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = threadIdx.x + (pass * CPT + j) * NT;
      const int plane = o / (BS * CR), r = (o / CR) % BS, c = o % CR;
      *reinterpret_cast<uint4*>((plane ? bv : bk) + kchunk<D>(r, c) * 16) = x[j];
    }
  }
}

// Arrival counts of the (row, kv head) groups of one launch: the live
// blocks of a group take tickets, and the one that takes the last merges
// and leaves the count at 0 (atomicInc wraps), so no launch needs it
// zeroed. Launches on one device run one at a time, as the port's do.
constexpr int MAX_GROUPS = 1 << 16;
__device__ unsigned int g_tickets[MAX_GROUPS];

// Block (split, kh, b), NW warps over the a.G query heads of the group:
// the split's share of row b's visible tiles. The group's live blocks are
// splits 0 .. n_live - 1, each with `share` tiles (the last fewer); a
// block past them returns at once. One live block writes the output
// itself; otherwise each writes its partial and the last to arrive
// merges them. TRIGGER: once its first copies are issued, the block lets
// the next launch, a programmatic dependent one, start (a block that
// returns early lets it by exiting). At D = 128 the stages and the
// accumulators double; two blocks an SM is what the bf16 ring leaves
// (the register budget follows). Heads past G are zero columns of the
// products: they write nothing, and the tickets count blocks, not heads.
template <int D, bool PAGED, bool STAGED, class KV, bool TRIGGER = false>
__global__ void __launch_bounds__(NT, D <= 64 ? 4 : 2)
    decode_split_kernel(Args<KV> a) {
  using T = Tile<KV, D>;
  constexpr int WS = T::WS;
  constexpr int KS = D / 16;  // k16 steps of the scores, m16 tiles of O^T
  constexpr int HALVES = (D + 63) / 64;  // passes of 64 dims over a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int ticket;
  const int G = a.G;
  // each warp's (m, l, acc) a head: part[(x * G + h) * WS + i]
  float* part = reinterpret_cast<float*>(smem + T::SMEM);
  // the split is the grid's slowest dimension: every group's split 0,
  // the only live block of a short row, is dispatched before any block
  // that may find nothing to do
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r4 = lane / 4, c4 = lane % 4;
  const size_t head0 = ((size_t)b * a.Kh + kh) * G;  // (b, h) row of head 0
  const int li = a.layer[0], p = a.pos[b];
  // visible keys: npool in the slab or pool, then (staged) ntail slots
  int npool, ntail = 0;
  if constexpr (STAGED) {
    const int base = a.base[b];
    npool = max(0, min(base, a.cap_tiles * BS));
    ntail = max(0, min(p - base + 1, a.Cs));
  } else {
    npool = min(p + 1, a.cap_tiles * BS);
  }
  const int n_pool = (npool + BS - 1) / BS;
  const int n_tiles = n_pool + (ntail + BS - 1) / BS;
  if (n_tiles <= 0) {  // no visible key: zeros (denominator 1)
    if (split == 0)
      for (int i = threadIdx.x; i < G * D / 2; i += NT)
        reinterpret_cast<__nv_bfloat162*>(a.out + head0 * D)[i] =
            __floats2bfloat162_rn(0.f, 0.f);
    return;
  }
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
      issue<D, PAGED, STAGED>(smem + s * T::STAGE, a, li, b, kh, t0 + s,
                              n_pool, npool, ntail);
    cp_async_commit();  // empty groups keep the count uniform
  }
  if constexpr (TRIGGER) hopper::launch_dependents();
  // the group's queries as the scores' B fragments: head r4 (zero past
  // G), dims 16 kk + 2 c4 + {0, 1} in qb[kk][0] and + 8 in qb[kk][1]
  uint32_t qb[KS][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        a.q + (head0 + min(r4, G - 1)) * D);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qb[kk][0] = r4 < G ? qr[8 * kk + c4] : 0u;
      qb[kk][1] = r4 < G ? qr[8 * kk + 4 + c4] : 0u;
    }
  }

  unsigned char* bk = smem + T::NS * T::STAGE;  // converted tiles (RAW)
  unsigned char* bv = bk + T::BF_TILE;
  const float scale = 1.f / sqrtf((float)D);
  // this warp's sub-split: running max and sum of heads 2 c4 + e, and
  // acc[mt][2 i + e] = dim 16 mt + r4 + 8 i of head 2 c4 + e
  float m[2] = {TL_NEG_INF, TL_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[KS][4] = {};
  const int key0 = 16 * w;  // this warp's keys of every tile
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    if (t + T::NS - 1 < t1)
      issue<D, PAGED, STAGED>(smem + ((i + T::NS - 1) % T::NS) * T::STAGE, a,
                              li, b, kh, t + T::NS - 1, n_pool, npool, ntail);
    cp_async_commit();
    cp_async_wait<T::NS - 1>();  // this thread's copies of tile t landed
    __syncthreads();              // and everyone's
    const unsigned char* st = smem + (i % T::NS) * T::STAGE;
    const float* sc = reinterpret_cast<const float*>(st + 2 * T::BYTES);
    const unsigned char* kt = st;
    const unsigned char* vt = st + T::BYTES;
    if constexpr (T::RAW) {
      convert_tile<D, KV>(st, bk, bv, sc);
      __syncthreads();
      kt = bk;
      vt = bv;
    }
    // visible keys, >= 1: the rows the tile copied, the rest zeros
    const int n_ok = tile_keys<STAGED>(t, n_pool, npool, ntail);

    // S^T [16 keys x 8 heads]: s[2 i + e] is key key0 + r4 + 8 i, head
    // 2 c4 + e. A fragments: lanes 8 j .. 8 j + 7 address rows key0 +
    // (lane & 7) + 8 (j & 1) at chunk 2 kk + (j >> 1).
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int j = lane >> 3;
      const int r = key0 + (lane & 7) + 8 * (j & 1);
      uint32_t ka[4];
      hopper::ldmatrix_x4(ka, kt + kchunk<D>(r, 2 * kk + (j >> 1)) * 16);
      hopper::mma_16816(s, ka, qb[kk][0], qb[kk][1]);
    }
    // online softmax over the warp's 16 keys, a head's over the 8 lanes
    // of its column (lane % 4)
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = TL_NEG_INF;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int key = key0 + r4 + 8 * ii;
        float x = s[2 * ii + e] * scale;
        s[2 * ii + e] = x;
        if (key < n_ok) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[e], mx);
      alpha[e] = expf(m[e] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int key = key0 + r4 + 8 * ii;
        const float pr = key < n_ok ? expf(s[2 * ii + e] - m_new) : 0.f;
        s[2 * ii + e] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[e] = l[e] * alpha[e] + sum;
      m[e] = m_new;
    }
    // P^T as the B fragments (keys 2 c4 + {0, 1}, and + 8, of head r4):
    // the bf16 pairs of S^T's layout, transposed in registers
    const uint32_t pb0 = movmatrix_trans(kvkind::bf16x2(s[0], s[1]));
    const uint32_t pb1 = movmatrix_trans(kvkind::bf16x2(s[2], s[3]));
    // O^T [D dims x 8 heads] += V^T P^T: A fragments of V^T by
    // ldmatrix.trans, lanes 8 j .. 8 j + 7 addressing rows key0 + (lane &
    // 7) + 8 (j >> 1) at chunk 2 mt + (j & 1)
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][x] *= alpha[x & 1];
      const int j = lane >> 3;
      const int r = key0 + (lane & 7) + 8 * (j >> 1);
      uint32_t va[4];
      hopper::ldmatrix_x4_trans(va, vt + kchunk<D>(r, 2 * mt + (j & 1)) * 16);
      hopper::mma_16816(acc[mt], va, pb0, pb1);
    }
    __syncthreads();  // the stage and the bf16 tiles are free again
  }

  // the four sub-splits into the block's partial, a head at a time
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int h = 2 * c4 + e;
    if (h < G) {
      float* ph = part + (w * G + h) * WS;
      if (r4 == 0) {
        ph[0] = m[e];
        ph[1] = l[e];
      }
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        ph[2 + 16 * mt + r4] = acc[mt][e];
        ph[2 + 16 * mt + r4 + 8] = acc[mt][2 + e];
      }
    }
  }
  __syncthreads();
  // a warp a head, a lane two dims of each 64 (pair 32 hf + lane; at D =
  // 32 lanes 0-15)
  for (int h = w; h < G; h += NW) {
    float M = TL_NEG_INF;
#pragma unroll
    for (int x = 0; x < NW; ++x) M = fmaxf(M, part[(x * G + h) * WS]);
    const size_t row = head0 + h;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      const int dd = 64 * hf + 2 * lane;
      if (dd >= D) break;
      float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int x = 0; x < NW; ++x) {
        const float* ph = part + (x * G + h) * WS;
        const float c = expf(ph[0] - M);
        L = fmaf(c, ph[1], L);
        a0 = fmaf(c, ph[2 + dd], a0);
        a1 = fmaf(c, ph[3 + dd], a1);
      }
      if (n_live == 1) {  // the whole walk was this block's
        const float den = L > 0.f ? L : 1.f;
        reinterpret_cast<__nv_bfloat162*>(a.out + row * D)[32 * hf + lane] =
            __floats2bfloat162_rn(a0 / den, a1 / den);
      } else {
        float* ws = a.ws + (row * a.n_split + split) * WS;
        if (hf == 0 && lane == 0) {
          ws[0] = M;
          ws[1] = L;
        }
        reinterpret_cast<float2*>(ws + 2)[32 * hf + lane] = make_float2(a0, a1);
      }
    }
  }
  if (n_live == 1) return;
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0)
    ticket = atomicInc(&g_tickets[b * a.Kh + kh], n_live - 1);
  __syncthreads();
  if (ticket != n_live - 1) return;

  // the last block: merge the group's n_live <= 32 partials, a warp a
  // head, lane i holding partial i's (m, l) and every lane loading its two
  // dims of each acc, 64 dims at a time (past the L1, which may hold
  // nothing of them: the writers fenced)
  for (int h = w; h < G; h += NW) {
    const size_t row = head0 + h;
    const float* ws = a.ws + row * a.n_split * WS;  // this head's partials
    float mp = TL_NEG_INF, lp = 0.f;
    if (lane < n_live) {
      mp = __ldcg(ws + lane * WS);
      lp = __ldcg(ws + lane * WS + 1);
    }
    // dims 64 hf + 2 lane, + 1 of partial x (none past D): issued before
    // the reductions
    auto load = [&](float2 (&pacc)[MAX_SPLITS], int hf) {
#pragma unroll
      for (int x = 0; x < MAX_SPLITS; ++x)
        pacc[x] = x < n_live && 64 * hf + 2 * lane < D
                      ? __ldcg(reinterpret_cast<const float2*>(ws + x * WS + 2) +
                               32 * hf + lane)
                      : make_float2(0.f, 0.f);
    };
    float2 pacc[MAX_SPLITS];
    load(pacc, 0);
    const float M = tl_warp_max(mp);
    const float c = lane < n_live ? expf(mp - M) : 0.f;
    const float den_sum = tl_warp_sum(c * lp);
    const float den = den_sum > 0.f ? den_sum : 1.f;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      if (hf) load(pacc, hf);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int x = 0; x < MAX_SPLITS; ++x) {
        if (x < n_live) {
          const float cx = __shfl_sync(0xffffffffu, c, x);
          a0 = fmaf(cx, pacc[x].x, a0);
          a1 = fmaf(cx, pacc[x].y, a1);
        }
      }
      if (64 * hf + 2 * lane < D)
        reinterpret_cast<__nv_bfloat162*>(a.out + row * D)[32 * hf + lane] =
            __floats2bfloat162_rn(a0 / den, a1 / den);
    }
  }
}

// One launch at a.G (1 .. GMAX) query heads a kv head.
template <int D, bool PAGED, bool STAGED, class KV, bool TRIGGER = false>
int launch(const Args<KV>& a, cudaStream_t st) {
  using T = Tile<KV, D>;
  if (a.G < 1 || a.G > GMAX) return (int)cudaErrorInvalidValue;
  // the ring (f16: 64 KB, f32: 80 KB at D = 64, twice that at D = 128,
  // half at D = 32) and the partials; above 48 KB the attribute's
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<D, PAGED, STAGED, KV, TRIGGER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM + T::part_bytes(GMAX));
  if (attr != cudaSuccess) return (int)attr;
  decode_split_kernel<D, PAGED, STAGED, KV, TRIGGER>
      <<<dim3(a.Kh, a.B, a.n_split), NT, T::SMEM + T::part_bytes(a.G), st>>>(a);
  return (int)cudaGetLastError();
}

// launch at the call's head dim d (32, 64 or 128).
template <bool PAGED, bool STAGED, class KV, bool TRIGGER = false>
int launch_d(const Args<KV>& a, int d, cudaStream_t st) {
  if (d == 32) return launch<32, PAGED, STAGED, KV, TRIGGER>(a, st);
  if (d == 64) return launch<64, PAGED, STAGED, KV, TRIGGER>(a, st);
  if (d == 128) return launch<128, PAGED, STAGED, KV, TRIGGER>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dsplit
