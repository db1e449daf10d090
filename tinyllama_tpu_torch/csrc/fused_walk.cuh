// The weight walk of the port's decode matmuls, for Hopper (sm_90a):
//   out[m, n] = epilogue(sum_k xn[m, k] dequant(w)[k, n]),  m < M <= 32,
// xn the rows of x rms-normed in the kernel (or x as given), w a "kn"
// QTensor (qkind.cuh: q8 int8 [L, K, N], or q4 / q4g uint8 [L, K/2, N]
// nibble byte-rows, fp16 scales [L, K/32 or K/128, N]) stacked over
// layers, the layer index read from device memory, or one unstacked
// layer (a null layer pointer). Its users:
// * K5 fused_norm_qkv (decode_fused.cu): the norm, then x @ wqkv;
// * K6 fused_out_residual (decode_fused.cu): x @ wo + the residual;
// * K7 ffn_fused (ffn_fused.cu): the gate/up pair, whose epilogue writes
//   silu(gate) * up, then down (+ the residual) as a dependent launch;
// * K1 qmm_smallm (qmatmul.cu): x @ w at M <= 8 with a bf16 or f32
//   output, for every linear of the unfused decode branch and the
//   lm_head; with AQ8 (qmm_smallm_aq8) x quantized to int8 in the kernel;
// * K8 fused_attn_out (attn_out_fused.cu): attn @ wo + the residual at
//   M = 1, as a dependent launch after the attention of
//   decode_split.cuh, whose output is its x.
//
// What bounds it on this card: the weight bytes at every M <= 32 (a q8
// byte feeds 2 M <= 64 operations, far below the ~295 at which the tensor
// cores bind), 5.57 MB a call for wqkv, 36.8 MB for the FFN's two weights
// in q8, 67 MB for the lm_head. So every SM streams weight bytes, with
// enough of them in flight:
// * the grid: tiles of 64 or 128 output columns (a 64- or 128-byte strip
//   of each byte-row in every kind; the gate/up pair of K7 takes gate
//   columns [j, j + w) and up columns [F + j, F + j + w) as one tile) times
//   K splits, from shapes and the card's residency only
//   (ops/kernels/fused_plan.py: the widest tile, then the fewest splits, a
//   power of two, that give every SM a block with every cluster resident
//   at once, K1's from a sweep on the card; resident_of() below is the
//   card's count);
// * a ring of 8-17 KB stages a block (about 72 KB at row tile 8, 48 KB
//   for K1, 36 KB above): raw weight byte-rows (16-byte chunks XOR-swizzled so the
//   ldmatrix reads below hit distinct banks) and their fp16 scale rows,
//   cp.async copies that arrive on the stage's mbarrier, issued ahead of
//   the products (16-byte copies where the rows are 16-byte aligned, N %
//   16 == 0; else 4-byte weight and 8-byte scale copies of 4 columns);
//   where a block's share fits the ring, all of it is in flight at once
//   and the warps never wait for each other;
// * x staged once a block: only its split's K slice of the M rows (bf16)
//   and of the norm weight, copied before the weights. With a norm, each
//   split sums the squares of its own slice and pushes the sums to every
//   split of its tile (one thread-block cluster) with asynchronous stores
//   counted on the receiver's mbarrier; each adds them in split order and
//   normalizes and rounds only its slice. No cluster barrier stands on
//   that path (a releasing barrier and remote loads there cost K5 0.7 us
//   at M = 1, PERF.md: the release may wait for the weight copies still
//   in flight);
// * the products on the tensor cores at every M, transposed (out^T = W^T
//   x^T) as K2's: mma.sync.m16n8k16 with the dequantized weight as the A
//   operand in registers (ldmatrix.trans of the raw bytes, as K2) and the
//   staged x rows as B (row tiles of 8, 16 and 32). The dequantized weight
//   never goes back to shared memory. The two rounding regimes of the TPU
//   kernel's dot bodies stay (tinyllama_tpu/ops/pallas/ffn_fused.py
//   _block_dot_q for bm <= 8, _tile_dot_q above):
//   - row tile 8 (M <= 8): A holds the integer values q, or v - 7, exact
//     in bf16, and each 32-row block's two k16 products go to a fresh f32
//     accumulator that is scaled by the block's fp16 scale after the dot:
//     exact products of x with q in f32 sums, scaled after, as the
//     blockdot body (only the order of the f32 additions differs);
//   - row tiles 16, 32: A holds q * s, or (v - 7) * s, exact in f32 and
//     rounded to bf16 once, as the tile-dequantizing body;
// * AQ8 (K1's int8 activations, row tile 8; the aq8 branch of the TPU's
//   small-M matmul, tinyllama_tpu/ops/pallas/qmatmul.py block_x): once
//   its slice has landed, a split quantizes it in place, 8 lanes a (row,
//   32-block): round(x * 127 / absmax) half to even (IEEE division), the
//   block's scale absmax * (1 / 127) beside its 32 bytes, each byte at the
//   k the A fragment below gives it. A block's absmax is its own, so no
//   split needs another's. Each 32-row block is then one
//   mma.sync.m16n8k32 s8 into an int32 accumulator of its own (exact:
//   |dot| <= 32 * 127 * 128 < 2^24), its A the raw int8 bytes (or v - 7)
//   of ldmatrix.trans regrouped by byte permutes into 4 K-rows of one
//   column, and (float(dot) * x scale) * weight scale joins the f32 sum,
//   in the TPU body's order;
// * split K summed in the cluster: each split adds its warps' sums into
//   an f32 partial tile (the idle ring), and, once every split of the
//   cluster is done with its x slice (a relaxed cluster barrier, nothing
//   in flight), pushes each 4-column vector of it to the split whose share
//   of the outputs it is, into that split's x slice, counted on its
//   mbarrier; each split adds its share over the splits in split order
//   and runs the epilogue (bf16 or f32 out, silu(gate) * up, or the
//   residual added to the f32 sum): deterministic, one launch, nothing in
//   device memory.
// On the card (PERF.md) K5 at M = 1 takes 7.3 us against a 1.7 us bound:
// the layer index's load, the x slice and the norm's exchange come before
// the products, and the weight stream alone takes about 4 us.
// Ragged M (rows past M zero, never written), K (at M <= 8, a last half
// step of 32 rows zero-filled; above, K is whole steps, as qmatmul's tile
// regime takes it) and N (whole 4-column groups; a tile's columns past N
// zero-filled, never written). A launch allocates nothing and never
// synchronizes the card, so a decode step stays capturable in a CUDA graph.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "qkind.cuh"

// Internal linkage: qmatmul.cu, decode_fused.cu, ffn_fused.cu and
// attn_out_fused.cu each instantiate the kernel and its launcher into
// their own library, and the libraries live in one process; shared (weak)
// symbols would let one library's launcher or kernel handle stand in for
// another's.
namespace fwalk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 64;         // K-rows of a step: 4 k16 products
constexpr int MAX_SPLITS = 8;    // a portable cluster
constexpr int MAX_M = 32;
constexpr int XPAD = 8;          // bf16 pad of a staged x row (conflict-free ldmatrix)
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may have
constexpr int BARRIERS = 128;    // bytes for the ring's and the x slice's mbarriers
// 1 / 127 rounded once to f32, as the TPU body's absmax * (1.0 / 127.0)
constexpr float INV_127 = (float)(1.0 / 127.0);

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The staged x row length of a launch: the most steps a split has.
__host__ __device__ inline int slice_len(int nsteps, int splits) {
  return (nsteps + splits - 1) / splits * STEP;
}

// The ring of a K1 block (row tile 8, no norm): 48 KB, where K1's plan
// sweep on the card (PERF.md §6) found 72 KB (K5's) 1-2 us slower at
// the lm_head and aq8's w_gateup (fewer blocks resident an SM).
constexpr int QMM_RING = 49152;

// A block's geometry, for BITS-bit weights, row tile MT and tiles of NSEG
// segments of SW columns (SW bytes of each byte-row); QMM: K1's launch
// (no norm weight's slice, its own ring).
template <int MT, int BITS, int SW, int NSEG, bool QMM = false>
struct Geo {
  static constexpr int TW = SW * NSEG;      // bytes of a byte-row's strip = tile columns
  static constexpr int CH = TW / 16;        // its 16-byte chunks = 16-column groups
  static constexpr int RB = cmax(8192 / TW, STEP * BITS / 8);  // byte-rows a stage
  static constexpr int RK = RB * 8 / BITS;  // K-rows a stage
  static constexpr int SPS = RK / STEP;     // steps a stage
  static constexpr int NSR = RK / 32;       // scale rows a stage holds at most
  static constexpr int WBYTES = RB * TW;    // a stage's weight bytes, then its scale rows
  static constexpr int SLOT = (WBYTES + NSR * TW * 2 + 1023) / 1024 * 1024;
  // ring stages: about 72 KB at row tile 8 (a block's whole share of a
  // weight in flight at once at TinyLlama's widths), 36 KB above, where
  // the x slice takes the room
  static constexpr int NSTAGE = cmax(3, (QMM ? QMM_RING : MT <= 8 ? 73728 : 36864) / SLOT);
  static constexpr int PLD = TW + 4;        // f32 row stride of a partial tile
  // the float4s of the partials pushed to a split (at most MT rows of
  // 4-column vectors of each segment, in a share of every split)
  static constexpr int RECV = (MT * SW / 4 + MAX_SPLITS) * NSEG;
  static_assert(CH <= WARPS ? CH * SPS % WARPS == 0 : CH % WARPS == 0,
                "every warp has the same share of every stage");
  static_assert(RB * CH % THREADS == 0, "whole copies a thread");
  static_assert(MAX_M * PLD * 4 <= NSTAGE * SLOT, "a partial tile fits the ring");
  static_assert((NSTAGE + 3) * 8 <= 128, "the barriers fit");

  // Byte offset of chunk c of byte-row r in a stage: the chunk index XORed
  // with the row so the 8 rows of an ldmatrix matrix hit the 8 16-byte
  // bank groups of a 128-byte line once each.
  __device__ static int pos(int r, int c) {
    return r * TW + ((c ^ (CH == 4 ? (r >> 1) & 3 : r & 7)) << 4);
  }

  // Bytes of the x slice (bf16 rows of KL + XPAD), which the pushed
  // partials take over once every split is done with its own.
  __host__ __device__ static int xbytes(int KL) { return cmax(MT * (KL + XPAD) * 2, RECV * 16); }

  // Dynamic shared memory of a launch: 1 KB of alignment, the ring, the
  // barriers, the row statistic and every split's sums of squares, the x
  // slice and (but for K1) the norm weight's slice (f32).
  __host__ static int smem(int nsteps, int splits) {
    const int KL = slice_len(nsteps, splits);
    return 1024 + NSTAGE * SLOT + BARRIERS + (1 + MAX_SPLITS) * MAX_M * 4 + xbytes(KL) +
           (QMM ? 0 : KL * 4);
  }
};

struct Args {
  const bf16* x;      // [M, K] bf16 rows
  const float* nw;    // [L, K] f32 norm table, or null: x as given
  const int* layer;   // [1], or null: an unstacked weight
  const uint8_t* w;   // the kind's data plane, [L, K, N] or [L, K/2, N]
  const __half* s;    // [L, K >> sshift, N]
  const bf16* res;    // [M, ncols] added to the sums, or null
  void* out;          // [M, ncols], bf16 or f32
  int out_f32;        // the output is f32 (else bf16)
  int M, K, N;        // N: the weight's columns
  int ncols;          // output columns: N, or N / 2 for a gate/up pair
  float eps;
  int inside;         // rsqrt(ms + eps), else 1 / (sqrt(ms) + eps)
  int sshift;         // log2 of the K-rows a scale row covers
  int nsteps;         // ceil(K / STEP)
  int splits;         // the K splits of a tile, one cluster
  int wait_prior;     // the launch depends on the grid before it (PDL)
};

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Byte i of r as a signed int8, exact: 2^23 + (b + 128) as a float's bits.
__device__ inline float q8_value(uint32_t rx, int i) {  // rx = r ^ 0x80808080
  return __int_as_float(__byte_perm(rx, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}
// Nibble-bytes of r (each 0..15) minus 7, exact.
__device__ inline float q4_value(uint32_t nib, int i) {
  return __int_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 + i)) - 8388615.f;
}

__device__ inline float half_of(uint32_t pair, int e) {
  return __half2float(__ushort_as_half((unsigned short)(pair >> (16 * e))));
}

// One warp's step: K-rows [kb, kb + 64) of its 16 columns (chunk g of the
// stage's byte-rows) against the staged rows, into acc. The A rows of the
// warp stand for its 16 columns interleaved (K2's mapping): lane l's rows
// l / 4 and l / 4 + 8 are the columns col and col + 1, col = 16 g + 2 (l /
// 4); its accumulator holds rows m = 8 j + 2 (l % 4) + e of x.
template <int MT, int BITS, class G>
__device__ inline void step_product(const unsigned char* slot, int rowb, int g, int kb,
                                    int sr0, int sshift, int col, const bf16* xr,
                                    int xld, float (&acc)[MT / 8][4]) {
  constexpr bool EXACT = MT <= 8;
  const int lane = threadIdx.x % 32;
  // q8: K-rows 32 x + 8 i .. + 7 in q[4 x + i]; 4 bits: byte-rows 8 i ..
  // + 7 in q[i], K-rows 32 (i / 2) + 8 (i % 2) + {0..7} (high nibbles) and
  // + 16 (low)
  uint32_t q[BITS == 8 ? 8 : 4];
#pragma unroll
  for (int x = 0; x < BITS / 4; ++x)
    hopper::ldmatrix_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(q + 4 * x),
                              slot + G::pos(rowb + 32 * x + lane, g));
  const __half* sc = reinterpret_cast<const __half*>(slot + G::WBYTES);
  auto scales = [&](int k) {  // fp16 scales of columns (col, col + 1) at K-row k
    return *reinterpret_cast<const uint32_t*>(sc + (((k >> sshift) - sr0) * G::TW + col));
  };
  uint32_t A[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!EXACT) {
      const uint32_t sp = scales(kb + 16 * kk);
      s0 = half_of(sp, 0);
      s1 = half_of(sp, 1);
    }
    uint32_t lo = BITS == 8 ? q[2 * kk] : q[2 * (kk / 2)];
    uint32_t hi = BITS == 8 ? q[2 * kk + 1] : q[2 * (kk / 2) + 1];
    if constexpr (BITS == 8) {
      lo ^= 0x80808080u;
      hi ^= 0x80808080u;
    } else {
      const int sh = kk % 2 ? 0 : 4;  // even k16: the high nibbles
      lo = (lo >> sh) & 0x0F0F0F0Fu;
      hi = (hi >> sh) & 0x0F0F0F0Fu;
    }
    auto val = [&](uint32_t r, int b) {
      if constexpr (BITS == 8) return q8_value(r, b);
      return q4_value(r, b);
    };
    // bytes: 0 (K-row 2q, col), 1 (2q, col + 1), 2 (2q + 1, col), 3 (2q + 1, col + 1)
    A[kk][0] = hopper::pack_bf16(val(lo, 0) * s0, val(lo, 2) * s0);
    A[kk][1] = hopper::pack_bf16(val(lo, 1) * s1, val(lo, 3) * s1);
    A[kk][2] = hopper::pack_bf16(val(hi, 0) * s0, val(hi, 2) * s0);
    A[kk][3] = hopper::pack_bf16(val(hi, 1) * s1, val(hi, 3) * s1);
  }
#pragma unroll
  for (int j = 0; j < MT / 8; ++j) {
    // B: rows 8 j .. 8 j + 7 of x; matrices (k 0-7, 8-15) of k16 2 p and
    // of 2 p + 1
    uint32_t b[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
      hopper::ldmatrix_x4(b[p], xr + (8 * j + (lane & 7)) * xld + 32 * p + 8 * (lane >> 3));
    if constexpr (EXACT) {
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {  // the step's two 32-row blocks
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        hopper::mma_16816(t, A[2 * blk], b[blk][0], b[blk][1]);
        hopper::mma_16816(t, A[2 * blk + 1], b[blk][2], b[blk][3]);
        const uint32_t sp = scales(kb + 32 * blk);
        const float s0 = half_of(sp, 0), s1 = half_of(sp, 1);
        acc[j][0] += t[0] * s0;
        acc[j][1] += t[1] * s0;
        acc[j][2] += t[2] * s1;
        acc[j][3] += t[3] * s1;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::mma_16816(acc[j], A[kk], b[kk / 2][2 * (kk % 2)], b[kk / 2][2 * (kk % 2) + 1]);
    }
  }
}

// Four 4-bit values (one a byte, 0..15) -> four signed bytes v - 7: with
// each byte biased by 128 the subtraction never borrows across bytes.
__device__ inline uint32_t minus7(uint32_t v) {
  return ((v | 0x80808080u) - 0x07070707u) ^ 0x80808080u;
}

// Where an AQ8 block keeps the int8 of its K-row p (0..31): at the k of
// the s8 A fragment that step_product_aq8 gives that row. Its A bytes of
// column col are K-rows (2 t, 2 t + 1, 2 t + 8, 2 t + 9) (+ 16) at k 4 t
// .. 4 t + 3 (+ 16), t = lane % 4.
__device__ inline int aq8_slot(int p) {
  return (p & 16) + 4 * ((p >> 1) & 3) + 2 * ((p >> 3) & 1) + (p & 1);
}

// step_product's AQ8 twin (row tile 8): the step's two 32-row blocks,
// each one s8 product of the raw weight bytes (q8) or their v - 7 (4
// bits) with the quantized x rows (x as aq8_slot lays them out: 32 bytes
// a block of 64, the block's f32 scale at byte 32), into a fresh int32
// accumulator, scaled by the x scale of the row and then the weight
// scale of the column, in that order, into acc.
template <int BITS, class G>
__device__ inline void step_product_aq8(const unsigned char* slot, int rowb, int g, int kb,
                                        int sr0, int sshift, int col, const bf16* xr,
                                        int xld, float (&acc)[1][4]) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  // as step_product's: q8 K-rows 32 x + 8 i + {2 t, 2 t + 1} in q[4 x +
  // i]; 4 bits byte-rows 8 i + {2 t, 2 t + 1} in q[i]
  uint32_t q[BITS == 8 ? 8 : 4];
#pragma unroll
  for (int x = 0; x < BITS / 4; ++x)
    hopper::ldmatrix_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(q + 4 * x),
                              slot + G::pos(rowb + 32 * x + lane, g));
  const __half* sc = reinterpret_cast<const __half*>(slot + G::WBYTES);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(xr);
  const int row = 2 * xld;  // bytes of a staged row
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    // K-rows {2 t, 2 t + 1} + 0, 8, 16, 24 of the block, 4 bytes each:
    // (row, col), (row, col + 1), (row + 1, col), (row + 1, col + 1)
    uint32_t r[4];
    if constexpr (BITS == 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = q[4 * blk + i];
    } else {  // byte-row j: K-row j (high nibble) and j + 16 (low)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        r[i] = minus7((q[2 * blk + i] >> 4) & 0x0F0F0F0Fu);
        r[2 + i] = minus7(q[2 * blk + i] & 0x0F0F0F0Fu);
      }
    }
    // A rows l / 4 and l / 4 + 8: columns col and col + 1
    const uint32_t A[4] = {__byte_perm(r[0], r[1], 0x6420), __byte_perm(r[0], r[1], 0x7531),
                           __byte_perm(r[2], r[3], 0x6420), __byte_perm(r[2], r[3], 0x7531)};
    const unsigned char* xk = xb + 64 * blk;
    int d[4] = {0, 0, 0, 0};
    hopper::mma_16832_s8(d, A, *reinterpret_cast<const uint32_t*>(xk + (lane / 4) * row + 4 * t),
                         *reinterpret_cast<const uint32_t*>(xk + (lane / 4) * row + 16 + 4 * t));
    const float sx0 = *reinterpret_cast<const float*>(xk + 2 * t * row + 32);
    const float sx1 = *reinterpret_cast<const float*>(xk + (2 * t + 1) * row + 32);
    const uint32_t sp =
        *reinterpret_cast<const uint32_t*>(sc + ((((kb + 32 * blk) >> sshift) - sr0) * G::TW + col));
    const float s0 = half_of(sp, 0), s1 = half_of(sp, 1);
    acc[0][0] += __fmul_rn(__fmul_rn((float)d[0], sx0), s0);
    acc[0][1] += __fmul_rn(__fmul_rn((float)d[1], sx1), s0);
    acc[0][2] += __fmul_rn(__fmul_rn((float)d[2], sx0), s1);
    acc[0][3] += __fmul_rn(__fmul_rn((float)d[3], sx1), s1);
  }
}

// Block (tile, split) of a launch over grid (tiles, splits), cluster (1,
// splits, 1), tiles of SW output columns. PAIR: the gate/up pair of K7,
// whose epilogue writes silu(gate) * up; else out = sums (+ res). AQ8:
// x quantized to int8 per 32-block, s8 products (row tile 8 only). VEC:
// 16-byte copies (N and ncols % 16 == 0), else 4 columns a copy. QMM:
// K1's launch, which may take an unstacked weight (a null layer) and an
// f32 output; the fused kernels' instantiations go without them.
template <int MT, int BITS, int SW, bool PAIR, bool AQ8, bool VEC, bool QMM>
__global__ void __launch_bounds__(THREADS, 2) walk_kernel(const Args a) {
  static_assert(!AQ8 || (MT == 8 && !PAIR), "aq8 runs at row tile 8, one weight");
  using G = Geo<MT, BITS, SW, PAIR ? 2 : 1, QMM>;
  constexpr int NSTAGE = G::NSTAGE, SLOT = G::SLOT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);  // NSTAGE slots
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NSTAGE * SLOT);
  uint64_t* xbar = full + NSTAGE;                       // the x slice's copies
  uint64_t* ssbar = xbar + 1;                           // every split's sums of squares
  uint64_t* sumbar = xbar + 2;                          // the partials pushed to this split
  float* stat = reinterpret_cast<float*>(ring + NSTAGE * SLOT + BARRIERS);  // [MAX_M] the rms statistic
  float* ss = stat + MAX_M;  // [MAX_SPLITS][MAX_M] each split's sums of squares, pushed by it
  bf16* xs = reinterpret_cast<bf16*>(ss + MAX_SPLITS * MAX_M);  // [MT][KL + XPAD] the x slice

  const int tile = blockIdx.x, split = blockIdx.y;
  const int st0 = split * a.nsteps / a.splits, st1 = (split + 1) * a.nsteps / a.splits;
  const int klo = st0 * STEP, khi = min(st1 * STEP, a.K);
  const int KL = slice_len(a.nsteps, a.splits), xld = KL + XPAD;
  // [KL] the norm weight's slice, after the x slice
  float* nws = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xs) + G::xbytes(KL));
  const int li = QMM && !a.layer ? 0 : a.layer[0];
  const uint8_t* w = a.w + (size_t)li * qkind::plane_bytes(BITS, a.K, a.N);
  const __half* s = a.s + (size_t)li * (a.K >> a.sshift) * a.N;
  const int c0 = tile * SW;  // the tile's first output column
  const int nst = (st1 - st0 + G::SPS - 1) / G::SPS;
  // the tile's outputs as E vectors of 4 columns (row m, columns 4 (e %
  // Q)), those within ncols; split r sums [r E / splits, (r + 1) E /
  // splits), its share
  constexpr int Q = SW / 4;
  const int E = a.M * Q, e0 = split * E / a.splits, e1 = (split + 1) * E / a.splits;
  const int nq = min(Q, (a.ncols - c0) / 4);  // vectors of a row within ncols
  auto valid_below = [&](int e) { return e / Q * nq + min(e % Q, nq); };

  // the copies of stage t into its slot: raw byte-rows, then scale rows;
  // 16 columns a copy, or 4 where a row is not 16-byte aligned
  auto issue = [&](int t) {
    unsigned char* slot = ring + (t % NSTAGE) * SLOT;
    const int k0 = klo + t * G::RK;
    // the first K-row that byte-row r holds (4 bits: rows of its 32-block)
    auto krow = [&](int r) { return BITS == 8 ? k0 + r : k0 + 32 * (r / 16); };
    const int sr0 = k0 >> a.sshift, sr1 = (min(k0 + G::RK, khi) - 1) >> a.sshift;
    unsigned char* sdst = slot + G::WBYTES;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < G::RB * G::CH / THREADS; ++i) {
        const int u = threadIdx.x + i * THREADS, r = u / G::CH, c = u % G::CH;
        const int col = c0 + (c % (SW / 16)) * 16;
        const bool in = krow(r) < khi && col < a.ncols;
        const uint8_t* src =
            w + (size_t)(k0 * BITS / 8 + r) * a.N + (c / (SW / 16)) * a.ncols + col;
        hopper::cp_async16(slot + G::pos(r, c), in ? src : w, in ? 16 : 0);
      }
      if (threadIdx.x < G::NSR * G::TW / 8) {
        const int r = threadIdx.x / (G::TW / 8), c = threadIdx.x % (G::TW / 8);
        const int col = c0 + (c % (SW / 8)) * 8;
        const bool in = sr0 + r <= sr1 && col < a.ncols;
        const __half* src = s + (size_t)(sr0 + r) * a.N + (c / (SW / 8)) * a.ncols + col;
        hopper::cp_async16(sdst + (r * G::TW + c * 8) * 2, in ? src : s, in ? 16 : 0);
      }
    } else {
      auto wsrc = [&](int r, int c) {  // byte-row r, tile column c (its pair half first)
        return w + (size_t)(k0 * BITS / 8 + r) * a.N + (c / SW) * a.ncols + c0 + c % SW;
      };
      auto ssrc = [&](int r, int c) {
        return s + (size_t)(sr0 + r) * a.N + (c / SW) * a.ncols + c0 + c % SW;
      };
#pragma unroll
      for (int i = 0; i < G::RB * G::TW / 4 / THREADS; ++i) {
        const int u = threadIdx.x + i * THREADS, r = u / (G::TW / 4), c = u % (G::TW / 4) * 4;
        const bool in = krow(r) < khi && c0 + c % SW < a.ncols;
        hopper::cp_async4(slot + G::pos(r, c / 16) + c % 16, in ? wsrc(r, c) : w, in ? 4 : 0);
      }
      for (int u = threadIdx.x; u < G::NSR * G::TW / 4; u += THREADS) {
        const int r = u / (G::TW / 4), c = u % (G::TW / 4) * 4;
        const bool in = sr0 + r <= sr1 && c0 + c % SW < a.ncols;
        hopper::cp_async8(sdst + (r * G::TW + c) * 2, in ? ssrc(r, c) : s, in ? 8 : 0);
      }
    }
  };

  // the x slice [klo, khi) of rows < M (rows past M and K zero-filled)
  // and the norm weight's slice, 16-byte copies through L2, arriving on
  // xbar when they and every copy the thread issued before them have landed
  const int vpr = KL / 8;
  const float* nw = a.nw ? a.nw + (size_t)li * a.K : nullptr;
  auto issue_x = [&]() {
    for (int i = threadIdx.x; i < MT * vpr; i += THREADS) {
      const int m = i / vpr, k = (i % vpr) * 8;
      const bool in = m < a.M && klo + k < khi;
      hopper::cp_async16(xs + m * xld + k, in ? a.x + (size_t)m * a.K + klo + k : a.x,
                         in ? 16 : 0);
    }
    for (int k = 4 * threadIdx.x; nw && k < KL; k += 4 * THREADS)
      hopper::cp_async16(nws + k, klo + k < khi ? nw + klo + k : nw, klo + k < khi ? 16 : 0);
    hopper::cp_async_arrive(xbar);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= NSTAGE; ++i) hopper::mbar_init(&full[i], THREADS);  // and xbar
    hopper::mbar_init(ssbar, 1);
    hopper::mbar_init(sumbar, 1);
    hopper::mbar_init_fence();
    if (a.nw) hopper::mbar_expect(ssbar, a.splits * a.M * 4);
    hopper::mbar_expect(sumbar, a.splits * (valid_below(e1) - valid_below(e0)) * 16 * (PAIR ? 2 : 1));
  }
  __syncthreads();
  // every split's barriers initialized before another pushes into them
  // (while the layer index is loaded)
  hopper::cluster_arrive_relaxed();
  hopper::cluster_wait();
  if (!a.wait_prior) issue_x();
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < nst) {
      issue(t);
      hopper::cp_async_arrive(&full[t]);
    }
  }
  if constexpr (PAIR) hopper::launch_dependents();
  if (a.wait_prior) {  // x is the output of the grid before
    hopper::wait_prior_grid();
    issue_x();
  }
  // rms_norm: this split's sums of squares of its slice, pushed to every
  // split of the cluster (asynchronous stores counted on their barriers,
  // no releasing cluster barrier while the weight copies are in flight),
  // added in split order, then this slice normalized and rounded to bf16
  // in place
  hopper::mbar_wait(xbar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (a.nw) {
    for (int m = warp; m < a.M; m += WARPS) {
      float acc = 0.f;
      for (int k = lane * 2; k < khi - klo; k += 64) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + m * xld + k));
        acc += f.x * f.x + f.y * f.y;
      }
      acc = warp_sum(acc);
      if (lane < a.splits)  // lane r to split r
        hopper::st_async(hopper::cluster_addr(ss + split * MAX_M + m, lane), acc,
                         hopper::cluster_addr(ssbar, lane));
    }
    hopper::mbar_wait_cluster(ssbar, 0);
    if (threadIdx.x < a.M) {
      float t = 0.f;
      for (int r = 0; r < a.splits; ++r) t += ss[r * MAX_M + threadIdx.x];
      const float ms = t / (float)a.K;
      stat[threadIdx.x] = a.inside ? rsqrtf(ms + a.eps) : sqrtf(ms) + a.eps;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < a.M * vpr; i += THREADS) {
      const int m = i / vpr, k = (i % vpr) * 8;
      if (klo + k >= khi) continue;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(xs + m * xld + k);
      const float st = stat[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        const float n0 = (a.inside ? f.x * st : f.x / st) * nws[k + 2 * e];
        const float n1 = (a.inside ? f.y * st : f.y / st) * nws[k + 2 * e + 1];
        p[e] = __floats2bfloat162_rn(n0, n1);
      }
    }
    __syncthreads();
  }
  if constexpr (AQ8) {
    // the slice quantized in place, a (row, 32-block) to 8 lanes of 4
    // values, 4 a warp: each value's int8 at aq8_slot in the block's
    // first 32 bytes, the block's scale at byte 32 (rows past M and
    // blocks past K stay zero)
    const int nb = (khi - klo) / 32, j = lane % 8;
    for (int i0 = 4 * warp; i0 < a.M * nb; i0 += 4 * WARPS) {
      const int i = i0 + lane / 8;
      const bool on = i < a.M * nb;
      bf16* xv = xs + (on ? i / nb * xld + 32 * (i % nb) : 0);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (on) {
        const uint2 u = *reinterpret_cast<const uint2*>(xv + 4 * j);
        const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v[0] = f0.x, v[1] = f0.y, v[2] = f1.x, v[3] = f1.y;
      }
      float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
      for (int o = 4; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float inv = amax > 0.f ? 127.f / amax : 0.f;
      __syncwarp();
      if (on) {
        unsigned char* xq = reinterpret_cast<unsigned char*>(xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) xq[aq8_slot(4 * j + e)] = (unsigned char)__float2int_rn(v[e] * inv);
        if (j == 0) *reinterpret_cast<float*>(xq + 32) = amax * INV_127;
      }
    }
    __syncthreads();
  }

  // the walk: with CH <= 8 column groups, warp w takes group w % CH of
  // steps w / CH, w / CH + WARPS / CH, ... of every stage; with 16, groups
  // w and w + 8 of every step
  constexpr int GW = G::CH < WARPS ? G::CH : WARPS;  // groups side by side
  constexpr int GPW = G::CH / GW;                    // groups a warp
  constexpr int WPG = WARPS / GW;                    // warps a group
  float acc[GPW][MT / 8][4];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
    for (int j = 0; j < MT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.f;
  auto col_of = [&](int gi) { return 16 * (warp % GW + GW * gi) + 2 * (lane / 4); };
  for (int t = 0; t < nst; ++t) {
    const int nx = t + NSTAGE - 1;  // into the slot that stage t - 1 freed
    if (nx < nst) {
      issue(nx);
      hopper::cp_async_arrive(&full[nx % NSTAGE]);
    }
    hopper::mbar_wait(&full[t % NSTAGE], (t / NSTAGE) & 1);
    const unsigned char* slot = ring + (t % NSTAGE) * SLOT;
    const int k0 = klo + t * G::RK, here = min(G::SPS, st1 - st0 - t * G::SPS);
    for (int j = warp / GW; j < here; j += WPG)
#pragma unroll
      for (int gi = 0; gi < GPW; ++gi) {
        if constexpr (AQ8)
          step_product_aq8<BITS, G>(slot, j * STEP * BITS / 8, warp % GW + GW * gi,
                                    k0 + STEP * j, k0 >> a.sshift, a.sshift, col_of(gi),
                                    xs + k0 + STEP * j - klo, xld, acc[gi]);
        else
          step_product<MT, BITS, G>(slot, j * STEP * BITS / 8, warp % GW + GW * gi,
                                    k0 + STEP * j, k0 >> a.sshift, a.sshift, col_of(gi),
                                    xs + k0 + STEP * j - klo, xld, acc[gi]);
      }
    // every warp is done with the slot before it is filled again (where
    // the whole walk fits the ring, the warps never wait for each other)
    if (t + NSTAGE < nst) __syncthreads();
  }
  __syncthreads();

  // the block's partial tile in the idle ring, the warps of one column
  // group added in warp order
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int pass = 0; pass < WPG; ++pass) {
    if (warp / GW == pass) {
#pragma unroll
      for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
        for (int j = 0; j < MT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* p = part + (8 * j + 2 * (lane % 4) + (e & 1)) * G::PLD + col_of(gi) +
                       (e >> 1);
            *p = pass ? *p + acc[gi][j][e] : acc[gi][j][e];
          }
    }
    __syncthreads();
  }

  // the cluster's sum: every split pushes each vector of its partial to
  // the split whose share it is (asynchronous stores into that split's x
  // slice, counted on its barrier, once every split is done with its
  // own), and each adds its share over the splits in split order
  hopper::cluster_arrive_relaxed();
  hopper::cluster_wait();
  float4* recv = reinterpret_cast<float4*>(xs);  // [splits][share][PAIR ? 2 : 1]
  for (int e = threadIdx.x; e < E; e += THREADS) {
    const int m = e / Q, c = (e % Q) * 4;
    if (c0 + c >= a.ncols) continue;
    const int r = ((e + 1) * a.splits + E - 1) / E - 1;  // the split whose share e is
    const int r0 = r * E / a.splits, share = (r + 1) * E / a.splits - r0;
    const float* p = part + m * G::PLD + c;
    const int slot = (split * share + e - r0) * (PAIR ? 2 : 1);
    const uint32_t bar = hopper::cluster_addr(sumbar, r);
    hopper::st_async(hopper::cluster_addr(recv + slot, r), *reinterpret_cast<const float4*>(p),
                     bar);
    if constexpr (PAIR)
      hopper::st_async(hopper::cluster_addr(recv + slot + 1, r),
                       *reinterpret_cast<const float4*>(p + SW), bar);
  }
  hopper::mbar_wait_cluster(sumbar, 0);
  const int share = e1 - e0;
  for (int e = e0 + threadIdx.x; e < e1; e += THREADS) {
    const int m = e / Q, n = c0 + (e % Q) * 4;
    if (n >= a.ncols) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < a.splits; ++r) {
      const float4* q = recv + (r * share + e - e0) * (PAIR ? 2 : 1);
      const float4 g = q[0];
      v[0] += g.x;
      v[1] += g.y;
      v[2] += g.z;
      v[3] += g.w;
      if constexpr (PAIR) {
        const float4 h = q[1];
        u[0] += h.x;
        u[1] += h.y;
        u[2] += h.z;
        u[3] += h.w;
      }
    }
    const size_t o = (size_t)m * a.ncols + n;
    if constexpr (PAIR) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = v[j] / (1.f + expf(-v[j])) * u[j];
    } else if (a.res) {
      const uint2 rv = *reinterpret_cast<const uint2*>(a.res + o);
      const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.x));
      const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.y));
      v[0] += r01.x;
      v[1] += r01.y;
      v[2] += r23.x;
      v[3] += r23.y;
    }
    if (QMM && a.out_f32)
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + o) =
          make_uint2(hopper::pack_bf16(v[0], v[1]), hopper::pack_bf16(v[2], v[3]));
  }
}

// Call f(std::integral_constant<int, MT>{}) with the row tile of M
// (1 <= M <= 32): 8 up to 8 rows (the exact regime), then 16, 32.
template <class F>
__host__ inline int with_row_tile(int M, F f) {
  if (M <= 8) return f(std::integral_constant<int, 8>{});
  if (M <= 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

// Call f(std::integral_constant<int, SW>{}) with a tile width of 64 or 128
// columns; another width is refused.
template <class F>
__host__ inline int with_width(int width, F f) {
  if (width == 64) return f(std::integral_constant<int, 64>{});
  if (width == 128) return f(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

// Whether a launch of this shape is refused: kind, M, K (a multiple of the
// scale block; above 8 rows, of a whole step, as qmatmul's tile regime
// takes it), output columns (whole 4-column groups; whole 16-column
// groups, of N too, where the library has no 4-column copies), splits.
__host__ inline bool bad_shape(int kind, int M, int K, int ncols, int splits) {
  const int nsteps = (K + STEP - 1) / STEP;
  return !qkind::valid(kind) || M < 1 || M > MAX_M || K < 32 ||
         K % qkind::scale_rows(kind) || K % 32 || (M > 8 && K % STEP) || ncols < 4 ||
         ncols % 4 || splits < 1 || splits > MAX_SPLITS || splits > nsteps;
}

// One launch of walk_kernel<MT, BITS, SW, PAIR, AQ8, VEC> over grid
// (ncols / SW tiles, splits), each tile's splits one cluster, with
// `bytes` of shared memory; pdl: the launch may start while the grid
// before it runs (programmatic stream serialization), and its blocks
// wait for that grid before they read x.
template <int MT, int BITS, int SW, bool PAIR, bool AQ8, bool VEC, bool QMM>
__host__ inline int launch_one(const Args& a, int bytes, bool pdl, cudaStream_t st) {
  auto kernel = walk_kernel<MT, BITS, SW, PAIR, AQ8, VEC, QMM>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.ncols + SW - 1) / SW, a.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = a.splits;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// A launch of the walk: VEC where N and ncols are whole 16-column
// groups; else, for K1 (QMM), the 4-column copies; else refused.
template <int MT, int BITS, int SW, bool PAIR, bool AQ8 = false, bool QMM = false>
__host__ inline int launch(Args a, int kind, bool pdl, cudaStream_t st) {
  a.sshift = qkind::scale_shift(kind);
  a.nsteps = (a.K + STEP - 1) / STEP;
  a.wait_prior = pdl;
  const int bytes = Geo<MT, BITS, SW, PAIR ? 2 : 1, QMM>::smem(a.nsteps, a.splits);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (a.N % 16 == 0 && a.ncols % 16 == 0)
    return launch_one<MT, BITS, SW, PAIR, AQ8, true, QMM>(a, bytes, pdl, st);
  if constexpr (QMM) return launch_one<MT, BITS, SW, PAIR, AQ8, false, QMM>(a, bytes, pdl, st);
  return (int)cudaErrorInvalidValue;
}

// The clusters of walk_kernel<MT, BITS, SW, PAIR, AQ8, VEC, QMM> over K
// rows in `splits` splits that the card keeps resident at once, into
// *clusters: the grid runs in one wave when clusters * splits reaches its
// blocks. VEC as launch() chooses it: the two copy widths compile to
// kernels of their own registers.
template <int MT, int BITS, int SW, bool PAIR, bool AQ8 = false, bool QMM = false,
          bool VEC = true>
__host__ inline int resident_of(int K, int splits, int* clusters) {
  auto kernel = walk_kernel<MT, BITS, SW, PAIR, AQ8, VEC, QMM>;
  cudaLaunchConfig_t cfg = {};
  cfg.dynamicSmemBytes =
      Geo<MT, BITS, SW, PAIR ? 2 : 1, QMM>::smem((K + STEP - 1) / STEP, splits);
  if (cfg.dynamicSmemBytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(1, splits);
  cfg.blockDim = dim3(THREADS);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// resident_of for a launch of this shape at any M <= 32 (K5, K6, K7).
// PAIR: K7's gate/up launch.
template <bool PAIR>
__host__ inline int resident(int kind, int M, int K, int width, int splits, int* clusters) {
  if (bad_shape(kind, M, K, 32, splits)) return (int)cudaErrorInvalidValue;
  return with_row_tile(M, [&](auto mt) {
    return qkind::with_bits(kind, [&](auto bits) {
      return with_width(width, [&](auto sw) {
        return resident_of<decltype(mt)::value, decltype(bits)::value, decltype(sw)::value,
                           PAIR>(K, splits, clusters);
      });
    });
  });
}

}  // namespace
}  // namespace fwalk
