// Weight-only quantized matmul for Hopper (sm_90a):
//   out[M, N] = x[M, K] (bf16) @ dequant(w)[K, N],  f32 accumulation.
//
// The weight is the port's "kn" QTensor (qkind.cuh): q8 int8 data
// [L, K, N], or 4-bit (q4, q4g) data [L, K/2, N] whose byte-rows each pack
// two K-rows of a 32-row block; fp16 block scales [L, K/32, N] (q8, q4) or
// [L, K/128, N] (q4g). Both planes are stacked over layers; the layer
// index is read from device memory (a null pointer means an unstacked
// weight), so no layer is ever sliced or copied and a decode step stays
// capturable. Each kernel is a template on the bits; q4 and q4g differ
// only in the scale row a 32-row block reads.
//
// K1 qmm_smallm (M <= 8, decode) replaces _qmm_kernel_smallm in
//   tinyllama_tpu/ops/pallas/qmatmul.py (its q8 and q4/q4g bodies): every
//   linear of the unfused decode branch and the lm_head (f32 logits).
//   Bound: the weight bytes over the memory rate (2 * M flops per weight
//   byte at q8, 4 * M at 4 bits, far below the ridge). Design: the walk of
//   fused_walk.cuh at row tile 8 with x as given (no norm, no residual):
//   tiles of 64 or 128 columns times K splits from shapes and the card's
//   residency (ops/kernels/qmatmul.py smallm_plan: w_down 16 tiles x 8
//   splits, the lm_head 256 tiles of 128 unsplit), a cp.async ring of raw
//   weight rows, products on mma.sync with the integer values q (or v - 7)
//   in bf16 as A, each 32-row block's dot in a fresh f32 accumulator
//   scaled by its fp16 scale after the dot, as the TPU kernel does; the
//   splits' partials summed in split order in the cluster, and a bf16 or
//   f32 output. A null layer pointer means an unstacked weight (the
//   lm_head). x slices of up to 6,144 rows a split (K up to 49,152 rows:
//   Llama-3-70B's w_down is 28,672), any N % 4 == 0 (rows not 16-byte
//   aligned are copied 4 columns at a time).
//   The AQ8 instantiation (qmm_smallm_aq8; the q8a8 and q4a8 policies)
//   replaces the aq8 branch of the same body (block_x and its int8 dots):
//   each split quantizes its x slice to int8 per 32-block as it lands,
//   round(x * 127 / absmax) half to even (IEEE division, no fast math),
//   and each 32-row block is one mma.sync.m16n8k32 s8 product of those
//   bytes with the int8 weight (or its v - 7) into an exact int32
//   accumulator; (float(dot) * x scale) * weight scale joins the f32 sum,
//   in the TPU body's order. q4g has no aq8 branch.
//
// K2 qmm_bigm (M > 8, prefill) replaces _qmm_kernel_bigm + _dequant_tile
//   in tinyllama_tpu/ops/pallas/qmatmul.py (q8 and q4/q4g bodies). Bound:
//   the weight bytes over the memory rate at M <= 256 (a q8 byte feeds
//   2 M operations, below the ~295 at which the tensor cores bind), the
//   tensor-core operations (2 M K N over 989 TFLOP/s) above. Design:
//   * products on wgmma, taken transposed (out^T = W^T x^T), as Hopper's
//     mixed-input products are: a block owns a 128 x 128 output tile, two
//     warpgroups of 64 of its columns; each issues wgmma.m64n128k16 (bf16
//     operands, f32 accumulators in registers) over 64-deep K steps, A
//     its 64 columns of the dequantized weight, in registers, B the x
//     tile's 128 rows, in shared memory with the 128-byte swizzle
//     (hopper.cuh). The dequantized weight never goes through shared
//     memory: an earlier version that stored it there as wgmma's B
//     operand (MN-major) was bound by shared-memory traffic, 15-20%
//     slower at M >= 512 on the card;
//   * an asynchronous ring of 4 stages, each the x tile, the step's raw
//     weight rows (8 KB in q8, 4 KB at 4 bits; 16-byte chunks swizzled)
//     and its fp16 scale rows, filled by cp.async copies that arrive on
//     the stage's mbarrier, three steps ahead of the products;
//   * dequantized once a block and step, bit for bit as before: q * s or
//     (v - 7) * s, exact in f32, rounded to bf16 once (the TPU body's
//     hi16 * (s/16) + s). ldmatrix.trans of the raw bytes, read as 16-bit
//     pairs, hands each lane the bytes its A fragment wants (the A rows of
//     a warp stand for its 16 columns interleaved: row r for column 2 r,
//     row r + 8 for 2 r + 1), and step t + 1 is dequantized into a second
//     register set while step t's products run. With 128 rows a tile
//     each weight byte is dequantized M / 128 times, once in the whole
//     grid at M <= 128;
//   * split K where the tiles alone do not fill the card: the host picks
//     the split count from shapes only (ops/kernels/qmatmul.py
//     bigm_splits: about one block an SM), the splits of a tile run as
//     one thread-block cluster, each keeps its f32 partial in its own
//     shared memory, and after a cluster barrier each sums a slice of the
//     tile's rows over every partial, in split order, through distributed
//     shared memory: deterministic, one launch, nothing in device memory
//     (a wrapping ticket and f32 partials in device memory, summed by the
//     tile's last split, cost 20-40 us at M = 128 on the card: one
//     block's chain of L2 round trips);
//   * the N tiles of one M tile are neighbours in the grid, so they share
//     its x rows while a layer's weight stays in the 50 MB L2;
//   * ragged M (rows past M zero-filled) and N (masked) at any size.
//   Two blocks an SM: 101 KB of shared memory and at most 128 registers
//   a thread. At M >= 2,048 the x tiles that every column tile re-reads
//   from the L2 bound it (PERF.md).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fused_walk.cuh"
#include "hopper.cuh"
#include "qkind.cuh"

namespace {

constexpr int QBLOCK = 32;

template <typename T>
__device__ inline void store_out(T* p, float v);
template <>
__device__ inline void store_out<float>(float* p, float v) { *p = v; }
template <>
__device__ inline void store_out<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------- K2 ----

constexpr int BG_THREADS = 256;              // two warpgroups of 64 columns
constexpr int BM = 128, BN = 128, BK = 2 * QBLOCK;
constexpr int NSTAGE = 4;                    // ring stages
constexpr int A_BYTES = BM * BK * 2;         // bf16 x tile, swizzled
constexpr int W_BYTES = BK * BN;             // raw weight bytes (q8; 4 bits half)
constexpr int S_BYTES = 2 * BN * 2;          // at most two fp16 scale rows
constexpr int SLOT = 25 * 1024;              // one stage, 1 KB aligned
constexpr int BG_SMEM = NSTAGE * SLOT + 8 * NSTAGE + 1024;
static_assert(A_BYTES + W_BYTES + S_BYTES <= SLOT, "a stage fits its slot");
constexpr int MAX_SPLITS = 8;    // a portable cluster of at most 8 blocks
constexpr int PART_LD = BN + 4;  // f32 row stride of a partial tile
static_assert(BM * PART_LD * 4 <= NSTAGE * SLOT, "a partial tile fits the ring");

template <typename OutT>
struct BigmArgs {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const __half* s;
  const int* layer;
  OutT* out;
  int M, K, N, sshift, n_nt, splits;
};

// Issue one K step's copies into a ring slot: the x tile [BM, BK]
// (128-byte swizzled rows, rows past M zero-filled), the raw weight rows
// of the step (q8: BK rows of BN bytes; 4 bits: BK / 2 byte-rows), their
// 16-byte chunks swizzled as the x rows are, and its scale rows. VEC: N %
// 16 == 0, every weight and scale chunk a 16-byte cp.async (zero-filled
// past N); otherwise the weight and scales are loaded a value at a time
// and stored (the block synchronizes before they are read).
template <int BITS, bool VEC, typename OutT>
__device__ inline void bigm_issue(const BigmArgs<OutT>& a, const uint8_t* w,
                                  const __half* s, unsigned char* slot, int m0,
                                  int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < A_BYTES / 16 / BG_THREADS; ++i) {
    const int u = tid + i * BG_THREADS, r = u >> 3, c = u & 7;
    const bool in = m0 + r < a.M;
    hopper::cp_async16(slot + hopper::swz(r, c),
                       in ? a.x + (size_t)(m0 + r) * a.K + k0 + c * 8 : a.x,
                       in ? 16 : 0);
  }
  constexpr int WUNITS = BK * BITS / 8 * BN / 16;  // 16-byte weight units
  unsigned char* wdst = slot + A_BYTES;
#pragma unroll
  for (int i = 0; i < (WUNITS + BG_THREADS - 1) / BG_THREADS; ++i) {
    const int u = tid + i * BG_THREADS;
    if (u >= WUNITS) break;
    const int r = u >> 3, c = u & 7, n = n0 + c * 16;
    const uint8_t* src = w + (size_t)(k0 * BITS / 8 + r) * a.N + n;
    unsigned char* dst = wdst + hopper::swz(r, c);
    if constexpr (VEC) {
      hopper::cp_async16(dst, n < a.N ? src : w, n < a.N ? 16 : 0);
    } else {
      uint32_t q[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (n + j < a.N) q[j / 4] |= (uint32_t)src[j] << (8 * (j % 4));
      *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  const int sr0 = k0 >> a.sshift;
  const int nsr = ((k0 + BK - 1) >> a.sshift) - sr0 + 1;  // 2, or 1 for q4g
  if (tid < nsr * (BN / 8)) {
    const int r = tid / (BN / 8), c = (tid % (BN / 8)) * 8, n = n0 + c;
    const __half* src = s + (size_t)(sr0 + r) * a.N + n;
    unsigned char* dst = slot + A_BYTES + W_BYTES + (r * BN + c) * 2;
    if constexpr (VEC) {
      hopper::cp_async16(dst, n < a.N ? src : s, n < a.N ? 16 : 0);
    } else {
      uint32_t h[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + j < a.N) h[j / 2] |= (uint32_t)__half_as_ushort(src[j]) << (16 * (j % 2));
      *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
}

__device__ inline float hscale(uint32_t pair, int e) {
  return __half2float(__ushort_as_half((unsigned short)(pair >> (16 * e))));
}

// The dequantized weight of one landed stage as the A operand of the
// step's four k16 products: W^T, rows the warpgroup's 64 output columns.
// Warp w's rows 16 w + l / 4 and that + 8 stand for the columns c and c +
// 1, c = 64 wg + 16 w + 2 (l / 4): ldmatrix.trans of the raw bytes read as
// 16-bit pairs gives lane l the bytes of columns (c, c + 1) at K-rows 2 (l
// % 4) and that + 1 of each 8-row matrix, so each value is where its A
// fragment wants it. A value is q * s, or (v - 7) * s, exact in f32 and
// rounded to bf16 once, as the TPU body's hi16 * (s/16) + s.
template <int BITS>
__device__ inline void bigm_a_operand(const unsigned char* slot, int k0, int sshift,
                                      int col, uint32_t (&A)[BK / 16][4]) {
  const int lane = threadIdx.x % 32;
  const unsigned char* raw = slot + A_BYTES;
  const __half* sc = reinterpret_cast<const __half*>(slot + A_BYTES + W_BYTES);
  const int chunk = col / 16;  // the warp's 16 columns: one 16-byte chunk
  // q8: K-rows 32 x .. 32 x + 31 as four 8-row matrices; 4 bits: byte-rows
  // 0 .. 31, each K-rows (byte-row / 16) * 32 + byte-row % 16 (high
  // nibble) and that + 16 (low)
  uint32_t m[BITS == 8 ? 8 : 4];
#pragma unroll
  for (int x = 0; x < BITS / 4; ++x) {
    const int row = 32 * x + lane;
    hopper::ldmatrix_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(m + 4 * x),
                              raw + hopper::swz(row, chunk));
  }
  const int sr0 = k0 >> sshift;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // the scales of columns (col, col + 1) for K-rows k0 + 16 kk ..
    const uint32_t sp = *reinterpret_cast<const uint32_t*>(
        sc + (((k0 + 16 * kk) >> sshift) - sr0) * BN + col);
    const float s0 = hscale(sp, 0), s1 = hscale(sp, 1);
    // the matrices of K-rows 16 kk .. + 7 and 16 kk + 8 .. + 15
    const uint32_t lo = BITS == 8 ? m[2 * kk] : m[2 * (kk / 2)];
    const uint32_t hi = BITS == 8 ? m[2 * kk + 1] : m[2 * (kk / 2) + 1];
    auto val = [&](uint32_t r, int b) {
      const uint32_t byte = (r >> (8 * b)) & 0xFFu;
      if constexpr (BITS == 8) return (float)(int8_t)byte;
      return kk % 2 ? qkind::lo4(byte) : qkind::hi4(byte);
    };
    // bytes: 0 (row 2q, col c), 1 (2q, c + 1), 2 (2q + 1, c), 3 (2q + 1, c + 1)
    A[kk][0] = hopper::pack_bf16(val(lo, 0) * s0, val(lo, 2) * s0);
    A[kk][1] = hopper::pack_bf16(val(lo, 1) * s1, val(lo, 3) * s1);
    A[kk][2] = hopper::pack_bf16(val(hi, 0) * s0, val(hi, 2) * s0);
    A[kk][3] = hopper::pack_bf16(val(hi, 1) * s1, val(hi, 3) * s1);
  }
}

template <typename OutT>
__device__ inline void bigm_store(OutT* out, int N, int row, int col, float v0, float v1) {
  OutT* p = out + (size_t)row * N + col;
  if (col + 1 < N) {
    if ((N & 1) == 0) {
      if constexpr (std::is_same<OutT, float>::value)
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(v0, v1);
      return;
    }
    store_out(p + 1, v1);
  }
  if (col < N) store_out(p, v0);
}

// Block (tile, split): output tile tile % n_nt along N, tile / n_nt
// along M (the N tiles of one M tile are neighbours: they share its x
// rows, and a layer's weight, at most 12.3 MB in q8, stays in the L2
// across M tiles), over K steps [split * nk / splits, (split + 1) * nk /
// splits). The products compute the tile transposed, out^T = W^T x^T:
// each warpgroup owns 64 of its columns as the A operand, from registers,
// and x's 128 rows are the B operand, from shared memory.
template <typename OutT, int BITS, bool VEC>
__global__ void __launch_bounds__(BG_THREADS, 2) qmm_bigm_kernel(const BigmArgs<OutT> a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);  // NSTAGE slots
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NSTAGE * SLOT);

  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile / a.n_nt) * BM, n0 = (tile % a.n_nt) * BN;
  const int nk = a.K / BK;
  const int s0 = split * nk / a.splits, nsteps = (split + 1) * nk / a.splits - s0;
  const int li = a.layer ? a.layer[0] : 0;
  const uint8_t* w = a.w + (size_t)li * qkind::plane_bytes(BITS, a.K, a.N);
  const __half* s = a.s + (size_t)li * (a.K >> a.sshift) * a.N;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGE; ++i) hopper::mbar_init(&full[i], BG_THREADS);
    hopper::mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < nsteps) {
      bigm_issue<BITS, VEC>(a, w, s, ring + i * SLOT, m0, n0, (s0 + i) * BK);
      hopper::cp_async_arrive(&full[i]);
    }
  }

  const int wg = threadIdx.x / 128, wr = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int col = 64 * wg + 16 * wr + 2 * (lane / 4);  // this thread's columns col, col + 1
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // the A operands of two steps: step t + 1's is dequantized while step
  // t's products run
  uint32_t A0[BK / 16][4], A1[BK / 16][4];
  auto step = [&](int t, uint32_t(&cur)[BK / 16][4], uint32_t(&next)[BK / 16][4]) {
    // step t + NSTAGE - 1 into the slot that step t - 1 freed
    const int nx = t + NSTAGE - 1;
    if (nx < nsteps) {
      bigm_issue<BITS, VEC>(a, w, s, ring + (nx % NSTAGE) * SLOT, m0, n0, (s0 + nx) * BK);
      hopper::cp_async_arrive(&full[nx % NSTAGE]);
    }
    const uint32_t xa = hopper::smem_u32(ring + (t % NSTAGE) * SLOT);
    hopper::reg_fence(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_m64n128_rs(acc, cur[kk], hopper::desc_k(xa + kk * 32));
    hopper::wgmma_commit();
    if (t + 1 < nsteps) {
      const int sl = (t + 1) % NSTAGE;
      hopper::mbar_wait(&full[sl], ((t + 1) / NSTAGE) & 1);
      hopper::fence_proxy_async();  // its x tile, read by the next products
      bigm_a_operand<BITS>(ring + sl * SLOT, (s0 + t + 1) * BK, a.sshift, col, next);
    }
    hopper::wgmma_wait0();
    hopper::reg_fence(acc);
    hopper::reg_fence(cur);
    __syncthreads();  // both warpgroups are done with the slot
  };
  if (!VEC) __syncthreads();  // the stored, unvectorized weight rows
  hopper::mbar_wait(&full[0], 0);
  hopper::fence_proxy_async();
  bigm_a_operand<BITS>(ring, s0 * BK, a.sshift, col, A0);
  for (int t = 0; t < nsteps; t += 2) {
    step(t, A0, A1);
    if (t + 1 < nsteps) step(t + 1, A1, A0);
  }

  // acc[4 j + 2 i + e]: column col + i, row 8 j + 2 (lane % 4) + e of the
  // tile
  const int rbase = 2 * (lane % 4);
  if (a.splits == 1) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * j + rbase + e;
        if (row < a.M)
          bigm_store(a.out, a.N, row, n0 + col, acc[4 * j + e], acc[4 * j + 2 + e]);
      }
    return;
  }
  // split K: the tile's splits are one cluster; each keeps its f32
  // partial in its own shared memory (the ring is idle now), and after the
  // cluster barrier block `split` sums rows [split, split + 1) * BM /
  // splits of every partial, in split order, over distributed shared
  // memory, and writes them
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(part + (8 * j + rbase + e) * PART_LD + col) =
          make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
  cluster.sync();
  const int r0 = split * BM / a.splits, r1 = (split + 1) * BM / a.splits;
  for (int u = threadIdx.x; u < (r1 - r0) * (BN / 4); u += BG_THREADS) {
    const int rl = r0 + u / (BN / 4), cl = (u % (BN / 4)) * 4;
    if (m0 + rl >= a.M) break;  // the rows past M, and every later one
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < a.splits)
        v[sp] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, sp) + rl * PART_LD + cl);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp) {
      if (sp < a.splits) {
        sum.x += v[sp].x;
        sum.y += v[sp].y;
        sum.z += v[sp].z;
        sum.w += v[sp].w;
      }
    }
    bigm_store(a.out, a.N, m0 + rl, n0 + cl, sum.x, sum.y);
    bigm_store(a.out, a.N, m0 + rl, n0 + cl + 2, sum.z, sum.w);
  }
  cluster.sync();  // every block's partial stays until all have read it
}

// One launch; splits > 1 makes each tile's splits one cluster (1, splits,
// 1).
template <typename OutT, int BITS, bool VEC>
int launch_bigm(const BigmArgs<OutT>& a, int n_tiles, cudaStream_t st) {
  auto kernel = qmm_bigm_kernel<OutT, BITS, VEC>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BG_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, a.splits);
  cfg.blockDim = dim3(BG_THREADS);
  cfg.dynamicSmemBytes = BG_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = a.splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// K1: the walk at row tile 8 (M <= 8), one instantiation per bits, tile
// width, AQ8 and copy width (16 columns, or 4 where N % 16 != 0).
template <bool AQ8>
int smallm(const void* x, const void* w, const void* s, const void* layer, void* out,
           int out_f32, int kind, int M, int K, int N, int width, int splits, void* stream) {
  if ((AQ8 && kind == qkind::Q4G) || M > 8 || fwalk::bad_shape(kind, M, K, N, splits))
    return (int)cudaErrorInvalidValue;
  fwalk::Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.layer = static_cast<const int*>(layer);
  a.w = static_cast<const uint8_t*>(w);
  a.s = static_cast<const __half*>(s);
  a.out = out;
  a.out_f32 = out_f32;
  a.M = M;
  a.K = K;
  a.N = a.ncols = N;
  a.splits = splits;
  auto st = static_cast<cudaStream_t>(stream);
  return qkind::with_bits(kind, [&](auto bits) {
    return fwalk::with_width(width, [&](auto sw) {
      return fwalk::launch<8, decltype(bits)::value, decltype(sw)::value, false, AQ8, true>(
          a, kind, false, st);
    });
  });
}

template <bool AQ8>
int smallm_resident(int kind, int M, int K, int N, int width, int splits, int* clusters) {
  if ((AQ8 && kind == qkind::Q4G) || M > 8 || fwalk::bad_shape(kind, M, K, N, splits))
    return (int)cudaErrorInvalidValue;
  return qkind::with_bits(kind, [&](auto bits) {
    return fwalk::with_width(width, [&](auto sw) {
      constexpr int B = decltype(bits)::value, SW = decltype(sw)::value;
      if (N % 16 == 0)
        return fwalk::resident_of<8, B, SW, false, AQ8, true, true>(K, splits, clusters);
      return fwalk::resident_of<8, B, SW, false, AQ8, true, false>(K, splits, clusters);
    });
  });
}

}  // namespace

extern "C" {

// kind: 0 q8, 1 q4, 2 q4g (qkind.cuh); layer: [1] int32 for a stacked
// weight, or null; out: [M, N] f32 (out_f32 != 0) or bf16; width,
// splits: the tile width (64 or 128 columns) and the K splits of a tile
// (ops/kernels/qmatmul.py smallm_plan). Requires 1 <= M <= 8, K a
// multiple of the scale block (32, or 128 for q4g), N % 4 == 0 (4-column
// groups), 1 <= splits <= min(8, ceil(K / 64)) and the x slice within
// shared memory.
int qmm_smallm(const void* x, const void* w, const void* s, const void* layer,
               void* out, int out_f32, int kind, int M, int K, int N, int width,
               int splits, void* stream) {
  return smallm<false>(x, w, s, layer, out, out_f32, kind, M, K, N, width, splits, stream);
}

// qmm_smallm with x quantized to int8 per 32-block in the kernel (aq8);
// kind 0 (q8) or 1 (q4) only.
int qmm_smallm_aq8(const void* x, const void* w, const void* s,
                   const void* layer, void* out, int out_f32, int kind, int M,
                   int K, int N, int width, int splits, void* stream) {
  return smallm<true>(x, w, s, layer, out, out_f32, kind, M, K, N, width, splits, stream);
}

// The clusters of a launch of qmm_smallm's (aq8 != 0: qmm_smallm_aq8's)
// shape (kind, M, K, N, width, splits as above; N picks the copy width's
// kernel) that the card keeps resident at once, into *clusters.
int qmm_smallm_resident(int kind, int M, int K, int N, int width, int splits, int aq8,
                        int* clusters) {
  return aq8 ? smallm_resident<true>(kind, M, K, N, width, splits, clusters)
             : smallm_resident<false>(kind, M, K, N, width, splits, clusters);
}

// kind as above; out: [M, N] f32 (out_f32 != 0) or bf16. Requires K % 64
// == 0 (whole 64-deep K steps, 16-byte rows of x), K a multiple of the
// scale block and 1 <= splits <= min(8, K / 64); ragged M and N are
// masked (N % 16 != 0 loads the weight a value at a time).
int qmm_bigm(const void* x, const void* w, const void* s, const void* layer,
             void* out, int out_f32, int kind, int M, int K, int N, int splits,
             void* stream) {
  if (!qkind::valid(kind) || M < 1 || K < 1 || K % BK ||
      K % qkind::scale_rows(kind) || N < 1 || splits < 1 ||
      splits > MAX_SPLITS || splits > K / BK)
    return (int)cudaErrorInvalidValue;
  const int n_nt = (N + BN - 1) / BN;
  const long long n_tiles = (long long)((M + BM - 1) / BM) * n_nt;
  if (n_tiles > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int sh = qkind::scale_shift(kind);
  auto go = [&](auto out_tag) {
    using OutT = decltype(out_tag);
    const BigmArgs<OutT> a{static_cast<const __nv_bfloat16*>(x),
                           static_cast<const uint8_t*>(w),
                           static_cast<const __half*>(s),
                           static_cast<const int*>(layer),
                           static_cast<OutT*>(out),
                           M, K, N, sh, n_nt, splits};
    return qkind::with_bits(kind, [&](auto bits) {
      constexpr int BITS = decltype(bits)::value;
      return N % 16 == 0 ? launch_bigm<OutT, BITS, true>(a, (int)n_tiles, st)
                         : launch_bigm<OutT, BITS, false>(a, (int)n_tiles, st);
    });
  };
  return out_f32 ? go(float{}) : go(__nv_bfloat16{});
}

}  // extern "C"
