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
//   tinyllama_tpu/ops/pallas/qmatmul.py (its q8 and q4/q4g bodies). Bound:
//   the weight bytes over the memory rate (2 * M flops per weight byte at
//   q8, 4 * M at 4 bits, far below the ridge). Design: the weight streams
//   exactly once. A block owns a strip of 32 columns; its 256 threads are
//   8 column groups (4 columns each, read as one 4-byte word, so a row of
//   the strip is one 32-byte sector) times 32 K slices that walk 32-row
//   blocks: 32 word rows at q8, 16 at 4 bits, where each word holds two
//   K-rows of 4 columns. x is staged in shared memory as f32, 1024 rows
//   of K at a time. A 4-bit value is dequantized to (v - 7) in f32 before
//   its FMA (exact, so no x-sum correction is needed, where the TPU body
//   folds the offset into block sums of x after the dot); each 32-block's
//   partial dot is then scaled by that block's fp16 scale after the dot,
//   as the TPU kernel does; the 32 K slices are summed in shared memory in
//   a fixed order.
//   The AQ8 instantiation (qmm_smallm_aq8; the q8a8 and q4a8 policies)
//   replaces the aq8 branch of the same body (block_x and its int8 dots):
//   as a chunk of x is staged, one warp a (row, 32-block) quantizes it in
//   shared memory to int8, round(x * 127 / absmax) half to even with the
//   absmax a __shfl_xor_sync max (IEEE division: no fast math), and keeps
//   the block's scale absmax / 127 beside it. Each thread's 32-row block
//   is then an exact int32 dot per row and column (|dot| <= 32 * 127 * 128
//   < 2^24): its four char4 weight rows transposed into column quads by
//   __byte_perm, or its 4-bit values as bytes v - 7, through __dp4a; and
//   (float(dot) * x scale) * weight scale joins the f32 sum, in the TPU
//   body's order. q4g has no aq8 branch.
//
// K2 qmm_bigm (M > 8, prefill) replaces _qmm_kernel_bigm + _dequant_tile
//   (q8 and q4/q4g bodies). Bound: tensor-core operations at large M
//   (2*M*K*N over 989 TFLOP/s). Design: 64x64 output tiles, 4 warps of
//   32x32; each 64-deep K step dequantizes the 64x64 weight tile ((v - 7)
//   * s or q * s, exact in f32, then rounded to bf16 once, which equals the
//   TPU body's hi16 * (s/16) + s) into shared memory, once for all 64 rows
//   of x, and multiplies with nvcuda::wmma bf16 tensor-core products into
//   f32 accumulators; the epilogue casts to the output type. The next
//   step's global loads are issued into registers before this step's
//   products, so their latency hides behind the tensor cores. TMA, wgmma
//   and a deeper shared-memory ring are later work.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- K1 ----

constexpr int SM_THREADS = 256;
constexpr int SM_COLS = 32;                   // output columns per block
constexpr int SM_CG = SM_COLS / 4;            // column groups (4 bytes each)
constexpr int SM_KS = SM_THREADS / SM_CG;     // K slices per block
constexpr int SM_KCHUNK = SM_KS * QBLOCK;     // K rows of x staged per pass
constexpr int SM_XLD = SM_KCHUNK + SM_KS;     // one pad float per 32-block

// 1 / 127 rounded once to f32, as the TPU body's absmax * (1.0 / 127.0)
constexpr float INV_127 = (float)(1.0 / 127.0);

// Rows a, b, c, d of 4 byte columns -> the 4 columns as byte quads:
// col[j] = (a_j, b_j, c_j, d_j), the first row in the low byte.
__device__ inline void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                  uint32_t d, uint32_t (&col)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  col[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  col[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  col[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// Four 4-bit values (one a byte, 0..15) -> four signed bytes v - 7: with
// each byte biased by 128 the subtraction never borrows across bytes.
__device__ inline uint32_t minus7(uint32_t v) {
  return ((v | 0x80808080u) - 0x07070707u) ^ 0x80808080u;
}

template <int M, typename OutT, int BITS, bool AQ8>
__global__ void __launch_bounds__(SM_THREADS)
qmm_smallm_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  const __half* __restrict__ s,
                  const int* __restrict__ layer,
                  OutT* __restrict__ out, int K, int N, int sshift) {
  // x chunk [M][SM_XLD] during the K walk (AQ8: int8 [M][SM_KCHUNK] and
  // the blocks' scales [M][SM_KS]), then the [SM_KS][M][SM_COLS] partial
  // sums of the cross-slice reduction
  __shared__ float buf[M * SM_XLD];
  int8_t* xq = reinterpret_cast<int8_t*>(buf);
  float* xsc = buf + M * SM_KCHUNK / 4;
  const int li = layer ? layer[0] : 0;
  w += (size_t)li * qkind::plane_bytes(BITS, K, N);
  s += (size_t)li * (K >> sshift) * N;
  const int tc = threadIdx.x % SM_CG;
  const int ks = threadIdx.x / SM_CG;
  const int n = blockIdx.x * SM_COLS + tc * 4;
  const bool full = n + 3 < N;

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SM_KCHUNK) {
    const int kc = min(SM_KCHUNK, K - k0);
    __syncthreads();
    if constexpr (AQ8) {
      // one warp a (row, 32-block): the lanes are its values
      const int nb = kc / QBLOCK, lane = threadIdx.x % 32;
      for (int i = threadIdx.x / 32; i < M * nb; i += SM_THREADS / 32) {
        const int m = i / nb, b = i % nb;
        const float v = __bfloat162float(x[(size_t)m * K + k0 + b * QBLOCK + lane]);
        float amax = fabsf(v);
#pragma unroll
        for (int o = 16; o; o >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        const float inv = amax > 0.f ? 127.f / amax : 0.f;
        xq[m * SM_KCHUNK + b * QBLOCK + lane] = (int8_t)__float2int_rn(v * inv);
        if (lane == 0) xsc[m * SM_KS + b] = amax * INV_127;
      }
    } else {
      for (int i = threadIdx.x; i < M * kc; i += SM_THREADS) {
        const int m = i / kc, k = i % kc;
        buf[m * SM_XLD + k + k / QBLOCK] =
            __bfloat162float(x[(size_t)m * K + k0 + k]);
      }
    }
    __syncthreads();
    const int kb = ks * QBLOCK;
    if (kb < kc && n < N) {
      const float* xs = buf + ks * (QBLOCK + 1);
      float part[M][4];
      int idot[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[m][j] = 0.f;
          idot[m][j] = 0;
        }
      if constexpr (BITS == 8) {
        const int8_t* wp = reinterpret_cast<const int8_t*>(w) + (size_t)(k0 + kb) * N + n;
        // all 32 rows' loads first, so they are in flight together
        char4 q[QBLOCK];
        if (full) {
#pragma unroll
          for (int r = 0; r < QBLOCK; ++r)
            q[r] = *reinterpret_cast<const char4*>(wp + (size_t)r * N);
        } else {
#pragma unroll
          for (int r = 0; r < QBLOCK; ++r) {
            const int8_t* row = wp + (size_t)r * N;
            q[r] = make_char4(row[0], n + 1 < N ? row[1] : 0,
                              n + 2 < N ? row[2] : 0, 0);
          }
        }
        if constexpr (AQ8) {
          const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
          for (int r = 0; r < QBLOCK; r += 4) {
            uint32_t col[4];
            transpose4(qw[r], qw[r + 1], qw[r + 2], qw[r + 3], col);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const int xw = *reinterpret_cast<const int*>(xq + m * SM_KCHUNK + kb + r);
#pragma unroll
              for (int c = 0; c < 4; ++c) idot[m][c] = __dp4a(xw, (int)col[c], idot[m][c]);
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < QBLOCK; ++r) {
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float xv = xs[m * SM_XLD + r];
              part[m][0] += xv * (float)q[r].x;
              part[m][1] += xv * (float)q[r].y;
              part[m][2] += xv * (float)q[r].z;
              part[m][3] += xv * (float)q[r].w;
            }
          }
        }
      } else {
        // 16 byte-rows: word j holds K-rows j (high nibbles) and j + 16
        // (low nibbles) of the block, for 4 columns (N % 4 == 0, so a
        // strip's column group is whole or absent)
        const uint8_t* wp = w + (size_t)((k0 + kb) / 2) * N + n;
        uint32_t q[QBLOCK / 2];
#pragma unroll
        for (int j = 0; j < QBLOCK / 2; ++j)
          q[j] = *reinterpret_cast<const uint32_t*>(wp + (size_t)j * N);
        if constexpr (AQ8) {
#pragma unroll
          for (int j = 0; j < QBLOCK / 2; j += 4) {
            uint32_t hc[4], lc[4];
            transpose4(minus7((q[j] >> 4) & 0x0F0F0F0Fu),
                       minus7((q[j + 1] >> 4) & 0x0F0F0F0Fu),
                       minus7((q[j + 2] >> 4) & 0x0F0F0F0Fu),
                       minus7((q[j + 3] >> 4) & 0x0F0F0F0Fu), hc);
            transpose4(minus7(q[j] & 0x0F0F0F0Fu), minus7(q[j + 1] & 0x0F0F0F0Fu),
                       minus7(q[j + 2] & 0x0F0F0F0Fu),
                       minus7(q[j + 3] & 0x0F0F0F0Fu), lc);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const int8_t* xr = xq + m * SM_KCHUNK + kb;
              const int xh = *reinterpret_cast<const int*>(xr + j);
              const int xl = *reinterpret_cast<const int*>(xr + j + QBLOCK / 2);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                idot[m][c] = __dp4a(xl, (int)lc[c], __dp4a(xh, (int)hc[c], idot[m][c]));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < QBLOCK / 2; ++j) {
            float hv[4], lv[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              hv[c] = qkind::hi4(q[j] >> (8 * c));
              lv[c] = qkind::lo4(q[j] >> (8 * c));
            }
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float xh = xs[m * SM_XLD + j];
              const float xl = xs[m * SM_XLD + j + QBLOCK / 2];
#pragma unroll
              for (int c = 0; c < 4; ++c) part[m][c] += xh * hv[c] + xl * lv[c];
            }
          }
        }
      }
      const __half* sp = s + (size_t)((k0 + kb) >> sshift) * N + n;
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[j] = n + j < N ? __half2float(sp[j]) : 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if constexpr (AQ8) {
          const float sx = xsc[m * SM_KS + ks];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m][j] += __fmul_rn(__fmul_rn((float)idot[m][j], sx), sc[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] += part[m][j] * sc[j];
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      buf[(ks * M + m) * SM_COLS + tc * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < M * SM_COLS; i += SM_THREADS) {
    const int m = i / SM_COLS, c = i % SM_COLS;
    float v = 0.f;
    for (int t = 0; t < SM_KS; ++t) v += buf[(t * M + m) * SM_COLS + c];
    const int col = blockIdx.x * SM_COLS + c;
    if (col < N) store_out(out + (size_t)m * N + col, v);
  }
}

template <typename OutT, int BITS, bool AQ8>
void launch_smallm(int M, dim3 grid, cudaStream_t st,
                   const __nv_bfloat16* x, const uint8_t* w, const __half* s,
                   const int* layer, OutT* out, int K, int N, int sshift) {
#define TL_SMALLM(MM)                                                      \
  case MM:                                                                 \
    qmm_smallm_kernel<MM, OutT, BITS, AQ8><<<grid, SM_THREADS, 0, st>>>(   \
        x, w, s, layer, out, K, N, sshift);                                \
    break;
  switch (M) {
    TL_SMALLM(1) TL_SMALLM(2) TL_SMALLM(3) TL_SMALLM(4)
    TL_SMALLM(5) TL_SMALLM(6) TL_SMALLM(7) TL_SMALLM(8)
  }
#undef TL_SMALLM
}

// ---------------------------------------------------------------- K2 ----

constexpr int BG_THREADS = 128;
constexpr int BM = 64, BN = 64, BK = 2 * QBLOCK;
constexpr int A_LD = BK + 8;   // bf16 elements; 16-row steps stay 32-byte aligned
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // f32 elements
constexpr int A_CHUNKS = BM * BK / 8 / BG_THREADS;    // 16-byte x chunks a thread

// One K step's global tile data, held in registers while the tensor cores
// work on the previous step's shared-memory tiles: x chunks, and per
// 16-column data row (a K-row at q8, a byte-row of two K-rows at 4 bits)
// its 16 bytes and its 16 fp16 scales.
template <int BITS>
struct BigmStage {
  static constexpr int ROWS = BK * BITS / 8;                // data rows a step
  static constexpr int UNITS = ROWS * BN / 16 / BG_THREADS;  // rows a thread
  uint4 a[A_CHUNKS];
  int4 q[UNITS];
  int4 sc[UNITS][2];
};

__device__ inline int word_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The first K-row of data row r of the step at k0: r itself at q8; at 4
// bits byte-row r packs K-rows 32 (r / 16) + r % 16 and that + 16.
template <int BITS>
__device__ inline int bigm_krow(int k0, int r) {
  return BITS == 8 ? k0 + r : k0 + (r / 16) * QBLOCK + r % 16;
}

template <int BITS>
__device__ inline void bigm_load(BigmStage<BITS>& st, const __nv_bfloat16* x,
                                 const uint8_t* w, const __half* s, int M,
                                 int K, int N, int m0, int n0, int k0,
                                 int sshift) {
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int i = threadIdx.x + c * BG_THREADS;
    const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
    st.a[c] = m0 + r < M
        ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c8)
        : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int b = 0; b < BigmStage<BITS>::UNITS; ++b) {
    const int i = threadIdx.x + b * BG_THREADS;
    const int r = i / (BN / 16), n = n0 + (i % (BN / 16)) * 16;
    const uint8_t* wp = w + (size_t)(k0 * BITS / 8 + r) * N + n;
    const __half* sp = s + (size_t)(bigm_krow<BITS>(k0, r) >> sshift) * N + n;
    if (N % 16 == 0 && n + 15 < N) {
      st.q[b] = *reinterpret_cast<const int4*>(wp);
      st.sc[b][0] = *reinterpret_cast<const int4*>(sp);
      st.sc[b][1] = *reinterpret_cast<const int4*>(sp + 8);
    } else {  // ragged N: zero columns past it
      unsigned qw[4] = {0, 0, 0, 0}, sw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n + j < N) {
          qw[j / 4] |= (unsigned)wp[j] << (8 * (j % 4));
          sw[j / 2] |= (unsigned)__half_as_ushort(sp[j]) << (16 * (j % 2));
        }
      }
      st.q[b] = make_int4((int)qw[0], (int)qw[1], (int)qw[2], (int)qw[3]);
      st.sc[b][0] = make_int4((int)sw[0], (int)sw[1], (int)sw[2], (int)sw[3]);
      st.sc[b][1] = make_int4((int)sw[4], (int)sw[5], (int)sw[6], (int)sw[7]);
    }
  }
}

// Row `dst` of the bf16 weight tile: column j gets val(byte j) * scale j.
template <class Val>
__device__ inline void bigm_row(__nv_bfloat16* Bs, int dst, int c16, const int4& q,
                                const int4 (&sc)[2], Val val) {
  uint32_t ow[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float f[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * p + e;
      const uint32_t byte = (uint32_t)(word_of(q, j / 4) >> (8 * (j % 4))) & 0xFFu;
      const float sv = __half2float(__ushort_as_half((unsigned short)(
          word_of(sc[j / 8], (j % 8) / 2) >> (16 * (j % 2)))));
      f[e] = val(byte) * sv;
    }
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
    ow[p] = *reinterpret_cast<const uint32_t*>(&v);
  }
  uint4* d = reinterpret_cast<uint4*>(&Bs[dst * B_LD + c16]);
  d[0] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  d[1] = make_uint4(ow[4], ow[5], ow[6], ow[7]);
}

template <int BITS>
__device__ inline void bigm_store(const BigmStage<BITS>& st, __nv_bfloat16* As,
                                  __nv_bfloat16* Bs) {
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int i = threadIdx.x + c * BG_THREADS;
    const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(&As[r * A_LD + c8]) = st.a[c];
  }
#pragma unroll
  for (int b = 0; b < BigmStage<BITS>::UNITS; ++b) {
    const int i = threadIdx.x + b * BG_THREADS;
    const int r = i / (BN / 16), c16 = (i % (BN / 16)) * 16;
    if constexpr (BITS == 8) {
      bigm_row(Bs, r, c16, st.q[b], st.sc[b],
               [](uint32_t v) { return (float)(int8_t)v; });
    } else {
      const int hi = bigm_krow<BITS>(0, r);
      bigm_row(Bs, hi, c16, st.q[b], st.sc[b],
               [](uint32_t v) { return qkind::hi4(v); });
      bigm_row(Bs, hi + QBLOCK / 2, c16, st.q[b], st.sc[b],
               [](uint32_t v) { return qkind::lo4(v); });
    }
  }
}

template <typename OutT, int BITS>
__global__ void __launch_bounds__(BG_THREADS)
qmm_bigm_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w,
                const __half* __restrict__ s,
                const int* __restrict__ layer,
                OutT* __restrict__ out, int M, int K, int N, int sshift) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];
  const int li = layer ? layer[0] : 0;
  w += (size_t)li * qkind::plane_bytes(BITS, K, N);
  s += (size_t)li * (K >> sshift) * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  BigmStage<BITS> st;
  bigm_load(st, x, w, s, M, K, N, m0, n0, 0, sshift);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // dequantize this step's weight tile to bf16 (x tile as it is), then
    // start the next step's global loads before the tensor-core work
    bigm_store(st, As, Bs);
    __syncthreads();
    if (k0 + BK < K) bigm_load(st, x, w, s, M, K, N, m0, n0, k0 + BK, sshift);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * C_LD + wn + 16 * j, c[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += BG_THREADS) {
    const int r = i / BN, cc = i % BN;
    if (m0 + r < M && n0 + cc < N)
      store_out(out + (size_t)(m0 + r) * N + n0 + cc, Cs[r * C_LD + cc]);
  }
}

template <bool AQ8>
int smallm(const void* x, const void* w, const void* s, const void* layer,
           void* out, int out_f32, int kind, int M, int K, int N, void* stream) {
  if (!qkind::valid(kind) || (AQ8 && kind == qkind::Q4G) || M < 1 || M > 8 ||
      K < 1 || K % qkind::scale_rows(kind) || N % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + SM_COLS - 1) / SM_COLS);
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const uint8_t*>(w);
  auto sb = static_cast<const __half*>(s);
  auto lb = static_cast<const int*>(layer);
  const int sh = qkind::scale_shift(kind);
  qkind::with_bits(kind, [&](auto bits) {
    constexpr int BITS = decltype(bits)::value;
    if (out_f32)
      launch_smallm<float, BITS, AQ8>(M, grid, st, xb, wb, sb, lb,
                                      static_cast<float*>(out), K, N, sh);
    else
      launch_smallm<__nv_bfloat16, BITS, AQ8>(
          M, grid, st, xb, wb, sb, lb, static_cast<__nv_bfloat16*>(out), K, N, sh);
    return 0;
  });
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 q8, 1 q4, 2 q4g (qkind.cuh); out: [M, N] f32 (out_f32 != 0) or
// bf16. Requires 1 <= M <= 8, K a multiple of the scale block (32, or 128
// for q4g) and N % 4 == 0 (4-byte column groups).
int qmm_smallm(const void* x, const void* w, const void* s, const void* layer,
               void* out, int out_f32, int kind, int M, int K, int N,
               void* stream) {
  return smallm<false>(x, w, s, layer, out, out_f32, kind, M, K, N, stream);
}

// qmm_smallm with x quantized to int8 per 32-block in the kernel (aq8);
// kind 0 (q8) or 1 (q4) only.
int qmm_smallm_aq8(const void* x, const void* w, const void* s,
                   const void* layer, void* out, int out_f32, int kind, int M,
                   int K, int N, void* stream) {
  return smallm<true>(x, w, s, layer, out, out_f32, kind, M, K, N, stream);
}

// kind as above; out: [M, N] f32 (out_f32 != 0) or bf16. Requires K % 64
// == 0 (whole 64-deep K steps, 16-byte rows of x) and K a multiple of the
// scale block; ragged M and N are masked.
int qmm_bigm(const void* x, const void* w, const void* s, const void* layer,
             void* out, int out_f32, int kind, int M, int K, int N,
             void* stream) {
  if (!qkind::valid(kind) || M < 1 || K < 1 || K % BK ||
      K % qkind::scale_rows(kind) || N < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const uint8_t*>(w);
  auto sb = static_cast<const __half*>(s);
  auto lb = static_cast<const int*>(layer);
  const int sh = qkind::scale_shift(kind);
  qkind::with_bits(kind, [&](auto bits) {
    constexpr int BITS = decltype(bits)::value;
    if (out_f32)
      qmm_bigm_kernel<float, BITS><<<grid, BG_THREADS, 0, st>>>(
          xb, wb, sb, lb, static_cast<float*>(out), M, K, N, sh);
    else
      qmm_bigm_kernel<__nv_bfloat16, BITS><<<grid, BG_THREADS, 0, st>>>(
          xb, wb, sb, lb, static_cast<__nv_bfloat16*>(out), M, K, N, sh);
    return 0;
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
