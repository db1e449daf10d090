// Q8_0 weight-only quantized matmul for Hopper (sm_90a):
//   out[M, N] = x[M, K] (bf16) @ dequant(w)[K, N],  f32 accumulation.
//
// The weight is the port's "kn" QTensor: int8 data [L, K, N] and fp16
// block scales [L, K/32, N] (one scale per 32 rows of K, per column), both
// stacked over layers; the layer index is read from device memory (a null
// pointer means an unstacked weight), so no layer is ever sliced or copied
// and a decode step stays capturable.
//
// K1 qmm_smallm (M <= 8, decode) replaces _qmm_kernel_smallm in
//   tinyllama_tpu/ops/pallas/qmatmul.py. Bound: the weight bytes over the
//   memory rate (2 * M flops per weight byte is far below the ridge).
//   Design: the weight streams exactly once. A block owns a strip of 32
//   columns; its 256 threads are 8 column groups (4 columns each, read as
//   one char4, so a row of the strip is one 32-byte sector) times 32 K
//   slices that walk 32-row blocks. x is staged in shared memory as f32,
//   1024 rows of K at a time. Each 32-block's integer-valued partial dot
//   is scaled by that block's fp16 scale after the dot, as the TPU kernel
//   does; the 32 K slices are summed in shared memory in a fixed order.
//
// K2 qmm_bigm (M > 8, prefill) replaces _qmm_kernel_bigm + _dequant_tile.
//   Bound: tensor-core operations at large M (2*M*K*N over 989 TFLOP/s).
//   Design: 64x64 output tiles, 4 warps of 32x32; each 64-deep K step
//   dequantizes the 64x64 int8 weight tile (two scale rows) to bf16 in
//   shared memory, once for all 64 rows of x, and multiplies with
//   nvcuda::wmma bf16 tensor-core products into f32 accumulators; the
//   epilogue casts to the output type. The next step's global loads are
//   issued into registers before this step's products, so their latency
//   hides behind the tensor cores. TMA, wgmma and a deeper shared-memory
//   ring are later work.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
constexpr int SM_CG = SM_COLS / 4;            // column groups (char4 each)
constexpr int SM_KS = SM_THREADS / SM_CG;     // K slices per block
constexpr int SM_KCHUNK = SM_KS * QBLOCK;     // K rows of x staged per pass
constexpr int SM_XLD = SM_KCHUNK + SM_KS;     // one pad float per 32-block

template <int M, typename OutT>
__global__ void __launch_bounds__(SM_THREADS)
qmm_smallm_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const __half* __restrict__ s,
                  const int* __restrict__ layer,
                  OutT* __restrict__ out, int K, int N) {
  // x chunk [M][SM_XLD] during the K walk, then the [SM_KS][M][SM_COLS]
  // partial sums of the cross-slice reduction
  __shared__ float buf[M * SM_XLD];
  const int li = layer ? layer[0] : 0;
  w += (size_t)li * K * N;
  s += (size_t)li * (K / QBLOCK) * N;
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
    for (int i = threadIdx.x; i < M * kc; i += SM_THREADS) {
      const int m = i / kc, k = i % kc;
      buf[m * SM_XLD + k + k / QBLOCK] =
          __bfloat162float(x[(size_t)m * K + k0 + k]);
    }
    __syncthreads();
    const int kb = ks * QBLOCK;
    if (kb < kc && n < N) {
      const int8_t* wp = w + (size_t)(k0 + kb) * N + n;
      const float* xs = buf + ks * (QBLOCK + 1);
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
      float part[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
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
      const __half* sp = s + (size_t)((k0 + kb) / QBLOCK) * N + n;
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[j] = n + j < N ? __half2float(sp[j]) : 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += part[m][j] * sc[j];
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

template <typename OutT>
void launch_smallm(int M, dim3 grid, cudaStream_t st,
                   const __nv_bfloat16* x, const int8_t* w, const __half* s,
                   const int* layer, OutT* out, int K, int N) {
#define TL_SMALLM(MM)                                                      \
  case MM:                                                                 \
    qmm_smallm_kernel<MM, OutT><<<grid, SM_THREADS, 0, st>>>(x, w, s,      \
                                                             layer, out, K, N); \
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
constexpr int B_ROWS = BK * BN / 16 / BG_THREADS;     // 16-column weight rows a thread

// One K step's global tile data, held in registers while the tensor cores
// work on the previous step's shared-memory tiles: x chunks, and per
// 16-column weight row its 16 int8 values and 16 fp16 scales.
struct BigmStage {
  uint4 a[A_CHUNKS];
  int4 q[B_ROWS];
  int4 sc[B_ROWS][2];
};

__device__ inline int word_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ inline void bigm_load(BigmStage& st, const __nv_bfloat16* x,
                                 const int8_t* w, const __half* s, int M,
                                 int K, int N, int m0, int n0, int k0) {
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int i = threadIdx.x + c * BG_THREADS;
    const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
    st.a[c] = m0 + r < M
        ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c8)
        : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int b = 0; b < B_ROWS; ++b) {
    const int i = threadIdx.x + b * BG_THREADS;
    const int r = i / (BN / 16), n = n0 + (i % (BN / 16)) * 16;
    const int8_t* wp = w + (size_t)(k0 + r) * N + n;
    const __half* sp = s + (size_t)((k0 + r) / QBLOCK) * N + n;
    if (N % 16 == 0 && n + 15 < N) {
      st.q[b] = *reinterpret_cast<const int4*>(wp);
      st.sc[b][0] = *reinterpret_cast<const int4*>(sp);
      st.sc[b][1] = *reinterpret_cast<const int4*>(sp + 8);
    } else {  // ragged N: zero columns past it
      unsigned qw[4] = {0, 0, 0, 0}, sw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n + j < N) {
          qw[j / 4] |= (unsigned)(uint8_t)wp[j] << (8 * (j % 4));
          sw[j / 2] |= (unsigned)__half_as_ushort(sp[j]) << (16 * (j % 2));
        }
      }
      st.q[b] = make_int4((int)qw[0], (int)qw[1], (int)qw[2], (int)qw[3]);
      st.sc[b][0] = make_int4((int)sw[0], (int)sw[1], (int)sw[2], (int)sw[3]);
      st.sc[b][1] = make_int4((int)sw[4], (int)sw[5], (int)sw[6], (int)sw[7]);
    }
  }
}

__device__ inline void bigm_store(const BigmStage& st, __nv_bfloat16* As,
                                  __nv_bfloat16* Bs) {
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int i = threadIdx.x + c * BG_THREADS;
    const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(&As[r * A_LD + c8]) = st.a[c];
  }
#pragma unroll
  for (int b = 0; b < B_ROWS; ++b) {
    const int i = threadIdx.x + b * BG_THREADS;
    const int r = i / (BN / 16), c16 = (i % (BN / 16)) * 16;
    uint32_t ow[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * p + e;
        const float qv = (float)(int8_t)(word_of(st.q[b], j / 4) >> (8 * (j % 4)));
        const float sv = __half2float(__ushort_as_half((unsigned short)(
            word_of(st.sc[b][j / 8], (j % 8) / 2) >> (16 * (j % 2)))));
        f[e] = qv * sv;
      }
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
      ow[p] = *reinterpret_cast<const uint32_t*>(&v);
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[r * B_LD + c16]);
    dst[0] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    dst[1] = make_uint4(ow[4], ow[5], ow[6], ow[7]);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(BG_THREADS)
qmm_bigm_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w,
                const __half* __restrict__ s,
                const int* __restrict__ layer,
                OutT* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];
  const int li = layer ? layer[0] : 0;
  w += (size_t)li * K * N;
  s += (size_t)li * (K / QBLOCK) * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  BigmStage st;
  bigm_load(st, x, w, s, M, K, N, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // dequantize this step's weight tile to bf16 (x tile as it is), then
    // start the next step's global loads before the tensor-core work
    bigm_store(st, As, Bs);
    __syncthreads();
    if (k0 + BK < K) bigm_load(st, x, w, s, M, K, N, m0, n0, k0 + BK);
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

}  // namespace

extern "C" {

// out: [M, N] f32 (out_f32 != 0) or bf16. Requires 1 <= M <= 8,
// K % 32 == 0 and N % 4 == 0 (char4 rows).
int qmm_smallm(const void* x, const void* w, const void* s, const void* layer,
               void* out, int out_f32, int M, int K, int N, void* stream) {
  if (M < 1 || M > 8 || K % QBLOCK || N % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + SM_COLS - 1) / SM_COLS);
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const int8_t*>(w);
  auto sb = static_cast<const __half*>(s);
  auto lb = static_cast<const int*>(layer);
  if (out_f32)
    launch_smallm(M, grid, st, xb, wb, sb, lb, static_cast<float*>(out), K, N);
  else
    launch_smallm(M, grid, st, xb, wb, sb, lb,
                  static_cast<__nv_bfloat16*>(out), K, N);
  return (int)cudaGetLastError();
}

// out: [M, N] f32 (out_f32 != 0) or bf16. Requires K % 64 == 0 (whole
// 64-deep K steps, 16-byte rows of x); ragged M and N are masked.
int qmm_bigm(const void* x, const void* w, const void* s, const void* layer,
             void* out, int out_f32, int M, int K, int N, void* stream) {
  if (M < 1 || K % BK || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const int8_t*>(w);
  auto sb = static_cast<const __half*>(s);
  auto lb = static_cast<const int*>(layer);
  if (out_f32)
    qmm_bigm_kernel<float><<<grid, BG_THREADS, 0, st>>>(
        xb, wb, sb, lb, static_cast<float*>(out), M, K, N);
  else
    qmm_bigm_kernel<__nv_bfloat16><<<grid, BG_THREADS, 0, st>>>(
        xb, wb, sb, lb, static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
