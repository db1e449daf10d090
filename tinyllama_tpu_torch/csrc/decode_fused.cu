// Fused decode-layer matmuls for Hopper (sm_90a): rms_norm and the
// residual add folded into the q8 weight stream, M <= 32 rows of bf16
// activations, f32 accumulation. Both walk layer-stacked "kn" weights
// ([L, K, N] int8, [L, K/32, N] fp16 scales) with the layer index read
// from device memory, through the strip walk of qstrip.cuh.
//
// K5 fused_norm_qkv replaces _norm_qkv_kernel in
//   tinyllama_tpu/ops/pallas/decode_fused.py: out = rms_norm(x) * w_norm
//   @ dequant(wqkv). Bound: the weight bytes over the memory rate (5.57 MB
//   at TinyLlama's 2048 x 2560). Design: the TPU kernel normalizes x once
//   into VMEM on its first grid step and reuses it on later steps; Hopper
//   blocks share nothing, so every block recomputes the M row statistics
//   from x (at most 128 KB, read from L2) and normalizes each staged chunk
//   as it stages it, rounding to bf16 where the TPU kernel casts the
//   normed slice to the compute dtype. No hand-off, one launch.
//
// K6 fused_out_residual replaces _out_res_kernel (same file): out =
//   residual + attn @ dequant(wo). Bound: the weight bytes (4.46 MB at
//   2048 x 2048). Design: the same strip walk; the residual joins the f32
//   sum once, in the epilogue, and the result is cast to bf16 once.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "qstrip.cuh"

namespace {

using qstrip::bf16;
using qstrip::COLS;
using qstrip::THREADS;

template <int MT>
__global__ void __launch_bounds__(THREADS)
fused_norm_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ nw,
                      const int* __restrict__ layer, const int8_t* __restrict__ w,
                      const __half* __restrict__ s, bf16* __restrict__ out,
                      int M, int K, int N, float eps, int inside) {
  extern __shared__ __align__(128) float buf[];
  __shared__ float stat[qstrip::MAX_M];
  const int li = layer[0];
  w += (size_t)li * K * N;
  s += (size_t)li * (K / qstrip::QBLOCK) * N;
  nw += (size_t)li * K;
  qstrip::row_rms(x, M, K, eps, inside, stat);
  qstrip::strip_matmul<MT>(
      buf, w, s, K, N, blockIdx.x * COLS,
      [&](float* b, int k0, int kc) {
        qstrip::stage_rows<MT>(b, M, k0, kc, [&](int m, int k, float(&v)[8]) {
          qstrip::load_normed8(x, nw, K, stat, inside, m, k, v);
        });
      },
      [&](int m, int n, float v) {
        if (m < M) out[(size_t)m * N + n] = __float2bfloat16(v);
      });
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
fused_out_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ res,
                          const int* __restrict__ layer,
                          const int8_t* __restrict__ w,
                          const __half* __restrict__ s, bf16* __restrict__ out,
                          int M, int K, int N) {
  extern __shared__ __align__(128) float buf[];
  const int li = layer[0];
  w += (size_t)li * K * N;
  s += (size_t)li * (K / qstrip::QBLOCK) * N;
  qstrip::strip_matmul<MT>(
      buf, w, s, K, N, blockIdx.x * COLS,
      [&](float* b, int k0, int kc) {
        qstrip::stage_rows<MT>(b, M, k0, kc, [&](int m, int k, float(&v)[8]) {
          qstrip::load_bf16x8(a + (size_t)m * K + k, v);
        });
      },
      [&](int m, int n, float v) {
        if (m < M) {
          const size_t o = (size_t)m * N + n;
          out[o] = __float2bfloat16(__bfloat162float(res[o]) + v);
        }
      });
}

bool bad_shape(int M, int K, int N) {
  return M < 1 || M > qstrip::MAX_M || K < qstrip::QBLOCK ||
         K % qstrip::QBLOCK || N < COLS || N % COLS;
}

}  // namespace

extern "C" {

// x, out: [M, K] / [M, N] bf16; nw: [L, K] f32; w, s: [L, K, N] int8 and
// [L, K/32, N] fp16; layer: [1] int32. Requires 1 <= M <= 32,
// K % 32 == 0 and N % 32 == 0.
int fused_norm_qkv(const void* x, const void* nw, const void* layer,
                   const void* w, const void* s, void* out, int M, int K, int N,
                   float eps, int inside, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return qstrip::with_row_tile(M, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    const int bytes = qstrip::smem_floats(MT) * sizeof(float);
    static const cudaError_t smem = qstrip::allow_smem(fused_norm_qkv_kernel<MT>, bytes);
    if (smem) return (int)smem;
    fused_norm_qkv_kernel<MT><<<N / COLS, THREADS, bytes, st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(nw),
        static_cast<const int*>(layer), static_cast<const int8_t*>(w),
        static_cast<const __half*>(s), static_cast<bf16*>(out), M, K, N, eps,
        inside);
    return (int)cudaGetLastError();
  });
}

// a: [M, K] bf16; res, out: [M, N] bf16; w, s, layer as above. Same
// shape rules.
int fused_out_residual(const void* a, const void* res, const void* layer,
                       const void* w, const void* s, void* out, int M, int K,
                       int N, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return qstrip::with_row_tile(M, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    const int bytes = qstrip::smem_floats(MT) * sizeof(float);
    static const cudaError_t smem =
        qstrip::allow_smem(fused_out_residual_kernel<MT>, bytes);
    if (smem) return (int)smem;
    fused_out_residual_kernel<MT><<<N / COLS, THREADS, bytes, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(res),
        static_cast<const int*>(layer), static_cast<const int8_t*>(w),
        static_cast<const __half*>(s), static_cast<bf16*>(out), M, K, N);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
