// Fused decode-layer matmuls for Hopper (sm_90a): rms_norm and the
// residual add folded into the quantized weight stream, M <= 32 rows of
// bf16 activations, f32 accumulation. Both walk layer-stacked "kn" weights
// (q8 [L, K, N] int8 or q4/q4g [L, K/2, N] uint8, with fp16 scales
// [L, K/32 or K/128, N]; qkind.cuh) with the layer index read from device
// memory, through the strip walk of qstrip.cuh, a template on the bits.
//
// K5 fused_norm_qkv replaces _norm_qkv_kernel in
//   tinyllama_tpu/ops/pallas/decode_fused.py: out = rms_norm(x) * w_norm
//   @ dequant(wqkv). Bound: the weight bytes over the memory rate (5.57 MB
//   at TinyLlama's 2048 x 2560 in q8, 2.95 MB in q4, 2.70 MB in q4g). Design: the TPU kernel normalizes x once
//   into VMEM on its first grid step and reuses it on later steps; Hopper
//   blocks share nothing, so every block recomputes the M row statistics
//   from x (at most 128 KB, read from L2) and normalizes each staged chunk
//   as it stages it, rounding to bf16 where the TPU kernel casts the
//   normed slice to the compute dtype. No hand-off, one launch.
//
// K6 fused_out_residual replaces _out_res_kernel (same file): out =
//   residual + attn @ dequant(wo). Bound: the weight bytes (4.46 MB at
//   2048 x 2048 in q8, 2.36 MB in q4, 2.16 MB in q4g). Design: the same strip walk; the residual joins the f32
//   sum once, in the epilogue, and the result is cast to bf16 once.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "qstrip.cuh"

namespace {

using qstrip::bf16;
using qstrip::COLS;
using qstrip::THREADS;

template <int MT, int BITS>
__global__ void __launch_bounds__(THREADS)
fused_norm_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ nw,
                      const int* __restrict__ layer, const uint8_t* __restrict__ w,
                      const __half* __restrict__ s, bf16* __restrict__ out,
                      int M, int K, int N, float eps, int inside, int sshift) {
  extern __shared__ __align__(128) float buf[];
  __shared__ float stat[qstrip::MAX_M];
  const int li = layer[0];
  w += (size_t)li * qkind::plane_bytes(BITS, K, N);
  s += (size_t)li * (K >> sshift) * N;
  nw += (size_t)li * K;
  qstrip::row_rms(x, M, K, eps, inside, stat);
  qstrip::strip_matmul<MT, BITS>(
      buf, w, s, K, N, blockIdx.x * COLS, sshift,
      [&](float* b, int k0, int kc) {
        qstrip::stage_rows<MT>(b, M, k0, kc, [&](int m, int k, float(&v)[8]) {
          qstrip::load_normed8(x, nw, K, stat, inside, m, k, v);
        });
      },
      [&](int m, int n, float v) {
        if (m < M) out[(size_t)m * N + n] = __float2bfloat16(v);
      });
}

template <int MT, int BITS>
__global__ void __launch_bounds__(THREADS)
fused_out_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ res,
                          const int* __restrict__ layer,
                          const uint8_t* __restrict__ w,
                          const __half* __restrict__ s, bf16* __restrict__ out,
                          int M, int K, int N, int sshift) {
  extern __shared__ __align__(128) float buf[];
  const int li = layer[0];
  w += (size_t)li * qkind::plane_bytes(BITS, K, N);
  s += (size_t)li * (K >> sshift) * N;
  qstrip::strip_matmul<MT, BITS>(
      buf, w, s, K, N, blockIdx.x * COLS, sshift,
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

bool bad_shape(int kind, int M, int K, int N) {
  return !qkind::valid(kind) || M < 1 || M > qstrip::MAX_M || K < qstrip::QBLOCK ||
         K % qkind::scale_rows(kind) || N < COLS || N % COLS;
}

}  // namespace

extern "C" {

// x, out: [M, K] / [M, N] bf16; nw: [L, K] f32; kind: 0 q8, 1 q4, 2 q4g;
// w, s: the kind's [L, K, N] int8 or [L, K/2, N] uint8 data and
// [L, K/32 or K/128, N] fp16 scales; layer: [1] int32. Requires
// 1 <= M <= 32, K a multiple of the scale block and N % 32 == 0.
int fused_norm_qkv(const void* x, const void* nw, const void* layer,
                   const void* w, const void* s, void* out, int kind, int M,
                   int K, int N, float eps, int inside, void* stream) {
  if (bad_shape(kind, M, K, N)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int sh = qkind::scale_shift(kind);
  return qstrip::with_row_tile(M, [&](auto mt) {
    return qkind::with_bits(kind, [&](auto bits) {
      constexpr int MT = decltype(mt)::value, BITS = decltype(bits)::value;
      auto kernel = fused_norm_qkv_kernel<MT, BITS>;
      const int bytes = qstrip::smem_floats(MT) * sizeof(float);
      static const cudaError_t smem = qstrip::allow_smem(kernel, bytes);
      if (smem) return (int)smem;
      fused_norm_qkv_kernel<MT, BITS><<<N / COLS, THREADS, bytes, st>>>(
          static_cast<const bf16*>(x), static_cast<const float*>(nw),
          static_cast<const int*>(layer), static_cast<const uint8_t*>(w),
          static_cast<const __half*>(s), static_cast<bf16*>(out), M, K, N, eps,
          inside, sh);
      return (int)cudaGetLastError();
    });
  });
}

// a: [M, K] bf16; res, out: [M, N] bf16; kind, w, s, layer as above.
// Same shape rules.
int fused_out_residual(const void* a, const void* res, const void* layer,
                       const void* w, const void* s, void* out, int kind, int M,
                       int K, int N, void* stream) {
  if (bad_shape(kind, M, K, N)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int sh = qkind::scale_shift(kind);
  return qstrip::with_row_tile(M, [&](auto mt) {
    return qkind::with_bits(kind, [&](auto bits) {
      constexpr int MT = decltype(mt)::value, BITS = decltype(bits)::value;
      auto kernel = fused_out_residual_kernel<MT, BITS>;
      const int bytes = qstrip::smem_floats(MT) * sizeof(float);
      static const cudaError_t smem = qstrip::allow_smem(kernel, bytes);
      if (smem) return (int)smem;
      fused_out_residual_kernel<MT, BITS><<<N / COLS, THREADS, bytes, st>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(res),
          static_cast<const int*>(layer), static_cast<const uint8_t*>(w),
          static_cast<const __half*>(s), static_cast<bf16*>(out), M, K, N, sh);
      return (int)cudaGetLastError();
    });
  });
}

}  // extern "C"
