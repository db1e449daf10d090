// Fused decode-layer matmuls for Hopper (sm_90a): rms_norm and the
// residual add folded into the quantized weight stream, M <= 32 rows of
// bf16 activations, f32 accumulation, one launch each of the walk of
// fused_walk.cuh over a layer-stacked "kn" weight (q8 [L, K, N] int8 or
// q4/q4g [L, K/2, N] uint8, with fp16 scales [L, K/32 or K/128, N];
// qkind.cuh), the layer index read from device memory.
//
// K5 fused_norm_qkv replaces _norm_qkv_kernel in
//   tinyllama_tpu/ops/pallas/decode_fused.py: out = rms_norm(x) * w_norm
//   @ dequant(wqkv). Bound: the weight bytes over the memory rate at every
//   M <= 32 (5.57 MB at TinyLlama's 2048 x 2560 in q8, 2.95 MB in q4, 2.70
//   MB in q4g). Design: the walk of fused_walk.cuh: 20 tiles of 128
//   columns times K splits from ops/kernels/fused_plan.py (8 at
//   TinyLlama's shape: 160 blocks), each split one block of a cluster that
//   streams its weight rows through a cp.async ring, stages only its K
//   slice of x, sums the squares of that slice and takes the row
//   statistic from the sums its cluster's splits push to it (the TPU
//   kernel normalizes x once into VMEM on its first grid step), and the
//   products on mma.sync with the dequantized weight in registers; the
//   splits' partials are pushed to the split that sums them, in split
//   order, over distributed shared memory, and each output is cast to
//   bf16 once. Each block reads x's slice once: at M = 32, 20 x 128 KB of
//   L2 reads a call.
//
// K6 fused_out_residual replaces _out_res_kernel (same file): out =
//   residual + attn @ dequant(wo). Bound: the weight bytes (4.46 MB at
//   2048 x 2048 in q8, 2.36 MB in q4, 2.16 MB in q4g). Design: the same
//   walk with x as given (no norm) and the residual epilogue of K7's down
//   launch: each split streams its slice of wo, the partials are summed
//   in split order in the cluster, the residual joins the f32 sum once and
//   the result is cast to bf16 once (the TPU kernel starts its f32 sum
//   from the residual instead: only the order of the f32 additions
//   differs). Row tile 8 keeps the exact regime, 16 and 32 the tile regime.
//
// The launch entry points return cudaGetLastError() after their launch.

#include "fused_walk.cuh"

namespace {

using fwalk::bf16;

// One launch of the walk for K5 (nw set) or K6 (res set).
int walk(const fwalk::Args& a, int kind, int width, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return fwalk::with_row_tile(a.M, [&](auto mt) {
    return qkind::with_bits(kind, [&](auto bits) {
      return fwalk::with_width(width, [&](auto sw) {
        return fwalk::launch<decltype(mt)::value, decltype(bits)::value, decltype(sw)::value,
                             false>(a, kind, false, st);
      });
    });
  });
}

}  // namespace

extern "C" {

// x, out: [M, K] / [M, N] bf16; nw: [L, K] f32; kind: 0 q8, 1 q4, 2 q4g;
// w, s: the kind's [L, K, N] int8 or [L, K/2, N] uint8 data and
// [L, K/32 or K/128, N] fp16 scales; layer: [1] int32; width, splits:
// the tile width (64 or 128 columns) and the K splits of a tile
// (ops/kernels/fused_plan.py). Requires 1 <= M <= 32, K a multiple of the
// scale block (above 8 rows, of 64), N % 16 == 0 and 1 <= splits <= min(8,
// ceil(K / 64)).
int fused_norm_qkv(const void* x, const void* nw, const void* layer,
                   const void* w, const void* s, void* out, int kind, int M,
                   int K, int N, float eps, int inside, int width, int splits,
                   void* stream) {
  if (fwalk::bad_shape(kind, M, K, N, splits)) return (int)cudaErrorInvalidValue;
  fwalk::Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.nw = static_cast<const float*>(nw);
  a.layer = static_cast<const int*>(layer);
  a.w = static_cast<const uint8_t*>(w);
  a.s = static_cast<const __half*>(s);
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = a.ncols = N;
  a.eps = eps;
  a.inside = inside;
  a.splits = splits;
  return walk(a, kind, width, stream);
}

// The clusters of a launch of fused_norm_qkv's shape (kind, M, K, width,
// splits as above) that the card keeps resident at once, into *clusters.
int fused_norm_qkv_resident(int kind, int M, int K, int width, int splits, int* clusters) {
  return fwalk::resident<false>(kind, M, K, width, splits, clusters);
}

// a: [M, K] bf16; res, out: [M, N] bf16; kind, w, s, layer, width,
// splits as above. Same shape rules.
int fused_out_residual(const void* a, const void* res, const void* layer,
                       const void* w, const void* s, void* out, int kind, int M,
                       int K, int N, int width, int splits, void* stream) {
  if (fwalk::bad_shape(kind, M, K, N, splits)) return (int)cudaErrorInvalidValue;
  fwalk::Args r = {};
  r.x = static_cast<const bf16*>(a);
  r.layer = static_cast<const int*>(layer);
  r.w = static_cast<const uint8_t*>(w);
  r.s = static_cast<const __half*>(s);
  r.res = static_cast<const bf16*>(res);
  r.out = out;
  r.M = M;
  r.K = K;
  r.N = r.ncols = N;
  r.splits = splits;
  return walk(r, kind, width, stream);
}

// The clusters of a launch of fused_out_residual's shape (kind, M, K,
// width, splits as above) that the card keeps resident at once.
int fused_out_residual_resident(int kind, int M, int K, int width, int splits,
                                int* clusters) {
  return fwalk::resident<false>(kind, M, K, width, splits, clusters);
}

}  // extern "C"
