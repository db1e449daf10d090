// Fused SwiGLU FFN for Hopper (sm_90a), two launches a call:
//   ffn_fused_normed: out = x + down(silu(gate) * up) over rms_norm(x)
//   ffn_fused:        out = down(silu(gate) * up) over x as given
// gate | up = x @ dequant(w_gateup) ([L, D, 2F] "kn", gate columns first),
// down = act @ dequant(w_down) ([L, F, D]), both of one kind: q8, or q4 /
// q4g with [L, K/2, N] nibble data (qkind.cuh); M <= 32 bf16 rows, f32
// accumulation, the layer index read from device memory.
//
// K7 replaces _ffn_fused_kernel in tinyllama_tpu/ops/pallas/ffn_fused.py
//   (entries ffn_fused and ffn_fused_normed; dot bodies _block_dot_q at
//   bm <= 8 and _tile_dot_q above). Bound: the weight bytes over the
//   memory rate at every M <= 32 (36.8 MB a layer at TinyLlama's D 2048,
//   F 5632 in q8; 19.5 MB in q4, 17.8 MB in q4g).
//   Design: the TPU kernel walks one sequential grid: gate/up tiles write
//   silu(gate) * up into a VMEM scratch, and later grid steps run the down
//   matmul from that scratch. Here both phases are the walk of
//   fused_walk.cuh (a cp.async ring of raw weight rows a block, x staged
//   once a block, products on mma.sync, split K summed in a cluster):
//   - gate/up: a tile is gate columns [j, j + 128) with up columns [F + j,
//     F + j + 128), a 128-byte strip of each and one staged x slice for
//     both, split over K by ops/kernels/fused_plan.py (44 tiles x 4 splits
//     at TinyLlama's widths: 176 blocks); the cluster takes rms_norm's
//     statistic from its splits' sums of squares, and its epilogue writes
//     silu(g) * up = g / (1 + exp(-g)) * up, in f32, once as bf16 to the
//     [M, F] workspace: the value the down product multiplies (the TPU
//     kernel casts the scratch slice to the compute dtype);
//   - the hand-off: the down launch is a programmatic dependent launch
//     (griddepcontrol): its blocks start as the gate/up blocks finish,
//     issue their first stages of w_down, and wait for the gate/up grid
//     before they read the workspace. It costs about 1 us over one launch
//     on the card, and replays in a CUDA graph (PERF.md: a cooperative
//     launch with clusters crossing a grid barrier was measured beside it);
//   - down: 16 tiles of 128 columns x 8 splits of F (128 blocks, every
//     cluster resident at once: 32 tiles of 64 would be 256 blocks, and
//     the H100 keeps 30 clusters of 8); each stages its K slice of the
//     workspace, and the residual joins the f32 sum in the epilogue, cast
//     once.
//
// The launch entry point returns cudaGetLastError() after its launches.

#include "fused_walk.cuh"

extern "C" {

// x, out: [M, D] bf16; nw: [L, D] f32, or null for the plain entry (no
// norm, no residual); kind: 0 q8, 1 q4, 2 q4g, of both weights; gu, gus:
// [L, D, 2F] int8 (or [L, D/2, 2F] uint8) and [L, D/32 (or D/128), 2F]
// fp16; wd, wds: [L, F, D] (or [L, F/2, D]) and [L, F/32 (or F/128), D];
// act: [M, F] bf16 workspace; layer: [1] int32; width_gu, splits_gu,
// width_down, splits_down: each phase's tile width (64 or 128 columns) and
// K splits (ops/kernels/fused_plan.py). Requires 1 <= M <= 32, D and F
// multiples of 32 and of the scale block, and each split count in [1,
// min(8, ceil(K / 64))].
int ffn_fused(const void* x, const void* nw, const void* layer, const void* gu,
              const void* gus, const void* wd, const void* wds, void* act,
              void* out, int kind, int M, int D, int F, float eps, int inside,
              int width_gu, int splits_gu, int width_down, int splits_down,
              void* stream) {
  if (fwalk::bad_shape(kind, M, D, F, splits_gu) ||
      fwalk::bad_shape(kind, M, F, D, splits_down))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  using fwalk::bf16;
  fwalk::Args up = {};  // x -> silu(gate) * up
  up.x = static_cast<const bf16*>(x);
  up.nw = static_cast<const float*>(nw);
  up.layer = static_cast<const int*>(layer);
  up.w = static_cast<const uint8_t*>(gu);
  up.s = static_cast<const __half*>(gus);
  up.out = static_cast<bf16*>(act);
  up.M = M;
  up.K = D;
  up.N = 2 * F;
  up.ncols = F;
  up.eps = eps;
  up.inside = inside;
  up.splits = splits_gu;
  fwalk::Args down = {};  // act -> out (+ x)
  down.x = static_cast<const bf16*>(act);
  down.layer = up.layer;
  down.w = static_cast<const uint8_t*>(wd);
  down.s = static_cast<const __half*>(wds);
  down.res = nw ? up.x : nullptr;
  down.out = static_cast<bf16*>(out);
  down.M = M;
  down.K = F;
  down.N = down.ncols = D;
  down.splits = splits_down;
  return fwalk::with_row_tile(M, [&](auto mt) {
    return qkind::with_bits(kind, [&](auto bits) {
      constexpr int MT = decltype(mt)::value, BITS = decltype(bits)::value;
      const int err = fwalk::with_width(width_gu, [&](auto sw) {
        return fwalk::launch<MT, BITS, decltype(sw)::value, true>(up, kind, false, st);
      });
      return err ? err : fwalk::with_width(width_down, [&](auto sw) {
        return fwalk::launch<MT, BITS, decltype(sw)::value, false>(down, kind, true, st);
      });
    });
  });
}

// The clusters of one of ffn_fused's launches (kind, M as above; K: D for
// the gate/up launch, F for the down launch; its width and splits) that
// the card keeps resident at once, into *clusters. pair: the gate/up
// launch.
int ffn_fused_resident(int kind, int M, int K, int width, int splits, int pair,
                       int* clusters) {
  return pair ? fwalk::resident<true>(kind, M, K, width, splits, clusters)
              : fwalk::resident<false>(kind, M, K, width, splits, clusters);
}

}  // extern "C"
