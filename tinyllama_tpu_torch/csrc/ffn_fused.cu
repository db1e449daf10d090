// Fused SwiGLU FFN for Hopper (sm_90a), one launch:
//   ffn_fused_normed: out = x + down(silu(gate) * up) over rms_norm(x)
//   ffn_fused:        out = down(silu(gate) * up) over x as given
// gate | up = x @ dequant(w_gateup) ([L, D, 2F] "kn", gate columns first),
// down = act @ dequant(w_down) ([L, F, D]), both of one kind: q8, or q4 /
// q4g with [L, K/2, N] nibble data (qkind.cuh); M <= 32 bf16 rows, f32
// accumulation, the layer index read from device memory.
//
// K7 replaces _ffn_fused_kernel in tinyllama_tpu/ops/pallas/ffn_fused.py
//   (entries ffn_fused and ffn_fused_normed). Bound: the weight bytes over
//   the memory rate (36.8 MB a layer at TinyLlama's D 2048, F 5632 in q8;
//   19.5 MB in q4, 17.8 MB in q4g, whose w_down K of 5632 is 44 scale
//   groups of 128).
//   Design: the TPU kernel walks one sequential grid: gate/up tiles write
//   silu(gate) * up into a VMEM scratch, and later grid steps run the down
//   matmul from that scratch. Hopper blocks run in no order, so the walk
//   becomes two phases of one cooperative launch:
//   - gate/up: a block takes gate columns [j, j+32) and the matching up
//     columns [F+j, F+j+32) (strips of qstrip.cuh, grid-strided over the
//     F/32 pairs), keeps the gate sums in shared memory and writes
//     silu(gate) * up in f32 to a global [M, F] workspace (22 KB at M = 1,
//     720 KB at M = 32: it stays in L2);
//   - a grid-wide barrier (cooperative_groups grid sync);
//   - down: a block takes 32 output columns of w_down and stages the
//     workspace through L2 (__ldcg: written by other SMs in this launch,
//     so it must not come from a stale L1 line), each value rounded to
//     bf16 as the TPU kernel casts the scratch slice; the residual joins
//     the f32 sum in the epilogue.
//   Each block of the normed entry recomputes the row statistics of
//   rms_norm from x (the TPU kernel's first-step VMEM norm). The grid is
//   capped at the blocks the card holds at once, counted for each (row
//   tile, bits) instantiation; the shared memory does not depend on the
//   bits.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>

#include "qstrip.cuh"

namespace {

using qstrip::bf16;
using qstrip::COLS;
using qstrip::THREADS;

template <int MT, int BITS>
__global__ void __launch_bounds__(THREADS)
ffn_fused_kernel(const bf16* __restrict__ x, const float* __restrict__ nw,
                 const int* __restrict__ layer, const uint8_t* __restrict__ gu,
                 const __half* __restrict__ gus, const uint8_t* __restrict__ wd,
                 const __half* __restrict__ wds, float* act,
                 bf16* __restrict__ out, int M, int D, int F, float eps,
                 int inside, int sshift) {
  extern __shared__ __align__(128) float buf[];
  __shared__ float stat[qstrip::MAX_M];
  __shared__ float gate[MT * COLS];
  const int li = layer[0];
  gu += (size_t)li * qkind::plane_bytes(BITS, D, 2 * F);
  gus += (size_t)li * (D >> sshift) * 2 * F;
  wd += (size_t)li * qkind::plane_bytes(BITS, F, D);
  wds += (size_t)li * (F >> sshift) * D;
  const bool norm = nw != nullptr;
  if (norm) {
    nw += (size_t)li * D;
    qstrip::row_rms(x, M, D, eps, inside, stat);
  }
  auto stage_x = [&](float* b, int k0, int kc) {
    qstrip::stage_rows<MT>(b, M, k0, kc, [&](int m, int k, float(&v)[8]) {
      if (norm)
        qstrip::load_normed8(x, nw, D, stat, inside, m, k, v);
      else
        qstrip::load_bf16x8(x + (size_t)m * D + k, v);
    });
  };

  // phase 1: silu(gate) * up for F/32 column pairs
  for (int j = blockIdx.x * COLS; j < F; j += gridDim.x * COLS) {
    qstrip::strip_matmul<MT, BITS>(buf, gu, gus, D, 2 * F, j, sshift, stage_x,
                                   [&](int m, int n, float v) {
                                     gate[m * COLS + n - j] = v;
                                   });
    qstrip::strip_matmul<MT, BITS>(
        buf, gu, gus, D, 2 * F, F + j, sshift, stage_x, [&](int m, int n, float v) {
          if (m < M) {
            const float g = gate[m * COLS + n - F - j];
            act[(size_t)m * F + n - F] = g / (1.f + expf(-g)) * v;
          }
        });
  }

  cooperative_groups::this_grid().sync();

  // phase 2: down strips over the workspace, plus the residual
  for (int j = blockIdx.x * COLS; j < D; j += gridDim.x * COLS) {
    qstrip::strip_matmul<MT, BITS>(
        buf, wd, wds, F, D, j, sshift,
        [&](float* b, int k0, int kc) {
          qstrip::stage_rows<MT>(b, M, k0, kc, [&](int m, int k, float(&v)[8]) {
            qstrip::load_l2_f32x8(act + (size_t)m * F + k, v);
          });
        },
        [&](int m, int n, float v) {
          if (m < M) {
            const size_t o = (size_t)m * D + n;
            out[o] = __float2bfloat16((norm ? __bfloat162float(x[o]) : 0.f) + v);
          }
        });
  }
}

}  // namespace

extern "C" {

// x, out: [M, D] bf16; nw: [L, D] f32, or null for the plain entry (no
// norm, no residual); kind: 0 q8, 1 q4, 2 q4g, of both weights; gu, gus:
// [L, D, 2F] int8 (or [L, D/2, 2F] uint8) and [L, D/32 (or D/128), 2F]
// fp16; wd, wds: [L, F, D] (or [L, F/2, D]) and [L, F/32 (or F/128), D];
// act: [M, F] f32 workspace; layer: [1] int32. Requires 1 <= M <= 32, D
// and F multiples of 32 and of the scale block.
int ffn_fused(const void* x, const void* nw, const void* layer, const void* gu,
              const void* gus, const void* wd, const void* wds, void* act,
              void* out, int kind, int M, int D, int F, float eps, int inside,
              void* stream) {
  if (!qkind::valid(kind) || M < 1 || M > qstrip::MAX_M || D < COLS || D % COLS ||
      F < COLS || F % COLS || D % qkind::scale_rows(kind) ||
      F % qkind::scale_rows(kind))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int sh = qkind::scale_shift(kind);
  return qstrip::with_row_tile(M, [&](auto mt) {
    return qkind::with_bits(kind, [&](auto bits) {
      constexpr int MT = decltype(mt)::value, BITS = decltype(bits)::value;
      auto kernel = ffn_fused_kernel<MT, BITS>;
      const int bytes = qstrip::smem_floats(MT) * sizeof(float);
      static const cudaError_t smem = qstrip::allow_smem(kernel, bytes);
      if (smem) return (int)smem;
      static int resident = 0;
      static const cudaError_t occ = qstrip::resident_blocks(kernel, bytes, &resident);
      if (occ) return (int)occ;
      const int want = (F > D ? F : D) / COLS;
      const int grid = want < resident ? want : resident;
      const cudaError_t err = qstrip::launch_cooperative(
          kernel, grid, bytes, st, static_cast<const bf16*>(x),
          static_cast<const float*>(nw), static_cast<const int*>(layer),
          static_cast<const uint8_t*>(gu), static_cast<const __half*>(gus),
          static_cast<const uint8_t*>(wd), static_cast<const __half*>(wds),
          static_cast<float*>(act), static_cast<bf16*>(out), M, D, F, eps,
          inside, sh);
      cudaError_t last = cudaGetLastError();
      return (int)(err ? err : last);
    });
  });
}

}  // extern "C"
