// What the attention kernels' online-softmax (m, l, acc) recurrences
// share, the counterpart of online_update_batch in
// tinyllama_tpu/ops/pallas/softmax_update.py: the running max's start and
// the warp-wide max and sum. Each kernel runs the recurrence in its own
// registers (flash_attention.cu, decode_split.cuh).
#pragma once

#include <cuda_runtime.h>

// Finite stand-in for minus infinity as the running max starts, as the
// TPU kernels use (-0.7 * FLT_MAX): exp(TL_NEG_INF - m) underflows to 0
// and no inf - inf ever forms.
#define TL_NEG_INF (-0.7f * 3.402823466e38f)

__device__ inline float tl_warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float tl_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
