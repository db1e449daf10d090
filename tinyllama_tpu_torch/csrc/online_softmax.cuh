// The online-softmax (m, l, acc) recurrence shared by the attention
// kernels: the counterpart of online_update_batch in
// tinyllama_tpu/ops/pallas/softmax_update.py (the TPU prefill kernel
// inlines the same recurrence).
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

// One step of the recurrence for one query row over one tile of keys,
// run by a whole warp. Each lane holds N of the row's scores (already
// scaled); ok marks the keys the row may see.
//
// On return s holds the unnormalized probabilities exp(s - m_new), 0 at
// masked keys; m and l are the updated running max and normalizer (equal
// in every lane); the result alpha = exp(m_old - m_new) is the factor by
// which the caller rescales the row's weighted-V accumulator before it
// adds this tile's probabilities times V.
template <int N>
__device__ inline float online_softmax_update(float (&s)[N], const bool (&ok)[N],
                                              float& m, float& l) {
  float mx = TL_NEG_INF;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (ok[i]) mx = fmaxf(mx, s[i]);
  const float m_new = fmaxf(m, tl_warp_max(mx));
  const float alpha = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ok[i] ? expf(s[i] - m_new) : 0.f;
    sum += s[i];
  }
  l = l * alpha + tl_warp_sum(sum);
  m = m_new;
  return alpha;
}
