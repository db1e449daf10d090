// The KV-cache kinds of the attention kernels (runtime/kvcache.py), as
// qkind.cuh is for the weights:
//   bf16 (kind 0): bf16 k/v planes, no scales;
//   i8   (kind 1): int8 k/v planes, each (kv head, position) row with one
//        f32 scale (absmax / 127) in a plane of the data's shape less d;
//   f16  (kind 2): f16 k/v planes, no scales;
//   f32  (kind 3): f32 k/v planes, no scales.
// The attention kernels are templated on the element type. Every kind
// stages keys and values into shared memory as bf16, so the tile code
// after the load is shared: an int8 value times its row's scale is
// rounded to bf16 (an int8 row costs 64 bytes of device memory and a
// 4-byte scale instead of 128); an f16 or f32
// value is rounded to bf16 to nearest even, as the TPU kernels cast a
// tile to the compute dtype (astype(bf16); f16 -> f32 is exact, so going
// through f32 rounds once). An f16 row costs 128 bytes, an f32 row 256.
// Where the scales go: K3, K4 and K8-K11 dequantize a tile's keys and
// values as it lands (load8_scaled, flash_prefill.py's
// (k * ks).astype(bf16)), as the plain versions do; the TPU kernels fold a
// key's scale into its score after the 1/sqrt(d) scale instead
// (softmax_update.py) and round p * vs to bf16 for the MXU, where these
// kernels, whose products run on the tensor cores, round p and v * vs to
// bf16 apart (PERF.md, the int8 rounding against JAX).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace kvkind {

enum Kind { BF16 = 0, I8 = 1, F16 = 2, F32 = 3 };

__host__ inline bool valid(int kind) { return kind >= BF16 && kind <= F32; }

template <class KV>
constexpr bool is_i8 = std::is_same<KV, int8_t>::value;

__device__ inline uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a at the lower address
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte i of w as a signed value.
__device__ inline float byte_at(uint32_t w, int i) {
  return (float)(int8_t)((w >> (8 * i)) & 0xffu);
}

// Eight consecutive int8 values times s, each rounded to bf16, as a uint4
// of eight bf16 (one 8-byte load; 8-byte aligned).
__device__ inline uint4 load8_scaled(const int8_t* p, float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_uint4(bf16x2(byte_at(raw.x, 0) * s, byte_at(raw.x, 1) * s),
                    bf16x2(byte_at(raw.x, 2) * s, byte_at(raw.x, 3) * s),
                    bf16x2(byte_at(raw.y, 0) * s, byte_at(raw.y, 1) * s),
                    bf16x2(byte_at(raw.y, 2) * s, byte_at(raw.y, 3) * s));
}

// Eight consecutive values as eight bf16: a 16-byte load of bf16; a
// 16-byte load of f16, or two of f32, rounded to nearest even. p is
// aligned to the load.
__device__ inline uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ inline uint4 load8(const __half* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __half22float2(h[i]);
  return make_uint4(bf16x2(f[0].x, f[0].y), bf16x2(f[1].x, f[1].y),
                    bf16x2(f[2].x, f[2].y), bf16x2(f[3].x, f[3].y));
}
__device__ inline uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y),
                    bf16x2(b.z, b.w));
}

// Call f(KV{}) with the kind's element type (__nv_bfloat16, int8_t,
// __half or float).
template <class F>
__host__ inline int with_type(int kind, F f) {
  if (kind == I8) return f(int8_t{});
  if (kind == F16) return f(__half{});
  if (kind == F32) return f(float{});
  return f(__nv_bfloat16{});
}

}  // namespace kvkind
