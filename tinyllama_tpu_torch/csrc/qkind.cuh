// The weight kinds of the port's "kn" QTensor (quant/codec.py) as the
// kernels see them, shared by qmatmul.cu and fused_walk.cuh:
//   q8  (kind 0): int8 [K, N], one fp16 scale per 32 rows of K and column;
//   q4  (kind 1): uint8 [K/2, N], one scale per 32 rows;
//   q4g (kind 2): uint8 [K/2, N], one scale per 128 rows.
// A 4-bit byte-row packs two K-rows of a 32-row block: byte-row 16 b + j
// holds K-row 32 b + j in its high nibble and 32 b + j + 16 in its low
// nibble, each with the +7 offset. The kernels are templated on the bits
// (8 or 4); q4 and q4g differ only in which scale row a 32-row block
// reads, its first K-row >> scale_shift(kind), computed once a block.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace qkind {

enum Kind { Q8 = 0, Q4 = 1, Q4G = 2 };

__host__ __device__ constexpr int scale_shift(int kind) { return kind == Q4G ? 7 : 5; }

// K rows that share one scale
__host__ __device__ constexpr int scale_rows(int kind) { return 1 << scale_shift(kind); }

__host__ inline bool valid(int kind) { return kind == Q8 || kind == Q4 || kind == Q4G; }

// Bytes of one layer's [K, N] data plane.
__host__ __device__ inline size_t plane_bytes(int bits, int K, int N) {
  return (size_t)K * bits / 8 * N;
}

// The two offset-7 nibbles of byte b (the low 8 bits) as exact floats.
__device__ inline float hi4(uint32_t b) { return (float)((int)((b >> 4) & 15u) - 7); }
__device__ inline float lo4(uint32_t b) { return (float)((int)(b & 15u) - 7); }

// Call f(std::integral_constant<int, BITS>{}) with the kind's bits.
template <class F>
__host__ inline int with_bits(int kind, F f) {
  if (kind == Q8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 4>{});
}

}  // namespace qkind
