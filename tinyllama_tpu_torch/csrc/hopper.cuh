// Hopper (sm_90a) building blocks shared by the prefill kernels K2
// (qmatmul.cu) and K3 (flash_attention.cu) and the fused decode walk of
// K5 and K7 (fused_walk.cuh), written as inline PTX:
//
// * the ring: 16-byte cp.async copies into shared memory, each thread's
//   copies of a stage signalling the stage's mbarrier when they land
//   (cp.async.mbarrier.arrive.noinc, the barrier initialised to the
//   block's thread count), and a parity wait on it;
// * warpgroup products: wgmma.mma_async with bf16 operands and f32
//   accumulators in registers, A and B from shared memory (SS: K3's
//   scores) or A from registers (RS: K3's P V, K2's dequantized weight),
//   and the fence / commit / wait around them; ldmatrix.trans, which K2
//   reads its raw weight bytes with; the warp products mma.sync.m16n8k16
//   (bf16) and m16n8k32 (s8, int32 accumulators) and plain ldmatrix, for
//   the decode walk's narrow x tiles;
// * programmatic dependent launch (griddepcontrol), K7's hand-off; the
//   halves of a relaxed cluster barrier, and asynchronous stores into a
//   cluster peer's shared memory counted on its mbarrier (st.async);
// * the shared-memory matrix descriptor for the 128-byte swizzle: a
//   bf16 tile of 128-byte rows (64 values), row r's 16-byte chunk c
//   stored at chunk c ^ (r & 7) of the row, 1024-byte aligned. A K-major
//   operand (rows are M or N, the 64 values run along K) steps K by 16
//   values as +32 bytes; an MN-major operand (rows are K) steps K by 16
//   rows as +2048 bytes, and its next 64 values of N are `lbo` bytes on.
//
// Accumulator layout of wgmma.m64nNk16 (f32): thread t of the warpgroup
// (warp w = t / 32, lane l) holds d[4 j + 2 i + e] at row 16 w + l / 4 +
// 8 i, column 8 j + 2 (l % 4) + e (i, e in {0, 1}, j < N / 8). The bf16
// A operand from registers (K columns 16 kk .. 16 kk + 15) is four
// bf16x2: rows 16 w + l / 4 and that + 8, columns 2 (l % 4) + {0, 1} and
// that + 8, in the order (row, col), (row + 8, col), (row, col + 8),
// (row + 8, col + 8); so the pairs (d[8 kk + 2 p], d[8 kk + 2 p + 1]),
// p = 0 .. 3, of one product's f32 accumulator are the A fragment of the
// next.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary at or after p (a dynamic shared-memory
// base is only 16-byte aligned; the swizzle atoms need 1024).
__device__ inline unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ inline int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// ------------------------------------------------------------- the ring

// 16 bytes from global to shared; `bytes` < 16 fills the rest with zeros
// (0: all zeros, and src is not read).
__device__ inline void cp_async16(void* dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 or 8 bytes from global to shared (both aligned to their size), zero
// where `bytes` is 0: the walk's copies where a row is not 16-byte aligned.
__device__ inline void cp_async4(void* dst, const void* src, int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ inline void cp_async8(void* dst, const void* src, int bytes = 8) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible before any thread uses them
// (the caller then synchronizes the block).
__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival on `bar`, made when all its earlier cp.async
// copies have landed (the barrier counts it among its init count).
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's shared-memory accesses through the generic proxy
// (plain stores, and copies it has seen land) before the async proxy's
// (wgmma operand reads) that follow.
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------- the products

__device__ inline uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);  // 128-byte swizzle
}
// a K-major swizzled tile: 8-row groups 1024 bytes apart
__device__ inline uint64_t desc_k(uint32_t saddr) { return desc(saddr, 16, 1024); }
// an MN-major swizzled tile: 8-row (K) groups 1024 bytes apart, the next
// 64 values of N `lbo` bytes on
__device__ inline uint64_t desc_mn(uint32_t saddr, uint32_t lbo) {
  return desc(saddr, lbo, 1024);
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers
// across the asynchronous products.
template <int N>
__device__ inline void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A operands in registers, which the products read until
// they complete: fenced after the wait, they stay live until then.
template <int N>
__device__ inline void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HOPPER_R8(b)                                                          \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B from shared memory, both
// K-major.
__device__ inline void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A the four bf16x2 registers a of
// each thread, B from shared memory, MN-major.
__device__ inline void wgmma_m64n64_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A the four bf16x2 registers a
// of each thread, B from shared memory, K-major.
__device__ inline void wgmma_m64n128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24), HOPPER_R8(32),
        HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_R8

// Four 8 x 8 matrices of 16-bit elements, transposed: lanes 8 i .. 8 i + 7
// give the addresses of matrix i's 8 rows (16 bytes each); lane l gets in
// r[i] the elements (row 2 (l % 4), column l / 4) (low half) and (row 2
// (l % 4) + 1, column l / 4) (high half) of matrix i.
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// Four 8 x 8 matrices of 16-bit elements as they are: lanes 8 i .. 8 i + 7
// give the addresses of matrix i's rows; lane l gets in r[i] the elements
// (row l / 4, columns 2 (l % 4) and that + 1) of matrix i.
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// d[16 x 8] += A[16 x 16] B[16 x 8] on one warp, bf16 operands, f32
// accumulators: a as wgmma's register A fragment of one warp (above), b0
// the B elements (k 2 (l % 4) + {0, 1}, n l / 4) and b1 those at k + 8;
// d[2 i + e] is row l / 4 + 8 i, column 2 (l % 4) + e.
__device__ inline void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16 x 8] += A[16 x 32] B[32 x 8] on one warp, s8 operands, exact
// int32 accumulators: a[0] the A bytes (row l / 4, k 4 (l % 4) + {0..3}),
// a[1] those of row l / 4 + 8, a[2], a[3] the same at k + 16; b0 the B
// bytes (k 4 (l % 4) + {0..3}, n l / 4) and b1 those at k + 16; d[2 i +
// e] is row l / 4 + 8 i, column 2 (l % 4) + e.
__device__ inline void mma_16832_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Programmatic dependent launch: let the next launch in the stream (made
// with the programmatic-serialization attribute) start its blocks once
// every block of this grid has called this or exited; and, in that next
// launch, wait until the grid before it has completed and its writes are
// visible (at once when it was not launched so).
__device__ inline void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ inline void wait_prior_grid() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The two halves of a cluster barrier (every thread of every block of the
// cluster) that only says a point was reached: arrive without ordering
// this thread's earlier memory accesses (a release may wait for its
// cp.async copies in flight), then wait for every arrival.
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory: the address of `p` (this block's shared
// memory) in the shared memory of block `rank` of the cluster.
__device__ inline uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Store v at cluster address `dst` of a block of the cluster, its bytes
// counted on that block's mbarrier at cluster address `bar` (which
// expects them): no fence, no barrier.
__device__ inline void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ inline void st_async(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// Arrive on `bar` (initialized with a count of 1) and let its phase also
// wait for `bytes` of asynchronous stores into this block.
__device__ inline void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed, acquiring
// at cluster scope what other blocks' asynchronous stores brought.
__device__ inline void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace hopper
