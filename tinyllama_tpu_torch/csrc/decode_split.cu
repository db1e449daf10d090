// Single-token grouped-query attention over a long KV cache for Hopper
// (sm_90a), with the key walk split across the card's SMs: bf16 queries,
// a bf16, f16, f32 or int8 cache (kvkind.cuh), f32 softmax and sums, at
// head dim 32 (the tiny configurations), 64 (TinyLlama) or 128 (Llama-3),
// each an instantiation of the template, and 1 to 8 query heads a kv head
// (a runtime argument of every instantiation).
//
// One kernel template serves four TPU kernels, which differ only in how
// key tile t of batch row b is addressed:
//
// K4  flash_decode_heads replaces _decode_heads_kernel in
//     tinyllama_tpu/ops/pallas/flash_prefill.py: the row's slab of the
//     monolithic cache [L, B, Kh, S, d], tile t at key t * 64.
// K10 flash_paged replaces _flash_paged_kernel in
//     tinyllama_tpu/ops/pallas/flash_paged.py: the page pool
//     [L, NP, Kh, P, d], tile t in page table[b, t * 64 / P] (a page is a
//     whole number of tiles).
// K9  flash_staged replaces _flash_staged_kernel in flash_prefill.py, and
// K11 flash_paged_staged replaces _flash_paged_staged_kernel in
//     flash_paged.py: a staged decode chunk (runtime/staging.py). The
//     row's n_pool = ceil(npool / 64) tiles of the slab (K9) or the pool
//     (K11) below npool = min(base[b], capacity) come first, then its
//     n_tail = ceil(ntail / 64) tiles of the staged tail [L, B, Kh, Cs, d]
//     at slots < ntail = min(pos[b] - base[b] + 1, Cs) (Cs % 32 == 0).
//
// The template, its ring, its products and its merge: decode_split.cuh.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "decode_split.cuh"

namespace {

using namespace dsplit;

// The pointers of one call: k, v, sk, sv as the kind's element type; ks,
// vs, sks, svs the f32 scales (null unless int8); nullptr where the entry
// takes no such operand.
struct Ptrs {
  const void *q, *k, *v, *sk, *sv, *ks, *vs, *sks, *svs, *layer, *pos, *base,
      *table;
  void *ws, *out;
};

template <bool PAGED, bool STAGED>
int dispatch(int kv_kind, const Ptrs& p, int B, int H, int Kh, int rows,
             int n_pages, int J, int Cs, int d, int n_split, void* stream) {
  if (!kvkind::valid(kv_kind) || (d != 32 && d != 64 && d != 128) || B < 1 ||
      Kh < 1 || H % Kh || H / Kh > GMAX || rows < BS || rows % BS ||
      (PAGED && (J < 1 || n_pages < 1)) ||
      (STAGED && (Cs < 32 || Cs % 32)))
    return (int)cudaErrorInvalidValue;
  const int cap_tiles = PAGED ? J * (rows / BS) : rows / BS;
  const int tail_tiles = STAGED ? (Cs + BS - 1) / BS : 0;
  if (n_split < 1 || n_split > min(cap_tiles + tail_tiles, MAX_SPLITS) ||
      (long long)B * Kh > MAX_GROUPS || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return kvkind::with_type(kv_kind, [&](auto tag) {
    using KV = decltype(tag);
    Args<KV> a{static_cast<const bf16*>(p.q), static_cast<const KV*>(p.k),
               static_cast<const KV*>(p.v), static_cast<const KV*>(p.sk),
               static_cast<const KV*>(p.sv), static_cast<const float*>(p.ks),
               static_cast<const float*>(p.vs), static_cast<const float*>(p.sks),
               static_cast<const float*>(p.svs), static_cast<const int*>(p.layer),
               static_cast<const int*>(p.pos), static_cast<const int*>(p.base),
               static_cast<const int*>(p.table), static_cast<float*>(p.ws),
               static_cast<bf16*>(p.out), B, Kh, H / Kh, rows, n_pages, J,
               Cs, cap_tiles, n_split};
    return launch_d<PAGED, STAGED>(a, d, st);
  });
}

}  // namespace

extern "C" {

// kv_kind (kvkind.cuh): 0 bf16, 2 f16 or 3 f32 planes with null scales; 1
// int8 planes with f32 scale planes of their shape less d. ws: f32 [B, H,
// n_split, d + 2], written whole before it is read (never zeroed);
// 1 <= n_split <= min(32, the row's capacity in 64-key tiles, a staged
// tail's ceil(Cs / 64) counted); B * Kh <= 65536. One launch: the split
// walk, its last block a group merging. Every entry requires d in {32,
// 64, 128}, 1 <= H / Kh <= 8 and S (or P) % 64 == 0; the staged ones Cs %
// 32 == 0.

// K4. q, out: [B, 1, H, d] bf16; k, v: [L, B, Kh, S, d]; ks, vs: [L, B,
// Kh, S]; layer [1]; pos [B] (pos[b] < S).
int flash_decode_heads(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* layer,
                       const void* pos, void* ws, void* out, int kv_kind, int B,
                       int H, int Kh, int S, int d, int n_split, void* stream) {
  const Ptrs p{q, k, v, nullptr, nullptr, ks, vs, nullptr, nullptr, layer,
               pos, nullptr, nullptr, ws, out};
  return dispatch<false, false>(kv_kind, p, B, H, Kh, S, 0, 0, 0, d, n_split,
                                stream);
}

// K10. q, out: [B, 1, H, d]; k, v: [L, NP, Kh, P, d]; ks, vs: [L, NP, Kh,
// P]; table [B, J]; layer [1]; pos [B].
int flash_paged(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* layer, const void* pos,
                const void* table, void* ws, void* out, int kv_kind, int B,
                int H, int Kh, int n_pages, int P, int J, int d, int n_split,
                void* stream) {
  const Ptrs p{q, k, v, nullptr, nullptr, ks, vs, nullptr, nullptr, layer,
               pos, nullptr, table, ws, out};
  return dispatch<true, false>(kv_kind, p, B, H, Kh, P, n_pages, J, 0, d,
                               n_split, stream);
}

// K9. q, out: [B, 1, H, d]; k, v: [L, B, Kh, S, d]; sk, sv: [L, B, Kh, Cs,
// d]; ks, vs, sks, svs: their scales; layer [1]; pos, base [B].
int flash_staged(const void* q, const void* k, const void* v, const void* sk,
                 const void* sv, const void* ks, const void* vs,
                 const void* sks, const void* svs, const void* layer,
                 const void* pos, const void* base, void* ws, void* out,
                 int kv_kind, int B, int H, int Kh, int S, int Cs, int d,
                 int n_split, void* stream) {
  const Ptrs p{q, k, v, sk, sv, ks, vs, sks, svs, layer, pos, base, nullptr,
               ws, out};
  return dispatch<false, true>(kv_kind, p, B, H, Kh, S, 0, 0, Cs, d, n_split,
                               stream);
}

// K11. q, out: [B, 1, H, d]; k, v: [L, NP, Kh, P, d]; sk, sv: [L, B, Kh,
// Cs, d]; ks, vs, sks, svs: their scales; table [B, J]; layer [1]; pos,
// base [B].
int flash_paged_staged(const void* q, const void* k, const void* v,
                       const void* sk, const void* sv, const void* ks,
                       const void* vs, const void* sks, const void* svs,
                       const void* layer, const void* pos, const void* base,
                       const void* table, void* ws, void* out, int kv_kind,
                       int B, int H, int Kh, int n_pages, int P, int J, int Cs,
                       int d, int n_split, void* stream) {
  const Ptrs p{q, k, v, sk, sv, ks, vs, sks, svs, layer, pos, base, table, ws,
               out};
  return dispatch<true, true>(kv_kind, p, B, H, Kh, P, n_pages, J, Cs, d,
                              n_split, stream);
}

}  // extern "C"