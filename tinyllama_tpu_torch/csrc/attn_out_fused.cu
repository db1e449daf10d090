// Fused batch-1 decode attention + output projection + residual for
// Hopper (sm_90a), two launches from one entry point:
//   out = residual + attention(q, cache layer, keys 0..pos) @ dequant(wo)
// q [H, d] bf16 of the one new token (head dim d = 32, 64 or 128); the
// stacked cache [L, 1, Kh, S, d], bf16, f16, f32, or int8 with f32 scales
// [L, 1, Kh, S] (kvkind.cuh), with the token's k/v already written; wo
// the layer-stacked "kn" weight [L, H*d, N] (q8, or q4 / q4g as [L,
// H*d/2, N] nibble data; qkind.cuh); the layer index and pos read from
// device memory.
//
// K8 replaces the kernel of _run_attn_out in
//   tinyllama_tpu/ops/pallas/attn_out_fused.py. Bound: the bytes of wo
//   (4.46 MB at TinyLlama's 2048 x 2048 in q8, 2.36 MB in q4) plus the
//   visible keys and values, 1,024 * (pos + 1) bytes at TinyLlama's 4 kv
//   heads in bf16 and f16, 2,048 * (pos + 1) in f32 or 544 * (pos + 1) in
//   int8 with its scales, over the memory rate. Design: the TPU kernel
//   walks one sequential grid, the attention's online softmax into VMEM
//   scratch first, then wo's tiles against that scratch. On Hopper the two
//   phases are the port's two templates, launched one after the other on
//   the stream:
//   - attention: the split-key template of decode_split.cuh at K4's
//     addressing (B = 1, G = H / Kh query heads a kv head, any G <= 8, a
//     runtime argument; one instantiation a head dim and KV kind):
//     mma.sync products over a cp.async ring, a row of at most SOLO_TILES
//     tiles one block's, a longer one split over n_split blocks
//     (decode_split.decode_splits, host sizes only) and merged by the last
//     block to arrive; each head's result rounded to bf16, as the TPU
//     kernel casts its scratch, into a [H * d] workspace;
//   - wo: one launch of the walk of fused_walk.cuh with K6's arguments (x
//     that workspace, M = 1; row tile 8: exact integer products scaled
//     after each 32-row block, the TPU's m = 1 blockdot; split K summed in
//     a cluster, the residual joining the f32 sum once and the result cast
//     once), its plan from host sizes and the card's residency
//     (fused_attn_out_resident) by K1's rule at M = 1 (128 columns x 8
//     splits at TinyLlama's widths). It is a programmatic dependent
//     launch: the attention's blocks let it start once their first copies
//     are issued (TRIGGER), and its blocks issue their ring stages of wo,
//     at TinyLlama's widths a block's whole share, before they wait for
//     the attention grid and copy x. So wo streams while the attention
//     runs; the cooperative launch this replaced started wo only after two
//     grid-wide barriers.
//   An int8 cache's keys and values are dequantized to bf16 as a tile
//   lands, as K4's are and as the plain version does (kvkind.cuh).
//
// The entry point returns cudaGetLastError() after its launches.

#include "decode_split.cuh"
#include "fused_walk.cuh"

extern "C" {

// q: [H, d] bf16; k, v: [L, 1, Kh, S, d] of kv_kind (0 bf16, 1 int8,
// 2 f16, 3 f32); ks, vs: [L, 1, Kh, S] f32 scales (int8, 16-byte
// aligned; else null); layer, pos: [1] int32; kind: 0 q8, 1 q4, 2 q4g;
// w, s: [L, H*d, N] int8 (or [L, H*d/2, N] uint8) and [L, H*d/32 (or
// /128), N] fp16; res, out: [N] bf16; ws: f32 [H, n_split, d + 2] and
// attn: bf16 [H * d] workspaces (never zeroed); n_split: the attention's
// splits, 1 <= n_split <= min(32, S / 64); width, splits: the wo walk's
// tile width (64 or 128) and K splits (ops/kernels/fused_plan.py).
// Requires d in {32, 64, 128}, H / Kh <= 8, S % 64 == 0, N % 32 == 0,
// H * d a multiple of the scale block, splits <= the walk's K steps and
// pos < S.
int fused_attn_out(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* layer, const void* pos,
                   const void* w, const void* s, const void* res, void* ws,
                   void* attn, void* out, int kind, int kv_kind, int H, int Kh,
                   int S, int N, int d, int n_split, int width, int splits,
                   void* stream) {
  const int K = H * d;
  if (!kvkind::valid(kv_kind) || (d != 32 && d != 64 && d != 128) || Kh < 1 ||
      H % Kh || H / Kh > dsplit::GMAX ||
      S < dsplit::BS || S % dsplit::BS || n_split < 1 ||
      n_split > min(S / dsplit::BS, dsplit::MAX_SPLITS) ||
      Kh > dsplit::MAX_GROUPS || N % 32 || fwalk::bad_shape(kind, 1, K, N, splits))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int err = kvkind::with_type(kv_kind, [&](auto tag) {
    using KV = decltype(tag);
    dsplit::Args<KV> a = {};
    a.q = static_cast<const dsplit::bf16*>(q);
    a.k = static_cast<const KV*>(k);
    a.v = static_cast<const KV*>(v);
    a.ks = static_cast<const float*>(ks);
    a.vs = static_cast<const float*>(vs);
    a.layer = static_cast<const int*>(layer);
    a.pos = static_cast<const int*>(pos);
    a.ws = static_cast<float*>(ws);
    a.out = static_cast<dsplit::bf16*>(attn);
    a.B = 1;
    a.Kh = Kh;
    a.G = H / Kh;
    a.rows = S;
    a.cap_tiles = S / dsplit::BS;
    a.n_split = n_split;
    // the wo walk may start once the attention's copies are issued
    return dsplit::launch_d<false, false, KV, true>(a, d, st);
  });
  if (err) return err;
  fwalk::Args r = {};  // attn -> out (+ res)
  r.x = static_cast<const fwalk::bf16*>(attn);
  r.layer = static_cast<const int*>(layer);
  r.w = static_cast<const uint8_t*>(w);
  r.s = static_cast<const __half*>(s);
  r.res = static_cast<const fwalk::bf16*>(res);
  r.out = out;
  r.M = 1;
  r.K = K;
  r.N = r.ncols = N;
  r.splits = splits;
  return qkind::with_bits(kind, [&](auto bits) {
    return fwalk::with_width(width, [&](auto sw) {
      return fwalk::launch<8, decltype(bits)::value, decltype(sw)::value, false>(r, kind, true,
                                                                                st);
    });
  });
}

// The clusters of fused_attn_out's wo launch (kind, K = H * d, width,
// splits as above) that the card keeps resident at once, into *clusters.
int fused_attn_out_resident(int kind, int K, int width, int splits, int* clusters) {
  if (fwalk::bad_shape(kind, 1, K, 32, splits)) return (int)cudaErrorInvalidValue;
  return qkind::with_bits(kind, [&](auto bits) {
    return fwalk::with_width(width, [&](auto sw) {
      return fwalk::resident_of<8, decltype(bits)::value, decltype(sw)::value, false>(
          K, splits, clusters);
    });
  });
}

}  // extern "C"
