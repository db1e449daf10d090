"""Causal GQA attention of new tokens against layer `layer` of the stacked
KV cache ([L, B, Kh, S, d], the new k/v already written).

Replaces three kernels of tinyllama_tpu/ops/pallas/flash_prefill.py with
hand-written Hopper kernels, which share the online-softmax step of
csrc/online_softmax.cuh (the counterpart of
softmax_update.online_update_batch):

* K3 ``flash_prefill`` for ``_flash_attn_kernel`` (T new tokens at
  ``pos``): bound by the tensor-core rate of the QK^T and PV products.
  Its source is csrc/flash_attention.cu. One warpgroup a block, per
  (row, kv head, 64 flattened (token, group) query rows), so a token's
  G query heads share every K/V tile; the row blocks run in reverse
  (``prefill_row_blocks``), longest causal walks first. Both products
  are ``wgmma``: the scores' online softmax stays in the accumulator
  registers, whose bf16 probabilities are the A operand of P V. Key
  tiles come through a cp.async ring with mbarriers; tiles above the
  causal diagonal are neither loaded nor computed.
* K4 ``flash_decode_heads`` for ``_decode_heads_kernel`` (T = 1): bound
  by the bytes of the pos+1 cached keys and values.
* K9 ``flash_staged`` for ``_flash_staged_kernel`` (T = 1 in a staged
  decode chunk): the cache's tiles below the chunk's base, then the
  chunk's staged tail (runtime/staging.py) as the row's last tiles.
  Bound by the bytes of the keys and values each row attends. It shares
  K11's input checks and plain version (ops/kernels/flash_paged.py).

K4 and K9 have one source, csrc/decode_split.cu, a template with K10 and
K11: the key walk split over (Kh, B, n_split) blocks, each pipelining
its share of the tiles through a cp.async ring, then a merge of the
partials in the same launch (ops/kernels/decode_split.py).

The layer index and the positions are device tensors, read inside the
kernels. The cache is bf16, f16, f32, or int8 with f32 scale planes. An
int8 tile is dequantized by K3 once its raw bytes land; K4 and K9 read
half the bytes a key and round each key and value times its scale to
bf16 as a tile is converted (as the plain version dequantizes; the TPU
kernels fold the key scales into the scores and the value scales into
the probabilities). f16 and f32 values are rounded to bf16 once a
tile after its raw bytes land, as the TPU kernels cast a tile to the
compute dtype. CUDA tensors (bf16 q, d = 32, 64 or 128, each an
instantiation of the kernels' templates, and for K4 and K9 1 to 8 query
heads a kv head: ``flash_paged.check_heads``) launch a kernel or raise;
only CPU tensors go to the plain version, ``gqa_attention`` over the
layer's cache, dequantized.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.kernels import decode_split as ds
from tinyllama_tpu_torch.ops.kernels import flash_paged as fp
from tinyllama_tpu_torch.ops.kernels.qmatmul import layer_index
from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view

#: launches of each kernel since the counts were last set to 0; a cache of
#: another kind than bf16 counts under "<name>_i8", "_f16" or "_f32".
launches = {name + sfx: 0
            for name in ("flash_prefill", "flash_decode_heads", "flash_staged")
            for sfx in fp.KV_SUFFIX}

#: keys per tile: the cache length must be a whole number of tiles.
KEY_TILE = 64
#: K3's flattened (token, group member) query rows a block
QUERY_ROWS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_prefill.argtypes is None:
        lib.flash_prefill.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        lib.flash_prefill.restype = _I
    return lib


def attention_ref(q: torch.Tensor, cache: KVCache, layer,
                  pos: torch.Tensor) -> torch.Tensor:
    """Plain version of both kernels, any device: q [B, T, H, d] at
    absolute positions pos[b] + t against cache layer `layer`."""
    B, T = q.shape[:2]
    q_positions = (pos.reshape(B, 1).long()
                   + torch.arange(T, device=q.device)[None, :])
    k, v = layer_cache_view(cache, layer_index(layer), q.dtype)
    return gqa_attention(q, k, v, q_positions)


def prefill_row_blocks(T: int, G: int) -> list[range]:
    """K3's flattened query rows of each block, in launch order: block x
    takes rows [r0, r0 + 64) with r0 = (n_blocks - 1 - x) * 64 (cut at
    T * G), so the blocks whose rows reach furthest along the causal walk
    start first. Row r is token r // G, head kh * G + r % G."""
    rows = T * G
    n = -(-rows // QUERY_ROWS)
    return [range((n - 1 - x) * QUERY_ROWS, min((n - x) * QUERY_ROWS, rows))
            for x in range(n)]


def _check(kernel: str, q: torch.Tensor, cache: KVCache, layer,
           pos: torch.Tensor) -> int:
    """What K3, K4 and K8 take (`kernel` their launch-count name, for
    fp.check_heads); returns the cache's KV kind."""
    B, T, H, d = q.shape
    L, Bc, Kh, S, dc = cache.k.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA attention takes bf16 queries, not {q.dtype}")
    kind = fp.kv_kind([cache.k, cache.v], [cache.k_scale, cache.v_scale])
    if dc != d or Bc != B or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(cache.k.shape)}")
    fp.check_heads(kernel, d, H // Kh)
    if S % KEY_TILE or cache.v.shape != cache.k.shape:
        raise ValueError(f"cache length {S} is not a multiple of {KEY_TILE}")
    for t in (q, cache.k, cache.v):
        if not t.is_cuda or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("q and the cache must be contiguous on one CUDA "
                             "device, on 16-byte boundaries (vector loads)")
    for t, n in ((layer, 1), (pos, B)):
        if not (torch.is_tensor(t) and t.is_cuda and t.device == q.device
                and t.dtype == torch.int32 and t.numel() == n
                and t.is_contiguous()):
            raise ValueError("layer and pos must be int32 CUDA tensors of "
                             "1 and B elements")
    return kind


def flash_prefill_attention(q: torch.Tensor, cache: KVCache, layer,
                            pos: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention for T new tokens per row (tokens[:, 0] at
    pos[b]) against cache layer `layer`. Returns [B, T, H, d] in q.dtype."""
    if not q.is_cuda:
        return attention_ref(q, cache, layer, pos)
    kind = _check("flash_prefill", q, cache, layer, pos)
    if any(s is not None and s.data_ptr() % 16
           for s in (cache.k_scale, cache.v_scale)):
        raise ValueError("int8 cache scales must lie on 16-byte boundaries "
                         "(cp.async copies)")
    B, T, H, d = q.shape
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    out = torch.empty_like(q)
    err = _lib().flash_prefill(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        fp.ptr(cache.k_scale), fp.ptr(cache.v_scale), layer.data_ptr(),
        pos.data_ptr(), out.data_ptr(), kind, B, T, H, Kh, S, d,
        build.stream_ptr(q))
    build.check(err, "flash_prefill")
    fp.count(launches, "flash_prefill", kind)
    return out


def flash_decode_heads_attention(q: torch.Tensor, cache: KVCache, layer,
                                 pos: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention (q [B, 1, H, d] at pos[b]) over cache
    layer `layer`, the key walk split across blocks (decode_split).
    Returns [B, 1, H, d] in q.dtype."""
    if q.shape[1] != 1:
        raise ValueError("flash_decode_heads_attention is the T=1 decode path")
    if not q.is_cuda:
        return attention_ref(q, cache, layer, pos)
    kind = _check("flash_decode_heads", q, cache, layer, pos)
    B, _, H, d = q.shape
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    out = ds.launch("flash_decode_heads", q, cache.k, cache.v,
                    (cache.k_scale, cache.v_scale), (layer, pos), kind,
                    (B, H, Kh, S, d), S // KEY_TILE)
    fp.count(launches, "flash_decode_heads", kind)
    return out


def flash_staged_attention(q: torch.Tensor, st, layer,
                           pos: torch.Tensor) -> torch.Tensor:
    """K9: single-token GQA attention over the monolithic cache's rows
    below the chunk's base plus the staged tail up to slot pos - base
    (st: runtime.staging.StagedKVCache over a KVCache; the step's k/v
    already staged). Returns [B, 1, H, d] in q.dtype."""
    if q.shape[1] != 1:
        raise ValueError("flash_staged_attention is the T=1 decode path")
    if st.paged:
        raise TypeError("flash_staged_attention stages over a monolithic cache")
    if not q.is_cuda:
        return fp.staged_attention_ref(q, st, layer, pos)
    cache = st.pool
    B, _, H, d = q.shape
    if cache.k.shape[1] != B or st.sk.shape[1] != B:
        raise ValueError(f"{B} query rows against a cache of "
                         f"{cache.k.shape[1]} and a staged tail of "
                         f"{st.sk.shape[1]} rows")
    kind = fp.check_serving_inputs(
        "flash_staged", q,
        [(cache.k, KEY_TILE), (cache.v, KEY_TILE), (st.sk, 32), (st.sv, 32)],
        [cache.k_scale, cache.v_scale, st.sk_scale, st.sv_scale],
        {"layer": (layer, 1), "pos": (pos, B), "base": (st.base, B)})
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    Cs = st.sk.shape[3]
    out = ds.launch("flash_staged", q, cache.k, cache.v,
                    (cache.k_scale, cache.v_scale, st.sk_scale, st.sv_scale),
                    (layer, pos, st.base), kind, (B, H, Kh, S, Cs, d),
                    S // KEY_TILE + ds.tail_tiles(Cs), tail=(st.sk, st.sv))
    fp.count(launches, "flash_staged", kind)
    return out
