"""Causal GQA attention of new tokens against layer `layer` of the stacked
KV cache ([L, B, Kh, S, d], the new k/v already written).

Replaces two kernels of tinyllama_tpu/ops/pallas/flash_prefill.py with
hand-written Hopper kernels (csrc/flash_attention.cu), which share the
online-softmax step of csrc/online_softmax.cuh (the counterpart of
softmax_update.online_update_batch):

* K3 ``flash_prefill`` for ``_flash_attn_kernel`` (T new tokens at
  ``pos``): bound by the tensor-core rate of the QK^T and PV products.
  One block per (row, kv head, 64 flattened (token, group) query rows),
  so a token's G query heads share every K/V tile; key tiles above the
  causal diagonal are neither loaded nor computed.
* K4 ``flash_decode_heads`` for ``_decode_heads_kernel`` (T = 1): bound
  by the bytes of the pos+1 cached keys and values. One block per
  (row, kv head), one warp per query head; the key walk stops at pos.
  At batch 1 that is Kh blocks on 132 SMs; a split-KV walk is later work.

The layer index and the positions are device tensors, read inside the
kernels. CUDA tensors (bf16 q and cache, d = 64) launch a kernel or
raise; only CPU tensors go to the plain version, ``gqa_attention`` over
the layer's cache.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view

#: launches of each kernel since the counts were last set to 0.
launches = {"flash_prefill": 0, "flash_decode_heads": 0}

#: head dim the kernels take.
HEAD_DIM = 64
#: keys per tile: the cache length must be a whole number of tiles.
KEY_TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_prefill.argtypes is None:
        lib.flash_prefill.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        lib.flash_decode_heads.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.flash_prefill.restype = lib.flash_decode_heads.restype = _I
    return lib


def attention_ref(q: torch.Tensor, cache: KVCache, layer,
                  pos: torch.Tensor) -> torch.Tensor:
    """Plain version of both kernels, any device: q [B, T, H, d] at
    absolute positions pos[b] + t against cache layer `layer`."""
    li = int(layer.reshape(-1)[0]) if torch.is_tensor(layer) else int(layer)
    B, T = q.shape[:2]
    q_positions = (pos.reshape(B, 1).long()
                   + torch.arange(T, device=q.device)[None, :])
    k, v = layer_cache_view(cache, li, q.dtype)
    return gqa_attention(q, k, v, q_positions)


def _check(q: torch.Tensor, cache: KVCache, layer, pos: torch.Tensor) -> None:
    B, T, H, d = q.shape
    L, Bc, Kh, S, dc = cache.k.shape
    if q.dtype != torch.bfloat16 or cache.k.dtype != torch.bfloat16 \
            or cache.v.dtype != torch.bfloat16:
        raise TypeError("the CUDA attention takes bf16 queries and a bf16 cache")
    if d != HEAD_DIM or dc != d or Bc != B or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(cache.k.shape)} (d must be {HEAD_DIM})")
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


def flash_prefill_attention(q: torch.Tensor, cache: KVCache, layer,
                            pos: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention for T new tokens per row (tokens[:, 0] at
    pos[b]) against cache layer `layer`. Returns [B, T, H, d] in q.dtype."""
    if not q.is_cuda:
        return attention_ref(q, cache, layer, pos)
    _check(q, cache, layer, pos)
    B, T, H, d = q.shape
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    out = torch.empty_like(q)
    err = _lib().flash_prefill(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        layer.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, T, H, Kh, S, d, build.stream_ptr(q))
    build.check(err, "flash_prefill")
    launches["flash_prefill"] += 1
    return out


def flash_decode_heads_attention(q: torch.Tensor, cache: KVCache, layer,
                                 pos: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention (q [B, 1, H, d] at pos[b]) over cache
    layer `layer`, all query heads of a kv head in one block. Returns
    [B, 1, H, d] in q.dtype."""
    if q.shape[1] != 1:
        raise ValueError("flash_decode_heads_attention is the T=1 decode path")
    if not q.is_cuda:
        return attention_ref(q, cache, layer, pos)
    _check(q, cache, layer, pos)
    B, _, H, d = q.shape
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    if H // Kh not in (4, 8):
        raise ValueError(f"the decode kernel takes 4 or 8 query heads per "
                         f"kv head, got {H // Kh}")
    out = torch.empty_like(q)
    err = _lib().flash_decode_heads(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        layer.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, H, Kh, S, d, build.stream_ptr(q))
    build.check(err, "flash_decode_heads")
    launches["flash_decode_heads"] += 1
    return out
