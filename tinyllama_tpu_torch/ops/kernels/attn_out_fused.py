"""Fused batch-1 decode attention + output projection + residual.

Replaces the kernel of ``_run_attn_out`` in
tinyllama_tpu/ops/pallas/attn_out_fused.py (K8, entry ``fused_attn_out``)
with a hand-written Hopper kernel (csrc/attn_out_fused.cu): the new
token's GQA attention over cache layer `layer` (keys 0..pos), then
residual + attn @ dequant(wo), in one launch.

Bound by the bytes of wo (q8, q4 or q4g) plus the visible keys and
values. The TPU kernel keeps the attention result in VMEM for the wo
steps of its sequential grid; the Hopper kernel computes the attention
once per launch, split over (kv head, 64-key tile) pairs across blocks,
merges the tiles after a grid-wide barrier into a 4 KB workspace, and
runs wo's strips after a second one (a cooperative launch). The
workspaces come from the wrapper.

The layer index and pos are device tensors. The cache is bf16, f16, f32,
or int8 with f32 scale planes (read at half the bytes a key, the scales
folded into scores and probabilities as the TPU kernel folds them; f16
and f32 values rounded to bf16 as they are staged). CUDA
tensors (bf16 q and residual, d_head 64, at most 8 query heads per kv
head) launch the kernel or raise; only CPU tensors go to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.kernels import build, flash_attention, qmatmul
from tinyllama_tpu_torch.ops.kernels.decode_fused import STRIP, check_like
from tinyllama_tpu_torch.ops.kernels.flash_paged import KV_SUFFIX, count, ptr
from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view

#: launches since the count was last set to 0; with a cache of another
#: kind than bf16 under "fused_attn_out_i8", "_f16" or "_f32".
launches = {"fused_attn_out" + sfx: 0 for sfx in KV_SUFFIX}

#: query heads per kv head the kernel takes at most (one warp each).
MAX_GROUP = 8
#: floats of one (kv head, key tile, query head) partial: max, sum, d.
PART = 2 + flash_attention.HEAD_DIM

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("attn_out_fused")
    if lib.fused_attn_out.argtypes is None:
        lib.fused_attn_out.argtypes = [_P] * 13 + [_I] * 6 + [_P]
        lib.fused_attn_out.restype = _I
    return lib


def fused_attn_out_ref(q, cache, layer, pos, residual, wo) -> torch.Tensor:
    """Plain version: the attention result cast to q.dtype (the kernels'
    compute dtype), then residual + attn @ dequant(wo) with the residual
    in the f32 sum, cast once to residual.dtype."""
    B, T, H, d = q.shape
    k, v = layer_cache_view(cache, qmatmul.layer_index(layer), q.dtype)
    attn = gqa_attention(q, k, v, pos.reshape(B, 1).long())
    D = residual.shape[-1]
    out = residual.reshape(1, D).float() + qmatmul.dot_ref(
        attn.reshape(1, H * d), wo, layer)
    return out.to(residual.dtype).reshape(residual.shape)


def fused_attn_out(q: torch.Tensor, cache: KVCache, layer: torch.Tensor,
                   pos: torch.Tensor, residual: torch.Tensor,
                   wo: QTensor) -> torch.Tensor:
    """residual + attention(q, cache layer `layer`, keys 0..pos) @
    dequant(wo[layer]) -> [1, 1, D] in residual.dtype. q [1, 1, H, d] is
    the one new token (its k/v already in the cache); batch 1 only."""
    B, T, H, d = q.shape
    if B != 1 or T != 1:
        raise ValueError("fused_attn_out is the batch-1 decode path (B = T = 1)")
    if not q.is_cuda:
        return fused_attn_out_ref(q, cache, layer, pos, residual, wo)
    kv_kind = flash_attention._check(q, cache, layer, pos)
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    if H // Kh > MAX_GROUP:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads "
                         f"per kv head, got {H // Kh}")
    D = residual.shape[-1]
    qmatmul.check_weight(wo, H * d, layer, q.device)
    N = wo.data.shape[-1]
    if N != D or N % STRIP:
        raise ValueError(f"wo must map {H * d} to the residual's {D} columns "
                         f"(a multiple of {STRIP}), got N={N}")
    check_like(residual, (1, 1, D), torch.bfloat16, q.device, "the residual")
    part = torch.empty(H * (S // flash_attention.KEY_TILE) * PART,
                       dtype=torch.float32, device=q.device)
    attn = torch.empty(H * d, dtype=torch.float32, device=q.device)
    out = torch.empty_like(residual)
    err = _lib().fused_attn_out(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        ptr(cache.k_scale), ptr(cache.v_scale), layer.data_ptr(),
        pos.data_ptr(), wo.data.data_ptr(), wo.scales.data_ptr(),
        residual.data_ptr(), part.data_ptr(), attn.data_ptr(), out.data_ptr(),
        qmatmul.KIND_CODE[wo.kind], kv_kind, H, Kh, S, N, build.stream_ptr(q))
    build.check(err, "fused_attn_out")
    count(launches, "fused_attn_out", kv_kind)
    return out
