"""Fused batch-1 decode attention + output projection + residual.

Replaces the kernel of ``_run_attn_out`` in
tinyllama_tpu/ops/pallas/attn_out_fused.py (K8, entry ``fused_attn_out``)
with hand-written Hopper kernels (csrc/attn_out_fused.cu): the new
token's GQA attention over cache layer `layer` (keys 0..pos), then
residual + attn @ dequant(wo), two launches from one C call, at head
dim d = 32, 64 or 128 and 1 to 8 query heads a kv head
(``flash_paged.check_heads``).

Bound by the bytes of wo (q8, q4 or q4g) plus the visible keys and
values. The TPU kernel keeps the attention result in VMEM for the wo
steps of its sequential grid. On Hopper the attention is K4's split-key
template (csrc/decode_split.cuh; its split count
``decode_split.decode_splits``), which writes each head's result as bf16
to a [H * d] workspace, and wo is K6's walk (csrc/fused_walk.cuh; its
plan ``fused_plan.fused_plan`` with the card's residency of the launch),
launched as a programmatic dependent launch whose blocks stream their
share of wo while the attention runs and read the workspace once it is
done. ``plan`` gives both from host sizes only, so a captured decode step
replays at any layer and position. The workspaces come from the wrapper.

The layer index and pos are device tensors. The cache is bf16, f16, f32,
or int8 with f32 scale planes (read at half the bytes a key, each key
and value times its scale rounded to bf16 as a tile lands, as the plain
version dequantizes; f16 and f32 values rounded to bf16). CUDA tensors
(bf16 q and residual) launch the kernels or raise; only CPU tensors go
to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.kernels import (
    build, decode_split, flash_attention, fused_plan, qmatmul,
)
from tinyllama_tpu_torch.ops.kernels.decode_fused import STRIP, check_like
from tinyllama_tpu_torch.ops.kernels.flash_paged import KV_SUFFIX, count, ptr
from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view

#: launches since the count was last set to 0 (one a call, for its two
#: kernels); with a cache of another kind than bf16 under
#: "fused_attn_out_i8", "_f16" or "_f32".
launches = {"fused_attn_out" + sfx: 0 for sfx in KV_SUFFIX}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("attn_out_fused")
    if lib.fused_attn_out.argtypes is None:
        lib.fused_attn_out.argtypes = [_P] * 13 + [_I] * 10 + [_P]
        lib.fused_attn_out.restype = _I
        lib.fused_attn_out_resident.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
        lib.fused_attn_out_resident.restype = _I
    return lib


def plan(Kh: int, S: int, K: int, N: int, n_sm: int,
         resident=None) -> tuple[int, int, int]:
    """(n_split, width, splits) of a call: the attention's split count
    (``decode_split.decode_splits`` at B = 1 over the cache's S / 64
    tiles) and the wo walk's tile width and K splits for K = H * d rows
    to N columns by K1's rule at M = 1, whose product it is
    (``fused_plan.fused_plan`` with K1's slice length, so K may reach
    49,152 rows, and its slack of n_sm / 32 SMs: 128 columns x 8 splits
    at TinyLlama's 2048 x 2048, where the rule of K6 takes 64 x 4, 1-3%
    slower on the card, PERF.md; `resident(width, splits)` the card's
    count of the launch's resident clusters). Host sizes only: a tensor
    raises."""
    return (decode_split.decode_splits(1, Kh, S // flash_attention.KEY_TILE, n_sm),
            *fused_plan.fused_plan(K, N, n_sm, resident,
                                   fused_plan.SMALLM_SPLIT_STEPS, n_sm // 32))


@functools.lru_cache(maxsize=None)
def card_plan(kind: int, Kh: int, S: int, K: int, N: int,
              n_sm: int) -> tuple[int, int, int]:
    """``plan`` with the current card's residency of the wo launch of
    kind code `kind`."""
    def resident(width, splits):
        n = ctypes.c_int(0)
        build.check(_lib().fused_attn_out_resident(kind, K, width, splits,
                                                   ctypes.byref(n)),
                    "fused_attn_out_resident")
        return n.value
    return plan(Kh, S, K, N, n_sm, resident)


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
    kv_kind = flash_attention._check("fused_attn_out", q, cache, layer, pos)
    if any(s is not None and s.data_ptr() % 16
           for s in (cache.k_scale, cache.v_scale)):
        raise ValueError("int8 cache scales must lie on 16-byte boundaries "
                         "(cp.async copies)")
    Kh, S = cache.k.shape[2], cache.k.shape[3]
    D = residual.shape[-1]
    qmatmul.check_weight(wo, H * d, layer, q.device)
    N = wo.data.shape[-1]
    if N != D or N % STRIP:
        raise ValueError(f"wo must map {H * d} to the residual's {D} columns "
                         f"(a multiple of {STRIP}), got N={N}")
    check_like(residual, (1, 1, D), torch.bfloat16, q.device, "the residual")
    code = qmatmul.KIND_CODE[wo.kind]
    n_split, width, splits = card_plan(code, Kh, S, H * d, N,
                                       qmatmul.sm_count(q.device))
    ws = torch.empty((H, n_split, decode_split.partial_floats(d)),
                     dtype=torch.float32, device=q.device)
    attn = torch.empty(H * d, dtype=torch.bfloat16, device=q.device)
    out = torch.empty_like(residual)
    err = _lib().fused_attn_out(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        ptr(cache.k_scale), ptr(cache.v_scale), layer.data_ptr(),
        pos.data_ptr(), wo.data.data_ptr(), wo.scales.data_ptr(),
        residual.data_ptr(), ws.data_ptr(), attn.data_ptr(), out.data_ptr(),
        code, kv_kind, H, Kh, S, N, d, n_split, width, splits,
        build.stream_ptr(q))
    build.check(err, "fused_attn_out")
    count(launches, "fused_attn_out", kv_kind)
    return out
