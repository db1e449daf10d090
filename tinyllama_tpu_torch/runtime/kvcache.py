"""Explicit fixed-shape KV cache.

The cache is one tensor per plane of shape [n_layers, B, n_kv_heads,
max_ctx, d_head]: head-major, so one (layer, row, head)'s history is a
contiguous S x d slab that the attention kernels read in straight runs.
Unlike the JAX package's immutable carry, the port writes new positions
IN PLACE (``update_cache_at_layer`` mutates the tensors it is given), at
positions taken from a device tensor, so a decode step never reads a
position back to the host.

Storage is f32, bf16 or f16; the int8 cache with per-(head, pos) scales
is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinyllama_tpu_torch.config import ModelConfig

KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@dataclass(frozen=True)
class KVCache:
    """k/v: [L, B, Kh, S, d] in the storage dtype."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_ctx(self) -> int:
        return self.k.shape[3]


def init_cache(cfg: ModelConfig, batch: int, kv_dtype: str = "bf16",
               max_ctx: int | None = None, device="cpu") -> KVCache:
    if kv_dtype not in KV_DTYPES:
        raise NotImplementedError(
            f"KV dtype {kv_dtype!r} is not ported yet (ROADMAP.md, Queue 1)")
    S = max_ctx or cfg.max_ctx
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.d_head)
    dt = KV_DTYPES[kv_dtype]
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def update_cache_at_layer(
    cache: KVCache,
    li: int,
    k_new: torch.Tensor,  # [B, T, Kh, d] activation dtype
    v_new: torch.Tensor,
    pos: torch.Tensor,  # [B] int32 device tensor: write offsets
) -> KVCache:
    """Write T new positions of every row into layer `li`, in place, at
    pos[b] .. pos[b] + T - 1. Returns the same cache."""
    B, T = k_new.shape[:2]
    idx = pos.long()[:, None] + torch.arange(T, device=pos.device)[None, :]
    for plane, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new.transpose(1, 2).to(plane.dtype)  # [B, Kh, T, d]
        for b in range(B):
            plane[li, b].index_copy_(1, idx[b], new[b])
    return cache


def layer_cache_view(cache: KVCache, li: int,
                     dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer li's cache as `dtype`: (k, v) each [B, Kh, S, d]."""
    return cache.k[li].to(dtype), cache.v[li].to(dtype)
