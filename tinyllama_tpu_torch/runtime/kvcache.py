"""Explicit fixed-shape KV cache.

The cache is one tensor per plane of shape [n_layers, B, n_kv_heads,
max_ctx, d_head]: head-major, so one (layer, row, head)'s history is a
contiguous S x d slab that the attention kernels read in straight runs.
Unlike the JAX package's immutable carry, the port writes new positions
IN PLACE (``update_cache_at_layer`` mutates the tensors it is given), at
positions taken from a device tensor, so a decode step never reads a
position back to the host.

Storage is f32, bf16, f16 or int8 (kv_dtype "i8"): int8 values with one
f32 scale a (layer, row, kv head, position), absmax / 127 over the head
dim, in ``k_scale`` / ``v_scale`` planes [L, B, Kh, S]. A TinyLlama token
then costs 11,264 bytes of data and 704 of scales instead of 22,528 in
bf16. ``quantize_kv`` is the port's copy of the JAX package's
``_quantize_kv``, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinyllama_tpu_torch.config import ModelConfig

KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
             "i8": torch.int8}


@dataclass(frozen=True)
class KVCache:
    """k/v: [L, B, Kh, S, d] in the storage dtype; k_scale/v_scale: [L, B,
    Kh, S] f32 iff the storage is int8."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def max_ctx(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def kv_planes(cache) -> list[torch.Tensor]:
    """Every plane of a monolithic or paged cache: k, v and, int8, the
    two scale planes (same leading dims as the data, less d)."""
    planes = [cache.k, cache.v]
    if cache.quantized:
        planes += [cache.k_scale, cache.v_scale]
    return planes


def scale_planes(shape, kv_dtype: str, device):
    """Zeroed (k_scale, v_scale) for int8 planes of `shape`, else (None,
    None)."""
    if kv_dtype != "i8":
        return None, None
    return (torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def init_cache(cfg: ModelConfig, batch: int, kv_dtype: str = "bf16",
               max_ctx: int | None = None, device="cpu") -> KVCache:
    S = max_ctx or cfg.max_ctx
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.d_head)
    dt = KV_DTYPES[kv_dtype]
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device),
                   *scale_planes(shape, kv_dtype, device))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 quantization along the last dim: (q int8, scale f32 over the
    leading dims), scale = absmax / 127, q = round(x * (1 / scale)) half
    to even (0 where the row is all zero). Bit-equal to the JAX package's
    ``_quantize_kv``: the division, then a multiply by the reciprocal."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(scale > 0, 1.0 / scale, 0.0)  # 1 / 0 is never taken
    return torch.round(xf * inv[..., None]).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor | None,
                  dtype) -> torch.Tensor:
    """q * scale in f32, then cast to `dtype` (a plain cast when scale is
    None)."""
    if scale is None:
        return q.to(dtype)
    return (q.float() * scale[..., None]).to(dtype)


def update_cache_at_layer(
    cache: KVCache,
    li: int,
    k_new: torch.Tensor,  # [B, T, Kh, d] activation dtype
    v_new: torch.Tensor,
    pos: torch.Tensor,  # [B] int32 device tensor: write offsets
) -> KVCache:
    """Write T new positions of every row into layer `li`, in place, at
    pos[b] .. pos[b] + T - 1 (int8: quantized, data and scales). Returns
    the same cache."""
    B, T = k_new.shape[:2]
    idx = pos.long()[:, None] + torch.arange(T, device=pos.device)[None, :]
    new = [k_new.transpose(1, 2), v_new.transpose(1, 2)]  # [B, Kh, T, d]
    if cache.quantized:
        (kq, ks), (vq, vs) = quantize_kv(new[0]), quantize_kv(new[1])
        new = [kq, vq, ks, vs]
    for plane, n in zip(kv_planes(cache), new):
        n = n.to(plane.dtype)
        for b in range(B):
            plane[li, b].index_copy_(1, idx[b], n[b])
    return cache


def layer_cache_view(cache: KVCache, li: int,
                     dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer li's cache as `dtype` (int8 dequantized in f32 first): (k,
    v) each [B, Kh, S, d]."""
    ks, vs = ((cache.k_scale[li], cache.v_scale[li]) if cache.quantized
              else (None, None))
    return (dequantize_kv(cache.k[li], ks, dtype),
            dequantize_kv(cache.v[li], vs, dtype))
