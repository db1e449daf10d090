"""Grouped-query causal attention over a fixed-shape KV cache, in plain
PyTorch.

The plain version of both attention kernels (ops/kernels/
flash_attention.py) and so the model's attention on CPU tensors. Head h
uses kv head h // (H/Kh), expressed as a [B, T, Kh, G, d] reshape; scores
are scaled by 1/sqrt(d_head), keys at cache position s are visible to a
query at absolute position p iff s <= p, and the softmax runs in f32.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.ops.precision import exact_f32

NEG_INF = torch.finfo(torch.float32).min


def gqa_attention(
    q: torch.Tensor,  # [B, T, H, d]
    k: torch.Tensor,  # [B, Kh, S, d]
    v: torch.Tensor,  # [B, Kh, S, d]
    q_positions: torch.Tensor,  # [B, T] absolute positions of the queries
) -> torch.Tensor:
    """Causal GQA attention of new queries against the whole cache.
    Returns [B, T, H, d] in q.dtype.

    Products run on f32 copies of the operands (bf16 values are exact in
    f32) with TF32 off. At bf16 the normalized probabilities round to
    bf16 before the weighted sum of V, as the kernels feed bf16 to their
    second product."""
    B, T, H, d = q.shape
    Kh, S = k.shape[1], k.shape[2]
    G = H // Kh
    low = q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
    qf = q.reshape(B, T, Kh, G, d).float()
    with exact_f32():
        scores = torch.einsum("btkgd,bksd->bktgs", qf, k.float())
        scores = scores * (1.0 / d ** 0.5)
        key_pos = torch.arange(S, device=q.device)
        visible = key_pos[None, None, :] <= q_positions[:, :, None].long()
        scores = torch.where(visible[:, None, :, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        p = p / p.sum(dim=-1, keepdim=True)
        if low:
            p = p.to(torch.bfloat16).float()
        out = torch.einsum("bktgs,bksd->btkgd", p, v.float())
    return out.reshape(B, T, H, d).to(q.dtype)
