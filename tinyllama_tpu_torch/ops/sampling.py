"""Token samplers: greedy argmax and temperature + top-k.

Both run on the logits' device and return a device tensor, so a decode
loop samples without a host round-trip. Top-k draws from an explicit
``torch.Generator``; its numbers differ from JAX's PRNG for the same seed.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis (first maximum on ties, as jnp.argmax).
    logits [B, V] -> [B] int32."""
    return logits.argmax(dim=-1).to(torch.int32)


def sample_top_k(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator,
    temperature: float,
    top_k: int,
) -> torch.Tensor:
    """Temperature + top-k sampling, [B] int32. Ordering by logits/temp
    equals ordering by logits (temp > 0), so the top-k selection may come
    before the temperature divide."""
    vals, idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(vals.float() / temperature, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return idx.gather(-1, choice)[:, 0].to(torch.int32)
