"""Token samplers: greedy argmax and temperature + top-k.

Both run on the logits' device and return a device tensor, so a decode
loop samples without a host round-trip. Top-k draws from an explicit
``torch.Generator``; its numbers differ from JAX's PRNG for the same seed.
Its draw is ``torch.multinomial``'s one-sample path written out (an
exponential variate a candidate, the least variate / probability), the
same numbers from the same generator state, without multinomial's check
of the probabilities, so that a CUDA graph of the decode chunk
(runtime/graphs.py) captures the draw whatever form that check takes.
Over a batch group (rows sharded over the mesh's dcn x data ranks), each
rank draws the whole batch's variates and keeps its own rows: every row
gets noise of its own, and the rows get the single-device draw.
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
    rank: int = 0,
    group: int = 1,
) -> torch.Tensor:
    """Temperature + top-k sampling, [B] int32. Ordering by logits/temp
    equals ordering by logits (temp > 0), so the top-k selection may come
    before the temperature divide. With group > 1, `logits` holds rows
    [rank * B, (rank + 1) * B) of a batch of group * B: the variates of
    all its rows are drawn, and those rows' kept."""
    vals, idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(vals.float() / temperature, dim=-1)
    B = probs.shape[0]
    q = probs.new_empty((group * B, top_k)).exponential_(1, generator=generator)
    choice = q[rank * B:(rank + 1) * B].div_(probs).argmin(dim=-1, keepdim=True)
    return idx.gather(-1, choice)[:, 0].to(torch.int32)
