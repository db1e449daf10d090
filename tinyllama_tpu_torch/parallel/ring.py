"""Ring attention: causal GQA over a prompt whose T dimension is sharded
over the mesh's data group. The port's counterpart of the JAX package's
parallel/ring.py.

Data rank i holds the queries, keys and values of global positions
[i * Tl, (i + 1) * Tl). Each hop merges the K/V block it holds into a
flash online-softmax state (running max m, normalizer l, weighted-V
accumulator, all f32), then passes the block to data rank i + 1 and takes
rank i - 1's (``Mesh.data_ring_shift``, the JAX ppermute's direction), so
after n - 1 hops every rank has seen every earlier block. A block from a
later shard is invisible to every query here and its merge is skipped (a
host branch on the rank: half the ring's products); a block from an
earlier shard is visible to every query and is merged without a mask;
only the rank's own block takes the causal mask.

The merge (``_block_update``) is PyTorch on the card: the JAX package
computes it in XLA, outside any Pallas kernel. Scores are f32 products
of the inputs (bf16 products are exact in f32, accumulated in f32), the
probabilities are cast to v's dtype before the PV product, as JAX's. The
query rows are merged in slices of at most ``SCORE_BYTES`` of scores, so
a long prompt's [rows, Tl, Tl] scores never stand whole on the card.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.ops.precision import exact_f32

#: most bytes of f32 scores one slice of _block_update holds (its
#: temporaries are a few times this)
SCORE_BYTES = 256 * 2**20


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [R, M, K] @ b [R, K, N] with exact products and f32 accumulation,
    in f32: bf16 operands on the card's tensor cores with an f32 result,
    anything else upcast to f32 (TF32 off)."""
    with exact_f32():
        if a.is_cuda and a.dtype == torch.bfloat16 == b.dtype:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())


def _block_update(q, k, v, mask, m, l, acc, scale):
    """One online-softmax step over a visiting K/V block, in place.

    q [R, Tq, d]; k, v [R, Tk, d]; mask [Tq, Tk] bool, or None where every
    key is visible; m, l [R, Tq, 1] and acc [R, Tq, d] f32, updated in
    place. Fully masked rows keep m = -inf (the -inf guards are JAX's).
    The masked probabilities are exp(-inf) = 0 already, so JAX's second
    where is not needed."""
    scores = _bmm_f32(q, k.transpose(1, 2)) * scale
    if mask is not None:
        scores.masked_fill_(~mask, float("-inf"))
    m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                  float("-inf")))
    p = torch.exp(scores.sub_(m_safe))
    l.mul_(alpha).add_(p.sum(-1, keepdim=True))
    acc.mul_(alpha).add_(_bmm_f32(p.to(v.dtype), v))
    m.copy_(m_new)


def _merge(q, k, v, mask, m, l, acc, scale) -> None:
    """_block_update over slices of q's rows, each holding at most
    SCORE_BYTES of scores."""
    R, Tq, _ = q.shape
    step = max(1, SCORE_BYTES // (4 * R * k.shape[1]))
    for a in range(0, Tq, step):
        s = slice(a, a + step)
        _block_update(q[:, s], k, v, None if mask is None else mask[s],
                      m[:, s], l[:, s], acc[:, s], scale)


def ring_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh) -> torch.Tensor:
    """Causal GQA attention of this data rank's T slice: q [B, Tl, H, d],
    k, v [B, Tl, Kh, d] of global positions [dp_rank * Tl, (dp_rank + 1)
    * Tl). Returns [B, Tl, H, d] in q's dtype; a row that saw no key
    (l = 0) is divided by 1. Every rank of the data group calls it
    together (the n - 1 hops are collectives)."""
    B, Tl, H, d = q.shape
    Kh = k.shape[2]
    G = H // Kh
    n, idx = mesh.dp, mesh.dp_rank
    scale = 1.0 / (d ** 0.5)
    # a kv head's G query heads stacked on the query axis: [B * Kh, G * Tl,
    # d] against [B * Kh, Tl, d], JAX's kv-head repeat without the copy
    qr = q.permute(0, 2, 1, 3).reshape(B * Kh, G * Tl, d)
    # k and v travel as one block: one hop a step
    block = torch.stack([k.permute(0, 2, 1, 3).reshape(B * Kh, Tl, d),
                         v.permute(0, 2, 1, 3).reshape(B * Kh, Tl, d)])
    m = torch.full((B * Kh, G * Tl, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B * Kh, G * Tl, d), device=q.device)
    pos = torch.arange(Tl, device=q.device)
    causal = (pos[None, :] <= pos[:, None]).repeat(G, 1)  # [G * Tl, Tl]
    for step in range(n):
        src = (idx - step) % n  # the data rank whose block this hop holds
        if src <= idx:  # a later shard's block is invisible here
            _merge(qr, block[0], block[1], causal if src == idx else None,
                   m, l, acc, scale)
        if step < n - 1:  # the n-th hop's block would go unused
            block = mesh.data_ring_shift(block)
    out = acc / torch.where(l > 0.0, l, 1.0)
    return out.reshape(B, Kh * G, Tl, d).permute(0, 2, 1, 3).to(q.dtype)
