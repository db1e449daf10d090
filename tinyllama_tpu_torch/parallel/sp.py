"""Sequence-parallel prefill (context parallelism): one prompt's T
dimension sharded over the mesh's data group, then its K/V handed off
into the ordinary decode cache. The port's counterpart of the JAX
package's parallel/sp.py.

Data rank i runs the whole model over its slice of Tl = T / sp rows:
the embedding, the norms, the four linears, rope and SwiGLU need no
collective; attention is the ring (parallel/ring.py). The linears run on
the activation dtype without aq8, as JAX's (``use_pallas=False``): on the
card ``ops/linear.py:linear`` launches K2 at Tl > 8 rows and K1 at Tl = 8.
Under sp x tp (``tp``, a parallel/tp.py ``TpGroup``) the rank runs its
local heads and ffn slice, and the products of wo and w_down are summed
over the model group, as in ``models/llama.py``'s unfused block.

The prompt is padded to a multiple of sp * 8 rows. Pad rows lie after
every prompt row, so no prompt row attends them. The last prompt row's
hidden state lives on one data rank, which broadcasts it over the data
group; every rank then runs the lm_head (K1, with the policy's aq8) on
the same row, so the logits are bit-equal across ranks. (JAX replicates
every rank's last row with a masked psum and indexes it; when the prompt
fills its shards exactly that index picks the wrong rows: ROADMAP,
reference fault 10.)

The handoff all-gathers each layer's K/V along T over the data group as
soon as the layer's attention has used them, and writes them into the
rank's own cache (monolithic or paged; int8 quantized on the way by the
cache's writer), so one layer's gathered K/V is held at a time: every
rank holds the whole prompt's K/V and decodes, as JAX's decode
replicates over the data axis.
Only the first min(T, S) rows are written, S the cache's positions: JAX
writes all T and fails where T passes S (ROADMAP, reference fault 9);
rows at len(prompt) and past it are never read. In a page pool, pad rows
past the prompt's mapped pages fall on scratch page 0 through the
table's unmapped entries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.linear import embedding_lookup, linear
from tinyllama_tpu_torch.ops.norms import rms_norm
from tinyllama_tpu_torch.ops.rope import apply_rope_gathered, gather_rope
from tinyllama_tpu_torch.parallel.ring import ring_gqa_attention
from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime.kvcache import update_cache_at_layer
from tinyllama_tpu_torch.runtime.paged import PagedKVCache, update_paged_at_layer

#: the prompt is padded to a multiple of sp * ROW_MULTIPLE rows
ROW_MULTIPLE = 8


def padded_length(n: int, sp: int) -> int:
    """The padded prompt length T of an n-token prompt over sp ranks."""
    unit = sp * ROW_MULTIPLE
    return -(-n // unit) * unit


def seq_parallel_prefill(cfg: ModelConfig, policy: DtypePolicy,
                         params: llama.Params, tokens: torch.Tensor,
                         rope_rows: tuple[torch.Tensor, torch.Tensor], mesh,
                         layer_ids: torch.Tensor, hand_off, tp=None):
    """The model over this data rank's rows: tokens [1, Tl] of global
    positions [dp_rank * Tl, (dp_rank + 1) * Tl), rope_rows their (cos,
    sin) [1, Tl, d / 2]. `cfg` is the rank's config (its local heads
    under tp). Each layer's roped keys and values [1, Tl, Kh, d] go to
    hand_off(li, k, v) once its attention has run. Returns hidden [1, Tl,
    D] after the final norm, in the activation dtype."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    lp = params["layers"]
    dense = not isinstance(lp["wqkv"], QTensor)
    cos, sin = rope_rows
    Tl = tokens.shape[1]

    def lin(h, name, li):
        return linear(h, lp[name], li if dense else layer_ids[li:li + 1])

    def row_lin(h, name, li):
        if tp is None:
            return lin(h, name, li)
        return tp.row_linear(h, lp[name], li, layer_ids)

    x = embedding_lookup(tokens, params["embed"], llama.act_dtype(policy))
    for li in range(cfg.n_layers):
        qkv = lin(rms_norm(x, lp["attn_norm"][li], eps, inside), "wqkv", li)
        q = apply_rope_gathered(qkv[..., : H * d].reshape(1, Tl, H, d),
                                cos, sin)
        k = apply_rope_gathered(
            qkv[..., H * d: (H + Kh) * d].reshape(1, Tl, Kh, d), cos, sin)
        v = qkv[..., (H + Kh) * d:].reshape(1, Tl, Kh, d)
        attn = ring_gqa_attention(q, k, v, mesh)
        hand_off(li, k, v)
        x = x + row_lin(attn.reshape(1, Tl, H * d), "wo", li)
        gate_up = lin(rms_norm(x, lp["ffn_norm"][li], eps, inside),
                      "w_gateup", li)
        gate, up = gate_up[..., : cfg.n_ffn], gate_up[..., cfg.n_ffn:]
        x = x + row_lin(F.silu(gate.float()).to(x.dtype) * up, "w_down", li)
    return rms_norm(x, params["norm"], eps, inside)


def sp_prefill_into_cache(cfg: ModelConfig, policy: DtypePolicy,
                          params: llama.Params, prompt: list[int],
                          rope_tables: tuple[torch.Tensor, torch.Tensor],
                          mesh, cache, layer_ids: torch.Tensor,
                          tp=None) -> torch.Tensor:
    """Prefill one prompt over the mesh's data group and hand its K/V off
    into `cache` (B == 1: a KVCache, or a PagedKVCache whose table row
    maps the prompt's pages), in place. Returns the last prompt token's
    logits [1, V] f32, the same bits on every rank. Every rank of the
    mesh calls it with the same prompt."""
    sp, r = mesh.dp, mesh.dp_rank
    n = len(prompt)
    T = padded_length(n, sp)
    Tl = T // sp
    device = layer_ids.device
    toks = torch.tensor([(prompt + [0] * (T - n))[r * Tl:(r + 1) * Tl]],
                        dtype=torch.long, device=device)
    cos, sin = rope_tables
    # pad rows past the table read its last row, as JAX's clamped gather
    positions = torch.arange(r * Tl, (r + 1) * Tl, device=device)
    rope_rows = gather_rope(positions.clamp(max=cos.shape[0] - 1)[None],
                            cos, sin)
    rows = min(T, cache.max_ctx)
    write = (update_paged_at_layer if isinstance(cache, PagedKVCache)
             else update_cache_at_layer)
    pos0 = torch.zeros(1, dtype=torch.int32, device=device)

    def hand_off(li, k, v):
        kv = mesh.data_all_gather(torch.stack((k, v)), 2)  # [2, 1, T, Kh, d]
        write(cache, li, kv[0, :, :rows], kv[1, :, :rows], pos0)

    hidden = seq_parallel_prefill(cfg, policy, params, toks, rope_rows, mesh,
                                  layer_ids, hand_off, tp)

    # the owner's row crosses as f32 (exact; JAX replicates it in f32)
    owner, row = divmod(n - 1, Tl)
    h_last = mesh.data_broadcast(hidden[:, row].float(), owner)
    return llama.lm_head_logits(params, h_last.to(hidden.dtype), policy.aq8)
