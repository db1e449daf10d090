"""Llama-family forward pass in PyTorch.

The same model as the JAX package's models/llama.py (embedding ->
n_layers x [pre-norm GQA attention + SwiGLU FFN, with residuals] ->
RMSNorm -> lm_head), with its parameter layout: per-layer weights stacked
on a leading layer axis, q/k/v fused into one ``wqkv`` and gate/up into
one ``w_gateup`` along d_out. The forward is a Python loop over layers
that hands each kernel the stacked weight and a device layer index.

Each block picks its branch as the JAX ``_block`` does, from shapes and
weight types only:

* fused (``decode_fused_eligible``: M = B * T <= 32, n_embd <= 2048):
  ``fused_norm_qkv`` (K5), rope, the in-place cache write, then at
  B = T = 1 ``fused_attn_out`` (K8: attention + wo + residual), else
  flash attention (K4 at T = 1, K3 otherwise) and ``fused_out_residual``
  (K6); then ``ffn_fused_normed`` (K7). This is b1 decode, the prefill of
  a prompt of at most 32 tokens, and a decode step of up to 32 rows;
* unfused (M > 32, a long prompt's prefill): rms_norm, ``linear`` of
  wqkv (K2), rope, the cache write, ``flash_prefill_attention`` (K3),
  ``x + linear(attn, wo)``, rms_norm, ``linear`` of w_gateup, SwiGLU
  and ``x + linear(inner, w_down)``.

The cache's kind picks the attention, as in the JAX ``_block``: a
staged decode chunk (runtime/staging.py) writes the step's K/V into its
tail and attends with K9 (monolithic pool) or K11 (page pool); a page
pool (runtime/paged.py) takes K10 at T = 1, and at T > 1 a prefill from
position 0, which attends only its own keys, so K3 reads them from a
one-layer temporary cache; the monolithic cache keeps the branches
above. An int8 cache (kv_dtype "i8") takes the same branches: the
writes quantize, and each attention kernel runs its int8 instantiation.

Norm weights reach the fused kernels as the stacked [L, D] table with
the device layer index. The lm_head (K1) runs outside ``forward``, on the
rows the caller picks. Quantized weights are q8, q4 or q4g (every kernel
takes each kind). Dense weights (the f16, bf16 and f32 policies) take no
kernel at all, as the JAX package runs them with ``use_pallas=False``:
every block is unfused, each linear a plain f32-accumulated product of
the layer's slice (ops/linear.py), and the attention on every cache kind
is ``gqa_attention`` over the layer's keys gathered into a dense view
(``_attend_plain``). The choice follows the weights' type alone, as the
fused branch's does. With aq8 activations (the
q8a8 and q4a8 policies; q8 and q4 weights) every block takes the
unfused branch, as the JAX rule dictates: each ``linear`` and the
lm_head run K1's int8-activation branch at M <= 8 (K2 as it is above),
and the FFN is two ``linear`` calls, never ``ffn_fused``.

Under tensor parallelism (``forward(..., tp=)``, parallel/tp.py) a rank
runs this model at its local config over its shard: every block takes
the unfused branch (as JAX's), wqkv and w_gateup give the rank's heads
and ffn slice, and the products of wo and w_down are summed over the
model group before their residuals, so every rank holds the same
activations after each block.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig
from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.kernels.attn_out_fused import fused_attn_out
from tinyllama_tpu_torch.ops.kernels.decode_fused import (
    decode_fused_eligible,
    fused_norm_qkv,
    fused_out_residual,
)
from tinyllama_tpu_torch.ops.kernels.ffn_fused import (
    ffn_fused,
    ffn_fused_eligible,
    ffn_fused_normed,
)
from tinyllama_tpu_torch.ops.kernels.flash_attention import (
    KEY_TILE,
    flash_decode_heads_attention,
    flash_prefill_attention,
    flash_staged_attention,
)
from tinyllama_tpu_torch.ops.kernels.flash_paged import (
    flash_paged_attention,
    flash_paged_staged_attention,
)
from tinyllama_tpu_torch.ops.linear import (
    embedding_lookup,
    linear,
    linear_f32_out,
)
from tinyllama_tpu_torch.ops.norms import rms_norm
from tinyllama_tpu_torch.ops.rope import apply_rope_gathered, gather_rope, rope_table
from tinyllama_tpu_torch.quant.codec import QTensor, quantize, stack
from tinyllama_tpu_torch.runtime.kvcache import (
    KVCache,
    layer_cache_view,
    quantize_kv,
    update_cache_at_layer,
)
from tinyllama_tpu_torch.runtime.paged import (
    PagedKVCache,
    paged_layer_view,
    update_paged_at_layer,
)
from tinyllama_tpu_torch.runtime.staging import (
    StagedKVCache,
    staged_layer_view,
    update_staged_at_layer,
)

Params = dict[str, Any]

#: the float dtypes of the policies' activations and dense weights
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}

#: per-layer linear weights and their [d_out, d_in] shapes: rows
#: [q | k | v] and [gate | up] fused along d_out (block quantization is
#: per row, so quantize(concat) == concat(quantize)).
LAYER_LINEARS = {
    "wqkv": lambda c: (c.n_embd + 2 * c.kv_dim, c.n_embd),
    "wo": lambda c: (c.n_embd, c.n_embd),
    "w_gateup": lambda c: (2 * c.n_ffn, c.n_embd),
    "w_down": lambda c: (c.n_embd, c.n_ffn),
}


def act_dtype(policy: DtypePolicy) -> torch.dtype:
    return DTYPES[policy.adtype]


def check_policy(policy: DtypePolicy) -> None:
    """q4g has no aq8 branch (the JAX kernel asserts so)."""
    if policy.aq8 and policy.wdtype == "q4g":
        raise ValueError("q4g has no aq8 variant")


# ----------------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------------


def init_dense_params(cfg: ModelConfig, generator: torch.Generator,
                      device="cpu", store=None) -> Params:
    """Random dense f32 parameters, N(0, 0.02), [L, d_out, d_in] per layer
    linear, norm weights ones (``convert_params`` casts them per policy).
    `generator` lives on `device`, where the values are drawn; each tensor
    then moves to `store` (default `device`), so a rank of tensor
    parallelism draws on its card what a single-device run draws there
    and keeps the full weights in host memory. Real weights come from
    io/checkpoint.py or io/convert.py."""
    store = device if store is None else store

    def rand(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(store)

    L = cfg.n_layers
    layers: dict[str, Any] = {name: rand((L, *shape_fn(cfg)))
                              for name, shape_fn in LAYER_LINEARS.items()}
    layers["attn_norm"] = torch.ones((L, cfg.n_embd), device=store)
    layers["ffn_norm"] = torch.ones((L, cfg.n_embd), device=store)
    return {
        "embed": rand((cfg.n_vocab, cfg.n_embd)),
        "layers": layers,
        "norm": torch.ones((cfg.n_embd,), device=store),
        "lm_head": rand((cfg.n_vocab, cfg.n_embd)),
    }


def init_quantized_params(cfg: ModelConfig, policy: DtypePolicy,
                          generator: torch.Generator,
                          device="cpu", store=None) -> Params:
    """Random parameters of the policy's kind (N(0, 0.02) before
    quantization) built on `device` one f32 tensor at a time, so the peak
    extra memory is one layer's tensor plus the quantized layers and the
    embedding tables. `generator` lives on `device`. Each quantized
    tensor moves to `store` (default `device`) as it is made: with the
    host as `store`, `device` holds one layer's tensor at a time."""
    if not policy.is_quantized:
        raise ValueError(f"{policy.wdtype} weights are dense: use "
                         "init_dense_params")
    check_policy(policy)
    kind = policy.wdtype
    store = device if store is None else store

    def rand(shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    def quant(shape, layout):
        return quantize(rand(shape), kind, layout=layout).to(store)

    L = cfg.n_layers
    layers: dict[str, Any] = {}
    for name, shape_fn in LAYER_LINEARS.items():
        layers[name] = stack([quant(shape_fn(cfg), "kn") for _ in range(L)])
    layers["attn_norm"] = torch.ones((L, cfg.n_embd), device=store)
    layers["ffn_norm"] = torch.ones((L, cfg.n_embd), device=store)
    return {
        "embed": quant((cfg.n_vocab, cfg.n_embd), "nk"),
        "layers": layers,
        "norm": torch.ones((cfg.n_embd,), device=store),
        "lm_head": quant((cfg.n_vocab, cfg.n_embd), "kn"),
    }


def convert_params(dense: Params, policy: DtypePolicy) -> Params:
    """Cast or block-quantize dense f32 params ([L, d_out, d_in] per layer
    linear) per the policy. Norm weights stay f32. Quantized: the
    embedding table is "nk", every matmul weight "kn"; dense: each weight
    in the policy's wdtype, laid out as given."""
    check_policy(policy)

    def conv(name: str, w: torch.Tensor):
        if name.endswith("norm"):
            return w.float()
        if not policy.is_quantized:
            return w.to(DTYPES[policy.wdtype])
        return quantize(w, policy.wdtype,
                        layout="nk" if name == "embed" else "kn")

    return {
        "embed": conv("embed", dense["embed"]),
        "norm": dense["norm"].float(),
        "lm_head": conv("lm_head", dense["lm_head"]),
        "layers": {n: conv(n, w) for n, w in dense["layers"].items()},
    }


def params_to(params: Params, device) -> Params:
    """The same parameters on another device."""
    def move(w):
        return w.to(device)

    return {
        "embed": move(params["embed"]),
        "norm": move(params["norm"]),
        "lm_head": move(params["lm_head"]),
        "layers": {n: move(w) for n, w in params["layers"].items()},
    }


def pad_lm_head_vocab(params: Params, multiple: int = 2048) -> Params:
    """Pad a quantized kn lm_head's vocab dim (32003 -> 32768) with zero
    data and zero scales, so the decode kernel reads whole 4-byte column
    groups and strips. Zero scales null the pad columns exactly (a 4-bit
    column's -7 offset is multiplied by its scale too); lm_head_logits
    slices them off, so samplers never see pad ids. A dense lm_head, which
    no kernel reads, stays as it is (JAX pads only under use_pallas)."""
    lm = params["lm_head"]
    if not isinstance(lm, QTensor) or lm.layout != "kn":
        return params
    pad = (-lm.data.shape[-1]) % multiple
    if not pad:
        return params
    return {**params, "lm_head": QTensor(F.pad(lm.data, (0, pad)),
                                         F.pad(lm.scales, (0, pad)),
                                         lm.kind, lm.layout)}


def cast_dense_weights(params: Params, dtype: torch.dtype) -> Params:
    """Dense matmul weights and the embedding table in the activation
    dtype, norms as they are: the values every product and gather of the
    JAX package computes with (it casts the weight to x.dtype a call), so
    the cast is made once, not once a step. Quantized params pass
    through."""
    if isinstance(params["embed"], QTensor):
        return params

    def cast(name, w):
        return w if name.endswith("norm") else w.to(dtype)

    return {
        "embed": cast("embed", params["embed"]),
        "norm": params["norm"],
        "lm_head": cast("lm_head", params["lm_head"]),
        "layers": {n: cast(n, w) for n, w in params["layers"].items()},
    }


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------


def _attend_plain(q: torch.Tensor, cache, li: int,
                  pos: torch.Tensor) -> torch.Tensor:
    """The attention of dense weights on any cache kind, as the JAX
    ``_block`` computes it with use_pallas=False: the layer's keys and
    values gathered into a dense [B, Kh, S, d] view (pages, a staged
    tail and int8 dequantized in f32), then ``gqa_attention`` at the
    queries' absolute positions."""
    B, T = q.shape[:2]
    q_positions = (pos.long()[:, None]
                   + torch.arange(T, device=q.device)[None, :])
    if isinstance(cache, StagedKVCache):
        k, v = staged_layer_view(cache, li, q.dtype)
    elif isinstance(cache, PagedKVCache):
        k, v = paged_layer_view(cache, li, q.dtype)
    else:
        k, v = layer_cache_view(cache, li, q.dtype)
    return gqa_attention(q, k, v, q_positions, kernel_order=False)


def _attend_paged_prefill(q, k, v, layer0, pos, from_zero, quantized):
    """The paged prefill's attention (K3): a prefill from position 0
    attends only its own keys, so K3 reads them from a one-layer
    temporary cache instead of the pool. For an int8 pool the temporary
    cache holds the same quantized keys and scales the pool was just
    given, so the prefill attends what the pool holds. The temporary
    cache is padded to whole 64-key tiles; the pad keys lie past every
    query, so the causal mask hides them. Whether the prefill starts at
    0 is the caller's host fact, `from_zero`."""
    B, T, Kh, d = k.shape
    if not from_zero:
        raise ValueError(
            "a paged prefill attends only its own keys, so it must start at "
            "position 0: pass from_zero=True")
    S = -(-T // KEY_TILE) * KEY_TILE
    new = [k.transpose(1, 2), v.transpose(1, 2)]  # [B, Kh, T, d]
    if quantized:
        (kq, ks), (vq, vs) = quantize_kv(new[0]), quantize_kv(new[1])
        new = [kq, vq, ks, vs]
    tmp = []
    for n in new:
        t = torch.zeros((1, B, Kh, S, *n.shape[3:]), dtype=n.dtype,
                        device=k.device)
        t[0, :, :, :T] = n
        tmp.append(t)
    return flash_prefill_attention(q, KVCache(*tmp), layer0, pos)


def _block(cfg: ModelConfig, x: torch.Tensor, lp: Params, cache,
           li: int, layer_ids: torch.Tensor, pos: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor,
           from_zero: bool = False, aq8: bool = False,
           tp=None) -> torch.Tensor:
    """One pre-norm transformer block over x [B, T, D]; writes the
    block's K/V into the cache (monolithic, paged, or a staged chunk's
    tail) in place. The branch follows the JAX ``_block`` and depends on
    shapes, weight types, aq8, tensor parallelism and the cache's kind
    only.

    Under tensor parallelism (`tp`, a parallel/tp.py ``TpGroup``) `cfg`
    is the rank's local config, lp holds its shards, and the products of
    wo and w_down are summed over the model group (``tp.row_linear``: an
    all-reduce, or the ring): JAX's ``_row_linear``. The block is then
    always unfused, as JAX's."""
    B, T, _ = x.shape
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    layer = layer_ids[li:li + 1]
    dense = not isinstance(lp["wqkv"], QTensor)
    fused = decode_fused_eligible(cfg, lp, B * T, aq8,
                                  tp.size if tp is not None else 1)
    ffn_eligible = ffn_fused_eligible(cfg, lp["w_gateup"], lp["w_down"], B * T)

    def lin(h, name):
        # a dense weight's layer is sliced by its host index
        return linear(h, lp[name], li if dense else layer, aq8)

    def row_lin(h, name):
        if tp is None:
            return lin(h, name)
        return tp.row_linear(h, lp[name], li, layer_ids, aq8)

    if fused:
        qkv = fused_norm_qkv(x, lp["attn_norm"], lp["wqkv"], layer, eps, inside)
    else:
        qkv = lin(rms_norm(x, lp["attn_norm"][li], eps, inside), "wqkv")
    q = qkv[..., : H * d].reshape(B, T, H, d)
    k = qkv[..., H * d: (H + Kh) * d].reshape(B, T, Kh, d)
    v = qkv[..., (H + Kh) * d:].reshape(B, T, Kh, d)
    q = apply_rope_gathered(q, cos, sin)
    k = apply_rope_gathered(k, cos, sin)

    attn = None
    if isinstance(cache, StagedKVCache):
        # a staged decode chunk: one batched write of the step's K/V into
        # the tail; attention reads the pool below base + the tail
        update_staged_at_layer(cache, li, k, v)
    elif isinstance(cache, PagedKVCache):
        update_paged_at_layer(cache, li, k, v, pos)
    else:
        update_cache_at_layer(cache, li, k, v, pos)
    if dense:
        attn = _attend_plain(q, cache, li, pos)
    elif isinstance(cache, StagedKVCache):
        attend = (flash_paged_staged_attention if cache.paged
                  else flash_staged_attention)
        attn = attend(q, cache, layer, pos)
    elif isinstance(cache, PagedKVCache):
        if T == 1:
            attn = flash_paged_attention(q, cache, layer, pos)
        else:
            attn = _attend_paged_prefill(q, k, v, layer_ids[:1], pos,
                                         from_zero, cache.quantized)
    elif fused and T == 1 and B == 1 and d % 32 == 0:
        x = fused_attn_out(q, cache, layer, pos, x, lp["wo"])
    else:
        attend = (flash_decode_heads_attention if T == 1
                  else flash_prefill_attention)
        attn = attend(q, cache, layer, pos)
    if attn is not None:
        attn = attn.reshape(B, T, H * d)
        if fused:
            x = fused_out_residual(attn, x, lp["wo"], layer)
        else:
            x = x + row_lin(attn, "wo")
    if fused and ffn_eligible:
        return ffn_fused_normed(x, lp["ffn_norm"], lp["w_gateup"],
                                lp["w_down"], layer, cfg)

    h = rms_norm(x, lp["ffn_norm"][li], eps, inside)
    if ffn_eligible and not aq8 and tp is None:  # JAX's unfused-block gate
        return x + ffn_fused(h, lp["w_gateup"], lp["w_down"], layer, cfg)
    gate_up = lin(h, "w_gateup")
    gate, up = gate_up[..., : cfg.n_ffn], gate_up[..., cfg.n_ffn:]
    inner = F.silu(gate.float()).to(x.dtype) * up
    return x + row_lin(inner, "w_down")


def forward(
    cfg: ModelConfig,
    policy: DtypePolicy,
    params: Params,
    tokens: torch.Tensor,  # [B, T] integer, on the params' device
    cache,  # KVCache, PagedKVCache or StagedKVCache
    pos: torch.Tensor,  # [B] int32: absolute position of tokens[:, 0]
    rope_tables: tuple[torch.Tensor, torch.Tensor] | None = None,
    layer_ids: torch.Tensor | None = None,  # [L] int32 = arange(L)
    from_zero: bool = False,  # host fact: every pos is 0 (a prefill)
    tp=None,  # parallel/tp.py TpGroup: this rank's TP group
) -> torch.Tensor:
    """Run the model over T new tokens per sequence; the cache is updated
    in place. Returns hidden [B, T, D] after the final norm. Serves
    prefill (T = padded prompt length) and decode (T = 1) alike. A paged
    prefill needs from_zero (it starts at position 0). Rope rows of
    positions past max_ctx (the discarded overhang of a last chunk) read
    the table's last row, as the JAX package's clamped gather does.
    Under tensor parallelism `cfg` is the rank's local config and
    `params` its shard (``_block``); with the ring's chunk-stacked
    weights layer_ids is arange(L * tp)."""
    check_policy(policy)
    B, T = tokens.shape
    device = tokens.device
    cos, sin = rope_tables if rope_tables is not None else rope_table(
        cache.max_ctx, cfg.d_head, cfg.rope_theta, device)
    if layer_ids is None:
        layer_ids = torch.arange(cfg.n_layers, dtype=torch.int32, device=device)
    q_positions = pos.long()[:, None] + torch.arange(T, device=device)[None, :]
    cos_g, sin_g = gather_rope(q_positions.clamp(max=cos.shape[0] - 1), cos, sin)
    if isinstance(cache, StagedKVCache):
        cache = cache.at_step(pos)

    x = embedding_lookup(tokens, params["embed"], act_dtype(policy))
    for li in range(cfg.n_layers):
        x = _block(cfg, x, params["layers"], cache, li, layer_ids, pos,
                   cos_g, sin_g, from_zero, policy.aq8, tp)
    return rms_norm(x, params["norm"], cfg.norm_eps, cfg.norm_eps_inside_sqrt)


def lm_head_logits(params: Params, hidden: torch.Tensor,
                   aq8: bool = False) -> torch.Tensor:
    """Hidden rows [B, D] -> f32 logits [B, n_vocab] (with `aq8`, K1's
    int8-activation branch at B <= 8); a vocab-padded lm_head is sliced
    back to the embedding table's vocab (the rows of a dense table, of a
    quantized one's nk data)."""
    logits = linear_f32_out(hidden.contiguous(), params["lm_head"], aq8)
    emb = params["embed"]
    return logits[..., : (emb.data if isinstance(emb, QTensor) else emb).shape[0]]
