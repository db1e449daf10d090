"""Llama-family forward pass in PyTorch.

The same model as the JAX package's models/llama.py (embedding ->
n_layers x [pre-norm GQA attention + SwiGLU FFN, with residuals] ->
RMSNorm -> lm_head), with its parameter layout: per-layer weights stacked
on a leading layer axis, q/k/v fused into one ``wqkv`` and gate/up into
one ``w_gateup`` along d_out. The forward is a Python loop over layers
that hands each kernel the stacked weight and a device layer index.

Each block runs the unfused kernel path of the JAX ``_block`` (the
branch it takes when its fused decode kernels are not eligible):
rms_norm, ``linear`` of wqkv, rope, the in-place cache write, flash
attention (``flash_decode_heads_attention`` at T = 1,
``flash_prefill_attention`` otherwise), ``x + linear(attn, wo)``, then
rms_norm, ``linear`` of w_gateup, SwiGLU and ``x + linear(inner,
w_down)``. The lm_head runs outside ``forward``, on the rows the caller
picks. Weights are q8; the other formats come later (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig
from tinyllama_tpu_torch.ops.kernels.flash_attention import (
    flash_decode_heads_attention,
    flash_prefill_attention,
)
from tinyllama_tpu_torch.ops.linear import (
    embedding_lookup,
    linear,
    linear_f32_out,
)
from tinyllama_tpu_torch.ops.norms import rms_norm
from tinyllama_tpu_torch.ops.rope import apply_rope_gathered, gather_rope, rope_table
from tinyllama_tpu_torch.quant.codec import QTensor, quantize
from tinyllama_tpu_torch.runtime.kvcache import KVCache, update_cache_at_layer

Params = dict[str, Any]

ACT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}

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
    return ACT_DTYPES[policy.adtype]


def _require_q8(policy: DtypePolicy) -> None:
    if policy.wdtype != "q8" or policy.aq8:
        raise NotImplementedError(
            f"weights {policy.wdtype!r} (aq8={policy.aq8}) are not ported "
            "yet: the port runs q8 weight-only (ROADMAP.md, Queue 1)")


# ----------------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------------


def init_quantized_params(cfg: ModelConfig, policy: DtypePolicy,
                          generator: torch.Generator,
                          device="cpu") -> Params:
    """Random q8 parameters (N(0, 0.02) before quantization) built on
    `device` one f32 tensor at a time, so the peak extra memory is one
    layer's tensor plus the embedding tables. `generator` lives on
    `device`."""
    _require_q8(policy)

    def rand(shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    L = cfg.n_layers
    layers: dict[str, Any] = {}
    for name, shape_fn in LAYER_LINEARS.items():
        N, K = shape_fn(cfg)
        data = torch.empty((L, K, N), dtype=torch.int8, device=device)
        scales = torch.empty((L, K // 32, N), dtype=torch.float16, device=device)
        for li in range(L):
            qt = quantize(rand((N, K)), "q8", layout="kn")
            data[li], scales[li] = qt.data, qt.scales
        layers[name] = QTensor(data, scales, "q8", "kn")
    layers["attn_norm"] = torch.ones((L, cfg.n_embd), device=device)
    layers["ffn_norm"] = torch.ones((L, cfg.n_embd), device=device)
    return {
        "embed": quantize(rand((cfg.n_vocab, cfg.n_embd)), "q8", layout="nk"),
        "layers": layers,
        "norm": torch.ones((cfg.n_embd,), device=device),
        "lm_head": quantize(rand((cfg.n_vocab, cfg.n_embd)), "q8", layout="kn"),
    }


def convert_params(dense: Params, policy: DtypePolicy) -> Params:
    """Block-quantize dense f32 params ([L, d_out, d_in] per layer linear)
    per the policy. Norm weights stay f32; the embedding table is "nk",
    every matmul weight "kn"."""
    _require_q8(policy)

    def conv(name: str, w: torch.Tensor):
        if name.endswith("norm"):
            return w.float()
        return quantize(w, "q8", layout="nk" if name == "embed" else "kn")

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
    """Pad a kn lm_head's vocab dim (32003 -> 32768) with zero data and
    zero scales, so the decode kernel reads whole char4 rows and strips.
    Zero scales null the pad columns exactly; lm_head_logits slices them
    off, so samplers never see pad ids."""
    lm = params["lm_head"]
    pad = (-lm.data.shape[-1]) % multiple
    if lm.layout != "kn" or not pad:
        return params
    return {**params, "lm_head": QTensor(F.pad(lm.data, (0, pad)),
                                         F.pad(lm.scales, (0, pad)),
                                         lm.kind, lm.layout)}


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------


def _block(cfg: ModelConfig, x: torch.Tensor, lp: Params, cache: KVCache,
           li: int, layer: torch.Tensor, pos: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One pre-norm transformer block over x [B, T, D]; writes the
    block's K/V into the cache in place."""
    B, T, _ = x.shape
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt

    h = rms_norm(x, lp["attn_norm"][li], eps, inside)
    qkv = linear(h, lp["wqkv"], layer)
    q = qkv[..., : H * d].reshape(B, T, H, d)
    k = qkv[..., H * d: (H + Kh) * d].reshape(B, T, Kh, d)
    v = qkv[..., (H + Kh) * d:].reshape(B, T, Kh, d)
    q = apply_rope_gathered(q, cos, sin)
    k = apply_rope_gathered(k, cos, sin)

    update_cache_at_layer(cache, li, k, v, pos)
    attend = flash_decode_heads_attention if T == 1 else flash_prefill_attention
    attn = attend(q, cache, layer, pos).reshape(B, T, H * d)
    x = x + linear(attn, lp["wo"], layer)

    h = rms_norm(x, lp["ffn_norm"][li], eps, inside)
    gate_up = linear(h, lp["w_gateup"], layer)
    gate, up = gate_up[..., : cfg.n_ffn], gate_up[..., cfg.n_ffn:]
    inner = F.silu(gate.float()).to(x.dtype) * up
    return x + linear(inner, lp["w_down"], layer)


def forward(
    cfg: ModelConfig,
    policy: DtypePolicy,
    params: Params,
    tokens: torch.Tensor,  # [B, T] integer, on the params' device
    cache: KVCache,
    pos: torch.Tensor,  # [B] int32: absolute position of tokens[:, 0]
    rope_tables: tuple[torch.Tensor, torch.Tensor] | None = None,
    layer_ids: torch.Tensor | None = None,  # [L] int32 = arange(L)
) -> torch.Tensor:
    """Run the model over T new tokens per sequence; the cache is updated
    in place. Returns hidden [B, T, D] after the final norm. Serves
    prefill (T = padded prompt length) and decode (T = 1) alike."""
    _require_q8(policy)
    B, T = tokens.shape
    device = tokens.device
    cos, sin = rope_tables if rope_tables is not None else rope_table(
        cache.max_ctx, cfg.d_head, cfg.rope_theta, device)
    if layer_ids is None:
        layer_ids = torch.arange(cfg.n_layers, dtype=torch.int32, device=device)
    q_positions = pos.long()[:, None] + torch.arange(T, device=device)[None, :]
    cos_g, sin_g = gather_rope(q_positions, cos, sin)

    x = embedding_lookup(tokens, params["embed"], act_dtype(policy))
    for li in range(cfg.n_layers):
        x = _block(cfg, x, params["layers"], cache, li, layer_ids[li:li + 1],
                   pos, cos_g, sin_g)
    return rms_norm(x, params["norm"], cfg.norm_eps, cfg.norm_eps_inside_sqrt)


def lm_head_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Hidden rows [B, D] -> f32 logits [B, n_vocab]; a vocab-padded
    lm_head is sliced back to the embedding table's vocab."""
    logits = linear_f32_out(hidden.contiguous(), params["lm_head"])
    return logits[..., : params["embed"].data.shape[0]]
