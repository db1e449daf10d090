"""Model / dtype / generation configuration.

The port's own copy of the JAX package's configuration (same fields,
same presets, same defaults), so that the port imports nothing of it.
Defaults mirror TinyLlama-1.1B-Chat-v0.4 as the reference hardcodes it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters.

    Defaults are TinyLlama-1.1B-Chat-v0.4: n_vocab=32003, max_ctx=2048,
    n_embd=2048, n_ffn=5632, n_layers=22, n_heads=32, n_query_groups=4.
    """

    name: str = "tinyllama-1.1b-chat-v0.4"
    n_vocab: int = 32003
    max_ctx: int = 2048
    n_embd: int = 2048
    n_ffn: int = 5632
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4  # "n_query_groups" in the reference
    rope_theta: float = 10000.0
    # RMSNorm epsilon. The reference adds eps to the *root* mean square
    # (x / (rms + eps) * w), unlike HF Llama which uses
    # x * rsqrt(mean_sq + eps). `norm_eps_inside_sqrt` selects the HF
    # convention for non-TinyLlama models.
    norm_eps: float = 1e-6
    norm_eps_inside_sqrt: bool = False
    # Whether lm_head weights are tied to the embedding table.
    tie_lm_head: bool = False
    # Explicit head dim; None derives n_embd // n_heads.
    head_dim: int | None = None

    @property
    def d_head(self) -> int:
        return self.head_dim or self.n_embd // self.n_heads

    @property
    def q_heads_per_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --- Model registry ---------------------------------------------------------

TINYLLAMA_1_1B = ModelConfig()

LLAMA_3_8B = ModelConfig(
    name="llama-3-8b",
    n_vocab=128256,
    max_ctx=8192,
    n_embd=4096,
    n_ffn=14336,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    rope_theta=500000.0,
    norm_eps=1e-5,
    norm_eps_inside_sqrt=True,
)

LLAMA_3_70B = ModelConfig(
    name="llama-3-70b",
    n_vocab=128256,
    max_ctx=8192,
    n_embd=8192,
    n_ffn=28672,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    rope_theta=500000.0,
    norm_eps=1e-5,
    norm_eps_inside_sqrt=True,
)

MODEL_REGISTRY: dict[str, ModelConfig] = {
    m.name: m for m in (TINYLLAMA_1_1B, LLAMA_3_8B, LLAMA_3_70B)
}


def tiny_test_config(**overrides) -> ModelConfig:
    """A miniature config for fast unit tests."""
    base = dict(
        name="tiny-test",
        n_vocab=512,
        max_ctx=128,
        n_embd=128,
        n_ffn=256,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
    )
    base.update(overrides)
    return ModelConfig(**base)


# --- Dtype policy ------------------------------------------------------------

#: Weight formats. "q8"/"q4" are block-32 weight-only quantization, "q4g"
#: the group-128 4-bit serving format; f32/bf16/f16 are dense. The port
#: runs the three quantized formats; the dense ones are queued
#: (ROADMAP.md, Queue 1).
WEIGHT_DTYPES = ("f32", "bf16", "f16", "q8", "q4", "q4g")
#: Activation compute dtypes.
ACT_DTYPES = ("f32", "bf16", "f16")
#: KV-cache storage dtypes ("i8" = per-(pos,head) scaled int8).
KV_DTYPES = ("f32", "bf16", "f16", "i8")


@dataclass(frozen=True)
class DtypePolicy:
    """Weight/activation/KV-cache dtype policy, after the reference's
    ModuleDtype policy: fp16 -> {w: f16, a: f16}; q8 -> {w: q8};
    q4 -> {w: q4}. Weight-only quantization with bf16/f32 activations."""

    wdtype: str = "bf16"
    adtype: str = "bf16"
    kv_dtype: str = "bf16"
    #: quantize matmul activations to per-32-block int8 inside the decode
    #: kernel (the reference's q8 activation scheme). Not yet ported.
    aq8: bool = False

    def __post_init__(self):
        if self.wdtype not in WEIGHT_DTYPES:
            raise ValueError(f"unknown weight dtype {self.wdtype}")
        if self.adtype not in ACT_DTYPES:
            raise ValueError(f"unknown activation dtype {self.adtype}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown KV dtype {self.kv_dtype}")

    @property
    def is_quantized(self) -> bool:
        return self.wdtype in ("q8", "q4", "q4g")


#: Named dtype policies matching the reference CLI flags -f16/-q8/-q4.
POLICIES: dict[str, DtypePolicy] = {
    "f32": DtypePolicy("f32", "f32", "f32"),
    "bf16": DtypePolicy("bf16", "bf16", "bf16"),
    "f16": DtypePolicy("f16", "bf16", "bf16"),
    "q8": DtypePolicy("q8", "bf16", "bf16"),
    "q4": DtypePolicy("q4", "bf16", "bf16"),
    "q8-kvi8": DtypePolicy("q8", "bf16", "i8"),
    "q4-kvi8": DtypePolicy("q4", "bf16", "i8"),
    "q8a8": DtypePolicy("q8", "bf16", "bf16", aq8=True),
    "q4a8": DtypePolicy("q4", "bf16", "bf16", aq8=True),
    "q4g": DtypePolicy("q4g", "bf16", "bf16"),
    "q4g-kvi8": DtypePolicy("q4g", "bf16", "i8"),
}


@dataclass(frozen=True)
class GenerationConfig:
    """Sampler settings; defaults match the reference CLI
    (n_predict=768, temp=0.9, topk=50)."""

    n_predict: int = 768
    temperature: float = 0.9
    top_k: int = 50
    greedy: bool = False
    eos_token: int = 32002
    seed: int = 0
    #: decode steps run back to back on the device between two host
    #: read-backs of the sampled tokens.
    chunk_size: int = 32
