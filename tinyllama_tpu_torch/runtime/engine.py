"""Inference engine: bucketed prefill, single-token decode, and the
chunked generation loop.

The counterpart of the JAX package's runtime/engine.py for one prompt:

* ``prefill`` runs the whole (bucket-padded) prompt through the model,
  writing its K/V into the cache, and returns the last row's logits;
* ``decode_step`` runs one token per sequence at device positions;
* ``generate`` samples on the device and reads the sampled tokens back
  once per ``chunk_size`` steps, so the host waits on the card once a
  chunk and not once a token (the role of the JAX package's on-device
  decode chunk). Each step is dispatched eagerly from Python; capturing
  the step in a CUDA graph is queued work (ROADMAP.md).

The engine runs on the card unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain version. With no card and no
explicit ``"cpu"`` it raises; it never carries on on the CPU by itself.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from tinyllama_tpu_torch.config import DtypePolicy, GenerationConfig, ModelConfig
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops import sampling
from tinyllama_tpu_torch.ops.rope import rope_table
from tinyllama_tpu_torch.runtime.kvcache import KVCache, init_cache


@dataclass
class GenStats:
    """Timing and throughput of one generate call (the reference's
    print_perf data)."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    load_s: float = 0.0
    #: decode forward passes run (>= generated_tokens when EOS cuts a chunk)
    decode_steps: int = 0
    #: host wait per chunk read-back, seconds
    decode_token_times: list = field(default_factory=list)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def ms_per_token(self) -> float:
        return (1000.0 * self.decode_s / self.generated_tokens
                if self.generated_tokens else 0.0)


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another. Raises
    when CUDA is asked for (or implied) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def _bucket(n: int, max_ctx: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_ctx)


class Engine:
    """One model + dtype policy on one device."""

    def __init__(self, cfg: ModelConfig, policy: DtypePolicy,
                 params: llama.Params, max_ctx: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and (
                policy.adtype != "bf16" or policy.kv_dtype != "bf16"):
            raise NotImplementedError(
                "the CUDA kernels take bf16 activations and a bf16 KV cache; "
                "other dtypes are queued (ROADMAP.md)")
        self.cfg = cfg
        self.policy = policy
        self.max_ctx = max_ctx or cfg.max_ctx
        # whole char4 rows and strips for the lm_head kernel
        self.params = llama.pad_lm_head_vocab(llama.params_to(params, self.device))
        self.rope_tables = rope_table(self.max_ctx, cfg.d_head, cfg.rope_theta,
                                      self.device)
        self.layer_ids = torch.arange(cfg.n_layers, dtype=torch.int32,
                                      device=self.device)

    def new_cache(self, batch: int = 1) -> KVCache:
        return init_cache(self.cfg, batch, self.policy.kv_dtype, self.max_ctx,
                          self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward_logits(self, cache: KVCache, tokens: torch.Tensor,
                        pos: torch.Tensor,
                        last: torch.Tensor | None = None) -> torch.Tensor:
        """Logits of row b's token `last[b]` (the only token at decode)."""
        hidden = llama.forward(self.cfg, self.policy, self.params, tokens,
                               cache, pos, self.rope_tables, self.layer_ids)
        if last is None:
            return llama.lm_head_logits(self.params, hidden[:, 0])
        rows = torch.arange(hidden.shape[0], device=self.device)
        return llama.lm_head_logits(self.params, hidden[rows, last])

    def prefill(self, cache: KVCache, prompts: list[list[int]]):
        """Prefill a batch of prompts, padded to one bucket length.
        Returns (logits [B, V] f32 of each prompt's last token, lens)."""
        lens = np.array([len(p) for p in prompts], np.int64)
        if int(lens.max()) > self.max_ctx:
            raise ValueError(
                f"Number of prompt tokens ({int(lens.max())}) exceeds maximum "
                f"ctx size ({self.max_ctx})")
        T = _bucket(int(lens.max()), self.max_ctx)
        toks = np.zeros((len(prompts), T), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        pos = torch.zeros(len(prompts), dtype=torch.int32, device=self.device)
        logits = self._forward_logits(
            cache, torch.from_numpy(toks).to(self.device), pos,
            torch.from_numpy(lens - 1).to(self.device))
        return logits, lens

    def decode_step(self, cache: KVCache, tokens: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        """One token per sequence: tokens [B], pos [B] int32 (device) ->
        logits [B, V] f32; the cache is written in place."""
        return self._forward_logits(cache, tokens[:, None], pos)

    def generate(
        self,
        prompt_tokens: list[int],
        gen: GenerationConfig | None = None,
        stream: Callable[[int], None] | None = None,
    ) -> tuple[list[int], GenStats]:
        """Single-prompt generation (greedy or top-k), with the reference
        loop's semantics: up to n_predict - len(prompt) new tokens, ending
        at EOS (not emitted). The token of step i is sampled from the
        logits entering step i; after EOS a row keeps emitting EOS and the
        host cuts the rest."""
        gen = gen or GenerationConfig()
        stats = GenStats(prompt_tokens=len(prompt_tokens))
        cache = self.new_cache(1)

        t0 = time.perf_counter()
        logits, lens = self.prefill(cache, [prompt_tokens])
        self._sync()
        stats.prefill_s = time.perf_counter() - t0

        max_new = max(0, min(gen.n_predict - len(prompt_tokens),
                             self.max_ctx - len(prompt_tokens)))
        if not max_new:
            return [], stats
        C = max(1, min(gen.chunk_size, max_new))
        generator = None
        if not gen.greedy:
            generator = torch.Generator(self.device)
            generator.manual_seed(gen.seed)
        pos = torch.tensor([int(lens[0])], dtype=torch.int32, device=self.device)
        done = torch.zeros(1, dtype=torch.bool, device=self.device)
        eos = torch.full((1,), gen.eos_token, dtype=torch.int32,
                         device=self.device)

        out: list[int] = []
        t_decode = time.perf_counter()
        while len(out) < max_new:
            n = min(C, max_new - len(out))  # never past max_ctx
            toks = torch.empty((1, n), dtype=torch.int32, device=self.device)
            for i in range(n):
                if gen.greedy:
                    tok = sampling.greedy(logits)
                else:
                    tok = sampling.sample_top_k(logits, generator,
                                                gen.temperature, gen.top_k)
                tok = torch.where(done, eos, tok)
                done |= tok == eos
                toks[:, i] = tok
                logits = self.decode_step(cache, tok, pos)
                pos += 1
            stats.decode_steps += n
            t1 = time.perf_counter()
            chunk = toks[0].tolist()  # one read-back per chunk
            stats.decode_token_times.append(time.perf_counter() - t1)
            finished = False
            for t in chunk:
                if t == gen.eos_token:
                    finished = True
                    break
                out.append(t)
                if stream is not None:
                    stream(t)
                if len(out) >= max_new:
                    break
            if finished:
                break

        stats.decode_s = time.perf_counter() - t_decode
        stats.generated_tokens = len(out)
        return out, stats
