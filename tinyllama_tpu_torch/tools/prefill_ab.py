"""The prefill kernels and prefills on one card, for comparing two trees
of the port.

    python3 tinyllama_tpu_torch/tools/prefill_ab.py [--root DIR] [--label NAME]

Imports ``tinyllama_tpu_torch`` from the checkout at DIR (by default the
one this file is in), builds its kernels there, and prints one JSON line
a measurement, each with the label and the card's name and power limit
(nvidia-smi):

* K2 (``qmatmul`` at M > 8) at TinyLlama-1.1B's four layer shapes (wqkv
  2048 -> 2560, wo 2048 -> 2048, w_gateup 2048 -> 11264, w_down 5632 ->
  2048) over 22 layers of random weights: q8, q4 and q4g at M = 32, 128,
  512 and 2,048, and q8 at M = 8,192; bf16 out. q8 rows carry
  ``torch.matmul`` on the dequantized bf16 weight;
* K3 (``flash_prefill_attention``) over each KV kind (bf16, i8, f16,
  f32) at 32 query heads, 4 kv heads, d 64, a 2,048-key cache: B = 1 at T
  = 32, 128, 512 and 2,048 from pos 0, and B = 32 at T = 256 (an
  admission); bf16 rows carry SDPA (causal, GQA);

  microseconds a call by CUDA events over a CUDA graph of 100 calls
  cycling the 22 layers past the 50 MB L2 (chip_smoke.py's method), with
  the bound: max(bytes once / 3.35 TB/s, operations / 989 TFLOP/s);
* three prefills on random q8 weights (chip_smoke.py's seed 1234),
  eager, host clock ended by ``torch.cuda.synchronize()``, three times
  each after a warm-up: path (a)'s 100-token prompt through
  ``Engine.generate`` (its ``prefill_s``), path (e)'s 1,450-token prompt
  through a paged engine's ``generate``, and one admission of path
  (f)'s first 32 prompts (numpy seed 5, padded to one bucket) through
  ``Engine.prefill`` into a 32-row page pool, as ``ContinuousBatcher``
  admits them.

It calls only entry points the package has had since its kernel
microbench came (``qmatmul``, ``flash_prefill_attention``, ``Engine``,
``tools/kbench.py``'s ``time_ms`` and ``card_line``), so the same file
measures an older tree: unpack one with ``git archive`` into a directory
that .gitignore lists, and run parent, change, change, parent in one call
on one card. Without a card it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HBM_BW, PEAK_BF16 = 3.35e12, 989e12
SHAPES = {"wqkv": (2048, 2560), "wo": (2048, 2048),
          "w_gateup": (2048, 11264), "w_down": (5632, 2048)}
KV_ROW = {"bf16": 128, "f16": 128, "f32": 256, "i8": 68}  # bytes a key row
LONG_PROMPT, ADMIT = 1450, 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose tinyllama_tpu_torch is measured")
    ap.add_argument("--label", default="", help="name printed on every line")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefill_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import tinyllama_tpu_torch
    from tinyllama_tpu_torch.config import (
        GenerationConfig, POLICIES, TINYLLAMA_1_1B,
    )
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import build
    from tinyllama_tpu_torch.ops.kernels import flash_attention as fa
    from tinyllama_tpu_torch.ops.kernels import qmatmul as qm
    from tinyllama_tpu_torch.quant import codec
    from tinyllama_tpu_torch.runtime.engine import Engine
    from tinyllama_tpu_torch.runtime.kvcache import KVCache, quantize_kv
    from tinyllama_tpu_torch.tools import kbench

    pkg = Path(tinyllama_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        print(f"prefill_ab: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 1
    card = kbench.card_line()

    def emit(**kw):
        print(json.dumps({"label": args.label, **kw, "card": card}), flush=True)

    def bound_us(nbytes, flops):
        return max(nbytes / HBM_BW, flops / PEAK_BF16) * 1e6

    build.build_all()
    cfg = TINYLLAMA_1_1B
    L, H, Kh, d, S = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 2048
    dev = "cuda"
    layers = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    gen = torch.Generator(dev)
    gen.manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # K2
    for kind in ("q8", "q4", "q4g"):
        wgen = torch.Generator(dev)
        wgen.manual_seed(1234)
        lin = llama.init_quantized_params(cfg, POLICIES[kind], wgen, dev)["layers"]
        for name, (K, N) in SHAPES.items():
            w = lin[name]
            dense = ([codec.dequantize(codec.QTensor(w.data[i], w.scales[i], kind,
                                                     "kn"), torch.bfloat16)
                      for i in range(L)] if kind == "q8" else None)
            w_bytes = (w.data[0].numel() * w.data.element_size()
                       + w.scales[0].numel() * 2)
            for M in (32, 128, 512, 2048) + ((8192,) if kind == "q8" else ()):
                x = rand(M, K)
                us = kbench.time_ms(
                    lambda i: qm.qmatmul(x, w, torch.bfloat16, layers[i % L]),
                    100, True) * 1e3
                lib = (kbench.time_ms(lambda i: torch.matmul(x, dense[i % L]),
                                      100, True) * 1e3 if dense else None)
                emit(kernel="K2 qmm_bigm", kind=kind, shape=f"{name} M={M}",
                     us=us, bound_us=bound_us(w_bytes + M * K * 2 + M * N * 2,
                                              2 * M * K * N),
                     library_us=lib)
                del x
            del dense
        del lin

    # K3
    def of_kind(c, kv):
        if kv == "bf16":
            return c
        if kv == "i8":
            (k, ks), (v, vs) = quantize_kv(c.k), quantize_kv(c.v)
            return KVCache(k, v, ks, vs)
        dt = {"f16": torch.float16, "f32": torch.float32}[kv]
        return KVCache(c.k.to(dt), c.v.to(dt))

    for B, Ts in ((1, (32, 128, 512, 2048)), (32, (256,))):
        base = KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d))
        for kv in ("bf16", "i8", "f16", "f32"):
            cache = of_kind(base, kv)
            for T in Ts:
                q = rand(B, T, H, d)
                pos = torch.zeros((B,), dtype=torch.int32, device=dev)
                us = kbench.time_ms(
                    lambda i: fa.flash_prefill_attention(q, cache, layers[i % L],
                                                         pos), 100, True) * 1e3
                lib = None
                if kv == "bf16":
                    qh = q.transpose(1, 2)
                    kx, vx = base.k[3][:, :, :T], base.v[3][:, :, :T]
                    lib = kbench.time_ms(
                        lambda i: torch.nn.functional.scaled_dot_product_attention(
                            qh, kx, vx, is_causal=True, enable_gqa=True),
                        100, True) * 1e3
                pairs = B * H * T * (T + 1) // 2
                emit(kernel="K3 flash_prefill", kv=kv, shape=f"B={B} T={T}",
                     us=us, bound_us=bound_us(
                         B * (2 * T * H * d * 2 + 2 * Kh * T * KV_ROW[kv]),
                         4 * d * pairs), library_us=lib)
                del q
            del cache
        del base

    # the three prefills
    wgen = torch.Generator(dev)
    wgen.manual_seed(1234)
    params = llama.init_quantized_params(cfg, POLICIES["q8"], wgen, dev)
    rng = np.random.default_rng(0)

    def prompt_of(n):
        return [1] + rng.integers(2, cfg.n_vocab, n - 1).tolist()

    srng = np.random.default_rng(5)  # path (f)'s requests
    lens = srng.integers(8, 201, 64)
    admit = [[1] + srng.integers(2, cfg.n_vocab, n - 1).tolist()
             for n in lens][:ADMIT]
    for path, n, paged in (("(a)", 100, False), ("(e)", LONG_PROMPT, True)):
        eng = Engine(cfg, POLICIES["q8"], params, max_ctx=S, device=dev,
                     paged=paged)
        prompt = prompt_of(n)
        gcfg = GenerationConfig(n_predict=n + 4, greedy=True, eos_token=-1)
        eng.generate(prompt, gcfg)
        ms = []
        for _ in range(3):
            _, stats = eng.generate(prompt, gcfg)
            ms.append(stats.prefill_s * 1e3)
        emit(prefill=f"{path} b1 generate", prompt=n, ms=ms)
        del eng
    eng = Engine(cfg, POLICIES["q8"], params, max_ctx=S, device=dev, paged=True)
    cache = eng.new_paged_cache(ADMIT)
    eng.prefill(cache, admit)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(cache, admit)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    emit(prefill=f"(f) admission B={ADMIT}", prompt=int(max(len(p) for p in admit)),
         ms=ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
