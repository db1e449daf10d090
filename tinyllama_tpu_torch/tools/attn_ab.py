"""Decode attention on one card, for comparing two trees of the port.

    python3 tinyllama_tpu_torch/tools/attn_ab.py [--root DIR] [--label NAME]

Imports ``tinyllama_tpu_torch`` from the checkout at DIR (by default the
one this file is in), builds its kernels there, and prints one JSON line
a measurement, each with the label and the card's name and power limit
(nvidia-smi):

* the single-token attention kernels at TinyLlama-1.1B's shapes (4 kv
  heads, 32 query heads, d 64, max_ctx 2048, 22 layers) over each KV kind
  (bf16, i8, f16, f32): K4 at B = 1 and pos 127, 1500, 2047 and at B = 4,
  pos 1500; K10 at pos 127, 1500, 2047; K9 at B = 8 and K11 at B = 32
  over a fill of 256 keys and a 32-slot tail filled to 32 or to 1, and
  over fills of 384 and 1,536 and a tail filled to 32. Microseconds a call:
  CUDA events over a CUDA graph of 100 calls cycling the 22 layers
  (chip_smoke.py's method); random values from a seeded generator, int8
  through ``quantize_kv``, f16 and f32 cast. K9's and K11's lines also
  carry their bound (bytes once over 3.35 TB/s), the plain version's
  time (5 eager calls) and SDPA's (with enable_gqa, over the same keys
  gathered dense as bf16);
* two long-context b1 decode steps on random q8 weights (chip_smoke.py's
  seed 1234): a paged q8 engine (K10) and a q8a8 engine (K4), each a
  1,450-token prompt and 64 greedy tokens (eager ms/token, host clock),
  then one step at pos 1500 replayed as a CUDA graph (ms, CUDA events);
* three staged decode steps on the same weights, each 8 eager steps
  (ms a step, host clock) and one replayed as a CUDA graph: path (f)'s
  B = 32 step over a page pool after 32 prompts of 100 tokens (K11), the
  same after 32 prompts of 1,500 tokens, and path (g)'s B = 8 step over
  a monolithic cache after 8 prompts of 100 tokens (K9).

It calls only entry points the package has had since its kernel
microbench came (``tools/kbench.py``'s ``time_ms`` and ``card_line``),
so the same file measures an older tree: unpack one with ``git archive``
into a directory that .gitignore lists, and run parent, change, change,
parent in one call on one card. Without a card it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

LONG_PROMPT, LONG_POS, N_NEW = 1450, 1500, 64
#: K9's and K11's (pool fill, tail fill) cases over a 32-slot tail: 5, 7
#: and 25 key tiles a row
STAGED_CASES = ((256, 32), (256, 1), (384, 32), (1536, 32))
#: the staged steps: eager steps timed a step
STEPS = 8
#: bytes a second of the card's memory (H100 SXM data sheet)
HBM_BW = 3.35e12


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
        print("attn_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import tinyllama_tpu_torch
    from tinyllama_tpu_torch.config import (
        GenerationConfig, POLICIES, TINYLLAMA_1_1B,
    )
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import build
    from tinyllama_tpu_torch.ops.kernels import flash_attention as fa
    from tinyllama_tpu_torch.ops.kernels import flash_paged as fp
    from tinyllama_tpu_torch.runtime.engine import Engine
    from tinyllama_tpu_torch.runtime.kvcache import (
        KVCache, layer_cache_view, quantize_kv,
    )
    from tinyllama_tpu_torch.runtime.paged import (
        PagedKVCache, default_page_size, paged_layer_view,
    )
    from tinyllama_tpu_torch.runtime.staging import StagedKVCache, stage_cache
    from tinyllama_tpu_torch.tools import kbench

    pkg = Path(tinyllama_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        print(f"attn_ab: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 1
    card = kbench.card_line()

    def emit(**kw):
        print(json.dumps({"label": args.label, **kw, "card": card}), flush=True)

    build.build_all()
    cfg = TINYLLAMA_1_1B
    L, H, Kh, d, S = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 2048
    P = default_page_size(S)
    dev = "cuda"
    gen = torch.Generator(dev)
    gen.manual_seed(7)
    layers = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def of_kind(c, kv):
        """A bf16 cache (KVCache or PagedKVCache) in KV kind kv."""
        table = (c.table,) if isinstance(c, PagedKVCache) else ()
        if kv == "bf16":
            return c
        if kv == "i8":
            (k, ks), (v, vs) = quantize_kv(c.k), quantize_kv(c.v)
            return type(c)(k, v, *table, ks, vs)
        dt = {"f16": torch.float16, "f32": torch.float32}[kv]
        return type(c)(c.k.to(dt), c.v.to(dt), *table)

    def pool_of(B, n_keys, kv):
        """B rows of n_keys keys each in a pool of their pages, row b on
        pages 1 + b * n ... (b + 1) * n."""
        n = -(-n_keys // P)
        table = torch.zeros((B, S // P), dtype=torch.int32, device=dev)
        table[:, :n] = 1 + torch.arange(B * n, device=dev).reshape(B, n)
        return of_kind(PagedKVCache(rand(L, 1 + B * n, Kh, P, d),
                                    rand(L, 1 + B * n, Kh, P, d), table), kv)

    def kernel(name, kv, shape, fn, **extra):
        emit(kernel=name, kv=kv, shape=shape,
             us=kbench.time_ms(fn, 100, True) * 1e3, **extra)

    def i32(B, value):
        return torch.full((B,), value, dtype=torch.int32, device=dev)

    #: bytes of one cached key or value row of each kind (int8: its scale)
    row_bytes = {"bf16": 2 * d, "f16": 2 * d, "f32": 4 * d, "i8": d + 4}

    def staged_rows(kv):
        """K9 at B = 8 and K11 at B = 32 over STAGED_CASES: time, bound,
        plain and SDPA."""
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for name, B, paged in (("K9 flash_staged", 8, False),
                               ("K11 flash_paged_staged", 32, True)):
            for fill, tail in STAGED_CASES:
                base = pool_of(B, fill, kv) if paged else of_kind(
                    KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d)), kv)
                t = of_kind(KVCache(rand(L, B, Kh, 32, d),
                                    rand(L, B, Kh, 32, d)), kv)
                st = StagedKVCache(base, t.k, t.v, i32(B, fill),
                                   sk_scale=t.k_scale, sv_scale=t.v_scale)
                q, pos = rand(B, 1, H, d), i32(B, fill + tail - 1)
                fn = (fp.flash_paged_staged_attention if paged
                      else fa.flash_staged_attention)
                shape = f"B={B} fill={fill} tail={tail}"

                def call(i, fn=fn, q=q, st=st, pos=pos):
                    return fn(q, st, layers[i % L], pos)

                kd, vd = (paged_layer_view(base, 3, torch.bfloat16) if paged
                          else layer_cache_view(base, 3, torch.bfloat16))
                tk, tv = layer_cache_view(t, 3, torch.bfloat16)
                kx = torch.cat([kd[:, :, :fill], tk[:, :, :tail]], dim=2)
                vx = torch.cat([vd[:, :, :fill], tv[:, :, :tail]], dim=2)
                qh = q.transpose(1, 2)
                nbytes = (2 * B * Kh * (fill + tail) * row_bytes[kv]
                          + 2 * B * H * d * 2)
                kernel(name, kv, shape, call,
                       bound_us=nbytes / HBM_BW * 1e6,
                       plain_us=kbench.time_ms(
                           lambda i: fp.staged_attention_ref(
                               q, st, layers[i % L], pos), 5, False) * 1e3,
                       sdpa_us=kbench.time_ms(
                           lambda i: sdpa(qh, kx, vx, enable_gqa=True), 100,
                           True) * 1e3)
                del base, t, st

    for kv in ("bf16", "i8", "f16", "f32"):
        for B, positions in ((1, (127, 1500, 2047)), (4, (1500,))):
            cache = of_kind(KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d)),
                            kv)
            q = rand(B, 1, H, d)
            for p in positions:
                pos = i32(B, p)
                kernel("K4 flash_decode_heads", kv, f"B={B} pos={p}",
                       lambda i: fa.flash_decode_heads_attention(
                           q, cache, layers[i % L], pos))
            del cache
        q = rand(1, 1, H, d)
        for p in (127, 1500, 2047):
            pool, pos = pool_of(1, p + 1, kv), i32(1, p)
            kernel("K10 flash_paged", kv, f"B=1 pos={p}",
                   lambda i: fp.flash_paged_attention(q, pool, layers[i % L],
                                                      pos))
            del pool
        staged_rows(kv)

    wgen = torch.Generator(dev)
    wgen.manual_seed(1234)
    params = llama.init_quantized_params(cfg, POLICIES["q8"], wgen, dev)
    rng = np.random.default_rng(0)
    prompt = [1] + rng.integers(2, cfg.n_vocab, LONG_PROMPT - 1).tolist()
    for step, policy, paged in (("paged q8", "q8", True), ("q8a8", "q8a8", False)):
        eng = Engine(cfg, POLICIES[policy], params, max_ctx=S, device=dev,
                     paged=paged)
        eng.generate(prompt, GenerationConfig(n_predict=LONG_PROMPT + 8,
                                              greedy=True, eos_token=-1))
        out, stats = eng.generate(prompt, GenerationConfig(
            n_predict=LONG_PROMPT + N_NEW, greedy=True, eos_token=-1,
            chunk_size=32))
        torch.cuda.synchronize()
        if len(out) != N_NEW:
            raise AssertionError(f"{step}: {len(out)} tokens, not {N_NEW}")
        cache = eng.new_cache(1)
        eng.prefill(cache, [prompt])
        tok, pos = i32(1, 5), i32(1, LONG_POS)
        graph_ms = kbench.time_ms(lambda i: eng.decode_step(cache, tok, pos), 20,
                                  True)
        emit(step=step, prompt=LONG_PROMPT, new_tokens=N_NEW,
             eager_ms_per_token=stats.ms_per_token, graph_pos=LONG_POS,
             graph_ms=graph_ms)
        del eng, cache

    engine = Engine(cfg, POLICIES["q8"], params, max_ctx=S, device=dev)
    prompt = [1] + rng.integers(2, cfg.n_vocab, 1499).tolist()
    for step, B, fill, paged in (("(f) staged B=32 paged", 32, 100, True),
                                 ("(f) staged B=32 paged", 32, 1500, True),
                                 ("(g) staged B=8 monolithic", 8, 100, False)):
        cache = (engine.new_paged_cache(B) if paged
                 else engine.new_cache(B))
        engine.prefill(cache, [prompt[:fill]] * B)
        pos = i32(B, fill)
        st = stage_cache(cache, pos, 32)
        tok = i32(B, 5)
        engine.decode_step(st, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            engine.decode_step(st, tok, pos + i)
        torch.cuda.synchronize()
        emit(step=step, fill=fill,
             eager_ms=(time.perf_counter() - t0) * 1e3 / STEPS,
             graph_ms=kbench.time_ms(lambda i: engine.decode_step(st, tok, pos),
                                     20, True))
        del cache, st
    return 0


if __name__ == "__main__":
    sys.exit(main())
