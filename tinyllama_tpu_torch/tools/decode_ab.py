"""The fused decode-layer kernels and the decode steps on one card, for
comparing two trees of the port.

    python3 tinyllama_tpu_torch/tools/decode_ab.py [--root DIR] [--label NAME]
        [--plan W:S,W:S,W:S] [--rows-only | --steps-only] [--step-reps R]

Imports ``tinyllama_tpu_torch`` from the checkout at DIR (by default the
one this file is in), builds its kernels there, and prints one JSON line
a measurement, each with the label and the card's name and power limit
(nvidia-smi):

* the weight kernels of a decode layer at TinyLlama-1.1B's widths
  over 22 layers of random weights (``llama.init_quantized_params``, seed
  1234): K5 ``fused_norm_qkv`` and K7 ``ffn_fused_normed`` at M = 1, 4
  and 32 in q8, q4 and q4g, K7's plain entry ``ffn_fused`` at M = 1 (q8),
  K6 ``fused_out_residual`` at M = 4 and 32 in q8, q4 and q4g, K8
  ``fused_attn_out`` at pos 127 and 1500 over a bf16 cache in q8, q4 and
  q4g and over int8, f16 and f32 caches in q8 (its library call SDPA
  over the visible keys as bf16, then ``torch.addmm`` with the
  residual), and K1
  ``qmm_smallm`` (``qmatmul.qmatmul``) at wqkv, wo, w_gateup, w_down and
  the lm_head (padded to 32,768 columns as the engine pads it; f32 out)
  at M = 1, 4 and 8 in q8, q4, q4g, q8a8 and q4a8 (the aq8 branch on q8
  and q4 weights): microseconds a call by CUDA events over a CUDA graph
  of 100 calls cycling the 22 layers past the 50 MB L2 (chip_smoke.py's
  method), each held against its plain version first, with its bound
  (max(bytes once / 3.35 TB/s, operations / 989 TFLOP/s)), its plain
  version's time (eager, 5 calls) and its library call's at that M
  (``torch.matmul`` on the layer's weight dequantized to bf16; for K7 the
  gate/up and the down products; K6 ``torch.addmm``; for aq8 also
  ``torch._int_mm`` at M = 17, the least M it takes, on the int8 values
  with no scales);
* the decode steps on random q8 weights (the same seed): path (a)'s b1
  step (a 100-token prompt, 256 greedy tokens: eager ms/token on the
  host clock; one step at pos 127 replayed as a CUDA graph), path (c)'s
  B = 4 ``decode_step`` (8 eager steps on the host clock, and one
  replayed), path (f)'s staged B = 32 step at a 100-token fill (8 eager
  steps, and one replayed) and its ``ContinuousBatcher`` over a paged
  engine, 32 slots, 64 requests (numpy seed 5: tok/s, TTFT p50 / p95),
  path (h)'s b1 step on q4 weights and path (k)'s b1 step under q8a8
  (every linear and the lm_head K1's aq8 branch) replayed as CUDA graphs.

``--plan W:S,W:S,W:S`` sets the walk's tile width and K splits of K5, of
K7's gate/up and of its down launch in place of ``fused_plan``'s (it
needs a tree with the fused walk, csrc/fused_walk.cuh), and times K5 and
K7 at M = 1 and 32 in q8 only, each checked against its plain version.
``--rows-only`` skips the decode steps; ``--steps-only`` the kernel
rows. ``--step-reps R`` times each graph
step R times in its process and prints the median (``graph_ms``) and
all R (``graph_ms_all``): a step's graph time jumps by up to 0.4 ms
between processes, so compare steps over several turns.

It calls only entry points the package has had since its kernel
microbench came (the fused wrappers, ``qmatmul.qmatmul``, ``Engine``,
``ContinuousBatcher``, ``stage_cache``, ``tools/kbench.py``'s
``time_ms`` and ``card_line``),
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

HBM_BW, PEAK_BF16 = 3.35e12, 989e12
PROMPT, N_NEW, GRAPH_POS, BATCH, STEPS, SLOTS = 100, 256, 127, 4, 8, 32
#: K8's positions: path (a)'s graph step and the long-context step's
K8_POS = (GRAPH_POS, 1500)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose tinyllama_tpu_torch is measured")
    ap.add_argument("--label", default="", help="name printed on every line")
    ap.add_argument("--plan", default=None,
                    help="tile width:K splits of K5, K7's gate/up and down, "
                         "e.g. 128:8,128:4,64:8")
    ap.add_argument("--rows-only", action="store_true",
                    help="the kernel rows without the decode steps")
    ap.add_argument("--steps-only", action="store_true",
                    help="the decode steps without the kernel rows")
    ap.add_argument("--step-reps", type=int, default=1,
                    help="times each graph step is timed in the process")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import tinyllama_tpu_torch
    from tinyllama_tpu_torch.config import (
        GenerationConfig, POLICIES, TINYLLAMA_1_1B,
    )
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import attn_out_fused as ao
    from tinyllama_tpu_torch.ops.kernels import build
    from tinyllama_tpu_torch.ops.kernels import decode_fused as df
    from tinyllama_tpu_torch.ops.kernels import ffn_fused as ff
    from tinyllama_tpu_torch.ops.kernels import qmatmul as qm
    from tinyllama_tpu_torch.quant import codec
    from tinyllama_tpu_torch.runtime.engine import Engine
    from tinyllama_tpu_torch.runtime.kvcache import (
        KVCache, layer_cache_view, quantize_kv,
    )
    from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher
    from tinyllama_tpu_torch.runtime.staging import stage_cache
    from tinyllama_tpu_torch.tools import kbench

    pkg = Path(tinyllama_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        print(f"decode_ab: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 1
    card = kbench.card_line()

    def emit(**kw):
        print(json.dumps({"label": args.label, **kw, "card": card}), flush=True)

    def bound_us(nbytes, flops):
        return max(nbytes / HBM_BW, flops / PEAK_BF16) * 1e6

    quick = bool(args.plan)  # K5 and K7 in q8 at M = 1, 32
    build.build_all()
    cfg = TINYLLAMA_1_1B
    L, D, F, dev = cfg.n_layers, cfg.n_embd, cfg.n_ffn, "cuda"
    if args.plan:
        from tinyllama_tpu_torch.ops.kernels import fused_plan

        p_qkv, p_gu, p_down = (tuple(map(int, p.split(":")))
                               for p in args.plan.split(","))
        fused_plan.fused_plan = lambda K, ncols, n_sm, *_, **__: (
            p_down if K == F else p_gu if ncols == F else p_qkv)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    layers = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    gen = torch.Generator(dev)
    gen.manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def params_of(kind):
        wgen = torch.Generator(dev)
        wgen.manual_seed(1234)
        return llama.init_quantized_params(cfg, POLICIES[kind], wgen, dev)

    def nbytes(w):
        return w.data[0].numel() * w.data.element_size() + w.scales[0].numel() * 2

    def dense(w, kind):
        return [codec.dequantize(codec.QTensor(w.data[i], w.scales[i], kind, "kn"),
                                 torch.bfloat16) for i in range(L)]

    def row(kernel, kind, shape, fn, plain, lib, nb, flops, **extra):
        # the kernel against its plain version first
        got, want = fn(0).float(), plain(0).float()
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all()
                and ((got - want).abs() <= 5e-3 + 2e-2 * want.abs()).all()):
            raise AssertionError(f"{kernel} {kind} {shape}: disagrees with "
                                 "its plain version")
        us = kbench.time_ms(fn, 100, True) * 1e3
        rec = dict(kernel=kernel, kind=kind, shape=shape, us=us,
                   bound_us=bound_us(nb, flops))
        if args.plan:
            rec.update(plan=args.plan)
        else:
            rec.update(plain_us=kbench.time_ms(plain, 5, False) * 1e3,
                       library_us=kbench.time_ms(lib, 100, True) * 1e3)
        emit(**rec, **{k: f() for k, f in extra.items()})

    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    #: bytes of a cached key (or value) row by KV kind, int8 with its scale
    kv_row = {"bf16": 2 * d, "f16": 2 * d, "f32": 4 * d, "i8": d + 4}

    def kv_cache(base, kv):
        """base (bf16) as a cache of KV kind kv: the same values quantized
        to int8 with their scales, or cast."""
        if kv == "bf16":
            return base
        if kv == "i8":
            (k, ks), (v, vs) = quantize_kv(base.k), quantize_kv(base.v)
            return KVCache(k, v, ks, vs)
        dt = {"f16": torch.float16, "f32": torch.float32}[kv]
        return KVCache(base.k.to(dt), base.v.to(dt))

    def k8_rows(kind, wo, dwo):
        """K8 at K8_POS over a bf16 cache and, for q8, int8, f16 and f32
        ones (labels "q8-kvi8", ...); library: SDPA over the visible keys
        as bf16 (int8 dequantized, f16 and f32 cast), then torch.addmm."""
        base = KVCache(rand(L, 1, Kh, 2048, d), rand(L, 1, Kh, 2048, d))
        for kv in ("bf16", "i8", "f16", "f32") if kind == "q8" else ("bf16",):
            cache = kv_cache(base, kv)
            views = [layer_cache_view(cache, li, torch.bfloat16) for li in range(L)]
            q, res = rand(1, 1, H, d), rand(1, 1, D)
            for p in K8_POS:
                pos = torch.tensor([p], dtype=torch.int32, device=dev)
                n_keys = p + 1

                def sdpa_addmm(i, q=q, res=res, n_keys=n_keys):
                    k, v = views[i % L]
                    att = torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k[:, :, :n_keys], v[:, :, :n_keys],
                        enable_gqa=True)
                    return torch.addmm(res.view(1, D), att.reshape(1, D), dwo[i % L])

                row("K8 fused_attn_out", kind if kv == "bf16" else f"{kind}-kv{kv}",
                    f"pos={p}",
                    lambda i, q=q, res=res, pos=pos, cache=cache:
                        ao.fused_attn_out(q, cache, layers[i % L], pos, res, wo),
                    lambda i, q=q, res=res, pos=pos, cache=cache:
                        ao.fused_attn_out_ref(q, cache, layers[i % L], pos, res, wo),
                    sdpa_addmm,
                    nbytes(wo) + 2 * Kh * n_keys * kv_row[kv] + H * d * 2 + 2 * D * 2,
                    4 * H * n_keys * d + 2 * D * D)
            del cache, views
        del base

    for kind in () if args.steps_only else \
            ("q8",) if quick else ("q8", "q4", "q4g"):
        lin = params_of(kind)["layers"]
        wq, gu, wd, wo = lin["wqkv"], lin["w_gateup"], lin["w_down"], lin["wo"]
        nq, nf = lin["attn_norm"], lin["ffn_norm"]
        dq, dgu, dwd = dense(wq, kind), dense(gu, kind), dense(wd, kind)
        N = wq.data.shape[-1]
        for M in (1, 32) if quick else (1, 4, 32):
            x = rand(M, 1, D)
            row("K5 fused_norm_qkv", kind, f"M={M}",
                lambda i: df.fused_norm_qkv(x, nq, wq, layers[i % L], eps, inside),
                lambda i: df.fused_norm_qkv_ref(x, nq, wq, layers[i % L], eps, inside),
                lambda i: torch.matmul(x.view(M, D), dq[i % L]),
                nbytes(wq) + M * D * 2 + D * 4 + M * N * 2, 2 * M * D * N)
            row("K7 ffn_fused_normed", kind, f"M={M}",
                lambda i: ff.ffn_fused_normed(x, nf, gu, wd, layers[i % L], cfg),
                lambda i: ff.ffn_fused_ref(x, nf, gu, wd, layers[i % L], cfg, eps,
                                           inside),
                lambda i: torch.matmul(torch.matmul(x.view(M, D), dgu[i % L])[:, :F],
                                       dwd[i % L]),
                nbytes(gu) + nbytes(wd) + 2 * M * D * 2 + D * 4, 6 * M * F * D)
            if kind == "q8" and M == 1:
                row("K7 ffn_fused (plain entry)", kind, "M=1",
                    lambda i: ff.ffn_fused(x, gu, wd, layers[i % L], cfg),
                    lambda i: ff.ffn_fused_ref(x, None, gu, wd, layers[i % L], cfg),
                    lambda i: torch.matmul(torch.matmul(x.view(1, D), dgu[i % L])[:, :F],
                                           dwd[i % L]),
                    nbytes(gu) + nbytes(wd) + 2 * D * 2, 6 * F * D)
        if not quick:
            dwo = dense(wo, kind)
            for M in (4, 32):
                a, r = rand(M, 1, D), rand(M, 1, D)
                row("K6 fused_out_residual", kind, f"M={M}",
                    lambda i: df.fused_out_residual(a, r, wo, layers[i % L]),
                    lambda i: df.fused_out_residual_ref(a, r, wo, layers[i % L]),
                    lambda i: torch.addmm(r.view(M, D), a.view(M, D), dwo[i % L]),
                    nbytes(wo) + 3 * M * D * 2, 2 * M * D * D)
            k8_rows(kind, wo, dwo)
            del dwo
        del lin, dq, dgu, dwd
        torch.cuda.empty_cache()

    # K1: every linear of the unfused decode branch and the lm_head
    def int_mm_us(w, K, layered):
        """torch._int_mm at M = 17 on the int8 values (column-major, as
        cuBLAS's int8 product takes them), no scales."""
        planes = [w.data[i] for i in range(L)] if layered else [w.data]
        wi = [(p if w.kind == "q8" else qm.int_values(p, w.kind).to(torch.int8)
               ).t().contiguous().t() for p in planes]
        xi = torch.ones((17, K), dtype=torch.int8, device=dev)
        return kbench.time_ms(lambda i: torch._int_mm(xi, wi[i % len(wi)]), 100,
                              True) * 1e3

    def k1_rows(label, p, aq8):
        mats = {n: p["layers"][n] for n in ("wqkv", "wo", "w_gateup", "w_down")}
        mats["lm_head"] = llama.pad_lm_head_vocab(p)["lm_head"]
        for n, w in mats.items():
            layered = n != "lm_head"
            N, K = w.shape[-2:]
            out = torch.float32 if n == "lm_head" else torch.bfloat16
            lay = (lambda i: layers[i % L]) if layered else (lambda i: None)
            wd = (dense(w, w.kind) if layered else
                  [codec.dequantize(w, torch.bfloat16)])
            nb = nbytes(w) if layered else (w.data.numel() * w.data.element_size()
                                            + w.scales.numel() * 2)
            extra = {"int_mm_us": lambda w=w, K=K: int_mm_us(w, K, layered)} if aq8 else {}
            for M in (1, 4, 8):
                x = rand(M, K)
                row("K1 qmm_smallm", label, f"{n} M={M} K={K} N={N}",
                    lambda i: qm.qmatmul(x, w, out, lay(i), aq8=aq8),
                    lambda i: qm.qmatmul_ref(x, w, out, lay(i), aq8=aq8),
                    lambda i: torch.matmul(x, wd[i % len(wd)]),
                    nb + M * K * 2 + M * N * (4 if n == "lm_head" else 2),
                    2 * M * K * N, **(extra if M == 1 else {}))
            del wd
            torch.cuda.empty_cache()

    if not quick and not args.steps_only:
        for base in ("q8", "q4"):
            p = params_of(base)
            k1_rows(base, p, False)
            k1_rows(f"{base}a8", p, True)
            del p
        k1_rows("q4g", params_of("q4g"), False)
        torch.cuda.empty_cache()
    if quick or args.rows_only:
        return 0

    # the decode steps
    rng = np.random.default_rng(0)

    def prompt_of(n):
        return [1] + rng.integers(2, cfg.n_vocab, n - 1).tolist()

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    params = params_of("q8")
    engine = Engine(cfg, POLICIES["q8"], params, max_ctx=2048, device=dev)
    prompt = prompt_of(PROMPT)
    gcfg = GenerationConfig(n_predict=PROMPT + N_NEW, greedy=True, eos_token=-1,
                            chunk_size=32)
    engine.generate(prompt, GenerationConfig(n_predict=PROMPT + 8, greedy=True,
                                             eos_token=-1))
    out, stats = engine.generate(prompt, gcfg)
    if len(out) != N_NEW:
        raise AssertionError(f"(a): {len(out)} tokens, not {N_NEW}")

    def graph_times(fn):
        """{graph_ms: the median of --step-reps timings of fn as a graph of
        20 calls, graph_ms_all: each}"""
        times = [kbench.time_ms(fn, 20, True) for _ in range(args.step_reps)]
        out = {"graph_ms": float(np.median(times))}
        if args.step_reps > 1:
            out["graph_ms_all"] = times
        return out

    def graph_step(eng, prompts, pos):
        cache = eng.new_cache(len(prompts))
        eng.prefill(cache, prompts)
        tok = i32([5] * len(prompts))
        return graph_times(lambda i: eng.decode_step(cache, tok, pos))

    emit(step="(a) b1", eager_ms_per_token=stats.ms_per_token,
         **graph_step(engine, [prompt], i32([GRAPH_POS])), graph_pos=GRAPH_POS)

    prompts = [prompt_of(PROMPT) for _ in range(BATCH)]
    cache = engine.new_cache(BATCH)
    logits, lens = engine.prefill(cache, prompts)
    pos = i32(lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        logits = engine.decode_step(cache, logits.argmax(dim=-1).to(torch.int32), pos)
        pos += 1
    torch.cuda.synchronize()
    emit(step="(c) B=4 decode_step",
         eager_ms=(time.perf_counter() - t0) * 1e3 / STEPS,
         **graph_step(engine, prompts, i32([GRAPH_POS] * BATCH)))
    del cache

    cache = engine.new_paged_cache(SLOTS)
    engine.prefill(cache, [prompt] * SLOTS)
    pos = torch.full((SLOTS,), PROMPT, dtype=torch.int32, device=dev)
    st = stage_cache(cache, pos, 32)
    tok = torch.full((SLOTS,), 5, dtype=torch.int32, device=dev)
    engine.decode_step(st, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        engine.decode_step(st, tok, pos + i)
    torch.cuda.synchronize()
    emit(step="(f) staged B=32 step", eager_ms=(time.perf_counter() - t0) * 1e3 / STEPS,
         **graph_times(lambda i: engine.decode_step(st, tok, pos)))
    del cache, st, engine

    paged = Engine(cfg, POLICIES["q8"], params, max_ctx=2048, device=dev, paged=True)
    srng = np.random.default_rng(5)
    lens = srng.integers(8, 201, 64)
    n_new = srng.integers(32, 97, 64).tolist()
    reqs = [[1] + srng.integers(2, cfg.n_vocab, n - 1).tolist() for n in lens]
    batcher = ContinuousBatcher(paged, GenerationConfig(greedy=True, eos_token=-1,
                                                        chunk_size=32),
                                max_batch=SLOTS)
    ids = [batcher.submit(r, max_new=n) for r, n in zip(reqs, n_new)]
    t0 = time.perf_counter()
    res = batcher.run()
    wall = time.perf_counter() - t0
    ttft = np.array([res[i].first_token_s - res[i].submitted_s for i in ids])
    emit(step="(f) ContinuousBatcher", requests=64, new_tokens=int(sum(n_new)),
         tok_s=sum(n_new) / wall, ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p95_s=float(np.percentile(ttft, 95)))
    del paged, batcher, params

    engine = Engine(cfg, POLICIES["q4"], params_of("q4"), max_ctx=2048, device=dev)
    emit(step="(h) q4 b1", **graph_step(engine, [prompt], i32([GRAPH_POS])),
         graph_pos=GRAPH_POS)
    del engine
    engine = Engine(cfg, POLICIES["q8a8"], params_of("q8"), max_ctx=2048, device=dev)
    emit(step="(k) q8a8 b1", **graph_step(engine, [prompt], i32([GRAPH_POS])),
         graph_pos=GRAPH_POS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
