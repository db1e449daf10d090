#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tinyllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on one card, and fails (exit code not
0, no result line) without a CUDA device or without the port beside it.
Phases, each fatal on failure:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel from tinyllama_tpu_torch/csrc, one nvcc each, all
   at once, into build/kernels;
3. kernels: each kernel against its plain PyTorch version on the card,
   in bf16, at TinyLlama-1.1B's main-path shapes (K1 on the five decode
   matmuls, K2 at M=128 and 512, K3 at T=128 and 512, K4 at pos 127 and
   1500), with its time, its bound, the plain version's time and one
   PyTorch library call's time;
4. main path: TinyLlama-1.1B, q8 weights from a fixed seed, bf16
   activations and cache, one ~100-token prompt through
   Engine.generate, greedy, 256 new tokens; the launch counts of every
   kernel are set to 0 just before and must come out exactly as the
   path dictates;
5. parity: a 2-layer model at TinyLlama's full widths, the same weights
   on the card (kernels) and the CPU (plain versions), teacher-forced
   through a prefill and 4 decode steps; the logits must agree.

Prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds, after phase 4, a torch.profiler window over a few eager decode
steps of the main path: kernels launched a step, device time by kernel,
the kernels' share of it, and the host's time a step.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
#: bf16 tensor-core FLOP/s. bound_ms = max(bytes / BW, flops / PEAK).
HBM_BW = 3.35e12
PEAK_BF16 = 989e12

#: kernel vs plain version, both bf16 on the card: the JAX suite's own
#: tolerance for bf16 kernels (tests/test_tpu_kernels.py).
RTOL, ATOL = 2e-2, 5e-3

#: logits of the card (kernels) vs the CPU (plain versions), bf16
#: activations: the two paths round to bf16 at different points (f32
#: accumulation order inside the kernels, probabilities rounded before
#: or after normalization), each worth ~2^-8 relative, over ~10 rounding
#: sites a layer. Logits here have |max| ~4: allow 5% of it.
PARITY_REL = 0.05

N_NEW = 256
PROMPT_LEN = 100


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int, graph: bool) -> float:
    """Mean ms per call by CUDA events over `reps` calls, after warm-up;
    fn(i) gets the call index (to cycle layers past the 50 MB L2). With
    graph=True the calls are captured in one CUDA graph and replayed, so
    the time is the device's alone, free of Python dispatch; the plain
    versions read the layer index back to the host and run eagerly."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(i)
        run = g.replay
        run()
    else:
        def run():
            for i in range(reps):
                fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name: str, got, want) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= ATOL + RTOL * want.abs()).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {err}")
    return err


def phase_kernels(engine, torch, ops) -> list[dict]:
    """Every kernel against its plain version at main-path shapes."""
    qm, fa, codec = ops
    cfg, params = engine.cfg, engine.params
    L, dev = cfg.n_layers, engine.device
    layers = [engine.layer_ids[i:i + 1] for i in range(L)]
    gen = torch.Generator(dev)
    gen.manual_seed(7)
    rows = []

    def row(kernel, shape, route_src, replaces, err, ms, plain_ms, nbytes,
            flops, library_ms):
        t_bytes, t_ops = nbytes / HBM_BW * 1e3, flops / PEAK_BF16 * 1e3
        r = dict(name=f"{kernel} {shape}", kernel=kernel, route="cuda",
                 source=route_src, replaces=replaces, launches=0,
                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=library_ms)
        rows.append(r)
        print(f"kernel {r['name']}: max_abs_err {err:.3e} "
              f"(rtol {RTOL}, atol {ATOL}) kernel_ms {ms:.5f} "
              f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) "
              f"plain_ms {plain_ms:.5f} library_ms {library_ms:.5f}",
              flush=True)

    # K1 / K2: the quantized matmuls
    lin = params["layers"]
    mats = {n: lin[n] for n in ("wqkv", "wo", "w_gateup", "w_down")}
    dense = {n: [codec.dequantize(codec.QTensor(w.data[i], w.scales[i], "q8",
                                                "kn"), torch.bfloat16)
                 for i in range(L)] for n, w in mats.items()}
    lm = params["lm_head"]
    lm_dense = codec.dequantize(lm, torch.bfloat16)

    def qmm_case(label, w, wd, M, layered, out_dtype):
        K, N = w.data.shape[-2:]
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        lay = (lambda i: layers[i % L]) if layered else (lambda i: None)
        wdl = (lambda i: wd[i % L]) if layered else (lambda i: wd)
        got = qm.qmatmul(x, w, out_dtype, lay(0))
        want = qm.qmatmul_ref(x, w, out_dtype, lay(0))
        err = check_close(label, got, want)
        small = M <= qm.SMALL_M
        ms = time_ms(lambda i: qm.qmatmul(x, w, out_dtype, lay(i)), 200, True)
        plain = time_ms(lambda i: qm.qmatmul_ref(x, w, out_dtype, lay(i)), 10, False)
        lib = time_ms(lambda i: torch.matmul(x, wdl(i)), 200, True)
        out_b = 4 if out_dtype == torch.float32 else 2
        nbytes = K * N + (K // 32) * N * 2 + M * K * 2 + M * N * out_b
        kernel = "K1 qmm_smallm" if small else "K2 qmm_bigm"
        src = "tinyllama_tpu_torch/csrc/qmatmul.cu"
        rep = ("tinyllama_tpu/ops/pallas/qmatmul.py:87" if small
               else "tinyllama_tpu/ops/pallas/qmatmul.py:288")
        row(kernel, f"{label} M={M} K={K} N={N}", src, rep, err, ms, plain,
            nbytes, 2 * M * K * N, lib)

    for n, w in mats.items():
        qmm_case(n, w, dense[n], 1, True, torch.bfloat16)
    qmm_case("lm_head", lm, lm_dense, 1, False, torch.float32)
    for M in (128, 512):
        for n, w in mats.items():
            qmm_case(n, w, dense[n], M, True, torch.bfloat16)
    del dense, lm_dense

    # K3 / K4: attention over a full-size random bf16 cache
    H, Kh, d, S = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, engine.max_ctx
    G = H // Kh
    cache = engine.new_cache(1)
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev))
    src = "tinyllama_tpu_torch/csrc/flash_attention.cu"
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def attn_case(kernel, T, p):
        q = torch.randn((1, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        fn = (fa.flash_decode_heads_attention if T == 1
              else fa.flash_prefill_attention)
        got = fn(q, cache, layers[3], pos)
        want = fa.attention_ref(q, cache, layers[3], pos)
        err = check_close(f"{kernel} T={T} pos={p}", got, want)
        ms = time_ms(lambda i: fn(q, cache, layers[i % L], pos), 100, True)
        plain = time_ms(lambda i: fa.attention_ref(q, cache, layers[i % L], pos),
                        5, False)
        # library yardstick: SDPA over the visible keys, heads expanded
        n_keys = p + T
        kx = cache.k[3, :, :, :n_keys].repeat_interleave(G, dim=1)
        vx = cache.v[3, :, :, :n_keys].repeat_interleave(G, dim=1)
        qh = q.transpose(1, 2)
        causal = T > 1
        lib = time_ms(lambda i: sdpa(qh, kx, vx, is_causal=causal), 100, True)
        pairs = H * sum(p + t + 1 for t in range(T))
        nbytes = 2 * T * H * d * 2 + 2 * Kh * n_keys * d * 2
        rep = ("tinyllama_tpu/ops/pallas/flash_prefill.py:201" if T == 1
               else "tinyllama_tpu/ops/pallas/flash_prefill.py:35")
        row(kernel, f"T={T} pos={p} S={S}", src, rep, err, ms, plain, nbytes,
            4 * d * pairs, lib)

    for T in (128, 512):
        attn_case("K3 flash_prefill", T, 0)
    for p in (127, 1500):
        attn_case("K4 flash_decode_heads", 1, p)
    return rows


def profile_decode(engine, prompt, torch, steps: int = 4) -> None:
    """Where an eager decode step's time goes, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = engine.new_cache(1)
    engine.prefill(cache, [prompt])
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    for _ in range(3):
        engine.decode_step(cache, tok, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.decode_step(cache, tok, pos)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.elapsed_us() / 1e3
    dev_ms = sum(t for _, t in by_name.values()) / steps
    ours = sum(t for name, (_, t) in by_name.items()
               if "qmm_" in name or "flash_" in name) / steps
    print(f"profile: {len(kernels) / steps:.1f} device kernels a decode step "
          f"at pos {len(prompt)}; device busy {dev_ms:.4f} ms of "
          f"{host_ms:.4f} ms host time a step (profiler on); the port's "
          f"kernels {ours:.4f} ms, other PyTorch ops {dev_ms - ours:.4f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (count, ms) in top:
        print(f"profile:   {ms / steps:9.4f} ms  {count / steps:6.1f}x  {name[:90]}")


def main() -> int:
    if not (ROOT / "tinyllama_tpu_torch" / "csrc").is_dir():
        return fail("the tinyllama_tpu_torch package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from tinyllama_tpu_torch.config import (
        GenerationConfig, POLICIES, TINYLLAMA_1_1B,
    )
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import build
    from tinyllama_tpu_torch.ops.kernels import flash_attention as fa
    from tinyllama_tpu_torch.ops.kernels import qmatmul as qm
    from tinyllama_tpu_torch.quant import codec
    from tinyllama_tpu_torch.runtime.engine import Engine

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[torch.cuda.current_device()]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions, on the main path's weights
    policy = POLICIES["q8"]
    cfg = TINYLLAMA_1_1B
    gen = torch.Generator("cuda")
    gen.manual_seed(1234)
    t0 = time.perf_counter()
    params = llama.init_quantized_params(cfg, policy, gen, "cuda")
    engine = Engine(cfg, policy, params, max_ctx=2048, device="cuda")
    torch.cuda.synchronize()
    print(f"init: TinyLlama-1.1B q8 random weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = phase_kernels(engine, torch, (qm, fa, codec))

    # 4. main path
    rng = np.random.default_rng(0)
    prompt = [1] + rng.integers(2, cfg.n_vocab, PROMPT_LEN - 1).tolist()
    gcfg = GenerationConfig(n_predict=PROMPT_LEN + N_NEW, greedy=True,
                            eos_token=-1, chunk_size=32)
    engine.generate(prompt, GenerationConfig(n_predict=PROMPT_LEN + 8,
                                             greedy=True, eos_token=-1))
    for counts in (qm.launches, fa.launches):
        for k in counts:
            counts[k] = 0
    out, stats = engine.generate(prompt, gcfg)
    torch.cuda.synchronize()
    counts = {**qm.launches, **fa.launches}
    print(f"main path: launches {json.dumps(counts)}", flush=True)
    if len(out) != N_NEW or not all(0 <= t < cfg.n_vocab for t in out):
        return fail(f"generated {len(out)} tokens, or ids out of range")
    steps = stats.decode_steps
    L = cfg.n_layers
    want = {"qmm_bigm": 4 * L, "flash_prefill": L,
            "qmm_smallm": 1 + (4 * L + 1) * steps,
            "flash_decode_heads": L * steps}
    if steps != N_NEW or counts != want:
        return fail(f"launch counts {counts} (steps {steps}), want {want}")
    print(f"main path: prefill {stats.prefill_s * 1e3:.3f} ms "
          f"({stats.prompt_tokens} tokens, bucket 128); decode "
          f"{stats.decode_tokens_per_s:.2f} tok/s = "
          f"{stats.ms_per_token:.4f} ms/token over {stats.generated_tokens} "
          f"tokens; first ids {out[:8]}", flush=True)
    name_of = {"K1 qmm_smallm": "qmm_smallm", "K2 qmm_bigm": "qmm_bigm",
               "K3 flash_prefill": "flash_prefill",
               "K4 flash_decode_heads": "flash_decode_heads"}
    for r in rows:
        r["launches"] = counts[name_of[r["kernel"]]]

    # the device's own time for one decode step: the step captured in a
    # CUDA graph (it reads layer and pos from device memory, so it can be)
    cache = engine.new_cache(1)
    engine.prefill(cache, [prompt])
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    step_ms = time_ms(lambda i: engine.decode_step(cache, tok, pos), 20, True)
    print(f"main path: one decode step at pos {PROMPT_LEN} replayed as a "
          f"CUDA graph: {step_ms:.4f} ms device time; eager "
          f"{stats.ms_per_token:.4f} ms/token, so the device is busy "
          f"{step_ms / stats.ms_per_token:.3f} of an eager step", flush=True)
    if "--profile" in sys.argv[1:]:
        profile_decode(engine, prompt, torch)
    del engine, params

    # 5. parity: 2 layers at full width, the same weights on card and CPU
    cfg2 = TINYLLAMA_1_1B.replace(n_layers=2, max_ctx=256)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(99)
    p2 = llama.init_quantized_params(cfg2, policy, cpu_gen, "cpu")
    gpu, cpu = (Engine(cfg2, policy, p2, device=d) for d in ("cuda", "cpu"))
    feed = rng.integers(2, cfg2.n_vocab, 4).tolist()
    worst = 0.0
    traces = []
    for eng in (gpu, cpu):
        cache = eng.new_cache(1)
        logits, _ = eng.prefill(cache, [prompt])
        trace = [logits.float().cpu()]
        pos = torch.tensor([PROMPT_LEN], dtype=torch.int32, device=eng.device)
        for t in feed:
            tok = torch.tensor([t], dtype=torch.int32, device=eng.device)
            trace.append(eng.decode_step(cache, tok, pos).float().cpu())
            pos += 1
        traces.append(trace)
    for i, (a, b) in enumerate(zip(*traces)):
        if not (torch.isfinite(a).all() and a.shape == (1, cfg2.n_vocab)):
            return fail(f"parity step {i}: logits not finite or misshapen")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        worst = max(worst, err / scale)
        print(f"parity step {i}: max |gpu - cpu| {err:.5f}, max |cpu| "
              f"{scale:.4f}, mean |diff| {float((a - b).abs().mean()):.6f}")
        if err > PARITY_REL * scale:
            return fail(f"parity step {i}: {err} > {PARITY_REL} * {scale}")
    print(f"parity: worst relative max error {worst:.5f} (limit {PARITY_REL})")

    for r in rows:
        del r["kernel"]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
