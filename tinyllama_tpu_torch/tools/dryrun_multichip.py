"""The multi-device dryrun on N rank processes: the port's counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip``.

    python -m tinyllama_tpu_torch.tools.dryrun_multichip N [--device cpu]

starts N ranks (``parallel.mesh.RankPool``; on the card(s) unless
``--device cpu``: rank r on cuda:(r % cards), gloo where ranks share a
card, NCCL where each has its own), factors N into dp x tp with JAX's
rule (tp the first of 4, 2, 1 that divides N and the config's kv heads)
and runs JAX's paths on JAX's configurations and seeds (the weights drawn
by torch from those seeds), printing one line a path:

1. GSPMD (``param_sharding`` / ``cache_sharding`` + jit): not ported
   (ROADMAP.md, Queue 1 item 9); the line says so.
2. The TP engine's ``generate_batch`` of dp rows (a row a data rank, over
   the mesh's batch group) with 6 greedy tokens a row, and the
   ``tp_overlap`` engine token-identical to it.
3. The Llama-3-architecture mini config (GQA-8, rope 5e5, the HF norm) at
   tp N where N divides its 8 kv heads, else tp: q4 weights, an int8 KV
   cache, 8 tokens.
4. One pre-norm block over a sequence of 8 N rows sharded over N data
   ranks, ring attention (parallel/ring.py) between them, equal to the
   unsharded block (rtol and atol 2e-4).
6. ``Engine(sp=N)``'s tokens equal to sp 1's (a 41-token prompt).
7. ``Engine(sp=dp, tp=tp)`` and a paged ``Engine(sp=N)`` equal to the
   single-device engine.

A path that fails raises (the run exits non-zero); nothing is skipped
silently. The configs are JAX's on every device, the card included: a
head dim of 32 and 2 query heads a kv head (1 kv head and 2 query heads
a rank at tp 4), which the card's attention kernels take.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tinyllama_tpu_torch.config import (
    POLICIES,
    DtypePolicy,
    GenerationConfig,
    ModelConfig,
    tiny_test_config,
)
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.norms import rms_norm
from tinyllama_tpu_torch.ops.rope import (
    apply_rope_gathered,
    gather_rope,
    rope_table,
)
from tinyllama_tpu_torch.parallel.mesh import RankPool, rank_device, with_mesh
from tinyllama_tpu_torch.parallel.ring import ring_gqa_attention
from tinyllama_tpu_torch.runtime.engine import Engine

#: path 2's prompt length (JAX's T)
T = 8


def configs() -> tuple[ModelConfig, ModelConfig]:
    """JAX's two dryrun configs (the tiny one of paths 2, 4, 6 and 7; the
    Llama-3 mini of path 3), the same on every device."""
    cfg = tiny_test_config(n_heads=8, n_kv_heads=4, n_embd=256, n_ffn=512)
    l3 = tiny_test_config(
        name="llama-3-mini", n_vocab=2048, max_ctx=256, n_embd=512,
        n_ffn=1024, n_layers=4, n_heads=16, n_kv_heads=8,
    ).replace(rope_theta=500000.0, norm_eps=1e-5, norm_eps_inside_sqrt=True)
    return cfg, l3


def factor(n: int, cfg: ModelConfig) -> tuple[int, int]:
    """(dp, tp) of n ranks: tp the first of 4, 2, 1 dividing n and the kv
    heads (JAX's rule)."""
    tp = next(c for c in (4, 2, 1) if n % c == 0 and cfg.n_kv_heads % c == 0)
    return n // tp, tp


def _params(mesh, cfg, policy, seed):
    """`policy` weights of `cfg` from torch seed `seed`, drawn on the
    rank's device (the same on every rank) and kept in host memory."""
    g = torch.Generator(mesh.device).manual_seed(seed)
    dense = llama.init_dense_params(cfg, g, mesh.device, "cpu")
    return llama.convert_params(dense, policy)


def _path2(mesh, cfg, dp):
    """generate_batch of dp rows (psum and the tp_overlap ring)."""
    policy = DtypePolicy("q8", "bf16", "i8")
    gen = GenerationConfig(n_predict=T + 6, greedy=True, eos_token=-2,
                           chunk_size=3)
    outs = []
    for overlap in (False, True):
        eng = Engine(cfg, policy, _params(mesh, cfg, policy, 0), mesh=mesh,
                     tp_overlap=overlap)
        outs.append(eng.generate_batch([list(range(2, 2 + T))] * dp, gen)[0])
    return outs, eng.batch, eng.new_cache(dp).k.shape[1]


def _path3(mesh, l3):
    policy = DtypePolicy("q4", "bf16", "i8")
    eng = Engine(l3, policy, _params(mesh, l3, policy, 2), mesh=mesh)
    out, _ = eng.generate(list(range(3, 19)), GenerationConfig(
        n_predict=24, greedy=True, eos_token=-2, chunk_size=4))
    return out


class _OneRank:
    """A data group of one (the unsharded reference of path 4's ring)."""

    dp, dp_rank = 1, 0


def _sp_block(x, cos_g, sin_g, lw, cfg, mesh):
    """One pre-norm block over this rank's T slice; only the attention
    talks (JAX's ``sp_block``)."""
    B, Tl, D = x.shape
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, lw["attn_norm"], cfg.norm_eps, cfg.norm_eps_inside_sqrt)
    qkv = h @ lw["wqkv"].T
    q = qkv[..., : H * d].reshape(B, Tl, H, d)
    k = qkv[..., H * d: (H + Kh) * d].reshape(B, Tl, Kh, d)
    v = qkv[..., (H + Kh) * d:].reshape(B, Tl, Kh, d)
    q = apply_rope_gathered(q, cos_g, sin_g)
    k = apply_rope_gathered(k, cos_g, sin_g)
    attn = ring_gqa_attention(q, k, v, mesh)
    x = x + attn.reshape(B, Tl, H * d) @ lw["wo"].T
    h = rms_norm(x, lw["ffn_norm"], cfg.norm_eps, cfg.norm_eps_inside_sqrt)
    gu = h @ lw["w_gateup"].T
    inner = torch.nn.functional.silu(gu[..., : cfg.n_ffn]) * gu[..., cfg.n_ffn:]
    return x + inner @ lw["w_down"].T


def _path4(mesh, cfg):
    """This data rank's slice of the sharded block and the unsharded
    block, f32 numpy."""
    dev, n = mesh.device, mesh.dp
    g = torch.Generator(dev).manual_seed(5)
    dense = llama.init_dense_params(cfg, g, dev)
    lw = {name: w[0] for name, w in dense["layers"].items()}
    Tsp = 8 * n
    x = torch.randn((1, Tsp, cfg.n_embd), generator=g, device=dev) * 0.1
    cos, sin = rope_table(cfg.max_ctx, cfg.d_head, cfg.rope_theta, dev)
    cos_g, sin_g = gather_rope(torch.arange(Tsp, device=dev)[None], cos, sin)
    rows = slice(mesh.dp_rank * 8, (mesh.dp_rank + 1) * 8)
    got = _sp_block(x[:, rows], cos_g[:, rows], sin_g[:, rows], lw, cfg, mesh)
    want = _sp_block(x, cos_g, sin_g, lw, cfg, _OneRank())
    return got.cpu().numpy(), want.cpu().numpy()


def _path6_7(mesh, cfg, what):
    """The single-device engine's tokens on prompt 6 and those of
    Engine(sp=..., tp=...) (`what`: "sp", "sp_tp" or "sp_paged")."""
    policy = POLICIES["q8"]
    params = _params(mesh, cfg, policy, 7)
    gen = GenerationConfig(n_predict=52, greedy=True, eos_token=-2,
                           chunk_size=4)
    prompt = [2 + (i % 50) for i in range(41)]
    want, _ = Engine(cfg, policy, params, device=mesh.device).generate(prompt,
                                                                       gen)
    eng = Engine(cfg, policy, params, mesh=mesh, sp=mesh.dp,
                 paged=what == "sp_paged")
    got, _ = eng.generate(prompt, gen)
    return want, got, eng.sp, eng.tp


def _same(results, path):
    first = results[0]
    if any(not _equal(r, first) for r in results[1:]):
        raise AssertionError(f"path {path}: the ranks' results differ")
    return first


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def run_paths(pool: RankPool, n: int, device=None) -> list[str]:
    """The dryrun's paths on the n ranks of `pool`; returns (and prints)
    one line a path. Raises AssertionError where a path's check fails."""
    lines: list[str] = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    def ranks(fn, tp, dp, *args):
        return pool.run(with_mesh, fn, tp, dp, device, *args)[: tp * dp]

    cfg, l3 = configs()
    dp, tp = factor(n, cfg)
    say(f"dryrun_multichip path 1 not ported: GSPMD (param_sharding, "
        f"cache_sharding + jit) waits for --tp-mode gspmd (ROADMAP.md, Queue 1 "
        f"item 9); mesh dp={dp} x tp={tp} over {n} ranks")

    res = ranks(_path2, tp, dp, cfg, dp)
    (outs, outs_ovl), batch, rows = _same(res, 2)
    if [len(o) for o in outs] != [6] * dp or outs_ovl != outs:
        raise AssertionError(f"path 2: rows {outs}, the ring's {outs_ovl}")
    if batch != dp or rows != 1:
        raise AssertionError(f"path 2: a batch group of {batch}, {rows} "
                             f"row(s) a rank; want {dp} and 1")
    say(f"dryrun_multichip path 2 OK (shard_map TP Engine): mesh dp={dp} x "
        f"tp={tp}, a row a data rank; decoded {[len(o) for o in outs]} tokens "
        f"per row")
    say(f"dryrun_multichip path 2 OK (tp-overlap ring): token-identical to "
        f"the all-reduce at dp={dp} x tp={tp}")

    tp3 = n if l3.n_kv_heads % n == 0 else tp
    out3 = _same(ranks(_path3, tp3, 1, l3), 3)
    if len(out3) != 8:
        raise AssertionError(f"path 3: {len(out3)} tokens of 8")
    say(f"dryrun_multichip path 3 OK (Llama-3 arch, tp={tp3}): decoded "
        f"{len(out3)} tokens (GQA-8, rope 5e5, HF norm, q4 + int8 KV, head "
        f"dim {l3.d_head})")

    res = ranks(_path4, 1, n, cfg)
    got = np.concatenate([r[0] for r in res], axis=1)
    np.testing.assert_allclose(got, res[0][1], rtol=2e-4, atol=2e-4)
    say(f"dryrun_multichip path 4 OK (seq parallel): T={8 * n} sharded over "
        f"{n} ranks, ring attention == unsharded block")

    want, got6, sp, _ = _same(ranks(_path6_7, 1, n, cfg, "sp"), 6)
    if got6 != want or sp != n:
        raise AssertionError(f"path 6: sp={sp} {got6} != sp=1 {want}")
    say(f"dryrun_multichip path 6 OK (Engine sp={n} prefill): {len(got6)} "
        f"decoded tokens identical to sp=1")

    want, got7, sp, tp7 = _same(ranks(_path6_7, tp, dp, cfg, "sp_tp"), 7)
    want_p, got7p, sp_p, _ = _same(ranks(_path6_7, 1, n, cfg, "sp_paged"), 7)
    if got7 != want or got7p != want_p or (sp, tp7, sp_p) != (dp, tp, n):
        raise AssertionError(f"path 7: sp={sp} x tp={tp7} {got7}, paged "
                             f"sp={sp_p} {got7p}; single device {want}")
    say(f"dryrun_multichip path 7 OK (sp x tp prefill): sp={dp} x tp={tp} and "
        f"paged sp={n} both token-identical to the single-device engine")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="rank processes (JAX's n_devices)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the ranks on the CPU (default: the "
                         "card(s))")
    args = ap.parse_args(argv)
    if rank_device(0, args.device).type == "cuda":
        from tinyllama_tpu_torch.ops.kernels import build

        build.build_all()  # the ranks only load the libraries
    with RankPool(args.n, args.device) as pool:
        run_paths(pool, args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
