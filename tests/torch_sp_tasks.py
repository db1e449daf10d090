"""The rank side of tests/test_torch_sp.py: functions a rank process of
``parallel.mesh.RankPool`` runs, each ``fn(mesh, ...)`` through
``mesh.with_mesh``. They import the port only (no JAX), take the JAX
package's parameters as the numpy tree ``interop.params_from_numpy``
reads, and return numpy arrays and Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.parallel.ring import ring_gqa_attention
from tinyllama_tpu_torch.parallel.sp import sp_prefill_into_cache
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import kv_planes
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher


def ring(mesh, q, k, v, dtype="float32"):
    """ring_gqa_attention over this data rank's slice of the full [B, T,
    ., d] inputs; its [B, Tl, H, d] output as f32 numpy."""
    Tl = q.shape[1] // mesh.dp
    rows = slice(mesh.dp_rank * Tl, (mesh.dp_rank + 1) * Tl)
    dt = getattr(torch, dtype)
    out = ring_gqa_attention(*(torch.from_numpy(x[:, rows]).to(dt)
                               for x in (q, k, v)), mesh)
    return out.float().numpy()


def _engine(mesh, cfg, policy, tree, **kw) -> Engine:
    return Engine(cfg, policy, params_from_numpy(tree, cfg, policy),
                  device="cpu", mesh=mesh, **kw)


def _planes(cache) -> list[np.ndarray]:
    return [p.float().numpy() if p.dtype != torch.int8 else p.numpy()
            for p in kv_planes(cache)]


def sp_prefill(mesh, cfg, policy, tree, prompt, paged=False, max_ctx=None):
    """sp_prefill_into_cache on the engine's cache of one row: the logits
    and every plane of the cache after the handoff."""
    eng = _engine(mesh, cfg, policy, tree, paged=paged, max_ctx=max_ctx)
    cache = eng.new_cache(1)
    logits = sp_prefill_into_cache(eng.fwd_cfg, eng.policy, eng.params,
                                   prompt, eng.rope_tables, mesh, cache,
                                   eng.layer_ids, eng._tp)
    return logits.numpy(), _planes(cache)


def generate(mesh, cfg, policy, tree, prompt, gen, method="generate", **kw):
    """Engine(mesh).generate's (or generate_speculative's) tokens, the
    engine's sp and its chunk route."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    out, _ = getattr(eng, method)(prompt, gen)
    return out, eng.sp, eng.graph_stats["route"]


def generate_own_mesh(mesh, cfg, policy, tree, prompt, gen):
    """Engine(sp=, tp=) with no mesh passed (it makes its own, the same
    [dp, tp] grid as `mesh`): its tokens, sp and the mesh it holds."""
    eng = Engine(cfg, policy, params_from_numpy(tree, cfg, policy),
                 device="cpu", sp=mesh.dp, tp=mesh.tp)
    out, _ = eng.generate(prompt, gen)
    return out, eng.sp, eng.mesh is mesh


def raises(mesh, cfg, policy, tree, prompt, gen, **kw):
    """The ValueError Engine(mesh, **kw).generate raises, or None."""
    try:
        generate(mesh, cfg, policy, tree, prompt, gen, **kw)
    except ValueError as e:
        return str(e)
    return None


def batcher(mesh, cfg, policy, tree, prompts, max_new, gen, max_batch,
            threshold=None, **kw):
    """ContinuousBatcher over Engine(mesh): each request's tokens by
    submission order, and the batch size of every admission."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    waves = []
    prefill = eng.prefill

    def rec(cache, prompts_):
        waves.append(len(prompts_))
        return prefill(cache, prompts_)

    eng.prefill = rec
    b = ContinuousBatcher(eng, gen, max_batch=max_batch,
                          sp_admit_threshold=threshold)
    ids = [b.submit(p, max_new=max_new) for p in prompts]
    done = b.run()
    return [done[i].output for i in ids], waves, b.sp_admit_threshold


def collectives(mesh):
    """The data group's ring hop, all-gather and broadcast of
    rank-dependent values."""
    r = float(mesh.dp_rank)
    return (mesh.data_ring_shift(torch.full((2,), r)).tolist(),
            mesh.data_all_gather(torch.full((1, 2), r), 1).tolist(),
            mesh.data_broadcast(torch.full((3,), r), mesh.dp - 1).tolist(),
            mesh.broadcast_object(f"from {mesh.rank}"))


def card_sp_engine(mesh, cfg, prompt, n_new):
    """On the card (tests/test_torch_cuda.py): Engine(mesh) over q8 weights
    drawn there from seed 7; the prefill's logits (f32 numpy) and the
    launch counts of the prefill alone, then n_new greedy ids and the
    chunk's route."""
    from tinyllama_tpu_torch.config import GenerationConfig, POLICIES
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import flash_attention, qmatmul

    g = torch.Generator(mesh.device).manual_seed(7)
    params = llama.init_quantized_params(cfg, POLICIES["q8"], g, mesh.device,
                                         "cpu")
    eng = Engine(cfg, POLICIES["q8"], params, max_ctx=512, mesh=mesh)
    for c in (qmatmul.launches, flash_attention.launches):
        for k in c:
            c[k] = 0
    logits, _ = eng.prefill(eng.new_cache(1), [prompt])
    torch.cuda.synchronize()
    counts = {**qmatmul.launches, **flash_attention.launches}
    ids, _ = eng.generate(prompt, GenerationConfig(
        n_predict=len(prompt) + n_new, greedy=True, eos_token=-1))
    return (logits.float().cpu().numpy(), ids, counts,
            eng.graph_stats["route"])
