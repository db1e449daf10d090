"""The rank side of tests/test_torch_tp.py: functions a rank process of
``parallel.mesh.RankPool`` runs, each ``fn(mesh, ...)`` through
``mesh.with_mesh``. They import the port only (no JAX), take the JAX
package's parameters as the numpy tree ``interop.params_from_numpy``
reads, and return numpy arrays and Python values.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.parallel import tp as tpmod
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import init_cache
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher


def tp_step(mesh, cfg, policy, tree, tokens, pos, last, overlap=False):
    """The TP step (prefill logits of this rank's data row) and this
    rank's cache planes after it."""
    params = params_from_numpy(tree, cfg, policy)
    shard = tpmod.shard_params(params, cfg, mesh.tp, mesh.tp_rank, "cpu",
                               overlap)
    cache = init_cache(tpmod.local_config(cfg, mesh.tp),
                       tokens.shape[0] // mesh.dp, policy.kv_dtype)
    logits = tpmod.tp_step(cfg, policy, shard, cache,
                           torch.from_numpy(tokens), torch.from_numpy(pos),
                           torch.from_numpy(last), mesh, overlap=overlap)
    return logits.numpy(), cache.k.float().numpy(), cache.v.float().numpy()


def _engine(mesh, cfg, policy, tree, **kw) -> Engine:
    return Engine(cfg, policy, params_from_numpy(tree, cfg, policy),
                  device="cpu", mesh=mesh, **kw)


def generate(mesh, cfg, policy, tree, prompt, gen, **kw):
    """Engine(tp).generate's tokens, and the engine's chunk route."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    out, _ = eng.generate(prompt, gen)
    return out, eng.graph_stats["route"], tuple(eng.new_cache(1).k.shape)


def generate_batch(mesh, cfg, policy, tree, prompts, gen, **kw):
    out, _ = _engine(mesh, cfg, policy, tree, **kw).generate_batch(prompts,
                                                                   gen)
    return out


def batcher(mesh, cfg, policy, tree, prompts, gen, max_batch, max_new,
            **kw):
    """ContinuousBatcher over Engine(tp): each request's tokens, by id,
    and the pool's kv heads."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    b = ContinuousBatcher(eng, gen, max_batch=max_batch)
    for p in prompts:
        b.submit(p, max_new=max_new)
    done = b.run()
    heads = (b.pool if b.paged else b.cache).k.shape[2]
    return {i: r.output for i, r in done.items()}, heads


def speculative(mesh, cfg, policy, tree):
    """What Engine(tp).generate_speculative raises."""
    eng = _engine(mesh, cfg, policy, tree)
    try:
        eng.generate_speculative([1, 2, 3])
    except ValueError as e:
        return str(e)
    return None


def raise_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits in an all-reduce for it."""
    if mesh.tp_rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.all_reduce(torch.ones(4)).tolist()


def exit_on_rank_1(mesh):
    """Rank 1's process ends (code 3) while rank 0 is still at work."""
    if mesh.tp_rank == 1:
        os._exit(3)
    time.sleep(60)


def collectives(mesh):
    """all_reduce, ring_shift and all_gather of rank-dependent values."""
    r = float(mesh.tp_rank)
    return (mesh.all_reduce(torch.full((3,), r + 1)).tolist(),
            mesh.ring_shift(torch.full((2,), r)).tolist(),
            mesh.all_gather(torch.full((1, 2), r), 1).tolist(),
            mesh.broadcast_object(f"from {mesh.tp_rank}"),
            np.asarray(mesh.grid).tolist(), mesh.backend)
