"""The rank side of tests/test_torch_dp.py: functions a rank process of
``parallel.mesh.RankPool`` runs, each ``fn(mesh, ...)`` through
``mesh.with_mesh``. They import the port only (no JAX), take the JAX
package's parameters as the numpy tree ``interop.params_from_numpy``
reads, and return numpy arrays and Python values.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher


def coords(mesh):
    """This rank's (dcn, data, model) coordinates, its batch rank and
    group size, the cube, the batch group's gather of this rank's number
    and rank 0's object."""
    return ((mesh.dcn_rank, mesh.dp_rank, mesh.tp_rank), mesh.batch_rank,
            mesh.batch, mesh.cube.tolist(),
            mesh.batch_all_gather(torch.tensor([mesh.rank]), 0).tolist(),
            mesh.broadcast_object(f"from {mesh.rank}"))


def _engine(mesh, cfg, policy, tree, **kw) -> Engine:
    return Engine(cfg, policy, params_from_numpy(tree, cfg, policy),
                  device="cpu", mesh=mesh, **kw)


def generate_batch(mesh, cfg, policy, tree, prompts, gen, **kw):
    """Engine(mesh).generate_batch's tokens (every row), this rank's
    prefill logits of the prompts, its batch rank and the rows its cache
    of the batch holds."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    out, _ = eng.generate_batch(prompts, gen)
    cache = eng.new_cache(len(prompts))
    logits, _ = eng.prefill(cache, prompts)
    rows = (cache.table if eng.paged else cache.k[0]).shape[0]
    return out, logits.numpy(), eng.batch_rank, rows


def engine_layout(mesh, cfg, policy, tree, **kw):
    """Engine(mesh, **kw)'s sp, batch group and batch rank, and the rows
    of its cache of a batch of 4."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    return eng.sp, eng.batch, eng.batch_rank, eng.new_cache(4).k.shape[1]


def generate(mesh, cfg, policy, tree, prompt, gen, **kw):
    """Engine(mesh).generate's tokens and the engine's batch group."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    out, _ = eng.generate(prompt, gen)
    return out, eng.batch


def raises(mesh, cfg, policy, tree, what, *args, **kw):
    """The ValueError Engine(mesh, **kw).<what>(*args) (or the engine
    itself, what=None) raises, or None."""
    try:
        eng = _engine(mesh, cfg, policy, tree, **kw)
        if what is not None:
            getattr(eng, what)(*args)
    except ValueError as e:
        return str(e)
    return None


def batcher(mesh, cfg, policy, tree, prompts, max_new, gen, max_batch,
            **kw):
    """ContinuousBatcher over Engine(mesh): each request's tokens by
    submission order (`max_new`: one budget, or one a request), the batch
    and this rank's first row of every admission's prefill, the rows of
    every chunk, and whether the batcher downshifts."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    shapes = {"prefill": [], "chunk": []}
    prefill, run_chunk = eng.prefill, eng.run_chunk

    def rec_prefill(cache, prompts_):
        shapes["prefill"].append((len(prompts_), eng.batch_rows(
            len(prompts_)).start))
        return prefill(cache, prompts_)

    def rec_chunk(cache, logits, *a, **k):
        shapes["chunk"].append(logits.shape[0])
        return run_chunk(cache, logits, *a, **k)

    eng.prefill, eng.run_chunk = rec_prefill, rec_chunk
    b = ContinuousBatcher(eng, gen, max_batch=max_batch)
    budgets = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    ids = [b.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    done = b.run()
    return [done[i].output for i in ids], shapes, b.downshift


def batcher_downshift(mesh, cfg, policy, tree, max_batch, **kw):
    """What ContinuousBatcher(downshift=True) over Engine(mesh) raises, or
    None."""
    eng = _engine(mesh, cfg, policy, tree, **kw)
    try:
        ContinuousBatcher(eng, max_batch=max_batch, downshift=True)
    except ValueError as e:
        return str(e)
    return None


def _own_rows(eng, ref, prompts, gen):
    """The dp engine's generate_batch (every row) and this rank's prefill
    logits, and the model group's own-rows engine's (`ref`, dp 1) on this
    rank's rows, with each generate_batch's launch counts on the card."""
    from tinyllama_tpu_torch.ops.kernels import (
        flash_attention, flash_paged, qmatmul,
    )

    counters = (qmatmul.launches, flash_attention.launches,
                flash_paged.launches)
    mine = prompts[eng.batch_rows(len(prompts))]
    out = []
    for e, ps in ((eng, prompts), (ref, mine)):
        logits, _ = e.prefill(e.new_cache(len(ps)), ps)
        for c in counters:
            for k in c:
                c[k] = 0
        ids, _ = e.generate_batch(ps, gen)
        out.append((ids, logits.float().cpu().numpy(),
                    {k: v for c in counters for k, v in c.items()}))
    return out


def own_rows(mesh, cfg, policy, tree, prompts, gen, **kw):
    """_own_rows over the JAX package's weights on the CPU."""
    params = params_from_numpy(tree, cfg, policy)
    eng = Engine(cfg, policy, params, device="cpu", mesh=mesh, **kw)
    ref = Engine(cfg, policy, params, device="cpu", mesh=mesh.model_mesh(),
                 **kw)
    return _own_rows(eng, ref, prompts, gen)


def card_dp_engine(mesh, cfg, kind, prompts, n_new, paged=False):
    """On the card (tests/test_torch_cuda.py): _own_rows over `kind`
    weights drawn there from seed 7 (kept in host memory), n_new greedy
    tokens; and the dp engine's chunk route."""
    from tinyllama_tpu_torch.config import GenerationConfig, POLICIES
    from tinyllama_tpu_torch.models import llama

    policy = POLICIES[kind]
    g = torch.Generator(mesh.device).manual_seed(7)
    params = llama.init_quantized_params(cfg, policy, g, mesh.device, "cpu")
    eng = Engine(cfg, policy, params, max_ctx=512, mesh=mesh, paged=paged)
    ref = Engine(cfg, policy, params, max_ctx=512, mesh=mesh.model_mesh(),
                 paged=paged)
    gen = GenerationConfig(n_predict=max(map(len, prompts)) + n_new,
                           greedy=True, eos_token=-1)
    return _own_rows(eng, ref, prompts, gen), eng.graph_stats["route"]


def card_dp_topk(mesh, cfg, prompts, n_new):
    """On the card: Engine(mesh)'s generate_batch of `prompts` at top-k
    40 (temperature 0.9, seed 17), q8 weights drawn there from seed 7."""
    from tinyllama_tpu_torch.config import GenerationConfig, POLICIES
    from tinyllama_tpu_torch.models import llama

    policy = POLICIES["q8"]
    g = torch.Generator(mesh.device).manual_seed(7)
    params = llama.init_quantized_params(cfg, policy, g, mesh.device, "cpu")
    eng = Engine(cfg, policy, params, max_ctx=512, mesh=mesh)
    gen = GenerationConfig(n_predict=max(map(len, prompts)) + n_new,
                           greedy=False, top_k=40, temperature=0.9, seed=17,
                           eos_token=-1)
    return eng.generate_batch(prompts, gen)[0]
