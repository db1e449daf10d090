"""The port's serving path against the JAX package: the page pool, chunk
staging, the serving attention (K9-K11) and continuous batching.

Both packages get the same inputs, made from seeds with numpy: pools
and caches cross to the port through ``interop.cache_from_numpy``, q8
parameters through ``interop.params_from_numpy``. On the CPU the port's
kernel wrappers take their plain versions; the JAX side runs its Pallas
kernels in interpret mode, as its own tests do. At f32 the pools must be
equal after writes and flushes, the plain versions within rtol/atol 1e-4
of the JAX kernels at every step of a chunk, and greedy tokens identical.
"""

import ast
import collections
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.pallas.flash_paged import (
    flash_paged_attention as jax_flash_paged,
    flash_paged_staged_attention as jax_flash_paged_staged,
)
from tinyllama_tpu.ops.pallas.flash_prefill import (
    flash_staged_attention as jax_flash_staged,
)
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime import paged as jpaged
from tinyllama_tpu.runtime import staging as jstaging
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.cli import main as cli_main
from tinyllama_tpu_torch.interop import cache_from_numpy, params_from_numpy
from tinyllama_tpu_torch.ops.kernels import flash_attention, flash_paged
from tinyllama_tpu_torch.runtime import paged, staging
from tinyllama_tpu_torch.runtime.kvcache import KVCache
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: with the test
    workers sharing the host's cores, eight threads a worker each spin for
    the cores and the ops run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
JPOL = JaxPolicy("q8", "f32", "f32")
POL = pconfig.DtypePolicy("q8", "f32", "f32")
TOL = dict(rtol=1e-4, atol=1e-4)
L, Kh, d = CFG.n_layers, CFG.n_kv_heads, CFG.d_head

#: pools of the write, flush and kernel tests: 3 rows, max_ctx 256 in
#: 64-position pages, a 5-step chunk
B, S, P, C = 3, 256, 64, 5
J = S // P
#: chunk bases: two straddle a page boundary inside the chunk
BASES = {"straddle": [60, 33, 126], "limit": [S - 3, S - 5, 40]}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}


# --- shared inputs ------------------------------------------------------------


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def both_params():
    jp = jllama.init_quantized_params(JCFG, jax.random.PRNGKey(0), JPOL)
    return jp, params_from_numpy(_to_numpy(jp), CFG, POL)


def _table():
    return (1 + np.arange(B * J, dtype=np.int32)).reshape(B, J)[:, ::-1].copy()


def _pools(kind: str, kv: str, seed: int, fill: int = 140):
    """The same random pool for both packages: positions < fill of every
    row hold random values (a paged pool through a reversed table, so
    logical and physical page order differ; page 0 stays the scratch
    page). Returns (JAX pool, port pool)."""
    rng = np.random.default_rng(seed)
    if kind == "mono":
        shape = (L, B, Kh, S, d)
        k, v = (np.zeros(shape, np.float32) for _ in range(2))
        for a in (k, v):
            a[:, :, :, :fill] = rng.standard_normal((L, B, Kh, fill, d))
        jk, jv = (jnp.asarray(a, JNP[kv]) for a in (k, v))
        jpool = jkv.KVCache(k=jk, v=jv, k_scale=None, v_scale=None)
        return jpool, cache_from_numpy(np.asarray(jk), np.asarray(jv))
    shape = (L, 1 + B * J, Kh, P, d)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jk, jv = (jnp.asarray(a, JNP[kv]) for a in (k, v))
    table = _table()
    jpool = jpaged.PagedKVCache(k=jk, v=jv, k_scale=None, v_scale=None,
                                table=jnp.asarray(table))
    return jpool, cache_from_numpy(np.asarray(jk), np.asarray(jv), table)


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _step_kv(rng, T=1):
    return [rng.standard_normal((B, T, Kh, d)).astype(np.float32)
            for _ in range(2)]


# --- the page pool ------------------------------------------------------------


@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_paged_write_and_read_match_jax(kv):
    """update_paged_at_layer (a 9-token prefill from 0, single tokens at
    unaligned positions, across a page and past max_ctx) leaves the pool
    JAX leaves; paged_layer_view reads what JAX reads, trimmed or not."""
    jpool, ppool = _pools("paged", kv, seed=1)
    rng = np.random.default_rng(2)
    li = 1
    writes = [(np.zeros(B, np.int32), 9), (np.full(B, 9, np.int32), 1),
              (np.array([P - 1, P, P + 5], np.int32), 1),
              (np.array([S + 2, 3 * P, 17], np.int32), 1)]
    for pos, T in writes:
        k, v = _step_kv(rng, T)
        jpool = jpaged.update_paged_at_layer(
            jpool, jnp.int32(li), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos))
        paged.update_paged_at_layer(ppool, li, torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos))
    np.testing.assert_array_equal(_f32(ppool.k), _f32(jpool.k))
    np.testing.assert_array_equal(_f32(ppool.v), _f32(jpool.v))
    for bound in (None, 70):
        jk, jv = jpaged.paged_layer_view(jpool, jnp.int32(li), jnp.float32,
                                         bound)
        pk, pv = paged.paged_layer_view(ppool, li, torch.float32, bound)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_page_allocator():
    a = paged.PageAllocator(8)
    a.reserve(5)
    assert a.available == 3
    p = a.alloc(3)
    assert len(set(p)) == 3 and a.free_pages == 5
    assert not a.can_reserve(4)
    with pytest.raises(RuntimeError, match="over-committed"):
        a.reserve(4)
    a.reserve(3)
    q = a.alloc(2)
    a.release(p, 5)
    assert a.available == 5
    a.release(q, 3)
    assert a.available == 8 and a.free_pages == 8


def test_default_page_size():
    assert [paged.default_page_size(s) for s in (2048, 256, 128, 96, 64)] \
        == [256, 256, 128, 32, 64]
    with pytest.raises(ValueError):
        paged.default_page_size(12)


# --- staging ------------------------------------------------------------------


def _staged_pair(kind, kv, bases, seed):
    jpool, ppool = _pools(kind, kv, seed)
    base = np.asarray(bases, np.int32)
    return (jstaging.stage_cache(jpool, jnp.asarray(base), C),
            staging.stage_cache(ppool, torch.from_numpy(base), C), base)


@pytest.mark.parametrize("case", list(BASES))
@pytest.mark.parametrize("kind", ["mono", "paged"])
def test_stage_update_flush_match_jax(kind, case):
    """C staged steps in both layers, then the flush: the port's pool
    equals JAX's at bf16, with chunks that straddle pages and chunks that
    run past max_ctx (whose flush keeps to max_ctx)."""
    jst, pst, base = _staged_pair(kind, "bf16", BASES[case], seed=3)
    rng = np.random.default_rng(4)
    for t in range(C):
        pos = base + t
        pst = pst.at_step(torch.from_numpy(pos))
        for li in range(L):
            k, v = _step_kv(rng)
            jst = jstaging.update_staged_at_layer(
                jst, jnp.int32(li), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(pos))
            staging.update_staged_at_layer(pst, li, torch.from_numpy(k),
                                           torch.from_numpy(v))
    np.testing.assert_array_equal(_f32(pst.sk[:, :, :, :C]),
                                  _f32(jst.sk[:, :, :, :C]))
    jflushed = jstaging.flush_staged(jst, C)
    pflushed = staging.flush_staged(pst, C)
    np.testing.assert_array_equal(_f32(pflushed.k), _f32(jflushed.k))
    np.testing.assert_array_equal(_f32(pflushed.v), _f32(jflushed.v))


def test_staging_refuses_a_prefill():
    _, pst, base = _staged_pair("mono", "f32", BASES["straddle"], seed=5)
    k = torch.zeros(B, 2, Kh, d)
    with pytest.raises(ValueError, match="T == 1"):
        staging.update_staged_at_layer(pst.at_step(torch.from_numpy(base)), 0,
                                       k, k)
    with pytest.raises(ValueError, match="at_step"):
        staging.update_staged_at_layer(pst, 0, k[:, :1], k[:, :1])


# --- the serving attention: K9, K10, K11 ---------------------------------------


@pytest.mark.parametrize("kind", ["mono", "paged"])
def test_staged_attention_matches_jax_kernels(kind):
    """K9 (monolithic) and K11 (paged): the port's plain version against
    the JAX kernel in interpret mode, at f32, at every step of a chunk
    whose rows straddle pages."""
    jst, pst, base = _staged_pair(kind, "f32", BASES["straddle"], seed=6)
    jfn = jax_flash_staged if kind == "mono" else jax_flash_paged_staged
    pfn = (flash_attention.flash_staged_attention if kind == "mono"
           else flash_paged.flash_paged_staged_attention)
    rng = np.random.default_rng(7)
    li = 1
    for t in range(C):
        pos = base + t
        k, v = _step_kv(rng)
        q = rng.standard_normal((B, 1, CFG.n_heads, d)).astype(np.float32)
        jst = jstaging.update_staged_at_layer(
            jst, jnp.int32(li), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        pst = pst.at_step(torch.from_numpy(pos))
        staging.update_staged_at_layer(pst, li, torch.from_numpy(k),
                                       torch.from_numpy(v))
        want = jfn(jnp.asarray(q), jst, jnp.int32(li), jnp.asarray(pos),
                   interpret=True)
        got = pfn(torch.from_numpy(q), pst, torch.tensor([li], dtype=torch.int32),
                  torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")


def test_paged_attention_matches_jax_kernel():
    """K10: the port's plain version against the JAX kernel in interpret
    mode, at f32, at every step of a chunk of single-token writes across
    a page boundary."""
    jpool, ppool = _pools("paged", "f32", seed=8)
    rng = np.random.default_rng(9)
    li = 0
    base = np.array([P - 2, 3, 2 * P - 1], np.int32)
    for t in range(C):
        pos = base + t
        k, v = _step_kv(rng)
        q = rng.standard_normal((B, 1, CFG.n_heads, d)).astype(np.float32)
        jpool = jpaged.update_paged_at_layer(
            jpool, jnp.int32(li), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        paged.update_paged_at_layer(ppool, li, torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos))
        want = jax_flash_paged(jnp.asarray(q), jpool, jnp.int32(li),
                               jnp.asarray(pos), interpret=True)
        got = flash_paged.flash_paged_attention(
            torch.from_numpy(q), ppool, torch.tensor([li], dtype=torch.int32),
            torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")


def test_serving_wrappers_take_the_plain_path_on_cpu(monkeypatch):
    """On CPU tensors K9-K11's wrappers never build or launch a kernel:
    they return their plain versions' results and count no launch."""
    from tinyllama_tpu_torch.ops.kernels import build

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    before = {**flash_attention.launches, **flash_paged.launches}
    _, mono, base = _staged_pair("mono", "bf16", BASES["straddle"], seed=10)
    _, pool, _ = _staged_pair("paged", "bf16", BASES["straddle"], seed=10)
    q = torch.randn(B, 1, CFG.n_heads, d, dtype=torch.bfloat16)
    li, pos = torch.tensor([1], dtype=torch.int32), torch.from_numpy(base)
    for got, want in (
            (flash_attention.flash_staged_attention(q, mono, li, pos),
             flash_paged.staged_attention_ref(q, mono, li, pos)),
            (flash_paged.flash_paged_staged_attention(q, pool, li, pos),
             flash_paged.staged_attention_ref(q, pool, li, pos)),
            (flash_paged.flash_paged_attention(q, pool.pool, li, pos),
             flash_paged.paged_attention_ref(q, pool.pool, li, pos))):
        torch.testing.assert_close(got, want)
    assert {**flash_attention.launches, **flash_paged.launches} == before
    with pytest.raises(TypeError, match="page pool"):
        flash_paged.flash_paged_staged_attention(q, mono, li, pos)
    with pytest.raises(TypeError, match="monolithic"):
        flash_attention.flash_staged_attention(q, pool, li, pos)


# --- the engine -----------------------------------------------------------------


def _prompt(n, seed):
    return [1] + np.random.default_rng(seed).integers(2, CFG.n_vocab,
                                                      n - 1).tolist()


def test_generate_batch_matches_jax_pallas(both_params):
    """Greedy f32 tokens of the staged batched decode (K9 on the card)
    equal JAX ``Engine(use_pallas=True).generate_batch``: 3 rows of
    staggered lengths, 6-step chunks."""
    jp, pp = both_params
    prompts = [_prompt(n, n) for n in (5, 12, 20)]
    gen = dict(n_predict=40, greedy=True, eos_token=-1, chunk_size=6)
    jout, _ = JaxEngine(JCFG, JPOL, jp, max_batch=3, use_pallas=True
                        ).generate_batch(prompts, JaxGen(**gen))
    pout, stats = Engine(CFG, POL, pp, device="cpu").generate_batch(
        prompts, pconfig.GenerationConfig(**gen))
    assert [len(o) for o in pout] == [35, 28, 20]
    assert pout == [[int(t) for t in o] for o in jout]
    assert stats.decode_steps == 36


def test_paged_generate_matches_jax_pallas(both_params):
    """Greedy f32 tokens of ``Engine(paged=True).generate`` (the paged
    prefill's own-key attention, then K10 each step) equal JAX's paged
    engine with Pallas, and the port's monolithic generate."""
    jp, pp = both_params
    prompt = _prompt(24, 3)
    gen = dict(n_predict=24 + 20, greedy=True, eos_token=-1, chunk_size=8)
    jout, _ = JaxEngine(JCFG, JPOL, jp, paged=True, use_pallas=True
                        ).generate(prompt, JaxGen(**gen))
    pgen = pconfig.GenerationConfig(**gen)
    pout, _ = Engine(CFG, POL, pp, device="cpu", paged=True).generate(prompt,
                                                                       pgen)
    mono, _ = Engine(CFG, POL, pp, device="cpu").generate(prompt, pgen)
    assert len(pout) == 20
    assert pout == [int(t) for t in jout] == mono


@pytest.mark.parametrize("paged_cache", [False, True])
def test_generate_batch_at_context_limit(both_params, paged_cache):
    """Whole chunks run past max_ctx on the longer row: the staged B = 2
    chunks equal the unstaged B = 1 generate of each prompt token for
    token, up to max_ctx, on both pool kinds."""
    _, pp = both_params
    cfg = CFG.replace(max_ctx=64)
    prompts = [[3, 7, 1], [5, 2, 9, 4, 8, 6, 6, 1, 2]]
    gen = pconfig.GenerationConfig(n_predict=64, greedy=True, eos_token=-1,
                                   chunk_size=16)
    eng = Engine(cfg, POL, pp, device="cpu", paged=paged_cache)
    staged = eng.generate_batch(prompts, gen)[0]
    assert [len(o) for o in staged] == [61, 55]
    assert staged == [eng.generate(p, gen)[0] for p in prompts]


def test_paged_prefill_must_start_at_zero(both_params):
    """The paged prefill attends only its own keys: without the host's
    word that it starts at position 0 (from_zero) it raises; with it, it
    gives the monolithic prefill's hidden states."""
    _, pp = both_params
    from tinyllama_tpu_torch.models import llama

    eng = Engine(CFG, POL, pp, device="cpu", paged=True)
    toks = torch.tensor([[1, 2, 3, 4]])
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="position 0"):
        llama.forward(CFG, POL, eng.params, toks, eng.new_cache(1), zero)
    got = llama.forward(CFG, POL, eng.params, toks, eng.new_cache(1), zero,
                        from_zero=True)
    mono = Engine(CFG, POL, pp, device="cpu")
    want = llama.forward(CFG, POL, mono.params, toks, mono.new_cache(1), zero)
    torch.testing.assert_close(got, want)


# --- continuous batching --------------------------------------------------------


GEN = dict(n_predict=24, greedy=True, eos_token=-1, chunk_size=8)
PROMPTS = [[3, 7, 1], [9, 2, 4, 8, 5], [11, 6], [1, 2, 3, 4], [5, 5, 5]]


@pytest.fixture(scope="module")
def engines(both_params):
    jp, pp = both_params
    return (JaxEngine(JCFG, JPOL, jp, max_batch=2, use_pallas=False),
            {paged: Engine(CFG, POL, pp, device="cpu", paged=paged)
             for paged in (False, True)})


@pytest.fixture(scope="module")
def sequential(engines):
    _, pengs = engines
    gen = pconfig.GenerationConfig(**GEN)
    return [pengs[False].generate(p, gen)[0] for p in PROMPTS]


#: (paged, pool) of each batcher: the pool's n_pages and page_size
BATCHERS = {"mono": (False, {}),
            "paged": (True, dict(n_pages=7, page_size=16)),
            "paged-full-pool": (True, dict(page_size=16))}


@pytest.mark.parametrize("kind", list(BATCHERS))
def test_batcher_matches_sequential_and_jax(engines, sequential, kind):
    """5 requests through 2 slots (slot reuse; paged: a 7-page pool of
    16-position pages forces queueing and page recycling; full pool: the
    default pool, one max_ctx run of pages a slot): the outputs equal the
    port's sequential generate and the JAX batcher's."""
    jeng, pengs = engines
    is_paged, kw = BATCHERS[kind]
    jb = JaxBatcher(jeng, JaxGen(**GEN), max_batch=2, paged=is_paged, **kw)
    pb = ContinuousBatcher(pengs[is_paged], pconfig.GenerationConfig(**GEN),
                           max_batch=2, **kw)
    jids = [jb.submit(p) for p in PROMPTS]
    pids = [pb.submit(p) for p in PROMPTS]
    jres, pres = jb.run(), pb.run()
    for i, (jr, pr) in enumerate(zip(jids, pids)):
        assert pres[pr].output == sequential[i], f"prompt {i}"
        assert pres[pr].output == [int(t) for t in jres[jr].output]
        assert pres[pr].done and pres[pr].first_token_s is not None
    if is_paged:
        assert pb.alloc.free_pages == pb.alloc.available \
            == pb.alloc.n_pages - 1


def test_batcher_downshift_and_late_arrivals(both_params):
    """Paged, 4 slots: one request runs alone until the chunk bucket shrinks
    to 1, then 4 late arrivals grow it back to 4 and finish at staggered
    lengths (bucket 4, 2, 1 again): every output equals the port's
    sequential generate and the JAX batcher's, step for step."""
    jp, pp = both_params
    gen = dict(n_predict=30, greedy=True, eos_token=-1, chunk_size=4)
    prompts = [[3, 7, 1], [9, 2, 4, 8, 5], [11, 6], [1, 2, 3, 4], [5, 5, 5]]
    max_news = [27, 3, 7, 21, 12]
    pgen = pconfig.GenerationConfig(**gen)
    mono = Engine(CFG, POL, pp, device="cpu")
    want = [mono.generate(p, pgen)[0][:n] for p, n in zip(prompts, max_news)]
    jb = JaxBatcher(JaxEngine(JCFG, JPOL, jp, max_batch=4, use_pallas=False),
                    JaxGen(**gen), max_batch=4, paged=True, page_size=16)
    pb = ContinuousBatcher(Engine(CFG, POL, pp, device="cpu", paged=True),
                           pgen, max_batch=4, page_size=16)
    buckets = []
    outs = []
    for b in (jb, pb):
        ids = [b.submit(prompts[0], max_new=max_news[0])]
        for _ in range(3):
            b.step()
        ids += [b.submit(p, max_new=n) for p, n in zip(prompts[1:],
                                                       max_news[1:])]
        seen = [b._bucket]
        while b.has_work:
            b.step()
            seen.append(b._bucket)
        buckets.append(seen)
        outs.append([[int(t) for t in b.results[i].output] for i in ids])
    assert outs[0] == outs[1] == want
    assert buckets[0] == buckets[1]
    assert buckets[1][0] == 1 and 4 in buckets[1] and 2 in buckets[1]
    assert pb.alloc.free_pages == pb.alloc.n_pages - 1


def test_batcher_submit_and_options_refused(engines):
    """An oversize request and a pool's sizes given to the batcher of a
    monolithic engine (its cache follows the engine's kind) are refused.
    The SP admission threshold (ported since sequence parallelism) is
    taken, and off by default over an engine at sp 1."""
    _, pengs = engines
    pb = ContinuousBatcher(pengs[True], pconfig.GenerationConfig(**GEN),
                           max_batch=2, n_pages=3, page_size=16)
    with pytest.raises(ValueError, match="pool holds 2"):
        pb.submit(list(range(1, 40)))
    pb.submit([1, 2, 3], max_new=8)
    assert pb.sp_admit_threshold is None
    assert ContinuousBatcher(pengs[False], max_batch=2,
                             sp_admit_threshold=64).sp_admit_threshold == 64
    with pytest.raises(ValueError, match="paged=True"):
        ContinuousBatcher(pengs[False], max_batch=2, n_pages=3, page_size=16)
    mono = ContinuousBatcher(pengs[False], max_batch=2)
    assert not mono.paged and isinstance(mono.cache, KVCache)


def test_batcher_streams_and_respects_max_new(engines):
    _, pengs = engines
    pb = ContinuousBatcher(pengs[False], pconfig.GenerationConfig(**GEN),
                           max_batch=2)
    r0, r1 = pb.submit(PROMPTS[0], max_new=5), pb.submit(PROMPTS[1])
    seen = {r0: [], r1: []}
    res = pb.run(stream=lambda rid, tok: seen[rid].append(tok))
    assert len(res[r0].output) == 5 and seen[r0] == res[r0].output
    assert seen[r1] == res[r1].output
    assert res[r1].finished_s >= res[r1].first_token_s >= res[r1].submitted_s


# --- branch choice, CLI and hygiene ---------------------------------------------


#: the plain version behind each kernel; the spy counts their calls.
SPIED = [
    ("qmatmul", "qmatmul_ref", lambda x, *a, **k: "K1" if x.reshape(
        -1, x.shape[-1]).shape[0] <= 8 else "K2"),
    ("flash_attention", "attention_ref",
     lambda q, *a, **k: "K4" if q.shape[1] == 1 else "K3"),
    ("decode_fused", "fused_norm_qkv_ref", lambda *a, **k: "K5"),
    ("decode_fused", "fused_out_residual_ref", lambda *a, **k: "K6"),
    ("ffn_fused", "ffn_fused_ref", lambda *a, **k: "K7"),
    ("attn_out_fused", "fused_attn_out_ref", lambda *a, **k: "K8"),
    ("flash_paged", "staged_attention_ref",
     lambda q, st, *a, **k: "K11" if st.paged else "K9"),
    ("flash_paged", "paged_attention_ref", lambda *a, **k: "K10"),
]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the kernels a CPU run reaches, by the calls of their
    plain versions."""
    calls = collections.Counter()
    for mod_name, fn_name, which in SPIED:
        mod = importlib.import_module(f"tinyllama_tpu_torch.ops.kernels.{mod_name}")
        real = getattr(mod, fn_name)

        def spy(*a, _real=real, _which=which, **k):
            calls[_which(*a, **k)] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn_name, spy)
    return calls


@pytest.mark.parametrize("kind", ["mono", "paged"])
def test_serving_branch_counts(both_params, kernel_calls, kind):
    """Exact kernel counts at L = 2. A staged chunk at B = 2 runs K5, K9
    (monolithic) or K11 (paged), K6, K7 a layer-step and K1 a step; a
    paged b1 generate runs its short prefill as K5, K3, K6, K7 and each
    step as K5, K10, K6, K7 (no K8); the monolithic b1 generate keeps
    K8."""
    _, pp = both_params
    is_paged = kind == "paged"
    eng = Engine(CFG, POL, pp, device="cpu", paged=is_paged)
    gen = pconfig.GenerationConfig(greedy=True, eos_token=-1)
    cache = eng.new_cache(2)
    logits, lens = eng.prefill(cache, [[1, 5, 9], [1, 2, 3, 4, 5]])
    kernel_calls.clear()
    eng.chunk(cache, logits, torch.from_numpy(lens.astype(np.int32)), 3, gen)
    staged = "K11" if is_paged else "K9"
    assert dict(kernel_calls) == {"K5": 3 * L, staged: 3 * L, "K6": 3 * L,
                                  "K7": 3 * L, "K1": 3}
    kernel_calls.clear()
    eng.generate([1, 5, 9, 33, 70], pconfig.GenerationConfig(
        n_predict=9, greedy=True, eos_token=-1, chunk_size=2))
    attend = {"K10": 4 * L, "K6": 5 * L} if is_paged else {"K8": 4 * L,
                                                          "K6": L}
    assert dict(kernel_calls) == {"K5": 5 * L, "K3": L, "K7": 5 * L,
                                  "K1": 5, **attend}


def test_cli_paged_runs_on_cpu(capsys):
    assert cli_main(["--random-weights", "--model", "tiny-test", "-p", "hello",
                     "-greedy", "--npred", "12", "--device", "cpu",
                     "--paged"]) == 0
    captured = capsys.readouterr()
    assert len(captured.err.split()) == 12 - 6
    assert "Throughput" in captured.out


PKG = Path(__file__).resolve().parents[1] / "tinyllama_tpu_torch"
SERVING_MODULES = ["runtime/paged.py", "runtime/staging.py",
                   "runtime/scheduler.py", "ops/kernels/flash_paged.py",
                   "interop.py", "runtime/graphs.py"]


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_import_no_jax(module):
    """The serving modules import neither JAX nor the JAX package."""
    tree = ast.parse((PKG / module).read_text())
    tops = {alias.name.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.Import) for alias in node.names}
    tops |= {node.module.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module}
    assert not tops & {"jax", "jaxlib", "tinyllama_tpu"}, tops
    assert (PKG / "csrc" / "decode_split.cu").exists()
