"""The port's tensor parallelism (parallel/mesh.py, parallel/tp.py,
``Engine(tp=)``, the batcher over a TP engine and the CLI's ``--tp``)
against the JAX package's shard_map TP on its 8 virtual CPU devices.

One pool of 4 gloo rank processes on the CPU (one torch thread each)
serves the whole file; its grids are (tp 2, dp 1) on ranks 0-1, (4, 1)
and (2, 2). The rank side lives in tests/torch_tp_tasks.py (no JAX).
JAX's parameters cross to the ranks as numpy (interop.params_from_numpy);
every rank shards them itself.

Tolerance of the TP step at f32 (f32 activations and KV): the port's
logits within rtol 1e-5 and atol 1e-5 of max |logits| of JAX's
``make_tp_step`` and of JAX's single-device step; the gathered cache
within the same of max |cache|, the q4 case against JAX's Pallas kernels
in interpret mode too. (The sums differ only in order: the rank's
partial products, then the all-reduce.) Greedy tokens are held equal,
and every rank's results bit-equal.
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_tasks as tasks
from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.rope import rope_table as jax_rope_table
from tinyllama_tpu.parallel import tp as jtp
from tinyllama_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.kvcache import init_cache as jax_init_cache
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import gather_tp_planes, params_from_numpy
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.parallel import tp as ptp
from tinyllama_tpu_torch.parallel.mesh import (
    RankError,
    RankPool,
    backend_for,
    run_ranks,
    with_mesh,
)
from tinyllama_tpu_torch.quant import codec as pcodec
from tinyllama_tpu_torch.runtime import graphs
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher

SHAPE = dict(n_heads=8, n_kv_heads=4, n_embd=256, n_ffn=512)
JCFG, CFG = jax_tiny(**SHAPE), pconfig.tiny_test_config(**SHAPE)
#: q4g needs its row-parallel d_in in whole pack groups a rank (one layer:
#: the guard and the permutation read shapes and rows, not depth)
Q4G_SHAPE = dict(n_heads=4, n_kv_heads=2, n_embd=512, n_ffn=1024, n_layers=1)
STEP_RTOL = STEP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu", timeout=120, threads=1) as p:
        yield p


def run(pool, fn, tp, dp, *args, **kwargs):
    """fn on the [dp, tp] grid of the pool; the results of its ranks."""
    out = pool.run(with_mesh, fn, tp, dp, "cpu", *args, **kwargs)
    return out[: tp * dp]


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


_params: dict = {}


def jax_params(wdtype, kv="f32", shape=None, seed=0):
    """(JAX params, their numpy tree, JAX policy, port policy, port cfg)
    of `wdtype` weights at f32 activations, made once a key."""
    key = (wdtype, kv, tuple(sorted((shape or SHAPE).items())), seed)
    if key not in _params:
        jcfg = jax_tiny(**(shape or SHAPE))
        jpol, ppol = JaxPolicy(wdtype, "f32", kv), pconfig.DtypePolicy(
            wdtype, "f32", kv)
        dense = jllama.init_dense_params(jcfg, jax.random.PRNGKey(seed),
                                         jnp.float32)
        jp = jllama.convert_params(dense, jpol)
        _params[key] = (jp, _to_numpy(jp), jpol, ppol,
                        pconfig.tiny_test_config(**(shape or SHAPE)))
    return _params[key]


def same_on_ranks(results):
    """Every rank's result, bit for bit; returns rank 0's."""
    first = results[0]
    for r in results[1:]:
        assert _equal(r, first), "ranks differ"
    return first


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


# ----------------------------------------------------------------------------
# the plan: local_config, the permutation, the q4g guard, the shards
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name,tp", [("tiny", 2), ("tiny", 4),
                                     ("tinyllama", 2), ("tinyllama", 4),
                                     ("llama-3-8b", 2)])
def test_local_config_matches_jax(name, tp):
    from tinyllama_tpu.config import MODEL_REGISTRY as JREG

    jcfg = JCFG if name == "tiny" else JREG[
        "tinyllama-1.1b-chat-v0.4" if name == "tinyllama" else name]
    pcfg = CFG if name == "tiny" else pconfig.MODEL_REGISTRY[
        "tinyllama-1.1b-chat-v0.4" if name == "tinyllama" else name]
    want, got = jtp.local_config(jcfg, tp), ptp.local_config(pcfg, tp)
    for field in ("n_heads", "n_kv_heads", "n_ffn", "head_dim", "n_embd",
                  "n_layers", "n_vocab", "max_ctx"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.d_head == want.d_head and got.kv_dim == want.kv_dim


def test_local_config_refuses_a_tp_that_splits_a_head():
    with pytest.raises(ValueError, match="must divide"):
        ptp.local_config(CFG, 3)


@pytest.mark.parametrize("kind,tp", [("q8", 2), ("q8", 4), ("q4", 2),
                                     ("q4", 4), ("q4g", 2)])
def test_permuted_weights_bit_equal_to_jax(kind, tp):
    """Dequantized, the port's permuted wqkv and w_gateup are JAX's bit
    for bit (the port's own packing commutes with the permutation)."""
    shape = Q4G_SHAPE if kind == "q4g" else SHAPE
    jp, tree, _, ppol, pcfg = jax_params(kind, shape=shape)
    got = ptp.tp_permute_params(params_from_numpy(tree, pcfg, ppol), pcfg, tp)
    # JAX's permuted planes, carried across (the port's dequantize is
    # JAX's bit for bit: tests/test_torch_quant4.py)
    want = params_from_numpy(
        _to_numpy(jtp.tp_permute_params(jp, jax_tiny(**shape), tp)), pcfg, ppol)
    for name in ("wqkv", "w_gateup"):  # the permuted ones
        w = pcodec.dequantize(want["layers"][name]).numpy()
        g = pcodec.dequantize(got["layers"][name]).numpy()
        assert g.shape == w.shape and np.array_equal(g.view(np.uint32),
                                                     w.view(np.uint32)), name


def test_q4g_guard_refuses_what_jax_refuses():
    """A q4g row-parallel weight whose local d_in splits the JAX pack
    group: JAX's test case (w_down K = 768, tp = 2) is refused by both,
    its aligned case accepted by both."""
    bad = dict(n_embd=256, n_ffn=768, n_heads=4, n_kv_heads=2, n_layers=1)
    for shape, refused in ((bad, True), (Q4G_SHAPE, False)):
        jp, tree, _, ppol, pcfg = jax_params("q4g", shape=shape)
        pp = params_from_numpy(tree, pcfg, ppol)
        for fn, params, cfg in ((jtp.tp_permute_params, jp, jax_tiny(**shape)),
                                (ptp.tp_permute_params, pp, pcfg)):
            if refused:
                with pytest.raises(ValueError, match="pack group"):
                    fn(params, cfg, 2)
            else:
                fn(params, cfg, 2)
        if refused:  # and so does every route that shards
            with pytest.raises(ValueError, match="pack group"):
                ptp.shard_params(pp, pcfg, 2, 0)


def test_q4g_guard_refuses_tinyllama_at_tp4():
    """TinyLlama's w_down (K = 5,632, pack group 256) at tp = 4: a local
    K of 1,408 splits a group (one layer at full width); tp = 2 shards."""
    cfg = pconfig.TINYLLAMA_1_1B.replace(n_layers=1, n_vocab=512)
    params = llama.init_quantized_params(cfg, pconfig.POLICIES["q4g"],
                                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pack group 256"):
        ptp.tp_permute_params(params, cfg, 4)
    shard = ptp.shard_params(params, cfg, 2, 1)
    assert shard["layers"]["w_down"].shape == (1, 2048, 2816)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", ["f32", "q4"])
def test_shards_reassemble_the_permuted_weights(kind, overlap):
    """The ranks' column shards, concatenated, are the permuted wqkv and
    w_gateup; their row shards the whole wo and w_down (chunk-stacked
    [L * tp, .., N / tp] with overlap); the rest is whole on every rank."""
    tp = 2
    _, tree, _, ppol, pcfg = jax_params(kind)
    params = params_from_numpy(tree, pcfg, ppol)
    perm = ptp.tp_permute_params(params, pcfg, tp)
    shards = [ptp.shard_params(params, pcfg, tp, r, overlap=overlap)
              for r in range(tp)]

    def dense(w):  # [L, K, N] values (dense weights are [L, N, K])
        return (pcodec.dequantize(w) if isinstance(w, pcodec.QTensor)
                else w.transpose(-1, -2))

    for name in ("wqkv", "w_gateup"):
        got = torch.cat([dense(s["layers"][name]) for s in shards], -1)
        assert torch.equal(got, dense(perm["layers"][name])), name
    L = pcfg.n_layers
    for name in ("wo", "w_down"):
        parts = [dense(s["layers"][name]) for s in shards]
        if overlap:  # [L * tp, K / tp, N / tp]: layer li's chunk j at li*tp+j
            parts = [torch.stack([torch.cat([p[li * tp + j] for j in range(tp)],
                                            -1) for li in range(L)])
                     for p in parts]
        assert torch.equal(torch.cat(parts, -2), dense(params["layers"][name]))
    for s in shards:
        assert torch.equal(s["norm"], params["norm"])
        assert torch.equal(dense(s["lm_head"]), dense(params["lm_head"]))


# ----------------------------------------------------------------------------
# the TP step against JAX's make_tp_step and its single-device step
# ----------------------------------------------------------------------------

def _jax_steps(wdtype, tp, dp, use_pallas=False, seed=0):
    """JAX's make_tp_step and single-device logits and cache.k for B = dp
    rows of 6 tokens (the JAX test's inputs)."""
    jp, _, jpol, _, _ = jax_params(wdtype, seed=seed)
    ropes = jax_rope_table(JCFG.max_ctx, JCFG.d_head, JCFG.rope_theta)
    B, T = dp, 6
    tokens = jnp.tile(jnp.arange(2, 2 + T, dtype=jnp.int32)[None], (B, 1))
    pos = jnp.zeros((B,), jnp.int32)
    last = jnp.full((B,), T - 1, jnp.int32)
    hidden, single_cache = jllama.forward(
        JCFG, jpol, jp, tokens, jax_init_cache(JCFG, B, jpol.kv_dtype), pos,
        ropes)
    h_last = jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0]
    single = np.asarray(jllama.lm_head_logits(jp, h_last))
    mesh = jax_make_mesh(tp=tp, dp=dp)
    tparams = jtp.tp_permute_params(jp, JCFG, tp)
    tparams = jtp.place(mesh, tparams, jtp.param_partition_specs(tparams))
    cache = jax_init_cache(JCFG, B, jpol.kv_dtype)
    cache = jtp.place(mesh, cache, jtp.cache_partition_specs(cache))
    step = jtp.make_tp_step(JCFG, jpol, mesh, ropes, use_pallas, tparams,
                            cache)
    logits, tcache = step(tparams, cache, tokens, pos, last)
    return (np.asarray(tokens), np.asarray(pos), np.asarray(last),
            np.asarray(logits), np.asarray(tcache.k), single,
            np.asarray(single_cache.k))


def _port_step(pool, wdtype, tp, dp, tokens, pos, last, overlap=False,
               seed=0):
    _, tree, _, ppol, pcfg = jax_params(wdtype, seed=seed)
    out = run(pool, tasks.tp_step, tp, dp, pcfg, ppol, tree, tokens, pos,
              last, overlap=overlap)
    for d in range(dp):  # a model row's logits agree bit for bit
        same_on_ranks([o[0] for o in out[d * tp:(d + 1) * tp]])
    logits = np.concatenate([out[d * tp][0] for d in range(dp)])
    k = gather_tp_planes([o[1] for o in out], tp, dp)
    return logits, k


def _close(got, want, rtol=STEP_RTOL, atol=STEP_ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


@pytest.mark.parametrize("wdtype", ["f32", "q8"])
@pytest.mark.parametrize("tp,dp", [(2, 1), (4, 1), (2, 2)])
def test_tp_step_matches_jax(pool, wdtype, tp, dp):
    tokens, pos, last, jlogits, jk, single, single_k = _jax_steps(wdtype, tp,
                                                                  dp)
    logits, k = _port_step(pool, wdtype, tp, dp, tokens, pos, last)
    assert logits.shape == jlogits.shape and k.shape == jk.shape
    _close(logits, jlogits)
    _close(logits, single)
    _close(k, jk)
    _close(k, single_k)


def test_tp_step_overlap_matches_psum(pool):
    tokens, pos, last, jlogits, _, _, _ = _jax_steps("q8", 4, 1)
    got, _ = _port_step(pool, "q8", 4, 1, tokens, pos, last, overlap=True)
    _close(got, jlogits)


def test_tp_step_q4_against_jax_pallas_interpret(pool):
    """JAX's TP step with its Pallas kernels (interpret mode on the CPU
    mesh), as test_tp_step_runs_pallas_kernels runs it, against the
    port's ranks (the kernels' plain versions on the CPU)."""
    tokens, pos, last, jlogits, jk, _, _ = _jax_steps("q4", 2, 1,
                                                      use_pallas=True, seed=3)
    logits, k = _port_step(pool, "q4", 2, 1, tokens, pos, last, seed=3)
    assert np.isfinite(jlogits).all()
    _close(logits, jlogits)
    _close(k, jk)


# ----------------------------------------------------------------------------
# the engine, the batcher and the CLI over TP
# ----------------------------------------------------------------------------

GEN = dict(n_predict=24, greedy=True, eos_token=-2, chunk_size=4)
PROMPT = list(range(2, 12))


def _port_single(wdtype, kv, method, *args, seed=0, **kw):
    _, tree, _, ppol, pcfg = jax_params(wdtype, kv, seed=seed)
    eng = Engine(pcfg, ppol, params_from_numpy(tree, pcfg, ppol),
                 device="cpu", **kw)
    return getattr(eng, method)(*args)[0]


@pytest.mark.parametrize("kv", ["f32", "i8"])
def test_engine_tp2_generate_matches_jax_and_tp1(pool, kv):
    """Engine(tp=2).generate: JAX Engine(tp=2)'s greedy tokens and the
    port's Engine(tp=1)'s (test_engine_tp_generate_matches_single), the
    same on both ranks; each rank's cache holds its kv heads."""
    jp, tree, jpol, ppol, pcfg = jax_params("q8", kv, seed=5)
    want, _ = JaxEngine(JCFG, jpol, jp, tp=2, mesh=jax_make_mesh(tp=2, dp=1),
                        use_pallas=False).generate(PROMPT, JaxGen(**GEN))
    gen = pconfig.GenerationConfig(**GEN)
    out, route, cache_shape = same_on_ranks(run(
        pool, tasks.generate, 2, 1, pcfg, ppol, tree, PROMPT, gen))
    assert want and out == want
    assert out == _port_single("q8", kv, "generate", PROMPT, gen, seed=5)
    assert route == "cpu" and cache_shape[2] == CFG.n_kv_heads // 2


def test_engine_tp4_generate_batch_q4(pool):
    """generate_batch at tp = 4 over q4 weights (a kv head a rank):
    JAX's single-device generate_batch tokens and the port's tp = 1
    (test_engine_tp_generate_batch)."""
    jp, tree, jpol, ppol, pcfg = jax_params("q4", seed=6)
    prompts = [list(range(2, 8)), list(range(3, 13)), [7, 8, 9]]
    gen = dict(GEN, n_predict=16)
    want, _ = JaxEngine(JCFG, jpol, jp, max_batch=3,
                        use_pallas=False).generate_batch(prompts, JaxGen(**gen))
    pgen = pconfig.GenerationConfig(**gen)
    got = same_on_ranks(run(pool, tasks.generate_batch, 4, 1, pcfg, ppol, tree,
                            prompts, pgen))
    assert got == want
    assert got == _port_single("q4", "f32", "generate_batch", prompts, pgen,
                               seed=6)


@pytest.mark.parametrize("kv", ["f32", "i8"])
def test_paged_generate_tp2(pool, kv):
    """Paged generate at tp = 2: the port's tp = 1 paged tokens."""
    _, tree, _, ppol, pcfg = jax_params("q8", kv, seed=5)
    gen = pconfig.GenerationConfig(**GEN)
    out, _, cache_shape = same_on_ranks(run(
        pool, tasks.generate, 2, 1, pcfg, ppol, tree, PROMPT, gen, paged=True))
    assert out == _port_single("q8", kv, "generate", PROMPT, gen, seed=5,
                               paged=True)
    assert cache_shape[2] == CFG.n_kv_heads // 2


def test_generate_batch_tp2_paged_and_i8(pool):
    _, tree, _, ppol, pcfg = jax_params("q8", "i8", seed=7)
    prompts = [list(range(2, 9)), list(range(5, 25)), [9, 8, 7, 6]]
    gen = pconfig.GenerationConfig(**dict(GEN, n_predict=30))
    want = _port_single("q8", "i8", "generate_batch", prompts, gen, seed=7,
                        paged=True)
    got = same_on_ranks(run(pool, tasks.generate_batch, 2, 1, pcfg, ppol, tree,
                            prompts, gen, paged=True))
    assert got == want


@pytest.mark.parametrize("paged", [True, False])
def test_batcher_over_tp_engine_matches_tp1(pool, paged):
    """ContinuousBatcher over Engine(tp=2): every request's tokens those of
    the tp = 1 batcher, on every rank; its pool at the local kv heads."""
    _, tree, _, ppol, pcfg = jax_params("q8", seed=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, CFG.n_vocab, n).tolist()
               for n in (5, 17, 9, 30, 3, 12)]
    gen = pconfig.GenerationConfig(n_predict=40, greedy=True, eos_token=-2,
                                   chunk_size=8)
    base = ContinuousBatcher(
        Engine(pcfg, ppol, params_from_numpy(tree, pcfg, ppol), device="cpu",
               paged=paged), gen, max_batch=4)
    for p in prompts:
        base.submit(p, max_new=12)
    want = {i: r.output for i, r in base.run().items()}
    got, heads = same_on_ranks(run(
        pool, tasks.batcher, 2, 1, pcfg, ppol, tree, prompts, gen, 4, 12,
        paged=paged))
    assert got == want and all(len(o) == 12 for o in got.values())
    assert heads == CFG.n_kv_heads // 2


def test_tp_overlap_tokens_equal_psum(pool):
    """--tp-overlap at tp = 4: the ring's tokens are the all-reduce's
    (TestTpOverlap.test_overlap_matches_psum_baseline)."""
    _, tree, _, ppol, pcfg = jax_params("q8")
    gen = pconfig.GenerationConfig(**GEN)
    psum = same_on_ranks(run(pool, tasks.generate, 4, 1, pcfg, ppol, tree,
                             PROMPT, gen))[0]
    ring = same_on_ranks(run(pool, tasks.generate, 4, 1, pcfg, ppol, tree,
                             PROMPT, gen, tp_overlap=True))[0]
    assert psum and ring == psum


def test_topk_tokens_bit_equal_on_every_rank(pool):
    """Top-k from one seed: every rank draws the same tokens (the logits
    are bit-equal after each sum, the generators seeded alike)."""
    _, tree, _, ppol, pcfg = jax_params("q8")
    gen = pconfig.GenerationConfig(n_predict=30, greedy=False, top_k=20,
                                   temperature=0.9, seed=11, chunk_size=8,
                                   eos_token=-2)
    out = same_on_ranks(run(pool, tasks.generate, 4, 1, pcfg, ppol, tree,
                            PROMPT, gen))[0]
    assert len(out) == 20


def test_collectives_on_the_grid(pool):
    tp4 = run(pool, tasks.collectives, 4, 1)
    for r, (red, shifted, gathered, obj, grid, backend) in enumerate(tp4):
        assert red == [10.0] * 3 and shifted == [float((r + 1) % 4)] * 2
        assert gathered == [[0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]]
        assert obj == "from 0" and grid == [[0, 1, 2, 3]] and backend == "gloo"
    dp2 = run(pool, tasks.collectives, 2, 2)
    for r, (red, shifted, gathered, _, grid, _) in enumerate(dp2):
        assert red == [3.0] * 3 and shifted == [float(1 - r % 2)] * 2
        assert gathered == [[0.0, 0.0, 1.0, 1.0]] and grid == [[0, 1], [2, 3]]
    assert pool.run(with_mesh, tasks.collectives, 2, 1, "cpu")[2:] == [None,
                                                                      None]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", ["f32", "q8", "q4"])
def test_shard_params_moves_only_the_rank_slices(kind, overlap):
    """Full parameters in host memory, a rank's shard on another device
    ("meta" here, a card on the chip): every tensor of the shard lands
    there, only a 1 / tp share of wqkv, wo, w_gateup and w_down, the rest
    whole; the full parameters stay as they were, on the host."""
    tp = 2
    _, tree, _, ppol, pcfg = jax_params(kind)
    params = params_from_numpy(tree, pcfg, ppol)
    before = [t.clone() for t in _tensors(params)]
    shards = [ptp.shard_params(params, pcfg, tp, r, "meta", overlap)
              for r in range(tp)]
    for shard in shards:
        assert all(t.device.type == "meta" for t in _tensors(shard))
        for name, w in params["layers"].items():
            full = sum(t.numel() for t in _tensors(w))
            got = sum(t.numel() for t in _tensors(shard["layers"][name]))
            assert got * (tp if name in ("wqkv", "wo", "w_gateup", "w_down")
                          else 1) == full, name
    after = _tensors(params)
    assert all(t.device.type == "cpu" for t in after)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, pcodec.QTensor):
        return [tree.data, tree.scales]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("wdtype", ["q8", "f32"])
def test_random_weights_kept_where_asked(wdtype):
    """init_quantized_params and init_dense_params draw on `device` and
    keep each tensor on `store` (a --tp rank: drawn on its card as a
    single-device run draws them, kept in host memory): the same values
    as kept on `device`, and no tensor left behind."""
    def make(store):
        g = torch.Generator().manual_seed(5)
        if wdtype == "f32":
            return llama.init_dense_params(CFG, g, "cpu", store)
        return llama.init_quantized_params(CFG, pconfig.POLICIES[wdtype], g,
                                           "cpu", store)

    kept, meta = _tensors(make(None)), _tensors(make("meta"))
    assert all(t.device.type == "meta" for t in meta)
    assert [t.shape for t in meta] == [t.shape for t in kept]
    again = _tensors(make("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(kept, again))


def test_a_rank_that_raises_ends_the_run():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: run_ranks
    raises with rank 1's traceback at once, not at the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_ranks(tasks.raise_on_rank_1, 2, device="cpu", timeout=60)
    assert time.monotonic() - t0 < 45


def test_placement_and_route():
    assert backend_for(4, "cpu") == "gloo"
    gloo = SimpleNamespace(tp=2, backend="gloo")
    card = torch.device("cuda")
    assert graphs.capture_for(card, gloo) is None
    assert graphs.route(card, None) == "eager"
    assert graphs.route(torch.device("cpu"), None) == "cpu"


def test_speculative_refuses_tp(pool):
    _, tree, _, ppol, pcfg = jax_params("q8")
    for msg in run(pool, tasks.speculative, 2, 1, pcfg, ppol, tree):
        assert msg and "tp=1" in msg


@pytest.mark.parametrize("argv,msg", [
    (["--tp", "2", "--tp-mode", "gspmd"], "not ported"),
    (["--tp", "2", "--spec", "4", "-greedy"], "--tp 1"),
    (["--tp", "0"], "tp must be"),
])
def test_cli_refuses(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + ["--random-weights", "--device", "cpu"])


def test_cli_tp2_runs_on_the_cpu(capfd):
    """python -m tinyllama_tpu_torch.cli --tp 2 --device cpu: rank 0
    prints the ids of the tp = 1 run and one performance table; the other
    rank prints nothing."""
    argv = ["--random-weights", "--model", "tiny-test", "-q8", "-greedy",
            "-p", "hello", "--npred", "20", "--device", "cpu"]
    assert cli.main(argv) == 0
    one = capfd.readouterr()
    assert cli.main(argv + ["--tp", "2"]) == 0
    two = capfd.readouterr()
    ids = _id_lines(one.err)
    assert ids and _id_lines(two.err) == ids
    assert two.out.count("PERFORMANCE") == 1


def _id_lines(err: str) -> list[str]:
    """The lines of streamed ids (the process group's own warnings
    aside)."""
    return [line.split() for line in err.splitlines()
            if line.split() and all(w.isdigit() for w in line.split())]
