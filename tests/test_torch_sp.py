"""The port's sequence parallelism (parallel/ring.py, parallel/sp.py,
``Engine(sp=)``, the batcher's long-prompt admission and the CLI's
``--sp``) against the JAX package's shard_map ring and SP prefill on its
8 virtual CPU devices.

One pool of 4 gloo rank processes on the CPU (one torch thread each)
serves the whole file; its grids are [n, 1] (sp n at tp 1) and [2, 2]
(sp 2 x tp 2). The rank side lives in tests/torch_sp_tasks.py (no JAX).
JAX's parameters cross to the ranks as numpy.

Tolerance at f32 (f32 activations and weights, or q8 weights at f32
activations): within rtol 1e-5 and atol 1e-5 of max |x| of JAX's ring
output, logits and handed-off cache (the ring's sums run in another
order); the ring at bf16 within rtol 2e-2 and atol 5e-3 of max |x| (the
repo's bf16 kernel tolerance). An int8 cache's planes: the scales within
the f32 tolerance of JAX's and each int8 value within one step of it;
bit-equal to JAX's quantizer applied to the port's own K/V. Greedy tokens
are held equal, and every rank's results bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_sp_tasks as tasks
from test_torch_tp import _to_numpy, same_on_ranks
from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.rope import rope_table as jax_rope_table
from tinyllama_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tinyllama_tpu.parallel.ring import ring_gqa_attention as jax_ring
from tinyllama_tpu.parallel.sp import sp_prefill_into_cache as jax_sp_prefill
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.kvcache import _quantize_kv as jax_quantize_kv
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.parallel.mesh import RankPool, with_mesh
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher, Request

MAX_CTX = 256
JCFG, CFG = jax_tiny(max_ctx=MAX_CTX), pconfig.tiny_test_config(max_ctx=MAX_CTX)
RTOL = ATOL = 1e-5
F32, Q8_I8 = ("f32", "f32", "f32"), ("q8", "f32", "i8")


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


def run(pool, fn, sp, *args, tp=1, **kwargs):
    """fn on the [sp, tp] grid of the pool; its ranks' results, checked
    bit-equal, and rank 0's returned."""
    out = pool.run(with_mesh, fn, tp, sp, "cpu", *args, **kwargs)
    return same_on_ranks(out[: tp * sp])


_params: dict = {}


def params(policy, cfg=JCFG):
    """(JAX params, their numpy tree, JAX policy, port policy) of
    `policy` (wdtype, adtype, kv) from JAX's dense seed-0 weights."""
    key = (policy, cfg.max_ctx)
    if key not in _params:
        dense = jllama.init_dense_params(cfg, jax.random.PRNGKey(0),
                                         jnp.float32)
        jpol = JaxPolicy(*policy)
        jp = jllama.convert_params(dense, jpol)
        _params[key] = (jp, _to_numpy(jp), jpol, pconfig.DtypePolicy(*policy))
    return _params[key]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def prompt_of(n):
    return [2 + (i % 40) for i in range(n)]


# ----------------------------------------------------------------------------
# the ring and the data group's collectives
# ----------------------------------------------------------------------------

#: tests/test_ring.py's shapes: (B, T, H, d, Kh)
RING_SHAPES = [(1, 64, 4, 32, 2), (2, 32, 8, 16, 4)]


def _jax_ring(q, k, v, n, dtype):
    mesh = jax_make_mesh(tp=1, dp=n)
    spec = P(None, "data")
    f = shard_map(lambda q, k, v: jax_ring(q, k, v, axis_name="data"),
                  mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return np.asarray(f(*(jnp.asarray(x, dtype) for x in (q, k, v))),
                      np.float32)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", RING_SHAPES)
def test_ring_matches_jax(pool, shape, n):
    B, T, H, d, Kh = shape
    rng = np.random.default_rng(n)
    q = rng.standard_normal((B, T, H, d), np.float32)
    k, v = (rng.standard_normal((B, T, Kh, d), np.float32) for _ in range(2))
    got = np.concatenate(pool.run(with_mesh, tasks.ring, 1, n, "cpu", q, k,
                                  v)[:n], axis=1)
    _close(got, _jax_ring(q, k, v, n, jnp.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_bf16_matches_jax(pool, n):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 32, 4, 16), np.float32)
    k, v = (rng.standard_normal((1, 32, 2, 16), np.float32) for _ in range(2))
    got = np.concatenate(pool.run(with_mesh, tasks.ring, 1, n, "cpu", q, k, v,
                                  "bfloat16")[:n], axis=1)
    _close(got, _jax_ring(q, k, v, n, jnp.bfloat16), 2e-2, 5e-3)


def test_data_group_collectives(pool):
    """The data ring hops from data rank i to i + 1 (JAX's perm), the
    gather goes in data-rank order, the broadcast from the rank named;
    broadcast_object reaches every rank of a [2, 2] grid from rank 0."""
    out = pool.run(with_mesh, tasks.collectives, 1, 4, "cpu")
    for r, (shifted, gathered, bcast, obj) in enumerate(out):
        assert shifted == [float((r - 1) % 4)] * 2
        assert gathered == [[0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]]
        assert bcast == [3.0] * 3 and obj == "from 0"
    grid = pool.run(with_mesh, tasks.collectives, 2, 2, "cpu")
    for r, (shifted, gathered, bcast, obj) in enumerate(grid):
        dp_rank = r // 2
        assert shifted == [float(1 - dp_rank)] * 2
        assert gathered == [[0.0, 0.0, 1.0, 1.0]]
        assert bcast == [1.0] * 3 and obj == "from 0"


# ----------------------------------------------------------------------------
# sp_prefill_into_cache against JAX's: logits and the handed-off cache
# ----------------------------------------------------------------------------


def _jax_prefill(policy, sp, prompt, paged, max_ctx=MAX_CTX):
    cfg = jax_tiny(max_ctx=max_ctx)
    jp, _, jpol, _ = params(policy, cfg)
    eng = JaxEngine(cfg, jpol, jp, paged=paged, use_pallas=False)
    cache = eng.new_paged_cache(1) if paged else eng.new_cache(1)
    logits, cache = jax_sp_prefill(
        cfg, jpol, jp, prompt, jax_rope_table(max_ctx, cfg.d_head,
                                              cfg.rope_theta),
        jax_make_mesh(tp=1, dp=sp), cache)
    planes = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                   if cache.quantized else [])
    return np.asarray(logits), [np.asarray(p) for p in planes]


def _port_prefill(pool, policy, sp, prompt, paged):
    _, tree, _, ppol = params(policy)
    return run(pool, tasks.sp_prefill, sp, CFG, ppol, tree, prompt, paged)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("policy,paged", [(F32, False), (F32, True),
                                          (Q8_I8, False)],
                         ids=["f32", "f32-paged", "q8-i8"])
def test_sp_prefill_matches_jax(pool, policy, paged, sp):
    prompt = prompt_of(37)
    logits, planes = _port_prefill(pool, policy, sp, prompt, paged)
    jlogits, jplanes = _jax_prefill(policy, sp, prompt, paged)
    _close(logits, jlogits)
    assert [p.shape for p in planes] == [p.shape for p in jplanes]
    if policy[2] != "i8":
        for got, want in zip(planes, jplanes):
            _close(got, want)
        return
    data, scales = planes[:2], planes[2:]
    for got, want in zip(scales, jplanes[2:]):
        _close(got, want)
    for got, want in zip(data, jplanes[:2]):
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    # the int8 planes are JAX's quantizer, bit for bit, over the port's
    # own K/V (the same prefill into an f32 cache: the ring attends the
    # unquantized K/V, so the values are the same)
    _, f32_planes = _port_prefill(pool, ("q8", "f32", "f32"), sp, prompt,
                                  paged)
    for i in range(2):
        q, s = jax_quantize_kv(jnp.asarray(f32_planes[i]))
        assert np.array_equal(data[i], np.asarray(q))
        assert np.array_equal(scales[i].view(np.uint32),
                              np.asarray(s).view(np.uint32))


# ----------------------------------------------------------------------------
# Engine(sp=N): greedy tokens against JAX's Engine(sp=N) and Engine()
# ----------------------------------------------------------------------------

GEN = dict(greedy=True, eos_token=-1, chunk_size=4)


def _generate(pool, policy, prompt, n_predict, sp, tp=1, **kw):
    _, tree, _, ppol = params(policy)
    return run(pool, tasks.generate, sp, CFG, ppol, tree, prompt,
               pconfig.GenerationConfig(n_predict=n_predict, **GEN), tp=tp,
               **kw)


def _single(policy, prompt, n_predict, method="generate", **kw):
    _, tree, _, ppol = params(policy)
    eng = Engine(CFG, ppol, params_from_numpy(tree, CFG, ppol), device="cpu",
                 **kw)
    return getattr(eng, method)(prompt, pconfig.GenerationConfig(
        n_predict=n_predict, **GEN))[0]


@pytest.mark.parametrize("plen", [37, 64])
@pytest.mark.parametrize("policy,sp", [(F32, 2), (Q8_I8, 4)],
                         ids=["f32-sp2", "q8-i8-sp4"])
def test_sp_generate_matches_jax_and_sp1(pool, policy, sp, plen):
    """Engine(sp).generate: JAX Engine(sp)'s greedy tokens
    (test_sp_generate_token_identical) and the port's Engine()'s. A
    prompt that fills its shards exactly (64 tokens) is held against JAX's
    Engine() instead: there JAX's SP engine samples from the wrong row
    (reference fault 10, test_reference_fault_10_exact_fit_last_row)."""
    prompt = prompt_of(plen)
    jp, _, jpol, _ = params(policy)
    jax_sp = {"sp": sp} if plen % (sp * 8) else {}
    want, _ = JaxEngine(JCFG, jpol, jp, **jax_sp).generate(
        prompt, JaxGen(n_predict=plen + 12, **GEN))
    out, eng_sp, route = _generate(pool, policy, prompt, plen + 12, sp)
    assert len(want) == 12 and out == want and eng_sp == sp and route == "cpu"
    assert out == _single(policy, prompt, plen + 12)


@pytest.mark.parametrize("mode", ["paged", "sptp", "sptp_paged"])
def test_sp_modes_match_jax(pool, mode):
    """The paged handoff and sp 2 x tp 2 (ring over a rank's local heads,
    two sums a block over the model group), monolithic and paged: JAX's
    tokens (test_sp_generalized_token_identical) and the port's
    Engine()'s."""
    prompt = prompt_of(41)
    kw = {"paged": dict(sp=4, paged=True), "sptp": dict(sp=2, tp=2),
          "sptp_paged": dict(sp=2, tp=2, paged=True)}[mode]
    jp, _, jpol, _ = params(Q8_I8)
    want, _ = JaxEngine(JCFG, jpol, jp, **kw).generate(
        prompt, JaxGen(n_predict=52, **GEN))
    sp = kw.pop("sp")
    out, eng_sp, _ = _generate(pool, Q8_I8, prompt, 52, sp, **kw)
    assert len(want) == 11 and out == want and eng_sp == sp
    assert out == _single(Q8_I8, prompt, 52)


@pytest.mark.parametrize("sp,tp", [(2, 1), (2, 2)])
def test_engine_sp_makes_its_mesh(pool, sp, tp):
    """Engine(sp=N) with no mesh makes the [N, tp] grid itself (the one
    make_mesh made for the rank) and gives Engine()'s tokens."""
    prompt = prompt_of(39)
    _, tree, _, ppol = params(Q8_I8)
    out, eng_sp, same_mesh = run(
        pool, tasks.generate_own_mesh, sp, CFG, ppol, tree, prompt,
        pconfig.GenerationConfig(n_predict=50, **GEN), tp=tp)
    assert eng_sp == sp and same_mesh and len(out) == 11
    assert out == _single(Q8_I8, prompt, 50)


def test_sp_speculative_equals_generate(pool):
    """generate_speculative at sp 2 (its prefill into the padded cache of
    max_ctx + 128 through the SP route): generate's tokens."""
    prompt = prompt_of(45)
    out, eng_sp, _ = _generate(pool, Q8_I8, prompt, 80, 2,
                               method="generate_speculative")
    assert eng_sp == 2 and len(out) == 35
    assert out == _single(Q8_I8, prompt, 80)


def test_reference_fault_9_padding_past_max_ctx(pool):
    """sp 3 pads a 121-token prompt to 144 rows at max_ctx 128: JAX's
    handoff writes all 144 and raises; the port writes the first 128 and
    gives Engine()'s tokens."""
    policy, max_ctx = ("f32", "f32", "f32"), 128
    cfg, jcfg = CFG.replace(max_ctx=max_ctx), jax_tiny(max_ctx=max_ctx)
    jp, tree, jpol, ppol = params(policy, jcfg)
    prompt = prompt_of(121)
    gen = dict(n_predict=128, **GEN)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JaxEngine(jcfg, jpol, jp, sp=3).generate(prompt, JaxGen(**gen))
    want, _ = JaxEngine(jcfg, jpol, jp).generate(prompt, JaxGen(**gen))
    out, eng_sp, _ = run(pool, tasks.generate, 3, cfg, ppol, tree, prompt,
                         pconfig.GenerationConfig(**gen))
    assert eng_sp == 3 and len(out) == 7 and out == want


def test_reference_fault_10_exact_fit_last_row(pool):
    """A 64-token prompt at sp 2 fills both shards: its last row is the
    last row of shard 1. JAX reads it from a [1, sp, D] array as
    hidden_by_shard[owner], an index that clamps to 0 and yields every
    shard's last row: logits [sp, V], and generate samples shard 0's row.
    The port broadcasts the owner's row: Engine()'s logits and tokens."""
    sp, prompt = 2, prompt_of(64)
    jp, _, jpol, _ = params(F32)
    jlogits, _ = _jax_prefill(F32, sp, prompt, False)
    assert jlogits.shape == (sp, CFG.n_vocab)
    single = JaxEngine(JCFG, jpol, jp)
    want = np.asarray(single.prefill(single.new_cache(1), [prompt])[0])
    logits, _ = _port_prefill(pool, F32, sp, prompt, False)
    assert logits.shape == want.shape == (1, CFG.n_vocab)
    _close(logits, want)
    gen = JaxGen(n_predict=76, **GEN)
    wrong, _ = JaxEngine(JCFG, jpol, jp, sp=sp).generate(prompt, gen)
    right, _ = single.generate(prompt, gen)
    assert wrong != right
    out, _, _ = _generate(pool, F32, prompt, 76, sp)
    assert out == right


def test_tp_overlap_refused_with_sp(pool):
    """--tp-overlap with sp: the port raises ValueError on every rank,
    where the JAX engine asserts."""
    jp, tree, jpol, ppol = params(Q8_I8)
    prompt = prompt_of(20)
    with pytest.raises(AssertionError, match="tp-overlap"):
        JaxEngine(JCFG, jpol, jp, sp=2, tp=2, tp_overlap=True).generate(
            prompt, JaxGen(n_predict=24, **GEN))
    msg = run(pool, tasks.raises, 2, CFG, ppol, tree, prompt,
              pconfig.GenerationConfig(n_predict=24, **GEN), tp=2,
              tp_overlap=True)
    assert msg and "tp-overlap" in msg


# ----------------------------------------------------------------------------
# the batcher's long-prompt admission
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [True, False])
def test_batcher_admits_long_prompt_alone(pool, paged):
    """test_scheduler_admits_long_prompt_via_sp mirrored: a 240-token
    prompt between two short ones, 2 slots, threshold 128: it is admitted
    alone (an admission of one row: the SP route), and every request's
    tokens are those of a dedicated Engine().generate."""
    long_prompt = prompt_of(MAX_CTX - 16)
    shorts = [[3, 7, 1], [9, 2, 4, 8]]
    want = [_single(Q8_I8, p, len(p) + 8)
            for p in (shorts[0], long_prompt, shorts[1])]
    _, tree, _, ppol = params(Q8_I8)
    gen = pconfig.GenerationConfig(n_predict=8, **GEN)
    outs, waves, threshold = run(
        pool, tasks.batcher, 2, CFG, ppol, tree,
        [shorts[0], long_prompt, shorts[1]], 8, gen, 2, 128, paged=paged)
    assert outs == want and threshold == 128
    assert waves == [1, 1, 1]  # the short, then the long alone, the short
    # the default threshold over an sp engine: 1,024
    assert run(pool, tasks.batcher, 2, CFG, ppol, tree, [shorts[0]], 2, gen,
               1, paged=paged)[2] == 1024


class _Stub:
    """What _sp_take and the default threshold read of the batcher."""

    def __init__(self, lens, threshold):
        self.queue = [Request(i, [1] * n, 8) for i, n in enumerate(lens)]
        self.sp_admit_threshold = threshold

    _long = ContinuousBatcher._long
    _sp_take = ContinuousBatcher._sp_take


@pytest.mark.parametrize("lens,take,threshold,want", [
    ([10, 20, 30], 3, None, 3),  # no rule
    ([10, 20, 30], 3, 100, 3),  # nothing long
    ([200, 20, 30], 3, 100, 1),  # a long head goes alone
    ([10, 20, 200, 5], 4, 100, 2),  # stop before the long one
    ([10, 200], 1, 100, 1),  # the long one past the wave
    ([100], 1, 100, 1),  # at the threshold is long
])
def test_sp_take(lens, take, threshold, want):
    assert _Stub(lens, threshold)._sp_take(take) == want


def test_batcher_threshold_default_off_at_sp1():
    _, tree, _, ppol = params(Q8_I8)
    eng = Engine(CFG, ppol, params_from_numpy(tree, CFG, ppol), device="cpu")
    assert eng.sp == 1
    b = ContinuousBatcher(eng, max_batch=2)
    assert b.sp_admit_threshold is None


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("argv,msg", [
    (["--sp", "0"], "sp must be"),
    (["--sp", "2", "--profile", "p"], "--sp 1"),
    (["--sp", "2", "--tp", "2", "--tp-overlap"], "does not combine"),
])
def test_cli_refuses(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + ["--random-weights", "--device", "cpu"])


def test_cli_sp2_runs_on_the_cpu(capfd):
    """python -m tinyllama_tpu_torch.cli --sp 2 --device cpu: rank 0
    prints the ids of the --sp 1 run and one performance table; the other
    rank prints nothing."""
    argv = ["--random-weights", "--model", "tiny-test", "-q8", "-greedy",
            "-p", "a longer prompt for two ranks", "--npred", "44",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    one = capfd.readouterr()
    assert cli.main(argv + ["--sp", "2"]) == 0
    two = capfd.readouterr()
    ids = _id_lines(one.err)
    assert ids and len(ids[0]) == 14 and _id_lines(two.err) == ids
    assert two.out.count("PERFORMANCE") == 1


def _id_lines(err: str) -> list[list[str]]:
    return [line.split() for line in err.splitlines()
            if line.split() and all(w.isdigit() for w in line.split())]
