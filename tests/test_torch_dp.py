"""The port's data-parallel batch rows (``make_mesh``'s dcn and data axes
as the batch group, ``Engine(tp=, mesh=)`` through generate_batch, the
paged cache and the batcher), its multi-device dryrun and its multihost
smoke, against the JAX package's shard_map engine on its 8 virtual CPU
devices.

One pool of 4 gloo rank processes on the CPU (one torch thread each)
serves the whole file; its cubes are (dcn 1, data 2, model 2), (dcn 2,
data 1, model 2) and (dcn 2, data 2, model 1). The rank side lives in
tests/torch_dp_tasks.py (no JAX). JAX's parameters cross to the ranks as
numpy (interop.params_from_numpy).

Tolerance at f32 (q8 weights, f32 activations): greedy tokens equal to
JAX's TP engine on the same mesh and to the port's single-device engine;
the prefill logits, assembled from the ranks' rows, within rtol 1e-5 and
atol 1e-5 of max |logits| of JAX's, as tests/test_torch_tp.py. Top-k
draws are not compared with JAX's (its PRNG is not torch's); at dp 2 x
tp 2 they equal the port's single-device engine's for the same seed.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dp_tasks as tasks
from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.parallel.mesh import batch_axes as jax_batch_axes
from tinyllama_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.parallel.mesh import RankPool, with_mesh
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher
from tinyllama_tpu_torch.tools import dryrun_multichip

SHAPE = dict(n_heads=8, n_kv_heads=4, n_embd=256, n_ffn=512)
JCFG, CFG = jax_tiny(**SHAPE), pconfig.tiny_test_config(**SHAPE)
RTOL = ATOL = 1e-5
GEN = dict(n_predict=20, greedy=True, eos_token=-2, chunk_size=4)
#: test_paged.py:301's prompts (four rows: two a data rank at dp 2)
PROMPTS = [list(range(2, 10)), list(range(3, 11)), [5, 6], [9, 8, 7, 6]]


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


def run(pool, fn, tp, dp, *args, dcn=1, **kwargs):
    """fn on the [dcn, dp, tp] cube of the pool; the results of its
    ranks."""
    out = pool.run(with_mesh, fn, tp, dp, "cpu", *args, dcn=dcn, **kwargs)
    return out[: tp * dp * dcn]


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


_params: dict = {}


def jax_params(kv="f32", seed=0):
    """(JAX params, their numpy tree, JAX policy, port policy) of q8
    weights at f32 activations and a `kv` cache, made once a key."""
    key = (kv, seed)
    if key not in _params:
        jpol, ppol = JaxPolicy("q8", "f32", kv), pconfig.DtypePolicy(
            "q8", "f32", kv)
        dense = jllama.init_dense_params(JCFG, jax.random.PRNGKey(seed),
                                         jnp.float32)
        jp = jllama.convert_params(dense, jpol)
        _params[key] = (jp, _to_numpy(jp), jpol, ppol)
    return _params[key]


def port_engine(kv="f32", seed=0, **kw) -> Engine:
    _, tree, _, ppol = jax_params(kv, seed)
    return Engine(CFG, ppol, params_from_numpy(tree, CFG, ppol), device="cpu",
                  **kw)


def same_tokens(results):
    """Every rank's tokens (the first item of its result), equal; returns
    them."""
    first = results[0][0]
    assert all(r[0] == first for r in results[1:]), "ranks differ"
    return first


# ----------------------------------------------------------------------------
# the mesh: JAX's device order and batch_axes
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("tp,dp,dcn", [(2, 2, 1), (2, 1, 2), (1, 2, 2)])
def test_mesh_coordinates_are_jax_device_order(pool, tp, dp, dcn):
    """Rank r's (dcn, data, model) coordinates are those of device r in
    JAX's make_mesh (test_multihost.py:26-33), and its batch rank the
    shard of a leading batch dimension that device holds under
    P(batch_axes(mesh)); the batch group's gather runs in that order, and
    broadcast_object reaches every rank from rank 0."""
    jmesh = jax_make_mesh(tp=tp, dp=dp, dcn=dcn)
    axes = jax_batch_axes(jmesh)
    assert axes == (("dcn", "data") if dcn > 1 else "data")
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(dcn, dp, tp)
    n = dcn * dp
    shard_of = {d.id: idx[0].start or 0 for d, idx in NamedSharding(
        jmesh, P(axes)).devices_indices_map((n,)).items()}
    out = run(pool, tasks.coords, tp, dp, dcn=dcn)
    for r, (xyz, batch_rank, batch, cube, gathered, obj) in enumerate(out):
        assert cube == ids.tolist()
        assert xyz == tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert batch == n and batch_rank == shard_of[r]
        assert gathered == [int(ids[c, d, xyz[2]]) for c in range(dcn)
                            for d in range(dp)]
        assert obj == "from 0"


# ----------------------------------------------------------------------------
# the engine over dp x tp: generate_batch, the paged cache, the dcn axis
# ----------------------------------------------------------------------------


def _jax_engine(jp, jpol, tp, dp, dcn=1, **kw):
    return JaxEngine(JCFG, jpol, jp, max_batch=dp * dcn, tp=tp,
                     mesh=jax_make_mesh(tp=tp, dp=dp, dcn=dcn),
                     use_pallas=False, **kw)


def _jax_logits(eng, prompts):
    logits, _, _ = eng.prefill(eng.new_cache(len(prompts)), prompts)
    return np.asarray(logits)


def _check_rows(results, want_logits, B, ways, kv):
    """Each rank's prefill logits are its rows of the batch (its batch
    rank's) and its cache held B / ways rows. At an f32 KV cache the
    logits are within the tolerance of JAX's; an int8 cache's are held by
    their tokens only, as tests/test_torch_tp.py holds them (a 1-ulp
    difference in a key before it is quantized can move it a whole int8
    step)."""
    b = B // ways
    scale = float(np.abs(want_logits).max())
    for _, logits, batch_rank, rows in results:
        assert rows == b and logits.shape == (b, CFG.n_vocab)
        if kv == "i8":
            continue
        np.testing.assert_allclose(
            logits, want_logits[batch_rank * b:(batch_rank + 1) * b],
            rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv", ["f32", "i8"])
def test_generate_batch_dp2_tp2_matches_jax(pool, kv, paged):
    """generate_batch at dp 2 x tp 2 (tests/test_tp.py:51 and, paged,
    tests/test_paged.py:301): rows over the data group, every rank the
    full list of tokens, equal to JAX Engine(tp=2, mesh=make_mesh(2, 2))'s
    and to the port's single-device engine's; each rank's prefill logits
    are its two rows of JAX's."""
    jp, tree, jpol, ppol = jax_params(kv, seed=3)
    jeng = _jax_engine(jp, jpol, 2, 2, paged=paged)
    want, _ = jeng.generate_batch(PROMPTS, JaxGen(**GEN))
    gen = pconfig.GenerationConfig(**GEN)
    res = run(pool, tasks.generate_batch, 2, 2, CFG, ppol, tree, PROMPTS, gen,
              paged=paged)
    got = same_tokens(res)
    assert want and got == want
    assert got == port_engine(kv, 3, paged=paged).generate_batch(PROMPTS,
                                                                 gen)[0]
    _check_rows(res, _jax_logits(jeng, PROMPTS), 4, 2, kv)


def test_engine_on_dcn_mesh_matches_jax(pool):
    """A (dcn 2, data 1, model 2) engine: rows over dcn x data, weights
    over the model group, JAX's engine on the same mesh
    (tests/test_multihost.py:36-56, int8 KV) and the single-device port."""
    jp, tree, jpol, ppol = jax_params("i8", seed=11)
    prompts = [list(range(2, 8)), [9, 8, 7, 6, 5]]
    jeng = _jax_engine(jp, jpol, 2, 1, dcn=2)
    want, _ = jeng.generate_batch(prompts, JaxGen(**GEN))
    gen = pconfig.GenerationConfig(**GEN)
    res = run(pool, tasks.generate_batch, 2, 1, CFG, ppol, tree, prompts, gen,
              dcn=2)
    got = same_tokens(res)
    assert want and got == want
    assert got == port_engine("i8", 11).generate_batch(prompts, gen)[0]
    _check_rows(res, _jax_logits(jeng, prompts), 2, 2, "i8")


def test_topk_rows_on_dp_ranks(pool):
    """Top-k at dp 2 x tp 2: every rank returns the same rows (a model
    group draws alike, and the rows are gathered), the same seed draws the
    same tokens again, and each row's first token lies in the top k of its
    prefill logits (JAX's PRNG is not torch's: support and seed, not
    tokens)."""
    _, tree, _, ppol = jax_params(seed=3)
    gen = pconfig.GenerationConfig(**dict(GEN, greedy=False, top_k=5,
                                          temperature=0.9, seed=17))
    res = run(pool, tasks.generate_batch, 2, 2, CFG, ppol, tree, PROMPTS, gen)
    got = same_tokens(res)
    assert same_tokens(run(pool, tasks.generate_batch, 2, 2, CFG, ppol, tree,
                           PROMPTS, gen)) == got
    logits = np.concatenate([res[0][1], res[2][1]])
    for row, ids, prompt in zip(logits, got, PROMPTS):
        assert len(ids) == GEN["n_predict"] - len(prompt)
        assert all(0 <= t < CFG.n_vocab for t in ids)
        assert ids[0] in np.argsort(row)[-5:]


TOPK = dict(greedy=False, top_k=5, temperature=0.9, seed=17)


@pytest.mark.parametrize("what", ["generate_batch", "batcher"])
def test_topk_dp_equals_single_device(pool, what):
    """Top-k at dp 2 x tp 2 draws the single-device engine's tokens for
    the same seed: each rank draws the whole batch's variates and keeps
    its own rows, so its generator stays in step with every other rank's
    and with one device's (generate_batch of 4 prompts; the monolithic
    batcher, 6 requests into 4 slots)."""
    _, tree, _, ppol = jax_params(seed=9)
    if what == "generate_batch":
        gen = pconfig.GenerationConfig(**dict(GEN, **TOPK))
        want = port_engine(seed=9).generate_batch(PROMPTS, gen)[0]
        got = same_tokens(run(pool, tasks.generate_batch, 2, 2, CFG, ppol,
                              tree, PROMPTS, gen))
    else:
        gen = pconfig.GenerationConfig(**dict(BATCH_GEN, **TOPK))
        reqs, max_new = _requests(6), [4, 9, 6, 12, 5, 8]
        base = ContinuousBatcher(port_engine(seed=9), gen, max_batch=4)
        ids = [base.submit(p, max_new=n) for p, n in zip(reqs, max_new)]
        done = base.run()
        want = [done[i].output for i in ids]
        got = same_tokens(run(pool, tasks.batcher, 2, 2, CFG, ppol, tree,
                              reqs, max_new, gen, 4))
        assert [len(o) for o in got] == max_new
    assert got == want


def test_topk_identical_prompts_on_two_batch_ranks_differ(pool):
    """Best-of-n at dp 2 x tp 2: one prompt in rows 0 and 2, which lie on
    the two batch ranks, samples two different continuations (each row
    draws noise of its own), as on one device."""
    _, tree, _, ppol = jax_params(seed=9)
    gen = pconfig.GenerationConfig(**dict(GEN, **TOPK))
    prompts = [PROMPTS[0], PROMPTS[1]] * 2
    got = same_tokens(run(pool, tasks.generate_batch, 2, 2, CFG, ppol, tree,
                          prompts, gen))
    assert got[0] != got[2] and got[1] != got[3]
    assert got == port_engine(seed=9).generate_batch(prompts, gen)[0]


@pytest.mark.parametrize("what,args", [
    ("generate", ([2, 3, 4],)),
    ("generate_batch", (PROMPTS[:3],))])
def test_batch_the_group_does_not_divide_raises_as_jax(pool, what, args):
    """generate (B = 1) and generate_batch of 3 prompts at dp 2 raise a
    ValueError naming the batch group, where JAX's engine raises one."""
    jp, tree, jpol, ppol = jax_params()
    with pytest.raises(ValueError):
        getattr(_jax_engine(jp, jpol, 2, 2), what)(*args, JaxGen(**GEN))
    gen = pconfig.GenerationConfig(**GEN)
    msgs = run(pool, tasks.raises, 2, 2, CFG, ppol, tree, what, *args, gen)
    assert all(m and "batch group of 2 ranks" in m for m in msgs), msgs


def test_mesh_data_axis_carries_rows_not_the_prompt(pool):
    """The repair: Engine(tp=2, mesh=make_mesh(2, 2)) shards batch rows
    over the data group (sp 1, a batch group of 2: a cache of 4 rows holds
    2 a rank), as JAX's engine reads such a mesh; sp must equal the data
    group where it is given; at tp 1 a passed mesh only places the engine,
    which runs every row (generate of one prompt gives the single-device
    tokens)."""
    _, tree, _, ppol = jax_params()
    layout = run(pool, tasks.engine_layout, 2, 2, CFG, ppol, tree)
    assert [x[:2] for x in layout] == [(1, 2)] * 4
    assert [x[2] for x in layout] == [0, 0, 1, 1]
    assert all(x[3] == 2 for x in layout)
    assert run(pool, tasks.engine_layout, 2, 2, CFG, ppol, tree,
               sp=2)[0][:2] == (2, 1)
    msgs = run(pool, tasks.raises, 2, 2, CFG, ppol, tree, None, sp=4)
    assert all("data group, of 2 ranks" in m for m in msgs), msgs
    gen = pconfig.GenerationConfig(**GEN)
    out = run(pool, tasks.generate, 1, 2, CFG, ppol, tree, PROMPTS[0], gen)
    assert out == [(port_engine().generate(PROMPTS[0], gen)[0], 1)] * 2


@pytest.mark.parametrize("paged", [False, True])
def test_model_group_rows_equal_a_dp1_engine(pool, paged):
    """Each model group's rows of a dp 2 x tp 2 generate_batch are, bit for
    bit in tokens and prefill logits, those of a dp 1 x tp 2 engine
    (Mesh.model_mesh) over the group's two rows alone: the same shard,
    the same local batch (what chip_smoke.py's path (s) holds on the
    card)."""
    _, tree, _, ppol = jax_params(seed=3)
    gen = pconfig.GenerationConfig(**GEN)
    res = run(pool, tasks.own_rows, 2, 2, CFG, ppol, tree, PROMPTS, gen,
              paged=paged)
    for r, ((ids, logits, _), (own_ids, own_logits, _)) in enumerate(res):
        assert ids == res[0][0][0] and logits.shape[0] == 2
        assert own_ids == ids[2 * (r // 2):2 * (r // 2) + 2]
        assert np.array_equal(logits, own_logits)


# ----------------------------------------------------------------------------
# the batcher over dp x tp
# ----------------------------------------------------------------------------


def _requests(n):
    rng = np.random.default_rng(4)
    return [rng.integers(2, CFG.n_vocab, int(k)).tolist()
            for k in rng.integers(3, 20, n)]


BATCH_GEN = dict(n_predict=40, greedy=True, eos_token=-2, chunk_size=4)


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_dp2_tp2_matches_jax(pool, paged):
    """ContinuousBatcher over dp 2 x tp 2, 3 requests into 4 slots:
    JAX's batcher's tokens on every rank; slots shard two a rank, every
    chunk at 2 rows a rank; the admission's bucket of 4 (JAX's) puts the
    third request's row on rank 1; no downshift."""
    jp, tree, jpol, ppol = jax_params(seed=9)
    reqs = _requests(3)
    jb = JaxBatcher(_jax_engine(jp, jpol, 2, 2, paged=paged),
                    JaxGen(**BATCH_GEN), max_batch=4, paged=paged)
    ids = [jb.submit(p, max_new=10) for p in reqs]
    done = jb.run()
    want = [done[i].output for i in ids]
    gen = pconfig.GenerationConfig(**BATCH_GEN)
    res = run(pool, tasks.batcher, 2, 2, CFG, ppol, tree, reqs, 10, gen, 4,
              paged=paged)
    assert same_tokens(res) == want and all(len(o) == 10 for o in want)
    for r, (_, shapes, downshift) in enumerate(res):
        assert not downshift and set(shapes["chunk"]) == {2}
        assert shapes["prefill"][0] == (4, 2 * (r // 2))


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_admissions_below_the_batch_group(pool, paged):
    """6 requests into 4 slots at dp 2: later admissions of 1 or 2
    requests. Each rank's share of the bucket holds the requests of its
    own slots, so the bucket is at least the batch group; the tokens are
    the single-device batcher's. JAX's batcher raises there: its bucket
    of 1 does not divide over its data axis (ROADMAP.md, Queue 3,
    reference fault 11)."""
    jp, tree, jpol, ppol = jax_params(seed=9)
    reqs = _requests(6)
    max_new = [4, 9, 6, 12, 5, 8]
    jb = JaxBatcher(_jax_engine(jp, jpol, 2, 2, paged=paged),
                    JaxGen(**BATCH_GEN), max_batch=4, paged=paged)
    for p, n in zip(reqs, max_new):
        jb.submit(p, max_new=n)
    with pytest.raises(ValueError):
        jb.run()
    gen = pconfig.GenerationConfig(**BATCH_GEN)
    base = ContinuousBatcher(port_engine(seed=9, paged=paged), gen,
                             max_batch=4)
    ids = [base.submit(p, max_new=n) for p, n in zip(reqs, max_new)]
    done = base.run()
    want = [done[i].output for i in ids]
    res = run(pool, tasks.batcher, 2, 2, CFG, ppol, tree, reqs, max_new, gen,
              4, paged=paged)
    got = same_tokens(res)
    assert got == want and [len(o) for o in got] == max_new
    sizes = [n for n, _ in res[0][1]["prefill"]]
    assert min(sizes) < 4 and all(n % 2 == 0 for n in sizes), sizes


def test_downshift_at_dp2_raises_as_jax(pool):
    """Asking a paged batcher over dp 2 for its bucket downshift raises,
    as JAX's does (its downshift needs tp 1); over dp 1 x tp 2 the port
    keeps it (ROADMAP.md, deliberate differences)."""
    jp, tree, jpol, ppol = jax_params()
    with pytest.raises(ValueError, match="downshift"):
        JaxBatcher(_jax_engine(jp, jpol, 2, 2, paged=True), max_batch=4,
                   paged=True, downshift=True)
    msgs = run(pool, tasks.batcher_downshift, 2, 2, CFG, ppol, tree, 4,
               paged=True)
    assert all("batch group of one" in m for m in msgs), msgs
    assert run(pool, tasks.batcher_downshift, 2, 1, CFG, ppol, tree, 4,
               paged=True) == [None, None]


# ----------------------------------------------------------------------------
# the dryrun and the multihost smoke
# ----------------------------------------------------------------------------


def test_dryrun_multichip_on_four_ranks(pool):
    """The port's dryrun at N = 4 on the CPU: an OK line for paths 2, 3,
    4, 6 and 7, and path 1 said not ported."""
    lines = dryrun_multichip.run_paths(pool, 4, "cpu")
    text = "\n".join(lines)
    for path in (2, 3, 4, 6, 7):
        assert f"path {path} OK" in text, text
    assert "path 1 not ported" in text
    assert "path 2 OK (shard_map TP Engine): mesh dp=1 x tp=4" in text


def test_multihost_smoke_prints_ok():
    """tools/multihost_smoke.py as a user runs it: two host processes of
    two ranks each, one world over TCP on 127.0.0.1."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "tinyllama_tpu_torch.tools.multihost_smoke",
         "--device", "cpu"], cwd=root, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST SMOKE OK" in proc.stdout
