"""The device-resident decode chunk (runtime/graphs.py) on the CPU.

On the card ``Engine.run_chunk`` replays a CUDA graph of ``Engine.chunk``
over static buffers; on the CPU it runs the chunk over the same buffers.
Here:

* whole-chunk, double-buffered ``Engine.generate`` gives the JAX
  ``Engine.generate``'s greedy tokens at f32 (JAX on its plain path),
  monolithic and paged, with an f32 and an int8 cache, with a budget that
  is no multiple of the chunk and with an EOS inside a chunk;
* the engine's own caches are reused across calls;
* a stand-in for the capture (``Rerun``: a capture runs the body and undoes
  it, as a capture records without running; a replay re-runs the body with
  its counts kept out of the tables, as a replay runs no Python) drives
  the capture path's plumbing: logits and pos carried between chunks of
  different C, the page table copied in, the batcher's bucket downshift,
  the launch-count reckoning and the graph keys of a serving schedule.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops import sampling
from tinyllama_tpu_torch.ops.kernels import counts
from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime import graphs
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import kv_planes
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher

JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
#: the JAX and port policies of each cache kind, f32 activations
KV = {"f32": ("q8", "f32", "f32"), "i8": ("q8", "f32", "i8")}
PROMPT = [1, 17, 300, 42, 9, 250, 77]
#: 21 new tokens in chunks of 8: three whole chunks, the last one cut
N_NEW, CHUNK = 21, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many tiny ops: with the test
    workers sharing the host's cores, eight threads a worker each spin for
    the cores and the tiny ops run tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_jax(tree):
    """The port's parameters as the JAX package's, bits unchanged."""
    if isinstance(tree, QTensor):
        return jcodec.QTensor(data=jnp.asarray(tree.data.numpy()),
                              scales=jnp.asarray(tree.scales.numpy()),
                              kind=tree.kind, layout=tree.layout)
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def both_params():
    """Random q8 parameters (torch seed 0) for both packages."""
    pp = llama.init_quantized_params(CFG, pconfig.DtypePolicy(*KV["f32"]),
                                     torch.Generator().manual_seed(0))
    return _to_jax(pp), pp


def _engine(pp, kv="f32", paged=False, **kw):
    return Engine(CFG, pconfig.DtypePolicy(*KV[kv]), pp, device="cpu",
                  paged=paged, **kw)


def _gen(eos=-1, **kw):
    return dict(n_predict=len(PROMPT) + N_NEW, greedy=True, eos_token=eos,
                chunk_size=CHUNK, **kw)


class Rerun:
    """The capture's stand-in on the CPU. A capture records the body
    without running it: here it runs the body (its counts go to the
    capture's tally) and then puts back every tensor the chunk writes and
    the generator's state. A replay runs no Python: here it re-runs the
    body with its counts kept out of the tables."""

    def __init__(self, state):
        self.state = state  # () -> the tensors a chunk may write

    def warm_up(self, body):
        body()

    def __call__(self, body, generator):
        saved = [t.clone() for t in self.state()]
        gstate = None if generator is None else generator.get_state()
        body()
        for t, s in zip(self.state(), saved):
            t.copy_(s)
        if gstate is not None:
            generator.set_state(gstate)

        def replay():
            with counts.tally(launched=False):
                body()
        return replay


def _rerun(eng, *stores):
    """Give `eng` the stand-in capture (before its first chunk over any
    store); it restores the engine's caches, the stores in its `stores`
    list and every static buffer."""
    def state():
        caches = list(eng._caches.values()) + capture.stores
        bufs = [t for cg in eng._chunk_graphs.values()
                for b in cg.buffers.values()
                for t in (b.logits, b.pos, b.done, *b.tokens.values())
                + ((b.table,) if b.table is not None else ())]
        return [p for c in caches for p in kv_planes(c)] + bufs

    capture = eng._capture = Rerun(state)
    capture.stores = list(stores)
    return capture


# --- generate against JAX -----------------------------------------------------


_jax_runs: dict = {}


def _jax_generate(jp, kv, paged, eos):
    key = (kv, paged, eos)
    if key not in _jax_runs:
        eng = _jax_runs.setdefault((kv, paged), JaxEngine(
            JCFG, JaxPolicy(*KV[kv]), jp, paged=paged, use_pallas=False))
        out, _ = eng.generate(PROMPT, JaxGen(**_gen(eos)))
        _jax_runs[key] = [int(t) for t in out]
    return _jax_runs[key]


def _eos_mid_chunk(tokens):
    """A token of `tokens` first seen at an index inside the second chunk
    (not its first step), and that index."""
    for i in range(CHUNK + 1, 2 * CHUNK):
        if tokens[i] not in tokens[:i]:
            return tokens[i], i
    raise AssertionError("no token first seen inside the second chunk")


@pytest.mark.parametrize("case", ["budget", "eos"])
@pytest.mark.parametrize("kv", ["f32", "i8"])
@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_generate_matches_jax(both_params, paged, kv, case):
    """Greedy f32 tokens of whole-chunk, double-buffered generate equal the
    JAX generate's: 21 new tokens in chunks of 8 (three whole chunks, 24
    steps run); with an EOS first sampled at step 9-15, the tokens before
    it, and one chunk run past it. The stream gives the same tokens in
    the same order."""
    jp, pp = both_params
    want = _jax_generate(jp, kv, paged, -1)
    eos = -1
    if case == "eos":
        eos, at = _eos_mid_chunk(want)
        want = _jax_generate(jp, kv, paged, eos)
        assert len(want) == at
    streamed = []
    eng = _engine(pp, kv, paged)
    out, stats = eng.generate(PROMPT, pconfig.GenerationConfig(**_gen(eos)),
                              stream=streamed.append)
    assert out == want and streamed == out
    assert len(out) == (N_NEW if case == "budget" else at)
    assert stats.decode_steps == 3 * CHUNK
    assert len(stats.decode_token_times) == (3 if case == "budget" else 2)
    assert stats.generated_tokens == len(out)


# --- the engine's caches ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["mono", "paged", "i8"])
def test_cache_reuse_gives_a_fresh_cache_tokens(both_params, kind):
    """The engine keeps one cache a batch size and rewrites it from
    position 0: after a long prompt, a shorter one gives a fresh engine's
    tokens, in generate and in generate_batch."""
    _, pp = both_params
    kv, paged = ("i8", False) if kind == "i8" else ("f32", kind == "paged")
    used, fresh = _engine(pp, kv, paged), _engine(pp, kv, paged)
    long_, short = list(range(1, 25)), PROMPT[:4]
    gen = pconfig.GenerationConfig(n_predict=28, greedy=True, eos_token=-1,
                                   chunk_size=CHUNK)
    used.generate(long_, gen)
    cache = used._caches[1]
    assert used.generate(short, gen)[0] == fresh.generate(short, gen)[0]
    assert used._caches[1] is cache
    used.generate_batch([long_, long_[:20]], gen)
    pair = [short, PROMPT]
    assert used.generate_batch(pair, gen)[0] == fresh.generate_batch(pair, gen)[0]
    assert sorted(used._caches) == [1, 2]


# --- the static buffers through the stand-in capture ----------------------------


def _prefilled(eng, prompts):
    cache = eng.new_cache(len(prompts))
    logits, lens = eng.prefill(cache, prompts)
    return cache, logits, torch.from_numpy(lens.astype(np.int32))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_chained_chunks_equal_the_eager_chunk(both_params, paged, rows):
    """Chunks of C = 4, 2, 4, 2 through run_chunk (two captures, then their
    replays) equal the eager chunk from the same state: tokens, done,
    logits, pos and the cache. Monolithic, the logits and pos come back
    as the input buffers and go in again as they are (no copy). Paged,
    each chunk's table is a host array copied into the buffer: the rows
    in another order each chunk, with their logits and pos."""
    _, pp = both_params
    eng = _engine(pp, paged=paged)
    prompts = [PROMPT, PROMPT[:3], [1, 5, 9, 2, 7]][:rows]
    eager, logits_e, pos_e = _prefilled(eng, prompts)
    store, logits, pos = _prefilled(eng, prompts)
    _rerun(eng, store)
    gen = pconfig.GenerationConfig(greedy=True, eos_token=-1)
    cg = eng.chunk_graphs(store)
    for i, C in enumerate((4, 2, 4, 2)):
        out_e = eng.chunk(eager, logits_e, pos_e, C, gen)
        _, _, logits_e, pos_e = out_e
        if paged:
            perm = np.roll(np.arange(rows), i)
            view = store.with_table(torch.from_numpy(store.table.numpy()[perm]))
            out = eng.run_chunk(view, logits[perm], pos[perm], C, gen)
            assert torch.equal(cg.buffers[rows].table, view.table)
            out = [t[np.argsort(perm)] for t in out]
        else:
            out = eng.run_chunk(store, logits, pos, C, gen)
            assert out[2] is cg.buffers[rows].logits
            assert out[3] is cg.buffers[rows].pos
        for got, want in zip(out, out_e):
            assert torch.equal(got, want)
        logits, pos = out[2], out[3]
    for a, b in zip(kv_planes(store), kv_planes(eager)):
        assert torch.equal(a, b)
    assert eng.graph_stats["graphs"] == 2 and len(cg.graphs) == 2


def test_topk_draws_follow_the_generator(both_params):
    """Top-k through run_chunk draws the eager chunk's tokens from the same
    seed, across a capture and its replays; the sampler's draw is
    torch.multinomial's from the same generator state."""
    _, pp = both_params
    eng = _engine(pp)
    eager, logits_e, pos_e = _prefilled(eng, [PROMPT])
    store, logits, pos = _prefilled(eng, [PROMPT])
    _rerun(eng, store)
    gen = pconfig.GenerationConfig(greedy=False, top_k=40, temperature=1.3,
                                   eos_token=-1)
    g_e, g = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    for C in (4, 4, 4):
        toks_e, _, logits_e, pos_e = eng.chunk(eager, logits_e, pos_e, C, gen,
                                               g_e)
        toks, _, logits, pos = eng.run_chunk(store, logits, pos, C, gen, g)
        assert torch.equal(toks, toks_e) and torch.equal(logits, logits_e)
    logits = torch.randn(5, 64, generator=g)
    a, b = (torch.Generator().manual_seed(3) for _ in range(2))
    vals, idx = torch.topk(logits, 40)
    want = idx.gather(1, torch.multinomial(torch.softmax(vals / 0.7, -1), 1,
                                           generator=a))[:, 0]
    for _ in range(3):  # and the generator's state after each draw
        assert torch.equal(sampling.sample_top_k(logits, b, 0.7, 40).long(),
                           want)
        want = idx.gather(1, torch.multinomial(torch.softmax(vals / 0.7, -1),
                                               1, generator=a))[:, 0]
    out = [eng.generate(PROMPT, pconfig.GenerationConfig(
        n_predict=20, greedy=False, top_k=40, seed=5, chunk_size=4))[0]
        for _ in range(2)]
    assert out[0] == out[1] and len(out[0]) > 0


def _serving_run(eng, rerun=False):
    """Paged, 4 slots: one request runs alone (bucket 1), then 4 late
    arrivals grow the bucket to 4, and they finish at staggered lengths
    (4, 2, 1 again); with `rerun`, through the stand-in capture. Returns
    (outputs, buckets seen, batcher)."""
    prompts = [[3, 7, 1], [9, 2, 4, 8, 5], [11, 6], [1, 2, 3, 4], [5, 5, 5]]
    max_news = [27, 3, 7, 21, 12]
    gen = pconfig.GenerationConfig(n_predict=30, greedy=True, eos_token=-1,
                                   chunk_size=4)
    capture = _rerun(eng) if rerun else None
    b = ContinuousBatcher(eng, gen, max_batch=4, page_size=16)
    if rerun:
        capture.stores.append(b.pool)
    ids = [b.submit(prompts[0], max_new=max_news[0])]
    for _ in range(3):
        b.step()
    ids += [b.submit(p, max_new=n) for p, n in zip(prompts[1:], max_news[1:])]
    seen = [b._bucket]
    while b.has_work:
        b.step()
        seen.append(b._bucket)
    return [b.results[i].output for i in ids], seen, b


def test_batcher_downshift_through_the_buffers(both_params):
    """The paged batcher with the stand-in capture: the positions and the
    bucket's table from the host and the rows gathered into each bucket's
    buffers and scattered back give the eager batcher's tokens and
    buckets; the full-width logits are the B = 4 buffer itself."""
    _, pp = both_params
    want, buckets, _ = _serving_run(_engine(pp, paged=True))
    eng = _engine(pp, paged=True)
    got, seen, b = _serving_run(eng, rerun=True)
    assert got == want and seen == buckets
    assert b.logits is b.graphs.buffers[4].logits
    assert set(b.graphs.buffers) == {1, 2, 4}
    assert eng.graph_stats["graphs"] == len(b.graphs.graphs)


#: a stand-in launch table: one count a decode step
STEPS = {"step": 0}


@pytest.fixture
def step_counts(monkeypatch):
    real = Engine.decode_step

    def counted(self, cache, tokens, pos):
        counts.count(STEPS, "step")
        return real(self, cache, tokens, pos)

    monkeypatch.setattr(Engine, "decode_step", counted)
    STEPS["step"] = 0
    return STEPS


def test_launch_reckoning_is_exact(both_params, step_counts):
    """A capture counts nothing, its eager first run counts its launches,
    and each replay adds the capture's tally once: the counts equal the
    steps run, over generate (one capture, two replays), generate_batch
    and a serving schedule; a capture whose tally differs from its eager
    run's raises, and a failed capture raises."""
    _, pp = both_params
    eng = _engine(pp)
    _rerun(eng)
    _, stats = eng.generate(PROMPT, pconfig.GenerationConfig(**_gen()))
    assert step_counts["step"] == stats.decode_steps == 24
    _, stats = eng.generate_batch([PROMPT, PROMPT[:5]],
                                  pconfig.GenerationConfig(**_gen()))
    assert step_counts["step"] == 24 + stats.decode_steps
    step_counts["step"] = 0
    recorded = []
    real = Engine.run_chunk

    def rec(self, cache, logits, pos, C, *a, **k):
        recorded.append(C)  # a chunk runs C decode steps at any batch
        return real(self, cache, logits, pos, C, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Engine, "run_chunk", rec)
        _serving_run(_engine(pp, paged=True), rerun=True)
    assert step_counts["step"] == sum(recorded)
    with counts.tally(launched=False) as t:
        counts.count(STEPS, "step")
    t.add(3)
    assert step_counts["step"] == sum(recorded) + 3

    class Twice(Rerun):
        def __call__(self, body, generator):
            super().__call__(body, generator)
            return super().__call__(body, generator)

    class Fails(Rerun):
        def __call__(self, body, generator):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    gen = pconfig.GenerationConfig(**_gen())
    for capture, match in ((Twice, "the captured chunk launches"),
                           (Fails, "not permitted")):
        eng = _engine(pp)
        eng._capture = capture(_rerun(eng).state)
        eng._capture.stores = []
        with pytest.raises(RuntimeError, match=match):
            eng.generate(PROMPT, gen)
        assert all(not cg.graphs for cg in eng._chunk_graphs.values())


def test_graph_keys_of_a_serving_schedule(both_params):
    """(f)'s schedule at tiny size: 16 requests (prompts 3-40 tokens, 4-24
    new, numpy seed 5) through 8 paged slots, chunk 8: one graph for
    each (bucket, C) the batcher ran, buckets and C powers of two up to 8;
    with ttft_chunk = 2, C = 2 joins them. Each later chunk of a key is a
    replay."""
    _, pp = both_params
    rng = np.random.default_rng(5)
    lens, news = rng.integers(3, 41, 16), rng.integers(4, 25, 16)
    reqs = [[1] + rng.integers(2, CFG.n_vocab, n - 1).tolist() for n in lens]
    for ttft in (0, 2):
        eng = _engine(pp, paged=True)
        capture = _rerun(eng)
        b = ContinuousBatcher(eng, pconfig.GenerationConfig(
            greedy=True, eos_token=-1, chunk_size=8), max_batch=8,
            ttft_chunk=ttft)
        capture.stores.append(b.pool)
        ran = []
        real = eng.run_chunk

        def rec(cache, logits, pos, C, *a, **k):
            ran.append((logits.shape[0], C))
            return real(cache, logits, pos, C, *a, **k)

        eng.run_chunk = rec
        for r, n in zip(reqs, news):
            b.submit(r, max_new=int(n))
        b.run()
        keys = set(ran)
        assert {k[:2] for k in b.graphs.graphs} == keys
        assert eng.graph_stats["graphs"] == len(keys) <= 16
        assert all(B in (1, 2, 4, 8) and C in (1, 2, 4, 8) for B, C in keys)
        assert len(ran) > len(keys)
        assert ttft == 0 or (8, 2) in keys


# --- hygiene --------------------------------------------------------------------


PKG = Path(__file__).resolve().parents[1] / "tinyllama_tpu_torch"


@pytest.mark.parametrize("module", ["runtime/graphs.py", "ops/kernels/counts.py"])
def test_graph_modules_import_torch_and_the_standard_library(module):
    tree = ast.parse((PKG / module).read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert tops <= {"__future__", "contextlib", "collections", "dataclasses",
                    "gc", "threading", "time", "typing", "torch",
                    "tinyllama_tpu_torch"}, tops
    assert graphs.capture_for(torch.device("cpu")) is None


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_engine_with_graphs_is_freed(both_params, paged):
    """An engine whose chunks ran through run_chunk over its own cache
    (generate keeps one cache a batch size) is freed once nothing refers
    to it: the finalizer that drops its graphs with a storage holds the
    engine weakly, so the engine, its caches and its graphs go together."""
    import gc
    import weakref

    _, pp = both_params
    eng = _engine(pp, paged=paged)
    eng.generate(PROMPT, pconfig.GenerationConfig(**_gen()))
    assert eng._chunk_graphs
    gone = weakref.ref(eng)
    del eng
    gc.collect()
    assert gone() is None


@pytest.mark.parametrize("raises", [False, True])
def test_capturing_holds_the_collector_off(monkeypatch, raises):
    """Every capture of the port (``graphs.capturing``) runs in the
    thread-local mode with the cyclic collector off (a collection inside a
    capture could destroy a dropped engine's graphs there) and turns it
    back on after, also when the body raises. A stand-in for
    torch.cuda.graph records what the capture saw."""
    import contextlib
    import gc

    seen = {}

    @contextlib.contextmanager
    def fake_graph(graph, **kwargs):
        seen.update(kwargs, graph=graph, collector=gc.isenabled())
        yield

    monkeypatch.setattr(graphs.torch.cuda, "graph", fake_graph)
    assert gc.isenabled()
    with contextlib.suppress(RuntimeError):
        with graphs.capturing("g", pool="p"):
            assert not gc.isenabled()
            if raises:
                raise RuntimeError("in the capture")
    assert gc.isenabled()
    assert seen == {"graph": "g", "pool": "p", "collector": False,
                    "capture_error_mode": "thread_local"}
