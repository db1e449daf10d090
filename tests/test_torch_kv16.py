"""The port's f16 and f32 KV caches (kv_dtype "f16", "f32") against the
JAX package's.

Every input is made from a numpy seed and given to both packages: pools
cross to the port through ``interop.cache_from_numpy``, parameters
through ``params_from_numpy``. On the CPU the port's kernel wrappers take
their plain versions, which cast the cache views to the queries' dtype;
the JAX side runs its Pallas kernels in interpret mode, which cast each
tile to the compute dtype as they load it.

* Every cache write (monolithic, paged, staged, flushed) into an f16
  cache leaves planes bit-equal to JAX's, and the views equal JAX's.
* The plain versions of K3, K4, K8, K9, K10 and K11 over f16 and f32
  caches match the Pallas kernels within rtol/atol 1e-4 at f32 queries
  and the JAX suite's bf16 kernel tolerance, rtol 2e-2 / atol 5e-3
  (tests/test_tpu_kernels.py), at bf16 queries.
* Greedy f32 tokens with an f16 cache equal JAX's, monolithic and paged,
  and the CLI's ``--kv f16`` runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.pallas import attn_out_fused as jattn
from tinyllama_tpu.ops.pallas import flash_paged as jfpaged
from tinyllama_tpu.ops.pallas import flash_prefill as jfprefill
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime import paged as jpaged
from tinyllama_tpu.runtime import staging as jstaging
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import (
    cache_from_numpy,
    params_from_numpy,
    qtensor_from_numpy,
)
from tinyllama_tpu_torch.ops.kernels import (
    attn_out_fused,
    flash_attention,
    flash_paged,
)
from tinyllama_tpu_torch.runtime import kvcache, paged, staging
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
L, Kh, d = CFG.n_layers, CFG.n_kv_heads, CFG.d_head
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=5e-3)}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
NP = {"f16": np.float16, "f32": np.float32}

#: pools of the write and flush tests: 3 rows, max_ctx 256 in 64-position
#: pages, a 5-step chunk; chunk bases straddling a page, or past max_ctx
B, S, P, C = 3, 256, 64, 5
J = S // P
BASES = {"straddle": [60, 33, 126], "limit": [S - 3, S - 5, 40]}


# --- shared inputs ------------------------------------------------------------


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _bits(a):
    """An array's bytes as integers, for bit-equality."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _assert_planes_equal(port, jax_planes):
    for got, want in zip(port, jax_planes):
        assert got.dtype == TORCH[{np.dtype(np.float16): "f16",
                                   np.dtype(np.float32): "f32"}[
                                       np.asarray(want).dtype]]
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _table(rows, n_pages):
    """Row b's pages, reversed, so logical and physical order differ;
    page 0 stays the scratch page."""
    return (1 + np.arange(rows * n_pages, dtype=np.int32)).reshape(
        rows, n_pages)[:, ::-1].copy()


def _pools(kind, dtype, seed, rows=B, length=S, page=P, heads=Kh, dim=d):
    """The same random pool of `dtype` ("f16", "f32") for both packages:
    monolithic [L, rows, heads, length, dim] or a page pool of 1 + rows *
    length / page pages under `_table`."""
    rng = np.random.default_rng(seed)
    if kind == "mono":
        shape = (L, rows, heads, length, dim)
    else:
        shape = (L, 1 + rows * (length // page), heads, page, dim)
    k, v = (rng.standard_normal(shape).astype(NP[dtype]) for _ in range(2))
    if kind == "mono":
        return (jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=None,
                            v_scale=None),
                cache_from_numpy(k, v))
    table = _table(rows, length // page)
    return (jpaged.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                k_scale=None, v_scale=None,
                                table=jnp.asarray(table)),
            cache_from_numpy(k, v, table))


def _step_kv(rng, rows=B, T=1):
    return [rng.standard_normal((rows, T, Kh, d)).astype(np.float32)
            for _ in range(2)]


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


# --- cache writes and views ---------------------------------------------------


def test_cache_write_and_view_match_jax():
    """update_cache_at_layer into zeroed f16 caches (a 9-token prefill
    from 0, then single tokens at unequal positions, both layers) leaves
    the planes bit-equal to JAX's; layer_cache_view reads what JAX's
    reads, at f32 and bf16."""
    jc = jkv.init_cache(JCFG, B, "f16", max_ctx=S)
    pc = kvcache.init_cache(CFG, B, "f16", max_ctx=S)
    assert not pc.quantized and pc.k.dtype == torch.float16
    rng = np.random.default_rng(1)
    writes = [(np.zeros(B, np.int32), 9), (np.array([9, 63, 64], np.int32), 1),
              (np.array([10, 200, S - 1], np.int32), 1)]
    for pos, T in writes:
        for li in range(L):
            k, v = _step_kv(rng, T=T)
            jc = jkv.update_cache_at_layer(jc, jnp.int32(li), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(pos))
            kvcache.update_cache_at_layer(pc, li, torch.from_numpy(k),
                                          torch.from_numpy(v),
                                          torch.from_numpy(pos))
    _assert_planes_equal(kvcache.kv_planes(pc), [jc.k, jc.v])
    for dt in ("f32", "bf16"):
        want = jkv.layer_cache_view(jc, jnp.int32(1), JNP[dt])
        got = kvcache.layer_cache_view(pc, 1, TORCH[dt])
        for g, w in zip(got, want):
            assert g.dtype == TORCH[dt]
            np.testing.assert_array_equal(_f32(g), _f32(w))


def test_paged_write_and_view_match_jax():
    """update_paged_at_layer on an f16 pool (a 70-token prefill from 0
    that straddles a page, single tokens at a page's last and first
    position, and one past max_ctx) leaves the planes bit-equal to JAX's;
    paged_layer_view reads what JAX's reads, trimmed or not."""
    jpool, ppool = _pools("paged", "f16", seed=2)
    rng = np.random.default_rng(3)
    writes = [(np.zeros(B, np.int32), 70), (np.array([P - 1, P, P + 5], np.int32), 1),
              (np.array([S + 2, 3 * P, 17], np.int32), 1)]
    for pos, T in writes:
        k, v = _step_kv(rng, T=T)
        jpool = jpaged.update_paged_at_layer(jpool, jnp.int32(1), jnp.asarray(k),
                                             jnp.asarray(v), jnp.asarray(pos))
        paged.update_paged_at_layer(ppool, 1, torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos))
    _assert_planes_equal(kvcache.kv_planes(ppool), [jpool.k, jpool.v])
    for bound in (None, 70):
        want = jpaged.paged_layer_view(jpool, jnp.int32(1), jnp.float32, bound)
        got = paged.paged_layer_view(ppool, 1, torch.float32, bound)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", list(BASES))
@pytest.mark.parametrize("kind", ["mono", "paged"])
def test_staged_write_flush_and_view_match_jax(kind, case):
    """C staged steps in both layers over an f16 pool, chunks that
    straddle a page and chunks that run past max_ctx: the staged tail (in
    the pool's dtype), the view of pool + tail, and the flushed pool
    (whose flush keeps to max_ctx) are bit-equal to JAX's."""
    jpool, ppool = _pools(kind, "f16", seed=4)
    base = np.asarray(BASES[case], np.int32)
    jst = jstaging.stage_cache(jpool, jnp.asarray(base), C)
    pst = staging.stage_cache(ppool, torch.from_numpy(base), C)
    assert pst.sk.dtype == torch.float16 and not pst.quantized
    rng = np.random.default_rng(5)
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
    _assert_planes_equal([p[:, :, :, :C] for p in pst.planes()],
                         [p[:, :, :, :C] for p in (jst.sk, jst.sv)])
    want = jstaging.staged_layer_view(jst, jnp.int32(1), jnp.float32)
    got = staging.staged_layer_view(pst, 1, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    flushed = jstaging.flush_staged(jst, C)
    _assert_planes_equal(kvcache.kv_planes(staging.flush_staged(pst, C)),
                         [flushed.k, flushed.v])


# --- the attention kernels: K3, K4, K8, K9, K10, K11 ---------------------------

#: (queries' dtype, rows, query heads per kv head, positions): f32 at B =
#: 4 and G = 8 over pos 0, 5, 100 and a page boundary; bf16 at B = 1, G = 4
KERNEL_CASES = [("f32", 4, 8, [0, 5, 100, P]), ("bf16", 1, 4, [100])]
KS, KKH, KD = 256, 2, 32  # kernel caches: length, kv heads, head dim


def _q(dtype, shape, seed):
    jq = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                     JNP[dtype])
    return jq, torch.from_numpy(_f32(jq)).to(TORCH[dtype])


def _check(got, want, dtype):
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("dtype,rows,G,pos", KERNEL_CASES)
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_flash_attention_kv16_matches_pallas(kernel, dtype, rows, G, pos, kv):
    """K3 (8 new tokens from each row's pos) and K4 (T = 1 at pos) over
    an f16 or f32 cache of layer 1."""
    jc, pc = _pools("mono", kv, seed=6, rows=rows, length=KS, heads=KKH, dim=KD)
    T = 8 if kernel == "K3" else 1
    jq, pq = _q(dtype, (rows, T, KKH * G, KD), seed=7)
    jfn, pfn = {"K3": (jfprefill.flash_prefill_attention,
                       flash_attention.flash_prefill_attention),
                "K4": (jfprefill.flash_decode_heads_attention,
                       flash_attention.flash_decode_heads_attention)}[kernel]
    want = jfn(jq, jc, jnp.int32(1), jnp.asarray(pos, jnp.int32), interpret=True)
    _check(pfn(pq, pc, _i32([1]), _i32(pos)), want, dtype)


@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("dtype,G,pos", [("f32", 8, 100), ("f32", 4, 0),
                                         ("bf16", 4, 5)])
def test_fused_attn_out_kv16_matches_pallas(dtype, G, pos, kv):
    """K8: attention over keys 0..pos of an f16 or f32 cache, then a q8
    wo (H * d to H * d) and the residual."""
    jc, pc = _pools("mono", kv, seed=8, rows=1, length=KS, heads=KKH, dim=KD)
    H = KKH * G
    D = H * KD
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((L, D, D)) * 0.05).astype(np.float32)
    jwo = jax.jit(jcodec.quantize, static_argnums=(1, 2))(jnp.asarray(w), "q8",
                                                           "kn")
    pwo = qtensor_from_numpy((np.asarray(jwo.data), np.asarray(jwo.scales),
                              "q8", "kn"))
    jq, pq = _q(dtype, (1, 1, H, KD), seed=10)
    jr, pr = _q(dtype, (1, 1, D), seed=11)
    want = jattn.fused_attn_out(jq, jc, jnp.int32(1), jnp.asarray([pos], jnp.int32),
                                jr, jwo, interpret=True)
    _check(attn_out_fused.fused_attn_out(pq, pc, _i32([1]), _i32([pos]), pr, pwo),
           want, dtype)


def _staged_tails(jpool, ppool, kv, base, fill, rows, seed):
    """Both packages' staged chunk over the pools: random slots [0, fill)
    in the pool's dtype, the rest never written."""
    rng = np.random.default_rng(seed)
    shape = (L, rows, KKH, 32, KD)
    sk, sv = (rng.standard_normal(shape).astype(NP[kv]) for _ in range(2))
    for a in (sk, sv):
        a[:, :, :, fill:] = 0
    jst = jstaging.StagedKVCache(pool=jpool, sk=jnp.asarray(sk), sv=jnp.asarray(sv),
                                 sk_scale=None, sv_scale=None,
                                 base=jnp.asarray(base, jnp.int32))
    pst = staging.StagedKVCache(ppool, torch.from_numpy(sk), torch.from_numpy(sv),
                                _i32(base))
    return jst, pst


@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("dtype,rows,G,pos", KERNEL_CASES)
@pytest.mark.parametrize("kernel", ["K9", "K10", "K11"])
def test_serving_attention_kv16_matches_pallas(kernel, dtype, rows, G, pos, kv):
    """K10 at pos over an f16 or f32 page pool (64-position pages, a
    reversed table); K9 (monolithic) and K11 (paged) with each row's
    chunk base at `pos` (on a page boundary, 5, 100) or at 62, with a
    4-slot tail that crosses into the next page."""
    kind = "mono" if kernel == "K9" else "paged"
    jpool, ppool = _pools(kind, kv, seed=12, rows=rows, length=KS, heads=KKH,
                          dim=KD)
    jq, pq = _q(dtype, (rows, 1, KKH * G, KD), seed=13)
    if kernel == "K10":
        want = jfpaged.flash_paged_attention(jq, jpool, jnp.int32(1),
                                             jnp.asarray(pos, jnp.int32),
                                             interpret=True)
        got = flash_paged.flash_paged_attention(pq, ppool, _i32([1]), _i32(pos))
        return _check(got, want, dtype)
    base = [P - 2 if p == 0 else p for p in pos]  # 62 crosses P, 64 is on it
    fill = 4
    jst, pst = _staged_tails(jpool, ppool, kv, base, fill, rows, seed=14)
    step = np.asarray(base, np.int32) + fill - 1
    jfn, pfn = {"K9": (jfprefill.flash_staged_attention,
                       flash_attention.flash_staged_attention),
                "K11": (jfpaged.flash_paged_staged_attention,
                        flash_paged.flash_paged_staged_attention)}[kernel]
    want = jfn(jq, jst, jnp.int32(1), jnp.asarray(step), interpret=True)
    _check(pfn(pq, pst, _i32([1]), torch.from_numpy(step)), want, dtype)


def test_wrappers_take_kv16_on_cpu(monkeypatch):
    """f16 and f32 caches on the CPU take the plain versions (no build,
    no launch count); the kernels' checks give them their own kinds and
    launch counters, and refuse scales beside them."""
    from tinyllama_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "load", lambda name: pytest.fail(f"built {name}"))
    before = dict(flash_attention.launches)
    for kv, code in (("f16", 2), ("f32", 3)):
        _, pc = _pools("mono", kv, seed=15, rows=1, length=KS, heads=KKH, dim=KD)
        q = torch.randn(1, 1, KKH * 4, KD, dtype=torch.bfloat16)
        got = flash_attention.flash_decode_heads_attention(q, pc, _i32([0]),
                                                           _i32([9]))
        torch.testing.assert_close(got, flash_attention.attention_ref(
            q, pc, _i32([0]), _i32([9])))
        assert flash_paged.kv_kind([pc.k, pc.v], [None, None]) == code
        scale = torch.ones(pc.k.shape[:-1])
        with pytest.raises(TypeError, match="no scales"):
            flash_paged.kv_kind([pc.k, pc.v], [scale, scale])
    assert flash_attention.launches == before
    assert flash_paged.KV_SUFFIX == ("", "_i8", "_f16", "_f32")
    names = {"flash_prefill", "flash_decode_heads", "flash_staged",
             "flash_paged", "flash_paged_staged", "fused_attn_out"}
    tables = {**flash_attention.launches, **flash_paged.launches,
              **attn_out_fused.launches}
    assert set(tables) == {n + sfx for n in names for sfx in flash_paged.KV_SUFFIX}


# --- the engine, the batcher and the CLI ------------------------------------------


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def both_params():
    jp = jllama.init_quantized_params(JCFG, jax.random.PRNGKey(0),
                                      JaxPolicy("q8", "f32", "f32"))
    return jp, params_from_numpy(_to_numpy(jp), CFG,
                                 pconfig.DtypePolicy("q8", "f32", "f32"))


def _prompt(n, seed):
    return [1] + np.random.default_rng(seed).integers(2, CFG.n_vocab,
                                                      n - 1).tolist()


@pytest.mark.parametrize("mode", ["generate", "generate_paged", "batcher",
                                  "batcher_paged"])
def test_greedy_f16_cache_matches_jax(both_params, mode):
    """Greedy f32 tokens with an f16 cache equal JAX's: ``generate`` (b1,
    the fused branch's K8 over the f16 cache; paged K10) against
    ``Engine(use_pallas=True)``, and 5 requests through a 2-slot
    ContinuousBatcher over a monolithic and a paged engine (16-position
    pages) against JAX's batcher on its plain path, which reads the same
    f16 pool through its views."""
    jp, pp = both_params
    jpol, ppol = JaxPolicy("q8", "f32", "f16"), pconfig.DtypePolicy("q8", "f32",
                                                                    "f16")
    is_paged = mode.endswith("paged")
    if mode.startswith("generate"):
        prompt = _prompt(20, len(mode))
        gen = dict(n_predict=32, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = JaxEngine(JCFG, jpol, jp, paged=is_paged, use_pallas=True
                            ).generate(prompt, JaxGen(**gen))
        eng = Engine(CFG, ppol, pp, device="cpu", paged=is_paged)
        assert eng.new_cache(1).k.dtype == torch.float16
        pout, _ = eng.generate(prompt, pconfig.GenerationConfig(**gen))
        assert len(pout) == 12 and pout == [int(t) for t in jout]
        return
    prompts = [[3, 7, 1], [9, 2, 4, 8, 5], [11, 6], [1, 2, 3, 4], [5, 5, 5]]
    gen = dict(n_predict=20, greedy=True, eos_token=-1, chunk_size=8)
    kw = dict(page_size=16) if is_paged else {}
    jb = JaxBatcher(JaxEngine(JCFG, jpol, jp, max_batch=2, use_pallas=False),
                    JaxGen(**gen), max_batch=2, paged=is_paged, **kw)
    pb = ContinuousBatcher(Engine(CFG, ppol, pp, device="cpu", paged=is_paged),
                           pconfig.GenerationConfig(**gen), max_batch=2, **kw)
    assert (pb.pool if is_paged else pb.cache).k.dtype == torch.float16
    jids = [jb.submit(p) for p in prompts]
    pids = [pb.submit(p) for p in prompts]
    jres, pres = jb.run(), pb.run()
    for jr, pr in zip(jids, pids):
        assert pres[pr].output == [int(t) for t in jres[jr].output]
        assert pres[pr].done and len(pres[pr].output) > 0


@pytest.mark.parametrize("kv", ["f16", "f32"])
def test_cli_kv16_runs_on_cpu(capsys, monkeypatch, kv):
    """``--kv f16`` and ``--kv f32`` reach the engine's policy and its
    cache, on the CPU; the performance table counts the cache's bytes in
    its dtype."""
    seen = []

    class Spy(Engine):
        def new_cache(self, batch):
            cache = super().new_cache(batch)
            seen.append(cache.k.dtype)
            return cache

    monkeypatch.setattr(cli, "Engine", Spy)
    assert cli.main(["--random-weights", "--model", "tiny-test", "-p", "hello",
                     "-greedy", "--npred", "12", "--device", "cpu", "--kv",
                     kv]) == 0
    assert set(seen) == {TORCH[kv]}
    out = capsys.readouterr()
    assert len(out.err.split()) == 12 - 6 and "Throughput" in out.out
    from tinyllama_tpu_torch.runtime.perf import tree_nbytes
    assert tree_nbytes(kvcache.init_cache(CFG, 1, kv)) == \
        L * Kh * CFG.max_ctx * d * 2 * TORCH[kv].itemsize
