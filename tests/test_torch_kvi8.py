"""The port's int8 KV cache (kv_dtype "i8") against the JAX package's.

Every input is made from a numpy seed and given to both packages: int8
pools (random int8 data, f32 scales) cross to the port through
``interop.cache_from_numpy``, parameters through ``params_from_numpy``.
On the CPU the port's kernel wrappers take their plain versions, which
dequantize through the cache views; the JAX side runs its Pallas
kernels in interpret mode, as its own tests do.

* The quantizer and every cache write (monolithic, paged, staged,
  flushed) must be bit-equal to JAX's, data and scales, and the three
  views equal JAX's views.
* The plain versions of K3, K4, K8, K9, K10 and K11 over int8 caches
  must match the Pallas kernels within rtol/atol 1e-4 at f32 (only the
  order of the scale multiplies differs: the plain versions dequantize,
  the kernels fold the scales into scores and probabilities) and within
  the JAX suite's bf16 kernel tolerance, rtol 2e-2 / atol 5e-3, at bf16
  (tests/test_tpu_kernels.py), where the two also round at other places.
* ``forward`` matches ``forward(use_pallas=True)`` with an i8 cache at
  f32 within rtol/atol 1e-4, and greedy f32 tokens equal the JAX
  engine's and batcher's with an i8 cache, monolithic and paged, with q8
  and q4g weights.
"""

import ast
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
from tinyllama_tpu_torch.models import llama
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
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}

#: pools of the write and flush tests: 3 rows, max_ctx 256 in 64-position
#: pages, a 5-step chunk; chunk bases straddling a page, or past max_ctx
B, S, P, C = 3, 256, 64, 5
J = S // P
BASES = {"straddle": [60, 33, 126], "limit": [S - 3, S - 5, 40]}


# --- shared inputs ------------------------------------------------------------


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _bits(a):
    """An array's bytes as integers, for bit-equality of f32 scales."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_planes_equal(port, jax_planes):
    for got, want in zip(port, jax_planes):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _i8_planes(rng, shape):
    """Random int8 data and positive f32 scales for one k or v plane."""
    data = rng.integers(-127, 128, shape).astype(np.int8)
    scale = (rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
    return data, scale


def _table(rows, n_pages):
    """Row b's pages, reversed, so logical and physical order differ;
    page 0 stays the scratch page."""
    return (1 + np.arange(rows * n_pages, dtype=np.int32)).reshape(
        rows, n_pages)[:, ::-1].copy()


def _pools(kind, seed, rows=B, length=S, page=P, heads=Kh, dim=d):
    """The same random int8 pool for both packages (JAX pool, port pool):
    monolithic [L, rows, heads, length, dim] or a page pool of 1 + rows *
    length / page pages under `_table`."""
    rng = np.random.default_rng(seed)
    if kind == "mono":
        shape = (L, rows, heads, length, dim)
    else:
        shape = (L, 1 + rows * (length // page), heads, page, dim)
    (k, ks), (v, vs) = _i8_planes(rng, shape), _i8_planes(rng, shape)
    if kind == "mono":
        jpool = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        return jpool, cache_from_numpy(k, v, k_scale=ks, v_scale=vs)
    table = _table(rows, length // page)
    jpool = jpaged.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                                table=jnp.asarray(table))
    return jpool, cache_from_numpy(k, v, table, k_scale=ks, v_scale=vs)


def _jax_planes(cache):
    return [cache.k, cache.v, cache.k_scale, cache.v_scale]


def _step_kv(rng, rows=B, T=1):
    return [rng.standard_normal((rows, T, Kh, d)).astype(np.float32)
            for _ in range(2)]


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


# --- the quantizer ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """quantize_kv gives JAX _quantize_kv's int8 data and f32 scales bit
    for bit, with an all-zero head row (scale 0, data 0), values at
    +-absmax (+-127) and .5 ties (half to even)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 7, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 0.25
    x[0, 0, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -127.0]
    x[1, 2, 3, 0] = -2 * np.abs(x[1, 2, 3]).max()  # -absmax: -127
    jx = jnp.asarray(x, JNP[dtype])
    jq, js = jkv._quantize_kv(jx)
    pq, ps = kvcache.quantize_kv(torch.from_numpy(_f32(jx)).to(TORCH[dtype]))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    _assert_planes_equal([pq, ps], [jq, js])
    assert pq[0, 0, 1, :6].tolist() == [127, 0, 2, 2, 0, -127]
    assert float(ps[0, 0, 0]) == 0.0 and not pq[0, 0, 0].any()
    assert pq[1, 2, 3, 0] == -127


# --- cache writes and views ---------------------------------------------------


def test_cache_write_and_view_match_jax():
    """update_cache_at_layer into zeroed int8 caches (a 9-token prefill
    from 0, then single tokens at unequal positions, both layers) leaves
    every data and scale plane bit-equal to JAX's; layer_cache_view reads
    what JAX's reads, at f32 and bf16."""
    jc = jkv.init_cache(JCFG, B, "i8", max_ctx=S)
    pc = kvcache.init_cache(CFG, B, "i8", max_ctx=S)
    assert pc.quantized and pc.k.dtype == torch.int8
    assert pc.k_scale.shape == pc.k.shape[:-1] == (L, B, Kh, S)
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
    _assert_planes_equal(kvcache.kv_planes(pc), _jax_planes(jc))
    for dt in ("f32", "bf16"):
        want = jkv.layer_cache_view(jc, jnp.int32(1), JNP[dt])
        got = kvcache.layer_cache_view(pc, 1, TORCH[dt])
        for g, w in zip(got, want):
            assert g.dtype == TORCH[dt]
            np.testing.assert_array_equal(_f32(g), _f32(w))


def test_paged_write_and_view_match_jax():
    """update_paged_at_layer on an int8 pool (a 70-token prefill from 0
    that straddles a page, single tokens at a page's last and first
    position, and one past max_ctx) leaves every plane bit-equal to
    JAX's; paged_layer_view reads what JAX's reads, trimmed or not; the
    pool keeps its scales under another table."""
    jpool, ppool = _pools("paged", seed=2)
    rng = np.random.default_rng(3)
    writes = [(np.zeros(B, np.int32), 70), (np.array([P - 1, P, P + 5], np.int32), 1),
              (np.array([S + 2, 3 * P, 17], np.int32), 1)]
    for pos, T in writes:
        k, v = _step_kv(rng, T=T)
        jpool = jpaged.update_paged_at_layer(jpool, jnp.int32(1), jnp.asarray(k),
                                             jnp.asarray(v), jnp.asarray(pos))
        paged.update_paged_at_layer(ppool, 1, torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos))
    _assert_planes_equal(kvcache.kv_planes(ppool), _jax_planes(jpool))
    for bound in (None, 70):
        want = jpaged.paged_layer_view(jpool, jnp.int32(1), jnp.float32, bound)
        got = paged.paged_layer_view(ppool, 1, torch.float32, bound)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    other = ppool.with_table(np.zeros((1, J), np.int32))
    assert other.quantized and other.k_scale is ppool.k_scale


@pytest.mark.parametrize("case", list(BASES))
@pytest.mark.parametrize("kind", ["mono", "paged"])
def test_staged_write_flush_and_view_match_jax(kind, case):
    """C staged steps in both layers over an int8 pool, chunks that
    straddle a page and chunks that run past max_ctx: the staged data and
    scale planes, the view of pool + tail, and the flushed pool (whose
    flush keeps to max_ctx, for the scales as for the data) are
    bit-equal to JAX's."""
    jpool, ppool = _pools(kind, seed=4)
    base = np.asarray(BASES[case], np.int32)
    jst = jstaging.stage_cache(jpool, jnp.asarray(base), C)
    pst = staging.stage_cache(ppool, torch.from_numpy(base), C)
    assert pst.quantized and pst.sk_scale.shape == pst.sk.shape[:-1]
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
                         [p[:, :, :, :C] for p in (jst.sk, jst.sv, jst.sk_scale,
                                                   jst.sv_scale)])
    want = jstaging.staged_layer_view(jst, jnp.int32(1), jnp.float32)
    got = staging.staged_layer_view(pst, 1, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _assert_planes_equal(kvcache.kv_planes(staging.flush_staged(pst, C)),
                         _jax_planes(jstaging.flush_staged(jst, C)))


# --- the attention kernels: K3, K4, K8, K9, K10, K11 ---------------------------

#: (dtype, rows, query heads per kv head, positions): f32 at B = 4 and
#: G = 8 over pos 0, 5, 100 and a page boundary; bf16 at B = 1, G = 4
KERNEL_CASES = [("f32", 4, 8, [0, 5, 100, P]), ("bf16", 1, 4, [100])]
KS, KKH, KD = 256, 2, 32  # kernel caches: length, kv heads, head dim


def _q(dtype, shape, seed):
    jq = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                     JNP[dtype])
    return jq, torch.from_numpy(_f32(jq)).to(TORCH[dtype])


def _check(got, want, dtype):
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype,rows,G,pos", KERNEL_CASES)
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_flash_attention_i8_matches_pallas(kernel, dtype, rows, G, pos):
    """K3 (8 new tokens from each row's pos) and K4 (T = 1 at pos) over
    an int8 cache of layer 1."""
    jc, pc = _pools("mono", seed=6, rows=rows, length=KS, heads=KKH, dim=KD)
    T = 8 if kernel == "K3" else 1
    jq, pq = _q(dtype, (rows, T, KKH * G, KD), seed=7)
    jfn, pfn = {"K3": (jfprefill.flash_prefill_attention,
                       flash_attention.flash_prefill_attention),
                "K4": (jfprefill.flash_decode_heads_attention,
                       flash_attention.flash_decode_heads_attention)}[kernel]
    want = jfn(jq, jc, jnp.int32(1), jnp.asarray(pos, jnp.int32), interpret=True)
    _check(pfn(pq, pc, _i32([1]), _i32(pos)), want, dtype)


@pytest.mark.parametrize("dtype,G,pos", [("f32", 8, 100), ("f32", 4, 0),
                                         ("bf16", 4, 5)])
def test_fused_attn_out_i8_matches_pallas(dtype, G, pos):
    """K8: attention over keys 0..pos of an int8 cache, then a q8 wo
    (H * d to H * d) and the residual."""
    jc, pc = _pools("mono", seed=8, rows=1, length=KS, heads=KKH, dim=KD)
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


def _staged_tails(jpool, ppool, base, fill, rows, seed):
    """Both packages' staged chunk over the pools: random int8 slots
    [0, fill) with scales, the rest never written."""
    rng = np.random.default_rng(seed)
    shape = (L, rows, KKH, 32, KD)
    (sk, sks), (sv, svs) = _i8_planes(rng, shape), _i8_planes(rng, shape)
    for a in (sk, sks, sv, svs):
        a[:, :, :, fill:] = 0
    jst = jstaging.StagedKVCache(pool=jpool, sk=jnp.asarray(sk), sv=jnp.asarray(sv),
                                 sk_scale=jnp.asarray(sks),
                                 sv_scale=jnp.asarray(svs),
                                 base=jnp.asarray(base, jnp.int32))
    pst = staging.StagedKVCache(ppool, *(torch.from_numpy(a) for a in (sk, sv)),
                                _i32(base), sk_scale=torch.from_numpy(sks),
                                sv_scale=torch.from_numpy(svs))
    return jst, pst


@pytest.mark.parametrize("dtype,rows,G,pos", KERNEL_CASES)
@pytest.mark.parametrize("kernel", ["K9", "K10", "K11"])
def test_serving_attention_i8_matches_pallas(kernel, dtype, rows, G, pos):
    """K10 at pos over an int8 page pool (64-position pages, a reversed
    table); K9 (monolithic) and K11 (paged) with each row's chunk base at
    `pos` (on a page boundary, 5, 100) or at 62, with a 4-slot int8
    tail that crosses into the next page."""
    kind = "mono" if kernel == "K9" else "paged"
    jpool, ppool = _pools(kind, seed=12, rows=rows, length=KS, heads=KKH, dim=KD)
    jq, pq = _q(dtype, (rows, 1, KKH * G, KD), seed=13)
    if kernel == "K10":
        want = jfpaged.flash_paged_attention(jq, jpool, jnp.int32(1),
                                             jnp.asarray(pos, jnp.int32),
                                             interpret=True)
        got = flash_paged.flash_paged_attention(pq, ppool, _i32([1]), _i32(pos))
        return _check(got, want, dtype)
    base = [P - 2 if p == 0 else p for p in pos]  # 62 crosses P, 64 is on it
    fill = 4
    jst, pst = _staged_tails(jpool, ppool, base, fill, rows, seed=14)
    step = np.asarray(base, np.int32) + fill - 1
    jfn, pfn = {"K9": (jfprefill.flash_staged_attention,
                       flash_attention.flash_staged_attention),
                "K11": (jfpaged.flash_paged_staged_attention,
                        flash_paged.flash_paged_staged_attention)}[kernel]
    want = jfn(jq, jst, jnp.int32(1), jnp.asarray(step), interpret=True)
    _check(pfn(pq, pst, _i32([1]), torch.from_numpy(step)), want, dtype)


def test_wrappers_take_int8_on_cpu_and_refuse_bad_scales(monkeypatch):
    """An int8 cache on the CPU takes the plain versions (no build, no
    launch count); the kernels' input checks refuse int8 data without
    scales, scales beside bf16 or f32 data, scales of the wrong shape or
    dtype, planes of two dtypes and a dtype no kernel takes, before any
    launch."""
    from tinyllama_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "load", lambda name: pytest.fail(f"built {name}"))
    _, pc = _pools("mono", seed=15, rows=1, length=KS, heads=KKH, dim=KD)
    before = dict(flash_attention.launches)
    q = torch.randn(1, 1, KKH * 4, KD, dtype=torch.bfloat16)
    got = flash_attention.flash_decode_heads_attention(q, pc, _i32([0]), _i32([9]))
    torch.testing.assert_close(got, flash_attention.attention_ref(
        q, pc, _i32([0]), _i32([9])))
    assert flash_attention.launches == before
    k, v = pc.k, pc.v
    bf = k.to(torch.bfloat16)
    bad = {
        "int8 without scales": ([k, v], [None, None], TypeError, "needs its scale"),
        "scales with bf16": ([bf, bf], [pc.k_scale, pc.v_scale], TypeError,
                             "no scales"),
        "f16 scales": ([k, v], [pc.k_scale.half(), pc.v_scale], TypeError, "f32"),
        "scale shape": ([k, v], [pc.k_scale[..., :64], pc.v_scale], ValueError,
                        "contiguous"),
        "f32 data with scales": ([k.float(), v.float()],
                                 [pc.k_scale, pc.v_scale], TypeError,
                                 "no scales"),
        "two dtypes": ([k.float(), v.half()], [None, None], TypeError,
                       "one dtype"),
        "f64 data": ([k.double(), v.double()], [None, None], TypeError,
                     "bf16, f16, f32, or int8"),
    }
    for name, (data, scales, exc, match) in bad.items():
        with pytest.raises(exc, match=match):
            flash_paged.kv_kind(data, scales)
    assert flash_paged.kv_kind([k, v], [pc.k_scale, pc.v_scale]) == 1
    assert flash_paged.kv_kind([bf, bf], [None, None]) == 0
    assert flash_paged.kv_kind([k.half(), v.half()], [None, None]) == 2
    assert flash_paged.kv_kind([k.float(), v.float()], [None, None]) == 3


# --- the model, the engine and the batcher --------------------------------------


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


_params: dict = {}


def _both_params(kind):
    """JAX's random q8 or q4g parameters on tiny_test_config (q4g
    quantized by JAX's codec from numpy weights) and the port's copy."""
    if kind not in _params:
        if kind == "q8":
            jp = jllama.init_quantized_params(JCFG, jax.random.PRNGKey(0),
                                              JaxPolicy("q8", "f32", "f32"))
        else:
            quant = jax.jit(jcodec.quantize, static_argnums=(1, 2))
            rng = np.random.default_rng(21)

            def q(shape, layout):
                w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
                return quant(jnp.asarray(w), kind, layout)

            D, F, V = JCFG.n_embd, JCFG.n_ffn, JCFG.n_vocab
            ones = jnp.ones((L, D), jnp.float32)
            jp = {"embed": q((V, D), "nk"), "lm_head": q((V, D), "kn"),
                  "norm": jnp.ones((D,), jnp.float32),
                  "layers": {"wqkv": q((L, D + 2 * JCFG.kv_dim, D), "kn"),
                             "wo": q((L, D, D), "kn"),
                             "w_gateup": q((L, 2 * F, D), "kn"),
                             "w_down": q((L, D, F), "kn"),
                             "attn_norm": ones, "ffn_norm": ones}}
        _params[kind] = jp, params_from_numpy(
            _to_numpy(jp), CFG, pconfig.DtypePolicy(kind, "f32", "f32"))
    return _params[kind]


def _policies(kind):
    return JaxPolicy(kind, "f32", "i8"), pconfig.DtypePolicy(kind, "f32", "i8")


@pytest.mark.parametrize("rows", [1, 2])
def test_forward_i8_matches_jax_pallas(rows):
    """forward over an i8 cache equals JAX forward(use_pallas=True) at f32,
    hidden states, logits and the caches' dequantized values, after each
    call: one row, a 16-token prefill (fused: K5, K3, K6, K7) then a b1
    decode step (K5, K8, K7); two rows, a 9-token prefill then a B = 2
    decode step (K5, K4, K6, K7)."""
    jp, pp = _both_params("q8")
    jpol, ppol = _policies("q8")
    rng = np.random.default_rng(22)
    jc = jkv.init_cache(JCFG, rows, "i8")
    pc = kvcache.init_cache(CFG, rows, "i8")
    toks = rng.integers(0, CFG.n_vocab, (rows, 16 if rows == 1 else 9))
    pos = [0] * rows
    for _ in range(2):
        jh, jc = jllama.forward(JCFG, jpol, jp, jnp.asarray(toks, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32), use_pallas=True)
        ph = llama.forward(CFG, ppol, pp, torch.from_numpy(toks), pc, _i32(pos))
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL["f32"])
        n = rows * toks.shape[1]
        np.testing.assert_allclose(
            llama.lm_head_logits(pp, ph.reshape(n, -1)).numpy(),
            np.asarray(jllama.lm_head_logits(jp, jh.reshape(n, -1))),
            **TOL["f32"])
        for li in range(L):
            for g, w in zip(kvcache.layer_cache_view(pc, li, torch.float32),
                            jkv.layer_cache_view(jc, jnp.int32(li), jnp.float32)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL["f32"])
        pos = [p + toks.shape[1] for p in pos]
        toks = rng.integers(0, CFG.n_vocab, (rows, 1))


def _prompt(n, seed):
    return [1] + np.random.default_rng(seed).integers(2, CFG.n_vocab,
                                                      n - 1).tolist()


GEN_MODES = ["generate", "generate_paged", "generate_batch", "batcher",
             "batcher_paged"]


@pytest.mark.parametrize("mode", GEN_MODES)
@pytest.mark.parametrize("kind", ["q8", "q4g"])
def test_greedy_i8_matches_jax(kind, mode):
    """Greedy f32 tokens with an i8 cache equal JAX's: ``generate`` (b1:
    K8 monolithic, the paged prefill's own quantized keys then K10 paged)
    and ``generate_batch`` at B = 4 (staged chunks, K9) against
    ``Engine(use_pallas=True)``; the ContinuousBatcher over a monolithic
    and over a paged engine (5 requests through 2 slots; paged:
    16-position pages) against JAX's batcher on its plain path, which
    reads the same int8 pool through its dequantizing views."""
    jp, pp = _both_params(kind)
    jpol, ppol = _policies(kind)
    is_paged = mode.endswith("paged")
    if mode.startswith("generate") and mode != "generate_batch":
        prompt = _prompt(20, len(mode))
        gen = dict(n_predict=32, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = JaxEngine(JCFG, jpol, jp, paged=is_paged, use_pallas=True
                            ).generate(prompt, JaxGen(**gen))
        pout, _ = Engine(CFG, ppol, pp, device="cpu", paged=is_paged).generate(
            prompt, pconfig.GenerationConfig(**gen))
        assert len(pout) == 12 and pout == [int(t) for t in jout]
    elif mode == "generate_batch":
        prompts = [_prompt(n, n) for n in (5, 9, 12, 20)]
        gen = dict(n_predict=28, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = JaxEngine(JCFG, jpol, jp, max_batch=4, use_pallas=True
                            ).generate_batch(prompts, JaxGen(**gen))
        pout, _ = Engine(CFG, ppol, pp, device="cpu").generate_batch(
            prompts, pconfig.GenerationConfig(**gen))
        assert [len(o) for o in pout] == [23, 19, 16, 8]
        assert pout == [[int(t) for t in o] for o in jout]
    else:
        prompts = [[3, 7, 1], [9, 2, 4, 8, 5], [11, 6], [1, 2, 3, 4], [5, 5, 5]]
        gen = dict(n_predict=20, greedy=True, eos_token=-1, chunk_size=8)
        kw = dict(page_size=16) if is_paged else {}
        jb = JaxBatcher(JaxEngine(JCFG, jpol, jp, max_batch=2, use_pallas=False),
                        JaxGen(**gen), max_batch=2, paged=is_paged, **kw)
        pb = ContinuousBatcher(Engine(CFG, ppol, pp, device="cpu", paged=is_paged),
                               pconfig.GenerationConfig(**gen), max_batch=2, **kw)
        assert pb.paged == is_paged
        assert (pb.pool if is_paged else pb.cache).quantized
        jids = [jb.submit(p) for p in prompts]
        pids = [pb.submit(p) for p in prompts]
        jres, pres = jb.run(), pb.run()
        for jr, pr in zip(jids, pids):
            assert pres[pr].output == [int(t) for t in jres[jr].output]
            assert pres[pr].done and len(pres[pr].output) > 0


# --- interop, the CLI and hygiene ---------------------------------------------


@pytest.mark.parametrize("kind", ["mono", "paged"])
def test_cache_from_numpy_int8(kind):
    """cache_from_numpy with scales gives the JAX cache's values (its
    views, bit for bit); int8 data without scales, and scales beside
    bf16 data or of the wrong shape, are refused."""
    jpool, ppool = _pools(kind, seed=23)
    assert ppool.quantized and ppool.k_scale.dtype == torch.float32
    if kind == "mono":
        want = jkv.layer_cache_view(jpool, jnp.int32(0), jnp.float32)
        got = kvcache.layer_cache_view(ppool, 0, torch.float32)
    else:
        want = jpaged.paged_layer_view(jpool, jnp.int32(0), jnp.float32)
        got = paged.paged_layer_view(ppool, 0, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k, ks = np.asarray(jpool.k), np.asarray(jpool.k_scale)
    with pytest.raises(ValueError, match="scale planes"):
        cache_from_numpy(k, k)
    with pytest.raises(ValueError, match="scale planes"):
        cache_from_numpy(k.astype(np.float32), k.astype(np.float32),
                         k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="scale planes must be"):
        cache_from_numpy(k, k, k_scale=ks[..., :8], v_scale=ks[..., :8])


def test_cli_kv_i8_runs_on_cpu(capsys, monkeypatch):
    """``--kv i8`` reaches the engine's policy (a q8-kvi8 run on the CPU),
    and the performance table counts the scale planes in the cache's
    bytes."""
    seen = []

    class Spy(Engine):
        def __init__(self, cfg, policy, *a, **k):
            seen.append(policy)
            super().__init__(cfg, policy, *a, **k)

    monkeypatch.setattr(cli, "Engine", Spy)
    assert cli.main(["--random-weights", "--model", "tiny-test", "-q8", "-p",
                     "hello", "-greedy", "--npred", "12", "--device", "cpu",
                     "--kv", "i8"]) == 0
    assert [p.kv_dtype for p in seen] == ["i8"] and seen[0] == \
        pconfig.POLICIES["q8-kvi8"]
    out = capsys.readouterr()
    assert len(out.err.split()) == 12 - 6 and "Throughput" in out.out
    cache = kvcache.init_cache(CFG, 1, "i8")
    from tinyllama_tpu_torch.runtime.perf import tree_nbytes
    assert tree_nbytes(cache) == L * Kh * CFG.max_ctx * (2 * d + 2 * 4)
    assert cli.build_parser().parse_args(["--kv", "bf16"]).kv == "bf16"
    assert cli.build_parser().parse_args([]).kv is None


def test_kvi8_modules_import_no_jax():
    """The modules this slice changed import neither JAX nor the JAX
    package."""
    pkg = Path(__file__).resolve().parents[1] / "tinyllama_tpu_torch"
    for module in ("runtime/kvcache.py", "runtime/staging.py",
                   "ops/kernels/attn_out_fused.py",
                   "ops/kernels/flash_attention.py", "cli.py"):
        tree = ast.parse((pkg / module).read_text())
        tops = {alias.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names}
        tops |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
        assert not tops & {"jax", "jaxlib", "tinyllama_tpu"}, (module, tops)
    assert (pkg / "csrc" / "kvkind.cuh").exists()
