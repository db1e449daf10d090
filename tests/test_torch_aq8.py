"""The port's aq8 activations (the q8a8 and q4a8 policies) against the JAX
package's, and the CLI's seed and load-time repairs.

Every input is made from a numpy seed and given to both packages. With
aq8 the JAX package quantizes activations only on its Pallas path
(``ops/linear.py``: its plain path runs the dense matmul), so every JAX
side here runs the Pallas kernels in interpret mode: ``qmatmul(...,
aq8=True, interpret=True)``, ``forward(use_pallas=True)`` and
``Engine(use_pallas=True)``.

* ``quantize_x`` is bit-equal to a numpy f32 transcription of the TPU
  body's ``block_x``.
* K1's aq8 plain version matches the Pallas kernel within rtol/atol 1e-4
  at f32 (only the f32 order of the block sum differs: every block's dot
  is an exact integer) and the JAX suite's bf16 tolerance, rtol 2e-2 /
  atol 5e-3 (tests/test_tpu_kernels.py), at bf16. Above M = 8 aq8 is
  ignored, as the TPU's big-M kernel has no aq8 branch; q4g with aq8
  raises.
* ``forward`` matches JAX's at f32 within 1e-4, and greedy f32 tokens
  equal JAX's for ``generate`` (monolithic and paged), ``generate_batch``
  and the ContinuousBatcher, with q8 and q4 weights.
"""

import ast
import time
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
from tinyllama_tpu.ops.pallas import decode_fused as jdf
from tinyllama_tpu.ops.pallas.qmatmul import qmatmul as jax_qmatmul
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy, qtensor_from_numpy
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.kernels import decode_fused, qmatmul
from tinyllama_tpu_torch.runtime import kvcache
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
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=5e-3)}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_quant = jax.jit(jcodec.quantize, static_argnums=(1, 2))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


# --- the x quantizer ------------------------------------------------------------


def _np_block_x(x: np.ndarray):
    """The TPU body's block_x (ops/pallas/qmatmul.py) in numpy f32, per
    32-block of each row: (int8 x, its f32 scale)."""
    M, K = x.shape
    xf = x.astype(np.float32).reshape(M, K // 32, 32)
    absmax = np.max(np.abs(xf), axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        inv = np.where(absmax > 0, np.float32(127.0) / absmax, np.float32(0.0))
    xq = np.round(xf * inv).astype(np.int8)
    return xq.reshape(M, K), (absmax * np.float32(1.0 / 127.0))[..., 0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_x_bit_equal_to_block_x(dtype):
    """quantize_x gives block_x's int8 values and f32 scales bit for bit:
    an all-zero block (scale 0, values 0), values at +-absmax (+-127),
    and .5 ties (half to even) at absmax 127 and 254."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 128)) * 3).astype(np.float32)
    x[0, :32] = 0.0
    x[1, 32:64] = 0.25
    x[1, 32:38] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    x[1, 64:96] = 1.0
    x[1, 64:68] = [254.0, 1.0, 3.0, -5.0]
    x[2, 100] = -4 * np.abs(x[2, 96:]).max()
    x = _f32(jnp.asarray(x, JNP[dtype]))
    want_q, want_s = _np_block_x(x)
    got_q, got_s = qmatmul.quantize_x(torch.from_numpy(x).to(TORCH[dtype]))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32), want_s.view(np.int32))
    assert not got_q[0, :32].any() and float(got_s[0, 0]) == 0.0
    assert got_q[1, 32:38].tolist() == [127, 0, 2, 2, 0, -2]
    assert got_q[1, 64:68].tolist() == [127, 0, 2, -2]
    assert got_q[2, 100] == -127
    # many blocks of values with few significant bits, where a rounded
    # reciprocal in place of the division moves values across .5
    x = _f32(jnp.asarray(rng.standard_normal((64, 4096)), JNP[dtype]))
    want_q, want_s = _np_block_x(x)
    got_q, got_s = qmatmul.quantize_x(torch.from_numpy(x).to(TORCH[dtype]))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32), want_s.view(np.int32))


# --- K1's aq8 branch ------------------------------------------------------------


def _weights(kind, K, N, seed, layers=None):
    """The same kn weight for both packages: JAX's quantized (layer-
    stacked when `layers` is given) and the port's copy."""
    rng = np.random.default_rng(seed)
    shape = (N, K) if layers is None else (layers, N, K)
    jw = _quant(jnp.asarray((rng.standard_normal(shape) * 0.05).astype(np.float32)),
                kind, "kn")
    pw = qtensor_from_numpy((np.asarray(jw.data), np.asarray(jw.scales), kind, "kn"))
    return jw, pw


def _x(dtype, M, K, seed):
    jx = jnp.asarray(np.random.default_rng(seed).standard_normal((M, K)),
                     JNP[dtype])
    return jx, torch.from_numpy(_f32(jx)).to(TORCH[dtype])


#: the Pallas kernel's f32 result of each (kind, M, K), with its inputs
_pallas_out: dict = {}


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("K", [2048, 5632])
@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_aq8_plain_matches_pallas(kind, M, K, out):
    """K1's aq8 plain version against JAX ``qmatmul(aq8=True,
    interpret=True)`` at TinyLlama's two K, bf16 x (the activations of
    every policy that runs on the card), f32 or bf16 out. The Pallas
    kernel writes f32 and casts outside, so one JAX call serves both."""
    key = (kind, M, K)
    if key not in _pallas_out:
        jw, pw = _weights(kind, K, 64, seed=M + K)
        jx, px = _x("bf16", M, K, seed=M)
        _pallas_out[key] = px, pw, jax_qmatmul(jx, jw, out_dtype=jnp.float32,
                                               aq8=True, interpret=True)
    px, pw, want = _pallas_out[key]
    want = want.astype(JNP[out])
    got = qmatmul.qmatmul(px, pw, TORCH[out], aq8=True)
    assert got.dtype == TORCH[out] and got.shape == (M, 64)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[out])


@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_aq8_layer_stacked_and_f32_out(kind):
    """A layer-stacked weight at layer 1 and f32 out from bf16 x (the
    lm_head's case), against the Pallas kernel."""
    jw, pw = _weights(kind, 256, 96, seed=3, layers=2)
    jx, px = _x("bf16", 3, 256, seed=4)
    want = jax_qmatmul(jx, jw, out_dtype=jnp.float32, layer=jnp.int32(1),
                       aq8=True, interpret=True)
    got = qmatmul.qmatmul(px, pw, torch.float32, _i32([1]), aq8=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_aq8_ignored_above_small_m(kind):
    """At M = 16 aq8 changes nothing (K2 runs, as JAX's big-M kernel has
    no aq8 branch), and the result is JAX's."""
    jw, pw = _weights(kind, 256, 64, seed=5)
    jx, px = _x("f32", 16, 256, seed=6)
    got = qmatmul.qmatmul(px, pw, aq8=True)
    torch.testing.assert_close(got, qmatmul.qmatmul(px, pw), rtol=0, atol=0)
    want = jax_qmatmul(jx, jw, aq8=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])
    small = qmatmul.qmatmul(px[:8], pw, aq8=True)
    assert not torch.equal(small, qmatmul.qmatmul(px[:8], pw))


def test_q4g_aq8_raises():
    """q4g has no aq8 branch (the TPU kernel asserts so): the wrapper, its
    plain version and the policy check raise ValueError on the CPU."""
    _, pw = _weights("q4g", 256, 64, seed=7)
    x = torch.zeros(2, 256)
    for fn in (qmatmul.qmatmul, qmatmul.qmatmul_ref):
        with pytest.raises(ValueError, match="q4g"):
            fn(x, pw, aq8=True)
    with pytest.raises(ValueError, match="q4g"):
        llama.check_policy(pconfig.DtypePolicy("q4g", "bf16", "bf16",
                                               aq8=True))
    llama.check_policy(pconfig.POLICIES["q4a8"])


# --- the model and the engine ----------------------------------------------------


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


_params: dict = {}


def _both_params(kind):
    """JAX's random q8 parameters, or q4 ones quantized by JAX's codec from
    numpy weights, on tiny_test_config; and the port's copy."""
    if kind not in _params:
        if kind == "q8":
            jp = jllama.init_quantized_params(JCFG, jax.random.PRNGKey(0),
                                              JaxPolicy("q8", "f32", "f32"))
        else:
            rng = np.random.default_rng(31)

            def q(shape, layout):
                w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
                return _quant(jnp.asarray(w), kind, layout)

            L, D, F, V = JCFG.n_layers, JCFG.n_embd, JCFG.n_ffn, JCFG.n_vocab
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
    return (JaxPolicy(kind, "f32", "f32", aq8=True),
            pconfig.DtypePolicy(kind, "f32", "f32", aq8=True))


#: (rows, prompt tokens): a b1 decode step after a 9-token prefill, a
#: 16-token prefill (M = 16: K2, aq8 ignored) and a B = 4 decode step
FORWARD_CASES = {"b1_decode": (1, 9, 1), "prefill_16": (1, 16, 0),
                 "b4_decode": (4, 5, 1)}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_aq8_matches_jax_pallas(case, kind="q8"):
    """forward with aq8 (q8a8) equals JAX forward(use_pallas=True) at f32
    after each call: hidden states, the caches, and the last rows' logits
    through the aq8 lm_head (M = B <= 8). q4a8 is held to JAX by its
    greedy tokens below."""
    jp, pp = _both_params(kind)
    jpol, ppol = _policies(kind)
    rows, T, steps = FORWARD_CASES[case]
    rng = np.random.default_rng(len(case))
    jc = jkv.init_cache(JCFG, rows, "f32")
    pc = kvcache.init_cache(CFG, rows, "f32")
    toks, pos = rng.integers(0, CFG.n_vocab, (rows, T)), [0] * rows
    for _ in range(1 + steps):
        jh, jc = jllama.forward(JCFG, jpol, jp, jnp.asarray(toks, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32), use_pallas=True)
        ph = llama.forward(CFG, ppol, pp, torch.from_numpy(toks), pc, _i32(pos))
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL["f32"])
        np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), **TOL["f32"])
        np.testing.assert_allclose(
            llama.lm_head_logits(pp, ph[:, -1], aq8=True).numpy(),
            np.asarray(jllama.lm_head_logits(jp, jh[:, -1], True, True)),
            **TOL["f32"])
        pos = [p + toks.shape[1] for p in pos]
        toks = rng.integers(0, CFG.n_vocab, (rows, 1))


def _prompt(n, seed):
    return [1] + np.random.default_rng(seed).integers(2, CFG.n_vocab,
                                                      n - 1).tolist()


GEN_CASES = [("q8", "generate"), ("q8", "generate_paged"),
             ("q8", "generate_batch"), ("q8", "batcher"), ("q4", "generate"),
             ("q4", "generate_paged"), ("q4", "generate_batch")]


@pytest.mark.parametrize("kind,mode", GEN_CASES)
def test_greedy_aq8_matches_jax(kind, mode):
    """Greedy f32 tokens with aq8 equal JAX ``Engine(use_pallas=True)``'s:
    ``generate`` of a 20-token prompt (b1 decode through K1-aq8 and K4,
    monolithic; K10 paged), ``generate_batch`` at B = 4 (staged chunks,
    K1-aq8 at M = 4, K9), and (q8a8) 5 requests through a 2-slot
    ContinuousBatcher against JAX's batcher."""
    jp, pp = _both_params(kind)
    jpol, ppol = _policies(kind)
    if mode in ("generate", "generate_paged"):
        paged = mode == "generate_paged"
        prompt = _prompt(20, len(mode))
        gen = dict(n_predict=30, greedy=True, eos_token=-1, chunk_size=5)
        jout, _ = JaxEngine(JCFG, jpol, jp, paged=paged, use_pallas=True
                            ).generate(prompt, JaxGen(**gen))
        pout, _ = Engine(CFG, ppol, pp, device="cpu", paged=paged).generate(
            prompt, pconfig.GenerationConfig(**gen))
        assert len(pout) == 10 and pout == [int(t) for t in jout]
    elif mode == "generate_batch":
        prompts = [_prompt(n, n) for n in (5, 9, 12, 20)]
        gen = dict(n_predict=26, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = JaxEngine(JCFG, jpol, jp, max_batch=4, use_pallas=True
                            ).generate_batch(prompts, JaxGen(**gen))
        pout, _ = Engine(CFG, ppol, pp, device="cpu").generate_batch(
            prompts, pconfig.GenerationConfig(**gen))
        assert [len(o) for o in pout] == [21, 17, 14, 6]
        assert pout == [[int(t) for t in o] for o in jout]
    else:
        prompts = [[3, 7, 1], [9, 2, 4, 8, 5], [11, 6], [1, 2, 3, 4], [5, 5, 5]]
        gen = dict(n_predict=14, greedy=True, eos_token=-1, chunk_size=4)
        jb = JaxBatcher(JaxEngine(JCFG, jpol, jp, max_batch=2, use_pallas=True),
                        JaxGen(**gen), max_batch=2)
        pb = ContinuousBatcher(Engine(CFG, ppol, pp, device="cpu"),
                               pconfig.GenerationConfig(**gen), max_batch=2)
        jids = [jb.submit(p) for p in prompts]
        pids = [pb.submit(p) for p in prompts]
        jres, pres = jb.run(), pb.run()
        for jr, pr in zip(jids, pids):
            assert pres[pr].output == [int(t) for t in jres[jr].output]
            assert pres[pr].done and len(pres[pr].output) > 0


@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_gten_loads_under_aq8(tmp_path, kind):
    """A q8 (q4) .gten loaded under q8a8 (q4a8) gives the file's weights,
    as the JAX loader does, and keeps the aq8 policy."""
    from tinyllama_tpu.config import POLICIES as JAX_POLICIES
    from tinyllama_tpu.io import checkpoint as jckpt
    from tinyllama_tpu_torch.io import checkpoint
    from tinyllama_tpu_torch.quant import codec

    d = jllama.init_dense_params(JCFG, jax.random.PRNGKey(3))
    dense = {"embed": np.asarray(d["embed"]), "norm": np.asarray(d["norm"]),
             "lm_head": np.asarray(d["lm_head"]),
             "layers": {n: np.asarray(w) for n, w in d["layers"].items()}}
    path = tmp_path / f"m.{kind}.gten"
    checkpoint.save_gten_checkpoint(path, CFG, dense, kind)
    name = f"{kind}a8"
    jp, jpol = jckpt.load_gten_checkpoint(path, JCFG, JAX_POLICIES[name])
    pp, ppol = checkpoint.load_gten_checkpoint(path, CFG, pconfig.POLICIES[name])
    own, _ = checkpoint.load_gten_checkpoint(path, CFG)
    assert ppol.aq8 and jpol.aq8 and ppol.wdtype == kind
    for n in ("wqkv", "w_down"):
        got = codec.dequantize(pp["layers"][n]).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcodec.dequantize(
            jp["layers"][n])))
        assert torch.equal(pp["layers"][n].data, own["layers"][n].data)


def test_aq8_gates_match_jax(monkeypatch):
    """Under aq8 the fused branch is off (decode_fused_eligible false at
    every M, as the JAX rule), and an aq8 block never reaches the FFN
    kernel: its FFN is two ``linear`` calls, each through qmatmul with
    aq8."""
    import collections

    from tinyllama_tpu_torch.ops.kernels import ffn_fused

    jp, pp = _both_params("q8")
    jl = {n: jp["layers"][n] for n in ("wqkv", "wo", "w_gateup", "w_down")}
    pl = {n: pp["layers"][n] for n in ("wqkv", "wo", "w_gateup", "w_down")}
    for M in (1, 4, 32, 33):
        for aq8 in (False, True):
            want = jdf.decode_fused_eligible(JCFG, jl, M, None, aq8, jnp.int32(0))
            assert decode_fused.decode_fused_eligible(CFG, pl, M, aq8) == want
            assert want == (M <= 32 and not aq8)
    calls = collections.Counter()
    real_ref = qmatmul.qmatmul_ref

    def spy(x, *a, **k):
        calls["aq8" if k.get("aq8") else "weight-only"] += 1
        return real_ref(x, *a, **k)

    monkeypatch.setattr(qmatmul, "qmatmul_ref", spy)
    monkeypatch.setattr(ffn_fused, "ffn_fused_ref",
                        lambda *a, **k: pytest.fail("ffn_fused reached"))
    eng = Engine(CFG, _policies("q8")[1], pp, device="cpu")
    cache = eng.new_cache(1)
    eng.prefill(cache, [[1, 5, 9]])
    calls.clear()
    eng.decode_step(cache, _i32([7]), _i32([3]))
    assert calls == {"aq8": 4 * CFG.n_layers + 1}


# --- the CLI's repairs ------------------------------------------------------------


def _run_cli(monkeypatch, *flags):
    """cli.main on random tiny-test weights on the CPU; returns what its
    engine was built with and what its generate call got and returned."""
    seen = {}

    class Spy(Engine):
        def __init__(self, cfg, policy, params, *a, **k):
            seen["params"] = params
            super().__init__(cfg, policy, params, *a, **k)

        def generate(self, prompt, gen=None, stream=None):
            out, stats = super().generate(prompt, gen, stream)
            seen["gen"], seen["stats"] = gen, stats
            return out, stats

    monkeypatch.setattr(cli, "Engine", Spy)
    assert cli.main(["--random-weights", "--model", "tiny-test", "-p", "hi",
                     "--npred", "8", "--device", "cpu", *flags]) == 0
    return seen


def test_cli_seed_is_time_based_by_default(monkeypatch):
    """Without --seed, top-k's seed follows the clock, as the JAX CLI's
    (time.time_ns() % 2**31)."""
    seeds = []
    for now in (12_345_678_901, 2**40 + 77):
        monkeypatch.setattr(time, "time_ns", lambda now=now: now)
        seeds.append(_run_cli(monkeypatch)["gen"].seed)
    assert seeds == [12_345_678_901 % 2**31, (2**40 + 77) % 2**31]


def test_cli_explicit_seed_wins(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 999)
    assert _run_cli(monkeypatch, "--seed", "42")["gen"].seed == 42


def test_cli_weights_do_not_follow_seed(monkeypatch):
    """--random-weights come from one fixed seed, whatever --seed is."""
    a = _run_cli(monkeypatch, "--seed", "1")["params"]
    b = _run_cli(monkeypatch, "--seed", "2")["params"]
    for name in ("embed", "lm_head"):
        assert torch.equal(a[name], b[name])  # the default -f16: dense
    assert torch.equal(a["layers"]["wqkv"], b["layers"]["wqkv"])
    a = _run_cli(monkeypatch, "-q8", "--seed", "1")["params"]
    b = _run_cli(monkeypatch, "-q8", "--seed", "2")["params"]
    for name in ("embed", "lm_head"):
        assert torch.equal(a[name].data, b[name].data)
    assert torch.equal(a["layers"]["wqkv"].scales, b["layers"]["wqkv"].scales)


def test_cli_load_s_excludes_engine_construction(monkeypatch):
    """load_s stops after the weights are made, before the Engine is
    built: the CLI run with an Engine slowed by 0 s and then by 3 s
    reports load times that differ by far less than the 3 s (a load_s
    that covered the Engine would differ by them). Differential, so the
    host's load, which moves both runs, does not decide it."""
    real_init = Engine.__init__
    load_s = []
    for delay in (0.0, 3.0):
        def slow_init(self, *a, delay=delay, **k):
            time.sleep(delay)
            real_init(self, *a, **k)

        monkeypatch.setattr(Engine, "__init__", slow_init)
        load_s.append(_run_cli(monkeypatch, "-greedy")["stats"].load_s)
    assert all(s > 0.0 for s in load_s)
    assert abs(load_s[1] - load_s[0]) < 1.0, load_s


# --- hygiene ----------------------------------------------------------------------


def test_aq8_modules_import_no_jax():
    """The modules this slice changed, and chip_smoke.py, import neither
    JAX nor the JAX package."""
    root = Path(__file__).resolve().parents[1]
    pkg = root / "tinyllama_tpu_torch"
    files = [pkg / m for m in (
        "ops/kernels/qmatmul.py", "ops/linear.py", "ops/kernels/decode_fused.py",
        "ops/kernels/flash_paged.py", "ops/kernels/flash_attention.py",
        "ops/kernels/attn_out_fused.py", "models/llama.py",
        "runtime/engine.py", "io/checkpoint.py", "cli.py",
        "runtime/server.py", "runtime/router.py", "io/convert.py",
        "interop.py", "ops/attention.py", "ops/precision.py")]
    for path in files + [root / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        tops = {alias.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names}
        tops |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
        assert not tops & {"jax", "jaxlib", "tinyllama_tpu"}, (path.name, tops)
    assert "qmm_smallm_aq8" in (pkg / "csrc" / "qmatmul.cu").read_text()
