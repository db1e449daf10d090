"""The port's model and engine against the JAX package, end to end.

JAX builds random q8 parameters on tiny_test_config; they cross to the
port through interop.params_from_numpy. At f32 activations the port's
forward (its kernels' plain versions on the CPU) must match JAX's
``llama.forward`` within rtol/atol 1e-4, both without Pallas and with it
(interpret mode, where the JAX package takes its fused decode branch),
prefill must equal decode inside the port, greedy generation must give
the very tokens of JAX's ``Engine.generate``, and each path must reach
exactly the kernels the JAX branch choice dictates.
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
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.kvcache import init_cache as jax_init_cache
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.cli import main as cli_main
from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import init_cache


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


def _tokens(B, T, seed):
    return np.random.default_rng(seed).integers(0, CFG.n_vocab, (B, T))


def _jax_forward(jp, toks, cache, pos, use_pallas=False):
    hidden, cache = jllama.forward(JCFG, JPOL, jp, jnp.asarray(toks, jnp.int32),
                                   cache, jnp.asarray(pos, jnp.int32),
                                   use_pallas=use_pallas)
    B, T, D = hidden.shape
    logits = jllama.lm_head_logits(jp, hidden.reshape(B * T, D))
    return np.asarray(hidden), np.asarray(logits).reshape(B, T, -1), cache


def _port_forward(pp, toks, cache, pos):
    hidden = llama.forward(CFG, POL, pp, torch.from_numpy(toks), cache,
                           torch.tensor(pos, dtype=torch.int32))
    B, T, D = hidden.shape
    logits = llama.lm_head_logits(pp, hidden.reshape(B * T, D))
    return hidden.numpy(), logits.reshape(B, T, -1).numpy()


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_forward_matches_jax(both_params, phase):
    """Hidden states and logits at f32: a 2-row prefill at pos 0, then a
    decode step at the next positions over the cache both wrote."""
    jp, pp = both_params
    B, T = 2, 9
    toks = _tokens(B, T, seed=1)
    jc = jax_init_cache(JCFG, B, "f32")
    pc = init_cache(CFG, B, "f32")
    jh, jl, jc = _jax_forward(jp, toks, jc, [0, 0])
    ph, pl = _port_forward(pp, toks, pc, [0, 0])
    if phase == "decode":
        step = _tokens(B, 1, seed=2)
        jh, jl, jc = _jax_forward(jp, step, jc, [T, T])
        ph, pl = _port_forward(pp, step, pc, [T, T])
    np.testing.assert_allclose(ph, jh, **TOL)
    np.testing.assert_allclose(pl, jl, **TOL)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), **TOL)


#: (rows, prompt tokens, decode steps after the prompt): the fused
#: branch's three shapes. b1 decode takes K5 -> K8 -> K7; a 16-token
#: prefill K5 -> K3 -> K6 -> K7; a 2-row decode step K5 -> K4 -> K6 -> K7.
FUSED_CASES = {"b1_decode": (1, 9, 1), "prefill_16": (1, 16, 0),
               "b2_decode": (2, 9, 1)}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_forward_matches_jax_pallas(both_params, case):
    """The port picks the JAX package's fused branch: its forward matches
    ``llama.forward(use_pallas=True)`` (Pallas in interpret mode) at f32,
    hidden states, logits and cache."""
    jp, pp = both_params
    B, T, steps = FUSED_CASES[case]
    toks = _tokens(B, T, seed=5)
    jc = jax_init_cache(JCFG, B, "f32")
    pc = init_cache(CFG, B, "f32")
    jh, jl, jc = _jax_forward(jp, toks, jc, [0] * B, use_pallas=True)
    ph, pl = _port_forward(pp, toks, pc, [0] * B)
    for s in range(steps):
        step = _tokens(B, 1, seed=6 + s)
        jh, jl, jc = _jax_forward(jp, step, jc, [T + s] * B, use_pallas=True)
        ph, pl = _port_forward(pp, step, pc, [T + s] * B)
    np.testing.assert_allclose(ph, jh, **TOL)
    np.testing.assert_allclose(pl, jl, **TOL)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(pc.v.numpy(), np.asarray(jc.v), **TOL)


@pytest.mark.parametrize("prompt_len", [24, 40])
def test_greedy_generate_matches_jax_pallas(both_params, prompt_len):
    """Greedy tokens identical to JAX ``Engine(use_pallas=True)`` for a
    prompt of at most 32 tokens (fused prefill, bucket 32) and a longer
    one (unfused prefill, bucket 64); fused decode either way."""
    jp, pp = both_params
    prompt = [1] + np.random.default_rng(prompt_len).integers(
        2, CFG.n_vocab, prompt_len - 1).tolist()
    n_new = 16
    jout, _ = JaxEngine(JCFG, JPOL, jp, use_pallas=True).generate(
        prompt, JaxGen(n_predict=prompt_len + n_new, greedy=True,
                       eos_token=-1, chunk_size=8))
    pout, _ = Engine(CFG, POL, pp, device="cpu").generate(
        prompt, pconfig.GenerationConfig(n_predict=prompt_len + n_new,
                                         greedy=True, eos_token=-1,
                                         chunk_size=8))
    assert len(pout) == n_new
    assert pout == [int(t) for t in jout]


#: the 4-bit models: JAX config, port config, by n_embd (256: d_head 64)
WIDTHS = {128: (JCFG, CFG),
          256: (jax_tiny(n_embd=256, n_ffn=512, n_kv_heads=2),
                pconfig.tiny_test_config(n_embd=256, n_ffn=512, n_kv_heads=2))}
_params4: dict = {}


def _both_params4(kind, width):
    """Random q4/q4g parameters of the width's config: JAX's tree (the
    layout of its init_quantized_params, quantized by its jitted codec
    from numpy weights) and the port's copy."""
    key = (kind, width)
    if key not in _params4:
        jcfg, pcfg = WIDTHS[width]
        quant = jax.jit(jcodec.quantize, static_argnums=(1, 2))
        rng = np.random.default_rng(width)

        def q(shape, layout):
            w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
            return quant(jnp.asarray(w), kind, layout)

        L, D, F, V = jcfg.n_layers, jcfg.n_embd, jcfg.n_ffn, jcfg.n_vocab
        ones = jnp.ones((L, D), jnp.float32)
        jp = {"embed": q((V, D), "nk"), "lm_head": q((V, D), "kn"),
              "norm": jnp.ones((D,), jnp.float32),
              "layers": {"wqkv": q((L, D + 2 * jcfg.kv_dim, D), "kn"),
                         "wo": q((L, D, D), "kn"),
                         "w_gateup": q((L, 2 * F, D), "kn"),
                         "w_down": q((L, D, F), "kn"),
                         "attn_norm": ones, "ffn_norm": ones}}
        _params4[key] = jp, params_from_numpy(
            _to_numpy(jp), pcfg, pconfig.DtypePolicy(kind, "f32", "f32"))
    return _params4[key]


@pytest.mark.parametrize("mode", ["b1", "b4"])
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("kind", ["q4", "q4g"])
def test_greedy_4bit_matches_jax_pallas(kind, width, mode):
    """Greedy f32 tokens with q4 and q4g weights equal JAX
    ``Engine(use_pallas=True)``'s: b1 ``generate`` of a 20-token prompt
    (fused prefill, K5 -> K8 -> K7 decode), and ``generate_batch`` of 4
    prompts of staggered lengths (staged B = 4 chunks)."""
    jp, pp = _both_params4(kind, width)
    jcfg, pcfg = WIDTHS[width]
    jpol, ppol = JaxPolicy(kind, "f32", "f32"), pconfig.DtypePolicy(kind, "f32",
                                                                    "f32")
    rng = np.random.default_rng(width + len(kind))
    if mode == "b1":
        prompt = [1] + rng.integers(2, pcfg.n_vocab, 19).tolist()
        gen = dict(n_predict=32, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = JaxEngine(jcfg, jpol, jp, use_pallas=True).generate(
            prompt, JaxGen(**gen))
        pout, _ = Engine(pcfg, ppol, pp, device="cpu").generate(
            prompt, pconfig.GenerationConfig(**gen))
        assert len(pout) == 12 and pout == [int(t) for t in jout]
    else:
        prompts = [[1] + rng.integers(2, pcfg.n_vocab, n - 1).tolist()
                   for n in (5, 9, 12, 20)]
        gen = dict(n_predict=28, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = JaxEngine(jcfg, jpol, jp, max_batch=4, use_pallas=True
                            ).generate_batch(prompts, JaxGen(**gen))
        pout, _ = Engine(pcfg, ppol, pp, device="cpu").generate_batch(
            prompts, pconfig.GenerationConfig(**gen))
        assert [len(o) for o in pout] == [23, 19, 16, 8]
        assert pout == [[int(t) for t in o] for o in jout]


#: the plain version behind each kernel; a test spy counts their calls.
SPIED = [
    ("qmatmul", "qmatmul_ref", lambda x, *a, aq8=False, **k: (
        ("K1 aq8" if aq8 else "K1") if x.reshape(-1, x.shape[-1]).shape[0] <= 8
        else "K2")),
    ("flash_attention", "attention_ref",
     lambda q, *a, **k: "K4" if q.shape[1] == 1 else "K3"),
    ("decode_fused", "fused_norm_qkv_ref", lambda *a, **k: "K5"),
    ("decode_fused", "fused_out_residual_ref", lambda *a, **k: "K6"),
    ("ffn_fused", "ffn_fused_ref", lambda x, norm_w, *a, **k:
     "K7" if norm_w is not None else "K7 plain"),
    ("attn_out_fused", "fused_attn_out_ref", lambda *a, **k: "K8"),
]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the kernels a CPU run reaches, by the calls of their
    plain versions (the wrappers' launch counters count launches on the
    card only)."""
    import collections
    import importlib

    calls = collections.Counter()
    for mod_name, fn_name, which in SPIED:
        mod = importlib.import_module(f"tinyllama_tpu_torch.ops.kernels.{mod_name}")
        real = getattr(mod, fn_name)

        def spy(*a, _real=real, _which=which, **k):
            calls[_which(*a, **k)] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn_name, spy)
    return calls


def test_branch_choice_counts(both_params, kernel_calls):
    """Exact kernel counts of each path at L = 2: a 16-bucket prefill is
    fused (K5, K3, K6, K7), a longer one is not (K2, K3); a b1 decode
    step runs K5, K8, K7 and no K4 or K6; a 2-row step K5, K4, K6, K7;
    the lm_head is one K1 each time. With aq8 (q8a8) no block is fused
    and none reaches K7 (the JAX rule): every linear and the lm_head go
    through qmatmul with aq8, K1's aq8 branch at M <= 8, K2 above."""
    _assert_branch_counts(both_params[1], POL, kernel_calls)
    L = CFG.n_layers
    eng = Engine(CFG, pconfig.DtypePolicy("q8", "f32", "f32", aq8=True),
                 both_params[1], device="cpu")
    cache = eng.new_cache(1)
    kernel_calls.clear()
    eng.prefill(cache, [[1, 5, 9, 33, 70]])
    assert dict(kernel_calls) == {"K2": 4 * L, "K3": L, "K1 aq8": 1}
    kernel_calls.clear()
    eng.decode_step(cache, torch.tensor([7], dtype=torch.int32),
                    torch.tensor([5], dtype=torch.int32))
    assert dict(kernel_calls) == {"K1 aq8": 4 * L + 1, "K4": L}
    cache2 = eng.new_cache(2)
    eng.prefill(cache2, [[1, 2, 3], [4, 5, 6, 7]])
    kernel_calls.clear()
    eng.decode_step(cache2, torch.tensor([8, 9], dtype=torch.int32),
                    torch.tensor([3, 4], dtype=torch.int32))
    assert dict(kernel_calls) == {"K1 aq8": 4 * L + 1, "K4": L}


def test_branch_choice_counts_i8(both_params, kernel_calls):
    """The same counts over an int8 KV cache: the branch depends on
    shapes and weight types, not on the cache's dtype (as in the JAX
    ``_block``)."""
    _assert_branch_counts(both_params[1], pconfig.DtypePolicy("q8", "f32", "i8"),
                          kernel_calls)


def _assert_branch_counts(pp, policy, kernel_calls):
    L = CFG.n_layers
    eng = Engine(CFG, policy, pp, device="cpu")
    assert eng.new_cache(1).quantized == (policy.kv_dtype == "i8")

    def run(fn):
        kernel_calls.clear()
        fn()
        return dict(kernel_calls)

    cache = eng.new_cache(1)
    assert run(lambda: eng.prefill(cache, [[1, 5, 9, 33, 70]])) == {
        "K5": L, "K3": L, "K6": L, "K7": L, "K1": 1}
    tok, pos = torch.tensor([7], dtype=torch.int32), torch.tensor(
        [5], dtype=torch.int32)
    assert run(lambda: eng.decode_step(cache, tok, pos)) == {
        "K5": L, "K8": L, "K7": L, "K1": 1}
    cache = eng.new_cache(1)
    assert run(lambda: eng.prefill(cache, [list(range(1, 41))])) == {
        "K2": 4 * L, "K3": L, "K1": 1}
    cache2 = eng.new_cache(2)
    eng.prefill(cache2, [[1, 2, 3], [4, 5, 6, 7]])
    assert run(lambda: eng.decode_step(
        cache2, torch.tensor([8, 9], dtype=torch.int32),
        torch.tensor([3, 4], dtype=torch.int32))) == {
        "K5": L, "K4": L, "K6": L, "K7": L, "K1": 1}


def test_prefill_equals_decode(both_params):
    """Logits of a one-shot prefill == logits of token-by-token decode."""
    _, pp = both_params
    T = 10
    toks = _tokens(1, T, seed=3)
    _, full = _port_forward(pp, toks, init_cache(CFG, 1, "f32"), [0])
    cache = init_cache(CFG, 1, "f32")
    steps = [_port_forward(pp, toks[:, t:t + 1], cache, [t])[1][:, 0]
             for t in range(T)]
    np.testing.assert_allclose(np.stack(steps, axis=1), full, rtol=1e-5,
                               atol=1e-5)


def test_greedy_generate_token_identical(both_params):
    """The port's Engine.generate on the CPU emits JAX's greedy tokens."""
    jp, pp = both_params
    prompt = [1, 17, 300, 42, 7, 99, 256]
    n_new = 40
    jout, _ = JaxEngine(JCFG, JPOL, jp).generate(
        prompt, JaxGen(n_predict=len(prompt) + n_new, greedy=True,
                       chunk_size=16))
    pout, stats = Engine(CFG, POL, pp, device="cpu").generate(
        prompt, pconfig.GenerationConfig(n_predict=len(prompt) + n_new,
                                         greedy=True, chunk_size=16))
    assert len(pout) == n_new >= 24
    assert pout == [int(t) for t in jout]
    # whole chunks, as the JAX generate: 40 tokens take 3 chunks of 16
    assert stats.decode_steps == -(-n_new // 16) * 16
    assert stats.prompt_tokens == len(prompt)


def test_generate_stops_at_eos(both_params):
    _, pp = both_params
    eng = Engine(CFG, POL, pp, device="cpu")
    gen = pconfig.GenerationConfig(n_predict=20, greedy=True, chunk_size=4)
    out, _ = eng.generate([1, 2], gen)
    gen_eos = pconfig.GenerationConfig(n_predict=20, greedy=True,
                                       chunk_size=4, eos_token=out[5])
    out2, _ = eng.generate([1, 2], gen_eos)
    assert out2 == out[: out.index(out[5])]


def test_topk_generate_reproducible(both_params):
    _, pp = both_params
    eng = Engine(CFG, POL, pp, device="cpu")
    gen = pconfig.GenerationConfig(n_predict=16, top_k=5, seed=11, eos_token=-1)
    a, _ = eng.generate([1, 5, 9], gen)
    b, _ = eng.generate([1, 5, 9], gen)
    assert a == b and len(a) == 13 and all(0 <= t < CFG.n_vocab for t in a)


def test_bf16_forward_close_to_f32(both_params):
    """At bf16 activations and cache the port stays within the bf16
    per-op tolerance of its f32 path (no token identity at bf16)."""
    _, pp = both_params
    toks = _tokens(1, 12, seed=4)
    _, l32 = _port_forward(pp, toks, init_cache(CFG, 1, "f32"), [0])
    bf = pconfig.POLICIES["q8"]
    hidden = llama.forward(CFG, bf, pp, torch.from_numpy(toks),
                           init_cache(CFG, 1, "bf16"),
                           torch.zeros(1, dtype=torch.int32))
    assert hidden.dtype == torch.bfloat16
    l16 = llama.lm_head_logits(pp, hidden[0]).numpy()
    np.testing.assert_allclose(l16, l32[0], rtol=5e-2, atol=5e-2)


def test_cli_runs_on_cpu(capsys):
    assert cli_main(["--random-weights", "--model", "tiny-test", "-q8", "-p",
                     "hello", "-greedy", "--npred", "12", "--device",
                     "cpu"]) == 0
    captured = capsys.readouterr()
    assert len(captured.err.split()) == 12 - 6
    assert "Throughput" in captured.out
    with pytest.raises(SystemExit, match="not both"):
        cli_main(["--random-weights", "--ckpt", "x.gten", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli_main(["--ckpt", "no-such-file.gten", "--device", "cpu"])
