"""The port's model and engine against the JAX package, end to end.

JAX builds random q8 parameters on tiny_test_config; they cross to the
port through interop.params_from_numpy. At f32 activations the port's
forward (its kernels' plain versions on the CPU) must match JAX's
``llama.forward(use_pallas=False)`` within rtol/atol 1e-4, prefill must
equal decode inside the port, and greedy generation must give the very
tokens of JAX's ``Engine.generate``.
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


def _jax_forward(jp, toks, cache, pos):
    hidden, cache = jllama.forward(JCFG, JPOL, jp, jnp.asarray(toks, jnp.int32),
                                   cache, jnp.asarray(pos, jnp.int32),
                                   use_pallas=False)
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
    assert stats.decode_steps == n_new
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
    with pytest.raises(SystemExit, match="not yet ported"):
        cli_main(["--random-weights", "--ckpt", "x.gten", "--device", "cpu"])
