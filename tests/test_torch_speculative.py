"""Speculative decoding (runtime/speculative.py) against the JAX package.

Greedy acceptance is exact, so the port's ``generate_speculative`` must
give the JAX ``Engine.generate_speculative``'s tokens and the port's own
``generate``'s, token for token, at f32 activations: dense f32 weights
(the JAX test's engine) and q8 and q4 weights carried across from JAX
(the JAX side on its plain path, one case with Pallas in interpret mode).
The cases of the JAX tests/test_speculative.py: draft lengths 1, 3 and 4
over two prompts, an EOS mid-stream, the budget, and the whole budget at
the context limit; then draft_len 40 (T = 41 > 32: the unfused branch),
the R-round body against one round at a time, the rounds after done, the
capture path's keys through a stand-in capture, the refusals, and the
CLI's --spec.
"""

import collections
import importlib
import re

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
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.kernels import counts
from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime import speculative
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import kv_planes

JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
KINDS = ("f32", "q8", "q4")
PROMPTS = ([3, 7, 1], [9, 2, 4, 8, 5, 11, 6])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many tiny ops (the test
    workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _to_jax(tree):
    """The port's q8 parameters as the JAX package's, bits unchanged."""
    if isinstance(tree, QTensor):
        return jcodec.QTensor(data=jnp.asarray(tree.data.numpy()),
                              scales=jnp.asarray(tree.scales.numpy()),
                              kind=tree.kind, layout=tree.layout)
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


_models: dict = {}


def _q4_params():
    """Random q4 parameters in the JAX package's layout, from numpy
    weights through its jitted quantizer (its init_quantized_params
    quantizes op by op, several times slower)."""
    quant = jax.jit(jcodec.quantize, static_argnums=(1, 2))
    rng = np.random.default_rng(4)

    def q(shape, layout):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return quant(jnp.asarray(w), "q4", layout)

    L, D, F, V = JCFG.n_layers, JCFG.n_embd, JCFG.n_ffn, JCFG.n_vocab
    ones = jnp.ones((L, D), jnp.float32)
    return {"embed": q((V, D), "nk"), "lm_head": q((V, D), "kn"),
            "norm": jnp.ones((D,), jnp.float32),
            "layers": {"wqkv": q((L, D + 2 * JCFG.kv_dim, D), "kn"),
                       "wo": q((L, D, D), "kn"),
                       "w_gateup": q((L, 2 * F, D), "kn"),
                       "w_down": q((L, D, F), "kn"),
                       "attn_norm": ones, "ffn_norm": ones}}


def _model(kind):
    """(JAX params, port params, port policy) of `kind` at f32
    activations: dense f32 weights as the JAX test makes them, q4 from the
    JAX quantizer, q8 from the port's (its q8 planes are the JAX
    package's, bits unchanged, and it is the faster to make)."""
    if kind not in _models:
        pol = pconfig.DtypePolicy(kind, "f32", "f32")
        if kind == "q8":
            pp = llama.init_quantized_params(CFG, pol,
                                             torch.Generator().manual_seed(0))
            _models[kind] = _to_jax(pp), pp, pol
        else:
            jp = (jllama.init_dense_params(JCFG, jax.random.PRNGKey(0))
                  if kind == "f32" else _q4_params())
            _models[kind] = (jp, params_from_numpy(_to_numpy(jp), CFG, pol),
                             pol)
    return _models[kind]


_engines: dict = {}


def _engines_of(kind, use_pallas=False):
    """The JAX engine (its plain path unless `use_pallas`) and the port's
    CPU engine of `kind`, one each for the module."""
    key = (kind, use_pallas)
    if key not in _engines:
        jp, pp, pol = _model(kind)
        _engines[key] = (JaxEngine(JCFG, JaxPolicy(kind, "f32", "f32"), jp,
                                   use_pallas=use_pallas),
                         Engine(CFG, pol, pp, device="cpu"))
    return _engines[key]


def _gens(n_predict, eos=-1):
    return (JaxGen(n_predict=n_predict, greedy=True, eos_token=eos),
            pconfig.GenerationConfig(n_predict=n_predict, greedy=True,
                                     eos_token=eos, chunk_size=8))


def _three_ways(kind, prompt, n_predict, draft_len, eos=-1, use_pallas=False):
    """The JAX speculative tokens, the port's, the port's generate and the
    port's stats; asserts the three token lists are equal."""
    je, pe = _engines_of(kind, use_pallas)
    jgen, pgen = _gens(n_predict, eos)
    jout, _ = je.generate_speculative(prompt, jgen, draft_len)
    got, stats = pe.generate_speculative(prompt, pgen, draft_len)
    want, _ = pe.generate(prompt, pgen)
    assert got == [int(t) for t in jout]
    assert got == want
    return got, stats


#: the JAX test's draft lengths on its dense f32 engine; fewer on the
#: quantized ones (each (kind, draft length) is a JAX compile)
GRID = [("f32", 1), ("f32", 3), ("f32", 4), ("q8", 4), ("q4", 4)]


@pytest.mark.parametrize("kind,draft_len", GRID)
@pytest.mark.parametrize("prompt", PROMPTS)
def test_speculative_matches_jax_and_generate(kind, draft_len, prompt):
    got, stats = _three_ways(kind, prompt, 48, draft_len)
    n_verify = stats.decode_token_times[0]
    # at worst one forward a token after the prefill's
    assert 1 <= n_verify <= len(got) - 1
    # whole replays of R rounds, the next queued before one is read: at
    # most 2R - 1 rounds after done
    R = speculative.ROUNDS
    assert stats.decode_steps % R == 0
    assert n_verify + 1 <= stats.decode_steps < n_verify + 2 * R


@pytest.mark.parametrize("kind", ["f32"])
def test_speculative_respects_eos(kind):
    """A token from mid-stream becomes the EOS: the speculative loop
    stops exactly where generate and JAX stop."""
    _, pe = _engines_of(kind)
    base, _ = pe.generate([3, 7, 1], _gens(32)[1])
    eos = base[len(base) // 2]
    got, _ = _three_ways(kind, [3, 7, 1], 32, 3, eos=eos)
    assert eos not in got and len(got) < len(base)


@pytest.mark.parametrize("kind", KINDS)
def test_speculative_budget(kind):
    got, _ = _three_ways(kind, [3, 7, 1], 10, 4)
    assert len(got) == 7


@pytest.mark.parametrize("kind", ["f32", "q4"])
def test_speculative_full_budget_at_context_limit(kind):
    """Near max_ctx the loop uses the whole budget: the padded cache and
    history let the last verifies run full width (q8 reaches the limit in
    test_wide_drafts_to_the_context_limit)."""
    got, _ = _three_ways(kind, [3, 7, 1], CFG.max_ctx, 4)
    assert len(got) == CFG.max_ctx - 3


@pytest.mark.parametrize("draft_len", [40, speculative.PAD - 1])
def test_wide_drafts_to_the_context_limit(draft_len):
    """The widest windows at the context limit stay in bounds (no clamp
    in the port's gathers and scatters): every token of the budget, equal
    to generate's, from a prompt 40 short of max_ctx, one that leaves two
    tokens (one round) and one that leaves one (the prefill's)."""
    _, pe = _engines_of("q8")
    for n_prompt in (CFG.max_ctx - 40, CFG.max_ctx - 2, CFG.max_ctx - 1):
        prompt = [1 + i % 50 for i in range(n_prompt)]
        pgen = _gens(CFG.max_ctx)[1]
        got, _ = pe.generate_speculative(prompt, pgen, draft_len)
        want, _ = pe.generate(prompt, pgen)
        assert got == want and len(got) == CFG.max_ctx - n_prompt


#: the plain version behind each kernel; the spy counts their calls
SPIED = [
    ("qmatmul", "qmatmul_ref", lambda x, *a, **k:
     "K1" if x.reshape(-1, x.shape[-1]).shape[0] <= 8 else "K2"),
    ("flash_attention", "attention_ref",
     lambda q, *a, **k: "K4" if q.shape[1] == 1 else "K3"),
    ("decode_fused", "fused_norm_qkv_ref", lambda *a, **k: "K5"),
    ("decode_fused", "fused_out_residual_ref", lambda *a, **k: "K6"),
    ("ffn_fused", "ffn_fused_ref", lambda *a, **k: "K7"),
    ("attn_out_fused", "fused_attn_out_ref", lambda *a, **k: "K8"),
]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the kernels a CPU run reaches, by their plain versions'
    calls."""
    calls = collections.Counter()
    for mod_name, fn_name, which in SPIED:
        mod = importlib.import_module(f"tinyllama_tpu_torch.ops.kernels.{mod_name}")
        real = getattr(mod, fn_name)

        def spy(*a, _real=real, _which=which, **k):
            calls[_which(*a, **k)] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn_name, spy)
    return calls


@pytest.mark.parametrize("draft_len,fused", [(4, True), (40, False)])
def test_verify_round_branch(kernel_calls, draft_len, fused):
    """A verify round at T = k + 1 takes the JAX ``_block``'s branch:
    fused (K5, K3, K6, K7, the lm_head on K1) at T <= 32; unfused (K2 for
    each linear and the lm_head, K3) at T = 41. The tokens equal JAX's."""
    _, pe = _engines_of("q8")
    prompt = PROMPTS[1]
    _three_ways("q8", prompt, 40, draft_len)
    spec = pe.round_graphs()
    speculative.start(spec.buffers_for(draft_len), prompt, 5, 30)
    kernel_calls.clear()
    spec.run(draft_len, -1, 1)
    L = CFG.n_layers
    want = ({"K5": L, "K3": L, "K6": L, "K7": L, "K1": 1} if fused
            else {"K2": 4 * L + 1, "K3": L})
    assert dict(kernel_calls) == want


def test_speculative_matches_jax_pallas():
    """JAX with Pallas (interpret mode: its fused branch and flash
    kernels) gives the port's tokens."""
    _three_ways("q8", PROMPTS[1], 24, 4, use_pallas=True)


def _snapshot(spec, k):
    buf = spec.buffers_for(k)
    return [t.clone() for t in (buf.toks, buf.out, buf.state,
                                *kv_planes(spec.cache))]


def test_rounds_at_a_time_equal_one_round(monkeypatch):
    """R rounds of the body a call over the static buffers leave the
    buffers and the cache as R calls of one round do, through done and
    past it; generate_speculative gives the same tokens and verify count
    at every R."""
    _, pe = _engines_of("q8")
    prompt, k, R = PROMPTS[0], 3, 4
    spec = pe.round_graphs()
    next_tok = int(pe.prefill(spec.cache, [prompt])[0].argmax())

    def rounds_of(rounds):
        """24 rounds, `rounds` a call, from the prefill into a zeroed
        cache; the buffers and the cache after every R rounds."""
        for plane in kv_planes(spec.cache):
            plane.zero_()
        pe.prefill(spec.cache, [prompt])
        speculative.start(spec.buffers_for(k), prompt, next_tok, 12)
        snaps = []
        for i in range(24 // rounds):
            spec.run(k, -1, rounds)
            if (i + 1) * rounds % R == 0:
                snaps.append(_snapshot(spec, k))
        return snaps

    one, many = rounds_of(1), rounds_of(R)
    assert len(one) == len(many) == 24 // R
    assert one[-1][2][speculative.STATE.index("done")] == 1
    for a, b in zip(one, many):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    outs = []
    for r in (1, 2, R):
        monkeypatch.setattr(speculative, "ROUNDS", r)
        outs.append(pe.generate_speculative(prompt, _gens(40)[1], k))
    assert all(o == outs[0][0] for o, _ in outs)
    assert len({s.decode_token_times[0] for _, s in outs}) == 1
    assert [s.decode_steps % r for (_, s), r in zip(outs, (1, 2, R))] == [0] * 3


def test_rounds_after_done_change_nothing():
    """Once done, a round leaves toks, out and the state as they are."""
    _, pe = _engines_of("f32")
    pe.generate_speculative(PROMPTS[0], _gens(20)[1], 4)
    spec = pe.round_graphs()
    buf = spec.buffers_for(4)
    assert buf.done.item() == 1
    before = [t.clone() for t in (buf.toks, buf.out, buf.state)]
    spec.run(4, -1, 3)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 (buf.toks, buf.out, buf.state)))


class Rerun:
    """The capture's stand-in on the CPU (tests/test_torch_graphs.py's):
    a capture runs the body and puts back what it wrote (a capture
    records without running); a replay re-runs it with its counts kept
    out of the tables."""

    def __init__(self, state):
        self.state = state
        self.captures = 0

    def warm_up(self, body):
        body()

    def __call__(self, body, generator):
        saved = [t.clone() for t in self.state()]
        body()
        for t, s in zip(self.state(), saved):
            t.copy_(s)
        self.captures += 1

        def replay():
            with counts.tally(launched=False):
                body()
        return replay


def test_capture_path_keys_and_tokens(monkeypatch):
    """Through the capture path (a stand-in capture): one graph a (draft
    length, EOS, R) key, the first call's rounds eager and captured, the
    later ones replayed; the tokens those of the eager rounds."""
    _, pp, pol = _model("q8")
    eng = Engine(CFG, pol, pp, device="cpu")
    want = [eng.generate_speculative(p, _gens(40)[1], 3) for p in PROMPTS]
    eng = Engine(CFG, pol, pp, device="cpu")
    spec = eng.round_graphs()

    def state():
        return [t for b in spec.buffers.values()
                for t in (b.toks, b.out, b.state)] + kv_planes(spec.cache) + [
                    eng.nan_flag]

    spec.capture = Rerun(state)
    for p, (w, ws) in zip(PROMPTS, want):
        got, stats = eng.generate_speculative(p, _gens(40)[1], 3)
        assert got == w and stats.decode_token_times == ws.decode_token_times
    eng.generate_speculative(PROMPTS[0], _gens(40, eos=7)[1], 3)
    R = speculative.ROUNDS
    monkeypatch.setattr(speculative, "ROUNDS", 4)
    eng.generate_speculative(PROMPTS[0], _gens(40)[1], 3)
    monkeypatch.setattr(speculative, "ROUNDS", R)
    assert set(spec.graphs) == {(3, -1, R), (3, 7, R), (3, -1, 4)}
    assert spec.capture.captures == eng.graph_stats["graphs"] == 3
    eng.debug_nans = True
    eng.generate_speculative(PROMPTS[0], _gens(40)[1], 3)
    assert (3, -1, speculative.ROUNDS, "debug_nans") in spec.graphs


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True), "monolithic"),
    (dict(greedy=False), "greedy-only"),
    (dict(draft_len=speculative.PAD), "draft_len"),
    (dict(draft_len=-1), "draft_len"),
])
def test_refusals(kw, match):
    """Top-k, a page pool and a draft of 128 or more raise, as the JAX
    engine asserts."""
    _, pp, pol = _model("f32")
    eng = Engine(CFG, pol, pp, device="cpu", paged=kw.get("paged", False))
    gen = pconfig.GenerationConfig(n_predict=20, greedy=kw.get("greedy", True),
                                   eos_token=-1)
    with pytest.raises(ValueError, match=match):
        eng.generate_speculative([3, 7, 1], gen, kw.get("draft_len", 4))


def test_draft_len_0_is_generate():
    """draft_len 0 verifies one token a forward (the b1 branch, K8), as
    JAX runs it: generate's tokens, one verify a token."""
    got, stats = _three_ways("f32", PROMPTS[1], 30, 0)
    assert stats.decode_token_times[0] == len(got) - 1


def test_early_returns():
    """[] at a budget of 0 and when the prefill's token is EOS; one token
    at a budget of 1, no round run."""
    _, pe = _engines_of("f32")
    first, _ = pe.generate([3, 7, 1], _gens(10)[1])
    for n_predict, eos, want in ((3, -1, []), (10, first[0], []),
                                 (4, -1, first[:1])):
        got, stats = pe.generate_speculative([3, 7, 1], _gens(n_predict, eos)[1])
        assert got == want and stats.decode_steps == 0


def test_cli_spec(capsys):
    """--spec needs -greedy and the monolithic cache (the JAX CLI's
    messages); a run prints generate's tokens and the speculative line."""
    base = ["--random-weights", "--model", "tiny-test", "-q8", "-p", "hi hi hi",
            "--npred", "40", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--spec requires -greedy"):
        cli.main(base + ["--spec", "4"])
    with pytest.raises(SystemExit, match="--spec uses the monolithic cache"):
        cli.main(base + ["--spec", "4", "-greedy", "--paged"])
    assert cli.main(base + ["-greedy"]) == 0
    plain = capsys.readouterr()
    assert cli.main(base + ["-greedy", "--spec", "4"]) == 0
    spec = capsys.readouterr()
    assert spec.err == plain.err and len(spec.err.split()) > 10
    line = re.search(r" speculative : (\d+) tokens / (\d+) verify forwards = "
                     r"[\d.]+ tok per weight-stream \(draft K=4\)\n", spec.out)
    assert line and int(line[1]) == len(spec.err.split())
