"""The dense policies (f16, bf16, f32) against the JAX package.

JAX builds random dense f32 weights and casts them per policy
(``convert_params``); they cross to the port through
``interop.params_from_numpy``, bits unchanged. The port's dense path runs
no kernel, as the JAX package runs dense weights without Pallas: its
``linear``, ``embedding_lookup`` and a 2-layer forward must match JAX's
at rtol 2e-2 / atol 5e-3 under bf16 activations (the JAX suite's bf16
tolerance, tests/test_tpu_kernels.py) and within 1e-5 of the largest
value under f32, and greedy tokens at f32 must be JAX's on every cache
kind. An fp16 .gten loads into each dense policy as JAX loads it, bit for
bit; the converter writes the JAX converter's bytes; the CLI defaults to
-f16.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import POLICIES as JPOLICIES
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.io import checkpoint as jckpt
from tinyllama_tpu.io import convert as jconvert
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.kvcache import init_cache as jax_init_cache
from tinyllama_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from tinyllama_tpu_torch.io import checkpoint, convert
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.linear import embedding_lookup, linear, linear_f32_out
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import init_cache
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher

#: the module (tinyllama_tpu.ops re-exports a function of its name)
jlinear = importlib.import_module("tinyllama_tpu.ops.linear")
JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
DENSE = ("f16", "bf16", "f32")
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}


def _close(got, want, adtype, scaled=False):
    """bf16 activations: the JAX suite's bf16 tolerance, its atol times
    the largest |value| when `scaled`; f32: 1e-5 of the largest |value|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if adtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=5e-3 * (scale if scaled else 1.0))


def _f32(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t, jnp.float32))


_params: dict = {}


def _both(name):
    """JAX's dense params of the policy and the port's copy."""
    if name not in _params:
        jd = jllama.init_dense_params(JCFG, jax.random.PRNGKey(7))
        jp = jllama.convert_params(jd, JPOLICIES[name])
        pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                               pconfig.POLICIES[name])
        _params[name] = jp, pp
    return _params[name]


# --- the ops ------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_linear_matches_jax(name):
    """linear (a stacked weight's layer 1) and linear_f32_out (the
    lm_head) on the same activations, in the policy's activation dtype."""
    jp, pp = _both(name)
    adt = pconfig.POLICIES[name].adtype
    x = np.random.default_rng(1).standard_normal((3, 5, CFG.n_embd)).astype(
        np.float32)
    jx = jnp.asarray(x, JNP[adt])
    px = tensor_from_numpy(np.asarray(jx))
    got = linear(px, pp["layers"]["wqkv"], 1)
    assert got.dtype == px.dtype and pp["layers"]["wqkv"].dtype == \
        llama.DTYPES[name]
    _close(_f32(got), _f32(jlinear.linear(jx, jp["layers"]["wqkv"][1])), adt)
    got = linear_f32_out(px, pp["lm_head"])
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(jlinear.linear_f32_out(jx, jp["lm_head"])),
           adt)


@pytest.mark.parametrize("name", DENSE)
def test_embedding_lookup_matches_jax(name):
    """A gather and a cast: bit-equal."""
    jp, pp = _both(name)
    adt = pconfig.POLICIES[name].adtype
    toks = np.random.default_rng(2).integers(0, CFG.n_vocab, (2, 7))
    got = embedding_lookup(torch.from_numpy(toks), pp["embed"], llama.DTYPES[adt])
    want = jlinear.embedding_lookup(jnp.asarray(toks), jp["embed"], JNP[adt])
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_jax(name):
    """A 2-layer forward: a 2-row prefill at pos 0, then a decode step over
    the cache both wrote (the policy's KV dtype); logits at the bf16
    tolerance, the bf16 hidden states and cache at its atol times their
    largest |value|: JAX's jitted forward keeps bf16 intermediates in
    excess precision (XLA's default), so from layer 1 on an entry that
    cancels to near 0 differs by the rounding of its operands (~3.5 at
    most here), not of its own value."""
    jp, pp = _both(name)
    jpol, pol = JPOLICIES[name], pconfig.POLICIES[name]
    B, T = 2, 9
    rng = np.random.default_rng(3)
    jc = jax_init_cache(JCFG, B, jpol.kv_dtype)
    pc = init_cache(CFG, B, pol.kv_dtype)
    for toks, pos in ((rng.integers(0, CFG.n_vocab, (B, T)), [0, 0]),
                      (rng.integers(0, CFG.n_vocab, (B, 1)), [T, T])):
        jh, jc = jllama.forward(JCFG, jpol, jp, jnp.asarray(toks, jnp.int32),
                                jc, jnp.asarray(pos, jnp.int32))
        ph = llama.forward(CFG, pol, pp, torch.from_numpy(toks), pc,
                           torch.tensor(pos, dtype=torch.int32))
        _close(_f32(ph), _f32(jh), pol.adtype, scaled=True)
        n = toks.shape[1]
        jl = jllama.lm_head_logits(jp, jh.reshape(B * n, -1))
        pl = llama.lm_head_logits(pp, ph.reshape(B * n, -1))
        assert pl.shape == (B * n, CFG.n_vocab)
        _close(pl.numpy(), np.asarray(jl), pol.adtype)
    _close(_f32(pc.k), _f32(jc.k), pol.adtype, scaled=True)


# --- greedy tokens at f32 -----------------------------------------------------------


GEN = dict(greedy=True, eos_token=-1, chunk_size=8)
PROMPTS = [[1, 3, 7, 9], [1, 9, 2, 4, 8, 5, 30], [1, 11, 6], [1, 2, 3, 4, 5]]


@pytest.mark.parametrize("run", ["monolithic", "paged", "batcher"])
def test_greedy_f32_token_identical(run):
    """f32 weights and activations: the JAX engine's greedy tokens from a
    monolithic and a paged generate, and its batcher's (2 slots, 4
    requests) from the port's."""
    jp, pp = _both("f32")
    jpol, pol = JPOLICIES["f32"], pconfig.POLICIES["f32"]
    if run == "batcher":
        jb = JaxBatcher(JaxEngine(JCFG, jpol, jp, max_batch=2),
                        JaxGen(n_predict=20, **GEN), max_batch=2)
        pb = ContinuousBatcher(Engine(CFG, pol, pp, device="cpu"),
                               pconfig.GenerationConfig(n_predict=20, **GEN),
                               max_batch=2)
        jids = [jb.submit(p) for p in PROMPTS]
        pids = [pb.submit(p) for p in PROMPTS]
        jres, pres = jb.run(), pb.run()
        for j, p in zip(jids, pids):
            assert pres[p].output == [int(t) for t in jres[j].output]
            assert len(pres[p].output) > 8
        return
    paged = run == "paged"
    prompt = PROMPTS[1]
    n = len(prompt) + 20
    jout, _ = JaxEngine(JCFG, jpol, jp, paged=paged).generate(
        prompt, JaxGen(n_predict=n, **GEN))
    pout, _ = Engine(CFG, pol, pp, device="cpu", paged=paged).generate(
        prompt, pconfig.GenerationConfig(n_predict=n, **GEN))
    assert len(pout) == 20 and pout == [int(t) for t in jout]


def test_engine_runs_dense_as_the_activation_dtype():
    """The f16 policy stores its weights as bf16 (the values every JAX
    product casts them to) and pads no lm_head; the logits keep the
    vocab."""
    _, pp = _both("f16")
    eng = Engine(CFG, pconfig.POLICIES["f16"], pp, device="cpu")
    assert pp["layers"]["wqkv"].dtype == torch.float16
    for w in (eng.params["embed"], eng.params["lm_head"],
              eng.params["layers"]["w_down"]):
        assert w.dtype == torch.bfloat16
    assert eng.params["lm_head"].shape == (CFG.n_vocab, CFG.n_embd)
    assert eng.params["layers"]["attn_norm"].dtype == torch.float32
    torch.testing.assert_close(eng.params["layers"]["wo"],
                               pp["layers"]["wo"].to(torch.bfloat16),
                               rtol=0, atol=0)
    logits, _ = eng.prefill(eng.new_cache(1), [PROMPTS[0]])
    assert logits.shape == (1, CFG.n_vocab) and logits.dtype == torch.float32


# --- checkpoints --------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_np():
    d = jllama.init_dense_params(JCFG, jax.random.PRNGKey(3))
    return jax.tree_util.tree_map(np.asarray, d)


@pytest.fixture(scope="module")
def files(dense_np, tmp_path_factory):
    out = tmp_path_factory.mktemp("gten")
    paths = {}
    for dtype in ("fp16", "q8"):
        paths[dtype] = out / f"m.{dtype}.gten"
        jckpt.save_gten_checkpoint(paths[dtype], JCFG, dense_np, dtype)
    return paths


def _assert_bits_equal(pp, jp):
    pairs = [("embed", pp["embed"], jp["embed"]),
             ("lm_head", pp["lm_head"], jp["lm_head"]),
             ("norm", pp["norm"], jp["norm"])]
    pairs += [(n, pp["layers"][n], jp["layers"][n]) for n in jp["layers"]]
    for name, p, j in pairs:
        j = np.asarray(j)
        assert str(p.dtype).split(".")[-1] == {"bfloat16": "bfloat16",
                                               "float16": "float16",
                                               "float32": "float32"}[j.dtype.name]
        assert tuple(p.shape) == j.shape, name
        np.testing.assert_array_equal(p.view(torch.int16 if p.element_size() == 2
                                             else torch.int32).numpy(),
                                      j.view(np.int16 if j.itemsize == 2
                                             else np.int32), err_msg=name)


@pytest.mark.parametrize("name", [None, *DENSE])
def test_fp16_gten_loads_into_dense_policy(files, name):
    """An fp16 file into f16 (its own policy, also with no policy given),
    bf16 and f32: every tensor bit-equal to the JAX loader's."""
    jp, jpol = jckpt.load_gten_checkpoint(files["fp16"], JCFG,
                                          name and JPOLICIES[name])
    pp, pol = checkpoint.load_gten_checkpoint(files["fp16"], CFG,
                                              name and pconfig.POLICIES[name])
    assert pol == pconfig.POLICIES[name or "f16"] and jpol.wdtype == pol.wdtype
    _assert_bits_equal(pp, jp)


def test_quantized_gten_under_dense_policy_raises(files):
    """A q8 file under f16 raises in both packages."""
    with pytest.raises(ValueError, match="incompatible"):
        jckpt.load_gten_checkpoint(files["q8"], JCFG, JPOLICIES["f16"])
    with pytest.raises(ValueError, match="incompatible"):
        checkpoint.load_gten_checkpoint(files["q8"], CFG, pconfig.POLICIES["f16"])


@pytest.fixture(scope="module")
def hf_bin(dense_np, tmp_path_factory):
    """A tiny HF .bin (torch.save of a state dict) of the same weights."""
    D, kv, F = CFG.n_embd, CFG.kv_dim, CFG.n_ffn
    sd = {"model.embed_tokens.weight": dense_np["embed"],
          "model.norm.weight": dense_np["norm"] + 0.5,
          "lm_head.weight": dense_np["lm_head"]}
    split = {"wqkv": (("self_attn.q_proj", 0, D), ("self_attn.k_proj", D, D + kv),
                      ("self_attn.v_proj", D + kv, D + 2 * kv)),
             "wo": (("self_attn.o_proj", 0, D),),
             "w_gateup": (("mlp.gate_proj", 0, F), ("mlp.up_proj", F, 2 * F)),
             "w_down": (("mlp.down_proj", 0, D),)}
    L = dense_np["layers"]
    for i in range(CFG.n_layers):
        for rname, parts in split.items():
            for hf, lo, hi in parts:
                sd[f"model.layers.{i}.{hf}.weight"] = L[rname][i][lo:hi]
        sd[f"model.layers.{i}.input_layernorm.weight"] = L["attn_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = L["ffn_norm"][i]
    path = tmp_path_factory.mktemp("hf") / "pytorch_model.bin"
    torch.save({k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
                if k.endswith("up_proj.weight") else torch.from_numpy(np.array(v))
                for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("dtype", ["fp16", "q8", "q4"])
def test_convert_bytes_equal_jax(hf_bin, tmp_path, dtype, capsys,
                                 monkeypatch):
    """python -m tinyllama_tpu_torch.io.convert writes the JAX converter's
    bytes (the up projections are bf16 in the file: both read them as f32,
    exactly)."""
    want = jconvert.convert_model_to_gten(hf_bin, dtype, tmp_path / "j.gten",
                                          JCFG)
    got = tmp_path / "p.gten"
    monkeypatch.setitem(pconfig.MODEL_REGISTRY, "tiny-test", CFG)
    assert convert.main([str(hf_bin), dtype, "-o", str(got), "--model",
                         "tiny-test"]) == 0
    assert f"wrote {got}" in capsys.readouterr().out
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("name", DENSE)
def test_hf_checkpoint_loads_into_dense_policy(hf_bin, name):
    """load_hf_checkpoint under a dense policy: JAX's tensors, bits
    equal."""
    jp = jckpt.load_hf_checkpoint(hf_bin, JCFG, JPOLICIES[name])
    pp = checkpoint.load_hf_checkpoint(hf_bin, CFG, pconfig.POLICIES[name])
    _assert_bits_equal(pp, jp)


# --- the CLI ------------------------------------------------------------------------


def _run_cli(monkeypatch, *flags):
    seen = {}

    class Spy(Engine):
        def __init__(self, cfg, policy, params, *a, **k):
            seen["policy"], seen["params"] = policy, params
            super().__init__(cfg, policy, params, *a, **k)

        def new_cache(self, batch):
            cache = super().new_cache(batch)
            seen["cache"] = cache.k.dtype
            return cache

    monkeypatch.setattr(cli, "Engine", Spy)
    assert cli.main(["--random-weights", "--model", "tiny-test", "-p",
                     "hello", "-greedy", "--npred", "12", "--device", "cpu",
                     *flags]) == 0
    return seen


@pytest.mark.parametrize("flags,name", [((), "f16"), (("-f16",), "f16"),
                                        (("--bf16",), "bf16"),
                                        (("--f32",), "f32")])
def test_cli_dense_flags(monkeypatch, capsys, flags, name):
    """No flag is -f16, as in the JAX CLI; --random-weights under a dense
    policy are dense weights of its wdtype."""
    seen = _run_cli(monkeypatch, *flags)
    assert seen["policy"] == pconfig.POLICIES[name]
    assert seen["params"]["layers"]["wqkv"].dtype == llama.DTYPES[name]
    out = capsys.readouterr()
    assert len(out.err.split()) == 12 - 6 and "Throughput" in out.out


def test_cli_kv_i8_with_f16(monkeypatch, capsys):
    """--kv composes with a dense policy: f16 weights over an int8 cache."""
    seen = _run_cli(monkeypatch, "-f16", "--kv", "i8")
    assert seen["policy"] == dataclasses.replace(pconfig.POLICIES["f16"],
                                                 kv_dtype="i8")
    assert seen["cache"] == torch.int8
    assert len(capsys.readouterr().err.split()) == 12 - 6
