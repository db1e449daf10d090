"""The port's codec, ops, samplers and entry points against the JAX
package, plus the port's source hygiene.

Inputs are made from a seed with numpy and fed to both packages. The
codec must match bit for bit; f32 ops within rtol/atol 1e-6.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import POLICIES as JAX_POLICIES
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.attention import gqa_attention as jax_gqa
from tinyllama_tpu.ops.norms import rms_norm as jax_rms_norm
from tinyllama_tpu.ops.rope import (
    apply_rope_gathered as jax_apply_rope,
    gather_rope as jax_gather_rope,
    rope_table as jax_rope_table,
)
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy, qtensor_from_numpy
from tinyllama_tpu_torch.ops import sampling
from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.norms import rms_norm
from tinyllama_tpu_torch.ops.rope import apply_rope_gathered, gather_rope, rope_table
from tinyllama_tpu_torch.quant import codec

PKG = Path(__file__).resolve().parent.parent / "tinyllama_tpu_torch"
F32 = dict(rtol=1e-6, atol=1e-6)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_tree_to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# --- config -------------------------------------------------------------------


def test_config_matches_jax():
    """The port's own copy of config.py: the same presets and policies."""
    import dataclasses

    from tinyllama_tpu.config import MODEL_REGISTRY

    for name, cfg in MODEL_REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            pconfig.MODEL_REGISTRY[name])
    assert dataclasses.asdict(jax_tiny()) == dataclasses.asdict(
        pconfig.tiny_test_config())
    assert {k: dataclasses.asdict(v) for k, v in JAX_POLICIES.items()} == {
        k: dataclasses.asdict(v) for k, v in pconfig.POLICIES.items()}


# --- codec ----------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["nk", "kn"])
def test_q8_codec_bit_equal(layout):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 40, 96)) * 0.05).astype(np.float32)
    w[0, 3, :32] = 0.0  # an all-zero block: zero scale, zero values
    jq = jcodec.quantize(jnp.asarray(w), "q8", layout=layout)
    pq = codec.quantize(torch.from_numpy(w), "q8", layout=layout)
    assert pq.layout == layout and pq.shape == (2, 40, 96)
    np.testing.assert_array_equal(pq.data.numpy(), np.asarray(jq.data))
    jscales = np.asarray(jq.scales)
    if jscales.dtype == np.int16:  # the JAX package's kn bit patterns
        jscales = jscales.view(np.float16)
    np.testing.assert_array_equal(pq.scales.numpy().view(np.uint16),
                                  jscales.view(np.uint16))
    np.testing.assert_array_equal(_bits(codec.dequantize(pq).numpy()),
                                  _bits(jcodec.dequantize(jq)))


def test_q8_round_half_to_even():
    # absmax 127 -> delta 1: x/delta lands exactly on .5 ties
    w = np.zeros((1, 32), np.float32)
    w[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    pq = codec.quantize(torch.from_numpy(w), "q8")
    assert pq.data[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_unported_quant_kinds_raise():
    """Every quantized kind is ported, and aq8 activations with q8 and q4
    weights (q8a8, q4a8); an unknown kind raises, and so do dense weights
    given to init_quantized_params (they take init_dense_params), and q4g
    with aq8, which has no aq8 branch."""
    from tinyllama_tpu_torch.models import llama

    with pytest.raises(ValueError, match="unknown quant kind"):
        codec.quantize(torch.zeros(4, 64), "q5")
    with pytest.raises(ValueError, match="unknown quant kind"):
        codec.block_size("q5")
    cfg = pconfig.tiny_test_config()
    for name in ("q8a8", "q4a8"):
        params = llama.init_quantized_params(cfg, pconfig.POLICIES[name],
                                             torch.Generator())
        assert params["lm_head"].kind == pconfig.POLICIES[name].wdtype
    with pytest.raises(ValueError, match="init_dense_params"):
        llama.init_quantized_params(cfg, pconfig.POLICIES["bf16"],
                                    torch.Generator())
    with pytest.raises(ValueError, match="q4g"):
        llama.init_quantized_params(
            cfg, pconfig.DtypePolicy("q4g", "bf16", "bf16", aq8=True),
            torch.Generator())


def test_params_from_numpy_bit_equal():
    """JAX's random q8 parameters carried across: dequantized values
    bit-equal, kn scales arriving as int16 fp16 bit patterns."""
    cfg = jax_tiny()
    policy = JaxPolicy("q8", "f32", "f32")
    jp = jllama.init_quantized_params(cfg, jax.random.PRNGKey(3), policy)
    assert np.asarray(jp["lm_head"].scales).dtype == np.int16
    pp = params_from_numpy(_jax_tree_to_numpy(jp), pconfig.tiny_test_config(),
                           pconfig.DtypePolicy("q8", "f32", "f32"))
    pairs = [(jp["embed"], pp["embed"]), (jp["lm_head"], pp["lm_head"])]
    pairs += [(jp["layers"][n], pp["layers"][n])
              for n in ("wqkv", "wo", "w_gateup", "w_down")]
    for jq, pq in pairs:
        np.testing.assert_array_equal(_bits(codec.dequantize(pq).numpy()),
                                      _bits(jcodec.dequantize(jq)))
    np.testing.assert_array_equal(pp["layers"]["attn_norm"].numpy(),
                                  np.asarray(jp["layers"]["attn_norm"]))


def test_convert_params_bit_equal():
    """Dense f32 parameters quantized by both packages' convert_params:
    the same layouts and bit-equal dequantized values."""
    from tinyllama_tpu_torch.models import llama as pllama

    cfg = jax_tiny()
    dense = jllama.init_dense_params(cfg, jax.random.PRNGKey(5))
    jp = jllama.convert_params(dense, JaxPolicy("q8", "f32", "f32"))
    as_torch = {k: torch.from_numpy(np.array(dense[k]))
                for k in ("embed", "norm", "lm_head")}
    as_torch["layers"] = {n: torch.from_numpy(np.array(w))
                          for n, w in dense["layers"].items()}
    pp = pllama.convert_params(as_torch, pconfig.DtypePolicy("q8", "f32", "f32"))
    for name in ("wqkv", "wo", "w_gateup", "w_down", "embed", "lm_head"):
        jq = jp["layers"].get(name) or jp[name]
        pq = pp["layers"].get(name) or pp[name]
        assert pq.layout == jq.layout
        np.testing.assert_array_equal(_bits(codec.dequantize(pq).numpy()),
                                      _bits(jcodec.dequantize(jq)))
    np.testing.assert_array_equal(pp["layers"]["ffn_norm"].numpy(),
                                  np.asarray(jp["layers"]["ffn_norm"]))


def test_qtensor_from_numpy_rejects_f32_scales():
    with pytest.raises(TypeError):
        qtensor_from_numpy((np.zeros((32, 4), np.int8),
                            np.zeros((1, 4), np.float32), "q8", "kn"))


# --- ops ------------------------------------------------------------------------


@pytest.mark.parametrize("inside", [False, True])
def test_rms_norm_matches_jax(inside):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, inside)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, inside)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    cos_j, sin_j = jax_rope_table(64, 32, 10000.0)
    cos_p, sin_p = rope_table(64, 32, 10000.0)
    np.testing.assert_array_equal(cos_p.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_p.numpy(), np.asarray(sin_j))
    positions = rng.integers(0, 64, (2, 3)).astype(np.int32)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    cj, sj = jax_gather_rope(jnp.asarray(positions), cos_j, sin_j)
    cp, sp = gather_rope(torch.from_numpy(positions), cos_p, sin_p)
    want = jax_apply_rope(jnp.asarray(x), cj, sj)
    got = apply_rope_gathered(torch.from_numpy(x), cp, sp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gqa_attention_matches_jax():
    rng = np.random.default_rng(3)
    B, T, H, Kh, S, d = 2, 3, 4, 2, 16, 8
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Kh, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Kh, S, d)).astype(np.float32)
    qpos = np.array([[2, 3, 4], [9, 10, 11]], np.int32)
    want = jax_gqa(*(jnp.asarray(a) for a in (q, k, v, qpos)))
    got = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v, qpos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_greedy_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 5.0, 0.0]])
    assert sampling.greedy(logits).tolist() == [1, 0]
    assert sampling.greedy(logits).dtype == torch.int32


def test_top_k_support_and_seed():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    top = set(torch.topk(logits, 5).indices.flatten().tolist())

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sampling.sample_top_k(logits, g, 0.9, 5)
                            for _ in range(20)])

    a, b = draw(7), draw(7)
    assert torch.equal(a, b)
    rows_top = [set(torch.topk(logits[r], 5).indices.tolist()) for r in range(4)]
    for r in range(4):
        assert set(a[:, r].tolist()) <= rows_top[r]
    assert set(a.flatten().tolist()) <= top


# --- entry points and hygiene -------------------------------------------------


def test_entry_points_raise_without_a_card():
    """No GPU and no explicit device: Engine and the CLI raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tinyllama_tpu_torch.cli import main
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.runtime.engine import Engine

    cfg = pconfig.tiny_test_config()
    policy = pconfig.POLICIES["q8"]
    params = llama.init_quantized_params(cfg, policy, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, policy, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--random-weights", "--model", "tiny-test", "-p", "x"])
    Engine(cfg, policy, params, device="cpu")  # explicit CPU is fine


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name, a.asname or a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                yield node.lineno, node.module, a.asname or a.name


@pytest.mark.parametrize("rule", ["no_jax", "no_reference_package",
                                  "no_unused_imports"])
def test_port_source_hygiene(rule):
    """The port and chip_smoke.py import neither JAX, nor the JAX package,
    nor the safetensors package (the port reads .safetensors itself), and
    (the rule of tests/test_lint.py) every import is used."""
    offenders = []
    sources = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert PKG / "io" / "checkpoint.py" in sources
    assert {PKG / "parallel" / name for name in (
        "mesh.py", "tp.py", "ring.py", "sp.py")} <= set(sources)
    for path in sources:
        tree = ast.parse(path.read_text())
        used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        used |= {n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        for lineno, module, name in _imports(tree):
            top = module.split(".")[0]
            where = f"{path.relative_to(PKG.parent)}:{lineno} {module}"
            if rule == "no_jax" and top in ("jax", "jaxlib", "safetensors"):
                offenders.append(where)
            elif rule == "no_reference_package" and top == "tinyllama_tpu":
                offenders.append(where)
            elif (rule == "no_unused_imports" and path.name != "__init__.py"
                  and name != "annotations" and name not in used):
                offenders.append(f"{where} {name}")
    assert not offenders, "\n".join(offenders)
