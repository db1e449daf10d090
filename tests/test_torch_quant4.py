"""The port's 4-bit weights (q4, q4g) against the JAX package: the codec,
the carrying of JAX parameter trees across, and K1/K2 (the quantized
matmul) against the Pallas kernel.

Inputs are made from a seed with numpy and fed to both packages. The
codec must match bit for bit: dequantized values in both layouts, at
d_in 128, 256, 2048 and 5632 (the JAX package packs q4g in groups of 128
at d_in 128 and of 256 at the others).
The matmul's plain version (what the wrapper runs for CPU tensors; the
CUDA kernels are held against it on the card) must match the Pallas
kernel in interpret mode within rtol/atol 1e-4 at f32 activations (only
the summation order differs: every 4-bit weight is exact in f32) and the
JAX suite's bf16 kernel tolerance, rtol 2e-2 / atol 5e-3, at bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.pallas.qmatmul import qmatmul as jax_qmatmul
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy, qtensor_from_numpy
from tinyllama_tpu_torch.models import llama as pllama
from tinyllama_tpu_torch.ops.kernels import decode_fused, ffn_fused, qmatmul
from tinyllama_tpu_torch.quant import codec
from tinyllama_tpu_torch.quant.codec import QTensor

KINDS = ["q4", "q4g"]
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=5e-3)}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
RNG = np.random.default_rng(7)

#: the JAX codec jitted: one compile a shape instead of one an eager op
jquantize = jax.jit(jcodec.quantize, static_argnums=(1, 2))
jdequantize = jax.jit(jcodec.dequantize)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# --- codec ----------------------------------------------------------------------


@pytest.mark.parametrize("d_in", [128, 256, 2048, 5632])
@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("kind", KINDS)
def test_codec_4bit_bit_equal(kind, layout, d_in):
    """quantize + dequantize bit-equal to the JAX codec, and the JAX
    QTensor carried across equals the port's own bytes."""
    w = (RNG.standard_normal((2, 24, d_in)) * 0.05).astype(np.float32)
    w[0, 3, :128] = 0.0  # an all-zero block: zero scale, zero values
    jq = jquantize(jnp.asarray(w), kind, layout)
    pq = codec.quantize(torch.from_numpy(w), kind, layout=layout)
    assert pq.layout == layout and pq.kind == kind and pq.shape == (2, 24, d_in)
    assert pq.data.dtype == torch.uint8 and pq.scales.dtype == torch.float16
    np.testing.assert_array_equal(_bits(codec.dequantize(pq).numpy()),
                                  _bits(jdequantize(jq)))
    carried = qtensor_from_numpy(_to_numpy(jq))
    assert torch.equal(carried.data, pq.data)
    assert torch.equal(carried.scales.view(torch.int16),
                       pq.scales.view(torch.int16))
    bs = codec.block_size(kind)
    rows = (2, d_in // 2, 24) if layout == "kn" else (2, 24, d_in // 2)
    sc = (2, d_in // bs, 24) if layout == "kn" else (2, 24, d_in // bs)
    assert tuple(pq.data.shape) == rows and tuple(pq.scales.shape) == sc


def _fuzz_cases():
    shapes = [(1, 128), (3, 384), (8, 512), (5, 1664), (2, 2048)]
    return [(s, sc) for s in shapes for sc in (1e-8, 1e-3, 1.0, 3e3)]


@pytest.mark.parametrize("shape,scale", _fuzz_cases())
@pytest.mark.parametrize("kind", KINDS)
def test_codec_4bit_fuzz_matches_oracles(shape, scale, kind):
    """The analog of tests/test_codec_fuzz.py: random shapes and
    magnitudes (denormal scales, zero blocks, saturating values); q4
    against the numpy oracles of both packages, q4g against the JAX
    codec, all exact."""
    w = (RNG.standard_normal(shape) * scale).astype(np.float32)
    w[0, :codec.BLOCK_SIZE] = 0.0
    w[-1, -1] = scale * 8
    got = codec.dequantize(codec.quantize(torch.from_numpy(w), kind)).numpy()
    if kind == "q4":
        vals, deltas = codec.np_quantize_q4(w)
        jvals, jdeltas = jcodec.np_quantize_q4(w)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(deltas.view(np.uint16),
                                      jdeltas.view(np.uint16))
        want = jcodec.np_dequantize_q4_unpacked(jvals, jdeltas)
        np.testing.assert_array_equal(
            codec.np_dequantize_q4_unpacked(vals, deltas), want)
    else:
        want = np.asarray(jdequantize(jquantize(jnp.asarray(w), kind, "nk")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_kn_layout_same_values_4bit(kind):
    """kn holds the nk values transposed; to_kn is a transpose of both
    planes."""
    for shape in [(4, 128), (6, 384), (2, 1024)]:
        w = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))
        nk = codec.quantize(w, kind, layout="nk")
        kn = codec.quantize(w, kind, layout="kn")
        assert torch.equal(codec.to_kn(nk).data, kn.data)
        assert torch.equal(codec.dequantize(nk), codec.dequantize(kn).T)


def test_gten_q4_packing_matches_jax():
    """gten's half-block packing is the port's nibble order: the nk data
    of a q4 tensor is the gten payload's bytes, and the numpy pack and
    unpack equal the JAX package's."""
    w = RNG.standard_normal((5, 256)).astype(np.float32)
    vals, _ = codec.np_quantize_q4(w)
    packed = codec.gten_q4_pack(vals)
    np.testing.assert_array_equal(packed, jcodec.gten_q4_pack(vals))
    np.testing.assert_array_equal(codec.gten_q4_unpack(packed),
                                  jcodec.gten_q4_unpack(packed))
    np.testing.assert_array_equal(codec.gten_q4_unpack(packed), vals)
    nk = codec.quantize(torch.from_numpy(w), "q4")
    np.testing.assert_array_equal(nk.data.numpy(), packed)
    np.testing.assert_array_equal(
        codec.unpack_q4(torch.from_numpy(packed)).numpy(), vals)


def test_unknown_kinds_and_shapes_raise():
    with pytest.raises(ValueError, match="unknown quant kind"):
        codec.quantize(torch.zeros(4, 128), "q3")
    with pytest.raises(ValueError, match="128"):
        codec.quantize(torch.zeros(4, 96), "q4g")
    with pytest.raises(ValueError, match="unknown layout"):
        codec.quantize(torch.zeros(4, 128), "q4", layout="mk")


# --- interop and parameters -------------------------------------------------------


def _jax_params(kind, cfg, seed=3):
    """What JAX's init_quantized_params builds (per-row quantization, so
    quantizing the stacked layers equals stacking quantized layers), from
    numpy weights through the jitted JAX codec."""
    rng = np.random.default_rng(seed)

    def q(shape, layout):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return jquantize(jnp.asarray(w), kind, layout)

    L, D, F, V = cfg.n_layers, cfg.n_embd, cfg.n_ffn, cfg.n_vocab
    layers = {"wqkv": q((L, D + 2 * cfg.kv_dim, D), "kn"),
              "wo": q((L, D, D), "kn"), "w_gateup": q((L, 2 * F, D), "kn"),
              "w_down": q((L, D, F), "kn"),
              "attn_norm": np.ones((L, D), np.float32),
              "ffn_norm": np.ones((L, D), np.float32)}
    return {"embed": q((V, D), "nk"), "layers": layers,
            "norm": np.ones(D, np.float32), "lm_head": q((V, D), "kn")}


@pytest.mark.parametrize("n_embd", [128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_params_from_numpy_4bit_bit_equal(kind, n_embd):
    """JAX's random q4/q4g trees carried across (kn planar groups, the
    XOR 0x80 bias, q4g's 4x scale rows and nk planar groups undone):
    every tensor's dequantized values bit-equal. n_embd 128 puts q4g in
    JAX's pack group 128, 256 in group 256."""
    jcfg = jax_tiny(n_embd=n_embd, n_ffn=2 * n_embd)
    pcfg = pconfig.tiny_test_config(n_embd=n_embd, n_ffn=2 * n_embd)
    jp = _jax_params(kind, jcfg)
    pp = params_from_numpy(_to_numpy(jp), pcfg, pconfig.DtypePolicy(kind, "f32", "f32"))
    pairs = [(jp["embed"], pp["embed"]), (jp["lm_head"], pp["lm_head"])]
    pairs += [(jp["layers"][n], pp["layers"][n])
              for n in ("wqkv", "wo", "w_gateup", "w_down")]
    for jq, pq in pairs:
        assert pq.kind == kind and pq.layout == jq.layout
        np.testing.assert_array_equal(_bits(codec.dequantize(pq).numpy()),
                                      _bits(jdequantize(jq)))


def test_params_from_numpy_refuses_a_kind_mismatch():
    jp = _jax_params("q4", jax_tiny())
    with pytest.raises(ValueError, match="q4g kn"):
        params_from_numpy(_to_numpy(jp), pconfig.tiny_test_config(),
                          pconfig.DtypePolicy("q4g", "f32", "f32"))


@pytest.mark.parametrize("kind", KINDS)
def test_convert_params_4bit_bit_equal(kind):
    """convert_params quantizes as JAX's does: each matmul weight kn, the
    embedding table nk (JAX's convert_params is its codec per tensor,
    here jitted)."""
    cfg = jax_tiny()
    dense = jllama.init_dense_params(cfg, jax.random.PRNGKey(5))
    as_torch = {k: torch.from_numpy(np.array(dense[k]))
                for k in ("embed", "norm", "lm_head")}
    as_torch["layers"] = {n: torch.from_numpy(np.array(w))
                          for n, w in dense["layers"].items()}
    pp = pllama.convert_params(as_torch, pconfig.DtypePolicy(kind, "f32", "f32"))
    for name in ("wqkv", "wo", "w_gateup", "w_down", "embed", "lm_head"):
        w = dense["layers"].get(name)
        w = dense[name] if w is None else w
        layout = "nk" if name == "embed" else "kn"
        pq = pp["layers"].get(name) or pp[name]
        assert pq.layout == layout and pq.kind == kind
        np.testing.assert_array_equal(
            _bits(codec.dequantize(pq).numpy()),
            _bits(jdequantize(jquantize(w, kind, layout))))


@pytest.mark.parametrize("kind", KINDS)
def test_padded_lm_head_and_embedding(kind):
    """The vocab-padded 4-bit lm_head gives zero logits in its pad columns
    (zero scales null the -7 offset) and the unpadded logits otherwise;
    the embedding lookup dequantizes the gathered nk rows."""
    cfg = pconfig.tiny_test_config(n_vocab=500)
    pol = pconfig.DtypePolicy(kind, "f32", "f32")
    pp = pllama.init_quantized_params(cfg, pol, torch.Generator().manual_seed(1))
    padded = pllama.pad_lm_head_vocab(pp, multiple=128)
    assert padded["lm_head"].data.shape[-1] == 512
    h = torch.randn(3, cfg.n_embd, generator=torch.Generator().manual_seed(2))
    full = qmatmul.qmatmul(h, padded["lm_head"], torch.float32)
    assert torch.equal(full[:, 500:], torch.zeros(3, 12))
    torch.testing.assert_close(pllama.lm_head_logits(padded, h),
                               pllama.lm_head_logits(pp, h), rtol=0, atol=0)
    toks = torch.tensor([[0, 7, 499]])
    rows = pllama.embedding_lookup(toks, pp["embed"], torch.float32)
    assert torch.equal(rows[0], codec.dequantize(pp["embed"])[[0, 7, 499]])


def test_tree_nbytes_counts_the_4bit_planes():
    """The perf table's weight bytes are the planes' own: half a byte a
    weight plus a 2-byte scale per block."""
    from tinyllama_tpu_torch.runtime.perf import tree_nbytes

    w = torch.randn(64, 256)
    for kind, per_weight in (("q8", 1 + 2 / 32), ("q4", 0.5 + 2 / 32),
                             ("q4g", 0.5 + 2 / 128)):
        assert tree_nbytes(codec.quantize(w, kind, "kn")) == 64 * 256 * per_weight


# --- K1 / K2 ----------------------------------------------------------------------


def _stacked(kind, L, K, N, seed):
    """A layer-stacked kn weight quantized by the JAX codec: the JAX
    QTensor and the port's copy of its values."""
    rng = np.random.default_rng(seed)
    jw = jquantize(jnp.asarray(rng.standard_normal((L, N, K)) * 0.05,
                               jnp.float32), kind, "kn")
    return jw, qtensor_from_numpy(_to_numpy(jw))


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("M", [1, 4, 16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_qmatmul_4bit_matches_pallas(kind, M, K, adtype):
    """K1 (M <= 8) and K2 (M > 8), layer-stacked, ragged N, f32 out."""
    N, L, li = 300, 2, 1
    jw, pw = _stacked(kind, L, K, N, seed=M + K)
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    jx = jnp.asarray(x, JNP[adtype])
    want = jax_qmatmul(jx, jw, out_dtype=jnp.float32, layer=jnp.int32(li),
                       interpret=True)
    px = torch.from_numpy(_np(jx)).to(TORCH[adtype])
    got = qmatmul.qmatmul(px, pw, out_dtype=torch.float32,
                          layer=torch.tensor([li], dtype=torch.int32))
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL[adtype])


# --- what the kernels refuse --------------------------------------------------------


def _bad_4bit_weights():
    g = torch.Generator().manual_seed(0)
    w4 = codec.quantize(torch.randn(2, 32, 256, generator=g), "q4", "kn")
    w4g = codec.quantize(torch.randn(2, 32, 256, generator=g), "q4g", "kn")
    return {
        "int8 nibble data": QTensor(w4.data.view(torch.int8), w4.scales, "q4",
                                    "kn"),
        "q4 data under q4g scales": QTensor(w4.data, w4g.scales, "q4", "kn"),
        "q4g with q4 scales": QTensor(w4g.data, w4.scales, "q4g", "kn"),
        "unpacked rows": QTensor(torch.cat([w4.data, w4.data], 1), w4.scales,
                                 "q4", "kn"),
        "q4g K % 128": QTensor(w4g.data[:, :48], w4g.scales[:, :1], "q4g", "kn"),
        "f32 scales": QTensor(w4.data, w4.scales.float(), "q4", "kn"),
        "nk layout": QTensor(w4.data, w4.scales, "q4", "nk"),
    }


@pytest.mark.parametrize("case", list(_bad_4bit_weights()))
def test_4bit_weight_checks_refuse(case):
    """A malformed 4-bit weight is refused before any launch (the checks
    run ahead of the device check, so they run here)."""
    w = _bad_4bit_weights()[case]
    K = 96 if case == "q4g K % 128" else 256
    x = torch.zeros(1, K, dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        qmatmul._check(x, w, torch.tensor([0], dtype=torch.int32), torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        decode_fused.check_rows(x, w, torch.tensor([0], dtype=torch.int32))


def test_ffn_refuses_mixed_kinds():
    """K7 takes its two weights of one kind (one kind code a launch)."""
    g = torch.Generator().manual_seed(1)
    gu = codec.quantize(torch.randn(2, 512, 128, generator=g), "q4", "kn")
    dn = codec.quantize(torch.randn(2, 128, 256, generator=g), "q4g", "kn")
    x = torch.zeros(1, 1, 128, dtype=torch.bfloat16)
    cfg = pconfig.tiny_test_config()
    with pytest.raises(ValueError, match="one kind"):
        ffn_fused._launch(x, None, gu, dn, torch.tensor([0], dtype=torch.int32),
                          cfg, 0.0, False, "ffn_fused")
