"""The port's fused decode-layer kernels (K5-K8) with 4-bit weights (q4,
q4g) against the JAX package's Pallas kernels.

JAX quantizes random weights of tiny_test_config (n_embd 128, n_ffn
256: K of 128 for wqkv, wo and w_gateup and 256 for w_down, so q4g's
JAX packing groups of 128 and 256 both occur); they cross to the port
through interop.params_from_numpy. Activations are made from a seed with
numpy and go through the Pallas kernel in interpret mode and through the
port's plain version on the CPU (what its wrappers run for CPU tensors),
at layer 1 and at M in {1, 4, 16, 32}, which covers both of the TPU
kernels' dot bodies (blockdot at M <= 8, tile dequant above).

Tolerances: at f32 rtol/atol 1e-4 (1e-3 for K7, as for q8 in
tests/test_torch_fused.py): every 4-bit weight is exact in f32, so only
the summation order differs. At bf16 the JAX suite's bf16 kernel
tolerance, rtol 2e-2 / atol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.ops.pallas import attn_out_fused as jattn
from tinyllama_tpu.ops.pallas import decode_fused as jdf
from tinyllama_tpu.ops.pallas import ffn_fused as jffn
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import qtensor_from_numpy
from tinyllama_tpu_torch.ops.kernels import attn_out_fused, decode_fused, ffn_fused
from tinyllama_tpu_torch.runtime.kvcache import KVCache

JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
KINDS = ["q4", "q4g"]
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=5e-3)}
FFN_TOL = {"f32": dict(rtol=1e-3, atol=1e-3), "bf16": TOL["bf16"]}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
LAYER = 1
M_CASES = [1, 4, 16, 32]

jquantize = jax.jit(jcodec.quantize, static_argnums=(1, 2))


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=KINDS)
def weights(request):
    """(kind, JAX layer weights, the port's copy): the four stacked kn
    weights of a 2-layer tiny model and random positive norm weights."""
    kind = request.param
    rng = np.random.default_rng(9)
    L, D, F = CFG.n_layers, CFG.n_embd, CFG.n_ffn
    shapes = {"wqkv": (L, D + 2 * CFG.kv_dim, D), "wo": (L, D, D),
              "w_gateup": (L, 2 * F, D), "w_down": (L, D, F)}
    jl, pl = {}, {}
    for name, shape in shapes.items():
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        jl[name] = jquantize(jnp.asarray(w), kind, "kn")
        pl[name] = qtensor_from_numpy((np.asarray(jl[name].data),
                                       np.asarray(jl[name].scales), kind, "kn"))
    for name in ("attn_norm", "ffn_norm"):
        w = np.abs(rng.standard_normal((L, D))).astype(np.float32) + 0.5
        jl[name], pl[name] = jnp.asarray(w), torch.from_numpy(w)
    return kind, jl, pl


def _rows(adtype, shape, seed):
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    JNP[adtype])
    return a, torch.from_numpy(_np(a)).to(TORCH[adtype])


def _layer():
    return torch.tensor([LAYER], dtype=torch.int32)


def _check(got, want, tol, shape, dtype):
    assert tuple(got.shape) == shape and got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_fused_norm_qkv_4bit_matches_pallas(weights, adtype, M):
    kind, jl, pl = weights
    assert pl["wqkv"].kind == kind
    jx, px = _rows(adtype, (M, 1, CFG.n_embd), seed=M)
    want = jdf.fused_norm_qkv(jx, jl["attn_norm"], jl["wqkv"], jnp.int32(LAYER),
                              CFG.norm_eps, CFG.norm_eps_inside_sqrt,
                              interpret=True)
    got = decode_fused.fused_norm_qkv(px, pl["attn_norm"], pl["wqkv"], _layer(),
                                      CFG.norm_eps, CFG.norm_eps_inside_sqrt)
    _check(got, want, TOL[adtype], (M, 1, pl["wqkv"].data.shape[-1]),
           TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_fused_out_residual_4bit_matches_pallas(weights, adtype, M):
    _, jl, pl = weights
    ja, pa = _rows(adtype, (1, M, CFG.n_embd), seed=10 + M)
    jr, pr = _rows(adtype, (1, M, CFG.n_embd), seed=20 + M)
    want = jdf.fused_out_residual(ja, jr, jl["wo"], jnp.int32(LAYER),
                                  interpret=True)
    got = decode_fused.fused_out_residual(pa, pr, pl["wo"], _layer())
    _check(got, want, TOL[adtype], (1, M, CFG.n_embd), TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_ffn_fused_normed_4bit_matches_pallas(weights, adtype, M):
    _, jl, pl = weights
    jx, px = _rows(adtype, (M, 1, CFG.n_embd), seed=30 + M)
    want = jffn.ffn_fused_normed(jx, jl["ffn_norm"], jl["w_gateup"],
                                 jl["w_down"], jnp.int32(LAYER), JCFG,
                                 interpret=True)
    got = ffn_fused.ffn_fused_normed(px, pl["ffn_norm"], pl["w_gateup"],
                                     pl["w_down"], _layer(), CFG)
    _check(got, want, FFN_TOL[adtype], (M, 1, CFG.n_embd), TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_ffn_fused_4bit_matches_pallas(weights, adtype, M):
    """K7's plain entry: an already normed input, no residual."""
    _, jl, pl = weights
    jh, ph = _rows(adtype, (1, M, CFG.n_embd), seed=40 + M)
    want = jffn.ffn_fused(jh, jl["w_gateup"], jl["w_down"], jnp.int32(LAYER),
                          JCFG, interpret=True)
    got = ffn_fused.ffn_fused(ph, pl["w_gateup"], pl["w_down"], _layer(), CFG)
    _check(got, want, FFN_TOL[adtype], (1, M, CFG.n_embd), TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 100])
def test_fused_attn_out_4bit_matches_pallas(weights, adtype, pos):
    """Attention over keys 0..pos of layer 1, then the 4-bit wo and the
    residual, in one call."""
    _, jl, pl = weights
    L, Kh, S, d = CFG.n_layers, CFG.n_kv_heads, CFG.max_ctx, CFG.d_head
    rng = np.random.default_rng(50 + pos)
    kv = np.zeros((2, L, 1, Kh, S, d), np.float32)
    kv[..., : pos + 1, :] = rng.standard_normal((2, L, 1, Kh, pos + 1, d))
    jk, jv = (jnp.asarray(a, JNP[adtype]) for a in kv)
    jc = JaxKVCache(k=jk, v=jv, k_scale=None, v_scale=None)
    pc = KVCache(k=torch.from_numpy(_np(jk)).to(TORCH[adtype]),
                 v=torch.from_numpy(_np(jv)).to(TORCH[adtype]))
    jq, pq = _rows(adtype, (1, 1, CFG.n_heads, d), seed=60 + pos)
    jr, pr = _rows(adtype, (1, 1, CFG.n_embd), seed=70 + pos)
    want = jattn.fused_attn_out(jq, jc, jnp.int32(LAYER),
                                jnp.asarray([pos], jnp.int32), jr, jl["wo"],
                                interpret=True)
    got = attn_out_fused.fused_attn_out(pq, pc, _layer(),
                                        torch.tensor([pos], dtype=torch.int32),
                                        pr, pl["wo"])
    _check(got, want, TOL[adtype], (1, 1, CFG.n_embd), TORCH[adtype])


@pytest.mark.parametrize("M", [1, 33])
def test_fused_gate_ignores_the_kind(weights, M):
    """decode_fused_eligible takes 4-bit weights as the JAX rule does:
    M <= 32 and n_embd <= 2048 decide, not the kind."""
    _, jl, pl = weights
    want = jdf.decode_fused_eligible(JCFG, jl, M, None, False, jnp.int32(0))
    assert decode_fused.decode_fused_eligible(CFG, pl, M) == want == (M <= 32)
    assert ffn_fused.ffn_fused_eligible(CFG, pl["w_gateup"], pl["w_down"], M) \
        == jffn.ffn_fused_eligible(JCFG, jl["w_gateup"], jl["w_down"], M)
