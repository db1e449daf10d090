"""The port's fused decode-layer kernels (K5-K8) against the JAX
package's Pallas kernels, and the gates of the fused branch.

JAX builds random q8 parameters on tiny_test_config (d_head 32, so one
32-block of wo spans one head row); they cross to the port through
interop.params_from_numpy. Activations are made from a seed with numpy
and go through the Pallas kernel in interpret mode and through the
port's plain version on the CPU (what its wrappers run for CPU tensors),
at layer 1 and at M in {1, 8, 17, 32}, which covers both of the TPU
kernels' dot bodies (blockdot at M <= 8, tile dequant above).

Tolerances: at f32 rtol/atol 1e-4 (1e-3 for K7, the JAX suite's own
figure in tests/test_decode_fused.py); only the summation order
differs. At bf16, where interpret mode runs it, the JAX suite's bf16
kernel tolerance rtol 2e-2 / atol 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import LLAMA_3_8B as JAX_LLAMA_3_8B
from tinyllama_tpu.config import TINYLLAMA_1_1B as JAX_TINYLLAMA
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.ops.pallas import attn_out_fused as jattn
from tinyllama_tpu.ops.pallas import decode_fused as jdf
from tinyllama_tpu.ops.pallas import ffn_fused as jffn
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.ops.kernels import (
    attn_out_fused,
    decode_fused,
    ffn_fused,
)
from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime.kvcache import KVCache

JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=5e-3)}
FFN_TOL = {"f32": dict(rtol=1e-3, atol=1e-3), "bf16": TOL["bf16"]}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
LAYER = 1
M_CASES = [1, 8, 17, 32]


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def weights():
    """JAX's layer weights and the port's copy; random positive norm
    weights so the norm's scale matters."""
    policy = JaxPolicy("q8", "f32", "f32")
    jp = jllama.init_quantized_params(JCFG, jax.random.PRNGKey(0), policy)
    rng = np.random.default_rng(9)
    norms = {n: np.abs(rng.standard_normal((CFG.n_layers, CFG.n_embd)))
             .astype(np.float32) + 0.5 for n in ("attn_norm", "ffn_norm")}
    jl = {**jp["layers"], **{n: jnp.asarray(w) for n, w in norms.items()}}
    pp = params_from_numpy(_to_numpy(jp), CFG,
                           pconfig.DtypePolicy("q8", "f32", "f32"))
    pl = {**pp["layers"], **{n: torch.from_numpy(w) for n, w in norms.items()}}
    return jl, pl


def _rows(adtype, shape, seed):
    """The same activations for both packages: JAX array, torch tensor."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    JNP[adtype])
    return a, torch.from_numpy(_np(a)).to(TORCH[adtype])


def _layer():
    return torch.tensor([LAYER], dtype=torch.int32)


def _check(got, want, tol, shape, dtype):
    assert tuple(got.shape) == shape and got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# --- K5, K6 ---------------------------------------------------------------------


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_fused_norm_qkv_matches_pallas(weights, adtype, M):
    jl, pl = weights
    jx, px = _rows(adtype, (M, 1, CFG.n_embd), seed=M)
    want = jdf.fused_norm_qkv(jx, jl["attn_norm"], jl["wqkv"], jnp.int32(LAYER),
                              CFG.norm_eps, CFG.norm_eps_inside_sqrt,
                              interpret=True)
    got = decode_fused.fused_norm_qkv(px, pl["attn_norm"], pl["wqkv"],
                                      _layer(), CFG.norm_eps,
                                      CFG.norm_eps_inside_sqrt)
    _check(got, want, TOL[adtype], (M, 1, pl["wqkv"].data.shape[-1]),
           TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_fused_out_residual_matches_pallas(weights, adtype, M):
    jl, pl = weights
    ja, pa = _rows(adtype, (1, M, CFG.n_embd), seed=10 + M)
    jr, pr = _rows(adtype, (1, M, CFG.n_embd), seed=20 + M)
    want = jdf.fused_out_residual(ja, jr, jl["wo"], jnp.int32(LAYER),
                                  interpret=True)
    got = decode_fused.fused_out_residual(pa, pr, pl["wo"], _layer())
    _check(got, want, TOL[adtype], (1, M, CFG.n_embd), TORCH[adtype])


# --- K7 -------------------------------------------------------------------------


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_ffn_fused_normed_matches_pallas(weights, adtype, M):
    jl, pl = weights
    jx, px = _rows(adtype, (M, 1, CFG.n_embd), seed=30 + M)
    want = jffn.ffn_fused_normed(jx, jl["ffn_norm"], jl["w_gateup"],
                                 jl["w_down"], jnp.int32(LAYER), JCFG,
                                 interpret=True)
    got = ffn_fused.ffn_fused_normed(px, pl["ffn_norm"], pl["w_gateup"],
                                     pl["w_down"], _layer(), CFG)
    _check(got, want, FFN_TOL[adtype], (M, 1, CFG.n_embd), TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", M_CASES)
def test_ffn_fused_matches_pallas(weights, adtype, M):
    """K7's plain entry: an already normed input, no residual."""
    jl, pl = weights
    jh, ph = _rows(adtype, (1, M, CFG.n_embd), seed=40 + M)
    want = jffn.ffn_fused(jh, jl["w_gateup"], jl["w_down"], jnp.int32(LAYER),
                          JCFG, interpret=True)
    got = ffn_fused.ffn_fused(ph, pl["w_gateup"], pl["w_down"], _layer(), CFG)
    _check(got, want, FFN_TOL[adtype], (1, M, CFG.n_embd), TORCH[adtype])


# --- K8 -------------------------------------------------------------------------


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 5, 100])
def test_fused_attn_out_matches_pallas(weights, adtype, pos):
    """Attention over keys 0..pos of layer 1 (history in both caches,
    zeros past pos), then wo and the residual, in one call."""
    jl, pl = weights
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


def test_fused_attn_out_refuses_a_batch():
    q = torch.zeros(2, 1, 4, 32)
    with pytest.raises(ValueError, match="batch-1"):
        attn_out_fused.fused_attn_out(q, None, _layer(), None, None, None)


# --- the gates ------------------------------------------------------------------


def _gate_weights(cfg):
    """Stand-in kn QTensors of the right shapes (the gates look at types,
    layouts and the config only)."""
    def qt(jax_side):
        if jax_side:
            return jcodec.QTensor(jnp.zeros((1, 32, 4), jnp.int8),
                                  jnp.zeros((1, 1, 4), jnp.float16), "q8", "kn")
        return QTensor(torch.zeros(1, 32, 4, dtype=torch.int8),
                       torch.zeros(1, 1, 4, dtype=torch.float16), "q8", "kn")

    names = ("wqkv", "wo", "w_gateup", "w_down")
    return ({n: qt(True) for n in names}, {n: qt(False) for n in names})


@pytest.mark.parametrize("name", ["tinyllama", "tiny", "llama-3-8b"])
@pytest.mark.parametrize("M", [1, 32, 33])
def test_gates_match_jax(name, M):
    """decode_fused_eligible and ffn_fused_eligible give the JAX
    package's answers (Llama-3-8B's n_embd 4096 is never fused)."""
    jcfg = {"tinyllama": JAX_TINYLLAMA, "tiny": JCFG,
            "llama-3-8b": JAX_LLAMA_3_8B}[name]
    pcfg = pconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jlp, plp = _gate_weights(jcfg)
    want = jdf.decode_fused_eligible(jcfg, jlp, M, None, False, jnp.int32(0))
    assert decode_fused.decode_fused_eligible(pcfg, plp, M) == want
    want_ffn = jffn.ffn_fused_eligible(jcfg, jlp["w_gateup"], jlp["w_down"], M)
    assert ffn_fused.ffn_fused_eligible(pcfg, plp["w_gateup"], plp["w_down"],
                                        M) == want_ffn
    assert want == (M <= 32 and jcfg.n_embd <= 2048)


@pytest.mark.parametrize("N", [128, 256, 384, 2048, 5632, 11264, 14336, 32003])
def test_pick_bn_matches_jax(N):
    from tinyllama_tpu.ops.pallas.qmatmul import _pick_bn

    assert ffn_fused.pick_bn(N) == _pick_bn(N)
