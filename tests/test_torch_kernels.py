"""The port's kernel modules against the JAX package's Pallas kernels.

Same inputs, made from a seed with numpy, go through the JAX kernel in
interpret mode and through the port's plain version on the CPU (what
the port's wrappers run for CPU tensors). The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.

Tolerances: at f32 activations rtol/atol 1e-5 (int8 x fp16 values and
bf16-rounded weights are exact in f32, so only the summation order
differs); at bf16 the JAX suite's own rtol 2e-2 / atol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import tiny_test_config
from tinyllama_tpu.ops.pallas.flash_prefill import (
    flash_decode_heads_attention as jax_decode_heads,
    flash_prefill_attention as jax_flash_prefill,
)
from tinyllama_tpu.ops.pallas.qmatmul import qmatmul as jax_qmatmul
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from tinyllama_tpu_torch.interop import qtensor_from_numpy
from tinyllama_tpu_torch.ops.kernels import flash_attention, qmatmul
from tinyllama_tpu_torch.runtime.kvcache import KVCache

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=5e-3)}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _stacked_q8(L, K, N, seed):
    """A layer-stacked kn q8 weight, quantized by the JAX codec: the JAX
    QTensor and the port's copy of the same bytes."""
    rng = np.random.default_rng(seed)
    qts = [jcodec.quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05,
                                       jnp.float32), "q8", layout="kn")
           for _ in range(L)]
    jw = jcodec.QTensor(jnp.stack([q.data for q in qts]),
                        jnp.stack([q.scales for q in qts]), "q8", "kn")
    pw = qtensor_from_numpy((np.asarray(jw.data), np.asarray(jw.scales),
                             "q8", "kn"))
    return jw, pw


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,bm", [(1, None), (8, None), (40, 16)])
def test_qmatmul_matches_pallas(adtype, M, bm):
    """K1 (M <= 8) and K2 (bm=16 tiles, M=40) layer-stacked, ragged N."""
    K, N, L, li = 256, 300, 3, 2
    jw, pw = _stacked_q8(L, K, N, seed=M)
    x = np.random.default_rng(7).standard_normal((M, K)).astype(np.float32)
    jx = jnp.asarray(x, JNP[adtype])
    want = jax_qmatmul(jx, jw, out_dtype=jnp.float32, layer=jnp.int32(li),
                       bm=bm, interpret=True)
    px = torch.from_numpy(_np(jx)).to(TORCH[adtype])
    got = qmatmul.qmatmul(px, pw, out_dtype=torch.float32,
                          layer=torch.tensor([li], dtype=torch.int32))
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL[adtype])


def test_qmatmul_unstacked_default_dtype():
    K, N = 128, 64
    jw, pw = _stacked_q8(1, K, N, seed=3)
    x = np.random.default_rng(1).standard_normal((2, 3, K)).astype(np.float32)
    pw2 = type(pw)(pw.data[0], pw.scales[0], "q8", "kn")
    jw2 = jcodec.QTensor(jw.data[0], jw.scales[0], "q8", "kn")
    want = jax_qmatmul(jnp.asarray(x), jw2, interpret=True)
    got = qmatmul.qmatmul(torch.from_numpy(x), pw2)
    assert got.shape == (2, 3, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL["f32"])


def _cache_pair(adtype, B, fill, seed, L=2, Kh=2, S=128, d=64):
    """Random K/V history in positions [0, fill[b]) of layer 1, zeros
    after it: the same values in a JAX and a port cache."""
    rng = np.random.default_rng(seed)
    k = np.zeros((L, B, Kh, S, d), np.float32)
    v = np.zeros((L, B, Kh, S, d), np.float32)
    for b in range(B):
        k[:, b, :, : fill[b]] = rng.standard_normal((L, Kh, fill[b], d))
        v[:, b, :, : fill[b]] = rng.standard_normal((L, Kh, fill[b], d))
    jk, jv = jnp.asarray(k, JNP[adtype]), jnp.asarray(v, JNP[adtype])
    jc = JaxKVCache(k=jk, v=jv, k_scale=None, v_scale=None)
    pc = KVCache(k=torch.from_numpy(_np(jk)).to(TORCH[adtype]),
                 v=torch.from_numpy(_np(jv)).to(TORCH[adtype]))
    return jc, pc


def _queries(adtype, shape, seed):
    q = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    JNP[adtype])
    return q, torch.from_numpy(_np(q)).to(TORCH[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
def test_flash_prefill_matches_pallas(adtype):
    """K3: T new tokens at pos > 0 over a partly filled cache."""
    cfg = tiny_test_config(n_heads=8, n_kv_heads=2, n_embd=512)
    B, T, pos = 2, 12, [5, 30]
    jc, pc = _cache_pair(adtype, B, [p + T for p in pos], seed=0)
    jq, pq = _queries(adtype, (B, T, cfg.n_heads, cfg.d_head), seed=1)
    want = jax_flash_prefill(jq, jc, jnp.int32(1), jnp.asarray(pos, jnp.int32),
                             interpret=True)
    got = flash_attention.flash_prefill_attention(
        pq, pc, torch.tensor([1], dtype=torch.int32),
        torch.tensor(pos, dtype=torch.int32))
    assert got.shape == pq.shape and got.dtype == pq.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[adtype])


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [[0, 3], [70, 127]])
def test_flash_decode_heads_matches_pallas(adtype, pos):
    """K4: one token at pos over a partly filled cache, fills crossing a
    key tile."""
    cfg = tiny_test_config(n_heads=8, n_kv_heads=2, n_embd=512)
    B = len(pos)
    jc, pc = _cache_pair(adtype, B, [p + 1 for p in pos], seed=2)
    jq, pq = _queries(adtype, (B, 1, cfg.n_heads, cfg.d_head), seed=3)
    want = jax_decode_heads(jq, jc, jnp.int32(1), jnp.asarray(pos, jnp.int32),
                            interpret=True)
    got = flash_attention.flash_decode_heads_attention(
        pq, pc, torch.tensor([1], dtype=torch.int32),
        torch.tensor(pos, dtype=torch.int32))
    assert got.shape == pq.shape and got.dtype == pq.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[adtype])


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On CPU tensors the wrappers never build or launch a kernel."""
    from tinyllama_tpu_torch.ops.kernels import build

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    from tinyllama_tpu_torch.ops.kernels import (
        attn_out_fused,
        decode_fused,
        ffn_fused,
    )

    monkeypatch.setattr(build, "load", no_build)
    mods = (qmatmul, flash_attention, decode_fused, ffn_fused, attn_out_fused)

    def counts():
        return {k: v for m in mods for k, v in m.launches.items()}

    before = counts()
    _, pw = _stacked_q8(2, 64, 32, seed=5)
    x = torch.randn(3, 64, dtype=torch.bfloat16)
    li = torch.tensor([1], dtype=torch.int32)
    torch.testing.assert_close(qmatmul.qmatmul(x, pw, layer=li),
                               qmatmul.qmatmul_ref(x, pw, layer=li))
    _, pc = _cache_pair("bf16", 1, [9], seed=4)
    q = torch.randn(1, 1, 4, 64, dtype=torch.bfloat16)
    pos = torch.tensor([8], dtype=torch.int32)
    torch.testing.assert_close(
        flash_attention.flash_decode_heads_attention(q, pc, li, pos),
        flash_attention.attention_ref(q, pc, li, pos))
    # the fused wrappers, on a 64-wide layer (wo 256 -> 64 for K8)
    norm = torch.rand(2, 64) + 0.5
    x3 = x.reshape(3, 1, 64)
    torch.testing.assert_close(
        decode_fused.fused_norm_qkv(x3, norm, pw, li, 1e-6, False),
        decode_fused.fused_norm_qkv_ref(x3, norm, pw, li, 1e-6, False))
    _, wgu = _stacked_q8(2, 64, 64, seed=6)
    _, wdn = _stacked_q8(2, 32, 64, seed=7)
    cfg = tiny_test_config(n_embd=64, n_ffn=32)
    torch.testing.assert_close(
        ffn_fused.ffn_fused_normed(x3, norm, wgu, wdn, li, cfg),
        ffn_fused.ffn_fused_ref(x3, norm, wgu, wdn, li, cfg, cfg.norm_eps,
                                cfg.norm_eps_inside_sqrt))
    _, wo = _stacked_q8(2, 256, 64, seed=8)
    res = torch.randn(1, 1, 64, dtype=torch.bfloat16)
    torch.testing.assert_close(
        attn_out_fused.fused_attn_out(q, pc, li, pos, res, wo),
        attn_out_fused.fused_attn_out_ref(q, pc, li, pos, res, wo))
    assert counts() == before


def test_kernel_sources_present():
    """Every kernel the wrappers load has its CUDA source in the package."""
    from tinyllama_tpu_torch.ops.kernels import build

    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\"" in src and "cudaGetLastError" in src
    assert (build.CSRC / "online_softmax.cuh").exists()
    assert jax.default_backend() == "cpu"
