"""The port's CUDA kernels against their plain versions, and what the
kernel wrappers and the builder refuse.

The tests marked ``cuda`` need a card and skip without one; they import
neither JAX nor the JAX package, so on a machine with a card they run
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

They cover shapes the main path of chip_smoke.py does not: M from 1 to 8
and ragged M / N for the matmuls, batch 2 with a different position per
row, prefill at pos > 0 with a partial last query tile, and 4 query
heads per kv head. Tolerance: the JAX suite's bf16 kernel tolerance,
rtol 2e-2 / atol 5e-3 (tests/test_tpu_kernels.py), against the plain
version on the same card and inputs.

The rest run anywhere: the wrappers' input checks (run before any
launch), and the builder's hashing and its refusal without nvcc.
"""

import numpy as np
import pytest
import torch

from tinyllama_tpu_torch.config import POLICIES, tiny_test_config
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.kernels import build, flash_attention, qmatmul
from tinyllama_tpu_torch.quant.codec import QTensor, quantize
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import KVCache

TOL = dict(rtol=2e-2, atol=5e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weight(L, K, N, seed, device="cpu") -> QTensor:
    g = torch.Generator().manual_seed(seed)
    qts = [quantize(torch.randn(N, K, generator=g) * 0.05, "q8", "kn")
           for _ in range(L)]
    return QTensor(torch.stack([q.data for q in qts]).to(device),
                   torch.stack([q.scales for q in qts]).to(device), "q8", "kn")


def _cache(B, Kh, S, fill, seed, device="cpu", L=2, d=64) -> KVCache:
    """Random bf16 history in positions [0, fill[b]) of every layer."""
    rng = np.random.default_rng(seed)
    k = np.zeros((L, B, Kh, S, d), np.float32)
    v = np.zeros((L, B, Kh, S, d), np.float32)
    for b in range(B):
        k[:, b, :, : fill[b]] = rng.standard_normal((L, Kh, fill[b], d))
        v[:, b, :, : fill[b]] = rng.standard_normal((L, Kh, fill[b], d))
    return KVCache(k=torch.from_numpy(k).to(device, torch.bfloat16),
                   v=torch.from_numpy(v).to(device, torch.bfloat16))


def _i32(values, device="cpu") -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


# --- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 40, 200])
def test_qmatmul_kernels_match_plain(card, M, out_dtype):
    """K1 (M <= 8) and K2 (M > 8), layer-stacked, N = 300 ragged against
    both kernels' column tiles."""
    K, N, li = 256, 300, 2
    w = _weight(3, K, N, seed=M, device=card)
    x = torch.randn(M, K, device=card).to(torch.bfloat16)
    layer = _i32([li], card)
    name = "qmm_smallm" if M <= qmatmul.SMALL_M else "qmm_bigm"
    before = qmatmul.launches[name]
    got = qmatmul.qmatmul(x, w, out_dtype, layer)
    assert qmatmul.launches[name] == before + 1
    want = qmatmul.qmatmul_ref(x, w, out_dtype, layer)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Kh", [(32, 4), (16, 4)])
@pytest.mark.parametrize("T,pos", [(12, [5, 70]), (1, [0, 127]), (1, [63, 64])])
def test_attention_kernels_match_plain(card, H, Kh, T, pos):
    """K3 (T > 1) at pos > 0 with a partial last query tile, K4 (T = 1)
    at fills on both sides of a key tile; two rows at different
    positions, G = 8 and G = 4 query heads per kv head."""
    B, S = len(pos), 256
    cache = _cache(B, Kh, S, [p + T for p in pos], seed=T, device=card)
    q = torch.randn(B, T, H, 64, device=card).to(torch.bfloat16)
    layer, p = _i32([1], card), _i32(pos, card)
    fn = (flash_attention.flash_decode_heads_attention if T == 1
          else flash_attention.flash_prefill_attention)
    got = fn(q, cache, layer, p)
    want = flash_attention.attention_ref(q, cache, layer, p)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_wrappers_refuse_f32_on_the_card(card):
    w = _weight(1, 64, 32, seed=0, device=card)
    with pytest.raises(TypeError, match="bf16"):
        qmatmul.qmatmul(torch.randn(1, 64, device=card), w, layer=_i32([0], card))


@pytest.mark.cuda
def test_engine_on_the_card_matches_cpu(card):
    """A small model (d_head 64, 4 query heads per kv head) through the
    kernels and through the plain path: last-token logits of a prefill
    and of two decode steps agree to 5% of their largest magnitude
    (bf16 rounds at other places in the two paths)."""
    cfg = tiny_test_config(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512)
    policy = POLICIES["q8"]
    params = llama.init_quantized_params(cfg, policy,
                                         torch.Generator().manual_seed(0))
    traces = []
    for device in (card, "cpu"):
        eng = Engine(cfg, policy, params, device=device)
        cache = eng.new_cache(1)
        logits, _ = eng.prefill(cache, [[1, 5, 9, 33, 70, 2, 8]])
        trace = [logits.float().cpu()]
        p = _i32([7], eng.device)
        for t in (11, 12):
            trace.append(eng.decode_step(cache, _i32([t], eng.device), p)
                         .float().cpu())
            p += 1
        traces.append(trace)
    for a, b in zip(*traces):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


# --- anywhere -------------------------------------------------------------------


def _bad_qmatmul_inputs():
    w = _weight(2, 64, 32, seed=1)
    x = torch.zeros(1, 64, dtype=torch.bfloat16)
    li = _i32([0])
    flat = QTensor(w.data[0], w.scales[0], "q8", "kn")
    return {
        "f32 activations": (x.float(), w, li, torch.float32, TypeError),
        "f16 output": (x, w, li, torch.float16, TypeError),
        "nk layout": (x, QTensor(w.data, w.scales, "q8", "nk"), li, None,
                      ValueError),
        "f32 scales": (x, QTensor(w.data, w.scales.float(), "q8", "kn"), li,
                       None, TypeError),
        "stacked without layer": (x, w, None, None, ValueError),
        "layer on an unstacked weight": (x, flat, li, None, ValueError),
        "K mismatch": (torch.zeros(1, 32, dtype=torch.bfloat16), w, li, None,
                       ValueError),
        "decode N % 4": (x, _weight(2, 64, 30, seed=2), li, None, ValueError),
        "prefill K % 64": (torch.zeros(9, 96, dtype=torch.bfloat16),
                           _weight(2, 96, 32, seed=3), li, None, ValueError),
        "CPU tensors": (x, w, li, None, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_qmatmul_inputs()))
def test_qmatmul_checks_refuse(case):
    """What the CUDA qmatmul does not take is refused before a launch."""
    x, w, li, out_dtype, exc = _bad_qmatmul_inputs()[case]
    with pytest.raises(exc):
        qmatmul._check(x, w, li, out_dtype or torch.bfloat16)


def _bad_attention_inputs():
    cache = _cache(1, 2, 64, [4], seed=0)
    q = torch.zeros(1, 3, 8, 64, dtype=torch.bfloat16)
    li, pos = _i32([0]), _i32([1])
    return {
        "f32 queries": (q.float(), cache, li, pos, TypeError),
        "head dim 32": (torch.zeros(1, 3, 8, 32, dtype=torch.bfloat16),
                        _cache(1, 2, 64, [4], seed=0, d=32), li, pos,
                        ValueError),
        "batch mismatch": (torch.zeros(2, 3, 8, 64, dtype=torch.bfloat16),
                           cache, li, _i32([1, 1]), ValueError),
        "heads not a multiple of kv heads": (
            torch.zeros(1, 3, 7, 64, dtype=torch.bfloat16), cache, li, pos,
            ValueError),
        "cache length % 64": (q, _cache(1, 2, 96, [4], seed=0), li, pos,
                              ValueError),
        "CPU tensors": (q, cache, li, pos, ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_attention_inputs()))
def test_attention_checks_refuse(case):
    q, cache, li, pos, exc = _bad_attention_inputs()[case]
    with pytest.raises(exc):
        flash_attention._check(q, cache, li, pos)


def test_decode_attention_refuses_several_tokens():
    cache = _cache(1, 2, 64, [4], seed=0)
    with pytest.raises(ValueError, match="T=1"):
        flash_attention.flash_decode_heads_attention(
            torch.zeros(1, 2, 8, 64), cache, _i32([0]), _i32([1]))


def test_library_path_follows_sources(tmp_path, monkeypatch):
    """An edited kernel or shared header gets a new library name, so it
    is rebuilt; an unchanged one keeps its name and is loaded as is."""
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "shared.cuh").write_text("// header\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.library_path("k")
    assert first.parent == tmp_path / "out" and build.library_path("k") == first
    (tmp_path / "shared.cuh").write_text("// header, edited\n")
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text("// kernel, edited\n")
    assert len({first, second, build.library_path("k")}) == 3


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("qmatmul")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        build.check(1, "qmm_smallm")
    build.check(0, "qmm_smallm")
