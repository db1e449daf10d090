"""K8 ``fused_attn_out`` as two launches (ops/kernels/attn_out_fused.py)
on the CPU: the attention on the split-key template of K4, then wo on the
fused walk of K6.

``k8_model`` runs the two kernels' arithmetic in plain PyTorch: the
attention's shares and merge as ``decode_split.decode_heads_model``
models them (each head's result rounded to bf16), then the walk's K
splits as tests/test_torch_fused_plan.py's ``split_model`` models them
for K1, K5, K6 and K7 (each slice's f32 product added in split order),
the residual added to that sum once and the result cast once. Here, on inputs made from a numpy seed at a narrow width (2
kv heads, d = 64, S = 512: 8 key tiles, one past a solo row), it is held
against the port's plain version ``fused_attn_out_ref`` for q8, q4 and q4g
wo, every KV kind (bf16, int8 with f32 scales, f16, f32), G = 4 and 8,
pos 0, 63, 64, 447, 448 and S - 1 (447 is the last solo row of 7 tiles,
448 the first split one), with the attention's and the walk's splits at
1, at 3 and at the plan's; and against the JAX package's
``fused_attn_out`` (Pallas in interpret mode, as the JAX tests run it) on
a dozen of those cases. Tolerance: bf16 queries and outputs, the JAX
suite's bf16 kernel tolerance rtol 2e-2 / atol 5e-3
(tests/test_tpu_kernels.py): the template rounds each share's
probabilities to bf16 against its own running max, and the walk sums in
another order. Over an int8 cache, against JAX alone, the bound adds
what tests/test_torch_staged_split.py adds for K9 and K11, carried
through wo: the model, as the plain version and the kernel, rounds each
value times its scale to bf16 and then p, where JAX's kernel rounds p
times the value scale, two other roundings of each term p v vs of at
most u = 2^-8 of it; so each attention output may move by 2 u sum_j p_j
|v_j vs_j| / l, and output n by the sum over k of that times |wo[k, n]|
(the module's deliberate difference from JAX, PERF.md §7).

The plan (the attention's split count and the walk's tile width and
splits) reads host sizes only: tensors raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.ops.pallas import attn_out_fused as jattn
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from tinyllama_tpu_torch.interop import cache_from_numpy, qtensor_from_numpy
from tinyllama_tpu_torch.ops.kernels import attn_out_fused as ao
from tinyllama_tpu_torch.ops.kernels import decode_split, flash_attention, fused_plan, qmatmul
from tinyllama_tpu_torch.quant.codec import QTensor, dequantize
from tinyllama_tpu_torch.runtime.kvcache import KVCache

from test_torch_fused_plan import split_model


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: with the test
    workers sharing the host's cores, eight threads a worker each spin for
    the cores and the ops run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


L, KH, S, D = 2, 2, 512, 64
LAYER = 1
POSITIONS = (0, 63, 64, 447, 448, S - 1)
TOL = dict(rtol=2e-2, atol=5e-3)
H100_SMS = 132
NP = {"f16": np.float16, "f32": np.float32}
U = 2.0 ** -8  # bf16's unit roundoff

jquantize = jax.jit(jcodec.quantize, static_argnums=(1, 2))


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _wo(kind, G):
    """The JAX package's layer-stacked kn wo (H * 64 -> H * 64) and the
    port's copy of it."""
    K = KH * G * D
    rng = np.random.default_rng(["q8", "q4", "q4g"].index(kind) * 10 + G)
    w = (rng.standard_normal((L, K, K)) * 0.05).astype(np.float32)
    jw = jquantize(jnp.asarray(w), kind, "kn")
    return jw, qtensor_from_numpy((np.asarray(jw.data), np.asarray(jw.scales),
                                   kind, "kn"))


@functools.lru_cache(maxsize=None)
def _cache(kv):
    """Both packages' [L, 1, KH, S, 64] cache of KV kind `kv`, random in
    every position (the kernels never read past pos)."""
    rng = np.random.default_rng(["bf16", "i8", "f16", "f32"].index(kv))
    shape = (L, 1, KH, S, D)
    scales = [None, None]
    if kv == "i8":
        planes = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [(rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
                  for _ in range(2)]
    elif kv == "bf16":
        planes = [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
                  for _ in range(2)]
    else:
        planes = [rng.standard_normal(shape).astype(NP[kv]) for _ in range(2)]
    jc = JaxKVCache(*(jnp.asarray(a) for a in planes),
                    *(None if s is None else jnp.asarray(s) for s in scales))
    return jc, cache_from_numpy(*planes, k_scale=scales[0], v_scale=scales[1])


def _rows(shape, seed):
    """The same bf16 activations for both packages."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def k8_model(q, cache, layer, pos, residual, wo, n_split, splits):
    """The two launches' arithmetic: the split attention with n_split
    shares, each head's result in q.dtype, then the wo walk in `splits`
    K splits with the residual in its f32 sum, cast to residual.dtype."""
    H, d = q.shape[2], q.shape[3]
    attn = decode_split.decode_heads_model(q, cache, layer, pos, n_split)
    out = split_model(attn.reshape(1, H * d), None, wo, layer, splits,
                      residual=residual.reshape(1, -1))
    return out.to(residual.dtype).reshape(residual.shape)


def _splits(split, G):
    """(attention splits, walk splits): a number for both, or the plan's
    on an H100 (its walk at two blocks an SM)."""
    if split == "plan":
        n_split, _, splits = ao.plan(KH, S, KH * G * D, KH * G * D, H100_SMS)
        return n_split, splits
    return split, split


@pytest.mark.parametrize("split", [1, 3, "plan"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_split_model_matches_plain(kind, kv, G, split):
    """The two launches' arithmetic against fused_attn_out_ref (what the
    wrapper runs for CPU tensors) at every position of POSITIONS."""
    H = KH * G
    _, wo = _wo(kind, G)
    _, cache = _cache(kv)
    n_split, splits = _splits(split, G)
    for pos in POSITIONS:
        _, q = _rows((1, 1, H, D), seed=pos)
        _, res = _rows((1, 1, H * D), seed=1000 + pos)
        p = _i32([pos])
        got = k8_model(q, cache, _i32([LAYER]), p, res, wo, n_split, splits)
        want = ao.fused_attn_out_ref(q, cache, _i32([LAYER]), p, res, wo)
        assert got.shape == res.shape and got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), **TOL,
                                   msg=f"pos {pos}")


#: (kind, KV kind, G, pos, split) held against the Pallas kernel
JAX_CASES = [
    ("q8", "bf16", 8, 0, "plan"), ("q8", "bf16", 4, 448, "plan"),
    ("q8", "bf16", 8, S - 1, 3), ("q8", "i8", 8, 64, "plan"),
    ("q8", "i8", 4, 447, 1), ("q8", "f16", 8, 63, 3),
    ("q8", "f32", 4, S - 1, "plan"), ("q4", "bf16", 8, 448, "plan"),
    ("q4", "f16", 4, 0, 1), ("q4", "i8", 8, S - 1, "plan"),
    ("q4g", "bf16", 4, 64, "plan"), ("q4g", "f32", 8, 447, 3),
]


def _jax_slack(cache, q, p, wo):
    """The bound's term over an int8 cache (module docstring): 2 u sum_j
    p_j |v_j vs_j| / l for each attention output (the plain version over
    |v|), carried through |wo|; 0 for the other kinds."""
    if not cache.quantized:
        return np.float32(0.0)
    mag = KVCache(cache.k, cache.v.abs(), cache.k_scale, cache.v_scale)
    layer = _i32([LAYER])
    e = 2 * U * flash_attention.attention_ref(q, mag, layer, p).float()
    wd = dequantize(QTensor(*qmatmul._layer_view(wo, layer), wo.kind, wo.layout),
                    torch.float32)
    return (e.reshape(1, -1) @ wd.abs()).numpy()


@pytest.mark.parametrize("kind,kv,G,pos,split", JAX_CASES)
def test_split_model_matches_pallas(kind, kv, G, pos, split):
    """The two launches' arithmetic against the JAX package's K8."""
    H = KH * G
    jwo, wo = _wo(kind, G)
    jc, cache = _cache(kv)
    jq, q = _rows((1, 1, H, D), seed=pos)
    jr, res = _rows((1, 1, H * D), seed=1000 + pos)
    want = jattn.fused_attn_out(jq, jc, jnp.int32(LAYER),
                                jnp.asarray([pos], jnp.int32), jr, jwo,
                                interpret=True)
    got = k8_model(q, cache, _i32([LAYER]), _i32([pos]), res, wo,
                   *_splits(split, G))
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy().reshape(1, -1), np.asarray(want, np.float32).reshape(1, -1)
    bad = np.abs(got - want) > (TOL["atol"] + TOL["rtol"] * np.abs(want)
                                + _jax_slack(cache, q, _i32([pos]), wo))
    assert not bad.any(), (np.argwhere(bad)[:4], got[bad][:4], want[bad][:4])


def test_plan_reads_host_sizes_only():
    """The attention's splits and the walk's plan come from sizes alone:
    at TinyLlama's widths on an H100 (4 kv heads, max_ctx 2048, wo 2048
    -> 2048) as the split count of K4 and the walk plan of K1 at M = 1
    give them, 128 columns x 8 splits, at any position; a tensor in any
    size raises."""
    n_split, width, splits = ao.plan(4, 2048, 2048, 2048, H100_SMS)
    assert n_split == decode_split.decode_splits(1, 4, 32, H100_SMS) == 16
    assert (width, splits) == (128, 8) == fused_plan.fused_plan(
        2048, 2048, H100_SMS, None, fused_plan.SMALLM_SPLIT_STEPS, H100_SMS // 32)
    # K past K6's 8,192 rows: the walk's x slices of K1's length
    assert ao.plan(4, 2048, 16384, 16384, H100_SMS)[2] <= fused_plan.MAX_SPLITS
    for bad in ((torch.tensor(4), 2048, 2048, 2048),
                (4, torch.tensor(2048), 2048, 2048),
                (4, 2048, torch.tensor(2048), 2048),
                (4, 2048, 2048, torch.tensor(2048))):
        with pytest.raises(TypeError):
            ao.plan(*bad, H100_SMS)
