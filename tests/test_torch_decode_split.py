"""The split-key decode attention of K4 and K10 (ops/kernels/decode_split.py)
on the CPU.

The kernel splits each row's key walk into n_split shares, runs the
online softmax over each share from its own running max, and merges the
partials. Its plain model, ``split_decode_model``, runs that arithmetic
in PyTorch; here it is held, on inputs made from a numpy seed, against
the JAX package's ``flash_decode_heads_attention`` and
``flash_paged_attention`` (Pallas in interpret mode, as the JAX tests run
them) and against the port's plain versions (``attention_ref``,
``paged_attention_ref``), for every KV kind (bf16, int8 with f32 scales,
f16, f32), n_split in {1, 2, 3, 32} (32 leaves shares of the 8-tile row
at S - 1 empty; a row of at most SOLO_TILES = 7 tiles is one share, as
in the kernel), positions 0, 63, 64, 65 and S - 1 ragged across 3 rows,
and for K10 a page table out of order.

Tolerances: at f32 queries 1e-5 of max |out| (the model sums in another
order than JAX and the plain version, and rescales each share by exp(m_i
- M)); at bf16 the JAX suite's bf16 kernel tolerance, rtol 2e-2 / atol
5e-3 (tests/test_tpu_kernels.py), since each share rounds its
probabilities to bf16 against its own running max.

The split count reads host sizes only: ``decode_splits`` takes ints and
refuses tensors, and the launch path gives the same count and workspace
at every position.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.ops.pallas import flash_paged as jfpaged
from tinyllama_tpu.ops.pallas import flash_prefill as jfprefill
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime import paged as jpaged
from tinyllama_tpu_torch.interop import cache_from_numpy
from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.kernels import decode_split as ds
from tinyllama_tpu_torch.ops.kernels import flash_attention, flash_paged


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: with the test
    workers sharing the host's cores, eight threads a worker each spin for
    the cores and the ops run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


L, B, KH, G, D = 2, 3, 2, 4, 64
S, P = 512, 64  # 8 key tiles a row (one past SOLO_TILES); K10 pages of one tile
#: each case runs both position sets: 0, 63, 64, 65 and S - 1 over 3 rows
POS_SETS = ((0, 64, S - 1), (63, 65, 0))
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
NP = {"f16": np.float16, "f32": np.float32}


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _planes(kv, shape, rng):
    """k, v and (int8) their f32 scales, the same for both packages."""
    if kv == "i8":
        out = []
        for _ in range(2):
            out.append(rng.integers(-127, 128, shape).astype(np.int8))
        scales = [(rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
                  for _ in range(2)]
        return out + scales
    x = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kv == "bf16":
        return [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in x] + [None] * 2
    return [a.astype(NP[kv]) for a in x] + [None] * 2


@functools.lru_cache(maxsize=None)
def _inputs(kernel, kv, adtype):
    """JAX and port caches and queries of one case."""
    rng = np.random.default_rng(["K4", "K10"].index(kernel) * 10
                                + ["bf16", "i8", "f16", "f32"].index(kv))
    if kernel == "K4":
        k, v, ks, vs = _planes(kv, (L, B, KH, S, D), rng)
        table = None
        jc = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         k_scale=None if ks is None else jnp.asarray(ks),
                         v_scale=None if vs is None else jnp.asarray(vs))
    else:
        J = S // P
        k, v, ks, vs = _planes(kv, (L, 1 + B * J, KH, P, D), rng)
        # a table out of order: logical page j of row b at a shuffled page
        table = (1 + rng.permutation(B * J)).astype(np.int32).reshape(B, J)
        jc = jpaged.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                 k_scale=None if ks is None else jnp.asarray(ks),
                                 v_scale=None if vs is None else jnp.asarray(vs),
                                 table=jnp.asarray(table))
    pc = cache_from_numpy(k, v, table, k_scale=ks, v_scale=vs)
    jq = jnp.asarray(rng.standard_normal((B, 1, KH * G, D)), JNP[adtype])
    pq = torch.from_numpy(np.array(_f32(jq))).to(TORCH[adtype])
    return jc, pc, jq, pq


@functools.lru_cache(maxsize=None)
def _jax_out(kernel, kv, adtype, pos):
    jc, _, jq, _ = _inputs(kernel, kv, adtype)
    fn = (jfprefill.flash_decode_heads_attention if kernel == "K4"
          else jfpaged.flash_paged_attention)
    return _f32(fn(jq, jc, jnp.int32(1), jnp.asarray(pos, jnp.int32),
                   interpret=True))


def _close(got, want, adtype, what):
    got, want = _f32(got), _f32(want)
    if adtype == "f32":
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3, err_msg=what)


@pytest.mark.parametrize("n_split", [1, 2, 3, 32])
@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("kernel", ["K4", "K10"])
def test_split_model_matches_pallas_and_plain(kernel, kv, adtype, n_split):
    """The model of n_split shares and their merge against the JAX kernel
    and the port's plain version, both position sets."""
    _, pc, _, pq = _inputs(kernel, kv, adtype)
    layer = torch.tensor([1], dtype=torch.int32)
    model, plain = ((ds.decode_heads_model, flash_attention.attention_ref)
                    if kernel == "K4"
                    else (ds.paged_model, flash_paged.paged_attention_ref))
    for pos in POS_SETS:
        p = torch.tensor(pos, dtype=torch.int32)
        got = model(pq, pc, layer, p, n_split)
        assert got.shape == pq.shape and got.dtype == pq.dtype
        _close(got, _jax_out(kernel, kv, adtype, pos), adtype, f"JAX {pos}")
        _close(got, plain(pq, pc, layer, p), adtype, f"plain {pos}")


def test_decode_splits_stays_in_range():
    """About BLOCKS_PER_SM (1) blocks an SM, between 1 and the row's tiles
    over MIN_SHARE (2; at most 32), for any batch, kv heads, capacity and
    SM count."""
    assert list(inspect.signature(ds.decode_splits).parameters) == [
        "B", "Kh", "cap_tiles", "n_sm"]
    assert ds.BLOCKS_PER_SM == 1 and ds.MIN_SHARE == 2
    assert ds.decode_splits(1, 4, 32, 132) == 16  # TinyLlama b1, max_ctx 2048
    assert ds.decode_splits(4, 4, 32, 132) == 9
    assert ds.decode_splits(8, 4, 33, 132) == 5  # K9 at (g)'s batch
    assert ds.decode_splits(32, 4, 33, 132) == 2  # K11 at (f)'s batch
    assert ds.decode_splits(1, 1, 512, 132) == ds.MAX_SPLITS
    for b in (1, 2, 3, 4, 8, 32, 64):
        for kh in (1, 2, 4, 8):
            for cap in (1, 2, 3, 4, 32, 64, 512):
                for n_sm in (1, 8, 132):
                    n = ds.decode_splits(b, kh, cap, n_sm)
                    most = min(-(-cap // ds.MIN_SHARE), ds.MAX_SPLITS)
                    assert 1 <= n <= most
                    assert n == most or n * b * kh >= ds.BLOCKS_PER_SM * n_sm


@pytest.mark.parametrize("bad", [torch.tensor(4), 4.0, 0, True])
def test_decode_splits_takes_host_ints_only(bad):
    """A tensor (a value that could be pos), a float, zero or a bool is
    refused."""
    with pytest.raises(TypeError):
        ds.decode_splits(1, bad, 32, 132)


@pytest.mark.parametrize("kernel", ["K4", "K10"])
def test_launch_path_ignores_pos(kernel, monkeypatch):
    """The wrappers' launch path hands the kernel the same n_split and a
    workspace of the same shape whatever pos holds (a fake library
    records the call; no card is needed)."""
    seen = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                seen.append((name, args[-2]))
                return 0
            return call

    monkeypatch.setattr(ds, "_lib", Lib)
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    shapes = []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        shapes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    _, pc, _, pq = _inputs(kernel, "bf16", "bf16")
    layer = torch.tensor([1], dtype=torch.int32)
    for p in (0, 63, 64, S - 1):
        pos = torch.full((B,), p, dtype=torch.int32)
        if kernel == "K4":
            ds.launch("flash_decode_heads", pq, pc.k, pc.v, (None, None),
                      (layer, pos), 0, (B, KH * G, KH, S, D), S // 64)
        else:
            ds.launch("flash_paged", pq, pc.k, pc.v, (None, None),
                      (layer, pos, pc.table), 0,
                      (B, KH * G, KH, pc.k.shape[1], P, S // P, D), S // P)
    want = ds.decode_splits(B, KH, S // 64, 132)
    assert [n for _, n in seen] == [want] * 4
    assert set(shapes) == {(B, KH * G, want, ds.partial_floats(D))}


def test_attn_ab_needs_a_card(capsys):
    """The A/B timing tool refuses to run without a CUDA device."""
    from tinyllama_tpu_torch.tools import attn_ab

    assert not torch.cuda.is_available()
    assert attn_ab.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
