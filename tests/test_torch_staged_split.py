"""The split-key staged attention of K9 and K11 (csrc/decode_split.cu) on
the CPU.

The kernel walks a staged decode chunk's row as one tile space: the
slab's (K9) or the pool's (K11) tiles below the chunk's base, then the
staged tail's tiles up to slot pos - base, split into n_split shares
whose partials are merged. Its plain model, ``staged_split_model``, runs
that arithmetic in PyTorch; here it is held, on inputs made from a numpy
seed, against the JAX package's ``flash_staged_attention`` and
``flash_paged_staged_attention`` (Pallas in interpret mode, as the JAX
tests run them) and against the port's plain version
(``staged_attention_ref``), for every KV kind (bf16, int8 with f32
scales, f16, f32), n_split in {1, 2, 3, 32}, tails of Cs = 32, 64 and 96
slots, chunk bases 0, 1, 63, 64, 65 and S - 64 and tail fills 1, 31, 32
and Cs ragged across 3 rows in four sets (every position below S; a row
at base S - 64 walks 8 tiles, one past SOLO_TILES, so it splits), and
for K11 a page table out of order. A row with no visible key (base 0,
pos -1) is 0, as JAX gives it.

Tolerances: at f32 queries 1e-5 of max |out| (the model sums in another
order than JAX and the plain version, and rescales each share by exp(m_i
- M)); at bf16 the JAX suite's bf16 kernel tolerance, rtol 2e-2 / atol
5e-3 (tests/test_tpu_kernels.py), since each share rounds its
probabilities to bf16 against its own running max. Over an int8 cache at
bf16 the model rounds each value times its scale to bf16 and then p, as
the plain version and the kernel do, where JAX's kernel rounds p times
the value scale: two other roundings of each term p v vs, each at most
bf16's unit roundoff u = 2^-8 of it. So against JAX there alone the
bound is rtol 2e-2 / atol 5e-3 plus 2 u sum_j p_j |v_j vs_j| / l (the
plain version over |v|): on few-key rows with large values those
roundings alone reach past the bf16 tolerance, between JAX and the plain
version themselves. The model, as the plain version, also rounds each key
times its scale to bf16, where JAX folds the key scale into the score in
f32: a score moves by at most u of scale * sum_i |q_i k_i ks|, which these
inputs keep well inside the bound (the worst excess over the bf16
tolerance measured is 0.13 u sum_j p_j |v_j vs_j| / l).

The launch path's split count and workspace follow host sizes only: the
same at every pos and base.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.ops.pallas import flash_paged as jfpaged
from tinyllama_tpu.ops.pallas import flash_prefill as jfprefill
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime import paged as jpaged
from tinyllama_tpu.runtime import staging as jstaging
from tinyllama_tpu_torch.interop import cache_from_numpy, tensor_from_numpy
from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.kernels import decode_split as ds
from tinyllama_tpu_torch.ops.kernels import flash_attention, flash_paged
from tinyllama_tpu_torch.runtime.staging import StagedKVCache

L, B, KH, G, D = 2, 3, 2, 4, 64
S, P = 512, 64  # 8 key tiles a row; K11 pages of one tile
CS = (32, 64, 96)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
NP = {"f16": np.float16, "f32": np.float32}
#: bf16's unit roundoff: |round(x) - x| <= U |x|
U = 2.0 ** -8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The model and the plain version run hundreds of tiny torch ops a
    case: on one thread, as they are fastest, and without the thread pool
    spinning against the other test workers of a loaded host (measured
    there: 235 s for a quarter of this file on every core, 39 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row_sets(Cs):
    """Four sets of (base, tail fill) over the B = 3 rows: every base and
    fill of the module's docstring twice over, no position at or past S
    (3 rows a call keep each Pallas kernel's interpret-mode compile
    short; its later calls reuse it)."""
    return (((0, Cs), (1, 1), (63, 31)), ((64, 32), (65, Cs), (S - 64, 1)),
            ((S - 64, 32), (65, 31), (0, 1)), ((1, Cs), (63, 32), (64, Cs)))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _planes(kv, shape, rng):
    """k, v and (int8) their f32 scales (0.005 to 0.025, a key each), the
    same for both packages."""
    if kv == "i8":
        out = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [(rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
                  for _ in range(2)]
        return out + scales
    x = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kv == "bf16":
        return [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in x] + [None] * 2
    return [a.astype(NP[kv]) for a in x] + [None] * 2


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else tensor_from_numpy(a)


@functools.lru_cache(maxsize=None)
def _inputs(kernel, kv, adtype, Cs):
    """JAX and port pools, staged tails of Cs slots and queries of one
    case (the bases come with each row set)."""
    rng = np.random.default_rng(["K9", "K11"].index(kernel) * 100
                                + ["bf16", "i8", "f16", "f32"].index(kv) * 10
                                + CS.index(Cs))
    if kernel == "K9":
        k, v, ks, vs = _planes(kv, (L, B, KH, S, D), rng)
        table = None
        jc = jkv.KVCache(k=_jax(k), v=_jax(v), k_scale=_jax(ks), v_scale=_jax(vs))
    else:
        J = S // P
        k, v, ks, vs = _planes(kv, (L, 1 + B * J, KH, P, D), rng)
        # a table out of order: logical page j of row b at a shuffled page
        table = (1 + rng.permutation(B * J)).astype(np.int32).reshape(B, J)
        jc = jpaged.PagedKVCache(k=_jax(k), v=_jax(v), k_scale=_jax(ks),
                                 v_scale=_jax(vs), table=jnp.asarray(table))
    pc = cache_from_numpy(k, v, table, k_scale=ks, v_scale=vs)
    tail = _planes(kv, (L, B, KH, Cs, D), rng)
    jq = jnp.asarray(rng.standard_normal((B, 1, KH * G, D)), JNP[adtype])
    pq = torch.from_numpy(np.array(_f32(jq))).to(TORCH[adtype])
    return jc, pc, tail, jq, pq


def _staged(kernel, kv, adtype, Cs, base):
    """Both packages' staged chunk at chunk bases `base`."""
    jc, pc, (sk, sv, sks, svs), _, _ = _inputs(kernel, kv, adtype, Cs)
    jst = jstaging.StagedKVCache(pool=jc, sk=_jax(sk), sv=_jax(sv),
                                 sk_scale=_jax(sks), sv_scale=_jax(svs),
                                 base=jnp.asarray(base, jnp.int32))
    pst = StagedKVCache(pc, _torch(sk), _torch(sv),
                        torch.tensor(base, dtype=torch.int32),
                        sk_scale=_torch(sks), sv_scale=_torch(svs))
    return jst, pst


@functools.lru_cache(maxsize=None)
def _jax_out(kernel, kv, adtype, Cs, base, pos):
    jst, _ = _staged(kernel, kv, adtype, Cs, base)
    jq = _inputs(kernel, kv, adtype, Cs)[3]
    fn = (jfprefill.flash_staged_attention if kernel == "K9"
          else jfpaged.flash_paged_staged_attention)
    return _f32(fn(jq, jst, jnp.int32(1), jnp.asarray(pos, jnp.int32),
                   interpret=True))


def _close(got, want, adtype, what, slack=0.0):
    """At f32, within 1e-5 of max |want|; at bf16, within rtol 2e-2 / atol
    5e-3 plus `slack` (each output's, or one for all)."""
    got, want = _f32(got), _f32(want)
    if adtype == "f32":
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (what, err)
    else:
        bad = np.abs(got - want) > 5e-3 + 2e-2 * np.abs(want) + _f32(slack)
        assert not bad.any(), (what, np.argwhere(bad)[:4], got[bad][:4],
                               want[bad][:4])


def _jax_slack(kv, adtype, pq, pst, layer, p):
    """The bound's term for another rounding of each term than JAX's
    (module docstring): 2 u sum_j p_j |v_j vs_j| / l over an int8 cache at
    bf16, else 0."""
    if kv != "i8" or adtype != "bf16":
        return 0.0
    mag = dataclasses.replace(
        pst, pool=dataclasses.replace(pst.pool, v=pst.pool.v.abs()),
        sv=pst.sv.abs())
    return 2 * U * _f32(flash_paged.staged_attention_ref(pq, mag, layer, p))


@pytest.mark.parametrize("n_split", [1, 2, 3, 32])
@pytest.mark.parametrize("Cs", CS)
@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("kernel", ["K9", "K11"])
def test_staged_split_model_matches_pallas_and_plain(kernel, kv, adtype, Cs,
                                                     n_split):
    """The model of n_split shares over pool and tail tiles, and their
    merge, against the JAX kernel and the port's plain version, every row
    set."""
    pq = _inputs(kernel, kv, adtype, Cs)[4]
    layer = torch.tensor([1], dtype=torch.int32)
    for rows in row_sets(Cs):
        base = tuple(b for b, _ in rows)
        pos = tuple(b + f - 1 for b, f in rows)
        _, pst = _staged(kernel, kv, adtype, Cs, base)
        p = torch.tensor(pos, dtype=torch.int32)
        got = ds.staged_split_model(pq, pst, layer, p, n_split)
        assert got.shape == pq.shape and got.dtype == pq.dtype
        _close(got, _jax_out(kernel, kv, adtype, Cs, base, pos), adtype,
               f"JAX {rows}", _jax_slack(kv, adtype, pq, pst, layer, p))
        _close(got, flash_paged.staged_attention_ref(pq, pst, layer, p), adtype,
               f"plain {rows}")


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("kernel", ["K9", "K11"])
def test_staged_split_model_empty_row_is_zero(kernel, kv, n_split):
    """A row with no visible key (base 0, pos -1: no pool key, no tail
    slot) beside ragged rows: the model equals JAX, and the row is 0."""
    Cs = 32
    pq = _inputs(kernel, kv, "bf16", Cs)[4]
    base = (65, 0, S - 64)
    pos = (65, -1, S - 33)
    _, pst = _staged(kernel, kv, "bf16", Cs, base)
    layer = torch.tensor([1], dtype=torch.int32)
    p = torch.tensor(pos, dtype=torch.int32)
    got = ds.staged_split_model(pq, pst, layer, p, n_split)
    want = _jax_out(kernel, kv, "bf16", Cs, base, pos)
    assert not np.any(want[1]) and not torch.any(got[1])
    _close(got, want, "bf16", f"JAX {kernel} {kv}",
           _jax_slack(kv, "bf16", pq, pst, layer, p))


def test_staged_tile_space_counts_pool_then_tail():
    """cap_tiles of the staged launches: the slab's or pool's tiles plus
    ceil(Cs / 64), so Cs = 32 and 64 add one tile and 96 adds two."""
    assert [ds.tail_tiles(c) for c in (32, 64, 96, 128)] == [1, 1, 2, 2]


@pytest.mark.parametrize("kernel", ["K9", "K11"])
def test_launch_path_ignores_pos_and_base(kernel, monkeypatch):
    """The K9 and K11 wrappers hand the kernel the same n_split and a
    workspace of the same shape whatever pos and base hold (a fake
    library records the call and the wrapper's input checks pass as on a
    card; no card is needed)."""
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
    monkeypatch.setattr(flash_paged, "check_serving_inputs", lambda *a: 0)
    monkeypatch.setattr(flash_paged, "_check_paged", lambda *a: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    shapes = []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        shapes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    Cs = 96
    pq = _inputs(kernel, "bf16", "bf16", Cs)[4]
    layer = torch.tensor([1], dtype=torch.int32)
    fn = (flash_attention.flash_staged_attention if kernel == "K9"
          else flash_paged.flash_paged_staged_attention)
    for base, fill in ((0, 1), (63, 31), (64, 96), (S - 64, 32)):
        _, pst = _staged(kernel, "bf16", "bf16", Cs, (base,) * B)
        fn(pq, pst, layer, torch.full((B,), base + fill - 1, dtype=torch.int32))
    want = ds.decode_splits(B, KH, S // 64 + 2, 132)
    name = "flash_staged" if kernel == "K9" else "flash_paged_staged"
    assert seen == [(name, want)] * 4
    assert set(shapes) == {(B, KH * G, want, ds.partial_floats(D))}
