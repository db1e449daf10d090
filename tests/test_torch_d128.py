"""Head dim 128 (Llama-3's) through the port on the CPU, against the JAX
package.

The attention kernels K3, K4, K9, K10 and K11 take d = 64 or 128 on the
card; on the CPU their wrappers run the plain versions, which are held
here, on inputs made from a numpy seed, against the JAX kernels at d =
128 (Pallas in interpret mode, as the JAX tests run them off a TPU):
``flash_prefill_attention`` (K3), ``flash_decode_heads_attention`` (K4),
``flash_staged_attention`` (K9), ``flash_paged_attention`` (K10) and
``flash_paged_staged_attention`` (K11), each at G = 4 over a bf16 cache
and at G = 8 over an int8 one (a JAX kernel's interpret-mode compile
costs 1-4 s a shape here, so the two cases cover both group sizes and
both kinds), S = 256 keys, one row at each of the positions 0, 63, 64
and S - 1 (tile edges), a page table out of order; the split-and-merge
models of decode_split.py (what the card's kernels compute) at 3 splits
against the same JAX outputs.

Tolerance: bf16 queries, the JAX suite's bf16 kernel tolerance, rtol 2e-2
/ atol 5e-3 (tests/test_tpu_kernels.py). Over an int8 cache the port
rounds v * vs to bf16 where JAX rounds p * vs, so its bound adds the
term the int8 tests state for that (tests/test_torch_staged_split.py): 2
u sum_j p_j |v_j vs_j| / l, u = 2^-8.

Then the whole model at d = 128: a Llama-3-shaped tiny config (n_embd
512, 4 heads of 128, one kv head: G = 4; rope theta 500,000, eps inside
the sqrt), 2 layers, JAX's q8 and q4 parameters carried across by
``interop.params_from_numpy``. The greedy f32 tokens equal JAX
``Engine(use_pallas=True)``'s for a 20-token prompt (fused prefill and
decode) and a 40-token one (the unfused prefill, K2 + K3), q8 and q4, and
in q8 for ``generate_batch`` of 4 prompts (staged chunks) and a paged
``generate``; q8a8 reaches the unfused b1 decode with K4 (JAX's fused gate
refuses aq8).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.ops.pallas import flash_paged as jfpaged
from tinyllama_tpu.ops.pallas import flash_prefill as jfprefill
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime import paged as jpaged
from tinyllama_tpu.runtime import staging as jstaging
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import (
    cache_from_numpy, params_from_numpy, tensor_from_numpy,
)
from tinyllama_tpu_torch.ops.kernels import decode_split as ds
from tinyllama_tpu_torch.ops.kernels import flash_attention as fa
from tinyllama_tpu_torch.ops.kernels import flash_paged as fp
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.staging import StagedKVCache

L, KH, D = 2, 2, 128
S, P, CS = 256, 64, 64  # 4 key tiles a row; pages of one tile; a 64-slot tail
#: one row at each: the first key, both sides of a tile edge, the last
POS = (0, 63, 64, S - 1)
B = len(POS)
#: K3: 65 new tokens a row from each start (crossing 63 | 64; the last
#: row's end is S - 1)
T3, POS3 = 65, (0, 63, S - 65)
#: K9 / K11: (base, tail fill) a row, every base and tail edge
STAGED = ((0, CS), (63, 1), (64, 33), (S - 64, CS))
U = 2.0 ** -8  # bf16's unit roundoff
KERNELS = ("K3", "K4", "K9", "K10", "K11")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Hundreds of tiny torch ops a case: one thread, as in the other
    model tests (tests/test_torch_staged_split.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else tensor_from_numpy(a)


def _planes(kv, shape, rng):
    """k, v and (int8) their f32 scales, the same for both packages."""
    if kv == "i8":
        out = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        return out + [(rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
                      for _ in range(2)]
    return [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
            for _ in range(2)] + [None, None]


@functools.lru_cache(maxsize=None)
def _case(kernel, G, kv):
    """JAX's output and the port's (plain version, split model at 3
    splits, and the plain version over |v| for the int8 bound) of one
    case."""
    rng = np.random.default_rng([KERNELS.index(kernel), G, kv == "i8"])
    paged = kernel in ("K10", "K11")
    rows = len(POS3) if kernel == "K3" else B
    if paged:
        J = S // P
        k, v, ks, vs = _planes(kv, (L, 1 + rows * J, KH, P, D), rng)
        table = (1 + rng.permutation(rows * J)).astype(np.int32).reshape(rows, J)
        jc = jpaged.PagedKVCache(k=_j(k), v=_j(v), k_scale=_j(ks),
                                 v_scale=_j(vs), table=jnp.asarray(table))
    else:
        k, v, ks, vs = _planes(kv, (L, rows, KH, S, D), rng)
        table = None
        jc = jkv.KVCache(k=_j(k), v=_j(v), k_scale=_j(ks), v_scale=_j(vs))
    pc = cache_from_numpy(k, v, table, k_scale=ks, v_scale=vs)
    T = T3 if kernel == "K3" else 1
    jq = jnp.asarray(rng.standard_normal((rows, T, KH * G, D)), jnp.bfloat16)
    pq = torch.from_numpy(np.array(_f32(jq))).to(torch.bfloat16)
    li = torch.tensor([1], dtype=torch.int32)
    if kernel in ("K9", "K11"):
        sk, sv, sks, svs = _planes(kv, (L, rows, KH, CS, D), rng)
        base = [b for b, _ in STAGED]
        pos = np.array([b + f - 1 for b, f in STAGED], np.int32)
        jst = jstaging.StagedKVCache(pool=jc, sk=_j(sk), sv=_j(sv),
                                     sk_scale=_j(sks), sv_scale=_j(svs),
                                     base=jnp.asarray(base, jnp.int32))
        pst = StagedKVCache(pc, _t(sk), _t(sv), torch.tensor(base, dtype=torch.int32),
                            sk_scale=_t(sks), sv_scale=_t(svs))
        jfn = (jfprefill.flash_staged_attention if kernel == "K9"
               else jfpaged.flash_paged_staged_attention)
        jout = jfn(jq, jst, jnp.int32(1), jnp.asarray(pos), interpret=True)
        p_pos = torch.from_numpy(pos)
        plain = fp.staged_attention_ref(pq, pst, li, p_pos)
        model = ds.staged_split_model(pq, pst, li, p_pos, 3)
        mag = dataclasses.replace(
            pst, pool=dataclasses.replace(pst.pool, v=pst.pool.v.abs()),
            sv=pst.sv.abs())
        absv = fp.staged_attention_ref(pq, mag, li, p_pos)
        return jout, plain, model, absv
    pos = np.array(POS3 if kernel == "K3" else POS, np.int32)
    p_pos = torch.from_numpy(pos)
    jfn = {"K3": jfprefill.flash_prefill_attention,
           "K4": jfprefill.flash_decode_heads_attention,
           "K10": jfpaged.flash_paged_attention}[kernel]
    ref = fp.paged_attention_ref if paged else fa.attention_ref
    jout = jfn(jq, jc, jnp.int32(1), jnp.asarray(pos), interpret=True)
    plain = ref(pq, pc, li, p_pos)
    model = None
    if kernel != "K3":
        model = (ds.paged_model if paged else ds.decode_heads_model)(
            pq, pc, li, p_pos, 3)
    absv = ref(pq, dataclasses.replace(pc, v=pc.v.abs()), li, p_pos)
    return jout, plain, model, absv


@pytest.mark.parametrize("G, kv", [(4, "bf16"), (8, "i8")])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_and_split_model_match_pallas_d128(kernel, G, kv):
    """The plain version (and for K4, K9-K11 the split model) against the
    JAX kernel at d = 128, one row at each tile edge."""
    jout, plain, model, absv = _case(kernel, G, kv)
    want = _f32(jout)
    slack = 2 * U * _f32(absv) if kv == "i8" else 0.0
    assert plain.shape == jout.shape and plain.shape[-1] == D
    for name, got in (("plain", plain), ("split model", model)):
        if got is None:
            continue
        bad = np.abs(_f32(got) - want) > 5e-3 + 2e-2 * np.abs(want) + slack
        assert not bad.any(), (kernel, G, kv, name, np.argwhere(bad)[:4])


# ---------------------------------------------------------------- the model

#: Llama-3's shape at a tiny size: d = 128, G = 4
JCFG = jax_tiny(n_embd=512, n_ffn=512, n_heads=4, n_kv_heads=1,
                rope_theta=500000.0, norm_eps=1e-5, norm_eps_inside_sqrt=True)
CFG = pconfig.tiny_test_config(n_embd=512, n_ffn=512, n_heads=4, n_kv_heads=1,
                               rope_theta=500000.0, norm_eps=1e-5,
                               norm_eps_inside_sqrt=True)


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _params(kind):
    """JAX's q8 or q4 parameters of CFG (quantized by its jitted codec
    from numpy N(0, 0.02) weights) and the port's copy."""
    quant = jax.jit(jcodec.quantize, static_argnums=(1, 2))
    rng = np.random.default_rng(128)

    def q(shape, layout):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return quant(jnp.asarray(w), kind, layout)

    nl, d, F, V = JCFG.n_layers, JCFG.n_embd, JCFG.n_ffn, JCFG.n_vocab
    ones = jnp.ones((nl, d), jnp.float32)
    jp = {"embed": q((V, d), "nk"), "lm_head": q((V, d), "kn"),
          "norm": jnp.ones((d,), jnp.float32),
          "layers": {"wqkv": q((nl, d + 2 * JCFG.kv_dim, d), "kn"),
                     "wo": q((nl, d, d), "kn"),
                     "w_gateup": q((nl, 2 * F, d), "kn"),
                     "w_down": q((nl, d, F), "kn"),
                     "attn_norm": ones, "ffn_norm": ones}}
    return jp, params_from_numpy(_to_numpy(jp), CFG,
                                 pconfig.DtypePolicy(kind, "f32", "f32"))


@functools.lru_cache(maxsize=None)
def _jax_engine(kind, paged=False, max_batch=1, aq8=False):
    """One JAX engine a policy and cache kind, shared by the tests that
    run it: its jitted steps compile once (5-7 s here in interpret mode)."""
    return JaxEngine(JCFG, JaxPolicy(kind, "f32", "f32", aq8=aq8), _params(kind)[0],
                     paged=paged, max_batch=max_batch, use_pallas=True)


def test_d128_config_shape():
    """The config is Llama-3's head shape: d = 128, four query heads a kv
    head, and two layers."""
    assert (CFG.d_head, CFG.q_heads_per_group, CFG.n_layers) == (128, 4, 2)
    assert (JCFG.n_embd // JCFG.n_heads, JCFG.n_layers) == (128, 2)


#: (weights, mode): q8 through every mode; q4, whose attention is q8's,
#: through the b1 engine's two (a JAX engine costs 5-7 s of compiles here)
GREEDY_CASES = [("q8", "b1"), ("q8", "b1_unfused_prefill"), ("q8", "batch"),
                ("q8", "paged"), ("q4", "b1"), ("q4", "b1_unfused_prefill")]


@pytest.mark.parametrize("kind, mode", GREEDY_CASES)
def test_greedy_d128_matches_jax_pallas(kind, mode):
    """Greedy f32 tokens at d = 128 equal JAX ``Engine(use_pallas=True)``'s:
    b1 ``generate`` of a 20-token prompt (fused prefill and decode) and of
    a 40-token one (the unfused prefill), ``generate_batch`` of 4 prompts
    (staged chunks), and a paged ``generate``."""
    pp = _params(kind)[1]
    ppol = pconfig.DtypePolicy(kind, "f32", "f32")
    rng = np.random.default_rng(len(mode) + 10 * len(kind))
    if mode == "batch":
        prompts = [[1] + rng.integers(2, CFG.n_vocab, n - 1).tolist()
                   for n in (5, 9, 12, 20)]
        gen = dict(n_predict=28, greedy=True, eos_token=-1, chunk_size=6)
        jout, _ = _jax_engine(kind, max_batch=4).generate_batch(
            prompts, JaxGen(**gen))
        pout, _ = Engine(CFG, ppol, pp, device="cpu").generate_batch(
            prompts, pconfig.GenerationConfig(**gen))
        assert [len(o) for o in pout] == [23, 19, 16, 8]
        assert pout == [[int(t) for t in o] for o in jout]
        return
    n = 40 if mode == "b1_unfused_prefill" else 20
    prompt = [1] + rng.integers(2, CFG.n_vocab, n - 1).tolist()
    paged = mode == "paged"
    gen = dict(n_predict=n + 12, greedy=True, eos_token=-1, chunk_size=6)
    jout, _ = _jax_engine(kind, paged=paged).generate(prompt, JaxGen(**gen))
    pout, _ = Engine(CFG, ppol, pp, device="cpu", paged=paged).generate(
        prompt, pconfig.GenerationConfig(**gen))
    assert len(pout) == 12 and pout == [int(t) for t in jout]


def test_greedy_d128_aq8_unfused_decode_matches_jax():
    """q8a8 at d = 128: every block unfused, the b1 decode through K4's
    plain version; greedy f32 tokens equal JAX ``Engine(use_pallas=True)``'s."""
    pp = _params("q8")[1]
    prompt = [1] + np.random.default_rng(7).integers(2, CFG.n_vocab, 19).tolist()
    gen = dict(n_predict=32, greedy=True, eos_token=-1, chunk_size=6)
    jout, _ = _jax_engine("q8", aq8=True).generate(prompt, JaxGen(**gen))
    pout, _ = Engine(CFG, pconfig.DtypePolicy("q8", "f32", "f32", aq8=True),
                     pp, device="cpu").generate(
        prompt, pconfig.GenerationConfig(**gen))
    assert len(pout) == 12 and pout == [int(t) for t in jout]
