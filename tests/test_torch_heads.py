"""The JAX package's own tiny head shapes through the port on the CPU:
head dim 32 and 1 to 8 query heads a kv head, and d = 128 on K8.

The attention kernels K3, K4 and K8-K11 take d = 32, 64 or 128 on the
card, and the split-key ones (K4, K8-K11) 1 to 8 query heads a kv head
(``flash_paged.check_heads``). On the CPU their wrappers run the plain
versions, which are held here, on inputs made from a numpy seed, against
the JAX kernels (Pallas in interpret mode, as the JAX tests run them off
a TPU): K3, K4, K9, K10, K11 and K8 at d = 32 with G = 1 and 2, over a
bf16 and an int8 cache, one row at each tile edge (positions 0, 63, 64,
S - 1), and K8 at d = 128 with G = 4; the split-and-merge models of
decode_split.py (what the card's split kernels compute) at 3 splits
against the same JAX outputs.

Tolerance: bf16 queries, the JAX suite's bf16 kernel tolerance, rtol 2e-2
/ atol 5e-3 (tests/test_tpu_kernels.py). Over an int8 cache the port
rounds v * vs to bf16 where JAX rounds p * vs, so its bound adds the
term the int8 tests state for that (tests/test_torch_staged_split.py): 2
u sum_j p_j |v_j vs_j| / l, u = 2^-8.

Then whole models: ``Engine.generate`` on the CPU at
``tiny_test_config(n_kv_heads=4)`` (d 32, G 1) and at a d = 128 config
small enough for the fused branch (n_embd 512, 4 heads, 1 kv head: G 4,
K8 at d = 128), q8 weights carried across by ``interop.params_from_numpy``:
greedy f32 tokens equal to JAX ``Engine(use_pallas=True)``'s. The port's
multi-device dryrun runs JAX's own configurations, field by field those
that ``__graft_entry__.py`` builds, on every device; an id past the
embedding table (tiny-test's 512 rows under a real tokenizer) takes its
last row, as JAX's gather clamps it.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.ops.linear import embedding_lookup as jax_embedding
from tinyllama_tpu.ops.pallas import attn_out_fused as jattn
from tinyllama_tpu.ops.pallas import flash_paged as jfpaged
from tinyllama_tpu.ops.pallas import flash_prefill as jfprefill
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu.runtime import kvcache as jkv
from tinyllama_tpu.runtime import paged as jpaged
from tinyllama_tpu.runtime import staging as jstaging
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import (
    cache_from_numpy, params_from_numpy, qtensor_from_numpy, tensor_from_numpy,
)
from tinyllama_tpu_torch.ops.linear import embedding_lookup
from tinyllama_tpu_torch.ops.kernels import attn_out_fused as ao
from tinyllama_tpu_torch.ops.kernels import decode_split as ds
from tinyllama_tpu_torch.ops.kernels import flash_attention as fa
from tinyllama_tpu_torch.ops.kernels import flash_paged as fp
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.staging import StagedKVCache
from tinyllama_tpu_torch.tools import dryrun_multichip

L, KH = 2, 2
S, P, CS = 256, 64, 64  # 4 key tiles a row; pages of one tile; a 64-slot tail
#: one row at each: the first key, both sides of a tile edge, the last
POS = (0, 63, 64, S - 1)
#: K3: 65 new tokens a row from each start (crossing 63 | 64; the last
#: row's end is S - 1)
T3, POS3 = 65, (0, 63, S - 65)
#: K9 / K11: (base, tail fill) a row, every base and tail edge
STAGED = ((0, CS), (63, 1), (64, 33), (S - 64, CS))
#: K8 (batch 1): positions at a tile edge and the last key
POS8 = (64, S - 1)
U = 2.0 ** -8  # bf16's unit roundoff
KERNELS = ("K3", "K4", "K9", "K10", "K11", "K8")
#: (kernel, d, G, kv): every kernel at d = 32 with G 1 and 2 over both
#: caches; K8 also at d = 128 with G 4
CASES = ([(k, 32, G, kv) for k in KERNELS for G in (1, 2)
          for kv in ("bf16", "i8")]
         + [("K8", 128, 4, kv) for kv in ("bf16", "i8")])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Hundreds of tiny torch ops a case: one thread, as in the other
    model tests (tests/test_torch_graphs.py)."""
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


def _bf16(rng, shape):
    """Random values rounded to bf16, the same for both packages (a JAX
    array, a torch tensor)."""
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _planes(kv, shape, rng):
    """k, v and (int8) their f32 scales, the same for both packages."""
    if kv == "i8":
        out = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        return out + [(rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
                      for _ in range(2)]
    return [np.asarray(_bf16(rng, shape)[0]) for _ in range(2)] + [None, None]


def _k8_case(d, G, kv, rng):
    """K8 at batch 1, one call a position of POS8: JAX's output, the plain
    version's, and the plain version over |v| and |wo| (the int8 bound's
    term, carried through wo)."""
    k, v, ks, vs = _planes(kv, (L, 1, KH, S, d), rng)
    jc = jkv.KVCache(k=_j(k), v=_j(v), k_scale=_j(ks), v_scale=_j(vs))
    pc = cache_from_numpy(k, v, k_scale=ks, v_scale=vs)
    H = KH * G
    D = H * d
    w = (rng.standard_normal((L, D, D)) * 0.05).astype(np.float32)
    jwo = jax.jit(jcodec.quantize, static_argnums=(1, 2))(jnp.asarray(w), "q8", "kn")
    pwo = qtensor_from_numpy((np.asarray(jwo.data), np.asarray(jwo.scales), "q8", "kn"))
    mag_wo = dataclasses.replace(pwo, data=pwo.data.abs())
    mag_c = dataclasses.replace(pc, v=pc.v.abs())
    li = torch.tensor([1], dtype=torch.int32)
    outs = []
    for pos in POS8:
        jq, pq = _bf16(rng, (1, 1, H, d))
        jr, pr = _bf16(rng, (1, 1, D))
        p_pos = torch.tensor([pos], dtype=torch.int32)
        jout = jattn.fused_attn_out(jq, jc, jnp.int32(1),
                                    jnp.asarray([pos], jnp.int32), jr, jwo,
                                    interpret=True)
        plain = ao.fused_attn_out(pq, pc, li, p_pos, pr, pwo)
        absv = ao.fused_attn_out_ref(pq, mag_c, li, p_pos, torch.zeros_like(pr),
                                     mag_wo)
        outs.append((jout, plain, None, absv))
    return outs


@functools.lru_cache(maxsize=None)
def _case(kernel, d, G, kv):
    """JAX's output and the port's (plain version, split model at 3
    splits, and the plain version over |v| for the int8 bound) of one
    case, as a list of such tuples (K8: one a position)."""
    rng = np.random.default_rng([KERNELS.index(kernel), d, G, kv == "i8"])
    if kernel == "K8":
        return _k8_case(d, G, kv, rng)
    paged = kernel in ("K10", "K11")
    rows = len(POS3) if kernel == "K3" else len(POS)
    if paged:
        J = S // P
        k, v, ks, vs = _planes(kv, (L, 1 + rows * J, KH, P, d), rng)
        table = (1 + rng.permutation(rows * J)).astype(np.int32).reshape(rows, J)
        jc = jpaged.PagedKVCache(k=_j(k), v=_j(v), k_scale=_j(ks),
                                 v_scale=_j(vs), table=jnp.asarray(table))
    else:
        k, v, ks, vs = _planes(kv, (L, rows, KH, S, d), rng)
        table = None
        jc = jkv.KVCache(k=_j(k), v=_j(v), k_scale=_j(ks), v_scale=_j(vs))
    pc = cache_from_numpy(k, v, table, k_scale=ks, v_scale=vs)
    T = T3 if kernel == "K3" else 1
    jq, pq = _bf16(rng, (rows, T, KH * G, d))
    li = torch.tensor([1], dtype=torch.int32)
    if kernel in ("K9", "K11"):
        sk, sv, sks, svs = _planes(kv, (L, rows, KH, CS, d), rng)
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
        wrapper = (fa.flash_staged_attention if kernel == "K9"
                   else fp.flash_paged_staged_attention)
        plain = wrapper(pq, pst, li, p_pos)
        model = ds.staged_split_model(pq, pst, li, p_pos, 3)
        mag = dataclasses.replace(
            pst, pool=dataclasses.replace(pst.pool, v=pst.pool.v.abs()),
            sv=pst.sv.abs())
        absv = fp.staged_attention_ref(pq, mag, li, p_pos)
        return [(jout, plain, model, absv)]
    pos = np.array(POS3 if kernel == "K3" else POS, np.int32)
    p_pos = torch.from_numpy(pos)
    jfn, wrapper = {
        "K3": (jfprefill.flash_prefill_attention, fa.flash_prefill_attention),
        "K4": (jfprefill.flash_decode_heads_attention,
               fa.flash_decode_heads_attention),
        "K10": (jfpaged.flash_paged_attention, fp.flash_paged_attention)}[kernel]
    ref = fp.paged_attention_ref if paged else fa.attention_ref
    jout = jfn(jq, jc, jnp.int32(1), jnp.asarray(pos), interpret=True)
    plain = wrapper(pq, pc, li, p_pos)
    model = None
    if kernel != "K3":
        model = (ds.paged_model if paged else ds.decode_heads_model)(
            pq, pc, li, p_pos, 3)
    absv = ref(pq, dataclasses.replace(pc, v=pc.v.abs()), li, p_pos)
    return [(jout, plain, model, absv)]


@pytest.mark.parametrize("kernel, d, G, kv", CASES)
def test_plain_and_split_model_match_pallas_small_heads(kernel, d, G, kv):
    """The plain version (and for K4, K9-K11 the split model) against the
    JAX kernel at the tiny configurations' head shapes, one row (K8: one
    call) at each tile edge."""
    for jout, plain, model, absv in _case(kernel, d, G, kv):
        want = _f32(jout)
        slack = 2 * U * _f32(absv) if kv == "i8" else 0.0
        assert plain.shape == jout.shape
        for name, got in (("plain", plain), ("split model", model)):
            if got is None:
                continue
            bad = np.abs(_f32(got) - want) > 5e-3 + 2e-2 * np.abs(want) + slack
            assert not bad.any(), (kernel, d, G, kv, name, np.argwhere(bad)[:4])


# ------------------------------------------------------------ the host check

SPLIT_KERNELS = ("flash_decode_heads", "fused_attn_out", "flash_staged",
                 "flash_paged", "flash_paged_staged")


@pytest.mark.parametrize("kernel", SPLIT_KERNELS + ("flash_prefill",))
def test_check_heads_takes_the_tiny_shapes(kernel):
    """Every attention kernel takes d 32, 64 and 128 at 1 to 8 query heads
    a kv head (K3 at any G), from host ints alone."""
    for d in (32, 64, 128):
        for G in range(1, 9):
            fp.check_heads(kernel, d, G)
    assert fp.HEAD_DIMS == (32, 64, 128) and list(fp.GROUPS) == list(range(1, 9))


@pytest.mark.parametrize("kernel", SPLIT_KERNELS + ("flash_prefill",))
def test_check_heads_refuses_other_shapes(kernel):
    """d 96 is refused by every kernel and G 16 by the split-key ones (K3
    takes any G), with a ValueError naming ROADMAP.md Queue 2."""
    with pytest.raises(ValueError, match="d must be one of.*Queue 2"):
        fp.check_heads(kernel, 96, 2)
    if kernel == "flash_prefill":
        fp.check_heads(kernel, 32, 16)
        return
    with pytest.raises(ValueError, match="H / Kh.*Queue 2"):
        fp.check_heads(kernel, 32, 16)


# ------------------------------------------------------------- the embedding


@pytest.mark.parametrize("table", ["q8", "dense"])
def test_embedding_ids_past_the_table_match_jax(table):
    """tiny-test's 512-row table under a 32,000-piece tokenizer: an id past
    the table takes its last row, as JAX's gather clamps it (the server at
    --model tiny-test on the card would otherwise stop the device)."""
    w = (np.random.default_rng(5).standard_normal((512, 128)) * 0.02).astype(
        np.float32)
    ids = np.array([[0, 511, 512, 31999]], np.int32)
    if table == "q8":
        jt = jax.jit(jcodec.quantize, static_argnums=(1, 2))(jnp.asarray(w), "q8",
                                                             "nk")
        pt = qtensor_from_numpy((np.asarray(jt.data), np.asarray(jt.scales), "q8",
                                 "nk"))
    else:
        jt, pt = jnp.asarray(w), torch.from_numpy(w)
    want = np.asarray(jax_embedding(jnp.asarray(ids), jt, jnp.float32))
    got = embedding_lookup(torch.from_numpy(ids), pt, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[0, 2], want[0, 1])


# ------------------------------------------------------------------ the dryrun


def _graft_configs():
    """The two configs ``__graft_entry__.dryrun_multichip`` builds (`cfg`
    and `l3`), evaluated from its source with JAX's tiny_test_config."""
    path = Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    src = path.read_text()
    found = {}
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("cfg", "l3")
                and "tiny_test_config" in ast.get_source_segment(src, node.value)):
            found.setdefault(node.targets[0].id, eval(  # noqa: S307
                ast.get_source_segment(src, node.value),
                {"tiny_test_config": jax_tiny}))
    return found["cfg"], found["l3"]


def test_dryrun_configs_are_jax_own():
    """The port's dryrun configs equal JAX's, field by field: head dim
    32 and 2 query heads a kv head, unwidened."""
    for port, jax_cfg in zip(dryrun_multichip.configs(), _graft_configs()):
        jax_fields = dataclasses.asdict(jax_cfg)
        port_fields = dataclasses.asdict(port)
        assert {k: port_fields[k] for k in jax_fields} == jax_fields
        assert port.d_head == jax_cfg.n_embd // jax_cfg.n_heads == 32
        assert port.n_heads // port.n_kv_heads == 2


# ------------------------------------------------------------------- the model

#: (JAX config, the port's): d 32 with G 1, and the d 128 config of the
#: fused branch (n_embd 512 <= 2,048) with G 4
MODEL_CFGS = {
    "g1": (jax_tiny(n_kv_heads=4), pconfig.tiny_test_config(n_kv_heads=4)),
    "d128": (jax_tiny(n_embd=512, n_heads=4, n_kv_heads=1, n_ffn=1024),
             pconfig.tiny_test_config(n_embd=512, n_heads=4, n_kv_heads=1,
                                      n_ffn=1024)),
}


def _to_numpy(tree):
    if isinstance(tree, jcodec.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.kind,
                tree.layout)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _models(name):
    """JAX's q8 parameters of the config (quantized by its jitted codec
    from numpy N(0, 0.02) weights), its engine, and the port's copy of
    the parameters."""
    jcfg, cfg = MODEL_CFGS[name]
    quant = jax.jit(jcodec.quantize, static_argnums=(1, 2))
    rng = np.random.default_rng(32)

    def q(shape, layout):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return quant(jnp.asarray(w), "q8", layout)

    nl, d, F, V = jcfg.n_layers, jcfg.n_embd, jcfg.n_ffn, jcfg.n_vocab
    ones = jnp.ones((nl, d), jnp.float32)
    jp = {"embed": q((V, d), "nk"), "lm_head": q((V, d), "kn"),
          "norm": jnp.ones((d,), jnp.float32),
          "layers": {"wqkv": q((nl, d + 2 * jcfg.kv_dim, d), "kn"),
                     "wo": q((nl, d, d), "kn"),
                     "w_gateup": q((nl, 2 * F, d), "kn"),
                     "w_down": q((nl, d, F), "kn"),
                     "attn_norm": ones, "ffn_norm": ones}}
    jeng = JaxEngine(jcfg, JaxPolicy("q8", "f32", "f32"), jp, use_pallas=True)
    return jeng, params_from_numpy(_to_numpy(jp), cfg,
                                   pconfig.DtypePolicy("q8", "f32", "f32"))


def test_model_configs_shape():
    """g1 is the tiny config at one query head a kv head (d 32); d128 is
    head dim 128 at four, narrow enough for the fused branch."""
    shapes = {n: (c.d_head, c.q_heads_per_group, c.n_embd <= 2048)
              for n, (_, c) in MODEL_CFGS.items()}
    assert shapes == {"g1": (32, 1, True), "d128": (128, 4, True)}


@pytest.mark.parametrize("prompt_len", [20, 40], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_greedy_small_heads_matches_jax_pallas(name, prompt_len):
    """Greedy f32 tokens of ``Engine.generate`` on the CPU equal JAX
    ``Engine(use_pallas=True)``'s: a 20-token prompt (the fused prefill:
    K5, K3, K6, K7) and a 40-token one (the unfused prefill: K2, K3),
    then 12 b1 decode steps on the fused branch (K5, K8, K7)."""
    jeng, pp = _models(name)
    cfg = MODEL_CFGS[name][1]
    rng = np.random.default_rng(prompt_len)
    prompt = [1] + rng.integers(2, cfg.n_vocab, prompt_len - 1).tolist()
    gen = dict(n_predict=prompt_len + 12, greedy=True, eos_token=-1,
               chunk_size=6)
    jout, _ = jeng.generate(prompt, JaxGen(**gen))
    pout, _ = Engine(cfg, pconfig.DtypePolicy("q8", "f32", "f32"), pp,
                     device="cpu").generate(prompt,
                                            pconfig.GenerationConfig(**gen))
    assert len(pout) == 12 and pout == [int(t) for t in jout]
