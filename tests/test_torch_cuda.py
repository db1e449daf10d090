"""The port's CUDA kernels against their plain versions, and what the
kernel wrappers and the builder refuse.

The tests marked ``cuda`` need a card and skip without one; they import
neither JAX nor the JAX package, so on a machine with a card they run
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

They cover shapes the main path of chip_smoke.py does not: M from 1 to 8
and ragged M / N for the matmuls, batch 2 with a different position per
row, prefill at pos > 0 with a partial last query tile, and 4 query
heads per kv head; for the fused kernels (K5-K8) M in {1, 3, 8, 9, 17,
32}, K5 and K7 in q8 at TinyLlama's widths and at ragged widths (a half
tile of output columns, a half step of K), K8 at pos 0 to 1500, K5, K7
and K8 captured in a CUDA graph at one layer and replayed at another,
and their wrappers' refusals; for the serving attention (K9-K11) pos and
chunk bases 0, P - 1, P and 1500 with P = 256, B = 1, 4 and 32, 4 and 8
query heads per kv head, staged tail fills 1 to C, a CUDA-graph replay,
and the engine's staged and paged chunks against the plain path; the
int8 KV cache's kernels (K3 at T 16 to 512, K4 and K8 at pos 0 to 1500,
K9-K11 at the same bases and batches, at TinyLlama's heads), their graph
replay, refusals and an int8 engine against the plain path; K1's aq8
branch (q8 and q4, M 1 to 8, every TinyLlama weight shape, bf16 and f32
out) and the f16 and f32 instantiations of K3, K4, K8-K11 at the int8
cases' shapes, their graph replay, refusals (q4g with aq8, planes of two
dtypes, scales beside an f16 cache), and aq8, f16-KV and f32-KV engines
against the plain path; and the split-key K4 and K10 over every KV kind
at pos 0, 63, 64, 1500 and 2047 (B = 1, and B = 4 with a position a row),
G = 4 and 8, and replayed from a CUDA graph captured at pos 127 at other
positions; K1 and K6 on the fused walk (K1 at K = 14,336 and 28,672, at
N = 32,004, unstacked, f32 and bf16 out, aq8 in q8 and q4; the card's
residency for their plans; both replayed from a CUDA graph across
layers; K1's refusals); and the split-key K9 and K11 over every KV kind at ragged
chunk bases and tail fills (a 1-slot tail among them), tails of 32, 64
and 96 slots, G = 4 and 8, a row with no visible key (zeros), and
replayed from a CUDA graph at later slots and chunk bases; K4, K9,
K10 and K11 over caches whose keys past each row's visible ones are NaN;
and K8 as two launches (the split attention, then the walk as a
programmatic dependent launch) over every weight kind and KV kind at G =
1, 2, 3, 4 and 8 and pos 0, 63, 64, 127, 447, 448 and 1500 (a second call
bit-equal, K4's and K6's counts unmoved), replayed from a CUDA graph
captured at layer 0 and pos 127 at another layer and positions, and its
plan resident on the card; and the decode chunk as a CUDA graph
(``Engine.run_chunk``) bit-equal to the eager ``Engine.chunk`` over
every cache kind at B = 1, 4 and 32 and over dense f16 and f32 weights,
its top-k draws, its replays after a cache is reused (tokens and launch
counts of the eager chunk), and two threads capturing at once; and
speculative decoding: K3 at a verify round's shapes (T = 5, G = 8, pos
> 0 over 2,048 + 128 keys) over every KV kind, captured at one pos and
replayed at others, the verify rounds' graph torch.equal to the same
rounds run eagerly (k = 1, 4 and 40), f32 dense generate_speculative
equal to generate, the graph keys and launch counts with and without
debug_nans, and the profiler's kernel events against the launch counts
of a replayed chunk and a replayed set of rounds; and K1-K4 and K9-K11 at
a tensor-parallel rank's local widths (TinyLlama at tp 2 and 4, Kh = 1
at 4; Llama-3-8B at tp 2; the --tp-overlap ring's column chunks).
Tolerance: the JAX suite's bf16 kernel tolerance,
rtol 2e-2 / atol 5e-3 (tests/test_tpu_kernels.py), against the plain
version on the same card and inputs.

The rest run anywhere: the wrappers' input checks (run before any
launch), and the builder's hashing and its refusal without nvcc.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tinyllama_tpu_torch.config import (
    GenerationConfig, MODEL_REGISTRY, POLICIES, tiny_test_config,
)
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops import sampling
from tinyllama_tpu_torch.ops.kernels import (
    attn_out_fused,
    build,
    decode_fused,
    ffn_fused,
    flash_attention,
    flash_paged,
    fused_plan,
    qmatmul,
)
from tinyllama_tpu_torch.parallel.tp import local_config
from tinyllama_tpu_torch.quant.codec import QTensor, quantize
from tinyllama_tpu_torch.runtime import kvcache, speculative, trace
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import KVCache
from tinyllama_tpu_torch.runtime.paged import PagedKVCache
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher
from tinyllama_tpu_torch.runtime.staging import StagedKVCache

TOL = dict(rtol=2e-2, atol=5e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weight(L, K, N, seed, device="cpu", kind="q8") -> QTensor:
    g = torch.Generator().manual_seed(seed)
    qts = [quantize(torch.randn(N, K, generator=g) * 0.05, kind, "kn")
           for _ in range(L)]
    return QTensor(torch.stack([q.data for q in qts]).to(device),
                   torch.stack([q.scales for q in qts]).to(device), kind, "kn")


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


def _fused_inputs(M, device, D=256, F=512, L=2, seed=0, kind="q8", n_qkv=None):
    """Activations, stacked [L, D] norm table and the four stacked
    weights of a small fused layer (wqkv D -> n_qkv, by default D + 128)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, 1, D, generator=g).to(device, torch.bfloat16)
    a = torch.randn(M, 1, D, generator=g).to(device, torch.bfloat16)
    nw = (torch.rand(L, D, generator=g) + 0.5).to(device)
    ws = {"wqkv": _weight(L, D, n_qkv or D + 128, seed + 1, device, kind),
          "wo": _weight(L, D, D, seed + 2, device, kind),
          "w_gateup": _weight(L, D, 2 * F, seed + 3, device, kind),
          "w_down": _weight(L, F, D, seed + 4, device, kind)}
    cfg = tiny_test_config(n_embd=D, n_ffn=F, n_heads=4, n_kv_heads=1)
    return x, a, nw, ws, cfg


def _counted(mod, name, fn):
    before = mod.launches[name]
    out = fn()
    assert mod.launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 32])
def test_fused_matmul_kernels_match_plain(card, M):
    """K5, K6 and both entries of K7 against their plain versions on the
    card, across both rounding bodies (M <= 8 exact, M > 8 bf16 weight)."""
    x, a, nw, ws, cfg = _fused_inputs(M, card, seed=M)
    layer = _i32([1], card)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    cases = [
        (decode_fused, "fused_norm_qkv",
         lambda: decode_fused.fused_norm_qkv(x, nw, ws["wqkv"], layer, eps, inside),
         lambda: decode_fused.fused_norm_qkv_ref(x, nw, ws["wqkv"], layer, eps,
                                                 inside)),
        (decode_fused, "fused_out_residual",
         lambda: decode_fused.fused_out_residual(a, x, ws["wo"], layer),
         lambda: decode_fused.fused_out_residual_ref(a, x, ws["wo"], layer)),
        (ffn_fused, "ffn_fused_normed",
         lambda: ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"],
                                            layer, cfg),
         lambda: ffn_fused.ffn_fused_ref(x, nw, ws["w_gateup"], ws["w_down"],
                                         layer, cfg, eps, inside)),
        (ffn_fused, "ffn_fused",
         lambda: ffn_fused.ffn_fused(a, ws["w_gateup"], ws["w_down"], layer, cfg),
         lambda: ffn_fused.ffn_fused_ref(a, None, ws["w_gateup"], ws["w_down"],
                                         layer, cfg)),
    ]
    for mod, name, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


def _attn_out_inputs(device, G, pos, Kh=2, S=1536, seed=0):
    H = G * Kh
    D = H * 64
    cache = _cache(1, Kh, S, [pos + 1], seed=seed, device=device)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, 1, H, 64, generator=g).to(device, torch.bfloat16)
    res = torch.randn(1, 1, D, generator=g).to(device, torch.bfloat16)
    return q, cache, res, _weight(2, D, D, seed + 1, device)


def _attn_out_kind_inputs(card, kind, kv, G, seed, Kh=2, S=1536):
    """K8's operands over a cache of KV kind `kv` (every position random;
    int8 quantized, f16 and f32 cast, from the same values) with a `kind`
    wo mapping H * 64 to H * 64 columns."""
    H = G * Kh
    D = H * 64
    cache = _cache(1, Kh, S, [S], seed=seed, device=card)
    cache = cache if kv == "bf16" else _i8(cache) if kv == "i8" else _float_kv(cache, kv)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, 1, H, 64, generator=g).to(card, torch.bfloat16)
    res = torch.randn(1, 1, D, generator=g).to(card, torch.bfloat16)
    return q, cache, res, _weight(2, D, D, seed + 1, card, kind)


@functools.lru_cache(maxsize=1)
def _attn_out_kind_case(card, kind, kv, G):
    """_attn_out_kind_inputs for one weight kind, KV kind and G, shared by
    the positions of test_fused_attn_out_matches_plain."""
    return _attn_out_kind_inputs(card, kind, kv, G, seed=G)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 63, 64, 127, 447, 448, 1500])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_fused_attn_out_matches_plain(card, kind, kv, G, pos):
    """K8's two launches over every weight kind and KV kind, G = 1 to 8
    query heads a kv head (2 kv heads), at pos 0, 63, 64 (a key tile's
    edges), 127, 447, 448 (the last row of SOLO_TILES tiles, one block's,
    and the first split one) and 1500, every key past pos random: against
    its plain version, counted once under its KV kind's key with K4's and
    K6's counts unmoved, and a second call bit-equal to the first."""
    q, cache, res, wo = _attn_out_kind_case(card, kind, kv, G)
    layer, p = _i32([1], card), _i32([pos], card)
    key = "fused_attn_out" + ("" if kv == "bf16" else f"_{kv}")
    k4, k6 = dict(flash_attention.launches), dict(decode_fused.launches)
    got = _counted(attn_out_fused, key,
                   lambda: attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo))
    again = attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo)
    assert flash_attention.launches == k4 and decode_fused.launches == k6
    want = attn_out_fused.fused_attn_out_ref(q, cache, layer, p, res, wo)
    torch.cuda.synchronize()
    assert got.shape == res.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 32])
def test_cooperative_kernels_replay_in_a_graph(card, M):
    """K5 and both entries of K7 (the fused walk: split K summed in a
    cluster; K7 two launches, the second a programmatic dependent launch)
    and K8 (the split attention, then the walk as a programmatic dependent
    launch, its merge's arrival counts wrapping), captured in one CUDA
    graph at layer 0 and replayed 3 times at layer 1, give the eager
    result at layer 1 bit for bit every time."""
    x, a, nw, ws, cfg = _fused_inputs(M, card, seed=3)
    q, cache, res, wo = _attn_out_inputs(card, 8, 700, seed=3)
    layer, p = _i32([0], card), _i32([700], card)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt

    def run():
        return (decode_fused.fused_norm_qkv(x, nw, ws["wqkv"], layer, eps, inside),
                ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"],
                                           layer, cfg),
                ffn_fused.ffn_fused(a, ws["w_gateup"], ws["w_down"], layer, cfg),
                attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo))

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    layer.fill_(1)
    eager = run()
    torch.cuda.synchronize()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
def test_fused_attn_out_replays_at_other_layers_and_positions(card, kv):
    """K8 at TinyLlama's heads (32 query heads, 4 kv heads, q8 wo
    2048 -> 2048) captured in a CUDA graph at layer 0 and pos 127 (two
    tiles, one block a kv head) and replayed at layer 1 and pos 1500,
    448, 447, 5 and 2047 (split rows merged by a ticket, and solo rows):
    each replay equal to an eager call there bit for bit; the attention's
    split count and the walk's plan follow host sizes only."""
    q, cache, res, wo = _attn_out_kind_inputs(card, "q8", kv, 8, seed=5, Kh=4, S=2048)
    layer, p = _i32([0], card), _i32([127], card)

    def run():
        return attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo)

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    layer.fill_(1)
    for pos in (1500, 448, 447, 5, 2047):
        p.fill_(pos)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, run()), pos


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_fused_attn_out_plan_is_resident(card, kind):
    """K8's plan at TinyLlama's widths on the card: the attention splits
    a row of max_ctx 2048 over 16 blocks (K4's count at B = 1), and the
    wo walk (K1's rule at M = 1) gives every SM but n_sm / 32 a block
    with every cluster resident at once: 16 tiles of 128 x 8 splits."""
    n_sm, code = qmatmul.sm_count(card), qmatmul.KIND_CODE[kind]
    n_split, width, splits = attn_out_fused.card_plan(code, 4, 2048, 2048, 2048, n_sm)
    assert n_split == min(16, -(-n_sm // 4))
    clusters = ctypes.c_int(0)
    build.check(attn_out_fused._lib().fused_attn_out_resident(
        code, 2048, width, splits, ctypes.byref(clusters)), "K8")
    blocks = -(-2048 // width) * splits
    assert n_sm - n_sm // 32 <= blocks <= clusters.value * splits, (width, splits)
    assert (width, splits) == (128, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 24, 32])
@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_fused_walk_ragged_shapes_match_plain(card, kind, M):
    """K5 and both entries of K7 where the output columns end in half a
    64-column tile (wqkv N 480 or 416, and at M <= 8 F 480 and D 352) and,
    at M <= 8, K in half a 64-row step (352 = 5.5 steps, 480 = 7.5; above
    M = 8 the wrappers and the kernel refuse such a K, as qmatmul's tile
    regime does: test_fused_walk_refuses_half_steps_above_8_rows), against
    their plain versions."""
    D, F, n_qkv = (352, 480, 480) if M <= 8 else (320, 512, 416)
    x, a, nw, ws, cfg = _fused_inputs(M, card, D=D, F=F, seed=M, kind=kind,
                                      n_qkv=n_qkv)
    layer = _i32([1], card)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    got = [decode_fused.fused_norm_qkv(x, nw, ws["wqkv"], layer, eps, inside),
           ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"], layer, cfg),
           ffn_fused.ffn_fused(a, ws["w_gateup"], ws["w_down"], layer, cfg)]
    want = [decode_fused.fused_norm_qkv_ref(x, nw, ws["wqkv"], layer, eps, inside),
            ffn_fused.ffn_fused_ref(x, nw, ws["w_gateup"], ws["w_down"], layer, cfg,
                                    eps, inside),
            ffn_fused.ffn_fused_ref(a, None, ws["w_gateup"], ws["w_down"], layer, cfg)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_fused_walk_grid_is_resident_in_one_wave(card, kind, M):
    """At TinyLlama's widths the wrappers' plans keep every cluster of K5's
    launch and of K7's two launches resident at once (the occupancy the
    libraries report for the launch shape), and give every SM a block but
    a few: K7's down launch takes 16 tiles of 128 columns times 8 splits
    (128 blocks) where 32 tiles of 64 (256 blocks) would run a second wave
    of clusters."""
    n_sm = qmatmul.sm_count(card)
    code = qmatmul.KIND_CODE[kind]
    k5, k7 = decode_fused._lib().fused_norm_qkv_resident, ffn_fused._lib().ffn_fused_resident
    launches = [("K5", decode_fused.plan(code, M, 2048, 2560, n_sm), 2560,
                 lambda w, s, n: k5(code, M, 2048, w, s, n)),
                ("K7 gate/up", ffn_fused.plan(code, M, 2048, 5632, True, n_sm), 5632,
                 lambda w, s, n: k7(code, M, 2048, w, s, 1, n)),
                ("K7 down", ffn_fused.plan(code, M, 5632, 2048, False, n_sm), 2048,
                 lambda w, s, n: k7(code, M, 5632, w, s, 0, n))]
    for name, (width, splits), ncols, resident in launches:
        clusters = ctypes.c_int(0)
        build.check(resident(width, splits, ctypes.byref(clusters)), name)
        blocks = -(-ncols // width) * splits
        assert 1 <= splits <= 8 and n_sm - n_sm // 32 <= blocks, (name, width, splits)
        assert blocks <= clusters.value * splits, (name, blocks, clusters.value)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [9, 32])
def test_fused_walk_refuses_half_steps_above_8_rows(card, M):
    """Above 8 rows (the bf16 regime) K must be whole 64-row steps: the
    three wrappers raise before a launch, and the libraries' entry points
    refuse the shape themselves (cudaErrorInvalidValue) without launching."""
    x, a, nw, ws, cfg = _fused_inputs(M, card, D=352, F=480, n_qkv=480)
    layer = _i32([0], card)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    with pytest.raises(ValueError, match="64 rows"):
        decode_fused.fused_norm_qkv(x, nw, ws["wqkv"], layer, eps, inside)
    with pytest.raises(ValueError, match="64 rows"):
        ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"], layer, cfg)
    with pytest.raises(ValueError, match="64 rows"):
        ffn_fused.ffn_fused(a, ws["w_gateup"], ws["w_down"], layer, cfg)
    out = torch.empty(M, 480, dtype=torch.bfloat16, device=card)
    act = torch.empty(M, 480, dtype=torch.bfloat16, device=card)
    w, gu, wd = ws["wqkv"], ws["w_gateup"], ws["w_down"]
    code, stream = qmatmul.KIND_CODE["q8"], build.stream_ptr(x)
    assert decode_fused._lib().fused_norm_qkv(
        x.data_ptr(), nw.data_ptr(), layer.data_ptr(), w.data.data_ptr(),
        w.scales.data_ptr(), out.data_ptr(), code, M, 352, 480, eps, int(inside), 64, 2,
        stream) == 1
    assert ffn_fused._lib().ffn_fused(
        x.data_ptr(), nw.data_ptr(), layer.data_ptr(), gu.data.data_ptr(),
        gu.scales.data_ptr(), wd.data.data_ptr(), wd.scales.data_ptr(), act.data_ptr(),
        out.data_ptr(), code, M, 352, 480, eps, int(inside), 64, 2, 64, 2, stream) == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_wrappers_refuse_on_the_card(card):
    x, a, nw, ws, cfg = _fused_inputs(2, card)
    layer = _i32([0], card)
    with pytest.raises(TypeError, match="bf16"):
        decode_fused.fused_norm_qkv(x.float(), nw, ws["wqkv"], layer, 1e-6, False)
    with pytest.raises(ValueError, match="norm weight"):
        decode_fused.fused_norm_qkv(x, nw[0], ws["wqkv"], layer, 1e-6, False)
    with pytest.raises(ValueError, match="residual"):
        decode_fused.fused_out_residual(a, x.float(), ws["wo"], layer)
    with pytest.raises(ValueError, match="M <= 32"):
        ffn_fused.ffn_fused(torch.zeros(33, 1, 256, dtype=torch.bfloat16,
                                        device=card),
                            ws["w_gateup"], ws["w_down"], layer, cfg)
    q, cache, res, wo = _attn_out_inputs(card, 8, 5)
    with pytest.raises(ValueError, match="wo must map"):
        attn_out_fused.fused_attn_out(q, cache, layer, _i32([5], card), res,
                                      _weight(2, 1024, 512, 0, card))


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


SERVE_S, SERVE_P, SERVE_C = 2048, 256, 32


def _serving_inputs(B, G, base, seed, device="cpu", Kh=2, L=2, d=64):
    """Random bf16 K9-K11 operands at full context: q [B, 1, G * Kh, d]; a
    dense cache [L, B, Kh, S, d]; a page pool of 1 + B * J pages under a
    shuffled table (page 0 the scratch page); a staged tail of C = 32
    slots; row b's chunk base is (base + 97 b) % (S - C) and its tail fill
    1 + (b + base) % C, so B = 32 covers every fill from 1 to C."""
    g = torch.Generator().manual_seed(seed)
    J = SERVE_S // SERVE_P

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(device, torch.bfloat16)

    bases = [(base + 97 * b) % (SERVE_S - SERVE_C) for b in range(B)]
    if B == 1:
        bases = [base]
    fills = [1 + (b + base) % SERVE_C for b in range(B)]
    dense = KVCache(rand(L, B, Kh, SERVE_S, d), rand(L, B, Kh, SERVE_S, d))
    table = 1 + torch.randperm(B * J, generator=g).reshape(B, J)
    pool = PagedKVCache(rand(L, 1 + B * J, Kh, SERVE_P, d),
                        rand(L, 1 + B * J, Kh, SERVE_P, d),
                        table.to(device, torch.int32))
    sk, sv = rand(L, B, Kh, SERVE_C, d), rand(L, B, Kh, SERVE_C, d)
    base_t = _i32(bases, device)
    pos = _i32([b + f - 1 for b, f in zip(bases, fills)], device)
    q = rand(B, 1, G * Kh, d)
    return (q, pos, pool, StagedKVCache(dense, sk, sv, base_t),
            StagedKVCache(pool, sk, sv, base_t))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("base", [0, SERVE_P - 1, SERVE_P, 1500])
def test_serving_attention_kernels_match_plain(card, base, B, G):
    """K9 and K11 at chunk bases on both sides of a page and deep in the
    context, every tail fill; K10 at pos = base (0, P - 1, P, 1500 for row
    0): each against its plain version on the same card and inputs."""
    q, pos, pool, st_dense, st_paged = _serving_inputs(B, G, base, seed=base + B,
                                                       device=card)
    layer = _i32([1], card)
    cases = [
        (flash_attention, "flash_staged",
         lambda: flash_attention.flash_staged_attention(q, st_dense, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_dense, layer, pos)),
        (flash_paged, "flash_paged_staged",
         lambda: flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_paged, layer, pos)),
        (flash_paged, "flash_paged",
         lambda: flash_paged.flash_paged_attention(q, pool, layer, st_paged.base),
         lambda: flash_paged.paged_attention_ref(q, pool, layer, st_paged.base)),
    ]
    for mod, name, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.cuda
def test_serving_attention_replays_in_a_graph(card):
    """K9, K10 and K11 captured in one CUDA graph and replayed 3 times give
    the eager result every time. Then K4 and K10 over bf16 caches and K4
    over an f32 cache, captured at pos 127 and replayed at 1500, 5 and
    2047 with pos written in place between replays: each replay equals an
    eager call at that pos (the split count does not follow pos, and each
    group's arrival count is back at 0 after every launch). Then K9 and
    K11 over each KV kind and a 96-slot tail, captured at slot 3 of a
    chunk and replayed at slots 0, 40 and 95 of it and in chunks whose
    bases moved by 64 and 300, base and pos written in place: each replay
    equals an eager call there."""
    q, pos, pool, st_dense, st_paged = _serving_inputs(32, 8, 700, seed=11,
                                                       device=card)
    layer = _i32([1], card)

    def run():
        return (flash_attention.flash_staged_attention(q, st_dense, layer, pos),
                flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos),
                flash_paged.flash_paged_attention(q, pool, layer, pos))

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)

    q1, dense, pool1 = _split_inputs(1, 8, "bf16", seed=12, device=card)
    _, dense32, _ = _split_inputs(1, 8, "f32", seed=13, device=card)
    p = _i32([127], card)

    def run_split():
        return (flash_attention.flash_decode_heads_attention(q1, dense, layer, p),
                flash_paged.flash_paged_attention(q1, pool1, layer, p),
                flash_attention.flash_decode_heads_attention(q1, dense32, layer,
                                                             p))

    run_split()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run_split()
    for at in (1500, 5, 2047):
        p.fill_(at)
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        eager = run_split()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e), f"replay at pos {at}"

    # K9 and K11 over every KV kind, captured at slot 3 of a chunk and
    # replayed at later slots and in later chunks (base and pos written in
    # place): the split count follows neither
    for kv in ("bf16", "i8", "f16", "f32"):
        rows = _staged_rows(96)
        bases = torch.tensor([b for b, _ in rows], dtype=torch.int32)
        q8, st_d, st_p = _staged_split_inputs(len(rows), 8, kv, 96,
                                              bases.tolist(), seed=14,
                                              device=card)
        p8 = st_d.base + 3

        def run_staged():
            return (flash_attention.flash_staged_attention(q8, st_d, layer, p8),
                    flash_paged.flash_paged_staged_attention(q8, st_p, layer,
                                                             p8))

        run_staged()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = run_staged()
        for shift, slot in ((0, 0), (0, 40), (0, 95), (64, 17), (300, 70)):
            st_d.base.copy_((bases + shift) % (SERVE_S - 96))
            p8.copy_(st_d.base + slot)
            for o in outs:
                o.zero_()
            graph.replay()
            torch.cuda.synchronize()
            eager = run_staged()
            torch.cuda.synchronize()
            for o, e in zip(outs, eager):
                assert torch.equal(o, e), f"{kv} replay at base + {shift}, {slot}"


@pytest.mark.cuda
def test_serving_attention_refuses_on_the_card(card):
    """Pages that are not whole 64-key tiles, and 2 query heads per kv
    head, are refused before a launch."""
    q, pos, pool, _, st_paged = _serving_inputs(2, 4, 10, seed=1, device=card)
    layer = _i32([0], card)
    small = PagedKVCache(pool.k[:, :, :, :32].contiguous(),
                         pool.v[:, :, :, :32].contiguous(), pool.table)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_paged.flash_paged_attention(q, small, layer, pos)
    with pytest.raises(ValueError, match="H / Kh"):
        flash_paged.flash_paged_staged_attention(q[:, :, :4], st_paged, layer,
                                                 pos)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_chunk_on_the_card_matches_cpu(card, paged):
    """A small model (d_head 64, 4 query heads per kv head, max_ctx 256)
    through a staged B = 3 decode chunk and a B = 1 chunk (K10 when paged,
    K8 when not), on the card and through the plain path: the logits
    agree to 5% of their largest magnitude, and the card's chunk launches
    the serving kernels."""
    cfg = tiny_test_config(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512,
                           max_ctx=256)
    policy = POLICIES["q8"]
    params = llama.init_quantized_params(cfg, policy,
                                         torch.Generator().manual_seed(0))
    gen = GenerationConfig(greedy=True, eos_token=-1)
    prompts = [[1, 5, 9, 33, 70, 2, 8], [1, 4], [1] + list(range(2, 60))]
    staged_name = "flash_paged_staged" if paged else "flash_staged"
    staged_mod = flash_paged if paged else flash_attention
    traces = []
    for device in (card, "cpu"):
        eng = Engine(cfg, policy, params, device=device, paged=paged)
        trace = []
        for rows in (prompts, prompts[:1]):
            cache = eng.new_cache(len(rows))
            logits, lens = eng.prefill(cache, rows)
            pos = torch.from_numpy(lens.astype(np.int32)).to(eng.device)
            before = staged_mod.launches[staged_name]
            _, _, logits, _ = eng.chunk(cache, logits, pos, 5, gen)
            if eng.device.type == "cuda" and len(rows) > 1:
                assert staged_mod.launches[staged_name] == before + 5 * 2
            trace.append(logits.float().cpu())
        traces.append(trace)
    for a, b in zip(*traces):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


# --- 4-bit weights on the card ---------------------------------------------------

#: TinyLlama-1.1B's matmul weights (K, N), the lm_head padded to 32768
TINYLLAMA_SHAPES = {"wqkv": (2048, 2560), "wo": (2048, 2048),
                    "w_gateup": (2048, 11264), "w_down": (5632, 2048),
                    "lm_head": (2048, 32768)}
_tl_weights: dict = {}


def _tl_weight(kind, name, device):
    """A TinyLlama-shaped kn weight of `kind` made and quantized on the card
    (2 layers; the lm_head unstacked), kept for the module's tests."""
    key = (kind, name)
    if key not in _tl_weights:
        K, N = TINYLLAMA_SHAPES[name]
        g = torch.Generator(device).manual_seed(len(_tl_weights))
        shape = (N, K) if name == "lm_head" else (2, N, K)
        _tl_weights[key] = quantize(torch.randn(shape, generator=g, device=device)
                                  * 0.02, kind, "kn")
    return _tl_weights[key]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TINYLLAMA_SHAPES))
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 16, 32])
@pytest.mark.parametrize("kind", ["q4", "q4g"])
def test_qmatmul_4bit_kernels_match_plain(card, kind, M, name):
    """K1 (M <= 8) and K2 (M = 16, 32) with q4 and q4g weights at every
    TinyLlama weight shape; f32 out for the lm_head, bf16 otherwise."""
    w = _tl_weight(kind, name, card)
    K = TINYLLAMA_SHAPES[name][0]
    layer = None if name == "lm_head" else _i32([1], card)
    out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
    x = torch.randn(M, K, device=card).to(torch.bfloat16)
    kname = "qmm_smallm" if M <= qmatmul.SMALL_M else "qmm_bigm"
    got = _counted(qmatmul, kname, lambda: qmatmul.qmatmul(x, w, out_dtype, layer))
    want = qmatmul.qmatmul_ref(x, w, out_dtype, layer)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _fused4_inputs(kind, M, device, seed=0):
    cfg = tiny_test_config(n_embd=2048, n_ffn=5632, n_heads=32, n_kv_heads=4)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, 1, 2048, generator=g).to(device, torch.bfloat16)
    a = torch.randn(M, 1, 2048, generator=g).to(device, torch.bfloat16)
    nw = (torch.rand(2, 2048, generator=g) + 0.5).to(device)
    ws = {n: _tl_weight(kind, n, device) for n in ("wqkv", "wo", "w_gateup",
                                                 "w_down")}
    return x, a, nw, ws, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 32])
@pytest.mark.parametrize("kind", ["q4", "q4g"])
def test_fused_4bit_kernels_match_plain(card, kind, M):
    """K5, K6 and both entries of K7 with 4-bit weights at TinyLlama's
    widths (w_down's K of 5632: 176 blocks of 32, 44 groups of 128),
    across both rounding bodies."""
    x, a, nw, ws, cfg = _fused4_inputs(kind, M, card, seed=M)
    layer = _i32([1], card)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    cases = [
        (decode_fused, "fused_norm_qkv",
         lambda: decode_fused.fused_norm_qkv(x, nw, ws["wqkv"], layer, eps, inside),
         lambda: decode_fused.fused_norm_qkv_ref(x, nw, ws["wqkv"], layer, eps,
                                                 inside)),
        (decode_fused, "fused_out_residual",
         lambda: decode_fused.fused_out_residual(a, x, ws["wo"], layer),
         lambda: decode_fused.fused_out_residual_ref(a, x, ws["wo"], layer)),
        (ffn_fused, "ffn_fused_normed",
         lambda: ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"],
                                            layer, cfg),
         lambda: ffn_fused.ffn_fused_ref(x, nw, ws["w_gateup"], ws["w_down"],
                                         layer, cfg, eps, inside)),
        (ffn_fused, "ffn_fused",
         lambda: ffn_fused.ffn_fused(a, ws["w_gateup"], ws["w_down"], layer, cfg),
         lambda: ffn_fused.ffn_fused_ref(a, None, ws["w_gateup"], ws["w_down"],
                                         layer, cfg)),
    ]
    for mod, name, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 32])
def test_fused_walk_q8_at_tinyllama_widths(card, M):
    """K5 and both entries of K7 with q8 weights at TinyLlama's widths
    (the splits of the plan at 2048 -> 2560, 2048 -> 2 x 5632 and 5632 ->
    2048), across both rounding regimes."""
    x, a, nw, ws, cfg = _fused4_inputs("q8", M, card, seed=M)
    layer = _i32([1], card)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    cases = [
        (decode_fused, "fused_norm_qkv",
         lambda: decode_fused.fused_norm_qkv(x, nw, ws["wqkv"], layer, eps, inside),
         lambda: decode_fused.fused_norm_qkv_ref(x, nw, ws["wqkv"], layer, eps,
                                                 inside)),
        (ffn_fused, "ffn_fused_normed",
         lambda: ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"],
                                            layer, cfg),
         lambda: ffn_fused.ffn_fused_ref(x, nw, ws["w_gateup"], ws["w_down"],
                                         layer, cfg, eps, inside)),
        (ffn_fused, "ffn_fused",
         lambda: ffn_fused.ffn_fused(a, ws["w_gateup"], ws["w_down"], layer, cfg),
         lambda: ffn_fused.ffn_fused_ref(a, None, ws["w_gateup"], ws["w_down"],
                                         layer, cfg)),
    ]
    for mod, name, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


def _attn_out4_inputs(kind, device, pos, seed=0):
    cache = _cache(1, 4, 2048, [pos + 1], seed=seed, device=device)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, 1, 32, 64, generator=g).to(device, torch.bfloat16)
    res = torch.randn(1, 1, 2048, generator=g).to(device, torch.bfloat16)
    return q, cache, res, _tl_weight(kind, "wo", device)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 127, 1500])
@pytest.mark.parametrize("kind", ["q4", "q4g"])
def test_fused_attn_out_4bit_matches_plain(card, kind, pos):
    """K8 with a 4-bit wo at TinyLlama's widths (32 heads, 4 kv heads)."""
    q, cache, res, wo = _attn_out4_inputs(kind, card, pos, seed=pos)
    layer, p = _i32([1], card), _i32([pos], card)
    got = _counted(attn_out_fused, "fused_attn_out",
                   lambda: attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo))
    want = attn_out_fused.fused_attn_out_ref(q, cache, layer, p, res, wo)
    torch.cuda.synchronize()
    assert got.shape == res.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_cooperative_4bit_kernels_replay_in_a_graph(card):
    """K7 and K8 with q4g weights captured in one CUDA graph and replayed
    3 times give the eager result every time."""
    x, _, nw, ws, cfg = _fused4_inputs("q4g", 4, card, seed=3)
    q, cache, res, wo = _attn_out4_inputs("q4g", card, 700, seed=3)
    layer, p = _i32([1], card), _i32([700], card)

    def run():
        return (ffn_fused.ffn_fused_normed(x, nw, ws["w_gateup"], ws["w_down"],
                                           layer, cfg),
                attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo))

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.cuda
def test_4bit_wrappers_refuse_on_the_card(card):
    """Malformed 4-bit weights on the card are refused before a launch:
    the wrong data type, scales of the other 4-bit kind, and two kinds in
    one FFN."""
    x, a, nw, ws, cfg = _fused4_inputs("q4", 2, card)
    layer = _i32([0], card)
    w = ws["wqkv"]
    with pytest.raises(TypeError, match="uint8"):
        qmatmul.qmatmul(x[0], QTensor(w.data.view(torch.int8), w.scales, "q4",
                                      "kn"), layer=layer)
    with pytest.raises(ValueError, match="scales"):
        decode_fused.fused_norm_qkv(x, nw, QTensor(w.data, w.scales[:, ::4],
                                                   "q4", "kn"), layer, 1e-6, False)
    with pytest.raises(ValueError, match="one kind"):
        ffn_fused.ffn_fused(a, ws["w_gateup"], _tl_weight("q4g", "w_down", card),
                            layer, cfg)
    with pytest.raises(ValueError, match="K=2048"):
        attn_out_fused.fused_attn_out(
            *_attn_out4_inputs("q4", card, 5)[:2], layer, _i32([5], card),
            _attn_out4_inputs("q4", card, 5)[2],
            QTensor(w.data[:, :512], w.scales[:, :32], "q4", "kn"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["q4", "q4g"])
def test_engine_4bit_on_the_card_matches_cpu(card, kind):
    """A small 4-bit model through the kernels and the plain path:
    last-token logits of a long prefill (K2), a short one (K5, K6, K7)
    and two decode steps (K5, K8, K7, K1) agree to 5% of their largest
    magnitude."""
    cfg = tiny_test_config(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512)
    policy = POLICIES[kind]
    params = llama.init_quantized_params(cfg, policy,
                                         torch.Generator().manual_seed(0))
    traces = []
    for device in (card, "cpu"):
        eng = Engine(cfg, policy, params, device=device)
        logits, _ = eng.prefill(eng.new_cache(1), [list(range(1, 41))])
        trace = [logits.float().cpu()]
        cache = eng.new_cache(1)
        logits, _ = eng.prefill(cache, [[1, 5, 9, 33, 70, 2, 8]])
        trace.append(logits.float().cpu())
        p = _i32([7], eng.device)
        for t in (11, 12):
            trace.append(eng.decode_step(cache, _i32([t], eng.device), p)
                         .float().cpu())
            p += 1
        traces.append(trace)
    for a, b in zip(*traces):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


# --- the int8 KV cache on the card ----------------------------------------------


def _i8(cache):
    """The same history quantized to int8 with its scales (quantize_kv),
    for a KVCache, a PagedKVCache or a StagedKVCache over either."""
    (k, ks), (v, vs) = kvcache.quantize_kv(cache.k), kvcache.quantize_kv(cache.v)
    if isinstance(cache, PagedKVCache):
        return PagedKVCache(k, v, cache.table, ks, vs)
    return KVCache(k, v, ks, vs)


def _i8_staged(st: StagedKVCache, pool) -> StagedKVCache:
    (sk, sks), (sv, svs) = kvcache.quantize_kv(st.sk), kvcache.quantize_kv(st.sv)
    return StagedKVCache(pool, sk, sv, st.base, sk_scale=sks, sv_scale=svs)


@pytest.mark.cuda
@pytest.mark.parametrize("T,pos", [(16, 0), (128, 0), (512, 0), (1, 0),
                                   (1, 127), (1, 1500)])
def test_attention_i8_kernels_match_plain(card, T, pos):
    """K3 (a prompt of T tokens) and K4 (T = 1, two rows at pos and pos
    / 2) over an int8 cache at TinyLlama's heads (32 query, 4 kv) and
    max_ctx 2048: each against its plain version, which dequantizes."""
    rows = [pos] if T > 1 else [pos, pos // 2]
    cache = _i8(_cache(len(rows), 4, 2048, [p + T for p in rows], seed=T + pos,
                       device=card))
    q = torch.randn(len(rows), T, 32, 64, device=card).to(torch.bfloat16)
    layer, p = _i32([1], card), _i32(rows, card)
    fn, name = ((flash_attention.flash_decode_heads_attention, "flash_decode_heads")
                if T == 1 else (flash_attention.flash_prefill_attention,
                                "flash_prefill"))
    got = _counted(flash_attention, f"{name}_i8", lambda: fn(q, cache, layer, p))
    want = flash_attention.attention_ref(q, cache, layer, p)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _attn_out_i8_inputs(device, pos, seed=0):
    """K8's operands at TinyLlama's widths over an int8 cache, q8 wo."""
    cache = _i8(_cache(1, 4, 2048, [pos + 1], seed=seed, device=device))
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, 1, 32, 64, generator=g).to(device, torch.bfloat16)
    res = torch.randn(1, 1, 2048, generator=g).to(device, torch.bfloat16)
    return q, cache, res, _weight(2, 2048, 2048, seed + 1, device)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 127, 1500])
def test_fused_attn_out_i8_matches_plain(card, pos):
    """K8 over an int8 cache at TinyLlama's widths (32 heads, 4 kv heads,
    q8 wo)."""
    q, cache, res, wo = _attn_out_i8_inputs(card, pos, seed=pos)
    layer, p = _i32([1], card), _i32([pos], card)
    got = _counted(attn_out_fused, "fused_attn_out_i8",
                   lambda: attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo))
    want = attn_out_fused.fused_attn_out_ref(q, cache, layer, p, res, wo)
    torch.cuda.synchronize()
    assert got.shape == res.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _serving_i8_inputs(B, base, seed, device):
    """_serving_inputs at TinyLlama's heads (4 kv heads, 8 query heads
    each), every plane quantized to int8."""
    q, pos, pool, st_dense, st_paged = _serving_inputs(B, 8, base, seed, device,
                                                       Kh=4)
    pool, dense = _i8(pool), _i8(st_dense.pool)
    return (q, pos, pool, _i8_staged(st_dense, dense),
            _i8_staged(st_paged, pool))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("base", [0, SERVE_P - 1, SERVE_P, 1500])
def test_serving_attention_i8_kernels_match_plain(card, base, B):
    """K9 and K11 over an int8 pool and tail, chunk bases on both sides of
    a page and deep in the context, every tail fill at B = 32; K10 at pos
    = base: each against its plain version."""
    q, pos, pool, st_dense, st_paged = _serving_i8_inputs(B, base, base + B, card)
    layer = _i32([1], card)
    cases = [
        ("flash_staged_i8", flash_attention,
         lambda: flash_attention.flash_staged_attention(q, st_dense, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_dense, layer, pos)),
        ("flash_paged_staged_i8", flash_paged,
         lambda: flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_paged, layer, pos)),
        ("flash_paged_i8", flash_paged,
         lambda: flash_paged.flash_paged_attention(q, pool, layer, st_paged.base),
         lambda: flash_paged.paged_attention_ref(q, pool, layer, st_paged.base)),
    ]
    for name, mod, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.cuda
def test_i8_kernels_replay_in_a_graph(card):
    """K8, K9, K10 and K11 over int8 caches captured in one CUDA graph
    and replayed 3 times give the eager result every time."""
    q, pos, pool, st_dense, st_paged = _serving_i8_inputs(32, 700, 11, card)
    q8, cache8, res8, wo8 = _attn_out_i8_inputs(card, 700, seed=3)
    layer, p8 = _i32([1], card), _i32([700], card)

    def run():
        return (attn_out_fused.fused_attn_out(q8, cache8, layer, p8, res8, wo8),
                flash_attention.flash_staged_attention(q, st_dense, layer, pos),
                flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos),
                flash_paged.flash_paged_attention(q, pool, layer, pos))

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.cuda
def test_i8_wrappers_refuse_on_the_card(card):
    """On the card, int8 data without scales, scales beside bf16 data, and
    scales of the wrong shape or dtype are refused before a launch."""
    q, cache, res, wo = _attn_out_i8_inputs(card, 5)
    layer, p = _i32([0], card), _i32([5], card)
    bf = _cache(1, 4, 2048, [6], seed=0, device=card)
    bad = {
        "int8 without scales": (KVCache(cache.k, cache.v), TypeError),
        "scales with bf16": (KVCache(bf.k, bf.v, cache.k_scale, cache.v_scale),
                             TypeError),
        "f16 scales": (KVCache(cache.k, cache.v, cache.k_scale.half(),
                               cache.v_scale), TypeError),
        "scale shape": (KVCache(cache.k, cache.v, cache.k_scale[..., :1024],
                                cache.v_scale), ValueError),
    }
    for name, (c, exc) in bad.items():
        with pytest.raises(exc):
            flash_attention.flash_decode_heads_attention(q, c, layer, p)
        with pytest.raises(exc):
            attn_out_fused.fused_attn_out(q, c, layer, p, res, wo)
    _, pos, pool, _, st_paged = _serving_i8_inputs(2, 10, 1, card)
    with pytest.raises(TypeError, match="scale"):
        flash_paged.flash_paged_attention(
            q.expand(2, 1, 32, 64).contiguous(),
            PagedKVCache(pool.k, pool.v, pool.table), layer, pos)


#: the widest margin by which the CPU's own greedy pick may beat the card's
#: token where the two differ, for the policies where they did on the card
#: (logits of these engines reach about 1.15): twice the largest
#: difference between the card's and the CPU's logits of a row at the
#: staged chunk's steps before the tie (0.0068 with an int8 cache, 0.0152
#: under q8a8, where both sides quantize activations), since two logits
#: each moved that far may swap. The ties seen: CPU margins 0.0004 (int8
#: cache) and 0.0106 (q8a8) at the 4th step of the B = 3 chunk, the card
#: taking token 243 and the CPU 238.
NEAR_TIE = {"q8-kvi8": 0.015, "q8a8": 0.03}


def _card_and_cpu_traces(cfg, policy, params, card, paged=False, ties=None,
                         near_tie=0.0):
    """Logits of a small model through a prefill, a staged B = 3 chunk of 5
    greedy steps and a B = 1 chunk, on the card and through the plain path
    on the CPU, each decoding greedily on its own; each cache is int8
    exactly when the policy asks for it. With `ties` (pytest's
    monkeypatch), the CPU's greedy token must equal the card's at every
    step but where its own pick beats the card's by at most `near_tie`: a
    near-tie, where the CPU takes the card's token so that the later
    logits stay comparable."""
    prompts = [[1, 5, 9, 33, 70, 2, 8], [1, 4], [1] + list(range(2, 60))]
    gen = GenerationConfig(greedy=True, eos_token=-1)
    greedy, picked = sampling.greedy, []

    def record(logits):
        tok = greedy(logits)
        picked.append(tok.cpu())
        return tok

    def follow(logits):
        tok, theirs = greedy(logits), picked.pop(0).to(logits.device)
        x = logits.float()
        margin = (x.gather(-1, tok.long()[:, None])
                  - x.gather(-1, theirs.long()[:, None]))[:, 0]
        differ = tok != theirs
        assert bool((margin[differ] <= near_tie).all()), (tok, theirs, margin)
        return theirs

    traces = []
    for device, pick in ((card, record), ("cpu", follow)):
        if ties is not None:
            ties.setattr(sampling, "greedy", pick)
        eng = Engine(cfg, policy, params, device=device, paged=paged)
        trace = []
        for rows in (prompts, prompts[:1]):
            cache = eng.new_cache(len(rows))
            assert cache.quantized == (policy.kv_dtype == "i8")
            logits, lens = eng.prefill(cache, rows)
            trace.append(logits.float().cpu())
            pos = torch.from_numpy(lens.astype(np.int32)).to(eng.device)
            _, _, logits, _ = eng.chunk(cache, logits, pos, 5, gen)
            trace.append(logits.float().cpu())
        traces.append(trace)
    assert not picked
    return traces


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_i8_on_the_card_matches_cpu(card, paged, monkeypatch):
    """A small model with an int8 KV cache (q8-kvi8) through the kernels
    and through the plain path: a prefill, a staged B = 3 chunk and a
    B = 1 chunk (K8, or K10 when paged), the same greedy tokens but at a
    near-tie (_card_and_cpu_traces); the logits agree to 5% of their
    largest magnitude."""
    cfg = tiny_test_config(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512,
                           max_ctx=256)
    policy = POLICIES["q8-kvi8"]
    params = llama.init_quantized_params(cfg, policy,
                                         torch.Generator().manual_seed(0))
    for a, b in zip(*_card_and_cpu_traces(cfg, policy, params, card, paged,
                                          monkeypatch, NEAR_TIE["q8-kvi8"])):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


# --- aq8 activations on the card (q8a8, q4a8) --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(TINYLLAMA_SHAPES))
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_qmatmul_aq8_kernel_matches_plain(card, kind, M, name, out_dtype):
    """K1's aq8 branch (x quantized to int8 per 32-block in the kernel,
    int32 block dots) at every TinyLlama weight shape, layer-stacked but
    the lm_head, against its plain version, which takes the same integer
    dots in f64."""
    w = _tl_weight(kind, name, card)
    K = TINYLLAMA_SHAPES[name][0]
    layer = None if name == "lm_head" else _i32([1], card)
    x = torch.randn(M, K, device=card).to(torch.bfloat16)
    got = _counted(qmatmul, "qmm_smallm_aq8",
                   lambda: qmatmul.qmatmul(x, w, out_dtype, layer, aq8=True))
    want = qmatmul.qmatmul_ref(x, w, out_dtype, layer, aq8=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_aq8_refusals_on_the_card(card):
    """q4g has no aq8 branch; above M = 8 aq8 is ignored and K2 runs."""
    x = torch.randn(2, 2048, device=card).to(torch.bfloat16)
    with pytest.raises(ValueError, match="q4g"):
        qmatmul.qmatmul(x, _tl_weight("q4g", "wo", card), layer=_i32([0], card),
                        aq8=True)
    x16 = torch.randn(16, 2048, device=card).to(torch.bfloat16)
    w = _tl_weight("q8", "wo", card)
    got = _counted(qmatmul, "qmm_bigm",
                   lambda: qmatmul.qmatmul(x16, w, layer=_i32([0], card), aq8=True))
    torch.testing.assert_close(got, qmatmul.qmatmul(x16, w, layer=_i32([0], card)),
                               rtol=0, atol=0)


# --- f16 and f32 KV caches on the card ----------------------------------------------


def _float_kv(cache, kv):
    """A bf16 KVCache or PagedKVCache with its values in f16 or f32."""
    dt = {"f16": torch.float16, "f32": torch.float32}[kv]
    if isinstance(cache, PagedKVCache):
        return PagedKVCache(cache.k.to(dt), cache.v.to(dt), cache.table)
    return KVCache(cache.k.to(dt), cache.v.to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("T,pos", [(16, 0), (128, 0), (512, 0), (1, 0),
                                   (1, 127), (1, 1500)])
def test_attention_kv16_kernels_match_plain(card, T, pos, kv):
    """K3 and K4 over an f16 or f32 cache at TinyLlama's heads and max_ctx
    2048, the values rounded to bf16 as a tile is staged."""
    rows = [pos] if T > 1 else [pos, pos // 2]
    cache = _float_kv(_cache(len(rows), 4, 2048, [p + T for p in rows],
                             seed=T + pos, device=card), kv)
    q = torch.randn(len(rows), T, 32, 64, device=card).to(torch.bfloat16)
    layer, p = _i32([1], card), _i32(rows, card)
    fn, name = ((flash_attention.flash_decode_heads_attention, "flash_decode_heads")
                if T == 1 else (flash_attention.flash_prefill_attention,
                                "flash_prefill"))
    got = _counted(flash_attention, f"{name}_{kv}", lambda: fn(q, cache, layer, p))
    want = flash_attention.attention_ref(q, cache, layer, p)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _attn_out_kv_inputs(device, pos, kv, seed=0):
    """K8's operands at TinyLlama's widths over an f16 or f32 cache, q8 wo."""
    q, cache, res, wo = _attn_out_i8_inputs(device, pos, seed)
    return q, _float_kv(_cache(1, 4, 2048, [pos + 1], seed=seed, device=device),
                        kv), res, wo


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("pos", [0, 127, 1500])
def test_fused_attn_out_kv16_matches_plain(card, pos, kv):
    q, cache, res, wo = _attn_out_kv_inputs(card, pos, kv, seed=pos)
    layer, p = _i32([1], card), _i32([pos], card)
    got = _counted(attn_out_fused, f"fused_attn_out_{kv}",
                   lambda: attn_out_fused.fused_attn_out(q, cache, layer, p, res, wo))
    want = attn_out_fused.fused_attn_out_ref(q, cache, layer, p, res, wo)
    torch.cuda.synchronize()
    assert got.shape == res.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _serving_kv_inputs(B, base, seed, device, kv):
    """_serving_inputs at TinyLlama's heads, every plane in f16 or f32."""
    q, pos, pool, st_dense, st_paged = _serving_inputs(B, 8, base, seed, device,
                                                       Kh=4)
    pool, dense = _float_kv(pool, kv), _float_kv(st_dense.pool, kv)
    tail = _float_kv(KVCache(st_dense.sk, st_dense.sv), kv)
    sk, sv = tail.k, tail.v
    return (q, pos, pool, StagedKVCache(dense, sk, sv, st_dense.base),
            StagedKVCache(pool, sk, sv, st_paged.base))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("base", [0, SERVE_P - 1, SERVE_P, 1500])
def test_serving_attention_kv16_kernels_match_plain(card, base, B, kv):
    """K9 and K11 over an f16 or f32 pool and tail, K10 at pos = base."""
    q, pos, pool, st_dense, st_paged = _serving_kv_inputs(B, base, base + B, card,
                                                          kv)
    layer = _i32([1], card)
    cases = [
        (f"flash_staged_{kv}", flash_attention,
         lambda: flash_attention.flash_staged_attention(q, st_dense, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_dense, layer, pos)),
        (f"flash_paged_staged_{kv}", flash_paged,
         lambda: flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_paged, layer, pos)),
        (f"flash_paged_{kv}", flash_paged,
         lambda: flash_paged.flash_paged_attention(q, pool, layer, st_paged.base),
         lambda: flash_paged.paged_attention_ref(q, pool, layer, st_paged.base)),
    ]
    for name, mod, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.cuda
def test_aq8_and_kv16_kernels_replay_in_a_graph(card):
    """K1-aq8 (q8 and q4, M = 1 and 4), K8 over an f16 cache and K11 over
    an f32 pool captured in one CUDA graph and replayed 3 times give the
    eager result every time."""
    xs = [torch.randn(M, 2048, device=card).to(torch.bfloat16) for M in (1, 4)]
    ws = [_tl_weight(kind, "wqkv", card) for kind in ("q8", "q4")]
    q8_, cache8, res8, wo8 = _attn_out_kv_inputs(card, 700, "f16", seed=3)
    q, pos, _, _, st_paged = _serving_kv_inputs(32, 700, 11, card, "f32")
    layer, p8 = _i32([1], card), _i32([700], card)

    def run():
        outs = [qmatmul.qmatmul(x, w, layer=layer, aq8=True) for x in xs for w in ws]
        return outs + [
            attn_out_fused.fused_attn_out(q8_, cache8, layer, p8, res8, wo8),
            flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos)]

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.cuda
def test_kv16_wrappers_refuse_on_the_card(card):
    """Planes of two dtypes, and scales beside an f16 cache, are refused
    before a launch."""
    q, cache, res, wo = _attn_out_kv_inputs(card, 5, "f16")
    layer, p = _i32([0], card), _i32([5], card)
    scale = torch.ones(cache.k.shape[:-1], device=card)
    bad = {"two dtypes": KVCache(cache.k, cache.v.float()),
           "scales with f16": KVCache(cache.k, cache.v, scale, scale)}
    for name, c in bad.items():
        with pytest.raises(TypeError):
            flash_attention.flash_decode_heads_attention(q, c, layer, p)
        with pytest.raises(TypeError):
            attn_out_fused.fused_attn_out(q, c, layer, p, res, wo)


# --- the split-key decode attention (K4, K10) ---------------------------------


def _split_inputs(B, G, kv, seed, device):
    """K4's and K10's operands at TinyLlama's kv heads (4) and max_ctx
    2048, every key random: q [B, 1, 4 G, 64]; a monolithic cache and a
    page pool (256-key pages under a shuffled table) of the same values,
    in the KV kind `kv`."""
    g = torch.Generator().manual_seed(seed)
    J = SERVE_S // SERVE_P
    dense = _cache(B, 4, SERVE_S, [SERVE_S] * B, seed=seed, device=device)
    # row b's logical page j is physical page table[b, j] of the pool
    table = 1 + torch.randperm(B * J, generator=g).reshape(B, J)
    pool_k = torch.zeros((2, 1 + B * J, 4, SERVE_P, 64), dtype=torch.bfloat16,
                         device=device)
    pool_v = torch.zeros_like(pool_k)
    for b in range(B):
        for j in range(J):
            keys = slice(j * SERVE_P, (j + 1) * SERVE_P)
            pool_k[:, table[b, j]] = dense.k[:, b, :, keys]
            pool_v[:, table[b, j]] = dense.v[:, b, :, keys]
    pool = PagedKVCache(pool_k, pool_v, table.to(device, torch.int32))
    if kv == "i8":
        dense, pool = _i8(dense), _i8(pool)
    elif kv != "bf16":
        dense, pool = _float_kv(dense, kv), _float_kv(pool, kv)
    q = torch.randn(B, 1, 4 * G, 64, generator=g).to(device, torch.bfloat16)
    return q, dense, pool


#: positions of the split kernels' card tests: both sides of the first
#: tile, deep in the context and the last key of a 2,048-key cache; at
#: B = 4 every row at its own position
SPLIT_POS = {1: [[0], [63], [64], [1500], [2047]],
             4: [[0, 63, 64, 1500], [2047, 1500, 64, 0]]}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("B", [1, 4])
def test_split_decode_kernels_match_plain(card, B, G, kv):
    """K4 over the monolithic cache and K10 over the page pool, the key
    walk split across blocks: each against its plain version at every
    position of SPLIT_POS, one launch counted a call."""
    q, dense, pool = _split_inputs(B, G, kv, seed=B * 10 + G, device=card)
    layer = _i32([1], card)
    sfx = "" if kv == "bf16" else f"_{kv}"
    for rows in SPLIT_POS[B]:
        p = _i32(rows, card)
        cases = [
            (flash_attention, "flash_decode_heads",
             lambda: flash_attention.flash_decode_heads_attention(q, dense,
                                                                  layer, p),
             lambda: flash_attention.attention_ref(q, dense, layer, p)),
            (flash_paged, "flash_paged",
             lambda: flash_paged.flash_paged_attention(q, pool, layer, p),
             lambda: flash_paged.paged_attention_ref(q, pool, layer, p)),
        ]
        for mod, name, kernel, plain in cases:
            got = _counted(mod, name + sfx, kernel)
            want = plain()
            torch.cuda.synchronize()
            assert got.shape == q.shape and got.dtype == torch.bfloat16, name
            torch.testing.assert_close(got.float(), want.float(), **TOL,
                                       msg=f"{name} at {rows}")


# --- the split-key staged attention (K9, K11) --------------------------------


def _staged_split_inputs(B, G, kv, Cs, bases, seed, device, Kh=2, L=2,
                         poison=None):
    """K9's and K11's operands at max_ctx 2048 in the KV kind `kv`: q [B,
    1, G Kh, 64]; a monolithic cache and a page pool (256-key pages under
    a shuffled table) of the same values; a staged tail of Cs slots; the
    chunk bases `bases` on the device. Values N(0, 1); int8 ones uniform
    with scales uniform in [0.005, 0.025). With `poison`, a (cache keys,
    tail slots) pair a row, every key past those of the cache and of the
    tail is NaN (int8: its scales), the rest as without it."""
    g = torch.Generator().manual_seed(seed)
    J = SERVE_S // SERVE_P

    def planes(shape):  # k, v and their scales (None but int8), on the CPU
        if kv == "i8":
            data = [torch.randint(-127, 128, shape, generator=g,
                                  dtype=torch.int8) for _ in range(2)]
            return data + [torch.rand(shape[:-1], generator=g) * 0.02 + 0.005
                           for _ in range(2)]
        dt = {"bf16": torch.bfloat16, "f16": torch.float16,
              "f32": torch.float32}[kv]
        return [torch.randn(shape, generator=g).to(dt) for _ in range(2)] + [
            None, None]

    def spoil(xs, keep):  # NaN past keep[b] keys of row b, in place
        for x in xs[2:] if kv == "i8" else xs[:2]:
            for b, n in enumerate(keep):
                x[:, b, :, n:] = float("nan")

    dense = planes((L, B, Kh, SERVE_S, 64))
    tail = planes((L, B, Kh, Cs, 64))
    if poison is not None:
        spoil(dense, [n for n, _ in poison])
        spoil(tail, [n for _, n in poison])
    # row b's logical page j is physical page table[b, j] of the pool
    table = 1 + torch.randperm(B * J, generator=g).reshape(B, J)
    pool = []
    for x in dense:
        if x is None:
            pool.append(None)
            continue
        y = torch.zeros((L, 1 + B * J) + x.shape[2:3] + (SERVE_P,) + x.shape[4:],
                        dtype=x.dtype)
        for b in range(B):
            for j in range(J):
                y[:, table[b, j]] = x[:, b, :, j * SERVE_P:(j + 1) * SERVE_P]
        pool.append(y)
    on = [None if x is None else x.to(device) for x in dense + pool + tail]
    k, v, ks, vs, pk, pv, pks, pvs, sk, sv, sks, svs = on
    base = _i32(bases, device)
    cache = KVCache(k, v, ks, vs)
    paged = PagedKVCache(pk, pv, table.to(device, torch.int32), pks, pvs)
    q = torch.randn(B, 1, G * Kh, 64, generator=g).to(device, torch.bfloat16)
    return (q, StagedKVCache(cache, sk, sv, base, sk_scale=sks, sv_scale=svs),
            StagedKVCache(paged, sk, sv, base, sk_scale=sks, sv_scale=svs))


def _staged_rows(Cs):
    """(chunk base, tail fill) of the 8 rows of the staged split tests:
    bases on both sides of a tile and a page and deep in the context,
    fills of 1 slot, 31, 32 and the whole tail."""
    return [(0, 1), (1, 1), (63, 31), (64, 32), (65, Cs), (255, Cs), (256, 1),
            (1500, Cs)]


def _staged_cases(q, st_dense, st_paged, layer, pos):
    return [
        (flash_attention, "flash_staged",
         lambda: flash_attention.flash_staged_attention(q, st_dense, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_dense, layer, pos)),
        (flash_paged, "flash_paged_staged",
         lambda: flash_paged.flash_paged_staged_attention(q, st_paged, layer,
                                                          pos),
         lambda: flash_paged.staged_attention_ref(q, st_paged, layer, pos)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("Cs", [32, 64, 96])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
def test_staged_split_kernels_match_plain(card, kv, G, Cs):
    """K9 over the monolithic cache and K11 over the page pool, the key
    walk over pool tiles then tail tiles split across blocks: ragged bases
    and tail fills across 8 rows (a 1-slot tail among them), tails of 32,
    64 and 96 slots, each against its plain version, one launch counted a
    call."""
    rows = _staged_rows(Cs)
    q, st_dense, st_paged = _staged_split_inputs(
        len(rows), G, kv, Cs, [b for b, _ in rows], seed=G * 100 + Cs,
        device=card)
    layer = _i32([1], card)
    pos = _i32([b + f - 1 for b, f in rows], card)
    sfx = "" if kv == "bf16" else f"_{kv}"
    for mod, name, kernel, plain in _staged_cases(q, st_dense, st_paged, layer,
                                                  pos):
        got = _counted(mod, name + sfx, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL,
                                   msg=f"{name} {kv} G={G} Cs={Cs}")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
def test_staged_split_empty_row_gives_zeros(card, kv):
    """A row with no visible key (base 0, pos -1) beside ragged rows: K9
    and K11 write zeros there (JAX's denominator of 1) and match the
    plain version on the other rows."""
    bases, pos = [65, 0, 1500, 0], [96, -1, 1500, 31]
    q, st_dense, st_paged = _staged_split_inputs(4, 8, kv, 32, bases, seed=7,
                                                 device=card)
    layer = _i32([1], card)
    p = _i32(pos, card)
    for _, name, kernel, plain in _staged_cases(q, st_dense, st_paged, layer, p):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        assert torch.equal(got[1], torch.zeros_like(got[1])), name
        keep = [0, 2, 3]
        torch.testing.assert_close(got[keep].float(), want[keep].float(), **TOL,
                                   msg=f"{name} {kv}")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
def test_split_kernels_read_only_visible_keys(card, kv):
    """K4, K10, K9 and K11 over caches and tails whose every key past a
    row's visible ones is NaN (int8: its scales), as a page not yet
    written or a cache from torch.empty may hold: each output equals the
    same kernel's over the clean operands bit for bit (a tile copies only
    its visible keys and zero-fills the rest of its stage). K4 and K10
    attend the keys below each chunk base, K9 and K11 those and the tail's
    first slots."""
    rows = [(65, 1), (1, 32), (1500, 17), (256, 96), (63, 50)]
    bases = [b for b, _ in rows]
    layer = _i32([1], card)
    pos = _i32([b + f - 1 for b, f in rows], card)
    below = _i32([b - 1 for b in bases], card)
    outs = []
    for poison in (None, rows):
        q, st_d, st_p = _staged_split_inputs(len(rows), 8, kv, 96, bases,
                                             seed=21, device=card,
                                             poison=poison)
        outs.append([
            flash_attention.flash_decode_heads_attention(q, st_d.pool, layer,
                                                         below),
            flash_paged.flash_paged_attention(q, st_p.pool, layer, below),
            flash_attention.flash_staged_attention(q, st_d, layer, pos),
            flash_paged.flash_paged_staged_attention(q, st_p, layer, pos)])
    torch.cuda.synchronize()
    for name, clean, spoiled in zip(("K4", "K10", "K9", "K11"), *outs):
        assert torch.isfinite(clean.float()).all(), name
        assert torch.equal(spoiled, clean), f"{name} {kv}"


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["q8a8", "q4a8", "q8-kvf16", "q8-kvf32"])
def test_engine_aq8_and_kv16_on_the_card_matches_cpu(card, policy, monkeypatch):
    """A small model with aq8 activations, or an f16 or f32 cache, through
    the kernels and the plain path: a long prefill (K2), a staged B = 3
    chunk and a B = 1 chunk (q8a8: the same greedy tokens but at a
    near-tie, _card_and_cpu_traces); the logits agree to 5% of their
    largest magnitude."""
    cfg = tiny_test_config(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512,
                           max_ctx=256)
    kv = policy.split("kv")[-1] if "kv" in policy else None
    pol = (POLICIES[policy] if kv is None else
           dataclasses.replace(POLICIES["q8"], kv_dtype=kv))
    params = llama.init_quantized_params(cfg, pol, torch.Generator().manual_seed(0))
    ties = monkeypatch if policy in NEAR_TIE else None
    for a, b in zip(*_card_and_cpu_traces(cfg, pol, params, card, False, ties,
                                          NEAR_TIE.get(policy, 0.0))):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


# --- the kernel microbench (probes, flash ablations, i4, q4 sweep) -----------------


def _kb_small_sweep(card, M=8, K=1024, N=256, idx=9):
    from tinyllama_tpu_torch.tools import kbench

    return kbench.sweep_operands(idx, K, N, M, card)


def _kb_sweep_case(card, var, name, M, K, N, bn=0, bk=0):
    """The sweep kernel of `var` against its plain version on port-made
    operands (tiled for -t), max |err| <= 1e-4 max |plain|."""
    from tinyllama_tpu_torch.ops.kernels import kbench_sweep as ks

    x, data, scales, _ = _kb_small_sweep(card, M, K, N, idx=len(name))
    bn = bn or ks.pick_bn(N)
    bk = bk or ks.pick_bk(K, bn)
    base, tiled, _, _ = ks.parse_variant(var)
    if tiled:
        data, scales = ks.tile(data, bn), ks.tile(scales, bn)
    before = ks.launches[f"kbench_sweep_{base}"]
    got = ks.sweep(x, data, scales, var, bn, bk)
    assert ks.launches[f"kbench_sweep_{base}"] == before + 1
    want = ks.sweep_ref(x, data, scales, var, bn, bk)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all() and err <= 1e-4 * float(want.abs().max()), err


KB_SWEEP_ALL = ("cur", "i8shift", "i16shift", "ilp4", "tree", "fullunpack", "dq",
                "corrdot", "corrdotnm", "dot3", "dotsraw", "unpackonly", "biasand",
                "nosum", "noand", "dotsonly", "g128", "g128d2", "g256", "g256presum",
                "g256dots", "g256fma1", "dqbias", "overlap", "stream", "manual")


@pytest.mark.cuda
@pytest.mark.parametrize("var", KB_SWEEP_ALL)
def test_kbench_sweep_small_matches_plain(card, var):
    """Every sweep variant at K = 1024, N = 256 in two K steps of 512."""
    _kb_sweep_case(card, var, "small", 8, 1024, 256, 256, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("var", KB_SWEEP_ALL)
def test_kbench_sweep_wqkv_matches_plain(card, var):
    """Every sweep variant at wqkv's full width, the JAX tiles (1280, 1024)."""
    _kb_sweep_case(card, var, "wqkv", 8, 2048, 2560)


@pytest.mark.cuda
@pytest.mark.parametrize("var,name,M,K,N,bn,bk", [
    ("cur-t", "wqkv", 8, 2048, 2560, 0, 0),
    ("cur-x", "wqkv", 8, 2048, 2560, 0, 0),
    ("cur-t-x", "wo", 8, 2048, 2048, 0, 256),
    ("cur-x-v", "w_down", 8, 5632, 2048, 0, 0),
    ("manual", "w_down", 8, 5632, 2048, 0, 0),
    ("manual", "w_gateup", 3, 2048, 11264, 0, 0),
    ("cur", "lm_head", 8, 2048, 32003, 0, 0),
    ("dq", "lm_head", 8, 2048, 32003, 0, 0),
    ("stream", "lm_head", 8, 2048, 32003, 0, 0),
    ("cur", "ragged", 1, 512, 200, 0, 0),
    ("g256", "ragged", 5, 512, 200, 0, 256),
    ("cur", "wo", 3, 2048, 2048, 512, 512),
])
def test_kbench_sweep_flags_and_shapes_match_plain(card, var, name, M, K, N, bn, bk):
    """The -t / -x / -v flags, manual at two shapes, the ragged lm_head and
    a ragged small N, M below 8, other tiles."""
    _kb_sweep_case(card, var, name, M, K, N, bn, bk)


@pytest.mark.cuda
def test_kbench_sweep_refuses_on_the_card(card):
    from tinyllama_tpu_torch.ops.kernels import kbench_sweep as ks

    x, data, scales, _ = _kb_small_sweep(card, K=5632, N=256)
    with pytest.raises(ValueError, match="-v"):
        ks.sweep(x, data, scales, "cur-x", 256, 512)
    with pytest.raises(ValueError, match="M = 8"):
        ks.sweep(x[:4].contiguous(), data, scales, "unpackonly", 256, 512)
    with pytest.raises(TypeError):
        ks.sweep(x.float(), data, scales, "cur", 256, 512)
    with pytest.raises(ValueError, match="bk"):
        ks.sweep(x, data, scales, "cur", 256, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 2048])
@pytest.mark.parametrize("var", ["full", "noexp", "nomask", "nomax", "nosum", "dots",
                                 "stream", "flipT", "flipTtr", "flipTnoscale",
                                 "flipTpre"])
def test_kbench_flash_matches_plain(card, var, T):
    """Every flash ablation at T = 1024 (two key tiles) and 2048, held as
    the microbench holds it (noexp: where both are finite, and finite or
    overflowing on both sides wherever the order of the sums cannot
    change it)."""
    from tinyllama_tpu_torch.ops.kernels import kbench_flash as kf
    from tinyllama_tpu_torch.tools import kbench

    case = next(c for c in kbench.flash_cases(
        kbench.parse(["--bench", "flash", "--m", str(T), "--variants", var]), card))
    before = kf.launches[f"kbench_flash_{var}"]
    kbench.check_case(case)
    assert kf.launches[f"kbench_flash_{var}"] == before + 1


@pytest.mark.cuda
def test_kbench_flash_at_a_later_position(card):
    """pos > 0 and B = 2: the frontier moves with each row's position."""
    from tinyllama_tpu_torch.ops.kernels import kbench_flash as kf

    g = torch.Generator(card).manual_seed(3)
    B, Kh, T, S = 2, 2, 512, 1536
    q = (torch.randn((B, Kh, T * 8, 64), generator=g, device=card) * 0.3).to(torch.bfloat16)
    k = torch.randint(-127, 127, (B, Kh, S, 64), generator=g, device=card).to(torch.int8)
    v = torch.randint(-127, 127, (B, Kh, S, 64), generator=g, device=card).to(torch.int8)
    sk = torch.rand((B, Kh, S), generator=g, device=card) * 0.02 + 0.001
    sv = torch.rand((B, Kh, S), generator=g, device=card) * 0.02 + 0.001
    pos = _i32([300, 1000], card)
    for var in ("full", "flipT", "nomask"):
        got = kf.flash(q, k, v, sk, sv, pos, var)
        want = kf.flash_ref(q, k, v, sk, sv, pos, var)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["blockdot", "tiledeq"])
@pytest.mark.parametrize("M,K,N", [(8, 256, 98), (1, 512, 64), (5, 768, 2),
                                   (8, 2048, 2560), (8, 2048, 2048), (8, 2048, 11264),
                                   (8, 5632, 2048), (8, 2048, 32004)])
def test_kbench_i4_matches_plain(card, body, M, K, N):
    from tinyllama_tpu_torch.ops.kernels import kbench_i4 as ki
    from tinyllama_tpu_torch.tools import kbench

    x, packed, s, _ = kbench._i4_operands(N, K, N, M, card)
    before = ki.launches[f"kbench_i4_{body}"]
    got = ki.i4_matmul(x, packed, s, body)
    assert ki.launches[f"kbench_i4_{body}"] == before + 1
    want = ki.i4_ref(x, packed, s, body)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (64, 32), (3, 512)])
def test_kbench_probes_match_plain_exactly(card, shape):
    """The four probes, exact, at the JAX probes' shapes and others."""
    from tinyllama_tpu_torch.ops.kernels import kbench_i4 as ki
    from tinyllama_tpu_torch.ops.kernels import kbench_probe as kp

    R, C = shape
    g = torch.Generator(card).manual_seed(R)
    vals = torch.randint(-8, 8, (R, 2 * C), generator=g, device=card)
    if C % 8 == 0:
        packed = ki.pack_nibbles(vals)
        assert torch.equal(kp.int4(packed), kp.int4_ref(packed))
        assert torch.equal(kp.int4(packed).float(), 2.0 * vals.float())
    w8 = torch.randint(-128, 128, (4 * R, C), generator=g, device=card).to(torch.int8)
    assert torch.equal(kp.bitcast(w8), kp.bitcast_ref(w8))
    M, K, N = min(R, 16), 512, 8 * C
    x = torch.randint(-128, 128, (M, K), generator=g, device=card).to(torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=card).to(torch.int8)
    before = dict(kp.launches)
    assert torch.equal(kp.i32dot(x, w), kp.dot_ref(x, w))
    assert torch.equal(kp.i8dot(x, w), kp.dot_ref(x, w))
    assert kp.launches["kbench_probe_i8dot"] == before["kbench_probe_i8dot"] + 1


@pytest.mark.cuda
def test_kbench_kernels_replay_in_a_graph(card):
    """A flash ablation and a sweep variant captured in a CUDA graph give
    their eager result again."""
    from tinyllama_tpu_torch.ops.kernels import kbench_flash as kf
    from tinyllama_tpu_torch.ops.kernels import kbench_sweep as ks
    from tinyllama_tpu_torch.tools import kbench

    q, k, v, sk, sv, pos = kbench._flash_operands(1024, card)
    x, data, scales, _ = _kb_small_sweep(card, K=2048, N=2560)
    for name, fn in (("flash full", lambda: kf.flash(q, k, v, sk, sv, pos, "full")),
                     ("sweep manual", lambda: ks.sweep(x, data, scales, "manual",
                                                        1280, 1024)),
                     ("sweep cur", lambda: ks.sweep(x, data, scales, "cur", 1280, 1024))):
        eager = fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), name


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["--bench", "probe"],
    ["--bench", "flash", "--m", "1024", "--variants", "full,stream,flipTpre"],
    ["--bench", "i4", "--shape", "wo"],
    ["--bench", "sweep", "--shape", "wqkv", "--variants", "cur,dq,manual,cur-t"],
    ["--bench", "qmatmul", "--shape", "wo", "--kind", "q8"],
])
def test_kbench_cli_on_the_card(card, argv, capsys):
    """The microbench's entry point checks and times on the card: each
    kernel held against its plain version (one launch) before its timed
    calls, each line a time over its bound, never under it."""
    from tinyllama_tpu_torch.tools import kbench

    rows = kbench.run(kbench.parse(argv + ["--iters", "5"]))
    assert rows and all(r["ms"] > 0 and r["ms"] >= r["bound_ms"] for r in rows)
    assert all(r["max_abs_err"] >= 0 and r["plain_ms"] > 0 for r in rows)
    assert "x bound" in capsys.readouterr().out


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


def _bad_serving_inputs():
    q, pos, pool, st_dense, st_paged = _serving_inputs(2, 4, 10, seed=2)
    return {
        "f32 queries": (q.float(), pool, st_paged, pos, TypeError),
        "CPU tensors": (q, pool, st_paged, pos, ValueError),
        "two tokens": (torch.cat([q, q], 1), pool, st_paged, pos, ValueError),
        "row mismatch": (q[:1], pool, st_paged, pos[:1], ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_serving_inputs()))
def test_serving_checks_refuse(case):
    """What K10 and K11 do not take is refused before a launch."""
    q, pool, st, pos, exc = _bad_serving_inputs()[case]
    li = _i32([0])
    with pytest.raises(exc):
        flash_paged._check_paged(q, pool, li, pos)
    with pytest.raises(exc):
        flash_paged._check_paged(q, pool, li, pos, st)


# --- the prefill kernels redesigned for Hopper: K2 and K3 on wgmma ---------

PREFILL_M = [9, 33, 128, 200, 512, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", PREFILL_M)
@pytest.mark.parametrize("name", ["wqkv", "wo", "w_gateup", "w_down"])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_prefill_qmatmul_matches_plain(card, kind, name, M, out_dtype):
    """K2 at TinyLlama's four layer shapes, ragged M (9, 33, 200) and the
    split K walk (M <= 256), layer 1 of a stacked weight: one launch,
    against its plain version."""
    w = _tl_weight(kind, name, card)
    K = TINYLLAMA_SHAPES[name][0]
    x = torch.randn(M, K, device=card).to(torch.bfloat16)
    layer = _i32([1], card)
    got = _counted(qmatmul, "qmm_bigm",
                   lambda: qmatmul.qmatmul(x, w, out_dtype, layer))
    want = qmatmul.qmatmul_ref(x, w, out_dtype, layer)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(40, 256, 300), (33, 2048, 72), (2048, 256, 1064)])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_prefill_qmatmul_ragged_n_matches_plain(card, kind, M, K, N, out_dtype):
    """K2 with N % 16 != 0 (the weight loaded a value at a time), its K
    walk split (M = 40; M = 33 one tile in a cluster of the most splits)
    or not (M = 2048)."""
    g = torch.Generator(card).manual_seed(M + N)
    w = quantize(torch.randn((2, N, K), generator=g, device=card) * 0.02, kind, "kn")
    x = torch.randn(M, K, device=card).to(torch.bfloat16)
    layer = _i32([1], card)
    got = _counted(qmatmul, "qmm_bigm",
                   lambda: qmatmul.qmatmul(x, w, out_dtype, layer))
    want = qmatmul.qmatmul_ref(x, w, out_dtype, layer)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _prefill_inputs(kv, T, B, G, device, seed, Kh=2, L=2):
    """q [B, T, Kh G, 64] at unequal positions pos[b] (B = 4: 0, 70, 3,
    131, cut to the cache), the cache's history [0, pos[b] + T) random in
    the KV kind `kv`; S = T + 192 rounded up to 64."""
    S = -(-(T + 192) // 64) * 64
    pos = [0] if B == 1 else [0, 70, 3, 131][:B]
    cache = _cache(B, Kh, S, [p + T for p in pos], seed=seed, device=device, L=L)
    if kv == "i8":
        cache = _i8(cache)
    elif kv != "bf16":
        cache = _float_kv(cache, kv)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, T, Kh * G, 64, generator=g).to(device, torch.bfloat16)
    return q, cache, _i32(pos, device)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T", [12, 128, 200, 512, 2048])
def test_prefill_attention_matches_plain(card, T, B, G, kv):
    """K3 over every KV kind: T new tokens a row at their own positions,
    partial last row blocks (T G % 64 != 0 at T = 12, 200 with G = 4),
    diagonal tiles at pos % 64 != 0; one launch, against its plain
    version."""
    q, cache, pos = _prefill_inputs(kv, T, B, G, card, seed=T + B + G)
    layer = _i32([1], card)
    sfx = "" if kv == "bf16" else f"_{kv}"
    got = _counted(flash_attention, "flash_prefill" + sfx,
                   lambda: flash_attention.flash_prefill_attention(q, cache, layer, pos))
    want = flash_attention.attention_ref(q, cache, layer, pos)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_prefill_kernels_replay_in_a_graph(card):
    """K2 (split K at M = 128 and 512, each tile's splits one cluster; one
    split at M = 2048) and K3 (bf16 and int8 caches) captured in a CUDA
    graph at layer 0 and replayed with the layer index written to 1 give
    what eager calls at layer 1 give, three replays in a row."""
    layer = _i32([0], card)
    w = _tl_weight("q8", "wo", card)
    xs = {M: torch.randn(M, 2048, device=card).to(torch.bfloat16)
          for M in (128, 512, 2048)}
    calls = {f"K2 M={M}": (lambda x=x: qmatmul.qmatmul(x, w, torch.bfloat16, layer))
             for M, x in xs.items()}
    for kv in ("bf16", "i8"):
        q, cache, pos = _prefill_inputs(kv, 200, 4, 8, card, seed=5)
        calls[f"K3 {kv}"] = (lambda q=q, c=cache, p=pos:
                             flash_attention.flash_prefill_attention(q, c, layer, p))
    for name, fn in calls.items():
        layer.fill_(0)
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn()
        layer.fill_(1)
        want = fn()
        for _ in range(3):
            out.zero_()
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want), name


# --- K1 and K6 on the fused walk ----------------------------------------------------

#: K1 where the walk meets K1's own shape rules: K past the fused kernels'
#: 8,192 rows (Llama-3-8B's w_down 14,336, 70B's 28,672; a split's x
#: slice of 1,792 and 3,584 rows) and N = 32,004 (4-column groups, rows
#: not 16-byte aligned), stacked and unstacked: (K, N, stacked)
SMALLM_EDGES = {"K=14336": (14336, 4096, True), "K=28672": (28672, 1024, False),
                "N=32004": (2048, 32004, False)}
_edge_weights: dict = {}


def _edge_weight(kind, name, device):
    key = (kind, name)
    if key not in _edge_weights:
        K, N, stacked = SMALLM_EDGES[name]
        g = torch.Generator(device).manual_seed(100 + len(_edge_weights))
        shape = (2, N, K) if stacked else (N, K)
        _edge_weights[key] = quantize(torch.randn(shape, generator=g, device=device)
                                      * 0.02, kind, "kn")
    return _edge_weights[key]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("name", list(SMALLM_EDGES))
@pytest.mark.parametrize("kind,aq8", [("q8", False), ("q4", False), ("q4g", False),
                                      ("q8", True), ("q4", True)])
def test_smallm_walk_edges_match_plain(card, kind, aq8, name, M, out_dtype):
    """K1 (and its aq8 branch) on the walk at long K, at N = 32,004 and on
    an unstacked weight, in f32 and bf16 out, against its plain version."""
    K, N, stacked = SMALLM_EDGES[name]
    w = _edge_weight(kind, name, card)
    layer = _i32([1], card) if stacked else None
    x = torch.randn(M, K, device=card).to(torch.bfloat16)
    counter = "qmm_smallm_aq8" if aq8 else "qmm_smallm"
    got = _counted(qmatmul, counter,
                   lambda: qmatmul.qmatmul(x, w, out_dtype, layer, aq8=aq8))
    want = qmatmul.qmatmul_ref(x, w, out_dtype, layer, aq8=aq8)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("aq8", [False, True])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_smallm_and_out_residual_plans_are_resident(card, kind, aq8):
    """The card's answer for K1's launches at TinyLlama's five shapes, the
    unpadded lm_head (N = 32,004: the 4-column copies' kernel, asked of
    its own residency) and Llama-3-70B's w_down, and for K6's at M = 4
    and 32: at TinyLlama's shapes K1's plan gives every SM a block but
    n_sm / 32 with every cluster resident at once (w_down 16 tiles of 128
    x 8 splits, the lm_head 256 tiles of 128 unsplit); 70B's w_down (64
    tiles of 128 x 8 splits of 3,584-row slices) runs in waves; K6's plan
    is one wave."""
    if aq8 and kind == "q4g":
        pytest.skip("q4g has no aq8 branch")
    n_sm, code = qmatmul.sm_count(card), qmatmul.KIND_CODE[kind]
    lib = qmatmul._lib()

    def held(K, N, width, splits):  # blocks the card keeps at once
        clusters = ctypes.c_int(0)
        build.check(lib.qmm_smallm_resident(code, 1, K, N, width, splits, int(aq8),
                                            ctypes.byref(clusters)), "K1")
        return clusters.value * splits

    shapes = dict(TINYLLAMA_SHAPES, **{"lm_head N=32004": (2048, 32004),
                                       "70b w_down": (28672, 8192)})
    for name, (K, N) in shapes.items():
        width, splits = qmatmul.smallm_plan(code, 1, K, N, aq8, n_sm)
        blocks = -(-N // width) * splits
        if name == "70b w_down":  # 64 x 8 blocks of 3,584-row slices: waves
            assert (width, splits) == (128, 8) and blocks > held(K, N, width, splits)
        else:
            assert n_sm - n_sm // 32 <= blocks <= held(K, N, width, splits), \
                (name, width, splits)
        if name in ("w_down", "lm_head"):
            assert (width, splits) == ((128, 8) if name == "w_down" else (128, 1))
    if aq8:
        return
    for M in (4, 32):
        width, splits = decode_fused.plan(code, M, 2048, 2048, n_sm, "fused_out_residual")
        clusters = ctypes.c_int(0)
        build.check(decode_fused._lib().fused_out_residual_resident(
            code, M, 2048, width, splits, ctypes.byref(clusters)), "K6")
        assert -(-2048 // width) * splits <= clusters.value * splits


@pytest.mark.cuda
def test_smallm_and_out_residual_replay_in_a_graph(card):
    """K1 (layer-stacked q8 at M = 1 and 4, aq8 in q8 and q4 at M = 1, the
    unstacked lm_head with f32 logits: a cluster launch inside the step's
    graph) and K6 (M = 4 and 32, q8 and q4) captured in one CUDA graph at
    layer 0 and replayed 3 times with the layer index written to 1 give
    the eager result at layer 1 bit for bit."""
    layer = _i32([0], card)
    xs = {M: torch.randn(M, 2048, device=card).to(torch.bfloat16) for M in (1, 4, 32)}
    res = {M: torch.randn(M, 1, 2048, device=card).to(torch.bfloat16) for M in (4, 32)}
    lm = _tl_weight("q8", "lm_head", card)

    def run():
        outs = [qmatmul.qmatmul(xs[M], _tl_weight("q8", "wqkv", card), layer=layer)
                for M in (1, 4)]
        outs += [qmatmul.qmatmul(xs[1], _tl_weight(k, "wo", card), layer=layer, aq8=True)
                 for k in ("q8", "q4")]
        outs.append(qmatmul.qmatmul(xs[1], lm, torch.float32))
        outs += [decode_fused.fused_out_residual(xs[M].view(M, 1, 2048), res[M],
                                                 _tl_weight(k, "wo", card), layer)
                 for M in (4, 32) for k in ("q8", "q4")]
        return outs

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    layer.fill_(1)
    eager = run()
    torch.cuda.synchronize()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.cuda
def test_smallm_refusals_on_the_card(card):
    """K past K1's longest x slices raises before a launch; the library
    refuses a split count its walk does not take, and a half step above
    8 rows is K2's, not K1's, to refuse."""
    K = qmatmul.SMALLM_MAX_K + 64
    w = quantize(torch.zeros(64, K, device=card), "q8", "kn")
    with pytest.raises(ValueError, match="past"):
        qmatmul.qmatmul(torch.zeros(1, K, device=card, dtype=torch.bfloat16), w)
    wo = _tl_weight("q8", "wo", card)
    x = torch.randn(1, 2048, device=card).to(torch.bfloat16)
    out = torch.empty(1, 2048, dtype=torch.bfloat16, device=card)
    for width, splits in ((128, 0), (128, 9), (96, 2)):
        assert qmatmul._lib().qmm_smallm(
            x.data_ptr(), wo.data.data_ptr(), wo.scales.data_ptr(), None, out.data_ptr(),
            0, 0, 1, 2048, 2048, width, splits, build.stream_ptr(x)) == 1
    torch.cuda.synchronize()


# --- the dense policies on the card ---------------------------------------------

#: every kernel wrapper's launch counts
COUNTERS = (qmatmul.launches, flash_attention.launches, decode_fused.launches,
            ffn_fused.launches, attn_out_fused.launches, flash_paged.launches)
DENSE_CFG = tiny_test_config(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512)


def _zero_counts():
    for c in COUNTERS:
        for k in c:
            c[k] = 0


def _launched():
    return {k: v for c in COUNTERS for k, v in c.items() if v}


def _dense_traces(policy, device, params):
    """Logits of a prefill and two b1 decode steps, then of a staged
    2-step chunk at B = 2, over a monolithic and a paged engine."""
    out = []
    greedy = GenerationConfig(greedy=True, eos_token=-1)
    for paged in (False, True):
        eng = Engine(DENSE_CFG, policy, params, device=device, paged=paged)
        cache = eng.new_cache(1)
        logits, _ = eng.prefill(cache, [[1, 5, 9, 33, 70, 2, 8]])
        out.append(logits)
        p = _i32([7], eng.device)
        for t in (11, 12):
            out.append(eng.decode_step(cache, _i32([t], eng.device), p))
            p += 1
        cache = eng.new_cache(2)
        logits, lens = eng.prefill(cache, [[1, 4], [1, 6, 7]])
        out.append(eng.chunk(cache, logits, _i32(lens.tolist(), eng.device), 2,
                             greedy)[2])
    return [t.float().cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f16", "bf16", "f32"])
def test_dense_on_the_card_launches_no_kernel(card, name):
    """Dense weights run the plain ops on the card, as the JAX package runs
    them without Pallas: a prefill, b1 steps, a paged prefill and steps
    and a staged chunk launch no port kernel; the logits agree with the
    CPU's to 5% of their largest magnitude (bf16 activations) or 1e-4 of
    it (f32)."""
    policy = POLICIES[name]
    dense = llama.init_dense_params(DENSE_CFG, torch.Generator().manual_seed(0))
    params = llama.convert_params(dense, policy)
    _zero_counts()
    got = _dense_traces(policy, card, params)
    torch.cuda.synchronize()
    assert _launched() == {}
    want = _dense_traces(policy, "cpu", params)
    rel = 1e-4 if name == "f32" else 0.05
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())


def _engine_chunk(eng):
    cache = eng.new_cache(1)
    logits, _ = eng.prefill(cache, [[1, 5, 9, 33, 70, 2, 8]])
    return eng.chunk(cache, logits, _i32([7], eng.device), 2,
                     GenerationConfig(greedy=True, eos_token=-1))


@pytest.mark.cuda
def test_quantized_policy_still_launches_or_raises(card, monkeypatch):
    """A q8 engine on the card launches its kernels; with no kernel
    library to load, it raises rather than run a plain product."""
    params = llama.init_quantized_params(DENSE_CFG, POLICIES["q8"],
                                         torch.Generator().manual_seed(0))
    eng = Engine(DENSE_CFG, POLICIES["q8"], params, device=card)
    _zero_counts()
    _engine_chunk(eng)
    torch.cuda.synchronize()
    assert {"qmm_smallm", "fused_norm_qkv", "fused_attn_out",
            "ffn_fused_normed"} <= set(_launched())

    def no_library(name):
        raise RuntimeError(f"no library {name}")

    monkeypatch.setattr(build, "load", no_library)
    with pytest.raises(RuntimeError, match="no library"):
        _engine_chunk(eng)


@pytest.mark.cuda
def test_f32_dense_on_the_card_runs_without_tf32(card):
    """With TF32 allowed process-wide, the f32 dense product still runs at
    full precision (TF32 keeps ~10 mantissa bits: errors near 1e-3 of the
    scale) and leaves the setting as it found it."""
    from tinyllama_tpu_torch.ops.linear import linear, linear_f32_out

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 7, 2048, generator=g)
    w = torch.randn(2, 512, 2048, generator=g)
    want = (x.double() @ w[1].double().t())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = linear(x.to(card), w.to(card), 1)
        got32 = linear_f32_out(x.to(card), w[1].to(card))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    scale = float(want.abs().max())
    for t in (got, got32):
        assert t.dtype == torch.float32
        assert float((t.cpu().double() - want).abs().max()) <= 1e-5 * scale


# --- the decode chunk as a CUDA graph (runtime/graphs.py) ---------------------------

#: the graph tests' model: d_head 64, 4 query heads a kv head, max_ctx 256
GRAPH_CFG = dict(n_embd=256, n_heads=4, n_kv_heads=1, n_ffn=512, max_ctx=256)
_graph_params: dict = {}


def _graph_engine(card, policy, paged=False):
    """An Engine of the graph tests' model under `policy` (q8 weights, or
    dense f32 weights from a seed for a dense policy)."""
    cfg = tiny_test_config(**GRAPH_CFG)
    kind = "q8" if policy.is_quantized else "dense"
    if kind not in _graph_params:
        g = torch.Generator().manual_seed(0)
        _graph_params[kind] = (
            llama.init_quantized_params(cfg, POLICIES["q8"], g)
            if kind == "q8" else llama.init_dense_params(cfg, g))
    return Engine(cfg, policy, _graph_params[kind], device=card, paged=paged)


def _graph_prompts(B):
    return [[1] + [2 + (7 * b + 3 * i) % 200 for i in range(5 + (13 * b) % 40)]
            for b in range(B)]


def _graph_against_eager(eng, B, gen, chunks=(8, 8, 4), seed=None):
    """Chained chunks of `chunks` steps from one prefill: Engine.chunk
    eagerly over one cache, and run_chunk twice over another (its graphs
    captured in the first pass, every chunk of the second a replay over
    the re-prefilled cache), each pass's top-k generator seeded alike;
    tokens, done and logits must be torch.equal at every chunk."""
    prompts = _graph_prompts(B)

    def generator():
        return (None if seed is None
                else torch.Generator(eng.device).manual_seed(seed))

    def start(cache):
        logits, lens = eng.prefill(cache, prompts)
        return logits, torch.from_numpy(lens.astype(np.int32)).to(eng.device)

    eager, cache = [], eng.new_cache(B)
    logits, pos = start(cache)
    g = generator()
    for C in chunks:
        toks, done, logits, pos = eng.chunk(cache, logits, pos, C, gen, g)
        eager.append((toks.clone(), done.clone(), logits.clone()))
    store = eng.new_cache(B)
    g = generator()
    for _ in range(2):
        logits, pos = start(store)
        if g is not None:
            g.manual_seed(seed)
        for C, want in zip(chunks, eager):
            toks, done, logits, pos = eng.run_chunk(store, logits, pos, C, gen, g)
            for a, b in zip((toks, done, logits), want):
                assert torch.equal(a, b), (B, C)
    assert len(eng.chunk_graphs(store).graphs) == len(set(chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_graph_chunk_equals_eager_chunk(card, paged, kv, B):
    """Every cache kind (monolithic B = 1: K8; paged B = 1: K10; staged
    B = 4 and 32: K9 or K11; bf16, int8, f16, f32): the replayed chunk is
    the eager chunk, bit for bit, over chained chunks of 8, 8 and 4 steps
    and after the cache is prefilled again."""
    policy = dataclasses.replace(POLICIES["q8"], kv_dtype=kv)
    eng = _graph_engine(card, policy, paged)
    _graph_against_eager(eng, B, GenerationConfig(greedy=True, eos_token=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
@pytest.mark.parametrize("name", ["f16", "f32"])
def test_dense_graph_chunk_equals_eager_chunk(card, name, paged, B):
    """The dense weights' plain ops (no kernel) captured and replayed: the
    eager chunk's tokens and logits, bit for bit."""
    eng = _graph_engine(card, POLICIES[name], paged)
    _graph_against_eager(eng, B, GenerationConfig(greedy=True, eos_token=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_graph_topk_draws_equal_eager(card, B):
    """Top-k through the graph draws the eager chunk's tokens from one seed
    (the generator registered with each graph advances as the eager body
    advances it); the sampler's draw is torch.multinomial's on the card."""
    eng = _graph_engine(card, POLICIES["q8"])
    gen = GenerationConfig(greedy=False, top_k=40, temperature=0.9,
                           eos_token=-1)
    _graph_against_eager(eng, B, gen, seed=17)
    logits = torch.randn(6, 300, device=card)
    a, b = (torch.Generator(card).manual_seed(5) for _ in range(2))
    vals, idx = torch.topk(logits, 40)
    for _ in range(3):
        want = idx.gather(1, torch.multinomial(torch.softmax(vals / 0.9, -1),
                                               1, generator=a))[:, 0]
        got = sampling.sample_top_k(logits, b, 0.9, 40)
        assert torch.equal(got.long(), want)


def _launch_counts():
    mods = (qmatmul, decode_fused, ffn_fused, flash_attention, flash_paged,
            attn_out_fused)
    return {k: v for m in mods for k, v in m.launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_generate_replays_after_cache_reuse(card, paged, monkeypatch):
    """generate on one engine, a long prompt and then a short one (its
    chunks replays over the reused cache), gives the tokens and the launch
    counts of generate with the eager chunk on a fresh engine; so do
    generate_batch and the batcher."""
    gen = GenerationConfig(n_predict=48, greedy=True, eos_token=-1,
                           chunk_size=8)
    long_, short = _graph_prompts(3)[2], _graph_prompts(1)[0]
    used = _graph_engine(card, POLICIES["q8"], paged)
    used.generate(long_, gen)
    used.generate_batch(_graph_prompts(4)[::-1], gen)

    def run(eng):
        before = _launch_counts()
        out = (eng.generate(short, gen)[0],
               eng.generate_batch(_graph_prompts(4), gen)[0])
        b = ContinuousBatcher(eng, gen, max_batch=4)
        ids = [b.submit(p, max_new=n) for p, n in
               zip(_graph_prompts(6), (9, 20, 3, 14, 30, 6))]
        res = b.run()
        torch.cuda.synchronize()
        after = _launch_counts()
        return out + ([res[i].output for i in ids],), {
            k: after[k] - before[k] for k in after}

    graph_out, graph_counts = run(used)
    fresh = _graph_engine(card, POLICIES["q8"], paged)
    monkeypatch.setattr(fresh, "run_chunk", fresh.chunk)
    eager_out, eager_counts = run(fresh)
    assert graph_out == eager_out
    assert graph_counts == eager_counts and any(graph_counts.values())


@pytest.mark.cuda
def test_two_threads_capture_at_once(card):
    """Two engines, each driven by its own thread (as two servers in one
    process), capture and replay their chunks at the same time: each
    gives its eager chunk's tokens."""
    import threading

    gen = GenerationConfig(greedy=True, eos_token=-1)
    engines = [_graph_engine(card, POLICIES["q8"], paged) for paged in (False,
                                                                         True)]
    want, got, errors = [], [None, None], []
    for eng in engines:
        cache = eng.new_cache(4)
        logits, lens = eng.prefill(cache, _graph_prompts(4))
        pos = torch.from_numpy(lens.astype(np.int32)).to(card)
        seq = []
        for C in (8, 4, 2, 8, 1):
            toks, _, logits, pos = eng.chunk(cache, logits, pos, C, gen)
            seq.append(toks.cpu())
        want.append(seq)
    barrier = threading.Barrier(2)

    def drive(i, eng):
        try:
            stream = torch.cuda.Stream(card)
            with torch.cuda.stream(stream):
                cache = eng.new_cache(4)
                logits, lens = eng.prefill(cache, _graph_prompts(4))
                pos = torch.from_numpy(lens.astype(np.int32))
                barrier.wait()
                seq = []
                for C in (8, 4, 2, 8, 1):
                    toks, _, logits, pos = eng.run_chunk(cache, logits, pos, C,
                                                         gen)
                    seq.append(toks.cpu())
                got[i] = seq
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(i, e))
               for i, e in enumerate(engines)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w))
    assert all(e.graph_stats["graphs"] == 4 for e in engines)


# --- head dim 128 (Llama-3): K3, K4, K9, K10, K11 -----------------------------

#: max_ctx of the d = 128 tests (Llama-3's) and their page size
D128_S, D128_P = 8192, 256
#: K4 / K10: a row at each position; K9 / K11: (chunk base, tail fill) a
#: row, a 64-slot tail
D128_POS = [0, 63, 64, D128_S - 1]
D128_STAGED = [(0, 1), (63, 33), (64, 64), (D128_S - 64, 64)]


def _d128_inputs(B, G, kv, bases, seed, device, T=1, Kh=2, L=2, Cs=64):
    """The d = 128 kernels' operands in the KV kind `kv` at max_ctx 8,192:
    q [B, T, G Kh, 128]; a monolithic cache [L, B, Kh, S, 128] and a page
    pool of the same values (256-key pages under a shuffled table); a
    staged tail of Cs slots over each, chunk bases `bases`. Values N(0,
    1); int8 ones uniform with scales uniform in [0.005, 0.025)."""
    g = torch.Generator().manual_seed(seed)
    S, P, d = D128_S, D128_P, 128
    J = S // P

    def planes(shape):  # k, v and their scales (None but int8), on the CPU
        if kv == "i8":
            data = [torch.randint(-127, 128, shape, generator=g,
                                  dtype=torch.int8) for _ in range(2)]
            return data + [torch.rand(shape[:-1], generator=g) * 0.02 + 0.005
                           for _ in range(2)]
        dt = {"bf16": torch.bfloat16, "f16": torch.float16,
              "f32": torch.float32}[kv]
        return [torch.randn(shape, generator=g).to(dt) for _ in range(2)] + [
            None, None]

    dense = planes((L, B, Kh, S, d))
    tail = planes((L, B, Kh, Cs, d))
    table = 1 + torch.randperm(B * J, generator=g).reshape(B, J)
    pool = []
    for x in dense:
        if x is None:
            pool.append(None)
            continue
        y = torch.zeros((L, 1 + B * J, Kh, P) + x.shape[4:], dtype=x.dtype)
        for b in range(B):
            for j in range(J):
                y[:, table[b, j]] = x[:, b, :, j * P:(j + 1) * P]
        pool.append(y)
    on = [None if x is None else x.to(device) for x in dense + pool + tail]
    k, v, ks, vs, pk, pv, pks, pvs, sk, sv, sks, svs = on
    base = _i32(bases, device)
    cache = KVCache(k, v, ks, vs)
    paged = PagedKVCache(pk, pv, table.to(device, torch.int32), pks, pvs)
    q = torch.randn(B, T, G * Kh, d, generator=g).to(device, torch.bfloat16)
    return (q, cache, paged,
            StagedKVCache(cache, sk, sv, base, sk_scale=sks, sv_scale=svs),
            StagedKVCache(paged, sk, sv, base, sk_scale=sks, sv_scale=svs))


def _d128_decode_cases(q, cache, paged, st_d, st_p, layer, p, p_st):
    """(module, counter, kernel, plain) of K4, K10, K9 and K11."""
    fa, fp = flash_attention, flash_paged
    return [
        (fa, "flash_decode_heads",
         lambda: fa.flash_decode_heads_attention(q, cache, layer, p),
         lambda: fa.attention_ref(q, cache, layer, p)),
        (fp, "flash_paged", lambda: fp.flash_paged_attention(q, paged, layer, p),
         lambda: fp.paged_attention_ref(q, paged, layer, p)),
        (fa, "flash_staged",
         lambda: fa.flash_staged_attention(q, st_d, layer, p_st),
         lambda: fp.staged_attention_ref(q, st_d, layer, p_st)),
        (fp, "flash_paged_staged",
         lambda: fp.flash_paged_staged_attention(q, st_p, layer, p_st),
         lambda: fp.staged_attention_ref(q, st_p, layer, p_st)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("G", [4, 8])
def test_d128_split_kernels_match_plain(card, G, kv):
    """K4 and K10 at d = 128, a row at each of pos 0, 63, 64 and S - 1 (S =
    8,192), and K9 and K11 at chunk bases 0, 63, 64 and S - 64 with tails
    filled 1, 33, 64 and 64: each against its plain version, one launch
    counted a call under the kind's counter."""
    bases = [b for b, _ in D128_STAGED]
    q, cache, paged, st_d, st_p = _d128_inputs(4, G, kv, bases, seed=G,
                                               device=card)
    layer = _i32([1], card)
    p = _i32(D128_POS, card)
    p_st = _i32([b + f - 1 for b, f in D128_STAGED], card)
    sfx = "" if kv == "bf16" else f"_{kv}"
    for mod, name, kernel, plain in _d128_decode_cases(q, cache, paged, st_d,
                                                       st_p, layer, p, p_st):
        got = _counted(mod, name + sfx, kernel)
        want = plain()
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("T,pos", [(130, [0, 7000]), (8192, [0])])
def test_d128_prefill_kernel_matches_plain(card, T, pos, G, kv):
    """K3 at d = 128: 130 new tokens a row at pos 0 and 7,000 (a partial
    last query tile, keys past 7,129 unread), and a whole 8,192-token
    prompt against S = 8,192; against its plain version."""
    q, cache, _, _, _ = _d128_inputs(len(pos), G, kv, [0] * len(pos),
                                     seed=T + G, device=card, T=T)
    layer, p = _i32([1], card), _i32(pos, card)
    sfx = "" if kv == "bf16" else f"_{kv}"
    got = _counted(flash_attention, "flash_prefill" + sfx,
                   lambda: flash_attention.flash_prefill_attention(q, cache,
                                                                   layer, p))
    want = flash_attention.attention_ref(q, cache, layer, p)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _replays_equal(run, states, what):
    """run() captured in a CUDA graph (after an eager call), then for each
    state: set it (a callable writing device tensors in place), replay,
    and the outputs must equal an eager call there."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for label, set_state in states:
        set_state()
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        eager = run()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e), f"{what} replayed at {label}"


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
def test_d128_kernels_replay_in_a_graph(card, kv):
    """At d = 128, G = 4: K4 and K10 captured at pos 127 and replayed at
    1,500, 5 and 8,191; K9 and K11 captured at slot 3 of a chunk and
    replayed at slots 0, 40 and 63 and in chunks whose bases moved by 64
    and 3,000; K3 captured at pos 0 and replayed at 500 and 8,062 (pos,
    base written in place): each replay equals an eager call there."""
    bases = [b for b, _ in D128_STAGED[:3]] + [4000]
    q, cache, paged, st_d, st_p = _d128_inputs(4, 4, kv, bases, seed=21,
                                               device=card)
    layer = _i32([1], card)
    p = _i32([127] * 4, card)
    p_st = st_d.base + 3
    cases = _d128_decode_cases(q, cache, paged, st_d, st_p, layer, p, p_st)
    _replays_equal(lambda: [c[2]() for c in cases[:2]],
                   [(at, functools.partial(p.fill_, at))
                    for at in (1500, 5, D128_S - 1)], f"K4, K10 {kv}")
    base0 = st_d.base.clone()

    def chunk_at(shift, slot):
        def set_state():
            st_d.base.copy_(base0 + shift)
            p_st.copy_(st_d.base + slot)
        return (f"base + {shift}, slot {slot}", set_state)

    _replays_equal(lambda: [c[2]() for c in cases[2:]],
                   [chunk_at(0, 0), chunk_at(0, 40), chunk_at(0, 63),
                    chunk_at(64, 17), chunk_at(3000, 50)], f"K9, K11 {kv}")
    q3, cache3, _, _, _ = _d128_inputs(1, 4, kv, [0], seed=22, device=card,
                                       T=130)
    p3 = _i32([0], card)
    _replays_equal(
        lambda: [flash_attention.flash_prefill_attention(q3, cache3, layer, p3)],
        [(at, functools.partial(p3.fill_, at)) for at in (500, D128_S - 130)],
        f"K3 {kv}")


@pytest.mark.cuda
def test_d128_wrappers_refuse_other_head_dims(card):
    """A head dim the kernels do not take (96) is refused on the card with
    a ValueError naming the ones they take, before a launch; K8 takes
    only 64."""
    d = 96
    q = torch.zeros(1, 1, 8, d, dtype=torch.bfloat16, device=card)
    cache = _cache(1, 2, 256, [4], seed=0, device=card, d=d)
    layer, pos = _i32([0], card), _i32([3], card)
    pool = PagedKVCache(cache.k.clone(), cache.v.clone(), _i32([[0]], card))
    st = StagedKVCache(cache, cache.k[:, :, :, :32].contiguous(),
                       cache.v[:, :, :, :32].contiguous(), _i32([2], card))
    calls = [
        lambda: flash_attention.flash_prefill_attention(
            torch.zeros(1, 2, 8, d, dtype=torch.bfloat16, device=card), cache,
            layer, pos),
        lambda: flash_attention.flash_decode_heads_attention(q, cache, layer,
                                                             pos),
        lambda: flash_attention.flash_staged_attention(q, st, layer, pos),
        lambda: flash_paged.flash_paged_attention(q, pool, layer, pos),
        lambda: flash_paged.flash_paged_staged_attention(
            q, StagedKVCache(pool, st.sk, st.sv, st.base), layer, pos),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=r"d must be one of \(64, 128\)"):
            call()
    q = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16, device=card)
    cache = _cache(1, 2, 256, [4], seed=0, device=card, d=128)
    res = torch.zeros(1, 1, 1024, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match=r"one of \(64,\)"):
        attn_out_fused.fused_attn_out(q, cache, _i32([0], card), _i32([3], card),
                                      res, _weight(2, 1024, 1024, 0, card))


_llama3_params: dict = {}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kv", ["bf16", "i8"])
@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_graph_chunk_equals_eager_chunk_llama3_width(card, paged, kv, B):
    """test_graph_chunk_equals_eager_chunk at Llama-3-8B's widths and head
    dim (2 of its 32 layers, q4 weights made on the card, max_ctx 1,024):
    the unfused b1 step (K1, K4 or K10 at d = 128) and the staged B = 4
    one (K9 or K11), replayed, are the eager chunk bit for bit."""
    from tinyllama_tpu_torch.config import LLAMA_3_8B

    cfg = LLAMA_3_8B.replace(n_layers=2)
    if "q4" not in _llama3_params:
        g = torch.Generator(card).manual_seed(0)
        _llama3_params["q4"] = llama.init_quantized_params(cfg, POLICIES["q4"], g,
                                                           device=card)
    policy = dataclasses.replace(POLICIES["q4"], kv_dtype=kv)
    eng = Engine(cfg, policy, _llama3_params["q4"], max_ctx=1024, device=card,
                 paged=paged)
    _graph_against_eager(eng, B, GenerationConfig(greedy=True, eos_token=-1))


# --- speculative decoding: verify rounds as CUDA graphs (runtime/graphs.py) --


def _kv_kind(cache: KVCache, kv: str) -> KVCache:
    """A bf16 cache's values in the KV kind `kv` (int8 through quantize_kv,
    with its scales; f16 and f32 cast)."""
    if kv == "bf16":
        return cache
    if kv == "i8":
        (k, ks), (v, vs) = (kvcache.quantize_kv(cache.k),
                            kvcache.quantize_kv(cache.v))
        return KVCache(k, v, ks, vs)
    dt = {"f16": torch.float16, "f32": torch.float32}[kv]
    return KVCache(cache.k.to(dt), cache.v.to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "i8", "f16", "f32"])
def test_k3_at_verify_shapes_replays(card, kv):
    """K3 at a verify round's shapes: T = 5 new tokens of TinyLlama's heads
    (32 query, 4 kv: 40 query rows a kv head, one partial row block) from
    pos > 0 over S = 2,048 + 128 keys, against its plain version at pos 1,
    127, 1,500 and S - 5; captured in a CUDA graph at pos 127 and replayed
    at 5, 1,500 and S - 5, each replay equal to an eager call there."""
    H, Kh, S, T = 32, 4, 2048 + speculative.PAD, 5
    cache = _kv_kind(_cache(1, Kh, S, [S], seed=31, device=card), kv)
    g = torch.Generator().manual_seed(32)
    q = torch.randn(1, T, H, 64, generator=g).to(card, torch.bfloat16)
    layer, pos = _i32([1], card), _i32([0], card)
    for p in (1, 127, 1500, S - T):
        pos.fill_(p)
        got = flash_attention.flash_prefill_attention(q, cache, layer, pos)
        want = flash_attention.attention_ref(q, cache, layer, pos)
        torch.testing.assert_close(got.float(), want.float(), **TOL,
                                   msg=f"pos {p}")
    pos.fill_(127)
    _replays_equal(
        lambda: [flash_attention.flash_prefill_attention(q, cache, layer, pos)],
        [(at, functools.partial(pos.fill_, at)) for at in (5, 1500, S - T)],
        f"K3 verify {kv}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 40])
def test_spec_rounds_replay_equals_eager(card, k):
    """From one saved state, the verify rounds' graph (4 rounds a replay,
    captured at its first call) leaves toks, out, the state and the cache
    torch.equal to the same rounds run eagerly, replay by replay, through
    done and past it; twice, the second pass all replays. k = 40 (T = 41)
    takes the unfused branch (K2)."""
    eng = _graph_engine(card, POLICIES["q8"])
    spec = eng.round_graphs()
    buf, R = spec.buffers_for(k), 4
    prompt = _graph_prompts(2)[1]
    logits, _ = eng.prefill(spec.cache, [prompt])
    speculative.start(buf, prompt, int(logits[0].argmax()), 30)

    def tensors():
        return [buf.toks, buf.out, buf.state, *kvcache.kv_planes(spec.cache)]

    saved = [t.clone() for t in tensors()]
    eager = []
    for i in range(10 * R):
        speculative.verify_round(eng, spec.cache, spec.rope, buf, k, -1)
        if i % R == R - 1:
            eager.append([t.clone() for t in tensors()])
    assert eager[-1][2][speculative.STATE.index("done")] == 1
    for _ in range(2):
        for t, s in zip(tensors(), saved):
            t.copy_(s)
        for i, want in enumerate(eager):
            spec.run(k, -1, R)
            assert all(torch.equal(a, b) for a, b in zip(tensors(), want)), i
    assert list(spec.graphs) == [(k, -1, R)]


@pytest.mark.cuda
def test_spec_f32_dense_equals_generate(card):
    """Dense f32 weights (no kernel, so the loop alone): generate's tokens
    at k = 1 and 4 over two prompts, and the whole budget at the context
    limit (max_ctx 256, a 200-token prompt)."""
    eng = _graph_engine(card, POLICIES["f32"])
    for prompt in _graph_prompts(2):
        gen = GenerationConfig(n_predict=len(prompt) + 48, greedy=True,
                               eos_token=-1)
        want = eng.generate(prompt, gen)[0]
        for k in (1, 4):
            assert eng.generate_speculative(prompt, gen, k)[0] == want, k
    prompt = [1] + [2 + (7 * i) % 100 for i in range(199)]
    gen = GenerationConfig(n_predict=256, greedy=True, eos_token=-1)
    want = eng.generate(prompt, gen)[0]
    got = eng.generate_speculative(prompt, gen, 4)[0]
    assert got == want and len(got) == 56


@pytest.mark.cuda
def test_debug_nans_keys_and_counts(card):
    """Without debug_nans the chunk's graph key is (B, C, sampler, EOS,
    generator) and the rounds' (k, EOS, R); with it each key ends in
    "debug_nans". The tokens and the kernels' launches are the same
    either way."""
    prompt = _graph_prompts(1)[0]
    gen = GenerationConfig(n_predict=len(prompt) + 24, greedy=True,
                           eos_token=-1, chunk_size=8)
    runs = []
    for debug in (False, True):
        eng = _graph_engine(card, POLICIES["q8"])
        eng.debug_nans = debug
        before = _launch_counts()
        out = (eng.generate(prompt, gen)[0],
               eng.generate_speculative(prompt, gen, 3)[0])
        torch.cuda.synchronize()
        after = _launch_counts()
        keys = [key for cg in eng._chunk_graphs.values() for key in cg.graphs]
        runs.append((out, {n: after[n] - before[n] for n in after},
                     keys + list(eng.round_graphs().graphs)))
    (out0, counts0, keys0), (out1, counts1, keys1) = runs
    assert out0 == out1 and counts0 == counts1
    assert keys0 == [(1, 8, (True, 0, 0.0), -1, None),
                     (3, -1, speculative.ROUNDS)]
    assert keys1 == [key + ("debug_nans",) for key in keys0]


@pytest.mark.cuda
def test_profiler_kernel_events_equal_launches(card, tmp_path):
    """One replayed b1 chunk (K5, K8's two launches, K7's two, K1) and one
    replay of the verify rounds under torch.profiler: the trace's events
    of each of the port's kernels are what the launch counts stand for."""
    eng = _graph_engine(card, POLICIES["q8"])
    prompt = _graph_prompts(1)[0]
    gen = GenerationConfig(n_predict=len(prompt) + 16, greedy=True,
                           eos_token=-1, chunk_size=8)
    eng.generate(prompt, gen)
    eng.generate_speculative(prompt, gen, 4)
    cache = eng._cache(1)
    logits, lens = eng.prefill(cache, [prompt])
    spec = eng.round_graphs()
    speculative.start(spec.buffers_for(4), prompt, int(logits[0].argmax()), 100)
    torch.cuda.synchronize()
    pos = _i32([int(lens[0])], card)
    before = _launch_counts()

    def replays():
        eng.run_chunk(cache, logits, pos, 8, gen)
        spec.run(4, -1, speculative.ROUNDS)

    events = trace.profile_device_events(replays, tmp_path, card)
    after = _launch_counts()
    launched = {n: after[n] - before[n] for n in after}
    L = eng.cfg.n_layers
    assert launched["fused_attn_out"] == 8 * L
    assert launched["fused_out_residual"] == speculative.ROUNDS * L
    assert trace.kernel_event_counts(events) == trace.expected_kernel_events(
        launched)


# --- tensor parallelism: the kernels at a TP rank's local widths -------------

#: (model, tp) of the TP ranks path (q) of chip_smoke.py runs: TinyLlama at
#: tp 2 and 4 (one kv head a rank), Llama-3-8B at tp 2
TP_CASES = [("tinyllama-1.1b-chat-v0.4", 2), ("tinyllama-1.1b-chat-v0.4", 4),
            ("llama-3-8b", 2)]


def _tp_local(model, tp):
    """(H, Kh, d) of a TP rank and its linears' (K, N): the column-parallel
    wqkv and w_gateup shards, the row-parallel wo and w_down shards, and
    the --tp-overlap ring's chunks of those (N / tp)."""
    cfg = local_config(MODEL_REGISTRY[model], tp)
    H, Kh, d, D, F = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_embd,
                      cfg.n_ffn)
    return (H, Kh, d), {"wqkv": (D, (H + 2 * Kh) * d), "wo": (H * d, D),
                        "w_gateup": (D, 2 * F), "w_down": (F, D),
                        "wo_chunk": (H * d, D // tp), "w_down_chunk": (F, D // tp)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wqkv", "wo", "w_gateup", "w_down",
                                  "wo_chunk", "w_down_chunk"])
@pytest.mark.parametrize("model,tp,kind", [
    ("tinyllama-1.1b-chat-v0.4", 2, "q8"), ("tinyllama-1.1b-chat-v0.4", 2, "q4"),
    ("tinyllama-1.1b-chat-v0.4", 2, "q4g"), ("tinyllama-1.1b-chat-v0.4", 4, "q8"),
    ("tinyllama-1.1b-chat-v0.4", 4, "q4"), ("llama-3-8b", 2, "q4")])
def test_tp_local_linears_match_plain(card, model, tp, kind, name):
    """K1 (M = 1 and 4) and K2 (M = 128) on a TP rank's shard of each
    linear, layer-stacked, against their plain versions."""
    K, N = _tp_local(model, tp)[1][name]
    w = _weight(2, K, N, seed=K + N, device=card, kind=kind)
    layer = _i32([1], card)
    for M in (1, 4, 128):
        x = torch.randn(M, K, device=card).to(torch.bfloat16)
        name_ = "qmm_smallm" if M <= qmatmul.SMALL_M else "qmm_bigm"
        got = _counted(qmatmul, name_,
                       lambda: qmatmul.qmatmul(x, w, torch.bfloat16, layer))
        want = qmatmul.qmatmul_ref(x, w, torch.bfloat16, layer)
        torch.cuda.synchronize()
        assert got.shape == (M, N)
        torch.testing.assert_close(got.float(), want.float(), **TOL,
                                   msg=f"M={M}")


@pytest.mark.cuda
@pytest.mark.parametrize("T,pos", [(128, [0, 0]), (12, [5, 70]),
                                   (1, [127, 1500])])
@pytest.mark.parametrize("model,tp", TP_CASES)
def test_tp_local_attention_matches_plain(card, model, tp, T, pos):
    """K3 (T > 1, from pos 0 and from pos > 0) and K4 (T = 1) at a TP
    rank's heads (Kh = 1 at TinyLlama tp 4), two rows, S = 2,048."""
    (H, Kh, d), _ = _tp_local(model, tp)
    cache = _cache(2, Kh, 2048, [p + T for p in pos], seed=T, device=card, d=d)
    q = torch.randn(2, T, H, d, device=card).to(torch.bfloat16)
    layer, p = _i32([1], card), _i32(pos, card)
    fn, name = ((flash_attention.flash_decode_heads_attention,
                 "flash_decode_heads") if T == 1
                else (flash_attention.flash_prefill_attention, "flash_prefill"))
    got = _counted(flash_attention, name, lambda: fn(q, cache, layer, p))
    want = flash_attention.attention_ref(q, cache, layer, p)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T,pos", [(128, [0, 0]), (1, [127, 1500])])
@pytest.mark.parametrize("model,tp", TP_CASES)
def test_tp_local_i8_attention_matches_plain(card, model, tp, T, pos):
    """K3 and K4 over an int8 cache at a TP rank's heads (an --kv i8
    engine at tp > 1: Kh = 2 at TinyLlama tp 2, 1 at tp 4)."""
    (H, Kh, d), _ = _tp_local(model, tp)
    cache = _i8(_cache(2, Kh, 2048, [p + T for p in pos], seed=T + 1,
                       device=card, d=d))
    q = torch.randn(2, T, H, d, device=card).to(torch.bfloat16)
    layer, p = _i32([1], card), _i32(pos, card)
    fn, name = ((flash_attention.flash_decode_heads_attention,
                 "flash_decode_heads_i8") if T == 1
                else (flash_attention.flash_prefill_attention, "flash_prefill_i8"))
    got = _counted(flash_attention, name, lambda: fn(q, cache, layer, p))
    want = flash_attention.attention_ref(q, cache, layer, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,base", [(1, 127), (4, 100), (8, 300)])
@pytest.mark.parametrize("model,tp", TP_CASES)
def test_tp_local_serving_attention_matches_plain(card, model, tp, B, base):
    """K9 (staged, monolithic), K11 (staged over a page pool) and K10
    (paged) at a TP rank's heads, as generate_batch, the batcher and a
    paged generate run them on path (q)."""
    (H, Kh, d), _ = _tp_local(model, tp)
    q, pos, pool, st_dense, st_paged = _serving_inputs(
        B, H // Kh, base, seed=base + B, device=card, Kh=Kh, d=d)
    layer = _i32([1], card)
    cases = [
        (flash_attention, "flash_staged",
         lambda: flash_attention.flash_staged_attention(q, st_dense, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_dense, layer, pos)),
        (flash_paged, "flash_paged_staged",
         lambda: flash_paged.flash_paged_staged_attention(q, st_paged, layer, pos),
         lambda: flash_paged.staged_attention_ref(q, st_paged, layer, pos)),
        (flash_paged, "flash_paged",
         lambda: flash_paged.flash_paged_attention(q, pool, layer, st_paged.base),
         lambda: flash_paged.paged_attention_ref(q, pool, layer, st_paged.base)),
    ]
    for mod, name, kernel, plain in cases:
        got = _counted(mod, name, kernel)
        want = plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)



# --- sequence parallelism: K1 / K2 at a rank's rows, the ring, the engine ----

#: (model, sp, Tl) of the SP ranks path (r) of chip_smoke.py runs: path
#: (e)'s 1,450-token prompt at sp 2 and 4 (1,456 and 1,472 rows), path
#: (o2)'s 7,000 at Llama-3-8B sp 2 (7,008 rows), and the 8 rows of a
#: prompt of at most 16 tokens at sp 2
SP_CASES = [("tinyllama-1.1b-chat-v0.4", 2, 728),
            ("tinyllama-1.1b-chat-v0.4", 4, 368),
            ("tinyllama-1.1b-chat-v0.4", 2, 8), ("llama-3-8b", 2, 3504)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wqkv", "wo", "w_gateup", "w_down"])
@pytest.mark.parametrize("model,sp,Tl", SP_CASES)
def test_sp_rank_linears_match_plain(card, model, sp, Tl, name):
    """K2 (K1 at Tl = 8) on one SP rank's Tl rows of each linear, at the
    full widths (a rank at tp 1 holds every weight), against the plain
    version."""
    (H, Kh, d), shapes = _tp_local(model, 1)
    K, N = shapes[name]
    kind = "q4" if model == "llama-3-8b" else "q8"
    w = _weight(2, K, N, seed=K + Tl, device=card, kind=kind)
    x = torch.randn(Tl, K, device=card).to(torch.bfloat16)
    layer = _i32([1], card)
    got = _counted(qmatmul, "qmm_smallm" if Tl <= qmatmul.SMALL_M
                   else "qmm_bigm",
                   lambda: qmatmul.qmatmul(x, w, torch.bfloat16, layer))
    want = qmatmul.qmatmul_ref(x, w, torch.bfloat16, layer)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL)


class _TwoRankRing:
    """Data rank 1 of 2 for ring_gqa_attention in one process: its one hop
    hands over rank 0's block."""

    dp, dp_rank = 2, 1

    def __init__(self, block0):
        self.block0 = block0

    def data_ring_shift(self, t):
        return self.block0


@pytest.mark.cuda
@pytest.mark.parametrize("model,sp,Tl", [c for c in SP_CASES if c[2] > 8])
def test_sp_ring_on_the_card_matches_plain(card, model, sp, Tl):
    """The ring's rank 0 (its own block, causal) and rank 1 (rank 0's
    block unmasked, then its own), bf16 on the card with f32 scores on the
    tensor cores (sliced at Llama-3-8B's Tl), against the plain causal
    attention over the 2 * Tl rows."""
    from types import SimpleNamespace

    from tinyllama_tpu_torch.ops.attention import gqa_attention
    from tinyllama_tpu_torch.parallel.ring import ring_gqa_attention

    (H, Kh, d), _ = _tp_local(model, 1)
    g = torch.Generator(card).manual_seed(Tl)
    q = torch.randn(1, 2 * Tl, H, d, device=card, generator=g).bfloat16()
    k, v = (torch.randn(1, 2 * Tl, Kh, d, device=card, generator=g).bfloat16()
            for _ in range(2))
    half = [slice(0, Tl), slice(Tl, 2 * Tl)]
    out0 = ring_gqa_attention(q[:, half[0]], k[:, half[0]], v[:, half[0]],
                              SimpleNamespace(dp=1, dp_rank=0))
    block0 = torch.stack([x[:, half[0]].permute(0, 2, 1, 3).reshape(
        Kh, Tl, d) for x in (k, v)])
    out1 = ring_gqa_attention(q[:, half[1]], k[:, half[1]], v[:, half[1]],
                              _TwoRankRing(block0))
    want = gqa_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                         torch.arange(2 * Tl, device=card)[None])
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([out0, out1], 1).float(),
                               want.float(), **TOL)


@pytest.mark.cuda
def test_sp_engine_on_the_card(card):
    """Engine(sp=2) in 2 rank processes sharing the card (gloo; the chunk
    a CUDA graph at tp 1): TinyLlama's widths at 2 layers, q8, a 300-token
    prompt. Each rank's prefill launches K2 4 x L times at Tl = 152 and
    K1 once (the lm_head), no K3; its logits are bit-equal on both ranks
    and within 5% of max |logits| of the sp = 1 engine's; 16 greedy
    tokens the same on both."""
    import torch_sp_tasks

    from tinyllama_tpu_torch.parallel.mesh import run_ranks

    cfg = MODEL_REGISTRY["tinyllama-1.1b-chat-v0.4"].replace(n_layers=2)
    prompt = [1] + list(range(2, 301))
    build.build_all()
    res = run_ranks(torch_sp_tasks.card_sp_engine, 1, cfg, prompt, 16, dp=2)
    assert np.array_equal(res[0][0], res[1][0]) and res[0][1:] == res[1][1:]
    logits, ids, counts, route = res[0]
    assert route == "graph" and len(ids) == 16
    assert counts["qmm_bigm"] == 4 * cfg.n_layers
    assert counts["qmm_smallm"] == 1 and counts["flash_prefill"] == 0
    g = torch.Generator(card).manual_seed(7)
    params = llama.init_quantized_params(cfg, POLICIES["q8"], g, card)
    eng = Engine(cfg, POLICIES["q8"], params, max_ctx=512, device=card)
    want = eng.prefill(eng.new_cache(1), [prompt])[0].float().cpu().numpy()
    assert np.abs(logits - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.cuda
def test_capture_survives_a_dropped_engines_graphs(card):
    """An engine with a captured chunk dropped in a reference cycle (it
    and its ChunkGraphs), then a capture whose body allocates Python
    objects with the collector set to run at nearly every allocation: the
    capture (graphs.capturing, as time_ms and the engines capture)
    collects first and holds the collector off, so the dropped engine's
    graphs are not destroyed inside it (CUDA error 901 when they were)."""
    import gc
    import weakref

    from tinyllama_tpu_torch.runtime.graphs import capturing

    eng = _graph_engine(card, POLICIES["q8"])
    eng.generate([1, 5, 9], GenerationConfig(n_predict=11, greedy=True,
                                             eos_token=-1, chunk_size=4))
    assert eng._chunk_graphs
    gone = weakref.ref(eng)
    del eng
    x = torch.zeros(4, device=card)
    g = torch.cuda.CUDAGraph()
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        with capturing(g):
            for _ in range(100):
                _ = [object() for _ in range(10)]
                x.add_(1)
    finally:
        gc.set_threshold(*thresholds)
    g.replay()
    torch.cuda.synchronize()
    assert gone() is None and float(x[0]) == 100
