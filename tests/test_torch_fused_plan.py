"""The fused decode walk's host plan, and its split arithmetic against the
plain versions of K5 and K7.

K5 (``fused_norm_qkv``) and both phases of K7 (``ffn_fused``) walk their
weight in tiles of 64 or 128 columns times K splits, a tile's splits one
thread-block cluster (csrc/fused_walk.cuh); ``fused_plan.fused_plan``
picks the width and the split count from shapes and the SM count only. Here the plan is
checked for covering every (column, 32-row K block) exactly once at
TinyLlama-1.1B's shapes and every M of the fused branch, for clusters of
at most 8 blocks (a power of two) and for a block on every SM of an H100
(132 SMs), at most two an SM (that the card keeps them all resident is
asked of the card, in tests/test_torch_cuda.py). ``split_model``, the
kernel's split arithmetic in plain PyTorch (per-split sums of squares
added in split order into the rms statistic, per-split partial products
added in split order), is held against ``fused_norm_qkv_ref`` and
``ffn_fused_ref`` on the CPU, whose parity with the JAX kernels
tests/test_torch_fused.py and test_torch_fused4.py check. Tolerance:
bf16 outputs, the JAX suite's rtol 2e-2 / atol 5e-3.

K1 (``qmm_smallm``) and K6 (``fused_out_residual``) walk their weights
the same way: K1's plan (``fused_plan.fused_plan`` with K1's numbers,
as ``qmatmul.smallm_plan`` calls it) is checked at
TinyLlama-1.1B's five decode shapes, Llama-3-8B's and 70B's and at
ragged N, the split model against ``qmatmul_ref`` (bf16 and f32 out,
stacked and unstacked, K past 8,192 rows) and ``fused_out_residual_ref``,
and K1's aq8 branch by a model of its registers (the s8 fragments built
by byte permutes) and of its per-split quantization, whose int32 block
dots must equal the plain version's bit for bit. K8's wo launch is the
same walk: tests/test_torch_attn_out_split.py models it with
``split_model`` and a residual.
"""

import collections

import numpy as np
import pytest
import torch

from tinyllama_tpu_torch.config import tiny_test_config
from tinyllama_tpu_torch.ops.kernels import decode_fused, ffn_fused, fused_plan, qmatmul
from tinyllama_tpu_torch.ops.precision import exact_f32
from tinyllama_tpu_torch.quant.codec import QTensor, dequantize, quantize


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: with the test
    workers sharing the host's cores, eight threads a worker each spin for
    the cores and the ops run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=2e-2, atol=5e-3)
H100_SMS = 132
#: TinyLlama-1.1B's fused launches: (K, output columns); the gate/up
#: launch counts F columns (each tile a gate and an up half)
SHAPES = {"wqkv": (2048, 2560), "w_gateup": (2048, 5632), "w_down": (5632, 2048)}


def fused_blocks(K, ncols, width, splits):
    """The grid as the kernel reads it: block (tile, split) -> its output
    columns [c0, c1) and K-rows [k0, k1)."""
    tiles, steps, step = -(-ncols // width), -(-K // fused_plan.STEP), fused_plan.STEP
    return {(t, s): (t * width, min((t + 1) * width, ncols),
                     s * steps // splits * step,
                     min((s + 1) * steps // splits * step, K))
            for t in range(tiles) for s in range(splits)}


def split_model(x2, norm_w, w, layer, splits, eps=0.0, inside=False,
                residual=None):
    """The kernel's split arithmetic on the plain path: x2 [M, K] (normed
    in the walk when norm_w, the [L, K] table, is given) against the
    layer's dequantized weight, its K walk cut as ``fused_blocks`` cuts
    it. With a norm each split's f32 sum of squares of its slice is added
    in split order into the rms statistic; each split's f32 partial
    product is added in split order, and a residual [M, N] (the epilogue
    of K6 and K8) to that sum once. Returns the f32 [M, N] sums."""
    K, M = x2.shape[1], x2.shape[0]
    steps = -(-K // fused_plan.STEP)
    cuts = [min(s * steps // splits * fused_plan.STEP, K) for s in range(splits + 1)]
    xf = x2.float()
    if norm_w is not None:
        ms = sum((xf[:, a:b] * xf[:, a:b]).sum(dim=1, keepdim=True)
                 for a, b in zip(cuts, cuts[1:])) / K
        nrm = xf * torch.rsqrt(ms + eps) if inside else xf / (torch.sqrt(ms) + eps)
        xf = (nrm * norm_w[qmatmul.layer_index(layer)].float()).to(x2.dtype).float()
    data, scales = qmatmul._layer_view(w, layer)
    wd = dequantize(QTensor(data, scales, w.kind, w.layout), torch.float32)
    if M > qmatmul.SMALL_M:  # the tile regime: bf16 weights
        wd = wd.to(x2.dtype).float()
    out = torch.zeros(M, wd.shape[1], device=x2.device)
    with exact_f32():
        for a, b in zip(cuts, cuts[1:]):
            out = out + xf[:, a:b] @ wd[a:b]
    return out if residual is None else out + residual.float()


def _cover(K, ncols, width, splits):
    blocks = fused_blocks(K, ncols, width, splits)
    seen = collections.Counter(
        (c, kb) for c0, c1, k0, k1 in blocks.values()
        for c in range(c0, c1) for kb in range(k0 // 32, -(-k1 // 32)))
    return blocks, seen


@pytest.mark.parametrize("name", list(SHAPES))
def test_blocks_cover_every_column_and_block_once(name):
    K, ncols = SHAPES[name]
    width, splits = fused_plan.fused_plan(K, ncols, H100_SMS)
    blocks, seen = _cover(K, ncols, width, splits)
    assert set(seen.values()) == {1}
    assert set(seen) == {(c, kb) for c in range(ncols) for kb in range(K // 32)}
    assert all(k1 > k0 for _, _, k0, k1 in blocks.values())
    for _ in range(1, 33):  # the plan reads shapes only: one grid for every M
        assert fused_plan.fused_plan(K, ncols, H100_SMS) == (width, splits)
        assert fused_blocks(K, ncols, width, splits) == blocks


@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("name", list(SHAPES))
def test_every_sm_has_work_in_one_wave(name, M):
    """At TinyLlama's shapes, for any M (the plan reads none), on an H100
    (SXM 132 SMs, PCIe 114, the full die 144): a block for every SM, at
    most two an SM, the two the kernel's launch bounds keep resident, in
    clusters of 2, 4 or 8. Whether the card keeps every cluster at once
    (a cluster stays within one GPC) is the card's answer:
    tests/test_torch_cuda.py test_fused_walk_grid_is_resident_in_one_wave
    and test_plan_keeps_the_grid_in_one_wave below."""
    K, ncols = SHAPES[name]
    for n_sm in (H100_SMS, 114, 144):
        width, splits = fused_plan.fused_plan(K, ncols, n_sm)
        blocks = len(fused_blocks(K, ncols, width, splits))
        assert 1 <= splits <= fused_plan.MAX_SPLITS  # a portable cluster
        assert splits & (splits - 1) == 0  # clusters of 2, 4, 8 pack the GPCs
        assert n_sm <= blocks <= 2 * n_sm


def test_plan_reads_host_sizes_only():
    plan = fused_plan.fused_plan
    assert [plan(K, n, H100_SMS) for K, n in SHAPES.values()] == [
        (128, 8), (128, 4), (64, 8)]
    assert plan(256, 384, H100_SMS) == (64, 4)  # too small to fill: the most
    assert plan(96, 64, H100_SMS) == (64, 2)  # K's steps, the last one half
    assert plan(8192, 64, H100_SMS) == (64, 8)
    with pytest.raises(ValueError, match="past"):
        plan(8256, 64, H100_SMS)
    with pytest.raises(TypeError):
        plan(torch.tensor(2048), 2560, H100_SMS)
    with pytest.raises(TypeError):
        plan(2048, 2560, 0)


def test_plan_keeps_the_grid_in_one_wave():
    """With the card's residency (an H100 keeps 30 clusters of 8 blocks at
    two blocks an SM, since a cluster stays within one GPC), w_down's 32
    tiles of 64 columns times 8 splits (256 blocks) would run a second
    wave: 16 tiles of 128 (128 blocks) run in one. wqkv and the gate/up
    pairs keep their plans; where nothing is resident, the plan of the
    most blocks that covers every SM."""
    clusters = {8: 30, 4: 64, 2: 132, 1: 264}
    plan = fused_plan.fused_plan
    assert [plan(K, n, H100_SMS, lambda w, s: clusters[s]) for K, n in SHAPES.values()] == [
        (128, 8), (128, 4), (128, 8)]
    assert plan(5632, 2048, H100_SMS, lambda w, s: 0) == (64, 8)
    assert plan(256, 384, H100_SMS, lambda w, s: clusters[s]) == (64, 4)


@pytest.mark.parametrize("K,ncols", [(96, 96), (320, 160), (1056, 288), (128, 32)])
def test_ragged_shapes_cover_once(K, ncols):
    """K with a last half step, output columns with a last half tile."""
    for width in fused_plan.WIDTHS:
        for splits in range(1, min(8, -(-K // 64)) + 1):
            _, seen = _cover(K, ncols, width, splits)
            assert set(seen.values()) == {1}
            assert set(seen) == {(c, kb) for c in range(ncols)
                                 for kb in range(K // 32)}


def _weight(kind, L, K, N, rng):
    w = torch.from_numpy(rng.standard_normal((L, N, K)).astype(np.float32) * 0.05)
    return quantize(w, kind, "kn")


def _inputs(kind, M, D, F, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, 1, D)).astype(np.float32)).to(
        torch.bfloat16)
    nw = torch.from_numpy(rng.random((2, D)).astype(np.float32) + 0.5)
    return x, nw, _weight(kind, 2, D, D + 128, rng), _weight(kind, 2, D, 2 * F, rng), \
        _weight(kind, 2, F, D, rng)


@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 32])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_split_model_matches_fused_norm_qkv_ref(kind, M):
    D, F = 384, 640
    x, nw, wqkv, _, _ = _inputs(kind, M, D, F, seed=M)
    layer = torch.tensor([1], dtype=torch.int32)
    cfg = tiny_test_config(n_embd=D, n_ffn=F)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    want = decode_fused.fused_norm_qkv_ref(x, nw, wqkv, layer, eps, inside)
    for splits in (1, 3, fused_plan.fused_plan(D, D + 128, H100_SMS)[1]):
        got = split_model(x.reshape(M, D), nw, wqkv, layer, splits, eps,
                                     inside)
        torch.testing.assert_close(got.to(torch.bfloat16).float(),
                                   want.reshape(M, -1).float(), **TOL)


@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 32])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
@pytest.mark.parametrize("normed", [True, False])
def test_split_model_matches_ffn_fused_ref(kind, M, normed):
    """Both phases of K7: gate/up split, silu(g) * up in f32 rounded to
    bf16 once, down split, the residual added to the f32 sum."""
    D, F = 384, 640
    x, nw, _, wgu, wdown = _inputs(kind, M, D, F, seed=100 + M)
    layer = torch.tensor([0], dtype=torch.int32)
    cfg = tiny_test_config(n_embd=D, n_ffn=F)
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    norm = nw if normed else None
    want = ffn_fused.ffn_fused_ref(x, norm, wgu, wdown, layer, cfg, eps, inside)
    x2 = x.reshape(M, D)
    for s_gu, s_down in ((1, 1), (3, 7), (fused_plan.fused_plan(D, F, H100_SMS)[1],
                                          fused_plan.fused_plan(F, D, H100_SMS)[1])):
        gu = split_model(x2, norm, wgu, layer, s_gu, eps, inside)
        g, up = gu[:, :F], gu[:, F:]
        act = (g / (1.0 + torch.exp(-g)) * up).to(torch.bfloat16)
        out = split_model(act, None, wdown, layer, s_down)
        if normed:
            out = x2.float() + out
        torch.testing.assert_close(out.to(torch.bfloat16).float(),
                                   want.reshape(M, D).float(), **TOL)


def test_split_model_sums_in_split_order():
    """Each split's partial is a product over its own K slice, and the
    statistic a sum over the splits' slices: the model equals the plain
    sums at one split, and a split of an exactly representable problem
    changes nothing."""
    rng = np.random.default_rng(3)
    K, N = 256, 64
    x = torch.from_numpy(rng.integers(-4, 5, (4, K)).astype(np.float32)).to(
        torch.bfloat16)
    w = QTensor(torch.from_numpy(rng.integers(-8, 9, (K, N)).astype(np.int8)),
                torch.ones((K // 32, N), dtype=torch.float16), "q8", "kn")
    want = x.float() @ w.data.float()
    for splits in (1, 2, 3, 4):
        assert torch.equal(split_model(x, None, w, None, splits), want)


# --- K1 qmm_smallm and K6 fused_out_residual on the walk -------------------

#: K1's launches (K, N): TinyLlama-1.1B's five decode matmuls (the
#: lm_head padded to 32,768 columns, as the engine pads it), Llama-3-8B's
#: and 70B's (config.py), the microbench's unpadded-to-2048 lm_head and a
#: ragged N
SMALLM_SHAPES = {
    "wqkv": (2048, 2560), "wo": (2048, 2048), "w_gateup": (2048, 11264),
    "w_down": (5632, 2048), "lm_head": (2048, 32768),
    "8b wqkv": (4096, 6144), "8b wo": (4096, 4096), "8b w_gateup": (4096, 28672),
    "8b w_down": (14336, 4096), "8b lm_head": (4096, 128256),
    "70b wqkv": (8192, 10240), "70b wo": (8192, 8192), "70b w_gateup": (8192, 57344),
    "70b w_down": (28672, 8192), "70b lm_head": (8192, 128256),
    "lm_head N=32004": (2048, 32004), "ragged N=300": (256, 300),
}
#: an H100's resident clusters of each size at two blocks an SM, and at
#: three (a cluster stays within one GPC)
H100_CLUSTERS = {8: 30, 4: 64, 2: 132, 1: 264}
H100_CLUSTERS_3 = {8: 45, 4: 99, 2: 198, 1: 396}


def smallm_plan(K, N, clusters=H100_CLUSTERS, aq8=False):
    return fused_plan.fused_plan(K, N, H100_SMS, lambda w, s: clusters[s],
                                 qmatmul.SMALLM_SPLIT_STEPS, H100_SMS // 32, aq8)


def _ranges_partition(ranges, end, unit):
    """Sorted [a, b) ranges tile [0, end) with no gap or overlap, each
    non-empty and starting on a multiple of `unit`."""
    ranges = sorted(set(ranges))
    assert ranges[0][0] == 0 and ranges[-1][1] == end
    assert all(b > a and a % unit == 0 for a, b in ranges)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    return len(ranges)


@pytest.mark.parametrize("name", list(SMALLM_SHAPES))
def test_smallm_plan_covers_every_column_and_block_once(name):
    """K1's grid is tiles x splits: the tiles partition the columns (in
    4-column groups), the splits partition K's 32-row blocks, each split
    a run of whole 64-row steps of at most SMALLM_SPLIT_STEPS, so every
    (column, 32-row block) is one block's, once; a cluster of 1 to 8
    splits, a power of two."""
    K, N = SMALLM_SHAPES[name]
    width, splits = smallm_plan(K, N)
    assert width in fused_plan.WIDTHS
    assert 1 <= splits <= fused_plan.MAX_SPLITS and splits & (splits - 1) == 0
    blocks = fused_blocks(K, N, width, splits)
    tiles = _ranges_partition([(c0, c1) for c0, c1, _, _ in blocks.values()], N, 4)
    cuts = _ranges_partition([(k0, k1) for _, _, k0, k1 in blocks.values()], K, 64)
    assert (tiles, cuts) == (-(-N // width), splits) and len(blocks) == tiles * cuts
    assert all(k1 - k0 <= qmatmul.SMALLM_SPLIT_STEPS * fused_plan.STEP
               for _, _, k0, k1 in blocks.values())
    assert all(k1 % 32 == 0 for _, _, _, k1 in blocks.values())
    if N * K <= 2048 * 2560:
        _, seen = _cover(K, N, width, splits)
        assert set(seen.values()) == {1} and len(seen) == N * (K // 32)


@pytest.mark.parametrize("aq8", [False, True])
@pytest.mark.parametrize("clusters", [H100_CLUSTERS, H100_CLUSTERS_3])
@pytest.mark.parametrize("name", list(SMALLM_SHAPES))
def test_smallm_plan_keeps_one_wave(name, clusters, aq8):
    """Where some plan keeps every cluster resident at once, K1's does;
    where a one-wave plan gives every SM a block (but n_sm / 32), K1's
    does too, at the widest tile that can; the lm_heads of Llama-3 and
    70B's w_down, which no plan runs in one wave, take the widest tile at
    the fewest splits."""
    K, N = SMALLM_SHAPES[name]
    width, splits = smallm_plan(K, N, clusters, aq8)
    steps = -(-K // fused_plan.STEP)
    cands = [(w, s) for w in fused_plan.WIDTHS for s in (1, 2, 4, 8)
             if s <= min(8, steps) and s * qmatmul.SMALLM_SPLIT_STEPS >= steps]

    def blocks(p):
        return -(-N // p[0]) * p[1]

    def one_wave(p):
        return blocks(p) <= clusters[p[1]] * p[1]

    waves = [p for p in cands if one_wave(p)]
    if not waves:
        assert (width, splits) == (128, min(s for _, s in cands)), name
        return
    assert one_wave((width, splits))
    full = [p for p in waves if blocks(p) >= H100_SMS - H100_SMS // 32]
    if full:
        assert blocks((width, splits)) >= H100_SMS - H100_SMS // 32
        assert width == max(w for w, _ in full)
    else:  # a small grid: the most blocks in one wave
        assert blocks((width, splits)) == max(map(blocks, waves))


def test_smallm_plan_reads_host_sizes_only():
    """The TinyLlama plans (w_down 16 tiles of 128 x 8 splits, the lm_head
    256 tiles of 128 unsplit; aq8 doubles w_gateup's splits where three
    blocks an SM keep 352 resident), equal to K5's and K7's at their
    shapes; K past the fused kernels' 8,192 rows takes longer slices up to
    SMALLM_MAX_K (Llama-3-70B's w_down, 28,672 rows); past it, or given a
    tensor, the plan raises."""
    names = ("wqkv", "wo", "w_gateup", "w_down", "lm_head")
    assert [smallm_plan(*SMALLM_SHAPES[n]) for n in names] == [
        (128, 8), (128, 8), (128, 2), (128, 8), (128, 1)]
    assert [smallm_plan(*SMALLM_SHAPES[n], H100_CLUSTERS_3, True) for n in names] == [
        (128, 8), (128, 8), (128, 4), (128, 8), (128, 1)]
    clusters = lambda w, s: H100_CLUSTERS[s]  # noqa: E731
    for K, N in SHAPES.values():
        assert smallm_plan(K, N) == fused_plan.fused_plan(K, N, H100_SMS, clusters)
    assert qmatmul.SMALLM_MAX_K == 8 * qmatmul.SMALLM_SPLIT_STEPS * 64 >= 28672
    assert smallm_plan(qmatmul.SMALLM_MAX_K, 4096)[1] == 8
    with pytest.raises(ValueError, match="past"):
        smallm_plan(qmatmul.SMALLM_MAX_K + 64, 4096)
    with pytest.raises(ValueError, match="past"):
        fused_plan.fused_plan(14336, 4096, H100_SMS)  # the fused kernels' slices
    with pytest.raises(TypeError):
        smallm_plan(torch.tensor(2048), 2560)


def _kn(kind, K, N, rng, L=None):
    """A kn weight of K rows (layer-stacked when L is given)."""
    ws = [_weight(kind, 1, K, N, rng) for _ in range(L or 1)]
    if L is None:
        return QTensor(ws[0].data[0], ws[0].scales[0], kind, "kn")
    return QTensor(torch.cat([w.data for w in ws]), torch.cat([w.scales for w in ws]),
                   kind, "kn")


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_split_model_matches_qmatmul_ref(kind, M, out_dtype):
    """K1 on the walk: the splits' partial products of x as given (no
    norm) added in split order, at row tile 8's exact regime, cast to the
    output dtype once, against ``qmatmul_ref``: a stacked weight with a
    ragged N (300: a last half tile and 4-column groups that are not
    16-byte rows) and an unstacked one (the lm_head's case), K with a last
    half step where the kind allows it, and a long K (16 steps a split
    past 8 of them, as Llama-3-8B's w_down takes)."""
    rng = np.random.default_rng(10 + M)
    K = 384 if kind == "q4g" else 352
    cases = [(_kn(kind, K, 300, rng, L=2), torch.tensor([1], dtype=torch.int32), K),
             (_kn(kind, 256, 132, rng), None, 256),
             (_kn(kind, 16896, 68, rng), None, 16896)]
    for w, layer, Kw in cases:
        x2 = torch.from_numpy(rng.standard_normal((M, Kw)).astype(np.float32)).to(
            torch.bfloat16)
        want = qmatmul.qmatmul_ref(x2, w, out_dtype, layer)
        plan_splits = smallm_plan(Kw, w.data.shape[-1])[1]
        for splits in sorted({1, 3, plan_splits}):
            if splits > -(-Kw // fused_plan.STEP):
                continue
            got = split_model(x2, None, w, layer, splits).to(out_dtype)
            assert got.dtype == want.dtype == out_dtype
            torch.testing.assert_close(got.float(), want.float(), **TOL)


# The aq8 walk's registers, modelled: the A fragment of the s8 product is
# built from ldmatrix.trans of the raw byte-rows by byte permutes, the B
# fragment read from x's quantized bytes where the quantizer put them
# (fused_walk.cuh step_product_aq8 and aq8_slot).


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm(a, b, sel): byte i of the result is byte (sel >>
    4 i) & 7 of the 8 bytes b:a."""
    src = (a & 0xFFFFFFFF) | ((b & 0xFFFFFFFF) << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _minus7(v):
    return (((v | 0x80808080) - 0x07070707) ^ 0x80808080) & 0xFFFFFFFF


def _aq8_slot(p):
    return (p & 16) + 4 * ((p >> 1) & 3) + 2 * ((p >> 3) & 1) + (p & 1)


def _bytes(vals):
    return sum((int(v) & 0xFF) << (8 * i) for i, v in enumerate(vals))


def _signed_bytes(word):
    return [((word >> (8 * i)) & 0xFF) - (256 if (word >> (8 * i)) & 0x80 else 0)
            for i in range(4)]


def fragment_dots(rows, xq, bits):
    """The int32 dots of one warp's 32-row block and 16 columns as the aq8
    walk forms them. rows: the block's raw byte-rows of the 16 columns (q8
    int8 [32, 16]; 4 bits uint8 nibble bytes [16, 16]); xq: int8 [8, 32]
    quantized x rows. Returns [16 columns, 8 rows] int64."""
    rows = rows.astype(np.int64) & 0xFF
    xs = np.zeros((8, 32), np.int64)
    for p in range(32):  # the quantizer's store
        xs[:, _aq8_slot(p)] = xq[:, p]
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4

        def trans(i):  # ldmatrix.trans word i: byte-rows 8 i + 2 t, + 1
            r0, r1 = rows[8 * i + 2 * t], rows[8 * i + 2 * t + 1]
            return _bytes([r0[2 * g], r0[2 * g + 1], r1[2 * g], r1[2 * g + 1]])

        if bits == 8:
            r = [trans(i) for i in range(4)]
        else:
            q = [trans(0), trans(1)]
            r = [_minus7((v >> 4) & 0x0F0F0F0F) for v in q] + \
                [_minus7(v & 0x0F0F0F0F) for v in q]
        a = [_byte_perm(r[0], r[1], 0x6420), _byte_perm(r[0], r[1], 0x7531),
             _byte_perm(r[2], r[3], 0x6420), _byte_perm(r[2], r[3], 0x7531)]
        for j, (v0, v1, v2, v3) in enumerate(zip(*map(_signed_bytes, a))):
            A[g, 4 * t + j], A[g + 8, 4 * t + j] = v0, v1
            A[g, 16 + 4 * t + j], A[g + 8, 16 + 4 * t + j] = v2, v3
            B[4 * t + j, g], B[16 + 4 * t + j, g] = xs[g, 4 * t + j], xs[g, 16 + 4 * t + j]
    D = A @ B  # mma.sync m16n8k32: A row r < 8 is column 2 r, r + 8 is 2 r + 1
    return np.stack([D[c // 2 + 8 * (c % 2)] for c in range(16)])


@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_aq8_fragment_dots_are_exact(kind):
    """The A and B fragments the walk builds pair each K-row of a column
    with the same K-row of x: every 32-row block's int32 dot equals the
    integer dot of the quantized x with the weight's values (q, or v - 7),
    bit for bit, at the extremes of both ranges too."""
    rng = np.random.default_rng(7)
    for trial in range(4):
        xq = rng.integers(-127, 128, (8, 32))
        if kind == "q8":
            w = rng.integers(-128, 128, (32, 16))
            if trial == 0:
                w[:], xq[:] = -128, -127
            rows, vals = w, w
        else:
            v = rng.integers(0, 16, (32, 16))
            if trial == 0:
                v[:], xq[:] = 0, 127
            rows = (v[:16] << 4) | v[16:]  # byte-row j: K-rows j and j + 16
            vals = v - 7
        got = fragment_dots(rows, xq, 8 if kind == "q8" else 4)
        assert np.array_equal(got, vals.T @ xq.T)
    assert sorted(map(_aq8_slot, range(32))) == list(range(32))


def aq8_split_model(x2, w, layer, splits):
    """K1-aq8's arithmetic on the walk: each split quantizes its own
    slice of x per 32-block (a block's absmax is its own), takes each
    block's exact integer dot, and adds (float(dot) * x scale) * weight
    scale into its f32 sum in block order; the splits' sums are added in
    split order. Returns (the int64 dots [blocks, M, N], the f32 sums)."""
    M, K = x2.shape
    steps = -(-K // fused_plan.STEP)
    cuts = [min(s * steps // splits * fused_plan.STEP, K) for s in range(splits + 1)]
    data, scales = qmatmul._layer_view(w, layer)
    wv = qmatmul.int_values(data, w.kind).long()
    dots, out = [], torch.zeros(M, wv.shape[1])
    for a, b in zip(cuts, cuts[1:]):
        xq, sx = qmatmul.quantize_x(x2[:, a:b])
        part = torch.zeros(M, wv.shape[1])
        for j in range((b - a) // 32):
            k = a + 32 * j
            d = xq[:, 32 * j:32 * j + 32].long() @ wv[k:k + 32]
            dots.append(d)
            part = part + (d.float() * sx[:, j:j + 1]) * scales[k >> (
                7 if w.kind == "q4g" else 5)].float()
        out = out + part
    return torch.stack(dots), out


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_aq8_split_model_matches_plain(kind, M, out_dtype):
    """Quantizing each split's slice gives the plain version's int8 x
    (``quantize_x`` over the whole row): every block's int32 dot is bit
    for bit the plain one's, and the f32 sums agree with ``qmatmul_ref``
    (aq8) at the bf16 tolerance (only the order of the f32 additions
    differs)."""
    rng = np.random.default_rng(20 + M)
    w = _kn(kind, 352, 300, rng, L=2)
    layer = torch.tensor([1], dtype=torch.int32)
    x2 = torch.from_numpy(rng.standard_normal((M, 352)).astype(np.float32)).to(
        torch.bfloat16)
    x2[0, 64:96] = 0  # an all-zero block: scale 0, q 0
    xq, _ = qmatmul.quantize_x(x2)
    wv = qmatmul.int_values(w.data[1], kind).long()
    plain = torch.stack([xq[:, k:k + 32].long() @ wv[k:k + 32] for k in range(0, 352, 32)])
    want = qmatmul.qmatmul_ref(x2, w, out_dtype, layer, aq8=True)
    for splits in (1, 3, smallm_plan(352, 300)[1]):
        dots, sums = aq8_split_model(x2, w, layer, splits)
        assert torch.equal(dots, plain)
        torch.testing.assert_close(sums.to(out_dtype).float(), want.float(), **TOL)


@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 32])
@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_split_model_matches_fused_out_residual_ref(kind, M):
    """K6 on the walk: the splits' partials of attn @ wo added in split
    order (row tile 8 exact, 16 and 32 the bf16 weight), the residual
    added to the f32 sum once, cast to bf16 once, against
    ``fused_out_residual_ref``."""
    D = 384
    rng = np.random.default_rng(30 + M)
    wo = _kn(kind, D, D, rng, L=2)
    a, r = (torch.from_numpy(rng.standard_normal((M, 1, D)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    layer = torch.tensor([1], dtype=torch.int32)
    want = decode_fused.fused_out_residual_ref(a, r, wo, layer)
    for splits in (1, 3, fused_plan.fused_plan(D, D, H100_SMS)[1]):
        out = split_model(a.reshape(M, D), None, wo, layer, splits,
                          residual=r.reshape(M, D))
        torch.testing.assert_close(out.to(torch.bfloat16).float(),
                                   want.reshape(M, D).float(), **TOL)
