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
"""

import collections

import numpy as np
import pytest
import torch

from tinyllama_tpu_torch.config import tiny_test_config
from tinyllama_tpu_torch.ops.kernels import decode_fused, ffn_fused, fused_plan, qmatmul
from tinyllama_tpu_torch.ops.precision import exact_f32
from tinyllama_tpu_torch.quant.codec import QTensor, dequantize, quantize

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


def split_model(x2, norm_w, w, layer, splits, eps=0.0, inside=False):
    """The kernel's split arithmetic on the plain path: x2 [M, K] (normed
    in the walk when norm_w, the [L, K] table, is given) against the
    layer's dequantized weight, its K walk cut as ``fused_blocks`` cuts
    it. With a norm each split's f32 sum of squares of its slice is added
    in split order into the rms statistic; each split's f32 partial
    product is added in split order. Returns the f32 [M, N] sums."""
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
    return out


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
