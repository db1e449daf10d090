"""The grid of the fused decode-layer walk (K5 ``fused_norm_qkv``, both
phases of K7 ``ffn_fused``; csrc/fused_walk.cuh), from shapes only.

A launch covers the output columns in tiles of 64 or 128 columns (a
64- or 128-byte strip of each weight byte-row, in q8 and in 4 bits
alike; K7's gate/up tile pairs gate columns [j, j + w) with up columns
[F + j, F + j + w)) and splits the K walk, in steps of ``STEP`` rows,
over the blocks of one thread-block cluster (at most ``MAX_SPLITS``, the
portable size). The plan comes from the shapes, the card's SM count and
the residency of the launch (the kind and row tile of M) alone, never
from a tensor, so a captured decode step replays at any layer.

``fused_plan`` takes the widest tile, then the fewest splits (a power of
two) that give every SM a block with the whole grid resident in one
wave; where no plan does both (TinyLlama's w_down on an H100: 32 tiles
of 64 columns times 8 splits are 256 blocks, but the card keeps 30
clusters of 8 at once, since a cluster stays within one GPC), the one
wave comes first. Whether a grid is resident is the card's answer, not a
model's: each library exports the count of clusters its launch shape
keeps resident (``fused_norm_qkv_resident``, ``ffn_fused_resident``),
which the wrappers pass in. Split s of a tile walks the K steps
[s * steps // splits, (s + 1) * steps // splits).
"""

from __future__ import annotations

#: the tile widths the kernel is built for, widest first
WIDTHS = (128, 64)
#: K-rows of a step; a split is a run of whole steps
STEP = 64
#: splits of a tile: one cluster, at most the portable cluster size
MAX_SPLITS = 8
#: most steps a split stages (x slices of at most 1,024 rows)
MAX_SPLIT_STEPS = 16


def _positive(*vals) -> None:
    for v in vals:
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise TypeError(f"the fused plan takes positive ints, got {v!r}")


def fused_plan(K: int, ncols: int, n_sm: int, resident=None) -> tuple[int, int]:
    """(tile width, K splits) for `ncols` output columns (a gate/up pair
    counts its F) over K rows, on a card of `n_sm` SMs. The candidates:
    each width of ``WIDTHS`` with each power of two of splits from the
    least that keeps a split's x slice within MAX_SPLIT_STEPS steps to
    at most MAX_SPLITS and K's steps. Of those whose blocks the card keeps
    resident at once (``resident(width, splits)`` clusters of `splits`
    blocks, the card's answer; without it two blocks an SM, the kernel's
    launch bounds), the first, widest tile and then fewest splits, that
    gives every SM a block; else the one with the most blocks, then the
    fewest splits, then the narrowest tile. Host sizes only: a tensor
    raises."""
    _positive(K, ncols, n_sm)
    steps = -(-K // STEP)
    most = min(MAX_SPLITS, steps)
    least = 1
    while least * MAX_SPLIT_STEPS < steps:
        least *= 2
    if least > most:
        raise ValueError(f"K = {K} is past the fused kernels' "
                         f"{MAX_SPLITS * MAX_SPLIT_STEPS * STEP} rows")
    splits = [least]
    while 2 * splits[-1] <= most:
        splits.append(2 * splits[-1])
    plans = [(w, s) for w in WIDTHS for s in splits]

    def blocks(plan):
        return -(-ncols // plan[0]) * plan[1]

    def one_wave(plan):
        held = 2 * n_sm if resident is None else resident(*plan) * plan[1]
        return blocks(plan) <= held

    plans = [p for p in plans if one_wave(p)] or plans
    full = [p for p in plans if blocks(p) >= n_sm]
    if full:
        return full[0]
    return max(plans, key=lambda p: (blocks(p), -p[1], -p[0]))
