"""The grid of the walk of csrc/fused_walk.cuh (K5 ``fused_norm_qkv``, K6
``fused_out_residual``, both phases of K7 ``ffn_fused`` and K1
``qmm_smallm``), from shapes only.

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
keeps resident (``fused_norm_qkv_resident``, ``fused_out_residual_resident``,
``ffn_fused_resident``, ``qmm_smallm_resident``), which the wrappers pass
in. Split s of a tile walks the K steps
[s * steps // splits, (s + 1) * steps // splits). A split of K5-K7
stages at most MAX_SPLIT_STEPS steps of x.

K1's launches (``qmatmul.smallm_plan``) run at row tile 8 with no norm
and take the same plan with three numbers of their own, from a sweep of
every plan on the card (PERF.md §6): up to SMALLM_SPLIT_STEPS steps a
split (K up to 49,152 rows), every SM a block but n_sm / 32, and with
aq8 (whose s8 products take fewer instructions than the bf16 ones) twice
the splits where that grid is still one wave.
"""

from __future__ import annotations

#: the tile widths the kernel is built for, widest first
WIDTHS = (128, 64)
#: K-rows of a step; a split is a run of whole steps
STEP = 64
#: splits of a tile: one cluster, at most the portable cluster size
MAX_SPLITS = 8
#: most steps a split of K5-K7 stages (x slices of at most 1,024 rows)
MAX_SPLIT_STEPS = 16
#: most steps a split of K1 stages (6,144 rows, within a block's shared
#: memory with K1's ring)
SMALLM_SPLIT_STEPS = 96


def _positive(*vals) -> None:
    for v in vals:
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise TypeError(f"the fused plan takes positive ints, got {v!r}")


def fused_plan(K: int, ncols: int, n_sm: int, resident=None,
               max_split_steps: int = MAX_SPLIT_STEPS, slack: int = 0,
               aq8: bool = False) -> tuple[int, int]:
    """(tile width, K splits) for `ncols` output columns (a gate/up pair
    counts its F) over K rows, on a card of `n_sm` SMs. The candidates:
    each width of ``WIDTHS`` with each power of two of splits from the
    least that keeps a split's x slice within `max_split_steps` steps to
    at most MAX_SPLITS and K's steps. Of those whose blocks the card keeps
    resident at once (``resident(width, splits)`` clusters of `splits`
    blocks, the card's answer; without it two blocks an SM, the kernel's
    launch bounds), the first, widest tile and then fewest splits, that
    gives every SM but `slack` a block, with `aq8` at twice those splits
    where that is still one wave; else the one with the most blocks, then
    the fewest splits, then the narrowest tile. Where no plan is one wave,
    the fewest waves, then the most blocks. Host sizes only: a tensor
    raises."""
    _positive(K, ncols, n_sm, max_split_steps)
    steps = -(-K // STEP)
    most = min(MAX_SPLITS, steps)
    least = 1
    while least * max_split_steps < steps:
        least *= 2
    if least > most:
        raise ValueError(f"K = {K} is past the kernel's "
                         f"{MAX_SPLITS * max_split_steps * STEP} rows")
    splits = [least]
    while 2 * splits[-1] <= most:
        splits.append(2 * splits[-1])
    plans = [(w, s) for w in WIDTHS for s in splits]

    def blocks(plan):
        return -(-ncols // plan[0]) * plan[1]

    def held(plan):
        return 2 * n_sm if resident is None else resident(*plan) * plan[1]

    waves = [p for p in plans if blocks(p) <= held(p)]
    if not waves:
        return min(plans, key=lambda p: (-(-blocks(p) // held(p)) if held(p) else
                                          float("inf"), -blocks(p)))
    full = [p for p in waves if blocks(p) >= n_sm - slack]
    if full:
        width, s = full[0]
        return (width, 2 * s) if aq8 and (width, 2 * s) in waves else (width, s)
    return max(waves, key=lambda p: (blocks(p), -p[1], -p[0]))
