"""The split-key decode attention shared by K4 and K10 (csrc/decode_split.cu).

K4 ``flash_decode_heads_attention`` (ops/kernels/flash_attention.py) and
K10 ``flash_paged_attention`` (ops/kernels/flash_paged.py) launch one
kernel template whose grid is (n_split, Kh, B): each block walks a
contiguous share of ceil(n_tiles / n_split) of its row's visible 64-key
tiles through a ring of cp.async stages and writes a partial (m, l, acc)
to a workspace; the last block of a (row, kv head) to arrive merges the
partials, in the same launch. This module holds what the two wrappers
share on the host: the split count, the workspace, the launch, and a
plain model of the split-and-merge arithmetic that the tests hold against
the JAX kernels and the plain versions.

The split count reads host-known sizes only, never pos: a decode step is
captured in a CUDA graph once and replayed at every later position. The
merge counts arrivals in a device array of the library, so calls on one
device run in stream order (as the port's do), never on two streams at
once; the f32 kind's shared-memory attribute is set on the device of
the process's first call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.kernels.qmatmul import layer_index, sm_count
from tinyllama_tpu_torch.ops.precision import exact_f32

#: keys per tile of the walk
KEY_TILE = 64
#: f32 values of one partial: m, l, then acc over d = 64
PARTIAL = 66
#: blocks an SM the split count aims at
BLOCKS_PER_SM = 2
#: most splits a row takes: one warp merges them, a lane a partial
MAX_SPLITS = 32
#: the kernels' running-max start (online_softmax.cuh TL_NEG_INF)
NEG_INF = -0.7 * torch.finfo(torch.float32).max

_P = ctypes.c_void_p
_I = ctypes.c_int


def decode_splits(B: int, Kh: int, cap_tiles: int, n_sm: int) -> int:
    """Blocks each (row, kv head) splits its key walk over: about
    BLOCKS_PER_SM blocks an SM over the B * Kh groups, at least 1 and at
    most MAX_SPLITS and the row's capacity in tiles. Host sizes only: a
    tensor raises."""
    for x in (B, Kh, cap_tiles, n_sm):
        if not isinstance(x, int) or isinstance(x, bool) or x < 1:
            raise TypeError(f"decode_splits takes positive ints, got {x!r}")
    most = min(cap_tiles, MAX_SPLITS)
    return max(1, min(most, -(-BLOCKS_PER_SM * n_sm // (B * Kh))))


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_split")
    if lib.flash_decode_heads.argtypes is None:
        lib.flash_decode_heads.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        lib.flash_paged.argtypes = [_P] * 10 + [_I] * 9 + [_P]
        lib.flash_decode_heads.restype = lib.flash_paged.restype = _I
    return lib


def launch(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scales, ints, kind: int, sizes, cap_tiles: int) -> torch.Tensor:
    """One call of the split kernel `entry` ("flash_decode_heads" or
    "flash_paged"): q [B, 1, H, d] and the planes already checked by the
    wrapper; `ints` the index tensors in the entry's order; `sizes` its
    int arguments between the kind and n_split. Returns the output."""
    B, _, H, _ = q.shape
    Kh = k.shape[2]
    if any(s is not None and s.data_ptr() % 16 for s in scales):
        raise ValueError("int8 cache scales must lie on 16-byte boundaries "
                         "(cp.async copies)")
    n_split = decode_splits(B, Kh, cap_tiles, sm_count(q.device))
    ws = torch.empty((B, H, n_split, PARTIAL), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    err = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *[None if s is None else s.data_ptr() for s in scales],
        *[t.data_ptr() for t in ints], ws.data_ptr(), out.data_ptr(), kind,
        *sizes, n_split, build.stream_ptr(q))
    build.check(err, entry)
    return out


def split_decode_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale, v_scale, pos: torch.Tensor,
                       n_split: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for tests: q [B, 1, H, d]
    against one layer's raw planes k, v [B, Kh, N, d] (bf16, f16, f32, or
    int8 with f32 scales [B, Kh, N]), keys <= pos[b]. Row b's n_tiles =
    min(pos // 64 + 1, N // 64) tiles go to n_split shares of
    ceil(n_tiles / n_split) tiles, the last shares empty. Each share runs
    the online softmax a tile at a time (probabilities rounded to bf16
    for bf16 queries, the int8 scales folded as kvkind.cuh folds them)
    from its own running max; the merge rescales each share by exp(m_i -
    M), and an empty share weighs 0. Returns [B, 1, H, d] in q.dtype."""
    B, _, H, d = q.shape
    Kh, N = k.shape[1], k.shape[2]
    G = H // Kh
    low = q.dtype == torch.bfloat16
    dev = q.device
    i8 = k.dtype == torch.int8

    def values(x):  # int8, bf16, f16 exact in f32; rounded to bf16 if low
        x = x.float()
        return x.to(torch.bfloat16).float() if low else x

    def tile(x, keys):  # [B, Kh, N(, d)] at each row's keys [B, 64]
        idx = keys.clamp(max=N - 1)[:, None, :]
        if x.dim() == 4:
            idx = idx[..., None].expand(B, Kh, KEY_TILE, d)
        else:
            idx = idx.expand(B, Kh, KEY_TILE)
        return torch.take_along_dim(x, idx, dim=2)

    qf = q.reshape(B, Kh, G, d).float()
    pos = pos.reshape(B).long().to(dev)
    n_tiles = torch.clamp(pos // KEY_TILE + 1, max=N // KEY_TILE)
    share = -(-n_tiles // n_split)
    lane = torch.arange(KEY_TILE, device=dev)
    scale = 1.0 / math.sqrt(d)
    parts = []
    with exact_f32():
        for s in range(n_split):
            t0 = s * share
            t1 = torch.minimum(t0 + share, n_tiles)
            m = torch.full((B, Kh, G), NEG_INF, device=dev)
            l = torch.zeros((B, Kh, G), device=dev)
            acc = torch.zeros((B, Kh, G, d), device=dev)
            for i in range(int((t1 - t0).clamp(min=0).max())):
                t = t0 + i
                keys = t[:, None] * KEY_TILE + lane  # [B, 64]
                sc = torch.einsum("bkgd,bksd->bkgs", qf, values(tile(k, keys)))
                sc = sc * scale
                if i8:
                    sc = sc * tile(k_scale, keys)[:, :, None, :]
                vis = (keys <= pos[:, None])[:, None, None, :]
                mx = torch.where(vis, sc, NEG_INF).amax(-1)
                m_new = torch.maximum(m, mx)
                alpha = torch.exp(m - m_new)
                p = torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0)
                l_new = l * alpha + p.sum(-1)
                pr = p.to(torch.bfloat16).float() if low else p
                if i8:
                    pr = pr * tile(v_scale, keys)[:, :, None, :]
                acc_new = acc * alpha[..., None] + torch.einsum(
                    "bkgs,bksd->bkgd", pr, values(tile(v, keys)))
                live = (t < t1)[:, None, None]
                m = torch.where(live, m_new, m)
                l = torch.where(live, l_new, l)
                acc = torch.where(live[..., None], acc_new, acc)
            parts.append((m, l, acc))
        m = torch.stack([p[0] for p in parts])
        w = torch.exp(m - m.amax(0))
        l = (w * torch.stack([p[1] for p in parts])).sum(0)
        acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
        out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(B, 1, H, d).to(q.dtype)


def decode_heads_model(q: torch.Tensor, cache, layer, pos: torch.Tensor,
                       n_split: int) -> torch.Tensor:
    """split_decode_model over layer `layer` of a monolithic KVCache: K4's
    arithmetic."""
    li = layer_index(layer)
    scales = ((cache.k_scale[li], cache.v_scale[li]) if cache.quantized
              else (None, None))
    return split_decode_model(q, cache.k[li], cache.v[li], *scales, pos, n_split)


def paged_model(q: torch.Tensor, cache, layer, pos: torch.Tensor,
                n_split: int) -> torch.Tensor:
    """split_decode_model over layer `layer` of a PagedKVCache, its pages
    gathered through the table in logical order: K10's arithmetic."""
    li = layer_index(layer)
    tbl = cache.table.long()
    B, J = tbl.shape

    def gather(plane):  # [NP, Kh, P(, d)] -> [B, Kh, J * P(, d)]
        g = plane[li][tbl]
        return g.transpose(1, 2).reshape(B, g.shape[2], J * g.shape[3],
                                         *g.shape[4:])

    scales = ((gather(cache.k_scale), gather(cache.v_scale)) if cache.quantized
              else (None, None))
    return split_decode_model(q, gather(cache.k), gather(cache.v), *scales, pos,
                              n_split)
