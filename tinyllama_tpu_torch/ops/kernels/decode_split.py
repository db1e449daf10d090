"""The split-key single-token attention of K4, K9, K10 and K11
(csrc/decode_split.cu).

K4 ``flash_decode_heads_attention`` and K9 ``flash_staged_attention``
(ops/kernels/flash_attention.py), K10 ``flash_paged_attention`` and K11
``flash_paged_staged_attention`` (ops/kernels/flash_paged.py) launch one
kernel template whose grid is (Kh, B, n_split): each block walks a
contiguous share of ceil(n_tiles / n_split) of its row's visible 64-key
tiles through a ring of cp.async stages and writes a partial (m, l, acc)
to a workspace; the last block of a (row, kv head) to arrive merges the
partials, in the same launch. K4 and K10 walk the row's keys <= pos in
the slab or the page pool; K9 and K11, a staged decode chunk's, walk the
slab's or pool's tiles below the chunk's base, then the staged tail's
tiles up to slot pos - base. This module holds what the four wrappers
share on the host: the split count, the workspace, the launch, and plain
models of the split-and-merge arithmetic that the tests hold against the
JAX kernels and the plain versions.

The split count reads host-known sizes only, never pos or base: a decode
step is captured in a CUDA graph once and replayed at every later
position and chunk. The merge counts arrivals in a device array of the
library, so calls on one device run in stream order (as the port's do),
never on two streams at once; the f32 kind's shared-memory attribute is
set on the device of the process's first call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.kernels.qmatmul import layer_index, sm_count
from tinyllama_tpu_torch.ops.precision import exact_f32
from tinyllama_tpu_torch.runtime.paged import PagedKVCache

#: keys per tile of the walk
KEY_TILE = 64
#: blocks an SM the split count aims at (chosen on the card: with the
#: tensor-core products a block walks a tile in well under a microsecond,
#: and every block past one an SM costs more in launch and merge than it
#: saves)
BLOCKS_PER_SM = 1
#: tiles a share holds at least, at the row's capacity (chosen on the card:
#: a block of one tile pays the ring's fill and its warps' merge for one
#: tile, and at batch 1 and pos 2047, 32 one-tile shares took 5-8% longer
#: than 16 two-tile ones in every KV kind)
MIN_SHARE = 2
#: most splits a row takes: one warp merges them, a lane a partial
MAX_SPLITS = 32
#: a row of at most this many tiles is one block's (decode_split.cu)
SOLO_TILES = 7
#: the kernels' running-max start (online_softmax.cuh TL_NEG_INF)
NEG_INF = -0.7 * torch.finfo(torch.float32).max

_P = ctypes.c_void_p
_I = ctypes.c_int


def decode_splits(B: int, Kh: int, cap_tiles: int, n_sm: int) -> int:
    """Blocks each (row, kv head) splits its key walk over: about
    BLOCKS_PER_SM blocks an SM over the B * Kh groups (rounded up), at
    least 1 and at most MAX_SPLITS and the row's capacity in tiles over
    MIN_SHARE (rounded up). Host sizes only: a tensor raises."""
    for x in (B, Kh, cap_tiles, n_sm):
        if not isinstance(x, int) or isinstance(x, bool) or x < 1:
            raise TypeError(f"decode_splits takes positive ints, got {x!r}")
    most = min(-(-cap_tiles // MIN_SHARE), MAX_SPLITS)
    return max(1, min(most, -(-BLOCKS_PER_SM * n_sm // (B * Kh))))


#: each entry point's (pointer, int) argument counts before the stream
_ENTRIES = {"flash_decode_heads": (9, 7), "flash_paged": (10, 9),
            "flash_staged": (14, 8), "flash_paged_staged": (15, 10)}


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_split")
    if lib.flash_decode_heads.argtypes is None:
        for name, (n_ptr, n_int) in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
            fn.restype = _I
    return lib


def partial_floats(d: int) -> int:
    """f32 values of one partial in the workspace: m, l, then acc over
    the head dim d (34 at d = 32, 66 at d = 64, 130 at d = 128)."""
    return d + 2


def tail_tiles(Cs: int) -> int:
    """Key tiles of a staged tail of Cs slots: ceil(Cs / 64)."""
    return -(-Cs // KEY_TILE)


def launch(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scales, ints, kind: int, sizes, cap_tiles: int,
           tail=()) -> torch.Tensor:
    """One call of the split kernel `entry` (a key of _ENTRIES): q [B, 1,
    H, d] and the planes already checked by the wrapper; `tail` the staged
    planes (sk, sv) of K9 and K11, else empty; `scales` the scale planes
    of k, v (and sk, sv) or None each; `ints` the index tensors in the
    entry's order; `sizes` its int arguments between the kind and
    n_split; `cap_tiles` the row's capacity in key tiles, a tail's
    counted. Returns the output."""
    B, _, H, d = q.shape
    Kh = k.shape[2]
    if any(s is not None and s.data_ptr() % 16 for s in scales):
        raise ValueError("int8 cache scales must lie on 16-byte boundaries "
                         "(cp.async copies)")
    n_split = decode_splits(B, Kh, cap_tiles, sm_count(q.device))
    ws = torch.empty((B, H, n_split, partial_floats(d)), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    err = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *[t.data_ptr() for t in tail],
        *[None if s is None else s.data_ptr() for s in scales],
        *[t.data_ptr() for t in ints], ws.data_ptr(), out.data_ptr(), kind,
        *sizes, n_split, build.stream_ptr(q))
    build.check(err, entry)
    return out


def _split_walk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale,
                v_scale, n_tiles: torch.Tensor, tile_at,
                n_split: int) -> torch.Tensor:
    """The kernel's walk and merge in plain PyTorch: q [B, 1, H, d]
    against planes k, v [B, Kh, N, d] (bf16, f16, f32, or int8 with f32
    scales [B, Kh, N]). Row b has n_tiles[b] tiles; tile_at(t), for tile
    indices t [n_split, B] (share s of row b at t[s, b]), gives each
    one's first key and count of visible keys (key0, n_ok of t's shape).
    A row of at most SOLO_TILES tiles is one share, else the tiles go to
    n_split shares of ceil(n_tiles / n_split), the last shares empty.
    Each share runs the online softmax a tile at a time from its own
    running max: for bf16 queries the keys, the probabilities and the
    values are rounded to bf16 for the products, int8 keys and values
    after their scale (k * ks, v * vs; kvkind.cuh); the merge rescales
    each share by exp(m_i - M), an empty
    share weighs 0, and a row with no tile is 0. (The kernel also splits
    each tile's keys over its warps; that order of f32 sums is not
    modelled.) Returns [B, 1, H, d] in q.dtype."""
    B, _, H, d = q.shape
    Kh, N = k.shape[1], k.shape[2]
    G = H // Kh
    low = q.dtype == torch.bfloat16
    dev = q.device
    i8 = k.dtype == torch.int8

    def values(x, scale=None):  # f32 (int8 times its scale), to bf16 if low
        x = x.float() if scale is None else x.float() * scale[..., None]
        return x.to(torch.bfloat16).float() if low else x

    def tile(x, keys):  # [B, Kh, N(, d)] at keys [S, B, 64] -> [S, B, Kh, 64(, d)]
        idx = keys.clamp(0, N - 1)[:, :, None, :]
        src = x[None].expand(n_split, *x.shape)
        if x.dim() == 4:
            idx = idx[..., None].expand(n_split, B, Kh, KEY_TILE, d)
        else:
            idx = idx.expand(n_split, B, Kh, KEY_TILE)
        return torch.gather(src, 3, idx)

    # every share at once: share s of row b walks tiles t0[s, b] + i
    qf = q.reshape(B, Kh, G, d).float()
    n_tiles = n_tiles.long().to(dev)
    share = torch.where(n_tiles <= SOLO_TILES, n_tiles, -(-n_tiles // n_split))
    t0 = torch.arange(n_split, device=dev)[:, None] * share  # [S, B]
    t1 = torch.minimum(t0 + share, n_tiles)
    lane = torch.arange(KEY_TILE, device=dev)
    scale = 1.0 / math.sqrt(d)
    with exact_f32():
        m = torch.full((n_split, B, Kh, G), NEG_INF, device=dev)
        l = torch.zeros((n_split, B, Kh, G), device=dev)
        acc = torch.zeros((n_split, B, Kh, G, d), device=dev)
        for i in range(int((t1 - t0).clamp(min=0).max())):
            t = t0 + i
            key0, n_ok = tile_at(t)
            keys = key0[..., None] + lane  # [S, B, 64]
            kk = values(tile(k, keys), tile(k_scale, keys) if i8 else None)
            sc = torch.einsum("bkgd,sbkjd->sbkgj", qf, kk) * scale
            vis = (lane < n_ok[..., None])[:, :, None, None, :]
            mx = torch.where(vis, sc, NEG_INF).amax(-1)
            m_new = torch.maximum(m, mx)
            alpha = torch.exp(m - m_new)
            p = torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0)
            l_new = l * alpha + p.sum(-1)
            pr = p.to(torch.bfloat16).float() if low else p
            vv = values(tile(v, keys), tile(v_scale, keys) if i8 else None)
            acc_new = acc * alpha[..., None] + torch.einsum(
                "sbkgj,sbkjd->sbkgd", pr, vv)
            live = (t < t1)[:, :, None, None]
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live[..., None], acc_new, acc)
        w = torch.exp(m - m.amax(0))
        l = (w * l).sum(0)
        acc = (w[..., None] * acc).sum(0)
        out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(B, 1, H, d).to(q.dtype)


def split_decode_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale, v_scale, pos: torch.Tensor,
                       n_split: int) -> torch.Tensor:
    """K4's and K10's arithmetic in plain PyTorch, for tests: q [B, 1, H,
    d] against one layer's raw planes k, v [B, Kh, N, d] (bf16, f16, f32,
    or int8 with f32 scales [B, Kh, N]), keys <= pos[b]: row b's n_tiles
    = min(pos // 64 + 1, N // 64) tiles through _split_walk's shares and
    merge. Returns [B, 1, H, d] in q.dtype."""
    N = k.shape[2]
    pos = pos.reshape(-1).long().to(q.device)
    n_tiles = torch.clamp(pos // KEY_TILE + 1, max=N // KEY_TILE)
    return _split_walk(q, k, v, k_scale, v_scale, n_tiles,
                       lambda t: (t * KEY_TILE, pos + 1 - t * KEY_TILE),
                       n_split)


def _layer_planes(cache, li: int):
    """Layer li of a KVCache or PagedKVCache as [B, Kh, N, d] k, v (pages
    gathered through the table in logical order) and their int8 scales
    [B, Kh, N] (None, None unless int8)."""
    if isinstance(cache, PagedKVCache):
        tbl = cache.table.long()
        B, J = tbl.shape

        def layer(plane):  # [NP, Kh, P(, d)] -> [B, Kh, J * P(, d)]
            g = plane[li][tbl]
            return g.transpose(1, 2).reshape(B, g.shape[2], J * g.shape[3],
                                             *g.shape[4:])
    else:
        def layer(plane):
            return plane[li]
    scales = ((layer(cache.k_scale), layer(cache.v_scale)) if cache.quantized
              else (None, None))
    return layer(cache.k), layer(cache.v), *scales


def decode_heads_model(q: torch.Tensor, cache, layer, pos: torch.Tensor,
                       n_split: int) -> torch.Tensor:
    """split_decode_model over layer `layer` of a monolithic KVCache: K4's
    arithmetic."""
    return split_decode_model(q, *_layer_planes(cache, layer_index(layer)),
                              pos, n_split)


def paged_model(q: torch.Tensor, cache, layer, pos: torch.Tensor,
                n_split: int) -> torch.Tensor:
    """split_decode_model over layer `layer` of a PagedKVCache, its pages
    gathered through the table in logical order: K10's arithmetic."""
    return split_decode_model(q, *_layer_planes(cache, layer_index(layer)),
                              pos, n_split)


def staged_split_model(q: torch.Tensor, st, layer, pos: torch.Tensor,
                       n_split: int) -> torch.Tensor:
    """K9's (st over a KVCache) and K11's (over a PagedKVCache)
    arithmetic in plain PyTorch, for tests: q [B, 1, H, d] at pos[b]
    against layer `layer` of a staged chunk (runtime.staging
    .StagedKVCache). Row b's keys are the pool's npool = clamp(base[b],
    0, N) (N its capacity) in n_pool = ceil(npool / 64) tiles, then the
    tail's ntail = clamp(pos[b] - base[b] + 1, 0, Cs) slots in
    ceil(ntail / 64) tiles (slots past Cs are zeros here and masked, as
    the kernel's uncopied rows are), through _split_walk's shares and
    merge. Returns [B, 1, H, d] in q.dtype."""
    li = layer_index(layer)
    k, v, ks, vs = _layer_planes(st.pool, li)
    N, Cs = k.shape[2], st.sk.shape[3]
    pad = tail_tiles(Cs) * KEY_TILE - Cs

    def joined(pool_plane, tail_plane):  # pool keys, then the padded tail
        tail = tail_plane[li]
        widths = (0, 0, 0, pad) if tail.dim() == 4 else (0, pad)
        return torch.cat([pool_plane, torch.nn.functional.pad(tail, widths)],
                         dim=2)

    planes = [joined(k, st.sk), joined(v, st.sv)]
    scales = ([joined(ks, st.sk_scale), joined(vs, st.sv_scale)]
              if st.quantized else [None, None])
    dev = q.device
    base = st.base.reshape(-1).long().to(dev)
    pos = pos.reshape(-1).long().to(dev)
    npool = base.clamp(0, N)
    ntail = (pos - base + 1).clamp(0, Cs)
    n_pool = -(-npool // KEY_TILE)

    def tile_at(t):
        tail = t - n_pool
        in_pool = tail < 0
        return (torch.where(in_pool, t * KEY_TILE, N + tail * KEY_TILE),
                torch.where(in_pool, npool - t * KEY_TILE,
                            ntail - tail * KEY_TILE))

    return _split_walk(q, *planes, *scales, n_pool + -(-ntail // KEY_TILE),
                       tile_at, n_split)
