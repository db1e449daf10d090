"""Chunk-local KV staging: one cache write a plane a layer-step at any
batch.

The counterpart of the JAX package's runtime/staging.py. Inside a C-step
decode chunk every row emits one token a step, so the chunk-local slot
t = pos - base is the same for every row. A step's new K/V goes into a
staging tail ``[L, B, Kh, Cs, d]`` (Cs = C rounded up to 32) with one
batched ``index_copy_`` a plane, at a slot index computed on the device;
the attention kernels (K9 over the monolithic cache, K11 over the page
pool) read {pool positions below the chunk's base} + {the staged tail up
to the step}; ``flush_staged`` writes the tail into the pool once at the
chunk's end. Over an int8 pool the tail is int8 too, with its own f32
scale planes ``[L, B, Kh, Cs]``, written, flushed and read beside the
data.

The last chunk of a generation may run past max_ctx (the engine and the
scheduler run whole chunks and drop the tokens past the end). The flush
then writes only the positions below max_ctx, and no staged row lands
on another position.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from tinyllama_tpu_torch.runtime.kvcache import (
    KVCache,
    dequantize_kv,
    kv_planes,
    layer_cache_view,
    quantize_kv,
)
from tinyllama_tpu_torch.runtime.paged import (
    PagedKVCache,
    page_slots,
    paged_layer_view,
)

#: staged slots are padded to a multiple of this
SLOT_QUANTUM = 32


@dataclass(frozen=True)
class StagedKVCache:
    """A monolithic or paged pool plus this chunk's staged tail.

    sk/sv: [L, B, Kh, Cs, d] in the pool's storage dtype (slots past the
    chunk length are never written and always masked). base: [B] int32,
    each row's fill when the chunk started: slot t holds the token at
    position base + t. slot: the current step's slot as a one-element
    int64 device tensor (``at_step``). sk_scale/sv_scale: [L, B, Kh, Cs]
    f32 iff the pool is int8."""

    pool: KVCache | PagedKVCache
    sk: torch.Tensor
    sv: torch.Tensor
    base: torch.Tensor
    slot: torch.Tensor | None = None
    sk_scale: torch.Tensor | None = None
    sv_scale: torch.Tensor | None = None

    @property
    def paged(self) -> bool:
        return isinstance(self.pool, PagedKVCache)

    @property
    def quantized(self) -> bool:
        return self.sk_scale is not None

    @property
    def max_ctx(self) -> int:
        return self.pool.max_ctx

    def planes(self) -> list[torch.Tensor]:
        """sk, sv and, int8, their scale planes: kv_planes(pool)'s order."""
        planes = [self.sk, self.sv]
        if self.quantized:
            planes += [self.sk_scale, self.sv_scale]
        return planes

    def at_step(self, pos: torch.Tensor) -> "StagedKVCache":
        """The same buffers with `slot` = pos[0] - base[0], on the device."""
        return replace(self, slot=(pos[:1] - self.base[:1]).long())


def stage_cache(pool: KVCache | PagedKVCache, base: torch.Tensor,
                chunk: int) -> StagedKVCache:
    """Wrap `pool` for a C-step decode chunk starting at fills `base`."""
    L, _, Kh = pool.k.shape[:3]
    d = pool.k.shape[-1]
    Cs = -(-chunk // SLOT_QUANTUM) * SLOT_QUANTUM
    shape = (L, base.shape[0], Kh, Cs, d)
    dev = pool.k.device
    scales = ({n: torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
               for n in ("sk_scale", "sv_scale")} if pool.quantized else {})
    return StagedKVCache(
        pool=pool,
        sk=torch.zeros(shape, dtype=pool.k.dtype, device=dev),
        sv=torch.zeros(shape, dtype=pool.v.dtype, device=dev),
        base=base.to(torch.int32).clone(), **scales)


def update_staged_at_layer(st: StagedKVCache, li: int, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> StagedKVCache:
    """Write a decode step's K/V ([B, 1, Kh, d]) into staged slot
    `st.slot` of layer li (int8: quantized, data and scales): one batched
    write a plane."""
    if k_new.shape[1] != 1:
        raise ValueError("staging is a decode-chunk (T == 1) path")
    if st.slot is None:
        raise ValueError("call at_step(pos) before a staged write")
    new = [k_new.transpose(1, 2), v_new.transpose(1, 2)]  # [B, Kh, 1, d]
    if st.quantized:
        (kq, ks), (vq, vs) = quantize_kv(new[0]), quantize_kv(new[1])
        new = [kq, vq, ks, vs]
    for buf, n in zip(st.planes(), new):
        buf[li].index_copy_(2, st.slot, n.to(buf.dtype))
    return st


def _window(st: StagedKVCache, C: int):
    """Each row's flush window: C positions cb + r below max_ctx with cb =
    clip(base, 0, S - C), the staged slot r - (base - cb) of each, and
    whether that slot holds the row's token (else the pool keeps its
    own). Rows' windows are disjoint runs, so no position is written
    twice."""
    S = st.max_ctx
    base = st.base.long()
    cb = base.clamp(0, S - C)
    r = torch.arange(C, device=base.device)
    delta = (base - cb)[:, None]
    keep = r >= delta  # [B, C]
    slots = (r - delta).clamp(0, st.sk.shape[3] - 1)
    return cb[:, None] + r, slots, keep


def flush_staged(st: StagedKVCache, chunk: int) -> KVCache | PagedKVCache:
    """Write the chunk's staged rows [base, base + chunk) into the pool,
    in place, for every layer at once (int8: the scale planes through the
    same window); returns the pool. Staged slot t lands at position base
    + t where that is below max_ctx."""
    positions, slots, keep = _window(st, chunk)
    pool = st.pool
    L, B, Kh = st.sk.shape[:3]
    dev = st.sk.device
    lay = torch.arange(L, device=dev)[:, None, None, None]
    rows = torch.arange(B, device=dev)[None, :, None, None]
    heads = torch.arange(Kh, device=dev)[None, None, :, None]
    src = (lay, rows, heads, slots[None, :, None, :])  # -> [L, B, Kh, C]
    if st.paged:
        page, off = page_slots(pool, positions)
        dst = (lay, page[None, :, None, :], heads, off[None, :, None, :])
    else:
        dst = (lay, rows, heads, positions[None, :, None, :])
    mask = keep[None, :, None, :]
    for plane, staged in zip(kv_planes(pool), st.planes()):
        m = mask[..., None] if plane.dim() == 5 else mask
        plane.index_put_(dst, torch.where(m, staged[src], plane[dst]))
    return pool


def staged_layer_view(st: StagedKVCache, li: int, dtype
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense [B, Kh, S, d] k/v of pool + staged tail (the plain read path
    of K9 and K11; int8 dequantized in f32 first): position q of row b
    reads staged slot q - base[b] where that is a slot, else the pool."""
    if st.paged:
        k, v = paged_layer_view(st.pool, li, dtype)
    else:
        k, v = layer_cache_view(st.pool, li, dtype)
    S, Cs = k.shape[2], st.sk.shape[3]
    slot = (torch.arange(S, device=k.device)[None, :]
            - st.base.long()[:, None])  # [B, S]
    inside = ((slot >= 0) & (slot < Cs))[:, None, :, None]
    idx = slot.clamp(0, Cs - 1)[:, None, :, None].expand_as(k)
    scales = ((st.sk_scale[li], st.sv_scale[li]) if st.quantized
              else (None, None))
    out = []
    for dense, staged, s in zip((k, v), (st.sk, st.sv), scales):
        tail = dequantize_kv(staged[li], s, dtype).gather(2, idx)
        out.append(torch.where(inside, tail, dense))
    return out[0], out[1]
