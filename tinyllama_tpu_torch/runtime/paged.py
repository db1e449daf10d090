"""Paged KV cache: a page table over one shared page pool.

The counterpart of the JAX package's runtime/paged.py:

* one **page pool** a model: k/v ``[L, n_pages, Kh, P, d]`` (P positions
  a page; a logical page covers all L layers, so one table serves the
  whole model);
* a **page table** ``[B, J]`` (J = max_ctx // P) of physical page ids,
  one row a sequence. Physical page 0 is the scratch page: table entries
  that map nothing are 0, so parked and padding rows write there;
* ``PageAllocator``, the host-side free list with reservation-based
  admission that the scheduler uses.

Writes go into the pool IN PLACE (``update_paged_at_layer``), one batched
``index_put_`` a plane at device page and offset indices, so a decode
step reads nothing back to the host. The attention kernels (K10, K11 in
ops/kernels/flash_paged.py) read the pool through the table;
``paged_layer_view`` gathers a dense view for their plain versions.

Storage is f32, bf16, f16 or int8; an int8 pool carries f32 scale planes
``[L, n_pages, Kh, P]`` beside its data, written and read through the
same page and offset indices (runtime/kvcache.py quantizes).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinyllama_tpu_torch.config import ModelConfig
from tinyllama_tpu_torch.runtime.kvcache import (
    KV_DTYPES,
    dequantize_kv,
    kv_planes,
    quantize_kv,
    scale_planes,
)

#: Default page length (the JAX package's serving default).
PAGE_SIZE = 256


def default_page_size(S: int) -> int:
    """The largest legal page (<= PAGE_SIZE) for a max_ctx of S."""
    p = PAGE_SIZE
    while p > S or S % p:
        p //= 2
        if p < 8:
            raise ValueError(f"max_ctx must be a multiple of 8, got {S}")
    return p


@dataclass(frozen=True)
class PagedKVCache:
    """k/v: [L, n_pages, Kh, P, d] in the storage dtype; table: [B, J]
    int32 physical page ids on the pool's device; k_scale/v_scale: [L,
    n_pages, Kh, P] f32 iff the storage is int8."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def batch(self) -> int:
        return self.table.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_ctx(self) -> int:
        return self.table.shape[1] * self.page_size

    def with_table(self, table) -> "PagedKVCache":
        """The same pool under another page table (another sequence set)."""
        table = torch.as_tensor(table, dtype=torch.int32, device=self.k.device)
        return PagedKVCache(self.k, self.v, table, self.k_scale, self.v_scale)


def init_paged_cache(cfg: ModelConfig, n_pages: int, batch: int,
                     kv_dtype: str = "bf16", max_ctx: int | None = None,
                     page_size: int | None = None,
                     device="cpu") -> PagedKVCache:
    S = max_ctx or cfg.max_ctx
    page_size = page_size or default_page_size(S)
    if S % page_size:
        raise ValueError(f"max_ctx {S} is not a whole number of {page_size}-"
                         "position pages")
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.d_head)
    dt = KV_DTYPES[kv_dtype]
    return PagedKVCache(
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros((batch, S // page_size), dtype=torch.int32, device=device),
        *scale_planes(shape, kv_dtype, device))


def page_slots(cache: PagedKVCache, positions: torch.Tensor):
    """(physical page, offset in the page) of absolute positions [B, T]
    of each table row. A position past the table reads its row's last
    entry, as the JAX package's clamped index does."""
    P, J = cache.page_size, cache.table.shape[1]
    positions = positions.long()
    logical = (positions // P).clamp(max=J - 1)
    return cache.table.long().gather(1, logical), positions % P


def update_paged_at_layer(
    cache: PagedKVCache,
    li: int,
    k_new: torch.Tensor,  # [B, T, Kh, d] activation dtype
    v_new: torch.Tensor,
    pos: torch.Tensor,  # [B] int32 device tensor: write offsets
) -> PagedKVCache:
    """Write T new positions of each row into its pages, in place: row b's
    token t lands at position pos[b] + t, in page table[b, (pos[b] + t) //
    P]. T == 1 is decode; a T > 1 prefill starts on a page boundary, as
    the scheduler's admissions (pos 0) do. An int8 pool takes the
    quantized data and its scales. One index_put_ a plane."""
    B, T, Kh = k_new.shape[:3]
    positions = pos.long()[:, None] + torch.arange(T, device=pos.device)
    page, off = page_slots(cache, positions)
    heads = torch.arange(Kh, device=pos.device)
    idx = (page[..., None], heads, off[..., None])  # -> [B, T, Kh]
    new = [k_new, v_new]
    if cache.quantized:
        (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
        new = [kq, vq, ks, vs]
    for plane, n in zip(kv_planes(cache), new):
        plane[li].index_put_(idx, n.to(plane.dtype))
    return cache


def paged_layer_view(cache: PagedKVCache, li: int, dtype,
                     ctx_bound: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer li's pages gathered into dense [B, Kh, J * P, d] k/v (the
    plain read path; int8 dequantized in f32 first). `ctx_bound` (every
    attended position < ctx_bound) trims the gather to the pages that can
    hold live positions."""
    tbl = cache.table.long()
    if ctx_bound is not None:
        tbl = tbl[:, : max(1, -(-ctx_bound // cache.page_size))]
    B, J = tbl.shape

    def gather(plane):
        g = plane[li][tbl]  # [B, J, Kh, P(, d)]
        return g.transpose(1, 2).reshape(B, g.shape[2], J * g.shape[3],
                                         *g.shape[4:])

    ks, vs = ((gather(cache.k_scale), gather(cache.v_scale))
              if cache.quantized else (None, None))
    return (dequantize_kv(gather(cache.k), ks, dtype),
            dequantize_kv(gather(cache.v), vs, dtype))


class PageAllocator:
    """Host-side free list with reservation-based admission.

    ``reserve(n)`` claims capacity without picking pages (a request's
    worst case is reserved at admission, so lazy growth never fails);
    ``alloc(n)`` hands out physical pages against a reservation;
    ``release(pages, reserved)`` returns both."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._reserved = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        """Unreserved capacity."""
        return self.n_pages - self._reserved

    def can_reserve(self, n: int) -> bool:
        return n <= self.available

    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise RuntimeError(
                f"page pool over-committed: want {n}, available "
                f"{self.available} of {self.n_pages}")
        self._reserved += n

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"want {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: list[int], reserved: int) -> None:
        self._free.extend(pages)
        self._reserved -= reserved
        if self._reserved < 0 or len(self._free) > self.n_pages:
            raise RuntimeError("page pool released more than it handed out")
