"""Single-token GQA attention over the page pool and over a staged chunk:
the serving path's attention.

Replaces two kernels of tinyllama_tpu/ops/pallas/flash_paged.py with
hand-written Hopper kernels, both in csrc/decode_split.cu, one split-key
template with K4 and K9 (ops/kernels/flash_attention.py): the row's key
walk split over (Kh, B, n_split) blocks, each pipelining its share of
the 64-key tiles through a cp.async ring, then a merge of the partials in
the same launch (ops/kernels/decode_split.py):

* K10 ``flash_paged`` for ``_flash_paged_kernel``: q [B, 1, H, d] at
  pos[b] against the pool through row b's page table, keys <= pos[b].
* K11 ``flash_paged_staged`` for ``_flash_paged_staged_kernel``: the
  pool's tiles below the chunk's base, then the chunk's staged tail up
  to the step (runtime/staging.py) as the row's last tiles.

Both are bound by the bytes of the keys and values each row attends;
the walk stops at each row's own fill. The layer, pos, base and the
table are device tensors read inside the kernels. The pool and the tail
are bf16, f16, f32, or int8 with f32 scale planes (the kernels' int8
instantiation reads half the bytes a key and rounds each key and value
times its scale to bf16 as a tile is converted, as the plain version
dequantizes, where the TPU kernels fold the key scales into the scores
and the value scales into the probabilities; f16 and f32 values are rounded
to bf16 as a tile is converted, as the TPU kernels cast a tile to the
compute dtype). Each tile reads only its row's visible keys. CUDA
tensors (bf16 q, d = 32, 64 or 128, G from 1 to 8: ``check_heads``;
pages a whole number of 64-key tiles, a tail a multiple of 32 slots)
launch a kernel or raise;
only CPU tensors go to the plain versions, ``gqa_attention`` over
``paged_layer_view`` or ``staged_layer_view``, which dequantize.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.ops.attention import gqa_attention
from tinyllama_tpu_torch.ops.kernels import counts
from tinyllama_tpu_torch.ops.kernels import decode_split as ds
from tinyllama_tpu_torch.ops.kernels.qmatmul import layer_index
from tinyllama_tpu_torch.runtime.paged import PagedKVCache, paged_layer_view
from tinyllama_tpu_torch.runtime.staging import StagedKVCache, staged_layer_view

#: the kernels' KV kinds (csrc/kvkind.cuh), and the suffix each kind's
#: launches count under
KV_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float16: 2, torch.float32: 3}
KV_SUFFIX = ("", "_i8", "_f16", "_f32")

#: launches of each kernel since the counts were last set to 0; a cache
#: of another kind than bf16 counts under "<name>_i8", "_f16" or "_f32".
launches = {name + sfx: 0 for name in ("flash_paged", "flash_paged_staged")
            for sfx in KV_SUFFIX}

#: head dims the attention kernels take, K3, K4 and K8-K11 alike (the
#: tiny configurations' 32, TinyLlama's 64, Llama-3's 128): each an
#: instantiation of their templates.
HEAD_DIMS = (32, 64, 128)
#: keys per tile: a page must be a whole number of tiles.
KEY_TILE = 64
#: query heads per kv head the split-key kernels take (K4, K8-K11: a
#: group's heads are the 8 columns of their products, a runtime argument);
#: K3 takes any.
GROUPS = range(1, 9)


def check_heads(kernel: str, d: int, G: int) -> None:
    """What `kernel` (a launch-count name: "flash_prefill" for K3, else
    a split-key kernel) takes of the head dim d and the query heads per
    kv head G, from host ints alone: d in HEAD_DIMS, and G in GROUPS but
    for K3. Anything else raises a ValueError that names where those
    shapes wait (ROADMAP.md Queue 2)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: d must be one of {HEAD_DIMS}, got {d} "
                         "(other head dims: ROADMAP.md Queue 2)")
    if kernel != "flash_prefill" and G not in GROUPS:
        raise ValueError(f"{kernel}: H / Kh must be 1 to {GROUPS[-1]} query "
                         f"heads per kv head, got {G} (more: ROADMAP.md "
                         "Queue 2)")


def paged_attention_ref(q: torch.Tensor, cache: PagedKVCache, layer,
                        pos: torch.Tensor) -> torch.Tensor:
    """Plain version of K10, any device; the page gather stops at the
    pages that hold the largest pos."""
    k, v = paged_layer_view(cache, layer_index(layer), q.dtype,
                            int(pos.max()) + 1)
    return gqa_attention(q, k, v, pos.reshape(-1, 1))


def staged_attention_ref(q: torch.Tensor, st: StagedKVCache, layer,
                         pos: torch.Tensor) -> torch.Tensor:
    """Plain version of K9 and K11, any device."""
    k, v = staged_layer_view(st, layer_index(layer), q.dtype)
    return gqa_attention(q, k, v, pos.reshape(-1, 1))


def kv_kind(data, scales) -> int:
    """The kernels' code for a cache's planes (KV_KIND): 0 bf16, 2 f16 or
    3 f32 data without scales, 1 int8 data with f32 contiguous scale
    planes of the data's shape less d on its device. Planes of two dtypes
    and anything else raise."""
    dtypes = {t.dtype for t in data}
    if len(dtypes) != 1 or not dtypes <= KV_KIND.keys():
        raise TypeError("the CUDA attention takes a cache of one dtype, "
                        "bf16, f16, f32, or int8 with scales, not "
                        f"{sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    kind = KV_KIND[dtype]
    if kind != 1:
        if any(s is not None for s in scales):
            raise TypeError(f"a {dtype} cache takes no scales")
        return kind
    if any(s is None for s in scales):
        raise TypeError("an int8 cache needs its scale planes")
    for t, s in zip(data, scales):
        if s.dtype != torch.float32:
            raise TypeError(f"int8 cache scales must be f32, got {s.dtype}")
        if s.shape != t.shape[:-1] or not s.is_contiguous() \
                or s.device != t.device:
            raise ValueError(f"int8 cache scales must be contiguous "
                             f"{tuple(t.shape[:-1])} on the data's device, got "
                             f"{tuple(s.shape)}")
    return kind


def ptr(t) -> int | None:
    """A tensor's device address for a launch, None (a null pointer) for
    an absent operand."""
    return None if t is None else t.data_ptr()


def check_serving_inputs(kernel: str, q: torch.Tensor, planes, scales,
                         ints) -> int:
    """What K9-K11 take: q [B, 1, H, d] bf16 with d and H / Kh as
    check_heads(kernel, ...) takes them; key planes [.., Kh, rows, d] of
    one KV kind with `scales` (one per plane; kv_kind), whose rows are
    whole 64-key tiles (32-slot multiples for a staged tail); contiguous,
    16-byte aligned tensors on q's device; int32 index tensors of the
    sizes in `ints` ({name: (tensor, numel)}). Returns the KV kind."""
    B, T, H, d = q.shape
    if T != 1:
        raise ValueError("the serving attention kernels are the T=1 decode path")
    if q.dtype != torch.bfloat16:
        raise TypeError("the serving attention kernels take bf16 queries, "
                        f"not {q.dtype}")
    kind = kv_kind([p for p, _ in planes], scales)
    for plane, rows_quantum in planes:
        Kh, rows, dc = plane.shape[2:]
        if dc != d or H % Kh:
            raise ValueError(f"q {tuple(q.shape)} does not fit keys "
                             f"{tuple(plane.shape)}")
        check_heads(kernel, d, H // Kh)
        if rows % rows_quantum:
            raise ValueError(f"{rows} key rows a slab, not a multiple of "
                             f"{rows_quantum}")
    for t in [q] + [p for p, _ in planes]:
        if not t.is_cuda or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("q and the cache must be contiguous on one CUDA "
                             "device, on 16-byte boundaries (vector loads)")
    for name, (t, n) in ints.items():
        if not (torch.is_tensor(t) and t.is_cuda and t.device == q.device
                and t.dtype == torch.int32 and t.numel() == n
                and t.is_contiguous()):
            raise ValueError(f"{name} must be an int32 CUDA tensor of {n} "
                             "elements")
    return kind


def _check_paged(kernel, q, cache: PagedKVCache, layer, pos,
                 staged=None) -> int:
    B = q.shape[0]
    planes = [(cache.k, KEY_TILE), (cache.v, KEY_TILE)]
    scales = [cache.k_scale, cache.v_scale]
    ints = {"layer": (layer, 1), "pos": (pos, B),
            "table": (cache.table, B * cache.table.shape[1])}
    if staged is not None:
        planes += [(staged.sk, 32), (staged.sv, 32)]
        scales += [staged.sk_scale, staged.sv_scale]
        ints["base"] = (staged.base, B)
    rows = {cache.table.shape[0]} | (
        set() if staged is None else {staged.sk.shape[1]})
    if rows != {B}:
        raise ValueError(f"{B} query rows against a page table or staged "
                         f"tail of {sorted(rows)} rows")
    return check_serving_inputs(kernel, q, planes, scales, ints)


def count(table: dict, name: str, kind: int) -> None:
    """One launch of kernel `name` with a cache of KV kind `kind`, in a
    module's launch table, under "<name>" plus the kind's KV_SUFFIX."""
    counts.count(table, name + KV_SUFFIX[kind])


def flash_paged_attention(q: torch.Tensor, cache: PagedKVCache, layer,
                          pos: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention (q [B, 1, H, d] at pos[b], its k/v
    already written) over the page pool. Returns [B, 1, H, d] in q.dtype.
    The kernel stops at each row's own fill, its key walk split across
    blocks (decode_split)."""
    if q.shape[1] != 1:
        raise ValueError("flash_paged_attention is the T=1 decode path")
    if not q.is_cuda:
        return paged_attention_ref(q, cache, layer, pos)
    kind = _check_paged("flash_paged", q, cache, layer, pos)
    B, _, H, d = q.shape
    _, NP, Kh, P, _ = cache.k.shape
    J = cache.table.shape[1]
    out = ds.launch("flash_paged", q, cache.k, cache.v,
                    (cache.k_scale, cache.v_scale), (layer, pos, cache.table),
                    kind, (B, H, Kh, NP, P, J, d), J * P // KEY_TILE)
    count(launches, "flash_paged", kind)
    return out


def flash_paged_staged_attention(q: torch.Tensor, st: StagedKVCache, layer,
                                 pos: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over the pool's pages below the chunk's
    base plus the staged tail up to slot pos - base (the step's k/v
    already staged). Returns [B, 1, H, d] in q.dtype."""
    if q.shape[1] != 1:
        raise ValueError("flash_paged_staged_attention is the T=1 decode path")
    if not st.paged:
        raise TypeError("flash_paged_staged_attention stages over a page pool")
    if not q.is_cuda:
        return staged_attention_ref(q, st, layer, pos)
    cache = st.pool
    kind = _check_paged("flash_paged_staged", q, cache, layer, pos, st)
    B, _, H, d = q.shape
    _, NP, Kh, P, _ = cache.k.shape
    J, Cs = cache.table.shape[1], st.sk.shape[3]
    out = ds.launch("flash_paged_staged", q, cache.k, cache.v,
                    (cache.k_scale, cache.v_scale, st.sk_scale, st.sv_scale),
                    (layer, pos, st.base, cache.table), kind,
                    (B, H, Kh, NP, P, J, Cs, d),
                    J * P // KEY_TILE + ds.tail_tiles(Cs), tail=(st.sk, st.sv))
    count(launches, "flash_paged_staged", kind)
    return out
