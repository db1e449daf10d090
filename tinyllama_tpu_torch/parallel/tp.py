"""Tensor parallelism over rank processes: the port's counterpart of the
JAX package's parallel/tp.py.

Every rank runs the single-device program, with its kernels, on its own
shard of the weights and the KV cache, and the two row-parallel products
of a block (wo and w_down) are summed over the model group: the
Megatron minimum of two all-reduces a block (``TpGroup.row_linear``,
called by models/llama.py). The plan, as JAX's:

  wqkv, w_gateup   column-parallel on the fused d_out, its rows first
                   put shard-major (``tp_permute_params``) so a rank owns
                   whole heads and whole ffn slices
  wo, w_down       row-parallel on d_in
  KV cache         the rank's kv heads (its engine's caches are made at
                   ``local_config``)
  embed, norms,    replicated
  lm_head

``shard_params`` keeps a rank's slice of each weight and moves only that
to its device. The port's packed layout is its own (quant/codec.py); a
row permutation commutes with it and with the per-row block scales, as
with JAX's, so the dequantized permuted weights are JAX's, bit for bit.
A q4g row-parallel weight whose local d_in would split the JAX package's
pack group is refused as JAX refuses it (ROADMAP: a deliberate sameness;
the port's own layout could split it).

With ``overlap`` (the CLI's ``--tp-overlap``) the sum is the JAX ring
(``ring_row_parallel``): the row-parallel weights are chunk-stacked
[L * tp, .., N / tp] (``tp_chunk_row_parallel``), each rank computes its
product in tp column chunks, passes the partial sums round the ring and
gathers the reduced chunks; chunk j of layer li is layer li * tp + j of
the stacked weight, read by the kernels from a device layer-id tensor of
length L * tp.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig
from tinyllama_tpu_torch.interop import jax_q4g_pack_group
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.linear import linear
from tinyllama_tpu_torch.parallel.mesh import Mesh
from tinyllama_tpu_torch.quant.codec import QTensor, block_size

_COL = ("wqkv", "w_gateup")
_ROW = ("wo", "w_down")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """A rank's architecture: heads, kv heads and ffn divided by tp."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.n_ffn % tp:
        raise ValueError(f"tp={tp} must divide heads {cfg.n_heads} / "
                         f"{cfg.n_kv_heads} and n_ffn {cfg.n_ffn}")
    return cfg.replace(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp,
                       n_ffn=cfg.n_ffn // tp, head_dim=cfg.d_head)


def _rank_runs(cfg: ModelConfig, tp: int,
               rank: int) -> dict[str, list[tuple[int, int]]]:
    """The (start, length) runs of wqkv's and w_gateup's output rows that
    model rank `rank` owns, in order: its q, k and v heads; its gate and
    up slices."""
    D, kv, F = cfg.n_embd, cfg.kv_dim, cfg.n_ffn
    return {"wqkv": [(rank * D // tp, D // tp),
                     (D + rank * kv // tp, kv // tp),
                     (D + kv + rank * kv // tp, kv // tp)],
            "w_gateup": [(rank * F // tp, F // tp),
                         (F + rank * F // tp, F // tp)]}


def _fused_perm(cfg: ModelConfig, tp: int) -> dict[str, torch.Tensor]:
    """Row orders turning [q|k|v] and [gate|up] into shard-major
    [q0|k0|v0|q1|k1|v1|...], so a contiguous slice holds whole heads:
    every rank's runs in rank order."""
    return {name: torch.tensor([i for s in range(tp)
                                for a, n in _rank_runs(cfg, tp, s)[name]
                                for i in range(a, a + n)])
            for name in _COL}


def _check_q4g_groups(params: llama.Params, tp: int) -> None:
    """Refuse a q4g row-parallel weight whose local d_in splits the JAX
    package's pack group (its kernel would re-derive the group from the
    local K and decode garbage)."""
    for name in _ROW:
        w = params["layers"][name]
        if isinstance(w, QTensor) and w.kind == "q4g":
            K = w.shape[-1]
            pg = jax_q4g_pack_group(K)
            if (K // tp) % pg:
                raise ValueError(
                    f"q4g weight '{name}' (K={K}, pack group {pg}) cannot "
                    f"shard over tp={tp}: the local K={K // tp} splits a pack "
                    f"group. Use a tp that divides {K // pg} group(s), or the "
                    "q4/q8 policies.")


def tp_permute_params(params: llama.Params, cfg: ModelConfig,
                      tp: int) -> llama.Params:
    """wqkv's and w_gateup's output rows shard-major (the last axis of a kn
    QTensor's data and scales; axis -2 of a dense [L, d_out, d_in]): a
    relabelling, the values untouched."""
    if tp == 1:
        return params
    _check_q4g_groups(params, tp)
    layers = dict(params["layers"])
    for name, perm in _fused_perm(cfg, tp).items():
        w = layers[name]
        if isinstance(w, QTensor):
            if w.layout != "kn":
                raise ValueError("the TP permutation takes kn weights")
            perm = perm.to(w.data.device)
            layers[name] = QTensor(w.data[..., perm], w.scales[..., perm],
                                   w.kind, w.layout)
        else:
            layers[name] = w[..., perm.to(w.device), :]
    return {**params, "layers": layers}


def tp_chunk_row_parallel(params: llama.Params, tp: int) -> llama.Params:
    """wo and w_down with their output columns in tp chunks stacked on the
    layer axis: kn [L, R, N] -> [L * tp, R, N / tp] (data and scales);
    dense [L, N, K] -> [L * tp, N / tp, K]. Chunk j of layer li is layer
    li * tp + j."""
    if tp == 1:
        return params
    layers = dict(params["layers"])

    def chunk(a):  # [L, R, N] -> [L * tp, R, N / tp]
        L, R, N = a.shape
        return (a.reshape(L, R, tp, N // tp).transpose(1, 2)
                .reshape(L * tp, R, N // tp))

    for name in _ROW:
        w = layers[name]
        N = w.shape[-2]
        if N % tp:
            raise ValueError(f"{name}: {N} output columns do not split in {tp}")
        if isinstance(w, QTensor):
            layers[name] = QTensor(chunk(w.data), chunk(w.scales), w.kind,
                                   w.layout)
        else:
            L, _, K = w.shape
            layers[name] = w.reshape(L * tp, N // tp, K)
    return {**params, "layers": layers}


def _owned(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy on `device` that holds no more than t's values
    (a slice must not keep the whole weight alive)."""
    return t.to(device, copy=True).contiguous()


def _slice(t: torch.Tensor, axis: int, rank: int, tp: int, device):
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"an axis of {n} does not split in {tp}")
    return _owned(t.narrow(axis, rank * (n // tp), n // tp), device)


def shard_params(params: llama.Params, cfg: ModelConfig, tp: int, rank: int,
                 device="cpu", overlap: bool = False) -> llama.Params:
    """Model rank `rank`'s shard of the full parameters, on `device`:
    wqkv and w_gateup's rows of this rank in the shard-major order
    (``tp_permute_params``'s slice `rank`), wo and w_down sliced on d_in
    (chunk-stacked with `overlap`), the rest whole. Each slice is cut
    (and chunk-stacked) where the full parameters live (best: host
    memory), then copied to `device`; the full parameters are not
    changed."""
    if tp == 1:
        return llama.params_to(params, device)
    _check_q4g_groups(params, tp)
    runs = _rank_runs(cfg, tp, rank)

    def rows(t, axis, name):  # the rank's runs of d_out, joined
        return torch.cat([t.narrow(axis, a, n) for a, n in runs[name]],
                         axis).to(device)

    layers: dict = {}
    row_parallel: dict = {}
    for name, w in params["layers"].items():
        if name in _COL:  # the rank's rows of the permuted d_out
            if isinstance(w, QTensor):  # kn: d_out is the last axis
                if w.layout != "kn":
                    raise ValueError("the TP permutation takes kn weights")
                layers[name] = QTensor(rows(w.data, -1, name),
                                       rows(w.scales, -1, name),
                                       w.kind, w.layout)
            else:  # dense [L, d_out, d_in]
                layers[name] = rows(w, -2, name)
        elif name not in _ROW:
            layers[name] = w.to(device)
        elif isinstance(w, QTensor):  # kn: d_in is axis -2
            K = w.shape[-1]
            if (K // tp) % block_size(w.kind) or K % tp:
                raise ValueError(f"{name}: d_in {K} over tp={tp} splits a "
                                 f"{block_size(w.kind)}-value scale block")
            row_parallel[name] = QTensor(
                _slice(w.data, -2, rank, tp, w.data.device),
                _slice(w.scales, -2, rank, tp, w.scales.device),
                w.kind, w.layout)
        else:  # dense [L, d_out, d_in]
            row_parallel[name] = _slice(w, -1, rank, tp, w.device)
    if overlap:
        row_parallel = tp_chunk_row_parallel({"layers": row_parallel},
                                             tp)["layers"]
    layers.update({n: w.to(device) for n, w in row_parallel.items()})
    return {"embed": params["embed"].to(device),
            "norm": params["norm"].to(device),
            "lm_head": params["lm_head"].to(device), "layers": layers}


def ring_row_parallel(x: torch.Tensor, w, li: int, layer_ids: torch.Tensor,
                      mesh: Mesh, aq8: bool = False) -> torch.Tensor:
    """x @ w summed over the model group as JAX's ring: the product in tp
    column chunks of the chunk-stacked `w` (layer li * tp + j), the chunk
    bound for the farthest rank first; each partial sum passes to the
    left neighbour and gains this rank's next chunk (tp - 1 hops), so rank
    s ends holding the reduced chunk s; one all_gather rebuilds the row.
    The same order of sums as JAX's."""
    tp, me = mesh.tp, mesh.tp_rank
    dense = not isinstance(w, QTensor)

    def mm(j):
        i = li * tp + j
        return linear(x, w, i if dense else layer_ids[i:i + 1], aq8)

    acc = mm((me + 1) % tp)
    for step in range(tp - 1):
        acc = mesh.ring_shift(acc) + mm((me + step + 2) % tp)
    return mesh.all_gather(acc, x.dim() - 1)


@dataclass(frozen=True)
class TpGroup:
    """What the model's blocks need of tensor parallelism: the sum of a
    row-parallel product over the model group, a bare all-reduce or (with
    `overlap`) the ring."""

    mesh: Mesh
    overlap: bool = False

    @property
    def size(self) -> int:
        return self.mesh.tp

    def row_linear(self, y: torch.Tensor, w, li: int,
                   layer_ids: torch.Tensor, aq8: bool = False) -> torch.Tensor:
        if self.overlap:
            return ring_row_parallel(y, w, li, layer_ids, self.mesh, aq8)
        layer = li if not isinstance(w, QTensor) else layer_ids[li:li + 1]
        return self.mesh.all_reduce(linear(y, w, layer, aq8))


def layer_ids_for(cfg: ModelConfig, tp: int, overlap: bool,
                  device) -> torch.Tensor:
    """The device layer indices the kernels read: arange(L), or with the
    ring's chunk-stacked weights arange(L * tp) (layer li is still li for
    the weights that are not stacked)."""
    n = cfg.n_layers * (tp if overlap and tp > 1 else 1)
    return torch.arange(n, dtype=torch.int32, device=device)


def tp_step(cfg: ModelConfig, policy: DtypePolicy, shard: llama.Params,
            cache, tokens: torch.Tensor, pos: torch.Tensor,
            last: torch.Tensor, mesh: Mesh, rope_tables=None,
            overlap: bool = False) -> torch.Tensor:
    """The counterpart of JAX's ``make_tp_step`` on one rank: the model
    over this rank's data row of tokens [B, T] (B / dp rows) from pos,
    on its `shard` (``shard_params``) and its monolithic `cache` (made at
    ``local_config``, B / dp rows, written in place); returns the f32
    logits [B / dp, V] of each row's token `last`."""
    b = tokens.shape[0] // mesh.dp
    rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
    hidden = llama.forward(
        local_config(cfg, mesh.tp), policy, shard, tokens[rows], cache,
        pos[rows], rope_tables,
        layer_ids_for(cfg, mesh.tp, overlap, tokens.device),
        tp=TpGroup(mesh, overlap))
    h_last = hidden[torch.arange(b, device=tokens.device), last[rows].long()]
    return llama.lm_head_logits(shard, h_last, policy.aq8)
