"""Carry a JAX parameter tree across to the port, as numpy arrays.

The tests build parameters with the JAX package, turn every array into
numpy and hand the tree here, so both packages run on the same weights.
This module imports no JAX: a quantized tensor arrives as a tuple
``(data, scales, kind, layout)``; dense arrays (the norm weights, and
every weight of a dense policy: f32, f16, or bf16 as numpy's ml_dtypes
type) arrive as they are. The JAX package ships "kn" scales as int16 fp16 bit
patterns; they are viewed back as float16, bits unchanged.

The JAX package's 4-bit planes are laid out for Mosaic, so they are
unpacked to their values in numpy and repacked in the port's layout
(quant/codec.py):

* "kn" data: each byte is stored XOR 0x80 (a biased high nibble), and
  K is packed in planar groups of G rows, packed row g*G/2 + j holding
  K-row g*G + j (high nibble) and g*G + G/2 + j (low nibble); G is 64
  for q4 and ``q4g_pack_group(K)`` (256, or 128) for q4g;
* "kn" q4g scales: each group-128 scale duplicated into 4 rows of a
  [K/32, N] plane;
* "nk" data: the same planar groups along each row, unbiased, G =
  ``q4_group_size(K)`` for q4 and ``q4g_pack_group(K)`` for q4g.

``cache_from_numpy`` does the same for a KV cache: the k/v planes (an
int8 cache's scale planes, a page pool's table) of a JAX cache, as
numpy, become the port's KVCache or PagedKVCache, so that both packages
can be given the same pool. ``gather_tp_planes`` goes the other way for
tensor parallelism: the planes of every rank's cache (its kv heads of
its data row's batch rows) back into the one cache JAX's sharded cache
assembles to.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig
from tinyllama_tpu_torch.models.llama import DTYPES, LAYER_LINEARS, Params
from tinyllama_tpu_torch.quant.codec import (
    BLOCK_SIZE,
    Q4G_BLOCK,
    QTensor,
    block_size,
    pack_q4,
)
from tinyllama_tpu_torch.runtime.kvcache import KVCache
from tinyllama_tpu_torch.runtime.paged import PagedKVCache

#: the JAX package's kn packing group for q4 (its codec.KN_GROUP)
JAX_KN_GROUP = 64


def jax_q4_group_size(d_in: int) -> int:
    """The JAX package's nk packing group for q4 (``q4_group_size``)."""
    for g in (512, 256, 128, 64):
        if d_in % g == 0:
            return g
    raise ValueError(f"q4 requires d_in % 64 == 0, got {d_in}")


def jax_q4g_pack_group(d_in: int) -> int:
    """The JAX package's packing group for q4g (``q4g_pack_group``)."""
    for g in (256, 128):
        if d_in % g == 0:
            return g
    raise ValueError(f"q4g requires d_in % 128 == 0, got {d_in}")


def _planar_values(packed: np.ndarray, group: int) -> np.ndarray:
    """Planar-packed uint8 [.., K//2] -> offset-7 values [.., K]: in each
    group of `group` values, byte j holds value j high, j + group/2 low."""
    K = packed.shape[-1] * 2
    g = packed.reshape(*packed.shape[:-1], K // group, group // 2)
    return np.concatenate([g >> 4, g & 0x0F], axis=-1).reshape(
        *packed.shape[:-1], K)


def _scales_f16(scales) -> np.ndarray:
    scales = np.asarray(scales)
    if scales.dtype == np.int16:
        scales = scales.view(np.float16)
    if scales.dtype != np.float16:
        raise TypeError(f"scales arrive as fp16 values or bits, got {scales.dtype}")
    return scales


def _from_jax_4bit(data: np.ndarray, scales: np.ndarray, kind: str,
                   layout: str) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's 4-bit planes -> the port's (data, scales)."""
    u8 = np.asarray(data).view(np.uint8)
    if layout == "kn":
        K = u8.shape[-2] * 2
        group = JAX_KN_GROUP if kind == "q4" else jax_q4g_pack_group(K)
        rows = np.swapaxes(u8 ^ 0x80, -1, -2)  # [.., N, K//2], unbiased
        vals = _planar_values(rows, group)
        if kind == "q4g":
            dup = Q4G_BLOCK // BLOCK_SIZE
            true = scales[..., ::dup, :]
            if not all(np.array_equal(true.view(np.uint16),
                                      scales[..., i::dup, :].view(np.uint16))
                       for i in range(1, dup)):
                raise ValueError("q4g kn scales are not 4x duplicated rows")
            scales = true
        packed = pack_q4(torch.from_numpy(vals)).numpy()
        return np.ascontiguousarray(np.swapaxes(packed, -1, -2)), scales
    K = u8.shape[-1] * 2
    group = jax_q4_group_size(K) if kind == "q4" else jax_q4g_pack_group(K)
    return pack_q4(torch.from_numpy(_planar_values(u8, group))).numpy(), scales


def qtensor_from_numpy(parts, device="cpu") -> QTensor:
    data, scales, kind, layout = parts
    scales = _scales_f16(scales)
    if kind in ("q4", "q4g"):
        data, scales = _from_jax_4bit(data, scales, kind, layout)
    elif kind != "q8":
        raise ValueError(f"unknown quant kind: {kind}")
    return QTensor(torch.from_numpy(np.array(data)).to(device),
                   torch.from_numpy(np.array(scales)).to(device), kind, layout)


def params_from_numpy(tree: dict, cfg: ModelConfig, policy: DtypePolicy,
                      device="cpu") -> Params:
    """The port's parameters from the JAX tree in numpy form (see the
    module docstring), checked against `cfg` and `policy`: quantized
    tuples of the policy's kind, or dense [L, d_out, d_in] arrays of its
    wdtype, bits unchanged."""
    kind = policy.wdtype
    norms = ("attn_norm", "ffn_norm")

    def dense(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    if not policy.is_quantized:
        want_dtype = DTYPES[kind]
        shapes = {"embed": (cfg.n_vocab, cfg.n_embd),
                  "lm_head": (cfg.n_vocab, cfg.n_embd),
                  **{n: (cfg.n_layers, *f(cfg)) for n, f in LAYER_LINEARS.items()}}
        out = {n: tensor_from_numpy(tree["layers"][n] if n in LAYER_LINEARS
                                    else tree[n], device) for n in shapes}
        for n, t in out.items():
            if t.dtype != want_dtype or tuple(t.shape) != shapes[n]:
                raise ValueError(f"{n}: expected {kind} {shapes[n]}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        layers = {n: out[n] for n in LAYER_LINEARS}
        layers.update({n: dense(tree["layers"][n]) for n in norms})
        return {"embed": out["embed"], "layers": layers,
                "norm": dense(tree["norm"]), "lm_head": out["lm_head"]}

    bs = block_size(kind)
    rows = 1 if kind == "q8" else 2

    layers = {}
    for name, shape_fn in LAYER_LINEARS.items():
        qt = qtensor_from_numpy(tree["layers"][name], device)
        N, K = shape_fn(cfg)
        want = (cfg.n_layers, K // rows, N)
        if qt.kind != kind or qt.layout != "kn" \
                or tuple(qt.data.shape) != want \
                or tuple(qt.scales.shape) != (cfg.n_layers, K // bs, N):
            raise ValueError(f"{name}: expected {kind} kn data {want}, got "
                             f"{qt.kind} {qt.layout} {tuple(qt.data.shape)}")
        layers[name] = qt
    for name in norms:
        layers[name] = dense(tree["layers"][name])
    embed = qtensor_from_numpy(tree["embed"], device)
    lm_head = qtensor_from_numpy(tree["lm_head"], device)
    if embed.layout != "nk" or lm_head.layout != "kn":
        raise ValueError("expected an nk embedding table and a kn lm_head")
    return {"embed": embed, "layers": layers, "norm": dense(tree["norm"]),
            "lm_head": lm_head}


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor, bf16 (numpy's ml_dtypes bfloat16, as JAX
    hands it out) included, bits unchanged."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def cache_from_numpy(k, v, table=None, k_scale=None, v_scale=None,
                     device="cpu") -> KVCache | PagedKVCache:
    """The port's cache from a JAX cache's planes as numpy: a monolithic
    KVCache (k, v [L, B, Kh, S, d]) or, with a page table [B, J], a
    PagedKVCache (k, v [L, n_pages, Kh, P, d]). Int8 planes come with
    their f32 scales (k_scale, v_scale: the data's shape less d), other
    dtypes without."""
    k, v = tensor_from_numpy(k, device), tensor_from_numpy(v, device)
    int8 = k.dtype == torch.int8
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 planes need both scale planes, and only "
                         f"int8 planes take them (data {k.dtype})")
    scales = ()
    if int8:
        scales = tuple(tensor_from_numpy(np.asarray(s, np.float32), device)
                       for s in (k_scale, v_scale))
        if any(s.shape != k.shape[:-1] for s in scales):
            raise ValueError(f"scale planes must be {tuple(k.shape[:-1])}")
    if table is None:
        return KVCache(k, v, *scales)
    return PagedKVCache(k, v, torch.from_numpy(
        np.asarray(table, np.int32)).to(device), *scales)


def gather_tp_planes(planes: list, tp: int, dp: int = 1) -> np.ndarray:
    """One cache plane [L, B, Kh, ...] from the ranks' planes (rank r at
    grid place (r // tp, r % tp): its data row's B / dp batch rows, its
    Kh / tp kv heads), as JAX assembles a cache sharded kv heads on
    "model" and batch on "data"."""
    if len(planes) != tp * dp:
        raise ValueError(f"{len(planes)} planes for a {dp} x {tp} grid")
    rows = [np.concatenate([np.asarray(planes[d * tp + t]) for t in range(tp)],
                           axis=2) for d in range(dp)]
    return np.concatenate(rows, axis=1)
