"""Block-wise Q8_0 / Q4_0 / q4g weight quantization codec.

The reference's formats, plus the JAX package's group-128 4-bit format:

* ``q8`` (Q8_0): per block of 32 values along d_in, one fp16 scale
  ``delta = absmax/127`` and int8 values ``q = round(x/delta)``.
* ``q4`` (Q4_0): per block of 32, ``delta = absmax/7`` and 4-bit values
  ``q = clip(round(x/delta) + 7, 0, 14)``, two a byte.
* ``q4g``: q4's values with one scale per 128 values (``Q4G_BLOCK``).

Rounding is half to even (``torch.round``, as ``jnp.round``); the delta is
computed and divided by in f32, then stored as fp16. Dequantized values
are ``float(q) * float(delta)`` (``(float(q) - 7) * float(delta)`` for the
4-bit kinds), bit-equal to the JAX package's ``codec.dequantize``.

A quantized 2-D weight ``[d_out, d_in]`` (= ``[N, K]``) is a pair of dense
planes in one of two layouts:

* ``layout="nk"`` (row-major; the embedding table): data ``[.., N, K]``
  int8 (q8) or ``[.., N, K//2]`` uint8 (4-bit); scales float16
  ``[.., N, K//bs]``.
* ``layout="kn"`` (K-major; every matmul weight): data ``[.., K, N]``
  int8 or ``[.., K//2, N]`` uint8; scales float16 ``[.., K//bs, N]``.
  The kernels read rows of N contiguous bytes, so their loads coalesce
  along N.

``bs`` is ``block_size(kind)``: 32, or 128 for q4g. Both 4-bit kinds and
both layouts share one nibble order, gten's half-block packing: within
every 32-value block along K, byte j holds value j in its high nibble and
value j + 16 in its low nibble, unsigned, with the +7 offset. So an "nk"
q4 table is a gten q4 payload with its fp16 deltas split off, and the
"kn" data is the "nk" data transposed: each 32-row block of K is 16
byte-rows. (The JAX package packs in Mosaic-shaped planar groups with a
biased high nibble and duplicates q4g's scale rows 4x; ``interop.py``
undoes those.)

Leading axes (the stacked layer axis) are preserved. The numpy oracles
(``np_quantize_*``, ``np_dequantize_*``) and gten's q4 packing serve the
checkpoint writer (io/gten.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BLOCK_SIZE = 32  # the reference's block size (q8, q4)
Q4G_BLOCK = 128  # q4g's scale block
Q8_MAX = 127.0
Q4_MAX = 7.0
Q4_OFFSET = 7
KINDS = ("q8", "q4", "q4g")


def block_size(kind: str) -> int:
    """Values along K that share one scale."""
    if kind not in KINDS:
        raise ValueError(f"unknown quant kind: {kind}")
    return Q4G_BLOCK if kind == "q4g" else BLOCK_SIZE


@dataclass(frozen=True)
class QTensor:
    """A block-quantized tensor: packed integer data + per-block fp16
    scales (see the module docstring for the layouts)."""

    data: torch.Tensor
    scales: torch.Tensor
    kind: str
    layout: str = "nk"

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical [..., d_out, d_in] regardless of layout."""
        bs = block_size(self.kind)
        if self.layout == "kn":
            d_in = self.scales.shape[-2] * bs
            return (*self.data.shape[:-2], self.data.shape[-1], d_in)
        return (*self.data.shape[:-1], self.scales.shape[-1] * bs)

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scales.to(device),
                       self.kind, self.layout)


def _deltas_and_inv(w: torch.Tensor, bs: int, qmax: float):
    """Blocks of `bs` along the last axis: the f32 deltas absmax/qmax and
    their inverses (0 where the delta is 0)."""
    if w.shape[-1] % bs:
        raise ValueError(f"d_in must be a multiple of {bs}, got {tuple(w.shape)}")
    blocks = w.float().reshape(*w.shape[:-1], -1, bs)
    deltas = blocks.abs().amax(dim=-1) / qmax
    safe = torch.where(deltas != 0, deltas, torch.ones_like(deltas))
    inv = torch.where(deltas != 0, 1.0 / safe, torch.zeros_like(deltas))
    return blocks, deltas, inv


def _finish(data_nk: torch.Tensor, scales_nk: torch.Tensor, kind: str,
            layout: str) -> QTensor:
    qt = QTensor(data_nk, scales_nk, kind, "nk")
    if layout == "kn":
        return to_kn(qt)
    if layout != "nk":
        raise ValueError(f"unknown layout {layout!r}")
    return qt


def quantize_q8(w: torch.Tensor, layout: str = "nk") -> QTensor:
    """Block-32 int8 + fp16 scales. The values divide by the f32 delta
    (the reference converter's rule); the stored scale is its fp16
    rounding."""
    blocks, deltas, inv = _deltas_and_inv(w, BLOCK_SIZE, Q8_MAX)
    q = torch.round(blocks * inv[..., None]).to(torch.int8).reshape(w.shape)
    return _finish(q, deltas.to(torch.float16), "q8", layout)


def _quantize_4bit(w: torch.Tensor, kind: str, layout: str) -> QTensor:
    blocks, deltas, inv = _deltas_and_inv(w, block_size(kind), Q4_MAX)
    q = torch.round(blocks * inv[..., None]) + Q4_OFFSET
    vals = q.clamp(0, 14).to(torch.uint8).reshape(w.shape)
    return _finish(pack_q4(vals), deltas.to(torch.float16), kind, layout)


def quantize_q4(w: torch.Tensor, layout: str = "nk") -> QTensor:
    """Q4_0: block-32 4-bit values (+7 offset) + fp16 scales."""
    return _quantize_4bit(w, "q4", layout)


def quantize_q4g(w: torch.Tensor, layout: str = "nk") -> QTensor:
    """q4g: q4's values with one fp16 scale per 128 (d_in % 128 == 0)."""
    return _quantize_4bit(w, "q4g", layout)


def quantize(w: torch.Tensor, kind: str, layout: str = "nk") -> QTensor:
    if kind == "q8":
        return quantize_q8(w, layout)
    if kind == "q4":
        return quantize_q4(w, layout)
    if kind == "q4g":
        return quantize_q4g(w, layout)
    raise ValueError(f"unknown quant kind: {kind}")


def pack_q4(vals: torch.Tensor) -> torch.Tensor:
    """Unpacked offset-7 values [.., K] (K % 32 == 0) -> uint8 [.., K//2]:
    within each 32-block, byte j = vals[j] << 4 | vals[j + 16]."""
    blocks = vals.to(torch.uint8).reshape(*vals.shape[:-1], -1, BLOCK_SIZE)
    half = BLOCK_SIZE // 2
    packed = (blocks[..., :half] << 4) | (blocks[..., half:] & 0x0F)
    return packed.reshape(*vals.shape[:-1], vals.shape[-1] // 2)


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_q4``: uint8 [.., K//2] -> offset-7 values [.., K]."""
    half = packed.reshape(*packed.shape[:-1], -1, BLOCK_SIZE // 2)
    vals = torch.cat([half >> 4, half & 0x0F], dim=-1)
    return vals.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def to_kn(qt: QTensor) -> QTensor:
    """An "nk" QTensor in the "kn" matmul layout (values unchanged): both
    planes transposed, which is the kn nibble layout too."""
    if qt.layout == "kn":
        return qt
    return QTensor(qt.data.transpose(-1, -2).contiguous(),
                   qt.scales.transpose(-1, -2).contiguous(), qt.kind, "kn")


def stack(qts: list[QTensor]) -> QTensor:
    """QTensors of one kind, layout and shape (the layers of a weight) ->
    one QTensor with a leading layer axis."""
    first = qts[0]
    return QTensor(torch.stack([q.data for q in qts]),
                   torch.stack([q.scales for q in qts]), first.kind, first.layout)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense values in storage orientation: [.., N, K] for "nk",
    [.., K, N] for "kn". Computed in f32 (int x fp16 is exact there),
    then cast to `dtype`."""
    kn = qt.layout == "kn"
    if qt.kind == "q8":
        vals = qt.data.float()
    elif qt.kind in ("q4", "q4g"):
        data = qt.data.transpose(-1, -2) if kn else qt.data
        vals = unpack_q4(data).float() - Q4_OFFSET
        if kn:
            vals = vals.transpose(-1, -2)
    else:
        raise ValueError(f"unknown quant kind: {qt.kind}")
    sexp = qt.scales.float().repeat_interleave(block_size(qt.kind),
                                               dim=-2 if kn else -1)
    return (vals * sexp).to(dtype)


# ----------------------------------------------------------------------------
# numpy oracles and gten's q4 packing (checkpoint I/O)
# ----------------------------------------------------------------------------


def _np_deltas(w: np.ndarray, qmax: float):
    if w.shape[-1] % BLOCK_SIZE:
        raise ValueError(f"d_in must be a multiple of 32, got {w.shape}")
    blocks = w.astype(np.float32).reshape(*w.shape[:-1], -1, BLOCK_SIZE)
    deltas = np.abs(blocks).max(axis=-1) / np.float32(qmax)
    inv = np.where(deltas != 0, 1.0 / np.where(deltas != 0, deltas, 1),
                   0).astype(np.float32)
    return blocks, deltas, inv


def np_quantize_q8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(int8 data [.., d_in], f16 deltas [.., d_in//32]): absmax/127 in
    f32, round half to even, the reference converter's rule."""
    blocks, deltas, inv = _np_deltas(w, Q8_MAX)
    q = np.round(blocks * inv[..., None]).astype(np.int8)
    return q.reshape(w.shape), deltas.astype(np.float16)


def np_quantize_q4(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 offset-7 values [.., d_in] UNPACKED, f16 deltas): absmax/7
    in f32, round half to even, + 7."""
    blocks, deltas, inv = _np_deltas(w, Q4_MAX)
    q = (np.round(blocks * inv[..., None]) + Q4_OFFSET).astype(np.uint8)
    if q.max(initial=0) > 14:
        raise ValueError("a q4 value left [0, 14]")
    return q.reshape(w.shape), deltas.astype(np.float16)


def np_dequantize_q4_unpacked(vals: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    d = np.repeat(deltas.astype(np.float32), BLOCK_SIZE, axis=-1)
    return (vals.astype(np.float32) - Q4_OFFSET) * d


def gten_q4_pack(vals: np.ndarray) -> np.ndarray:
    """Unpacked offset-7 values [.., d_in] -> gten's half-block packing
    (uint8 [.., d_in//2]; within each 32-block byte j = q[j] << 4 |
    q[j + 16]), the numpy twin of ``pack_q4``."""
    blocks = vals.reshape(*vals.shape[:-1], -1, BLOCK_SIZE)
    t0 = blocks[..., : BLOCK_SIZE // 2]
    t1 = blocks[..., BLOCK_SIZE // 2:]
    packed = (t0 << 4) | (t1 & 0x0F)
    return packed.reshape(*vals.shape[:-1], vals.shape[-1] // 2).astype(np.uint8)


def gten_q4_unpack(packed: np.ndarray) -> np.ndarray:
    """Inverse of ``gten_q4_pack`` -> unpacked offset-7 values [.., d_in]."""
    half = packed.reshape(*packed.shape[:-1], -1, BLOCK_SIZE // 2)
    blocks = np.concatenate([half >> 4, half & 0x0F], axis=-1).astype(np.uint8)
    return blocks.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
