"""Block-wise Q8_0 weight quantization codec.

The reference's Q8_0 format: per block of 32 values along d_in, one fp16
scale ``delta = absmax/127`` and int8 values ``q = round(x/delta)``
(round half to even, as ``torch.round`` and ``jnp.round`` do). Dequantized
values are ``float(q) * float(delta)``, bit-equal to the JAX package's
``codec.dequantize``.

A quantized 2-D weight ``[d_out, d_in]`` (= ``[N, K]``) is a pair of dense
planes in one of two layouts:

* ``layout="nk"`` (row-major; the embedding table): data int8 ``[.., N, K]``,
  scales float16 ``[.., N, K//32]``.
* ``layout="kn"`` (K-major; every matmul weight): data int8 ``[.., K, N]``,
  scales float16 ``[.., K//32, N]``. The decode kernel reads rows of N
  contiguous bytes, so its loads coalesce along N.

Leading axes (the stacked layer axis) are preserved. Scales stay
``torch.float16``; the JAX package ships kn scales as int16 bit patterns
for Mosaic, which the port does not need (``interop.py`` views them back).
The 4-bit formats (q4, q4g) are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BLOCK_SIZE = 32  # the reference's q8 block size
Q8_MAX = 127.0


@dataclass(frozen=True)
class QTensor:
    """A block-quantized tensor: int8 data + per-block fp16 scales."""

    data: torch.Tensor
    scales: torch.Tensor
    kind: str
    layout: str = "nk"

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical [..., d_out, d_in] regardless of layout."""
        if self.layout == "kn":
            d_in = self.scales.shape[-2] * BLOCK_SIZE
            return (*self.data.shape[:-2], self.data.shape[-1], d_in)
        return (*self.data.shape[:-1], self.scales.shape[-1] * BLOCK_SIZE)

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scales.to(device),
                       self.kind, self.layout)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"quant kind {kind!r} is not ported yet (ROADMAP.md, Queue 1: the "
        "q4/q4g branches come with slice 2)"
    )


def quantize_q8(w: torch.Tensor, layout: str = "nk") -> QTensor:
    """Quantize along the last axis into block-32 int8 + fp16 scales.

    The delta is absmax/127 in f32 (quantization divides by that f32
    delta, like the reference's converter); the stored scale is its fp16
    rounding."""
    if w.shape[-1] % BLOCK_SIZE:
        raise ValueError(f"d_in must be a multiple of 32, got {tuple(w.shape)}")
    w = w.float()
    blocks = w.reshape(*w.shape[:-1], -1, BLOCK_SIZE)
    deltas = blocks.abs().amax(dim=-1) / Q8_MAX
    safe = torch.where(deltas != 0, deltas, torch.ones_like(deltas))
    inv = torch.where(deltas != 0, 1.0 / safe, torch.zeros_like(deltas))
    q = torch.round(blocks * inv[..., None]).to(torch.int8).reshape(w.shape)
    scales = deltas.to(torch.float16)
    if layout == "kn":
        return QTensor(q.transpose(-1, -2).contiguous(),
                       scales.transpose(-1, -2).contiguous(), "q8", "kn")
    if layout != "nk":
        raise ValueError(f"unknown layout {layout!r}")
    return QTensor(q, scales, "q8", "nk")


def quantize(w: torch.Tensor, kind: str, layout: str = "nk") -> QTensor:
    if kind == "q8":
        return quantize_q8(w, layout)
    if kind in ("q4", "q4g"):
        raise _not_ported(kind)
    raise ValueError(f"unknown quant kind: {kind}")


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense values in storage orientation: [.., N, K] for "nk",
    [.., K, N] for "kn". Computed in f32 (int8 x fp16 is exact there),
    then cast to `dtype`."""
    if qt.kind != "q8":
        raise _not_ported(qt.kind)
    axis = -2 if qt.layout == "kn" else -1
    sexp = qt.scales.float().repeat_interleave(BLOCK_SIZE, dim=axis)
    return (qt.data.float() * sexp).to(dtype)
