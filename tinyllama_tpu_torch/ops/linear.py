"""Linear layers over block-quantized weights, and the token embedding.

Weights are QTensors of kind q8, q4 or q4g: "kn" for every matmul
(layer-stacked inside the model) and "nk" for the embedding table. Every matmul goes to
``ops/kernels/qmatmul.py``: its kernels for CUDA tensors, its plain
version for CPU tensors. ``aq8`` (the q8a8 and q4a8 policies) quantizes
the activations to int8 per 32-block inside the decode kernel (K1, M <=
8), as the JAX package's ``linear(..., aq8=True)`` does on its Pallas
path.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.ops.kernels.qmatmul import qmatmul
from tinyllama_tpu_torch.quant.codec import QTensor, dequantize


def linear(x: torch.Tensor, w: QTensor, layer: torch.Tensor | None = None,
           aq8: bool = False) -> torch.Tensor:
    """x [..., d_in] @ w -> [..., d_out] in x.dtype. `layer` (a
    one-element int32 tensor on x's device) picks one layer of a
    layer-stacked weight inside the kernel."""
    return qmatmul(x, w, layer=layer, aq8=aq8)


def linear_f32_out(x: torch.Tensor, w: QTensor, aq8: bool = False) -> torch.Tensor:
    """Like `linear` but keeps the f32 accumulator as the result (the
    lm_head: logits are f32 in the reference), with x in its own dtype."""
    return qmatmul(x, w, out_dtype=torch.float32, aq8=aq8)


def embedding_lookup(tokens: torch.Tensor, table: QTensor,
                     dtype) -> torch.Tensor:
    """Gather the packed rows and scales of the tokens, then dequantize
    only those rows (any kind: a 4-bit row is d_in/2 bytes of nibbles).
    tokens [B, T] -> [B, T, D] in `dtype`."""
    if table.layout != "nk":
        raise ValueError("embedding tables are row-major (nk)")
    idx = tokens.long()
    rows = QTensor(table.data[idx], table.scales[idx], table.kind, "nk")
    return dequantize(rows, dtype)
