"""Linear layers over dense or block-quantized weights, and the token
embedding.

Quantized weights are QTensors of kind q8, q4 or q4g: "kn" for every
matmul (layer-stacked inside the model) and "nk" for the embedding table.
Every quantized matmul goes to ``ops/kernels/qmatmul.py``: its kernels for
CUDA tensors, its plain version for CPU tensors. ``aq8`` (the q8a8 and
q4a8 policies) quantizes the activations to int8 per 32-block inside the
decode kernel (K1, M <= 8), as the JAX package's ``linear(..., aq8=True)``
does on its Pallas path.

Dense weights (the f16, bf16 and f32 policies) are [d_out, d_in] tensors,
as in the JAX package, whose dense products run outside any Pallas
kernel: a plain ``torch.matmul``. The weight takes the activation dtype
(an f16 weight becomes bf16 under the f16 policy, as JAX computes it),
the product accumulates in f32, and ``linear`` rounds it once to
x.dtype. f32 and f16 operands multiply at full precision (JAX's HIGHEST):
f32 products with TF32 off. bf16 operands run on the card's tensor cores
with f32 accumulation; on the CPU they are upcast to f32 first (exact),
as the JAX package's ``cpu_safe_operand`` does.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.ops.kernels.qmatmul import layer_index, qmatmul
from tinyllama_tpu_torch.ops.precision import exact_f32
from tinyllama_tpu_torch.quant.codec import QTensor, dequantize


def dense_product(x: torch.Tensor, w: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """x [..., K] @ w[N, K]^T -> [..., N] in out_dtype: w cast to x.dtype,
    exact products, f32 accumulation, one rounding to out_dtype."""
    w = w.to(x.dtype)
    with exact_f32():
        if x.is_cuda and x.dtype == torch.bfloat16:
            if out_dtype == torch.bfloat16:
                return torch.matmul(x, w.t())
            x2 = x.reshape(-1, x.shape[-1])
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
            return out.reshape(*x.shape[:-1], w.shape[0]).to(out_dtype)
        return torch.matmul(x.float(), w.float().t()).to(out_dtype)


def linear(x: torch.Tensor, w, layer=None, aq8: bool = False) -> torch.Tensor:
    """x [..., d_in] @ w -> [..., d_out] in x.dtype. `layer` picks one
    layer of a layer-stacked weight: a one-element int32 tensor on x's
    device, read inside the kernel, for a QTensor; an int for a dense
    [L, d_out, d_in] tensor."""
    if isinstance(w, QTensor):
        return qmatmul(x, w, layer=layer, aq8=aq8)
    if layer is not None:
        w = w[layer_index(layer)]
    return dense_product(x, w, x.dtype)


def linear_f32_out(x: torch.Tensor, w, aq8: bool = False) -> torch.Tensor:
    """Like `linear` but keeps the f32 accumulator as the result (the
    lm_head: logits are f32 in the reference), with x in its own dtype."""
    if isinstance(w, QTensor):
        return qmatmul(x, w, out_dtype=torch.float32, aq8=aq8)
    return dense_product(x, w, torch.float32)


def embedding_lookup(tokens: torch.Tensor, table, dtype) -> torch.Tensor:
    """tokens [B, T] -> [B, T, D] in `dtype`. A dense table's rows are
    gathered and cast; a quantized one's packed rows and scales are
    gathered, then only those rows dequantized (any kind: a 4-bit row is
    d_in/2 bytes of nibbles). An id past the table takes its last row, as
    JAX's gather clamps (the tiny configurations' 512 rows under a
    32,000-piece tokenizer); on the card an out-of-range index would
    stop the device instead."""
    idx = tokens.long().clamp(max=table.shape[0] - 1)
    if not isinstance(table, QTensor):
        return table[idx].to(dtype)
    if table.layout != "nk":
        raise ValueError("embedding tables are row-major (nk)")
    rows = QTensor(table.data[idx], table.scales[idx], table.kind, "nk")
    return dequantize(rows, dtype)
