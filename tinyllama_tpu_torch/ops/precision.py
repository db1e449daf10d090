"""Exact-input products with f32 accumulation.

The JAX package runs f32 (and f16) matmuls at HIGHEST precision, so
prefill and decode agree to rounding (ops/linear.py there), and bf16
ones accumulate in f32. On the card a PyTorch f32 matmul may run in
TF32, which keeps about three decimal digits, when
``torch.backends.cuda.matmul.allow_tf32`` is set, and a bf16 or f16
matmul may reduce its split-K partials in the operand type when
``allow_bf16_reduced_precision_reduction`` (``..._fp16_...``) is set.
The plain paths multiply inside ``exact_f32()``, which holds all three
off.
"""

from __future__ import annotations

import contextlib

import torch

_FLAGS = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
          "allow_fp16_reduced_precision_reduction")


@contextlib.contextmanager
def exact_f32():
    m = torch.backends.cuda.matmul
    prev = {f: getattr(m, f) for f in _FLAGS}
    for f in _FLAGS:
        setattr(m, f, False)
    try:
        yield
    finally:
        for f, v in prev.items():
            setattr(m, f, v)
