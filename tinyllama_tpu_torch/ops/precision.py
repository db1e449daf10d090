"""Exact-input f32 products.

The JAX package runs f32 matmuls at HIGHEST precision, so prefill and
decode agree to rounding (ops/linear.py there). On the card a PyTorch f32
matmul may run in TF32, which keeps about three decimal digits, when
``torch.backends.cuda.matmul.allow_tf32`` is set. The plain f32 paths
multiply inside ``exact_f32()``, which holds it off.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
