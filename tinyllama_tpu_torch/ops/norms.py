"""RMS normalization.

The reference normalizes as ``x / (sqrt(mean(x^2)) + eps) * w`` (epsilon
added to the root mean square, outside the sqrt); HF Llama computes
``x * rsqrt(mean(x^2) + eps)``. ModelConfig.norm_eps_inside_sqrt selects
the convention. Plain PyTorch: the TPU package left this to XLA fusion,
and no TPU kernel is behind it.
"""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    eps_inside_sqrt: bool = False,
) -> torch.Tensor:
    """Normalize the last axis. Computes in f32, returns x.dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    if eps_inside_sqrt:
        normed = xf * torch.rsqrt(ms + eps)
    else:
        normed = xf / (torch.sqrt(ms) + eps)
    return (normed * weight.float()).to(x.dtype)
