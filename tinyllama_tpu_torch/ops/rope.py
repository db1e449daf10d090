"""Rotary position embeddings (GPT-NeoX half-rotation style).

Pairs (j, j + d_head/2) rotate by ``theta_j = pos * base^(-2j/d_head)``.
The f32 cos/sin tables are computed once with numpy exactly as the JAX
package computes them, then gathered by position each step.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_table(max_ctx: int, d_head: int, base: float = 10000.0,
               device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_ctx, d_head//2], f32."""
    d_half = d_head // 2
    j = np.arange(d_half, dtype=np.float32)
    inv_freq = np.power(np.float32(base), -(2.0 * j / np.float32(d_head)))
    pos = np.arange(max_ctx, dtype=np.float32)
    angles = np.outer(pos, inv_freq)
    return (torch.from_numpy(np.cos(angles)).to(device),
            torch.from_numpy(np.sin(angles)).to(device))


def gather_rope(
    positions: torch.Tensor,  # [B, T] integer
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) rows for a step's positions: [B, T, d_half] f32. The
    rows are the same for every layer, so the caller gathers them once
    per step."""
    idx = positions.long()
    return cos_table[idx], sin_table[idx]


def apply_rope_gathered(
    x: torch.Tensor,  # [B, T, n_heads, d_head]
    cos: torch.Tensor,  # [B, T, d_half] f32
    sin: torch.Tensor,
) -> torch.Tensor:
    """Half-rotation: out0 = x0*cos - x1*sin, out1 = x0*sin + x1*cos.
    Computed in f32, returned in x.dtype."""
    d_half = x.shape[-1] // 2
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    x0 = xf[..., :d_half]
    x1 = xf[..., d_half:]
    out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.to(x.dtype)
