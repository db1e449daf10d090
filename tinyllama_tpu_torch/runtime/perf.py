"""Performance report: the reference's print_perf table (per-token
latency, phase totals, weights / KV memory), plus decode tok/s and the
weight-stream roofline of the card.

The memory rate is the H100 SXM's published figure (NVIDIA data
sheet): 3.35 TB/s of HBM3, at the card's full 700 W power limit.
"""

from __future__ import annotations

import torch

from tinyllama_tpu_torch.quant.codec import QTensor
from tinyllama_tpu_torch.runtime.engine import GenStats

#: peak HBM bandwidth, bytes/s, by a substring of the device name
HBM_BW = {"H100": 3.35e12}


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a params dict, QTensor or KV cache."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, QTensor):
        return tree_nbytes(tree.data) + tree_nbytes(tree.scales)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if hasattr(tree, "k") and hasattr(tree, "v"):
        return tree_nbytes(tree.k) + tree_nbytes(tree.v)
    return 0


def detect_hbm_bw(device) -> float | None:
    """The card's peak memory rate in bytes/s, None off a known card."""
    if torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in HBM_BW.items() if k in name), None)


def perf_report(stats: GenStats, params=None, cache=None,
                device="cpu") -> str:
    """Format the performance table (reference layout, card metrics
    added when `device` is a known card)."""
    weights_mb = tree_nbytes(params) / 1e6 if params is not None else 0.0
    cache_mb = tree_nbytes(cache) / 1e6 if cache is not None else 0.0
    lines = [
        "",
        "-------------------------------",
        " PERFORMANCE",
        "-------------------------------",
        f" Inference [per tok] : {stats.ms_per_token:8.2f}ms",
        f" Throughput          : {stats.decode_tokens_per_s:8.1f} tok/s",
        f" Prefill time        : {stats.prefill_s * 1000:8.0f}ms"
        f" ({stats.prompt_tokens} tokens)",
        f" Load time           : {stats.load_s * 1000:8.0f}ms",
        f" Inference [total]   : {stats.decode_s * 1000:8.0f}ms"
        f" ({stats.generated_tokens} tokens)",
        f" Total runtime       : "
        f"{(stats.load_s + stats.prefill_s + stats.decode_s) * 1000:8.0f}ms",
        "-------------------------------",
        f" Mem usage [total]   : {weights_mb + cache_mb:7.0f}MB",
        f" Mem usage [model]   : {weights_mb:7.0f}MB",
        f" Mem usage [kvcache] : {cache_mb:7.0f}MB",
        "-------------------------------",
    ]
    bw = detect_hbm_bw(device)
    if bw and weights_mb and stats.decode_tokens_per_s:
        # every decoded token streams all weights once
        roofline_tps = bw / (weights_mb * 1e6)
        pct = 100.0 * stats.decode_tokens_per_s / roofline_tps
        lines += [
            f" Roofline [tok/s]    : {roofline_tps:8.1f} (weight-stream bound)",
            f" Roofline achieved   : {pct:7.1f}%",
            "-------------------------------",
        ]
    return "\n".join(lines) + "\n"
