"""Carry a JAX parameter tree across to the port, as numpy arrays.

The tests build parameters with the JAX package, turn every array into
numpy and hand the tree here, so both packages run on the same weights.
This module imports no JAX: a quantized tensor arrives as a tuple
``(data, scales, kind, layout)``; dense arrays (the norm weights) arrive
as they are. The JAX package ships "kn" scales as int16 fp16 bit
patterns; they are viewed back as float16, bits unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig
from tinyllama_tpu_torch.models.llama import LAYER_LINEARS, Params
from tinyllama_tpu_torch.quant.codec import BLOCK_SIZE, QTensor


def qtensor_from_numpy(parts, device="cpu") -> QTensor:
    data, scales, kind, layout = parts
    scales = np.asarray(scales)
    if scales.dtype == np.int16:
        scales = scales.view(np.float16)
    if scales.dtype != np.float16:
        raise TypeError(f"q8 scales arrive as fp16 values or bits, got {scales.dtype}")
    return QTensor(torch.from_numpy(np.array(data)).to(device),
                   torch.from_numpy(np.array(scales)).to(device), kind, layout)


def params_from_numpy(tree: dict, cfg: ModelConfig, policy: DtypePolicy,
                      device="cpu") -> Params:
    """The port's parameters from the JAX tree in numpy form (see the
    module docstring), checked against `cfg` and `policy`."""
    if policy.wdtype != "q8":
        raise NotImplementedError(
            f"weights {policy.wdtype!r} are not ported yet (ROADMAP.md)")

    def dense(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    layers = {}
    for name, shape_fn in LAYER_LINEARS.items():
        qt = qtensor_from_numpy(tree["layers"][name], device)
        N, K = shape_fn(cfg)
        want = (cfg.n_layers, K, N)
        if qt.layout != "kn" or tuple(qt.data.shape) != want \
                or tuple(qt.scales.shape) != (cfg.n_layers, K // BLOCK_SIZE, N):
            raise ValueError(f"{name}: expected kn data {want}, got "
                             f"{qt.layout} {tuple(qt.data.shape)}")
        layers[name] = qt
    for name in ("attn_norm", "ffn_norm"):
        layers[name] = dense(tree["layers"][name])
    embed = qtensor_from_numpy(tree["embed"], device)
    lm_head = qtensor_from_numpy(tree["lm_head"], device)
    if embed.layout != "nk" or lm_head.layout != "kn":
        raise ValueError("expected an nk embedding table and a kn lm_head")
    return {"embed": embed, "layers": layers, "norm": dense(tree["norm"]),
            "lm_head": lm_head}
