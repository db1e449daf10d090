"""Checkpoint loading: .gten files and HuggingFace checkpoints -> the
port's parameters, and dense parameters -> .gten.

The counterpart of the JAX package's io/checkpoint.py. A .gten file is
parsed on the host (io/gten.py); its payloads travel to the target device
as raw bytes and are split into the port's planes there with torch ops
(``gten.decode_record``), one decode path for every device. The matmul weights are fused as the
model holds them (q | k | v and gate | up along d_out; block quantization
is per row, so concatenating quantized rows keeps every value), stacked
over layers and laid out "kn"; the embedding table stays "nk".

File and policy pair as in the JAX package: a q8 or q4 file loads into
its own policy; an fp16 file loads into a dense policy (f16, bf16, f32:
the values cast to its wdtype, fused and stacked as [L, d_out, d_in])
or into a quantized one (``quantize`` of the file's values), and a q4
or q8 file under q4g is dequantized and requantized (one more 4-bit
rounding); any other pair, a q8 or q4 file under a dense policy
included, raises ValueError.

HuggingFace checkpoints are read without the ``safetensors`` package: a
.safetensors file is an 8-byte little-endian header length, a JSON
header and the raw tensors, which ``read_safetensors`` views with
``torch.frombuffer``; sharded checkpoints follow
``model.safetensors.index.json``; a .bin file goes through
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from tinyllama_tpu_torch.config import DtypePolicy, ModelConfig, POLICIES
from tinyllama_tpu_torch.io import gten
from tinyllama_tpu_torch.models.llama import DTYPES, Params
from tinyllama_tpu_torch.quant.codec import (
    QTensor,
    dequantize,
    quantize,
    stack,
    to_kn,
)

_FILE_TO_POLICY = {"fp16": "f16", "q8": "q8", "q4": "q4"}

#: runtime layer params and the file / HF weights fused into each
_MERGES = {
    "wqkv": ("wq", "wk", "wv"),
    "wo": ("wo",),
    "w_gateup": ("w_gate", "w_up"),
    "w_down": ("w_down",),
    "attn_norm": ("attn_norm",),
    "ffn_norm": ("ffn_norm",),
}
_HF_SUFFIX = {rname: suffix for suffix, rname, _ in gten.BLOCK_WEIGHTS}


def load_gten_checkpoint(path: str | Path, cfg: ModelConfig,
                         policy: DtypePolicy | None = None,
                         device="cpu") -> tuple[Params, DtypePolicy]:
    """Load a .gten file into the port's parameters on `device`. Returns
    (params, the effective policy: the file's own when `policy` is None).
    Norm weights (always fp16 in the file) become f32, exactly."""
    file_dtype, data, recs = gten.read_gten_records(path, cfg)
    if policy is None:
        policy = POLICIES[_FILE_TO_POLICY[file_dtype]]
    canon = {"fp16": None, "q8": "q8", "q4": "q4"}[file_dtype]
    requant = policy.is_quantized and policy.wdtype != canon
    if (requant and not (file_dtype == "fp16" or policy.wdtype == "q4g")) or (
            canon is not None and not policy.is_quantized):
        raise ValueError(
            f"file dtype {file_dtype} incompatible with policy {policy.wdtype}")
    kind = policy.wdtype

    def decode(key):
        """A record -> f16 tensor, or (data, deltas) "nk" planes."""
        return gten.decode_record(data, recs[key], device)

    def dense(decoded) -> torch.Tensor:
        """Any decoded record -> f32, exactly the file's values."""
        if not isinstance(decoded, tuple):
            return decoded.float()
        return dequantize(QTensor(*decoded, file_dtype, "nk"))

    def weight(parts, layout: str) -> QTensor | torch.Tensor:
        """The records of `parts` fused along d_out, in the policy's kind
        (a dense policy: the fp16 values in its wdtype)."""
        decoded = [decode(p) for p in parts]
        if not policy.is_quantized:
            return torch.cat(decoded).to(DTYPES[kind])
        if requant:
            return quantize(torch.cat([dense(d) for d in decoded]), kind, layout)
        qt = QTensor(torch.cat([d for d, _ in decoded]),
                     torch.cat([s for _, s in decoded]), kind, "nk")
        return qt if layout == "nk" else to_kn(qt)

    layers: dict[str, object] = {}
    for name, parts in _MERGES.items():
        if name.endswith("norm"):
            layers[name] = torch.stack([decode(f"{name}.{i}").float()
                                        for i in range(cfg.n_layers)])
        else:
            ws = [weight([f"{p}.{i}" for p in parts], "kn")
                  for i in range(cfg.n_layers)]
            layers[name] = stack(ws) if policy.is_quantized else torch.stack(ws)
    params: Params = {
        "embed": weight(["embed"], "nk"),
        "layers": layers,
        "norm": decode("norm").float(),
        "lm_head": weight(["lm_head"], "kn"),
    }
    return params, policy


# ---------------------------------------------------------------- HuggingFace

#: safetensors dtype names -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU."""
    path = Path(path)
    data = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(data) != len(data):
            raise ValueError(f"short read of {path}")
    (n,) = struct.unpack_from("<Q", data, 0)
    if n > len(data) - 8:
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(bytes(data[8:8 + n]))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if base + end > len(data) or start > end:
            raise ValueError(f"{path}: tensor {name} lies outside the file")
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dt)
            continue
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start,
                               offset=base + start).clone()
        out[name] = raw.view(dt).reshape(info["shape"])
    return out


def load_hf_state_dict(path: Path) -> dict[str, torch.Tensor]:
    """A HuggingFace checkpoint file or directory -> {name: CPU tensor}:
    .safetensors (one file, or shards under model.safetensors.index.json)
    or a torch .bin / .pt."""
    if path.is_dir():
        idx = path / "model.safetensors.index.json"
        if idx.exists():
            weight_map = json.loads(idx.read_text())["weight_map"]
            out: dict[str, torch.Tensor] = {}
            for shard in sorted(set(weight_map.values())):
                out.update(read_safetensors(path / shard))
            return out
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (path / name).exists():
                return load_hf_state_dict(path / name)
        raise FileNotFoundError(f"no checkpoint found under {path}")
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return dict(ckpt)


def load_hf_checkpoint(path: str | Path, cfg: ModelConfig, policy: DtypePolicy,
                       device="cpu") -> Params:
    """Load a HuggingFace Llama-family checkpoint into the port's
    parameters on `device`, quantized or cast per the policy. A tied
    lm_head (cfg.tie_lm_head, or no lm_head.weight) is the embedding
    table."""
    sd = load_hf_state_dict(Path(path))

    def f32(name) -> torch.Tensor:
        return sd[name].to(device, torch.float32)

    def conv(w: torch.Tensor, layout: str):
        if policy.is_quantized:
            return quantize(w, policy.wdtype, layout)
        return w.to(DTYPES[policy.wdtype])

    layers: dict[str, object] = {}
    # one fused name at a time bounds the extra memory to one stack
    for rname, parts in _MERGES.items():
        stacked = torch.stack([
            torch.cat([f32(f"model.layers.{i}.{_HF_SUFFIX[p]}") for p in parts])
            for i in range(cfg.n_layers)])
        layers[rname] = (stacked if rname.endswith("norm")
                         else conv(stacked, "kn"))
        del stacked
    embed = f32("model.embed_tokens.weight")
    tied = cfg.tie_lm_head or "lm_head.weight" not in sd
    lm = embed if tied else f32("lm_head.weight")
    return {
        "embed": conv(embed, "nk"),
        "layers": layers,
        "norm": f32("model.norm.weight"),
        "lm_head": conv(lm, "kn"),
    }


# ---------------------------------------------------------------- writing


def save_gten_checkpoint(path: str | Path, cfg: ModelConfig,
                         dense_params: Params, dtype: str) -> None:
    """Write dense parameters (f32 tensors or arrays, layers stacked and
    fused as the model holds them) to .gten: the converter's counterpart,
    for round trips and for making quantized files from dense ones."""
    D, kv, F = cfg.n_embd, cfg.kv_dim, cfg.n_ffn
    # the file keeps the reference's separate tensors: split rows back out
    pieces = {
        "wqkv": (("self_attn.q_proj.weight", 0, D),
                 ("self_attn.k_proj.weight", D, D + kv),
                 ("self_attn.v_proj.weight", D + kv, D + 2 * kv)),
        "wo": (("self_attn.o_proj.weight", 0, D),),
        "w_gateup": (("mlp.gate_proj.weight", 0, F),
                     ("mlp.up_proj.weight", F, 2 * F)),
        "w_down": (("mlp.down_proj.weight", 0, D),),
        "attn_norm": (("input_layernorm.weight", 0, D),),
        "ffn_norm": (("post_attention_layernorm.weight", 0, D),),
    }

    def host(a) -> np.ndarray:
        if torch.is_tensor(a):
            return a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a, np.float32)

    hf: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": host(dense_params["embed"]),
        "model.norm.weight": host(dense_params["norm"]),
        "lm_head.weight": host(dense_params["lm_head"]),
    }
    for rname, parts in pieces.items():
        stacked = host(dense_params["layers"][rname])
        for i in range(cfg.n_layers):
            for suffix, lo, hi in parts:
                w = stacked[i]
                hf[f"model.layers.{i}.{suffix}"] = w if w.ndim == 1 else w[lo:hi]
    gten.write_gten(path, cfg, hf, dtype)
