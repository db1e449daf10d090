"""Offline HuggingFace checkpoint -> .gten converter.

The port's counterpart of the JAX package's io/convert.py: reads a HF
checkpoint (a torch .bin / .pt state dict, a .safetensors file, or a
directory of either, read by ``io/checkpoint.load_hf_state_dict``
without the safetensors package) and writes an fp16, q8 or q4 .gten file
in the loader's exact weight order (``io/gten.write_gten``).

    python -m tinyllama_tpu_torch.io.convert MPATH {fp16,q8,q4} [-o OUT] \\
        [--model PRESET]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tinyllama_tpu_torch.config import MODEL_REGISTRY, TINYLLAMA_1_1B, ModelConfig
from tinyllama_tpu_torch.io import gten
from tinyllama_tpu_torch.io.checkpoint import load_hf_state_dict


def hf_weights(mpath: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a HF checkpoint as f32 numpy (exact for f16, bf16
    and f32 tensors)."""
    return {k: v.float().numpy()
            for k, v in load_hf_state_dict(Path(mpath)).items()}


def convert_model_to_gten(mpath: str | Path, dtype: str,
                          out_path: str | Path | None = None,
                          cfg: ModelConfig = TINYLLAMA_1_1B) -> Path:
    out_path = Path(out_path or f"tinyllama.{dtype}.gten")
    gten.write_gten(out_path, cfg, hf_weights(mpath), dtype)
    return out_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("mpath", help="Model path to be converted.")
    parser.add_argument("dtype", help="output dtype.",
                        choices=gten.FILE_DTYPES)
    parser.add_argument("-o", "--out", default=None, help="output .gten path")
    parser.add_argument("--model", default=TINYLLAMA_1_1B.name,
                        choices=sorted(MODEL_REGISTRY),
                        help="architecture preset")
    args = parser.parse_args(argv)
    out = convert_model_to_gten(args.mpath, args.dtype, args.out,
                                MODEL_REGISTRY[args.model])
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
