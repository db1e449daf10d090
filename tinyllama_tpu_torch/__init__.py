"""tinyllama_tpu_torch: the PyTorch / CUDA port of tinyllama_tpu.

TinyLlama inference on one NVIDIA H100: the model and engine in PyTorch,
and every kernel that the JAX package wrote in Pallas for the TPU written
by hand in CUDA C++ for Hopper (``csrc/``). Each kernel keeps a plain
PyTorch twin, which is what runs on CPU tensors.
"""

from tinyllama_tpu_torch.config import (
    DtypePolicy,
    GenerationConfig,
    LLAMA_3_8B,
    LLAMA_3_70B,
    MODEL_REGISTRY,
    ModelConfig,
    POLICIES,
    TINYLLAMA_1_1B,
    tiny_test_config,
)
from tinyllama_tpu_torch.quant.codec import QTensor, dequantize, quantize

__version__ = "0.1.0"

__all__ = [
    "DtypePolicy",
    "GenerationConfig",
    "LLAMA_3_8B",
    "LLAMA_3_70B",
    "MODEL_REGISTRY",
    "ModelConfig",
    "POLICIES",
    "QTensor",
    "TINYLLAMA_1_1B",
    "dequantize",
    "quantize",
    "tiny_test_config",
]
