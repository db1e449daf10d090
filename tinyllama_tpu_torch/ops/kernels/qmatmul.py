"""Quantized matmul: x [..., K] @ dequant(w) -> [..., N], w a "kn" q8 QTensor.

Replaces the two kernel bodies behind ``qmatmul`` in
tinyllama_tpu/ops/pallas/qmatmul.py with hand-written Hopper kernels
(csrc/qmatmul.cu):

* K1 ``qmm_smallm`` (M <= 8, decode) for ``_qmm_kernel_smallm``: bound
  by the weight bytes over the memory rate. The weight streams once,
  read as char4 along N; each 32-block's dot is scaled by its fp16 scale
  after the dot.
* K2 ``qmm_bigm`` (M > 8, prefill) for ``_qmm_kernel_bigm``: bound by
  tensor-core operations at large M. Each weight tile is dequantized to
  bf16 once in shared memory and multiplied on the tensor cores with f32
  accumulation.

Both take the layer-stacked weight ``[L, K, N]`` with a device layer
index, so nothing is sliced or copied per layer and the launch stays
capturable. The wrapper launches a kernel for CUDA tensors (bf16
activations only) and raises on what the kernels do not take; only CPU
tensors go to the plain version ``qmatmul_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.precision import exact_f32
from tinyllama_tpu_torch.quant.codec import BLOCK_SIZE, QTensor, dequantize

#: largest M that takes the decode kernel (K1); larger M takes K2.
SMALL_M = 8

#: launches of each kernel since the counts were last set to 0.
launches = {"qmm_smallm": 0, "qmm_bigm": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("qmatmul")
    if lib.qmm_smallm.argtypes is None:
        for fn in (lib.qmm_smallm, lib.qmm_bigm):
            fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
            fn.restype = _I
    return lib


def _layer_view(w: QTensor, layer) -> tuple[torch.Tensor, torch.Tensor]:
    if layer is None:
        return w.data, w.scales
    li = int(layer.reshape(-1)[0]) if torch.is_tensor(layer) else int(layer)
    return w.data[li], w.scales[li]


def qmatmul_ref(x: torch.Tensor, w: QTensor, out_dtype=None,
                layer=None) -> torch.Tensor:
    """Plain version of both kernels, any device. M <= 8 multiplies by the
    f32-dequantized weight (int8 x fp16 is exact in f32, as K1's post-dot
    scaling is); larger M first rounds the dequantized weight to x.dtype,
    as K2 and the TPU prefill kernel do. f32 accumulation either way,
    with TF32 off."""
    out_dtype = out_dtype or x.dtype
    data, scales = _layer_view(w, layer)
    wd = dequantize(QTensor(data, scales, w.kind, w.layout), torch.float32)
    *lead, K = x.shape
    x2 = x.reshape(-1, K)
    if x2.shape[0] > SMALL_M:
        wd = wd.to(x.dtype).float()
    with exact_f32():
        out = x2.float() @ wd
    return out.to(out_dtype).reshape(*lead, wd.shape[-1])


def _check(x2: torch.Tensor, w: QTensor, layer, out_dtype) -> None:
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA qmatmul takes bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if w.kind != "q8" or w.layout != "kn":
        raise ValueError(f"the CUDA qmatmul takes q8 kn weights, got "
                         f"{w.kind}/{w.layout}")
    if w.data.dtype != torch.int8 or w.scales.dtype != torch.float16:
        raise TypeError("q8 weights are int8 data with float16 scales")
    stacked = w.data.dim() == 3
    if w.data.dim() not in (2, 3) or stacked != (layer is not None):
        raise ValueError("pass `layer` exactly when the weight is layer-stacked")
    K, N = w.data.shape[-2:]
    if x2.shape[1] != K or K % BLOCK_SIZE:
        raise ValueError(f"x has K={x2.shape[1]}, weight K={K} (needs K % 32 == 0)")
    if w.scales.shape[-2:] != (K // BLOCK_SIZE, N):
        raise ValueError(f"scales {tuple(w.scales.shape)} do not match data")
    if x2.shape[0] <= SMALL_M and N % 4:
        raise ValueError(f"the decode kernel reads char4 rows: N % 4 != 0 ({N})")
    if x2.shape[0] > SMALL_M and K % (2 * BLOCK_SIZE):
        raise ValueError(f"the prefill kernel steps 64 rows of K: K={K}")
    for t in (x2, w.data, w.scales):
        if not t.is_cuda or t.device != x2.device:
            raise ValueError("x and the weight must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA qmatmul takes contiguous tensors on "
                             "16-byte boundaries (vector loads)")
    if stacked and not (torch.is_tensor(layer) and layer.is_cuda
                        and layer.dtype == torch.int32 and layer.numel() == 1
                        and layer.device == x2.device):
        raise ValueError("`layer` must be a one-element int32 CUDA tensor")


def qmatmul(x: torch.Tensor, w: QTensor, out_dtype=None,
            layer: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] @ dequant(w) -> [..., N] in out_dtype (default x.dtype).

    `w` is a "kn" q8 QTensor, layer-stacked ([L, K, N]) iff `layer` is
    given; on CUDA `layer` is a one-element int32 device tensor."""
    if not x.is_cuda:
        return qmatmul_ref(x, w, out_dtype, layer)
    out_dtype = out_dtype or x.dtype
    *lead, K = x.shape
    x2 = x.reshape(-1, K)
    _check(x2, w, layer, out_dtype)
    M, N = x2.shape[0], w.data.shape[-1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    name = "qmm_smallm" if M <= SMALL_M else "qmm_bigm"
    fn = getattr(_lib(), name)
    li = None if layer is None else layer.data_ptr()
    err = fn(x2.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(), li,
             out.data_ptr(), int(out_dtype == torch.float32), M, K, N,
             build.stream_ptr(x))
    build.check(err, name)
    launches[name] += 1
    return out.reshape(*lead, N)
