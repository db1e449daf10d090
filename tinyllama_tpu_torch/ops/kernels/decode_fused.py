"""Fused decode-layer matmuls: rms_norm and the residual add inside the
quantized weight stream (q8, q4 or q4g), for M <= 32 rows.

Replaces two kernels of tinyllama_tpu/ops/pallas/decode_fused.py with
hand-written Hopper kernels (csrc/decode_fused.cu):

* K5 ``fused_norm_qkv`` for ``_norm_qkv_kernel``: rms_norm(x) * w_norm
  @ dequant(wqkv). Bound by the weight bytes over the memory rate. It
  runs on the walk that K7 shares (csrc/fused_walk.cuh): column tiles
  times K splits (``fused_plan.fused_plan``, shapes only), each split
  one block of a cluster that streams its weight rows through a
  ``cp.async`` ring and stages only its slice of x; the row statistic
  comes from the splits' sums of squares, exchanged in the cluster, and
  the splits' partial products are summed in split order there.
* K6 ``fused_out_residual`` for ``_out_res_kernel``: residual + attn @
  dequant(wo), one launch of the same walk with x as given and the
  residual added to the f32 sum once, in the epilogue (the plan from
  ``fused_plan.fused_plan`` as K5's). Bound by the weight bytes.

The module also holds the gate of the fused branch
(``decode_fused_eligible``) and the plain arithmetic of the fused kernels
(``rms_normed``), which ffn_fused.py and attn_out_fused.py share. Norm
weights come as the stacked [L, D] table and the layer index as a device
tensor, so nothing is sliced per layer. CUDA tensors (bf16 activations)
launch a kernel or raise; only CPU tensors go to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tinyllama_tpu_torch.config import ModelConfig
from tinyllama_tpu_torch.ops.kernels import build, fused_plan, qmatmul
from tinyllama_tpu_torch.ops.kernels.counts import count
from tinyllama_tpu_torch.quant.codec import QTensor

#: largest M (= B * T) of the fused branch; larger M takes the unfused one.
FUSED_M = 32
#: the fused kernels take output columns in whole strips of this many
#: (the JAX package's rule; the walk itself takes 4-column groups)
STRIP = 32

#: launches of each kernel since the counts were last set to 0.
launches = {"fused_norm_qkv": 0, "fused_out_residual": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_fused")
    if lib.fused_norm_qkv.argtypes is None:
        lib.fused_norm_qkv.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 3 + [_P]
        lib.fused_out_residual.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        for fn in (lib.fused_norm_qkv_resident, lib.fused_out_residual_resident):
            fn.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
            fn.restype = _I
        lib.fused_norm_qkv.restype = lib.fused_out_residual.restype = _I
    return lib


def decode_fused_eligible(cfg: ModelConfig, lp: dict, M: int,
                          aq8: bool = False, tp: int = 1) -> bool:
    """Whether a block of M = B * T rows takes the fused branch, by the
    rule of the JAX package's ``decode_fused_eligible``: M <= 32, no aq8
    activations (the fused kernels take no int8 activations), no tensor
    parallelism (tp > 1: the row-parallel sums sit between the products
    the fused kernels join), all four linears kn QTensors, n_embd <= 2048.
    The port's weights are always layer-stacked, so that condition of the
    JAX rule never refuses here."""
    if M > FUSED_M or aq8 or tp > 1:
        return False
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        w = lp.get(name)
        if not (isinstance(w, QTensor) and w.layout == "kn"):
            return False
    return cfg.n_embd <= 2048


def rms_normed(x2: torch.Tensor, norm_w: torch.Tensor, layer, eps: float,
               inside: bool) -> torch.Tensor:
    """rms_norm of x2 [M, D] by row `layer` of the [L, D] table, in f32
    (the TPU kernels' ``_rms_normed``), cast to x2.dtype as the kernels
    cast the normed slice to the compute dtype."""
    xf = x2.float()
    ms = (xf * xf).mean(dim=1, keepdim=True)
    nrm = xf * torch.rsqrt(ms + eps) if inside else xf / (torch.sqrt(ms) + eps)
    return (nrm * norm_w[qmatmul.layer_index(layer)].float()).to(x2.dtype)


def fused_norm_qkv_ref(x, norm_w, w, layer, eps, inside) -> torch.Tensor:
    """Plain version of K5: x [B, T, D] -> [B, T, N] in x.dtype."""
    B, T, D = x.shape
    h = rms_normed(x.reshape(-1, D), norm_w, layer, eps, inside)
    return qmatmul.dot_ref(h, w, layer).to(x.dtype).reshape(B, T, -1)


def fused_out_residual_ref(attn, residual, w, layer) -> torch.Tensor:
    """Plain version of K6: residual + attn @ dequant(w), the residual
    added to the f32 sum, cast to residual.dtype once."""
    B, T, D = residual.shape
    out = residual.reshape(-1, D).float() + qmatmul.dot_ref(
        attn.reshape(B * T, -1), w, layer)
    return out.to(residual.dtype).reshape(B, T, D)


def check_rows(x2: torch.Tensor, w: QTensor, layer) -> None:
    """What the fused kernels take for x2 [M, K] against the
    layer-stacked kn weight w (any kind): qmatmul's checks, M <= 32 and
    whole 32-column strips."""
    qmatmul._check(x2, w, layer, torch.bfloat16)
    M, N = x2.shape[0], w.data.shape[-1]
    if M > FUSED_M or N % STRIP:
        raise ValueError(f"the fused kernels take M <= {FUSED_M} rows and "
                         f"N % {STRIP} == 0, got M={M}, N={N}")


def check_like(t: torch.Tensor, shape, dtype, device, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def check_norm(norm_w: torch.Tensor, w: QTensor, K: int, device) -> None:
    check_like(norm_w, (w.data.shape[0], K), torch.float32, device,
               "the norm weight (the stacked [L, D] table)")


@functools.lru_cache(maxsize=None)
def plan(kind: int, M: int, K: int, N: int, n_sm: int,
         entry: str = "fused_norm_qkv") -> tuple[int, int]:
    """The (tile width, K splits) of K5 (or, with `entry`
    "fused_out_residual", K6) for M rows of K -> N, kind code `kind`, on
    the current card: ``fused_plan.fused_plan`` with the card's count of
    the launch's clusters it keeps resident."""
    def resident(width, splits):
        n = ctypes.c_int(0)
        build.check(getattr(_lib(), f"{entry}_resident")(kind, M, K, width, splits,
                                                         ctypes.byref(n)), entry)
        return n.value
    return fused_plan.fused_plan(K, N, n_sm, resident)


def fused_norm_qkv(x: torch.Tensor, norm_w: torch.Tensor, w: QTensor,
                   layer: torch.Tensor, eps: float,
                   inside: bool) -> torch.Tensor:
    """rms_norm(x) * norm_w[layer] @ dequant(w[layer]) -> [B, T, N] in
    x.dtype; x [B, T, D] unnormed, norm_w the [L, D] table."""
    if not x.is_cuda:
        return fused_norm_qkv_ref(x, norm_w, w, layer, eps, inside)
    B, T, D = x.shape
    x2 = x.reshape(-1, D)
    check_rows(x2, w, layer)
    check_norm(norm_w, w, D, x.device)
    M, N = x2.shape[0], w.data.shape[-1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    width, splits = plan(qmatmul.KIND_CODE[w.kind], M, D, N, qmatmul.sm_count(x.device))
    err = _lib().fused_norm_qkv(
        x2.data_ptr(), norm_w.data_ptr(), layer.data_ptr(), w.data.data_ptr(),
        w.scales.data_ptr(), out.data_ptr(), qmatmul.KIND_CODE[w.kind], M, D, N,
        float(eps), int(inside), width, splits, build.stream_ptr(x))
    build.check(err, "fused_norm_qkv")
    count(launches, "fused_norm_qkv")
    return out.reshape(B, T, N)


def fused_out_residual(attn: torch.Tensor, residual: torch.Tensor, w: QTensor,
                       layer: torch.Tensor) -> torch.Tensor:
    """residual + attn @ dequant(w[layer]) -> [B, T, D] in residual.dtype;
    attn [B, T, K], residual [B, T, D] with D = N."""
    if not attn.is_cuda:
        return fused_out_residual_ref(attn, residual, w, layer)
    B, T, D = residual.shape
    a2 = attn.reshape(B * T, -1)
    check_rows(a2, w, layer)
    check_like(residual, (B, T, w.data.shape[-1]), torch.bfloat16,
               attn.device, "the residual")
    out = torch.empty_like(residual)
    code, M, K = qmatmul.KIND_CODE[w.kind], B * T, a2.shape[1]
    err = _lib().fused_out_residual(
        a2.data_ptr(), residual.data_ptr(), layer.data_ptr(), w.data.data_ptr(),
        w.scales.data_ptr(), out.data_ptr(), code, M, K, D,
        *plan(code, M, K, D, qmatmul.sm_count(attn.device), "fused_out_residual"),
        build.stream_ptr(attn))
    build.check(err, "fused_out_residual")
    count(launches, "fused_out_residual")
    return out
