"""Fused SwiGLU FFN: gate/up matmul, SwiGLU and down matmul, for M <= 32
rows.

Replaces ``_ffn_fused_kernel`` of tinyllama_tpu/ops/pallas/ffn_fused.py
(K7) with a hand-written Hopper kernel (csrc/ffn_fused.cu, on the walk of
csrc/fused_walk.cuh that K5 shares), behind the TPU kernel's two entries:

* ``ffn_fused_normed``: x + down(silu(gate) * up) over rms_norm(x), the
  fused branch's FFN (norm weight as the stacked [L, D] table);
* ``ffn_fused``: down(silu(gate) * up) over an already normed input, no
  residual: the same kernel with the norm and the residual switched off.

Bound by the weight bytes over the memory rate (36.8 MB a layer at
TinyLlama's widths in q8, 19.5 MB in q4, 17.8 MB in q4g). Both weights
are of one kind. The TPU kernel keeps the [M, F] intermediate in VMEM
across a sequential grid; here a call is two launches of the walk, each
over column tiles times K splits (``fused_plan.fused_plan``, shapes
only), each split one block of a cluster: the gate/up launch writes
silu(gate) * up once as bf16 (the value the down product multiplies) to
a workspace from the wrapper, and the down launch is a programmatic
dependent launch that streams its first weight stages while the gate/up
launch finishes and waits for it before it reads the workspace. One
call counts one launch.

``ffn_fused_eligible`` is the JAX package's gate, with the port's own
copy of ``_pick_bn``'s rule: it decides the same branch as the JAX
package, not a tile of the CUDA kernel. CUDA tensors (bf16 activations)
launch the kernel or raise; only CPU tensors go to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tinyllama_tpu_torch.config import ModelConfig
from tinyllama_tpu_torch.ops.kernels import build, fused_plan, qmatmul
from tinyllama_tpu_torch.ops.kernels.counts import count
from tinyllama_tpu_torch.ops.kernels.decode_fused import (
    FUSED_M,
    STRIP,
    check_norm,
    check_rows,
    rms_normed,
)
from tinyllama_tpu_torch.quant.codec import QTensor

#: launches of each entry since the counts were last set to 0.
launches = {"ffn_fused_normed": 0, "ffn_fused": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("ffn_fused")
    if lib.ffn_fused.argtypes is None:
        lib.ffn_fused.argtypes = [_P] * 9 + [_I] * 4 + [ctypes.c_float] + [_I] * 5 + [_P]
        lib.ffn_fused_resident.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
        lib.ffn_fused.restype = lib.ffn_fused_resident.restype = _I
    return lib


def pick_bn(N: int) -> int:
    """The TPU matmul's lane tile (``qmatmul._pick_bn``): 2048 where it
    divides N, else the largest 128-multiple in [384, 2048] dividing N,
    else N rounded up to 128 (at most 2048)."""
    if N >= 2048 and N % 2048 == 0:
        return 2048
    for bn in range(2048, 383, -128):
        if N % bn == 0:
            return bn
    return min(2048, (N + 127) // 128 * 128)


def ffn_fused_eligible(cfg: ModelConfig, wgu, wdown, M: int) -> bool:
    """The JAX package's ``ffn_fused_eligible``: kn QTensors, M <= 32,
    n_embd <= 2048, and n_ffn a whole number of gate/up tiles."""
    if not (isinstance(wgu, QTensor) and isinstance(wdown, QTensor)):
        return False
    if wgu.layout != "kn" or wdown.layout != "kn":
        return False
    if M > FUSED_M or cfg.n_embd > 2048:
        return False
    bn = pick_bn(cfg.n_ffn)
    return cfg.n_ffn % bn == 0 and 2 * cfg.n_ffn % bn == 0


def ffn_fused_ref(x, norm_w, wgu, wdown, layer, cfg, eps=0.0,
                  inside=False) -> torch.Tensor:
    """Plain version of both entries; norm_w None is ``ffn_fused``. The
    gate and up sums and silu(g) * up = g / (1 + exp(-g)) * up stay f32;
    the intermediate is cast to x.dtype for the down dot; the residual
    joins the f32 sum, cast once."""
    B, T, D = x.shape
    F = cfg.n_ffn
    x2 = x.reshape(-1, D)
    h = x2 if norm_w is None else rms_normed(x2, norm_w, layer, eps, inside)
    gu = qmatmul.dot_ref(h, wgu, layer)
    g, up = gu[:, :F], gu[:, F:]
    act = g / (1.0 + torch.exp(-g)) * up
    out = qmatmul.dot_ref(act.to(x.dtype), wdown, layer)
    if norm_w is not None:
        out = x2.float() + out
    return out.to(x.dtype).reshape(B, T, D)


@functools.lru_cache(maxsize=None)
def plan(kind: int, M: int, K: int, ncols: int, pair: bool, n_sm: int) -> tuple[int, int]:
    """(tile width, K splits) of K7's gate/up launch (pair: K = D, F
    column pairs) or down launch (K = F, D columns) for M rows, kind code
    `kind`, on the current card: ``fused_plan.fused_plan`` with the card's
    count of the launch's clusters it keeps resident."""
    def resident(width, splits):
        n = ctypes.c_int(0)
        build.check(_lib().ffn_fused_resident(kind, M, K, width, splits, int(pair),
                                              ctypes.byref(n)), "ffn_fused")
        return n.value
    return fused_plan.fused_plan(K, ncols, n_sm, resident)


def _launch(x, norm_w, wgu, wdown, layer, cfg, eps, inside, name):
    B, T, D = x.shape
    F = cfg.n_ffn
    x2 = x.reshape(-1, D)
    if wgu.data.shape[-1] != 2 * F or wdown.data.shape[-1] != D \
            or F % STRIP or wgu.kind != wdown.kind:
        raise ValueError(f"w_gateup must map {D} to {2 * F} columns and "
                         f"w_down {F} to {D}, both of one kind, F % {STRIP} == 0")
    check_rows(x2, wgu, layer)
    qmatmul.check_weight(wdown, F, layer, x.device)
    if norm_w is not None:
        check_norm(norm_w, wgu, D, x.device)
    M = x2.shape[0]
    act = torch.empty((M, F), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x2)
    code, n_sm = qmatmul.KIND_CODE[wgu.kind], qmatmul.sm_count(x.device)
    err = _lib().ffn_fused(
        x2.data_ptr(), None if norm_w is None else norm_w.data_ptr(),
        layer.data_ptr(), wgu.data.data_ptr(), wgu.scales.data_ptr(),
        wdown.data.data_ptr(), wdown.scales.data_ptr(), act.data_ptr(),
        out.data_ptr(), code, M, D, F, float(eps), int(inside),
        *plan(code, M, D, F, True, n_sm), *plan(code, M, F, D, False, n_sm),
        build.stream_ptr(x))
    build.check(err, name)
    count(launches, name)
    return out.reshape(B, T, D)


def ffn_fused_normed(x: torch.Tensor, norm_w: torch.Tensor, wgu: QTensor,
                     wdown: QTensor, layer: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """x + FFN(rms_norm(x)) -> [B, T, D] in x.dtype, one launch; norm_w
    is the stacked [L, D] table. The caller has checked
    ``ffn_fused_eligible``."""
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    if not x.is_cuda:
        return ffn_fused_ref(x, norm_w, wgu, wdown, layer, cfg, eps, inside)
    return _launch(x, norm_w, wgu, wdown, layer, cfg, eps, inside,
                   "ffn_fused_normed")


def ffn_fused(h: torch.Tensor, wgu: QTensor, wdown: QTensor,
              layer: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """FFN(h) -> [B, T, D] in h.dtype for an already normed h, one launch,
    no residual. The caller has checked ``ffn_fused_eligible``."""
    if not h.is_cuda:
        return ffn_fused_ref(h, None, wgu, wdown, layer, cfg)
    return _launch(h, None, wgu, wdown, layer, cfg, 0.0, False, "ffn_fused")
