"""Quantized matmul: x [..., K] @ dequant(w) -> [..., N], w a "kn" QTensor
of kind q8, q4 or q4g.

Replaces the two kernel bodies behind ``qmatmul`` in
tinyllama_tpu/ops/pallas/qmatmul.py with hand-written Hopper kernels
(csrc/qmatmul.cu):

* K1 ``qmm_smallm`` (M <= 8, decode) for ``_qmm_kernel_smallm``: bound
  by the weight bytes over the memory rate. It runs on the walk of the
  fused decode kernels (csrc/fused_walk.cuh) at row tile 8: column tiles
  times K splits (``smallm_plan``, shapes and the card's residency only),
  each split one block of a cluster that streams its weight rows through
  a ``cp.async`` ring and stages only its slice of x; products on
  ``mma.sync`` with the integer values q (or v - 7) exact in bf16, each
  32-block's dot scaled by its fp16 scale after the dot; the splits'
  partials summed in split order in the cluster; bf16 or f32 out.
* K2 ``qmm_bigm`` (M > 8, prefill) for ``_qmm_kernel_bigm``: bound by
  the weight bytes at M <= 256 and by tensor-core operations above. A
  block owns a 128 x 128 output tile; each 64-deep K step's x tile and
  raw weight land through a 4-stage cp.async ring with mbarriers, the
  weight is dequantized once, straight into ``wgmma``'s A operand in
  registers (the product taken transposed, out^T = W^T x^T), with f32
  accumulation. Where the tiles alone do not fill the card, the K walk
  is split (``bigm_splits``, shapes only), a tile's splits run as one
  thread-block cluster and sum their f32 partials in split order through
  distributed shared memory.

With ``aq8`` (the q8a8 and q4a8 policies) K1 runs its int8-activation
branch, the counterpart of ``block_x`` and the integer dots of
``_qmm_kernel_smallm``: each split quantizes its slice of x to int8 per
32-value block in the kernel (``quantize_x``), each block's dot is one
exact int32 ``mma.sync`` s8 product, scaled by the block's x scale and
then its weight scale. At M > 8 aq8 is ignored and K2 runs unchanged,
as the TPU's big-M kernel has no aq8 branch; q4g has none at all and
raises.

Both take the layer-stacked weight (``[L, K, N]`` int8, or ``[L, K/2,
N]`` uint8 nibbles, with ``[L, K/bs, N]`` fp16 scales) with a device
layer index, so nothing is sliced or copied per layer and the launch
stays capturable, or one unstacked weight (the lm_head). Each kernel is
a template on the bits; q4 and q4g differ only in the scale row a 32-row
block reads. The wrapper launches a kernel for CUDA tensors (bf16
activations only) and raises on what the kernels do not take; only CPU
tensors go to the plain version ``qmatmul_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tinyllama_tpu_torch.ops.kernels import build, fused_plan
from tinyllama_tpu_torch.ops.kernels.counts import count
from tinyllama_tpu_torch.ops.precision import exact_f32
from tinyllama_tpu_torch.quant.codec import (
    BLOCK_SIZE,
    Q4_OFFSET,
    QTensor,
    block_size,
    dequantize,
    unpack_q4,
)

#: largest M that takes the decode kernel (K1); larger M takes K2.
SMALL_M = 8
#: most 64-row steps of x a split of K1 stages, and the most rows of K
#: that K1 takes
SMALLM_SPLIT_STEPS = fused_plan.SMALLM_SPLIT_STEPS
SMALLM_MAX_K = fused_plan.MAX_SPLITS * SMALLM_SPLIT_STEPS * fused_plan.STEP

#: K2's output tile (rows of x, columns of the weight) and K step
BIGM_TILE_M, BIGM_TILE_N, BIGM_STEP = 128, 128, 64
#: most splits of K2's K walk
BIGM_MAX_SPLITS = 8

#: launches of each kernel since the counts were last set to 0.
launches = {"qmm_smallm": 0, "qmm_bigm": 0, "qmm_smallm_aq8": 0}

#: 1/127 rounded once to f32, as the TPU body's ``absmax * (1.0 / 127.0)``
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

#: the kernels' code for each weight kind (csrc/qkind.cuh)
KIND_CODE = {"q8": 0, "q4": 1, "q4g": 2}
#: the data plane's dtype of each kind
DATA_DTYPE = {"q8": torch.int8, "q4": torch.uint8, "q4g": torch.uint8}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("qmatmul")
    if lib.qmm_smallm.argtypes is None:
        for fn in (lib.qmm_smallm, lib.qmm_smallm_aq8):
            fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
            fn.restype = _I
        lib.qmm_smallm_resident.argtypes = [_I] * 7 + [ctypes.POINTER(_I)]
        lib.qmm_smallm_resident.restype = _I
        lib.qmm_bigm.argtypes = [_P] * 5 + [_I] * 6 + [_P]
        lib.qmm_bigm.restype = _I
    return lib


def bigm_splits(M: int, N: int, K: int, n_sm: int) -> int:
    """Splits of K2's K walk, one cluster of blocks a tile: the largest
    power of two, at most BIGM_MAX_SPLITS and K's steps, that keeps tiles
    x splits within 4/3 of the card's `n_sm` SMs (1 where the tiles alone
    reach that). About one block an SM: on the card more splits than that
    cost more in prologues and partials than they gained (PERF.md). Host
    sizes only: a tensor raises."""
    for v in (M, N, K, n_sm):
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise TypeError(f"bigm_splits takes positive ints, got {v!r}")
    tiles = -(-M // BIGM_TILE_M) * -(-N // BIGM_TILE_N)
    most = min(BIGM_MAX_SPLITS, K // BIGM_STEP)
    splits = 1
    while 2 * splits <= most and 3 * tiles * 2 * splits <= 4 * n_sm:
        splits *= 2
    return splits


def bigm_blocks(M: int, N: int, K: int, splits: int):
    """K2's grid as the kernel reads it: for block (x, y), its M tile, N
    tile and K steps [s0, s1). x runs over the output tiles with the N
    tiles of one M tile adjacent; y is the split."""
    n_nt = -(-N // BIGM_TILE_N)
    n_tiles = -(-M // BIGM_TILE_M) * n_nt
    nk = K // BIGM_STEP
    return {(x, y): (x // n_nt, x % n_nt, y * nk // splits, (y + 1) * nk // splits)
            for x in range(n_tiles) for y in range(splits)}


@functools.lru_cache(maxsize=None)
def smallm_plan(kind: int, M: int, K: int, N: int, aq8: bool,
                n_sm: int) -> tuple[int, int]:
    """K1's (tile width, K splits) for M <= 8 rows of K -> N, kind code
    `kind`, on the current card: ``fused_plan.fused_plan`` with K1's
    slices of up to SMALLM_SPLIT_STEPS steps, n_sm / 32 SMs of slack and
    aq8's doubled splits, and the card's count of the launch's clusters
    it keeps resident. Shapes only, never a tensor, so a captured lm_head
    launch replays. K past 8 slices of SMALLM_SPLIT_STEPS steps raises."""
    def resident(width, splits):
        n = ctypes.c_int(0)
        build.check(_lib().qmm_smallm_resident(kind, M, K, N, width, splits, int(aq8),
                                               ctypes.byref(n)), "qmm_smallm")
        return n.value
    return fused_plan.fused_plan(K, N, n_sm, resident, SMALLM_SPLIT_STEPS,
                                 n_sm // 32, aq8)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def layer_index(layer) -> int:
    """The host value of a layer index (an int or a one-element tensor),
    for the plain versions."""
    return int(layer.reshape(-1)[0]) if torch.is_tensor(layer) else int(layer)


def _layer_view(w: QTensor, layer) -> tuple[torch.Tensor, torch.Tensor]:
    if layer is None:
        return w.data, w.scales
    li = layer_index(layer)
    return w.data[li], w.scales[li]


def quantize_x(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x2 [M, K] -> (int8 [M, K], f32 scales [M, K/32]): the port's copy of
    the TPU body's ``block_x``. In f32, each row's absmax over a 32-block,
    inv = 127 / absmax (0 for an all-zero block), q = round(x * inv) half
    to even, scale = absmax * (1/127)."""
    M, K = x2.shape
    xf = x2.float().reshape(M, K // BLOCK_SIZE, BLOCK_SIZE)
    absmax = xf.abs().amax(dim=-1)
    # a true division: a Python number over a tensor is its reciprocal
    # times the number in PyTorch, which rounds twice
    inv = torch.where(absmax > 0, torch.full_like(absmax, 127.0) / absmax, 0.0)
    xq = torch.round(xf * inv[..., None]).to(torch.int8)
    return xq.reshape(M, K), absmax * INV_127


def int_values(data: torch.Tensor, kind: str) -> torch.Tensor:
    """A kn data plane [K(/2), N] as its integer values [K, N] in f64: the
    int8 itself (q8), or v - 7 (q4)."""
    if kind == "q8":
        return data.double()
    return (unpack_q4(data.transpose(-1, -2)).double() - Q4_OFFSET
            ).transpose(-1, -2)


def check_aq8(w: QTensor) -> None:
    if w.kind == "q4g":
        raise ValueError("q4g has no aq8 variant (the TPU kernel asserts so)")


def _aq8_dot(x2: torch.Tensor, w: QTensor, layer) -> torch.Tensor:
    """K1's aq8 arithmetic: each 32-block's dot of int8 x with the integer
    weight values is an exact integer (taken in f64), then (float(idot) *
    sx) * s_w in f32, as the TPU body orders it; the blocks summed in f32."""
    data, scales = _layer_view(w, layer)
    M, K = x2.shape
    nb = K // BLOCK_SIZE
    xq, sx = quantize_x(x2)
    wv = int_values(data, w.kind).reshape(nb, BLOCK_SIZE, -1)
    idot = torch.matmul(xq.double().reshape(M, nb, BLOCK_SIZE).transpose(0, 1),
                        wv)  # [nb, M, N], exact
    return ((idot.float() * sx.t()[..., None])
            * scales.float()[:, None, :]).sum(dim=0)


def dot_ref(x2: torch.Tensor, w: QTensor, layer=None,
            aq8: bool = False) -> torch.Tensor:
    """x2 [M, K] @ dequant(w) -> f32 [M, N], the arithmetic of every
    kernel's dot, for every kind. M <= 8 multiplies by the f32-dequantized
    weight (int x fp16 is exact in f32, as a post-dot scaling is), or with
    `aq8` takes integer block dots of the int8-quantized x; larger M first
    rounds the dequantized weight to x2.dtype, as K2 and the TPU's
    tile-dequant bodies do (aq8 ignored). f32 accumulation either way,
    with TF32 off."""
    if aq8:
        check_aq8(w)
        if x2.shape[0] <= SMALL_M:
            return _aq8_dot(x2, w, layer)
    data, scales = _layer_view(w, layer)
    wd = dequantize(QTensor(data, scales, w.kind, w.layout), torch.float32)
    if x2.shape[0] > SMALL_M:
        wd = wd.to(x2.dtype).float()
    with exact_f32():
        return x2.float() @ wd


def qmatmul_ref(x: torch.Tensor, w: QTensor, out_dtype=None,
                layer=None, aq8: bool = False) -> torch.Tensor:
    """Plain version of both kernels, any device (see ``dot_ref``)."""
    *lead, K = x.shape
    out = dot_ref(x.reshape(-1, K), w, layer, aq8)
    return out.to(out_dtype or x.dtype).reshape(*lead, out.shape[-1])


def check_weight(w: QTensor, K: int, layer, device) -> None:
    """What every kernel takes as its weight: a kn QTensor of K rows on
    `device` (q8: int8 [.., K, N]; q4, q4g: uint8 [.., K/2, N]; float16
    scales [.., K/bs, N], K a multiple of bs), layer-stacked exactly when
    `layer` (a one-element int32 tensor on `device`) is given."""
    if w.kind not in KIND_CODE or w.layout != "kn":
        raise ValueError(f"the CUDA kernels take q8, q4 or q4g kn weights, "
                         f"got {w.kind}/{w.layout}")
    if w.data.dtype != DATA_DTYPE[w.kind] or w.scales.dtype != torch.float16:
        raise TypeError(f"{w.kind} weights are {DATA_DTYPE[w.kind]} data with "
                        "float16 scales")
    stacked = w.data.dim() == 3
    if w.data.dim() not in (2, 3) or stacked != (layer is not None):
        raise ValueError("pass `layer` exactly when the weight is layer-stacked")
    rows, N = w.data.shape[-2:]
    bs = block_size(w.kind)
    Kw = rows if w.kind == "q8" else 2 * rows
    if K != Kw or K % bs:
        raise ValueError(f"x has K={K}, weight K={Kw} (needs K % {bs} == 0)")
    if w.scales.shape != (*w.data.shape[:-2], K // bs, N):
        raise ValueError(f"scales {tuple(w.scales.shape)} do not match data")
    for t in (w.data, w.scales):
        if not t.is_cuda or t.device != device:
            raise ValueError("x and the weight must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take contiguous tensors on "
                             "16-byte boundaries (vector loads)")
    if stacked and not (torch.is_tensor(layer) and layer.is_cuda
                        and layer.dtype == torch.int32 and layer.numel() == 1
                        and layer.device == device):
        raise ValueError("`layer` must be a one-element int32 CUDA tensor")


def _check(x2: torch.Tensor, w: QTensor, layer, out_dtype) -> None:
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA qmatmul takes bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    check_weight(w, x2.shape[1], layer, x2.device)
    K, N = x2.shape[1], w.data.shape[-1]
    if x2.shape[0] <= SMALL_M and N % 4:
        raise ValueError(f"the decode kernel takes 4-column groups: N % 4 != 0 ({N})")
    if x2.shape[0] <= SMALL_M and K > SMALLM_MAX_K:
        raise ValueError(f"K = {K} is past the decode kernel's {SMALLM_MAX_K} rows")
    if x2.shape[0] > SMALL_M and K % (2 * BLOCK_SIZE):
        raise ValueError(f"the prefill kernel steps 64 rows of K: K={K}")
    if not x2.is_cuda or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("the CUDA qmatmul takes contiguous CUDA tensors on "
                         "16-byte boundaries (vector loads)")


def qmatmul(x: torch.Tensor, w: QTensor, out_dtype=None,
            layer: torch.Tensor | None = None, aq8: bool = False) -> torch.Tensor:
    """x [..., K] @ dequant(w) -> [..., N] in out_dtype (default x.dtype).

    `w` is a "kn" QTensor (q8, q4 or q4g), layer-stacked iff `layer` is
    given; on CUDA `layer` is a one-element int32 device tensor. `aq8`
    quantizes x to int8 per 32-block inside K1 (M <= 8; q8 and q4)."""
    if aq8:
        check_aq8(w)
    if not x.is_cuda:
        return qmatmul_ref(x, w, out_dtype, layer, aq8=aq8)
    out_dtype = out_dtype or x.dtype
    *lead, K = x.shape
    x2 = x.reshape(-1, K)
    _check(x2, w, layer, out_dtype)
    M, N = x2.shape[0], w.data.shape[-1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    name = "qmm_bigm" if M > SMALL_M else "qmm_smallm_aq8" if aq8 else "qmm_smallm"
    fn = getattr(_lib(), name)
    li = None if layer is None else layer.data_ptr()
    ptrs = (x2.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(), li,
            out.data_ptr())
    code = KIND_CODE[w.kind]
    ints = (int(out_dtype == torch.float32), code, M, K, N)
    if M > SMALL_M:
        err = fn(*ptrs, *ints, bigm_splits(M, N, K, sm_count(x.device)),
                 build.stream_ptr(x))
    else:
        err = fn(*ptrs, *ints, *smallm_plan(code, M, K, N, aq8, sm_count(x.device)),
                 build.stream_ptr(x))
    build.check(err, name)
    count(launches, name)
    return out.reshape(*lead, N)
