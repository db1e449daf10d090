"""The native-int4 small-M matmul of the kernel microbench.

Replaces ``kernel`` of ``bench_i4`` in tools/kbench.py (``pallas_call`` at
line 653) with a hand-written Hopper kernel (csrc/kbench_i4.cu): x bf16
[M, K] (M <= 8) times signed int4 weights [-7, 7] [K, N] with f32 scales
a 32-row block [K/32, N], into f32 [M, N]. The port has no int4 dtype:
the weight is ``pack_nibbles``'s bytes, uint8 [K, N/2], the low nibble of
byte j holding column 2j and the high nibble column 2j + 1 (N even; the
JAX tool pads lm_head's 32,003 columns to 32,004).

Two bodies, as in JAX:

* ``blockdot``: each 32-row block's dot of x with the integer values in
  f32, then scaled by the block's scale and summed;
* ``tiledeq``: the weight dequantized first, w * s rounded to bf16, then
  one dot.

The wrapper launches the kernel for CUDA tensors and raises on what it
does not take; CPU tensors take the plain version ``i4_ref``. Launches
count under ``"kbench_i4_<body>"``.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.precision import exact_f32

BODIES = ("blockdot", "tiledeq")
BLOCK_SIZE = 32
MAX_M = 8

launches = {f"kbench_i4_{b}": 0 for b in BODIES}

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_body(body: str) -> None:
    if body not in BODIES:
        raise ValueError(f"unknown i4 body {body!r}; the JAX tool's are "
                         f"{', '.join(BODIES)}")


def pack_nibbles(vals: torch.Tensor) -> torch.Tensor:
    """The port's copy of the JAX tool's ``pack_nibbles``: int [K, N] in
    [-8, 7], N even -> uint8 [K, N/2], the low nibble column 2j, the high
    one 2j + 1 (two's complement nibbles)."""
    if vals.shape[-1] % 2:
        raise ValueError(f"nibble pairs pack along N: N={vals.shape[-1]} is odd")
    v = vals.to(torch.int32)
    return (((v[..., 1::2] & 0xF) << 4) | (v[..., 0::2] & 0xF)).to(torch.uint8).contiguous()


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_nibbles``: uint8 [K, N/2] -> int8 [K, N], each
    nibble sign-extended."""
    b = packed.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1).to(torch.int8)


def i4_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
           body: str) -> torch.Tensor:
    """Plain version: x bf16 [M, K], packed uint8 [K, N/2], scales f32
    [K/32, N] -> f32 [M, N]."""
    check_body(body)
    M, K = x.shape
    w = unpack_nibbles(packed).float()
    N = w.shape[1]
    s = scales.float()
    xf = x.float()
    with exact_f32():
        if body == "tiledeq":
            wd = (w.reshape(K // BLOCK_SIZE, BLOCK_SIZE, N) * s[:, None, :])
            return xf @ wd.reshape(K, N).to(torch.bfloat16).float()
        xb = xf.reshape(M, K // BLOCK_SIZE, BLOCK_SIZE).transpose(0, 1)
        part = torch.matmul(xb, w.reshape(K // BLOCK_SIZE, BLOCK_SIZE, N))
        return (part * s[:, None, :]).sum(0)


def _lib() -> ctypes.CDLL:
    lib = build.load("kbench_i4")
    if lib.kbench_i4.argtypes is None:
        lib.kbench_i4.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.kbench_i4.restype = _I
    return lib


def i4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              body: str) -> torch.Tensor:
    """x [M, K] @ (int4 w * s) by `body` -> f32 [M, N]; see ``i4_ref``."""
    check_body(body)
    if not x.is_cuda:
        return i4_ref(x, packed, scales, body)
    M, K = x.shape
    N = 2 * packed.shape[-1]
    if not 1 <= M <= MAX_M or K % 256 or packed.shape != (K, N // 2) \
            or scales.shape != (K // BLOCK_SIZE, N):
        raise ValueError(f"i4 takes x [M <= {MAX_M}, K % 256 == 0], packed "
                         "[K, N/2] and scales [K/32, N]")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.uint8 \
            or scales.dtype != torch.float32:
        raise TypeError("i4 takes bf16 x, uint8 packed nibbles, f32 scales")
    for t in (x, packed, scales):
        if not t.is_cuda or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("i4 takes contiguous tensors on one CUDA device, "
                             "on 16-byte boundaries")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = _lib().kbench_i4(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                           out.data_ptr(), BODIES.index(body), M, K, N,
                           build.stream_ptr(x))
    build.check(err, f"kbench_i4 {body}")
    launches[f"kbench_i4_{body}"] += 1
    return out
