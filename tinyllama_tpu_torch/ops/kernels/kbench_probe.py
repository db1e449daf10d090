"""The feature probes of the kernel microbench.

Replaces the four Pallas probes of ``bench_probe`` in tools/kbench.py
(``pallas_call`` at lines 148, 179, 202 and 225) with four tiny
hand-written Hopper kernels (csrc/kbench_probe.cu):

* ``int4`` (``k4``): packed signed nibbles -> bf16 2 * v. The port has no
  int4 dtype: its operand is ``pack_nibbles``'s bytes, uint8 [R, C/2].
* ``bitcast`` (``kb``): each column's four consecutive bytes as one
  little-endian int32, & 0xF, as bf16: int8 [4R, C] -> bf16 [R, C]. The
  JAX probe meant this and cannot trace it (its bitcast result is 2-D
  and the body then swaps axes 1 and 2).
* ``i32dot`` (``ki``): int8 operands widened to int32, an int32 dot by
  scalar multiply-adds (Hopper has no int32 tensor-core product), as f32.
* ``i8dot`` (``k8``): int8 x int8 -> int32 on the tensor cores
  (``mma.sync.m16n8k32.s8``), as f32.

Each wrapper launches its kernel for CUDA tensors and raises on what it
does not take; CPU tensors take the plain version. Launches count under
``"kbench_probe_<name>"``.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.kernels.kbench_i4 import unpack_nibbles

PROBES = ("int4", "bitcast", "i32dot", "i8dot")

launches = {f"kbench_probe_{p}": 0 for p in PROBES}

_P = ctypes.c_void_p
_I = ctypes.c_int


def int4_ref(packed: torch.Tensor) -> torch.Tensor:
    return (unpack_nibbles(packed).float() * 2.0).to(torch.bfloat16)


def bitcast_ref(w: torch.Tensor) -> torch.Tensor:
    R4, C = w.shape
    b = w.view(torch.uint8).to(torch.int64).reshape(R4 // 4, 4, C)
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return (word & 0xF).to(torch.bfloat16)


def dot_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact integer dot of int8 operands, as f32 (both integer
    probes): taken in f64, exact while K * 128^2 < 2^53 (CUDA has no
    int64 matmul)."""
    return (x.double() @ w.double()).float()


def _lib() -> ctypes.CDLL:
    lib = build.load("kbench_probe")
    if lib.kbench_probe.argtypes is None:
        lib.kbench_probe.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.kbench_probe.restype = _I
    return lib


def _launch(name: str, out: torch.Tensor, a: torch.Tensor, b, rows: int,
            cols: int, depth: int) -> torch.Tensor:
    for t in (a, b) if b is not None else (a,):
        if not t.is_cuda or t.device != out.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"probe {name} takes contiguous tensors on one "
                             "CUDA device, on 16-byte boundaries")
    err = _lib().kbench_probe(a.data_ptr(), 0 if b is None else b.data_ptr(),
                              out.data_ptr(), PROBES.index(name), rows, cols,
                              depth, build.stream_ptr(a))
    build.check(err, f"kbench_probe {name}")
    launches[f"kbench_probe_{name}"] += 1
    return out


def int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [R, C/2] packed nibbles -> bf16 [R, C] = 2 * v."""
    if not packed.is_cuda:
        return int4_ref(packed)
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] % 8:
        raise ValueError("int4 takes uint8 [R, C/2] with C/2 % 8 == 0")
    R, C2 = packed.shape
    out = torch.empty((R, 2 * C2), dtype=torch.bfloat16, device=packed.device)
    return _launch("int4", out, packed, None, R, 2 * C2, 0)


def bitcast(w: torch.Tensor) -> torch.Tensor:
    """int8 [4R, C] -> bf16 [R, C]: each column's 4 bytes as an int32, & 0xF."""
    if not w.is_cuda:
        return bitcast_ref(w)
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] % 4:
        raise ValueError("bitcast takes int8 [4R, C]")
    R4, C = w.shape
    out = torch.empty((R4 // 4, C), dtype=torch.bfloat16, device=w.device)
    return _launch("bitcast", out, w, None, R4 // 4, C, 0)


def _dot(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return dot_ref(x, w)
    M, K = x.shape
    if x.dtype != torch.int8 or w.dtype != torch.int8 or w.shape[0] != K \
            or w.dim() != 2:
        raise ValueError(f"{name} takes int8 x [M, K] and w [K, N]")
    N = w.shape[1]
    if name == "i8dot" and (M > 16 or K % 32 or N % 8):
        raise ValueError("i8dot runs m16n8k32 tiles: M <= 16, K % 32 == 0, "
                         "N % 8 == 0")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    return _launch(name, out, x, w, M, N, K)


def i32dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] . int8 [K, N] -> f32 [M, N] by int32 multiply-adds."""
    return _dot("i32dot", x, w)


def i8dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] . int8 [K, N] -> f32 [M, N] on the int8 tensor cores."""
    return _dot("i8dot", x, w)
