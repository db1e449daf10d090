"""The q4 small-M variant sweep of the kernel microbench.

Replaces ``body`` (25 variants) and ``run_manual`` of ``bench_sweep`` in
tools/kbench.py (``pallas_call`` at lines 1421, 1469 and 1485) with a
hand-written Hopper kernel (csrc/kbench_sweep.cu): x bf16 [M, K] (M <= 8)
times JAX's planar q4 weight, int8 data [K/2, N] (byte row 32g + j holds
K-row 64g + j in its high nibble and 64g + 32 + j in its low one), with
f32 "scales" [K/32, N], into f32 [M, N].

Each variant is what its TPU body computes, tile by tile: the body runs
once a (bn, bk) grid step and its output sums the steps, so ``stream``
(the first 8 byte rows and the first scale row of each step), ``overlap``
(x's first 16 blocks of 32 each step), ``dotsraw`` (the first half of
each step's x window) and ``unpackonly`` (8-row slabs, M = 8) depend on
bk, and the kernel and its plain version take (bn, bk) as the JAX tool
does (``pick_bn`` / ``pick_bk`` are the port's copies of its picks).
Variants that only reschedule ``cur`` (``i8shift``, ``i16shift``,
``ilp4``, ``tree``, ``fullunpack``, ``dq``, ``corrdot``, ``manual``)
compute ``cur``'s function; the others are the JAX tool's cost
ablations, wrong values by design. Flags, suffixed as in JAX: ``-t`` the
pre-tiled weight ``[N/bn, K/2, bn]`` (scales ``[N/bn, K/32, bn]``), ``-x``
x staged whole once a block, ``-v`` the kernel's dynamic shared-memory
limit raised to the card's most (without it a launch that needs more than
48 KB is refused, as JAX's default VMEM limit refuses).

The wrapper launches the kernel for CUDA tensors and raises on what it
does not take; CPU tensors take the plain version ``sweep_ref``. Launches
count under ``"kbench_sweep_<variant>"`` (flags apart).
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.precision import exact_f32

BLOCK_SIZE = 32
KN_GROUP = 64
Q4_OFFSET = 7
#: the JAX tool's VMEM budget for one weight-data tile
DATA_TILE_BYTES = 1024 * 1024
#: the body variants, in the order of the kernel's variant codes
VARIANTS = ("cur", "i8shift", "i16shift", "ilp4", "tree", "fullunpack", "dq",
            "corrdot", "corrdotnm", "dot3", "dotsraw", "unpackonly", "biasand",
            "nosum", "noand", "dotsonly", "g128", "g128d2", "g256",
            "g256presum", "g256dots", "g256fma1", "dqbias", "overlap", "stream")
#: the variants whose function is cur's
SAME_AS_CUR = ("cur", "i8shift", "i16shift", "ilp4", "tree", "fullunpack", "dq",
               "corrdot", "manual")
#: most rows M of x the kernel takes
MAX_M = 8
#: dynamic shared memory a launch may use without -v
DEFAULT_SMEM = 48 * 1024

launches = {f"kbench_sweep_{v}": 0 for v in VARIANTS + ("manual",)}

_P = ctypes.c_void_p
_I = ctypes.c_int


def parse_variant(name: str) -> tuple[str, bool, bool, bool]:
    """"cur-t-x" -> ("cur", tiled, xfull, vmem): the JAX tool's suffixes,
    in any order. Raises ValueError on a name the JAX tool lacks."""
    base, tiled, xfull, vmem = name, False, False, False
    while base[-2:] in ("-t", "-x", "-v"):
        flag, base = base[-1], base[:-2]
        tiled |= flag == "t"
        xfull |= flag == "x"
        vmem |= flag == "v"
    if base not in VARIANTS + ("manual",):
        raise ValueError(f"unknown sweep variant {name!r}; the JAX tool's are "
                         f"{', '.join(VARIANTS + ('manual',))}")
    return base, tiled, xfull, vmem


def pick_bn(N: int) -> int:
    """The port's copy of the JAX matmul's ``_pick_bn``: the largest
    128-multiple <= 2048 dividing N, else 2048-wide ragged tiles."""
    if N >= 2048 and N % 2048 == 0:
        return 2048
    for bn in range(2048, 383, -128):
        if N % bn == 0:
            return bn
    return min(2048, (N + 127) // 128 * 128)


def pick_bk(K: int, bn: int) -> int:
    """The port's copy of ``_pick_bk`` for q4: the largest multiple of 256
    dividing K whose packed tile (bk/2 rows of bn bytes) fits 1 MiB, else
    the whole K."""
    best = 0
    for bk in range(256, K + 1, 256):
        if K % bk == 0 and (bk // 2) * bn <= DATA_TILE_BYTES:
            best = bk
    if not best:
        if K % KN_GROUP == 0 and (K // 2) * bn <= DATA_TILE_BYTES:
            return K
        raise ValueError(f"K={K} not tileable (needs K % {KN_GROUP} == 0)")
    return best


def pack_planar(vals: torch.Tensor, xor: bool = False) -> torch.Tensor:
    """Offset-7 values [K, N] (0..14) -> JAX's planar q4 bytes, int8
    [K/2, N]: byte row 32g + j = v[64g + j] << 4 | v[64g + 32 + j], XOR
    0x80 with `xor` (JAX's biased-hi storage, which ``biasand`` and
    ``dqbias`` decode)."""
    K, N = vals.shape
    if K % KN_GROUP:
        raise ValueError(f"K={K} is not a multiple of {KN_GROUP}")
    g = vals.to(torch.int32).contiguous().reshape(K // KN_GROUP, KN_GROUP, N)
    half = KN_GROUP // 2
    packed = ((g[:, :half] << 4) | (g[:, half:] & 0x0F)) ^ (0x80 if xor else 0)
    return packed.reshape(K // 2, N).to(torch.uint8).contiguous().view(torch.int8)


def untile(t: torch.Tensor) -> torch.Tensor:
    """The pre-tiled [N/bn, R, bn] layout back to [R, N]."""
    gn, R, bn = t.shape
    return t.permute(1, 0, 2).reshape(R, gn * bn)


def tile(t: torch.Tensor, bn: int) -> torch.Tensor:
    """[R, N] -> the pre-tiled [N/bn, R, bn] layout of ``-t`` (N % bn == 0)."""
    R, N = t.shape
    if N % bn:
        raise ValueError(f"-t needs N % bn == 0 (N={N}, bn={bn})")
    return t.reshape(R, N // bn, bn).permute(1, 0, 2).contiguous()


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with exact_f32():
        return torch.matmul(a, b.float())


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _step_ref(v: str, xs: torch.Tensor, rows: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """One grid step of body variant `v`: xs f32 [M, bk] (bf16 values),
    rows int32 [bk/2, N] (the signed bytes), s f32 [bk/32, N] -> the f32
    [M, N] the step adds to the output."""
    M, bk = xs.shape
    N = rows.shape[1]
    if v == "stream":
        return (rows[:8].float().sum(0, keepdim=True) + s[:1]
                + _bf16(xs.sum(1, keepdim=True)))
    if v == "overlap":
        if bk < 512:
            raise ValueError("overlap reads 16 blocks of 32 of x a step: bk >= 512")
        xb = xs[:, :512].reshape(M, 16, 32)
        part = (xb * xs[:1, :512].reshape(1, 16, 32)).sum(-1).sum(-1, keepdim=True)
        return part + rows[:1].float()
    if v in ("dq", "dqbias"):
        if bk % KN_GROUP:
            raise ValueError(f"{v} reshapes the tile by {KN_GROUP}: bk={bk}")
        G = bk // KN_GROUP
        g8 = rows.reshape(G, KN_GROUP // 2, N)
        if v == "dq":
            vals = torch.cat([(g8 >> 4) & 0x0F, g8 & 0x0F], 1).float() - Q4_OFFSET
            wd = vals.reshape(bk // BLOCK_SIZE, BLOCK_SIZE, N) * s[:, None, :]
        else:
            s2 = s.reshape(G, 2, N)
            s_hi, s_lo = s2[:, 0:1], s2[:, 1:2]
            hi = (g8 & -16).float() * (s_hi * (1.0 / 16.0)) + s_hi
            lo = (g8 & 0x0F).float() * s_lo - 7.0 * s_lo
            wd = torch.cat([hi, lo], 1)
        return _bmm(xs, _bf16(wd.reshape(bk, N)))
    if v == "dotsraw":  # 32 byte rows a block, against x's first bk/2 columns
        G = rows.shape[0] // BLOCK_SIZE
        rb = rows[:G * BLOCK_SIZE].reshape(G, BLOCK_SIZE, N)
        xb = xs[:, :G * BLOCK_SIZE].reshape(M, G, BLOCK_SIZE).transpose(0, 1)
        return (_bmm(xb, rb) * s[:G, None, :]).sum(0)
    if v.startswith("g128") or v.startswith("g256"):
        W = 128 if v.startswith("g128") else 256  # K-rows a group
        G = bk // W
        r3 = rows[:G * W // 2].reshape(G, W // 2, N)
        hi16, lo = r3 & -16, r3 & 0x0F
        xw = xs[:, :G * W].reshape(M, G, W).transpose(0, 1)  # [G, M, W]
        xh, xl = xw[..., :W // 2], xw[..., W // 2:]
        sumh, suml = xh.sum(-1, keepdim=True), xl.sum(-1, keepdim=True)
        if v == "g128":
            xg = torch.cat([_bf16(xh * 0.0625), xl], -1)
            pg = _bmm(xg, torch.cat([hi16, lo], 1))
            return ((pg + sumh - 7.0 * suml) * s[0:2 * G:2, None]).sum(0)
        ph, pl = _bmm(xh, hi16), _bmm(xl, lo)
        if v == "g128d2":
            s16 = s * (1.0 / 16.0)
            return (ph * s16[0:2 * G:2, None]
                    + (pl + sumh - 7.0 * suml) * s[0:2 * G:2, None]).sum(0)
        sa, sb = s[0:4 * G:4, None], s[2:4 * G:4, None]
        if v == "g256":
            return ((ph * (1.0 / 16.0) + sumh) * sa + (pl - 7.0 * suml) * sb).sum(0)
        if v == "g256presum":
            return ((ph * (1.0 / 16.0) + 1.0) * sa + (pl - 7.0) * sb).sum(0)
        if v == "g256dots":
            return (ph + pl).sum(0)
        return ((ph + pl + 1.0) * sa).sum(0)  # g256fma1
    # the 64-row groups of the rest: 32 byte rows, hi against x's first 32
    G = rows.shape[0] // (KN_GROUP // 2)
    rg = rows[:G * KN_GROUP // 2].reshape(G, KN_GROUP // 2, N)
    xw = xs[:, :G * KN_GROUP].reshape(M, G, KN_GROUP).transpose(0, 1)
    xh, xl = xw[..., :KN_GROUP // 2], xw[..., KN_GROUP // 2:]
    sumh, suml = xh.sum(-1, keepdim=True), xl.sum(-1, keepdim=True)
    sh, sl = s[0:2 * G:2, None], s[1:2 * G:2, None]
    if v == "unpackonly":
        if M != 8:
            raise ValueError("unpackonly sums 8-row slabs into the output: M = 8")
        both = ((rg >> 4) & 0x0F) + (rg & 0x0F)
        return both.reshape(G, 4, 8, N).sum((0, 1)).float()
    if v in ("corrdot", "corrdotnm"):
        hi = rg >> 4 if v == "corrdotnm" else (rg >> 4) & 0x0F
        acc = (_bmm(xh, hi) * sh + _bmm(xl, rg & 0x0F) * sl).sum(0)
        bsum = xs.reshape(M, bk // BLOCK_SIZE, BLOCK_SIZE).sum(-1) * float(Q4_OFFSET)
        return acc - _bmm(bsum, s)
    if v == "dot3":
        h = (rg >> 4) & 0x0F
        A, C, B = _bmm(xh, h), _bmm(xl, h), _bmm(xl, rg)
        return ((A - 7.0 * sumh) * sh + (B - 16.0 * C - 7.0 * suml) * sl).sum(0)
    if v in ("biasand", "nosum", "noand", "dotsonly"):
        hi16, lo = (rg, rg) if v == "noand" else (rg & -16, rg & 0x0F)
        if v in ("nosum", "dotsonly"):
            sumh = suml = 1.0
        ph, pl = _bmm(xh, hi16), _bmm(xl, lo)
        s16h = (s * (1.0 / 16.0))[0:2 * G:2, None]
        if v == "dotsonly":
            return (ph * s16h + pl * sl).sum(0)
        return (ph * s16h + sumh * sh + (pl - 7.0 * suml) * sl).sum(0)
    # cur and its reschedules (i8shift, i16shift, ilp4, tree, fullunpack)
    ph = _bmm(xh, (rg >> 4) & 0x0F) - float(Q4_OFFSET) * sumh
    pl = _bmm(xl, rg & 0x0F) - float(Q4_OFFSET) * suml
    return (ph * sh + pl * sl).sum(0)


def check_tiles(variant: str, M: int, K: int, N: int, bn: int, bk: int) -> None:
    """What every variant takes (the kernel and the plain version alike)."""
    base, tiled, _, _ = parse_variant(variant)
    if not 1 <= M <= MAX_M:
        raise ValueError(f"the sweep takes 1 <= M <= {MAX_M} rows, got {M}")
    if K % KN_GROUP or bk % KN_GROUP or K % bk:
        raise ValueError(f"needs K % bk == 0 and bk % {KN_GROUP} == 0 "
                         f"(K={K}, bk={bk})")
    if (tiled or base == "manual") and N % bn:
        raise ValueError(f"{variant} needs N % bn == 0 (N={N}, bn={bn}), as "
                         "the JAX tool skips it")
    if base == "unpackonly" and M != 8:
        raise ValueError("unpackonly sums 8-row slabs into the output: M = 8")
    if base == "overlap" and bk < 512:
        raise ValueError("overlap reads 16 blocks of 32 of x a step: bk >= 512")


def sweep_ref(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
              variant: str, bn: int, bk: int) -> torch.Tensor:
    """Plain version: what the TPU body of `variant` computes, step by
    step over the K tiles of bk (bn changes no value: each column is its
    own). x bf16 [M, K]; data int8 [K/2, N] and scales f32 [K/32, N], or
    with ``-t`` their pre-tiled [N/bn, .., bn] forms. Returns f32 [M, N]."""
    base, tiled, _, _ = parse_variant(variant)
    if tiled:
        data, scales = untile(data), untile(scales)
    M, K = x.shape
    N = data.shape[1]
    check_tiles(variant, M, K, N, bn, bk)
    xf = x.float()
    rows = data.to(torch.int32)
    s = scales.float()
    body = "cur" if base == "manual" else base
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, bk):
        out += _step_ref(body, xf[:, k0:k0 + bk], rows[k0 // 2:(k0 + bk) // 2],
                         s[k0 // BLOCK_SIZE:(k0 + bk) // BLOCK_SIZE])
    return out


def smem_bytes(variant: str, M: int, K: int, bk: int) -> int:
    """Dynamic shared memory of a launch: x staged as bf16 (a bk window,
    or all of K with -x or manual) with its 32-block sums in f32, and for
    manual the two-stage ring of (bk/2 x 32) data bytes and (bk/32 x 32)
    scales. Kept in step with csrc/kbench_sweep.cu."""
    base, _, xfull, _ = parse_variant(variant)
    W = K if xfull or base == "manual" else bk
    total = M * W * 2 + M * (W // BLOCK_SIZE) * 4
    if base == "manual":
        total += 2 * ((bk // 2) * 32 + (bk // BLOCK_SIZE) * 32 * 4)
    return (total + 15) // 16 * 16


def _lib() -> ctypes.CDLL:
    lib = build.load("kbench_sweep")
    if lib.kbench_sweep.argtypes is None:
        lib.kbench_sweep.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _P]
        lib.kbench_sweep.restype = _I
    return lib


def sweep(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
          variant: str, bn: int, bk: int) -> torch.Tensor:
    """x [M, K] times the planar q4 weight by body `variant` over (bn, bk)
    tiles -> f32 [M, N]; see ``sweep_ref`` for the operands."""
    base, tiled, xfull, vmem = parse_variant(variant)
    if not x.is_cuda:
        return sweep_ref(x, data, scales, variant, bn, bk)
    M, K = x.shape
    if tiled:
        gn, rows, tbn = data.shape
        N = gn * tbn
        if tbn != bn or rows != K // 2 or scales.shape != (gn, K // BLOCK_SIZE, bn):
            raise ValueError("-t takes data [N/bn, K/2, bn] and scales "
                             "[N/bn, K/32, bn]")
    else:
        N = data.shape[-1]
        if data.shape != (K // 2, N) or scales.shape != (K // BLOCK_SIZE, N):
            raise ValueError(f"data {tuple(data.shape)} / scales "
                             f"{tuple(scales.shape)} do not fit x {tuple(x.shape)}")
    check_tiles(variant, M, K, N, bn, bk)
    if x.dtype != torch.bfloat16 or data.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError("the sweep takes bf16 x, int8 data and f32 scales")
    for t in (x, data, scales):
        if not t.is_cuda or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("the sweep takes contiguous tensors on one CUDA "
                             "device, on 16-byte boundaries")
    smem = smem_bytes(variant, M, K, bk)
    if smem > DEFAULT_SMEM and not (vmem or base == "manual"):
        raise ValueError(f"{variant} needs {smem} B of shared memory, over the "
                         f"default {DEFAULT_SMEM}: add -v")
    if base == "manual" and N % 16:
        raise ValueError("manual copies 16-byte runs of a row: N % 16 == 0")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    code = VARIANTS.index(base) if base != "manual" else len(VARIANTS)
    err = _lib().kbench_sweep(x.data_ptr(), data.data_ptr(), scales.data_ptr(),
                              out.data_ptr(), code, M, K, N, bn, bk, int(tiled),
                              int(xfull), int(vmem), smem, build.stream_ptr(x))
    build.check(err, f"kbench_sweep {variant}")
    launches[f"kbench_sweep_{base}"] += 1
    return out
