"""The flash-attention ablations of the kernel microbench.

Replaces ``body``, ``body_flip`` and ``body_flip_pre`` of ``bench_flash``
in tools/kbench.py (``pallas_call`` at lines 495 and 559) with a
hand-written Hopper kernel (csrc/kbench_flash.cu): causal grouped-query
attention of q bf16 [B, Kh, T*G, d] (a token's G = 8 query heads
flattened into rows, row r at position pos + r // G) over int8 K/V
[B, Kh, S, d] with per-key f32 scales [B, Kh, S], d = 64, into f32
[B, Kh, T*G, d], or [B, Kh, d, T*G] for the ``flipT*`` variants.

Each variant computes what its TPU body computes, over the TPU tool's
tiles (``BTG`` = 512 query rows, ``BS`` = 512 keys): a query tile visits
the key tiles s with s * BS <= its last row's position, the running max
moves once a key tile, and unvisited tiles are neither read nor counted.
So the ablations, which drop one cost each and are wrong by design,
give the TPU's wrong values:

* ``full``: scores (q . k) / 8 * ks, the causal mask (-0.7 FLT_MAX), the
  online max and sum, p * vs rounded to bf16 for the PV product,
  out = acc / max(l, 1);
* ``noexp`` p = (s - m) / 2 (alpha still exp); ``nomask`` no mask (keys
  of visited tiles past the diagonal count); ``nomax`` m = 0;
  ``nosum`` l = 0; ``dots`` the two products only (scores, unmasked, to
  bf16 times V); ``stream`` reads every visited tile and writes 0 (the
  final acc / max(l, 1) of an untouched accumulator);
* ``flipT`` / ``flipTtr`` / ``flipTpre`` compute ``full``'s function with
  the scales folded into K and V before the products: ``flipT`` rounds
  ks and vs to bf16 first, then k * ks to bf16; ``flipTtr`` and
  ``flipTpre`` (scales interleaved [B, Kh, S, 2]) round k * ks once;
  ``flipTnoscale`` drops the scales. Their output is transposed.

``noexp`` overflows by design: the masked -0.7 FLT_MAX halves into
p * vs products past f32's range, so most of its rows end inf or NaN;
where the products cancel, whether a sum leaves f32's range depends on
its order (``noexp_determinate`` says where it does not).

The wrapper launches the kernel for CUDA tensors and raises on what it
does not take; CPU tensors take the plain version ``flash_ref``. Launches
count under ``"kbench_flash_<variant>"``.
"""

from __future__ import annotations

import ctypes

import torch

from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.ops.precision import exact_f32

VARIANTS = ("full", "noexp", "nomask", "nomax", "nosum", "dots", "stream",
            "flipT", "flipTtr", "flipTnoscale", "flipTpre")
#: the variants whose function is full's (the flips transpose the output)
SAME_AS_FULL = ("full", "flipT", "flipTtr", "flipTpre")
G = 8          # query heads a kv head
D = 64         # head dim
BTG = 512      # query rows a TPU tile
BS = 512       # keys a TPU tile
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

launches = {f"kbench_flash_{v}": 0 for v in VARIANTS}

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r}; the JAX tool's "
                         f"are {', '.join(VARIANTS)}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with exact_f32():
        return torch.matmul(a, b)


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ks: torch.Tensor, vs: torch.Tensor | None, pos: torch.Tensor,
              variant: str) -> torch.Tensor:
    """Plain version over the TPU tiles. For ``flipTpre`` `ks` holds the
    interleaved [B, Kh, S, 2] scales and `vs` is None."""
    check_variant(variant)
    B, Kh, TG, d = q.shape
    S = k.shape[2]
    check_shapes(TG, S, d)
    if variant == "flipTpre":
        ks, vs = ks[..., 0], ks[..., 1]
    qf, kf, vf = q.float(), k.float(), v.float()
    ksf, vsf = ks.float()[:, :, None, :], vs.float()[:, :, None, :]  # [B,Kh,1,S]
    rows = torch.arange(TG, device=q.device)
    p0 = pos.to(q.device).long().reshape(B, 1)
    t_abs = p0 + rows // G                                   # [B, TG]
    t_max = p0 + ((rows // BTG) * BTG + BTG - 1) // G        # [B, TG]
    flip = variant.startswith("flipT")
    if flip and variant != "flipTnoscale":
        kss = ksf.transpose(2, 3)  # [B, Kh, S, 1]
        vss = vsf.transpose(2, 3)
        if variant == "flipT":
            kss, vss = _bf16(kss), _bf16(vss)
        kf, vf = _bf16(kf * kss), _bf16(vf * vss)
    acc = torch.zeros((B, Kh, TG, d), dtype=torch.float32, device=q.device)
    m = torch.full((B, Kh, TG, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Kh, TG, 1), device=q.device)
    if variant == "stream":
        return acc if not flip else acc.transpose(2, 3).contiguous()
    for s0 in range(0, S, BS):
        seen = (s0 <= t_max)[:, None, :, None]               # [B, 1, TG, 1]
        sc = _mm(qf, kf[:, :, s0:s0 + BS].transpose(2, 3)) * (1.0 / (d ** 0.5))
        if not flip:
            sc = sc * ksf[..., s0:s0 + BS]
        if variant == "dots":
            acc = torch.where(seen, acc + _mm(_bf16(sc), vf[:, :, s0:s0 + BS]), acc)
            continue
        if variant != "nomask":
            keys = s0 + torch.arange(BS, device=q.device)
            ok = keys[None, None, None, :] <= t_abs[:, None, :, None]
            sc = torch.where(ok, sc, NEG_INF)
        if variant == "nomax":
            m_new, alpha = torch.zeros_like(m), torch.ones_like(m)
        else:
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
        p = (sc - m_new) * 0.5 if variant == "noexp" else torch.exp(sc - m_new)
        l_new = l if variant == "nosum" else l * alpha + p.sum(-1, keepdim=True)
        if not flip:
            p = p * vsf[..., s0:s0 + BS]
        a_new = acc * alpha + _mm(_bf16(p), vf[:, :, s0:s0 + BS])
        acc = torch.where(seen, a_new, acc)
        m = torch.where(seen, m_new, m)
        l = torch.where(seen, l_new, l)
    out = acc / torch.clamp(l, min=1.0)
    return out.transpose(2, 3).contiguous() if flip else out


def check_shapes(TG: int, S: int, d: int) -> None:
    if d != D or TG % BTG or S % BS:
        raise ValueError(f"the flash bench takes d = {D}, T*G a multiple of "
                         f"{BTG} and S a multiple of {BS} (T*G={TG}, S={S}, d={d})")


def noexp_determinate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ks: torch.Tensor, vs: torch.Tensor,
                      pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Where ``noexp``'s output is the same whatever the order of its f32
    sums: bool (finite, overflow) of the output's shape. Its output is acc
    itself (p <= 0, so l <= 0 and max(l, 1) = 1), the running sum of the
    terms bf16(p * vs) * v, rescaled by alpha each key tile. With those
    terms in f64: finite where the sum of their magnitudes, plus 2^-7 of
    it for a term's last bf16 bit, stays under f32's largest value, so no
    partial sum in any order leaves f32's range; overflow where the sum's
    magnitude, less that room, exceeds it. Between them (where the terms
    cancel) the order decides."""
    B, Kh, TG, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    ksf, vsf = ks.float()[:, :, None, :], vs.float()[:, :, None, :]
    rows = torch.arange(TG, device=q.device)
    p0 = pos.long().reshape(B, 1)
    t_abs = p0 + rows // G
    t_max = p0 + ((rows // BTG) * BTG + BTG - 1) // G
    m = torch.full((B, Kh, TG, 1), NEG_INF, device=q.device)
    acc = torch.zeros((B, Kh, TG, d), dtype=torch.float64, device=q.device)
    mag = torch.zeros_like(acc)
    for s0 in range(0, k.shape[2], BS):
        seen = (s0 <= t_max)[:, None, :, None]
        sc = (_mm(qf, kf[:, :, s0:s0 + BS].transpose(2, 3)) * (1.0 / (d ** 0.5))
              * ksf[..., s0:s0 + BS])
        keys = s0 + torch.arange(BS, device=q.device)
        sc = torch.where(keys[None, None, None, :] <= t_abs[:, None, :, None], sc,
                         NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new).double()
        pv = _bf16((sc - m_new) * 0.5 * vsf[..., s0:s0 + BS]).double()
        vt = vf[:, :, s0:s0 + BS].double()
        acc = torch.where(seen, acc * alpha + pv @ vt, acc)
        mag = torch.where(seen, mag * alpha + pv.abs() @ vt.abs(), mag)
        m = torch.where(seen, m_new, m)
    fmax, room = torch.finfo(torch.float32).max, mag * 2.0 ** -7
    return mag + room < fmax, acc.abs() - room > fmax


def _lib() -> ctypes.CDLL:
    lib = build.load("kbench_flash")
    if lib.kbench_flash.argtypes is None:
        lib.kbench_flash.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _P]
        lib.kbench_flash.restype = _I
    return lib


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ks: torch.Tensor,
          vs: torch.Tensor | None, pos: torch.Tensor,
          variant: str) -> torch.Tensor:
    """The ablation `variant` of the causal int8-KV attention; see
    ``flash_ref`` for the operands."""
    check_variant(variant)
    if not q.is_cuda:
        return flash_ref(q, k, v, ks, vs, pos, variant)
    B, Kh, TG, d = q.shape
    S = k.shape[2]
    check_shapes(TG, S, d)
    pre = variant == "flipTpre"
    want_s = (B, Kh, S, 2) if pre else (B, Kh, S)
    if k.shape != (B, Kh, S, d) or v.shape != k.shape or ks.shape != want_s \
            or (not pre and (vs is None or vs.shape != want_s)) \
            or (pre and vs is not None) or pos.shape != (B,):
        raise ValueError("flash takes q [B, Kh, TG, 64], k/v [B, Kh, S, 64], "
                         "scales [B, Kh, S] (flipTpre: one [B, Kh, S, 2]) and "
                         "pos [B]")
    if q.dtype != torch.bfloat16 or k.dtype != torch.int8 or v.dtype != torch.int8 \
            or ks.dtype != torch.float32 or pos.dtype != torch.int32 \
            or (vs is not None and vs.dtype != torch.float32):
        raise TypeError("flash takes bf16 q, int8 k/v, f32 scales, int32 pos")
    for t in (q, k, v, ks, pos) + ((vs,) if vs is not None else ()):
        if not t.is_cuda or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("flash takes contiguous tensors on one CUDA device, "
                             "on 16-byte boundaries")
    flip = variant.startswith("flipT")
    out = torch.empty((B, Kh, d, TG) if flip else (B, Kh, TG, d),
                      dtype=torch.float32, device=q.device)
    err = _lib().kbench_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              ks.data_ptr(), 0 if pre else vs.data_ptr(),
                              pos.data_ptr(), out.data_ptr(),
                              VARIANTS.index(variant), B, Kh, TG, S,
                              build.stream_ptr(q))
    build.check(err, f"kbench_flash {variant}")
    launches[f"kbench_flash_{variant}"] += 1
    return out
