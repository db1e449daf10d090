"""Kernel microbenchmark of the port: device time a call of each of the
microbench's kernels at TinyLlama-1.1B's shapes, beside its bound.

    python -m tinyllama_tpu_torch.tools.kbench --bench qmatmul --kind q4
    python -m tinyllama_tpu_torch.tools.kbench --bench probe
    python -m tinyllama_tpu_torch.tools.kbench --bench flash [--m 2048]
    python -m tinyllama_tpu_torch.tools.kbench --bench i4 [--shape wqkv]
    python -m tinyllama_tpu_torch.tools.kbench --bench sweep \\
        --variants cur,dq,manual,cur-t --bns 0 --bks 0,512

The counterpart of tools/kbench.py. ``qmatmul`` drives the port's K1/K2
(``ops/kernels/qmatmul.py``; ``--aq8`` its int8-activation branch) at M =
``--m`` on the five decode matmuls; ``probe``, ``flash``, ``i4`` and
``sweep`` drive the hand-written kernels of ``ops/kernels/kbench_*.py``.
Variant names are the JAX tool's (``--variants``; default all 11 for
flash, JAX's "stream,cur,i8shift,dq" for sweep); an unknown name raises.
Sweep tiles: ``--bns`` / ``--bks`` comma lists, 0 the JAX matmul's pick;
the sweep skips what the JAX tool skips (K % bk, a data tile over 4 MiB,
``-t`` and ``manual`` where N % bn).

Timing: ``--iters`` calls (at least one a copy, below) captured in one
CUDA graph and replayed, timed with CUDA events, so the time is the
device's. The card's L2 holds 50 MB, so the calls cycle over copies of
their operands until one replay moves more than twice that (3 copies for
an operand set of 41 MB and more): no call finds its operands in L2.
Each line prints µs a call, GB/s, the bound max(bytes / 3.35 TB/s,
operations / 989 TFLOP/s) with what binds it, and the time over the
bound, and the plain version's time; the card's name and power limit
print once. Each kernel is held against its plain version before it is
timed, and a disagreement raises. With ``--device cpu`` the plain
versions run and no time prints (the sweep then checks the
variants that compute cur's function against x @ dequant(w)). Without a
card and without ``--device cpu`` it raises. Operands come from a
``torch.Generator`` seeded by the shape's index.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections.abc import Callable
from dataclasses import dataclass, field

import torch

from tinyllama_tpu_torch.ops.kernels import kbench_flash as kf
from tinyllama_tpu_torch.ops.kernels import kbench_i4 as ki
from tinyllama_tpu_torch.ops.kernels import kbench_probe as kp
from tinyllama_tpu_torch.ops.kernels import kbench_sweep as ks
from tinyllama_tpu_torch.ops.kernels import qmatmul as qm
from tinyllama_tpu_torch.quant import codec
from tinyllama_tpu_torch.runtime.graphs import capturing

#: TinyLlama-1.1B decode matmul shapes (K, N)
SHAPES = {
    "wqkv": (2048, 2560),
    "wo": (2048, 2048),
    "w_gateup": (2048, 11264),
    "w_down": (5632, 2048),
    "lm_head": (2048, 32003),
}

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
#: bf16 tensor-core FLOP/s. bound = max(bytes / BW, operations / PEAK).
HBM_BW = 3.35e12
PEAK_BF16 = 989e12
#: the card's L2; a replay moves more than twice it
L2_BYTES = 50e6
#: operand sets this large cycle over 3 copies
BIG_OPERANDS = 41e6
#: kernel against plain version: bf16 kernels at the JAX suite's tolerance
#: (tests/test_tpu_kernels.py); f32 sums of large terms relative to the
#: output's largest
RTOL, ATOL = 2e-2, 5e-3
REL = 1e-4

SWEEP_DEFAULT = "stream,cur,i8shift,dq"


def time_ms(fn, reps: int, graph: bool) -> float:
    """Mean ms per call by CUDA events over `reps` calls, after warm-up;
    fn(i) gets the call index (to cycle operands past the 50 MB L2). With
    graph=True the calls are captured in one CUDA graph and replayed, so
    the time is the device's alone, free of Python dispatch; the plain
    versions read the layer index back to the host and run eagerly."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with capturing(g):
            for i in range(reps):
                fn(i)
        run = g.replay
        run()
    else:
        def run():
            for i in range(reps):
                fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return smi[torch.cuda.current_device()]


def copies_for(nbytes: int) -> int:
    """Operand copies so that one pass over them moves more than 2 x L2."""
    if nbytes >= BIG_OPERANDS:
        return 3
    return int(2 * L2_BYTES // nbytes) + 1


def compare(got: torch.Tensor, want: torch.Tensor, mode: str,
            determinate: tuple[torch.Tensor, torch.Tensor] | None = None
            ) -> tuple[bool, float]:
    """(agrees, max |got - want| over the entries compared). Modes:
    "exact"; "rel" (max error <= REL * max |want|); "bf16" (each entry
    within ATOL + RTOL |want|); "bf16-scaled" (ATOL times max |want|: the
    unnormalized ablations whose outputs reach 10^2-10^4); "overflow"
    (noexp: bf16 where both are finite; both finite, and both not, where
    `determinate` = (finite, overflow) says the order of the sums cannot
    change it)."""
    got, want = got.float(), want.float()
    if mode == "exact":
        ok = torch.equal(got, want)
        return ok, float((got - want).abs().max()) if ok else float("inf")
    fin = torch.isfinite(got) & torch.isfinite(want)
    if mode == "overflow":
        finite, overflow = determinate
        ok_fin = bool(fin[finite].all()) and not bool(
            (torch.isfinite(got) | torch.isfinite(want))[overflow].any())
    else:
        ok_fin = bool(fin.all())
    diff = torch.where(fin, (got - want).abs(), 0.0)
    err = float(diff.max())
    scale = float(torch.where(fin, want.abs(), 0.0).max())
    if mode == "rel":
        return ok_fin and err <= REL * scale, err
    atol = ATOL * max(scale, 1.0) if mode == "bf16-scaled" else ATOL
    ok = bool((diff <= atol + RTOL * torch.where(fin, want.abs(), 0.0)).all())
    return ok_fin and ok, err


def finite_mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of positions finite on one side and not on the other."""
    return float((torch.isfinite(got) != torch.isfinite(want)).float().mean())


@dataclass
class Case:
    """One kernel call of the bench: its label, launch counter, kernel and
    plain version over the operands `make(i)` (copy i), the bytes and
    operations its bound counts, how it is compared, and the PyTorch call
    that computes the same function (`library`, over `make_library(i)`)."""

    label: str
    counter: str
    kernel: Callable
    plain: Callable
    make: Callable[[int], tuple]
    nbytes: int
    flops: int
    mode: str
    library: Callable | None = None
    make_library: Callable[[int], tuple] | None = None
    library_note: str = ""
    #: noexp: (finite, overflow) where the order of the sums cannot change it
    determinate: Callable[[tuple], tuple] | None = None
    #: for port-made q4 operands: x @ dequant(w), bf16 weight, f32 out
    reference: Callable[[tuple], torch.Tensor] | None = None
    extra: dict = field(default_factory=dict)

    def bound_ms(self) -> tuple[float, str]:
        tb, to = self.nbytes / HBM_BW * 1e3, self.flops / PEAK_BF16 * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")


def check_case(case: Case) -> dict:
    """Hold the kernel against its plain version on copy 0 (one launch);
    raises on a disagreement. Returns the max |error| (and, for noexp,
    the share of positions whose finiteness differs)."""
    ops = case.make(0)
    got, want = case.kernel(*ops), case.plain(*ops)
    det = case.determinate(ops) if case.determinate else None
    ok, err = compare(got, want, case.mode, det)
    if not ok:
        raise AssertionError(f"{case.label}: kernel disagrees with its plain "
                             f"version ({case.mode}), max |err| {err}, finiteness "
                             f"differs at {finite_mismatch(got, want):.2%}")
    check = dict(max_abs_err=err)
    if case.mode == "overflow":
        check["finite_mismatch"] = finite_mismatch(got, want)
    return check


def time_case(case: Case, iters: int, library: bool = True) -> dict:
    """The kernel's (and the library call's) device ms a call over copies
    past the L2, and the bound."""
    n = copies_for(case.nbytes)
    reps = max(iters, n)
    # every output stays alive, so no call writes into the buffer its
    # predecessor wrote (and left in L2)
    sets, outs = [case.make(i) for i in range(n)], []
    ms = time_ms(lambda i: outs.append(case.kernel(*sets[i % n])), reps, True)
    del sets, outs
    lib_ms = None
    if library and case.library is not None:
        lsets, outs = [case.make_library(i) for i in range(n)], []
        lib_ms = time_ms(lambda i: outs.append(case.library(*lsets[i % n])), reps,
                         True)
        del lsets, outs
    bound, by = case.bound_ms()
    return dict(name=case.label, counter=case.counter, ms=ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, copies=n, mode=case.mode,
                library_note=case.library_note if case.library else "",
                **case.extra)


def time_plain(case: Case, reps: int = 3) -> float:
    ops = case.make(0)
    return time_ms(lambda i: case.plain(*ops), reps, False)


def print_row(r: dict, nbytes: int) -> None:
    us, bus = r["ms"] * 1e3, r["bound_ms"] * 1e3
    lib = (f"  library {r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
           else "")
    fin = (f", finiteness differs at {r['finite_mismatch']:.2%}"
           if "finite_mismatch" in r else "")
    print(f"{r['name']}: {us:9.2f} us/call {nbytes / (us * 1e-6) / 1e9:8.1f} GB/s"
          f"  bound {bus:7.3f} us ({r['bound_by']})  {us / bus:6.1f}x bound"
          f"{lib}  plain {r['plain_ms'] * 1e3:.1f} us  max |err| "
          f"{r['max_abs_err']:.3e} ({r['mode']}{fin})", flush=True)


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device)
    g.manual_seed(seed)
    return g


def _shapes(args) -> list[tuple[int, str, int, int]]:
    if args.shape and args.shape not in SHAPES:
        raise ValueError(f"unknown shape {args.shape!r}: {', '.join(SHAPES)}")
    return [(i, n, K, N) for i, (n, (K, N)) in enumerate(SHAPES.items())
            if not args.shape or n == args.shape]


# --------------------------------------------------------------------- cases --


def probe_cases(args, dev) -> list[Case]:
    g = _gen(dev, 0)
    vals = torch.randint(-8, 8, (256, 256), generator=g, device=dev)
    packed = ki.pack_nibbles(vals)
    w8 = torch.randint(-128, 128, (256, 256), generator=g, device=dev).to(torch.int8)
    x = torch.randint(-128, 128, (8, 512), generator=g, device=dev).to(torch.int8)
    w = torch.randint(-128, 128, (512, 256), generator=g, device=dev).to(torch.int8)
    dot_bytes = x.numel() + w.numel() + 8 * 256 * 4
    # torch._int_mm takes M > 16: x padded to 17 rows
    x17 = torch.zeros((17, 512), dtype=torch.int8, device=dev)
    x17[:8] = x
    return [
        Case("probe pallas-int4-ref", "kbench_probe_int4", kp.int4, kp.int4_ref,
             lambda i: (packed.clone(),), packed.numel() + 256 * 256 * 2, 0,
             "exact"),
        Case("probe pallas-bitcast-i8-i32", "kbench_probe_bitcast", kp.bitcast,
             kp.bitcast_ref, lambda i: (w8.clone(),), w8.numel() + 64 * 256 * 2, 0,
             "exact"),
        Case("probe pallas-i32-dot", "kbench_probe_i32dot", kp.i32dot, kp.dot_ref,
             lambda i: (x.clone(), w.clone()), dot_bytes, 2 * 8 * 512 * 256,
             "exact", library=torch._int_mm,
             make_library=lambda i: (x17.clone(), w.clone()),
             library_note="torch._int_mm at M = 17"),
        Case("probe pallas-i8-dot", "kbench_probe_i8dot", kp.i8dot, kp.dot_ref,
             lambda i: (x.clone(), w.clone()), dot_bytes, 2 * 8 * 512 * 256,
             "exact", library=torch._int_mm,
             make_library=lambda i: (x17.clone(), w.clone()),
             library_note="torch._int_mm at M = 17"),
    ]


def _flash_operands(T: int, dev):
    g = _gen(dev, 0)
    B, Kh, d = 1, 4, kf.D
    q = (torch.randn((B, Kh, T * kf.G, d), generator=g, device=dev) * 0.3
         ).to(torch.bfloat16)
    k = torch.randint(-127, 127, (B, Kh, T, d), generator=g, device=dev).to(torch.int8)
    v = torch.randint(-127, 127, (B, Kh, T, d), generator=g, device=dev).to(torch.int8)
    sk = torch.randn((B, Kh, T), generator=g, device=dev).abs() * 0.01 + 0.001
    sv = torch.randn((B, Kh, T), generator=g, device=dev).abs() * 0.01 + 0.001
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    return q, k, v, sk, sv, pos


def flash_cases(args, dev) -> list[Case]:
    T = args.m if args.m > 8 else 2048
    variants = (args.variants or ",".join(kf.VARIANTS)).split(",")
    for v in variants:
        kf.check_variant(v)
    q, k, v8, sk, sv, pos = _flash_operands(T, dev)
    B, Kh, TG, d = q.shape
    H = Kh * kf.G
    kvs = torch.stack([sk, sv], dim=-1)
    # SDPA over the K/V dequantized to bf16, heads h = kh * 8 + g
    qh = q.reshape(B, Kh, T, kf.G, d).transpose(2, 3).reshape(B, H, T, d)
    kd = (k.float() * sk[..., None]).to(torch.bfloat16)
    vd = (v8.float() * sv[..., None]).to(torch.bfloat16)
    # flipTnoscale's function: the int8 values themselves, exact in bf16
    kr, vr = k.to(torch.bfloat16), v8.to(torch.bfloat16)
    causal = H * T * (T + 1) // 2
    # keys of the visited 512-key tiles, every row
    t_max = ((torch.arange(TG) // kf.BTG) * kf.BTG + kf.BTG - 1) // kf.G
    visited = int((torch.clamp(t_max // kf.BS + 1, max=T // kf.BS) * kf.BS).sum()) * Kh
    base = q.numel() * 2 + 2 * k.numel() + 2 * sk.numel() * 4 + q.numel() * 4

    def sdpa(qx, kx, vx):
        return torch.nn.functional.scaled_dot_product_attention(
            qx, kx, vx, is_causal=True, enable_gqa=True)

    cases = []
    for var in variants:
        pre = var == "flipTpre"

        def make(i, pre=pre):
            if pre:
                return q.clone(), k.clone(), v8.clone(), kvs.clone(), None, pos
            return q.clone(), k.clone(), v8.clone(), sk.clone(), sv.clone(), pos

        pairs = {"stream": 0, "nomask": visited, "dots": visited}.get(var, causal)
        mode = ("overflow" if var == "noexp" else "bf16-scaled"
                if var in ("dots", "nosum", "flipTnoscale") else "bf16")
        cases.append(Case(
            f"flash T={T} {var:>12}", f"kbench_flash_{var}",
            lambda *o, var=var: kf.flash(*o, var),
            lambda *o, var=var: kf.flash_ref(*o, var), make, base,
            4 * d * pairs, mode,
            library=sdpa if var in kf.SAME_AS_FULL + ("flipTnoscale",)
            else None,
            make_library=(lambda i: (qh.clone(), kr.clone(), vr.clone()))
            if var == "flipTnoscale"
            else (lambda i: (qh.clone(), kd.clone(), vd.clone())),
            library_note="SDPA (causal, enable_gqa) over the int8 K/V cast "
                         "to bf16, scales dropped" if var == "flipTnoscale"
            else "SDPA (causal, enable_gqa) over the K/V dequantized to bf16",
            determinate=(lambda o: kf.noexp_determinate(*o))
            if var == "noexp" else None))
    return cases


def _i4_operands(idx: int, K: int, N: int, M: int, dev):
    g = _gen(dev, idx)
    N += N % 2
    vals = torch.randint(-7, 8, (K, N), generator=g, device=dev).to(torch.int8)
    s = torch.randn((K // 32, N), generator=g, device=dev).abs() * 0.01 + 0.001
    x = (torch.randn((M, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return x, ki.pack_nibbles(vals), s, vals


def i4_cases(args, dev) -> list[Case]:
    cases = []
    for idx, name, K, N in _shapes(args):
        x, packed, s, vals = _i4_operands(idx, K, N, args.m, dev)
        Np = vals.shape[1]
        wd = (vals.float().reshape(K // 32, 32, Np) * s[:, None, :]
              ).reshape(K, Np).to(torch.bfloat16)
        nbytes = packed.numel() + s.numel() * 4 + x.numel() * 2 + args.m * Np * 4
        for body in ki.BODIES:
            cases.append(Case(
                f"{name:>9} K={K:<5} N={Np:<5} {body:>8}", f"kbench_i4_{body}",
                lambda *o, body=body: ki.i4_matmul(*o, body),
                lambda *o, body=body: ki.i4_ref(*o, body),
                lambda i, x=x, p=packed, s=s: (x.clone(), p.clone(), s.clone()),
                nbytes, 2 * args.m * K * Np, "rel",
                library=torch.matmul,
                make_library=lambda i, x=x, wd=wd: (x.clone(), wd.clone()),
                library_note="torch.matmul on the dequantized bf16 weight"))
    return cases


def sweep_operands(idx: int, K: int, N: int, M: int, dev):
    """Port-made operands of a shape: random N(0, 0.02) weights quantized
    to real q4 (offset-7 values, f32 deltas rounded to fp16), packed
    planar without the XOR; x N(0, 0.5) in bf16. Returns x, data, scales
    and the dequantized bf16 weight [K, N]."""
    g = _gen(dev, idx)
    w = torch.randn((N, K), generator=g, device=dev) * 0.02
    qt = codec.quantize(w, "q4", "nk")
    vals = codec.unpack_q4(qt.data).t()                       # [K, N]
    scales = qt.scales.float().t().contiguous()               # [K/32, N]
    data = ks.pack_planar(vals)
    wd = ((vals.float() - ks.Q4_OFFSET) * scales.repeat_interleave(32, 0)
          ).to(torch.bfloat16)
    x = (torch.randn((M, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return x, data, scales, wd


def sweep_cases(args, dev) -> list[Case]:
    variants = (args.variants or SWEEP_DEFAULT).split(",")
    parsed = {v: ks.parse_variant(v) for v in variants}
    cases = []
    for idx, name, K, N in _shapes(args):
        x, data, scales, wd = sweep_operands(idx, K, N, args.m, dev)
        # the library call on the weight padded as the engine pads lm_head
        wdl = torch.nn.functional.pad(wd, (0, -N % 4))
        nbytes = data.numel() + scales.numel() * 4 + x.numel() * 2 + args.m * N * 4
        for bn in [int(v) or ks.pick_bn(N) for v in args.bns.split(",")]:
            bks = [int(v) or ks.pick_bk(K, bn) for v in args.bks.split(",")]
            for bk in bks:
                if K % bk or (bk // 2) * bn > 4 * 1024 * 1024:
                    continue
                tiled_ops = None
                for var in variants:
                    base, tiled, _, _ = parsed[var]
                    if (tiled or base == "manual") and N % bn:
                        continue
                    if tiled and tiled_ops is None:
                        tiled_ops = (ks.tile(data, bn), ks.tile(scales, bn))
                    d_, s_ = tiled_ops if tiled else (data, scales)

                    def make(i, x=x, d_=d_, s_=s_):
                        return x.clone(), d_.clone(), s_.clone()

                    cases.append(Case(
                        f"{name:>9} bn={bn:<5} bk={bk:<5} {var:>10}",
                        f"kbench_sweep_{base}",
                        lambda *o, var=var, bn=bn, bk=bk: ks.sweep(*o, var, bn, bk),
                        lambda *o, var=var, bn=bn, bk=bk: ks.sweep_ref(*o, var, bn, bk),
                        make, nbytes, 2 * args.m * K * N, "rel",
                        library=torch.matmul if base in ks.SAME_AS_CUR else None,
                        make_library=lambda i, x=x, wdl=wdl: (x.clone(), wdl.clone()),
                        library_note="torch.matmul on the dequantized bf16 weight"
                                     + (f", padded to {N + -N % 4} columns"
                                        if N % 4 else ""),
                        reference=(lambda *o, x=x, wd=wd: x.float() @ wd.float())
                        if base in ks.SAME_AS_CUR else None))
    return cases


def qmatmul_cases(args, dev) -> list[Case]:
    cases = []
    for idx, name, K, N in _shapes(args):
        g = _gen(dev, idx)
        Np = -(-N // 4) * 4  # K1 reads 4-column words: lm_head padded, as the engine
        w = codec.quantize(torch.randn((Np, K), generator=g, device=dev) * 0.02,
                           args.kind, "kn")
        x = (torch.randn((args.m, K), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
        nbytes = (w.data.numel() * w.data.element_size() + w.scales.numel() * 2
                  + x.numel() * 2 + args.m * Np * 2)
        wd = codec.dequantize(w, torch.bfloat16)
        counter = ("qmm_bigm" if args.m > qm.SMALL_M else
                   "qmm_smallm_aq8" if args.aq8 else "qmm_smallm")
        cases.append(Case(
            f"{name:>9} K={K:<5} N={Np:<5}", counter,
            lambda x_, d_, s_, w=w: qm.qmatmul(
                x_, codec.QTensor(d_, s_, w.kind, "kn"), torch.bfloat16,
                aq8=args.aq8),
            lambda x_, d_, s_, w=w: qm.qmatmul_ref(
                x_, codec.QTensor(d_, s_, w.kind, "kn"), torch.bfloat16,
                aq8=args.aq8),
            lambda i, w=w, x=x: (x.clone(), w.data.clone(), w.scales.clone()),
            nbytes, 2 * args.m * K * Np, "bf16", library=torch.matmul,
            make_library=lambda i, x=x, wd=wd: (x.clone(), wd.clone()),
            library_note="torch.matmul on the dequantized bf16 weight",
            extra={"shape": name}))
    return cases


CASES = {"probe": probe_cases, "flash": flash_cases, "i4": i4_cases,
         "sweep": sweep_cases, "qmatmul": qmatmul_cases}


# ---------------------------------------------------------------------- run --


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", default="qmatmul", choices=tuple(CASES))
    ap.add_argument("--variants", default=None)
    ap.add_argument("--bns", default="0")
    ap.add_argument("--bks", default="0")
    ap.add_argument("--kind", default="q4", choices=("q4", "q8"))
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--aq8", action="store_true")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def run_cpu(cases: list[Case]) -> list[dict]:
    """The plain versions once each; the cur-like sweep variants held
    against x @ dequant(w)."""
    rows = []
    for case in cases:
        out = case.plain(*case.make(0))
        line = (f"{case.label}: cpu plain version, max |out| "
                f"{float(out.float().abs().nan_to_num(posinf=0, neginf=0).max()):.5g}")
        if case.reference is not None:
            want = case.reference(*case.make(0))
            ok, err = compare(out, want, "bf16")
            if not ok:
                raise AssertionError(f"{case.label}: differs from x @ dequant(w) "
                                     f"by {err}")
            line += f", max |out - x @ dequant(w)| {err:.3e}"
        print(line, flush=True)
        rows.append(dict(name=case.label, counter=case.counter))
    return rows


def run(args) -> list[dict]:
    """Run the bench; returns one row a case. On the card each case's
    kernel is first held against its plain version (one launch, which
    raises on a disagreement), then timed; a row holds its ms, bound,
    library ms, the plain version's ms and the check's max |error|."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to "
                           "run the plain PyTorch versions")
    cases = CASES[args.bench](args, dev)
    if dev.type == "cpu":
        return run_cpu(cases)
    print(f"card: {card_line()}", flush=True)
    if args.bench == "probe":
        vals = torch.arange(-8, 8, device=dev).reshape(4, 4)
        back = ki.unpack_nibbles(ki.pack_nibbles(vals))
        print(f"probe int4-device-cast: OK roundtrip="
              f"{bool(torch.equal(back.long(), vals))}", flush=True)
    rows = []
    for case in cases:
        check = check_case(case)
        if args.bench == "probe":
            print(f"{case.label}: OK correct={check['max_abs_err'] == 0.0}",
                  flush=True)
        r = time_case(case, args.iters)
        r.update(check, plain_ms=time_plain(case))
        print_row(r, case.nbytes)
        if args.verbose:
            print(f"    {r['copies']} operand copies, {max(args.iters, r['copies'])}"
                  f" calls a replay; library: {case.library_note or 'none'}")
        rows.append(r)
    if args.bench == "qmatmul" and len(rows) == len(SHAPES):
        us = {r["shape"]: r["ms"] * 1e3 for r in rows}
        layer = sum(v for k, v in us.items() if k != "lm_head")
        print(f"\nper-token matmul time: 22*{layer:.1f} + {us['lm_head']:.1f} = "
              f"{22 * layer + us['lm_head']:.1f} us")
    return rows


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
