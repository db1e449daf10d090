"""The port's kernel microbench (``tinyllama_tpu_torch/tools/kbench.py``
and ``ops/kernels/kbench_*.py``) against the JAX tool it ports
(``tools/kbench.py``).

The JAX tool runs unedited: ``jax.experimental.pallas.pallas_call`` is
wrapped to run in interpret mode and to record each call's operands and
output, its timing loop becomes one eager call and its profiler a
constant. Each port plain version then runs on the recorded operands
(int4 in the port's byte layout, the JAX run's own tiles, as printed):

* probes: int4 -> 2 v and the integer dots exactly on the JAX probes' own
  operands (rebuilt: they run under jit), the bitcast intent exactly
  against numpy's; the JAX bitcast probe cannot trace (recorded);
* flash (T = 1024: two key tiles, so the online rescale runs): the bf16
  kernel tolerance, rtol 2e-2 / atol 5e-3 (tests/test_tpu_kernels.py),
  with atol times max |JAX| for the unnormalized ablations whose outputs
  reach 60-10^4 (dots, nosum, flipTnoscale), and for noexp, which
  overflows to inf / NaN by design, the same tolerance where both are
  finite, and both finite (or both not) wherever no order of the f32
  sums could change it (kbench_flash.noexp_determinate);
* i4 (wqkv, w_down) and the sweep (every variant and manual at wqkv,
  cur with -t, -x and other tiles): max |port - JAX| <= 1e-4 max |JAX|
  (f32 sums of terms up to 10^6 in another order).

Then the port's own pieces: its tile picks and planar packing equal the
JAX package's, the variants that compute cur's function equal x @
dequant(w) on port-made operands, the CLI runs each bench on the CPU,
and unknown variant names raise.
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyllama_tpu.ops.pallas import qmatmul as jqm
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu_torch.ops.kernels import kbench_flash as kf
from tinyllama_tpu_torch.ops.kernels import kbench_i4 as ki
from tinyllama_tpu_torch.ops.kernels import kbench_probe as kp
from tinyllama_tpu_torch.ops.kernels import kbench_sweep as ks
from tinyllama_tpu_torch.tools import kbench


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: with the test
    workers sharing the host's cores, eight threads a worker each spin for
    the cores and the ops run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent
SWEEP_ALL = ks.VARIANTS + ("manual",)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_kbench_tool",
                                                  REPO / "tools" / "kbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(argv):
    """Run the JAX tool on `argv` with its Pallas calls interpreted;
    returns its output lines and each concrete call's (operands, out)."""
    tool = _jax_tool()
    real = jax.experimental.pallas.pallas_call
    calls = []

    def interpreted(*a, **k):
        f = real(*a, **dict(k, interpret=True))

        def call(*ops):
            out = f(*ops)
            if not isinstance(out, jax.core.Tracer):
                calls.append(([np.asarray(o if o.dtype != jnp.int4
                                          else o.astype(jnp.int8)) for o in ops],
                              np.asarray(out)))
            return out
        return call

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental.pallas, "pallas_call", interpreted)
        mp.setattr(tool, "loop_fn", lambda f, x, iters: (lambda: f(x)))
        mp.setattr(tool, "device_time_us", lambda g, *a, **k: (g(), {"k": 1.0})[1])
        with contextlib.redirect_stdout(buf):
            assert tool.main(argv) == 0
    return buf.getvalue().splitlines(), calls


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32 if a.dtype == jnp.bfloat16
                                  else a.dtype))
    return t.to(dtype) if dtype is not None else t


@pytest.fixture(scope="module")
def jax_sweep():
    """{printed variant: (bn, bk, operands, out)} at wqkv, every variant
    with the JAX picks, and cur at a second pair of tiles."""
    runs = {}
    for argv in (["--variants", ",".join(SWEEP_ALL + ("cur-t", "cur-x"))],
                 ["--variants", "cur", "--bns", "640", "--bks", "512"]):
        lines, calls = _run_jax(["--bench", "sweep", "--shape", "wqkv"] + argv)
        lines = [ln for ln in lines if "bn=" in ln]
        assert len(lines) == len(calls) and not any("FAIL" in ln for ln in lines)
        for ln, (ops, out) in zip(lines, calls):
            bn, bk, var = re.search(r"bn=(\d+)\s+bk=(\d+)\s+(\S+):", ln).groups()
            key = var if argv[-1] != "512" else f"{var} bn={bn} bk={bk}"
            runs[key] = (int(bn), int(bk), ops, out)
    return runs


@pytest.mark.parametrize("variant", SWEEP_ALL + ("cur-t", "cur-x",
                                                 "cur bn=640 bk=512"))
def test_sweep_plain_matches_jax_body(jax_sweep, variant):
    bn, bk, (x, data, scales), out = jax_sweep[variant]
    if variant.startswith("cur bn="):
        assert (bn, bk) == (640, 512)
        variant = "cur"
    else:
        assert (bn, bk) == (1280, 1024)  # the JAX picks at wqkv
    got = ks.sweep_ref(_t(x, torch.bfloat16), _t(data), _t(scales), variant, bn, bk)
    err = float((got - torch.tensor(out)).abs().max())
    assert err <= 1e-4 * float(np.abs(out).max()), err


@pytest.fixture(scope="module")
def jax_flash():
    lines, calls = _run_jax(["--bench", "flash", "--m", "1024", "--variants",
                             ",".join(kf.VARIANTS)])
    assert len(calls) == len(kf.VARIANTS) and not any("FAIL" in ln for ln in lines)
    return dict(zip(kf.VARIANTS, calls))


@pytest.mark.parametrize("variant", kf.VARIANTS)
def test_flash_plain_matches_jax_body(jax_flash, variant):
    ops, out = jax_flash[variant]
    pos, q, k, v = _t(ops[0]), _t(ops[1], torch.bfloat16), _t(ops[2]), _t(ops[3])
    sk, sv = (_t(ops[4]), None) if variant == "flipTpre" else (_t(ops[4]), _t(ops[5]))
    got = kf.flash_ref(q, k, v, sk, sv, pos, variant)
    want = torch.tensor(out)
    assert got.shape == want.shape
    mode = ("overflow" if variant == "noexp" else "bf16-scaled"
            if variant in ("dots", "nosum", "flipTnoscale") else "bf16")
    det = kf.noexp_determinate(q, k, v, sk, sv, pos) if variant == "noexp" else None
    ok, err = kbench.compare(got, want, mode, det)
    assert ok, err
    if variant == "stream":
        assert not want.any()
    if variant == "noexp":  # both kinds of fixed positions are there
        finite, overflow = det
        assert finite.any() and overflow.any()
        print(f"noexp T=1024: finite whatever the order at {finite.float().mean():.4%}"
              f", overflowing at {overflow.float().mean():.4%}; finiteness differs "
              f"at {kbench.finite_mismatch(got, want):.4%} of positions")


def test_overflow_mode_holds_finiteness():
    """noexp's comparison: a result non-finite where the order of the sums
    cannot make it so, or finite where it cannot, disagrees; elsewhere
    either may be."""
    want = torch.ones(4, 100)
    want[0] = float("inf")
    finite = torch.zeros(4, 100, dtype=torch.bool)
    overflow = torch.zeros_like(finite)
    finite[3], overflow[0] = True, True
    assert kbench.compare(want.clone(), want, "overflow", (finite, overflow))[0]
    got = want.clone()
    got[1:3] = float("nan")
    assert kbench.compare(got, want, "overflow", (finite, overflow))[0]
    got[3, 0] = float("nan")
    assert not kbench.compare(got, want, "overflow", (finite, overflow))[0]
    got = want.clone()
    got[0, 5] = 1.0
    assert not kbench.compare(got, want, "overflow", (finite, overflow))[0]


def test_noexp_determinate_holds_in_any_order():
    """At T = 512 (one key tile, out = sum_j bf16(p_j vs_j) v_j): f32 sums
    of every 64th row's terms, keys forward and reversed, are finite
    where noexp_determinate says finite and not where it says overflow."""
    q, k, v, sk, sv, pos = kbench._flash_operands(512, torch.device("cpu"))
    finite, overflow = kf.noexp_determinate(q, k, v, sk, sv, pos)
    rows = torch.arange(0, q.shape[2], 64)
    t = rows // kf.G
    sc = q[0, :, rows].float() @ k[0].float().transpose(1, 2) / 8 * sk[0][:, None]
    sc = torch.where(torch.arange(512) <= t[:, None], sc, kf.NEG_INF)
    pv = ((sc - sc.amax(-1, keepdim=True)) * 0.5 * sv[0][:, None]).to(torch.bfloat16)
    terms = pv.float()[..., None] * v[0].float()[:, None]       # [Kh, rows, S, d]
    for order in (terms, terms.flip(2)):
        fin = torch.isfinite(order.cumsum(2)[:, :, -1])
        assert fin[finite[0][:, rows]].all()
        assert not fin[overflow[0][:, rows]].any()
    assert finite[0][:, rows].any() and overflow[0][:, rows].any()


@pytest.fixture(scope="module")
def jax_i4():
    runs = {}
    for shape in ("wqkv", "w_down"):
        _, calls = _run_jax(["--bench", "i4", "--shape", shape])
        runs.update({(shape, b): c for b, c in zip(ki.BODIES, calls)})
    return runs


@pytest.mark.parametrize("shape", ["wqkv", "w_down"])
@pytest.mark.parametrize("body", ki.BODIES)
def test_i4_plain_matches_jax_kernel(jax_i4, shape, body):
    (x, w4, s), out = jax_i4[(shape, body)]
    got = ki.i4_ref(_t(x, torch.bfloat16), ki.pack_nibbles(_t(w4)), _t(s), body)
    err = float((got - torch.tensor(out)).abs().max())
    assert err <= 1e-4 * float(np.abs(out).max()), err


@pytest.fixture(scope="module")
def jax_probe_lines():
    lines, _ = _run_jax(["--bench", "probe"])
    return lines


def test_probe_int4_matches_jax_probe(jax_probe_lines):
    assert "probe pallas-int4-ref: OK correct=True" in jax_probe_lines
    w8 = jnp.clip(jax.random.randint(jax.random.PRNGKey(0), (256, 256), -8, 8),
                  -8, 7).astype(jnp.int8)
    vals = torch.from_numpy(np.asarray(w8))
    got = kp.int4_ref(ki.pack_nibbles(vals))
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), 2.0 * vals.float())
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.integers(-8, 8, (64, 32)))
    assert torch.equal(kp.int4_ref(ki.pack_nibbles(vals)).float(), 2.0 * vals.float())


def _np_bitcast(w: np.ndarray) -> np.ndarray:
    R4, C = w.shape
    words = np.ascontiguousarray(w.reshape(R4 // 4, 4, C).transpose(0, 2, 1))
    return words.view(np.int32)[..., 0] & 0xF


def test_probe_bitcast_intent_matches_numpy(jax_probe_lines):
    """The JAX probe fails to trace (fault 1); the port computes its intent."""
    assert any(ln.startswith("probe pallas-bitcast-i8-i32: FAIL IndexError")
               for ln in jax_probe_lines)
    ones = np.ones((256, 256), np.int8)
    rng = np.random.default_rng(1)
    rand = rng.integers(-128, 128, (256, 256)).astype(np.int8)
    for w in (ones, rand):
        got = kp.bitcast_ref(torch.from_numpy(w))
        assert got.shape == (64, 256)
        np.testing.assert_array_equal(got.float().numpy(), _np_bitcast(w))


@pytest.mark.parametrize("probe", ["pallas-i32-dot", "pallas-i8-dot"])
def test_probe_dots_match_jax_probe(jax_probe_lines, probe):
    assert f"probe {probe}: OK 512.0" in jax_probe_lines
    x, w = torch.ones((8, 512), dtype=torch.int8), torch.ones((512, 256), dtype=torch.int8)
    assert torch.equal(kp.dot_ref(x, w), torch.full((8, 256), 512.0))
    rng = np.random.default_rng(2)
    xn = rng.integers(-128, 128, (8, 512)).astype(np.int8)
    wn = rng.integers(-128, 128, (512, 256)).astype(np.int8)
    want = xn.astype(np.int64) @ wn.astype(np.int64)
    np.testing.assert_array_equal(kp.dot_ref(torch.from_numpy(xn),
                                             torch.from_numpy(wn)).numpy(), want)


@pytest.mark.parametrize("N", [96, 2048, 2560, 11264, 32003, 32004, 2176])
def test_tile_picks_equal_jax(N):
    assert ks.pick_bn(N) == jqm._pick_bn(N)
    for K in (2048, 5632, 1024, 192):
        assert ks.pick_bk(K, ks.pick_bn(N)) == jqm._pick_bk(K, jqm._pick_bn(N), "q4")


@pytest.mark.parametrize("xor", [False, True])
def test_planar_packing_equals_jax(xor):
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 15, (96, 256)).astype(np.uint8)  # [N, K]
    want = np.asarray(jcodec._pack_q4_kn(jnp.asarray(vals)))
    if not xor:
        want = (want.view(np.uint8) ^ 0x80).view(np.int8)
    got = ks.pack_planar(torch.from_numpy(vals).t(), xor=xor)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bench,shape", [("sweep", "wqkv"), ("sweep", "lm_head"),
                                         ("i4", "lm_head")])
def test_library_call_wherever_it_computes_the_function(bench, shape):
    """Every sweep case of cur's function and both i4 bodies carry the
    torch.matmul yardstick, on a weight padded as the engine pads lm_head
    (N a multiple of 4); the ablations carry none."""
    variants = ",".join(ks.VARIANTS + ("manual",)) if bench == "sweep" else None
    args = kbench.parse(["--bench", bench, "--shape", shape, "--device", "cpu"]
                        + (["--variants", variants] if variants else []))
    cases = kbench.CASES[bench](args, torch.device("cpu"))
    for case in cases:
        var = case.label.split()[-1]
        same = bench == "i4" or var in ks.SAME_AS_CUR
        assert (case.library is torch.matmul) == same, case.label
        if same:
            x, w = case.make_library(0)
            assert w.shape[1] % 4 == 0 and w.shape[1] - kbench.SHAPES[shape][1] < 4
            assert case.library(x, w).shape == (args.m, w.shape[1])
    assert sum(c.library is not None for c in cases) >= 2


def test_flash_library_call_wherever_it_computes_the_function():
    """full and the flips that compute its function (flipT, flipTtr,
    flipTpre) carry the SDPA yardstick over the dequantized K/V, and
    flipTnoscale SDPA over the int8 K/V cast to bf16 (its function, the
    scales dropped); the ablations carry none."""
    args = kbench.parse(["--bench", "flash", "--m", "128", "--device", "cpu"])
    cases = kbench.CASES["flash"](args, torch.device("cpu"))
    assert {c.label.split()[-1] for c in cases} == set(kf.VARIANTS)
    for case in cases:
        var = case.label.split()[-1]
        timed = var in kf.SAME_AS_FULL + ("flipTnoscale",)
        assert (case.library is not None) == timed, var
        if case.library is not None:
            q, k, v = case.make_library(0)
            assert case.library(q, k, v).shape == q.shape
            if var == "flipTnoscale":
                o = case.make(0)
                assert torch.equal(k.float(), o[1].float())
    assert set(kf.SAME_AS_FULL) == {"full", "flipT", "flipTtr", "flipTpre"}


@pytest.mark.parametrize("variant", ["cur", "dq", "ilp4", "manual"])
def test_sweep_on_port_operands_is_the_q4_product(variant):
    x, data, scales, wd = kbench.sweep_operands(0, 2048, 2560, 8, "cpu")
    got = ks.sweep_ref(x, data, scales, variant, 1280, 1024)
    torch.testing.assert_close(got, x.float() @ wd.float(), rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("argv", [
    ["--bench", "probe"],
    ["--bench", "flash", "--m", "512"],
    ["--bench", "i4", "--shape", "wo"],
    ["--bench", "sweep", "--shape", "wqkv", "--variants", "cur,dq,manual,cur-t,stream"],
    ["--bench", "qmatmul", "--shape", "wqkv"],
])
def test_cli_runs_on_cpu(argv, capsys):
    assert kbench.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cpu plain version" in out and " us/call" not in out


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        kbench.main(["--bench", "probe"])


def test_unknown_variants_raise():
    with pytest.raises(ValueError, match="sweep variant"):
        ks.parse_variant("curr")
    with pytest.raises(ValueError, match="sweep variant"):
        kbench.main(["--bench", "sweep", "--variants", "cur,dqq", "--device", "cpu"])
    with pytest.raises(ValueError, match="flash variant"):
        kbench.main(["--bench", "flash", "--variants", "cur", "--device", "cpu"])
    with pytest.raises(ValueError, match="i4 body"):
        ki.i4_ref(torch.zeros(1, 256, dtype=torch.bfloat16),
                  torch.zeros(256, 1, dtype=torch.uint8), torch.zeros(8, 2), "tiled")
    assert ks.parse_variant("cur-x-t-v") == ("cur", True, True, True)
