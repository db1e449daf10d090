"""runtime/trace.py's buckets and parser, the CLI's --profile, and
--debug-nans, on the CPU.

The bucket of a device event follows its kernel's name, so every kernel
the port's CUDA sources define (the microbench's aside) must land in
linear or attention by its own name: a renamed kernel that drifts into
other fails here instead of skewing a profile. The parser counts device
kernel events only, which a synthetic Kineto trace checks; on the CPU a
trace has none, and the table is still printed.
"""

import contextlib
import gzip
import json
import re
from pathlib import Path

import pytest
import torch

from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.runtime import speculative, trace
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.trace import (
    DeviceEvent, bucket_report, classify, format_bucket_table,
)

CSRC = Path(__file__).resolve().parents[1] / "tinyllama_tpu_torch" / "csrc"
CFG = pconfig.tiny_test_config()
F32 = pconfig.POLICIES["f32"]
CLI = ["--random-weights", "--model", "tiny-test", "-q8", "-p", "hi hi hi",
       "-greedy", "--npred", "30", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny ops (the test workers
    share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kernels() -> dict[str, str]:
    """Each __global__ function of the port's sources (less the
    microbench's kbench_*), by name, with its file."""
    found = {}
    for f in sorted(CSRC.glob("*.cu*")):
        if f.name.startswith("kbench_"):
            continue
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                               r"\([^)]*\)\s*)?(\w+)\s*\(", f.read_text()):
            found[name] = f.name
    return found


def test_every_port_kernel_is_classified():
    kernels = _kernels()
    assert set(kernels) == {"walk_kernel", "qmm_bigm_kernel",
                            "decode_split_kernel", "flash_prefill_kernel"}
    for name, src in kernels.items():
        assert classify(name) != "other", (
            f"{name} ({src}) matches no bucket fragment of runtime/trace.py")


def test_kernel_launch_table_covers_every_kernel_and_counter():
    """KERNEL_LAUNCHES names every kernel of the sources, and every
    wrapper counter (other cache kinds and aq8 folded) stands for a
    launch of one of them; a synthetic trace of a b1 decode step counts
    as its launches say."""
    from tinyllama_tpu_torch.ops.kernels import (
        attn_out_fused, decode_fused, ffn_fused, flash_attention, flash_paged,
        qmatmul,
    )

    assert set(trace.KERNEL_LAUNCHES) == set(_kernels())
    for mod in (qmatmul, decode_fused, ffn_fused, flash_attention,
                flash_paged, attn_out_fused):
        for counter in mod.launches:
            want = trace.expected_kernel_events({counter: 1})
            assert sum(want.values()) >= 1, counter
    L = 22
    step = {"fused_norm_qkv": L, "fused_attn_out_i8": L,
            "ffn_fused_normed": L, "qmm_smallm": 1}
    assert trace.expected_kernel_events(step) == {
        "walk_kernel": 4 * L + 1, "qmm_bigm_kernel": 0,
        "flash_prefill_kernel": 0, "decode_split_kernel": L}
    events = [DeviceEvent(NAMES["linear"][0], 1.0, 4 * L + 1),
              DeviceEvent(NAMES["attention"][0], 1.0, L),
              DeviceEvent(NAMES["other"][0], 1.0, 7)]
    assert trace.kernel_event_counts(events) == trace.expected_kernel_events(
        step)


#: device kernel names as a trace on the card gives them, by bucket
NAMES = {
    "linear": [
        "void (anonymous namespace)::walk_kernel<8, 8, 128, false, false, "
        "false>((anonymous namespace)::Args)",
        "void (anonymous namespace)::qmm_bigm_kernel<__nv_bfloat16, 8>"
        "((anonymous namespace)::BigmArgs<__nv_bfloat16>)",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas",
        "nvjet_hsh_128x64_64x4_1x2_h_bz_coopA_NTT",
        "cutlass_80_simt_sgemm_128x64_8x5_nn_align1",
        "void gemv2T_kernel_val<int, int, float, float, float, float, 128>",
    ],
    "attention": [
        "void (anonymous namespace)::decode_split_kernel<0, 64, 8, 1>"
        "((anonymous namespace)::Args<0>)",
        "void (anonymous namespace)::flash_prefill_kernel<0, 128>"
        "((anonymous namespace)::PfArgs<0>)",
        "void at::native::index_elementwise_kernel<128, 4, at::native::"
        "gpu_index_kernel<at::native::index_copy_kernel_impl<float>>>",
        "void at::native::_scatter_gather_elementwise_kernel<128, 4>",
        "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>",
    ],
    "other": [
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "CUDAFunctor_add<float>>",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
        "at::native::ArgMaxOps<float>>>",
        "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>",
        "void at::native::unrolled_elementwise_kernel<at::native::"
        "direct_copy_kernel_cuda>",
    ],
}


@pytest.mark.parametrize("bucket", sorted(NAMES))
def test_bucket_of_card_names(bucket):
    for name in NAMES[bucket]:
        assert classify(name) == bucket, name


def _write_trace(path: Path, events) -> None:
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_parse_counts_kernel_events_only(tmp_path):
    """Kernel events sum by name; host ops, runtime calls, copies and
    metadata do not count; a file without kernels adds nothing; no file
    raises FileNotFoundError."""
    with pytest.raises(FileNotFoundError):
        trace.parse_device_events(tmp_path)
    walk, split = NAMES["linear"][0], NAMES["attention"][0]
    _write_trace(tmp_path / f"a{trace.SUFFIX}", [
        {"ph": "X", "cat": "kernel", "name": walk, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": walk, "dur": 5.5},
        {"ph": "X", "cat": "kernel", "name": split, "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_copy_", "dur": 99.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "dur": 7.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 3.0},
        {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    ])
    sub = tmp_path / "sub"
    sub.mkdir()
    _write_trace(sub / f"b{trace.SUFFIX}", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0}])
    (tmp_path / "c.json").write_text("not a trace")
    events = {e.name: e for e in trace.parse_device_events(tmp_path)}
    assert set(events) == {walk, split}
    assert (events[walk].count, events[walk].dur_us) == (2, 15.5)
    assert (events[split].count, events[split].dur_us) == (1, 4.0)


def test_bucket_report_and_table():
    events = [DeviceEvent(NAMES["linear"][0], 100.0, 10),
              DeviceEvent(NAMES["attention"][1], 50.0, 10),
              DeviceEvent(NAMES["other"][0], 25.0, 5)]
    rep = bucket_report(events, steps=10)
    assert rep.buckets_us == {"linear": 100.0, "attention": 50.0,
                              "other": 25.0}
    assert rep.total_us == 175.0 and rep.us_per_step("linear") == 10.0
    table = format_bucket_table(rep)
    assert " DEVICE TIME PER TOKEN (profiled)" in table
    assert re.search(r" linear    :\s+0\.010ms \( 57\.1%\)", table)
    assert re.search(r" total     :\s+0\.018ms", table)
    assert "[linear   ] void (anonymous namespace)::walk_kernel" in table


def test_cli_profile_writes_a_trace_and_prints_the_table(tmp_path, capsys):
    """--profile DIR on the CPU: a Kineto trace under DIR (no device
    track, so every bucket is 0) and the table after the perf report and
    the speculative line; the tokens are those of a run without it."""
    spec = ["--spec", "4"]
    assert cli.main(CLI + spec) == 0
    plain = capsys.readouterr()
    assert cli.main(CLI + spec + ["--profile", str(tmp_path)]) == 0
    got = capsys.readouterr()
    files = list(tmp_path.glob("*" + trace.SUFFIX))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as f:
        assert json.load(f)["traceEvents"]
    assert got.err == plain.err
    assert got.out.index(" PERFORMANCE") < got.out.index(" speculative :") < \
        got.out.index(" DEVICE TIME PER TOKEN (profiled)")
    assert " total     :    0.000ms" in got.out


def test_cli_profile_reports_a_missing_trace(tmp_path, capsys, monkeypatch):
    """The JAX CLI's line when no trace file is found under DIR."""
    monkeypatch.setattr(trace, "profiled",
                        lambda d, device=None: contextlib.nullcontext())
    assert cli.main(CLI + ["--profile", str(tmp_path / "none")]) == 0
    err = capsys.readouterr().err
    assert f"[profile] no trace files found under {tmp_path / 'none'}" in err


def _params(nan_at=None, row=None):
    """Dense f32 parameters (seed 0); a NaN in the final norm's weight
    (nan_at="norm") or in an embedding row (nan_at="embed")."""
    pp = llama.convert_params(
        llama.init_dense_params(CFG, torch.Generator().manual_seed(0)), F32)
    if nan_at == "norm":
        pp["norm"][0] = float("nan")
    elif nan_at == "embed":
        pp["embed"][row] = float("nan")
    return pp


PROMPT = [1, 5, 9, 13]


def _runs(eng):
    gen = pconfig.GenerationConfig(n_predict=30, greedy=True, eos_token=-1,
                                   chunk_size=8)
    return {"generate": lambda: eng.generate(PROMPT, gen),
            "generate_speculative": lambda: eng.generate_speculative(PROMPT,
                                                                     gen),
            "generate_batch": lambda: eng.generate_batch([PROMPT, PROMPT], gen)}


@pytest.mark.parametrize("call", ["generate", "generate_speculative",
                                  "generate_batch"])
def test_debug_nans_raises_at_the_prefill(call):
    eng = Engine(CFG, F32, _params("norm"), device="cpu", debug_nans=True)
    with pytest.raises(FloatingPointError, match=f"{call}: .* the prefill"):
        _runs(eng)[call]()
    # the flag is cleared by the raise; without the flag nothing raises
    assert not eng.nan_flag.item()
    eng.debug_nans = False
    _runs(eng)[call]()


@pytest.mark.parametrize("call,where", [
    ("generate", "chunk 0"),
    ("generate_speculative", f"verify rounds 0-{speculative.ROUNDS - 1}")])
def test_debug_nans_names_the_chunk(call, where):
    """A NaN embedding row of the first generated token: the prefill is
    clean, the first decode step's logits are NaN."""
    first = _runs(Engine(CFG, F32, _params(), device="cpu"))["generate"]()[0][0]
    assert first not in PROMPT
    eng = Engine(CFG, F32, _params("embed", first), device="cpu",
                 debug_nans=True)
    with pytest.raises(FloatingPointError, match=f"{call}: .* {where}$"):
        _runs(eng)[call]()


def test_debug_nans_off_changes_nothing(capsys):
    """Without a NaN, the flag gives the same tokens (the CLI's output
    too) and the same graph keys; an inf alone does not set it."""
    pp = _params()
    on = Engine(CFG, F32, pp, device="cpu", debug_nans=True)
    off = Engine(CFG, F32, pp, device="cpu")
    for call in ("generate", "generate_speculative", "generate_batch"):
        assert _runs(on)[call]()[0] == _runs(off)[call]()[0]
    on._note_nans(torch.tensor([[float("inf"), 1.0]]))
    assert not on.nan_flag.item()
    on._note_nans(torch.tensor([[float("nan"), 1.0]]))
    assert on.nan_flag.item()
    outs = []
    for flag in ([], ["--debug-nans"]):
        assert cli.main(CLI + ["--spec", "3", "--no-perf"] + flag) == 0
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1]


def test_profile_check_sources_of_the_port_kernels(tmp_path):
    """tools/profile_check.diagnose: the port's kernel events by kernel
    and the host call of their correlation id, those outside the window
    counted; other kernels and host ops are not listed."""
    from tinyllama_tpu_torch.tools import profile_check

    walk, flash = NAMES["linear"][0], NAMES["attention"][1]
    _write_trace(tmp_path / f"a{trace.SUFFIX}", [
        {"ph": "i", "name": "Iteration Start: PyTorch Profiler", "ts": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 110.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "ts": 120.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": walk, "ts": 130.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": flash, "ts": 140.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": walk, "ts": 150.0,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": walk, "ts": 90.0,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": NAMES["other"][0], "ts": 160.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 170.0},
        {"ph": "i", "name": "Record Window End", "ts": 200.0},
    ])
    (found,) = profile_check.diagnose(tmp_path)
    assert found["by_call"] == {"walk_kernel by cudaGraphLaunch": 1,
                                "flash_prefill_kernel by cudaGraphLaunch": 1,
                                "walk_kernel by cudaLaunchKernelExC": 1,
                                "walk_kernel by no call": 1}
    assert found["outside_window"] == 1 and found["cupti"] is None


def test_profile_check_runs_the_cli(tmp_path, capsys):
    """tools/profile_check over the CLI on the CPU: a trace and the CLI's
    output a run, no device track and no launch, so the two sides agree;
    Engine's generate calls are themselves again afterwards."""
    from tinyllama_tpu_torch.tools import profile_check

    calls = (Engine.generate, Engine.generate_speculative)
    assert profile_check.main(["--runs", "2", "--out", str(tmp_path), "--"]
                              + CLI + ["--spec", "4"]) == 0
    assert (Engine.generate, Engine.generate_speculative) == calls
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["run"] for x in lines] == [0, 1]
    for i, x in enumerate(lines):
        assert x["equal"] and not any(x["events"].values())
        assert x["sources"][0]["by_call"] == {}
        assert len(list((tmp_path / f"run{i}").glob("*" + trace.SUFFIX))) == 1
        assert " speculative :" in (tmp_path / f"run{i}.out").read_text()
