"""The CLI's --profile trace held against the kernels' launch counts.

    python3 -m tinyllama_tpu_torch.tools.profile_check [--runs N] [--out DIR] \\
        -- CLI ARGUMENTS

Runs ``cli.main(CLI ARGUMENTS + ["--profile", DIR/run<i>])`` N times in
this process and prints one JSON line a run: the trace's events of each of
the port's kernels (``trace.kernel_event_counts``), what the wrappers'
launch counts in the run stand for (``trace.expected_kernel_events``),
whether the two are equal, and where the events came from (``diagnose``):
their counts by the host call that launched them (a CUDA graph's replay or
a launch of its own), how many lie outside the profiler's window, and the
trace's CUPTI version. The CLI's own output goes to DIR/run<i>.out. Exits 1
if any run's events differ from its launches. On the CPU (``--device
cpu`` among the CLI arguments) a trace has no device track and the
wrappers launch nothing, so both sides are 0.

For example, the speculative CLI run of chip_smoke.py's path (p4):

    python3 -m tinyllama_tpu_torch.tools.profile_check --runs 8 -- -q8 \\
        --random-weights -greedy --spec 4 --debug-nans -p "Hello" --npred 70
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gzip
import io
import json
import sys
import tempfile
from pathlib import Path

import torch

from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch.ops.kernels import (
    attn_out_fused, decode_fused, ffn_fused, flash_attention, flash_paged,
    qmatmul,
)
from tinyllama_tpu_torch.runtime import trace
from tinyllama_tpu_torch.runtime.engine import Engine

#: the wrapper modules whose launch tables the trace's kernels stand for
LAUNCH_TABLES = (qmatmul.launches, flash_attention.launches,
                 decode_fused.launches, ffn_fused.launches,
                 attn_out_fused.launches, flash_paged.launches)
#: the engine calls the CLI generates through
_CALLS = ("generate", "generate_speculative")


def profiled_cli(argv: list[str], prof_dir: str | Path) -> dict:
    """``cli.main(argv + ["--profile", prof_dir])`` with the launch tables
    set to 0 first. Returns the ids of its one generate call, the steps
    (or verify rounds) the device ran, its ms a token, the launch counts
    and what the CLI printed; raises if the CLI failed."""
    import torch

    seen = []
    real = {name: getattr(Engine, name) for name in _CALLS}

    def spy(name):
        def call(self, *a, **k):
            out, stats = real[name](self, *a, **k)
            seen.append((out, stats))
            return out, stats
        return call

    for table in LAUNCH_TABLES:
        for k in table:
            table[k] = 0
    printed = io.StringIO()
    try:
        for name in _CALLS:
            setattr(Engine, name, spy(name))
        with contextlib.redirect_stdout(printed):
            rc = cli.main(list(argv) + ["--profile", str(prof_dir)])
    finally:
        for name in _CALLS:
            setattr(Engine, name, real[name])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if rc or len(seen) != 1:
        raise RuntimeError(f"cli.main gave {rc} after {len(seen)} generate "
                           "calls")
    (out, stats), = seen
    return {"ids": out, "decode_steps": stats.decode_steps,
            "ms_per_token": stats.ms_per_token,
            "launches": {k: v for t in LAUNCH_TABLES for k, v in t.items()},
            "printed": printed.getvalue()}


def diagnose(prof_dir: str | Path) -> list[dict]:
    """Each trace file's events of the port's kernels by (kernel, host
    call that launched it), those outside the profiler's window (before
    its "Iteration Start" or after its "Record Window End"), and the
    trace's CUPTI version."""
    found = []
    for f in sorted(Path(prof_dir).rglob("*" + trace.SUFFIX)):
        with gzip.open(f, "rt") as fh:
            js = json.load(fh)
        evs = js.get("traceEvents", [])
        calls = {e["args"].get("correlation"): e.get("name") for e in evs
                 if str(e.get("cat", "")).lower() == "cuda_runtime"
                 and "args" in e}
        start = [e["ts"] for e in evs
                 if str(e.get("name", "")).startswith("Iteration Start")]
        end = [e["ts"] for e in evs if e.get("name") == "Record Window End"]
        by_call = collections.Counter()
        outside = 0
        for e in evs:
            if e.get("ph") != "X" or str(e.get("cat", "")).lower() != "kernel":
                continue
            kernel = next((k for k in trace.KERNEL_LAUNCHES if k in e["name"]),
                          None)
            if kernel is None:
                continue
            call = calls.get(e.get("args", {}).get("correlation"), "no call")
            by_call[f"{kernel} by {call}"] += 1
            outside += bool((start and e["ts"] < start[0])
                            or (end and e["ts"] > end[0]))
        found.append({"file": f.name, "cupti": js.get("cupti_version"),
                      "by_call": dict(by_call), "outside_window": outside})
    return found


def check(argv: list[str], prof_dir: str | Path) -> dict:
    """One profiled CLI run: its result (``profiled_cli``) with the trace's
    events of the port's kernels, what its launches stand for, whether
    they are equal, and ``diagnose``'s findings."""
    res = profiled_cli(argv, prof_dir)
    res["events"] = trace.kernel_event_counts(trace.parse_device_events(prof_dir))
    res["want_events"] = trace.expected_kernel_events(res["launches"])
    res["equal"] = res["events"] == res["want_events"]
    res["sources"] = diagnose(prof_dir)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1, help="profiled CLI runs")
    ap.add_argument("--out", default=None,
                    help="directory of the traces (default: a temporary one)")
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="the CLI's arguments, after --")
    args = ap.parse_args(argv)
    cli_args = args.cli_args[1:] if args.cli_args[:1] == ["--"] else args.cli_args
    out = Path(args.out or tempfile.mkdtemp(prefix="profile_check_"))
    ok = True
    for i in range(args.runs):
        res = check(cli_args, out / f"run{i}")
        (out / f"run{i}.out").write_text(res.pop("printed"))
        del res["ids"], res["launches"]
        ok &= res["equal"]
        print(json.dumps({"run": i, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
