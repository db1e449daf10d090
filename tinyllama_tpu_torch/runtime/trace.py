"""Device-time profiling: a torch.profiler trace, parsed into the
reference's print_perf buckets.

The counterpart of the JAX package's runtime/trace.py. The reference
buckets wall-clock time a module (linear, attention, other ms a token);
here a torch.profiler window (CPU and CUDA activities) around a known
number of tokens is written as a Kineto trace, its device kernel events
(``"cat": "kernel"``) are summed by name, and each name goes to a bucket
by fragments of the port's own kernel names (the Pallas names do not
occur on the card):

* linear: ``walk_kernel`` (csrc/fused_walk.cuh: K1, K5, K6, K7 and K8's
  wo launch), ``qmm_bigm_kernel`` (K2), and the library products of the
  dense policies (cuBLAS and CUTLASS gemm / gemv kernels);
* attention: ``decode_split_kernel`` (csrc/decode_split.cuh: K4, K9-K11
  and K8's attention launch), ``flash_prefill_kernel`` (K3), and the
  cache writes (index and scatter copies), as JAX counts its
  dynamic-update-slice;
* other: the rest (norms, rope, sampling, casts).

Two differences from the JAX buckets: K8 is two launches here, and its
wo launch lands in linear where JAX files the whole ``fused_attn_out``
call under attention; and rope is elementwise PyTorch kernels with no
name of their own, so it lands in other. A replayed CUDA graph's kernels
are device events of their own, by the names above.

Usage:
    events = profile_device_events(fn, trace_dir)
    report = bucket_report(events, steps=N)
    print(format_bucket_table(report))
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: kernel-name fragments -> print_perf bucket, checked in order; the
#: first match wins
_BUCKETS = (
    ("linear", ("walk_kernel", "qmm_", "gemm", "gemv", "nvjet", "cutlass",
                "xmma", "matmul")),
    ("attention", ("decode_split", "flash_", "attn", "attention",
                   "index_copy", "scatter")),
)
#: the trace file's name ends so (the JAX parser's suffix)
SUFFIX = ".trace.json.gz"
#: the port's kernels by their __global__ names, each with the launches
#: of it that one count of a wrapper's launch counter stands for (K7 and
#: K8 are two launches a call)
KERNEL_LAUNCHES = {
    "walk_kernel": {"qmm_smallm": 1, "fused_norm_qkv": 1,
                    "fused_out_residual": 1, "ffn_fused_normed": 2,
                    "ffn_fused": 2, "fused_attn_out": 1},
    "qmm_bigm_kernel": {"qmm_bigm": 1},
    "flash_prefill_kernel": {"flash_prefill": 1},
    "decode_split_kernel": {"flash_decode_heads": 1, "flash_staged": 1,
                            "flash_paged": 1, "flash_paged_staged": 1,
                            "fused_attn_out": 1},
}
#: the suffixes of a counter of another cache kind or K1's aq8 branch
_COUNTER_SUFFIX = re.compile(r"_(i8|f16|f32|aq8)$")


def classify(name: str) -> str:
    low = name.lower()
    for bucket, frags in _BUCKETS:
        if any(f in low for f in frags):
            return bucket
    return "other"


@dataclass
class DeviceEvent:
    name: str
    dur_us: float
    count: int = 1


@dataclass
class BucketReport:
    steps: int
    per_kernel: dict[str, DeviceEvent] = field(default_factory=dict)
    buckets_us: dict[str, float] = field(default_factory=dict)
    total_us: float = 0.0

    def us_per_step(self, bucket: str) -> float:
        return self.buckets_us.get(bucket, 0.0) / max(1, self.steps)


def _find_trace_files(trace_dir: str | Path) -> list[Path]:
    return sorted(Path(trace_dir).rglob("*" + SUFFIX))


def parse_device_events(trace_dir: str | Path) -> list[DeviceEvent]:
    """One DeviceEvent a kernel name, its durations summed, from every
    trace file under `trace_dir`. Only device kernel events count (host
    ops, runtime calls and memory copies do not), so a file with no
    device track (a CPU run) adds nothing. Raises FileNotFoundError when
    there is no trace file."""
    files = _find_trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no *{SUFFIX} under {trace_dir}")
    merged: dict[str, DeviceEvent] = {}
    for f in files:
        with gzip.open(f, "rt") as fh:
            events = json.load(fh).get("traceEvents", [])
        for e in events:
            if e.get("ph") != "X" or str(e.get("cat", "")).lower() != "kernel":
                continue
            name, dur = e.get("name", "?"), float(e.get("dur", 0.0))
            ev = merged.get(name)
            if ev is None:
                merged[name] = DeviceEvent(name, dur, 1)
            else:
                ev.dur_us += dur
                ev.count += 1
    return list(merged.values())


@contextlib.contextmanager
def profiled(trace_dir: str | Path, device=None):
    """A torch.profiler window (CPU, and CUDA when `device` is a card)
    whose Kineto trace is written under `trace_dir` on exit, as
    ``<pid>.<ns>.pt.trace.json.gz``. The card is synchronised before the
    window closes, so the device work queued inside it lands in it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    path = out / f"{os.getpid()}.{time.time_ns()}.pt{SUFFIX}"
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        plain = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(plain))
        with open(plain, "rb") as fin, gzip.open(path, "wb") as fout:
            shutil.copyfileobj(fin, fout)


def profile_device_events(fn, trace_dir: str | Path | None = None,
                          device=None) -> list[DeviceEvent]:
    """Run `fn()` inside ``profiled`` and return its parsed device
    events (a temporary directory when `trace_dir` is None)."""
    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="tlt_trace_")
    with profiled(trace_dir, device):
        fn()
    return parse_device_events(trace_dir)


def expected_kernel_events(launches: dict[str, int]) -> dict[str, int]:
    """The device events of each of the port's kernels that the wrappers'
    launch counts (counter name -> launches) stand for."""
    want = dict.fromkeys(KERNEL_LAUNCHES, 0)
    for name, n in launches.items():
        base = _COUNTER_SUFFIX.sub("", name)
        for kernel, per_call in KERNEL_LAUNCHES.items():
            want[kernel] += n * per_call.get(base, 0)
    return want


def kernel_event_counts(events: list[DeviceEvent]) -> dict[str, int]:
    """The events of each of the port's kernels among `events`."""
    got = dict.fromkeys(KERNEL_LAUNCHES, 0)
    for ev in events:
        for kernel in KERNEL_LAUNCHES:
            if kernel in ev.name:
                got[kernel] += ev.count
    return got


def bucket_report(events: list[DeviceEvent], steps: int) -> BucketReport:
    rep = BucketReport(steps=steps)
    for ev in events:
        rep.per_kernel[ev.name] = ev
        bucket = classify(ev.name)
        rep.buckets_us[bucket] = rep.buckets_us.get(bucket, 0.0) + ev.dur_us
        rep.total_us += ev.dur_us
    return rep


def format_bucket_table(rep: BucketReport, top_n: int = 16) -> str:
    """The print_perf per-module breakdown with device times: linear,
    attention and other ms a token, then the top kernels."""
    n = max(1, rep.steps)
    lines = [
        "",
        "-------------------------------------------",
        " DEVICE TIME PER TOKEN (profiled)",
        "-------------------------------------------",
    ]
    for bucket in ("linear", "attention", "other"):
        us = rep.buckets_us.get(bucket, 0.0) / n
        pct = 100.0 * rep.buckets_us.get(bucket, 0.0) / max(rep.total_us, 1e-9)
        lines.append(f" {bucket:<10}: {us / 1000.0:8.3f}ms ({pct:5.1f}%)")
    lines.append(f" {'total':<10}: {rep.total_us / n / 1000.0:8.3f}ms")
    lines.append("-------------------------------------------")
    lines.append(" top kernels (us/token, count/token):")
    ranked = sorted(rep.per_kernel.values(), key=lambda e: -e.dur_us)
    for ev in ranked[:top_n]:
        lines.append(
            f"  {ev.dur_us / n:9.1f}us  x{ev.count / n:6.1f}  "
            f"[{classify(ev.name):<9}] {ev.name[:60]}"
        )
    lines.append("-------------------------------------------")
    return "\n".join(lines) + "\n"
