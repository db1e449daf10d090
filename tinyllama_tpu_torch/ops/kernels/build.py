"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the
source, the shared headers and the flags, so an edited source rebuilds
and an unchanged one loads at once. A failed build raises; nothing falls
back to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("qmatmul", "flash_attention", "decode_split", "decode_fused",
           "ffn_fused", "attn_out_fused", "kbench_probe", "kbench_flash",
           "kbench_i4", "kbench_sweep")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: where the CUDA toolkit puts nvcc when it is not on PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build with the CUDA toolkit"
        )
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, tuple[str, float]]:
    """Build every kernel source at once, one nvcc per source, all started
    together. Returns nvcc's output (registers, spills) and its seconds
    per source that was built; sources already built are skipped."""
    with _lock:
        t0 = time.perf_counter()
        jobs = {name: job for name in SOURCES if (job := _start(name))}

        def finish(job):
            log = _finish(job)
            return log, time.perf_counter() - t0

        # one waiting thread a job, so each source's seconds are its own
        with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
            done = {name: pool.submit(finish, job) for name, job in jobs.items()}
            return {name: f.result() for name, f in done.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job:
                _finish(job)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current PyTorch stream of tensor t's device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
