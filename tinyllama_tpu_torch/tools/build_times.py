"""Seconds nvcc takes for each kernel source, one source at a time.

    python -m tinyllama_tpu_torch.tools.build_times [--root DIR] [NAME ...]

compiles ``tinyllama_tpu_torch/csrc/NAME.cu`` of the checkout at DIR
(default: this one; a parent commit unpacked elsewhere gives the
before of a before/after) with the port's flags (ops/kernels/build.py)
into a temporary directory, one source after another, so that no build
competes with another for the host, and prints one JSON line a source:
its seconds, and the kernel entry functions ptxas compiled (the
template's instantiations). Without NAMEs, every source of the build.
It needs nvcc (the machine with the card); the libraries it writes are
thrown away.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from tinyllama_tpu_torch.ops.kernels import build


def time_source(root: Path, name: str) -> dict:
    """One nvcc of csrc/NAME.cu under `root`: its wall seconds and the
    entry functions ptxas reported. A failed build raises."""
    src = root / "tinyllama_tpu_torch" / "csrc" / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(Path(tmp) / "k.so"),
               str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    entries = sum("Compiling entry function" in line
                  for line in proc.stdout.splitlines())
    return {"source": name, "root": str(root), "seconds": round(seconds, 2),
            "entry_functions": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(build.SOURCES),
                    help="csrc/<name>.cu sources (default: all)")
    ap.add_argument("--root", default=str(build.CSRC.parents[1]),
                    help="the checkout whose sources to compile")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    for name in args.names:
        print(json.dumps(time_source(root, name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
