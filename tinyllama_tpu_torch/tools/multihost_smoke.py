"""Two "hosts" of two ranks each in one ``torch.distributed`` world: the
port's counterpart of the JAX package's tools/multihost_smoke.py.

    python -m tinyllama_tpu_torch.tools.multihost_smoke [--port P] [--device cpu]

The parent starts two host processes; each starts its two rank processes
(``parallel.mesh.RankPool(4, hosts=2, host=h)``), and the four join one
process group over TCP on 127.0.0.1 (``parallel.mesh.init_distributed``;
rank 0, on host 0, serves the rendezvous). On the (dcn 2, data 1, model 2)
mesh, whose model groups stay within a host and whose dcn axis crosses
them, every rank checks what the JAX tool checks:

1. an all-reduce of arange(4) (rank r holds r) over all four ranks crosses
   the host boundary and gives 6;
2. the column x row parallel pair (x = ones [1, 16], w1 = 2 I split on its
   columns, w2 = 3 I on its rows), summed over the model group only, gives
   6.0 on every rank.

Each host prints its ranks' lines; the parent prints them (on a host's
failure, the end of what it said) and ``MULTIHOST SMOKE OK`` (or
``FAILED``, exit 1). Ranks run on the card(s) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch
import torch.distributed as dist

from tinyllama_tpu_torch.parallel.mesh import RankPool, free_port, with_mesh

N_HOSTS, LOCAL_RANKS = 2, 2
D = 16


def check(mesh) -> str:
    """One rank's two checks; returns its line (raises where one fails)."""
    host = mesh.rank // LOCAL_RANKS
    model_ranks = mesh.cube[mesh.dcn_rank, mesh.dp_rank].tolist()
    if mesh.dcn_rank != host or any(r // LOCAL_RANKS != host
                                    for r in model_ranks):
        raise AssertionError(f"rank {mesh.rank}: model group {model_ranks} "
                             f"leaves host {host}")
    dev = mesh.device
    # 1. every rank, both hosts
    x = torch.tensor([float(mesh.rank)], device=dev)
    dist.all_reduce(x)
    total = float(x.item())
    if total != 6.0:
        raise AssertionError(f"rank {mesh.rank}: all-reduce gave {total}")
    # 2. Megatron's pair, summed over the model group (this host) only
    tp, t = mesh.tp, mesh.tp_rank
    cols = slice(t * D // tp, (t + 1) * D // tp)
    w1 = torch.eye(D, device=dev) * 2.0
    w2 = torch.eye(D, device=dev) * 3.0
    y = (torch.ones((1, D), device=dev) @ w1[:, cols]) @ w2[cols, :]
    got = float(mesh.all_reduce(y)[0, 0].item())
    if got != 6.0:
        raise AssertionError(f"rank {mesh.rank}: the TP pair gave {got}")
    return (f"rank {mesh.rank} (host {host}, dcn {mesh.dcn_rank}, model "
            f"{t}, {mesh.backend} on {dev}): all-reduce over 4 ranks = "
            f"{total}, tp pair = {got}")


def host_main(host: int, port: int, device) -> int:
    with RankPool(N_HOSTS * LOCAL_RANKS, device, timeout=120, hosts=N_HOSTS,
                  host=host, address=f"tcp://127.0.0.1:{port}") as pool:
        for line in pool.run(with_mesh, check, LOCAL_RANKS, 1, device,
                             dcn=N_HOSTS):
            print(line, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=None,
                    help="the rendezvous port (default: a free one)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the ranks on the CPU")
    ap.add_argument("--host", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.host is not None:
        return host_main(args.host, args.port, args.device)
    port = args.port or free_port()
    extra = ["--device", args.device] if args.device else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tinyllama_tpu_torch.tools.multihost_smoke",
         "--host", str(h), "--port", str(port), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for h in range(N_HOSTS)]
    rc = 0
    for h, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        ok = p.returncode == 0
        rc |= not ok
        lines = out.strip().splitlines()
        # the ranks' lines, or on a failure the end of what the host said
        shown = [x for x in lines if x.startswith("rank ")] if ok else lines[-20:]
        print(f"--- host {h}: {'OK' if ok else 'FAIL'}\n" + "\n".join(shown))
    print("MULTIHOST SMOKE", "FAILED" if rc else "OK")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
