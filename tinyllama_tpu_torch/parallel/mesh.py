"""Rank processes, their process groups and the collectives of tensor
parallelism: the port's counterpart of the JAX package's parallel/mesh.py.

The JAX package runs one program over a (data, model) device mesh. Here
each rank is a process with one device, over ``torch.distributed``:

* ``run_ranks(fn, tp, ...)`` starts the tp * dp rank processes on this
  host, runs ``fn(mesh, *args)`` in each and returns their results in
  rank order; ``RankPool`` keeps the processes (and their process group)
  for many such calls. A rank that raises, dies or outlives the timeout
  ends the run: the others are stopped and the call raises;
* ``init_distributed`` joins the process group, with a timeout, so no
  collective waits forever on a rank that is gone;
* ``make_mesh(tp, dp)`` lays the ranks out as a [dp, tp] grid: the model
  group is a row (the ranks that share one batch and split the weights),
  the data group a column.

Rank r runs on ``cuda:(r % device_count)``, or on the CPU where the
caller passes ``device="cpu"``. The backend follows from the placement
(``backend_for``): NCCL where every rank has a card of its own, gloo where
ranks share a card (NCCL places no two ranks on one device), and on the
CPU. It is fixed when the group is made; a failure of it raises.

The collectives the model calls are the mesh's ``all_reduce`` (the sum
after the row-parallel wo and w_down), ``ring_shift`` (the ring's hop of
``--tp-overlap``) and ``all_gather``. After each of them every rank of
the group holds the same bits. Under gloo the all-reduce of a CUDA
tensor is gloo's own (it copies through host memory itself), and the
ring's hop and the gather go through host memory (``Mesh._host_staged``);
under NCCL they stay on the card and can be captured in a CUDA graph.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue
import socket
import sys
import time
import traceback
from dataclasses import dataclass
from multiprocessing import reduction

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective may wait before the process group raises
DEFAULT_TIMEOUT_S = 300.0
#: seconds a rank process has to join the process group
START_TIMEOUT_S = 120.0


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: cuda:(rank % device_count), or the CPU where
    `device` says so. Raises when a card is implied and none is there."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world: int, device=None) -> str:
    """NCCL where each of the `world` ranks has a card of its own; gloo
    where ranks share a card, and on the CPU."""
    if rank_device(0, device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def init_distributed(rank: int, world: int, address: str, device=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group of `world` ranks at `address`
    (``tcp://host:port``) as `rank`, on its device and backend
    (``backend_for``). A collective that waits past `timeout` seconds
    raises."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(world, device), init_method=address,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the [dp, tp] grid of ranks."""

    grid: np.ndarray  # [dp, tp] global ranks
    rank: int
    model_group: dist.ProcessGroup
    data_group: dist.ProcessGroup
    device: torch.device
    backend: str

    @property
    def dp(self) -> int:
        return self.grid.shape[0]

    @property
    def tp(self) -> int:
        return self.grid.shape[1]

    @property
    def dp_rank(self) -> int:
        return int(np.argwhere(self.grid == self.rank)[0, 0])

    @property
    def tp_rank(self) -> int:
        return int(np.argwhere(self.grid == self.rank)[0, 1])

    def _peer(self, offset: int) -> int:
        """The global rank `offset` places along this rank's model row."""
        return int(self.grid[self.dp_rank, (self.tp_rank + offset) % self.tp])

    def _host_staged(self, t: torch.Tensor) -> bool:
        # gloo takes CUDA tensors in all_reduce and broadcast only: its
        # point-to-point ops and all_gather go through host memory, here
        # and nowhere else
        return self.backend == "gloo" and t.is_cuda

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the model group, in place; returns t."""
        dist.all_reduce(t, group=self.model_group)
        return t

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The right neighbour's `t` (model rank + 1), while this rank's
        goes to its left neighbour: the JAX ring's ppermute with perm
        [(i, i - 1)]."""
        staged = self._host_staged(t)
        send = t.cpu() if staged else t.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, self._peer(-1), self.model_group),
               dist.P2POp(dist.irecv, recv, self._peer(1), self.model_group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(t.device) if staged else recv

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's `t`, concatenated along `dim` in rank order
        (the JAX ``all_gather(tiled=True)``)."""
        staged = self._host_staged(t)
        src = t.cpu() if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.tp)]
        dist.all_gather(parts, src, group=self.model_group)
        out = torch.cat(parts, dim)
        return out.to(t.device) if staged else out

    def broadcast_object(self, obj):
        """Model rank 0's `obj` on every rank of the group (a host value:
        a seed, a prompt)."""
        box = [obj]
        dist.broadcast_object_list(box, src=int(self.grid[self.dp_rank, 0]),
                                   group=self.model_group)
        return box[0]


def make_mesh(tp: int, dp: int = 1, device=None) -> Mesh | None:
    """The [dp, tp] grid over the first tp * dp ranks of the process group
    (row-major: a model group is tp consecutive ranks) and this rank's
    place in it, or None for a rank outside the grid. Every rank of the
    process group must call it (each group is made by all of them)."""
    if not dist.is_initialized():
        raise RuntimeError("tensor parallelism runs in rank processes: start "
                           "them with parallel.mesh.run_ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = tp * dp
    if tp < 1 or dp < 1 or need > world:
        raise ValueError(f"a mesh of {dp} x {tp} needs {need} ranks, the "
                         f"process group has {world}")
    backend = dist.get_backend()
    if backend != backend_for(world, device):
        raise RuntimeError(f"the process group runs {backend}; ranks on "
                           f"these devices take {backend_for(world, device)}")
    key = (id(dist.group.WORLD), tp, dp, str(rank_device(rank, device)))
    if key not in _MESHES:
        grid = np.arange(need).reshape(dp, tp)
        rows = [dist.new_group(row.tolist()) for row in grid]
        cols = [dist.new_group(col.tolist()) for col in grid.T]
        d, t = divmod(rank, tp)
        _MESHES[key] = None if rank >= need else Mesh(
            grid, rank, rows[d], cols[t], rank_device(rank, device), backend)
    return _MESHES[key]


#: the meshes this process made, by its process group and shape: every
#: rank makes the same meshes in the same order, so they hit or miss
#: together, and no group is made twice
_MESHES: dict = {}


# ----------------------------------------------------------------------------
# Rank processes
# ----------------------------------------------------------------------------


class RankError(RuntimeError):
    """A rank process raised, died, or outlived its time."""


class _InheritedFd:
    """A file descriptor handed to a spawned process (multiprocessing
    passes it across as it passes a pipe's end)."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        return _InheritedFd, (reduction.DupFd(self.fd).detach(),)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, address, device, timeout, threads, stdin, tasks,
               results):
    """A rank process: join the group, then run each task it is sent
    (None ends it), putting (rank, "ok" | "error", value) on `results`."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if stdin is not None:
            sys.stdin = os.fdopen(stdin.fd, "r")
        init_distributed(rank, world, address, device, timeout)
        results.put((rank, "ready", None))
        while (task := tasks.get()) is not None:
            fn, args, kwargs = task
            try:
                results.put((rank, "ok", fn(*args, **kwargs)))
            except BaseException:  # reported to the launcher, which stops all
                results.put((rank, "error", traceback.format_exc()))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """`world` rank processes on this host (spawned), joined in one
    process group for their life, that run the functions they are sent.

    ``run(fn, *args, **kwargs)`` runs fn on every rank and returns the
    results in rank order; fn and its arguments go by pickle (fn by its import
    path), and so do the results. A rank that raises, dies, or does not
    answer within `timeout` (the process group's) and a grace period
    stops every rank and raises RankError; the pool is then closed.
    `threads` sets torch's threads a rank (default on the CPU: the cores
    shared out). With `stdin`, rank 0 reads this process's standard input
    (the CLI's chat REPL)."""

    def __init__(self, world: int, device=None,
                 timeout: float = DEFAULT_TIMEOUT_S,
                 threads: int | None = None, stdin: bool = False):
        if rank_device(0, device).type == "cpu" and threads is None:
            threads = max(1, (os.cpu_count() or 1) // world)
        self.world, self.timeout = world, timeout
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.SimpleQueue() for _ in range(world)]
        address = f"tcp://127.0.0.1:{_free_port()}"
        fd = os.dup(sys.stdin.fileno()) if stdin else None
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, address, device, timeout, threads,
                _InheritedFd(fd) if r == 0 and fd is not None else None,
                self._tasks[r], self._results))
            for r in range(world)]
        try:
            for p in self._procs:
                p.start()
        finally:
            if fd is not None:  # rank 0 holds its own copy
                os.close(fd)
        try:
            self._collect("ready", START_TIMEOUT_S + timeout)
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str, timeout: float) -> list:
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        while len(out) < self.world:
            try:
                rank, status, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    self.close()
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{self._procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    self.close()
                    raise RankError(f"{self.world - len(out)} rank(s) gave no "
                                    f"{what} within {timeout:.0f} s")
                continue
            if status == "error":
                self.close()
                raise RankError(f"rank {rank} raised:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args, **kwargs) -> list:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if not self._procs:
            raise RankError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect("result", self.timeout + 30.0)

    def close(self) -> None:
        """End every rank: each is asked to stop, and stopped if it does
        not within a few seconds."""
        procs, self._procs = self._procs, []
        for p, q in zip(procs, self._tasks):
            if p.is_alive():
                with contextlib.suppress(OSError, ValueError):
                    q.put(None)
        deadline = time.monotonic() + 5.0
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def with_mesh(fn, tp: int, dp: int, device, *args, **kwargs):
    """fn(mesh, *args, **kwargs) on a rank of the [dp, tp] grid; None on
    a rank outside it (a task for ``RankPool.run``)."""
    mesh = make_mesh(tp, dp, device)
    return None if mesh is None else fn(mesh, *args, **kwargs)


def run_ranks(fn, tp: int, *args, dp: int = 1, device=None,
              timeout: float = DEFAULT_TIMEOUT_S, stdin: bool = False) -> list:
    """Start tp * dp rank processes, run fn(mesh, *args) in each (mesh:
    ``make_mesh(tp, dp, device)``) and return the results in rank order;
    the processes end with the call. fn must be importable (a module's
    function) and its arguments and result picklable. A rank that raises
    or dies ends the run with RankError, within the process group's
    `timeout`."""
    with RankPool(tp * dp, device, timeout, stdin=stdin) as pool:
        return pool.run(with_mesh, fn, tp, dp, device, *args)
