"""Rank processes, their process groups and the collectives of tensor
parallelism: the port's counterpart of the JAX package's parallel/mesh.py.

The JAX package runs one program over a (dcn, data, model) device mesh.
Here each rank is a process with one device, over ``torch.distributed``:

* ``run_ranks(fn, tp, ...)`` starts the dcn * dp * tp rank processes on this
  host, runs ``fn(mesh, *args)`` in each and returns their results in
  rank order; ``RankPool`` keeps the processes (and their process group)
  for many such calls. A rank that raises, dies or outlives the timeout
  ends the run: the others are stopped and the call raises;
* ``init_distributed`` joins the process group, with a timeout, so no
  collective waits forever on a rank that is gone;
* ``make_mesh(tp, dp, dcn)`` lays the ranks out as a [dcn, dp, tp] cube,
  host-major as JAX's device order: the model group is tp consecutive
  ranks (the ranks that share one batch and split the weights, on one
  host's links), the data group the dp ranks of one dcn slice that share
  a model rank, and the batch group the dcn * dp ranks that share a model
  rank (JAX's ``batch_axes``: "data", or ("dcn", "data") where the mesh
  has a dcn axis); only the dcn axis crosses hosts. ``RankPool(hosts=,
  host=)`` starts one host's share of a world.

Rank r runs on ``cuda:(r % device_count)``, or on the CPU where the
caller passes ``device="cpu"``. The backend follows from the placement
(``backend_for``): NCCL where every rank has a card of its own, gloo where
ranks share a card (NCCL places no two ranks on one device), and on the
CPU. It is fixed when the group is made; a failure of it raises.

The collectives the model calls are the model group's ``all_reduce``
(the sum after the row-parallel wo and w_down), ``ring_shift`` (the
ring's hop of ``--tp-overlap``) and ``all_gather``, and the data group's
``data_ring_shift`` (the hop of sequence parallelism's ring attention,
parallel/ring.py), ``data_all_gather`` (its K/V handoff) and
``data_broadcast`` (its last row), and the batch group's
``batch_all_gather`` (the rows of a data-parallel batch). After each of
them every rank of the group holds the same bits. Under gloo the
all-reduce of a CUDA tensor is gloo's own (it copies through host memory
itself), and the other collectives of a CUDA tensor go through host
memory (``Mesh._host_staged``; ``.cpu()`` waits for the work queued on
the tensor first); under NCCL they stay on the card and can be captured
in a CUDA graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import sys
import time
import traceback
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the [dcn, dp, tp] cube of ranks."""

    cube: np.ndarray  # [dcn, dp, tp] global ranks
    rank: int
    model_group: dist.ProcessGroup
    data_group: dist.ProcessGroup
    batch_group: dist.ProcessGroup
    device: torch.device
    backend: str

    @property
    def dcn(self) -> int:
        return self.cube.shape[0]

    @property
    def dp(self) -> int:
        return self.cube.shape[1]

    @property
    def tp(self) -> int:
        return self.cube.shape[2]

    def _coords(self) -> tuple[int, int, int]:
        c, d, t = np.argwhere(self.cube == self.rank)[0]
        return int(c), int(d), int(t)

    @property
    def dcn_rank(self) -> int:
        return self._coords()[0]

    @property
    def dp_rank(self) -> int:
        return self._coords()[1]

    @property
    def tp_rank(self) -> int:
        return self._coords()[2]

    @property
    def grid(self) -> np.ndarray:
        """The [dp, tp] grid of this rank's dcn slice (global ranks)."""
        return self.cube[self.dcn_rank]

    @property
    def batch(self) -> int:
        """The ranks of the batch group: dcn * dp."""
        return self.dcn * self.dp

    @property
    def batch_rank(self) -> int:
        """This rank's place in its batch group: dcn-major, as JAX shards
        a leading batch dimension over ("dcn", "data")."""
        c, d, _ = self._coords()
        return c * self.dp + d

    def model_mesh(self) -> "Mesh":
        """This rank's model group alone, as a mesh of dcn = dp = 1: a
        tensor-parallel engine over it runs only this model group's rows
        (its data and batch groups are left as they are, and an engine at
        sp 1 runs no collective over them)."""
        c, d, _ = self._coords()
        return dataclasses.replace(self, cube=self.cube[c:c + 1, d:d + 1])

    def _peer(self, offset: int) -> int:
        """The global rank `offset` places along this rank's model row."""
        return int(self.grid[self.dp_rank, (self.tp_rank + offset) % self.tp])

    def _data_peer(self, offset: int) -> int:
        """The global rank `offset` places along this rank's data column."""
        return int(self.grid[(self.dp_rank + offset) % self.dp, self.tp_rank])

    def _host_staged(self, t: torch.Tensor) -> bool:
        # gloo's all_reduce takes a CUDA tensor itself; its point-to-point
        # ops and all_gather take host tensors only, and the broadcast goes
        # the same way here
        return self.backend == "gloo" and t.is_cuda

    def _shift(self, t: torch.Tensor, to: int, source: int,
               group) -> torch.Tensor:
        """`source`'s t, while this rank's goes to `to` (global ranks)."""
        staged = self._host_staged(t)
        send = t.cpu() if staged else t.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, to, group),
               dist.P2POp(dist.irecv, recv, source, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(t.device) if staged else recv

    def _gather(self, t: torch.Tensor, dim: int, n: int,
                group) -> torch.Tensor:
        """The n ranks' t of `group`, concatenated along dim in rank
        order."""
        staged = self._host_staged(t)
        src = t.cpu() if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim)
        return out.to(t.device) if staged else out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the model group, in place; returns t."""
        dist.all_reduce(t, group=self.model_group)
        return t

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The right neighbour's `t` (model rank + 1), while this rank's
        goes to its left neighbour: the JAX ring's ppermute with perm
        [(i, i - 1)]."""
        return self._shift(t, self._peer(-1), self._peer(1), self.model_group)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's `t`, concatenated along `dim` in rank order
        (the JAX ``all_gather(tiled=True)``)."""
        return self._gather(t, dim, self.tp, self.model_group)

    def data_ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The `t` of the data rank before this one (data rank - 1), while
        this rank's goes to data rank + 1: the JAX ring attention's
        ppermute with perm [(i, i + 1)] (the other way round from
        ``ring_shift``)."""
        return self._shift(t, self._data_peer(1), self._data_peer(-1),
                           self.data_group)

    def data_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every data rank's `t`, concatenated along `dim` in data-rank
        order."""
        return self._gather(t, dim, self.dp, self.data_group)

    def data_broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Data rank `src`'s `t` on every rank of the data group (`t` of
        the same shape and dtype on every rank); returns the tensor."""
        staged = self._host_staged(t)
        box = t.cpu() if staged else t.contiguous()
        dist.broadcast(box, src=int(self.grid[src, self.tp_rank]),
                       group=self.data_group)
        return box.to(t.device) if staged else box

    def batch_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every batch rank's `t`, concatenated along `dim` in batch-rank
        order (each rank's rows of a batch back in the batch's order)."""
        return self._gather(t, dim, self.batch, self.batch_group)

    def broadcast_object(self, obj):
        """Rank 0's `obj` (the cube's first rank) on every rank of the cube
        (a host value: a seed, a prompt): over each model row from its
        first rank, then over each batch group from its first rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=int(self.grid[self.dp_rank, 0]),
                                   group=self.model_group)
        if self.batch > 1:
            dist.broadcast_object_list(
                box, src=int(self.cube[0, 0, self.tp_rank]),
                group=self.batch_group)
        return box[0]


def make_mesh(tp: int, dp: int = 1, dcn: int = 1, device=None) -> Mesh | None:
    """The [dcn, dp, tp] cube over the first dcn * dp * tp ranks of the
    process group (row-major, JAX's device order: a model group is tp
    consecutive ranks, and dcn is the outermost axis, the one that crosses
    hosts) and this rank's place in it, or None for a rank outside it.
    Every rank of the process group must call it (each group is made by
    all of them, in the same order)."""
    if not dist.is_initialized():
        raise RuntimeError("tensor and sequence parallelism run in rank "
                           "processes: start them with "
                           "parallel.mesh.run_ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = tp * dp * dcn
    if tp < 1 or dp < 1 or dcn < 1 or need > world:
        raise ValueError(f"a mesh of {dcn} x {dp} x {tp} needs {need} ranks, "
                         f"the process group has {world}")
    backend = dist.get_backend()
    if backend != backend_for(world, device):
        raise RuntimeError(f"the process group runs {backend}; ranks on "
                           f"these devices take {backend_for(world, device)}")
    key = (id(dist.group.WORLD), tp, dp, dcn, str(rank_device(rank, device)))
    if key not in _MESHES:
        cube = np.arange(need).reshape(dcn, dp, tp)
        models = {(c, d): dist.new_group(cube[c, d].tolist())
                  for c in range(dcn) for d in range(dp)}
        datas = {(c, t): dist.new_group(cube[c, :, t].tolist())
                 for c in range(dcn) for t in range(tp)}
        # at dcn 1 the batch group is the data group
        batches = ({t: datas[0, t] for t in range(tp)} if dcn == 1 else
                   {t: dist.new_group(cube[:, :, t].ravel().tolist())
                    for t in range(tp)})
        if rank >= need:
            _MESHES[key] = None
        else:
            c, d, t = (int(i) for i in np.argwhere(cube == rank)[0])
            _MESHES[key] = Mesh(cube, rank, models[c, d], datas[c, t],
                                batches[t], rank_device(rank, device),
                                backend)
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


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (for a rendezvous)."""
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
    (the CLI's chat REPL).

    With `hosts` > 1 the world spans that many hosts, each of which starts
    its own pool: this one starts host `host`'s world / hosts ranks
    (global ranks host * world / hosts onwards), joined at `address`
    (``tcp://host:port``, the same on every host; host 0's first rank
    serves it), and ``run`` returns this host's ranks' results."""

    def __init__(self, world: int, device=None,
                 timeout: float = DEFAULT_TIMEOUT_S,
                 threads: int | None = None, stdin: bool = False,
                 hosts: int = 1, host: int = 0, address: str | None = None):
        if world % hosts or not 0 <= host < hosts:
            raise ValueError(f"{world} ranks do not split over {hosts} hosts, "
                             f"or host {host} is not one of them")
        if hosts > 1 and address is None:
            raise ValueError("a world over several hosts needs the address "
                             "that every host joins")
        local = world // hosts
        self.ranks = list(range(host * local, (host + 1) * local))
        if rank_device(0, device).type == "cpu" and threads is None:
            threads = max(1, (os.cpu_count() or 1) // local)
        self.world, self.timeout = world, timeout
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.SimpleQueue() for _ in self.ranks]
        address = address or f"tcp://127.0.0.1:{free_port()}"
        fd = os.dup(sys.stdin.fileno()) if stdin else None
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, address, device, timeout, threads,
                _InheritedFd(fd) if r == 0 and fd is not None else None,
                q, self._results))
            for r, q in zip(self.ranks, self._tasks)]
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
        while len(out) < len(self.ranks):
            try:
                rank, status, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in zip(self.ranks, self._procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    self.close()
                    raise RankError(f"rank {dead[0][0]} exited with code "
                                    f"{dead[0][1]}")
                if time.monotonic() > deadline:
                    self.close()
                    raise RankError(f"{len(self.ranks) - len(out)} rank(s) "
                                    f"gave no {what} within {timeout:.0f} s")
                continue
            if status == "error":
                self.close()
                raise RankError(f"rank {rank} raised:\n{value}")
            out[rank] = value
        return [out[r] for r in self.ranks]

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


def with_mesh(fn, tp: int, dp: int, device, *args, dcn: int = 1, **kwargs):
    """fn(mesh, *args, **kwargs) on a rank of the [dcn, dp, tp] cube; None
    on a rank outside it (a task for ``RankPool.run``)."""
    mesh = make_mesh(tp, dp, dcn, device)
    return None if mesh is None else fn(mesh, *args, **kwargs)


def run_ranks(fn, tp: int, *args, dp: int = 1, dcn: int = 1, device=None,
              timeout: float = DEFAULT_TIMEOUT_S, stdin: bool = False) -> list:
    """Start dcn * dp * tp rank processes, run fn(mesh, *args) in each
    (mesh: ``make_mesh(tp, dp, dcn, device)``) and return the results in
    rank order; the processes end with the call. fn must be importable (a
    module's function) and its arguments and result picklable. A rank
    that raises or dies ends the run with RankError, within the process
    group's `timeout`."""
    with RankPool(tp * dp * dcn, device, timeout, stdin=stdin) as pool:
        return pool.run(with_mesh, fn, tp, dp, device, *args, dcn=dcn)
