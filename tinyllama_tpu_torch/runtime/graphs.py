"""The decode chunk as a CUDA graph: the port's counterpart of the JAX
package's jitted ``_chunk_fn`` (its ``lax.scan`` over C decode steps).

``Engine.chunk`` is the eager body, dispatched op by op from Python.
``ChunkGraphs`` holds the captured chunks over one cache's storage (a
monolithic cache, or a page pool and every table over it):

* **static buffers** a batch size B (``ChunkBuffers``): the inputs logits
  [B, V] f32, pos [B] int32 and, over a pool, the table [B, J] int32;
  the outputs done [B] and tokens [B, C] int32 (one a C). Every graph of
  one B reads and writes them, so chunks of different C chain with no
  copy between them. The captured body ends by writing its final logits
  and pos back into the input buffers, as ``lax.scan``'s carry: the next
  chunk needs no host op;
* **one graph a key** (B, C, sampler, EOS token, generator), captured at
  its first use: the body runs once eagerly on a side stream (real work,
  returned to the caller: it builds the kernels and fills the
  allocator), then is captured into the engine's graph pool. A failed
  capture raises; nothing falls back to the eager body;
* **top-k** draws from the caller's ``torch.Generator``, registered with
  each graph, so a replay draws what the eager body would draw from the
  generator's state, and advances it as the eager body would;
* **launch counts**: a capture launches nothing, so the kernel wrappers'
  counts made while capturing go to a tally (ops/kernels/counts.py),
  which must equal the eager first run's, and each replay adds the tally
  once;
* **memory**: outputs that outlive a replay live in the static buffers,
  everything else a graph allocates in the engine's one graph pool, so
  the graphs of an engine replay one at a time (one thread drives an
  engine), and a chunk's tokens are read before its buffers' next chunk.

Captures are serialised in the process and made with the thread-local
capture mode, so two engines driven by two threads (two servers in one
process) capture and run side by side. Every capture of the port
(``capturing``) also holds the cyclic garbage collector off: an engine
dropped in a reference cycle (it and its ``ChunkGraphs`` hold each other)
is freed by a collection, and a collection that ran inside a capture would
destroy that engine's graphs there: CUDA refuses that during a capture
and ends the capture (error 901 at the next launch in it). It collects
first, outside the capture.

On the CPU there is no capture: ``run`` runs the body over the same
buffers at every call; so on the card for a tensor-parallel engine under
gloo, whose collectives wait on the host (``capture_for``).

``RoundGraphs`` does the same for speculative decoding
(runtime/speculative.py): R verify rounds a graph, over the engine's
cache padded past max_ctx and the static buffers of each draft length;
one graph a key (draft length, EOS token, R), captured in the same pool
with the same tally. ``Engine.generate_speculative`` replays it until a
read back of the state shows done, each replay queued before the one
before it is read.

With the engine's ``debug_nans`` on, the bodies OR a NaN test of their
logits into the engine's flag, and every key takes a ``"debug_nans"``
entry; with it off the keys and bodies are as they were.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from tinyllama_tpu_torch.ops.kernels import counts
from tinyllama_tpu_torch.ops.rope import rope_table
from tinyllama_tpu_torch.runtime import speculative
from tinyllama_tpu_torch.runtime.kvcache import init_cache

#: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


@dataclass
class ChunkBuffers:
    """The static tensors of the chunks of one batch size over one cache."""

    logits: torch.Tensor  # [B, V] f32: in, and the last step's out
    pos: torch.Tensor  # [B] int32: in, and pos + C out
    table: torch.Tensor | None  # [B, J] int32 over a page pool
    done: torch.Tensor  # [B] bool
    tokens: dict[int, torch.Tensor] = field(default_factory=dict)  # C -> [B, C]


@dataclass
class _Graph:
    replay: Callable[[], None]
    tally: counts.Tally


@contextlib.contextmanager
def capturing(graph: "torch.cuda.CUDAGraph", **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` in the thread-local capture
    mode, with garbage collected first and the collector held off until
    the capture ends (see the module's docstring)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local",
                              **kwargs):
            yield
    finally:
        if enabled:
            gc.enable()


class CudaCapture:
    """Captures on one side stream into one graph pool (an engine's)."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def warm_up(self, body: Callable[[], None]) -> None:
        """The body once, eagerly, on the side stream."""
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            body()
        torch.cuda.current_stream().wait_stream(self.stream)

    def __call__(self, body: Callable[[], None],
                 generator: torch.Generator | None) -> Callable[[], None]:
        """The body captured (not run); returns its replay."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with _CAPTURE_LOCK, capturing(graph, pool=self.pool,
                                      stream=self.stream):
            body()
        return graph.replay


def capture_for(device: torch.device, mesh=None) -> CudaCapture | None:
    """How an engine on `device` captures its chunks: a CudaCapture on
    cuda; none on the CPU, where the body runs at every call. A
    tensor-parallel engine (`mesh`, tp > 1) captures only where its
    collectives can be captured, under NCCL; under gloo they wait on the
    host, so its chunk runs eagerly on the card. Fixed when the engine is
    built: a failed capture raises, nothing falls back."""
    if device.type != "cuda":
        return None
    if mesh is not None and mesh.tp > 1 and mesh.backend != "nccl":
        return None
    return CudaCapture(device)


def route(device: torch.device, capture: CudaCapture | None) -> str:
    """The chunk's route: "graph", "eager" (on the card without capture)
    or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return "graph" if capture is not None else "eager"


def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src is not dst:
        dst.copy_(src)


class ChunkGraphs:
    """The captured chunks of one engine over one cache's storage."""

    def __init__(self, engine, capture: CudaCapture | None):
        self.engine = engine
        self.capture = capture
        self.buffers: dict[int, ChunkBuffers] = {}
        self.graphs: dict[tuple, _Graph] = {}

    def buffers_for(self, cache, B: int) -> ChunkBuffers:
        """The static buffers of B-row chunks over `cache` (made at first
        use: zero logits and pos, a table of scratch pages)."""
        buf = self.buffers.get(B)
        if buf is None:
            dev, V = self.engine.device, self.engine.cfg.n_vocab
            table = getattr(cache, "table", None)
            if table is None and cache.k.shape[1] != B:
                raise ValueError(f"a monolithic cache of {cache.k.shape[1]} "
                                 f"rows runs {B}-row chunks")
            buf = self.buffers[B] = ChunkBuffers(
                logits=torch.zeros((B, V), dtype=torch.float32, device=dev),
                pos=torch.zeros((B,), dtype=torch.int32, device=dev),
                table=None if table is None else torch.zeros(
                    (B, table.shape[1]), dtype=torch.int32, device=dev),
                done=torch.zeros((B,), dtype=torch.bool, device=dev))
        return buf

    def run(self, cache, logits: torch.Tensor, pos: torch.Tensor, C: int,
            gen, generator: torch.Generator | None = None):
        """``Engine.chunk(cache, logits, pos, C, gen, generator)`` through
        the static buffers: inputs that are not already the buffers are
        copied in (pos and the table may come from the host), then the
        chunk's graph replays (or, at its key's first use, is run and
        captured). Returns the buffers (tokens [B, C], done, logits,
        pos)."""
        B = logits.shape[0]
        buf = self.buffers_for(cache, B)
        _put(buf.logits, logits)
        _put(buf.pos, pos)
        if buf.table is not None:
            _put(buf.table, cache.table)
            cache = cache.with_table(buf.table)
        toks = buf.tokens.get(C)
        if toks is None:
            toks = buf.tokens[C] = torch.empty(
                (B, C), dtype=torch.int32, device=self.engine.device)

        def body():
            out = self.engine.chunk(cache, buf.logits, buf.pos, C, gen,
                                    generator)
            for dst, src in zip((toks, buf.done, buf.logits, buf.pos), out):
                dst.copy_(src)

        if self.capture is None:
            body()
        else:
            sampler = ((True, 0, 0.0) if gen.greedy
                       else (False, gen.top_k, gen.temperature))
            key = (B, C, sampler, gen.eos_token, generator)
            _run_graph(self.engine, self.capture, self.graphs,
                       key + _debug_key(self.engine), body, generator, "chunk")
        return toks, buf.done, buf.logits, buf.pos


def _debug_key(engine) -> tuple:
    return ("debug_nans",) if engine.debug_nans else ()


def _run_graph(engine, capture: CudaCapture, graphs: dict, key, body,
               generator, what: str) -> None:
    """Replay the graph of `key` (adding its tally), or at the key's first
    use run `body` (the `what`) eagerly and capture it."""
    graph = graphs.get(key)
    if graph is not None:
        graph.replay()
        graph.tally.add()
        return
    t0 = time.perf_counter()
    with counts.tally() as ran:
        capture.warm_up(body)
    with counts.tally(launched=False) as captured:
        replay = capture(body, generator)
    if captured != ran:
        raise RuntimeError(
            f"the captured {what} launches {captured.by_name()}, its eager "
            f"run {ran.by_name()}")
    engine.graph_stats["graphs"] += 1
    engine.graph_stats["capture_s"] += time.perf_counter() - t0
    graphs[key] = _Graph(replay, captured)


class RoundGraphs:
    """The captured verify rounds of one engine: its cache and rope table
    padded to max_ctx + speculative.PAD (made once: the graphs address
    them), the static buffers of each draft length, and one graph a key
    (draft length, EOS token, rounds)."""

    def __init__(self, engine, capture: CudaCapture | None):
        self.engine = engine
        self.capture = capture
        S = engine.max_ctx + speculative.PAD
        cfg = engine.cfg
        self.cache = init_cache(cfg, 1, engine.policy.kv_dtype, S,
                                engine.device)
        self.rope = rope_table(S, cfg.d_head, cfg.rope_theta, engine.device)
        self.buffers: dict[int, speculative.SpecBuffers] = {}
        self.graphs: dict[tuple, _Graph] = {}

    def buffers_for(self, k: int) -> speculative.SpecBuffers:
        buf = self.buffers.get(k)
        if buf is None:
            buf = self.buffers[k] = speculative.new_buffers(
                self.engine.max_ctx, k, self.engine.device)
        return buf

    def run(self, k: int, eos: int, rounds: int) -> None:
        """`rounds` verify rounds of draft length k over its buffers: the
        graph of (k, eos, rounds) replayed (at the key's first use run
        eagerly and captured); on the CPU the rounds run eagerly."""
        buf = self.buffers_for(k)

        def body():
            for _ in range(rounds):
                speculative.verify_round(self.engine, self.cache, self.rope,
                                         buf, k, eos)

        if self.capture is None:
            body()
        else:
            _run_graph(self.engine, self.capture, self.graphs,
                       (k, eos, rounds) + _debug_key(self.engine), body, None,
                       "rounds")
