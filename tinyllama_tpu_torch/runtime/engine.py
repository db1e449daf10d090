"""Inference engine: bucketed prefill, single-token decode, and the
chunked generation loop.

The counterpart of the JAX package's runtime/engine.py:

* ``prefill`` runs the whole (bucket-padded) prompts through the model
  from position 0, writing their K/V into the cache, and returns each
  last row's logits;
* ``decode_step`` runs one token per sequence at device positions;
* ``chunk`` runs C decode steps with sampling on the device and no
  read-back (the body of the JAX package's on-device decode chunk); at
  B > 1 it stages the chunk's K/V (runtime/staging.py). It is dispatched
  op by op from Python: the eager reference;
* ``run_chunk`` is ``chunk``'s function through static buffers: on the
  card a CUDA graph of ``chunk``, captured at its first use and replayed
  after (runtime/graphs.py), the counterpart of the JAX package's
  jitted chunk; on the CPU ``chunk`` over the same buffers;
* ``generate`` (one prompt) runs whole chunks and dispatches chunk i + 1
  before it reads chunk i back, as the JAX ``generate`` does;
  ``generate_batch`` (prompts in lockstep) reads each chunk back before
  the next. Both replay ``run_chunk`` over one cache a batch size, kept
  on the engine and rewritten from position 0 by each prefill (no
  kernel or plain path reads a key past its row's position).
* ``generate_speculative`` (one prompt, greedy) verifies n-gram drafts
  k + 1 tokens a forward (runtime/speculative.py), in graphs of R verify
  rounds replayed until done (runtime/graphs.py ``RoundGraphs``), over a
  cache of max_ctx + 128 positions kept on the engine.

``debug_nans`` is the counterpart of the JAX CLI's ``jax_debug_nans``:
the prefill, every step of a chunk and every verify round OR a NaN test
of their logits into a device flag (``nan_flag``), and the call raises
FloatingPointError after the read back that shows it, naming the call and
the chunk. It tests the logits only, where JAX tests every value; an inf
does not raise. Off, nothing of the above runs.

The cache is monolithic, or with ``paged=True`` a page pool
(runtime/paged.py), in the policy's KV dtype: bf16, f16, f32, or int8
with scales (``"i8"``, the ``*-kvi8`` policies). The policy's aq8 (q8a8,
q4a8) reaches every linear and the lm_head. Dense weights (f16, bf16,
f32) run the plain ops on either device, as the JAX engine runs them
without Pallas, and their chunk is captured as well; the engine stores
them cast to the activation dtype (an f16 weight as bf16 under the f16
policy), the values every product of the JAX package casts them to.

The engine runs on the card unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain version. With no card and no
explicit ``"cpu"`` it raises; it never carries on on the CPU by itself.

``tp=N`` is JAX's ``Engine(tp=N)``: the engine runs in each of N rank
processes (parallel/mesh.py ``run_ranks``) on its rank's device, over the
rank's shard of the weights (parallel/tp.py ``shard_params``); its
forward runs at the rank's local config (``fwd_cfg``: heads, kv heads
and ffn divided by N), with two sums over the model group a block, and
every cache it makes holds the rank's kv heads only. ``tp_overlap``
sums with the ring instead of an all-reduce. Every rank computes the same
logits bit for bit after each sum, so every rank samples the same
tokens, and the host loops of all ranks stay in lockstep. The chunk is a
CUDA graph where the collectives can be captured (NCCL, ranks on cards
of their own); under gloo (ranks sharing a card, or the CPU) it runs
eagerly. ``graph_stats["route"]`` says which.

``sp=N`` is JAX's ``Engine(sp=N)``: the mesh is [N, tp] (data x model),
and a prefill of one prompt (B == 1) shards the prompt's T over the data
group with ring attention, then hands its K/V off into the cache
(parallel/sp.py); every other prefill and every decode step runs as
above on each rank, which holds every batch row (JAX's decode replicates
over the data axis). At tp 1 each rank keeps the full weights on its
device and decodes the same tokens, its chunk a CUDA graph on the card
(no collective in it).

A mesh passed with tp > 1 and sp == 1 is JAX's ``Engine(tp=, mesh=)``
with ``batch_axes``: batch rows shard over the mesh's batch group (its
dcn x data ranks, parallel/mesh.py). Every rank receives every prompt;
rank r of a group of n prefills and decodes rows [r * B / n, (r + 1) *
B / n) at its local widths (``batch_rows``), its caches hold those rows
(a page pool the whole page-id space, as JAX's replicated pool: a rank
reads only the pages its rows wrote), and after each chunk's read back
the rows' tokens are all-gathered over the batch group
(``all_rows``), so every rank's host loop makes the same decisions and
returns every row. The gather is outside the chunk, which keeps its CUDA
graph under NCCL. A batch the group does not divide raises, as JAX's
``device_put`` does (``generate`` at dp > 1 among them). At tp 1 and
sp 1 a passed mesh only places the engine on its rank's device: every
rank runs every row, as JAX uses no mesh there.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from tinyllama_tpu_torch.config import DtypePolicy, GenerationConfig, ModelConfig
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops import sampling
from tinyllama_tpu_torch.ops.rope import rope_table
from tinyllama_tpu_torch.parallel.mesh import make_mesh
from tinyllama_tpu_torch.parallel.sp import sp_prefill_into_cache
from tinyllama_tpu_torch.parallel.tp import (
    TpGroup,
    layer_ids_for,
    local_config,
    shard_params,
)
from tinyllama_tpu_torch.runtime import graphs, speculative
from tinyllama_tpu_torch.runtime.kvcache import KVCache, init_cache
from tinyllama_tpu_torch.runtime.paged import (
    PagedKVCache,
    default_page_size,
    init_paged_cache,
)
from tinyllama_tpu_torch.runtime.staging import flush_staged, stage_cache


@dataclass
class GenStats:
    """Timing and throughput of one generate call (the reference's
    print_perf data)."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    load_s: float = 0.0
    #: decode forward passes run (>= generated_tokens when EOS cuts a chunk)
    decode_steps: int = 0
    #: host wait per chunk read-back, seconds
    decode_token_times: list = field(default_factory=list)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def ms_per_token(self) -> float:
        return (1000.0 * self.decode_s / self.generated_tokens
                if self.generated_tokens else 0.0)


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another. Raises
    when CUDA is asked for (or implied) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def _bucket(n: int, max_ctx: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_ctx)


def _drop_graphs(engine_ref, key: int) -> None:
    """Drop an engine's chunk graphs over a storage that is gone (if the
    engine still lives)."""
    engine = engine_ref()
    if engine is not None:
        engine._chunk_graphs.pop(key, None)


class Engine:
    """One model + dtype policy on one device (with tp > 1: one rank's
    shard, on the rank's device). `mesh` is the rank's ``make_mesh``,
    whose tp the engine takes; its data group is the sequence-parallel
    group where ``sp`` > 1 (sp must then be the mesh's dp), else, at tp >
    1, its batch group carries the batch rows. Without one, ``tp=N`` and
    ``sp=M`` make it here ([M, N]). Under tensor parallelism `params` are
    best kept in host memory: only the rank's shard is copied to its
    device.

    ``paged`` makes every cache of the engine a page pool (one static run
    of pages a row, page 0 the scratch page)."""

    def __init__(self, cfg: ModelConfig, policy: DtypePolicy,
                 params: llama.Params, max_ctx: int | None = None,
                 device=None, paged: bool = False, debug_nans: bool = False,
                 tp: int = 1, tp_overlap: bool = False, mesh=None,
                 sp: int = 1):
        if mesh is None and (tp > 1 or sp > 1):
            mesh = make_mesh(tp, sp, device=device)
        if mesh is not None:
            if tp not in (1, mesh.tp):
                raise ValueError(f"tp={tp}: the mesh's model group has "
                                 f"{mesh.tp} ranks")
            if sp > 1 and sp != mesh.dp:
                raise ValueError(f"sp={sp}: sequence parallelism runs over "
                                 f"the mesh's data group, of {mesh.dp} ranks")
            tp = mesh.tp
        self.tp = tp
        #: the ways of the sequence-parallel prefill (the mesh's dp)
        self.sp = sp
        #: the ranks the batch rows shard over (the mesh's batch group,
        #: dcn x data, under tp with sp 1; else 1) and this rank's place
        self.batch = mesh.batch if mesh is not None and tp > 1 and sp == 1 \
            else 1
        self.batch_rank = mesh.batch_rank if self.batch > 1 else 0
        self.tp_overlap = tp_overlap and tp > 1
        self._tp = None
        if mesh is not None:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device}: this rank runs on "
                                 f"{mesh.device}")
            device = mesh.device
        if tp > 1:
            self._tp = TpGroup(mesh, self.tp_overlap)
        self.mesh = mesh
        self.device = resolve_device(device)
        if (self.device.type == "cuda" and policy.is_quantized
                and policy.adtype != "bf16"):
            raise NotImplementedError(
                f"the CUDA kernels take bf16 activations, not {policy.adtype}; "
                "f32 and f16 compute with quantized weights are queued "
                "(ROADMAP.md)")
        self.cfg = cfg
        #: the config the forward and the caches run at: the rank's local
        #: one under tensor parallelism
        self.fwd_cfg = local_config(cfg, tp) if tp > 1 else cfg
        self.policy = policy
        self.max_ctx = max_ctx or cfg.max_ctx
        self.paged = paged
        # the rank's shard on its device (only the slices are copied);
        # quantized: whole char4 rows and strips for the lm_head kernel;
        # dense: the weights cast to the activation dtype once, here
        shard = (shard_params(params, cfg, tp, mesh.tp_rank, self.device,
                              self.tp_overlap) if tp > 1
                 else llama.params_to(params, self.device))
        self.params = llama.cast_dense_weights(llama.pad_lm_head_vocab(shard),
                                               llama.act_dtype(policy))
        self.rope_tables = rope_table(self.max_ctx, cfg.d_head, cfg.rope_theta,
                                      self.device)
        self.layer_ids = layer_ids_for(cfg, tp, self.tp_overlap, self.device)
        #: top-k draws of generate and generate_batch, reseeded each call
        self.generator = torch.Generator(self.device)
        #: the caches of generate and generate_batch, one a batch size
        self._caches: dict[int, KVCache | PagedKVCache] = {}
        #: the captured chunks by cache storage (id of its k plane), each
        #: dropped with its storage
        self._chunk_graphs: dict[int, graphs.ChunkGraphs] = {}
        self._capture = graphs.capture_for(self.device, mesh)
        #: graphs captured by this engine and the seconds spent on them
        #: (their eager first runs included), and the chunk's route:
        #: "graph" (captured and replayed), "eager" (on the card, TP under
        #: gloo) or "cpu"
        self.graph_stats = {"graphs": 0, "capture_s": 0.0,
                            "route": graphs.route(self.device, self._capture)}
        #: the speculative rounds' padded cache, buffers and graphs (made
        #: at the first generate_speculative)
        self._rounds: graphs.RoundGraphs | None = None
        self.debug_nans = debug_nans
        #: set by a NaN in the logits while debug_nans is on
        self.nan_flag = torch.zeros(1, dtype=torch.bool, device=self.device)

    def batch_rows(self, batch: int) -> slice:
        """This rank's rows of a batch of `batch` (all of them at a batch
        group of one). Raises ValueError where the batch group does not
        divide the batch, as JAX's ``device_put`` does."""
        if batch % self.batch:
            raise ValueError(
                f"a batch of {batch} row(s) does not divide over the batch "
                f"group of {self.batch} ranks (the mesh's dcn x data axes)")
        b = batch // self.batch
        return slice(self.batch_rank * b, (self.batch_rank + 1) * b)

    def all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every batch rank's rows of `t` ([rows, ...], this rank's),
        all-gathered in the batch's order (`t` itself at a batch group of
        one)."""
        return self.mesh.batch_all_gather(t, 0) if self.batch > 1 else t

    def new_cache(self, batch: int) -> KVCache | PagedKVCache:
        """A cache for a batch of `batch`: this rank's rows of it."""
        if self.paged:
            return self.new_paged_cache(batch)
        rows = self.batch_rows(batch)
        return init_cache(self.fwd_cfg, rows.stop - rows.start,
                          self.policy.kv_dtype, self.max_ctx, self.device)

    def new_paged_cache(self, batch: int) -> PagedKVCache:
        """A page pool for the paths outside the scheduler (generate,
        generate_batch, the CLI's --paged): row b owns pages 1 + b * J ..
        (b + 1) * J, covering max_ctx; page 0 stays the scratch page. The
        pool spans the whole batch's page ids, its table this rank's
        rows."""
        rows = self.batch_rows(batch)
        J = self.max_ctx // default_page_size(self.max_ctx)
        cache = init_paged_cache(self.fwd_cfg, 1 + batch * J,
                                 rows.stop - rows.start, self.policy.kv_dtype,
                                 self.max_ctx, device=self.device)
        table = 1 + torch.arange(batch * J, dtype=torch.int32).reshape(batch, J)
        return cache.with_table(table[rows])

    def _cache(self, batch: int) -> KVCache | PagedKVCache:
        """The engine's own cache of `batch` rows for generate and
        generate_batch: made once, reused by every later call (its
        captured chunks address it)."""
        cache = self._caches.get(batch)
        if cache is None:
            cache = self._caches[batch] = self.new_cache(batch)
        return cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward_logits(self, cache, tokens: torch.Tensor, pos: torch.Tensor,
                        last: torch.Tensor | None = None,
                        from_zero: bool = False) -> torch.Tensor:
        """Logits of row b's token `last[b]` (the only token at decode)."""
        hidden = llama.forward(self.fwd_cfg, self.policy, self.params,
                               tokens, cache, pos, self.rope_tables,
                               self.layer_ids, from_zero, self._tp)
        aq8 = self.policy.aq8
        if last is None:
            return llama.lm_head_logits(self.params, hidden[:, 0], aq8)
        rows = torch.arange(hidden.shape[0], device=self.device)
        return llama.lm_head_logits(self.params, hidden[rows, last], aq8)

    def prefill(self, cache, prompts: list[list[int]]):
        """Prefill a batch of prompts from position 0, padded to one bucket
        length (at sp > 1, one prompt: sequence-parallel). Returns (logits
        [B, V] f32 of each prompt's last token, lens). Over a batch group,
        `cache` holds this rank's rows (``new_cache(B)``), which it
        prefills, padded to their own bucket, and the logits are theirs;
        lens are every prompt's."""
        lens = np.array([len(p) for p in prompts], np.int64)
        if int(lens.max()) > self.max_ctx:
            raise ValueError(
                f"Number of prompt tokens ({int(lens.max())}) exceeds maximum "
                f"ctx size ({self.max_ctx})")
        if self.sp > 1 and len(prompts) == 1:
            # one prompt over the data group (parallel/sp.py), its K/V
            # handed off into this cache
            if self.tp_overlap:
                raise ValueError("the sequence-parallel prefill sums wo and "
                                 "w_down with an all-reduce: --tp-overlap "
                                 "does not combine with sp (as the JAX "
                                 "engine asserts)")
            logits = sp_prefill_into_cache(
                self.fwd_cfg, self.policy, self.params, prompts[0],
                self.rope_tables, self.mesh, cache, self.layer_ids, self._tp)
            self._note_nans(logits)
            return logits, lens
        rows = self.batch_rows(len(prompts))
        mine, mine_lens = prompts[rows], lens[rows]
        T = _bucket(int(mine_lens.max()), self.max_ctx)
        toks = np.zeros((len(mine), T), np.int64)
        for i, p in enumerate(mine):
            toks[i, : len(p)] = p
        pos = torch.zeros(len(mine), dtype=torch.int32, device=self.device)
        # from position 0: the paged prefill attends its own keys only
        # (models/llama.py)
        logits = self._forward_logits(
            cache, torch.from_numpy(toks).to(self.device), pos,
            torch.from_numpy(mine_lens - 1).to(self.device), from_zero=True)
        self._note_nans(logits)
        return logits, lens

    def decode_step(self, cache, tokens: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        """One token per sequence: tokens [B], pos [B] int32 (device) ->
        logits [B, V] f32; the cache is written in place."""
        return self._forward_logits(cache, tokens[:, None], pos)

    def chunk(self, cache, logits: torch.Tensor, pos: torch.Tensor, C: int,
              gen: GenerationConfig,
              generator: torch.Generator | None = None):
        """C decode steps back to back on the device, sampling included:
        the counterpart of the JAX package's ``_chunk_fn``. The token of
        step i is sampled from the logits entering step i; once a row
        samples EOS it keeps emitting EOS. Returns (tokens [B, C] int32,
        done [B], logits, pos + C); nothing is read back to the host.

        At B > 1 the steps' K/V go to a chunk-local staging tail, one
        write a plane a layer-step, flushed into the cache at the end. At
        B == 1 the plain write is one write already, so the chunk writes
        the cache directly. A chunk may run past max_ctx (the scheduler
        runs whole chunks and drops the tokens past the end): a staged
        chunk's flush keeps to max_ctx, and an unstaged one writes and
        reads those steps at max_ctx - 1."""
        B = logits.shape[0]
        staged = B > 1
        state = stage_cache(cache, pos, C) if staged else cache
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        eos = torch.full((B,), gen.eos_token, dtype=torch.int32,
                         device=self.device)
        toks = torch.empty((B, C), dtype=torch.int32, device=self.device)
        pos = pos.clone()
        for i in range(C):
            if gen.greedy:
                tok = sampling.greedy(logits)
            else:
                tok = sampling.sample_top_k(logits, generator, gen.temperature,
                                            gen.top_k, self.batch_rank,
                                            self.batch)
            tok = torch.where(done, eos, tok)
            done |= tok == eos
            toks[:, i] = tok
            step_pos = pos if staged else pos.clamp(max=self.max_ctx - 1)
            logits = self.decode_step(state, tok, step_pos)
            self._note_nans(logits)
            pos += 1
        if staged:
            flush_staged(state, C)
        return toks, done, logits, pos

    def chunk_graphs(self, cache) -> graphs.ChunkGraphs:
        """The captured chunks over `cache`'s storage and their static
        buffers (made at first use; dropped when the storage is)."""
        plane = cache.k
        key = id(plane)
        found = self._chunk_graphs.get(key)
        if found is None:
            found = graphs.ChunkGraphs(self, self._capture)
            self._chunk_graphs[key] = found
            # the finalizer holds the engine weakly: the engine holds its
            # caches, and a strong hold would keep both alive for good
            weakref.finalize(plane, _drop_graphs, weakref.ref(self), key)
        return found

    def run_chunk(self, cache, logits: torch.Tensor, pos: torch.Tensor,
                  C: int, gen: GenerationConfig,
                  generator: torch.Generator | None = None):
        """``chunk``'s function and results, through the static buffers of
        `cache` (``chunk_graphs``): on the card its CUDA graph replays
        (captured at the first call of its key); on the CPU ``chunk`` runs
        over the same buffers. The results are those buffers: read the
        tokens before the next chunk over this cache at this batch size.
        pos (and a page table) may be host tensors; inputs that are
        already the buffers are not copied."""
        return self.chunk_graphs(cache).run(cache, logits, pos, C, gen,
                                            generator)

    def _note_nans(self, logits: torch.Tensor) -> None:
        if self.debug_nans:
            self.nan_flag.logical_or_(torch.isnan(logits).any())

    def nan_mark(self) -> torch.Tensor | None:
        """With debug_nans, the NaN flag as the work queued so far leaves
        it (a copy, queued behind that work; over a batch group, any
        rank's, so all raise together); else None."""
        if not self.debug_nans:
            return None
        return self.all_rows(self.nan_flag.int()).amax(0, keepdim=True).bool()

    def raise_on_nan(self, mark: torch.Tensor | None, call: str,
                     where: str) -> None:
        """Raise FloatingPointError if `mark` (``nan_mark``) shows a NaN;
        the flag is cleared for the next call."""
        if mark is not None and bool(mark.cpu()):
            self.nan_flag.zero_()
            raise FloatingPointError(
                f"debug_nans: {call}: a NaN in the logits of {where}")

    def _generator(self, gen: GenerationConfig) -> torch.Generator | None:
        if gen.greedy:
            return None
        return self.generator.manual_seed(gen.seed)

    def generate(
        self,
        prompt_tokens: list[int],
        gen: GenerationConfig | None = None,
        stream: Callable[[int], None] | None = None,
    ) -> tuple[list[int], GenStats]:
        """Single-prompt generation (greedy or top-k), with the reference
        loop's semantics: up to n_predict - len(prompt) new tokens, ending
        at EOS (not emitted). Decodes whole chunks of C = min(chunk_size,
        budget) steps (a last chunk's steps past max_ctx write and read
        position max_ctx - 1, and the host drops their tokens), and
        dispatches chunk i + 1 before it reads chunk i back, so the host's
        read and its loop overlap the card's next chunk; at most one chunk
        is wasted at EOS, as in the JAX generate."""
        gen = gen or GenerationConfig()
        stats = GenStats(prompt_tokens=len(prompt_tokens))
        cache = self._cache(1)

        t0 = time.perf_counter()
        logits, lens = self.prefill(cache, [prompt_tokens])
        self._sync()
        stats.prefill_s = time.perf_counter() - t0
        self.raise_on_nan(self.nan_mark(), "generate", "the prefill")

        max_new = max(0, min(gen.n_predict - len(prompt_tokens),
                             self.max_ctx - len(prompt_tokens)))
        if not max_new:
            return [], stats
        C = max(1, min(gen.chunk_size, max_new))
        generator = self._generator(gen)
        pos = torch.tensor([int(lens[0])], dtype=torch.int32, device=self.device)
        readback = _Readback(self.device, C)

        out: list[int] = []
        t_decode = time.perf_counter()
        toks, _, logits, pos = self.run_chunk(cache, logits, pos, C, gen,
                                              generator)
        mark = self.nan_mark()
        stats.decode_steps += C
        while True:
            pending = readback.start(toks[0])
            more = len(out) + C < max_new
            if more:  # queued behind the copy of this chunk's tokens
                toks, _, logits, pos = self.run_chunk(cache, logits, pos, C,
                                                      gen, generator)
                next_mark = self.nan_mark()
                stats.decode_steps += C
            t1 = time.perf_counter()
            chunk = readback.wait(pending)  # one read-back a chunk
            stats.decode_token_times.append(time.perf_counter() - t1)
            self.raise_on_nan(
                mark, "generate",
                f"chunk {len(stats.decode_token_times) - 1}")
            mark = next_mark if more else None
            finished = False
            for t in chunk:
                if t == gen.eos_token:
                    finished = True
                    break
                out.append(t)
                if stream is not None:
                    stream(t)
                if len(out) >= max_new:
                    break
            if finished or not more:
                break

        stats.decode_s = time.perf_counter() - t_decode
        stats.generated_tokens = len(out)
        return out, stats

    def round_graphs(self) -> graphs.RoundGraphs:
        """The speculative rounds' padded cache, buffers and graphs (made
        at first use)."""
        if self._rounds is None:
            self._rounds = graphs.RoundGraphs(self, self._capture)
        return self._rounds

    def generate_speculative(
        self,
        prompt_tokens: list[int],
        gen: GenerationConfig | None = None,
        draft_len: int = 4,
    ) -> tuple[list[int], GenStats]:
        """Greedy generation with n-gram drafts of `draft_len` tokens
        verified draft_len + 1 at a time (runtime/speculative.py), as the
        JAX ``generate_speculative``: the same tokens as ``generate``. The
        loop runs in graphs of R = speculative.ROUNDS verify rounds,
        replayed until a read back of (n_out, done) after a replay shows
        done (on the CPU the rounds run eagerly); each replay is queued
        before the state of the one before it is read, so at most 2R - 1
        rounds run after done. ``stats.decode_token_times`` is [verify
        forwards], as in JAX; ``stats.decode_steps`` counts every round
        the device ran, those after done included. Greedy and monolithic
        only, draft_len below speculative.PAD."""
        gen = gen or GenerationConfig()
        if self.tp > 1:
            raise ValueError("speculative decoding runs at tp=1 (as the "
                             "JAX engine asserts)")
        if not gen.greedy:
            raise ValueError("speculative decoding is greedy-only")
        if self.paged:
            raise ValueError("speculative decoding uses the monolithic cache")
        if not 0 <= draft_len < speculative.PAD:
            raise ValueError(f"draft_len must lie in [0, {speculative.PAD}), "
                             f"not {draft_len}")
        stats = GenStats(prompt_tokens=len(prompt_tokens))
        spec = self.round_graphs()

        t0 = time.perf_counter()
        logits, _ = self.prefill(spec.cache, [prompt_tokens])
        next_tok = int(sampling.greedy(logits)[0])
        stats.prefill_s = time.perf_counter() - t0
        self.raise_on_nan(self.nan_mark(), "generate_speculative", "the prefill")

        max_new = max(0, min(gen.n_predict - len(prompt_tokens),
                             self.max_ctx - len(prompt_tokens)))
        if not max_new or next_tok == gen.eos_token:
            return [], stats
        if max_new == 1:
            stats.generated_tokens = 1
            return [next_tok], stats

        buf = spec.buffers_for(draft_len)
        speculative.start(buf, list(prompt_tokens), next_tok, max_new - 1)
        readback = _Readback(self.device, len(speculative.STATE))
        rounds = speculative.ROUNDS

        def replay():
            """The next `rounds` rounds, then a copy of the state they
            leave (and the NaN flag) queued behind them."""
            spec.run(draft_len, gen.eos_token, rounds)
            stats.decode_steps += rounds
            return readback.start(buf.state), self.nan_mark()

        t1 = time.perf_counter()
        pending = replay()
        while True:
            # replay i + 1 is queued before replay i's state is read, so
            # the host's read and the next launch overlap the device's
            # rounds; a replay after done changes nothing
            queued = replay()
            state = dict(zip(speculative.STATE, readback.wait(pending[0])))
            first = stats.decode_steps - 2 * rounds
            self.raise_on_nan(pending[1], "generate_speculative",
                              f"verify rounds {first}-{first + rounds - 1}")
            if state["done"]:
                break
            pending = queued
        out = [next_tok] + buf.out[: state["n_out"]].tolist()
        stats.decode_s = time.perf_counter() - t1
        stats.generated_tokens = len(out)
        stats.decode_token_times.append(state["n_verify"])
        return out, stats

    def generate_batch(
        self,
        prompts: list[list[int]],
        gen: GenerationConfig | None = None,
    ) -> tuple[list[list[int]], GenStats]:
        """Offline batched generation: all prompts decode in lockstep, in
        whole chunks of chunk_size steps (staged at B > 1), each read back
        before the next is dispatched, as the JAX generate_batch. Row b
        keeps min(n_predict, max_ctx) - len(prompt b) new tokens, cut at
        EOS; a row past its budget or max_ctx decodes padding that the
        host drops (ContinuousBatcher serves requests that arrive over
        time)."""
        gen = gen or GenerationConfig()
        B = len(prompts)
        stats = GenStats(prompt_tokens=sum(len(p) for p in prompts))
        rows = self.batch_rows(B)
        cache = self._cache(B)
        t0 = time.perf_counter()
        logits, lens = self.prefill(cache, prompts)
        self._sync()
        stats.prefill_s = time.perf_counter() - t0
        self.raise_on_nan(self.nan_mark(), "generate_batch", "the prefill")

        budgets = [max(0, min(gen.n_predict, self.max_ctx) - int(n))
                   for n in lens]
        max_new = max(budgets, default=0)
        if not max_new:
            return [[] for _ in range(B)], stats
        C = max(1, min(gen.chunk_size, max_new))
        generator = self._generator(gen)
        pos = torch.from_numpy(lens[rows].astype(np.int32)).to(self.device)

        outs: list[list[int]] = [[] for _ in range(B)]
        finished = [b == 0 for b in budgets]
        t_decode = time.perf_counter()
        emitted = 0
        while emitted < max_new and not all(finished):
            toks, _, logits, pos = self.run_chunk(cache, logits, pos, C, gen,
                                                  generator)
            stats.decode_steps += C
            # one read-back per chunk (every batch rank's rows)
            toks_np = self.all_rows(toks).cpu().numpy()
            self.raise_on_nan(self.nan_mark(), "generate_batch",
                              f"chunk {stats.decode_steps // C - 1}")
            emitted += C
            for b in range(B):
                if finished[b]:
                    continue
                for t in toks_np[b]:
                    t = int(t)
                    if t == gen.eos_token or len(outs[b]) >= budgets[b]:
                        finished[b] = True
                        break
                    outs[b].append(t)

        stats.decode_s = time.perf_counter() - t_decode
        stats.generated_tokens = sum(len(o) for o in outs)
        return outs, stats


class _Readback:
    """A chunk's tokens (or the verify rounds' state) to the host without
    a wait at the copy: two host buffers (pinned on the card) used in
    turn, each copy marked by an event that the reader waits on."""

    def __init__(self, device: torch.device, n: int):
        cuda = device.type == "cuda"
        self.bufs = [torch.empty(n, dtype=torch.int32, pin_memory=cuda)
                     for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self.turn = 0

    def start(self, toks: torch.Tensor) -> int:
        i, self.turn = self.turn, 1 - self.turn
        self.bufs[i].copy_(toks, non_blocking=True)
        if self.events is not None:
            self.events[i].record()
        return i

    def wait(self, i: int) -> list[int]:
        if self.events is not None:
            self.events[i].synchronize()
        return self.bufs[i].tolist()
