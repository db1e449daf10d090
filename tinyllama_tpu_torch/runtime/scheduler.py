"""Continuous batching over one Engine: the counterpart of the JAX
package's runtime/scheduler.py.

* The batcher holds B fixed slots, each at its own position (kept on the
  host and uploaded with each chunk). Its KV cache is of the engine's
  kind: a page pool for ``Engine(paged=True)``, else monolithic.
* Queued requests are admitted in one batched prefill whose batch is
  padded to a power-of-two bucket with BOS-only rows. Monolithic: the
  prefill fills a bucket cache, then the admitted rows are copied into
  their slots (only the admitted rows, so no two writes hit one slot;
  an int8 cache's scale planes with its data).
  Paged: each request reserves its worst-case page count, gets its
  prompt's pages, and is prefilled straight into the pool through an
  admission page table; only its logits row moves.
* Every running slot advances in the engine's decode chunk
  (``Engine.run_chunk``: on the card a replayed CUDA graph), one
  read-back a chunk. The chunk's inputs are written into its static
  buffers (runtime/graphs.py): the slots' positions and, paged, the
  bucket's page table from the host, the admitted rows' logits in place;
  the full-width logits are the buffer itself. The admission prefill is
  queued behind the chunk before the chunk's tokens are read, so the
  host never waits on the card to admit.
* Finished slots park at position 0 (paged: table row 0, the scratch
  page) and their tokens are dropped.
* Paged bucket downshift (``downshift``, on by default for a paged
  batcher whose engine has a batch group of one): when few slots run, the
  chunk runs at the smallest power-of-two bucket that holds them; the
  table rows, pos and logits rows are gathered into the bucket's buffers
  and the logits scattered back, outside the graph. The KV pages never
  move. (A monolithic downshift would move cache rows, so the monolithic
  batcher always runs at full width.)

Over a tensor-parallel engine (``Engine(tp=N)``) the batcher runs on every
rank with the same requests: its pool is made at the rank's local config
(its kv heads), and every host decision follows from tokens that are
bit-equal on all ranks, so the ranks admit, grow, downshift and finish in
lockstep. (The JAX batcher turns its downshift off at tp > 1, where its
batch rows shard over a data axis; at dp = 1 a rank holds every row, so
the downshift stays.)

Over an engine whose batch rows shard over a batch group (``Engine(tp=N,
mesh=make_mesh(N, dp, dcn))``, dcn x dp > 1) the slots shard as the
rows do: rank r of the group holds slots [r * B / n, (r + 1) * B / n)
(``Engine.batch_rows``), decodes them, and the chunk's tokens are
all-gathered (``Engine.all_rows``), so every rank keeps every slot's host
state and decides the same. An admission's bucket is laid out by owner:
each rank's share of it holds the requests bound for its own slots, so no
row moves between ranks, and the share is the smallest power of two that
holds the largest rank's requests (the JAX batcher makes one bucket of
the admitted count and raises where it is smaller than the batch group:
ROADMAP.md, Queue 3, reference fault 11). A downshift would move rows
between ranks: it is off there, and asking for it raises, as JAX's.

Over a sequence-parallel engine (``Engine(sp=N)``) a prompt of at least
``sp_admit_threshold`` tokens (default 1,024 there) is admitted alone, so
its B == 1 prefill takes the engine's sequence-parallel route: an
admission stops just before it, and it goes in the next wave by itself.
Every rank runs the batcher with the same requests, as under tp.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from tinyllama_tpu_torch.config import GenerationConfig
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.kvcache import kv_planes
from tinyllama_tpu_torch.runtime.paged import (
    PageAllocator,
    default_page_size,
    init_paged_cache,
)


@dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new: int
    output: list[int] = field(default_factory=list)
    done: bool = False
    submitted_s: float = 0.0
    first_token_s: float | None = None  # TTFT
    finished_s: float | None = None


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class ContinuousBatcher:
    """Fixed-slot continuous batching over one Engine: `max_batch` slots,
    paged when the engine is (`n_pages` and `page_size` size its pool)."""

    def __init__(
        self,
        engine: Engine,
        gen: GenerationConfig | None = None,
        *,
        max_batch: int,
        n_pages: int | None = None,
        page_size: int | None = None,
        sp_admit_threshold: int | None = None,
        ttft_chunk: int = 0,
        downshift: bool | None = None,
    ):
        paged = engine.paged
        if not paged and (n_pages or page_size):
            raise ValueError("n_pages and page_size size a page pool: build "
                             "the engine with paged=True")
        self.engine = engine
        self.gen = gen or GenerationConfig()
        self.B = max_batch
        #: this rank's slots (every slot at a batch group of one)
        self.rows = engine.batch_rows(max_batch)
        self.b = self.rows.stop - self.rows.start
        if downshift is None:
            downshift = paged and engine.batch == 1
        if downshift and not (paged and engine.batch == 1):
            raise ValueError(
                "bucket downshift requires paged=True and a batch group of one "
                f"rank (this engine's has {engine.batch}): compaction would "
                "move rows between ranks")
        #: paged bucket downshift (see the module's docstring)
        self.downshift = downshift
        #: prompts at least this long are admitted alone, so the engine's
        #: B == 1 sequence-parallel prefill takes them (None: no rule);
        #: on by default over an engine with sp > 1
        if sp_admit_threshold is None and engine.sp > 1:
            sp_admit_threshold = 1024
        self.sp_admit_threshold = sp_admit_threshold
        #: first-token latency dial (0: off): while a running slot has
        #: produced no token yet, the next chunk runs at most this many
        #: steps, so its first token reaches the host sooner, at the cost
        #: of more, shorter chunks
        self.ttft_chunk = ttft_chunk
        #: the batch of the last chunk (this rank's rows)
        self._bucket = self.b
        self._ids = itertools.count()
        self.queue: list[Request] = []
        self.running: list[Request | None] = [None] * self.B
        self.results: dict[int, Request] = {}

        self.paged = paged
        dev = engine.device
        self.pos_np = np.zeros((self.B,), np.int32)
        self.generator = None
        if not self.gen.greedy:
            self.generator = torch.Generator(dev)
            self.generator.manual_seed(self.gen.seed)
        if paged:
            S = engine.max_ctx
            self.P = page_size or default_page_size(S)
            self.J = S // self.P
            n_pages = n_pages or self.B * self.J + 1
            self.pool = init_paged_cache(engine.fwd_cfg, n_pages, self.b,
                                         engine.policy.kv_dtype, S,
                                         page_size=self.P, device=dev)
            self.alloc = PageAllocator(n_pages)
            # physical page 0 is the scratch page: unmapped table entries
            # are 0, so parked and padding rows write there harmlessly
            self.alloc.reserve(1)
            if self.alloc.alloc(1) != [0]:
                raise RuntimeError("the scratch page must be page 0")
            self.table_np = np.zeros((self.B, self.J), np.int32)
            self.slot_pages: list[list[int]] = [[] for _ in range(self.B)]
            self.slot_reserved: list[int] = [0] * self.B
            self.cache = None
        else:
            self.cache = engine.new_cache(self.B)
        #: the chunks' static buffers over this batcher's pool or cache
        self.graphs = engine.chunk_graphs(self.pool if paged else self.cache)
        #: this rank's slots' logits: the full-width chunk's input buffer
        self.logits = self.graphs.buffers_for(self.pool if paged
                                              else self.cache, self.b).logits
        #: monolithic admission caches, one a bucket, reused
        self._admit_caches: dict = {}

    # ------------------------------------------------------------------ API

    def submit(self, prompt: list[int], max_new: int | None = None) -> int:
        req = Request(
            req_id=next(self._ids),
            prompt=list(prompt),
            max_new=max_new if max_new is not None
            else max(1, self.gen.n_predict - len(prompt)),
            submitted_s=time.perf_counter())
        if self.paged:
            # a request the whole pool (less the scratch page) cannot hold
            # would block the head of the queue forever
            need = -(-self._worst_case_tokens(req) // self.P)
            capacity = self.alloc.n_pages - 1
            if need > capacity:
                raise ValueError(
                    f"request needs up to {need} pages but the pool holds "
                    f"{capacity}: shrink prompt/max_new or grow n_pages")
        self.queue.append(req)
        return req.req_id

    def _worst_case_tokens(self, req: Request) -> int:
        """A request's largest context: prompt + budget + one chunk of
        parked overrun, capped at max_ctx."""
        return min(len(req.prompt) + req.max_new + self.gen.chunk_size,
                   self.engine.max_ctx)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.running)

    def run(self, stream: Callable[[int, int], None] | None = None
            ) -> dict[int, Request]:
        """Drive until every submitted request finishes."""
        while self.has_work:
            self.step(stream)
        return self.results

    # ---------------------------------------------------------------- admission

    def _admit_prefill(self):
        """Queue one batched prefill for the queued requests that have a
        free slot; returns the admission, or None."""
        free = [s for s in range(self.B) if self.running[s] is None]
        if not free or not self.queue:
            return None
        if self.paged:
            return self._admit_prefill_paged(free)
        take = self._sp_take(min(len(free), len(self.queue)))
        reqs = [self.queue.pop(0) for _ in range(take)]
        at, prompts = self._layout(free, reqs)
        bucket = len(prompts)
        cache = self._admit_caches.get(bucket)
        if cache is None:
            cache = self._admit_caches[bucket] = self.engine.new_cache(bucket)
        logits, lens = self.engine.prefill(cache, prompts)
        return free, reqs, at, logits, lens, cache

    def _layout(self, free: list[int], reqs: list[Request]):
        """An admission's bucket: request i (bound for slot free[i]) at
        row at[i], and the bucket's prompts (BOS-only rows pad it). Each
        batch rank's share of the bucket holds the requests of its own
        slots in order, then padding; a share is the smallest power of two
        that holds the most any rank takes (at a batch group of one: the
        power of two at least len(reqs), at most B)."""
        ways = self.engine.batch
        owners = [s // self.b for s in free[: len(reqs)]]
        share = min(_pow2_at_least(max(owners.count(r) for r in range(ways))),
                    self.b)
        at, taken = [], [0] * ways
        for r in owners:
            at.append(r * share + taken[r])
            taken[r] += 1
        prompts = [[1]] * (share * ways)
        for i, req in zip(at, reqs):
            prompts[i] = req.prompt
        return at, prompts

    def _long(self, req: Request) -> bool:
        """Whether `req` is admitted alone (the sequence-parallel rule)."""
        return (self.sp_admit_threshold is not None
                and len(req.prompt) >= self.sp_admit_threshold)

    def _sp_take(self, take: int) -> int:
        """An admission of the queue's first `take` requests, cut so that a
        long prompt goes alone: just it when it heads the queue, else the
        requests before it (it goes in the next wave)."""
        for i in range(take):
            if self._long(self.queue[i]):
                return max(1, i)
        return take

    def _admit_prefill_paged(self, free: list[int]):
        """Reserve each request's worst-case pages (so lazy growth never
        fails), allocate its prompt's pages, and prefill into the pool
        through an admission table (whose unmapped entries are the scratch
        page 0). A long prompt (``_long``) goes alone."""
        reqs: list[Request] = []
        needs: list[int] = []
        while self.queue and len(reqs) < len(free):
            long = self._long(self.queue[0])
            if long and reqs:
                break  # it goes alone, in the next wave
            need = -(-self._worst_case_tokens(self.queue[0]) // self.P)
            if not self.alloc.can_reserve(need):
                break  # FIFO admission: wait for pages to free
            self.alloc.reserve(need)
            reqs.append(self.queue.pop(0))
            needs.append(need)
            if long:
                break  # B == 1: the engine's sequence-parallel prefill
        if not reqs:
            return None
        at, prompts = self._layout(free, reqs)
        adm_table = np.zeros((len(prompts), self.J), np.int32)
        pages_list: list[list[int]] = []
        for i, req in zip(at, reqs):
            pages = self.alloc.alloc(max(1, -(-len(req.prompt) // self.P)))
            adm_table[i, : len(pages)] = pages
            pages_list.append(pages)
        logits, lens = self.engine.prefill(self.pool.with_table(
            adm_table[self.engine.batch_rows(len(prompts))]), prompts)
        return free, reqs, at, logits, lens, (needs, pages_list)

    def _insert_admitted(self, admitted) -> None:
        """Put the admitted requests in their slots: the logits row (and,
        monolithic, the cache row) of each admitted request only, each on
        the rank that holds its slot (its bucket row is there too)."""
        free, reqs, at, logits, lens, extra = admitted
        first = self.engine.batch_rank * logits.shape[0]  # this rank's share
        mine, src = [], []
        for i, (slot, req) in enumerate(zip(free, reqs)):
            self.pos_np[slot] = int(lens[at[i]])
            self.running[slot] = req
            if self.paged:
                needs, pages_list = extra
                self.slot_pages[slot] = pages_list[i]
                self.slot_reserved[slot] = needs[i]
                self.table_np[slot, :] = 0
                self.table_np[slot, : len(pages_list[i])] = pages_list[i]
            if self.rows.start <= slot < self.rows.stop:
                mine.append(slot - self.rows.start)
                src.append(at[i] - first)
        if not mine:
            return
        dev = self.logits.device
        idx = torch.tensor(mine, dtype=torch.long, device=dev)
        src_idx = torch.tensor(src, dtype=torch.long, device=dev)
        self.logits.index_copy_(0, idx, logits.index_select(0, src_idx))
        if not self.paged:  # data and, int8, scale planes
            for plane, rows in zip(kv_planes(self.cache), kv_planes(extra)):
                plane.index_copy_(1, idx, rows.index_select(1, src_idx))

    # ------------------------------------------------------------------ decode

    def _grow_pages(self, C: int) -> None:
        """Map pages covering the next C positions of every running slot
        (always within the slot's reservation)."""
        for slot, req in enumerate(self.running):
            if req is None:
                continue
            need = min(-(-(int(self.pos_np[slot]) + C) // self.P), self.J)
            have = len(self.slot_pages[slot])
            if need > have:
                new = self.alloc.alloc(need - have)
                self.slot_pages[slot].extend(new)
                self.table_np[slot, have:need] = new

    def _chunk_len(self) -> int:
        """chunk_size, cut to the largest remaining budget (rounded up to a
        power of two), and to ttft_chunk while a running slot waits for
        its first token."""
        C = max(1, self.gen.chunk_size)
        rem = [r.max_new - len(r.output) for r in self.running if r is not None]
        if rem:
            C = min(C, _pow2_at_least(max(max(rem), 1)))
        if self.ttft_chunk and any(r is not None and not r.output
                                   for r in self.running):
            C = max(1, min(C, self.ttft_chunk))
        return C

    def step(self, stream: Callable[[int, int], None] | None = None) -> None:
        """Decode one chunk for every running slot, admit queued requests
        behind it, then put the admitted rows in place for the next
        chunk."""
        C = self._chunk_len()
        was_running = [r is not None for r in self.running]
        idx = None  # bucket row -> slot (None: every slot, in order)
        in_flight = None
        if any(was_running):
            pos_in = self.pos_np[self.rows]
            store = self.pool if self.paged else self.cache
            if self.paged:
                self._grow_pages(C)
                table = self.table_np[self.rows]
            if self.downshift:
                # the smallest power-of-two bucket holding the running slots
                self._bucket = min(_pow2_at_least(sum(was_running)), self.B)
                if self._bucket < self.B:
                    active = [s for s, w in enumerate(was_running) if w]
                    parked = [s for s, w in enumerate(was_running) if not w]
                    idx = np.asarray(active + parked[: self._bucket - len(active)])
                    table, pos_in = table[idx], pos_in[idx]
                    idx_dev = torch.from_numpy(idx).to(self.logits.device)
            buf = self.graphs.buffers_for(store, self._bucket)
            buf.pos.copy_(torch.from_numpy(pos_in.astype(np.int32)))
            if self.paged:
                buf.table.copy_(torch.from_numpy(table))
                store = store.with_table(buf.table)
            if idx is not None:
                torch.index_select(self.logits, 0, idx_dev, out=buf.logits)
            in_flight = self.engine.run_chunk(store, buf.logits, buf.pos, C,
                                              self.gen, self.generator)
        admitted = self._admit_prefill()
        if in_flight is None:
            if admitted is not None:
                self._insert_admitted(admitted)
            return

        toks, _, logits_out, _ = in_flight
        if idx is not None:
            self.logits.index_copy_(0, idx_dev, logits_out)
        elif logits_out is not self.logits:  # the eager Engine.chunk's own
            self.logits.copy_(logits_out)
        # one read-back a chunk (every batch rank's slots)
        toks_np = self.engine.all_rows(toks).cpu().numpy()
        self.engine.raise_on_nan(self.engine.nan_mark(), "ContinuousBatcher",
                                 "a chunk or an admission")
        now = time.perf_counter()
        for slot, was in enumerate(was_running):
            if was:
                self.pos_np[slot] += C

        max_ctx = self.engine.max_ctx
        rows = range(self.B) if idx is None else (int(s) for s in idx)
        for slot, t_row in zip(rows, toks_np):
            req = self.running[slot]
            if req is None:
                continue
            for t in t_row:
                t = int(t)
                if t == self.gen.eos_token:
                    self._finish(slot, req, now)
                    break
                req.output.append(t)
                if req.first_token_s is None:
                    req.first_token_s = now
                if stream is not None:
                    stream(req.req_id, t)
                if (len(req.output) >= req.max_new
                        or len(req.prompt) + len(req.output) >= max_ctx - C):
                    self._finish(slot, req, now)
                    break

        if admitted is not None:
            self._insert_admitted(admitted)

    def _finish(self, slot: int, req: Request, now: float) -> None:
        req.done = True
        req.finished_s = now
        self.results[req.req_id] = req
        self.running[slot] = None
        # park at position 0: a parked row writes and attends one scratch
        # position, and its pos never creeps past max_ctx
        self.pos_np[slot] = 0
        if self.paged:
            # release pages and reservation; table row 0 = scratch page
            self.alloc.release(self.slot_pages[slot], self.slot_reserved[slot])
            self.slot_pages[slot] = []
            self.slot_reserved[slot] = 0
            self.table_np[slot, :] = 0
