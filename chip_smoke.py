#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tinyllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on one card, and fails (exit code not
0, no result line) without a CUDA device or without the port beside it.
Phases, each fatal on failure:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel from tinyllama_tpu_torch/csrc, one nvcc each, all
   at once, into build/kernels;
3. kernels: each kernel against its plain PyTorch version on the card,
   in bf16, at TinyLlama-1.1B's shapes (K1 on the five decode matmuls,
   K2 at M=128, 512, 2048 and 8192 (q8; q4 and q4g to 2048 after (i)),
   K3 at T=32, 128, 512 and 2048 and at B=32, T=256 (an admission of (f)),
   K4 at pos 127, 1500 and 2047
   and at B=4 (path (c)'s batch) at pos 1500, K4 and K10 also captured in
   a CUDA graph at pos 127 and replayed at 1500, 5 and 2047, K5 at M=1, 4, 32, K6 at
   M=4, 32, K7 at M=1, 4, 32 and its plain entry at M=1, K8 at pos 127
   and 1500 (and captured at 127, replayed at 1500, 448, 5 and 2047), K9 at B=8 over a fill of 256 and a 32-slot staged tail, K10
   at pos 127, 1500 and 2047, K11 at B=32 over a fill of 256 and a
   32-slot tail and at B=32 over path (f)'s first 32 prompt lengths
   (8-200 keys a row, seed 5) and a 32-slot tail, its library call SDPA
   under a key mask), with its time, its bound, the plain
   version's time and a PyTorch library call's time (for attention, SDPA
   with enable_gqa over the same un-repeated keys); K7 and K8 must give
   their eager result again when replayed from a CUDA graph; then the
   int8-KV instantiations of K3, K4, K8-K11 at the same shapes over
   int8 caches (the same random values quantized; their bound counts
   int8 data and f32 scales, their yardstick is SDPA over the
   dequantized bf16 K/V); K1's aq8 branch on the five decode matmuls at
   M = 1 (its yardsticks torch.matmul on the dequantized bf16 weight and
   torch._int_mm where it takes the shape); and the f16 and f32
   instantiations of K3, K4, K8-K11 over the same values cast (bound at 2
   and 4 bytes a value, yardstick SDPA over the cache cast to bf16);
   then the microbench's entry point (tinyllama_tpu_torch.tools.kbench:
   P1-P4, KF, KI, KS), which holds each of its kernels against the plain
   version before it times it, with its launch counts read around it;
4. paths: TinyLlama-1.1B, q8 weights from a fixed seed ((a)-(g), (j)-(l)),
   then q4 and q4g weights from a file ((h), (i)), bf16 activations, a
   bf16 cache except in (j), (l) and (h)'s --kv runs; the launch counts
   of every kernel (the instantiations of other cache kinds, and K1's aq8
   branch, counted apart) are set to 0 just before each path and must
   come out exactly as the path dictates:
   (a) main path: a 100-token prompt (bucket 128, unfused prefill)
       through Engine.generate, greedy, 256 new tokens, each decode step
       on the fused branch (K5, K8, K7, then K1 for the lm_head);
   (b) chat-length prompt: 24 tokens (bucket 32, fused prefill: K5, K3,
       K6, K7) through Engine.generate, 32 greedy tokens;
   (c) batched decode: Engine.prefill of 4 100-token prompts, then 8
       Engine.decode_step calls at B = 4 (K5, K4, K6, K7), and one step
       replayed as a CUDA graph;
   (d) Engine.generate_batch, monolithic: 4 prompts of 100 tokens, 64
       greedy tokens each in two staged 32-step chunks (K5, K9, K6, K7);
   (e) Engine(paged=True).generate: a 100-token prompt with 64 new
       tokens and a 24-token one with 16 (its prefill attends a 32-key
       temporary cache, padded to 64), each step K5, K10, K6, K7, no K8;
       then a 1,450-token prompt (bucket 2,048: its prefill ms printed)
       with 64 new tokens, and one step at pos 1500 replayed as a CUDA
       graph (the long-context b1 step);
   (f) ContinuousBatcher(Engine(paged=True), max_batch=32): 64
       requests, prompts of 8-200 tokens and 32-96 new tokens from a
       fixed seed, chunk 32;
       every chunk stages over the pool (K11) or, at a bucket of 1, runs
       K10; the counts follow from each chunk's batch and length and each
       admission's shape, recorded by wrapping the engine's methods; it
       prints aggregate tok/s, TTFT p50/p95 and the wall time; then one
       admission at full width, its first 32 prompts prefilled into a
       page pool at once (bucket 256, M = 8,192 through K2), three times
       on the host clock, each with its launch counts;
   (g) ContinuousBatcher(Engine(), max_batch=8): 16 requests through
       the monolithic admission and K9;
   then, for (f) and (g), one full-width staged step at a 100-token
   fill, eager on the host clock against its CUDA-graph replay (the
   device's busy share of an eager step);
   (h) 4-bit weights from a file through the CLI: a full-depth q4 .gten
       of random N(0, 0.02) weights (written one tensor at a time) and a
       stand-in tokenizer.bin of 32,000 pieces go to a temporary
       directory, written by a child process (this script with
       --write-checkpoint) that starts before the build; cli.main(["-q4", "--ckpt", ..., "--tokenizer", ...,
       "-p", P, "-greedy", "--npred", "256"]) runs it (P is 105 tokens in
       the chat template: the unfused prefill, then fused b1 decode K5,
       K8, K7 and K1 until the tokenizer's EOS or the budget), then the
       same file with -q4g (requantized at load); each prints its load
       seconds, prefill ms and ms/token, and one decode step replayed as a
       CUDA graph;
   (i) on each engine of (h): a 24-token prompt with 32 greedy tokens
       (K5, K3, K6, K7), and 8 decode steps at B = 4 (K5, K4, K6, K7);
       then the same file through cli.main with "-q4 --kv i8" (q4-kvi8);
   (j) the int8 KV cache, POLICIES["q8-kvi8"] on (a)'s weights, run
       before (h): (a)'s prompt with 64 greedy tokens (K2, int8 K3, then
       K5, int8 K8, K7, K1) and its step replayed as a CUDA graph; (c) at
       B = 4 (int8 K4); (d)'s generate_batch for one 32-step chunk (int8
       K9); a paged generate of 100 + 32 tokens (int8 K3 over the
       prompt's own quantized keys, then int8 K10); (f)'s and (g)'s
       requests through paged and monolithic batchers (int8 K11, K10 at
       bucket 1, K9), each printed beside the bf16 run's tok/s, TTFT and
       KV pool bytes;
   (k) aq8 activations, POLICIES["q8a8"] on (a)'s weights (every block
       unfused, K1's aq8 branch at M <= 8, K4 for b1 attention): (a)'s
       prompt with 64 greedy tokens and its step replayed as a CUDA graph,
       then (e)'s 1,450-token prompt with 64 tokens and a graph-replayed
       step at pos 1500,
       (c) at B = 4, a paged generate of 100 + 32 tokens, and (g)'s
       requests through the monolithic batcher; then POLICIES["q4a8"] on
       (h)'s q4 weights: (b) and (c);
   (l) f16 and then f32 KV caches on (a)'s weights: (a)'s prompt with 64
       tokens (K3, K8) and its graph step, (c) (K4), (d) for one chunk
       (K9), a paged generate (K10; its prefill attends the step's own
       bf16 keys), and (K11) for f16 (f)'s requests through the paged
       batcher, with the pool bytes beside bf16's, for f32 one staged
       chunk of a paged generate_batch; then the CLI on (h)'s file with
       -q4 --kv f16;
   (m) the HTTP server and the router (run before (h), on (a)'s q8
       weights and (h)'s stand-in tokenizer): runtime.server.serve over
       Engine(paged=True) with 8 slots on an ephemeral port, 16 text
       requests of 32 greedy tokens from 8 client threads, half streamed
       (each streamed piece the tokenizer's, the stream closed by [DONE]),
       its requests a second, client TTFT p50 / p95 and wall time, exact
       launch counts (K2 or K5 at admission, K3, K11 or K10, K6, K7, K1,
       no K8); one request alone against ContinuousBatcher.run's tokens;
       runtime.router.serve_router over two such servers (each its own
       engine on the card), one stopped, /healthz showing it down, every
       later request answered; then (f)'s requests with ttft_chunk=16
       beside (f)'s tok/s and TTFT;
   (n) dense weights, which launch no kernel (the JAX package runs them
       without Pallas): cli.main with -f16, --bf16 and --f32 and
       --random-weights on the CLI prompt with 64 new tokens, then under
       f16 (a)'s prompt through Engine.generate, a paged generate and (g)'s
       requests through the monolithic batcher; every counter must read 0,
       each run prints its ms/token;
   after each kind's (h) and (i), that kind's weight kernels (K1, K2 at
   M = 128, 512 and 2048, K5-K8) against their plain versions, as in phase 3, with
   the launches of (h) and (i), and K1-aq8's q4 rows;
   every decode chunk of these paths goes through Engine.run_chunk, a CUDA
   graph of Engine.chunk captured at its first use and replayed after
   (runtime/graphs.py); the counts read the chunks through run_chunk, so a
   replay counts its captured launches. For comparison the entry points
   run again with the eager Engine.chunk (eager_chunks): (a), (e), (j),
   (k), (l) and (n)'s b1 generate (the same ids and counts; ms/token
   each, and the device's ms a step over replayed chunks), (h)'s q4 CLI,
   (f)'s and (g)'s requests (the batchers' first pass captures, the
   measured pass replays and gives the first pass's tokens, the eager
   pass the same tokens) and (m)'s 16 HTTP requests; each path prints
   the graphs it captured, their seconds and torch.cuda.memory_reserved;
   and for (a), (d), (e), (f), (j), (l) and (n), two chained 32-step
   chunks from one prefill, eager and through run_chunk's capture and
   replays over a cache prefilled again, must be torch.equal (tokens and
   logits); on (a) also with top-k from one seed;
5. parity: a 2-layer model at TinyLlama's full widths, the same weights
   on the card (kernels) and the CPU (plain versions): a long prefill
   and 4 teacher-forced decode steps, a short (fused) prefill, a B = 4
   decode step, a staged monolithic and a staged paged chunk step at
   B = 4, and a paged b1 step (K10); then the same widths with q4 and
   with q4g weights: a long and a short prefill, 2 b1 decode steps and a
   B = 4 step; and q8 weights with an int8 KV cache: a long prefill, 2
   b1 steps, a B = 4 step, staged monolithic and paged chunk steps and a
   paged b1 step; q8a8 and q4a8: a long prefill, 2 b1 steps and a B = 4
   step; f16 and f32 caches: a long prefill, 2 b1 steps and a staged
   paged chunk step; dense f16, bf16 and f32 weights through an fp16
   .gten the port writes and loads: a long and a short prefill, 2 b1
   steps and a B = 4 step (the plain path on both sides, f32 within 1e-3
   of max |logits|); the logits must agree (the CPU's traces run in
   threads in the background while the card's go on). Then a reading: 48
   greedy b1 steps with an int8 cache on the card, the CPU fed the card's
   tokens, and how often its own pick is the card's.
6. path (o), Llama-3-8B (head dim 128, G = 4, 32 layers, n_embd 4,096,
   max_ctx 8,192) at full width and depth on random weights made on the
   card, after TinyLlama's phases (the helpers of phase 4 read its config
   from there on; its blocks take the unfused branch, n_embd > 2,048): the
   d = 128 kernel rows (phase_attention_d128: K3, K4, K9-K11 at Llama-3's
   heads over every KV kind, S = 8,192, K3 at G = 4 and 8); (o1) q4 b1, a
   1,000-token prompt and 128 tokens, graph and eager, a profiler window,
   then q8 and q4g (100 + 64); (o2) a 7,000-token prompt through a paged
   engine (K3 at T = 8,192), 64 tokens and a graph step at pos 7,000;
   (o3) generate_batch of 4 prompts (K9) and a paged ContinuousBatcher of
   16 slots over 32 requests (prompts 64-2,048, seed 7: K11, K3 at
   admission); (o4) q4-kvi8 b1 and an 8-request int8 admission, then
   int8, f16 and f32 caches through K3, K4, K9, K10 and K11 (eager
   chunks); (o5) cli.main --model llama-3-8b -q4 --random-weights; exact
   launch counts throughout; then logits parity at 2 layers: 8B q8, q4,
   q4g, q4-kvi8 (long prefill, b1, B = 4, a staged paged chunk step) and
   70B q4 (G = 8: a prefill and 2 b1 steps), the CPU's traces in threads;
   inside (o1), (p5): generate_speculative with k = 4 on its q4 engine (a
   100-token prompt, 64 tokens: the unfused branch, K1 at M = 5 for every
   linear and the lm_head, K3 at d = 128 from pos > 0), ms/token beside
   (o1)'s;
7. path (p), speculative decoding (Engine.generate_speculative: n-gram
   drafts verified k + 1 = 5 at a time, R verify rounds a CUDA graph
   replay) on TinyLlama q8 from (a)'s seed, after (o): the verify round's
   kernels against their plain versions (K3 at T = 5, G = 8 over S =
   2,048 + 128 from pos 127, 1,500 and 2,170, captured at 127 and
   replayed at the others, its library call SDPA under an offset causal
   mask; K5, K6, K7 and the lm_head's K1 at M = 5); (p1) (a)'s prompt and
   a 100-token prompt repeating a 20-token phrase, 256 tokens each with
   exact counts (the prefill's K2 and K3; K5, K3, K6, K7 a layer and K1
   once a round, the rounds after done included): tokens a verify,
   ms/token beside (a)'s generate, the device's busy share, the capture,
   the tokens each verify gave, the prefix shared with generate (printed,
   not asserted at bf16), and ms/token at R = 1, 2, 4 and 8; (p2) 16
   replays of the rounds' graph torch.equal to the same rounds run
   eagerly from one saved state, through done; (p3) dense f32 weights
   (no kernel): generate_speculative equal to generate for two prompts x
   64 tokens at k = 1 and 4, and the whole budget at the context limit
   (max_ctx 256, a 200-token prompt, 56 tokens); a differing token prints
   its logit margin and fails; (p4) cli.main -q8 --random-weights -greedy
   --spec 4 --profile DIR --debug-nans in a process of its own, as a user
   runs the CLI (it prints its ids, rounds and launch counts back): the
   speculative line and the profile table printed, its exact launch
   counts, each port kernel's events in the trace equal to what those
   counts stand for (a mismatch prints where the events differ), the
   same ids as cli.main without --debug-nans in this process.
8. path (q), tensor parallelism (parallel/mesh.py, parallel/tp.py,
   Engine(tp=N)), after (p): first K1-K4 and K9-K11 at a TP rank's local
   widths against their plain versions (phase_tp_rows: TinyLlama at tp 2
   and 4, one kv head a rank at 4; at tp 2 also q4g K1 / K2, the ring's
   chunks and K3 / K4 over int8; Llama-3-8B q4 at tp 2: K2, K3); then a
   pool of 4 rank processes (ranks sharing one card run gloo, the chunk
   eagerly; with a card a rank, NCCL and the chunk a graph; the kernels
   are built before the ranks start, so they only load them), each
   rank's weights drawn on the card from the tp = 1 engine's seed and
   kept in host memory (building the engine may take the card no more
   than the rank's shard and one lm_head), every step's launch counts
   exact on every rank and the same on all, its outputs bit-equal
   across ranks: (q1) TinyLlama q8, bf16 KV, full width and depth, at
   tp 2 and 4: the prefill's logits of (a)'s length against the tp = 1
   engine (within PARITY_REL of max |logits|), 64 greedy tokens at tp 2
   and 16 at tp 4 (ms/token beside tp = 1 graph and eager; tp 4's gloo
   steps take seconds on a busy host), generate_batch of 4 x 100
   + 8 (K9), one all-reduce of a row timed (its share of a token, an
   estimate); (q4), (q5) a paged engine: generate of 16 tokens
   (K10), generate_batch (K11) and a batcher of 8 slots over 8 requests
   of 8 tokens; (q2) q4g at tp 2 (parity, 16 tokens), and at tp 4
   refused on every rank (a JAX pack group split); (q3) an int8 cache at
   tp 2 (32 tokens); (q6) --tp-overlap at tp 2 (the ring: its prefill
   against tp = 1, wo and w_down launched in 2 chunks); (q8) Llama-3-8B
   q4, full width,
   4 layers, tp 2: prefill parity; (q7) `python -m tinyllama_tpu_torch.cli
   --tp 2 -q8 --random-weights -greedy -p hi --npred 32` as a child (29
   ids, one table); (q9) NCCL: (q1)-(q8) ran it where the machine has 4
   cards or more, tp 2 runs here on 2 or 3, else a line says it did not
   run.
9. path (r), sequence parallelism (parallel/ring.py, parallel/sp.py,
   Engine(sp=N)), after (q): first K2 at an SP rank's Tl rows on the four
   linears (TinyLlama q8 at sp 2 and 4 over (e)'s 1,450-token prompt,
   Llama-3-8B q4 at sp 2 over a 7,000-token one) and K1 on the lm_head
   against their plain versions (phase_sp_rows), and the ring's hop (one
   _block_update, PyTorch) timed beside K3 and SDPA over the same causal
   keys; then a pool of 4 rank processes sharing the card through gloo
   (the chunk a CUDA graph at tp 1), each rank's weights drawn on the card
   from the sp = 1 engine's seed, every step's launch counts exact on
   every rank (an SP prefill: the four linears at Tl rows a layer, K1 for
   the lm_head, no K3) and the same on all, its outputs bit-equal across
   ranks: (r1) TinyLlama q8, bf16 KV, full width and depth, at sp 2 and
   4: the prefill's logits and handed-off cache of (e)'s prompt against
   the sp = 1 engine's (within PARITY_REL of max |.|), 64 greedy tokens,
   the prefill's ms beside sp = 1 and (at sp 2) the share of the ring's
   hops, the K/V gather and the cache writes in it; (r2) a paged engine with an
   int8 cache (q8-kvi8), the same checks and 16 tokens; (r3) the batcher
   over Engine(sp=2), paged and monolithic: 8 short requests and 2 of
   1,100 and 1,300 tokens, 16 tokens each, the long ones admitted alone
   through the SP route; (r4) sp 2 x tp 2 on 4 ranks: prefill parity
   against sp = 1, tp = 1; (r5) Llama-3-8B q4, full width and depth, sp
   2: a 7,000-token prompt through a paged engine, parity, 16 tokens, the
   card's peak in the prefill a rank and sp = 1's; (r6) `python -m tinyllama_tpu_torch.cli --sp 2 -q8
   --random-weights -greedy` on a 1,100-character prompt as a child (99
   ids, one table); (r7) NCCL, a card a rank, where the machine has 2
   cards or more, else a line says it did not run.
10. path (s), data-parallel batch rows (Engine(tp=2, mesh=make_mesh(2,
   2)): rows over the mesh's batch group, parallel/mesh.py), after (r)
   in the same pool: first K1, K2, K3 and K9 at a dp 2 x tp 2 rank's 2
   rows and local widths (K1 at M = 2, K2 at M = 256, K3 at B = 2), K3
   and K11 over an int8 pool at 2 rows and K10 at a dcn 2 x tp 2 rank's
   one row, against their plain versions (phase_tp_rows, DP_ROWS); then
   TinyLlama q8 at full width and depth, each rank's engine and a dp 1 x
   tp 2 engine over its model group alone (Mesh.model_mesh), every
   step's launch counts exactly what the rank's own rows dictate, a
   model group's ranks bit-equal: (s1) dp 2 x tp 2, generate_batch of 4
   prompts of 100 tokens, 32 greedy tokens: each model group's rows
   bit-equal in tokens and prefill logits to the dp 1 x tp 2 engine on
   its 2 rows alone, every row's logits within PARITY_REL of tp 1, every
   rank returning every row, and top-k over two prompts, each in a row
   of both batch ranks, drawing apart; (s2) the same paged with an int8
   cache, and a rank's pool bytes; (s3) the monolithic batcher over dp 2
   x tp 2, 6 requests into 4 slots, 16 tokens each; (s4) a (dcn 2, data
   1, model 2) mesh's paged generate_batch of 2 rows at 2 layers, held
   as (s1); the ms a decode step and each rank's peak.

Prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds, after path (a), a torch.profiler window over a few eager decode
steps of the main path: kernels launched a step, device time by kernel,
the port's kernels' share of it, and the host's time a step.

    python3 chip_smoke.py --tp-only

builds the kernels and runs path (q) alone, with its kernel rows: on a
machine of 4 cards or more its pool's ranks take a card each and run
NCCL, the chunk a captured CUDA graph.

    python3 chip_smoke.py --sp-only

builds the kernels and runs path (r) alone, with its kernel rows.

    python3 chip_smoke.py --dp-only

builds the kernels and runs path (s) alone, with its kernel rows: on a
machine of 4 cards or more its ranks take a card each and run NCCL, the
chunk a captured CUDA graph.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import functools
import gc
import http.client
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
#: bf16 tensor-core FLOP/s. bound_ms = max(bytes / BW, flops / PEAK).
HBM_BW = 3.35e12
PEAK_BF16 = 989e12

#: kernel vs plain version, both bf16 on the card: the JAX suite's own
#: tolerance for bf16 kernels (tests/test_tpu_kernels.py).
RTOL, ATOL = 2e-2, 5e-3

#: logits of the card (kernels) vs the CPU (plain versions), bf16
#: activations: the two paths round to bf16 at different points (f32
#: accumulation order inside the kernels, probabilities rounded before
#: or after normalization), each worth ~2^-8 relative, over ~10 rounding
#: sites a layer. Logits here have |max| ~4: allow 5% of it.
PARITY_REL = 0.05
#: greedy b1 steps of the int8 cache's token reading after the parity
GREEDY_STEPS = 48

N_NEW = 256
PROMPT_LEN = 100
#: the long-context b1 steps of (e) and (k): a prompt of LONG_PROMPT
#: tokens, 64 new ones, and one step at pos LONG_POS replayed as a graph
LONG_PROMPT, LONG_POS = 1450, 1500
#: path (b): a chat-length prompt (bucket 32, fused prefill)
CHAT_LEN, CHAT_NEW = 24, 32
#: the attention kernels' launch counters; with an int8, f16 or f32 cache
#: they count under "<name>_i8", "_f16" or "_f32"
ATTENTION = ("flash_prefill", "flash_decode_heads", "flash_staged",
             "fused_attn_out", "flash_paged", "flash_paged_staged")
#: the counter suffix of each policy label's KV cache
KV_SUFFIX = {"kvi8": "_i8", "kvf16": "_f16", "kvf32": "_f32"}
#: path (c): rows and decode steps of the batched decode
BATCH, BATCH_STEPS = 4, 8
#: path (f)'s slots: one admission prefills this many prompts at once
ADMIT = 32
#: path (h): the chat prompt (105 tokens in the chat template over the
#: stand-in vocab: bucket 128, the unfused prefill) and --npred
CLI_PROMPT = ("Give three tips for staying healthier, and explain for each "
              "one why it helps, what it costs in time and money, and how a "
              "busy person can start on it this week.")
CLI_NPRED = 256
#: path (m): the server's slots, its requests, the client threads that
#: send them and each request's new tokens
SERVE_SLOTS, SERVE_REQUESTS, SERVE_CLIENTS, SERVE_NEW = 8, 16, 8, 32
#: path (n): new tokens a dense run generates after the CLI prompt
DENSE_NEW = 64
#: the dense f32 path's logits, card against CPU: f32 products without
#: TF32 on both, so only the order of the f32 sums differs
F32_PARITY_REL = 1e-3


def counter_name(name: str, label: str) -> str:
    """The launch counter of kernel `name` on a path of policy `label`
    ("q8", "q4-kvi8", "q8-kvf16", "q8a8", ...): attention counters take
    the cache's suffix; "flash_prefill_own" (a paged prefill's K3 over the
    step's own keys, int8 when the pool is, bf16 otherwise) is
    flash_prefill or flash_prefill_i8; K1 counts its aq8 branch apart."""
    kv = label.split("-")[-1]
    if name == "flash_prefill_own":
        return "flash_prefill" + ("_i8" if kv == "kvi8" else "")
    if name in ATTENTION:
        return name + KV_SUFFIX.get(kv, "")
    if name == "qmm_smallm" and label.endswith("a8"):
        return "qmm_smallm_aq8"
    return name


class RandomWeights(Mapping):
    """HF-named weights of `cfg`, made when looked up: N(0, 0.02) f32 from
    (seed, the name's index) for the matrices, ones for the norms. Writing
    a full-depth .gten from it holds one tensor at a time."""

    def __init__(self, cfg, seed: int):
        D, kv, F, V = cfg.n_embd, cfg.kv_dim, cfg.n_ffn, cfg.n_vocab
        block = {"self_attn.q_proj.weight": (D, D),
                 "self_attn.k_proj.weight": (kv, D),
                 "self_attn.v_proj.weight": (kv, D),
                 "self_attn.o_proj.weight": (D, D),
                 "mlp.gate_proj.weight": (F, D), "mlp.up_proj.weight": (F, D),
                 "mlp.down_proj.weight": (D, F),
                 "input_layernorm.weight": (D,),
                 "post_attention_layernorm.weight": (D,)}
        self.shapes = {"model.embed_tokens.weight": (V, D),
                       "model.norm.weight": (D,), "lm_head.weight": (V, D)}
        for i in range(cfg.n_layers):
            for suffix, shape in block.items():
                self.shapes[f"model.layers.{i}.{suffix}"] = shape
        self.index = {name: i for i, name in enumerate(self.shapes)}
        self.seed = seed

    def __getitem__(self, name):
        import numpy as np

        shape = self.shapes[name]
        if len(shape) == 1:
            return np.ones(shape, np.float32)
        rng = np.random.default_rng([self.seed, self.index[name]])
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self):
        return len(self.shapes)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def start_server(httpd) -> int:
    """Serve `httpd` from a daemon thread; returns its port."""
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def http_generate(port: int, payload: dict, tokenizer,
                  timeout: float = 300.0) -> tuple[list[int], float]:
    """POST /generate; returns (tokens, TTFT in s): for a streamed request
    its tokens up to the closing [DONE] (raising if it does not come, or
    if a piece is not the tokenizer's) and the client's time to the first
    one; else the body's tokens and the server's ttft_ms."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/generate", json.dumps(payload),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    if r.status != 200:
        raise AssertionError(f"POST /generate on :{port}: HTTP {r.status}")
    if not payload.get("stream"):
        body = json.loads(r.read())
        return body["tokens"], body["ttft_ms"] / 1e3
    toks, ttft, prev = [], None, 1
    while line := r.readline():
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):].strip()
        if data == b"[DONE]":
            return toks, ttft
        ttft = ttft if ttft is not None else time.perf_counter() - t0
        event = json.loads(data)
        if event["piece"] != tokenizer.decode(prev, event["token"]).decode(
                "utf-8", "replace"):
            raise AssertionError(f"a streamed piece is not token "
                                 f"{event['token']}'s")
        toks.append(prev := event["token"])
    raise AssertionError(f"a stream from :{port} ended without [DONE]")


def http_health(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/healthz")
    return json.loads(conn.getresponse().read())


def replay_equals(name: str, fn) -> None:
    """fn() captured in a CUDA graph and replayed twice must give its
    eager result (K7's and K8's dependent launches and cluster sums,
    K8's merge tickets)."""
    import torch

    from tinyllama_tpu_torch.runtime.graphs import capturing

    eager = fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with capturing(g):
        out = fn()
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            raise AssertionError(f"{name}: graph replay differs from eager")


def replay_at(name: str, fn, pos, capture_at: int, positions) -> None:
    """fn() captured in a CUDA graph with pos (a device tensor it reads)
    at capture_at, then replayed with pos written in place at each of
    `positions`, must give what an eager call gives there: what the key
    walk is split into may not follow the position it was captured at.
    pos is restored after."""
    import torch

    from tinyllama_tpu_torch.runtime.graphs import capturing

    keep = pos.clone()
    pos.fill_(capture_at)
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with capturing(g):
        out = fn()
    for p in positions:
        pos.fill_(p)
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, fn()):
            raise AssertionError(f"{name}: graph captured at pos {capture_at} "
                                 f"and replayed at pos {p} differs from eager")
    pos.copy_(keep)
    print(f"replay {name}: captured at pos {capture_at}, replayed at pos "
          f"{', '.join(map(str, positions))}: equal to eager", flush=True)


def check_close(name: str, got, want) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= ATOL + RTOL * want.abs()).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {err}")
    return err


#: each kernel row's launch counters (a row's launches: their sum on the
#: paths of its kind)
LAUNCH_NAMES = {"K1 qmm_smallm": ["qmm_smallm"], "K2 qmm_bigm": ["qmm_bigm"],
                "K3 flash_prefill": ["flash_prefill"],
                "K4 flash_decode_heads": ["flash_decode_heads"],
                "K5 fused_norm_qkv": ["fused_norm_qkv"],
                "K6 fused_out_residual": ["fused_out_residual"],
                "K7 ffn_fused": ["ffn_fused_normed", "ffn_fused"],
                "K8 fused_attn_out": ["fused_attn_out"],
                "K9 flash_staged": ["flash_staged"],
                "K10 flash_paged": ["flash_paged"],
                "K11 flash_paged_staged": ["flash_paged_staged"]}


#: the TPU kernel bodies each weight kernel's 4-bit rows replace, by kind
REPLACES_4BIT = {
    "K1": {"q4g": "tinyllama_tpu/ops/pallas/qmatmul.py:128",
           "q4": "tinyllama_tpu/ops/pallas/qmatmul.py:176"},
    "K2": {"q4g": "tinyllama_tpu/ops/pallas/qmatmul.py:232",
           "q4": "tinyllama_tpu/ops/pallas/qmatmul.py:264"},
    "K5-K7": {"q4g": "tinyllama_tpu/ops/pallas/ffn_fused.py:72",
              "q4": "tinyllama_tpu/ops/pallas/ffn_fused.py:112"},
    "K8": {"q4g": "tinyllama_tpu/ops/pallas/attn_out_fused.py:61",
           "q4": "tinyllama_tpu/ops/pallas/attn_out_fused.py:114"},
}


#: the TPU kernel lines that cast an f16 or f32 cache tile to the compute
#: dtype, which each f16 and f32 attention row replaces: K3's own load,
#: and the online-softmax helper of K4 and K8-K11
REPLACES_KV16 = {"K3": "tinyllama_tpu/ops/pallas/flash_prefill.py:75"}
REPLACES_KV16_HELPER = "tinyllama_tpu/ops/pallas/softmax_update.py:37"
#: the aq8 branch of the small-M body each K1-aq8 row replaces, by kind
REPLACES_AQ8 = {"q8": "tinyllama_tpu/ops/pallas/qmatmul.py:169",
                "q4": "tinyllama_tpu/ops/pallas/qmatmul.py:199"}
#: bytes of one cached key (or value) row of d values, by KV kind; int8
#: with its f32 scale
KV_ROW_BYTES = {"bf16": lambda d: 2 * d, "f16": lambda d: 2 * d,
                "f32": lambda d: 4 * d, "i8": lambda d: d + 4}


#: the TPU kernel bodies' int8-KV branches each int8 row replaces
REPLACES_I8 = {
    "K3": "tinyllama_tpu/ops/pallas/flash_prefill.py:78",
    "K4": "tinyllama_tpu/ops/pallas/flash_prefill.py:218",
    "K8": "tinyllama_tpu/ops/pallas/attn_out_fused.py:169",
    "K9": "tinyllama_tpu/ops/pallas/flash_prefill.py:397",
    "K10": "tinyllama_tpu/ops/pallas/flash_paged.py:43",
    "K11": "tinyllama_tpu/ops/pallas/flash_paged.py:194",
}
#: the note of an attention row's library yardstick over each KV kind
KV_YARDSTICK = {"bf16": "", "i8": " (SDPA over the dequantized bf16 K/V)",
                "f16": " (SDPA over the cache cast to bf16)",
                "f32": " (SDPA over the cache cast to bf16)"}
#: the TPU kernels the bf16 attention rows replace
REPLACES_ATTN = {"K3": "tinyllama_tpu/ops/pallas/flash_prefill.py:35",
                 "K4": "tinyllama_tpu/ops/pallas/flash_prefill.py:201",
                 "K8": "tinyllama_tpu/ops/pallas/attn_out_fused.py:143",
                 "K9": "tinyllama_tpu/ops/pallas/flash_prefill.py:375",
                 "K10": "tinyllama_tpu/ops/pallas/flash_paged.py:38",
                 "K11": "tinyllama_tpu/ops/pallas/flash_paged.py:171"}


def attention_replaces(kernel: str, kv: str) -> str:
    """The TPU kernel line an attention row ("K4 ...") over a cache of KV
    kind `kv` replaces."""
    k = kernel.split()[0]
    if kv == "i8":
        return REPLACES_I8[k]
    if kv != "bf16":
        return REPLACES_KV16.get(k, REPLACES_KV16_HELPER)
    return REPLACES_ATTN[k]


def as_kv_kind(cache, kv: str):
    """A bf16 KVCache or PagedKVCache in the KV kind `kv`: itself for
    "bf16", quantized to int8 with its f32 scale planes for "i8", cast
    for "f16" and "f32"."""
    import torch

    from tinyllama_tpu_torch.runtime.kvcache import KVCache, quantize_kv
    from tinyllama_tpu_torch.runtime.paged import PagedKVCache

    if kv == "bf16":
        return cache
    if kv == "i8":
        (k, ks), (v, vs) = quantize_kv(cache.k), quantize_kv(cache.v)
    else:
        dt = {"f16": torch.float16, "f32": torch.float32}[kv]
        k, v, ks, vs = cache.k.to(dt), cache.v.to(dt), None, None
    if isinstance(cache, PagedKVCache):
        return PagedKVCache(k, v, cache.table, ks, vs)
    return KVCache(k, v, ks, vs)


def sdpa_gqa(q, k, v, is_causal=False, mask=None):
    """The attention rows' library yardstick: one SDPA call with the K/V
    shared across each query group (enable_gqa), so it reads the bytes
    the kernels read."""
    import torch

    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True)


def kernel_row(kernel, name, kind, src, replaces, err, ms, plain_ms, nbytes,
               flops, library_ms, note="") -> dict:
    """One kernel's row of the `kernels` line (its launches filled in from
    the paths of policy `kind` later), printed: bound_ms = max(bytes /
    HBM_BW, operations / PEAK_BF16)."""
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, flops / PEAK_BF16 * 1e3
    r = dict(name=name, kernel=kernel, kind=kind, route="cuda", source=src,
             replaces=replaces, launches=0, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             library_ms=library_ms)
    print(f"kernel {name}: max_abs_err {err:.3e} (rtol {RTOL}, atol {ATOL}) "
          f"kernel_ms {ms:.5f} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) "
          f"plain_ms {plain_ms:.5f} library_ms {library_ms:.5f}" + note,
          flush=True)
    return r


def phase_kernels(engine, torch, ops, kind="q8", kv="bf16",
                  aq8=False) -> list[dict]:
    """Every kernel against its plain version at main-path shapes, on the
    engine's weights of `kind`. For a 4-bit kind only the weight kernels
    (K1, K2, K5-K8): the attention kernels take no weights. With kv="i8",
    "f16" or "f32" only the attention kernels (K3, K4, K8-K11), over
    caches of that kind: the same random values quantized (int8, with
    f32 scales) or cast, their bound counting the kind's bytes, their
    library yardstick SDPA over the cache as bf16. With aq8 only K1's
    aq8 branch, on the five decode shapes at M = 1."""
    import numpy as np

    from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view
    from tinyllama_tpu_torch.runtime.paged import (
        PagedKVCache, default_page_size, paged_layer_view,
    )
    from tinyllama_tpu_torch.runtime.staging import StagedKVCache
    from tinyllama_tpu_torch.tools.kbench import time_ms

    qm, fa, df, ffn, ao, fp, codec = ops
    cfg, params = engine.cfg, engine.params
    L, dev = cfg.n_layers, engine.device
    layers = [engine.layer_ids[i:i + 1] for i in range(L)]
    gen = torch.Generator(dev)
    gen.manual_seed(7)
    rows = []
    i8 = kv == "i8"
    attn_only = kv != "bf16"
    if aq8:
        label, row_kind = f"aq8 {kind} ", f"{kind}a8"
    elif attn_only:
        label, row_kind = f"{kv} ", f"q8-kv{kv}"
    else:
        label, row_kind = ("" if kind == "q8" else f"{kind} "), kind
    kv_row = KV_ROW_BYTES[kv](cfg.d_head)
    yardstick = KV_YARDSTICK[kv]

    def replaces(kernel, q8_line):
        if i8:
            return REPLACES_I8.get(kernel, q8_line)
        if attn_only:
            return REPLACES_KV16.get(kernel, REPLACES_KV16_HELPER)
        return q8_line if kind == "q8" else REPLACES_4BIT[kernel][kind]

    def row(kernel, shape, route_src, replaces, err, ms, plain_ms, nbytes,
            flops, library_ms, note=""):
        rows.append(kernel_row(kernel, f"{kernel} {label}{shape}", row_kind,
                               route_src, replaces, err, ms, plain_ms, nbytes,
                               flops, library_ms, note or yardstick))

    # K1 / K2: the quantized matmuls
    lin = params["layers"]
    mats = {n: lin[n] for n in ("wqkv", "wo", "w_gateup", "w_down")}
    dense = {n: [codec.dequantize(codec.QTensor(w.data[i], w.scales[i], kind,
                                                "kn"), torch.bfloat16)
                 for i in range(L)] for n, w in mats.items()}
    lm = params["lm_head"]
    lm_dense = codec.dequantize(lm, torch.bfloat16)

    def nbytes_of(w, stacked=True):
        """Bytes of one layer's data and scale planes."""
        d, s = (w.data[0], w.scales[0]) if stacked else (w.data, w.scales)
        return d.numel() * d.element_size() + s.numel() * 2

    def qmm_case(label, w, wd, M, layered, out_dtype):
        N, K = w.shape[-2:]  # logical: 4-bit data holds K/2 rows
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        lay = (lambda i: layers[i % L]) if layered else (lambda i: None)
        wdl = (lambda i: wd[i % L]) if layered else (lambda i: wd)
        got = qm.qmatmul(x, w, out_dtype, lay(0))
        want = qm.qmatmul_ref(x, w, out_dtype, lay(0))
        err = check_close(label, got, want)
        small = M <= qm.SMALL_M
        ms = time_ms(lambda i: qm.qmatmul(x, w, out_dtype, lay(i)), 200, True)
        plain = time_ms(lambda i: qm.qmatmul_ref(x, w, out_dtype, lay(i)), 10, False)
        lib = time_ms(lambda i: torch.matmul(x, wdl(i)), 200, True)
        out_b = 4 if out_dtype == torch.float32 else 2
        nbytes = nbytes_of(w, layered) + M * K * 2 + M * N * out_b
        kernel = "K1 qmm_smallm" if small else "K2 qmm_bigm"
        src = "tinyllama_tpu_torch/csrc/qmatmul.cu"
        rep = (replaces("K1", "tinyllama_tpu/ops/pallas/qmatmul.py:87") if small
               else replaces("K2", "tinyllama_tpu/ops/pallas/qmatmul.py:288"))
        row(kernel, f"{label} M={M} K={K} N={N}", src, rep, err, ms, plain,
            nbytes, 2 * M * K * N, lib)

    def qmm_aq8_case(label, w, wd, layered, out_dtype):
        """K1's aq8 branch at M = 1; yardsticks torch.matmul on the
        dequantized bf16 weight, and torch._int_mm (int8 x int8 -> int32,
        no scales) on x padded to the least M it takes, if it takes one."""
        N, K = w.shape[-2:]
        x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
        lay = (lambda i: layers[i % L]) if layered else (lambda i: None)
        wdl = (lambda i: wd[i % L]) if layered else (lambda i: wd)
        err = check_close(f"K1 aq8 {label}",
                          qm.qmatmul(x, w, out_dtype, lay(0), aq8=True),
                          qm.qmatmul_ref(x, w, out_dtype, lay(0), aq8=True))
        ms = time_ms(lambda i: qm.qmatmul(x, w, out_dtype, lay(i), aq8=True),
                     200, True)
        plain = time_ms(lambda i: qm.qmatmul_ref(x, w, out_dtype, lay(i),
                                                 aq8=True), 10, False)
        lib = time_ms(lambda i: torch.matmul(x, wdl(i)), 200, True)
        planes = ([w.data[i] for i in range(L)] if layered else [w.data])
        # int8 [K, N] weights, column-major as cuBLAS's int8 GEMM takes them
        wi = [(p if kind == "q8" else qm.int_values(p, kind).to(torch.int8)
               ).t().contiguous().t() for p in planes]
        int_mm, int_m = None, None
        for m in (1, 8, 16, 17, 32):
            xi = torch.ones((m, K), dtype=torch.int8, device=dev)
            try:
                torch._int_mm(xi, wi[0])
            except RuntimeError:
                continue
            int_mm = time_ms(lambda i: torch._int_mm(xi, wi[i % len(wi)]), 200,
                             True)
            int_m = m
            break
        del wi
        out_b = 4 if out_dtype == torch.float32 else 2
        nbytes = nbytes_of(w, layered) + K * 2 + N * out_b
        note = (" (library: torch.matmul on the dequantized bf16 weight; "
                + (f"torch._int_mm at M={int_m}, column-major int8 weight, "
                   f"{int_mm:.5f} ms)" if int_mm
                   else "torch._int_mm takes no M here)"))
        row("K1 qmm_smallm", f"{label} M=1 K={K} N={N}",
            "tinyllama_tpu_torch/csrc/qmatmul.cu", REPLACES_AQ8[kind], err, ms,
            plain, nbytes, 2 * K * N, lib, note)
        rows[-1]["int_mm_ms"] = int_mm

    if aq8:
        for n, w in mats.items():
            qmm_aq8_case(n, w, dense[n], True, torch.bfloat16)
        qmm_aq8_case("lm_head", lm, lm_dense, False, torch.float32)
        return rows
    if not attn_only:
        for n, w in mats.items():
            qmm_case(n, w, dense[n], 1, True, torch.bfloat16)
        qmm_case("lm_head", lm, lm_dense, 1, False, torch.float32)
        # K2 at prefill sizes: a chat prompt (128), longer prompts (512,
        # 2,048: path (e)'s bucket) and, q8, a B = 32 admission (8,192)
        for M in (128, 512, 2048, 8192) if kind == "q8" else (128, 512, 2048):
            for n, w in mats.items():
                qmm_case(n, w, dense[n], M, True, torch.bfloat16)

    # K5-K7: the fused decode-layer matmuls on the same weights
    D, F = cfg.n_embd, cfg.n_ffn
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    w_bytes = {n: nbytes_of(w) for n, w in mats.items()}

    def rows_bf16(M, K):
        return torch.randn((M, 1, K), generator=gen, device=dev).to(torch.bfloat16)

    def fused_case(kernel, label, src, rep, fn, plain, lib, nbytes, flops,
                   replay=False):
        err = check_close(f"{kernel} {label}", fn(0), plain(0))
        if replay:
            replay_equals(f"{kernel} {label}", lambda: fn(1))
        ms = time_ms(fn, 100, True)
        plain_ms = time_ms(plain, 5, False)
        lib_ms = time_ms(lib, 100, True)
        row(kernel, label, src, rep, err, ms, plain_ms, nbytes, flops, lib_ms)

    src = "tinyllama_tpu_torch/csrc/decode_fused.cu"
    rep = "tinyllama_tpu/ops/pallas/decode_fused.py"
    norm_a, norm_f = lin["attn_norm"], lin["ffn_norm"]
    for M in () if attn_only else (1, 4, 32):
        x = rows_bf16(M, D)
        wq, N = lin["wqkv"], lin["wqkv"].data.shape[-1]
        fused_case(
            "K5 fused_norm_qkv", f"M={M} K={D} N={N}", src,
            replaces("K5-K7", f"{rep}:49"),
            lambda i: df.fused_norm_qkv(x, norm_a, wq, layers[i % L], eps, inside),
            lambda i: df.fused_norm_qkv_ref(x, norm_a, wq, layers[i % L], eps,
                                            inside),
            lambda i: torch.matmul(x.view(M, D), dense["wqkv"][i % L]),
            w_bytes["wqkv"] + M * D * 2 + D * 4 + M * N * 2, 2 * M * D * N)
    for M in () if attn_only else (4, 32):
        a, r = rows_bf16(M, D), rows_bf16(M, D)
        fused_case(
            "K6 fused_out_residual", f"M={M} K={D} N={D}", src,
            replaces("K5-K7", f"{rep}:130"),
            lambda i: df.fused_out_residual(a, r, lin["wo"], layers[i % L]),
            lambda i: df.fused_out_residual_ref(a, r, lin["wo"], layers[i % L]),
            lambda i: torch.addmm(r.view(M, D), a.view(M, D), dense["wo"][i % L]),
            w_bytes["wo"] + 3 * M * D * 2, 2 * M * D * D)

    src = "tinyllama_tpu_torch/csrc/ffn_fused.cu"
    rep = replaces("K5-K7", "tinyllama_tpu/ops/pallas/ffn_fused.py:160")
    gu, wd = lin["w_gateup"], lin["w_down"]
    ffn_bytes = w_bytes["w_gateup"] + w_bytes["w_down"]

    def ffn_library(x, M):
        # the gate/up and down products on dequantized bf16 weights
        return lambda i: torch.matmul(
            torch.matmul(x.view(M, D), dense["w_gateup"][i % L])[:, :F],
            dense["w_down"][i % L])

    for M in () if attn_only else (1, 4, 32):
        x = rows_bf16(M, D)
        fused_case(
            "K7 ffn_fused", f"normed M={M} D={D} F={F}", src, rep,
            lambda i: ffn.ffn_fused_normed(x, norm_f, gu, wd, layers[i % L], cfg),
            lambda i: ffn.ffn_fused_ref(x, norm_f, gu, wd, layers[i % L], cfg,
                                        eps, inside),
            ffn_library(x, M), ffn_bytes + 2 * M * D * 2 + D * 4,
            2 * M * 3 * F * D, replay=True)
    if not attn_only:
        x = rows_bf16(1, D)
        fused_case(
            "K7 ffn_fused", f"plain entry M=1 D={D} F={F}", src, rep,
            lambda i: ffn.ffn_fused(x, gu, wd, layers[i % L], cfg),
            lambda i: ffn.ffn_fused_ref(x, None, gu, wd, layers[i % L], cfg),
            ffn_library(x, 1), ffn_bytes + 2 * D * 2, 2 * 3 * F * D)

    # K3 / K4 / K8: attention over a full-size random bf16 cache
    H, Kh, d, S = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, engine.max_ctx
    shape = (L, 1, Kh, S, d)
    cache = as_kv_kind(KVCache(
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)), kv)
    # the library's K/V: layer 3 as bf16 (int8 dequantized, f16 and f32
    # cast)
    dense_k, dense_v = layer_cache_view(cache, 3, torch.bfloat16)

    src = "tinyllama_tpu_torch/csrc/attn_out_fused.cu"
    for p in (127, 1500):
        q = torch.randn((1, 1, H, d), generator=gen, device=dev).to(torch.bfloat16)
        res = torch.randn((1, 1, D), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        kx, vx = dense_k[:, :, :p + 1], dense_v[:, :, :p + 1]
        qh = q.transpose(1, 2)
        fused_case(
            "K8 fused_attn_out", f"pos={p} S={S} N={D}", src,
            replaces("K8", "tinyllama_tpu/ops/pallas/attn_out_fused.py:143"),
            lambda i: ao.fused_attn_out(q, cache, layers[i % L], pos, res,
                                        lin["wo"]),
            lambda i: ao.fused_attn_out_ref(q, cache, layers[i % L], pos, res,
                                            lin["wo"]),
            # SDPA over the visible keys, then wo and the residual
            lambda i: torch.addmm(res.view(1, D),
                                  sdpa_gqa(qh, kx, vx).reshape(1, D),
                                  dense["wo"][i % L]),
            w_bytes["wo"] + 2 * Kh * (p + 1) * kv_row + H * d * 2 + 2 * D * 2,
            4 * d * H * (p + 1) + 2 * D * D, replay=True)
    # its attention's split count and its walk's plan follow sizes only
    replay_at(f"K8 fused_attn_out {row_kind}",
              lambda: ao.fused_attn_out(q, cache, layers[3], pos, res, lin["wo"]),
              pos, 127, (1500, 448, 5, S - 1))
    del dense, lm_dense
    if kind != "q8":
        return rows

    def attn_case(kernel, T, p, B=1, c=cache, dk=dense_k, dv=dense_v):
        q = torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.full((B,), p, dtype=torch.int32, device=dev)
        fn = (fa.flash_decode_heads_attention if T == 1
              else fa.flash_prefill_attention)
        got = fn(q, c, layers[3], pos)
        want = fa.attention_ref(q, c, layers[3], pos)
        err = check_close(f"{kernel} T={T} pos={p} B={B}", got, want)
        if T == 1 and p == S - 1:  # a full cache: any position is valid
            replay_at(f"{kernel} {row_kind} B={B}",
                      lambda: fn(q, c, layers[3], pos), pos, 127,
                      (1500, 5, S - 1))
        ms = time_ms(lambda i: fn(q, c, layers[i % L], pos), 100, True)
        plain = time_ms(lambda i: fa.attention_ref(q, c, layers[i % L], pos),
                        5, False)
        # library yardstick: SDPA over the visible keys
        n_keys = p + T
        kx, vx = dk[:, :, :n_keys], dv[:, :, :n_keys]
        qh = q.transpose(1, 2)
        causal = T > 1
        lib = time_ms(lambda i: sdpa_gqa(qh, kx, vx, is_causal=causal), 100, True)
        pairs = B * H * sum(p + t + 1 for t in range(T))
        nbytes = B * (2 * T * H * d * 2 + 2 * Kh * n_keys * kv_row)
        rep = replaces(kernel.split()[0],
                       "tinyllama_tpu/ops/pallas/flash_prefill.py:201" if T == 1
                       else "tinyllama_tpu/ops/pallas/flash_prefill.py:35")
        # K3's source is flash_attention.cu; K4's the split template
        src = ("tinyllama_tpu_torch/csrc/decode_split.cu" if T == 1
               else "tinyllama_tpu_torch/csrc/flash_attention.cu")
        row(kernel, f"T={T} pos={p} S={S}" + (f" B={B}" if B > 1 else ""),
            src, rep, err, ms, plain, nbytes, 4 * d * pairs, lib)

    for T in (32, 128, 512, 2048):
        attn_case("K3 flash_prefill", T, 0)
    for p in (127, 1500, 2047):
        attn_case("K4 flash_decode_heads", 1, p)
    del cache, dense_k, dense_v
    # K4 at path (c)'s batch: 4 rows at pos 1500
    shape = (L, BATCH, Kh, S, d)
    cache = as_kv_kind(KVCache(
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)), kv)
    dense_k, dense_v = layer_cache_view(cache, 3, torch.bfloat16)
    attn_case("K4 flash_decode_heads", 1, 1500, BATCH, cache, dense_k, dense_v)
    del cache, dense_k, dense_v
    # K3 at an admission of path (f): 32 rows of 256 tokens from pos 0
    shape = (L, ADMIT, Kh, S, d)
    cache = as_kv_kind(KVCache(
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)), kv)
    dense_k, dense_v = layer_cache_view(cache, 3, torch.bfloat16)
    attn_case("K3 flash_prefill", 256, 0, ADMIT, cache, dense_k, dense_v)
    del cache, dense_k, dense_v

    # K9-K11: the serving attention at the shapes of paths (d)-(g)
    src = "tinyllama_tpu_torch/csrc/decode_split.cu"
    P = default_page_size(S)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def serving_case(kernel, B, fill, tail, paged, rep, label=None):
        """B rows whose pool holds `fill` keys (below the chunk's base; an
        int, or one a row) and, staged, a 32-slot tail filled to `tail`;
        K10 (tail 0) at pos fill - 1."""
        fills = [fill] * B if isinstance(fill, int) else list(fill)
        most = max(fills)
        q = rand(B, 1, H, d)
        if paged:
            n = -(-most // P)
            table = torch.zeros((B, S // P), dtype=torch.int32, device=dev)
            table[:, :n] = 1 + torch.arange(B * n, device=dev).reshape(B, n)
            pool = as_kv_kind(PagedKVCache(rand(L, 1 + B * n, Kh, P, d),
                                      rand(L, 1 + B * n, Kh, P, d), table), kv)
        else:
            pool = as_kv_kind(KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d)), kv)
        base = torch.tensor(fills, dtype=torch.int32, device=dev)
        if tail:
            t = as_kv_kind(KVCache(rand(L, B, Kh, 32, d), rand(L, B, Kh, 32, d)), kv)
            st = StagedKVCache(pool, t.k, t.v, base, sk_scale=t.k_scale,
                               sv_scale=t.v_scale)
            pos = base + (tail - 1)
            fn = (fp.flash_paged_staged_attention if paged
                  else fa.flash_staged_attention)
            cache_arg, plain = st, fp.staged_attention_ref
        else:
            pos = base - 1
            fn, cache_arg = fp.flash_paged_attention, pool
            plain = fp.paged_attention_ref
        # library yardstick: SDPA over the same keys, gathered dense (rows
        # of other fills: the longest row's keys under a mask)
        kd, vd = (paged_layer_view(pool, 3, torch.bfloat16) if paged
                  else layer_cache_view(pool, 3, torch.bfloat16))
        kx, vx = kd[:, :, :most], vd[:, :, :most]
        mask = (torch.arange(most + tail, device=dev)[None, :]
                < base[:, None].long()) | (
            torch.arange(most + tail, device=dev)[None, :] >= most)
        if tail:
            tk, tv = layer_cache_view(t, 3, torch.bfloat16)
            kx = torch.cat([kx, tk[:, :, :tail]], dim=2)
            vx = torch.cat([vx, tv[:, :, :tail]], dim=2)
        qh = q.transpose(1, 2)
        ragged = min(fills) < most

        def library(i):
            if ragged:
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kx, vx, attn_mask=mask[:, None, None, :],
                    enable_gqa=True)
            return sdpa_gqa(qh, kx, vx)

        n_keys = sum(fills) + B * tail
        if label is None:
            label = (f"B={B} fill={fill} tail={tail} P={P}" if paged
                     else f"B={B} fill={fill} tail={tail} S={S}")
            if not tail:
                label = f"B={B} pos={fill - 1} P={P}"
        if not tail and fill == S:  # every page of the row: any position
            replay_at(f"{kernel} {row_kind} {label}",
                      lambda: fn(q, cache_arg, layers[3], pos), pos, 127,
                      (1500, 5, S - 1))
        fused_case(
            kernel, label, src, rep,
            lambda i: fn(q, cache_arg, layers[i % L], pos),
            lambda i: plain(q, cache_arg, layers[i % L], pos),
            library,
            2 * Kh * n_keys * kv_row + 2 * B * H * d * 2,
            4 * d * H * n_keys)

    serving_case("K9 flash_staged", 8, 256, 32, False,
                 replaces("K9", "tinyllama_tpu/ops/pallas/flash_prefill.py:375"))
    for p in (127, 1500, 2047):
        serving_case("K10 flash_paged", 1, p + 1, 0, True,
                     replaces("K10", "tinyllama_tpu/ops/pallas/flash_paged.py:38"))
    rep11 = replaces("K11", "tinyllama_tpu/ops/pallas/flash_paged.py:171")
    serving_case("K11 flash_paged_staged", 32, 256, 32, True, rep11)
    # path (f)'s first 32 requests (seed 5) at a chunk's last step: each
    # row's base its prompt's length, 8-200 keys
    fills = np.random.default_rng(5).integers(8, 201, 64)[:ADMIT].tolist()
    serving_case("K11 flash_paged_staged", ADMIT, fills, 32, True, rep11,
                 f"B={ADMIT} fill=ragged {min(fills)}-{max(fills)} (seed 5) "
                 f"tail=32 P={P}")
    return rows



#: the d = 128 rows' shapes: Llama-3-8B's heads (32 query, 8 kv: G = 4)
#: and Llama-3-70B's (64, 8: G = 8), max_ctx 8,192
D128_S = 8192
D128_HEADS = {4: (32, 8), 8: (64, 8)}


def phase_attention_d128(torch, ops, kv="bf16") -> list[dict]:
    """The five attention kernels at head dim 128 against their plain
    versions, over random caches of Llama-3's heads at S = 8,192, 4
    layers cycled (past the 50 MB L2): in bf16, K3 at T = 128, 512, 2,048
    and 8,192 at G = 4 and 8 (8,192 at G = 8 with 32 query heads over 4
    kv heads: the plain version's f32 scores of 64 heads would not fit
    beside the rest), K4 at pos 127, 1,500 and 8,191 and at B = 4 (pos
    4,000), K10 at pos 127, 1,500 and 8,191 (K4 and K10 also captured at
    pos 127 and replayed elsewhere), K9 at B = 8 and K11 at B = 16 over
    fills of 1,536 and 8,000 and a 32-slot tail; with kv = "i8", "f16" or
    "f32" one shape of each (K3 T = 2,048, K4 and K10 pos 1,500, K9 and
    K11 fill 1,536 + 32), at G = 4. Each row's bound counts the kind's
    bytes (int8 with its f32 scales); its library yardstick is SDPA over
    the same keys as bf16."""
    from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view
    from tinyllama_tpu_torch.runtime.paged import PagedKVCache, paged_layer_view
    from tinyllama_tpu_torch.runtime.staging import StagedKVCache
    from tinyllama_tpu_torch.tools.kbench import time_ms

    _, fa, _, _, _, fp, _ = ops
    dev, d, S, L = "cuda", 128, D128_S, 4
    layers = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    gen = torch.Generator(dev)
    gen.manual_seed(128)
    rows = []
    kv_row = KV_ROW_BYTES[kv](d)
    kind = "8b-q4" if kv == "bf16" else f"8b-q4-kv{kv}"
    yardstick = KV_YARDSTICK[kv]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def measure(kernel, shape, src, fn, plain, library, nbytes, flops, reps):
        err = check_close(f"{kernel} d=128 {kv} {shape}", fn(0), plain(0))
        ms = time_ms(fn, reps, True)
        plain_ms = time_ms(plain, 3, False)
        lib_ms = time_ms(library, reps, True)
        rows.append(kernel_row(kernel, f"{kernel} d=128 "
                               + ("" if kv == "bf16" else f"{kv} ") + shape,
                               kind, src, attention_replaces(kernel, kv), err,
                               ms, plain_ms, nbytes, flops, lib_ms, yardstick))

    def mono(B, H, Kh):
        return as_kv_kind(KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d)), kv)

    # K3: the causal prefill from pos 0 over T new tokens
    src3 = "tinyllama_tpu_torch/csrc/flash_attention.cu"
    k3 = ([(T, G) for G in (4, 8) for T in (128, 512, 2048, 8192)]
          if kv == "bf16" else [(2048, 4)])
    for T, G in k3:
        H, Kh = (32, 4) if (T, G) == (8192, 8) else D128_HEADS[G]
        cache = mono(1, H, Kh)
        dk, dv = layer_cache_view(cache, 3, torch.bfloat16)
        dk, dv = dk[:, :, :T], dv[:, :, :T]
        q = rand(1, T, H, d)
        pos = torch.zeros(1, dtype=torch.int32, device=dev)
        qh = q.transpose(1, 2)
        pairs = H * T * (T + 1) // 2
        measure("K3 flash_prefill", f"T={T} pos=0 S={S} H={H} Kh={Kh} G={G}",
                src3, lambda i: fa.flash_prefill_attention(q, cache, layers[i % L],
                                                           pos),
                lambda i: fa.attention_ref(q, cache, layers[i % L], pos),
                lambda i: sdpa_gqa(qh, dk, dv, is_causal=True),
                2 * T * H * d * 2 + 2 * Kh * T * kv_row, 4 * d * pairs,
                20 if T == 8192 else 100)
        del cache, dk, dv, q, qh

    # K4 and K10: one new token a row at pos, the cache full of keys
    src = "tinyllama_tpu_torch/csrc/decode_split.cu"
    H, Kh = D128_HEADS[4]
    P = 256
    k4 = ([(1, p) for p in (127, 1500, S - 1)] + [(4, 4000)] if kv == "bf16"
          else [(1, 1500)])
    for B, p in k4:
        cache = mono(B, H, Kh)
        q = rand(B, 1, H, d)
        pos = torch.full((B,), p, dtype=torch.int32, device=dev)
        dk, dv = layer_cache_view(cache, 3, torch.bfloat16)
        kx, vx, qh = dk[:, :, :p + 1], dv[:, :, :p + 1], q.transpose(1, 2)
        if p == S - 1:
            replay_at(f"K4 d=128 {kv} B={B}",
                      lambda: fa.flash_decode_heads_attention(q, cache, layers[3],
                                                              pos),
                      pos, 127, (1500, 5, S - 1))
        measure("K4 flash_decode_heads", f"B={B} pos={p} S={S} H={H} Kh={Kh}",
                src, lambda i: fa.flash_decode_heads_attention(q, cache,
                                                               layers[i % L], pos),
                lambda i: fa.attention_ref(q, cache, layers[i % L], pos),
                lambda i: sdpa_gqa(qh, kx, vx),
                B * (2 * H * d * 2 + 2 * Kh * (p + 1) * kv_row),
                4 * d * B * H * (p + 1), 100)
        del cache, dk, dv, kx, vx
    for p in (127, 1500, S - 1) if kv == "bf16" else (1500,):
        n = p // P + 1
        table = torch.zeros((1, S // P), dtype=torch.int32, device=dev)
        table[0, :n] = 1 + torch.arange(n, device=dev)
        pool = as_kv_kind(PagedKVCache(rand(L, 1 + n, Kh, P, d),
                                  rand(L, 1 + n, Kh, P, d), table), kv)
        q = rand(1, 1, H, d)
        pos = torch.full((1,), p, dtype=torch.int32, device=dev)
        dk, dv = paged_layer_view(pool, 3, torch.bfloat16)
        kx, vx, qh = dk[:, :, :p + 1], dv[:, :, :p + 1], q.transpose(1, 2)
        if p == S - 1:
            replay_at(f"K10 d=128 {kv}",
                      lambda: fp.flash_paged_attention(q, pool, layers[3], pos),
                      pos, 127, (1500, 5, S - 1))
        measure("K10 flash_paged", f"B=1 pos={p} P={P} H={H} Kh={Kh}", src,
                lambda i: fp.flash_paged_attention(q, pool, layers[i % L], pos),
                lambda i: fp.paged_attention_ref(q, pool, layers[i % L], pos),
                lambda i: sdpa_gqa(qh, kx, vx),
                2 * H * d * 2 + 2 * Kh * (p + 1) * kv_row, 4 * d * H * (p + 1),
                100)
        del pool, dk, dv, kx, vx

    # K9 (B = 8, the monolithic cache) and K11 (B = 16, the pool): every
    # row's base at `fill`, a 32-slot tail full
    for kernel, B, paged in (("K9 flash_staged", 8, False),
                             ("K11 flash_paged_staged", 16, True)):
        for fill in (1536, 8000) if kv == "bf16" else (1536,):
            if paged:
                n = -(-fill // P)
                table = torch.zeros((B, S // P), dtype=torch.int32, device=dev)
                table[:, :n] = 1 + torch.arange(B * n, device=dev).reshape(B, n)
                pool = as_kv_kind(PagedKVCache(rand(L, 1 + B * n, Kh, P, d),
                                          rand(L, 1 + B * n, Kh, P, d), table), kv)
                fn = fp.flash_paged_staged_attention
                dk, dv = paged_layer_view(pool, 3, torch.bfloat16)
            else:
                pool = mono(B, H, Kh)
                fn = fa.flash_staged_attention
                dk, dv = layer_cache_view(pool, 3, torch.bfloat16)
            t = as_kv_kind(KVCache(rand(L, B, Kh, 32, d), rand(L, B, Kh, 32, d)), kv)
            base = torch.full((B,), fill, dtype=torch.int32, device=dev)
            st = StagedKVCache(pool, t.k, t.v, base, sk_scale=t.k_scale,
                               sv_scale=t.v_scale)
            pos = base + 31
            q = rand(B, 1, H, d)
            tk, tv = layer_cache_view(t, 3, torch.bfloat16)
            kx = torch.cat([dk[:, :, :fill], tk], dim=2)
            vx = torch.cat([dv[:, :, :fill], tv], dim=2)
            qh = q.transpose(1, 2)
            measure(kernel, f"B={B} fill={fill} tail=32 "
                    + (f"P={P}" if paged else f"S={S}") + f" H={H} Kh={Kh}", src,
                    lambda i: fn(q, st, layers[i % L], pos),
                    lambda i: fp.staged_attention_ref(q, st, layers[i % L], pos),
                    lambda i: sdpa_gqa(qh, kx, vx),
                    2 * Kh * B * (fill + 32) * kv_row + 2 * B * H * d * 2,
                    4 * d * H * B * (fill + 32), 100)
            del pool, st, t, dk, dv, kx, vx
    torch.cuda.empty_cache()
    return rows


#: path (t): the tiny configurations' rows: K4 and K9-K11 at each of the
#: fills (tiny-test's max_ctx, and 2,048), K8 at each position
TINY_FILLS = (128, 2048)
TINY_K8_POS = (127, 1500)
#: path (t): K11's batch rows (the server's slots, and the batcher's)
TINY_SLOTS = 8
#: path (t1): the CLI's greedy tokens after its prompt (two 32-step
#: chunks within tiny-test's max_ctx of 128)
TINY_NEW = 64


def phase_attention_tiny(torch, ops, kv="bf16") -> list[dict]:
    """The attention kernels at the JAX package's tiny head shapes against
    their plain versions, over random caches of one KV kind: head dim 32,
    the tiny-test config's 4 query heads over 2 kv heads (G 2) or 4 (G 1):
    K3 at T = 32 and 128 from pos 0 over max_ctx 128 (G 2); K4 (B = 4),
    K10 (B = 1), K9 (B = 4) and K11 (B = TINY_SLOTS) at G 1 and 2 with
    every row's keys filled to each of TINY_FILLS (K9 and K11: the last 32
    in a full tail); K8 at d 32 (G 2, the tiny config's wo 128 x 128) and
    at d 128 (4 query heads over 1 kv head, G 4, wo 512 x 512: path (t4)'s
    model) at TINY_K8_POS over 2,048 keys, q8 wo; with kv = "i8", "f16" or
    "f32" one shape of each (K3 T = 128, the rest at G 2 over 2,048 keys,
    K8 at pos 1,500), as the d = 128 rows do. In bf16, K4 and K8 at d 32
    are also captured in a CUDA graph at one position and replayed at
    others. Each row's bound counts the kind's bytes (int8 with its f32 scales);
    its library yardstick is SDPA (enable_gqa) over the same keys as bf16,
    for K8 then wo (dequantized, bf16) and the residual by torch.addmm."""
    from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view
    from tinyllama_tpu_torch.runtime.paged import PagedKVCache, paged_layer_view
    from tinyllama_tpu_torch.runtime.staging import StagedKVCache
    from tinyllama_tpu_torch.tools.kbench import time_ms

    _, fa, _, _, ao, fp, codec = ops
    dev, d, L, H = "cuda", 32, 2, 4
    layers = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    gen = torch.Generator(dev)
    gen.manual_seed(32)
    rows = []
    sfx = "" if kv == "bf16" else f"-kv{kv}"
    yardstick = KV_YARDSTICK[kv]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def measure(kernel, dh, shape, src, fn, plain, library, nbytes, flops,
                kind="tiny-q8"):
        name = f"{kernel} d={dh} " + ("" if kv == "bf16" else f"{kv} ") + shape
        err = check_close(name, fn(0), plain(0))
        ms = time_ms(fn, 50, True)
        plain_ms = time_ms(plain, 3, False)
        lib_ms = time_ms(library, 50, True)
        rows.append(kernel_row(kernel, name, kind + sfx, src,
                               attention_replaces(kernel, kv),
                               err, ms, plain_ms, nbytes, flops, lib_ms,
                               yardstick))

    kv_row = KV_ROW_BYTES[kv](d)
    # K3: the causal prefill from pos 0 over T new tokens, max_ctx 128
    S, Kh = 128, 2
    cache = as_kv_kind(KVCache(rand(L, 1, Kh, S, d), rand(L, 1, Kh, S, d)), kv)
    dk, dv = layer_cache_view(cache, 1, torch.bfloat16)
    pos0 = torch.zeros(1, dtype=torch.int32, device=dev)
    every = kv == "bf16"  # every shape, else one of each
    for T in (32, 128) if every else (128,):
        q = rand(1, T, H, d)
        qh, kx, vx = q.transpose(1, 2), dk[:, :, :T], dv[:, :, :T]
        measure("K3 flash_prefill", d, f"T={T} pos=0 S={S} H={H} Kh={Kh} G=2",
                "tinyllama_tpu_torch/csrc/flash_attention.cu",
                lambda i: fa.flash_prefill_attention(q, cache, layers[i % L], pos0),
                lambda i: fa.attention_ref(q, cache, layers[i % L], pos0),
                lambda i: sdpa_gqa(qh, kx, vx, is_causal=True),
                2 * T * H * d * 2 + 2 * Kh * T * kv_row,
                4 * d * H * T * (T + 1) // 2)
    del cache

    src = "tinyllama_tpu_torch/csrc/decode_split.cu"
    P = 64
    for G in (1, 2) if every else (2,):
        Kh = H // G
        for fill in TINY_FILLS if every else TINY_FILLS[-1:]:
            # K4: path (c)'s batch of 4 rows, each at pos fill - 1
            B, S = 4, fill
            cache = as_kv_kind(KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d)), kv)
            q = rand(B, 1, H, d)
            pos = torch.full((B,), fill - 1, dtype=torch.int32, device=dev)
            dk, dv = layer_cache_view(cache, 1, torch.bfloat16)
            qh = q.transpose(1, 2)
            if every and fill == TINY_FILLS[-1]:  # any position is valid
                replay_at(f"K4 d=32 {kv} G={G} B={B}",
                          lambda: fa.flash_decode_heads_attention(
                              q, cache, layers[1], pos),
                          pos, 127, (1500, 5, S - 1))
            measure("K4 flash_decode_heads", d,
                    f"B={B} pos={fill - 1} S={S} H={H} Kh={Kh} G={G}", src,
                    lambda i: fa.flash_decode_heads_attention(
                        q, cache, layers[i % L], pos),
                    lambda i: fa.attention_ref(q, cache, layers[i % L], pos),
                    lambda i: sdpa_gqa(qh, dk, dv),
                    B * (2 * H * d * 2 + 2 * Kh * fill * kv_row),
                    4 * d * B * H * fill)
            del cache
            # K10: one row at pos fill - 1 through its page table
            n = fill // P
            table = (1 + torch.arange(n, device=dev, dtype=torch.int32))[None]
            pool = as_kv_kind(PagedKVCache(rand(L, 1 + n, Kh, P, d),
                                      rand(L, 1 + n, Kh, P, d), table), kv)
            q = rand(1, 1, H, d)
            pos = torch.full((1,), fill - 1, dtype=torch.int32, device=dev)
            dk, dv = paged_layer_view(pool, 1, torch.bfloat16)
            qh = q.transpose(1, 2)
            measure("K10 flash_paged", d,
                    f"B=1 pos={fill - 1} P={P} H={H} Kh={Kh} G={G}", src,
                    lambda i: fp.flash_paged_attention(q, pool, layers[i % L], pos),
                    lambda i: fp.paged_attention_ref(q, pool, layers[i % L], pos),
                    lambda i: sdpa_gqa(qh, dk[:, :, :fill], dv[:, :, :fill]),
                    2 * H * d * 2 + 2 * Kh * fill * kv_row, 4 * d * H * fill)
            del pool
            # K9 (B = 4, the monolithic cache) and K11 (TINY_SLOTS rows, the
            # pool): every row's base at fill - 32, its 32-slot tail full
            for kernel, B, paged in (("K9 flash_staged", 4, False),
                                     ("K11 flash_paged_staged", TINY_SLOTS,
                                      True)):
                base_n = fill - 32
                if paged:
                    n = -(-base_n // P)
                    table = torch.zeros((B, fill // P), dtype=torch.int32,
                                        device=dev)
                    table[:, :n] = 1 + torch.arange(
                        B * n, device=dev, dtype=torch.int32).reshape(B, n)
                    pool = as_kv_kind(PagedKVCache(rand(L, 1 + B * n, Kh, P, d),
                                              rand(L, 1 + B * n, Kh, P, d),
                                              table), kv)
                    fn = fp.flash_paged_staged_attention
                    dk, dv = paged_layer_view(pool, 1, torch.bfloat16)
                else:
                    pool = as_kv_kind(KVCache(rand(L, B, Kh, fill, d),
                                         rand(L, B, Kh, fill, d)), kv)
                    fn = fa.flash_staged_attention
                    dk, dv = layer_cache_view(pool, 1, torch.bfloat16)
                t = as_kv_kind(KVCache(rand(L, B, Kh, 32, d), rand(L, B, Kh, 32, d)), kv)
                base = torch.full((B,), base_n, dtype=torch.int32, device=dev)
                st = StagedKVCache(pool, t.k, t.v, base, sk_scale=t.k_scale,
                                   sv_scale=t.v_scale)
                pos = base + 31
                q = rand(B, 1, H, d)
                tk, tv = layer_cache_view(t, 1, torch.bfloat16)
                kx = torch.cat([dk[:, :, :base_n], tk], dim=2)
                vx = torch.cat([dv[:, :, :base_n], tv], dim=2)
                qh = q.transpose(1, 2)
                measure(kernel, d, f"B={B} fill={base_n} tail=32 "
                        + (f"P={P}" if paged else f"S={fill}")
                        + f" H={H} Kh={Kh} G={G}", src,
                        lambda i: fn(q, st, layers[i % L], pos),
                        lambda i: fp.staged_attention_ref(q, st, layers[i % L],
                                                          pos),
                        lambda i: sdpa_gqa(qh, kx, vx),
                        2 * Kh * B * fill * kv_row + 2 * B * H * d * 2,
                        4 * d * H * B * fill)
                del pool, st, t

    # K8: the b1 step's attention, wo (q8) and residual over 2,048 keys
    S = 2048
    for dh, Kh, kind in ((32, 2, "tiny-q8"), (128, 1, "t4-q8")):
        D = H * dh
        w = [codec.quantize(torch.randn((D, D), generator=gen, device=dev) * 0.02,
                            "q8", "kn") for _ in range(L)]
        wo = codec.QTensor(torch.stack([x.data for x in w]),
                           torch.stack([x.scales for x in w]), "q8", "kn")
        dense = [codec.dequantize(x, torch.bfloat16) for x in w]
        cache = as_kv_kind(KVCache(rand(L, 1, Kh, S, dh), rand(L, 1, Kh, S, dh)), kv)
        dk, dv = layer_cache_view(cache, 1, torch.bfloat16)
        row_bytes = KV_ROW_BYTES[kv](dh)
        for p in TINY_K8_POS if every else TINY_K8_POS[-1:]:
            q, res = rand(1, 1, H, dh), rand(1, 1, D)
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            qh, kx, vx = q.transpose(1, 2), dk[:, :, :p + 1], dv[:, :, :p + 1]
            if every and dh == 32 and p == TINY_K8_POS[0]:
                replay_at(f"K8 d=32 {kv} G=2",
                          lambda: ao.fused_attn_out(q, cache, layers[1], pos, res,
                                                    wo),
                          pos, 127, (1500, 5, S - 1))
            measure("K8 fused_attn_out", dh,
                    f"pos={p} S={S} H={H} Kh={Kh} G={H // Kh} N={D}",
                    "tinyllama_tpu_torch/csrc/attn_out_fused.cu",
                    lambda i: ao.fused_attn_out(q, cache, layers[i % L], pos,
                                                res, wo),
                    lambda i: ao.fused_attn_out_ref(q, cache, layers[i % L], pos,
                                                    res, wo),
                    lambda i: torch.addmm(res.view(1, D),
                                          sdpa_gqa(qh, kx, vx).reshape(1, D),
                                          dense[i % L]),
                    D * D + D // 32 * D * 2 + 2 * Kh * (p + 1) * row_bytes
                    + H * dh * 2 + 2 * D * 2,
                    4 * dh * H * (p + 1) + 2 * D * D, kind)
        del cache, wo, dense
    torch.cuda.empty_cache()
    return rows


#: the TPU kernel bodies the microbench's kernels replace (tools/kbench.py)
#: path (p): the verify rounds' draft length, and K3's positions over the
#: speculative cache (max_ctx 2,048 + 128) for its rows
SPEC_K = 4
SPEC_POS = (127, 1500, 2170)
#: path (p4): the CLI's speculative run, 64 new tokens after CLI_PROMPT
SPEC_CLI_ARGV = ["-q8", "--random-weights", "-greedy", "--spec", str(SPEC_K),
                 "-p", CLI_PROMPT, "--npred", str(len(CLI_PROMPT) + 1 + 64)]


def phase_spec_rows(engine, torch, ops) -> list[dict]:
    """The verify round's kernels at its shapes (T = M = SPEC_K + 1 = 5) on
    the engine's q8 weights against their plain versions, in the
    phase_kernels idiom (CUDA events over a graph of calls, layers cycled):
    K3 over the speculative cache's length S = max_ctx + 128 from pos 127,
    1,500 and 2,170 (captured at pos 127 and replayed at the others; its
    library call SDPA under an explicit causal mask offset by pos), K5, K6
    and K7 at M = 5 and K1 as the lm_head at M = 5 (f32 out)."""
    from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view
    from tinyllama_tpu_torch.runtime.speculative import PAD
    from tinyllama_tpu_torch.tools.kbench import time_ms

    qm, fa, df, ffn, _, _, codec = ops
    cfg, params = engine.cfg, engine.params
    L, dev, M = cfg.n_layers, engine.device, SPEC_K + 1
    D, F = cfg.n_embd, cfg.n_ffn
    H, Kh, d, S = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, engine.max_ctx + PAD
    eps, inside = cfg.norm_eps, cfg.norm_eps_inside_sqrt
    layers = [engine.layer_ids[i:i + 1] for i in range(L)]
    lin = params["layers"]
    gen = torch.Generator(dev)
    gen.manual_seed(17)
    rows = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def dense(name):
        w = lin[name]
        return [codec.dequantize(codec.QTensor(w.data[i], w.scales[i], "q8",
                                               "kn"), torch.bfloat16)
                for i in range(L)]

    def nbytes_of(w):
        return w.data[0].numel() * w.data[0].element_size() + w.scales[0].numel() * 2

    def case(kernel, label, src, rep, fn, plain, lib, nbytes, flops, note=""):
        err = check_close(f"{kernel} {label}", fn(0), plain(0))
        ms = time_ms(fn, 100, True)
        plain_ms = time_ms(plain, 5, False)
        lib_ms = time_ms(lib, 100, True)
        rows.append(kernel_row(kernel, f"{kernel} verify {label}", "q8-spec",
                               src, rep, err, ms, plain_ms, nbytes, flops,
                               lib_ms, note))

    # K3: T = 5 new tokens (40 query rows a kv head) from pos over S
    shape = (L, 1, Kh, S, d)
    cache = KVCache(rand(*shape), rand(*shape))
    dk, dv = layer_cache_view(cache, 3, torch.bfloat16)
    q = rand(1, M, H, d)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    replay_at(f"K3 flash_prefill verify T={M}",
              lambda: fa.flash_prefill_attention(q, cache, layers[3], pos), pos,
              SPEC_POS[0], SPEC_POS[1:])
    for p in SPEC_POS:
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        n_keys = p + M
        kx, vx = dk[:, :, :n_keys], dv[:, :, :n_keys]
        mask = (torch.arange(n_keys, device=dev)[None, :]
                <= p + torch.arange(M, device=dev)[:, None])
        qh = q.transpose(1, 2)
        case("K3 flash_prefill", f"T={M} pos={p} S={S}",
             "tinyllama_tpu_torch/csrc/flash_attention.cu",
             "tinyllama_tpu/ops/pallas/flash_prefill.py:35",
             lambda i, pos=pos: fa.flash_prefill_attention(q, cache,
                                                           layers[i % L], pos),
             lambda i, pos=pos: fa.attention_ref(q, cache, layers[i % L], pos),
             lambda i, kx=kx, vx=vx, mask=mask: (
                 torch.nn.functional.scaled_dot_product_attention(
                     qh, kx, vx, attn_mask=mask, enable_gqa=True)),
             2 * M * H * d * 2 + 2 * Kh * n_keys * 2 * d,
             4 * d * H * sum(p + t + 1 for t in range(M)),
             " (SDPA under a causal mask offset by pos)")
    del cache, dk, dv

    src = "tinyllama_tpu_torch/csrc/decode_fused.cu"
    rep = "tinyllama_tpu/ops/pallas/decode_fused.py"
    x, r = rand(1, M, D), rand(1, M, D)  # the round's [1, T, D]
    wqkv, N = lin["wqkv"], lin["wqkv"].data.shape[-1]
    dq = dense("wqkv")
    case("K5 fused_norm_qkv", f"M={M} K={D} N={N}", src, f"{rep}:49",
         lambda i: df.fused_norm_qkv(x, lin["attn_norm"], wqkv, layers[i % L],
                                     eps, inside),
         lambda i: df.fused_norm_qkv_ref(x, lin["attn_norm"], wqkv,
                                         layers[i % L], eps, inside),
         lambda i: torch.matmul(x.view(M, D), dq[i % L]),
         nbytes_of(wqkv) + M * D * 2 + D * 4 + M * N * 2, 2 * M * D * N)
    del dq
    do = dense("wo")
    case("K6 fused_out_residual", f"M={M} K={D} N={D}", src, f"{rep}:130",
         lambda i: df.fused_out_residual(x, r, lin["wo"], layers[i % L]),
         lambda i: df.fused_out_residual_ref(x, r, lin["wo"], layers[i % L]),
         lambda i: torch.addmm(r.view(M, D), x.view(M, D), do[i % L]),
         nbytes_of(lin["wo"]) + 3 * M * D * 2, 2 * M * D * D)
    del do
    gu, wd = lin["w_gateup"], lin["w_down"]
    dgu, dwd = dense("w_gateup"), dense("w_down")
    case("K7 ffn_fused", f"normed M={M} D={D} F={F}",
         "tinyllama_tpu_torch/csrc/ffn_fused.cu",
         "tinyllama_tpu/ops/pallas/ffn_fused.py:160",
         lambda i: ffn.ffn_fused_normed(x, lin["ffn_norm"], gu, wd,
                                        layers[i % L], cfg),
         lambda i: ffn.ffn_fused_ref(x, lin["ffn_norm"], gu, wd, layers[i % L],
                                     cfg, eps, inside),
         lambda i: torch.matmul(torch.matmul(x.view(M, D), dgu[i % L])[:, :F],
                                dwd[i % L]),
         nbytes_of(gu) + nbytes_of(wd) + 2 * M * D * 2 + D * 4,
         2 * M * 3 * F * D)
    del dgu, dwd
    lm = params["lm_head"]
    lm_dense = codec.dequantize(lm, torch.bfloat16)
    xl = rand(M, D)
    Nv = lm.data.shape[-1]
    case("K1 qmm_smallm", f"lm_head M={M} K={D} N={Nv}",
         "tinyllama_tpu_torch/csrc/qmatmul.cu",
         "tinyllama_tpu/ops/pallas/qmatmul.py:87",
         lambda i: qm.qmatmul(xl, lm, torch.float32),
         lambda i: qm.qmatmul_ref(xl, lm, torch.float32),
         lambda i: torch.matmul(xl, lm_dense),
         lm.data.numel() + lm.scales.numel() * 2 + M * D * 2 + M * Nv * 4,
         2 * M * D * Nv)
    return rows


KBENCH_REPLACES = {
    "kbench_probe_int4": "tools/kbench.py:142",
    "kbench_probe_bitcast": "tools/kbench.py:167",
    "kbench_probe_i32dot": "tools/kbench.py:192",
    "kbench_probe_i8dot": "tools/kbench.py:217",
    "kbench_flash": "tools/kbench.py:273",
    "kbench_flash_flipTpre": "tools/kbench.py:351",
    "kbench_flash_flipT": "tools/kbench.py:405",
    "kbench_i4": "tools/kbench.py:615",
    "kbench_sweep": "tools/kbench.py:776",
    "kbench_sweep_manual": "tools/kbench.py:1338",
}


#: path (q): the local widths of a TP rank a row kind measures: (model,
#: weight kind, tp, layers of path (q)'s engine)
TP_ROWS = {"q8-tp2": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 22, "all"),
           "q8-tp4": ("tinyllama-1.1b-chat-v0.4", "q8", 4, 22, "all"),
           "q4g-tp2": ("tinyllama-1.1b-chat-v0.4", "q4g", 2, 22, "linears"),
           "q8-tp2-kvi8": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 22, "kv"),
           "q8-tp2-overlap": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 22, "ring"),
           "8b-q4-tp2": ("llama-3-8b", "q4", 2, 4, "prefill")}
#: path (q): the keys of a TP row's cache (max_ctx of its engines, and of
#: path (r)'s TinyLlama engines)
TP_S = 2048
#: path (s): the local widths and rows of a data-parallel rank (dp 2 x tp
#: 2; dcn 2 x tp 2) a row kind measures: (model, weight kind, tp, layers,
#: part, the rank's rows of a batch). "dp": K1 and K2 at M = rows and
#: 128 x rows on the four linears, K3 over the rows' prefill, K9 over
#: their staged chunk; "dp-kv" (int8 KV, paged): K3 and K11; "dcn" (a row
#: a rank, paged): K10
DP_ROWS = {"q8-dp2tp2": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 22, "dp", 2),
           "q8-dp2tp2-kvi8": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 22,
                              "dp-kv", 2),
           "q8-dcn2tp2": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 22, "dcn", 1)}


def phase_tp_rows(torch, ops, kind) -> list[dict]:
    """K1-K4 and K9-K11 at one TP rank's local widths (parallel/tp.py
    ``local_config``: heads, kv heads and ffn divided by tp) against their
    plain versions, with their times, bounds and library times, as phase
    3, at each shape path (q) launches for its `kind` (TP_ROWS). "all":
    K1 at M = 1 and K2 at M = 128 on the rank's four linears (random
    weights, one a layer, cycled past the L2; wo and w_down quantized at
    the full d_in and sliced as shard_params slices them), K3 at T = 128,
    K4 at pos 127, K9 at B = 4, K10 at pos 127 and K11 at B = 8 over a
    fill of 128 and a 32-slot tail, over S = TP_S keys; "linears": K1 and
    K2 only; "ring": K1 and K2 on --tp-overlap's chunk-stacked wo and
    w_down (tp_chunk_row_parallel: N / tp columns a chunk); "kv": K3 and
    K4 over an int8 cache; "prefill" (Llama-3-8B, whose path (q) runs a
    prefill): K2 and K3 only. The kinds of DP_ROWS (path (s)) take the
    rank's rows of a batch as B (see there)."""
    from tinyllama_tpu_torch.config import MODEL_REGISTRY
    from tinyllama_tpu_torch.parallel.tp import (
        local_config, tp_chunk_row_parallel,
    )
    from tinyllama_tpu_torch.runtime.kvcache import KVCache, layer_cache_view
    from tinyllama_tpu_torch.runtime.paged import PagedKVCache, paged_layer_view
    from tinyllama_tpu_torch.runtime.staging import StagedKVCache
    from tinyllama_tpu_torch.tools.kbench import time_ms

    qm, fa, _, _, _, fp, codec = ops
    model, wkind, tp, L, part, *rows_of = TP_ROWS.get(kind) or DP_ROWS[kind]
    b = rows_of[0] if rows_of else 1  # the rank's rows (path (s))
    cfg = local_config(MODEL_REGISTRY[model], tp)
    D, H, Kh, d, F = cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_ffn
    dev, S, bf = "cuda", TP_S, torch.bfloat16
    i8 = part in ("kv", "dp-kv")
    gen = torch.Generator(dev)
    gen.manual_seed(11)
    layers = [torch.tensor([i], dtype=torch.int32, device=dev)
              for i in range(L * tp)]
    rows = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def row(kernel, label, src, rep, err, ms, plain, nbytes, flops, lib):
        rows.append(kernel_row(kernel, f"{kernel} {kind} {label}", kind, src,
                               rep, err, ms, plain, nbytes, flops, lib,
                               " (one TP rank's local widths)"))

    def weights(N, K, row_parallel):
        """L layers of a [N, K] linear of the rank: a row-parallel one
        quantized at the full d_in K * tp, then rank 0's d_in slice."""
        w = codec.stack([codec.quantize(
            torch.randn((N, K * tp if row_parallel else K), generator=gen,
                        device=dev) * 0.02, wkind, "kn") for _ in range(L)])
        if not row_parallel:
            return w

        def cut(a):
            return a.narrow(-2, 0, a.shape[-2] // tp).contiguous()

        return codec.QTensor(cut(w.data), cut(w.scales), w.kind, w.layout)

    # K1 / K2 on the rank's column- and row-parallel shards
    shapes = {"wqkv": ((H + 2 * Kh) * d, D), "wo": (D, H * d),
              "w_gateup": (2 * F, D), "w_down": (D, F)}
    names = {"all": shapes, "linears": shapes, "prefill": shapes, "dp": shapes,
             "ring": ("wo", "w_down"), "kv": (), "dp-kv": (), "dcn": ()}[part]
    mats = {n: weights(*shapes[n], n in ("wo", "w_down")) for n in names}
    if part == "ring":
        mats = tp_chunk_row_parallel({"layers": mats}, tp)["layers"]
    src = "tinyllama_tpu_torch/csrc/qmatmul.cu"
    for name, w in mats.items():
        n_w, (N, K) = w.data.shape[0], w.shape[-2:]
        wd = [codec.dequantize(codec.QTensor(w.data[i], w.scales[i], wkind,
                                             "kn"), bf) for i in range(n_w)]
        w_bytes = w.data[0].numel() * w.data.element_size() + w.scales[0].numel() * 2
        for M in {"prefill": (128,), "dp": (b, 128 * b)}.get(part, (1, 128)):
            x = rand(M, K)
            err = check_close(f"{kind} {name} M={M}",
                              qm.qmatmul(x, w, bf, layers[0]),
                              qm.qmatmul_ref(x, w, bf, layers[0]))
            ms = time_ms(lambda i: qm.qmatmul(x, w, bf, layers[i % n_w]), 200,
                         True)
            plain = time_ms(lambda i: qm.qmatmul_ref(x, w, bf,
                                                     layers[i % n_w]), 10, False)
            lib = time_ms(lambda i: torch.matmul(x, wd[i % n_w]), 200, True)
            small = M <= qm.SMALL_M
            q8_line = ("tinyllama_tpu/ops/pallas/qmatmul.py:87" if small
                       else "tinyllama_tpu/ops/pallas/qmatmul.py:288")
            rep = q8_line if wkind == "q8" else REPLACES_4BIT[
                "K1" if small else "K2"][wkind]
            chunked = f" (chunk of {n_w // L})" if part == "ring" else ""
            row("K1 qmm_smallm" if small else "K2 qmm_bigm",
                f"{name}{chunked} M={M} K={K} N={N}", src, rep, err, ms, plain,
                w_bytes + M * K * 2 + M * N * 2, 2 * M * K * N, lib)
        del wd
    del mats
    if part in ("linears", "ring"):
        torch.cuda.empty_cache()
        return rows

    kv = "i8" if i8 else "bf16"
    kv_row = KV_ROW_BYTES[kv](d)

    def attn_row(kernel, label, src, rep, fn, plain, lib, n_keys, pairs, B, T):
        err = check_close(f"{kernel} {kind} {label}", fn(0), plain(0))
        ms = time_ms(fn, 100, True)
        plain_ms = time_ms(plain, 5, False)
        lib_ms = time_ms(lib, 100, True)
        row(kernel, label, src, rep, err, ms, plain_ms,
            2 * Kh * n_keys * kv_row + 2 * B * T * H * d * 2, 4 * d * pairs,
            lib_ms)

    # K3 (T = 128 from pos 0; b rows of path (s)'s prefill) and K4 (pos
    # 127) over a monolithic cache (int8 for "kv" and "dp-kv": its library
    # yardstick SDPA over the dequantized keys)
    cache = as_kv_kind(KVCache(rand(L, b, Kh, S, d), rand(L, b, Kh, S, d)), kv)
    dk, dv = layer_cache_view(cache, 3, bf)
    attn_shapes = {"prefill": ((128, 0),), "dp": ((128, 0),),
                   "dp-kv": ((128, 0),), "dcn": ()}.get(part,
                                                    ((128, 0), (1, 127)))
    for T, p in attn_shapes:
        q = rand(b, T, H, d)
        pos = torch.full((b,), p, dtype=torch.int32, device=dev)
        fn = fa.flash_decode_heads_attention if T == 1 else fa.flash_prefill_attention
        n_keys = p + T
        kx, vx, qh = dk[:, :, :n_keys], dv[:, :, :n_keys], q.transpose(1, 2)
        kernel = "K4" if T == 1 else "K3"
        rep = ("tinyllama_tpu/ops/pallas/flash_prefill.py:" + ("201" if T == 1
                                                               else "35"))
        attn_row(
            "K4 flash_decode_heads" if T == 1 else "K3 flash_prefill",
            (f"B={b} " if b > 1 else "")
            + f"T={T} pos={p} H={H} Kh={Kh} d={d} S={S}" + (" int8" if i8 else ""),
            "tinyllama_tpu_torch/csrc/" + ("decode_split.cu" if T == 1
                                           else "flash_attention.cu"),
            REPLACES_I8[kernel] if i8 else rep,
            lambda i: fn(q, cache, layers[i % L], pos),
            lambda i: fa.attention_ref(q, cache, layers[i % L], pos),
            lambda i: sdpa_gqa(qh, kx, vx, is_causal=T > 1), b * n_keys,
            b * H * sum(p + t + 1 for t in range(T)), b, T)
    del cache, dk, dv
    if part in ("prefill", "kv"):
        torch.cuda.empty_cache()
        return rows

    # K9, K10, K11 at the serving shapes of path (q): generate_batch's B = 4
    # staged chunk (monolithic), a paged b1 step, the batcher's B = 8
    # staged chunk over the pool; path (s)'s at the rank's rows
    P, fill, tail = 256, 128, 32
    k9 = ("K9 flash_staged", 4, False, True, "flash_prefill.py:375")
    k10 = ("K10 flash_paged", 1, True, False, "flash_paged.py:38")
    k11 = ("K11 flash_paged_staged", 8, True, True, "flash_paged.py:171")
    cases = {"all": (k9, k10, k11), "dp": ((*k9[:1], b, *k9[2:]),),
             "dp-kv": ((*k11[:1], b, *k11[2:4], "flash_paged.py:194"),),
             "dcn": (k10,)}[part]
    for kernel, B, paged, staged, rep in cases:
        q = rand(B, 1, H, d)
        if paged:
            table = torch.zeros((B, S // P), dtype=torch.int32, device=dev)
            table[:, 0] = 1 + torch.arange(B, device=dev, dtype=torch.int32)
            pool = as_kv_kind(PagedKVCache(rand(L, 1 + B, Kh, P, d),
                                      rand(L, 1 + B, Kh, P, d), table), kv)
            kd, vd = paged_layer_view(pool, 3, bf)
        else:
            pool = as_kv_kind(KVCache(rand(L, B, Kh, S, d), rand(L, B, Kh, S, d)), kv)
            kd, vd = layer_cache_view(pool, 3, bf)
        base = torch.full((B,), fill, dtype=torch.int32, device=dev)
        kx, vx = kd[:, :, :fill], vd[:, :, :fill]
        if staged:
            t = as_kv_kind(KVCache(rand(L, B, Kh, 32, d), rand(L, B, Kh, 32, d)), kv)
            arg = StagedKVCache(pool, t.k, t.v, base, sk_scale=t.k_scale,
                                sv_scale=t.v_scale)
            pos = base + (tail - 1)
            fn = (fp.flash_paged_staged_attention if paged
                  else fa.flash_staged_attention)
            plain = fp.staged_attention_ref
            tk, tv = layer_cache_view(t, 3, bf)
            kx = torch.cat([kx, tk[:, :, :tail]], dim=2)
            vx = torch.cat([vx, tv[:, :, :tail]], dim=2)
            label = f"B={B} fill={fill} tail={tail} H={H} Kh={Kh}"
        else:
            arg, pos = pool, base - 1
            fn, plain = fp.flash_paged_attention, fp.paged_attention_ref
            label = f"B={B} pos={fill - 1} P={P} H={H} Kh={Kh}"
        n_keys = kx.shape[2]
        qh = q.transpose(1, 2)
        attn_row(kernel, label + (" int8" if i8 else ""),
                 "tinyllama_tpu_torch/csrc/decode_split.cu",
                 f"tinyllama_tpu/ops/pallas/{rep}",
                 lambda i: fn(q, arg, layers[i % L], pos),
                 lambda i: plain(q, arg, layers[i % L], pos),
                 lambda i: sdpa_gqa(qh, kx, vx), B * n_keys, B * H * n_keys, B, 1)
        del pool, arg, kd, vd, kx, vx
    torch.cuda.empty_cache()
    return rows


def rank_task(mesh, model, kind, seed, layers, steps, S=TP_S, refused=False,
              reference=False, **kw):
    """One rank of paths (q) and (r): Engine(mesh=mesh, **kw) (tp from the
    mesh; path (r) passes sp, the mesh's dp) over `kind` weights of `model` (cut to `layers` if given)
    drawn on the card from `seed` (the same on every rank: the tp = sp = 1
    engine's weights) and kept in host memory, as the CLI keeps them, so
    the engine copies only the rank's shard to the card; max_ctx S. Then
    each step of `steps`, its launch counts set to 0 just before it and
    read just after, with the shape of each prefill (("sp", Tl) for the
    sequence-parallel route, else (rows, bucket)) and chunk, and the
    card's peak in it. A step: ("prefill", prompts[, cache_layers]) ->
    last-token logits (with cache_layers, one prompt: the digest of the
    cache's rows of those layers and, on rank 0, the rows);
    ("generate", prompt, n) -> ids; ("generate_batch", prompts, n) ->
    ids; ("topk_batch", prompts, n) -> generate_batch's ids at top-k 40
    (temperature 0.9, seed 17); ("batcher", prompts, n, slots) -> ids by
    request;
    ("all_reduce", n) -> ms of one all-reduce of a [1, 1, n_embd] bf16
    row, back to back; ("timed", prompt, reps, synced) -> the prefill's
    ms (best of reps), and with `synced` one more run with a sync around
    each ring hop, the K/V gather and the cache writes: their ms. With
    `refused`, the engine is expected to refuse (a ValueError, whose
    text returns). Over a mesh whose batch group carries rows (path (s)),
    a prefill's shape is this rank's rows and bucket, and with
    `reference` a second engine over the same weights runs on the rank's
    model group alone (``Mesh.model_mesh``: dp 1 x tp): the steps
    ("ref_prefill", prompts) and ("ref_generate_batch", prompts, n) run
    it on this rank's rows of prompts only."""
    import hashlib

    import torch

    from tinyllama_tpu_torch.config import (
        GenerationConfig, MODEL_REGISTRY, POLICIES,
    )
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import (
        attn_out_fused, decode_fused, ffn_fused, flash_attention,
        flash_paged, qmatmul,
    )
    from tinyllama_tpu_torch.parallel import sp as spmod
    from tinyllama_tpu_torch.runtime.engine import Engine, _bucket
    from tinyllama_tpu_torch.runtime.perf import tree_nbytes
    from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher

    counters = (qmatmul.launches, flash_attention.launches,
                decode_fused.launches, ffn_fused.launches,
                attn_out_fused.launches, flash_paged.launches)
    # the engines of earlier calls (they and their chunk graphs hold each
    # other) go now, so the card's readings below are this call's
    gc.collect()
    torch.cuda.empty_cache()
    cfg = MODEL_REGISTRY[model]
    cfg = cfg.replace(n_layers=layers) if layers else cfg
    policy = POLICIES[kind]
    g = torch.Generator("cuda")
    g.manual_seed(seed)
    t0 = time.perf_counter()
    params = llama.init_quantized_params(cfg, policy, g, "cuda", "cpu")
    full_bytes = tree_nbytes(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = Engine(cfg, policy, params, max_ctx=S, mesh=mesh, **kw)
    except ValueError as e:
        if refused:
            return {"refused": str(e)}
        raise
    if refused:
        raise AssertionError("the engine was built where it must refuse")
    ref = (Engine(cfg, policy, params, max_ctx=S, mesh=mesh.model_mesh(), **kw)
           if reference else None)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # what building the engine took on the card, against its shard
    memory = {"init_s": init_s, "peak": torch.cuda.max_memory_allocated() - base,
              "shard": tree_nbytes(eng.params), "full": full_bytes,
              "lm_head": tree_nbytes(eng.params["lm_head"])}
    record = {"prefill": [], "chunk": []}

    def recording(e):
        """Wrap e's prefill and run_chunk to record their shapes."""
        prefill, run_chunk = e.prefill, e.run_chunk

        def rec_prefill(cache, prompts):
            mine = prompts[e.batch_rows(len(prompts))]
            n = max(len(p) for p in mine)
            record["prefill"].append(
                ("sp", spmod.padded_length(n, e.sp) // e.sp)
                if e.sp > 1 and len(prompts) == 1
                else (len(mine), _bucket(n, e.max_ctx)))
            return prefill(cache, prompts)

        def rec_chunk(cache, logits, pos, C, *a, **k):
            record["chunk"].append((logits.shape[0], C))
            return run_chunk(cache, logits, pos, C, *a, **k)

        e.prefill, e.run_chunk = rec_prefill, rec_chunk

    def timed_prefill(prompt, reps, synced):
        cache = eng.new_cache(1)
        best = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.prefill(cache, [prompt])
            torch.cuda.synchronize()
            best.append((time.perf_counter() - t1) * 1e3)
        out = {"ms": min(best)}
        if not synced:
            return out
        spent = {"hops": 0.0, "gather": 0.0, "writes": 0.0}

        def timed(key, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res_ = fn(*a, **k)
                torch.cuda.synchronize()
                spent[key] += (time.perf_counter() - t1) * 1e3
                return res_
            return run

        Mesh = type(mesh)  # a frozen dataclass: patched on the class
        saved = (Mesh.data_ring_shift, Mesh.data_all_gather,
                 spmod.update_cache_at_layer, spmod.update_paged_at_layer)
        Mesh.data_ring_shift = timed("hops", saved[0])
        Mesh.data_all_gather = timed("gather", saved[1])
        spmod.update_cache_at_layer = timed("writes", saved[2])
        spmod.update_paged_at_layer = timed("writes", saved[3])
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.prefill(cache, [prompt])
            torch.cuda.synchronize()
            spent["total"] = (time.perf_counter() - t1) * 1e3
        finally:
            (Mesh.data_ring_shift, Mesh.data_all_gather,
             spmod.update_cache_at_layer, spmod.update_paged_at_layer) = saved
        return {**out, **spent}

    for e in (eng, ref):
        if e is not None:
            recording(e)
    gcfg = GenerationConfig(n_predict=S, greedy=True, eos_token=-1,
                            chunk_size=32)
    results = []
    for step in steps:
        what = step[0]
        if what == "generate" and eng.graph_stats["route"] == "graph":
            # capture the b1 chunk first (its C follows from the step's n),
            # so the step times its replays
            eng.generate(step[1][:16], dataclasses.replace(
                gcfg, n_predict=16 + step[2]))
        if what.endswith("generate_batch") and eng.graph_stats["route"] == "graph":
            # the same for a batch's chunk (path (s)): run it once before
            e = ref if what.startswith("ref_") else eng
            prompts = step[1][eng.batch_rows(len(step[1]))] if e is ref else step[1]
            e.generate_batch(prompts, dataclasses.replace(
                gcfg, n_predict=max(map(len, prompts)) + step[2]))
        for c in counters:
            for k in c:
                c[k] = 0
        record["prefill"].clear()
        record["chunk"].clear()
        torch.cuda.reset_peak_memory_stats()
        res = {"what": what}
        t0 = time.perf_counter()
        if what == "prefill":
            cache = eng.new_cache(len(step[1]))
            logits, _ = eng.prefill(cache, step[1])
            res["out"] = logits.float().cpu().numpy()
            if len(step) > 2:
                rows = cache_rows(cache, len(step[1][0]), step[2])
                res["digest"] = hashlib.sha1(rows.tobytes()).hexdigest()
                if mesh.rank == 0:
                    res["cache"] = rows
            del cache
        elif what == "generate":
            res["out"], stats = eng.generate(step[1], dataclasses.replace(
                gcfg, n_predict=len(step[1]) + step[2]))
            res["ms_per_token"] = stats.ms_per_token
            res["prefill_ms"] = stats.prefill_s * 1e3
        elif what in ("generate_batch", "ref_generate_batch"):
            e, prompts = ((ref, step[1][eng.batch_rows(len(step[1]))])
                          if what == "ref_generate_batch" else (eng, step[1]))
            res["out"], stats = e.generate_batch(prompts, dataclasses.replace(
                gcfg, n_predict=max(map(len, prompts)) + step[2]))
            res["ms_per_step"] = stats.decode_s * 1e3 / max(stats.decode_steps, 1)
        elif what == "topk_batch":
            res["out"], _ = eng.generate_batch(step[1], dataclasses.replace(
                gcfg, n_predict=max(map(len, step[1])) + step[2], greedy=False,
                top_k=40, temperature=0.9, seed=17))
        elif what == "ref_prefill":
            mine = step[1][eng.batch_rows(len(step[1]))]
            logits, _ = ref.prefill(ref.new_cache(len(mine)), mine)
            res["out"] = logits.float().cpu().numpy()
        elif what == "batcher":
            b = ContinuousBatcher(eng, gcfg, max_batch=step[3])
            for p in step[1]:
                b.submit(p, max_new=step[2])
            done = b.run()
            res["out"] = {i: r.output for i, r in done.items()}
            res["threshold"] = b.sp_admit_threshold
        elif what == "all_reduce":
            x = torch.zeros((1, 1, cfg.n_embd), dtype=torch.bfloat16,
                            device="cuda")
            mesh.all_reduce(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(step[1]):
                mesh.all_reduce(x)
            torch.cuda.synchronize()
            res["out"] = (time.perf_counter() - t0) * 1e3 / step[1]
        elif what == "timed":
            res["out"] = timed_prefill(*step[1:])
        torch.cuda.synchronize()
        res["s"] = time.perf_counter() - t0
        res["peak"] = torch.cuda.max_memory_allocated()
        res["counts"] = {k: v for c in counters for k, v in c.items()}
        res["record"] = {k: list(v) for k, v in record.items()}
        results.append(res)
    return {"steps": results, "route": eng.graph_stats["route"],
            "backend": mesh.backend, "sp": eng.sp, "tp_rank": mesh.tp_rank,
            "batch": eng.batch, "batch_rank": eng.batch_rank,
            # the planes of generate and generate_batch's caches
            "cache_bytes": sum(tree_nbytes(c) for c in eng._caches.values()),
            "build_s": build_s, "cache_heads": eng.new_cache(eng.batch).k.shape[2],
            "memory": memory, "memory_reserved": torch.cuda.memory_reserved()}


def same_on_ranks(path: str, res: list, i: int) -> dict:
    """Step i on every rank of a pool's run: the same output bit for bit
    (a timed step's clock readings are each rank's own; a cache digest is
    compared among the ranks holding rank 0's kv heads), the same counts
    and shapes. Returns rank 0's step."""
    import numpy as np

    s0 = res[0]["steps"][i]
    for rank, r in enumerate(res[1:], 1):
        s = r["steps"][i]
        out_same = (s0["what"] == "timed"
                    or (np.array_equal(s["out"], s0["out"])
                        if isinstance(s0["out"], np.ndarray)
                        else s["out"] == s0["out"]))
        if not out_same or ("digest" in s0 and r["tp_rank"] == 0
                            and s["digest"] != s0["digest"]):
            raise AssertionError(f"path {path}: rank {rank}'s output is not "
                                 "rank 0's")
        if s["counts"] != s0["counts"] or s["record"] != s0["record"]:
            raise AssertionError(f"path {path}: rank {rank}'s launches "
                                 f"{s['counts']} are not rank 0's "
                                 f"{s0['counts']}")
    return s0


#: path (r): the rows of a sequence-parallel rank a row kind measures:
#: (model, weight kind, sp, prompt tokens of path (r)'s prefill)
SP_ROWS = {"q8-sp2": ("tinyllama-1.1b-chat-v0.4", "q8", 2, 1450),
           "q8-sp4": ("tinyllama-1.1b-chat-v0.4", "q8", 4, 1450),
           "8b-q4-sp2": ("llama-3-8b", "q4", 2, 7000)}


def cache_rows(cache, n: int, layers) -> "np.ndarray":
    """Positions [0, n) of `layers` of a B = 1 cache (monolithic or paged,
    int8 dequantized), as float16 numpy [len(layers), 2, Kh, n, d]."""
    import numpy as np
    import torch

    from tinyllama_tpu_torch.runtime.kvcache import layer_cache_view
    from tinyllama_tpu_torch.runtime.paged import PagedKVCache, paged_layer_view

    view = (paged_layer_view if isinstance(cache, PagedKVCache)
            else layer_cache_view)
    out = [torch.stack([p[0, :, :n] for p in view(cache, li, torch.float32)])
           for li in layers]
    return np.stack([o.half().cpu().numpy() for o in out])


def phase_sp_rows(torch, ops) -> list[dict]:
    """The kernels of path (r)'s sequence-parallel prefill at one rank's
    shapes against their plain versions, with their times, bounds and
    library times (torch.matmul on the dequantized bf16 weight), as
    phase 3: K2 on the four linears at the Tl rows of SP_ROWS's prompts
    (TinyLlama q8 at sp 2 and 4, Llama-3-8B q4 at sp 2; random weights,
    two layers, full widths: a rank at tp 1 holds every weight), K1 on
    the lm_head (M = 1, f32 out, vocab padded). Then the ring's hop: one
    _block_update over the rank's own (causal) block and over an earlier
    (unmasked) one, timed beside K3 over the same keys (T = Tl from pos
    0) and SDPA (is_causal, enable_gqa), at TinyLlama sp 2 and Llama-3-8B
    sp 2; printed, not rows (the hop is PyTorch, not a kernel)."""
    from tinyllama_tpu_torch.config import MODEL_REGISTRY
    from tinyllama_tpu_torch.models.llama import pad_lm_head_vocab
    from tinyllama_tpu_torch.parallel import ring
    from tinyllama_tpu_torch.parallel.sp import padded_length
    from tinyllama_tpu_torch.runtime.kvcache import KVCache
    from tinyllama_tpu_torch.tools.kbench import time_ms

    qm, fa, _, _, _, _, codec = ops
    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(dev)
    gen.manual_seed(19)
    layers = [torch.tensor([i], dtype=torch.int32, device=dev)
              for i in range(2)]
    rows = []
    src = "tinyllama_tpu_torch/csrc/qmatmul.cu"

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    for kind, (model, wkind, sp, n) in SP_ROWS.items():
        cfg = MODEL_REGISTRY[model]
        D, H, Kh, d, F = (cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.n_ffn)
        Tl = padded_length(n, sp) // sp
        shapes = {"wqkv": ((H + 2 * Kh) * d, D), "wo": (D, H * d),
                  "w_gateup": (2 * F, D), "w_down": (D, F)}
        cases = [(name, Tl, N, K, bf, 2) for name, (N, K) in shapes.items()]
        if sp == 2:
            cases.append(("lm_head", 1, cfg.n_vocab, D, torch.float32, 1))
        for name, M, N, K, out, n_w in cases:
            w = codec.stack([codec.quantize(
                torch.randn((N, K), generator=gen, device=dev) * 0.02, wkind,
                "kn") for _ in range(n_w)])
            if name == "lm_head":  # as the engine pads it
                w = pad_lm_head_vocab({"lm_head": codec.QTensor(
                    w.data[0], w.scales[0], wkind, "kn")})["lm_head"]
                N = w.shape[-2]
            lay = [None] if n_w == 1 else layers
            wd = [codec.dequantize(w if n_w == 1 else codec.QTensor(
                w.data[i], w.scales[i], wkind, "kn"), bf) for i in range(n_w)]
            x = rand(M, K)
            err = check_close(f"{kind} {name} M={M}",
                              qm.qmatmul(x, w, out, lay[0]),
                              qm.qmatmul_ref(x, w, out, lay[0]))
            ms = time_ms(lambda i: qm.qmatmul(x, w, out, lay[i % n_w]), 50,
                         True)
            plain = time_ms(lambda i: qm.qmatmul_ref(x, w, out, lay[i % n_w]),
                            3, False)
            lib = time_ms(lambda i: torch.matmul(x, wd[i % n_w]), 50, True)
            small = M <= qm.SMALL_M
            rep = (("tinyllama_tpu/ops/pallas/qmatmul.py:87" if small
                    else "tinyllama_tpu/ops/pallas/qmatmul.py:288")
                   if wkind == "q8"
                   else REPLACES_4BIT["K1" if small else "K2"][wkind])
            per = w.data.numel() // n_w * w.data.element_size() + \
                w.scales.numel() // n_w * w.scales.element_size()
            kernel = "K1 qmm_smallm" if small else "K2 qmm_bigm"
            rows.append(kernel_row(
                kernel, f"{kernel} {kind} {name} M={M} K={K} N={N}", kind, src,
                rep, err, ms, plain,
                per + M * K * 2 + M * N * out.itemsize, 2 * M * K * N, lib,
                f" (an SP rank's {M} rows)" if not small
                else " (the SP prefill's lm_head)"))
            del w, wd
        torch.cuda.empty_cache()
        if sp != 2:
            continue
        # the ring's hop at this rank's Tl: the merge of one block (the
        # rank's own, causal; an earlier one, unmasked) beside K3 and SDPA
        # over the same Tl keys
        q, k, v = rand(1, Tl, H, d), rand(1, Tl, Kh, d), rand(1, Tl, Kh, d)
        G = H // Kh
        qr = q.permute(0, 2, 1, 3).reshape(Kh, G * Tl, d)
        kb, vb = (x.permute(0, 2, 1, 3).reshape(Kh, Tl, d) for x in (k, v))
        pos = torch.arange(Tl, device=dev)
        causal = (pos[None, :] <= pos[:, None]).repeat(G, 1)

        def merge(mask):
            m = torch.full((Kh, G * Tl, 1), float("-inf"), device=dev)
            l, acc = torch.zeros_like(m), torch.zeros((Kh, G * Tl, d),
                                                      device=dev)
            ring._merge(qr, kb, vb, mask, m, l, acc, 1.0 / d ** 0.5)

        hop_diag = time_ms(lambda i: merge(causal), 5, False)
        hop_full = time_ms(lambda i: merge(None), 5, False)
        S = -(-Tl // 64) * 64
        kc, vc = (torch.zeros((1, 1, Kh, S, d), dtype=bf, device=dev)
                  for _ in range(2))
        kc[0, 0, :, :Tl], vc[0, 0, :, :Tl] = kb, vb
        cache, zero = KVCache(kc, vc), torch.zeros(1, dtype=torch.int32,
                                                   device=dev)
        k3 = time_ms(lambda i: fa.flash_prefill_attention(q, cache, zero,
                                                          zero), 20, True)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), 20, True)
        pairs = H * Tl * (Tl + 1) // 2
        k3_bound = max((2 * Tl * H * d + 2 * Tl * Kh * d) * 2 / HBM_BW,
                       4 * d * pairs / PEAK_BF16) * 1e3
        print(f"hop {kind}: one _block_update at Tl={Tl} (H={H}, Kh={Kh}, "
              f"d={d}): {hop_diag:.4f} ms over the rank's own causal block, "
              f"{hop_full:.4f} ms over an earlier unmasked one (PyTorch: f32 "
              f"scores on the tensor cores, sliced at {ring.SCORE_BYTES >> 20} "
              f"MiB); K3 over the same {Tl} causal keys {k3:.4f} ms (bound "
              f"{k3_bound:.4f} ms), SDPA is_causal {sdpa:.4f} ms",
              flush=True)
        del q, k, v, qr, kb, vb, kc, vc, cache
        torch.cuda.empty_cache()
    return rows


def kbench_replaces(counter: str) -> str:
    for key in sorted(KBENCH_REPLACES, key=len, reverse=True):
        if counter.startswith(key):
            return KBENCH_REPLACES[key]
    raise KeyError(counter)


def phase_kbench(torch) -> list[dict]:
    """The microbench's entry point on the card (the main path of the
    kbench kernels): P1-P4, KF's 11 variants at T = 2048, KI's two
    bodies at the five shapes, KS's 26 variants at wqkv and cur, dq,
    stream and manual at the other four shapes (manual but at lm_head,
    which the JAX tool skips), with the launch counts read around it.
    The entry point holds each kernel against its plain version (one
    launch a case, not counted here) before it times it. Fails if a
    kernel was not launched outside its check or a time is under its
    bound."""
    from tinyllama_tpu_torch.ops.kernels import kbench_flash as kf
    from tinyllama_tpu_torch.ops.kernels import kbench_i4 as ki
    from tinyllama_tpu_torch.ops.kernels import kbench_probe as kp
    from tinyllama_tpu_torch.ops.kernels import kbench_sweep as ks
    from tinyllama_tpu_torch.tools import kbench

    counters = (kp.launches, kf.launches, ki.launches, ks.launches)
    runs = [["--bench", "probe"], ["--bench", "flash", "--m", "2048"],
            ["--bench", "i4"],
            ["--bench", "sweep", "--shape", "wqkv", "--variants",
             ",".join(ks.VARIANTS + ("manual",))]]
    runs += [["--bench", "sweep", "--shape", n, "--variants", "cur,dq,stream,manual"]
             for n in ("wo", "w_gateup", "w_down", "lm_head")]
    for c in counters:
        for k in c:
            c[k] = 0
    timed = []
    for argv in runs:
        args = kbench.parse(argv + ["--iters", "20"])
        timed += [(args.bench, r) for r in kbench.run(args)]
    torch.cuda.synchronize()
    counts = {k: v for c in counters for k, v in c.items()}
    checks = collections.Counter(r["counter"] for _, r in timed)
    launches = {k: v - checks[k] for k, v in counts.items()}
    print(f"kbench: launches outside the checks {json.dumps(launches)}", flush=True)
    rows = []
    for bench, r in timed:
        if r["ms"] < r["bound_ms"]:
            raise AssertionError(f"kbench {r['name']}: {r['ms']} ms under its "
                                 f"bound {r['bound_ms']} ms: L2 was measured")
        if not launches[r["counter"]]:
            raise AssertionError(f"kbench {r['name']}: {r['counter']} was not "
                                 "launched by the microbench")
        rows.append(dict(
            name=f"{r['counter']} {' '.join(r['name'].split())}", route="cuda",
            source=f"tinyllama_tpu_torch/csrc/kbench_{bench}.cu",
            replaces=kbench_replaces(r["counter"]), launches=launches[r["counter"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
        fin = (f", finiteness differs at {r['finite_mismatch']:.4%}"
               if "finite_mismatch" in r else "")
        print(f"kernel {rows[-1]['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['mode']}{fin}) kernel_ms {r['ms']:.5f} bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}) plain_ms {r['plain_ms']:.5f} "
              f"library_ms {r['library_ms']}"
              + (f" ({r['library_note']})" if r["library_note"] else ""), flush=True)
    return rows


def profile_decode(engine, prompt, torch, steps: int = 4) -> None:
    """Where an eager decode step's time goes, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = engine.new_cache(1)
    engine.prefill(cache, [prompt])
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    for _ in range(3):
        engine.decode_step(cache, tok, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.decode_step(cache, tok, pos)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.elapsed_us() / 1e3
    dev_ms = sum(t for _, t in by_name.values()) / steps
    port = {name: v for name, v in by_name.items()
            if any(k in name for k in ("qmm_", "flash_", "fused_", "walk_kernel",
                                       "decode_split"))}
    ours = sum(t for _, t in port.values()) / steps
    n_ours = sum(c for c, _ in port.values()) / steps
    print(f"profile: {len(kernels) / steps:.1f} device kernels a decode step "
          f"at pos {len(prompt)}, {n_ours:.1f} of them the port's; device "
          f"busy {dev_ms:.4f} ms of {host_ms:.4f} ms host time a step "
          f"(profiler on); the port's kernels {ours:.4f} ms, other PyTorch "
          f"ops {dev_ms - ours:.4f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (count, ms) in top:
        print(f"profile:   {ms / steps:9.4f} ms  {count / steps:6.1f}x  {name[:90]}")


def main() -> int:
    t_start = time.perf_counter()
    last_mark = [t_start]

    def mark(what: str) -> None:
        """The script's seconds so far, and on a line of its own those
        since the last mark (each path's, or phase's, own)."""
        now = time.perf_counter()
        print(f"elapsed: {what} done at {now - t_start:.1f} s", flush=True)
        print(f"seconds: {what} {now - last_mark[0]:.1f} s", flush=True)
        last_mark[0] = now
    if not (ROOT / "tinyllama_tpu_torch" / "csrc").is_dir():
        return fail("the tinyllama_tpu_torch package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from tinyllama_tpu_torch import cli
    from tinyllama_tpu_torch.config import (
        GenerationConfig, POLICIES, TINYLLAMA_1_1B,
    )
    from tinyllama_tpu_torch.io import checkpoint, tokenizer
    from tinyllama_tpu_torch.models import llama
    from tinyllama_tpu_torch.ops.kernels import attn_out_fused as ao
    from tinyllama_tpu_torch.ops.kernels import build
    from tinyllama_tpu_torch.ops.kernels import decode_fused as df
    from tinyllama_tpu_torch.ops.kernels import ffn_fused as ffn
    from tinyllama_tpu_torch.ops.kernels import flash_attention as fa
    from tinyllama_tpu_torch.ops.kernels import flash_paged as fp
    from tinyllama_tpu_torch.ops.kernels import qmatmul as qm
    from tinyllama_tpu_torch.quant import codec
    from tinyllama_tpu_torch.runtime.engine import Engine
    from tinyllama_tpu_torch.runtime.engine import _bucket as engine_bucket
    from tinyllama_tpu_torch.runtime.perf import tree_nbytes
    from tinyllama_tpu_torch.runtime import speculative, trace
    from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher
    from tinyllama_tpu_torch.runtime.staging import stage_cache
    from tinyllama_tpu_torch.tools import kbench, profile_check
    from tinyllama_tpu_torch.tools.kbench import time_ms

    # 1. card
    card = kbench.card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(card, flush=True)

    #: --tp-only / --sp-only / --dp-only / --tiny-only: the build, then
    #: path (q) / (r) / (s) / (t) alone (the first three for a machine of
    #: several cards, where their ranks run NCCL)
    tp_only = sys.argv[1:] == ["--tp-only"]
    sp_only = sys.argv[1:] == ["--sp-only"]
    dp_only = sys.argv[1:] == ["--dp-only"]
    tiny_only = sys.argv[1:] == ["--tiny-only"]
    only = tp_only or sp_only or dp_only or tiny_only

    def finish(rows, kb_rows) -> int:
        for r in rows:
            del r["kernel"], r["kind"]
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the builds "
              "included")
        print(json.dumps({"kernels": rows + kb_rows}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # path (h)'s files, written by a child process while the kernels build
    # and phase 3 runs (host numpy, ~40 s); stopped and removed at exit
    files = tempfile.TemporaryDirectory()
    ckpt = Path(files.name) / "tinyllama.q4.gten"
    vocab = Path(files.name) / "tokenizer.bin"
    atexit.register(files.cleanup)
    if not only:
        writer = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--write-checkpoint", str(ckpt), str(vocab)],
                                  stdout=subprocess.PIPE, text=True)
        atexit.register(lambda: writer.poll() is None and writer.kill())

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (log, seconds) in logs.items():
        print(f"  {name}: built in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions, on the main path's weights
    policy = POLICIES["q8"]
    cfg = TINYLLAMA_1_1B
    gen = torch.Generator("cuda")
    gen.manual_seed(1234)
    t0 = time.perf_counter()
    params = llama.init_quantized_params(cfg, policy, gen, "cuda")
    engine = Engine(cfg, policy, params, max_ctx=2048, device="cuda")
    torch.cuda.synchronize()
    print(f"init: TinyLlama-1.1B q8 random weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ops = (qm, fa, df, ffn, ao, fp, codec)
    rows, kb_rows = [], []
    if not only:
        rows = phase_kernels(engine, torch, ops)
        rows += phase_kernels(engine, torch, ops, kv="i8")
        rows += phase_kernels(engine, torch, ops, aq8=True)
        for kv in ("f16", "f32"):
            rows += phase_kernels(engine, torch, ops, kv=kv)
        mark("phase 3")
        kb_rows = phase_kbench(torch)
        mark("kbench")

    # 4. paths, each with exact launch counts
    counters = (qm.launches, fa.launches, df.launches, ffn.launches,
                ao.launches, fp.launches)
    #: launches summed over the paths of each policy: (a)-(g) are q8, (h)
    #: and (i) run q4 and q4g, (j) q8-kvi8, (k) q8a8 and q4a8, (l)
    #: q8-kvf16 and q8-kvf32, (h)'s last runs q4-kvi8 and q4-kvf16
    totals = {kind: {k: 0 for c in counters for k in c}
              for kind in ("q8", "q4", "q4g", "q8-kvi8", "q4-kvi8", "q8a8",
                           "q4a8", "q8-kvf16", "q8-kvf32", "q4-kvf16", "f16",
                           "bf16", "f32")}

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0

    def expect(path, kind="q8", tally=True, **want):
        """The launch counts of a path of policy `kind` must be `want`
        (by the bf16, weight-only names, moved by counter_name); with
        `tally` they add to the kind's totals."""
        got = {k: v for c in counters for k, v in c.items()}
        moved = {}
        for k, v in want.items():
            k = counter_name(k, kind)
            moved[k] = moved.get(k, 0) + v
        want = {k: moved.get(k, 0) for k in got}
        print(f"path {path}: launches {json.dumps(got)}", flush=True)
        if got != want:
            raise AssertionError(f"path {path}: launch counts {got}, want {want}")
        for k, v in got.items():
            totals[kind][k] += v if tally else 0

    L = cfg.n_layers
    rng = np.random.default_rng(0)

    def prompt_of(n):
        return [1] + rng.integers(2, cfg.n_vocab, n - 1).tolist()

    def generate(prompt, n_new, eng=None):
        gcfg = GenerationConfig(n_predict=len(prompt) + n_new, greedy=True,
                                eos_token=-1, chunk_size=32)
        reset()
        out, stats = (eng or engine).generate(prompt, gcfg)
        torch.cuda.synchronize()
        steps = stats.decode_steps
        if len(out) != n_new or steps != n_new or not all(
                0 <= t < cfg.n_vocab for t in out):
            raise AssertionError(f"generated {len(out)} tokens in {steps} "
                                 "steps, or ids out of range")
        return out, stats

    def graph_step(eng, prompt_, at):
        """One b1 decode step at pos `at` after prefilling prompt_,
        replayed as a CUDA graph, ms."""
        cache = eng.new_cache(1)
        eng.prefill(cache, [prompt_])
        tok = torch.tensor([5], dtype=torch.int32, device="cuda")
        pos = torch.tensor([at], dtype=torch.int32, device="cuda")
        return time_ms(lambda i: eng.decode_step(cache, tok, pos), 20, True)

    long_prompt = prompt_of(LONG_PROMPT)

    def long_step(path, eng, kind):
        """The long-context b1 step: a LONG_PROMPT-token prompt and 64
        greedy tokens with exact launch counts (eager ms/token), then one
        step at pos LONG_POS replayed as a CUDA graph."""
        gcfg = GenerationConfig(n_predict=LONG_PROMPT + 64, greedy=True,
                                eos_token=-1, chunk_size=32)
        (out, stats), record, want = recorded(
            eng, eng.paged, lambda: eng.generate(long_prompt, gcfg))
        if not ids_ok([out], [64]) or stats.decode_steps != 64:
            raise AssertionError(f"path {path} long: {len(out)} ids in "
                                 f"{stats.decode_steps} steps")
        expect(f"{path} {LONG_PROMPT}-token prompt", kind, **want)
        ms = graph_step(eng, long_prompt, LONG_POS)
        print(f"path {path}: {LONG_PROMPT}-token prompt: prefill "
              f"{stats.prefill_s * 1e3:.3f} ms (bucket "
              f"{engine_bucket(LONG_PROMPT, eng.max_ctx)}, eager, host clock); "
              f"b1 decode after it: "
              f"{stats.ms_per_token:.4f} ms/token over 64 tokens (pos "
              f"{LONG_PROMPT}-{LONG_PROMPT + 63}); one step at pos {LONG_POS} "
              f"replayed as a CUDA graph {ms:.4f} ms{notes['first_use']}; card "
              f"{card}", flush=True)

    def graphs_of(engs):
        engs = engs if isinstance(engs, list) else [engs]
        return (sum(e.graph_stats["graphs"] for e in engs),
                sum(e.graph_stats["capture_s"] for e in engs),
                torch.cuda.memory_reserved())

    def first_use(engs, before):
        """The note of a run whose chunks met keys with no graph yet (their
        first chunks ran eagerly and were captured, in its time)."""
        n, sec, _ = graphs_of(engs)
        n, sec = n - before[0], sec - before[1]
        return (f" (first use of {n} chunk graph key{'s' * (n != 1)}: its "
                f"first chunk eager, then captured, {sec:.3f} s, included)"
                if n else "")

    #: the last recorded run's first_use note
    notes = {"first_use": ""}

    # the serving paths: exact counts from the shapes each path ran at
    def qmm(M):
        return "qmm_smallm" if M <= qm.SMALL_M else "qmm_bigm"

    def prefill_counts(c, b, T, paged, unfused):
        """An admission of b rows at bucket T from position 0 (a paged
        prefill attends its own keys: flash_prefill_own); `unfused`: the
        fused branch is closed (aq8, or n_embd above 2,048)."""
        attend = "flash_prefill_own" if paged else "flash_prefill"
        if b * T <= 32 and not unfused:  # the fused branch
            for k in ("fused_norm_qkv", attend, "fused_out_residual",
                      "ffn_fused_normed"):
                c[k] += L
        else:
            c[qmm(b * T)] += 4 * L
            c[attend] += L
        c[qmm(b)] += 1

    def chunk_counts(c, B, C, paged, unfused):
        attend = ({True: "flash_paged_staged", False: "flash_staged"}[paged]
                  if B > 1 else "flash_paged" if paged
                  else "flash_decode_heads" if unfused else "fused_attn_out")
        c[attend] += C * L
        if unfused:  # four linears a layer and the lm_head (no K7 either)
            c[qmm(B)] += C * (4 * L + 1)
            return
        for k in ("fused_norm_qkv", "ffn_fused_normed"):
            c[k] += C * L
        if attend != "fused_attn_out":
            c["fused_out_residual"] += C * L
        c[qmm(B)] += C

    def dictated(record, paged, unfused=False):
        """The launches of a record's admissions (rows, bucket) and chunks
        (rows, steps), by the bf16, weight-only names."""
        want = {k: 0 for c in counters for k in c}
        want["flash_prefill_own"] = 0
        for b, T in record["prefill"]:
            prefill_counts(want, b, T, paged, unfused)
        for B, C in record["chunk"]:
            chunk_counts(want, B, C, paged, unfused)
        return want

    def recorded(eng, paged, run):
        """Run `run()` with the prefill and run_chunk of `eng` (an Engine,
        or a list of Engines of one policy) wrapped to record each
        admission's (rows, bucket) and each chunk's (rows, steps), whether
        the chunk is its graph's capture, a replay or (in eager_chunks)
        the eager Engine.chunk; returns run()'s result, the record and the
        counts it dictates (none for dense weights, which launch no
        kernel)."""
        engs = eng if isinstance(eng, list) else [eng]
        record = {"prefill": [], "chunk": []}

        def wrap(e):
            prefill, run_chunk = e.prefill, e.run_chunk

            def rec_prefill(cache, prompts):
                T = engine_bucket(max(len(p) for p in prompts), e.max_ctx)
                record["prefill"].append((len(prompts), T))
                return prefill(cache, prompts)

            def rec_chunk(cache, logits, pos, C, *a, **k):
                record["chunk"].append((logits.shape[0], C))
                return run_chunk(cache, logits, pos, C, *a, **k)

            e.prefill, e.run_chunk = rec_prefill, rec_chunk

        for e in engs:
            wrap(e)
        before = graphs_of(engs)
        try:
            reset()
            out = run()
            torch.cuda.synchronize()
        finally:
            for e in engs:
                del e.prefill, e.run_chunk
        notes["first_use"] = first_use(engs, before)
        if not engs[0].policy.is_quantized:
            return out, record, dictated({"prefill": [], "chunk": []}, paged)
        unfused = engs[0].policy.aq8 or engs[0].cfg.n_embd > 2048
        return out, record, dictated(record, paged, unfused)

    def ids_ok(outs, n_new):
        return all(len(o) == n and all(0 <= t < cfg.n_vocab for t in o)
                   for o, n in zip(outs, n_new))

    def run_cli(argv, method="generate"):
        """cli.main(argv) with Engine.generate (or `method`) caught:
        (engine, prompt tokens, ids, stats) of its one call."""
        seen = []
        real = getattr(Engine, method)

        def spy(self, prompt_tokens, *a, **k):
            out, stats = real(self, prompt_tokens, *a, **k)
            seen.append((self, prompt_tokens, out, stats))
            return out, stats

        setattr(Engine, method, spy)
        try:
            reset()
            rc = cli.main(argv)
            torch.cuda.synchronize()
        finally:
            setattr(Engine, method, real)
        if rc or len(seen) != 1:
            raise AssertionError(f"cli.main {argv[0]} gave {rc} after "
                                 f"{len(seen)} generate calls")
        return seen[0]

    # the decode chunk as a CUDA graph (Engine.run_chunk) against the
    # eager Engine.chunk
    graph_run_chunk = Engine.run_chunk

    @contextlib.contextmanager
    def eager_chunks():
        """Every engine's entry points (generate, generate_batch, the
        batcher) run the eager Engine.chunk for the duration, for
        comparison: run_chunk rebound to chunk on the class."""
        Engine.run_chunk = Engine.chunk
        try:
            yield
        finally:
            Engine.run_chunk = graph_run_chunk

    def graph_line(path, engs, before):
        """The graphs `engs` captured since `before` (graphs_of), the
        seconds spent on them and the memory the allocator holds."""
        (n0, s0, m0), (n1, s1, m1) = before, graphs_of(engs)
        print(f"path {path}: {n1 - n0} chunk graphs captured in "
              f"{s1 - s0:.3f} s (each with its eager first run); "
              f"torch.cuda.memory_reserved {m0 / 2**20:.1f} -> "
              f"{m1 / 2**20:.1f} MiB", flush=True)

    def replay_rate(eng, prompts, C=32, n=4):
        """n chained replays of a greedy C-step chunk over `prompts` in the
        engine's own cache of their batch size, the one generate and
        generate_batch use (so the graph they captured, over the same
        addresses; captured here if they have not): device ms a step
        (CUDA events around the replays) and host ms a step to the last
        replay's end."""
        cache = eng._cache(len(prompts))
        logits, lens = eng.prefill(cache, prompts)
        pos = torch.from_numpy(lens.astype(np.int32)).to("cuda")
        gcfg = GenerationConfig(greedy=True, eos_token=-1)
        _, _, logits, pos = eng.run_chunk(cache, logits, pos, C, gcfg)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            _, _, logits, pos = eng.run_chunk(cache, logits, pos, C, gcfg)
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end) / (n * C),
                (time.perf_counter() - t0) * 1e3 / (n * C))

    def graph_equals(path, eng, prompts_, seed=None, chunks=2, C=32):
        """`chunks` chained C-step chunks from one prefill: Engine.chunk
        eagerly over one cache, Engine.run_chunk over another in two
        passes (the first captures, the second replays every chunk after
        the cache is prefilled again); tokens and logits must be
        torch.equal. With `seed`, top-k (40, temperature 0.9) from
        generators of that seed."""
        gcfg = (GenerationConfig(greedy=True, eos_token=-1) if seed is None
                else GenerationConfig(greedy=False, top_k=40, temperature=0.9,
                                      eos_token=-1))

        def start(cache):
            logits, lens = eng.prefill(cache, prompts_)
            return logits, torch.from_numpy(lens.astype(np.int32)).to("cuda")

        def generator():
            return (None if seed is None
                    else torch.Generator("cuda").manual_seed(seed))

        cache = eng.new_cache(len(prompts_))
        logits, pos = start(cache)
        g, eager = generator(), []
        for _ in range(chunks):
            toks, _, logits, pos = eng.chunk(cache, logits, pos, C, gcfg, g)
            eager.append((toks.clone(), logits.clone()))
        store, g = eng.new_cache(len(prompts_)), generator()
        for rep in range(2):
            logits, pos = start(store)
            if g is not None:
                g.manual_seed(seed)
            for i, (want_t, want_l) in enumerate(eager):
                toks, _, logits, pos = eng.run_chunk(store, logits, pos, C,
                                                     gcfg, g)
                if not (torch.equal(toks, want_t) and torch.equal(logits,
                                                                   want_l)):
                    raise AssertionError(
                        f"graph {path}: chunk {i} of pass {rep} through "
                        "run_chunk differs from the eager Engine.chunk")
        print(f"graph {path}: {chunks} chained {C}-step chunks at B="
              f"{len(prompts_)}, {'greedy' if seed is None else f'top-k seed {seed}'}"
              f": the captured chunk and its replays (after the cache is "
              f"prefilled again) torch.equal to the eager Engine.chunk, "
              f"tokens and logits", flush=True)

    def b1_paths(path, eng, prompt_, n_new, kind="q8", **want):
        """prompt_ and n_new greedy tokens through Engine.generate with
        the chunk's graph replayed (captured by a warm-up generate), then
        with the eager chunk: the same tokens, the same exact launch
        counts (`want`, else those the recorded shapes dictate); their
        ms/token, and the device's ms a step over replayed chunks (its
        busy share of each)."""
        before = graphs_of(eng)
        eng.generate(prompt_, GenerationConfig(
            n_predict=len(prompt_) + 32, greedy=True, eos_token=-1,
            chunk_size=32))
        runs = []
        for mode in ("graph", "eager"):
            with eager_chunks() if mode == "eager" else contextlib.nullcontext():
                (out_, stats_), _, dictated = recorded(
                    eng, eng.paged, lambda: generate(prompt_, n_new, eng))
            expect(f"{path} {mode}", kind, **(want or dictated))
            runs.append((out_, stats_))
        (out_, stats_), (out_e, stats_e) = runs
        if out_e != out_:
            raise AssertionError(f"path {path}: the graph's tokens are not "
                                 "the eager chunk's")
        dev_ms, _ = replay_rate(eng, [prompt_])
        print(f"path {path}: decode {stats_.ms_per_token:.4f} ms/token with "
              f"the chunk's graph replayed, {stats_e.ms_per_token:.4f} ms/token"
              f" eager ({stats_e.ms_per_token / stats_.ms_per_token:.2f}x), "
              f"{n_new} tokens each, the same ids; the device "
              f"{dev_ms:.4f} ms a step over replayed chunks: busy "
              f"{dev_ms / stats_.ms_per_token:.3f} of a graph token, "
              f"{dev_ms / stats_e.ms_per_token:.3f} of an eager one; card "
              f"{card}", flush=True)
        graph_line(path, eng, before)
        return out_, stats_

    # (p) speculative decoding: the verify rounds' counts, runs and reads
    def spec_counts(eng, n_prompt, rounds, k=SPEC_K):
        """The launches of a generate_speculative: the prompt's prefill,
        then `rounds` verify rounds (those after done included) of T = k +
        1 tokens from pos > 0: K3 a layer, the fused branch's K5, K6, K7
        (T <= 32, n_embd <= 2,048, no aq8) or else four linears (K1 at T
        <= 8, K2 above), and the lm_head over the T rows."""
        c = {name: 0 for cc in counters for name in cc}
        c["flash_prefill_own"] = 0
        unfused = eng.policy.aq8 or eng.cfg.n_embd > 2048
        prefill_counts(c, 1, engine_bucket(n_prompt, eng.max_ctx), False,
                       unfused)
        T = k + 1
        c["flash_prefill"] += rounds * L
        if T <= 32 and not unfused:
            for name in ("fused_norm_qkv", "fused_out_residual",
                         "ffn_fused_normed"):
                c[name] += rounds * L
        else:
            c[qmm(T)] += rounds * 4 * L
        c[qmm(T)] += rounds
        return c

    def spec_run(path, eng, prompt_, n_new, kind, k=SPEC_K, rounds=None):
        """prompt_ and n_new greedy tokens through generate_speculative
        (with speculative.ROUNDS set to `rounds` for the call, if given),
        with its exact launch counts (none for dense weights)."""
        gcfg = GenerationConfig(n_predict=len(prompt_) + n_new, greedy=True,
                                eos_token=-1)
        chosen = speculative.ROUNDS
        speculative.ROUNDS = rounds or chosen
        reset()
        try:
            out_, stats_ = eng.generate_speculative(prompt_, gcfg, k)
        finally:
            speculative.ROUNDS = chosen
        torch.cuda.synchronize()
        if not ids_ok([out_], [n_new]):
            raise AssertionError(f"path {path}: {len(out_)} ids of {n_new}, "
                                 "or ids out of range")
        want_ = (spec_counts(eng, len(prompt_), stats_.decode_steps, k)
                 if eng.policy.is_quantized else {})
        expect(path, kind, **want_)
        return out_, stats_

    def round_ms(eng, prompt_, k=SPEC_K, R=None, n=4):
        """Device ms a verify round: CUDA events over n replays of the
        rounds' graph from prompt_'s prefill (its budget far from spent)."""
        R = R or speculative.ROUNDS
        spec = eng.round_graphs()
        buf = spec.buffers_for(k)
        logits, _ = eng.prefill(spec.cache, [prompt_])
        speculative.start(buf, prompt_, int(logits[0].argmax()),
                          eng.max_ctx - len(prompt_) - 1)
        spec.run(k, -1, R)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            spec.run(k, -1, R)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (n * R)

    def spec_line(path, eng, prompt_, n_new, kind, base_ms, k=SPEC_K):
        """generate_speculative twice (the first captures its rounds'
        graph, if none is there), the second timed; its ms/token beside
        base_ms (generate's), tokens a verify, the device's busy share and
        the graph's capture; returns its ids."""
        before = graphs_of(eng)
        _, first = spec_run(f"{path} first", eng, prompt_, n_new, kind, k)
        n_g, cap_s, _ = graphs_of(eng)
        out_, stats_ = spec_run(path, eng, prompt_, n_new, kind, k)
        nv = stats_.decode_token_times[0]
        dev = round_ms(eng, prompt_, k)
        print(f"path {path}: generate_speculative k={k}, R="
              f"{speculative.ROUNDS}: {stats_.generated_tokens} tokens in {nv} "
              f"verify forwards ({stats_.generated_tokens / nv:.3f} a verify; "
              f"{stats_.decode_steps} rounds run), {stats_.ms_per_token:.4f} "
              f"ms/token as a graph against generate's {base_ms:.4f} "
              f"({base_ms / stats_.ms_per_token:.3f}x); a round {dev:.4f} ms "
              f"on the device, busy {dev * stats_.decode_steps / (stats_.decode_s * 1e3):.3f} "
              f"of the decode; first call {first.ms_per_token:.4f} ms/token with "
              f"{n_g - before[0]} graph captured in {cap_s - before[1]:.3f} s; "
              f"card {card}", flush=True)
        return out_, stats_

    #: the pool of 4 rank processes paths (q) and (r) share (started at its
    #: first use, stopped at exit)
    rank_pools = {}

    def rank_pool():
        from tinyllama_tpu_torch.parallel.mesh import RankPool

        if 4 not in rank_pools:
            rank_pools[4] = RankPool(4)
            atexit.register(rank_pools[4].close)
        return rank_pools[4]

    #: kernel rows made ahead of their paths (beside the Llama-3 parity's
    #: CPU traces), by path
    ready_rows: dict[str, list] = {}

    def path_rows(path: str) -> list[dict]:
        """The kernel rows of path (q), (r), (s) or (t): those made ahead,
        else made now."""
        if path in ready_rows:
            return ready_rows.pop(path)
        made = {"q": lambda: [r for k in TP_ROWS
                              for r in phase_tp_rows(torch, ops, k)],
                "r": lambda: phase_sp_rows(torch, ops),
                "s": lambda: [r for k in DP_ROWS
                              for r in phase_tp_rows(torch, ops, k)],
                "t": lambda: [r for kv in ("bf16", "i8", "f16", "f32")
                              for r in phase_attention_tiny(torch, ops, kv)]}[path]()
        mark(f"({path}) kernel rows")
        return made

    def free():
        """Frees what engines deleted above held (an engine and its chunk
        graphs refer to each other, so they go at a collection)."""
        gc.collect()
        torch.cuda.empty_cache()

    def ref_engine(model_cfg, kind, seed, S=TP_S, **kw):
        """The tp = sp = 1 engine of paths (q) and (r), in this process,
        over the ranks' weights (drawn on the card from `seed`)."""
        g = torch.Generator("cuda")
        g.manual_seed(seed)
        return Engine(model_cfg, POLICIES[kind], llama.init_quantized_params(
            model_cfg, POLICIES[kind], g, "cuda"), max_ctx=S, device="cuda",
            **kw)

    def rank_parity(path, got, want, vs):
        """got (the ranks') within PARITY_REL of max |want| (the `vs` = 1
        engine's)."""
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"parity {path}: max |{vs} - {vs}1| {err:.5f}, max |{vs}1| "
              f"{scale:.4f}, mean |diff| {float(np.abs(got - want).mean()):.6f} "
              f"(limit {PARITY_REL} of max |{vs}1|)", flush=True)
        if not (np.isfinite(got).all() and err <= PARITY_REL * scale):
            raise AssertionError(f"parity {path}: {err} > {PARITY_REL} * {scale}")

    def ids_in_range(path, ids, n, vocab=TINYLLAMA_1_1B.n_vocab):
        if len(ids) != n or not all(0 <= t < vocab for t in ids):
            raise AssertionError(f"path {path}: {len(ids)} ids of {n}, or "
                                 "ids out of range")

    def check_ranks(path, kind, res, i, paged=False, unfused=False,
                    overlap_tp=0, tally=True):
        """Step i of a pool's run: the same on every rank
        (same_on_ranks), and rank 0's counts exactly what its prefills
        (an SP prefill: the four linears at Tl rows a layer, K1 for the
        lm_head) and chunks dictate, with the ring's overlap_tp - 1 more
        launches for each of wo and w_down under --tp-overlap (with
        `tally`, added to the kind's totals). Returns rank 0's step."""
        s0 = same_on_ranks(path, res, i)
        want = {k: 0 for c in counters for k in c}
        want["flash_prefill_own"] = 0
        extra = 2 * (overlap_tp - 1) * L if overlap_tp else 0
        for rec in s0["record"]["prefill"]:
            if rec[0] == "sp":
                want[qmm(rec[1])] += 4 * L
                want["qmm_smallm"] += 1
                continue
            prefill_counts(want, rec[0], rec[1], paged, unfused)
            want[qmm(rec[0] * rec[1])] += extra
        for B, C in s0["record"]["chunk"]:
            chunk_counts(want, B, C, paged, unfused)
            want[qmm(B)] += C * extra
        for c in counters:
            for k in c:
                c[k] = s0["counts"][k]
        totals.setdefault(kind, {k: 0 for c in counters for k in c})
        expect(f"{path} (each of {len(res)} ranks)", kind, tally, **want)
        return s0

    # (q) tensor parallelism: Engine(tp=N) in N rank processes on the
    # card(s), against the tp = 1 engine in this process
    def path_q() -> list[dict]:
        """Path (q); returns the TP kernel rows with its launches (a rank's:
        every rank's are checked equal)."""
        nonlocal L
        from tinyllama_tpu_torch.config import MODEL_REGISTRY
        from tinyllama_tpu_torch.parallel.mesh import (
            RankPool, backend_for, with_mesh,
        )

        t_q = time.perf_counter()
        q_rows = path_rows("q")
        name = TINYLLAMA_1_1B.name
        qrng = np.random.default_rng(18)

        def q_prompt(n):
            return [1] + qrng.integers(2, TINYLLAMA_1_1B.n_vocab, n - 1).tolist()

        prompt_q = q_prompt(PROMPT_LEN)
        batch_q = [q_prompt(PROMPT_LEN) for _ in range(BATCH)]
        requests_q = [q_prompt(int(n)) for n in qrng.integers(8, 201, 8)]

        # TP always takes the unfused branch
        check_step = functools.partial(check_ranks, unfused=True)

        def parity(path, got, want):
            rank_parity(path, got, want, "tp")

        # the tp = 1 references: (a)'s weights (seed 1234), graph and eager
        e1 = ref_engine(TINYLLAMA_1_1B, "q8", 1234)
        ref_logits = e1.prefill(e1.new_cache(1), [prompt_q])[0].float().cpu().numpy()
        ids1, st1 = generate(prompt_q, 64, e1)
        ids1, st1 = generate(prompt_q, 64, e1)  # the first captured its graph
        with eager_chunks():
            _, st1e = generate(prompt_q, 64, e1)
        del e1
        free()
        print(f"path (q) tp=1: {st1.ms_per_token:.4f} ms/token as a CUDA graph, "
              f"{st1e.ms_per_token:.4f} eager (64 tokens after a "
              f"{PROMPT_LEN}-token prompt); card {card}", flush=True)
        ms_tok = {}
        # the pool's backend and the chunk's route follow from the cards:
        # gloo and the eager chunk where its 4 ranks share a card, NCCL and
        # the captured chunk where each has its own
        n_cards = torch.cuda.device_count()
        backend = backend_for(4)
        route = "graph" if backend == "nccl" else "eager"
        how = (f"{backend}, the chunk {'a CUDA graph' if route == 'graph' else 'eager'}"
               f", ranks on {min(n_cards, 4)} card(s)")
        with contextlib.nullcontext(rank_pool()) as pool:
            def ranks(tp, *a, **k):
                res = pool.run(with_mesh, rank_task, tp, 1, None, *a, **k)[:tp]
                for rank, r in enumerate(res):
                    if "steps" not in r:
                        continue
                    if (r["backend"], r["route"]) != (backend, route):
                        raise AssertionError(
                            f"path (q): rank {rank} ran {r['backend']} and the "
                            f"{r['route']} chunk; on {n_cards} card(s) the pool "
                            f"runs {backend} and the {route} chunk")
                    # the engine copies the rank's shard to the card, not the
                    # full weights (and pads the lm_head's vocab once)
                    m = r["memory"]
                    limit = m["shard"] + m["lm_head"] + 64 * 2**20
                    if m["peak"] > limit:
                        raise AssertionError(
                            f"path (q): building rank {rank}'s engine took "
                            f"{m['peak']} B on the card; its shard is "
                            f"{m['shard']} B (limit {limit} B, the full "
                            f"weights {m['full']} B)")
                return res

            for tp in (2, 4):
                kind = f"q8-tp{tp}"
                # (q1) TinyLlama q8, bf16 KV, full width and depth
                n_q1 = 64 if tp == 2 else 16
                res = ranks(tp, name, "q8", 1234, 0, [
                    ("prefill", [prompt_q]), ("generate", prompt_q, n_q1),
                    ("generate_batch", batch_q, 8), ("all_reduce", 200)])
                heads = res[0]["cache_heads"]
                if heads != TINYLLAMA_1_1B.n_kv_heads // tp:
                    raise AssertionError(f"path (q1) tp={tp}: a rank's cache "
                                         f"holds {heads} kv heads")
                s = check_step(f"(q1) tp={tp} prefill", kind, res, 0)
                parity(f"(q1) TinyLlama q8 tp={tp} prefill", s["out"], ref_logits)
                s = check_step(f"(q1) tp={tp} generate", kind, res, 1)
                ids_in_range(f"(q1) tp={tp}", s["out"], n_q1)
                shared = next((i for i, (x, y) in enumerate(zip(s["out"], ids1))
                               if x != y), n_q1)
                s_b = check_step(f"(q4) tp={tp} generate_batch", kind, res, 2)
                for o in s_b["out"]:
                    ids_in_range(f"(q4) tp={tp} generate_batch", o, 8)
                ar_ms = res[0]["steps"][3]["out"]
                ms_tok[tp] = s["ms_per_token"]
                m = res[0]["memory"]
                print(f"path (q1) tp={tp}: {tp} ranks ({how}), weights drawn "
                      f"in {m['init_s']:.1f} s and the engine built in "
                      f"{res[0]['build_s']:.1f} s (the draw included), its "
                      f"peak on the card "
                      f"{m['peak'] / 2**20:.1f} MiB for a shard of "
                      f"{m['shard'] / 2**20:.1f} MiB (the full weights "
                      f"{m['full'] / 2**20:.1f} MiB, in host memory); prefill "
                      f"{s['prefill_ms']:.3f} ms, decode "
                      f"{s['ms_per_token']:.4f} ms/token over {n_q1} tokens "
                      f"(tp=1: {st1.ms_per_token:.4f} graph, "
                      f"{st1e.ms_per_token:.4f} eager); one all-reduce of a "
                      f"[1, 1, {TINYLLAMA_1_1B.n_embd}] bf16 row {ar_ms:.4f} ms "
                      f"back to back, x {2 * L} a step = "
                      f"{2 * L * ar_ms / s['ms_per_token']:.3f} of a token (an "
                      f"estimate); the prefix shared with tp=1 at bf16 "
                      f"{shared} of {n_q1}; memory_reserved a rank "
                      f"{res[0]['memory_reserved'] / 2**20:.0f} MiB; card {card}",
                      flush=True)
                # (q4), (q5) paged generate, paged generate_batch and a
                # batcher of 8 slots over 8 requests, on one paged engine
                res = ranks(tp, name, "q8", 1234, 0, [
                    ("generate", prompt_q, 16), ("generate_batch", batch_q, 8),
                    ("batcher", requests_q, 8, 8)], paged=True)
                s = check_step(f"(q4) tp={tp} paged generate", kind, res, 0,
                               paged=True)
                ids_in_range(f"(q4) tp={tp} paged", s["out"], 16)
                check_step(f"(q4) tp={tp} paged generate_batch", kind, res, 1,
                           paged=True)
                s = check_step(f"(q5) tp={tp} batcher", kind, res, 2, paged=True)
                if sorted(s["out"]) != list(range(8)) or any(
                        len(o) != 8 for o in s["out"].values()):
                    raise AssertionError(f"path (q5) tp={tp}: the batcher's "
                                         "requests did not all finish")
                print(f"path (q5) tp={tp}: the batcher: 8 requests x 8 tokens in "
                      f"{res[0]['steps'][2]['s']:.2f} s "
                      f"({8 * 8 / res[0]['steps'][2]['s']:.1f} tok/s; {how}); "
                      f"card {card}", flush=True)
            mark("(q1), (q4), (q5) tp = 2 and 4")

            # (q2) q4g: tp = 2 runs; tp = 4 is refused (TinyLlama's w_down
            # K = 5,632 over 4 splits a JAX pack group of 256)
            e1 = ref_engine(TINYLLAMA_1_1B, "q4g", 4321)
            ref4 = e1.prefill(e1.new_cache(1), [prompt_q])[0].float().cpu().numpy()
            del e1
            free()
            res = ranks(2, name, "q4g", 4321, 0, [("prefill", [prompt_q]),
                                                  ("generate", prompt_q, 16)])
            s = check_step("(q2) q4g tp=2 prefill", "q4g-tp2", res, 0)
            parity("(q2) TinyLlama q4g tp=2 prefill", s["out"], ref4)
            s = check_step("(q2) q4g tp=2 generate", "q4g-tp2", res, 1)
            ids_in_range("(q2) q4g tp=2", s["out"], 16)
            res = ranks(4, name, "q4g", 4321, 0, [], refused=True)
            if not all("pack group 256" in r["refused"] for r in res):
                raise AssertionError(f"path (q2): q4g at tp=4: {res[0]}")
            print(f"path (q2): q4g tp=2 {s['ms_per_token']:.4f} ms/token; tp=4 "
                  f"refused on every rank: {res[0]['refused']!r}", flush=True)

            # (q3) an int8 KV cache at tp = 2
            res = ranks(2, name, "q8-kvi8", 1234, 0, [("generate", prompt_q, 32)])
            s = check_step("(q3) int8 KV tp=2", "q8-tp2-kvi8", res, 0)
            ids_in_range("(q3) int8 KV tp=2", s["out"], 32)
            print(f"path (q3): q8-kvi8 tp=2 {s['ms_per_token']:.4f} ms/token",
                  flush=True)

            # (q6) --tp-overlap at tp = 2: the ring's logits against the
            # all-reduce's, and its launches (wo and w_down in 2 chunks)
            res = ranks(2, name, "q8", 1234, 0, [("prefill", [prompt_q]),
                                                 ("generate", prompt_q, 16)],
                        tp_overlap=True)
            s = check_step("(q6) overlap prefill", "q8-tp2-overlap", res, 0,
                           overlap_tp=2)
            parity("(q6) tp=2 --tp-overlap prefill", s["out"], ref_logits)
            s = check_step("(q6) overlap generate", "q8-tp2-overlap", res, 1,
                           overlap_tp=2)
            ids_in_range("(q6) overlap", s["out"], 16)
            print(f"path (q6): tp=2 --tp-overlap {s['ms_per_token']:.4f} ms/token "
                  f"({how}; under gloo the ring's hops and gather go through "
                  f"host memory)", flush=True)
            mark("(q2), (q3), (q6)")

            # (q8) Llama-3-8B q4 at tp = 2, full width, 4 layers: prefill
            # parity against tp = 1
            cfg8 = MODEL_REGISTRY["llama-3-8b"].replace(n_layers=4)
            e1 = ref_engine(cfg8, "q4", 88)
            ref8 = e1.prefill(e1.new_cache(1), [prompt_q])[0].float().cpu().numpy()
            del e1
            free()
            res = ranks(2, "llama-3-8b", "q4", 88, 4, [("prefill", [prompt_q])])
            L, L_tiny = 4, L
            try:
                s = check_step("(q8) Llama-3-8B q4 tp=2 prefill", "8b-q4-tp2",
                               res, 0)
            finally:
                L = L_tiny
            parity("(q8) Llama-3-8B q4 (4 layers) tp=2 prefill", s["out"], ref8)
            mark("(q8) Llama-3-8B")

        # (q7) the CLI as a user runs it: it starts its own 2 ranks
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "tinyllama_tpu_torch.cli", "--tp", "2", "-q8",
             "--random-weights", "-greedy", "-p", "hi", "--npred", "32"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            timeout=600)
        ids = [line.split() for line in child.stderr.splitlines()
               if line.split() and all(w.isdigit() for w in line.split())]
        if (child.returncode or child.stdout.count("PERFORMANCE") != 1
                or len(ids) != 1 or len(ids[0]) != 29):
            print(child.stdout, child.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"path (q7): the CLI with --tp 2 exited "
                                 f"{child.returncode}, or printed other than one "
                                 "table and 29 ids")
        per_tok = next(line for line in child.stdout.splitlines()
                       if "Inference [per tok]" in line)
        print(f"path (q7): python -m tinyllama_tpu_torch.cli --tp 2 -q8 "
              f"--random-weights -greedy -p hi --npred 32: 29 ids, one "
              f"performance table ({per_tok.strip()}), "
              f"{time.perf_counter() - t0:.1f} s with its ranks' start",
              flush=True)

        # (q9) NCCL across cards, the chunk captured as a CUDA graph: (q1)-
        # (q8) ran it where each of the pool's 4 ranks had a card; with 2
        # or 3 cards, tp = 2 runs here on 2 of them
        if backend == "nccl":
            print(f"path (q9): (q1)-(q8) ran under NCCL, a card a rank, the "
                  f"chunk a CUDA graph ({n_cards} cards)", flush=True)
        elif n_cards >= 2:
            with RankPool(2) as pool:
                res = pool.run(with_mesh, rank_task, 2, 1, None, name, "q8", 1234,
                               0, [("prefill", [prompt_q]),
                                   ("generate", prompt_q, 64)])
            if any(r["backend"] != "nccl" or r["route"] != "graph" for r in res):
                raise AssertionError("path (q9): ranks on cards of their own "
                                     "must run NCCL and the chunk as a graph")
            s = check_step("(q9) NCCL prefill", "q8-tp2-nccl", res, 0)
            parity("(q9) NCCL tp=2 prefill", s["out"], ref_logits)
            s = check_step("(q9) NCCL generate", "q8-tp2-nccl", res, 1)
            ids_in_range("(q9) NCCL", s["out"], 64)
            print(f"path (q9): NCCL tp=2 on 2 cards, the chunk a CUDA graph: "
                  f"{s['ms_per_token']:.4f} ms/token", flush=True)
        else:
            print(f"path (q9): NCCL across cards did not run: this machine has "
                  f"{n_cards} card (the ranks above shared it through gloo)",
                  flush=True)
        for r in q_rows:
            names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
            r["launches"] = sum(totals[r["kind"]][k] for k in names)
            if not r["launches"]:
                raise AssertionError(f"{r['name']} was not launched on path (q)")
        print(f"path (q): {time.perf_counter() - t_q:.1f} s; ms/token tp=1 "
              f"{st1.ms_per_token:.4f} (graph) / {st1e.ms_per_token:.4f} (eager), "
              f"tp=2 {ms_tok[2]:.4f}, tp=4 {ms_tok[4]:.4f} ({how}); card {card}",
              flush=True)
        return q_rows

    # (r) sequence parallelism: Engine(sp=N) in rank processes sharing the
    # card, against the sp = 1 engine in this process
    def path_r() -> list[dict]:
        """Path (r); returns the SP kernel rows with their launches (a
        rank's: every rank's are checked equal)."""
        nonlocal L
        from tinyllama_tpu_torch.config import MODEL_REGISTRY
        from tinyllama_tpu_torch.parallel.mesh import (
            RankPool, backend_for, with_mesh,
        )
        from tinyllama_tpu_torch.parallel.sp import padded_length

        t_r = time.perf_counter()
        r_rows = path_rows("r")
        name, L_tiny = TINYLLAMA_1_1B.name, L
        rrng = np.random.default_rng(19)

        def r_prompt(n, vocab=TINYLLAMA_1_1B.n_vocab):
            return [1] + rrng.integers(2, vocab, n - 1).tolist()

        def ref_prefill(eng, prompt_, layers_, reps=0):
            """The sp = 1 engine's logits and cache rows of prompt_, its
            prefill ms (best of reps, synced) and the card's peak over
            the prefills (all this process holds included)."""
            torch.cuda.reset_peak_memory_stats()
            cache = eng.new_cache(1)
            logits = eng.prefill(cache, [prompt_])[0].float().cpu().numpy()
            rows_ = cache_rows(cache, len(prompt_), layers_)
            best = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.prefill(cache, [prompt_])
                torch.cuda.synchronize()
                best.append((time.perf_counter() - t0) * 1e3)
            return (logits, rows_, min(best, default=0.0),
                    torch.cuda.max_memory_allocated())

        check_step = check_ranks

        def parity(path, got, want):
            rank_parity(path, got, want, "sp")

        # the sp = 1 references: (a)'s weights (seed 1234), (e)'s prompt
        all_layers = list(range(L))
        e1 = ref_engine(TINYLLAMA_1_1B, "q8", 1234)
        ref_logits, ref_rows, ref_ms, _ = ref_prefill(e1, long_prompt,
                                                      all_layers, reps=3)
        ids1, _ = generate(long_prompt, 64, e1)
        del e1
        e1 = ref_engine(TINYLLAMA_1_1B, "q8-kvi8", 1234, paged=True)
        ref_i8_logits, ref_i8_rows, _, _ = ref_prefill(e1, long_prompt,
                                                       all_layers)
        del e1
        free()
        print(f"path (r) sp=1: prefill of the {LONG_PROMPT}-token prompt "
              f"{ref_ms:.3f} ms (bucket {engine_bucket(LONG_PROMPT, TP_S)}, "
              f"best of 3, synced); card {card}", flush=True)
        long_reqs = [r_prompt(1100), r_prompt(1300)]
        requests_r = [r_prompt(int(n)) for n in rrng.integers(8, 201, 8)]
        requests_r[2:2] = long_reqs[:1]
        requests_r[7:7] = long_reqs[1:]
        n_cards = torch.cuda.device_count()
        backend = backend_for(4)
        how = (f"{backend}, ranks on {min(n_cards, 4)} card(s), the chunk a "
               "CUDA graph at tp 1")
        hop_note = ("through host memory" if backend == "gloo"
                    else "on the cards")

        def cache_parity(path, got, want):
            parity(f"{path} cache", got.astype(np.float32),
                   want.astype(np.float32))

        with contextlib.nullcontext(rank_pool()) as pool:
            def ranks(tp, sp, *a, **k):
                res = pool.run(with_mesh, rank_task, tp, sp, None, *a,
                               sp=sp, **k)[:tp * sp]
                for rank, r in enumerate(res):
                    want_route = "graph" if tp == 1 or backend == "nccl" else "eager"
                    if (r["backend"], r["route"], r["sp"]) != (backend,
                                                               want_route, sp):
                        raise AssertionError(
                            f"path (r): rank {rank} ran {r['backend']}, the "
                            f"{r['route']} chunk at sp {r['sp']}; want "
                            f"{backend}, {want_route}, sp {sp}")
                return res

            ms_sp = {}
            for sp in (2, 4):
                kind = f"q8-sp{sp}"
                # (r1) TinyLlama q8, bf16 KV, full width and depth
                # (a sync around each hop, the gather and the writes at
                # sp 2 only)
                res = ranks(1, sp, name, "q8", 1234, 0, [
                    ("prefill", [long_prompt], all_layers),
                    ("generate", long_prompt, 64),
                    ("timed", long_prompt, 3, sp == 2)])
                s = check_step(f"(r1) sp={sp} prefill", kind, res, 0)
                parity(f"(r1) TinyLlama q8 sp={sp} prefill", s["out"],
                       ref_logits)
                cache_parity(f"(r1) sp={sp}", s["cache"], ref_rows)
                s = check_step(f"(r1) sp={sp} generate", kind, res, 1)
                ids_in_range(f"(r1) sp={sp}", s["out"], 64)
                shared = next((i for i, (x, y) in enumerate(zip(s["out"], ids1))
                               if x != y), 64)
                t = check_step(f"(r1) sp={sp} timed", kind, res, 2)["out"]
                ms_sp[sp] = t["ms"]
                split = (f"; with a sync around each: the ring's "
                         f"{(sp - 1) * L} hops {t['hops']:.3f} ms, the K/V "
                         f"gather {t['gather']:.3f} ms and the cache writes "
                         f"{t['writes']:.3f} ms of {t['total']:.3f} ms (hops "
                         f"{t['hops'] / t['total']:.3f}, handoff "
                         f"{(t['gather'] + t['writes']) / t['total']:.3f}; "
                         f"the hops {hop_note})" if "total" in t else "")
                print(f"path (r1) sp={sp}: {sp} ranks ({how}); prefill of the "
                      f"{LONG_PROMPT}-token prompt ({padded_length(LONG_PROMPT, sp)}"
                      f" rows, Tl {padded_length(LONG_PROMPT, sp) // sp}) "
                      f"{t['ms']:.3f} ms (best of 3, synced; sp=1 "
                      f"{ref_ms:.3f} ms){split}; decode "
                      f"{s['ms_per_token']:.4f} ms/token over 64 tokens, the "
                      f"prefix shared with sp=1 at bf16 {shared} of 64; the "
                      f"card's peak a rank in the prefill "
                      f"{res[0]['steps'][0]['peak'] / 2**20:.0f} MiB; card "
                      f"{card}", flush=True)
            mark("(r1) sp = 2 and 4")

            # (r2) a paged engine with an int8 cache at sp 2
            res = ranks(1, 2, name, "q8-kvi8", 1234, 0, [
                ("prefill", [long_prompt], all_layers),
                ("generate", long_prompt, 16)], paged=True)
            s = check_step("(r2) paged kvi8 prefill", "q8-sp2-kvi8", res, 0,
                           paged=True)
            parity("(r2) TinyLlama q8-kvi8 paged sp=2 prefill", s["out"],
                   ref_i8_logits)
            cache_parity("(r2) paged kvi8 sp=2", s["cache"], ref_i8_rows)
            s = check_step("(r2) paged kvi8 generate", "q8-sp2-kvi8", res, 1,
                           paged=True)
            ids_in_range("(r2)", s["out"], 16)

            # (r3) the batcher over Engine(sp=2): 8 short requests and 2
            # long ones, each long one admitted alone (the SP route)
            for paged in (True, False):
                res = ranks(1, 2, name, "q8", 1234, 0, [
                    ("batcher", requests_r, 16, 8)], paged=paged)
                label = f"(r3) {'paged' if paged else 'monolithic'} batcher"
                s = check_step(label, "q8-sp2", res, 0, paged=paged)
                if sorted(s["out"]) != list(range(10)) or any(
                        len(o) != 16 for o in s["out"].values()):
                    raise AssertionError(f"path {label}: the requests did not "
                                         "all finish their 16 tokens")
                adm = s["record"]["prefill"]
                longs = [a for a in adm if a[0] == "sp" and a[1] >= 512]
                mixed = [a for a in adm if a[0] != "sp" and a[1] >= 1024]
                if (len(longs) != 2 or mixed or s["threshold"] != 1024):
                    raise AssertionError(f"path {label}: admissions {adm}: the "
                                         "long prompts were not admitted alone")
                print(f"path {label}: 10 requests x 16 tokens in "
                      f"{s['s']:.2f} s ({160 / s['s']:.1f} tok/s; {how}); "
                      f"admissions (rows, bucket) or (sp, Tl): {adm}; card "
                      f"{card}", flush=True)
            mark("(r2), (r3)")

            # (r4) sp 2 x tp 2 on 4 ranks: prefill parity against sp 1, tp 1
            res = ranks(2, 2, name, "q8", 1234, 0, [
                ("prefill", [long_prompt], [0, L - 1])])
            s = check_step("(r4) sp=2 x tp=2 prefill", "q8-sp2-tp2", res, 0,
                           unfused=True)
            parity("(r4) TinyLlama q8 sp=2 x tp=2 prefill", s["out"], ref_logits)
            # rank 0 holds the first half of the kv heads
            cache_parity("(r4) sp=2 x tp=2 (rank 0's kv heads)", s["cache"],
                         ref_rows[[0, L - 1], :, : TINYLLAMA_1_1B.n_kv_heads // 2])
            mark("(r4) sp x tp")

            # (r5) Llama-3-8B q4, full width and depth, sp 2: (o2)'s
            # 7,000-token prompt through a paged engine
            cfg8 = MODEL_REGISTRY["llama-3-8b"]
            prompt8 = r_prompt(7000, cfg8.n_vocab)
            held = torch.cuda.memory_allocated()
            e1 = ref_engine(cfg8, "q4", 88, S=cfg8.max_ctx, paged=True)
            ref8, rows8, ms8, peak8 = ref_prefill(
                e1, prompt8, [0, cfg8.n_layers - 1], reps=1)
            del e1
            free()
            res = ranks(1, 2, "llama-3-8b", "q4", 88, 0, [
                ("prefill", [prompt8], [0, cfg8.n_layers - 1]),
                ("generate", prompt8, 16)], S=cfg8.max_ctx, paged=True)
            L = cfg8.n_layers
            try:
                s = check_step("(r5) 8B prefill", "8b-q4-sp2", res, 0,
                               paged=True, unfused=True)
                parity("(r5) Llama-3-8B q4 sp=2 prefill", s["out"], ref8)
                cache_parity("(r5) 8B sp=2", s["cache"], rows8)
                g = check_step("(r5) 8B generate", "8b-q4-sp2", res, 1,
                               paged=True, unfused=True)
                ids_in_range("(r5)", g["out"], 16, cfg8.n_vocab)
            finally:
                L = L_tiny
            print(f"path (r5): Llama-3-8B q4 sp=2, a 7,000-token prompt "
                  f"(7,008 rows, Tl 3,504): generate's prefill "
                  f"{g['prefill_ms']:.3f} ms (sp=1 {ms8:.3f} ms, bucket "
                  f"8,192; synced); decode {g['ms_per_token']:.4f} ms/token "
                  f"over 16 tokens; the card's peak in the prefill (the "
                  f"engine's weights and cache included): a rank "
                  f"{[round(r['steps'][0]['peak'] / 2**30, 2) for r in res]} "
                  f"GiB, sp=1 {(peak8 - held) / 2**30:.2f} GiB; card {card}",
                  flush=True)
            mark("(r5) Llama-3-8B")

        # (r6) the CLI as a user runs it: it starts its own 2 ranks
        t0 = time.perf_counter()
        cli_prompt = "".join(chr(ord("a") + i % 26) for i in range(1100))
        child = subprocess.run(
            [sys.executable, "-m", "tinyllama_tpu_torch.cli", "--sp", "2",
             "-q8", "--random-weights", "-greedy", "-p", cli_prompt, "--npred",
             "1200"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, timeout=600)
        ids = [line.split() for line in child.stderr.splitlines()
               if line.split() and all(w.isdigit() for w in line.split())]
        if (child.returncode or child.stdout.count("PERFORMANCE") != 1
                or len(ids) != 1 or len(ids[0]) != 99):
            print(child.stdout, child.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"path (r6): the CLI with --sp 2 exited "
                                 f"{child.returncode}, or printed other than one "
                                 "table and 99 ids")
        per_tok = next(line for line in child.stdout.splitlines()
                       if "Inference [per tok]" in line)
        print(f"path (r6): python -m tinyllama_tpu_torch.cli --sp 2 -q8 "
              f"--random-weights -greedy -p <1,100 characters> --npred 1200: "
              f"99 ids, one performance table ({per_tok.strip()}), "
              f"{time.perf_counter() - t0:.1f} s with its ranks' start",
              flush=True)

        # (r7) NCCL, a card a rank: (r1)-(r5) ran it where the machine has
        # 4 cards or more; with 2 or 3, sp 2 runs here on 2 of them
        if backend == "nccl":
            print(f"path (r7): (r1)-(r5) ran under NCCL, a card a rank "
                  f"({n_cards} cards)", flush=True)
        elif n_cards >= 2:
            with RankPool(2) as pool:
                res = pool.run(with_mesh, rank_task, 1, 2, None, name, "q8",
                               1234, 0, [("prefill", [long_prompt], [0]),
                                         ("generate", long_prompt, 64)], sp=2)
            if any(r["backend"] != "nccl" for r in res):
                raise AssertionError("path (r7): ranks on cards of their own "
                                     "must run NCCL")
            s = check_step("(r7) NCCL prefill", "q8-sp2-nccl", res, 0)
            parity("(r7) NCCL sp=2 prefill", s["out"], ref_logits)
            s = check_step("(r7) NCCL generate", "q8-sp2-nccl", res, 1)
            ids_in_range("(r7) NCCL", s["out"], 64)
            print(f"path (r7): NCCL sp=2 on 2 cards: {s['ms_per_token']:.4f} "
                  "ms/token", flush=True)
        else:
            print(f"path (r7): NCCL across cards did not run: this machine has "
                  f"{n_cards} card (the ranks above shared it through gloo)",
                  flush=True)
        for r in r_rows:
            names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
            r["launches"] = sum(totals[r["kind"]][k] for k in names)
            if not r["launches"]:
                raise AssertionError(f"{r['name']} was not launched on path (r)")
        print(f"path (r): {time.perf_counter() - t_r:.1f} s; prefill of the "
              f"{LONG_PROMPT}-token prompt sp=1 {ref_ms:.3f} ms, sp=2 "
              f"{ms_sp[2]:.3f} ms, sp=4 {ms_sp[4]:.3f} ms ({how}); card {card}",
              flush=True)
        return r_rows

    # (s) data-parallel batch rows: Engine(tp=2, mesh=make_mesh(2, 2)) and a
    # (dcn 2, data 1, model 2) mesh in path (q)'s pool, against the dp 1 x
    # tp 2 engine on each model group's own rows and the tp = 1 engine
    def path_s() -> list[dict]:
        """Path (s); returns the DP kernel rows with their launches (rank
        0's: every rank's counts are checked against its own rows, and a
        model group's ranks against each other)."""
        nonlocal L
        from tinyllama_tpu_torch.parallel.mesh import backend_for, with_mesh

        t_s = time.perf_counter()
        s_rows = path_rows("s")
        name = TINYLLAMA_1_1B.name
        srng = np.random.default_rng(20)

        def s_prompt(n):
            return [1] + srng.integers(2, TINYLLAMA_1_1B.n_vocab, n - 1).tolist()

        prompts = [s_prompt(PROMPT_LEN) for _ in range(4)]
        requests = [s_prompt(int(n)) for n in srng.integers(8, 201, 6)]
        # the tp = 1 references: (a)'s weights (seed 1234)
        # ((s4)'s at its 2 layers)
        want = {}
        full = TINYLLAMA_1_1B.n_layers
        for key, kind, paged, layers in (("q8", "q8", False, full),
                                         ("q8-kvi8", "q8-kvi8", True, full),
                                         ("q8 2 layers", "q8", True, 2)):
            e1 = ref_engine(TINYLLAMA_1_1B.replace(n_layers=layers), kind,
                            1234, paged=paged)
            want[key] = e1.prefill(e1.new_cache(4), prompts)[0].float().cpu().numpy()
            del e1
        free()
        n_cards = torch.cuda.device_count()
        backend = backend_for(4)
        route = "graph" if backend == "nccl" else "eager"
        how = (f"{backend}, the chunk {'a CUDA graph' if route == 'graph' else 'eager'}"
               f", ranks on {min(n_cards, 4)} card(s)")
        pool = rank_pool()

        def ranks(dp, dcn, kind, steps, layers=0, **k):
            res = pool.run(with_mesh, rank_task, 2, dp, None, name, kind, 1234,
                           layers, steps, dcn=dcn, reference=True, **k)
            for rank, r in enumerate(res):
                got = (r["backend"], r["route"], r["batch"], r["batch_rank"])
                if got != (backend, route, dp * dcn, rank // 2):
                    raise AssertionError(
                        f"path (s): rank {rank} ran (backend, route, batch "
                        f"group, batch rank) {got}; want {backend}, {route}, "
                        f"{dp * dcn}, {rank // 2}")
            return res

        def by_group(path, kind, res, i, paged):
            """Step i of each model group (ranks 2g, 2g + 1): its ranks
            the same, their counts what their own rows dictate (rank 0's
            tallied, the dp engine's steps only). Returns the groups'
            steps."""
            ref = res[0]["steps"][i]["what"].startswith("ref_")
            return [check_ranks(f"{path} model group {g}", kind,
                                res[2 * g:2 * g + 2], i, paged, unfused=True,
                                tally=g == 0 and not ref) for g in range(2)]

        def held(path, kind, res, rows, paged, ref_logits):
            """Steps 0-3 (the dp engine's prefill and generate_batch, the
            dp 1 x tp 2 engine's on the group's own rows): each group's
            rows bit-equal to its own-rows engine's in tokens and logits,
            with the same launches, every row within PARITY_REL of tp 1;
            every rank returns every row. Returns the dp ms a step."""
            pre, gen_, ref_pre, ref_gen = (by_group(path, kind, res, i, paged)
                                           for i in range(4))
            b = rows // 2
            for g in range(2):
                own = slice(g * b, (g + 1) * b)
                if not np.array_equal(pre[g]["out"], ref_pre[g]["out"]):
                    raise AssertionError(f"path {path}: model group {g}'s "
                                         "prefill logits are not those of "
                                         "the dp 1 x tp 2 engine on its rows")
                if gen_[g]["out"][own] != ref_gen[g]["out"]:
                    raise AssertionError(f"path {path}: model group {g}'s "
                                         "tokens are not those of the dp 1 x "
                                         "tp 2 engine on its rows")
                if (gen_[g]["counts"], gen_[g]["record"]) != (
                        ref_gen[g]["counts"], ref_gen[g]["record"]):
                    raise AssertionError(f"path {path}: model group {g}'s "
                                         "launches differ from its own-rows "
                                         "engine's")
            if gen_[0]["out"] != gen_[1]["out"]:
                raise AssertionError(f"path {path}: the groups returned "
                                     "other rows")
            for o in gen_[0]["out"]:
                ids_in_range(path, o, 32)
            rank_parity(f"{path} prefill", np.concatenate(
                [pre[g]["out"] for g in range(2)]), ref_logits[:rows], "tp")
            return gen_[0]["ms_per_step"]

        def memory(res):
            return ", ".join(
                f"rank {r}: engines {m['memory']['peak'] / 2**20:.0f} MiB, "
                f"steps {max(x['peak'] for x in m['steps']) / 2**30:.2f} GiB"
                for r, m in enumerate(res))

        # (s1) dp 2 x tp 2, q8, bf16 KV: generate_batch of 4 prompts, 32
        # greedy tokens; (s3) the monolithic batcher, 6 requests into 4
        # slots; then top-k over two prompts, each in a row of both batch
        # ranks
        best_of = [prompts[0], prompts[1]] * 2
        res = ranks(2, 1, "q8", [
            ("prefill", prompts), ("generate_batch", prompts, 32),
            ("ref_prefill", prompts), ("ref_generate_batch", prompts, 32),
            ("batcher", requests, 16, 4), ("topk_batch", best_of, 8)])
        ms1 = held("(s1)", "q8-dp2tp2", res, 4, False, want["q8"])
        s3 = by_group("(s3) batcher", "q8-dp2tp2", res, 4, False)
        out3 = s3[0]["out"]
        if out3 != s3[1]["out"] or sorted(out3) != list(range(6)) or any(
                len(o) != 16 for o in out3.values()):
            raise AssertionError("path (s3): the requests did not all end at "
                                 "their 16 tokens, or the groups differ")
        topk = [r["steps"][5]["out"] for r in res]
        for o in topk[0]:
            ids_in_range("(s1) top-k", o, 8)
        if any(o != topk[0] for o in topk[1:]) or (
                topk[0][0] == topk[0][2] or topk[0][1] == topk[0][3]):
            raise AssertionError("path (s1) top-k: the ranks returned other "
                                 "rows, or a prompt's rows on the two batch "
                                 "ranks drew the same tokens")
        t3 = res[0]["steps"][4]["s"]
        print(f"path (s1) dp=2 x tp=2: 4 ranks ({how}); generate_batch of 4 "
              f"x {PROMPT_LEN} tokens, 32 greedy: {ms1:.4f} ms a decode step "
              f"(2 rows a rank), {res[0]['steps'][1]['s']:.2f} s; the dp 1 x "
              f"tp 2 engine on a group's 2 rows "
              f"{res[0]['steps'][3]['ms_per_step']:.4f} ms a step; memory "
              f"{memory(res)}; card {card}", flush=True)
        print(f"path (s1) top-k 40: two prompts, each in a row of both batch "
              f"ranks: 8 tokens a row, the rows apart {topk[0]}", flush=True)
        print(f"path (s3): the batcher over dp=2 x tp=2, 6 requests x 16 "
              f"tokens into 4 slots in {t3:.2f} s ({96 / t3:.1f} tok/s); "
              f"admissions (rows, bucket) of rank 0 "
              f"{res[0]['steps'][4]['record']['prefill']}, of rank 2 "
              f"{res[2]['steps'][4]['record']['prefill']}; card {card}",
              flush=True)
        mark("(s1), (s3)")

        # (s2) the same, paged with an int8 KV cache
        res = ranks(2, 1, "q8-kvi8", [
            ("prefill", prompts), ("generate_batch", prompts, 32),
            ("ref_prefill", prompts), ("ref_generate_batch", prompts, 32)],
            paged=True)
        ms2 = held("(s2)", "q8-dp2tp2-kvi8", res, 4, True, want["q8-kvi8"])
        pool_b = res[0]["cache_bytes"]
        print(f"path (s2) dp=2 x tp=2 paged, int8 KV: {ms2:.4f} ms a decode "
              f"step, {res[0]['steps'][1]['s']:.2f} s; a rank's page pool for "
              f"the batch of 4 (the whole page-id space, 2 rows' table) "
              f"{pool_b / 2**20:.1f} MiB; memory {memory(res)}; card {card}",
              flush=True)

        # (s4) a (dcn 2, data 1, model 2) mesh: a row a model group, paged,
        # at 2 layers (its kernels and shapes are (s2)'s at a row a rank)
        res = ranks(1, 2, "q8", [
            ("prefill", prompts[:2]), ("generate_batch", prompts[:2], 32),
            ("ref_prefill", prompts[:2]),
            ("ref_generate_batch", prompts[:2], 32)], layers=2, paged=True)
        L, L_full = 2, L
        try:
            ms4 = held("(s4)", "q8-dcn2tp2", res, 2, True, want["q8 2 layers"])
        finally:
            L = L_full
        print(f"path (s4) dcn=2 x dp=1 x tp=2 paged, 2 layers: {ms4:.4f} ms a "
              f"decode step (a row a rank), {res[0]['steps'][1]['s']:.2f} s; "
              f"memory {memory(res)}; card {card}", flush=True)
        mark("(s2), (s4)")
        for r in s_rows:
            names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
            r["launches"] = sum(totals[r["kind"]][k] for k in names)
            if not r["launches"]:
                raise AssertionError(f"{r['name']} was not launched on path (s)")
        print(f"path (s): {time.perf_counter() - t_s:.1f} s; ms a decode step "
              f"dp=2 x tp=2 {ms1:.4f} (bf16 KV), {ms2:.4f} (paged int8), dcn=2 "
              f"x tp=2 {ms4:.4f} ({how}); card {card}", flush=True)
        return s_rows

    # (t) the JAX package's own tiny configurations on the card: tiny-test
    # (head dim 32, 2 query heads a kv head) through the CLI and the HTTP
    # server, the dryrun on JAX's unwidened configs in path (q)'s pool, and
    # a d = 128 model narrow enough for the fused branch (K8 at d = 128)
    def path_t() -> list[dict]:
        """Path (t); returns the tiny-shape kernel rows with their
        launches (on (t1), (t2) and (t4) in this process)."""
        nonlocal L, cfg
        from tinyllama_tpu_torch.config import tiny_test_config

        t_t = time.perf_counter()
        t_rows = path_rows("t")
        for kind in [f"{m}-q8{k}" for m in ("tiny", "t4")
                     for k in ("", "-kvi8", "-kvf16", "-kvf32")] + ["tiny-q4g"]:
            totals.setdefault(kind, {k: 0 for c in counters for k in c})
        trng = np.random.default_rng(21)
        keep = cfg, L
        cfg = tiny_test_config()
        L = cfg.n_layers
        try:
            engines = t1_cli(trng)
            mark("(t1) cli")
            t2_server(engines["tiny-q8"], trng)
            mark("(t2) server")
            t3_dryrun()
            mark("(t3) dryrun")
            t4_d128(trng)
        finally:
            cfg, L = keep
        for r in t_rows:
            names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
            r["launches"] = sum(totals[r["kind"]][k] for k in names)
            if not r["launches"]:
                raise AssertionError(f"{r['name']} was not launched on path (t)")
        print(f"path (t): {time.perf_counter() - t_t:.1f} s; card {card}",
              flush=True)
        return t_rows

    def t1_cli(trng) -> dict:
        """(t1) cli.main at --model tiny-test on random weights (no
        tokenizer: a prompt's ids are its characters'): q8 with a short
        prompt (bucket 32: the fused prefill, K5, K3, K6, K7), q4g with one
        past 32 ids (bucket 64: K2, K3), q8 over int8, f16 and f32 caches;
        TINY_NEW greedy tokens of fused b1 decode (K5, K8, K7, the lm_head's
        K1) each in whole 32-step chunks (the CLI's --chunk), exact counts
        from the prompt's bucket and the steps run, and the chunks replayed
        as a CUDA graph equal to the eager chunk. Then,
        on each q8 engine's weights, the serving kernels at tiny-test's
        heads. Returns the CLI engines by kind."""
        short, long_ = "hello tiny world", ("the quick brown fox jumps over "
                                             "the lazy dog again")
        engines = {}
        for wkind, kv, prompt_ in (("q8", None, short), ("q4g", None, long_),
                                   ("q8", "i8", short), ("q8", "f16", short),
                                   ("q8", "f32", short)):
            kind = f"tiny-{wkind}" + (f"-kv{kv}" if kv else "")
            path = f"(t1) {kind}"
            n_prompt = 1 + len(prompt_)
            argv = (["--model", "tiny-test", "--random-weights", f"-{wkind}",
                     "-p", prompt_, "-greedy", "--npred",
                     str(n_prompt + TINY_NEW)] + (["--kv", kv] if kv else []))
            with contextlib.redirect_stdout(io.StringIO()):
                eng, toks, out, stats = run_cli(argv)
            bucket = 32 if prompt_ == short else 64
            if (eng.cfg != cfg or eng.device.type != "cuda"
                    or len(toks) != n_prompt
                    or engine_bucket(n_prompt, cfg.max_ctx) != bucket
                    or stats.decode_steps != TINY_NEW
                    or not ids_ok([out], [TINY_NEW])):
                raise AssertionError(
                    f"path {path}: {eng.cfg.name} on {eng.device}, "
                    f"{len(toks)} prompt ids, {len(out)} ids in "
                    f"{stats.decode_steps} steps")
            want = dictated({"prefill": [(1, bucket)],
                             "chunk": [(1, 32)] * (TINY_NEW // 32)}, False)
            expect(path, kind, **want)
            if not (want["fused_attn_out"] and want["flash_prefill"]):
                raise AssertionError(f"path {path}: K8 or K3 not on the path")
            graph_equals(path, eng, [toks])
            print(f"path {path}: cli.main --model tiny-test -{wkind}"
                  + (f" --kv {kv}" if kv else "") + f": {n_prompt}-id prompt "
                  f"(bucket {bucket}), prefill {stats.prefill_s * 1e3:.3f} ms, "
                  f"decode {stats.ms_per_token:.4f} ms/token over {len(out)} "
                  f"tokens (head dim {cfg.d_head}, {cfg.q_heads_per_group} "
                  f"query heads a kv head); card {card}", flush=True)
            if wkind == "q8":
                t1_serving(path, kind, eng, trng)
            engines[kind] = eng
        return engines

    def t1_serving(path, kind, eng, trng) -> None:
        """The serving kernels on a CLI engine's weights and cache kind,
        the chunks eager (exact counts): 4 rows of B = 4 decode steps (K4),
        generate_batch (staged chunks, K9), a paged generate (K10) and a
        paged batcher of TINY_SLOTS slots (K11; K3 at admission)."""
        prompts = [[1] + trng.integers(2, cfg.n_vocab, n - 1).tolist()
                   for n in (9, 20, 31, 12)]
        gcfg = GenerationConfig(n_predict=32 + 16, greedy=True, eos_token=-1,
                                chunk_size=8)
        cache = eng.new_cache(len(prompts))
        logits, lens = eng.prefill(cache, prompts)
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        reset()
        for _ in range(BATCH_STEPS):
            logits = eng.decode_step(cache, logits.argmax(-1).to(torch.int32),
                                     pos)
            pos += 1
        torch.cuda.synchronize()
        n = BATCH_STEPS
        expect(f"{path} B={len(prompts)} steps", kind, fused_norm_qkv=L * n,
               flash_decode_heads=L * n, fused_out_residual=L * n,
               ffn_fused_normed=L * n, qmm_smallm=n)
        peng = Engine(cfg, eng.policy, eng.params, device="cuda", paged=True)
        with eager_chunks():
            (outs, _), rec, want = recorded(
                eng, False, lambda: eng.generate_batch(prompts, gcfg))
            expect(f"{path} generate_batch", kind, **want)
            (out, _), rec_p, want_p = recorded(
                peng, True, lambda: peng.generate(prompts[1], gcfg))
            expect(f"{path} paged generate", kind, **want_p)
            batcher = ContinuousBatcher(peng, gcfg, max_batch=TINY_SLOTS)
            reqs = [[1] + trng.integers(2, cfg.n_vocab, int(m) - 1).tolist()
                    for m in trng.integers(8, 60, 2 * TINY_SLOTS)]
            ids = [batcher.submit(r, max_new=16) for r in reqs]
            res, rec_b, want_b = recorded(peng, True, batcher.run)
            expect(f"{path} batcher", kind, **want_b)
        done = [res[i].output for i in ids]
        if not (ids_ok(outs, [gcfg.n_predict - len(p) for p in prompts])
                and ids_ok([out], [gcfg.n_predict - len(prompts[1])])
                and ids_ok(done, [16] * len(reqs))
                and want["flash_staged"] and want_p["flash_paged"]
                and want_b["flash_paged_staged"]):
            raise AssertionError(f"path {path}: serving ids out of range, or "
                                 "K9, K10 or K11 not on the path")
        print(f"path {path} serving: {BATCH_STEPS} B=4 steps (K4), "
              f"generate_batch of 4 (K9), a paged generate (K10), a paged "
              f"batcher of {TINY_SLOTS} slots over {len(reqs)} requests (K11 "
              f"at buckets {sorted({B for B, _ in rec_b['chunk']})}), the "
              "chunks eager", flush=True)

    def t2_server(eng_q8, trng) -> None:
        """(t2) the HTTP server over a paged tiny-test engine (the CLI's q8
        weights), TINY_SLOTS slots, 16 requests of 16 greedy tokens from 8
        client threads, half streamed, through a stand-in tokenizer (its
        ids past tiny-test's 512 rows take the last, as JAX's gather
        does): exact launch counts (K3 at admission, K10 / K11 in the
        chunks). Then every request sent alone must answer
        Engine.generate's tokens for its prompt."""
        from tinyllama_tpu_torch.io import tokenizer
        from tinyllama_tpu_torch.runtime.server import serve

        with tempfile.TemporaryDirectory() as tmp:
            vocab_t = Path(tmp) / "tokenizer.bin"
            tokenizer.stand_in_vocab(vocab_t)
            tok = tokenizer.Tokenizer(vocab_t)
        # prompts of 3 to 24 words (at most 80 ids): the batcher ends a
        # request within one chunk of max_ctx (JAX's rule), so 16 new
        # tokens and a 16-step chunk stay inside tiny-test's 128
        words = CLI_PROMPT.replace(",", "").replace(".", "").split()
        payloads = [{"prompt": " ".join(words[: int(k)]), "max_new": 16,
                     "stream": i % 2 == 1}
                    for i, k in enumerate(trng.integers(3, 25, 16))]
        gcfg = GenerationConfig(greedy=True, eos_token=-1, chunk_size=16)
        peng = Engine(cfg, eng_q8.policy, eng_q8.params, device="cuda",
                      paged=True)
        httpd = serve(peng, tok, gcfg, 0, max_batch=TINY_SLOTS)
        port = start_server(httpd)
        try:
            def clients(reqs):
                with ThreadPoolExecutor(8) as pool:
                    got = list(pool.map(lambda r: http_generate(port, r, tok),
                                        reqs))
                if not ids_ok([a for a, _ in got], [16] * len(reqs)):
                    raise AssertionError("path (t2): a request did not get its "
                                         "16 ids in range")
                return got

            clients(payloads)  # captures the chunk graphs of its buckets
            answers, record, want = recorded(peng, True,
                                             lambda: clients(payloads))
            expect("(t2) server", "tiny-q8", **want)
            got = {k: v for c in counters for k, v in c.items()}
            if not (got["flash_prefill"]
                    and got["flash_paged_staged"] + got["flash_paged"]):
                raise AssertionError(f"path (t2): the server's launches {got} "
                                     "miss K3, or K10 and K11")
            same = 0
            for (concurrent, _), p in zip(answers, payloads):
                ids = tok.encode(p["prompt"])
                want_ids, _ = peng.generate(ids, GenerationConfig(
                    n_predict=len(ids) + 16, greedy=True, eos_token=-1,
                    chunk_size=16))
                alone, _ = http_generate(port, {**p, "stream": False}, tok)
                if alone != want_ids:
                    raise AssertionError(
                        f"path (t2): {p['prompt']!r} sent alone answered "
                        f"{alone}, Engine.generate {want_ids}")
                same += concurrent == want_ids
        finally:
            httpd.shutdown()
            httpd.server_close()
        print(f"path (t2): serve(Engine(tiny-test, paged=True), max_batch="
              f"{TINY_SLOTS}), 16 requests (8 streamed) from 8 client threads,"
              f" 16 greedy tokens each: {len(record['prefill'])} admissions, "
              f"{len(record['chunk'])} chunks at buckets "
              f"{sorted({B for B, _ in record['chunk']})}; each request sent "
              f"alone answers Engine.generate's tokens; {same} of 16 "
              "answers sent together did too (a reading: a batch's chunks "
              "run K11 and other kernel shapes, whose bf16 sums may part "
              f"from b1's on random weights); card {card}", flush=True)

    def t3_dryrun() -> None:
        """(t3) the port's multi-device dryrun at N = 4 in the rank pool
        of paths (q)-(s), on JAX's configurations as they are (head dim
        32, 2 query heads a kv head): an OK line for paths 2, 3, 4, 6 and
        7, and path 1's not-ported line."""
        from tinyllama_tpu_torch.tools import dryrun_multichip

        lines = dryrun_multichip.run_paths(rank_pool(), 4)
        for n in (2, 3, 4, 6, 7):
            if not any(ln.startswith(f"dryrun_multichip path {n} OK")
                       for ln in lines):
                raise AssertionError(f"path (t3): no OK line for path {n}")
        if not any("path 1 not ported" in ln for ln in lines):
            raise AssertionError("path (t3): no line for path 1")
        cfg_d, l3 = dryrun_multichip.configs()
        print(f"path (t3): dryrun_multichip at N = 4 on "
              f"{torch.cuda.device_count()} card(s): paths 2, 3, 4, 6, 7 OK "
              f"at head dim {cfg_d.d_head} and {l3.d_head}, "
              f"{cfg_d.q_heads_per_group} query heads a kv head (JAX's "
              "configs, unwidened)", flush=True)

    def t4_d128(trng) -> None:
        """(t4) a hand-made d = 128 model that takes the fused branch
        (tiny_test_config(n_embd=512, n_heads=4, n_kv_heads=1, n_ffn=1024):
        G 4), q8, over every cache kind: Engine.generate b1 for 32 tokens
        (K8 at d = 128 a layer a step, exact counts), then the prefill's
        and each teacher-forced step's logits within PARITY_REL of max
        |logits| of the same engine on the CPU (the plain versions)."""
        nonlocal cfg, L
        from tinyllama_tpu_torch.config import tiny_test_config

        cfg = tiny_test_config(n_embd=512, n_heads=4, n_kv_heads=1, n_ffn=1024)
        L = cfg.n_layers
        g4 = torch.Generator()
        g4.manual_seed(128)
        params4 = llama.init_quantized_params(cfg, POLICIES["q8"], g4, "cpu")
        prompt4 = [1] + trng.integers(2, cfg.n_vocab, 19).tolist()
        worst = 0.0

        def trace4(eng, toks):
            i32 = functools.partial(torch.tensor, dtype=torch.int32,
                                    device=eng.device)
            cache = eng.new_cache(1)
            logits, _ = eng.prefill(cache, [prompt4])
            trace = [logits]
            for i, t in enumerate(toks[:-1]):
                trace.append(eng.decode_step(cache, i32([t]),
                                             i32([len(prompt4) + i])))
            return [x.float().cpu() for x in trace]

        for kv in (None, "i8", "f16", "f32"):
            pol = (POLICIES["q8"] if kv is None
                   else dataclasses.replace(POLICIES["q8"], kv_dtype=kv))
            kind = "t4-q8" + (f"-kv{kv}" if kv else "")
            eng4 = Engine(cfg, pol, params4, device="cuda")
            (out4, _), _, want = recorded(eng4, False, lambda: eng4.generate(
                prompt4, GenerationConfig(n_predict=len(prompt4) + 32,
                                          greedy=True, eos_token=-1,
                                          chunk_size=32)))
            if not ids_ok([out4], [32]) or want["fused_attn_out"] != 32 * L:
                raise AssertionError(f"path (t4) {kind}: {len(out4)} ids, or "
                                     f"K8 {want['fused_attn_out']} times")
            expect(f"(t4) {kind}", kind, **want)
            card_tr = trace4(eng4, out4)
            cpu_tr = trace4(Engine(cfg, pol, params4, device="cpu"), out4)
            for i, (a, b) in enumerate(zip(card_tr, cpu_tr)):
                scale = float(b.abs().max())
                err = float((a - b).abs().max())
                worst = max(worst, err / scale)
                if not (torch.isfinite(a).all() and err <= PARITY_REL * scale):
                    raise AssertionError(
                        f"path (t4) {kind}: step {i}'s logits {err} from the "
                        f"CPU's, limit {PARITY_REL} * {scale}")
            del eng4
        print(f"path (t4): d = {cfg.d_head}, G = {cfg.q_heads_per_group}, "
              f"n_embd {cfg.n_embd} (the fused branch): 32 greedy tokens a "
              f"cache kind with K8 at d = 128 ({32 * L} launches each), the "
              f"prefill's and 32 steps' logits within {worst:.4f} of max "
              f"|CPU logits| (limit {PARITY_REL}); card {card}", flush=True)

    if tp_only:
        rows = path_q()
        mark("(q) tensor parallelism")
        return finish(rows, kb_rows)
    if sp_only:
        rows = path_r()
        mark("(r) sequence parallelism")
        return finish(rows, kb_rows)
    if dp_only:
        rows = path_s()
        mark("(s) data-parallel rows")
        return finish(rows, kb_rows)
    if tiny_only:
        rows = path_t()
        mark("(t) tiny configurations")
        return finish(rows, kb_rows)

    # (a) main path: unfused prefill (bucket 128), fused b1 decode
    prompt = prompt_of(PROMPT_LEN)
    out, stats = b1_paths(
        "(a)", engine, prompt, N_NEW, qmm_bigm=4 * L, flash_prefill=L,
        qmm_smallm=1 + N_NEW, fused_norm_qkv=L * N_NEW,
        fused_attn_out=L * N_NEW, ffn_fused_normed=L * N_NEW)
    a_ms = stats.ms_per_token  # (p) reads it beside its own
    graph_equals("(a)", engine, [prompt])
    graph_equals("(a)", engine, [prompt], seed=7)
    print(f"path (a): prefill {stats.prefill_s * 1e3:.3f} ms "
          f"({stats.prompt_tokens} tokens, bucket 128); decode "
          f"{stats.decode_tokens_per_s:.2f} tok/s = "
          f"{stats.ms_per_token:.4f} ms/token over {stats.generated_tokens} "
          f"tokens; first ids {out[:8]}", flush=True)

    # the device's own time for one decode step: the step captured in a
    # CUDA graph (it reads layer and pos from device memory, so it can be)
    cache = engine.new_cache(1)
    engine.prefill(cache, [prompt])
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    step_ms = time_ms(lambda i: engine.decode_step(cache, tok, pos), 20, True)
    print(f"path (a): one decode step at pos {PROMPT_LEN} replayed as a "
          f"CUDA graph: {step_ms:.4f} ms device time; generate "
          f"{stats.ms_per_token:.4f} ms/token, so the device is busy "
          f"{step_ms / stats.ms_per_token:.3f} of its token", flush=True)
    if "--profile" in sys.argv[1:]:
        profile_decode(engine, prompt, torch)

    def chat_path(eng, path, kind="q8"):
        """(b), and (i) at 4 bits: a chat-length prompt (bucket 32, fused
        prefill: K5, K3, K6, K7), then fused b1 decode; under aq8 (k) the
        unfused branch throughout."""
        chat = prompt_of(CHAT_LEN)
        eng.generate(chat, GenerationConfig(n_predict=CHAT_LEN + 2, greedy=True,
                                            eos_token=-1))
        before = graphs_of(eng)
        out, stats = generate(chat, CHAT_NEW, eng)
        note = first_use(eng, before)
        if eng.policy.aq8:  # unfused: K2 at M = 32, then K1-aq8 and K4
            expect(path, kind, qmm_bigm=4 * L, flash_prefill=L,
                   qmm_smallm=1 + CHAT_NEW * (4 * L + 1),
                   flash_decode_heads=L * CHAT_NEW)
        else:
            expect(path, kind, fused_norm_qkv=L * (1 + CHAT_NEW),
                   flash_prefill=L, fused_out_residual=L,
                   ffn_fused_normed=L * (1 + CHAT_NEW),
                   fused_attn_out=L * CHAT_NEW, qmm_smallm=1 + CHAT_NEW)
        print(f"path {path}: prefill {stats.prefill_s * 1e3:.3f} ms "
              f"({stats.prompt_tokens} tokens, bucket 32); decode "
              f"{stats.ms_per_token:.4f} ms/token over {stats.generated_tokens} "
              f"tokens{note}", flush=True)
        return chat

    def batch_path(eng, path, kind="q8", graph=False):
        """(c), and (i) at 4 bits: the unfused prefill of 4 rows, then
        fused B = 4 decode steps (K5, K4, K6, K7); under aq8 unfused steps
        (K1-aq8 at M = 4, K4). With graph, one step replayed as a CUDA
        graph after the counted steps."""
        prompts = [prompt_of(PROMPT_LEN) for _ in range(BATCH)]
        cache = eng.new_cache(BATCH)
        reset()
        logits, lens = eng.prefill(cache, prompts)
        torch.cuda.synchronize()
        expect(f"{path} prefill", kind, qmm_bigm=4 * L, flash_prefill=L,
               qmm_smallm=1)
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        reset()
        t0 = time.perf_counter()
        for _ in range(BATCH_STEPS):
            tok = logits.argmax(dim=-1).to(torch.int32)
            logits = eng.decode_step(cache, tok, pos)
            pos += 1
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3 / BATCH_STEPS
        if not (torch.isfinite(logits).all()
                and logits.shape == (BATCH, cfg.n_vocab)):
            raise AssertionError(f"path {path}: logits not finite or misshapen")
        if eng.policy.aq8:
            expect(f"{path} decode", kind, flash_decode_heads=L * BATCH_STEPS,
                   qmm_smallm=(4 * L + 1) * BATCH_STEPS)
        else:
            expect(f"{path} decode", kind, fused_norm_qkv=L * BATCH_STEPS,
                   flash_decode_heads=L * BATCH_STEPS,
                   fused_out_residual=L * BATCH_STEPS,
                   ffn_fused_normed=L * BATCH_STEPS, qmm_smallm=BATCH_STEPS)
        print(f"path {path}: {BATCH_STEPS} decode steps at B={BATCH}: "
              f"{batch_ms:.4f} ms a step (eager, host clock)", flush=True)
        if graph:
            step_ms = time_ms(lambda i: eng.decode_step(cache, tok, pos), 20, True)
            print(f"path {path}: one step at B={BATCH} replayed as a CUDA "
                  f"graph {step_ms:.4f} ms", flush=True)

    # (b) chat-length prompt: fused prefill (bucket 32), fused b1 decode
    chat = chat_path(engine, "(b)")
    # (c) batched decode steps: unfused prefill of 4 rows, fused B = 4 steps
    batch_path(engine, "(c)", graph=True)

    # (d) generate_batch, monolithic: staged chunks over the cache (K9)
    gcfg = GenerationConfig(n_predict=PROMPT_LEN + 64, greedy=True,
                            eos_token=-1, chunk_size=32)
    prompts = [prompt_of(PROMPT_LEN) for _ in range(BATCH)]
    engine.generate_batch(prompts, GenerationConfig(  # captures B = 4, C = 32
        n_predict=PROMPT_LEN + 32, greedy=True, eos_token=-1, chunk_size=32))
    t0 = time.perf_counter()
    (outs, stats), record, want = recorded(
        engine, False, lambda: engine.generate_batch(prompts, gcfg))
    wall = time.perf_counter() - t0
    if record != {"prefill": [(BATCH, 128)], "chunk": [(BATCH, 32)] * 2} \
            or not ids_ok(outs, [64] * BATCH):
        return fail(f"path (d): ran {record}, or ids out of range")
    expect("(d)", **want)
    print(f"path (d): generate_batch of {BATCH} x {PROMPT_LEN}-token prompts, "
          f"64 new tokens each: prefill {stats.prefill_s * 1e3:.3f} ms, "
          f"decode {stats.decode_s * 1e3 / stats.decode_steps:.4f} ms a "
          f"staged B={BATCH} step, {stats.generated_tokens / stats.decode_s:.2f} "
          f"tok/s (the chunk's graph replayed); wall {wall:.3f} s", flush=True)
    graph_equals("(d)", engine, prompts)

    # (e) paged generate: K10 each step; the short prompt's prefill attends
    # a 32-key temporary cache. The engine serves (f) too.
    paged_engine = Engine(cfg, policy, engine.params, max_ctx=2048,
                          device="cuda", paged=True)
    paged_engine.generate(chat, GenerationConfig(n_predict=CHAT_LEN + 2,
                                                 greedy=True, eos_token=-1))
    b1_paths("(e) 100-token prompt", paged_engine, prompt, 64)
    graph_equals("(e)", paged_engine, [prompt])
    for prompt_e, n_new in ((chat, 16),):
        gcfg = GenerationConfig(n_predict=len(prompt_e) + n_new, greedy=True,
                                eos_token=-1, chunk_size=32)
        (out, stats), record, want = recorded(
            paged_engine, True, lambda: paged_engine.generate(prompt_e, gcfg))
        if not ids_ok([out], [n_new]) or stats.decode_steps != n_new:
            return fail(f"path (e): {len(out)} ids in {stats.decode_steps} "
                        "steps, or ids out of range")
        expect(f"(e) {len(prompt_e)}-token prompt", **want)
        print(f"path (e): paged generate, {len(prompt_e)}-token prompt: "
              f"prefill {stats.prefill_s * 1e3:.3f} ms; decode "
              f"{stats.ms_per_token:.4f} ms/token over {n_new} tokens"
              f"{notes['first_use']}",
              flush=True)
    long_step("(e)", paged_engine, "q8")

    # (f), (g) continuous batching: the batcher's cache is its engine's kind
    def serve(path, eng, max_batch, n_requests, seed, kind="q8", ttft_chunk=0,
              eager_too=False, lens_range=(8, 201), new_range=(32, 97)):
        """Run the requests of `seed` (prompt lengths and new tokens drawn
        from the ranges) through one batcher twice: a first
        pass that captures its chunks' graphs, then the measured pass
        (its chunks replays), whose tokens must be the first pass's; with
        eager_too, once more through a new batcher with the eager chunk,
        the same tokens again. Returns the measured pass's aggregate
        tok/s, TTFT p50 and p95 (s) and its pool's bytes."""
        srng = np.random.default_rng(seed)
        lens = srng.integers(*lens_range, n_requests)
        n_new = srng.integers(*new_range, n_requests).tolist()
        reqs = [[1] + srng.integers(2, cfg.n_vocab, n - 1).tolist() for n in lens]
        gcfg = GenerationConfig(greedy=True, eos_token=-1, chunk_size=32)

        def batcher_():
            return ContinuousBatcher(eng, gcfg, max_batch=max_batch,
                                     ttft_chunk=ttft_chunk)

        def run(b):
            ids = [b.submit(r, max_new=n) for r, n in zip(reqs, n_new)]
            t0 = time.perf_counter()
            res = b.run()
            return [res[i] for i in ids], time.perf_counter() - t0

        def report(mode, done, wall, record):
            ttft = np.array([r.first_token_s - r.submitted_s for r in done])
            buckets = sorted({B for B, _ in record["chunk"]})
            print(f"path {path}: ContinuousBatcher(paged={eng.paged}, "
                  f"max_batch={max_batch}), {mode}, {n_requests} requests, "
                  f"prompts {int(lens.min())}-{int(lens.max())} tokens, "
                  f"{sum(n_new)} new tokens: {sum(n_new) / wall:.2f} tok/s "
                  f"aggregate, TTFT p50 {np.percentile(ttft, 50) * 1e3:.3f} ms "
                  f"p95 {np.percentile(ttft, 95) * 1e3:.3f} ms, wall "
                  f"{wall:.3f} s; {len(record['prefill'])} admissions, "
                  f"{len(record['chunk'])} chunks at buckets {buckets}; card "
                  f"{card}", flush=True)
            return (sum(n_new) / wall, np.percentile(ttft, 50),
                    np.percentile(ttft, 95))

        batcher = batcher_()
        before = graphs_of(eng)
        first, first_wall = run(batcher)
        graph_line(f"{path} first pass ({first_wall:.3f} s)", eng, before)
        before = graphs_of(eng)
        (done, wall), record, want = recorded(eng, eng.paged,
                                              lambda: run(batcher))
        outs = [r.output for r in done]
        if not ids_ok(outs, n_new) or outs != [r.output for r in first]:
            raise AssertionError(f"path {path}: a request did not get its "
                                 "max_new ids in range, or not the first "
                                 "pass's")
        expect(path, kind, **want)
        result = report("chunk graphs replayed", done, wall, record)
        graph_line(f"{path} measured pass", eng, before)
        if eager_too:
            with eager_chunks():
                (done_e, wall_e), record_e, want_e = recorded(
                    eng, eng.paged, lambda: run(batcher_()))
            expect(f"{path} eager", kind, **want_e)
            if [r.output for r in done_e] != outs:
                raise AssertionError(f"path {path}: the eager chunk's tokens "
                                     "are not the graphs'")
            report("eager chunks, the same tokens", done_e, wall_e, record_e)
        pool = batcher.pool if eng.paged else batcher.cache
        return (*result, tree_nbytes(pool))

    served = {"(f)": serve("(f)", paged_engine, ADMIT, 64, 5, eager_too=True),
              "(g)": serve("(g)", engine, 8, 16, 6, eager_too=True)}
    srng = np.random.default_rng(5)
    graph_equals("(f)", paged_engine,
                 [[1] + srng.integers(2, cfg.n_vocab, n - 1).tolist()
                  for n in srng.integers(8, 201, 64)][:ADMIT])

    # one admission of (f) at full width: its first ADMIT prompts (seed 5)
    # prefilled into a page pool at once, padded to one bucket, as the
    # batcher admits them; eager, host clock, three times after a warm-up
    srng = np.random.default_rng(5)
    admit = [[1] + srng.integers(2, cfg.n_vocab, n - 1).tolist()
             for n in srng.integers(8, 201, 64)][:ADMIT]
    adm_cache = paged_engine.new_paged_cache(ADMIT)
    paged_engine.prefill(adm_cache, admit)
    adm_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, record, want = recorded(
            paged_engine, True, lambda: paged_engine.prefill(adm_cache, admit))
        adm_ms.append((time.perf_counter() - t0) * 1e3)
        (rows_, bucket), = record["prefill"]
        expect(f"(f) admission B={rows_}", **want)
    print(f"path (f): one admission prefill of {rows_} prompts "
          f"({min(map(len, admit))}-{max(map(len, admit))} tokens, bucket "
          f"{bucket}, M = {rows_ * bucket}): "
          f"{', '.join(f'{ms:.3f}' for ms in adm_ms)} ms (three calls, "
          f"eager, host clock); card {card}", flush=True)
    del adm_cache

    # the device's share of a full-width staged step of (f) and (g): 8
    # eager steps on the host clock against one step replayed as a CUDA
    # graph, at a 100-token fill; then 4 chained full-width 32-step chunks
    # replayed, device time against host time
    for path, paged, width in (("(f)", True, 32), ("(g)", False, 8)):
        cache = (engine.new_paged_cache(width) if paged
                 else engine.new_cache(width))
        engine.prefill(cache, [prompt] * width)
        pos = torch.full((width,), PROMPT_LEN, dtype=torch.int32, device="cuda")
        st = stage_cache(cache, pos, 32)
        tok = torch.full((width,), 5, dtype=torch.int32, device="cuda")
        engine.decode_step(st, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            engine.decode_step(st, tok, pos + i)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / 8
        graph_ms = time_ms(lambda i: engine.decode_step(st, tok, pos), 20, True)
        dev_ms, host_ms = replay_rate(paged_engine if paged else engine,
                                      [prompt] * width)
        print(f"path {path}: one staged B={width} step at pos {PROMPT_LEN}: "
              f"eager {eager_ms:.4f} ms (host clock, 8 steps), replayed as a "
              f"CUDA graph {graph_ms:.4f} ms, so the device is busy "
              f"{graph_ms / eager_ms:.3f} of an eager step; 32-step chunks "
              f"replayed: device {dev_ms:.4f} ms a step, host {host_ms:.4f} "
              f"ms a step, busy {dev_ms / host_ms:.3f}", flush=True)
        del cache, st
    del paged_engine

    mark("paths (a)-(g)")

    # (j) the int8 KV cache, POLICIES["q8-kvi8"], on (a)'s weights through
    # every cache kind: the int8 instantiations of K3, K4, K8-K11
    kvi8 = POLICIES["q8-kvi8"]
    eng8 = Engine(cfg, kvi8, engine.params, max_ctx=2048, device="cuda")
    out, stats = b1_paths("(j) b1", eng8, prompt, 64, "q8-kvi8",
                          qmm_bigm=4 * L, flash_prefill=L, qmm_smallm=1 + 64,
                          fused_norm_qkv=L * 64, fused_attn_out=L * 64,
                          ffn_fused_normed=L * 64)
    graph_equals("(j) b1", eng8, [prompt])
    graph_equals("(j) B=4", eng8, prompts)
    cache = eng8.new_cache(1)
    eng8.prefill(cache, [prompt])
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    step8_ms = time_ms(lambda i: eng8.decode_step(cache, tok, pos), 20, True)
    print(f"path (j) b1: prefill {stats.prefill_s * 1e3:.3f} ms "
          f"({stats.prompt_tokens} tokens, bucket 128); decode "
          f"{stats.ms_per_token:.4f} ms/token over {stats.generated_tokens} "
          f"tokens; one decode step at pos {PROMPT_LEN} replayed as a CUDA "
          f"graph {step8_ms:.4f} ms against (a)'s {step_ms:.4f} ms (bf16 "
          f"cache); busy {step8_ms / stats.ms_per_token:.3f} of a generate "
          "token", flush=True)
    del cache
    batch_path(eng8, "(j) B=4", "q8-kvi8")
    gcfg = GenerationConfig(n_predict=PROMPT_LEN + 32, greedy=True,
                            eos_token=-1, chunk_size=32)
    (outs, stats), record, want = recorded(
        eng8, False, lambda: eng8.generate_batch(prompts, gcfg))
    if record != {"prefill": [(BATCH, 128)], "chunk": [(BATCH, 32)]} \
            or not ids_ok(outs, [32] * BATCH):
        return fail(f"path (j) generate_batch: ran {record}, or ids out of range")
    expect("(j) generate_batch", "q8-kvi8", **want)
    print(f"path (j) generate_batch: {BATCH} x {PROMPT_LEN}-token prompts, one "
          f"staged 32-step chunk: {stats.decode_s * 1e3 / stats.decode_steps:.4f}"
          f" ms a staged B={BATCH} step{notes['first_use']}", flush=True)
    paged8 = Engine(cfg, kvi8, engine.params, max_ctx=2048, device="cuda",
                    paged=True)
    (out, stats), record, want = recorded(
        paged8, True, lambda: paged8.generate(prompt, gcfg))
    if not ids_ok([out], [32]) or stats.decode_steps != 32:
        return fail(f"path (j) paged: {len(out)} ids in {stats.decode_steps} "
                    "steps, or ids out of range")
    expect("(j) paged generate", "q8-kvi8", **want)
    print(f"path (j) paged generate: prefill {stats.prefill_s * 1e3:.3f} ms "
          f"(K3 over the prompt's own quantized keys); decode "
          f"{stats.ms_per_token:.4f} ms/token over 32 tokens"
          f"{notes['first_use']}", flush=True)
    served["(j) paged batcher"] = serve("(j) paged batcher", paged8, 32, 64, 5,
                                        "q8-kvi8")
    served["(j) monolithic batcher"] = serve("(j) monolithic batcher", eng8, 8,
                                             16, 6, "q8-kvi8")
    for bf, i8_path in (("(f)", "(j) paged batcher"),
                        ("(g)", "(j) monolithic batcher")):
        (tps, p50, p95, nb), (tps8, p508, p958, nb8) = served[bf], served[i8_path]
        print(f"path {i8_path} against {bf}, same requests, same call: "
              f"{tps8:.2f} tok/s against {tps:.2f}; TTFT p50 {p508 * 1e3:.3f} "
              f"ms against {p50 * 1e3:.3f}, p95 {p958 * 1e3:.3f} ms against "
              f"{p95 * 1e3:.3f}; KV pool {nb8} B (int8 data and f32 scales) "
              f"against {nb} B (bf16), {nb8 / nb:.4f}", flush=True)
    del eng8, paged8

    mark("path (j)")

    # (k) aq8 activations, POLICIES["q8a8"], on (a)'s weights (aq8 changes
    # no weight): every block unfused, K1's aq8 branch at M <= 8
    q8a8 = POLICIES["q8a8"]
    enga = Engine(cfg, q8a8, engine.params, max_ctx=2048, device="cuda")
    out, stats = b1_paths("(k) b1", enga, prompt, 64, "q8a8", qmm_bigm=4 * L,
                          flash_prefill=L, qmm_smallm=1 + 64 * (4 * L + 1),
                          flash_decode_heads=64 * L)
    stepa_ms = graph_step(enga, prompt, PROMPT_LEN)
    print(f"path (k) b1: prefill {stats.prefill_s * 1e3:.3f} ms "
          f"({stats.prompt_tokens} tokens, bucket 128); decode "
          f"{stats.ms_per_token:.4f} ms/token over {stats.generated_tokens} "
          f"tokens; one decode step at pos {PROMPT_LEN} replayed as a CUDA "
          f"graph {stepa_ms:.4f} ms against (a)'s {step_ms:.4f} ms (q8, fused "
          f"branch); busy {stepa_ms / stats.ms_per_token:.3f} of a generate "
          "token",
          flush=True)
    long_step("(k)", enga, "q8a8")
    batch_path(enga, f"(k) B={BATCH}", "q8a8")
    paged_a = Engine(cfg, q8a8, engine.params, max_ctx=2048, device="cuda",
                     paged=True)
    gcfg = GenerationConfig(n_predict=PROMPT_LEN + 32, greedy=True,
                            eos_token=-1, chunk_size=32)
    (out, stats), record, want = recorded(
        paged_a, True, lambda: paged_a.generate(prompt, gcfg))
    if not ids_ok([out], [32]) or stats.decode_steps != 32:
        return fail(f"path (k) paged: {len(out)} ids in {stats.decode_steps} "
                    "steps, or ids out of range")
    expect("(k) paged generate", "q8a8", **want)
    print(f"path (k) paged generate: prefill {stats.prefill_s * 1e3:.3f} ms; "
          f"decode {stats.ms_per_token:.4f} ms/token over 32 tokens"
          f"{notes['first_use']}", flush=True)
    del paged_a
    served["(k) monolithic batcher"] = serve("(k) monolithic batcher", enga, 8,
                                             16, 6, "q8a8")
    (tps, p50, p95, _), (tpsa, p50a, p95a, _) = (
        served["(g)"], served["(k) monolithic batcher"])
    print(f"path (k) monolithic batcher against (g), same requests, same call: "
          f"{tpsa:.2f} tok/s against {tps:.2f}; TTFT p50 {p50a * 1e3:.3f} ms "
          f"against {p50 * 1e3:.3f}, p95 {p95a * 1e3:.3f} ms against "
          f"{p95 * 1e3:.3f}", flush=True)
    del enga

    mark("path (k)")

    # (l) f16 and f32 KV caches on (a)'s weights: the bf16 path's kernels,
    # their attention instantiations counted under _f16 / _f32
    for kv in ("f16", "f32"):
        label = f"q8-kv{kv}"
        polk = dataclasses.replace(policy, kv_dtype=kv)
        engk = Engine(cfg, polk, engine.params, max_ctx=2048, device="cuda")
        out, stats = b1_paths(f"(l) {kv} b1", engk, prompt, 64, label,
                              qmm_bigm=4 * L, flash_prefill=L,
                              qmm_smallm=1 + 64, fused_norm_qkv=L * 64,
                              fused_attn_out=L * 64, ffn_fused_normed=L * 64)
        graph_equals(f"(l) {kv} b1", engk, [prompt])
        stepk_ms = graph_step(engk, prompt, PROMPT_LEN)
        print(f"path (l) {kv} b1: prefill {stats.prefill_s * 1e3:.3f} ms; decode "
              f"{stats.ms_per_token:.4f} ms/token over {stats.generated_tokens} "
              f"tokens; one decode step at pos {PROMPT_LEN} replayed as a CUDA "
              f"graph {stepk_ms:.4f} ms against (a)'s {step_ms:.4f} ms (bf16 "
              f"cache)", flush=True)
        batch_path(engk, f"(l) {kv} B={BATCH}", label)
        (outs, stats), record, want = recorded(
            engk, False, lambda: engk.generate_batch(prompts, gcfg))
        if record != {"prefill": [(BATCH, 128)], "chunk": [(BATCH, 32)]} \
                or not ids_ok(outs, [32] * BATCH):
            return fail(f"path (l) {kv} generate_batch: ran {record}, or ids "
                        "out of range")
        expect(f"(l) {kv} generate_batch", label, **want)
        print(f"path (l) {kv} generate_batch: {BATCH} x {PROMPT_LEN}-token "
              f"prompts, one staged 32-step chunk: "
              f"{stats.decode_s * 1e3 / stats.decode_steps:.4f} ms a staged "
              f"B={BATCH} step{notes['first_use']}; cache {tree_nbytes(engk.new_cache(BATCH))} B "
              f"against {tree_nbytes(engine.new_cache(BATCH))} B in bf16",
              flush=True)
        pagedk = Engine(cfg, polk, engine.params, max_ctx=2048, device="cuda",
                        paged=True)
        (out, stats), record, want = recorded(
            pagedk, True, lambda: pagedk.generate(prompt, gcfg))
        if not ids_ok([out], [32]) or stats.decode_steps != 32:
            return fail(f"path (l) {kv} paged: {len(out)} ids in "
                        f"{stats.decode_steps} steps, or ids out of range")
        expect(f"(l) {kv} paged generate", label, **want)
        print(f"path (l) {kv} paged generate: prefill "
              f"{stats.prefill_s * 1e3:.3f} ms (K3 over the step's own bf16 "
              f"keys); decode {stats.ms_per_token:.4f} ms/token over 32 tokens"
              f"{notes['first_use']}", flush=True)
        if kv == "f16":
            path = "(l) f16 paged batcher"
            served[path] = serve(path, pagedk, 32, 64, 5, label)
            (tps, p50, p95, nb), (tpsk, p50k, p95k, nbk) = (served["(f)"],
                                                           served[path])
            print(f"path {path} against (f), same requests, same call: "
                  f"{tpsk:.2f} tok/s against {tps:.2f}; TTFT p50 "
                  f"{p50k * 1e3:.3f} ms against {p50 * 1e3:.3f}, p95 "
                  f"{p95k * 1e3:.3f} ms against {p95 * 1e3:.3f}; KV pool {nbk} B "
                  f"against {nb} B (bf16), {nbk / nb:.4f}", flush=True)
        else:  # f32: one staged 32-step chunk over the pool at B = 4 (K11)
            (outs, stats), record, want = recorded(
                pagedk, True, lambda: pagedk.generate_batch(prompts, gcfg))
            if record["chunk"] != [(BATCH, 32)] or not ids_ok(outs, [32] * BATCH):
                return fail(f"path (l) {kv} paged generate_batch: ran {record}, "
                            "or ids out of range")
            expect(f"(l) {kv} paged generate_batch", label, **want)
            print(f"path (l) {kv} paged generate_batch: {BATCH} x {PROMPT_LEN}"
                  f"-token prompts, one staged 32-step chunk over the pool: "
                  f"{stats.decode_s * 1e3 / stats.decode_steps:.4f} ms a staged "
                  f"B={BATCH} step{notes['first_use']}", flush=True)
        del engk, pagedk

    mark("path (l)")

    # (m) and (n) take (h)'s stand-in tokenizer: wait for the child here
    t0 = time.perf_counter()
    writer_out, _ = writer.communicate()
    if writer.returncode:
        return fail(f"path (h): writing the files failed ({writer.returncode})")
    writer_wait = time.perf_counter() - t0
    tok = tokenizer.Tokenizer(vocab)
    n_prompt = len(tok.encode(CLI_PROMPT))
    if not 33 <= n_prompt <= 128:
        return fail(f"path (h): the templated prompt has {n_prompt} tokens")

    # (m) the HTTP server and the router over the port's batcher, on (a)'s
    # q8 weights: a paged engine, SERVE_SLOTS slots, an ephemeral port
    from tinyllama_tpu_torch.runtime import router as http_router
    from tinyllama_tpu_torch.runtime import server as http_server

    words = CLI_PROMPT.replace(",", "").replace(".", "").split()
    mrng = np.random.default_rng(8)
    payloads = [{"prompt": " ".join(words[: int(k)]), "max_new": SERVE_NEW,
                 "stream": i % 2 == 1}
                for i, k in enumerate(mrng.integers(3, len(words) + 1,
                                                    SERVE_REQUESTS))]
    gen_m = GenerationConfig(greedy=True, eos_token=-1, chunk_size=32)
    m_engines = [Engine(cfg, policy, engine.params, max_ctx=2048,
                        device="cuda", paged=True) for _ in range(2)]
    servers = [http_server.serve(e, tok, gen_m, 0, max_batch=SERVE_SLOTS)
               for e in m_engines]
    ports = [start_server(h) for h in servers]

    def clients(port, reqs):
        """Each request of `reqs` from SERVE_CLIENTS client threads; their
        (tokens, TTFT), each checked for SERVE_NEW ids in range."""
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            answers = list(pool.map(lambda r: http_generate(port, r, tok), reqs))
        if not ids_ok([a for a, _ in answers], [SERVE_NEW] * len(reqs)):
            raise AssertionError(f"a request to :{port} did not get its "
                                 f"{SERVE_NEW} ids in range")
        return answers

    # a first pass of the requests, then waves of 1, 2 and 4, capture the
    # chunk graphs of the buckets the server runs (which ones depends on
    # how the requests arrive)
    before = graphs_of(m_engines[0])
    t0 = time.perf_counter()
    clients(ports[0], payloads)
    for n in (1, 2, 4):
        clients(ports[0], payloads[:n])
    graph_line(f"(m) server first pass ({time.perf_counter() - t0:.3f} s)",
               m_engines[0], before)
    before = graphs_of(m_engines[0])
    t0 = time.perf_counter()
    answers, record, want = recorded(m_engines[0], True,
                                     lambda: clients(ports[0], payloads))
    wall = time.perf_counter() - t0
    expect("(m) server", **want)
    graph_line("(m) server measured pass", m_engines[0], before)
    got = {k: v for c in counters for k, v in c.items()}
    if not (got["qmm_smallm"] and got["flash_prefill"]
            and got["fused_out_residual"] and got["ffn_fused_normed"]
            and got["qmm_bigm"] + got["fused_norm_qkv"]
            and got["flash_paged_staged"] + got["flash_paged"]
            and not got["fused_attn_out"]):
        return fail(f"path (m): the server's launches {got} miss a serving "
                    "kernel, or launched K8")
    ttft = np.array([t for (_, t), p in zip(answers, payloads) if p["stream"]])
    ttft_srv = np.array([t for (_, t), p in zip(answers, payloads)
                         if not p["stream"]])
    print(f"path (m): serve(Engine(paged=True), max_batch={SERVE_SLOTS}) over "
          f"HTTP, {SERVE_REQUESTS} requests ({SERVE_REQUESTS // 2} streamed) "
          f"from {SERVE_CLIENTS} client threads, {SERVE_NEW} greedy tokens "
          f"each: {SERVE_REQUESTS / wall:.3f} requests/s, "
          f"{SERVE_REQUESTS * SERVE_NEW / wall:.2f} tok/s, wall {wall:.3f} s; "
          f"client TTFT of the streamed requests p50 "
          f"{np.percentile(ttft, 50) * 1e3:.3f} ms p95 "
          f"{np.percentile(ttft, 95) * 1e3:.3f} ms (server ttft_ms of the "
          f"others p50 {np.percentile(ttft_srv, 50) * 1e3:.3f} ms); "
          f"{len(record['prefill'])} admissions, {len(record['chunk'])} chunks "
          f"at buckets {sorted({B for B, _ in record['chunk']})}, the chunks' "
          f"graphs replayed; card {card}", flush=True)
    # the same requests with the eager chunk
    t0 = time.perf_counter()
    with eager_chunks():
        answers_e, record_e, want_e = recorded(
            m_engines[0], True, lambda: clients(ports[0], payloads))
    wall_e = time.perf_counter() - t0
    expect("(m) server eager", **want_e)
    ttft_e = np.array([t for (_, t), p in zip(answers_e, payloads)
                       if p["stream"]])
    print(f"path (m): the same requests with the eager chunk: "
          f"{SERVE_REQUESTS / wall_e:.3f} requests/s against "
          f"{SERVE_REQUESTS / wall:.3f} with graphs, wall {wall_e:.3f} s; "
          f"client TTFT p50 {np.percentile(ttft_e, 50) * 1e3:.3f} ms p95 "
          f"{np.percentile(ttft_e, 95) * 1e3:.3f} ms against "
          f"{np.percentile(ttft, 50) * 1e3:.3f} / "
          f"{np.percentile(ttft, 95) * 1e3:.3f}; "
          f"{len(record_e['prefill'])} admissions, {len(record_e['chunk'])} "
          f"chunks; card {card}", flush=True)
    # one request alone: the tokens of ContinuousBatcher.run on the engine
    alone, _ = http_generate(ports[0], {**payloads[0], "stream": False}, tok)
    solo = ContinuousBatcher(m_engines[0], gen_m, max_batch=SERVE_SLOTS)
    rid = solo.submit(tok.encode(payloads[0]["prompt"]), max_new=SERVE_NEW)
    if solo.run()[rid].output != alone:
        return fail("path (m): a request sent alone did not give "
                    "ContinuousBatcher.run's tokens")
    print("path (m): a request sent alone gives ContinuousBatcher.run's "
          f"{SERVE_NEW} tokens", flush=True)
    del solo

    # the router over two such servers, each its own Engine on the card;
    # then one backend stops and every later request is still answered
    rt = http_router.serve_router([f"http://127.0.0.1:{p}" for p in ports],
                                  0, probe_interval=0.2, max_failures=1)
    rport = start_server(rt)
    before = [len(h.batcher.results) for h in servers]
    _, record, want = recorded(m_engines, True,
                               lambda: clients(rport, payloads[:8]))
    expect("(m) router", **want)
    spread = [len(h.batcher.results) - n for h, n in zip(servers, before)]
    servers[1].shutdown()
    servers[1].server_close()
    deadline = time.monotonic() + 20
    while all(b["healthy"] for b in http_health(rport)["backends"]):
        if time.monotonic() > deadline:
            return fail("path (m): the router did not see the stopped backend")
        time.sleep(0.05)
    t0 = time.perf_counter()
    _, record, want = recorded(m_engines, True,
                               lambda: clients(rport, payloads[8:]))
    expect("(m) router, one backend stopped", **want)
    health = http_health(rport)
    down = [b["url"] for b in health["backends"] if not b["healthy"]]
    if down != [f"http://127.0.0.1:{ports[1]}"] or health["status"] != "ok":
        return fail(f"path (m): the router's /healthz after the stop: {health}")
    print(f"path (m): serve_router over 2 servers: 8 requests answered "
          f"(served {spread}); one backend stopped, /healthz shows it down, "
          f"and {len(payloads) - 8} more requests answered through the other in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    rt.shutdown()
    rt.server_close()
    rt.router.close()
    servers[0].shutdown()
    servers[0].server_close()
    # (f)'s requests again, with the batcher's first-token dial at 16
    path = "(m) ttft_chunk=16"
    served[path] = serve(path, m_engines[0], ADMIT, 64, 5, ttft_chunk=16)
    (tps, p50, p95, _), (tpst, p50t, p95t, _) = served["(f)"], served[path]
    print(f"path {path} against (f), same requests, same call: {tpst:.2f} "
          f"tok/s against {tps:.2f}; TTFT p50 {p50t * 1e3:.3f} ms against "
          f"{p50 * 1e3:.3f}, p95 {p95t * 1e3:.3f} ms against {p95 * 1e3:.3f}; "
          f"card {card}", flush=True)
    del m_engines, servers

    mark("path (m)")

    # (n) dense weights on the card: the plain path, as the JAX package
    # runs dense weights without Pallas, so every counter must read 0
    def dense_cli(name):
        flag = "-f16" if name == "f16" else f"--{name}"
        eng, toks, out, stats = run_cli(
            [flag, "--random-weights", "--tokenizer", str(vocab), "-p",
             CLI_PROMPT, "-greedy", "--npred", str(n_prompt + DENSE_NEW),
             "--model", cfg.name])
        steps = stats.decode_steps
        if (len(toks) != n_prompt or eng.policy != POLICIES[name]
                or not 0 < len(out) <= steps <= DENSE_NEW
                or not all(0 <= t < cfg.n_vocab for t in out)):
            raise AssertionError(f"path (n) {name}: {len(toks)} prompt tokens, "
                                 f"{len(out)} ids in {steps} steps, policy "
                                 f"{eng.policy}")
        expect(f"(n) {name} cli", name)
        print(f"path (n) {name}: cli.main {flag} --random-weights --tokenizer "
              f"--npred {n_prompt + DENSE_NEW}: weights stored as "
              f"{eng.params['layers']['wqkv'].dtype} at Engine build; load "
              f"{stats.load_s:.3f} s, prefill {stats.prefill_s * 1e3:.3f} ms "
              f"({n_prompt} tokens), decode {stats.ms_per_token:.4f} ms/token "
              f"over {len(out)} tokens (the chunk's graph, its capture "
              f"included; no port kernel); card {card}",
              flush=True)
        return eng

    eng16 = dense_cli("f16")
    out, stats = b1_paths("(n) f16 (a)", eng16, prompt, 64, "f16")
    graph_equals("(n) f16 b1", eng16, [prompt])
    graph_equals("(n) f16 B=4", eng16, prompts)
    print(f"path (n) f16 (a): prefill {stats.prefill_s * 1e3:.3f} ms "
          f"({PROMPT_LEN} tokens), decode {stats.ms_per_token:.4f} ms/token "
          f"over 64 tokens", flush=True)
    paged16 = Engine(cfg, POLICIES["f16"], eng16.params, max_ctx=2048,
                     device="cuda", paged=True)
    gcfg = GenerationConfig(n_predict=PROMPT_LEN + 64, greedy=True,
                            eos_token=-1, chunk_size=32)
    (out, stats), _, _ = recorded(paged16, True,
                                  lambda: paged16.generate(prompt, gcfg))
    if not ids_ok([out], [64]):
        return fail(f"path (n) f16 paged: {len(out)} ids, or ids out of range")
    expect("(n) f16 paged generate", "f16")
    print(f"path (n) f16 paged generate: prefill {stats.prefill_s * 1e3:.3f} "
          f"ms, decode {stats.ms_per_token:.4f} ms/token over 64 tokens"
          f"{notes['first_use']}", flush=True)
    del paged16
    path = "(n) f16 monolithic batcher"
    served[path] = serve(path, eng16, 8, 16, 6, "f16")
    (tps, p50, _, _), (tps16, p5016, _, _) = served["(g)"], served[path]
    print(f"path {path} against (g) (q8, kernels), same requests: "
          f"{tps16:.2f} tok/s against {tps:.2f}; TTFT p50 {p5016 * 1e3:.3f} ms "
          f"against {p50 * 1e3:.3f}", flush=True)
    del eng16
    for name in ("bf16", "f32"):
        dense_cli(name)

    mark("path (n)")

    # (h) 4-bit weights from a file through the CLI: a full-depth q4 .gten
    # loaded as q4, then as q4g (requantized at load); (i) the chat and
    # batched paths on each of those engines; then the 4-bit kernel rows
    # on its weights
    del engine, params

    def cli_path(kind, ckpt, vocab, n_prompt, kv=None, eager_too=False):
        """cli.main on the file (with --kv `kv` when given); the engine it
        builds and its generate call are caught by run_cli. Its decode
        runs whole 32-step chunks (the first of them captures the chunk's
        graph), so the steps run are a whole number of chunks within one
        chunk of the budget. With eager_too, cli.main again with the eager
        chunk: the same ids and counts."""
        policy_name = f"{kind}-kv{kv}" if kv else kind
        policy = (dataclasses.replace(POLICIES[kind], kv_dtype=kv) if kv
                  else POLICIES[kind])
        argv = ([f"-{kind}", "--ckpt", str(ckpt), "--tokenizer", str(vocab),
                 "-p", CLI_PROMPT, "-greedy", "--npred", str(CLI_NPRED),
                 "--model", cfg.name] + (["--kv", kv] if kv else []))
        eng, toks, out, stats = run_cli(argv)
        steps, budget = stats.decode_steps, CLI_NPRED - n_prompt
        if (len(toks) != n_prompt or eng.policy != policy
                or eng.params["lm_head"].kind != kind
                or not len(out) <= min(steps, budget)
                or steps % 32 or steps > -(-budget // 32) * 32
                or not all(0 <= t < cfg.n_vocab for t in out)):
            raise AssertionError(f"path (h) {kind}: {len(toks)} prompt tokens, "
                                 f"{len(out)} ids in {steps} steps, weights "
                                 f"{eng.policy.wdtype}, or ids out of range")
        expect(f"(h) {policy_name}", policy_name, qmm_bigm=4 * L,
               flash_prefill=L, qmm_smallm=1 + steps, fused_norm_qkv=L * steps,
               fused_attn_out=L * steps, ffn_fused_normed=L * steps)
        flags = f"-{kind}" + (f" --kv {kv}" if kv else "")
        print(f"path (h) {policy_name}: cli.main {flags} --ckpt (q4 .gten) "
              "--tokenizer: "
              f"load {stats.load_s:.3f} s, prefill {stats.prefill_s * 1e3:.3f} "
              f"ms ({n_prompt} tokens, bucket 128, first launches of the "
              f"{kind} kernels included), decode {stats.ms_per_token:.4f} "
              f"ms/token over {len(out)} tokens in {steps} steps (the chunk's "
              f"graph captured at its first chunk: {eng.graph_stats['graphs']} "
              f"graph in {eng.graph_stats['capture_s']:.3f} s)", flush=True)
        if eager_too:
            with eager_chunks():
                _, _, out_e, stats_e = run_cli(argv)
            expect(f"(h) {policy_name} eager", policy_name, qmm_bigm=4 * L,
                   flash_prefill=L, qmm_smallm=1 + steps,
                   fused_norm_qkv=L * steps, fused_attn_out=L * steps,
                   ffn_fused_normed=L * steps)
            if out_e != out or stats_e.decode_steps != steps:
                raise AssertionError(f"path (h) {policy_name}: the eager "
                                     "chunk's ids are not the graph's")
            print(f"path (h) {policy_name}: decode {stats.ms_per_token:.4f} "
                  f"ms/token with the chunk's graph (its capture included), "
                  f"{stats_e.ms_per_token:.4f} eager, the same {len(out)} "
                  f"ids; card {card}", flush=True)
        # the device's own time for one decode step, as for (a)
        cache = eng.new_cache(1)
        eng.prefill(cache, [toks])
        tok = torch.tensor([5], dtype=torch.int32, device="cuda")
        pos = torch.tensor([n_prompt], dtype=torch.int32, device="cuda")
        step_ms = time_ms(lambda i: eng.decode_step(cache, tok, pos), 20, True)
        print(f"path (h) {policy_name}: one decode step at pos {n_prompt} "
              "replayed as "
              f"a CUDA graph: {step_ms:.4f} ms device time; the CLI's "
              f"{stats.ms_per_token:.4f} ms/token (its first chunk's capture "
              f"included), so the device is busy "
              f"{step_ms / stats.ms_per_token:.3f} of its token", flush=True)
        return eng

    with files:
        print(f"path (h): wrote a {ckpt.stat().st_size / 1e6:.1f} MB q4 .gten "
              f"of TinyLlama-1.1B (random N(0, 0.02) weights, one tensor at a "
              f"time) and a stand-in tokenizer.bin in {writer_out.strip()} s, "
              "in a child process started before the build (waited after "
              f"(l) {writer_wait:.1f} s)", flush=True)
        for kind in ("q4", "q4g"):
            eng4 = cli_path(kind, ckpt, vocab, n_prompt, eager_too=kind == "q4")
            chat_path(eng4, f"(i) {kind} chat", kind)
            batch_path(eng4, f"(i) {kind} B={BATCH}", kind)
            rows += phase_kernels(eng4, torch, ops, kind)
            if kind == "q4":
                # (k) q4a8 on the same q4 weights: (b) and (c)
                enga = Engine(cfg, POLICIES["q4a8"], eng4.params, max_ctx=2048,
                              device="cuda")
                chat_path(enga, "(k) q4a8 chat", "q4a8")
                batch_path(enga, f"(k) q4a8 B={BATCH}", "q4a8")
                rows += phase_kernels(enga, torch, ops, "q4", aq8=True)
                del enga
            del eng4
        # the CLI's --kv i8 and --kv f16 on the same file (q4-kvi8,
        # q4-kvf16)
        cli_path("q4", ckpt, vocab, n_prompt, kv="i8")
        cli_path("q4", ckpt, vocab, n_prompt, kv="f16")

    for r in rows:
        names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
        r["launches"] = sum(totals[r["kind"]][k] for k in names)
        if not r["launches"]:
            return fail(f"{r['kernel']} ({r['kind']}) was not launched on any "
                        "path")

    mark("paths (h), (i)")

    # 5. parity: 2 layers at full width, the same weights on card and CPU
    cfg2 = TINYLLAMA_1_1B.replace(n_layers=2, max_ctx=256)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(99)
    feed = rng.integers(2, cfg2.n_vocab, 4).tolist()
    chats = [prompt_of(CHAT_LEN) for _ in range(BATCH)]
    worst = 0.0

    def parity_trace(eng, tag, b1_steps, short=False, b4=False, staged=(),
                     paged_b1=False):
        """Last-token logits of one engine: a long prefill, b1_steps
        teacher-forced decode steps, then as asked a short (fused) prefill,
        a B = 4 decode step, staged chunk steps over a monolithic and/or a
        paged cache, and a paged b1 step."""
        dev = eng.device

        def i32(values):
            return torch.tensor(values, dtype=torch.int32, device=dev)

        cache = eng.new_cache(1)
        logits, _ = eng.prefill(cache, [prompt])
        trace = [(f"{tag}long prefill", logits)]
        pos = i32([PROMPT_LEN])
        for i, t in enumerate(feed[:b1_steps]):
            trace.append((f"{tag}b1 decode {i}", eng.decode_step(cache, i32([t]),
                                                                 pos)))
            pos += 1
        if short:
            trace.append((f"{tag}short prefill",
                          eng.prefill(eng.new_cache(1), [chat])[0]))
        step_tok, step_pos = i32(feed), i32([CHAT_LEN] * BATCH)
        if b4:
            cache = eng.new_cache(BATCH)
            eng.prefill(cache, chats)
            trace.append((f"{tag}B={BATCH} decode", eng.decode_step(
                cache, step_tok, step_pos)))
        for kind in staged:
            cache = (eng.new_cache(BATCH) if kind == "monolithic"
                     else eng.new_paged_cache(BATCH))
            eng.prefill(cache, chats)
            st = stage_cache(cache, step_pos, 32)
            eng.decode_step(st, step_tok, step_pos)
            trace.append((f"{tag}B={BATCH} staged {kind} chunk step 2",
                          eng.decode_step(st, step_tok + 1, step_pos + 1)))
        if paged_b1:
            cache = eng.new_paged_cache(1)
            eng.prefill(cache, [prompt])
            trace.append((f"{tag}paged b1 decode", eng.decode_step(
                cache, step_tok[:1], i32([PROMPT_LEN]))))
        return [(n, t.float().cpu()) for n, t in trace]

    #: each trace's limit, relative to max |cpu logits|
    limit = {}

    #: the CPU's traces run in the background, on four threads (the plain
    #: ops hold no lock and launch nothing on the card), while the card's go
    #: on; they are checked once all are in
    cpu_side = ThreadPoolExecutor(4)

    def parity(pol, params_, *args, rel=PARITY_REL, **kw):
        """One policy's traces: the card's now, the CPU's in the background;
        [(card trace, future of the CPU's)]."""
        card_ = parity_trace(Engine(cfg2, pol, params_, device="cuda"), *args,
                             **kw)
        cpu_ = cpu_side.submit(lambda: parity_trace(
            Engine(cfg2, pol, params_, device="cpu"), *args, **kw))
        limit.update({name: rel for name, _ in card_})
        mark(f"parity {args[0] or 'q8 '}card traces")
        return [(card_, cpu_)]

    p2 = llama.init_quantized_params(cfg2, policy, cpu_gen, "cpu")
    # q8: long prefill and 4 decode steps, the short (fused) prefill, B = 4,
    # staged chunk steps (K9, K11) and a paged b1 step (K10)
    pairs = parity(policy, p2, "", 4, short=True, b4=True,
                   staged=("monolithic", "paged"), paged_b1=True)
    # the 4-bit weights: a long (K2) and a short (K5, K3, K6, K7) prefill,
    # b1 decode steps (K5, K8, K7, K1) and a B = 4 step (K6)
    p4 = {}
    for kind in ("q4", "q4g"):
        p4[kind] = llama.init_quantized_params(cfg2, POLICIES[kind], cpu_gen, "cpu")
        pairs += parity(POLICIES[kind], p4[kind], f"{kind} ", 2, short=True,
                        b4=True)
    # the int8 KV cache (q8-kvi8): a long prefill (K2, K3), b1 steps (K8), a
    # B = 4 step (K4), staged chunk steps (K9, K11) and a paged b1 step (K10)
    pairs += parity(kvi8, p2, "i8 ", 2, b4=True, staged=("monolithic", "paged"),
                    paged_b1=True)
    # aq8 (q8a8, q4a8): a long prefill (K2, K3, the lm_head's K1-aq8), b1
    # steps (K1-aq8, K4) and a B = 4 step (K1-aq8 at M = 4)
    pairs += parity(POLICIES["q8a8"], p2, "q8a8 ", 2, b4=True)
    pairs += parity(POLICIES["q4a8"], p4["q4"], "q4a8 ", 2, b4=True)
    # f16 and f32 caches: a long prefill (K3), b1 steps (K8) and a staged
    # paged chunk step (K11)
    for kv in ("f16", "f32"):
        pairs += parity(dataclasses.replace(policy, kv_dtype=kv), p2, f"{kv} ",
                        2, staged=("paged",))
    # dense f16, bf16 and f32: the card's plain path against the CPU's, the
    # weights through an fp16 .gten the port writes and loads: a long and a
    # short prefill, 2 b1 steps and a B = 4 step
    with tempfile.TemporaryDirectory() as tmp:
        path16 = Path(tmp) / "parity.fp16.gten"
        checkpoint.save_gten_checkpoint(
            path16, cfg2, llama.init_dense_params(cfg2, cpu_gen), "fp16")
        for name in ("f16", "bf16", "f32"):
            pd, _ = checkpoint.load_gten_checkpoint(path16, cfg2,
                                                    POLICIES[name])
            pairs += parity(POLICIES[name], pd, f"dense {name} ", 2, short=True,
                            b4=True,
                            rel=F32_PARITY_REL if name == "f32" else PARITY_REL)

    # a reading, not a gate: the int8 cache's greedy tokens on the b1 path
    # (K8 dequantizes keys and values to bf16 as the plain version does,
    # which the JAX kernel does not), the CPU fed the card's tokens
    def greedy_b1(eng, steps, forced=None):
        """(tokens, logits) of `steps` greedy b1 decode steps after the
        long prefill; with `forced`, each step takes forced's token."""
        def i32(values):
            return torch.tensor(values, dtype=torch.int32, device=eng.device)

        cache = eng.new_cache(1)
        logits = eng.prefill(cache, [prompt])[0]
        toks, seen = [], []
        for i in range(steps):
            seen.append(logits.float().cpu()[0])
            toks.append(int(seen[-1].argmax()) if forced is None else forced[i])
            logits = eng.decode_step(cache, i32([toks[-1]]), i32([PROMPT_LEN + i]))
        return toks, seen

    card_toks, _ = greedy_b1(Engine(cfg2, kvi8, p2, device="cuda"), GREEDY_STEPS)
    cpu_reading = cpu_side.submit(lambda: greedy_b1(
        Engine(cfg2, kvi8, p2, device="cpu"), GREEDY_STEPS, card_toks)[1])
    pairs = [pair for card_, cpu_ in pairs
             for pair in zip(card_, cpu_.result())]
    mark("parity CPU traces")
    for (name, a), (_, b) in pairs:
        if not (torch.isfinite(a).all() and a.shape[-1] == cfg2.n_vocab):
            return fail(f"parity {name}: logits not finite or misshapen")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if limit[name] == PARITY_REL:
            worst = max(worst, err / scale)
        print(f"parity {name}: max |gpu - cpu| {err:.5f}, max |cpu| "
              f"{scale:.4f}, mean |diff| {float((a - b).abs().mean()):.6f} "
              f"(limit {limit[name]} of max |cpu|)")
        if err > limit[name] * scale:
            return fail(f"parity {name}: {err} > {limit[name]} * {scale}")
    print(f"parity: worst relative max error {worst:.5f} (limit {PARITY_REL}; "
          f"dense f32 within {F32_PARITY_REL})")

    cpu_logits = cpu_reading.result()
    cpu_side.shutdown()
    margins = [float(x.max() - x[t]) for t, x in zip(card_toks, cpu_logits)]
    print(f"i8 b1 greedy: the CPU picks the card's token at "
          f"{sum(m == 0 for m in margins)} of {GREEDY_STEPS} steps (pos "
          f"{PROMPT_LEN}-{PROMPT_LEN + GREEDY_STEPS - 1}); where not, its own "
          f"pick beats the card's by at most {max(margins):.5f}")
    mark("i8 greedy reading")

    # (o) Llama-3-8B (d = 128, G = 4): its attention kernels' d = 128 rows,
    # then its paths at full width and depth on random weights made on the
    # card, bf16 activations, max_ctx 8,192; the helpers above read cfg and
    # L, so they count and check for it from here on
    from tinyllama_tpu_torch.config import LLAMA_3_70B, LLAMA_3_8B

    free()
    t_o = time.perf_counter()
    rows8 = []
    for kv in ("bf16", "i8", "f16", "f32"):
        rows8 += phase_attention_d128(torch, ops, kv)
    mark("(o) d = 128 kernel rows")
    cfg, L = LLAMA_3_8B, LLAMA_3_8B.n_layers
    kinds8 = ("8b-q4", "8b-q8", "8b-q4g", "8b-q4-kvi8", "8b-q4-kvf16",
              "8b-q4-kvf32")
    totals.update({kind: {k: 0 for c in counters for k in c} for kind in kinds8})
    rng = np.random.default_rng(16)

    def init8(kind):
        g = torch.Generator("cuda")
        g.manual_seed(8)
        t0 = time.perf_counter()
        p = llama.init_quantized_params(cfg, POLICIES[kind], g, "cuda")
        torch.cuda.synchronize()
        print(f"init: Llama-3-8B {kind} random weights on the card in "
              f"{time.perf_counter() - t0:.1f} s, {tree_nbytes(p) / 1e9:.3f} GB",
              flush=True)
        return p

    def engine8(policy, paged=False):
        return Engine(cfg, policy, params8, max_ctx=cfg.max_ctx, device="cuda",
                      paged=paged)

    def run8(path, eng, run, kind="8b-q4"):
        """run() with its shapes recorded and its exact counts checked."""
        out_, record_, want_ = recorded(eng, eng.paged, run)
        expect(path, kind, **want_)
        return out_, record_

    params8 = init8("q4")
    q4_8b = POLICIES["q4"]
    eng8 = engine8(q4_8b)
    prompt8 = prompt_of(1000)
    prompt100 = prompt_of(100)
    # (o1) b1 generate: a 1,000-token prompt (bucket 1,024: K2, K3 at T =
    # 1,024), 128 greedy tokens on the unfused branch (K1, K4)
    out, stats = b1_paths("(o1) 8B q4", eng8, prompt8, 128, "8b-q4")
    print(f"path (o1) 8B q4: prefill {stats.prefill_s * 1e3:.3f} ms (1,000 "
          f"tokens, bucket {engine_bucket(1000, eng8.max_ctx)}); decode "
          f"{stats.ms_per_token:.4f} ms/token over 128 tokens (graph); graph "
          f"captures so far {eng8.graph_stats['graphs']} in "
          f"{eng8.graph_stats['capture_s']:.3f} s; card {card}", flush=True)
    print("path (o1) 8B q4: torch.profiler over eager decode steps at pos 100:",
          flush=True)
    profile_decode(eng8, prompt100, torch)
    # (p5) speculative decoding on this engine, k = 4: the unfused branch
    # (K1 at M = 5 for every linear and the lm_head, K3 at d = 128 from
    # pos > 0)
    spec_line("(p5) 8B q4", eng8, prompt100, 64, "8b-q4", stats.ms_per_token)
    mark("(o1) q4")
    # (o2) long context, paged: a 7,000-token prompt (bucket 8,192: K3 at T
    # = 8,192 over the temporary cache), 64 tokens (K10 at pos 7,000-7,063,
    # the chunk captured at its first position and replayed at the next)
    peng = engine8(q4_8b, paged=True)
    long8 = prompt_of(7000)
    (out, stats), _ = run8("(o2) paged 7,000-token prompt", peng,
                           lambda: peng.generate(long8, GenerationConfig(
                               n_predict=7064, greedy=True, eos_token=-1,
                               chunk_size=32)))
    if not ids_ok([out], [64]):
        return fail(f"path (o2): {len(out)} ids, or ids out of range")
    ms = graph_step(peng, long8, 7000)
    print(f"path (o2) 8B q4 paged: 7,000-token prompt: prefill "
          f"{stats.prefill_s * 1e3:.3f} ms (bucket 8,192, eager, host clock); "
          f"decode {stats.ms_per_token:.4f} ms/token over 64 tokens (pos "
          f"7,000-7,063{notes['first_use']}); one step at pos 7,000 replayed "
          f"as a CUDA graph {ms:.4f} ms; card {card}", flush=True)
    mark("(o2) paged long context")
    # (o3) serving: generate_batch of 4 prompts (staged chunks, K9), then
    # the paged batcher, 16 slots, 32 requests (K11; K10 at bucket 1; K3 at
    # admission)
    batch8 = [prompt_of(n) for n in (100, 200, 300, 400)]
    gcfg = GenerationConfig(n_predict=464, greedy=True, eos_token=-1,
                            chunk_size=32)
    t0 = time.perf_counter()
    (outs, stats), record = run8("(o3) generate_batch", eng8,
                                 lambda: eng8.generate_batch(batch8, gcfg))
    if not ids_ok(outs, [364, 264, 164, 64]):
        return fail(f"path (o3) generate_batch: {[len(o) for o in outs]} ids")
    print(f"path (o3) 8B q4 generate_batch of 4 prompts (100-400 tokens, to "
          f"464): prefill {stats.prefill_s * 1e3:.3f} ms (bucket "
          f"{record['prefill'][0][1]}), decode {stats.decode_s * 1e3 / stats.decode_steps:.4f} "
          f"ms a staged B=4 step over {stats.decode_steps} steps"
          f"{notes['first_use']}; wall {time.perf_counter() - t0:.3f} s",
          flush=True)
    del eng8
    free()
    torch.cuda.reset_peak_memory_stats()
    tps, p50, p95, nb = serve("(o3) 8B q4 paged batcher", peng, 16, 32, 7,
                              "8b-q4", lens_range=(64, 2049),
                              new_range=(32, 129))
    print(f"path (o3): 8B q4 paged batcher, 16 slots, 32 requests (seed 7, "
          f"prompts 64-2,048, 32-128 new): {tps:.2f} tok/s, TTFT p50 "
          f"{p50 * 1e3:.3f} ms p95 {p95 * 1e3:.3f} ms; KV pool {nb} B; "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} "
          f"B; card {card}", flush=True)
    del peng
    free()
    mark("(o3) serving")
    # (o4) the int8 cache: b1 generate (int8 K3, K4), then one paged
    # batcher admission of 8 requests and their chunks (int8 K11)
    q4i8 = POLICIES["q4-kvi8"]
    eng8 = engine8(q4i8)
    b1_paths("(o4) 8B q4-kvi8", eng8, prompt100, 64, "8b-q4-kvi8")
    del eng8
    free()
    peng = engine8(q4i8, paged=True)
    tps, p50, p95, nb = serve("(o4) 8B q4-kvi8 paged batcher", peng, 8, 8, 9,
                              "8b-q4-kvi8", lens_range=(64, 513),
                              new_range=(32, 33))
    print(f"path (o4): one admission of 8 requests over an int8 pool: "
          f"{tps:.2f} tok/s, TTFT p50 {p50 * 1e3:.3f} ms; KV pool {nb} B",
          flush=True)
    del peng
    free()
    # int8, f16 and f32 caches: b1 (K3, K4), generate_batch (K9), paged b1
    # (K3 over the step's own keys, int8 when the pool is; K10) and a paged
    # generate_batch (K11), one eager 8-step chunk each (a capture would
    # cost seconds a run here)
    gcfg = GenerationConfig(n_predict=108, greedy=True, eos_token=-1,
                            chunk_size=8)
    for kv in ("i8", "f16", "f32"):
        polk = dataclasses.replace(q4_8b, kv_dtype=kv)
        for paged in (False, True):
            engk = engine8(polk, paged)
            with eager_chunks():
                (out, stats), _ = run8(f"(o4) 8B q4-kv{kv} b1 paged={paged}",
                                       engk, lambda: engk.generate(prompt100, gcfg),
                                       f"8b-q4-kv{kv}")
                (outs, _), _ = run8(f"(o4) 8B q4-kv{kv} B=4 paged={paged}", engk,
                                    lambda: engk.generate_batch(batch8[:1] * 4,
                                                                gcfg),
                                    f"8b-q4-kv{kv}")
            if not ids_ok([out] + outs, [8] * 5):
                return fail(f"path (o4) {kv}: ids out of range")
            print(f"path (o4) 8B q4-kv{kv} paged={paged}: b1 decode "
                  f"{stats.ms_per_token:.4f} ms/token over 8 tokens (eager "
                  f"chunk)", flush=True)
            del engk
            free()
    del params8
    free()
    mark("(o4) KV kinds")
    # q8 and q4g: b1 generate, a 100-token prompt and 64 tokens each
    for kind in ("q8", "q4g"):
        params8 = init8(kind)
        eng8 = engine8(POLICIES[kind])
        b1_paths(f"(o1) 8B {kind}", eng8, prompt100, 64, f"8b-{kind}")
        del eng8, params8
        free()
    mark("(o1) q8, q4g")
    # (o5) the CLI on the card: random q4 weights, 32 tokens
    eng_c, toks, out, stats = run_cli(
        ["--model", "llama-3-8b", "-q4", "--random-weights", "-p", CLI_PROMPT,
         "-greedy", "--npred", str(len(CLI_PROMPT) + 1 + 32)])
    want = {k: 0 for c in counters for k in c}
    prefill_counts(want, 1, engine_bucket(len(toks), eng_c.max_ctx), False, True)
    chunk_counts(want, 1, stats.decode_steps, False, True)
    expect("(o5) cli", "8b-q4", **want)
    if not (eng_c.cfg.name == "llama-3-8b" and ids_ok([out], [len(out)])
            and 0 < len(out) <= 32):
        return fail(f"path (o5): {eng_c.cfg.name}, {len(out)} ids")
    print(f"path (o5): cli.main --model llama-3-8b -q4 --random-weights: load "
          f"{stats.load_s:.3f} s, prefill {stats.prefill_s * 1e3:.3f} ms "
          f"({len(toks)} tokens), decode {stats.ms_per_token:.4f} ms/token over "
          f"{len(out)} tokens (its first chunk's capture included); card {card}",
          flush=True)
    del eng_c
    free()
    for r in rows8:
        names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
        r["launches"] = sum(totals[r["kind"]][k] for k in names)
        if not r["launches"]:
            return fail(f"{r['name']} was not launched on path (o)")
    rows += rows8
    mark("(o5) cli")

    # parity of Llama-3-8B and -70B at 2 layers and full width: the same
    # weights (made on the card, copied to the CPU) on the card and the
    # CPU; the card's traces first, then the CPU's all at once, a thread
    # each (the plain ops hold no lock)
    jobs = []
    for big, kinds_, kw in (
            (LLAMA_3_8B, ("q8", "q4", "q4g", "q4-kvi8"),
             dict(b1_steps=1, b4=True, staged=("paged",))),
            (LLAMA_3_70B, ("q4",), dict(b1_steps=2))):
        cfg2 = big.replace(n_layers=2, max_ctx=256)
        made = {}
        for kind in kinds_:
            wkind = kind.split("-")[0]
            if wkind not in made:
                g = torch.Generator("cuda")
                g.manual_seed(99)
                made[wkind] = llama.init_quantized_params(cfg2, POLICIES[wkind], g,
                                                          "cuda")
            tag = f"{cfg2.name} {kind} "
            card_trace = parity_trace(Engine(cfg2, POLICIES[kind], made[wkind],
                                             device="cuda"), tag, **kw)
            jobs.append((cfg2, POLICIES[kind], llama.params_to(made[wkind], "cpu"),
                         tag, kw, card_trace))
        del made
        free()
    def cpu_trace(job):
        t0 = time.perf_counter()
        trace = parity_trace(Engine(job[0], job[1], job[2], device="cpu"),
                             job[3], **job[4])
        print(f"parity {job[3]}CPU trace: {time.perf_counter() - t0:.1f} s "
              f"(one of {len(jobs)} threads)", flush=True)
        return trace

    # the CPU traces (2-3 minutes of the host's cores) run while the card
    # makes the kernel rows of paths (q)-(t): their times are the card's
    # over CUDA graphs (the median of time_ms's replays, so a host thread
    # held up by the traces spoils at most one), and only their plain
    # versions' eager times share the host. Each trace keeps every
    # intra-op thread: with fewer the five took longer on the card's
    # 8-core host (PERF.md §6).
    print(f"parity: {len(jobs)} CPU traces at once, beside the kernel rows "
          "of paths (q)-(t)", flush=True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        traces = [pool.submit(cpu_trace, job) for job in jobs]
        for path in "qrst":
            ready_rows[path] = path_rows(path)
        cpu_traces = [t.result() for t in traces]
    pairs = []
    for job, cpu_trace in zip(jobs, cpu_traces):
        pairs += list(zip(job[5], cpu_trace))
    del jobs
    mark("parity Llama-3 traces")
    worst = 0.0
    for (name, a), (_, b) in pairs:
        if not (torch.isfinite(a).all() and a.shape[-1] == LLAMA_3_8B.n_vocab):
            return fail(f"parity {name}: logits not finite or misshapen")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        worst = max(worst, err / scale)
        print(f"parity {name}: max |gpu - cpu| {err:.5f}, max |cpu| "
              f"{scale:.4f}, mean |diff| {float((a - b).abs().mean()):.6f} "
              f"(limit {PARITY_REL} of max |cpu|)")
        if err > PARITY_REL * scale:
            return fail(f"parity {name}: {err} > {PARITY_REL} * {scale}")
    print(f"parity: Llama-3's worst relative max error {worst:.5f} (limit "
          f"{PARITY_REL}); path (o) and its parity {time.perf_counter() - t_o:.1f} s")
    mark("(o) parity")

    # (p) speculative decoding on TinyLlama q8, (a)'s weights again (the
    # same seed), bf16 activations: the verify rounds as CUDA graphs
    t_p = time.perf_counter()
    cfg, L = TINYLLAMA_1_1B, TINYLLAMA_1_1B.n_layers
    totals["q8-spec"] = {k: 0 for c in counters for k in c}
    gen = torch.Generator("cuda")
    gen.manual_seed(1234)
    params = llama.init_quantized_params(cfg, policy, gen, "cuda")
    engine = Engine(cfg, policy, params, max_ctx=2048, device="cuda")
    spec_rows = phase_spec_rows(engine, torch, ops)
    mark("(p) kernel rows")
    # (p1) b1, k = 4: (a)'s prompt, and a 100-token prompt that repeats a
    # 20-token phrase, 256 tokens each
    phrase = prompt_of(20)[1:]
    repeat = [1] + (phrase * 5)[:PROMPT_LEN - 1]
    for name, prompt_ in (("(a)'s prompt", prompt), ("repeated phrase", repeat)):
        want_ids, _ = generate(prompt_, N_NEW)
        out, stats = spec_line(f"(p1) {name}", engine, prompt_, N_NEW,
                               "q8-spec", a_ms)
        shared = next((i for i, (x, y) in enumerate(zip(out, want_ids))
                       if x != y), len(out))
        spec = engine.round_graphs()
        buf = spec.buffers_for(SPEC_K)
        logits, _ = engine.prefill(spec.cache, [prompt_])
        speculative.start(buf, prompt_, int(logits[0].argmax()), N_NEW - 1)
        gave, n_out = [], 0
        while True:  # one round a replay, (n_out, done) read after each
            spec.run(SPEC_K, -1, 1)
            st = dict(zip(speculative.STATE, buf.state.tolist()))
            if st["n_verify"] > len(gave):
                gave.append(st["n_out"] - n_out)
                n_out = st["n_out"]
            if st["done"]:
                break
        print(f"path (p1) {name}: the prefix shared with generate at bf16 "
              f"{shared} of {N_NEW} tokens; tokens a verify forward gave "
              f"{dict(sorted(collections.Counter(gave).items()))}: "
              f"{gave[:48]}", flush=True)
    # R: ms/token of (a)'s prompt at 1, 2, 4 and 8 rounds a replay
    for R in (1, 2, 4, 8):
        n0, s0, _ = graphs_of(engine)
        spec_run(f"(p1) R={R} first", engine, prompt, N_NEW, "q8-spec",
                 rounds=R)
        n1, s1, _ = graphs_of(engine)
        _, stats = spec_run(f"(p1) R={R}", engine, prompt, N_NEW, "q8-spec",
                            rounds=R)
        print(f"path (p1) R={R}: {stats.ms_per_token:.4f} ms/token, "
              f"{stats.decode_token_times[0]} verify forwards, "
              f"{stats.decode_steps} rounds run, "
              f"{stats.decode_steps // R} host reads; capture "
              f"{s1 - s0:.3f} s ({n1 - n0} graph)", flush=True)
    mark("(p1) b1 k = 4")
    # (p2) the replayed rounds against the same rounds run eagerly, from
    # one saved state, through done
    spec = engine.round_graphs()
    buf = spec.buffers_for(SPEC_K)
    R = 4  # (p1)'s graph of 4 rounds: done within 16 replays
    logits, _ = engine.prefill(spec.cache, [repeat])
    speculative.start(buf, repeat, int(logits[0].argmax()), 40)

    def spec_state():
        return [t.clone() for t in (buf.toks, buf.out, buf.state, spec.cache.k,
                                    spec.cache.v)]

    saved = spec_state()
    eager = []
    for i in range(16 * R):
        speculative.verify_round(engine, spec.cache, spec.rope, buf, SPEC_K, -1)
        if i % R == R - 1:
            eager.append(spec_state())
    for t, v in zip((buf.toks, buf.out, buf.state, spec.cache.k, spec.cache.v),
                    saved):
        t.copy_(v)
    for i, want in enumerate(eager):
        spec.run(SPEC_K, -1, R)
        if not all(torch.equal(a, b) for a, b in zip(spec_state(), want)):
            return fail(f"path (p2): replay {i} of the rounds' graph differs "
                        "from the same rounds run eagerly")
    if not eager[-1][2][speculative.STATE.index("done")]:
        return fail("path (p2): the rounds did not reach done")
    print(f"path (p2): 16 replays of {R} rounds torch.equal to the same "
          f"{16 * R} rounds run eagerly (toks, out, n_ctx, next_tok, n_out, "
          f"n_verify, done, budget, the cache's k and v), done reached",
          flush=True)
    del saved, eager
    mark("(p2) graph against eager")
    # (p3) token identity at f32: the dense --f32 policy runs no kernel,
    # so it checks the loop alone
    g32 = torch.Generator("cuda")
    g32.manual_seed(32)
    p32 = llama.convert_params(llama.init_dense_params(cfg, g32, "cuda"),
                               POLICIES["f32"])

    def same_or_fail(path, eng, prompt_, want_ids, got):
        """got must be want_ids; else print the logit margin of the first
        token that differs (an f32 argmax tie?) and fail."""
        if got == want_ids:
            return None
        i = next(j for j, (x, y) in enumerate(zip(got, want_ids)) if x != y)
        lg, _ = eng.prefill(eng.new_cache(1), [prompt_ + want_ids[:i]])
        top = torch.topk(lg[0], 2)
        return fail(f"path {path}: token {i} is {got[i]}, generate's "
                    f"{want_ids[i]}; the top two logits there {top.values.tolist()} "
                    f"(ids {top.indices.tolist()}), margin "
                    f"{float(top.values[0] - top.values[1])}")

    e32 = Engine(cfg, POLICIES["f32"], p32, max_ctx=2048, device="cuda")
    for prompt_ in (prompt, repeat):
        want_ids, _ = generate(prompt_, 64, e32)
        for k in (1, SPEC_K):
            got, stats = spec_run(f"(p3) f32 k={k}", e32, prompt_, 64, "f32", k)
            if same_or_fail(f"(p3) f32 k={k}", e32, prompt_, want_ids, got):
                return 1
            print(f"path (p3) f32 k={k}: 64 tokens equal to generate's, "
                  f"{stats.decode_token_times[0]} verify forwards", flush=True)
    e256 = Engine(cfg, POLICIES["f32"], p32, max_ctx=256, device="cuda")
    edge = prompt_of(200)
    gcfg = GenerationConfig(n_predict=256, greedy=True, eos_token=-1)
    want_ids, _ = e256.generate(edge, gcfg)
    got, stats = spec_run("(p3) f32 context limit", e256, edge, 56, "f32")
    if same_or_fail("(p3) f32 context limit", e256, edge, want_ids, got):
        return 1
    print(f"path (p3): max_ctx 256, a 200-token prompt, n_predict 256: the "
          f"whole budget (56 tokens) equal to generate's in "
          f"{stats.decode_token_times[0]} verify forwards", flush=True)
    del e32, e256, p32
    free()
    mark("(p3) f32 token identity")
    # (p4) the CLI: --spec 4 with --profile and --debug-nans, in a process
    # of its own (a user's CLI run, with none of this process's profiler
    # windows and graphs behind it); its launch counts come back with it
    prof_dir = Path(files.name) / "profile"
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--profiled-cli", str(prof_dir)],
                           stdout=subprocess.PIPE, text=True, timeout=600)
    if child.returncode:
        return fail(f"path (p4): the CLI's process exited {child.returncode}")
    res = json.loads(child.stdout.splitlines()[-1])
    print(res["printed"], flush=True)
    with contextlib.redirect_stdout(io.StringIO()):
        eng_c, toks, out_plain, _ = run_cli(SPEC_CLI_ARGV, "generate_speculative")
    reset()
    for c in counters:
        for k in c:
            c[k] = res["launches"][k]
    expect("(p4) cli --spec --profile --debug-nans", "q8-spec",
           **spec_counts(eng_c, len(toks), res["decode_steps"]))
    events = trace.parse_device_events(prof_dir)
    want_ev = trace.expected_kernel_events(res["launches"])
    got_ev = trace.kernel_event_counts(events)
    print(f"path (p4): the trace's events of the port's kernels {got_ev}; "
          f"their launches {want_ev}", flush=True)
    if got_ev != want_ev:
        return fail("path (p4): the profiler's kernel events "
                    f"{got_ev} are not the kernels' launches {want_ev}; "
                    f"{profile_check.diagnose(prof_dir)}")
    printed = res["printed"]
    if " speculative : " not in printed or "DEVICE TIME PER TOKEN" not in printed:
        return fail("path (p4): the speculative line or the profile table "
                    "was not printed")
    if out_plain != res["ids"]:
        return fail("path (p4): --debug-nans changed the ids")
    print(f"path (p4): cli.main --spec {SPEC_K} --profile --debug-nans in its "
          f"own process: {len(out_plain)} ids, the same without --debug-nans; "
          f"decode {res['ms_per_token']:.4f} ms/token under the profiler (its "
          "first rounds' capture included)", flush=True)
    del eng_c, engine, params
    free()
    for r in spec_rows:
        names = [counter_name(n, r["kind"]) for n in LAUNCH_NAMES[r["kernel"]]]
        r["launches"] = sum(totals[r["kind"]][k] for k in names)
        if not r["launches"]:
            return fail(f"{r['name']} was not launched on path (p)")
    rows += spec_rows
    print(f"path (p): {time.perf_counter() - t_p:.1f} s", flush=True)
    mark("(p4) cli")

    rows += path_q()
    mark("(q) tensor parallelism")
    rows += path_r()
    mark("(r) sequence parallelism")
    rows += path_s()
    mark("(s) data-parallel rows")
    rows += path_t()
    mark("(t) tiny configurations")
    return finish(rows, kb_rows)


def write_checkpoint(ckpt: str, vocab: str) -> int:
    """The child process of path (h): a full-depth q4 .gten of TinyLlama
    with random N(0, 0.02) weights (one tensor at a time) at `ckpt`, and a
    stand-in tokenizer.bin at `vocab`; prints its seconds."""
    sys.path.insert(0, str(ROOT))
    from tinyllama_tpu_torch.config import TINYLLAMA_1_1B
    from tinyllama_tpu_torch.io import gten, tokenizer

    t0 = time.perf_counter()
    gten.write_gten(ckpt, TINYLLAMA_1_1B, RandomWeights(TINYLLAMA_1_1B, seed=4321),
                    "q4")
    tokenizer.stand_in_vocab(vocab)
    print(f"{time.perf_counter() - t0:.1f}")
    return 0


def profiled_cli(prof_dir: str) -> int:
    """The child process of path (p4): cli.main(SPEC_CLI_ARGV) with
    --profile prof_dir and --debug-nans on the card; prints one JSON line:
    the ids, the rounds run, the kernels' launch counts and what the CLI
    printed (tools/profile_check.py)."""
    sys.path.insert(0, str(ROOT))
    from tinyllama_tpu_torch.tools import profile_check

    print(json.dumps(profile_check.profiled_cli(SPEC_CLI_ARGV + ["--debug-nans"],
                                                prof_dir)))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-checkpoint"]:
        sys.exit(write_checkpoint(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--profiled-cli"]:
        sys.exit(profiled_cli(sys.argv[2]))
    sys.exit(main())
