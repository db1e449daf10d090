"""Command line: chat with TinyLlama through the port's engine.

    python -m tinyllama_tpu_torch.cli -q4 --ckpt tinyllama.q4.gten \\
        --tokenizer tokenizer.bin [-p "..."] [-greedy] [--npred 768]
    python -m tinyllama_tpu_torch.cli --random-weights -q8 -p "..." \\
        [--model tiny-test] [--device cuda|cpu] [--paged]

Flags follow the reference CLI (``-f16 -q8 -q4 -p PROMPT -greedy --temp
--npred --topk``), plus ``-q4g`` (the group-128 4-bit format, requantized
from the checkpoint at load) and the JAX CLI's ``--bf16`` and ``--f32``
dense weights. ``-f16`` is the default, as in the reference and the JAX
CLI: random weights and a HuggingFace checkpoint load as f16 unless
another flag is given; a .gten file with no flag loads as its own dtype
(f16 for the fp16 file). Dense weights run no kernel (the JAX package's
choice: its dense path runs without Pallas), so ``-f16``, ``--bf16``
and ``--f32`` run the plain PyTorch ops on the card. ``--ckpt`` takes a .gten file or a
HuggingFace checkpoint (a .safetensors / .bin file or a directory);
``--tokenizer`` a tokenizer.bin or tokenizer.json (default: tokenizer.bin
in the working directory, when there is one). Without ``-p`` the CLI is a
chat REPL. Generated text streams to stderr; a greedy run prints the
performance table to stdout.

``--random-weights`` makes the weights from a fixed seed (0) instead of
loading them; without a tokenizer the prompt then becomes token ids
(BOS, then each character's code modulo the vocab) and the output prints
as ids. ``--seed`` seeds top-k sampling only; without it the seed is
time-based, as in the reference. Runs on the card unless ``--device
cpu`` is given. ``--paged`` keeps the KV cache in a page pool (decode
attention K10). ``--kv`` sets the KV cache's dtype (default the
policy's, bf16): ``--kv i8`` stores int8 with one f32 scale a (head,
position), about half the bytes; ``f16`` and ``f32`` store the values
in that type. The performance table's load time covers reading (or
making) the weights, not building the engine.

``--spec K`` decodes with K-token n-gram drafts verified K + 1 at a time
(``Engine.generate_speculative``: greedy and monolithic only, the same
tokens as plain greedy), and prints the JAX CLI's speculative line after
the performance table. ``--profile DIR`` writes a torch.profiler trace of
the generation under DIR and prints the device time a token in the
reference's linear / attention / other buckets (runtime/trace.py).
``--debug-nans`` raises FloatingPointError at the first NaN in the
logits, as the JAX CLI's ``jax_debug_nans``.

``--tp N`` runs the model tensor-parallel over N rank processes that the
CLI starts itself (parallel/mesh.py ``run_ranks``; on the card the
kernels are built first, so the ranks only load them): each rank builds
``Engine(tp=N)`` over its shard, rank 0 prints and reads the chat REPL's
prompts and hands each to the others, the time-based seed is drawn on
rank 0 and handed on. Ranks on one card talk through gloo, ranks on cards
of their own through NCCL. ``--tp-overlap`` sums the row-parallel
products with JAX's ring. ``--tp-mode gspmd`` (JAX's NamedSharding path,
which runs no kernel) is not ported. ``--spec`` and ``--profile`` run at
``--tp 1``.

``--sp N`` prefills each prompt sequence-parallel over N ranks (ring
attention, parallel/sp.py; JAX's ``--sp``): the CLI starts tp x N rank
processes as for ``--tp``, every rank decodes the same tokens after the
handoff, and rank 0 alone prints. ``--spec`` combines with it, as in
JAX; ``--tp-overlap`` and ``--profile`` do not.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from pathlib import Path

import torch

from tinyllama_tpu_torch.config import (
    GenerationConfig, MODEL_REGISTRY, POLICIES, tiny_test_config,
)
from tinyllama_tpu_torch.io.checkpoint import load_gten_checkpoint, load_hf_checkpoint
from tinyllama_tpu_torch.io.hf_tokenizer import load_tokenizer
from tinyllama_tpu_torch.io.tokenizer import safe_piece
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops.kernels import build
from tinyllama_tpu_torch.parallel.mesh import rank_device, run_ranks
from tinyllama_tpu_torch.runtime import trace
from tinyllama_tpu_torch.runtime.engine import Engine, resolve_device
from tinyllama_tpu_torch.runtime.perf import perf_report

#: the seed of --random-weights, whatever --seed is (sampling's seed)
WEIGHTS_SEED = 0
#: the weights' policy when no flag names one (a .gten file: its own)
DEFAULT_DTYPE = "f16"
#: suffixes of a HuggingFace checkpoint file (a directory is one too)
HF_SUFFIXES = (".safetensors", ".bin", ".pt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tinyllama-tpu-torch",
        description="TinyLlama on an NVIDIA GPU (PyTorch + CUDA port).")
    g = p.add_mutually_exclusive_group()
    g.add_argument("-f16", action="store_const", dest="dtype", const="f16",
                   help="float-16 weights (2.2GB). [default; a .gten file "
                        "without a flag loads as its own dtype]")
    g.add_argument("-q8", action="store_const", dest="dtype", const="q8",
                   help="8-bit quantized weights (1.1GB).")
    g.add_argument("-q4", action="store_const", dest="dtype", const="q4",
                   help="4-bit quantized weights (0.62GB).")
    g.add_argument("-q4g", action="store_const", dest="dtype", const="q4g",
                   help="4-bit weights with one scale per 128 (0.57GB; "
                        "requantized from the checkpoint at load).")
    g.add_argument("--bf16", action="store_const", dest="dtype", const="bf16",
                   help="bfloat16 weights (dense).")
    g.add_argument("--f32", action="store_const", dest="dtype", const="f32",
                   help="float32 weights and activations (parity/debug).")
    p.add_argument("-p", dest="prompt", default="", metavar="PROMPT",
                   help="single prompt (otherwise: chat REPL)")
    p.add_argument("-greedy", action="store_true", help="greedy sampling")
    p.add_argument("--temp", type=float, default=0.9,
                   help="sampling temperature (> 0). [default=0.9]")
    p.add_argument("--npred", type=int, default=768, metavar="N",
                   help="number of tokens to generate, 1..2048. [default=768]")
    p.add_argument("--topk", type=int, default=50, metavar="K",
                   help="top-k for sampling. [default=50]")
    p.add_argument("--model", default="tinyllama-1.1b-chat-v0.4",
                   help="architecture preset or 'tiny-test'")
    p.add_argument("--max-ctx", type=int, default=None,
                   help="context window override")
    p.add_argument("--chunk", type=int, default=32,
                   help="decode steps between host read-backs")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache (page pool + page table)")
    p.add_argument("--kv", default=None, choices=("f32", "bf16", "f16", "i8"),
                   help="KV-cache dtype: i8 is int8 with per-(head, position) "
                        "scales. [default: the policy's]")
    p.add_argument("--ckpt", default=None,
                   help=".gten checkpoint, or a HuggingFace checkpoint file "
                        "or directory")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer.bin or tokenizer.json "
                        "(default: ./tokenizer.bin)")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights from a fixed seed (no checkpoint)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="run device. [default=cuda]")
    p.add_argument("--seed", type=int, default=None,
                   help="sampling seed (default: time-based)")
    p.add_argument("--no-perf", action="store_true",
                   help="suppress the performance table")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decoding with K-token n-gram drafts "
                        "(greedy only; output identical to plain greedy)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of generation to DIR "
                        "and print its device time by bucket")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast (FloatingPointError) on a NaN in the "
                        "logits")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="tensor-parallel degree: N rank processes, each on "
                        "its shard of the weights and KV cache")
    p.add_argument("--tp-overlap", action="store_true",
                   help="sum the row-parallel products with a ring of "
                        "partial sums (reduce-scatter, then all-gather) "
                        "instead of an all-reduce")
    p.add_argument("--sp", type=int, default=1, metavar="N",
                   help="sequence-parallel prefill ways: shard each prompt's "
                        "T over N rank processes with ring attention; every "
                        "rank then decodes")
    p.add_argument("--tp-mode", default="shard_map",
                   choices=("shard_map", "gspmd"),
                   help="the JAX CLI's TP paths: shard_map (the ranks run "
                        "the kernels on their shards) is the one ported")
    return p


def validate(args) -> None:
    if not (1 <= args.npred <= 2048):
        raise SystemExit("npred must be greater than 1 and less than 2048.")
    if args.temp <= 0.0:
        raise SystemExit("temp value must be greater than zero.")
    if not (1 <= args.topk <= 32003):
        raise SystemExit("topk must be gte 1 and lte 32003.")
    if args.random_weights and args.ckpt:
        raise SystemExit("pass either --ckpt or --random-weights, not both")
    if not (args.random_weights or args.ckpt):
        raise SystemExit("pass --ckpt (a .gten or HuggingFace checkpoint) or "
                         "--random-weights")
    if args.ckpt and not Path(args.ckpt).exists():
        raise SystemExit(f"no checkpoint at {args.ckpt}")
    if args.spec and not args.greedy:
        raise SystemExit("--spec requires -greedy (exact greedy acceptance).")
    if args.spec and args.paged:
        raise SystemExit("--spec uses the monolithic cache (drop --paged).")
    if args.tp < 1:
        raise SystemExit("tp must be >= 1.")
    if args.tp > 1 and args.tp_mode == "gspmd":
        raise SystemExit("--tp-mode gspmd (the JAX package's NamedSharding "
                         "path, which runs no kernel) is not ported; the "
                         "default shard_map path is.")
    if args.tp > 1 and (args.spec or args.profile):
        raise SystemExit("--spec and --profile run at --tp 1.")
    if args.sp < 1:
        raise SystemExit("sp must be >= 1.")
    if args.sp > 1 and args.profile:
        raise SystemExit("--profile runs at --sp 1.")
    if args.sp > 1 and args.tp > 1 and args.tp_overlap:
        raise SystemExit("--tp-overlap does not combine with --sp (the "
                         "sequence-parallel prefill sums with an "
                         "all-reduce).")


def load_params(args, cfg, device, store=None):
    """(params, policy) from the flags: random, an HF checkpoint, or a
    .gten file (whose own dtype serves when no dtype flag is given), on
    `store` (default `device`). Random weights are drawn on `device`, so
    they are the same wherever they are kept."""
    store = device if store is None else store
    if args.random_weights:
        policy = POLICIES[args.dtype or DEFAULT_DTYPE]
        generator = torch.Generator(device)
        generator.manual_seed(WEIGHTS_SEED)
        if policy.is_quantized:
            return (llama.init_quantized_params(cfg, policy, generator, device,
                                                store), policy)
        # as the JAX CLI: f32 weights, then cast per the policy
        dense = llama.init_dense_params(cfg, generator, device, store)
        return llama.convert_params(dense, policy), policy
    ckpt = Path(args.ckpt)
    if ckpt.is_dir() or ckpt.suffix in HF_SUFFIXES:
        policy = POLICIES[args.dtype or DEFAULT_DTYPE]
        return load_hf_checkpoint(ckpt, cfg, policy, store), policy
    return load_gten_checkpoint(ckpt, cfg, args.dtype and POLICIES[args.dtype],
                                store)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    validate(args)
    if args.tp == 1 and args.sp == 1:
        return run(args, resolve_device(args.device))
    if rank_device(0, args.device).type == "cuda":
        build.build_all()  # the ranks only load the libraries
    run_ranks(rank_main, args.tp, args, dp=args.sp, device=args.device,
              stdin=not args.prompt)
    return 0


def rank_main(mesh, args) -> int:
    """The CLI on one rank of ``--tp N`` / ``--sp M``: rank 0 prints, the
    others print nothing."""
    if mesh.rank == 0:
        return run(args, mesh.device, mesh)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
            contextlib.redirect_stderr(null):
        return run(args, mesh.device, mesh)


def run(args, device, mesh=None) -> int:
    """Load the weights, build the engine and generate (a prompt, or the
    chat REPL), on `device`; with `mesh`, as one rank of it."""
    lead = mesh is None or mesh.rank == 0
    cfg = (tiny_test_config() if args.model == "tiny-test"
           else MODEL_REGISTRY[args.model])
    if args.max_ctx:
        cfg = cfg.replace(max_ctx=args.max_ctx)

    load_t0 = time.perf_counter()
    # a rank keeps the full weights in host memory: its engine moves only
    # its shard to the card (parallel/tp.py shard_params)
    params, policy = load_params(args, cfg, device,
                                 "cpu" if mesh is not None else device)
    if device.type == "cuda":  # weights made on the card are made async
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - load_t0
    if args.kv:
        policy = dataclasses.replace(policy, kv_dtype=args.kv)
    engine = Engine(cfg, policy, params, max_ctx=args.max_ctx, device=device,
                    paged=args.paged, debug_nans=args.debug_nans,
                    tp_overlap=args.tp_overlap, mesh=mesh, sp=args.sp)
    del params  # a rank keeps its shard only

    tok_path = args.tokenizer or ("tokenizer.bin" if Path("tokenizer.bin").exists()
                                  else None)
    if tok_path is None and not args.random_weights:
        raise SystemExit("no tokenizer: pass --tokenizer")
    tokenizer = load_tokenizer(tok_path) if tok_path else None

    seed = args.seed if args.seed is not None else time.time_ns() % 2**31
    if mesh is not None:  # every rank samples with rank 0's seed
        seed = mesh.broadcast_object(seed)
    gen = GenerationConfig(
        n_predict=args.npred, temperature=args.temp, top_k=args.topk,
        greedy=args.greedy, chunk_size=args.chunk, seed=seed,
        eos_token=tokenizer.eos if tokenizer else -1,
    )

    def run_once(prompt: str) -> None:
        if tokenizer:
            tokens = tokenizer.encode(prompt)
            # the first piece decodes after BOS, which strips its
            # leading sentencepiece space
            prev = [1]

            def stream(t: int) -> None:
                piece = safe_piece(tokenizer.decode(prev[0], t))
                prev[0] = t
                sys.stderr.buffer.write(piece)
                sys.stderr.flush()
        else:
            tokens = [1] + [ord(c) % cfg.n_vocab for c in prompt]

            def stream(t: int) -> None:
                sys.stderr.write(f"{t} ")
                sys.stderr.flush()

        with (trace.profiled(args.profile, device) if args.profile
              else contextlib.nullcontext()):
            if args.spec:
                # the rounds run on the device until done: the tokens
                # stream once they are back
                out, stats = engine.generate_speculative(tokens, gen,
                                                         draft_len=args.spec)
                for t in out:
                    stream(t)
            else:
                out, stats = engine.generate(tokens, gen, stream=stream)
        stats.load_s = load_s
        sys.stderr.write("\n")
        if args.greedy and not args.no_perf:
            sys.stdout.write(perf_report(stats, engine.params,
                                         engine.new_cache(1), device))
            if args.spec and stats.decode_token_times:
                nv = stats.decode_token_times[0]
                sys.stdout.write(
                    f" speculative : {stats.generated_tokens} tokens / "
                    f"{nv} verify forwards = "
                    f"{stats.generated_tokens / max(1, nv):.2f} tok per "
                    f"weight-stream (draft K={args.spec})\n")
        if args.profile:
            # the print_perf buckets from the trace's device events
            try:
                events = trace.parse_device_events(args.profile)
            except FileNotFoundError:
                sys.stderr.write(
                    f"[profile] no trace files found under {args.profile}\n")
            else:
                sys.stdout.write(trace.format_bucket_table(trace.bucket_report(
                    events, steps=max(1, stats.generated_tokens))))

    if args.prompt:
        run_once(args.prompt)
        return 0
    print("Chat interface. Write your prompt and press enter to submit. "
          "Enter q or press ctrl+c to quit.")
    while True:
        prompt = None
        if lead:  # rank 0 reads; None ends the chat on every rank
            try:
                sys.stderr.write("\n\n[You]: ")
                sys.stderr.flush()
                prompt = input()
            except (EOFError, KeyboardInterrupt):
                prompt = None
            if prompt == "q":
                prompt = None
        if mesh is not None:
            prompt = mesh.broadcast_object(prompt)
        if prompt is None:
            break
        sys.stderr.write("\n[Tinyllama-Chat]: \n\n")
        run_once(prompt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
