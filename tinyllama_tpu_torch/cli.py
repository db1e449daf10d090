"""Command line: one prompt through the port's engine.

    python -m tinyllama_tpu_torch.cli --random-weights -q8 -p "..." -greedy \\
        --npred 256 [--model tiny-test] [--device cuda|cpu] [--paged]

Flags follow the reference CLI (``-q8 -p PROMPT -greedy --temp --npred
--topk``). Weights are random, made from ``--seed``; the checkpoint
loaders and the tokenizer are not ported yet, so the prompt becomes token
ids (BOS, then each character's code modulo the vocab) and the output
prints as ids. Runs on the card unless ``--device cpu`` is given.
``--paged`` keeps the KV cache in a page pool (decode attention K10).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from tinyllama_tpu_torch.config import (
    GenerationConfig, MODEL_REGISTRY, POLICIES, tiny_test_config,
)
from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.runtime.engine import Engine, resolve_device
from tinyllama_tpu_torch.runtime.perf import perf_report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tinyllama-tpu-torch",
        description="TinyLlama on an NVIDIA GPU (PyTorch + CUDA port).")
    p.add_argument("-q8", action="store_const", dest="dtype", const="q8",
                   help="8-bit quantized weights. [default; the only "
                        "format ported so far]")
    p.set_defaults(dtype="q8")
    p.add_argument("-p", dest="prompt", default="", metavar="PROMPT",
                   help="the prompt")
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
    p.add_argument("--random-weights", action="store_true",
                   help="random weights made from --seed (required for now)")
    p.add_argument("--ckpt", default=None, help="checkpoint (not yet ported)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer.bin (not yet ported)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="run device. [default=cuda]")
    p.add_argument("--seed", type=int, default=0, help="weights and sampling seed")
    p.add_argument("--no-perf", action="store_true",
                   help="suppress the performance table")
    return p


def validate(args) -> None:
    if not (1 <= args.npred <= 2048):
        raise SystemExit("npred must be greater than 1 and less than 2048.")
    if args.temp <= 0.0:
        raise SystemExit("temp value must be greater than zero.")
    if not (1 <= args.topk <= 32003):
        raise SystemExit("topk must be gte 1 and lte 32003.")
    if args.ckpt or args.tokenizer:
        raise SystemExit("--ckpt and --tokenizer are not yet ported "
                         "(ROADMAP.md, Queue 1); use --random-weights")
    if not args.random_weights:
        raise SystemExit("checkpoints are not yet ported; pass --random-weights")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    validate(args)
    device = resolve_device(args.device)

    cfg = (tiny_test_config() if args.model == "tiny-test"
           else MODEL_REGISTRY[args.model])
    if args.max_ctx:
        cfg = cfg.replace(max_ctx=args.max_ctx)
    policy = POLICIES[args.dtype]

    load_t0 = time.perf_counter()
    generator = torch.Generator(device)
    generator.manual_seed(args.seed)
    params = llama.init_quantized_params(cfg, policy, generator, device)
    engine = Engine(cfg, policy, params, max_ctx=args.max_ctx, device=device,
                    paged=args.paged)
    load_s = time.perf_counter() - load_t0

    gen = GenerationConfig(
        n_predict=args.npred, temperature=args.temp, top_k=args.topk,
        greedy=args.greedy, seed=args.seed, chunk_size=args.chunk,
        eos_token=-1,  # no tokenizer, so no EOS id
    )
    tokens = [1] + [ord(c) % cfg.n_vocab for c in args.prompt]

    def stream(t: int) -> None:
        sys.stderr.write(f"{t} ")
        sys.stderr.flush()

    out, stats = engine.generate(tokens, gen, stream=stream)
    stats.load_s = load_s
    sys.stderr.write("\n")
    if args.greedy and not args.no_perf:
        sys.stdout.write(perf_report(stats, engine.params, engine.new_cache(1),
                                     device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
