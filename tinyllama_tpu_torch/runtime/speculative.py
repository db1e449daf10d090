"""Speculative decoding with n-gram (prompt-lookup) drafts, on the device.

The counterpart of the JAX package's runtime/speculative.py. One verify
round feeds [current token, d1 .. dk] through the model at positions
pos .. pos + k (the prefill's kernels at T = k + 1 from pos > 0) and
accepts the longest prefix of the drafts that the greedy targets
confirm, plus the target after it. A forward over k + 1 tokens streams
the weights once, as a single-token step does, so the tokens emitted a
round are the gain. Greedy acceptance is exact: the tokens equal
``Engine.generate``'s (greedy only).

Drafting is pure tensor work on a fixed [s_max + T] history: the latest
j < n_ctx - 2 where (toks[j], toks[j + 1]) is the current bigram, found
by a compare and a max over an arange; its continuation toks[j + 2 ..
j + 2 + k) is gathered (toks[0 .. k) when there is none).

``verify_round`` is one round as PyTorch ops on device tensors, with no
read back to the host: the JAX ``while_loop`` body. The JAX loop stops
at done; a CUDA graph of R rounds (runtime/graphs.py ``RoundGraphs``)
runs its R rounds whatever happens, so a round after done changes no
state: its m is 0 and its writes put back what they overwrite. Its
forward still runs and writes K/V at positions from n_ctx - 1 on, which
hold nothing that is read (the K/V of toks[n_ctx - 1] is written by the
next round's forward in JAX too), and its logits are not read.

Windows stay in bounds by arithmetic, not by clamping (JAX's
``dynamic_slice`` clamps its start; the port's gathers and scatters do
not). With P prompt tokens, budget = max_new - 1 <= s_max - P - 1, and
n_ctx = P + 1 + n_out with n_out <= budget, so n_ctx <= s_max in every
round, done or not:

* the bigram toks[n_ctx - 2], toks[n_ctx - 1]: P >= 1, so n_ctx >= 2;
* the draft toks[start .. start + k): start <= n_ctx - 1, so its last
  index is <= s_max + k - 2 < s_max + T;
* the targets into toks[n_ctx .. n_ctx + T): last index <= s_max + T - 1;
* the targets into out[n_out .. n_out + T): n_out <= s_max - P - 1;
* the forward's cache rows and rope rows n_ctx - 1 .. n_ctx - 1 + k <=
  s_max + 126 < s_max + PAD, the padded cache's length (k < PAD), so K3's
  pos + T <= S holds too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinyllama_tpu_torch.models import llama
from tinyllama_tpu_torch.ops import sampling

#: verify rounds a graph replay runs. Each replay is queued before the
#: state of the one before it is read, so the host's launch (its cost
#: grows with the graph's nodes, so with R) and its read overlap the
#: device's rounds, and at most 2R - 1 rounds run after done. One round
#: a replay measured best on an H100 80GB HBM3 at 700 W (PERF.md, section
#: 6): a TinyLlama round is 2.0-2.3 ms of device time there, its launch
#: and read well under that
ROUNDS = 1
#: rows the speculative cache and rope table have past max_ctx: one
#: 128-row tile, as the JAX engine pads; draft_len must stay below it
PAD = 128
#: the int32 state of the loop, one slot each in SpecBuffers.state
STATE = ("n_ctx", "next_tok", "n_out", "n_verify", "done", "budget")


@dataclass
class SpecBuffers:
    """The static tensors of the verify rounds of one draft length k,
    T = k + 1, over one padded cache."""

    toks: torch.Tensor  # [s_max + T] int32: the prompt, then every token
    out: torch.Tensor  # [s_max + T] int32: the tokens after the first
    state: torch.Tensor  # [len(STATE)] int32, read back in one copy
    idx: torch.Tensor  # [s_max + T - 1] int32: arange, the bigram starts
    steps: torch.Tensor  # [T] int32: arange(T)

    def __getattr__(self, name):
        if name in STATE:  # a [1] view of its slot
            i = STATE.index(name)
            return self.state[i:i + 1]
        raise AttributeError(name)


def new_buffers(s_max: int, k: int, device) -> SpecBuffers:
    T = k + 1
    S = s_max + T

    def i32(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    return SpecBuffers(toks=i32(S), out=i32(S), state=i32(len(STATE)),
                       idx=torch.arange(S - 1, dtype=torch.int32, device=device),
                       steps=torch.arange(T, dtype=torch.int32, device=device))


def start(buf: SpecBuffers, prompt: list[int], next_tok: int,
          budget: int) -> None:
    """Fill the buffers for a generation: toks = prompt + [next_tok] (whose
    K/V is not in the cache yet), n_ctx = len(prompt) + 1, no token out,
    `budget` tokens to emit after next_tok."""
    dev = buf.toks.device
    buf.toks.zero_()
    buf.out.zero_()
    buf.toks[: len(prompt) + 1] = torch.tensor(prompt + [next_tok],
                                               dtype=torch.int32).to(dev)
    buf.state.copy_(torch.tensor([len(prompt) + 1, next_tok, 0, 0, 0, budget],
                                 dtype=torch.int32))


def draft_from_history(buf: SpecBuffers, k: int) -> torch.Tensor:
    """toks[j + 2 .. j + 2 + k) for the latest j < n_ctx - 2 with (toks[j],
    toks[j + 1]) == (toks[n_ctx - 2], toks[n_ctx - 1]); toks[0 .. k) when
    no j matches. [k] int32."""
    toks, n_ctx = buf.toks, buf.n_ctx
    ab = toks.index_select(0, torch.cat([n_ctx - 2, n_ctx - 1]))
    match = ((toks[:-1] == ab[0:1]) & (toks[1:] == ab[1:2])
             & (buf.idx < n_ctx - 2))
    j = torch.where(match, buf.idx, -1).amax()
    first = torch.where(j >= 0, j + 2, 0)
    return toks.gather(0, (first + buf.steps[:k]).long())


def _put(dst: torch.Tensor, at: torch.Tensor, src: torch.Tensor,
         live: torch.Tensor) -> None:
    """dst[at] = src where `live`, else dst[at] as it was."""
    at = at.long()
    dst.scatter_(0, at, torch.where(live, src, dst.gather(0, at)))


def verify_round(engine, cache, rope, buf: SpecBuffers, k: int,
                 eos: int) -> None:
    """One round of the JAX loop body over `buf`, in place: draft, verify
    forward at pos = n_ctx - 1 over the padded `cache` with the padded
    `rope` table, accept, cut at EOS and at the budget, append. No-op on
    the state once done (see the module docstring). With the engine's
    debug_nans, a NaN in this round's logits sets its flag."""
    T = k + 1
    n_ctx, n_out, done, budget = buf.n_ctx, buf.n_out, buf.done, buf.budget
    draft = draft_from_history(buf, k)
    seq = torch.cat([buf.next_tok, draft])
    hidden = llama.forward(engine.cfg, engine.policy, engine.params, seq[None],
                           cache, n_ctx - 1, rope, engine.layer_ids)
    logits = llama.lm_head_logits(engine.params, hidden[0], engine.policy.aq8)
    targets = sampling.greedy(logits)  # [T]
    live = done == 0
    if engine.debug_nans:
        engine.nan_flag.logical_or_(torch.isnan(logits).any() & live)

    # the longest accepted draft prefix, then the target after it
    ok = (draft == targets[:k]).to(torch.int32)
    m = torch.cumprod(ok, 0).sum() + 1
    # the EOS cut: stop before the first EOS among the m
    is_eos = (targets == eos) & (buf.steps < m)
    any_eos = is_eos.any()
    first_eos = torch.where(is_eos, buf.steps, T).amin()
    m = torch.minimum(torch.where(any_eos, first_eos, m).to(torch.int32),
                      budget - n_out)
    finished = any_eos | (n_out + m >= budget)
    m = m * live

    _put(buf.out, n_out + buf.steps, targets, live)
    _put(buf.toks, n_ctx + buf.steps, targets, live)
    n_out.add_(m)
    n_ctx.add_(m)
    buf.next_tok.copy_(buf.toks.index_select(0, (n_ctx - 1).long()))
    buf.n_verify.add_(live.to(torch.int32))
    done.copy_((live.logical_not() | finished).to(torch.int32))
