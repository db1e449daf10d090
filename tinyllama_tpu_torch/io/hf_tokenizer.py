"""HF ``tokenizer.json`` byte-level BPE (the Llama-3 family), and the
dispatch of a tokenizer file by type.

The port's own copy of the JAX package's io/hf_tokenizer.py: GPT-2's
byte-to-unicode mapping, regex pre-tokenization, rank-ordered pair
merging and the Llama-3 chat template, with no ``tokenizers`` package.
The split pattern needs the ``regex`` package for its ``\\p{..}``
classes; without it a whitespace split keeps text decodable.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

from tinyllama_tpu_torch.io.tokenizer import Tokenizer

try:  # `regex` supports \p{..} classes (needed by the Llama-3 split)
    import regex as _re
except ImportError:  # pragma: no cover - depends on the installation
    _re = None

#: Llama-3's pre-tokenization split pattern (tiktoken cl100k-style).
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in _bytes_to_unicode().items()}


class HFTokenizer:
    """Byte-level BPE over an HF ``tokenizer.json`` vocabulary."""

    def __init__(self, path: str | Path, chat_template: str | None = "llama3"):
        spec = json.loads(Path(path).read_text())
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"not a BPE tokenizer: {model.get('type')}")
        self.vocab: dict[str, int] = dict(model["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(model.get("merges", [])):
            pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            self.ranks[pair] = rank
        self.special: dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            self.special[tok["content"]] = tok["id"]
            self.id_to_token[tok["id"]] = tok["content"]
        self.chat_template = chat_template
        self.bos = self.special.get("<|begin_of_text|>")
        self.eot = self.special.get("<|eot_id|>")
        self.eos = (self.eot if self.eot is not None
                    else self.special.get("<|end_of_text|>", -1))
        if _re is not None:
            self._split = _re.compile(LLAMA3_SPLIT)
        else:  # a whitespace split keeps text decodable
            import re

            self._split = re.compile(r"\S+|\s+")

    # ------------------------------------------------------------- encode

    def _bpe(self, piece: str) -> list[int]:
        """Merge the byte-mapped piece bottom-up by merge rank."""
        word = list(piece)
        if not word:
            return []
        while len(word) > 1:
            best_rank, best_i = None, -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            word[best_i: best_i + 2] = [word[best_i] + word[best_i + 1]]
        out = []
        for w in word:
            if w in self.vocab:
                out.append(self.vocab[w])
            else:  # an unknown fragment: its characters' byte tokens
                out.extend(self.vocab[c] for c in w if c in self.vocab)
        return out

    def encode_raw(self, text: str) -> list[int]:
        """Plain text, no template, no specials."""
        b2u = _bytes_to_unicode()
        ids: list[int] = []
        for piece in self._split.findall(text):
            ids.extend(self._bpe("".join(b2u[b] for b in piece.encode("utf-8"))))
        return ids

    def encode(self, prompt: str) -> list[int]:
        """A chat turn in the Llama-3 instruct header form (plain BOS +
        text without the template or a BOS token)."""
        if self.chat_template != "llama3" or self.bos is None:
            return ([self.bos] if self.bos is not None else []) \
                + self.encode_raw(prompt)
        sh = self.special.get("<|start_header_id|>")
        eh = self.special.get("<|end_header_id|>")
        ids = [self.bos, sh, *self.encode_raw("user"), eh]
        ids += self.encode_raw("\n\n" + prompt)
        ids += [self.eot, sh, *self.encode_raw("assistant"), eh]
        ids += self.encode_raw("\n\n")
        return ids

    # ------------------------------------------------------------- decode

    def decode_ids(self, ids: list[int]) -> str:
        u2b = _unicode_to_bytes()
        out = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if int(i) in self.special.values():
                out += tok.encode("utf-8")
            else:
                out += bytes(u2b[c] for c in tok if c in u2b)
        return out.decode("utf-8", errors="replace")

    def decode(self, prev_token: int, token: int) -> bytes:
        """One token's bytes, streamed (prev is unused in byte-level BPE;
        kept for the interface of io/tokenizer.py)."""
        tok = self.id_to_token.get(int(token))
        if tok is None:
            return b""
        if int(token) in self.special.values():
            return tok.encode("utf-8")
        u2b = _unicode_to_bytes()
        return bytes(u2b[c] for c in tok if c in u2b)

    def decode_sequence(self, tokens: list[int], prev: int | None = None) -> str:
        return self.decode_ids(tokens)


def load_tokenizer(path: str | Path, chat_template: str | None = None):
    """tokenizer.json -> HFTokenizer; any other file -> the reference's
    tokenizer.bin reader."""
    p = Path(path)
    if p.suffix == ".json":
        return HFTokenizer(p, chat_template or "llama3")
    return Tokenizer(p)
