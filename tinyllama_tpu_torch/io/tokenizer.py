"""SentencePiece-vocab BPE tokenizer (the reference's ``tokenizer.bin``).

The port's own copy of the JAX package's io/tokenizer.py, pure Python:

* the llama2.c vocab file format: ``[u32 max_token_len]`` then per token
  ``[f32 score][i32 len][len bytes]``;
* greedy highest-score pair-merge BPE, ties to the leftmost pair;
* dummy-prefix, byte fallback (``byte + 3``) and UTF-8 codepoint grouping;
* the hardcoded chat template: ``[1, 32001]`` + BPE("user\\n" + prompt) +
  ``[32002, 29871, 13, 32001, 20255, 13]``;
* decode rules: post-BOS leading-space strip and ``<0xXX>`` raw-byte
  pieces; ``safe_piece`` drops unprintable single bytes.

``stand_in_vocab`` writes a vocabulary of this format from code, for runs
without the published tokenizer.bin: the three specials, the 256 byte
pieces (so id 13 is ``<0x0A>`` as in the real file), printable ASCII, all
two-letter merges, and unique filler pieces up to 32,000.
"""

from __future__ import annotations

import string
import struct
from pathlib import Path

BOS_TOKEN = 1
EOS_TOKEN = 32002  # <|im_end|>
IM_START = 32001
#: chat template frame
PRE_PROMPT_TOKENS = (BOS_TOKEN, IM_START)
POST_PROMPT_TOKENS = (32002, 29871, 13, 32001, 20255, 13)

VOCAB_SIZE = 32000


class Tokenizer:
    """BPE tokenizer over a llama2.c-format binary vocab file."""

    eos = EOS_TOKEN

    def __init__(self, path: str | Path, vocab_size: int = VOCAB_SIZE):
        self.vocab_size = vocab_size
        self.vocab: list[bytes] = []
        self.scores: list[float] = []
        data = Path(path).read_bytes()
        (self.max_token_length,) = struct.unpack_from("<I", data, 0)
        off = 4
        for _ in range(vocab_size):
            score, length = struct.unpack_from("<fi", data, off)
            off += 8
            self.vocab.append(data[off: off + length])
            self.scores.append(score)
            off += length
        # exact-match lookup; on duplicate pieces the first id wins
        self.piece_to_id: dict[bytes, int] = {}
        for i, piece in enumerate(self.vocab):
            self.piece_to_id.setdefault(piece, i)
        self._byte_pieces = [bytes([b]) for b in range(256)]

    # ------------------------------------------------------------------ encode

    def encode_raw(self, text: str | bytes) -> list[int]:
        """BPE-encode raw text with the dummy prefix and byte fallback; no
        chat template."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if text:
            tokens.append(self.piece_to_id[b" "])  # the dummy prefix
        # group bytes into UTF-8 codepoints (at most 4 bytes), look each
        # up, fall back to byte tokens (the first 3 ids are the specials)
        i, n = 0, len(text)
        while i < n:
            j = i + 1
            while j < n and (text[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            chunk = text[i:j]
            tid = self.piece_to_id.get(chunk)
            if tid is not None:
                tokens.append(tid)
            else:
                tokens.extend(b + 3 for b in chunk)
            i = j
        # merge the adjacent pair whose concatenation scores highest, the
        # leftmost on ties (strict >), until none is in the vocab
        vocab, scores, lookup = self.vocab, self.scores, self.piece_to_id
        while True:
            best_score, best_id, best_idx = -1e10, -1, -1
            for k in range(len(tokens) - 1):
                tid = lookup.get(vocab[tokens[k]] + vocab[tokens[k + 1]])
                if tid is not None and scores[tid] > best_score:
                    best_score, best_id, best_idx = scores[tid], tid, k
            if best_idx == -1:
                return tokens
            tokens[best_idx: best_idx + 2] = [best_id]

    def encode(self, prompt: str) -> list[int]:
        """A chat turn in the reference's template: <|im_start|>user\\n
        PROMPT<|im_end|>\\n<|im_start|>assistant\\n."""
        body = self.encode_raw("user\n" + prompt)
        return [*PRE_PROMPT_TOKENS, *body, *POST_PROMPT_TOKENS]

    # ------------------------------------------------------------------ decode

    def decode(self, prev_token: int, token: int) -> bytes:
        """Piece bytes for `token` given the previous token."""
        if token >= self.vocab_size or token < 0:
            return b""
        piece = self.vocab[token]
        # following BOS, sentencepiece strips one leading whitespace
        if prev_token == BOS_TOKEN and piece.startswith(b" "):
            piece = piece[1:]
        # raw-byte tokens look like '<0x0A>'
        if len(piece) == 6 and piece.startswith(b"<0x") and piece.endswith(b">"):
            try:
                return self._byte_pieces[int(piece[3:5], 16)]
            except ValueError:
                pass
        return piece

    def decode_sequence(self, tokens: list[int], prev: int = BOS_TOKEN) -> str:
        """A whole token sequence as text (UTF-8, errors replaced)."""
        out = bytearray()
        for t in tokens:
            out += self.decode(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")


def safe_piece(piece: bytes) -> bytes:
    """Drop single-byte unprintable pieces, as the reference's
    safe_printf does."""
    if len(piece) == 1:
        b = piece[0]
        if not (32 <= b < 127 or b in (9, 10, 13, 11, 12)):
            return b""
    return piece


def stand_in_vocab(path: str | Path, size: int = VOCAB_SIZE) -> None:
    """Write a vocabulary of `size` unique pieces in the reference's
    format (see the module docstring); merges score by their order, so
    BPE over it is deterministic."""
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [b"<0x%02X>" % b for b in range(256)]
    pieces += [b" "] + [bytes([c]) for c in range(33, 127)]
    letters = string.ascii_lowercase.encode()
    pieces += [b" " + bytes([a]) for a in letters]
    pieces += [bytes([a, b]) for a in letters for b in letters]
    pieces += [b"<f%05d>" % i for i in range(size - len(pieces))]
    if len(set(pieces)) != size:
        raise ValueError(f"the stand-in vocab needs {len(pieces)} > {size} ids")
    with open(path, "wb") as f:
        f.write(struct.pack("<I", max(len(p) for p in pieces)))
        for i, piece in enumerate(pieces):
            f.write(struct.pack("<fi", -float(i), len(piece)))
            f.write(piece)
