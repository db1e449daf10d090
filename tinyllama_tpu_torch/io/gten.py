"""`.gten` checkpoint format reader and writer.

The reference's file format, byte for byte (the port's own copy of the
JAX package's io/gten.py):

* ``int64`` magic ``0x454c49464e455447`` (ASCII "GTENFILE"),
* per weight, a *layer header* ``[i32 name_len][name]`` followed by a
  *weight record* ``[i32 name_len][name][i32 payload_bytes][payload]``,
* strict fixed order: embed -> per block {q,k,v,o,gate,up,down,attn_norm,
  ffn_norm} -> final norm -> lm_head; norm weights are always fp16,
* payloads: fp16 = flat little-endian f16; q8 = per 32-block structs
  ``[f16 delta][32 x i8]``; q4 = ``[f16 delta][16 bytes]`` with gten's
  half-block nibble packing.

``read_gten_records`` parses the structure; ``decode_record`` ships a
payload's raw bytes to the target device and splits the block structs
there, with torch ops, into the port's "nk" planes (quant/codec.py): q8
int8 data, q4 uint8 data (the gten bytes as they are: gten's packing is
the port's nibble order) and fp16 deltas. Writing quantizes in numpy.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from tinyllama_tpu_torch.config import ModelConfig
from tinyllama_tpu_torch.quant import codec

GTEN_MAGIC = 0x454C49464E455447  # "GTENFILE" little-endian
FILE_DTYPES = ("fp16", "q8", "q4")

Q8_BLOCK = np.dtype([("delta", "<f2"), ("q", "i1", (codec.BLOCK_SIZE,))])
Q4_BLOCK = np.dtype([("delta", "<f2"), ("q", "u1", (codec.BLOCK_SIZE // 2,))])

#: weight order within one transformer block as (HF/file name suffix,
#: runtime name, is_norm)
BLOCK_WEIGHTS = [
    ("self_attn.q_proj.weight", "wq", False),
    ("self_attn.k_proj.weight", "wk", False),
    ("self_attn.v_proj.weight", "wv", False),
    ("self_attn.o_proj.weight", "wo", False),
    ("mlp.gate_proj.weight", "w_gate", False),
    ("mlp.up_proj.weight", "w_up", False),
    ("mlp.down_proj.weight", "w_down", False),
    ("input_layernorm.weight", "attn_norm", True),
    ("post_attention_layernorm.weight", "ffn_norm", True),
]


def weight_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Logical [d_out, d_in] / [d] shape of every record's weight."""
    return {
        "embed": (cfg.n_vocab, cfg.n_embd),
        "norm": (cfg.n_embd,),
        "lm_head": (cfg.n_vocab, cfg.n_embd),
        "wq": (cfg.n_embd, cfg.n_embd),
        "wk": (cfg.kv_dim, cfg.n_embd),
        "wv": (cfg.kv_dim, cfg.n_embd),
        "wo": (cfg.n_embd, cfg.n_embd),
        "w_gate": (cfg.n_ffn, cfg.n_embd),
        "w_up": (cfg.n_ffn, cfg.n_embd),
        "w_down": (cfg.n_embd, cfg.n_ffn),
        "attn_norm": (cfg.n_embd,),
        "ffn_norm": (cfg.n_embd,),
    }


# -----------------------------------------------------------------------------
# Writing
# -----------------------------------------------------------------------------


def _encode_payload(w: np.ndarray, dtype: str) -> bytes:
    if dtype == "fp16":
        return np.ascontiguousarray(w.astype(np.float16)).tobytes()
    w2 = w.reshape(w.shape[0], -1) if w.ndim == 2 else w.reshape(1, -1)
    if dtype == "q8":
        q, deltas = codec.np_quantize_q8(w2)
        rec = np.empty(deltas.size, Q8_BLOCK)
        rec["delta"] = deltas.reshape(-1)
        rec["q"] = q.reshape(-1, codec.BLOCK_SIZE)
        return rec.tobytes()
    if dtype == "q4":
        vals, deltas = codec.np_quantize_q4(w2)
        rec = np.empty(deltas.size, Q4_BLOCK)
        rec["delta"] = deltas.reshape(-1)
        rec["q"] = codec.gten_q4_pack(vals).reshape(-1, codec.BLOCK_SIZE // 2)
        return rec.tobytes()
    raise ValueError(f"unknown gten dtype {dtype!r}")


def _write_record(f, name: str, w: np.ndarray, dtype: str) -> None:
    nb = name.encode()
    # the layer header, then the weight record: the name twice
    f.write(struct.pack("<i", len(nb)))
    f.write(nb)
    f.write(struct.pack("<i", len(nb)))
    f.write(nb)
    payload = _encode_payload(np.asarray(w, np.float32), dtype)
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)


def write_gten(path: str | Path, cfg: ModelConfig,
               hf_weights: Mapping[str, np.ndarray], dtype: str) -> None:
    """Write HF-named weights ([d_out, d_in] numpy arrays) as a .gten
    checkpoint. Each weight is looked up once, in file order, so a
    mapping that makes its tensors on demand keeps one in memory."""
    if dtype not in FILE_DTYPES:
        raise ValueError(f"unknown gten dtype {dtype!r}")
    with open(path, "wb") as f:
        f.write(struct.pack("<q", GTEN_MAGIC))
        _write_record(f, "model.embed_tokens.weight",
                      hf_weights["model.embed_tokens.weight"], dtype)
        for i in range(cfg.n_layers):
            for suffix, _, is_norm in BLOCK_WEIGHTS:
                name = f"model.layers.{i}.{suffix}"
                _write_record(f, name, hf_weights[name],
                              "fp16" if is_norm else dtype)
        _write_record(f, "model.norm.weight", hf_weights["model.norm.weight"],
                      "fp16")
        _write_record(f, "lm_head.weight", hf_weights["lm_head.weight"], dtype)


# -----------------------------------------------------------------------------
# Reading
# -----------------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.data = data
        self.off = 0

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.off)
        self.off += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from("<q", self.data, self.off)
        self.off += 8
        return v

    def name(self) -> str:
        n = self.i32()
        if n < 0 or self.off + n > len(self.data):
            raise ValueError(f"bad name length {n} at byte {self.off}")
        s = bytes(self.data[self.off: self.off + n]).decode()
        self.off += n
        return s

    def payload(self) -> tuple[int, int]:
        """(offset, length) of the next payload."""
        n = self.i32()
        if n < 0 or self.off + n > len(self.data):
            raise ValueError(f"bad payload length {n} at byte {self.off}")
        start = self.off
        self.off += n
        return start, n


def sniff_dtype(path: str | Path, cfg: ModelConfig) -> str:
    """Infer the file dtype from the embed record's payload size."""
    with open(path, "rb") as f:
        head = f.read(8 + 4 + 256)
    r = _Reader(head)
    magic = r.i64()
    if magic != GTEN_MAGIC:
        raise ValueError(f"bad magic: {magic:#x} (expected {GTEN_MAGIC:#x})")
    name = r.name()
    r.name()  # the weight record repeats it
    with open(path, "rb") as f:
        f.seek(r.off)
        (payload_bytes,) = struct.unpack("<i", f.read(4))
    numel = cfg.n_vocab * cfg.n_embd
    per_block = {"fp16": codec.BLOCK_SIZE * 2, "q8": 2 + codec.BLOCK_SIZE,
                 "q4": 2 + codec.BLOCK_SIZE // 2}
    for dt, blk in per_block.items():
        if payload_bytes == numel // codec.BLOCK_SIZE * blk:
            return dt
    raise ValueError(f"cannot infer dtype from payload size {payload_bytes} "
                     f"of {name}")


def read_gten_records(path: str | Path, cfg: ModelConfig):
    """Parse a .gten file's structure without decoding its payloads.

    -> (file_dtype, buffer, {runtime_name or runtime_name.i: (offset,
    length, logical shape, payload dtype)}), the buffer a writable
    bytearray of the whole file (so torch can view it without a copy).
    Raises ValueError on a bad magic, a record out of order, or bytes
    after the last record."""
    path = Path(path)
    file_dtype = sniff_dtype(path, cfg)
    data = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(data) != len(data):
            raise ValueError(f"short read of {path}")
    r = _Reader(data)
    r.i64()  # the magic, checked by sniff_dtype
    shapes = weight_shapes(cfg)
    out: dict[str, tuple] = {}

    def read_one(runtime_name: str, is_norm: bool, key: str | None = None):
        r.name()  # layer header
        wname = r.name()
        off, n = r.payload()
        out[key or runtime_name] = (off, n, shapes[runtime_name],
                                    "fp16" if is_norm else file_dtype)
        return wname

    read_one("embed", False)
    for i in range(cfg.n_layers):
        for suffix, rname, is_norm in BLOCK_WEIGHTS:
            got = read_one(rname, is_norm, key=f"{rname}.{i}")
            expect = f"model.layers.{i}.{suffix}"
            if got != expect:
                raise ValueError(f"weight order mismatch: {got} != {expect}")
    read_one("norm", True)
    read_one("lm_head", False)
    if r.off != len(data):
        raise ValueError(f"{len(data) - r.off} bytes after the last record")
    return file_dtype, data, out


def decode_record(data, rec, device="cpu"):
    """One record of ``read_gten_records`` decoded on `device`: its raw
    bytes are copied there (aligned, whatever the record's offset), then
    split with torch ops into a float16 tensor (fp16 records) or the
    port's "nk" planes (data, fp16 deltas [d_out, d_in/32]): q8 int8
    [d_out, d_in], q4 uint8 [d_out, d_in/2], gten's bytes as they are."""
    off, n, shape, dtype = rec
    d_out, d_in = shape if len(shape) == 2 else (1, shape[0])
    per_block = {"fp16": 2 * codec.BLOCK_SIZE, "q8": Q8_BLOCK.itemsize,
                 "q4": Q4_BLOCK.itemsize}[dtype]
    if n != d_out * d_in // codec.BLOCK_SIZE * per_block:
        raise ValueError(f"{dtype} payload of {n} bytes for shape {shape}")
    u8 = torch.frombuffer(data, dtype=torch.uint8, count=n,
                          offset=off).to(device, copy=True)
    if dtype == "fp16":
        return u8.view(torch.float16).reshape(shape)
    blocks = u8.reshape(d_out * d_in // codec.BLOCK_SIZE, per_block)
    deltas = blocks[:, :2].contiguous().view(torch.float16).reshape(d_out, -1)
    q = blocks[:, 2:].contiguous()
    return (q.view(torch.int8) if dtype == "q8" else q).reshape(d_out, -1), deltas


def read_gten(path: str | Path, cfg: ModelConfig, device="cpu"):
    """Parse and decode a .gten file -> (file_dtype, {runtime_name or
    runtime_name.i: float16 tensor or (data, deltas) "nk" planes}) on
    `device`."""
    file_dtype, data, recs = read_gten_records(path, cfg)
    return file_dtype, {k: decode_record(data, rec, device)
                        for k, rec in recs.items()}
