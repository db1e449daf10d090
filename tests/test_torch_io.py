"""The port's checkpoint I/O, tokenizers and CLI against the JAX package.

Every file is made here from a seed: dense tiny_test_config weights from
JAX's init_dense_params, written as .gten by both packages (the bytes must
be equal), as .safetensors (one file, and shards under an index, written
with the safetensors package) and as a torch .bin; a llama2.c-format
vocab from the port's ``stand_in_vocab``; a byte-level BPE tokenizer.json
trained with the tokenizers library. Loaded parameters must dequantize
to the JAX loader's values bit for bit; the tokenizers must give the JAX
ones' ids and bytes. Nothing reads a real checkpoint or tokenizer.
"""

import json
import struct

import jax
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.io import checkpoint as jckpt
from tinyllama_tpu.io import gten as jgten
from tinyllama_tpu.io import hf_tokenizer as jhf
from tinyllama_tpu.io import tokenizer as jtok
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.quant import codec as jcodec
from tinyllama_tpu_torch import cli
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.io import checkpoint, gten, hf_tokenizer, tokenizer
from tinyllama_tpu_torch.quant import codec

JCFG = jax_tiny()
CFG = pconfig.tiny_test_config()
LINEARS = ("wqkv", "wo", "w_gateup", "w_down")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def dense():
    """Dense f32 weights (numpy), fused and stacked as the models hold
    them."""
    d = jllama.init_dense_params(JCFG, jax.random.PRNGKey(3))
    return {"embed": np.asarray(d["embed"]), "norm": np.asarray(d["norm"]) + 0.5,
            "lm_head": np.asarray(d["lm_head"]),
            "layers": {n: np.asarray(w) for n, w in d["layers"].items()}}


@pytest.fixture(scope="module")
def files(dense, tmp_path_factory):
    """The same weights written as .gten by the JAX writer, per dtype."""
    out = tmp_path_factory.mktemp("gten")
    paths = {}
    for dtype in gten.FILE_DTYPES:
        paths[dtype] = out / f"m.{dtype}.gten"
        jckpt.save_gten_checkpoint(paths[dtype], JCFG, dense, dtype)
    return paths


# --- gten -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp16", "q8", "q4"])
def test_gten_bytes_equal_jax(dense, files, tmp_path, dtype):
    """The port's writer puts out the JAX writer's bytes; both readers
    decode them to the same values."""
    p = tmp_path / "port.gten"
    checkpoint.save_gten_checkpoint(p, CFG, dense, dtype)
    assert p.read_bytes() == files[dtype].read_bytes()
    assert gten.sniff_dtype(p, CFG) == dtype
    fdt, got = gten.read_gten(p, CFG)
    jdt, want = jgten.read_gten(files[dtype], JCFG)
    assert fdt == jdt == dtype and got.keys() == want.keys()
    for key in ("embed", "wq.1", "w_down.0", "attn_norm.1", "norm", "lm_head"):
        if isinstance(got[key], tuple):
            jq = jcodec.QTensor(*(np.asarray(a) for a in want[key]), dtype)
            pq = codec.QTensor(*got[key], dtype)
            np.testing.assert_array_equal(_bits(codec.dequantize(pq).numpy()),
                                          _bits(jcodec.dequantize(jq)))
        else:
            np.testing.assert_array_equal(got[key].numpy(), want[key])


def _assert_params_equal(pp, jp):
    for name in LINEARS:
        assert pp["layers"][name].layout == "kn"
        np.testing.assert_array_equal(
            _bits(codec.dequantize(pp["layers"][name]).numpy()),
            _bits(jcodec.dequantize(jp["layers"][name])), err_msg=name)
    for name in ("attn_norm", "ffn_norm"):
        np.testing.assert_array_equal(pp["layers"][name].numpy(),
                                      np.asarray(jp["layers"][name]))
    np.testing.assert_array_equal(pp["norm"].numpy(), np.asarray(jp["norm"]))
    for name, layout in (("embed", "nk"), ("lm_head", "kn")):
        assert pp[name].layout == layout
        np.testing.assert_array_equal(_bits(codec.dequantize(pp[name]).numpy()),
                                      _bits(jcodec.dequantize(jp[name])),
                                      err_msg=name)


@pytest.mark.parametrize("file_dtype,wdtype", [
    ("q8", None), ("q4", None), ("q4", "q4g"), ("q8", "q4g"),
    ("fp16", "q8"), ("fp16", "q4"), ("fp16", "q4g"),
])
def test_load_gten_matches_jax(files, file_dtype, wdtype):
    """Each file kind into its own policy, q4 (and q8) into q4g by
    requantizing, and fp16 into every quantized policy: the parameters
    dequantize to the JAX loader's values bit for bit."""
    jpol = wdtype and JaxPolicy(wdtype, "f32", "f32")
    ppol = wdtype and pconfig.DtypePolicy(wdtype, "f32", "f32")
    jp, jpolicy = jckpt.load_gten_checkpoint(files[file_dtype], JCFG, jpol)
    pp, ppolicy = checkpoint.load_gten_checkpoint(files[file_dtype], CFG, ppol)
    assert ppolicy.wdtype == jpolicy.wdtype == (wdtype or file_dtype)
    assert pp["layers"]["wqkv"].kind == ppolicy.wdtype
    _assert_params_equal(pp, jp)


@pytest.mark.parametrize("file_dtype,wdtype,exc", [
    ("q8", "q4", ValueError), ("q4", "q8", ValueError),
    ("q4", "f16", ValueError), ("q8", "f32", ValueError),
])
def test_load_gten_refuses_pairs(files, file_dtype, wdtype, exc):
    """Incompatible file / policy pairs raise as in the JAX package (a
    quantized file under a dense policy among them; an fp16 file into a
    dense policy loads: tests/test_torch_dense.py)."""
    pol = wdtype and pconfig.POLICIES[wdtype]
    if exc is ValueError:
        with pytest.raises(ValueError):
            jckpt.load_gten_checkpoint(files[file_dtype], JCFG,
                                       wdtype and JaxPolicy(wdtype, "bf16", "bf16"))
    with pytest.raises(exc):
        checkpoint.load_gten_checkpoint(files[file_dtype], CFG, pol)


def test_gten_bad_magic_and_order_raise(files, tmp_path):
    p = tmp_path / "bad.gten"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        checkpoint.load_gten_checkpoint(p, CFG)
    raw = bytearray(files["q8"].read_bytes())
    idx = raw.find(b"q_proj")
    raw[raw.find(b"q_proj", idx + 1)] = ord("x")  # the weight record's copy
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="order mismatch"):
        checkpoint.load_gten_checkpoint(p, CFG)


@pytest.mark.parametrize("mutate", ["truncate_half", "truncate_1", "zero_len",
                                    "garbage_tail"])
def test_gten_parser_rejects_corruption(files, tmp_path, mutate):
    data = files["q4"].read_bytes()
    data = {"truncate_half": data[: len(data) // 2], "truncate_1": data[:-1],
            "zero_len": data[:8] + b"\x00" * 4 + data[12:],
            "garbage_tail": data + b"\xde\xad\xbe\xef" * 4}[mutate]
    p = tmp_path / "bad.gten"
    p.write_bytes(data)
    with pytest.raises((ValueError, struct.error)):
        gten.read_gten(p, CFG)


# --- HuggingFace ------------------------------------------------------------------


def _hf_state_dict(dense, cfg=CFG):
    sd = {"model.embed_tokens.weight": dense["embed"],
          "model.norm.weight": dense["norm"], "lm_head.weight": dense["lm_head"]}
    D, kv, F = cfg.n_embd, cfg.kv_dim, cfg.n_ffn
    splits = {"wqkv": (("self_attn.q_proj.weight", 0, D),
                       ("self_attn.k_proj.weight", D, D + kv),
                       ("self_attn.v_proj.weight", D + kv, D + 2 * kv)),
              "wo": (("self_attn.o_proj.weight", 0, D),),
              "w_gateup": (("mlp.gate_proj.weight", 0, F),
                           ("mlp.up_proj.weight", F, 2 * F)),
              "w_down": (("mlp.down_proj.weight", 0, D),),
              "attn_norm": (("input_layernorm.weight", None, None),),
              "ffn_norm": (("post_attention_layernorm.weight", None, None),)}
    for rname, pieces in splits.items():
        for i in range(cfg.n_layers):
            for suffix, lo, hi in pieces:
                w = dense["layers"][rname][i]
                sd[f"model.layers.{i}.{suffix}"] = np.ascontiguousarray(
                    w if lo is None else w[lo:hi])
    return sd


@pytest.mark.parametrize("form,wdtype", [("single", "q4"), ("sharded", "q4g"),
                                         ("tied", "q8"), ("bin", "q4")])
def test_load_hf_matches_jax(dense, tmp_path, form, wdtype):
    """One .safetensors file, shards under model.safetensors.index.json, a
    checkpoint without lm_head.weight (tied to the embedding table), and
    a torch .bin: the same parameters as the JAX loader."""
    from safetensors.numpy import save_file

    sd = _hf_state_dict(dense)
    if form == "tied":
        del sd["lm_head.weight"]
    if form == "sharded":
        names = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": names[::2],
                  "model-00002-of-00002.safetensors": names[1::2]}
        for shard, keys in shards.items():
            save_file({k: sd[k] for k in keys}, str(tmp_path / shard))
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: s for s, ks in shards.items() for k in ks}}))
        path = tmp_path
    elif form == "bin":
        path = tmp_path / "pytorch_model.bin"
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   path)
    else:
        path = tmp_path / "model.safetensors"
        save_file(sd, str(path))
    jp = jckpt.load_hf_checkpoint(path, JCFG, JaxPolicy(wdtype, "f32", "f32"))
    pp = checkpoint.load_hf_checkpoint(path, CFG, pconfig.DtypePolicy(wdtype, "f32",
                                                                      "f32"))
    _assert_params_equal(pp, jp)
    if form == "tied":
        np.testing.assert_array_equal(codec.dequantize(pp["lm_head"]).numpy().T,
                                      codec.dequantize(pp["embed"]).numpy())


def test_read_safetensors_dtypes(tmp_path):
    """bf16, f16 and int tensors, an empty one and metadata, read as the
    safetensors package reads them."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "b": torch.randn(7, generator=g).half(),
               "c": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "d": torch.zeros(0, 4)}
    p = tmp_path / "t.safetensors"
    save_file(tensors, str(p), metadata={"format": "pt"})
    got, want = checkpoint.read_safetensors(p), load_file(str(p))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


# --- tokenizers -------------------------------------------------------------------

TEXTS = ["Give three tips for staying healthier.", "hello world\nnew line",
         "Königin überraschung 你好 \t tabs", "", "zz  double  spaces ~!"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "tokenizer.bin"
    tokenizer.stand_in_vocab(p)
    return p


def test_stand_in_vocab_layout(vocab):
    t = tokenizer.Tokenizer(vocab)
    assert len(t.vocab) == 32000 and len(set(t.vocab)) == 32000
    assert t.vocab[13] == b"<0x0A>" and t.decode(5, 13) == b"\n"
    assert t.vocab[:3] == [b"<unk>", b"<s>", b"</s>"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(vocab, text):
    """encode_raw, the chat template, decode (and decode after BOS) and
    safe_piece give the JAX tokenizer's ids and bytes."""
    ours = tokenizer.Tokenizer(vocab)
    theirs = jtok.Tokenizer(vocab, use_native=False)
    ids = ours.encode_raw(text)
    assert ids == theirs.encode_raw(text)
    chat = ours.encode(text)
    assert chat == theirs.encode(text)
    assert chat[:2] == [1, 32001] and chat[-6:] == [32002, 29871, 13, 32001,
                                                      20255, 13]
    prev = 1
    for t in chat + [31999, 32000, -1]:
        piece = ours.decode(prev, t)
        assert piece == theirs.decode(prev, t)
        assert tokenizer.safe_piece(piece) == jtok.safe_piece(piece)
        prev = t
    assert ours.decode_sequence(ids) == theirs.decode_sequence(ids)


@pytest.fixture(scope="module")
def hf_tok(tmp_path_factory):
    """A small byte-level BPE with Llama-3's pre-tokenizer and specials,
    trained with the tokenizers library."""
    tk = pytest.importorskip("tokenizers")
    tok = tk.Tokenizer(tk.models.BPE())
    tok.pre_tokenizer = tk.pre_tokenizers.Sequence([
        tk.pre_tokenizers.Split(tk.Regex(hf_tokenizer.LLAMA3_SPLIT),
                                behavior="isolated"),
        tk.pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    trainer = tk.trainers.BpeTrainer(
        vocab_size=400, show_progress=False,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
                        "<|start_header_id|>", "<|end_header_id|>"],
        initial_alphabet=tk.pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator([" ".join(TEXTS) * 5], trainer)
    p = tmp_path_factory.mktemp("hf") / "tokenizer.json"
    tok.save(str(p))
    return p


@pytest.mark.parametrize("text", TEXTS)
def test_hf_tokenizer_matches_jax(hf_tok, text):
    ours, theirs = hf_tokenizer.HFTokenizer(hf_tok), jhf.HFTokenizer(hf_tok)
    ids = ours.encode_raw(text)
    assert ids == theirs.encode_raw(text)
    assert ours.encode(text) == theirs.encode(text)
    assert ours.eos == theirs.eos == ours.special["<|eot_id|>"]
    assert ours.decode_ids(ids) == theirs.decode_ids(ids) == text
    assert [ours.decode(0, i) for i in ids] == [theirs.decode(0, i) for i in ids]


def test_load_tokenizer_dispatch(hf_tok, vocab):
    assert isinstance(hf_tokenizer.load_tokenizer(hf_tok), hf_tokenizer.HFTokenizer)
    assert isinstance(hf_tokenizer.load_tokenizer(vocab), tokenizer.Tokenizer)


# --- the CLI ---------------------------------------------------------------------


@pytest.fixture
def cli_files(dense, monkeypatch, tmp_path, vocab):
    """tiny-test at the tokenizer's vocab (the chat template's ids reach
    32002): a q4 .gten of it, and the stand-in tokenizer.bin."""
    cfg = pconfig.tiny_test_config(n_vocab=32003)
    monkeypatch.setattr(cli, "tiny_test_config", lambda: cfg)
    rng = np.random.default_rng(4)
    big = {**dense, "embed": (rng.standard_normal((32003, 128)) * 0.02
                              ).astype(np.float32)}
    big["lm_head"] = (rng.standard_normal((32003, 128)) * 0.02).astype(np.float32)
    p = tmp_path / "tiny.q4.gten"
    checkpoint.save_gten_checkpoint(p, cfg, big, "q4")
    return cfg, p, vocab


@pytest.mark.parametrize("kind", ["q4", "q4g"])
def test_cli_runs_a_checkpoint_on_cpu(cli_files, capfd, kind):
    """--ckpt and --tokenizer at tiny-test: the streamed text is the
    tokenizer's decoding of the engine's greedy tokens on the loaded
    weights, ending at the tokenizer's EOS or the budget."""
    from tinyllama_tpu_torch.runtime.engine import Engine

    cfg, ckpt, vocab = cli_files
    argv = [f"-{kind}", "--ckpt", str(ckpt), "--tokenizer", str(vocab), "-p",
            "hello there", "-greedy", "--npred", "40", "--model", "tiny-test",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    out, err = capfd.readouterr()
    assert "Throughput" in out
    tok = tokenizer.Tokenizer(vocab)
    params, policy = checkpoint.load_gten_checkpoint(ckpt, cfg,
                                                     pconfig.POLICIES[kind])
    prompt = tok.encode("hello there")
    ids, _ = Engine(cfg, policy, params, device="cpu").generate(
        prompt, pconfig.GenerationConfig(n_predict=40, greedy=True,
                                         eos_token=tok.eos))
    text, prev = b"", 1
    for t in ids:
        text += tokenizer.safe_piece(tok.decode(prev, t))
        prev = t
    assert err.encode() == text + b"\n"


def test_cli_chat_repl(cli_files, capfd, monkeypatch):
    """Without -p the CLI reads prompts until "q"."""
    _, ckpt, vocab = cli_files
    prompts = iter(["hi", "q"])
    monkeypatch.setattr("builtins.input", lambda: next(prompts))
    assert cli.main(["--ckpt", str(ckpt), "--tokenizer", str(vocab), "-greedy",
                     "--npred", "30", "--model", "tiny-test", "--device",
                     "cpu", "--no-perf"]) == 0
    out, err = capfd.readouterr()
    assert "Chat interface" in out and err.count("[You]: ") == 2
    assert "[Tinyllama-Chat]" in err


def test_cli_refuses_bad_checkpoint_flags(tmp_path):
    with pytest.raises(SystemExit, match="not both"):
        cli.main(["--random-weights", "--ckpt", "x.gten", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["--ckpt", str(tmp_path / "missing.gten"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--random-weights"):
        cli.main(["-p", "hi", "--device", "cpu"])
