"""The port's HTTP server and router against the JAX package.

The same f32 dense weights, made by the JAX package and carried across
by ``interop.params_from_numpy``, serve both packages. The server's
tokens must equal the JAX engine's greedy ``generate`` (as the JAX
suite's test_generate_matches_engine holds its own server), streamed
and not; the router passes the JAX suite's router scenarios over two
port servers; the batcher's ``ttft_chunk`` runs the JAX batcher's chunk
lengths, first-token order and tokens. Every server takes an ephemeral
port, and every blocking call has a timeout.
"""

import ast
import http.client
import json
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tinyllama_tpu.config import DtypePolicy as JaxPolicy
from tinyllama_tpu.config import GenerationConfig as JaxGen
from tinyllama_tpu.config import tiny_test_config as jax_tiny
from tinyllama_tpu.models import llama as jllama
from tinyllama_tpu.runtime.engine import Engine as JaxEngine
from tinyllama_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from tinyllama_tpu_torch import config as pconfig
from tinyllama_tpu_torch.interop import params_from_numpy
from tinyllama_tpu_torch.io.tokenizer import Tokenizer, stand_in_vocab
from tinyllama_tpu_torch.runtime import server as pserver
from tinyllama_tpu_torch.runtime.engine import Engine
from tinyllama_tpu_torch.runtime.router import Router, serve_router
from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher
from tinyllama_tpu_torch.runtime.server import serve

#: the chat template's ids reach 32002: tiny-test at the tokenizer's vocab
JCFG = jax_tiny(n_vocab=32003)
CFG = pconfig.tiny_test_config(n_vocab=32003)
JF32 = JaxPolicy("f32", "f32", "f32")
F32 = pconfig.POLICIES["f32"]
GEN = pconfig.GenerationConfig(greedy=True, eos_token=-1)
TIMEOUT = 60


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX engine, port params, tokenizer, one port server's port)."""
    jp = jllama.init_dense_params(JCFG, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                               F32)
    vocab = tmp_path_factory.mktemp("vocab") / "tokenizer.bin"
    stand_in_vocab(vocab)
    tok = Tokenizer(vocab)
    httpd = serve(Engine(CFG, F32, params, device="cpu"), tok, GEN, 0,
                  max_batch=2)
    port = _start(httpd)
    yield JaxEngine(JCFG, JF32, jp, max_batch=2), params, tok, port
    httpd.shutdown()
    httpd.server_close()


def _want(world, prompt, max_new):
    jeng, _, tok, _ = world
    ids = tok.encode(prompt)
    out, _ = jeng.generate(ids, JaxGen(greedy=True, eos_token=-1,
                                       n_predict=len(ids) + max_new))
    return out


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("POST", "/generate", json.dumps(payload),
                 {"Content-Type": "application/json"})
    return conn.getresponse()


def _health(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("GET", "/healthz")
    return json.loads(conn.getresponse().read())


def _sse(r):
    """The tokens and pieces of an SSE response, and its last event."""
    events = r.read().split(b"\n\n")
    assert events[-1] == b"" and all(e.startswith(b"data: ") for e in events[:-1])
    payloads = [e[len(b"data: "):] for e in events[:-1]]
    data = [json.loads(p) for p in payloads[:-1]]
    return [d["token"] for d in data], [d["piece"] for d in data], payloads[-1]


# --- the server -------------------------------------------------------------------


def test_healthz(world):
    body = _health(world[3])
    assert body == {"status": "ok", "slots": 2, "queued": 0}


def test_generate_matches_jax_engine(world):
    r = _post(world[3], {"prompt": "hello", "max_new": 12})
    assert r.status == 200
    body = json.loads(r.read())
    want = _want(world, "hello", 12)
    assert body["tokens"] == want and len(want) == 12
    assert body["text"] == world[2].decode_sequence(want)
    assert body["ttft_ms"] >= 0


def test_generate_streaming_equals_non_streaming(world):
    _, _, tok, port = world
    r = _post(port, {"prompt": "hi there", "max_new": 8, "stream": True})
    assert r.status == 200
    assert r.getheader("Content-Type").startswith("text/event-stream")
    toks, pieces, last = _sse(r)
    assert last == b"[DONE]"
    plain = json.loads(_post(port, {"prompt": "hi there", "max_new": 8}).read())
    assert toks == plain["tokens"] == _want(world, "hi there", 8)
    prev = [1] + toks
    assert pieces == [tok.decode(p, t).decode("utf-8", "replace")
                      for p, t in zip(prev, toks)]


def test_concurrent_requests(world):
    port = world[3]
    prompts = ["alpha", "beta code", "gamma ray", "delta"]
    results = {}

    def go(i, prompt):
        results[i] = json.loads(_post(port, {"prompt": prompt,
                                             "max_new": 10}).read())["tokens"]

    threads = [threading.Thread(target=go, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert sorted(results) == [0, 1, 2, 3]
    for i, p in enumerate(prompts):
        assert results[i] == _want(world, p, 10), p


def test_many_concurrent_requests_under_fast_switching(world):
    """16 requests from 16 threads (more than this host's cores) through
    2 slots with the interpreter switching threads every microsecond:
    each gets the JAX engine's tokens, and the server's queued count
    returns to 0 (a lost update to it would not)."""
    port = world[3]
    prompts = [f"request {chr(97 + i)}" for i in range(16)]
    results = {}

    def go(i):
        body = _post(port, {"prompt": prompts[i], "max_new": 3}).read()
        results[i] = json.loads(body)["tokens"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(16)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    for i, p in enumerate(prompts):
        assert results[i] == _want(world, p, 3), p
    assert _health(port)["queued"] == 0


def test_dead_scheduler_thread_is_reported(world, monkeypatch):
    """A batcher step that raises ends the scheduler thread with that
    error: the request in flight gets a 500 (not a hang), /healthz says
    "error" with the cause, and a later request a 503."""
    _, params, tok, _ = world
    ended = []
    monkeypatch.setattr(threading, "excepthook", ended.append)
    httpd = serve(Engine(CFG, F32, params, device="cpu"), tok, GEN, 0,
                  max_batch=2)

    def broken(stream=None):
        raise RuntimeError("card lost")

    httpd.batcher.step = broken
    port = _start(httpd)
    try:
        r = _post(port, {"prompt": "x", "max_new": 4})
        assert r.status == 500
        r.read()
        body = _health(port)
        assert body["status"] == "error" and "card lost" in body["error"]
        deadline = time.monotonic() + TIMEOUT
        while not ended and time.monotonic() < deadline:
            time.sleep(0.01)  # the thread re-raises after releasing waiters
        assert [type(a.exc_value) for a in ended] == [RuntimeError]
        r = _post(port, {"prompt": "x", "max_new": 4, "stream": True})
        assert r.status == 503
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_server_main_needs_a_card_or_cpu(tmp_path):
    """Without --device cpu the server's entry point runs on the card, and
    raises without one before it loads anything or binds a port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pserver.main(["--random-weights", "--model", "tiny-test",
                      "--tokenizer", str(tmp_path / "absent.bin")])
    with pytest.raises(SystemExit, match="--random-weights"):
        pserver.main(["--device", "cpu"])


# --- the batcher's ttft_chunk -------------------------------------------------------


def test_ttft_chunk_matches_jax_batcher(world):
    """ttft_chunk=2 over chunk_size 8: the same requests through the JAX
    batcher and the port's run the same chunk lengths, reach each
    request's first token in the same chunk, and give the same tokens."""
    jeng, params, tok, _ = world
    prompts = [tok.encode(p) for p in ("one", "two two", "three", "four four",
                                       "five")]
    max_new = [5, 9, 3, 7, 6]

    def drive(batcher, record):
        first = {}

        def stream(rid, t):
            first.setdefault(rid, len(record))

        ids = [batcher.submit(p, max_new=n) for p, n in zip(prompts, max_new)]
        res = batcher.run(stream=stream)
        return [res[i].output for i in ids], [first[i] for i in ids]

    jlens = []
    real_chunk_fn = jeng._chunk_fn

    def rec_chunk_fn(C, *a, **k):
        jlens.append(C)
        return real_chunk_fn(C, *a, **k)

    jeng._chunk_fn = rec_chunk_fn
    try:
        jgen = JaxGen(greedy=True, eos_token=-1, chunk_size=8)
        jout, jfirst = drive(JaxBatcher(jeng, jgen, max_batch=2, ttft_chunk=2),
                             jlens)
    finally:
        del jeng._chunk_fn
    eng = Engine(CFG, F32, params, device="cpu")
    plens = []
    real_chunk = eng.chunk

    def rec_chunk(cache, logits, pos, C, *a, **k):
        plens.append(C)
        return real_chunk(cache, logits, pos, C, *a, **k)

    eng.chunk = rec_chunk
    pgen = pconfig.GenerationConfig(greedy=True, eos_token=-1, chunk_size=8)
    pout, pfirst = drive(ContinuousBatcher(eng, pgen, max_batch=2,
                                           ttft_chunk=2), plens)
    assert plens == jlens and 2 in plens and 8 in plens
    assert pfirst == jfirst
    assert pout == jout and [len(o) for o in pout] == max_new


# --- the router ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(world):
    _, params, tok, _ = world
    backends, ports = [], []
    for _ in range(2):
        httpd = serve(Engine(CFG, F32, params, device="cpu"), tok, GEN, 0,
                      max_batch=2)
        ports.append(_start(httpd))
        backends.append(httpd)
    router = serve_router([f"http://127.0.0.1:{p}" for p in ports], 0,
                          probe_interval=0.2, max_failures=1)
    rport = _start(router)
    yield backends, ports, router, rport
    router.shutdown()
    router.server_close()
    router.router.close()
    for b in backends:
        b.shutdown()
        b.server_close()


def test_router_routes_and_matches_engine(world, cluster):
    r = _post(cluster[3], {"prompt": "hello", "max_new": 10})
    assert r.status == 200
    assert json.loads(r.read())["tokens"] == _want(world, "hello", 10)


def test_router_healthz_aggregates_backends(cluster):
    body = _health(cluster[3])
    assert body["status"] == "ok" and len(body["backends"]) == 2
    assert all(b["healthy"] and b["slots"] == 2 for b in body["backends"])


def test_router_concurrent_requests_spread_and_complete(world, cluster):
    backends, _, _, rport = cluster
    before = [len(b.batcher.results) for b in backends]
    prompts = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    results = {}

    def go(i, prompt):
        results[i] = json.loads(_post(rport, {"prompt": prompt,
                                              "max_new": 8}).read())["tokens"]

    threads = [threading.Thread(target=go, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    for i, p in enumerate(prompts):
        assert results[i] == _want(world, p, 8), p
    served = [len(b.batcher.results) - n for b, n in zip(backends, before)]
    assert sum(served) == len(prompts) and min(served) > 0


def test_router_failover_and_recovery(world, cluster):
    backends, ports, router_httpd, rport = cluster
    _, params, tok, _ = world
    backends[0].shutdown()
    backends[0].server_close()  # frees the port for the restart below
    deadline = time.monotonic() + 20
    while all(b["healthy"] for b in _health(rport)["backends"]):
        assert time.monotonic() < deadline, "the dead backend stayed healthy"
        time.sleep(0.1)
    down = [b for b in _health(rport)["backends"] if not b["healthy"]]
    assert [b["url"] for b in down] == [f"http://127.0.0.1:{ports[0]}"]
    for prompt in ("after failure", "and again"):
        r = _post(rport, {"prompt": prompt, "max_new": 6})
        assert r.status == 200
        assert json.loads(r.read())["tokens"] == _want(world, prompt, 6)

    httpd = serve(Engine(CFG, F32, params, device="cpu"), tok, GEN, ports[0],
                  max_batch=2)
    _start(httpd)
    backends[0] = httpd  # the fixture shuts it down
    while not all(b["healthy"] for b in _health(rport)["backends"]):
        assert time.monotonic() < deadline + 20, "the backend did not rejoin"
        time.sleep(0.1)


def test_router_fails_over_within_one_request(world):
    """A backend that refuses connections while still marked healthy: the
    request goes to the next one and succeeds, and the dead one is
    marked down."""
    _, params, tok, _ = world
    live = serve(Engine(CFG, F32, params, device="cpu"), tok, GEN, 0,
                 max_batch=2)
    port = _start(live)
    dead = serve(Engine(CFG, F32, params, device="cpu"), tok, GEN, 0,
                 max_batch=2)
    dead_port = dead.server_address[1]
    dead.server_close()
    httpd = serve_router([f"http://127.0.0.1:{dead_port}",
                          f"http://127.0.0.1:{port}"], 0, probe_interval=60.0,
                         max_failures=1)
    r = httpd.router
    rport = _start(httpd)
    try:
        r.backends[0].healthy = True  # as if the probe had not seen it die
        r.backends[0].ewma_ttfb = 0.0  # and it were the best pick
        resp = _post(rport, {"prompt": "hello", "max_new": 4})
        assert resp.status == 200
        assert json.loads(resp.read())["tokens"] == _want(world, "hello", 4)
        assert not r.backends[0].healthy and r.backends[1].healthy
    finally:
        httpd.shutdown()
        httpd.server_close()
        r.close()
        live.shutdown()
        live.server_close()


def test_latency_weighted_pick_unit():
    """pick() minimizes the expected wait (depth + 1) x EWMA TTFB; a
    backend without a sample scores at the fleet mean."""
    r = Router(["http://127.0.0.1:1", "http://127.0.0.1:2"],
               probe_interval=60.0, max_failures=1)
    try:
        a, b = r.backends
        a.healthy = b.healthy = True
        r.record_latency(a, 0.1)
        r.record_latency(b, 0.4)
        assert r.pick() is a  # equal depth -> the faster backend
        a.inflight = 4  # (4 + 1) * 0.1 = 0.5 > (0 + 1) * 0.4
        assert r.pick() is b
        r.record_latency(b, 1.2)  # the EWMA folds new samples
        assert b.ewma_ttfb == pytest.approx(0.7 * 0.4 + 0.3 * 1.2)
        b.ewma_ttfb = None  # unseen backend: the fleet-mean service time
        a.inflight, b.queued = 0, 1
        assert r.pick() is a
        assert r.pick(exclude={a.url}) is b
    finally:
        r.close()
    with pytest.raises(ValueError):
        Router([])


def test_latency_ewma_recorded_on_proxy(cluster):
    """A proxied request, streamed or not, leaves a TTFB sample."""
    _, _, router_httpd, rport = cluster
    for b in router_httpd.router.backends:
        b.ewma_ttfb = None
    r = _post(rport, {"prompt": "hi", "max_new": 4})
    assert r.status == 200
    r.read()
    assert sum(b["ewma_ttfb_s"] is not None
               for b in _health(rport)["backends"]) == 1
    r = _post(rport, {"prompt": "hi", "max_new": 4, "stream": True})
    toks, _, last = _sse(r)
    assert last == b"[DONE]" and len(toks) == 4
    assert any(b["ewma_ttfb_s"] for b in _health(rport)["backends"])


# --- hygiene ------------------------------------------------------------------------


@pytest.mark.parametrize("module", ["runtime/server.py", "runtime/router.py",
                                    "io/convert.py"])
def test_front_end_modules_import_no_jax(module):
    """The server, the router and the converter import neither JAX nor
    the JAX package; the router only the standard library."""
    path = Path(__file__).resolve().parents[1] / "tinyllama_tpu_torch" / module
    tree = ast.parse(path.read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"jax", "jaxlib", "tinyllama_tpu"}, tops
    if module == "runtime/router.py":
        assert tops <= {"__future__", "argparse", "json", "threading", "time",
                        "urllib", "dataclasses", "http"}, tops
