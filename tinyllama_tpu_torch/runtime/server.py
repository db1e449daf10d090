"""HTTP streaming server over the port's continuous batcher.

The port's counterpart of the JAX package's runtime/server.py. Stdlib
only: a ThreadingHTTPServer front end feeds one scheduler thread, which
owns the ContinuousBatcher and does all torch work; HTTP threads only
enqueue requests and drain their per-request token queues.

Endpoints:
  POST /generate   {"prompt": str, "max_new"?: int, "stream"?: bool}
    stream=true  -> text/event-stream, one SSE `data:` line of
                    {"token", "piece"} per token, final event
                    `data: [DONE]`
    stream=false -> {"text": str, "tokens": [int], "ttft_ms": float}
  GET /healthz     {"status": "ok", "slots": B, "queued": n}

A request's sampling is the server's (``--greedy``, ``--temp``,
``--topk``): the handler reads ``prompt``, ``max_new`` (default 128) and
``stream`` only, as the JAX handler does; other keys are ignored. The
batcher's cache is the engine's kind (``--paged``: a page pool). If the
scheduler thread dies, /healthz reports ``"status": "error"`` with the
error, requests in flight end with it (a 500, or a stream's last event
``data: {"error": ...}`` in place of ``[DONE]``) and new ones get a 503,
where the JAX server answers the requests in flight 200 with the tokens
they had.

Run:  python -m tinyllama_tpu_torch.runtime.server --random-weights \\
          --model tiny-test --tokenizer tokenizer.bin --device cpu \\
          --port 8080
(without ``--device cpu`` it runs on the card, and raises without one).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tinyllama_tpu_torch.config import GenerationConfig


class _SchedulerLoop:
    """Single thread that owns the ContinuousBatcher: admits queued
    requests and fans generated tokens out to per-request queues."""

    _END = object()

    def __init__(self, batcher, tokenizer):
        self.batcher = batcher
        self.tokenizer = tokenizer
        self._lock = threading.Lock()
        self._queues: dict[int, queue.Queue] = {}
        self._pending = 0
        self._wake = threading.Event()
        self.error: str | None = None  # set if the scheduler thread died
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, prompt_ids, max_new) -> tuple[int, queue.Queue]:
        if self.error is not None:
            raise RuntimeError(f"scheduler thread died: {self.error}")
        q: queue.Queue = queue.Queue()
        with self._lock:
            rid = self.batcher.submit(prompt_ids, max_new=max_new)
            self._queues[rid] = q
            self._pending += 1
        self._wake.set()
        return rid, q

    @property
    def queued(self) -> int:
        return self._pending

    def _stream(self, rid: int, tok: int) -> None:
        q = self._queues.get(rid)
        if q is not None:
            q.put(tok)

    def _run(self) -> None:
        # An exception out of batcher.step would otherwise end this daemon
        # thread and leave every HTTP handler blocked on q.get(): record
        # it, release every waiter and mark the loop dead so later submits
        # fail at once, then let it end the thread (threading prints it).
        try:
            while True:
                with self._lock:
                    work = self.batcher.has_work
                if not work:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                with self._lock:
                    self.batcher.step(stream=self._stream)
                    finished = [rid for rid in list(self._queues)
                                if rid in self.batcher.results]
                    for rid in finished:
                        self._queues[rid].put(self._END)
                        del self._queues[rid]
                        self._pending -= 1
        except BaseException as e:
            self.error = f"{type(e).__name__}: {e}"
            with self._lock:
                for q in self._queues.values():
                    q.put(self._END)
                self._queues.clear()
                self._pending = 0
            raise


def make_handler(loop: _SchedulerLoop, tokenizer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._json({
                "status": "ok" if loop.error is None else "error",
                "slots": loop.batcher.B,
                "queued": loop.queued,
                **({"error": loop.error} if loop.error else {}),
            })

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                max_new = int(req.get("max_new", 128))
            except (KeyError, ValueError) as e:
                self.send_error(400, f"bad request: {e}")
                return
            ids = tokenizer.encode(prompt)
            t0 = time.perf_counter()
            try:
                _, q = loop.submit(ids, max_new)
            except (RuntimeError, ValueError) as e:
                self.send_error(503 if loop.error else 400, str(e))
                return

            toks: list[int] = []
            ttft = None
            if req.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                prev = 1
                while (tok := q.get()) is not loop._END:
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    piece = tokenizer.decode(prev, tok)
                    prev = tok
                    self.wfile.write(b"data: " + json.dumps({
                        "token": tok,
                        "piece": piece.decode("utf-8", "replace"),
                    }).encode() + b"\n\n")
                    self.wfile.flush()
                # a dead scheduler thread ends the stream without [DONE]
                self.wfile.write(b"data: " + (
                    json.dumps({"error": loop.error}).encode() if loop.error
                    else b"[DONE]") + b"\n\n")
                self.wfile.flush()
                self.close_connection = True
                return

            while (tok := q.get()) is not loop._END:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.append(tok)
            if loop.error:
                self.send_error(500, f"scheduler thread died: {loop.error}")
                return
            self._json({
                "text": tokenizer.decode_sequence(toks),
                "tokens": toks,
                "ttft_ms": round((ttft or 0.0) * 1000, 1),
            })

    return Handler


def serve(engine, tokenizer, gen: GenerationConfig, port: int,
          max_batch: int = 8, n_pages: int | None = None):
    """An HTTP server (not yet serving: call serve_forever) over a
    ContinuousBatcher of `max_batch` slots on `engine`, whose cache is the
    engine's kind; `port` 0 takes a free one (``server_address[1]``)."""
    from tinyllama_tpu_torch.runtime.scheduler import ContinuousBatcher

    batcher = ContinuousBatcher(engine, gen, max_batch=max_batch,
                                n_pages=n_pages)
    loop = _SchedulerLoop(batcher, tokenizer)
    httpd = ThreadingHTTPServer(("0.0.0.0", port),
                                make_handler(loop, tokenizer))
    httpd.batcher = batcher  # for tests and introspection
    return httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--model", default="tinyllama-1.1b-chat-v0.4")
    ap.add_argument("--dtype", default="q4")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--tokenizer", default="tokenizer.bin")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="run device. [default=cuda]")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--temp", type=float, default=0.9)
    ap.add_argument("--topk", type=int, default=50)
    args = ap.parse_args(argv)
    if not (args.random_weights or args.ckpt):
        raise SystemExit("pass --ckpt or --random-weights")

    from tinyllama_tpu_torch.cli import load_params
    from tinyllama_tpu_torch.config import MODEL_REGISTRY, tiny_test_config
    from tinyllama_tpu_torch.io.hf_tokenizer import load_tokenizer
    from tinyllama_tpu_torch.runtime.engine import Engine, resolve_device

    device = resolve_device(args.device)
    cfg = (tiny_test_config() if args.model == "tiny-test"
           else MODEL_REGISTRY[args.model])
    params, policy = load_params(args, cfg, device)
    tokenizer = load_tokenizer(args.tokenizer)
    engine = Engine(cfg, policy, params, device=device, paged=args.paged)
    gen = GenerationConfig(greedy=args.greedy, temperature=args.temp,
                           top_k=args.topk,
                           eos_token=getattr(tokenizer, "eos", -1))
    httpd = serve(engine, tokenizer, gen, args.port, max_batch=args.slots)
    print(f"serving on :{httpd.server_address[1]} ({args.slots} slots, "
          f"{'paged' if args.paged else 'monolithic'} KV, {policy.wdtype} "
          f"weights, {device})", flush=True)
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
