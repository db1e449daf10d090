"""Request routing across data-parallel replica servers.

The port's counterpart of the JAX package's runtime/router.py, stdlib
only like the server: each replica runs its own runtime.server (an
Engine and a ContinuousBatcher), and this router spreads requests over
them.

* Latency-weighted least-loaded routing. A probe thread polls every
  backend's /healthz each ``probe_interval`` seconds; its ``queued``
  count plus the router's own in-flight count is the backend's depth.
  Each backend carries an EWMA of its measured time to first byte, and
  the score is the expected wait (depth + 1) x EWMA; a backend with no
  sample yet scores at the fleet mean (all equal: least-loaded).
* Failure detection. A probe or proxy error marks a backend;
  ``max_failures`` errors in a row take it out of rotation. Probing
  goes on, so a backend whose /healthz answers again rejoins after one
  clean probe.
* Request-level failover. A request that fails on a backend before any
  byte reached the client is retried on the next best healthy backend,
  at most once a backend; once bytes have left, the error reaches the
  client (a sampled request run again would give other tokens).

Endpoints mirror the server's (POST /generate with SSE streaming, GET
/healthz aggregating the backends), so a client cannot tell the router
from a lone server.

Run:  python -m tinyllama_tpu_torch.runtime.router \\
          --backends http://host-a:8080,http://host-b:8080 --port 8000
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


@dataclass
class Backend:
    url: str  # e.g. "http://host:8080", no trailing slash
    healthy: bool = False
    consecutive_failures: int = 0
    queued: int = 0  # from the last /healthz probe
    slots: int = 0
    inflight: int = 0  # requests this router is holding open
    ewma_ttfb: float | None = None  # measured service latency, seconds
    lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def load(self) -> int:
        return self.queued + self.inflight


class Router:
    """Health-checked least-loaded proxy over replica servers."""

    def __init__(self, backend_urls: list[str], probe_interval: float = 2.0,
                 max_failures: int = 2, timeout: float = 300.0,
                 latency_alpha: float = 0.3):
        if not backend_urls:
            raise ValueError("the router needs at least one backend")
        self.latency_alpha = latency_alpha
        self.backends = [Backend(u.rstrip("/")) for u in backend_urls]
        self.probe_interval = probe_interval
        self.max_failures = max_failures
        self.timeout = timeout
        self._stop = threading.Event()
        self._probe_thread = threading.Thread(target=self._probe_loop,
                                              daemon=True)
        self.probe_all()  # a first pass in this thread: start from real state
        self._probe_thread.start()

    # ------------------------------------------------------------- probing

    def probe_all(self) -> None:
        for b in self.backends:
            self._probe(b)

    def _probe(self, b: Backend) -> None:
        try:
            with urllib.request.urlopen(b.url + "/healthz", timeout=5.0) as r:
                info = json.loads(r.read())
            ok = info.get("status") == "ok"
        except (OSError, ValueError, urllib.error.URLError):
            ok, info = False, {}
        if ok:
            with b.lock:
                b.healthy = True
                b.consecutive_failures = 0
                b.queued = int(info.get("queued", 0))
                b.slots = int(info.get("slots", 0))
        else:
            self.mark_failure(b)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            self.probe_all()

    def close(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------- routing

    def mark_failure(self, b: Backend) -> None:
        with b.lock:
            b.consecutive_failures += 1
            if b.consecutive_failures >= self.max_failures:
                b.healthy = False

    def record_latency(self, b: Backend, seconds: float) -> None:
        """Fold one measured time to first byte into the backend's EWMA
        service time (every successful proxy calls this)."""
        a = self.latency_alpha
        with b.lock:
            b.ewma_ttfb = (seconds if b.ewma_ttfb is None
                           else (1 - a) * b.ewma_ttfb + a * seconds)

    def pick(self, exclude: set[str] = frozenset()) -> Backend | None:
        """The healthy backend (not in `exclude`) with the least expected
        wait, (depth + 1) x EWMA service time; one without a sample yet
        scores at the fleet mean, so a new or recovered replica is neither
        shunned nor flooded."""
        live = [b for b in self.backends if b.healthy and b.url not in exclude]
        if not live:
            return None
        known = [b.ewma_ttfb for b in live if b.ewma_ttfb is not None]
        default = sum(known) / len(known) if known else 1.0
        return min(live, key=lambda b: (b.load + 1) * (
            b.ewma_ttfb if b.ewma_ttfb is not None else default))

    def health(self) -> dict:
        per = [{"url": b.url, "healthy": b.healthy, "queued": b.queued,
                "slots": b.slots, "inflight": b.inflight,
                "ewma_ttfb_s": b.ewma_ttfb} for b in self.backends]
        return {"status": "ok" if any(b.healthy for b in self.backends)
                else "error", "backends": per}


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps(router.health()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _proxy(self, b: Backend, payload: bytes) -> None:
            """Forward one request to `b`, each streamed chunk as it
            arrives; sets self.started once bytes leave for the client.
            Raises OSError on a backend failure."""
            t0 = time.monotonic()
            req = urllib.request.Request(
                b.url + "/generate", data=payload,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=router.timeout) as r:
                ctype = r.headers.get("Content-Type", "application/json")
                if not ctype.startswith("text/event-stream"):
                    # the first byte arrives with the finished generation
                    body = r.read()
                    router.record_latency(b, time.monotonic() - t0)
                    self.send_response(r.status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.started = True
                    self.wfile.write(body)
                    return
                self.send_response(r.status)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.started = True
                first = True
                while chunk := r.read1(1024):
                    if first:  # streaming: TTFT is the service signal
                        router.record_latency(b, time.monotonic() - t0)
                        first = False
                    self.wfile.write(chunk)
                    self.wfile.flush()
                self.close_connection = True

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            payload = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            tried: set[str] = set()
            while True:
                b = router.pick(exclude=tried)
                if b is None:
                    self.send_error(503, "no healthy backend")
                    return
                tried.add(b.url)
                with b.lock:
                    b.inflight += 1
                self.started = False
                try:
                    self._proxy(b, payload)
                    return
                except (OSError, urllib.error.URLError) as e:
                    router.mark_failure(b)
                    if self.started:
                        # bytes already left for the client: running the
                        # request again could give other tokens
                        self.close_connection = True
                        return
                    if len(tried) >= len(router.backends):
                        self.send_error(502, f"all backends failed (last: {e})")
                        return
                    # else: fail over to the next backend
                finally:
                    with b.lock:
                        b.inflight -= 1

    return Handler


def serve_router(backend_urls: list[str], port: int, **kw):
    """An HTTP server (not yet serving: call serve_forever) routing over
    `backend_urls`; `port` 0 takes a free one. ``httpd.router`` is the
    Router (close it after shutdown to end its probe thread)."""
    router = Router(backend_urls, **kw)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(router))
    httpd.router = router
    return httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backends", required=True,
                    help="comma-separated replica base URLs")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--probe-interval", type=float, default=2.0)
    args = ap.parse_args(argv)
    httpd = serve_router([u for u in args.backends.split(",") if u], args.port,
                         probe_interval=args.probe_interval)
    print(f"routing on :{httpd.server_address[1]} over "
          f"{len(httpd.router.backends)} backends", flush=True)
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
