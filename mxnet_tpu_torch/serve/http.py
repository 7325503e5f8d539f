"""Minimal stdlib-only HTTP frontend for the serving engine (counterpart
of ``mxnet_tpu/serve/http.py``, endpoint for endpoint).

The endpoints (the smallest surface a scraper, a client and a router
need):

- ``POST /generate`` — JSON ``{"input_ids": [...], "max_new_tokens": N,
  "temperature"?, "top_k"?, "top_p"?, "eos_token_id"?, "seed"?,
  "timeout_s"?, "grammar"?, "stream"?}`` -> ``{"status", "output_ids",
  "generated_ids", "ttft_s", "latency_s", "trace_id"}``. Backpressure
  surfaces as 429, a stopped engine as 503, bad requests as 400.
  Deadline-expired requests still return 200 with ``status: "timeout"``
  and the partial output. A W3C ``traceparent`` header parents the
  request's span tree (observability.trace), so the router/client trace
  id follows the request into the engine. ``grammar`` (a regex string or
  JSON-schema object) constrains decoding through the engine's token
  automaton (serve/grammar.py) — the completion conforms by
  construction. ``stream: true`` switches the response to Server-Sent
  Events (``text/event-stream``): one ``event: token`` frame per
  generated token straight off the engine's retire path, ``: heartbeat``
  comments while decode is quiet (so proxies don't idle the socket out),
  and a terminal ``event: done`` frame carrying the same JSON document
  the non-streaming path returns. A client disconnect mid-stream cancels
  the request, freeing its slot.
- ``POST /score`` — batched scoring: ``{"input_ids": [...]}`` ->
  ``{"tokens": N-1, "logprob": sum, "token_logprobs": [...]}``. One
  prefill-shaped forward, no decode loop — per-token logprobs of the
  given sequence under the served model (engine.score).
- ``GET /healthz`` — liveness + slot/page occupancy + the scalar
  ``load`` the multi-replica router's least-loaded dispatch keys on
  (serve/router.py); ``draining: true`` (503) tells the router to eject
  the replica while in-flight requests finish; ``dropped_trace_events``
  / ``profiler_dropped_events`` make silent buffer truncation visible
  from the router. ``models: {name: weight version}`` advertises what
  this replica serves — the router's model-aware dispatch and the
  fleet's weight-version rollout tracking both read it;
  ``models_health: {name: mxhealth tag}`` carries each served weight
  set's checkpoint health verdict (stashed by the weight refresher
  from the publish meta).
- ``POST /drain`` — graceful shutdown: stop admitting (new submits 503
  → the router fails over), finish in-flight slots. Returns
  immediately; poll ``/healthz`` for completion.
- ``POST /cache/export`` / ``POST /cache/import`` — the cache-aware
  fleet's cross-replica KV page transfer (serve/cachefleet.py): export
  returns the kvstore wire doc for a prompt's cached prefix pages, import
  adopts a doc's chain-hash-verified pages into this replica's prefix
  cache. ``/healthz`` also carries the bounded ``prefix_summary`` advert
  the router's prefix-affinity scoring reads, and the replica's ``tier``
  (prefill/decode/None).
- ``GET /metrics`` — Prometheus text exposition (``metrics.expose()``);
  ``GET /metrics/json`` — the JSON registry dump the router's fleet
  aggregation scrapes.
- ``GET /trace/{id}`` — the span tree recorded for one trace id
  (404 with ``tracing_enabled`` when unknown).
- ``GET /models`` — the model registry view (version + engine stats per
  served model); ``POST /weights`` — the push half of live weight
  refresh: ``{"dir": path, "version"?: N, "model"?: name}`` loads a
  published weight set (serve/registry.py layout) and hot-swaps the
  engine between decode ticks; with no ``dir``, re-checks the model's
  configured weights directory. No restart, no recompile.

Not ported yet, and answered with status 501 (Not Implemented) and a
message naming the ROADMAP item that brings it, so that a client or a
router sees at once what this replica lacks: ``GET /perf`` (the JAX
package's cost ledger is built from XLA's cost analysis and TPU peak
tables; it waits for ``observability/`` with a design for the card,
ROADMAP Queue 1 item 8).

Multi-model serving: construct the frontend with a
:class:`~mxnet_tpu_torch.serve.registry.ModelRegistry` instead of a single
engine — ``/generate`` then routes on the payload's ``model`` key
(absent = the registry default). An unknown model answers 503 so a
model-aware router fails over instead of failing the client.

``ThreadingHTTPServer`` gives one handler thread per connection; handlers
block on ``RequestHandle.result()`` while the engine thread batches all
of them into shared decode steps — the HTTP layer adds no scheduling of
its own.
"""
from __future__ import annotations

import json
import queue as _qmod
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import metrics as _metrics
from .. import profiler as _profiler
from ..base import MXNetError
from ..observability import trace as _trace
from .engine import EngineClosedError, InferenceEngine, QueueFullError

__all__ = ["HTTPFrontend", "serve_forever"]


#: the answer of the endpoints this port does not serve yet
_NOT_PORTED = {
    "/perf": "GET /perf (the cost ledger) is not ported yet: it waits for "
             "observability/ with a design for the card (ROADMAP Queue 1 item 8)",
}


class BurstHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog that holds a burst of
    clients connecting at once (a router's fan-out, a load generator): the
    standard library's backlog of 5 lets a busy process's kernel drop or
    reset the connections beyond it before the accept thread runs."""
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-serve/0.1"
    protocol_version = "HTTP/1.1"

    # engine telemetry is the observability story; per-request stderr
    # lines would swamp it under load
    def log_message(self, format, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(format, *args)

    @property
    def engine(self) -> InferenceEngine:
        return self.server.engine

    @property
    def registry(self):
        return self.server.registry

    def _engine_for(self, model):
        """Resolve the payload's ``model`` key to an engine. Unknown
        models raise MXNetError — the caller answers 503 so a
        model-aware router retries a replica that does serve it."""
        if self.registry is not None:
            return self.registry.get(model)
        if model is not None and model != self.engine.name:
            raise MXNetError(
                f"model {model!r} is not served here (serving: "
                f"[{self.engine.name!r}])")
        return self.engine

    def _engines(self):
        return (self.registry.engines() if self.registry is not None
                else [self.engine])

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, doc: dict):
        self._reply(code, json.dumps(doc).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            stats = [e.stats() for e in self._engines()]
            running = all(s["running"] for s in stats) and bool(stats)
            code = 200 if running else 503
            doc = {
                "ok": running,
                "draining": any(s["draining"] for s in stats),
                # multi-model replicas sum capacity and report the WORST
                # per-engine load: the router's least-loaded dispatch
                # must not route toward a replica whose requested model
                # is saturated just because another engine sits idle
                "slots": sum(s["slots"] for s in stats),
                "slots_in_use": sum(s["slots_in_use"] for s in stats),
                "queue_depth": sum(s["queue_depth"] for s in stats),
                "load": max((s["load"] for s in stats), default=0.0),
                "paged": any(s["paged"] for s in stats),
                # the model-aware dispatch + rollout-tracking handshake
                "models": {s["name"]: s["weight_version"] for s in stats},
                # mxhealth verdict of each served weight set (from the
                # publish meta, stashed by WeightRefresher; None = no
                # tag — weights that never went through the health-
                # tagged publish path)
                "models_health": {
                    getattr(e, "name", "default"):
                        getattr(e, "weight_health", None)
                    for e in self._engines()},
                # silent buffer truncation must be visible from the
                # router: nonzero means /trace output / chrome traces
                # are incomplete on this replica (evicted = whole traces
                # rotated out by the LRU bound — a 404 for a recently
                # issued trace id reads off that one)
                "dropped_trace_events": _trace.dropped_trace_events(),
                "evicted_traces": _trace.evicted_traces(),
                "profiler_dropped_events": _profiler.dropped_events(),
            }
            paged = [s for s in stats if s["paged"]]
            if paged:
                doc["pages"] = sum(s["pages"]["pages"] for s in paged)
                doc["pages_in_use"] = sum(s["pages"]["pages_in_use"]
                                          for s in paged)
                # bounded prefix-cache advert (serve_prefix_advert knob)
                # for the router's affinity scoring; single-model is the
                # common shape, so the first paged engine speaks for the
                # replica
                doc["prefix_summary"] = paged[0].get(
                    "prefix_summary", {"page_size": 0, "roots": []})
            # prefill/decode tier membership (None = untiered replica —
            # eligible for either role)
            doc["tier"] = next((s["tier"] for s in stats
                                if s.get("tier")), None)
            self._reply_json(code, doc)
        elif self.path == "/models":
            # the registry view: what this replica serves, at which
            # weight version, with full per-engine stats
            self._reply_json(200, {"models": {
                s["name"]: {"weight_version": s["weight_version"],
                            "stats": s}
                for s in (e.stats() for e in self._engines())}})
        elif self.path == "/metrics":
            self._reply(200, _metrics.expose().encode(),
                        "text/plain; version=0.0.4")
        elif self.path == "/metrics/json":
            # machine-readable registry dump — what the router's fleet
            # aggregation scrapes (observability.aggregate)
            self._reply(200, _metrics.dumps("json").encode(),
                        "application/json")
        elif self.path == "/perf":
            self._reply_json(501, {"error": _NOT_PORTED["/perf"]})
        elif self.path.startswith("/trace/"):
            tid = self.path[len("/trace/"):].strip("/")
            doc = _trace.export(tid)
            if doc is None:
                self._reply_json(404, {"error": f"no trace {tid!r}",
                                       "tracing_enabled": _trace.enabled()})
            else:
                self._reply_json(200, doc)
        else:
            self._reply_json(404, {"error": f"no such path: {self.path}"})

    def do_POST(self):
        if self.path == "/drain":
            # consume the body (keep-alive clients would otherwise see the
            # unread bytes parsed as their next request line), then stop
            # admitting NOW (the router fails over on the 503s); in-flight
            # slots finish on the engine loop so the reply is immediate
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            for eng in self._engines():
                eng.begin_drain()
            self._reply_json(200, {"ok": True, "draining": True})
            return
        if self.path == "/weights":
            self._post_weights()
            return
        if self.path in ("/cache/export", "/cache/import"):
            self._post_cache()
            return
        if self.path == "/score":
            self._post_score()
            return
        if self.path != "/generate":
            self._reply_json(404, {"error": f"no such path: {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            input_ids = payload["input_ids"]
            max_new_tokens = int(payload["max_new_tokens"])
            kwargs = {}
            for k, cast in (("temperature", float), ("top_k", int),
                            ("top_p", float), ("eos_token_id", int),
                            ("seed", int), ("timeout_s", float)):
                if payload.get(k) is not None:
                    kwargs[k] = cast(payload[k])
            # grammar rides through uncast: a regex string or a JSON-
            # schema object, compiled (and content-address cached) by
            # engine.submit
            if payload.get("grammar") is not None:
                kwargs["grammar"] = payload["grammar"]
            stream = bool(payload.get("stream", False))
            kwargs["stream"] = stream
            # W3C trace context: the router (or any client) parents the
            # request's span tree through this header
            tp = self.headers.get("traceparent")
            if tp is not None:
                kwargs["traceparent"] = tp
            model = payload.get("model")
            try:
                engine = self._engine_for(model)
            except MXNetError as e:
                # 503, not 404: a model-aware router retries a replica
                # that does advertise the model
                self._reply_json(503, {"error": str(e)})
                return
            handle = engine.submit(input_ids, max_new_tokens, **kwargs)
        except QueueFullError as e:
            self._reply_json(429, {"error": str(e)})
            return
        except EngineClosedError as e:
            self._reply_json(503, {"error": str(e)})
            return
        except (MXNetError, KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        if stream:
            self._reply_stream(handle)
            return
        res = handle.result()
        # deadline/cancel outcomes are successful partial responses (200);
        # an engine-side failure must surface to HTTP-level monitoring
        code = 500 if res.status == "error" else 200
        self._reply_result(code, res)

    def _reply_stream(self, handle):
        """Drain the handle's event queue onto the wire as Server-Sent
        Events. The engine thread feeds the queue from its retire path
        (one ``("token", id)`` per retired token, ``("done", result)``
        terminal), so frames track decode in real time; heartbeat
        comments cover quiet stretches. No Content-Length — the
        connection closes with the stream (``Connection: close`` also
        tells BaseHTTPRequestHandler not to expect another request)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        hb = float(getattr(self.server, "heartbeat_s", 10.0))
        index = 0
        try:
            while True:
                try:
                    kind, val = handle._events.get(timeout=hb)
                except _qmod.Empty:
                    # SSE comment line: keeps proxies/clients from
                    # idling the socket out between tokens
                    self.wfile.write(b": heartbeat\n\n")
                    self.wfile.flush()
                    continue
                if kind == "token":
                    doc = json.dumps({"token": val, "index": index})
                    index += 1
                    self.wfile.write(
                        b"event: token\ndata: " + doc.encode() + b"\n\n")
                    self.wfile.flush()
                else:   # ("done", ServeResult) — terminal frame
                    doc = json.dumps(self._result_doc(val))
                    self.wfile.write(
                        b"event: done\ndata: " + doc.encode() + b"\n\n")
                    self.wfile.flush()
                    return
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-stream: cancel so the slot frees at
            # the next decode tick instead of generating into the void
            handle.cancel()

    def _post_score(self):
        """Batched scoring: per-token logprobs of a given sequence in
        ONE prefill-shaped forward (engine.score) — no decode loop, no
        slot occupancy. Routes on the payload's ``model`` key like
        ``/generate``."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        try:
            engine = self._engine_for(payload.get("model"))
        except MXNetError as e:
            self._reply_json(503, {"error": str(e)})
            return
        try:
            self._reply_json(200, engine.score(payload["input_ids"]))
        except EngineClosedError as e:
            self._reply_json(503, {"error": str(e)})
        except (MXNetError, KeyError, TypeError, ValueError) as e:
            self._reply_json(400, {"error": str(e)})

    def _post_cache(self):
        """Cross-replica KV page transfer (serve/cachefleet.py's HTTP wire).
        ``/cache/export`` takes ``{"input_ids": [...]}`` and returns the
        kvstore wire doc for the longest cached prefix; ``/cache/import``
        takes that doc and adopts the verified pages into this replica's
        prefix cache. Both route on the payload's ``model`` key like
        ``/generate``."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        try:
            engine = self._engine_for(payload.get("model"))
        except MXNetError as e:
            self._reply_json(503, {"error": str(e)})
            return
        try:
            if self.path == "/cache/export":
                self._reply_json(200, engine.export_pages(payload["input_ids"]))
            else:
                self._reply_json(200, engine.import_pages(payload))
        except (MXNetError, KeyError, TypeError, ValueError) as e:
            self._reply_json(400, {"error": str(e)})

    def _post_weights(self):
        """Push-deploy: load a published weight version and hot-swap the
        target engine between decode ticks (zero downtime/recompiles).
        With no ``dir`` the model's configured weights directory is
        re-checked (the pull path, triggered now)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        model = payload.get("model")
        try:
            if payload.get("dir"):
                engine = self._engine_for(model)
                version = engine.swap_weights_from(
                    payload["dir"], payload.get("version"))
                self._reply_json(200, {"ok": True, "model": engine.name,
                                       "version": version})
            elif self.registry is not None:
                refreshed = self.registry.refresh(model)
                self._reply_json(200, {"ok": True, "refreshed": refreshed})
            else:
                self._reply_json(400, {
                    "error": "need 'dir' (no registry weights dir "
                             "configured on this replica)"})
        except (MXNetError, KeyError, TypeError, ValueError) as e:
            self._reply_json(400, {"error": str(e)})

    @staticmethod
    def _result_doc(res) -> dict:
        return {
            "status": res.status,
            "output_ids": res.output_ids,
            "generated_ids": res.generated_ids,
            "ttft_s": res.ttft_s,
            "queue_wait_s": res.queue_wait_s,
            "latency_s": res.latency_s,
            "error": res.error,
            "trace_id": res.trace_id,
        }

    def _reply_result(self, code: int, res):
        self._reply_json(code, self._result_doc(res))


class HTTPFrontend:
    """Threaded HTTP server bound to an :class:`InferenceEngine` — or to
    a :class:`~mxnet_tpu_torch.serve.registry.ModelRegistry`, in which case
    every registered model serves off this one port (``/generate``
    routes on the payload's ``model`` key).

    ``port=0`` binds an ephemeral port (tests); read it back from
    ``frontend.address``."""

    def __init__(self, engine, host: str = "127.0.0.1",
                 port: int = 8000, verbose: bool = False,
                 heartbeat_s: float = 10.0):
        registry = None
        if not isinstance(engine, InferenceEngine):
            registry, engine = engine, engine.get()
        self._httpd = BurstHTTPServer((host, port), _Handler)
        self._httpd.engine = engine
        self._httpd.registry = registry
        self._httpd.verbose = verbose
        # SSE quiet-stretch comment interval (POST /generate stream=true)
        self._httpd.heartbeat_s = float(heartbeat_s)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """(host, port) actually bound."""
        return self._httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "HTTPFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="mxnet-serve-http", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve_forever(engine, host: str = "127.0.0.1",
                  port: int = 8000, verbose: bool = False):
    """Blocking convenience for tools: start the engine (or model
    registry) if needed and serve until interrupted, then drain
    gracefully."""
    engine.start()
    frontend = HTTPFrontend(engine, host, port, verbose=verbose)
    try:
        frontend._httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend._httpd.server_close()
        engine.shutdown(drain=True)
