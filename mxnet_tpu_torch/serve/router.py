"""Multi-replica request router over N serving-engine HTTP replicas
(counterpart of ``mxnet_tpu/serve/router.py``, decision for decision).

N single-device ``InferenceEngine`` replicas each serve ``/generate``
behind an ``HTTPFrontend``; this stdlib-only router fans client traffic
across them.

- **Least-loaded dispatch.** Every health poll reads each replica's
  ``/healthz`` ``load`` (the worse of slot and page pressure plus the
  queue backlog), and dispatch picks the replica minimizing ``load +
  local in-flight``. The in-flight term spreads choices between polls;
  ``mxnet_router_rebalances_total`` counts dispatches where the load
  signal moved the choice off the previously preferred replica.
- **Eject / rejoin.** A failed poll, a connection error, a 5xx or
  ``draining: true`` ejects the replica
  (``mxnet_router_ejects_total{backend, reason=poll_fail|5xx|draining}``);
  the health loop keeps polling ejected replicas and re-admits them when
  ``/healthz`` is healthy again (``mxnet_router_rejoins_total``).
- **Drain.** ``Router.drain(url)`` POSTs the replica's ``/drain`` and
  ejects it at once: requests routed there finish, new ones fail over.
- **Retries.** A dispatch that fails at the transport, with a retriable
  status (429, 5xx), or that a drain bounced before it completed (status
  ``shutdown``, even with partial preemption tokens: none reached the
  client, and the stateless sampling streams make a replay regenerate the
  same output) goes to the next-least-loaded replica
  (``mxnet_router_retries_total``), each replica tried at most once per
  request; 4xx client errors pass through.
- **Streaming and scoring.** ``generate_stream`` proxies a replica's SSE
  stream frame by frame with the same failover and drain-bounce replay,
  but only before the first token frame reaches the client; after that,
  delivery is exactly once and a failure ends the stream with an ``event:
  done`` error frame. ``score`` forwards ``POST /score`` with the
  ordinary failover.
- **Tracing.** A ``router.request`` span with one ``router.dispatch``
  child per attempt, and the same W3C ``traceparent`` injected into every
  retry: one trace id follows a request across failovers, and
  ``get_trace`` merges the router's spans with every replica's view of
  the id (``observability.trace.assemble``).
- **Model-aware dispatch.** Replicas advertise ``models: {name: weight
  version}`` on ``/healthz`` (serve/registry.py); a request with a
  ``model`` key dispatches only to replicas serving it (no map = every
  model). An unserved model raises :class:`NoBackendError`.
- **Prefix-affinity dispatch** (``affinity=True``, serve/cachefleet.py).
  Paged replicas advertise their prefix-cache roots on ``/healthz``; the
  router hashes each request's ``input_ids`` with the same chain
  (``serve.paging.prefix_key``) and routes to the replica holding the
  longest matching prefix, if its ``load + inflight`` stays within
  ``affinity_max_load``. A malformed advert counts as absent (the replica
  stays in rotation); drain-bounced replays score the surviving rotation
  again. ``tier=`` restricts the rotation to one prefill/decode tier;
  untiered replicas serve any tier.
- **Tenant fair share.** With ``tenants=``, every request's ``tenant`` key
  passes weighted fair queueing and quota admission (serve/registry.py
  :class:`~mxnet_tpu_torch.serve.registry.TenantScheduler`) before
  dispatch, capped at the healthy fleet's slot count; a quota overflow
  raises :class:`~mxnet_tpu_torch.serve.registry.QuotaExceededError`
  (HTTP 429).
- **Membership.** ``add_backend``/``remove_backend`` let the autoscale
  controller (serve/fleet.py) grow and shrink the rotation; health polls
  run per replica on a jittered cadence with exponential backoff on
  failures.
- **Fleet metrics and SLOs.** ``fleet_metrics`` merges every replica's
  registry (observability.aggregate) and, with ``slo_targets``, refreshes
  the TTFT / inter-token SLO tracker (``mxnet_slo_*``).

Not ported yet: ``fleet_perf`` and the frontend's ``GET /perf`` (the cost
ledger waits for ``observability/`` with a design for the card, ROADMAP
Queue 1 item 8): the method raises and the endpoint answers 501.

Pure stdlib logic (urllib and threading): the router does no numerical
work and never touches a device, so it may share a host, or a process,
with the replicas it routes to.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional

from .. import metrics as _metrics
from ..analysis import guards as _guards
from ..base import MXNetError
from ..observability import aggregate as _aggregate
from ..observability import trace as _trace
from .http import BurstHTTPServer
from .paging import prefix_key
from .registry import QuotaExceededError, TenantPolicy, TenantScheduler

__all__ = ["Router", "RouterFrontend", "NoBackendError"]

# HTTP statuses worth failing over for: backpressure (429) and every
# replica-side failure (any 5xx — incl. 504 from a proxy in front of the
# replica). 4xx (bad request) would fail identically everywhere — pass
# it through.
def _retriable(code: int) -> bool:
    return code == 429 or code >= 500


def _sse_frame(block: bytes):
    """Parse one SSE frame (the lines between blank separators) into
    ``(event name, decoded JSON data)`` — either may be None (heartbeat
    comments have neither; malformed data decodes to None rather than
    killing the stream)."""
    kind = None
    data = None
    for ln in block.splitlines():
        if ln.startswith(b"event:"):
            kind = ln[6:].strip().decode("utf-8", "replace")
        elif ln.startswith(b"data:"):
            try:
                data = json.loads(ln[5:].strip() or b"null")
            except ValueError:
                data = None
    return kind, data


def _done_frame(doc: dict) -> bytes:
    return b"event: done\ndata: " + json.dumps(doc).encode() + b"\n\n"


#: the answer of the router's ``fleet_perf`` and ``GET /perf``
_PERF_NOT_PORTED = ("the fleet cost ledger (GET /perf, Router.fleet_perf) is not "
                    "ported yet: it waits for observability/ with a design for the "
                    "card (ROADMAP Queue 1 item 8)")


class NoBackendError(MXNetError):
    """No healthy replica is available for dispatch."""


@dataclasses.dataclass
class _Backend:
    url: str
    healthy: bool = False
    draining: bool = False
    load: float = 0.0
    inflight: int = 0
    fails: int = 0
    ejected: bool = False      # was in rotation, then removed (rejoin arms)
    last_seen: float = 0.0
    drained_at: float = 0.0    # monotonic stamp of the last drain() call
    # model-aware dispatch: {model name: weight version} off /healthz;
    # None = the replica does not advertise (pre-registry replica), which
    # keeps it eligible for every model (back-compat)
    models: Optional[Dict[str, int]] = None
    slots: int = 0             # decode capacity, the tenant-WFQ denominator
    # per-replica poll schedule: jittered interval on success,
    # exponential backoff on failure (0 = healthy cadence)
    next_poll: float = 0.0
    poll_backoff: float = 0.0
    # prefix-affinity advert off /healthz: [(chain key, prefix len)]
    # sorted longest-first, or None = no advert (non-paged replica, old
    # replica, or a malformed summary — treated as absent, never as a
    # health failure)
    prefix_summary: Optional[List] = None
    # prefill/decode tier membership; None = untiered (eligible for any
    # tier-targeted dispatch — back-compat)
    tier: Optional[str] = None
    # replica-side buffer truncation, read off /healthz every poll:
    # nonzero means that replica's traces / chrome profiles are incomplete
    dropped_trace_events: int = 0
    profiler_dropped_events: int = 0


class Router:
    """Least-loaded request router over serving-replica URLs.

    ``start()`` probes every backend once synchronously (so the first
    dispatch has a rotation) and launches the background health loop;
    ``generate(payload)`` dispatches one ``/generate`` request with
    failover. Thread-safe: any number of client threads may dispatch
    concurrently.
    """

    def __init__(self, backends: List[str], health_interval: float = 1.0,
                 health_timeout: float = 5.0,
                 request_timeout: float = 600.0,
                 slo_targets: Optional[Dict[str, float]] = None,
                 slo_objective: float = 0.99,
                 health_jitter: float = 0.1,
                 health_backoff: float = 2.0,
                 health_backoff_max: Optional[float] = None,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 default_tenant_policy: Optional[TenantPolicy] = None,
                 tenant_timeout: Optional[float] = None,
                 affinity: bool = False,
                 affinity_max_load: float = 1.5):
        """``slo_targets`` (e.g. ``{"ttft": 0.5, "intertoken": 0.1}``,
        seconds) arms the fleet SLO tracker: every ``fleet_metrics()``
        scrape recomputes p99 estimates, violation totals and
        error-budget burn from the merged replica histograms
        (``mxnet_slo_*``; observability.aggregate.SLOTracker).

        Health polls run per replica on a jittered cadence
        (``health_interval`` ± ``health_jitter`` fraction, so N routers
        never align their probes) with exponential backoff on failed
        polls (factor ``health_backoff``, capped at
        ``health_backoff_max``, default 8× the interval) — a struggling
        replica is probed LESS, not more, exactly when probing it hurts.

        ``tenants`` (name → :class:`TenantPolicy`) arms weighted-fair
        multi-tenant admission: every ``generate`` whose payload carries
        a ``tenant`` key passes WFQ + quota admission before dispatch,
        with total in-flight capped at the healthy fleet's slot count.
        Unknown tenants get ``default_tenant_policy`` (default: weight
        1, no quota); waits beyond ``tenant_timeout`` (default: the
        request timeout) raise :class:`QuotaExceededError` → HTTP 429.

        ``affinity=True`` arms prefix-affinity dispatch: replicas
        advertise their prefix-cache roots (chained token hashes, top-N
        by refcount) on ``/healthz``; the router hashes each request's
        ``input_ids`` with the same chained discipline and, among
        replicas whose ``load + inflight`` stays under
        ``affinity_max_load``, picks the one with the most expected
        prefix-hit tokens. Over-bound cache holders fall back to
        least-loaded (outcome ``load_bounded``), and a prompt nobody
        holds dispatches least-loaded (outcome ``cold``) — sticky, but
        a hot replica can never starve a cold one. Outcomes:
        ``mxnet_cache_affinity_dispatch_total{outcome}``."""
        if not backends:
            raise MXNetError("Router needs at least one backend URL")
        self._backends: Dict[str, _Backend] = {
            u.rstrip("/"): _Backend(u.rstrip("/")) for u in backends}
        self.health_interval = float(health_interval)
        self.health_timeout = float(health_timeout)
        self.request_timeout = float(request_timeout)
        self.health_jitter = max(0.0, float(health_jitter))
        self.health_backoff = max(1.0, float(health_backoff))
        self.health_backoff_max = (float(health_backoff_max)
                                   if health_backoff_max is not None
                                   else 8.0 * self.health_interval)
        self._tenants = (TenantScheduler(
            tenants, default_policy=default_tenant_policy,
            capacity_fn=self._fleet_slots)
            if (tenants or default_tenant_policy) else None)
        self.tenant_timeout = (float(tenant_timeout)
                               if tenant_timeout is not None
                               else float(request_timeout))
        self.affinity = bool(affinity)
        self.affinity_max_load = float(affinity_max_load)
        self._slo = (_aggregate.SLOTracker(slo_targets,
                                           objective=slo_objective)
                     if slo_targets else None)
        self._lock = _guards.make_lock("serve.Router._lock")
        self._running = False
        # interruptible sleep for the health loop: stop() (and tests
        # freezing the health view) must not wait out a long interval
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_choice: Optional[str] = None
        self._dispatches = 0
        self._retries = 0
        self._ejects = 0
        self._rejoins = 0
        self._rebalances = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Router":
        for b in list(self._backends.values()):
            self._probe(b)
        self._running = True
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._health_loop,
                                        name="mxnet-router-health",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(self.health_timeout + 1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ health
    def _fetch_health(self, url: str) -> dict:
        try:
            with urllib.request.urlopen(url + "/healthz",
                                        timeout=self.health_timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # a draining replica answers 503 WITH a JSON body
            # ({"draining": true, "load": ...}) — parse it so the eject
            # records a graceful drain, not a crash (non-JSON bodies
            # raise ValueError into the caller's failure path)
            with e:
                return json.loads(e.read())

    def _schedule_next_poll(self, b: _Backend, ok: bool, now: float):
        """Per-replica cadence: jittered ``health_interval`` while the
        replica answers; exponential backoff while it does not — a
        fixed cadence amplifies pressure exactly when a replica is
        overloaded, and N aligned probers make it worse (the jitter
        de-synchronizes routers sharing a fleet)."""
        if ok:
            b.poll_backoff = 0.0
            delay = self.health_interval
        else:
            b.poll_backoff = min(
                self.health_backoff_max,
                max(self.health_interval, b.poll_backoff)
                * self.health_backoff)
            delay = b.poll_backoff
        if self.health_jitter:
            delay *= 1.0 + random.uniform(0.0, self.health_jitter)
        b.next_poll = now + delay

    def _fleet_slots(self) -> int:
        """Healthy fleet decode capacity — the tenant scheduler's total
        in-flight cap (0 = unknown, treated as uncapped)."""
        with self._lock:
            return sum(b.slots for b in self._backends.values()
                       if b.healthy)

    def _probe(self, b: _Backend):
        """One health poll. The HTTP read happens OUTSIDE the router
        lock; only the state transition is serialized."""
        t_start = time.monotonic()
        dropped = None
        models = None
        slots = None
        psum = None
        tier = None
        try:
            doc = self._fetch_health(b.url)
            ok = bool(doc.get("ok")) and not doc.get("draining")
            load = float(doc.get("load") or 0.0)
            draining = bool(doc.get("draining"))
            if isinstance(doc.get("models"), dict):
                models = {str(k): int(v)
                          for k, v in doc["models"].items()}
            slots = int(doc.get("slots") or 0)
            dropped = (int(doc.get("dropped_trace_events") or 0),
                       int(doc.get("profiler_dropped_events") or 0))
            if isinstance(doc.get("tier"), str) and doc["tier"]:
                tier = doc["tier"]
            # the prefix-affinity advert rides the same poll but gets its
            # OWN guard: a malformed summary is an affinity hint lost,
            # not a health failure — the replica must stay in rotation
            try:
                raw = doc.get("prefix_summary")
                if isinstance(raw, dict):
                    roots = [(int(key), int(ln))
                             for key, ln, *_ in raw.get("roots", ())
                             if int(ln) > 0]
                    roots.sort(key=lambda r: -r[1])
                    psum = roots[:64] or None
            except (ValueError, TypeError, KeyError):
                psum = None
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError, TypeError):
            # HTTPException covers a replica dying mid-response
            # (BadStatusLine/IncompleteRead), which urllib does NOT wrap —
            # a health poll must never kill the health loop
            ok, load, draining = False, 0.0, False
        with self._lock:
            self._schedule_next_poll(b, ok, time.monotonic())
            if t_start < b.drained_at:
                # this poll read the replica BEFORE drain() ejected it: a
                # stale ok=true must not re-admit (or un-mark) a draining
                # replica — the next poll sees the post-drain truth
                return
            was = b.healthy
            b.load = load
            b.draining = draining
            b.last_seen = time.monotonic()
            if models is not None:
                b.models = models
            if slots is not None:
                b.slots = slots
            if dropped is not None:
                b.dropped_trace_events, b.profiler_dropped_events = dropped
            # unconditional: a failed/summary-less poll CLEARS the advert
            # (a restarted replica's stale roots must not attract traffic)
            b.prefix_summary = psum
            if tier is not None:
                b.tier = tier
            if ok and not was:
                b.healthy = True
                b.fails = 0
                if b.ejected:
                    b.ejected = False
                    self._rejoins += 1
                    _metrics.ROUTER_REJOINS.labels(backend=b.url).inc()
            elif not ok and was:
                self._eject_locked(b,
                                   "draining" if draining else "poll_fail")
            # unconditional: the FIRST healthy probe must move the gauge
            # off 0, not just ejections/rejoins
            _metrics.ROUTER_HEALTHY.set(self._healthy_count())

    def _health_loop(self):
        while self._running:
            now = time.monotonic()
            for b in list(self._backends.values()):
                if not self._running:
                    return
                if b.next_poll <= now:
                    self._probe(b)
            with self._lock:
                pending = [b.next_poll for b in self._backends.values()]
            # sleep until the earliest scheduled poll (bounded so a
            # freshly added backend is noticed within one interval)
            sleep = min(pending, default=0.0) - time.monotonic()
            self._stop_evt.wait(min(self.health_interval,
                                    max(0.02, sleep)))

    def _healthy_count(self) -> int:
        return sum(1 for b in self._backends.values() if b.healthy)

    def _eject_locked(self, b: _Backend, reason: str):
        """``reason`` ∈ poll_fail (healthz/transport failure), 5xx
        (dispatch-side replica failure), draining (graceful drain, incl.
        drain-bounced requests) — the labeled eject taxonomy."""
        b.healthy = False
        b.ejected = True
        b.fails += 1
        self._ejects += 1
        _metrics.ROUTER_EJECTS.labels(backend=b.url, reason=reason).inc()
        _metrics.ROUTER_HEALTHY.set(self._healthy_count())

    # ------------------------------------------------------------ membership
    def add_backend(self, url: str) -> None:
        """Add one replica to the rotation (the autoscale controller's
        scale-up half). Probed immediately so a healthy replica takes
        traffic before the next health-loop pass; idempotent."""
        url = url.rstrip("/")
        with self._lock:
            if url in self._backends:
                return
            b = self._backends[url] = _Backend(url)
        self._probe(b)

    def remove_backend(self, url: str) -> None:
        """Forget one replica entirely (after a drain completed — the
        scale-down half). Unknown URLs raise."""
        url = url.rstrip("/")
        with self._lock:
            if self._backends.pop(url, None) is None:
                raise MXNetError(f"unknown backend {url!r}")
            _metrics.ROUTER_HEALTHY.set(self._healthy_count())

    # ------------------------------------------------------------ dispatch
    @staticmethod
    def _hit_tokens(b: _Backend, prompt: List[int],
                    memo: Dict[int, int]) -> int:
        """Expected prefix-hit tokens on ``b`` for ``prompt``: the
        longest advertised root whose chain key matches the prompt's own
        chained hash at that length. ``memo`` caches the prompt's hashes
        across backends (one request scores the whole rotation). Capped
        at ``len(prompt) - 1`` — the engine always re-prefills at least
        the final token to produce first-token logits."""
        if not b.prefix_summary or len(prompt) < 2:
            return 0
        n = len(prompt)
        for key, ln in b.prefix_summary:        # longest-first
            if ln > n:
                continue
            k = memo.get(ln)
            if k is None:
                k = memo[ln] = prefix_key(prompt[:ln])
            if k == key:
                return min(ln, n - 1)
        return 0

    def _pick(self, exclude: set, model: Optional[str] = None,
              prompt: Optional[List[int]] = None,
              memo: Optional[Dict[int, int]] = None,
              tier: Optional[str] = None,
              info: Optional[dict] = None) -> _Backend:
        with self._lock:
            ready = [b for b in self._backends.values()
                     if b.healthy and b.url not in exclude
                     # model-aware: replicas that advertise a model map
                     # serve only those models; non-advertising replicas
                     # stay eligible for everything (back-compat)
                     and (model is None or b.models is None
                          or model in b.models)
                     # tier-targeted dispatch (prefill/decode
                     # disaggregation); untiered replicas serve any tier
                     and (tier is None or b.tier in (None, tier))]
            if not ready:
                what = (f"backend serving model {model!r}"
                        if model is not None else "backend")
                if tier is not None:
                    what = f"{tier}-tier {what}"
                raise NoBackendError(
                    f"no healthy {what} (of {len(self._backends)}; "
                    f"{len(exclude)} already tried this request)")
            best = None
            if self.affinity and prompt:
                # prefix-affinity: among cache holders under the load
                # bound, the most expected-hit tokens wins (ties: least
                # loaded). Over-bound holders and cold prompts fall back
                # to least-loaded — sticky, never starving.
                memo = {} if memo is None else memo
                scored = [(self._hit_tokens(b, prompt, memo), b)
                          for b in ready]
                scored = [(ht, b) for ht, b in scored if ht > 0]
                outcome = "cold"
                if scored:
                    bounded = [(ht, b) for ht, b in scored
                               if b.load + b.inflight
                               <= self.affinity_max_load]
                    if bounded:
                        ht, best = max(
                            bounded,
                            key=lambda x: (x[0], -(x[1].load
                                                   + x[1].inflight),
                                           x[1].url))
                        outcome = "hit"
                        _metrics.CACHE_AFFINITY_HIT_TOKENS.inc(ht)
                        if info is not None:
                            info["prefix_hit_tokens"] = ht
                    else:
                        outcome = "load_bounded"
                _metrics.CACHE_AFFINITY_DISPATCH.labels(
                    outcome=outcome).inc()
                if info is not None:
                    info["affinity"] = outcome
            if best is None:
                best = min(ready, key=lambda b: (b.load + b.inflight,
                                                 b.url))
            # rebalances track the LOAD signal only: the in-flight term
            # alternates dispatches across equally-loaded replicas by
            # design, and counting that would read ~dispatches/2 on a
            # perfectly balanced fleet
            load_best = min(ready, key=lambda b: (b.load, b.url)).url
            if (self._last_choice is not None
                    and load_best != self._last_choice
                    and any(b.url == self._last_choice for b in ready)):
                # the previously preferred replica is still in rotation:
                # the LOAD signal moved the choice, not an ejection
                self._rebalances += 1
                _metrics.ROUTER_REBALANCES.inc()
            self._last_choice = load_best
            best.inflight += 1
            self._dispatches += 1
            _metrics.ROUTER_DISPATCH.labels(backend=best.url).inc()
            return best

    def generate(self, payload: dict, timeout: Optional[float] = None,
                 traceparent: Optional[str] = None,
                 tier: Optional[str] = None) -> dict:
        """Dispatch one ``/generate`` request; returns the replica's JSON
        response. Transport failures and retriable statuses fail over to
        the next-least-loaded replica (each replica at most once);
        raises :class:`NoBackendError` when the rotation is exhausted.

        Tracing: a ``traceparent`` (the client's, or a fresh one when the
        router records traces) is injected into EVERY dispatch attempt —
        failover retries and drain-bounced replays carry the SAME trace
        id, so one ``/trace/{id}`` names the request across every replica
        that touched it. With router tracing disabled an incoming header
        is forwarded untouched (propagation without recording)."""
        body = json.dumps(payload).encode()
        timeout = self.request_timeout if timeout is None else timeout
        model = payload.get("model")
        # tenant fair-share admission happens ONCE per request, before
        # any dispatch: a bursting tenant queues here (WFQ + quota),
        # failover retries don't re-queue
        tenant = str(payload.get("tenant") or "default")
        if self._tenants is not None:
            self._tenants.acquire(tenant, timeout=self.tenant_timeout)
        try:
            return self._generate_dispatch(payload, body, timeout,
                                           traceparent, model, tier)
        finally:
            if self._tenants is not None:
                self._tenants.release(tenant)

    def _generate_dispatch(self, payload: dict, body: bytes,
                           timeout: float, traceparent: Optional[str],
                           model: Optional[str],
                           tier: Optional[str] = None) -> dict:
        root = _trace.start_span("router.request", parent=traceparent) \
            if _trace.ENABLED else None
        tried: set = set()
        last_err: Optional[str] = None
        # affinity inputs, computed once per request: the prompt tokens
        # and a hash memo shared across attempts — a drain-bounced replay
        # re-enters _pick and re-scores against the SURVIVING rotation's
        # adverts (the bounced replica is in ``tried``/ejected)
        prompt = None
        if self.affinity:
            ids = payload.get("input_ids")
            if isinstance(ids, (list, tuple)) and ids:
                try:
                    prompt = [int(t) for t in ids]
                except (ValueError, TypeError):
                    prompt = None
        memo: Dict[int, int] = {}
        try:
            while True:
                info: dict = {}
                b = self._pick(tried, model=model, prompt=prompt,
                               memo=memo, tier=tier, info=info)
                tried.add(b.url)
                aspan = (root.child("router.dispatch", backend=b.url,
                                    attempt=len(tried), tier=b.tier,
                                    prefix_hit_tokens=info.get(
                                        "prefix_hit_tokens", 0))
                         if root is not None else None)
                # the propagated identity: this attempt's span when the
                # router records, else the client's header verbatim.
                # Truthiness, not is-None: child() returns the falsy
                # NOOP (context None) if tracing was disabled mid-flight
                hdr = (aspan.context.traceparent() if aspan
                       else traceparent)
                headers = {"Content-Type": "application/json"}
                if hdr:
                    headers["traceparent"] = hdr
                req = urllib.request.Request(
                    b.url + "/generate", data=body, headers=headers)
                try:
                    with urllib.request.urlopen(req,
                                                timeout=timeout) as resp:
                        doc = json.loads(resp.read())
                    bounced = doc.get("status") == "shutdown"
                    with self._lock:
                        b.inflight -= 1
                        # a drain bounced the request before it completed
                        # (status 'shutdown' — possibly with partial
                        # tokens from a pool preemption, but NONE were
                        # delivered to the client: this discarded response
                        # was the only delivery channel, and the stateless
                        # sampling streams make a replay regenerate the
                        # same output, so failover is idempotent): treat
                        # like a replica failure and fail over
                        if bounced and b.healthy:
                            self._eject_locked(b, "draining")
                    if not bounced:
                        if aspan is not None:
                            aspan.end(status=doc.get("status"))
                        if root is not None:
                            root.end(status=doc.get("status"))
                            # requests through a non-tracing replica still
                            # get a pullable id (the router-side spans)
                            if not doc.get("trace_id"):
                                doc["trace_id"] = root.trace_id
                        return doc
                    last_err = f"{b.url}: draining"
                    if aspan is not None:
                        aspan.end(status="bounced")
                except urllib.error.HTTPError as e:
                    payload_doc = None
                    try:
                        payload_doc = json.loads(e.read())
                    except Exception:
                        pass
                    with self._lock:
                        b.inflight -= 1
                        if e.code >= 500:
                            # replica-side failure: out of rotation until
                            # the health loop sees it recover (429
                            # backpressure is NOT an ejection — the
                            # replica is healthy, just full)
                            if b.healthy:
                                self._eject_locked(b, "5xx")
                    if aspan is not None:
                        aspan.end(status=f"http_{e.code}")
                    if not _retriable(e.code):
                        doc = payload_doc or {"status": "error",
                                              "error": f"HTTP {e.code}"}
                        if root is not None:
                            root.end(status=f"http_{e.code}")
                            # failed requests are the ones worth
                            # tracing: hand back the router-side id
                            if not doc.get("trace_id"):
                                doc["trace_id"] = root.trace_id
                        return doc
                    last_err = f"{b.url}: HTTP {e.code}"
                except (urllib.error.URLError, http.client.HTTPException,
                        OSError, ValueError) as e:
                    # HTTPException/ValueError: the connection dropped
                    # mid-body or the 200 response was truncated JSON —
                    # same failover as a transport error, and the inflight
                    # counter MUST come back down or the backend is
                    # penalized forever
                    with self._lock:
                        b.inflight -= 1
                        if b.healthy:
                            self._eject_locked(b, "poll_fail")
                    if aspan is not None:
                        aspan.end(status="transport_error")
                    last_err = f"{b.url}: {e}"
                self._retries += 1
                _metrics.ROUTER_RETRIES.inc()
                with self._lock:
                    # count UNTRIED members of the current rotation, not
                    # len(tried) vs len(backends): under scale churn the
                    # tried set holds replicas that were since removed,
                    # and a replica added mid-request (a scale-up) must
                    # still get its attempt
                    remaining = [u for u in self._backends
                                 if u not in tried]
                if not remaining:
                    raise NoBackendError(
                        f"every backend failed this request "
                        f"(last: {last_err})")
        except NoBackendError:
            if root is not None:
                root.end(status="no_backend")
            raise

    # ------------------------------------------------------------ streaming
    def generate_stream(self, payload: dict,
                        timeout: Optional[float] = None,
                        traceparent: Optional[str] = None,
                        tier: Optional[str] = None):
        """Dispatch one streaming ``/generate`` (``stream: true`` forced
        into the payload) and yield the replica's SSE frames as raw
        bytes, frame by frame.

        Failover is EXACTLY-ONCE over delivered tokens: failures before
        any ``event: token`` frame reaches the caller — connect errors,
        retriable statuses, and drain bounces (``event: done`` carrying
        ``status: "shutdown"``) — eject the replica and replay on the
        next-least-loaded one, same as the non-streaming path (nothing
        was delivered, and the stateless sampling streams make the
        replay regenerate the same output). Once a token frame has been
        forwarded, failover is OFF: a later failure surfaces as a
        terminal ``event: done`` frame (status ``error``, or the bounced
        ``shutdown`` verbatim) so the caller never sees the same token
        index twice. Raises :class:`NoBackendError` only before the
        first frame; after that, exhaustion becomes a terminal error
        frame too. Closing the generator (client disconnect) drops the
        replica connection, which cancels the replica-side request."""
        payload = dict(payload)
        payload["stream"] = True
        body = json.dumps(payload).encode()
        timeout = self.request_timeout if timeout is None else timeout
        model = payload.get("model")
        tenant = str(payload.get("tenant") or "default")
        if self._tenants is not None:
            self._tenants.acquire(tenant, timeout=self.tenant_timeout)
        try:
            yield from self._stream_dispatch(payload, body, timeout,
                                             traceparent, model, tier)
        finally:
            if self._tenants is not None:
                self._tenants.release(tenant)

    def _stream_dispatch(self, payload: dict, body: bytes, timeout: float,
                         traceparent: Optional[str], model: Optional[str],
                         tier: Optional[str]):
        root = _trace.start_span("router.request", parent=traceparent) \
            if _trace.ENABLED else None
        tried: set = set()
        last_err: Optional[str] = None
        any_yielded = False     # headers committed caller-side: no raise
        prompt = None
        if self.affinity:
            ids = payload.get("input_ids")
            if isinstance(ids, (list, tuple)) and ids:
                try:
                    prompt = [int(t) for t in ids]
                except (ValueError, TypeError):
                    prompt = None
        memo: Dict[int, int] = {}
        while True:
            info: dict = {}
            try:
                b = self._pick(tried, model=model, prompt=prompt,
                               memo=memo, tier=tier, info=info)
            except NoBackendError as e:
                if root is not None:
                    root.end(status="no_backend")
                if any_yielded:
                    yield _done_frame({"status": "error", "error": str(e)})
                    return
                raise
            tried.add(b.url)
            aspan = (root.child("router.dispatch", backend=b.url,
                                attempt=len(tried), tier=b.tier)
                     if root is not None else None)
            hdr = (aspan.context.traceparent() if aspan else traceparent)
            headers = {"Content-Type": "application/json"}
            if hdr:
                headers["traceparent"] = hdr
            req = urllib.request.Request(
                b.url + "/generate", data=body, headers=headers)
            try:
                resp = urllib.request.urlopen(req, timeout=timeout)
            except urllib.error.HTTPError as e:
                payload_doc = None
                try:
                    payload_doc = json.loads(e.read())
                except Exception:
                    pass
                with self._lock:
                    b.inflight -= 1
                    if e.code >= 500 and b.healthy:
                        self._eject_locked(b, "5xx")
                if aspan is not None:
                    aspan.end(status=f"http_{e.code}")
                if not _retriable(e.code):
                    doc = payload_doc or {"status": "error",
                                          "error": f"HTTP {e.code}"}
                    if root is not None:
                        root.end(status=f"http_{e.code}")
                        if not doc.get("trace_id"):
                            doc["trace_id"] = root.trace_id
                    yield _done_frame(doc)
                    return
                last_err = f"{b.url}: HTTP {e.code}"
            except (urllib.error.URLError, http.client.HTTPException,
                    OSError, ValueError) as e:
                with self._lock:
                    b.inflight -= 1
                    if b.healthy:
                        self._eject_locked(b, "poll_fail")
                if aspan is not None:
                    aspan.end(status="transport_error")
                last_err = f"{b.url}: {e}"
            else:
                forwarded = False   # a token frame reached the caller
                bounced = False
                failed: Optional[str] = None
                try:
                    with resp:
                        block: List[bytes] = []
                        while True:
                            try:
                                line = resp.readline()
                            except (http.client.HTTPException, OSError,
                                    ValueError) as e:
                                failed = str(e) or type(e).__name__
                                break
                            if not line:
                                failed = "stream closed before done"
                                break
                            if line.strip():
                                block.append(line)
                                continue
                            if not block:
                                continue
                            kind, data = _sse_frame(b"".join(block))
                            frame = b"".join(block) + b"\n"
                            block = []
                            if kind == "done":
                                doc = (data if isinstance(data, dict)
                                       else {})
                                if doc.get("status") == "shutdown":
                                    if not forwarded:
                                        # drain bounce before any token:
                                        # replay elsewhere
                                        bounced = True
                                        break
                                    # tokens already on the wire:
                                    # exactly-once forbids replay — the
                                    # bounce IS the terminal frame
                                    with self._lock:
                                        b.inflight -= 1
                                        if b.healthy:
                                            self._eject_locked(
                                                b, "draining")
                                    if aspan is not None:
                                        aspan.end(status="bounced")
                                    if root is not None:
                                        root.end(status="shutdown")
                                    yield frame
                                    return
                                if (root is not None
                                        and not doc.get("trace_id")):
                                    doc["trace_id"] = root.trace_id
                                    frame = _done_frame(doc)
                                with self._lock:
                                    b.inflight -= 1
                                if aspan is not None:
                                    aspan.end(status=doc.get("status"))
                                if root is not None:
                                    root.end(status=doc.get("status"))
                                any_yielded = True
                                yield frame
                                return
                            if kind == "token":
                                forwarded = True
                            any_yielded = True
                            yield frame
                except GeneratorExit:
                    # caller closed mid-stream (client disconnect): the
                    # with-block closes the replica socket, which the
                    # replica's SSE writer sees as a broken pipe →
                    # handle.cancel() frees the slot
                    with self._lock:
                        b.inflight -= 1
                    if aspan is not None:
                        aspan.end(status="client_gone")
                    if root is not None:
                        root.end(status="client_gone")
                    raise
                # stream ended without a clean done frame
                with self._lock:
                    b.inflight -= 1
                    if b.healthy:
                        self._eject_locked(
                            b, "draining" if bounced else "poll_fail")
                if bounced:
                    if aspan is not None:
                        aspan.end(status="bounced")
                    last_err = f"{b.url}: draining"
                else:
                    if aspan is not None:
                        aspan.end(status="transport_error")
                    if forwarded:
                        # tokens delivered: no replay — surface the break
                        doc = {"status": "error",
                               "error": f"{b.url}: {failed}"}
                        if root is not None:
                            root.end(status="stream_error")
                            doc["trace_id"] = root.trace_id
                        yield _done_frame(doc)
                        return
                    last_err = f"{b.url}: {failed}"
            self._retries += 1
            _metrics.ROUTER_RETRIES.inc()
            with self._lock:
                remaining = [u for u in self._backends if u not in tried]
            if not remaining:
                if root is not None:
                    root.end(status="no_backend")
                err = (f"every backend failed this request "
                       f"(last: {last_err})")
                if any_yielded:
                    yield _done_frame({"status": "error", "error": err})
                    return
                raise NoBackendError(err)

    # ------------------------------------------------------------ score
    def score(self, payload: dict, timeout: Optional[float] = None,
              traceparent: Optional[str] = None) -> dict:
        """Dispatch one ``/score`` request with the same failover
        discipline as ``/generate`` (transport failures and retriable
        statuses try the next replica, each at most once; 4xx client
        errors pass through as their JSON body). Scoring is a single
        forward with no streaming or partial delivery, so every failure
        before the response is replayable."""
        body = json.dumps(payload).encode()
        timeout = self.request_timeout if timeout is None else timeout
        model = payload.get("model")
        tried: set = set()
        last_err: Optional[str] = None
        while True:
            b = self._pick(tried, model=model)
            tried.add(b.url)
            headers = {"Content-Type": "application/json"}
            if traceparent:
                headers["traceparent"] = traceparent
            req = urllib.request.Request(
                b.url + "/score", data=body, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    doc = json.loads(resp.read())
                with self._lock:
                    b.inflight -= 1
                return doc
            except urllib.error.HTTPError as e:
                payload_doc = None
                try:
                    payload_doc = json.loads(e.read())
                except Exception:
                    pass
                with self._lock:
                    b.inflight -= 1
                    if e.code >= 500 and b.healthy:
                        self._eject_locked(b, "5xx")
                if not _retriable(e.code):
                    return payload_doc or {"error": f"HTTP {e.code}"}
                last_err = f"{b.url}: HTTP {e.code}"
            except (urllib.error.URLError, http.client.HTTPException,
                    OSError, ValueError) as e:
                with self._lock:
                    b.inflight -= 1
                    if b.healthy:
                        self._eject_locked(b, "poll_fail")
                last_err = f"{b.url}: {e}"
            self._retries += 1
            _metrics.ROUTER_RETRIES.inc()
            with self._lock:
                remaining = [u for u in self._backends if u not in tried]
            if not remaining:
                raise NoBackendError(
                    f"every backend failed this request "
                    f"(last: {last_err})")

    # ------------------------------------------------------------ drain
    def drain(self, url: str, timeout: float = 10.0) -> dict:
        """Gracefully drain one replica: POST its ``/drain`` and eject it
        from the rotation immediately. In-flight requests routed there
        finish; the health loop re-admits the replica when (if) it comes
        back healthy."""
        url = url.rstrip("/")
        b = self._backends.get(url)
        if b is None:
            raise MXNetError(f"unknown backend {url!r}")
        req = urllib.request.Request(url + "/drain", data=b"{}",
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                doc = json.loads(resp.read())
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError) as e:
            doc = {"ok": False, "error": str(e)}
        with self._lock:
            if b.healthy:
                self._eject_locked(b, "draining")
            b.draining = True
            # in-flight health polls that read the replica before the
            # drain carry a stale ok=true — stamp so _probe discards them
            b.drained_at = time.monotonic()
        return doc

    # ------------------------------------------------------------ fleet view
    def _fetch_all(self, path: str, timeout: float) -> Dict[str, Any]:
        """GET ``path`` from every backend concurrently; returns
        {url: parsed JSON} for the ones that answered. One dead replica
        costs ~one timeout, not one per backend, and stragglers that
        outlive the join cannot mutate the returned snapshot."""
        out: Dict[str, Any] = {}
        lock = threading.Lock()

        def fetch(url: str):
            try:
                with urllib.request.urlopen(url + path,
                                            timeout=timeout) as resp:
                    doc = json.loads(resp.read())
            except (urllib.error.URLError, http.client.HTTPException,
                    OSError, ValueError):
                return
            with lock:
                out[url] = doc
        fetchers = [threading.Thread(target=fetch, args=(b.url,),
                                     daemon=True)
                    for b in list(self._backends.values())]
        for t in fetchers:
            t.start()
        for t in fetchers:
            t.join(timeout + 1.0)
        with lock:
            return dict(out)

    def fleet_metrics(self, timeout: float = 2.0) -> str:
        """One Prometheus exposition for the WHOLE fleet: every
        reachable replica's ``/metrics/json`` merged (counters summed,
        histogram buckets merged, plus per-``backend``-labeled samples)
        with the router's own registry riding along as
        ``backend="router"``. With SLO targets configured, each scrape
        first refreshes the ``mxnet_slo_*`` gauges/counters from the
        merged latency histograms. Unreachable replicas are skipped —
        a scrape never fails because one replica is down."""
        docs = self._fetch_all("/metrics/json", timeout)
        # one aggregation pass: the SLO tracker reads the fleet-total
        # latency histograms (the router process serves nothing, so its
        # registry adds no latency samples), then the local registry —
        # carrying the freshly updated slo gauges — merges in for the
        # rendered scrape
        merged = _aggregate.aggregate(docs) if docs else {}
        if self._slo is not None and docs:
            self._slo.update(merged)
        local = {"router": json.loads(_metrics.dumps("json"))}
        return _aggregate.render_prometheus(
            _aggregate.aggregate(local, into=merged))

    def fleet_perf(self, timeout: float = 2.0) -> dict:
        """The fleet cost-attribution view of the JAX router: not ported
        yet (``GET /perf`` answers 501 on every replica of this package)."""
        raise MXNetError(_PERF_NOT_PORTED)

    def get_trace(self, trace_id: str, timeout: float = 2.0
                  ) -> Optional[dict]:
        """Assemble one trace across the fleet: the router's own spans
        (dispatch attempts) merged with every replica's ``/trace/{id}``
        view of the same trace id. Replicas are polled concurrently —
        a dead replica (common right after the failover you are
        debugging) costs ~one timeout, not one per backend."""
        spans = []
        local = _trace.export(trace_id)
        if local is not None:
            spans.extend(local["spans"])
        for doc in self._fetch_all(f"/trace/{trace_id}",
                                   timeout).values():
            spans.extend(doc.get("spans", ()))
        if not spans:
            return None
        return _trace.assemble(trace_id, spans)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            out = {
                "backends": {
                    b.url: {"healthy": b.healthy, "draining": b.draining,
                            "load": b.load, "inflight": b.inflight,
                            "fails": b.fails,
                            "models": b.models, "slots": b.slots,
                            "tier": b.tier,
                            "prefix_roots": len(b.prefix_summary or ()),
                            "poll_backoff": round(b.poll_backoff, 3),
                            "dropped_trace_events":
                                b.dropped_trace_events,
                            "profiler_dropped_events":
                                b.profiler_dropped_events}
                    for b in self._backends.values()},
                "healthy": self._healthy_count(),
                "dispatches": self._dispatches,
                "retries": self._retries,
                "ejects": self._ejects,
                "rejoins": self._rejoins,
                "rebalances": self._rebalances,
            }
        if self._tenants is not None:
            out["tenants"] = self._tenants.stats()
        if self._slo is not None:
            out["slo"] = {"targets": dict(self._slo.targets),
                          "objective": self._slo.objective,
                          "last": self._slo.last}
        return out


class RouterFrontend:
    """Stdlib HTTP frontend exposing a :class:`Router` to clients:
    ``POST /generate`` proxies with failover (``stream: true`` payloads
    proxy the replica's SSE stream frame-by-frame, with pre-first-token
    drain-bounce replay and exactly-once delivery after —
    :meth:`Router.generate_stream`), ``POST /score`` proxies batched
    scoring with the same failover, ``GET /healthz`` aggregates the
    fleet, ``POST /drain`` (JSON ``{"backend": url}``) drains one
    replica, ``GET /metrics`` exposes the router process's counters."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 8080, verbose: bool = False):
        self._httpd = BurstHTTPServer((host, port), _RouterHandler)
        self._httpd.router = router
        self._httpd.verbose = verbose
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "RouterFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="mxnet-router-http",
                                        daemon=True)
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


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-router/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(format, *args)

    @property
    def router(self) -> Router:
        return self.server.router

    def _reply_json(self, code: int, doc: dict):
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            st = self.router.stats()
            code = 200 if st["healthy"] else 503
            self._reply_json(code, {"ok": st["healthy"] > 0, **st})
        elif self.path == "/metrics":
            # the fleet view: merged replica registries (summed counters,
            # merged histogram buckets, per-backend labels) + SLO state
            body = self.router.fleet_metrics().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/metrics/local":
            # the router process's own registry, unmerged
            body = _metrics.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/perf":
            self._reply_json(501, {"error": _PERF_NOT_PORTED})
        elif self.path.startswith("/trace/"):
            tid = self.path[len("/trace/"):].strip("/")
            doc = self.router.get_trace(tid)
            if doc is None:
                self._reply_json(404, {"error": f"no trace {tid!r}"})
            else:
                self._reply_json(200, doc)
        else:
            self._reply_json(404, {"error": f"no such path: {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        if self.path == "/drain":
            try:
                doc = self.router.drain(payload["backend"])
            except (MXNetError, KeyError) as e:
                self._reply_json(400, {"error": str(e)})
                return
            self._reply_json(200, doc)
        elif self.path == "/generate":
            if payload.get("stream"):
                self._proxy_stream(payload)
                return
            try:
                doc = self.router.generate(
                    payload, traceparent=self.headers.get("traceparent"))
            except QuotaExceededError as e:
                # tenant admission backpressure, not fleet failure
                self._reply_json(429, {"error": str(e)})
                return
            except NoBackendError as e:
                self._reply_json(503, {"error": str(e)})
                return
            code = 500 if doc.get("status") == "error" else 200
            self._reply_json(code, doc)
        elif self.path == "/score":
            try:
                doc = self.router.score(
                    payload, traceparent=self.headers.get("traceparent"))
            except NoBackendError as e:
                self._reply_json(503, {"error": str(e)})
                return
            self._reply_json(400 if doc.get("error") else 200, doc)
        else:
            self._reply_json(404, {"error": f"no such path: {self.path}"})

    def _proxy_stream(self, payload: dict):
        """SSE passthrough: pull the FIRST frame before committing
        headers, so pre-stream failures (no backend, tenant quota) still
        map to proper HTTP statuses; from then on forward frames as the
        replica produces them. A client disconnect closes the generator,
        which drops the replica connection (→ replica-side cancel)."""
        gen = self.router.generate_stream(
            payload, traceparent=self.headers.get("traceparent"))
        try:
            first = next(gen)
        except QuotaExceededError as e:
            self._reply_json(429, {"error": str(e)})
            return
        except NoBackendError as e:
            self._reply_json(503, {"error": str(e)})
            return
        except StopIteration:
            self._reply_json(502, {"error": "backend produced no stream"})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            self.wfile.write(first)
            self.wfile.flush()
            for frame in gen:
                self.wfile.write(frame)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            gen.close()
