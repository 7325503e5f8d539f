"""The cache-aware fleet: route work to where the KV lives (counterpart of
``mxnet_tpu/serve/cachefleet.py``).

The per-replica prefix cache (serve/paging.py) and least-loaded dispatch
(serve/router.py) pull apart: the cache makes a replica's KV pages
valuable, and least-loaded dispatch scatters a prompt family away from
them, so the fleet prefills again tokens it has already computed. Three
composable pieces:

1. **Prefix-affinity routing** (serve/router.py, ``Router(affinity=True)``).
   Replicas advertise their prefix-cache roots on ``/healthz``; the router
   hashes each prompt with the same chain
   (:func:`~mxnet_tpu_torch.serve.paging.prefix_key`) and picks, among
   replicas whose ``load + inflight`` stays within ``affinity_max_load``,
   the one holding the longest matching prefix.

2. **Disaggregated prefill / decode tiers.** :class:`PrefillDecodePipeline`
   prefills a request on a prefill replica (a 1-token generate publishes
   the prompt's pages), ships the full pages to a decode replica over the
   kvstore page wire (``kvstore.comm.encode_kv_pages``: exact f32 / bf16
   payloads, each with the chain hash of the prefix it ends, verified on
   receipt) and runs the real generate there, where admission maps the
   migrated pages instead of prefilling them.
   :class:`TieredFleetController` runs one
   :class:`~mxnet_tpu_torch.serve.fleet.FleetController` per tier over the
   shared router, each on its tier's replicas, bounds and SLO axis.

3. **Page migration as preemption rescue** (:func:`install_preempt_rescue`).
   An ``OutOfPages`` preemption normally requeues the victim behind the
   congestion that evicted it. With the hook installed the engine exports
   the victim's leased pages (prompt and generated tokens) before releasing
   them, imports them into the least-loaded peer and resumes the request
   there (``submit(resume=)``): the stateless ``fold_in(seed, counter)``
   sampling streams make the continuation the uninterrupted run's, and
   the peer's result is piped back into the client's handle.

Failure model: every shipped page is verified on receipt (the chain hash
of the doc's tokens, then the payload's shape and dtype against the
importer's pool spec); a page that fails is dropped and counted
(``mxnet_migrate_verify_failures_total``), never written, and the importer
prefills what it did not adopt, so a corrupt transfer costs a cache miss,
not wrong tokens: ``pages_sent == pages_received + verify_failures``. A
failed rescue (``mxnet_migrate_rescues_total{outcome=failed}``) falls back
to the local requeue.

The engines copy the pages (``export_pages`` reads them with one
``index_select`` a pool, ``import_pages`` writes them in place between
ticks, so the captured decode graphs go on reading the same pools); the
decode over migrated pages runs the same kernels (K6, K7, K8) as over
pages a replica filled itself.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from .. import metrics as _metrics
from ..base import MXNetError, logger
from .engine import InferenceEngine
from .fleet import AutoscalePolicy, FleetController

__all__ = [
    "migrate_prefix", "export_pages_http", "import_pages_http",
    "install_preempt_rescue", "PrefillDecodePipeline",
    "TieredFleetController",
]


# ------------------------------------------------------------ page wire
def export_pages_http(url: str, input_ids: Sequence[int],
                      model: Optional[str] = None,
                      timeout: float = 60.0) -> dict:
    """POST ``/cache/export`` on a replica: the kvstore wire doc for the
    longest cached prefix of ``input_ids``."""
    payload: Dict[str, Any] = {"input_ids": [int(t) for t in input_ids]}
    if model is not None:
        payload["model"] = model
    req = urllib.request.Request(
        url.rstrip("/") + "/cache/export", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def import_pages_http(url: str, doc: dict, model: Optional[str] = None,
                      timeout: float = 60.0) -> dict:
    """POST ``/cache/import`` on a replica: adopt a wire doc's verified
    pages into its prefix cache; returns the import summary."""
    if model is not None:
        doc = dict(doc, model=model)
    req = urllib.request.Request(
        url.rstrip("/") + "/cache/import", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def migrate_prefix(src: Union[InferenceEngine, str],
                   dst: Union[InferenceEngine, str],
                   input_ids: Sequence[int],
                   model: Optional[str] = None,
                   timeout: float = 60.0) -> dict:
    """Ship ``input_ids``' cached prefix pages from ``src`` to ``dst``
    and adopt them there (chain hash, shape and dtype verified on receipt).
    Engines and replica URLs mix freely — an in-process engine can warm
    an HTTP replica and vice versa; the wire doc is the same either
    way. Returns the import summary."""
    if isinstance(src, str):
        doc = export_pages_http(src, input_ids, model=model,
                                timeout=timeout)
    else:
        doc = src.export_pages(input_ids)
    if isinstance(dst, str):
        return import_pages_http(dst, doc, model=model, timeout=timeout)
    return dst.import_pages(doc, timeout=timeout)


# ------------------------------------------------------------ rescue
def install_preempt_rescue(engine: InferenceEngine,
                           peers: Union[Sequence[InferenceEngine],
                                        Callable[[], Sequence[
                                            InferenceEngine]]],
                           result_timeout: float = 600.0) -> None:
    """Arm cross-replica preemption rescue on ``engine``.

    When an ``OutOfPages`` preemption fires, the engine exports the
    victim's leased pages before releasing them and hands
    ``(engine, req, wire_doc)`` to this hook. The hook picks the
    least-loaded healthy peer, imports the pages there, and resubmits
    the request with its generated tokens as the resume stream — the
    continuation is token-exact (stateless sampling), and the peer's
    admission maps the migrated pages instead of re-prefilling the
    whole history. The peer's result is piped back into the client's
    original handle on a daemon thread. Returns are accounted in
    ``mxnet_migrate_rescues_total{outcome=resumed|failed}``; any
    failure falls back to the local requeue (the hook returns False).

    ``peers`` is a list of candidate engines or a zero-arg callable
    returning one (a live fleet view); the preempting engine itself is
    always excluded."""
    def hook(src: InferenceEngine, req, doc: dict) -> bool:
        try:
            cands = [e for e in (peers() if callable(peers) else peers)
                     if e is not src and e._paged and e._running
                     and not e._draining]
            if not cands:
                _metrics.MIGRATE_RESCUES.labels(outcome="failed").inc()
                return False
            dst = min(cands, key=lambda e: e.stats()["load"])
            dst.import_pages(doc)
            resume = list(req._resume or ())
            handle = dst.submit(
                list(req.prompt_ids), req.max_new_tokens,
                eos_token_id=req.eos_token_id,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, seed=req.seed, resume=resume)
        except Exception as e:
            logger.warning("cachefleet: preempt rescue failed, victim "
                           "requeues locally: %r", e)
            _metrics.MIGRATE_RESCUES.labels(outcome="failed").inc()
            return False
        _metrics.MIGRATE_RESCUES.labels(outcome="resumed").inc()

        def pipe():
            try:
                res = handle.result(result_timeout)
            except MXNetError:
                res = None
            if res is not None:
                req._complete(res)
            else:  # pragma: no cover - peer died mid-rescue
                from .engine import ServeResult
                req._complete(ServeResult(
                    status="error", prompt_ids=list(req.prompt_ids),
                    generated_ids=list(req._resume or ()),
                    queue_wait_s=0.0, ttft_s=None, latency_s=0.0,
                    error="preempt rescue lost the migrated request"))

        threading.Thread(target=pipe, name="mxnet-rescue-pipe",
                         daemon=True).start()
        return True

    engine._migrate_hook = hook


# ------------------------------------------------- prefill/decode tiers
class PrefillDecodePipeline:
    """Disaggregated serving: prefill on one tier, decode on another,
    KV pages streamed between them over the kvstore page wire.

    ``prefill``/``decode`` are lists of paged engines (or replica base
    URLs — engines and URLs mix freely); each request picks the
    least-loaded member of each tier. The prefill replica runs a
    1-token generate — exactly the chunked-prefill executables, which
    materialize the prompt's pages and publish them to its prefix
    cache — then the finished FULL pages ship to the decode replica,
    whose admission maps them and re-prefills only the partial tail.
    The decode replica draws token 0 from the same ``fold_in(seed, 0)``
    stream the prefill replica used, so the output is single-replica
    serving's (bit for bit on the CPU; on the card within the paged
    engine's contract, since the decode replica prefills the tail
    again)."""

    def __init__(self, prefill: Sequence[Union[InferenceEngine, str]],
                 decode: Sequence[Union[InferenceEngine, str]],
                 timeout: float = 600.0):
        if not prefill or not decode:
            raise MXNetError("PrefillDecodePipeline needs at least one "
                             "replica per tier")
        self.prefill = list(prefill)
        self.decode = list(decode)
        self.timeout = float(timeout)
        #: pages streamed prefill -> decode (the pipeline's own ledger;
        #: the balance invariant lives in mxnet_migrate_*)
        self.pages_streamed = 0
        self._lock = threading.Lock()

    @staticmethod
    def _load(replica) -> float:
        if isinstance(replica, str):
            try:
                with urllib.request.urlopen(replica.rstrip("/")
                                            + "/healthz", timeout=5) as r:
                    return float(json.loads(r.read()).get("load") or 0.0)
            except Exception:
                return float("inf")
        return float(replica.stats()["load"])

    def _pick(self, tier: List) -> Any:
        return min(tier, key=self._load)

    def _generate_on(self, replica, payload: dict):
        if isinstance(replica, str):
            req = urllib.request.Request(
                replica.rstrip("/") + "/generate",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return json.loads(resp.read())
        kwargs = {k: payload[k] for k in ("temperature", "top_k", "top_p",
                                          "eos_token_id", "seed")
                  if payload.get(k) is not None}
        handle = replica.submit(payload["input_ids"],
                                payload["max_new_tokens"], **kwargs)
        res = handle.result(self.timeout)
        return {"status": res.status, "output_ids": res.output_ids,
                "generated_ids": res.generated_ids, "ttft_s": res.ttft_s,
                "queue_wait_s": res.queue_wait_s,
                "latency_s": res.latency_s, "error": res.error,
                "trace_id": res.trace_id}

    def generate(self, payload: dict) -> dict:
        """One request through the disaggregated path: prefill-tier
        1-token generate → page stream → decode-tier generate. Returns
        the decode replica's ``/generate``-shaped response dict. A
        prefill-side or transfer failure degrades to a plain decode-tier
        dispatch (full re-prefill there) — disaggregation is a fast
        path, never a correctness dependency."""
        ids = [int(t) for t in payload["input_ids"]]
        pre = self._pick(self.prefill)
        dec = self._pick(self.decode)
        try:
            warm = dict(payload, input_ids=ids, max_new_tokens=1)
            self._generate_on(pre, warm)
            summary = migrate_prefix(pre, dec, ids,
                                     model=payload.get("model"),
                                     timeout=self.timeout)
            with self._lock:
                self.pages_streamed += int(summary.get("received", 0))
        except Exception as e:
            logger.warning("cachefleet: prefill tier failed, decode tier "
                           "re-prefills: %r", e)
        return self._generate_on(dec, payload)

    def stats(self) -> dict:
        with self._lock:
            return {"prefill_replicas": len(self.prefill),
                    "decode_replicas": len(self.decode),
                    "pages_streamed": self.pages_streamed}


class TieredFleetController:
    """One :class:`~mxnet_tpu_torch.serve.fleet.FleetController` per tier over
    a shared router: each tier scales on ITS replicas' pressure and ITS
    SLO axis, with its own min/max bounds (``mxnet_fleet_tier_*``).

    ``tiers`` maps tier name → ``(spawner, AutoscalePolicy)``; the
    spawner's ``build()`` must produce engines constructed with
    ``tier=<name>`` so ``/healthz`` advertises membership and the
    router's tier filter sees them. ``tick()`` advances every tier
    (deterministic: tests drive it directly);
    ``start()`` runs each tier's own background loop."""

    def __init__(self, router, tiers: Dict[str, tuple],
                 interval: float = 1.0, health_timeout: float = 2.0):
        if not tiers:
            raise MXNetError("TieredFleetController needs at least one "
                             "tier")
        self.router = router
        self.controllers: Dict[str, FleetController] = {}
        for name, (spawner, policy) in tiers.items():
            if policy is not None and not isinstance(policy,
                                                     AutoscalePolicy):
                raise MXNetError(
                    f"tier {name!r}: policy must be an AutoscalePolicy")
            self.controllers[name] = FleetController(
                router, spawner, policy, interval=interval,
                health_timeout=health_timeout, tier=name)

    def tick(self) -> Dict[str, Optional[dict]]:
        """One decision pass per tier; {tier: scale event or None}."""
        return {name: ctl.tick()
                for name, ctl in self.controllers.items()}

    def start(self) -> "TieredFleetController":
        for ctl in self.controllers.values():
            ctl.start()
        return self

    def stop(self, stop_retiring: bool = True):
        for ctl in self.controllers.values():
            ctl.stop(stop_retiring=stop_retiring)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def stats(self) -> dict:
        return {name: ctl.stats()
                for name, ctl in self.controllers.items()}
