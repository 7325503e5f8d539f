"""Live weight publishing and the multi-model registry (counterpart of
``mxnet_tpu/serve/registry.py``).

- **Weight publishing**: the deploy artifact. A trainer publishes a
  versioned weight set (:func:`publish_weights`: an atomic tmp + rename
  directory ``weights-v<N>/`` with ``params.npz``, ``manifest.json`` and a
  DONE sentinel), and replicas pick it up by polling
  (:class:`WeightRefresher`) or by push (``POST /weights``) and swap the
  engine's weights in place between decode ticks
  (``InferenceEngine.swap_weights``). The layout, the file names and the
  manifest are the JAX package's, so a version published by either package
  is read by the other; bf16 arrays are stored as the raw 2-byte records
  numpy keeps for the JAX package's bfloat16, with ``"bfloat16"`` in the
  manifest. :func:`publish_from_checkpoint` turns a
  :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` step directory
  (local or single-process sharded layout, written by either package) into
  a published version, optionally walking back to the newest checkpoint
  whose health tag is not tainted.
- **Multi-model registry**: :class:`ModelRegistry` maps model names to
  engines; the HTTP frontend serves every registered model off one port
  (``/generate``'s ``model`` key) and ``/healthz`` advertises ``{name:
  weight version}``.

- **Tenant fair share**: :class:`TenantScheduler` admits the router's
  requests by weighted fair queueing over the healthy fleet's capacity,
  with per-tenant in-flight quotas (:class:`TenantPolicy`); a wait past
  its timeout raises :class:`QuotaExceededError` (HTTP 429 at the
  router), all observed in ``mxnet_fleet_tenant_*``.

Host logic only: nothing here touches the device (the engine copies
swapped weights in).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import metrics as _metrics
from ..analysis import guards as _guards
from ..base import MXNetError

__all__ = [
    "publish_weights", "latest_weight_version", "weight_versions",
    "read_weights", "snapshot_params", "publish_from_checkpoint",
    "WeightRefresher", "ModelRegistry",
    "QuotaExceededError", "TenantPolicy", "TenantScheduler",
]

logger = logging.getLogger(__name__)

_DONE = "DONE"
_PREFIX = "weights-v"
_BF16 = "bfloat16"


# --------------------------------------------------------------- publishing
def _version_dir(directory: str, version: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{version:010d}")


def weight_versions(directory: str) -> List[int]:
    """Sorted COMPLETE published versions under ``directory`` (tmp
    directories and sentinel-less partials are invisible)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX) or ".tmp" in name:
            continue
        if not os.path.exists(os.path.join(directory, name, _DONE)):
            continue
        try:
            out.append(int(name[len(_PREFIX):]))
        except ValueError:
            continue
    return sorted(out)


def latest_weight_version(directory: str) -> Optional[int]:
    versions = weight_versions(directory)
    return versions[-1] if versions else None


def _host_array(a) -> Tuple[np.ndarray, str]:
    """(numpy array as ``np.savez`` stores it, manifest dtype string): a
    bf16 tensor or ml_dtypes array becomes its raw 2-byte records."""
    if torch.is_tensor(a):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2"), _BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(a)
    if arr.dtype.name == _BF16:
        return arr.view("V2"), _BF16
    return arr, str(arr.dtype)


def _host_tensor(a) -> torch.Tensor:
    """The inverse of :func:`_host_array`: an array or tensor as a new host
    tensor of its own dtype; bf16 (raw 2-byte records, or ml_dtypes'
    bfloat16) comes back as ``torch.bfloat16``, bit for bit."""
    if torch.is_tensor(a):
        return a.detach().to("cpu", copy=True)
    arr = np.asarray(a)
    if arr.dtype.name == _BF16 or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def snapshot_params(net) -> Dict[str, np.ndarray]:
    """Host snapshot of a live model's parameters keyed by their
    ``named_parameters()`` names (the JAX package's ``collect_params``
    names, what ``swap_weights`` maps back), as numpy arrays; bf16 as raw
    2-byte records."""
    from .. import serialization
    named = list(net.named_parameters())
    host = serialization.host_copies([p for _, p in named])
    return {name: _host_array(t)[0] for (name, _), t in zip(named, host)}


def publish_weights(directory: str, params: Dict[str, Any],
                    version: Optional[int] = None,
                    meta: Optional[dict] = None,
                    keep_last: Optional[int] = None) -> int:
    """Publish one versioned weight set atomically. ``params`` maps name to
    array or tensor (a live net: :func:`snapshot_params`); ``version``
    defaults to latest + 1. Returns the published version.

    Everything lands in a pid+thread-unique tmp directory, the DONE
    sentinel last, and one rename makes the version visible: a reader never
    sees a partial publish. ``keep_last`` prunes older versions (never the
    latest)."""
    if not params:
        raise MXNetError("publish_weights: empty params dict")
    os.makedirs(directory, exist_ok=True)
    if version is None:
        version = (latest_weight_version(directory) or 0) + 1
    version = int(version)
    if version <= 0:
        raise MXNetError("publish_weights: version must be positive "
                         "(0 is reserved for never-published weights)")
    host = {name: _host_array(a) for name, a in params.items()}
    final = _version_dir(directory, version)
    tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        np.savez(os.path.join(tmp, "params.npz"), **{n: a for n, (a, _) in host.items()})
        manifest = {
            "version": version, "time": time.time(), "meta": meta or {},
            "params": {name: {"dtype": dt, "shape": list(a.shape)}
                       for name, (a, dt) in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _DONE), "w") as f:
            f.write("ok\n")
        # versions are immutable: a rename onto an existing version fails,
        # and the winner's complete publish stays
        try:
            os.rename(tmp, final)
        except OSError:
            if not os.path.exists(final):
                raise
            shutil.rmtree(tmp, ignore_errors=True)
            logger.info("weights v%d already published under %s; "
                        "dropping the duplicate publish", version, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep_last:
        for old in weight_versions(directory)[:-int(keep_last)]:
            shutil.rmtree(_version_dir(directory, old), ignore_errors=True)
    logger.info("published weights v%d under %s", version, directory)
    return version


def _coerce_dtype(data: np.ndarray, dtype_str: str) -> np.ndarray:
    """A stored array back in its manifest dtype: same-width records are
    viewed (bf16 stays raw 2-byte records where numpy has no bfloat16),
    others cast."""
    try:
        want = np.dtype(dtype_str)
    except TypeError:
        return data                         # bfloat16 without ml_dtypes
    if data.dtype == want:
        return data
    if data.dtype.itemsize == want.itemsize:
        return data.view(want)
    return data.astype(want)


def read_weights(directory: str, version: Optional[int] = None
                 ) -> Tuple[int, Dict[str, np.ndarray], dict]:
    """Load one published version (default: the latest). Returns
    ``(version, {name: numpy array}, manifest)`` with dtypes restored from
    the manifest."""
    if version is None:
        version = latest_weight_version(directory)
        if version is None:
            raise MXNetError(f"no published weights under {directory!r}")
    path = _version_dir(directory, int(version))
    if not os.path.exists(os.path.join(path, _DONE)):
        raise MXNetError(f"weights v{version} under {directory!r} is "
                         "missing or incomplete")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "params.npz"), allow_pickle=False) as z:
        for name in z.files:
            spec = manifest.get("params", {}).get(name)
            arr = z[name]
            if spec is not None:
                arr = _coerce_dtype(arr, spec["dtype"])
            out[name] = arr
    return int(version), out, manifest


def _ckpt_manifest(step_dir: str) -> dict:
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _walk_back_healthy(step_dir: str) -> str:
    """Newest complete sibling checkpoint at or before ``step_dir`` whose
    manifest health tag is not tainted (untagged = healthy); raises when
    every candidate is tainted."""
    parent = os.path.dirname(os.path.abspath(step_dir)) or "."
    want = os.path.basename(step_dir)
    candidates = []
    for name in os.listdir(parent):
        if not name.startswith("step-") or ".tmp" in name:
            continue
        if not os.path.exists(os.path.join(parent, name, _DONE)):
            continue
        if name <= want:
            candidates.append(name)
    for name in sorted(candidates, reverse=True):
        full = os.path.join(parent, name)
        tag = _ckpt_manifest(full).get("health")
        if tag is None or tag.get("healthy", True):
            if name != want:
                logger.warning(
                    "publish_from_checkpoint(healthy_only): %s is "
                    "tainted; publishing last-healthy %s instead", want, name)
            return full
    raise MXNetError(
        f"publish_from_checkpoint(healthy_only): no healthy checkpoint "
        f"at or before {step_dir!r} — refusing to publish tainted "
        "weights")


def _shard_params(step_dir: str) -> Dict[str, np.ndarray]:
    """``param.<name>`` arrays of a sharded step directory: a whole array
    is its one shard; flat 1-D params split across shards are put back
    together in start order; multi-dimensional partial shards (a
    tensor-parallel save) cannot be, and raise."""
    pieces: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for fname in sorted(os.listdir(step_dir)):
        if not fname.startswith("shards-") or not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(step_dir, fname)) as z:
            for key in z.files:
                name, rng = key.rsplit("|", 1)
                if name.startswith("param."):
                    pieces.setdefault(name[len("param."):], []).append((rng, z[key]))
    params = {}
    for name, parts in pieces.items():
        if len(parts) == 1:
            params[name] = np.asarray(parts[0][1])
        elif all(";" not in r for r, _ in parts):
            parts.sort(key=lambda p: int(p[0].split(":")[0]))
            off = 0
            for rng, data in parts:
                if int(rng.split(":")[0]) != off:
                    raise MXNetError(
                        f"sharded checkpoint: shards for param.{name} do not "
                        f"tile the array (expected offset {off}, found piece "
                        f"at {rng}) — a shard file is missing or duplicated")
                off += data.shape[0]
            params[name] = np.concatenate([d for _, d in parts])
        else:
            full_key = [r for r, _ in parts
                        if all(seg.startswith("0:") for seg in r.split(";"))]
            raise MXNetError(
                f"publish_from_checkpoint: param {name!r} is sharded "
                "multi-dimensionally (tp/sp save) — publish from the "
                f"live net instead (full-slice keys: {full_key})")
    return params


def publish_from_checkpoint(step_dir: str, directory: str,
                            version: Optional[int] = None,
                            meta: Optional[dict] = None,
                            keep_last: Optional[int] = None,
                            healthy_only: bool = False) -> int:
    """Publish one CheckpointManager step directory as a weight version:
    the train-to-serve bridge. Reads the local layout (``model.params``)
    or the sharded one (``shards-*.npz``). ``healthy_only=True`` replaces
    a tainted ``step_dir`` by the newest untainted sibling (raising when
    there is none). The published meta carries the source checkpoint, its
    ``step`` and its ``health`` tag."""
    if healthy_only:
        step_dir = _walk_back_healthy(step_dir)
    ckpt_manifest = _ckpt_manifest(step_dir)
    local = os.path.join(step_dir, "model.params")
    if os.path.exists(local):
        from .. import serialization
        params: Dict[str, Any] = dict(serialization.load(local))
    else:
        params = _shard_params(step_dir)
    if not params:
        raise MXNetError(
            f"publish_from_checkpoint: no params found in {step_dir!r}")
    meta = dict(meta or {})
    meta["source_checkpoint"] = os.path.basename(step_dir)
    if ckpt_manifest.get("step") is not None:
        meta.setdefault("source_step", ckpt_manifest["step"])
    if ckpt_manifest.get("health") is not None:
        meta.setdefault("health", ckpt_manifest["health"])
    return publish_weights(directory, params, version=version, meta=meta,
                           keep_last=keep_last)


class WeightRefresher:
    """Poll a weights directory and swap an engine to each newer version:
    the replica side of the publish protocol. :meth:`check` is the one-shot
    probe (``POST /weights`` without a ``dir`` triggers it);
    :meth:`start` polls every ``interval`` seconds on a background thread
    (``interval`` <= 0 or None: push only). A failed load or swap is logged
    and retried at the next poll; the engine keeps serving throughout."""

    def __init__(self, engine, directory: str, interval: Optional[float] = 5.0):
        self.engine = engine
        self.directory = directory
        self.interval = float(interval) if interval else 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_error: Optional[str] = None

    def check(self) -> Optional[int]:
        """Swap to the latest published version if it is newer than the
        one the engine serves; returns the new version or None."""
        latest = latest_weight_version(self.directory)
        if latest is None or latest <= self.engine.weight_version:
            return None
        try:
            version, params, manifest = read_weights(self.directory, latest)
            self.engine.swap_weights(params, version=version)
            # the publish meta's health tag rides to /healthz
            self.engine.weight_health = manifest.get("meta", {}).get("health")
            self.last_error = None
            return version
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
            logger.warning("weight refresh failed (keeping v%d): %s",
                           self.engine.weight_version, self.last_error)
            return None

    def start(self) -> "WeightRefresher":
        if self._thread is not None or not self.interval:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self.check()

        self._thread = threading.Thread(target=loop, name="mxnet-weight-refresh",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join((self.interval or 0.0) + 5.0)


# ------------------------------------------------------------ model registry
@dataclasses.dataclass
class _ModelEntry:
    name: str
    engine: Any
    weights_dir: Optional[str] = None
    refresher: Optional[WeightRefresher] = None


class ModelRegistry:
    """Name -> engine map for one replica serving N models. The HTTP
    frontend takes a registry wherever it takes an engine: ``/generate``'s
    ``model`` key selects the entry and ``/healthz`` advertises ``{name:
    weight version}``. ``get()`` with no name gives the entry named
    ``"default"``, else the first registered."""

    def __init__(self):
        self._entries: Dict[str, _ModelEntry] = {}
        self._lock = threading.Lock()

    def add(self, name: str, engine, weights_dir: Optional[str] = None,
            refresh_interval: Optional[float] = None) -> "ModelRegistry":
        """Register one engine (named ``name`` from now on). With
        ``weights_dir``, :meth:`refresh` (and ``POST /weights``) pulls new
        published versions; ``refresh_interval`` also polls once
        :meth:`start` runs."""
        if not name:
            raise MXNetError("model name must be non-empty")
        with self._lock:
            if name in self._entries:
                raise MXNetError(f"model {name!r} already registered")
            engine.name = name          # the telemetry label
            refresher = None
            if weights_dir is not None:
                refresher = WeightRefresher(engine, weights_dir,
                                            interval=refresh_interval)
            self._entries[name] = _ModelEntry(name, engine, weights_dir, refresher)
        return self

    def get(self, name: Optional[str] = None):
        """The engine of ``name`` (None: the default). Raises on an unknown
        name and on an empty registry."""
        with self._lock:
            if not self._entries:
                raise MXNetError("model registry is empty")
            if name is None:
                entry = self._entries.get("default")
                if entry is None:
                    entry = next(iter(self._entries.values()))
                return entry.engine
            entry = self._entries.get(name)
        if entry is None:
            raise MXNetError(f"unknown model {name!r} (serving: {self.names()})")
        return entry.engine

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def engines(self) -> List[Any]:
        with self._lock:
            return [e.engine for e in self._entries.values()]

    def versions(self) -> Dict[str, int]:
        """{model name: served weight version}."""
        with self._lock:
            return {n: e.engine.weight_version for n, e in self._entries.items()}

    def refresh(self, name: Optional[str] = None) -> Dict[str, Optional[int]]:
        """One-shot refresh of one model (or of every model with a weights
        directory). Returns {name: new version or None}."""
        with self._lock:
            entries = ([self._entries[name]] if name is not None
                       else list(self._entries.values()))
        out: Dict[str, Optional[int]] = {}
        for e in entries:
            if e.refresher is not None:
                out[e.name] = e.refresher.check()
        return out

    def start(self) -> "ModelRegistry":
        """Start every engine and every polling refresher."""
        for e in list(self._entries.values()):
            e.engine.start()
            if e.refresher is not None:
                e.refresher.start()
        return self

    def warmup(self) -> "ModelRegistry":
        for eng in self.engines():
            eng.warmup()
        return self

    def shutdown(self, drain: bool = True):
        for e in list(self._entries.values()):
            if e.refresher is not None:
                e.refresher.stop()
            e.engine.shutdown(drain=drain)

    def stats(self) -> Dict[str, Any]:
        return {n: e.engine.stats() for n, e in list(self._entries.items())}


# ------------------------------------------------------- tenant fair share
class QuotaExceededError(MXNetError):
    """Tenant admission failed: quota/WFQ wait exceeded its timeout
    (surfaces as HTTP 429 backpressure at the router)."""


@dataclasses.dataclass
class TenantPolicy:
    """Per-tenant share of the fleet. ``weight`` is the WFQ share
    (dispatch ratios track weights over saturated periods);
    ``max_inflight`` is an absolute in-flight cap (None = bounded only
    by fair queueing)."""
    weight: float = 1.0
    max_inflight: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise MXNetError("tenant weight must be positive")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise MXNetError("tenant max_inflight must be >= 1")


@dataclasses.dataclass
class _TenantState:
    policy: TenantPolicy
    inflight: int = 0
    vtime: float = 0.0
    dispatched: int = 0
    waiters: "deque" = dataclasses.field(default_factory=deque)


class TenantScheduler:
    """Weighted-fair admission over a shared dispatch capacity.

    A ticket is admitted when (a) total in-flight < ``capacity_fn()``
    (None/<=0 = uncapped), (b) its tenant is under its ``max_inflight``
    quota, and (c) no OTHER quota-eligible tenant with waiters has
    strictly less virtual time (ties: global FIFO). Each admission adds
    ``1/weight`` to the tenant's virtual time — the WFQ invariant: over
    any period where both tenants keep the queue non-empty, admissions
    split ~weight_a : weight_b. A tenant returning from idle is floored
    to the minimum active virtual time, so saved-up credit cannot fund
    a catch-up burst."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 capacity_fn: Optional[Callable[[], int]] = None):
        self._policies = dict(policies or {})
        self._default = default_policy or TenantPolicy()
        self._capacity_fn = capacity_fn
        self._cond = threading.Condition(
            _guards.make_lock("serve.TenantScheduler._lock"))
        self._tenants: Dict[str, _TenantState] = {}
        self._seq = 0
        self._total_inflight = 0

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(
                self._policies.get(tenant, self._default))
        return st

    def _capacity(self) -> Optional[int]:
        if self._capacity_fn is None:
            return None
        try:
            cap = int(self._capacity_fn())
        except Exception:
            return None
        return cap if cap > 0 else None

    def _floor_vtime(self, st: _TenantState):
        """Idle-return floor: no banked credit from quiet periods."""
        active = [t.vtime for t in self._tenants.values()
                  if t is not st and (t.inflight or t.waiters)]
        if active:
            st.vtime = max(st.vtime, min(active))

    def _eligible_head(self, tenant: str, seq: int, cap: Optional[int]
                       ) -> bool:
        st = self._tenants[tenant]
        if cap is not None and self._total_inflight >= cap:
            return False
        quota = st.policy.max_inflight
        if quota is not None and st.inflight >= quota:
            return False
        if not st.waiters or st.waiters[0] != seq:
            return False        # FIFO within the tenant
        # least-virtual-time across tenants that could dispatch NOW
        for name, other in self._tenants.items():
            if name == tenant or not other.waiters:
                continue
            oq = other.policy.max_inflight
            if oq is not None and other.inflight >= oq:
                continue
            if (other.vtime, other.waiters[0]) < (st.vtime, seq):
                return False
        return True

    def acquire(self, tenant: str, timeout: Optional[float] = None) -> float:
        """Block until the tenant may dispatch one request; returns the
        wait in seconds. Raises :class:`QuotaExceededError` when the
        wait exceeds ``timeout``."""
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        with self._cond:
            st = self._state(tenant)
            if not st.inflight and not st.waiters:
                self._floor_vtime(st)
            self._seq += 1
            seq = self._seq
            st.waiters.append(seq)
            try:
                while not self._eligible_head(tenant, seq,
                                              self._capacity()):
                    remaining = (None if deadline is None
                                 else deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        _metrics.FLEET_TENANT_REJECTED.labels(
                            tenant=tenant).inc()
                        raise QuotaExceededError(
                            f"tenant {tenant!r} admission timed out after "
                            f"{timeout:.3f}s (quota="
                            f"{st.policy.max_inflight}, weight="
                            f"{st.policy.weight}); retry with backoff")
                    self._cond.wait(remaining if remaining is not None
                                    else 0.5)
            finally:
                st.waiters.remove(seq)
            st.inflight += 1
            st.vtime += 1.0 / st.policy.weight
            st.dispatched += 1
            self._total_inflight += 1
            _metrics.FLEET_TENANT_DISPATCH.labels(tenant=tenant).inc()
            _metrics.FLEET_TENANT_INFLIGHT.labels(tenant=tenant).set(
                st.inflight)
            # an admission can unblock a DIFFERENT tenant's head (the
            # vtime order just changed)
            self._cond.notify_all()
        wait = time.perf_counter() - t0
        _metrics.FLEET_TENANT_WAIT.labels(tenant=tenant).observe(wait)
        return wait

    def release(self, tenant: str):
        with self._cond:
            st = self._state(tenant)
            if st.inflight > 0:
                st.inflight -= 1
                self._total_inflight -= 1
            _metrics.FLEET_TENANT_INFLIGHT.labels(tenant=tenant).set(
                st.inflight)
            self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {name: {"inflight": st.inflight,
                           "waiting": len(st.waiters),
                           "dispatched": st.dispatched,
                           "vtime": round(st.vtime, 6),
                           "weight": st.policy.weight,
                           "max_inflight": st.policy.max_inflight}
                    for name, st in self._tenants.items()}
