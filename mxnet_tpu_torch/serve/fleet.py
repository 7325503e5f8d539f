"""SLO-driven autoscale controller for the multi-replica serving fleet
(counterpart of ``mxnet_tpu/serve/fleet.py``, decision for decision).

Every signal an autoscaler needs is already a gauge: per-replica
``/healthz`` load (slot and page pressure plus queue backlog,
serve/engine.py) and the fleet's SLO error-budget burn
(``observability.aggregate.SLOTracker`` on the router). This module turns
them into a replica count:

- **Control loop.** :class:`FleetController` runs in the router's process
  (``tick()`` is the public, deterministic unit: tests drive it directly;
  ``start()`` runs it on a background thread). Each tick reads the
  router's backend snapshot, fuses the pressure signal (mean healthy
  replica load; ``mxnet_fleet_pressure``), refreshes and reads the SLO
  burn, and decides: spawn on sustained pressure or budget burn, drain
  the least-loaded replica on sustained slack.
- **Hysteresis and cooldown.** A decision needs ``up_after`` /
  ``down_after`` consecutive qualifying ticks and a ``cooldown_s`` quiet
  period after any scale event; every suppressed decision is counted
  (``mxnet_fleet_decisions_suppressed_total{direction,why}``).
- **Graceful scale-down.** The victim is drained through the router
  (in-flight requests finish; drain-bounced ones replay on the survivors)
  and stopped once it reports idle (``retiring``, bounded by
  ``drain_grace_s``).
- **Spawners.** Replica lifecycle is the two-method ``spawn() -> url`` /
  ``stop(url)`` surface: :class:`InProcessSpawner` starts an engine and
  its HTTP frontend in this process (one device shared by the replicas);
  :class:`SubprocessSpawner` launches replica processes. The JAX package
  points a spawned replica at a prewarmed AOT cache; this package has no
  AOT cache yet (ROADMAP Queue 1 item 8), so a replica captures its own
  graphs at warm-up.

Every decision is visible: ``mxnet_fleet_scale_events_total{direction,
reason=load|slo_burn|min_floor}``, replica-state gauges, spawn and drain
histograms, the ``fleet.scale`` / ``fleet.retired`` flight-recorder
events, and the controller's ``events`` ledger. Pure stdlib logic.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import os
import subprocess
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from .. import metrics as _metrics
from ..analysis import guards as _guards
from ..base import MXNetError, logger
from ..observability import recorder as _recorder

__all__ = ["AutoscalePolicy", "FleetController", "InProcessSpawner",
           "SubprocessSpawner"]


@dataclasses.dataclass
class AutoscalePolicy:
    """The controller's knobs. Loads are the ``/healthz`` ``load``
    scalar (0 = idle, ~1 = saturated, > 1 = queueing)."""
    scale_up_load: float = 0.75     #: sustained mean load that adds a replica
    scale_down_load: float = 0.25   #: sustained mean load that removes one
    scale_up_burn: float = 1.0      #: SLO error-budget burn that counts as
    #: pressure regardless of load (> 1 = spending budget faster than it
    #: accrues); requires the router's SLO tracker to be armed
    up_after: int = 3               #: consecutive pressure ticks before up
    down_after: int = 5             #: consecutive slack ticks before down
    cooldown_s: float = 10.0        #: quiet period after any scale event
    min_replicas: int = 1
    max_replicas: int = 8
    drain_grace_s: float = 60.0     #: max wait for a draining replica to idle
    refresh_slo: bool = True        #: scrape fleet metrics each tick so the
    #: burn signal is current (costs one /metrics/json per replica per tick)
    #: restrict the burn signal to these SLO names (None = all). The
    #: disaggregated tiers scale on their OWN axes: the prefill tier
    #: watches ("ttft",), the decode tier ("intertoken",) — a TTFT
    #: budget fire must add prefill replicas, not decode ones.
    slo_names: Optional[tuple] = None

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < max(
                1, self.min_replicas):
            raise MXNetError("need 0 <= min_replicas <= max_replicas >= 1")
        if self.scale_down_load >= self.scale_up_load:
            raise MXNetError("scale_down_load must be < scale_up_load "
                             "(the hysteresis band)")
        if self.up_after < 1 or self.down_after < 1:
            raise MXNetError("up_after/down_after must be >= 1")


class FleetController:
    """Autoscale control loop over a Router + replica spawner.

    ``tick()`` performs ONE observation + decision; ``start()`` runs it
    every ``interval`` seconds on a daemon thread. The controller only
    ever drains replicas the spawner owns (``spawner.urls()``) —
    statically configured backends are load-bearing config, not cattle.
    """

    def __init__(self, router, spawner, policy: Optional[AutoscalePolicy]
                 = None, interval: float = 1.0,
                 health_timeout: float = 2.0,
                 tier: Optional[str] = None):
        """``tier`` scopes the controller to one replica tier of a
        disaggregated fleet (serve/cachefleet.py): pressure is computed
        over, and scale decisions apply to, only the backends whose
        ``/healthz`` advertises that tier — each tier runs its own
        controller with its own policy (min/max bounds, SLO names) over
        the shared router. ``None`` = the classic whole-fleet loop."""
        self.router = router
        self.spawner = spawner
        self.policy = policy or AutoscalePolicy()
        self.interval = float(interval)
        self.health_timeout = float(health_timeout)
        self.tier = str(tier) if tier else None
        #: host-side decision ledger (every scale event, in order)
        self.events: List[dict] = []
        self._lock = _guards.make_lock("serve.FleetController._lock")
        self._up_streak = 0
        self._down_streak = 0
        self._last_event_t = -float("inf")
        #: url -> {"t0": monotonic, "deadline": monotonic} for drained
        #: replicas whose in-flight work is still finishing
        self._retiring: Dict[str, Dict[str, float]] = {}
        # windowed SLO burn: last cumulative (violations, count) per slo,
        # so the decision signal is the burn of the CURRENT window — the
        # tracker's cumulative ratio would pin "burning" forever after
        # one bad episode and scale-down could never fire
        self._slo_prev: Dict[str, tuple] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._ticks = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetController":
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(self.interval):
                try:
                    self.tick()
                except Exception as e:  # pragma: no cover - defensive
                    # one bad tick (a replica dying mid-poll) must not
                    # kill the control loop
                    logger.warning("fleet controller tick failed: %r", e)

        self._thread = threading.Thread(target=loop,
                                        name="mxnet-fleet-controller",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, stop_retiring: bool = True):
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.interval + 5.0)
        if stop_retiring:
            for url in list(self._retiring):
                self._finish_retire(url, "controller_stop")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ signals
    def _healthz(self, url: str) -> Optional[dict]:
        try:
            with urllib.request.urlopen(url + "/healthz",
                                        timeout=self.health_timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                with e:
                    return json.loads(e.read())
            except Exception:
                return None
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError):
            return None

    def slo_burn(self) -> float:
        """Worst error-budget burn across the router's tracked SLOs
        (0.0 when the tracker is unarmed or has no data yet)."""
        slo = getattr(self.router, "_slo", None)
        if slo is None:
            return 0.0
        names = self.policy.slo_names
        return max((float(d.get("burn", 0.0))
                    for n, d in slo.last.items()
                    if names is None or n in names),
                   default=0.0)

    def _recent_burn(self) -> float:
        """Worst burn over requests observed SINCE the last tick (the
        decision signal): Δviolations/Δcount against the error budget.
        Consumes the window — call once per tick."""
        slo = getattr(self.router, "_slo", None)
        if slo is None:
            return 0.0
        budget = max(1e-9, 1.0 - slo.objective)
        names = self.policy.slo_names
        worst = 0.0
        for name, d in slo.last.items():
            if names is not None and name not in names:
                continue
            cur = (float(d.get("violations", 0)),
                   float(d.get("count", 0)))
            pv, pc = self._slo_prev.get(name, (0.0, 0.0))
            self._slo_prev[name] = cur
            dv, dc = cur[0] - pv, cur[1] - pc
            if dc > 0 and dv >= 0:
                worst = max(worst, (dv / dc) / budget)
        return worst

    # ------------------------------------------------------------ the loop
    def tick(self) -> Optional[dict]:
        """One observation + decision. Returns the event dict when the
        tick scaled the fleet, else None."""
        p = self.policy
        now = time.monotonic()
        self._ticks += 1
        _metrics.FLEET_TICKS.inc()
        self._advance_retiring(now)
        if p.refresh_slo and getattr(self.router, "_slo", None) is not None:
            try:
                # refresh the burn signal from the live fleet histograms
                self.router.fleet_metrics(timeout=self.health_timeout)
            except Exception:  # pragma: no cover - scrape best-effort
                pass
        stats = self.router.stats()
        # a tiered controller sees only ITS tier's slice of the rotation
        # (pressure, victims, replica bounds all scope to the tier)
        members = {u: b for u, b in stats["backends"].items()
                   if self.tier is None or b.get("tier") == self.tier}
        healthy = {u: b for u, b in members.items()
                   if b["healthy"] and u not in self._retiring}
        n = len(healthy)
        pressure = (sum(b["load"] for b in healthy.values()) / n
                    if n else float("inf"))
        burn = self._recent_burn()
        _metrics.FLEET_PRESSURE.set(0.0 if pressure == float("inf")
                                    else pressure)
        _metrics.FLEET_REPLICAS.labels(state="healthy").set(n)
        _metrics.FLEET_REPLICAS.labels(state="retiring").set(
            len(self._retiring))
        if self.tier is not None:
            _metrics.FLEET_TIER_REPLICAS.labels(
                tier=self.tier, state="healthy").set(n)
            _metrics.FLEET_TIER_REPLICAS.labels(
                tier=self.tier, state="retiring").set(len(self._retiring))

        # --- emergency floor: below min_replicas, spawn NOW (no
        # hysteresis — this is recovery, not scaling). Still bounded:
        # max_replicas counts EVERY rotation member (a probe blackout
        # marks live replicas unhealthy without killing them — spawning
        # one per tick through it would fork-bomb the host), and the
        # cooldown rate-limits consecutive recovery spawns.
        if n < p.min_replicas:
            total = len(members)
            if total >= p.max_replicas:
                _metrics.FLEET_SUPPRESSED.labels(direction="up",
                                                 why="at_max").inc()
            elif now - self._last_event_t < p.cooldown_s:
                _metrics.FLEET_SUPPRESSED.labels(direction="up",
                                                 why="cooldown").inc()
            else:
                return self._scale_up(now, "min_floor", n, pressure,
                                      burn)
            return None

        want_up = pressure >= p.scale_up_load or burn >= p.scale_up_burn
        want_down = (pressure <= p.scale_down_load
                     and burn < p.scale_up_burn)
        self._up_streak = self._up_streak + 1 if want_up else 0
        self._down_streak = self._down_streak + 1 if want_down else 0

        if want_up and self._up_streak >= p.up_after:
            if n >= p.max_replicas:
                _metrics.FLEET_SUPPRESSED.labels(direction="up",
                                                 why="at_max").inc()
            elif now - self._last_event_t < p.cooldown_s:
                _metrics.FLEET_SUPPRESSED.labels(direction="up",
                                                 why="cooldown").inc()
            else:
                reason = ("slo_burn" if burn >= p.scale_up_burn
                          and pressure < p.scale_up_load else "load")
                return self._scale_up(now, reason, n, pressure, burn)
        elif want_up:
            _metrics.FLEET_SUPPRESSED.labels(direction="up",
                                             why="hysteresis").inc()

        if want_down and self._down_streak >= p.down_after:
            if n <= p.min_replicas:
                _metrics.FLEET_SUPPRESSED.labels(direction="down",
                                                 why="at_min").inc()
            elif now - self._last_event_t < p.cooldown_s:
                _metrics.FLEET_SUPPRESSED.labels(direction="down",
                                                 why="cooldown").inc()
            else:
                return self._scale_down(now, healthy, pressure, burn)
        elif want_down:
            _metrics.FLEET_SUPPRESSED.labels(direction="down",
                                             why="hysteresis").inc()
        return None

    # ------------------------------------------------------------ actions
    def _record(self, event: dict) -> dict:
        with self._lock:
            self.events.append(event)
        _recorder.RECORDER.record("event", "fleet.scale", **{
            k: v for k, v in event.items() if k != "t"})
        logger.info("fleet scale event: %s", event)
        return event

    def _scale_up(self, now: float, reason: str, n: int, pressure: float,
                  burn: float) -> dict:
        t0 = time.perf_counter()
        url = self.spawner.spawn()
        self.router.add_backend(url)
        dt = time.perf_counter() - t0
        _metrics.FLEET_SPAWN_SECONDS.observe(dt)
        _metrics.FLEET_SCALE_EVENTS.labels(direction="up",
                                           reason=reason).inc()
        _metrics.FLEET_REPLICAS.labels(state="healthy").set(n + 1)
        if self.tier is not None:
            _metrics.FLEET_TIER_SCALE_EVENTS.labels(
                tier=self.tier, direction="up", reason=reason).inc()
            _metrics.FLEET_TIER_REPLICAS.labels(
                tier=self.tier, state="healthy").set(n + 1)
        self._up_streak = self._down_streak = 0
        self._last_event_t = now
        return self._record({
            "t": time.time(), "direction": "up", "reason": reason,
            "url": url, "replicas": n + 1, "spawn_s": round(dt, 3),
            "tier": self.tier,
            "pressure": round(pressure, 4), "burn": round(burn, 4)})

    def _scale_down(self, now: float, healthy: Dict[str, dict],
                    pressure: float, burn: float) -> Optional[dict]:
        owned = set(self.spawner.urls())
        victims = [u for u in healthy if u in owned]
        if not victims:
            _metrics.FLEET_SUPPRESSED.labels(direction="down",
                                             why="no_owned_replica").inc()
            return None
        # the least-loaded replica has the least in-flight work to drain
        victim = min(victims, key=lambda u: (healthy[u]["load"], u))
        self.router.drain(victim)
        self._retiring[victim] = {
            "t0": time.perf_counter(),
            "deadline": now + self.policy.drain_grace_s}
        _metrics.FLEET_SCALE_EVENTS.labels(direction="down",
                                           reason="load").inc()
        _metrics.FLEET_REPLICAS.labels(state="retiring").set(
            len(self._retiring))
        if self.tier is not None:
            _metrics.FLEET_TIER_SCALE_EVENTS.labels(
                tier=self.tier, direction="down", reason="load").inc()
            _metrics.FLEET_TIER_REPLICAS.labels(
                tier=self.tier, state="retiring").set(len(self._retiring))
        self._up_streak = self._down_streak = 0
        self._last_event_t = now
        return self._record({
            "t": time.time(), "direction": "down", "reason": "load",
            "url": victim, "replicas": len(healthy) - 1,
            "tier": self.tier,
            "pressure": round(pressure, 4), "burn": round(burn, 4)})

    def _advance_retiring(self, now: float):
        """Stop drained replicas once their in-flight work finished (or
        the grace period expired). The drain already ejected them from
        dispatch; this is only about not killing in-flight streams. A
        single failed probe is UNKNOWN, not idle — killing on it would
        void the grace period exactly when the replica is busiest; only
        repeated failures conclude the process is already gone."""
        for url, st in list(self._retiring.items()):
            doc = self._healthz(url)
            if doc is None:
                st["fails"] = st.get("fails", 0) + 1
            else:
                st["fails"] = 0
            idle = (doc is not None
                    and not doc.get("slots_in_use")
                    and not doc.get("queue_depth"))
            gone = st.get("fails", 0) >= 3
            if idle or gone or now > st["deadline"]:
                _metrics.FLEET_DRAIN_SECONDS.observe(
                    time.perf_counter() - st["t0"])
                self._finish_retire(
                    url, "drained" if idle else
                    "replica_gone" if gone else "drain_grace_expired")

    def _finish_retire(self, url: str, why: str):
        self._retiring.pop(url, None)
        try:
            self.spawner.stop(url)
        except Exception as e:  # pragma: no cover - defensive
            logger.warning("fleet: stopping %s failed: %r", url, e)
        try:
            self.router.remove_backend(url)
        except MXNetError:
            pass
        _metrics.FLEET_REPLICAS.labels(state="retiring").set(
            len(self._retiring))
        _recorder.RECORDER.record("event", "fleet.retired", url=url,
                                  why=why)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            events = list(self.events)
        return {
            "ticks": self._ticks,
            "tier": self.tier,
            "retiring": sorted(self._retiring),
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "events": events,
            "policy": dataclasses.asdict(self.policy),
        }


# ------------------------------------------------------------- spawners
class InProcessSpawner:
    """Replica lifecycle inside this process: each spawn builds an engine
    (or a multi-model registry) with ``build()``, starts it (and warms it
    up with ``warmup=True``), and binds an HTTP frontend on an ephemeral
    port. The fleet mechanics are those of real processes, minus process
    isolation; replicas built on one card share it."""

    def __init__(self, build: Callable[[], Any], warmup: bool = False):
        self._build = build
        self._warmup = warmup
        self._replicas: Dict[str, tuple] = {}
        self._lock = _guards.make_lock("serve.InProcessSpawner._lock")

    def spawn(self) -> str:
        from .http import HTTPFrontend
        served = self._build()
        served.start()
        if self._warmup:
            served.warmup()
        frontend = HTTPFrontend(served, port=0).start()
        url = frontend.url
        with self._lock:
            self._replicas[url] = (served, frontend)
        return url

    def stop(self, url: str):
        with self._lock:
            rec = self._replicas.pop(url, None)
        if rec is None:
            raise MXNetError(f"unknown replica {url!r}")
        served, frontend = rec
        frontend.stop()
        served.shutdown(drain=True)

    def urls(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def stop_all(self):
        for url in self.urls():
            try:
                self.stop(url)
            except MXNetError:
                pass


class SubprocessSpawner:
    """Replica lifecycle as child processes: ``argv_fn(port)`` builds the
    replica command line, and spawn blocks until ``/healthz`` reports ok
    (bounded by ``boot_timeout``). ``env`` (default: this process's
    environment) is the children's."""

    def __init__(self, argv_fn: Callable[[int], List[str]],
                 base_port: int = 8100, host: str = "127.0.0.1",
                 env: Optional[Dict[str, str]] = None,
                 boot_timeout: float = 300.0):
        self._argv_fn = argv_fn
        self._host = host
        self._next_port = int(base_port)
        self._env = dict(os.environ) if env is None else dict(env)
        self._boot_timeout = float(boot_timeout)
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = _guards.make_lock("serve.SubprocessSpawner._lock")

    def spawn(self) -> str:
        with self._lock:
            port = self._next_port
            self._next_port += 1
        argv = self._argv_fn(port)
        proc = subprocess.Popen(argv, env=self._env)
        url = f"http://{self._host}:{port}"
        deadline = time.monotonic() + self._boot_timeout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise MXNetError(
                    f"replica {url} exited during boot "
                    f"(rc={proc.returncode}): {' '.join(argv)}")
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=2) as r:
                    if json.loads(r.read()).get("ok"):
                        break
            except Exception:
                pass
            time.sleep(0.25)
        else:
            proc.terminate()
            raise MXNetError(f"replica {url} never became healthy within "
                             f"{self._boot_timeout}s")
        with self._lock:
            self._procs[url] = proc
        return url

    def stop(self, url: str, timeout: float = 10.0):
        with self._lock:
            proc = self._procs.pop(url, None)
        if proc is None:
            raise MXNetError(f"unknown replica {url!r}")
        proc.terminate()
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5)

    def urls(self) -> List[str]:
        with self._lock:
            return list(self._procs)

    def stop_all(self):
        for url in self.urls():
            try:
                self.stop(url)
            except MXNetError:
                pass
