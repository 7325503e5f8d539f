"""Training checkpoints on one process (counterpart of
``mxnet_tpu/checkpoint.py``): periodic atomic saves, resume, retention,
preemption.

- **Atomic**: a checkpoint is written to a tmp directory and renamed to
  ``step-<N>`` after its ``DONE`` sentinel; :meth:`~CheckpointManager.latest`
  sees complete directories only.
- **Local layout**: ``model.params`` (``serialization``),
  ``trainer.states`` (``Trainer.save_states``' pickle) and
  ``manifest.json`` with the global key's ``seed_state``, the step, the
  metric, ``meta`` and ``extra``.
- **Sharded layout** (``sharded=True``) as one process writes it:
  ``shards-0.npz`` with ``param.<name>`` and ``state.<name>`` entries
  keyed ``name|0:d0;0:d1`` (the whole array is the one shard), optimizer
  state from ``state_arrays`` (``TrainStep.state_arrays``). bf16 entries
  are raw 2-byte records, as numpy stores the JAX package's bfloat16.
- **Async** (``blocking=False``): the host snapshot is taken on the
  caller's thread, the files are written on a background thread;
  :meth:`~CheckpointManager.wait` joins it and re-raises its failure once,
  and runs before every save and restore.

- **Publish** (``publish_weights_dir``): after every completed save the
  checkpoint's parameters are also published as a serving weight version
  (``serve.registry``), the train-to-serve bridge; a failed publish is
  logged, never raised.

The files are the JAX package's, so each package resumes the other's
checkpoints. More than one process and ``health=`` are not ported
(ROADMAP Queue 1 item 8) and raise; the port records no checkpoint
metrics.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import _random, serialization
from .base import MXNetError
from .gluon.block import load_parameters

__all__ = ["CheckpointManager"]

logger = logging.getLogger(__name__)

_DONE = "DONE"
_LATER = "is not ported yet (ROADMAP Queue 1 item 8: kvstore and parallel)"


def _index_key(name: str, shape) -> str:
    """npz key of an array held whole by one process: 'name|0:d0;0:d1'."""
    return f"{name}|{';'.join(f'0:{int(d)}' for d in shape)}"


def _to_npz(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_npz(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype: records of the same
    width are viewed (bf16 is stored as raw 2-byte records), others cast."""
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(np.array(a, copy=True)).to(torch.bfloat16)
    want = torch.empty((), dtype=like.dtype).numpy().dtype
    if a.dtype != want:
        a = a.view(want) if a.dtype.itemsize == want.itemsize else a.astype(want)
    return torch.from_numpy(np.array(a, copy=True))


def _multi_process() -> bool:
    return (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


class CheckpointManager:
    """Checkpoints of a training run under ``directory``::

        mgr = CheckpointManager(dir, net=net, trainer=trainer, keep_last=3)
        start = mgr.restore_or_init()       # 0 when fresh
        mgr.handle_preemption()             # SIGTERM-safe
        for step in range(start, total):
            ...train...
            mgr.step(step, metric=loss)     # saves when the period elapses
    """

    def __init__(self, directory: str, net=None, trainer=None,
                 period: int = 100, keep_last: int = 3,
                 keep_best: bool = False, mode: str = "min",
                 extra_state: Optional[Callable[[], dict]] = None,
                 restore_extra: Optional[Callable[[dict], None]] = None,
                 sharded: bool = False,
                 state_arrays: Optional[Callable[[], Dict[str, Any]]] = None,
                 write_state_arrays: Optional[Callable[[Dict[str, Any]], None]] = None,
                 blocking: bool = True,
                 publish_weights_dir: Optional[str] = None,
                 health: Optional[Any] = None):
        """``net``: an ``nn.Module`` (parameters by ``named_parameters()``
        name); ``trainer``: a ``gluon.Trainer`` (local layout only).
        ``sharded=True`` takes optimizer state through ``state_arrays`` /
        ``write_state_arrays``; ``extra_state()`` is stored in the manifest
        and handed to ``restore_extra`` on restore. ``blocking=False``
        makes periodic saves asynchronous. ``publish_weights_dir``: after
        every completed save the parameters are also published there as a
        serving weight version (``serve.registry.publish_weights``, or
        ``publish_from_checkpoint`` for the sharded layout), which polling
        replicas swap to; a failed publish is logged, never raised."""
        if health is not None:
            raise MXNetError("CheckpointManager(health=...) is not ported yet: it "
                             "waits for observability/health.py (ROADMAP Queue 1 "
                             "item 8)")
        if _multi_process():
            raise MXNetError(f"CheckpointManager across processes {_LATER}")
        if sharded and trainer is not None:
            raise MXNetError("sharded checkpoints take optimizer state via "
                             "state_arrays (e.g. TrainStep.state_arrays), "
                             "not a Trainer")
        if mode not in ("min", "max"):
            raise MXNetError("mode must be 'min' or 'max'")
        self.directory = directory
        self.net = net
        self.trainer = trainer
        self.sharded = sharded
        self.publish_weights_dir = publish_weights_dir
        self._state_arrays = state_arrays
        self._write_state_arrays = write_state_arrays
        self.period = max(1, period)
        self.keep_last = keep_last
        self.keep_best = keep_best
        self.mode = mode
        self._best: Optional[float] = None
        self._extra_state = extra_state
        self._restore_extra = restore_extra
        # guards the best-metric decision and its symlink swap only
        self._lock = threading.Lock()
        self._preempted = False
        self._preempt_signum = None
        self.blocking = bool(blocking)
        # non-daemon: a clean exit finishes an in-flight write
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_err: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- info
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:010d}")

    def checkpoint_health(self, step: int) -> Optional[Dict[str, Any]]:
        """The ``health`` tag of a complete checkpoint's manifest (None when
        untagged: the walk-backs count it healthy)."""
        try:
            with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
                return json.load(f).get("health")
        except (OSError, ValueError):
            return None

    def last_healthy(self) -> Optional[int]:
        """Newest complete checkpoint whose manifest is not tainted."""
        for step in reversed(self.checkpoints()):
            tag = self.checkpoint_health(step)
            if tag is None or tag.get("healthy", True):
                return step
        return None

    def checkpoints(self):
        """Sorted steps of the COMPLETE checkpoints on disk."""
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if not name.startswith("step-") or ".tmp" in name:
                continue
            if not os.path.exists(os.path.join(self.directory, name, _DONE)):
                continue        # partial: crashed before the sentinel
            try:
                steps.append(int(name.split("-")[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest(self) -> Optional[int]:
        steps = self.checkpoints()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- save
    def save(self, step: int, metric: Optional[float] = None,
             meta: Optional[Dict[str, Any]] = None,
             blocking: Optional[bool] = None) -> str:
        """Write a complete checkpoint for ``step``. With ``blocking=False``
        (or the constructor's default) this returns once the state is
        snapshotted on the host; :meth:`wait` is the completion barrier,
        and the returned path exists once the write lands."""
        if blocking is None:
            blocking = self.blocking
        # at most one write in flight: wait for (and surface the error of)
        # the previous one
        self.wait()
        snap = self._snapshot_host()
        if blocking:
            path = self._write_snapshot(step, metric, meta, snap)
        else:
            path = self._step_dir(step)

            def _bg(snap=snap):
                try:
                    self._write_snapshot(step, metric, meta, snap)
                except Exception as e:  # noqa: BLE001 - re-raised by wait()
                    self._bg_err = e

            self._bg_thread = threading.Thread(target=_bg, name="mxnet-ckpt-write")
            self._bg_thread.start()
        return path

    def wait(self):
        """Block until an in-flight background save lands, re-raising its
        failure (exactly once)."""
        t = self._bg_thread
        if t is not None:
            t.join()
            self._bg_thread = None
        err, self._bg_err = self._bg_err, None
        if err is not None:
            raise MXNetError(f"async checkpoint save failed: {err!r}") from err

    # ------------------------------------------------ snapshot (caller)
    def _snapshot_host(self) -> Dict[str, Any]:
        """Host copies of everything the checkpoint holds, taken now: the
        write side never touches a live tensor."""
        snap: Dict[str, Any] = {"seed_state": _random.get_state()}
        if self._extra_state is not None:
            snap["extra"] = self._extra_state()
        if self.sharded:
            arrays = {}
            if self.net is not None:
                for name, p in self.net.named_parameters():
                    arrays[f"param.{name}"] = p
            if self._state_arrays is not None:
                for name, a in self._state_arrays().items():
                    arrays[f"state.{name}"] = a
            host = serialization.host_copies(list(arrays.values()))
            snap["shards"] = {_index_key(n, t.shape): _to_npz(t)
                              for n, t in zip(arrays, host)}
            return snap
        if self.net is not None:
            named = list(self.net.named_parameters())
            snap["params"] = dict(zip([n for n, _ in named], serialization.host_copies(
                [p for _, p in named])))
        if self.trainer is not None:
            snap["trainer"] = self.trainer._host_state_payload()
        return snap

    # ------------------------------------------------- write (bg-safe)
    def _write_snapshot(self, step, metric, meta, snap):
        if self.sharded:
            return self._write_sharded(step, metric, meta, snap)
        return self._write_local(step, metric, meta, snap)

    def _manifest(self, step, metric, meta, snap, **extra_fields):
        manifest = {"step": step, "metric": metric, "time": time.time(),
                    "seed_state": snap["seed_state"], "meta": meta or {}}
        manifest.update(extra_fields)
        if "extra" in snap:
            manifest["extra"] = snap["extra"]
        return manifest

    def _finish(self, tmp, final, manifest):
        """Manifest, sentinel, then the rename into place."""
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _DONE), "w") as f:
            f.write("ok\n")
        if os.path.exists(final):
            shutil.rmtree(final)
        try:
            os.rename(tmp, final)
        except OSError:
            # two saves of the SAME step raced the swap: the winner's
            # snapshot is complete and equivalent, so drop ours
            if not os.path.exists(final):
                raise
            shutil.rmtree(tmp, ignore_errors=True)

    def _tmp_dir(self, final):
        # thread-unique: a background write racing a blocking one never
        # shares a directory with it
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def _write_sharded(self, step, metric, meta, snap):
        final = self._step_dir(step)
        tmp = self._tmp_dir(final)
        try:
            if snap["shards"]:
                np.savez(os.path.join(tmp, "shards-0.npz"), **snap["shards"])
            self._finish(tmp, final, self._manifest(step, metric, meta, snap,
                                                    sharded=True))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        logger.info("sharded checkpoint saved: %s", final)
        self._maybe_publish(final, step)
        return final

    def _write_local(self, step, metric, meta, snap):
        final = self._step_dir(step)
        tmp = self._tmp_dir(final)
        try:
            if "params" in snap:
                serialization.save(os.path.join(tmp, "model.params"), snap["params"])
            if "trainer" in snap:
                self.trainer._write_states_payload(
                    os.path.join(tmp, "trainer.states"), snap["trainer"])
            self._finish(tmp, final, self._manifest(step, metric, meta, snap))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if metric is not None and self.keep_best:
            self._update_best(metric, final)
        self._prune()
        logger.info("checkpoint saved: %s", final)
        self._maybe_publish(final, step, snap.get("params"))
        return final

    def _maybe_publish(self, final: str, step: int, params=None):
        """Mirror a completed checkpoint into the serving weight-publish
        layout: the local layout publishes the host snapshot it holds, the
        sharded layout adapts the written directory. Best effort: a failed
        publish never fails the save."""
        if self.publish_weights_dir is None:
            return
        try:
            from .serve.registry import publish_from_checkpoint, publish_weights
            meta = {"step": step, "source_checkpoint": os.path.basename(final)}
            if params:
                version = publish_weights(self.publish_weights_dir, params, meta=meta,
                                          keep_last=self.keep_last or None)
            else:
                version = publish_from_checkpoint(final, self.publish_weights_dir,
                                                  meta=meta,
                                                  keep_last=self.keep_last or None)
            logger.info("published checkpoint step %d as serving weights v%d",
                        step, version)
        except Exception as e:
            logger.warning("checkpoint weight publish failed (training "
                           "unaffected): %s", e)

    def _update_best(self, metric, final):
        # the better-decision and the symlink swap are atomic together
        with self._lock:
            better = (self._best is None
                      or (metric < self._best if self.mode == "min" else metric > self._best))
            if not better:
                return
            self._best = metric
            best = os.path.join(self.directory, "best")
            if os.path.lexists(best) and not os.path.islink(best):
                shutil.rmtree(best)
            tmp_link = f"{best}.tmp-{os.getpid()}-{threading.get_ident()}"
            os.symlink(os.path.basename(final), tmp_link)
            os.replace(tmp_link, best)

    def _prune(self):
        steps = self.checkpoints()
        best_target = None
        best = os.path.join(self.directory, "best")
        if os.path.islink(best):
            try:
                best_target = int(os.readlink(best).split("-")[1])
            except (ValueError, OSError):
                best_target = None
        while self.keep_last and len(steps) > self.keep_last:
            victim = steps.pop(0)
            if victim == best_target:
                continue        # pinned by best
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, healthy_only: bool = False) -> int:
        """Load the checkpoint of ``step`` (default: the latest) and return
        its step; raises when there is none. ``healthy_only=True`` walks
        back from ``step`` (or the newest) to the newest checkpoint whose
        manifest is not tagged unhealthy; untagged manifests count as
        healthy."""
        self.wait()
        requested = step
        if healthy_only:
            step = None
            for s in reversed(self.checkpoints()):
                if requested is not None and s > requested:
                    continue
                tag = self.checkpoint_health(s)
                if tag is None or tag.get("healthy", True):
                    step = s
                    break
                logger.warning("restore(healthy_only): skipping tainted "
                               "checkpoint step %d (%s)", s, tag)
            if step is None:
                raise MXNetError(
                    f"no healthy checkpoint under {self.directory}"
                    + ("" if requested is None else f" at or before step {requested}"))
        elif step is None:
            step = self.latest()
        if step is None:
            raise MXNetError(f"no complete checkpoint under {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if self.sharded or manifest.get("sharded"):
            self._restore_sharded(path)
        else:
            if self.net is not None:
                load_parameters(self.net, os.path.join(path, "model.params"))
            if self.trainer is not None:
                self.trainer.load_states(os.path.join(path, "trainer.states"))
        if manifest.get("seed_state") is not None:
            _random.set_state(manifest["seed_state"])
        if self._restore_extra is not None and "extra" in manifest:
            self._restore_extra(manifest["extra"])
        if self.keep_best:
            # the best metric is behind the 'best' symlink
            self._best = self._read_best_metric()
        logger.info("restored checkpoint %s", path)
        return step

    @torch.no_grad()
    def _restore_sharded(self, path: str):
        with np.load(os.path.join(path, "shards-0.npz")) as z:
            def read(name, like):
                key = _index_key(name, like.shape)
                if key not in z.files:
                    raise MXNetError(f"sharded checkpoint: shard {key} not found — "
                                     "was it written with another model or sharding?")
                return _from_npz(z[key], like)

            if self.net is not None:
                for name, p in self.net.named_parameters():
                    p.copy_(read(f"param.{name}", p))
            if self._state_arrays is not None:
                if self._write_state_arrays is None:
                    raise MXNetError("sharded restore: state_arrays given "
                                     "without write_state_arrays")
                self._write_state_arrays({
                    name: read(f"state.{name}", a)
                    for name, a in self._state_arrays().items()})

    def _read_best_metric(self) -> Optional[float]:
        best = os.path.join(self.directory, "best")
        if not os.path.islink(best):
            return None
        try:
            with open(os.path.join(best, "manifest.json")) as f:
                return json.load(f).get("metric")
        except (OSError, ValueError):
            return None

    def restore_or_init(self, healthy_only: bool = False) -> int:
        """Resume from the latest complete checkpoint, or with
        ``healthy_only`` the newest untainted one; returns the step to
        CONTINUE from (0 when there is none)."""
        self.wait()
        if healthy_only:
            step = self.last_healthy()
            if step is None and self.latest() is not None:
                logger.warning("restore_or_init(healthy_only): every checkpoint "
                               "under %s is tainted; starting fresh", self.directory)
        else:
            step = self.latest()
        if step is None:
            return 0
        return self.restore(step, healthy_only=healthy_only) + 1

    # ------------------------------------------------------------- loop
    def step(self, step: int, metric: Optional[float] = None,
             meta: Optional[Dict[str, Any]] = None):
        """Call once per training step: saves when the period elapses or a
        preemption was signalled (then blocking, and re-raises the
        signal)."""
        if self._preempted or (step + 1) % self.period == 0:
            self.save(step, metric=metric, meta=meta,
                      blocking=True if self._preempted else None)
            if self._preempted:
                logger.warning("preemption checkpoint written at step %d; "
                               "re-raising signal", step)
                signal.raise_signal(self._preempt_signum)

    def handle_preemption(self, signals=(signal.SIGTERM,)):
        """Install handlers that flag a preemption: the NEXT :meth:`step`
        writes a checkpoint and re-raises the signal. Main thread only."""
        def handler(signum, frame):
            self._preempted = True
            self._preempt_signum = signum
            signal.signal(signum, signal.SIG_DFL)

        for s in signals:
            signal.signal(s, handler)
        return self
