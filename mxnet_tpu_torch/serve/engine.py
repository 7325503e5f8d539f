"""Continuous-batching inference engine over the KV-cache decode protocol
(counterpart of ``mxnet_tpu/serve/engine.py``, contiguous layout).

- **Slots.** The engine owns ``max_batch_size`` slots of one pooled
  [S, H, max_len, hd] cache per layer. A request holds one slot from
  prefill to completion; a finished slot is refilled from the queue
  between decode steps, so the batch never drains to refill.
- **Prefill** runs per admitted request at batch 1 over a prompt-length
  bucket (right-padded), writing the slot's cache rows in place, and
  selects token 0.
- **Decode** advances every occupied slot with one batched step over the
  power-of-two prefix of slots that covers them: per-slot positions,
  temperatures, seeds, sampling counters, eos ids and token budgets.
  ``multi_token=K`` runs K substeps per dispatch (models/generation.
  decode_multi_tokens) with token selection fused into the int8 head
  (K8) when the model carries one; tokens past a row's EOS or budget are
  discarded, so greedy output equals ``multi_token=1``.
- **Admission control.** A bounded FIFO queue, per-request deadlines,
  cancellation, and ``shutdown(drain=True)`` that finishes in-flight
  slots and completes queued requests with status ``shutdown``.

One background thread runs the loop; ``submit`` and ``result`` are safe
from any thread. The engine reads each dispatch's tokens back before the
next one (no lookahead). Token 0 of a request on a ``multi_token > 1``
engine with an int8 head is selected by the fused head from the prompt's
last hidden state, as ``generate(multi_token > 1)`` selects it (the JAX
engine samples it from materialised logits); greedy token 0 is the same
either way, because K3 and K8 compute the same logits.

Paged KV, prefix caching, speculation, grammar masks, live weight swaps,
page migration, HTTP, metrics and tuned configs are later slices: the
constructor raises on ``paged=True``, ``speculate`` and ``grammar``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..models import generation as _gen
from .bucketing import bucket_for

__all__ = ["InferenceEngine", "RequestHandle", "ServeResult",
           "QueueFullError", "EngineClosedError", "STATUS_OK",
           "STATUS_TIMEOUT", "STATUS_CANCELLED", "STATUS_SHUTDOWN",
           "STATUS_ERROR"]

STATUS_OK = "ok"
STATUS_TIMEOUT = "timeout"
STATUS_CANCELLED = "cancelled"
STATUS_SHUTDOWN = "shutdown"
STATUS_ERROR = "error"


class QueueFullError(MXNetError):
    """Admission control: the request queue is at max_queue_depth."""


class EngineClosedError(MXNetError):
    """The engine is shut down (or shutting down) and not accepting work."""


@dataclasses.dataclass
class ServeResult:
    """Terminal outcome of a request; ``generated_ids`` holds whatever was
    produced by completion, deadline or cancel."""
    status: str
    prompt_ids: List[int]
    generated_ids: List[int]
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    latency_s: float = 0.0
    error: Optional[str] = None

    @property
    def output_ids(self) -> List[int]:
        return list(self.prompt_ids) + list(self.generated_ids)

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class RequestHandle:
    """Future-like view of a submitted request."""

    def __init__(self, prompt_ids, max_new_tokens, temperature, eos_token_id,
                 seed, deadline):
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_token_id = eos_token_id
        self.seed = seed
        self.deadline = deadline
        self.submit_t = time.perf_counter()
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._cancelled = False

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """Ask for cancellation: a queued request is dropped, an in-flight
        one stops at the next step with partial output. False if the
        request already finished."""
        if self._event.is_set():
            return False
        self._cancelled = True
        return True

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block until the request reaches a terminal status."""
        if not self._event.wait(timeout):
            raise MXNetError("RequestHandle.result: timed out waiting for "
                             "completion (request still in flight)")
        return self._result

    def _complete(self, result: ServeResult):
        self._result = result
        self._event.set()


@dataclasses.dataclass
class _Slot:
    req: RequestHandle
    generated: List[int]


class InferenceEngine:
    """Continuous-batching serving engine for a GPT model of this package
    (``cache_spec``/``forward_cached_hidden`` protocol) on the model's
    device.

    Parameters
    ----------
    model : GPTModel, weights loaded (optionally ``quantize_net``-ed)
    max_batch_size : slot-pool size (concurrent in-flight requests)
    max_len : per-slot KV capacity; prompt + new tokens + (K - 1) must fit
    max_queue_depth : ``submit`` raises :class:`QueueFullError` beyond it
    min_prompt_bucket : smallest prompt-length bucket (power of two)
    multi_token : K tokens per decode dispatch (module docstring)
    bucket_growth : growth factor of the prompt-bucket ladder
    fused : ``True`` requires fused block packs, ``False`` their absence,
        ``None`` follows the model
    """

    def __init__(self, model, max_batch_size: int = 8, max_len: int = 256,
                 max_queue_depth: int = 64, min_prompt_bucket: int = 8,
                 multi_token: int = 1, bucket_growth: int = 2,
                 fused: Optional[bool] = None, paged: bool = False,
                 speculate: int = 0, grammar: bool = False):
        if paged:
            raise MXNetError("paged=True: the paged KV pool (kernels K6/K7) "
                             "is a later slice of the port")
        if speculate:
            raise MXNetError("speculate: self-speculative decoding is a later "
                             "slice of the port")
        if grammar:
            raise MXNetError("grammar=True: grammar-constrained decoding is a "
                             "later slice of the port")
        if max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        if max_len < 2:
            raise MXNetError("max_len must be >= 2")
        if multi_token < 1 or multi_token >= max_len:
            raise MXNetError("multi_token must be in [1, max_len)")
        if bucket_growth < 2:
            raise MXNetError("bucket_growth must be >= 2")
        if min_prompt_bucket < 1 or min_prompt_bucket & (min_prompt_bucket - 1):
            raise MXNetError("min_prompt_bucket must be a power of two")
        if max_len > model.cfg.max_position_embeddings:
            raise MXNetError(
                f"max_len ({max_len}) exceeds the model's "
                f"max_position_embeddings ({model.cfg.max_position_embeddings})")
        fused_blocks = any(blk._fused_pack is not None for blk in model.blocks)
        if fused is True and not fused_blocks:
            raise MXNetError("fused=True but the model has no fused decode "
                             "packs — quantize_net(..., fused_decode=True) first")
        if fused is False and fused_blocks:
            raise MXNetError("fused=False but the model has fused decode "
                             "enabled; call model.disable_fused_decode()")
        self.model = model
        self.device = model.device
        self.S = int(max_batch_size)
        self.L = int(max_len)
        self.K = int(multi_token)
        self.max_queue_depth = int(max_queue_depth)
        self.min_prompt_bucket = min(int(min_prompt_bucket), self.L)
        self._growth = int(bucket_growth)
        self._vocab = model.cfg.vocab_size
        self._head = model.head_weights() if self.K > 1 else None
        self._pools = model.new_caches(self.S, self.L)

        # host-side per-slot state (mutated only by the engine thread)
        self._slots: List[Optional[_Slot]] = [None] * self.S
        self._tokens = np.zeros(self.S, np.int32)
        self._pos = np.zeros(self.S, np.int32)
        self._temps = np.zeros(self.S, np.float32)
        self._seeds = np.zeros(self.S, np.int64)
        self._counters = np.zeros(self.S, np.int64)
        self._eos = np.full(self.S, -1, np.int64)
        self._remaining = np.zeros(self.S, np.int64)

        self._queue: "deque[RequestHandle]" = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = False
        self._closed = False
        self._abort_inflight = False
        self._thread: Optional[threading.Thread] = None

        # counters for stats()
        self._submitted = 0
        self._completed: Dict[str, int] = {}
        self._max_active = 0
        self._prefills = 0
        self._prefill_s = 0.0
        self._dispatches = 0
        self._substeps = 0
        self._decode_s = 0.0
        self._decode_tokens = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceEngine":
        """Launch the background continuous-batching loop."""
        with self._lock:
            if self._closed:
                raise EngineClosedError("engine already shut down")
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet-torch-serve", daemon=True)
        self._thread.start()
        return self

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the engine. ``drain=True`` finishes in-flight slots (queued
        requests complete with status 'shutdown'); ``drain=False`` also
        completes in-flight requests with their partial output."""
        with self._cond:
            self._closed = True
            self._running = False
            self._abort_inflight = not drain
            self._cond.notify_all()
            flushed = [] if self._thread is not None else list(self._queue)
            if self._thread is None:
                self._queue.clear()
        for req in flushed:
            self._finish_unstarted(req, STATUS_SHUTDOWN)
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    # ------------------------------------------------------------ submission
    def submit(self, input_ids, max_new_tokens: int,
               eos_token_id: Optional[int] = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               timeout_s: Optional[float] = None) -> RequestHandle:
        """Enqueue one request (one sequence of token ids). Returns a
        :class:`RequestHandle`; may raise :class:`QueueFullError` or
        :class:`EngineClosedError`."""
        prompt = [int(t) for t in np.asarray(input_ids).reshape(-1)]
        if not prompt:
            raise MXNetError("input_ids must hold at least one token")
        if any(t < 0 or t >= self._vocab for t in prompt):
            raise MXNetError(f"input_ids contain tokens outside [0, {self._vocab})")
        if max_new_tokens <= 0:
            raise MXNetError("max_new_tokens must be positive")
        _gen._validate_sampling(temperature, top_k, top_p)
        if temperature > 0 and self._head is None:
            raise MXNetError("temperature sampling on this engine needs "
                             "multi_token > 1 with an int8 head (the fused "
                             "sampler); otherwise it " + _gen._SAMPLING_LATER)
        if len(prompt) + max_new_tokens + (self.K - 1) > self.L:
            raise MXNetError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" + multi_token headroom ({self.K - 1}) exceeds the "
                f"engine's max_len ({self.L})")
        deadline = (time.perf_counter() + timeout_s
                    if timeout_s is not None else None)
        req = RequestHandle(prompt, int(max_new_tokens), float(temperature),
                            eos_token_id, int(seed), deadline)
        with self._cond:
            if self._closed or not self._running:
                raise EngineClosedError("engine is not running (call start(), "
                                        "or it was shut down)")
            if len(self._queue) >= self.max_queue_depth:
                raise QueueFullError(f"request queue full (max_queue_depth="
                                     f"{self.max_queue_depth})")
            self._queue.append(req)
            self._submitted += 1
            self._cond.notify_all()
        return req

    def generate(self, input_ids, max_new_tokens: int, timeout: Optional[float] = None,
                 **kwargs) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(input_ids, max_new_tokens, **kwargs).result(timeout)

    # ------------------------------------------------------------ loop
    def _loop(self):
        try:
            with torch.no_grad():
                self._loop_inner()
        except Exception:  # the engine thread's boundary: fail, never hang
            err = traceback.format_exc()
            with self._cond:
                self._running = False
                self._closed = True
                queued = list(self._queue)
                self._queue.clear()
            for req in queued:
                self._finish_unstarted(req, STATUS_ERROR, error=err)
            for s in range(self.S):
                if self._slots[s] is not None:
                    self._retire(s, STATUS_ERROR, error=err)

    def _loop_inner(self):
        while True:
            admits = []
            dead = []
            with self._cond:
                while self._running and not self._queue and not any(self._slots):
                    self._cond.wait(0.1)
                stopping = not self._running
                if stopping:
                    dead = [(req, STATUS_SHUTDOWN) for req in self._queue]
                    self._queue.clear()
                else:
                    now = time.perf_counter()
                    kept: "deque[RequestHandle]" = deque()
                    for req in self._queue:
                        if req._cancelled:
                            dead.append((req, STATUS_CANCELLED))
                        elif req.deadline is not None and now > req.deadline:
                            dead.append((req, STATUS_TIMEOUT))
                        else:
                            kept.append(req)
                    self._queue = kept
                    while self._queue and None in self._slots:
                        s = self._slots.index(None)
                        req = self._queue.popleft()
                        req.admit_t = now
                        self._slots[s] = _Slot(req, [])
                        admits.append((s, req))
            for req, status in dead:
                self._finish_unstarted(req, status)
            if stopping and self._abort_inflight:
                for s in range(self.S):
                    if self._slots[s] is not None:
                        self._retire(s, STATUS_SHUTDOWN)
            for s, req in admits:
                self._prefill(s, req)
            active = sum(slot is not None for slot in self._slots)
            self._max_active = max(self._max_active, active)
            if active:
                self._step()
            elif stopping:
                break

    # ------------------------------------------------------------ prefill
    def _prefill(self, s: int, req: RequestHandle):
        """Prefill one request into slot ``s`` and select its token 0."""
        t0 = time.perf_counter()
        P = len(req.prompt_ids)
        pb = bucket_for(P, self.min_prompt_bucket, self.L, self._growth)
        ids = np.zeros((1, pb), np.int32)
        ids[0, :P] = req.prompt_ids
        ids = torch.from_numpy(ids).to(self.device)
        caches = [pool[s:s + 1] for pool in self._pools]
        for c in caches:
            c.zero_()
        hidden, _ = _gen.decode_step_hidden(self.model, ids, 0, caches)
        if self._head is not None:
            from ..ops.fused_block_gemv import fused_lm_head_sample
            w_q, scale, vocab = self._head
            kb = _gen._key_bits([req.seed], [0])
            tok0 = fused_lm_head_sample(
                hidden[:, P - 1], w_q, scale, vocab,
                torch.as_tensor(kb).to(self.device),
                torch.tensor([req.temperature], device=self.device))
        else:
            # the JAX engine's logits over the whole bucket (its head
            # routing depends on the row count), read at the last prompt row
            logits = self.model._lm_head(hidden)
            tok0 = _gen.sample_tokens(logits[:, P - 1], [req.temperature])
        tok0 = int(tok0[0])
        now = time.perf_counter()
        self._prefills += 1
        self._prefill_s += now - t0
        req.first_token_t = now
        self._pos[s] = P
        self._counters[s] = 1
        self._temps[s] = req.temperature
        self._seeds[s] = req.seed & 0xFFFFFFFF
        self._eos[s] = -1 if req.eos_token_id is None else req.eos_token_id
        self._remaining[s] = req.max_new_tokens - 1   # token 0 is the first
        self._slots[s].generated.append(tok0)
        self._tokens[s] = tok0
        self._check_finished(s, now)

    # ------------------------------------------------------------ decode
    def _step(self):
        """One batched decode dispatch over the occupied slot prefix, read
        back and applied."""
        t0 = time.perf_counter()
        hi = max(s for s in range(self.S) if self._slots[s] is not None) + 1
        sb = bucket_for(hi, 1, self.S)
        live = [(s, self._slots[s]) for s in range(sb) if self._slots[s] is not None]
        dev = self.device
        caches = [pool[:sb] for pool in self._pools]
        tokens = torch.from_numpy(self._tokens[:sb].copy()).to(dev)
        pos = torch.from_numpy(self._pos[:sb].copy()).to(dev)
        if self.K > 1:
            done = torch.from_numpy(self._remaining[:sb] <= 0).to(dev)
            toks, _, steps, _, _ = _gen.decode_multi_tokens(
                self.model, tokens, pos, caches, self.K, self._temps[:sb],
                self._seeds[:sb], self._counters[:sb],
                eos_ids=self._eos[:sb], remaining=self._remaining[:sb],
                done=done, head=self._head)
            toks = toks.cpu().numpy()
        else:
            logits, _ = _gen.decode_step(self.model, tokens[:, None], pos, caches)
            toks = _gen.sample_tokens(logits[:, -1], self._temps[:sb])
            toks = toks.cpu().numpy()[:, None]
            steps = 1
        now = time.perf_counter()
        self._dispatches += 1
        self._substeps += steps
        self._decode_s += now - t0
        # the dispatch ran at this tick's clocks; advance them by K for
        # every occupied row (a row finishing early retires below)
        for s, _ in live:
            self._pos[s] += self.K
            self._counters[s] += self.K
            self._remaining[s] -= self.K
        for s, slot in live:
            for j in range(steps):
                tok = int(toks[s, j])
                slot.generated.append(tok)
                self._tokens[s] = tok
                self._decode_tokens += 1
                self._check_finished(s, now)
                if self._slots[s] is not slot:
                    break                  # rest of the K-vector: discard

    # ------------------------------------------------------------ completion
    def _check_finished(self, s: int, now: float):
        slot = self._slots[s]
        req = slot.req
        if req.eos_token_id is not None and slot.generated[-1] == req.eos_token_id:
            self._retire(s, STATUS_OK)
        elif len(slot.generated) >= req.max_new_tokens:
            self._retire(s, STATUS_OK)
        elif req._cancelled:
            self._retire(s, STATUS_CANCELLED)
        elif req.deadline is not None and now > req.deadline:
            self._retire(s, STATUS_TIMEOUT)

    def _reset_slot_state(self, s: int):
        self._tokens[s] = 0
        self._pos[s] = 0
        self._temps[s] = 0.0
        self._seeds[s] = 0
        self._counters[s] = 0
        self._eos[s] = -1
        self._remaining[s] = 0

    def _retire(self, s: int, status: str, error: Optional[str] = None):
        with self._lock:
            slot = self._slots[s]
            self._slots[s] = None
            self._completed[status] = self._completed.get(status, 0) + 1
        self._reset_slot_state(s)
        req = slot.req
        req._complete(ServeResult(
            status=status, prompt_ids=req.prompt_ids,
            generated_ids=list(slot.generated),
            queue_wait_s=(req.admit_t - req.submit_t
                          if req.admit_t is not None else None),
            ttft_s=(req.first_token_t - req.submit_t
                    if req.first_token_t is not None else None),
            latency_s=time.perf_counter() - req.submit_t, error=error))

    def _finish_unstarted(self, req: RequestHandle, status: str,
                          error: Optional[str] = None):
        with self._lock:
            self._completed[status] = self._completed.get(status, 0) + 1
        req._complete(ServeResult(status=status, prompt_ids=req.prompt_ids,
                                  generated_ids=[],
                                  latency_s=time.perf_counter() - req.submit_t,
                                  error=error))

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        """Request, prefill and decode counters. ``decode_substeps`` counts
        incremental forwards (each runs every block once); ``decode_s`` is
        the host wall time of the decode dispatches, read-back included."""
        with self._lock:
            return {
                "submitted": self._submitted,
                "completed": dict(self._completed),
                "queue_depth": len(self._queue),
                "max_active": self._max_active,
                "prefills": self._prefills,
                "prefill_s": self._prefill_s,
                "decode_dispatches": self._dispatches,
                "decode_substeps": self._substeps,
                "decode_tokens": self._decode_tokens,
                "decode_s": self._decode_s,
            }
