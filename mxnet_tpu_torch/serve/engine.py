"""Continuous-batching inference engine over the KV-cache decode protocol
(counterpart of ``mxnet_tpu/serve/engine.py``, contiguous and paged
layouts).

- **Slots.** The engine owns ``max_batch_size`` slots. A request holds one
  slot from prefill to completion; a finished slot is refilled from the
  queue between decode steps, so the batch never drains to refill.
- **Contiguous layout** (``paged=False``): one pooled [S, H, max_len, hd]
  cache per layer. Prefill runs per admitted request at batch 1 over a
  prompt-length bucket (right-padded), writing the slot's cache rows in
  place, and selects token 0.
- **Paged layout** (``paged=True``, the default on the card when
  ``max_len`` is a page multiple): one pool of ``num_pages + 1`` pages per
  layer, leased to slots as they grow through ``serve/paging.PagePool``.
  Prefills run in chunks of ``prefill_chunk`` tokens, at most one chunk
  per tick while other requests decode (the final chunk is bucketed and
  selects token 0); completed prompts are published to a prefix cache
  whose pages later requests map instead of prefilling, copying a shared
  page before their first write into it (copy-on-write). When the pool
  runs out, the youngest request is preempted and requeued at the front;
  its resume re-prefills ``prompt + generated`` and continues its sampling
  stream at the same counter, so it goes on with the tokens of an
  uninterrupted run (the generated tokens' K/V rows are recomputed by
  prefill: the same bits on the CPU, equal up to rounding on the card). A
  decode step of a fused model runs each block as one launch of K6, or of
  K7 past K6's context gate.
- **Decode** advances every occupied slot with one batched step over the
  power-of-two prefix of slots that covers them: per-slot positions,
  temperatures, top-k / top-p, seeds, sampling counters, eos ids and token
  budgets.
  ``multi_token=K`` runs K substeps per dispatch (models/generation.
  decode_multi_tokens) with token selection fused into the quantized
  head (K8, int8 or int4 lane) when the model carries one; tokens past a row's EOS or budget are
  discarded, so greedy output equals ``multi_token=1``.
- **Admission control.** A bounded FIFO queue, per-request deadlines,
  cancellation, and ``shutdown(drain=True)`` that finishes in-flight
  slots and completes queued requests with status ``shutdown``.

- **Decode lookahead** (``lookahead=True``, the default): the loop
  dispatches step N+1, fed step N's device-resident last tokens, before it
  reads step N's tokens, so the read overlaps the next step's work. Step
  N's [B, K] tokens are copied to pinned host memory right after its
  dispatch, with an event, and read after N+1 is dispatched. The pipeline
  drains whenever the decoding row set or its bucket changes (admission,
  retire, a prefill finishing, preemption): the speculative step's tokens
  of retired rows are discarded and its writes land where the next
  prefill or the row's own next write overwrites them, so the output is
  token for token that of ``lookahead=False``. A dispatch that fails
  first reads the pending step, so no computed token is lost.
- **Warm-up as CUDA-graph capture** (:meth:`InferenceEngine.warmup`): on
  the card every decode dispatch (per batch bucket, substep count and
  sampling branch) and every paged prefill chunk (per chunk bucket) is one
  captured ``torch.cuda.CUDAGraph`` over fixed input buffers, filled by
  one stream-ordered copy from pinned staging per dispatch; steady-state
  serving replays graphs and captures nothing (``stats()["captures"]``
  stays put: the port's zero-recompile contract). A step first needed
  after ``warmup()`` is captured then, and counted. A failed capture
  raises, naming the bucket; nothing serves eagerly on the card instead.
  On the CPU every entry is the same function run eagerly. The contiguous
  prefill (once per request, through a per-slot cache view) and token 0's
  head and read stay eager.

One background thread runs the loop; ``submit`` and ``result`` are safe
from any thread.

Sampling keys every request's stream with ``fold_in(key(seed), counter)``
(``counter`` = tokens the request has emitted), as the JAX engine does.
Token 0 is drawn by ``generation.sample_tokens`` from materialised
logits at that counter, in both layouts and on a resume: the head runs on
the last real prompt row of the prefill's hidden state alone (the JAX
engine materialises the whole bucket's logits and reads that row; a row's
logits do not depend on its batch). On the card one row takes the head
GEMV's warp route (K3, or K4), whose argmax equals K8's bit for bit, so a
greedy token 0 is the one ``generate()`` selects. Later tokens of a
``multi_token > 1`` engine with a quantized head go through the fused
head: greedy rows exact, unfiltered T > 0 rows on K8's hash-Gumbel
stream (the TPU kernel's; the JAX package's CPU path draws
``sample_tokens`` there, so those rows, and only those, differ from JAX
on the CPU by design), and a batch with any top-k/top-p row on
``sample_tokens``, as the JAX engine draws it.

- **Grammar-constrained decoding** (``grammar=True``): ``submit(...,
  grammar=)`` takes a regex, a JSON-schema dict or a compiled
  :class:`~mxnet_tpu_torch.serve.grammar.TokenGrammar` and every token of
  the request is drawn under the automaton's mask (serve/grammar.py). The
  per-slot tables (``cls`` [S, V], ``nxt`` [S, G, G], ``accept`` [S, G],
  G = :data:`~mxnet_tpu_torch.serve.grammar.GRAMMAR_MAX_STATES`) are one
  device buffer that every step reads, uploaded only when a slot's
  grammar changed; unconstrained slots carry identity tables, so
  constrained and free requests share a batch. The host's automaton
  ledger is authoritative; a decode step also advances the state on the
  device and writes it back into its inputs, so a lookahead dispatch reads
  the next state without a host trip. Token 0 is drawn under the mask of
  state 0, or of the state a resumed request's tokens lead to. Exclusive
  with ``multi_token > 1``, as in the JAX engine.
- **Self-speculative decoding** (``speculate=K``): decode proceeds in
  draft-verify rounds. K - 1 tokens are drafted from each request's own
  history (serve/speculate.py, n-gram lookup, no draft model); one
  captured verify step per batch bucket and sampling branch runs the
  [sb, K] inputs at positions ``pos..pos+K-1`` and selects every column
  with the key the non-speculative path uses there
  (``generation.spec_verify_tokens``), so acceptance is equality and the
  output is that of ``speculate=0``: token for token on the CPU, where
  both paths take the plain versions. On the card a verify runs the
  unfused layers (K3 and the plain cached attention) where ``speculate=0``
  runs the block kernels, so a near-tie can flip a greedy token (the
  README states the contract). Under a grammar the drafts are rewritten
  legal (``speculate.constrain_draft``) and each column takes the mask of
  its state. Rounds are synchronous (no lookahead); the clocks advance per
  token appended at the read. Exclusive with ``multi_token > 1``.

- **Teacher-forced scoring** (:meth:`InferenceEngine.score`): per-token
  log-probabilities of a given sequence in one forward of its prompt
  bucket over fresh contiguous caches (both layouts): no decode loop, no
  slot, no pool traffic, so it runs from any thread while the engine
  serves. On the card each bucket is one CUDA graph (:meth:`warmup_score`
  captures the ladder) in a memory pool and on a stream of its own, and a
  weight lock makes every score see one whole weight set.
- **Live weight swaps** (:meth:`InferenceEngine.swap_weights`): a
  published weight set (``serve/registry.py``) is validated against the
  live parameters, staged, and copied in place into them by the engine
  loop at the next tick boundary. The captured graphs read those
  addresses, so nothing is recaptured (``stats()["captures"]`` stays put)
  and in-flight requests decode on across the swap. A quantized model's
  int8 and int4 tables are derived from the swapped weights in place, as
  ``quantize_net`` derives them (the JAX package holds them as trace
  constants, which its swap does not reach). Engines with fused decode
  packs or a fused head refuse, as the JAX engine does.
- **Drain** (:meth:`InferenceEngine.begin_drain`): submits raise at once,
  in-flight slots finish, queued requests complete with status
  ``shutdown``.
- **Telemetry.** The JAX engine's ``mxnet_serve_*`` families at its sites
  (``metrics``), request spans under a W3C ``traceparent``
  (``observability.trace``: ``serve.request`` > ``serve.queue``,
  ``serve.prefill`` > ``serve.prefill_chunk``, ``serve.decode_chunk``),
  flight-recorder events, and per-token stream events for SSE
  (``submit(stream=True)``). ``mxnet_serve_compiles_total`` counts the
  steps built (captures on the card, where JAX counts compiles), and each
  built step adds its launch sites to ``mxnet_decode_launches_total``.

- **Page migration** (the cache-aware fleet, serve/cachefleet.py):
  :meth:`InferenceEngine.export_pages` reads a prompt's cached full pages
  (one ``index_select`` a pool, on the loop's stream) into the kvstore
  page wire (``kvstore.comm``); :meth:`InferenceEngine.import_pages`
  verifies each shipped page (chain hash, alignment, payload count, shape
  and dtype; a failure is dropped and counted) and copies it in place into
  freshly leased pages published in the prefix cache. Both land at a tick
  boundary of the loop; the pools are never rebound, so the captured
  graphs go on reading them and nothing is recaptured. A preemption with
  a rescue hook installed exports the victim's pages before releasing
  them and hands the request to the hook; ``submit(resume=)`` continues
  a migrated request's stream. Tuned configs are a later slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import queue as _qmod
import threading
import time
import traceback
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _prng
from .. import metrics as _metrics
from ..base import MXNetError
from ..kvstore.comm import decode_kv_pages, encode_kv_pages
from ..models import generation as _gen
from ..observability import recorder as _recorder
from ..observability import trace as _trace
from ..ops.int8_gemv import count_launches, note_build, record_graph
from . import grammar as _grammar
from . import speculate as _spec
from .bucketing import bucket_for, bucket_ladder
from .paging import OutOfPages, PagePool, pages_for, prefix_key
from .registry import _host_tensor

__all__ = ["InferenceEngine", "RequestHandle", "ServeResult",
           "QueueFullError", "EngineClosedError", "STATUS_OK",
           "STATUS_TIMEOUT", "STATUS_CANCELLED", "STATUS_SHUTDOWN",
           "STATUS_ERROR"]

STATUS_OK = "ok"
STATUS_TIMEOUT = "timeout"
STATUS_CANCELLED = "cancelled"
STATUS_SHUTDOWN = "shutdown"
STATUS_ERROR = "error"

#: n-gram window of the prompt-lookup draft source (the JAX knob
#: ``serve_spec_lookup``'s default)
SPEC_LOOKUP = 4
#: prefix-cache roots a paged engine advertises in ``stats()`` and
#: ``/healthz`` (the JAX knob ``serve_prefix_advert``'s default)
PREFIX_ADVERT = 8
#: seconds an export staged on a running engine waits for a tick boundary
EXPORT_TIMEOUT_S = 60.0


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
    #: trace id of the request's span tree (the ``/trace/{id}`` key); set
    #: only while tracing is enabled, else None
    trace_id: Optional[str] = None

    @property
    def output_ids(self) -> List[int]:
        return list(self.prompt_ids) + list(self.generated_ids)

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class RequestHandle:
    """Future-like view of a submitted request."""

    def __init__(self, prompt_ids, max_new_tokens, temperature, eos_token_id,
                 seed, deadline, top_k=0, top_p=1.0):
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.seed = seed
        self.deadline = deadline
        self.submit_t = time.perf_counter()
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._cancelled = False
        # tokens generated before a preemption; the resume re-prefills them
        self._resume: Optional[List[int]] = None
        #: the compiled grammar constraining this request (None: free)
        self.grammar: Optional[_grammar.TokenGrammar] = None
        self._status = "queued"
        # request span tree: root and the open phase spans (None while
        # tracing is off: one is-None check per site)
        self._trace = None
        self._span_queue = None
        self._span_prefill = None
        # submit(stream=True): ("token", id) per emitted token, then
        # ("done", ServeResult); the SSE frontend drains it
        self._events: Optional["_qmod.Queue"] = None

    @property
    def status(self) -> str:
        """``queued``, ``running``, or the terminal status."""
        return self._status

    @property
    def trace_id(self) -> Optional[str]:
        return self._trace.trace_id if self._trace is not None else None

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
        self._status = result.status
        if self._events is not None:
            self._events.put(("done", result))
        self._event.set()

    def _emit(self, tok: int):
        if self._events is not None:
            self._events.put(("token", int(tok)))


@dataclasses.dataclass
class _Slot:
    req: RequestHandle
    generated: List[int]
    t_last: float = 0.0


@dataclasses.dataclass
class _Prefill:
    """A paged prefill in progress: the ids to prefill (prompt + resumed
    tokens), the next position to write, and the sampling counter of its
    token 0 (the number of tokens already emitted)."""
    ids: List[int]
    cursor: int
    counter0: int
    t0: float


@dataclasses.dataclass
class _PendingStep:
    """One dispatched decode step whose tokens are not read yet (the
    lookahead window). ``slots`` snapshots the (index, slot) rows at
    dispatch, so the read skips rows retired or refilled since (identity
    check); ``toks`` is the pinned host [sb, K] copy that ``event`` (None
    on the CPU) marks complete."""
    sb: int
    slots: List[Tuple[int, "_Slot"]]
    t0: float
    steps: int
    toks: Any
    event: Any


_ALIGN = 16


class _Buffers:
    """The fixed inputs of a family of steps: one byte buffer on the device
    holding named fields (``self.<name>`` are device views, what a captured
    graph reads), and two host staging copies of the same layout (pinned on
    the card) with numpy views. A dispatch fills the next staging copy and
    :meth:`upload` moves a byte range of it with one stream-ordered copy;
    the copy's event keeps the dispatch after next from overwriting a
    staging copy the device may still be reading."""

    def __init__(self, device, fields):
        self._layout = {}
        off = 0
        for name, shape, dtype in fields:
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            self._layout[name] = (off, n, tuple(shape), dtype)
            off += -(-n // _ALIGN) * _ALIGN
        self.nbytes = off
        cuda = device.type == "cuda"
        self.dev = torch.zeros(off, dtype=torch.uint8, device=device)
        for name in self._layout:
            setattr(self, name, self._view(self.dev, name))
        self._host = [torch.zeros(off, dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        self._np = [{name: self._view(h, name).numpy() for name in self._layout}
                    for h in self._host]
        self._events = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._used = [False, False]
        self._i = 1

    def _view(self, buf, name):
        off, n, shape, dtype = self._layout[name]
        return buf[off:off + n].view(dtype).reshape(shape)

    def offset(self, name: str) -> int:
        return self._layout[name][0]

    def host(self) -> Dict[str, np.ndarray]:
        """The next staging copy's numpy views by field, once the copy that
        last read it has completed."""
        self._i ^= 1
        ev = self._events[self._i]
        if ev is not None and self._used[self._i]:
            ev.synchronize()
        return self._np[self._i]

    def upload(self, start: int, end: int):
        """Copy bytes [start, end) of the current staging copy into the
        device buffer, ordered on the current stream."""
        if end > start:
            self.dev[start:end].copy_(self._host[self._i][start:end], non_blocking=True)
        ev = self._events[self._i]
        if ev is not None:
            ev.record()
            self._used[self._i] = True


class _Step:
    """A decode dispatch or prefill chunk of one bucket: ``fn`` reads the
    bucket's fixed input buffers and returns its output. On the card
    ``graph`` is ``fn`` captured as a CUDA graph, ``out`` its output and
    ``tally`` its launch records; calling replays the graph and counts the
    replay. Elsewhere calling runs ``fn``, and ``tally`` holds the launch
    records of the build's first run. ``calls`` counts the calls, so that
    ``calls`` times ``tally`` are this step's launches on this engine
    (the process-wide counters mix every engine's)."""

    def __init__(self, fn: Callable, graph=None, out=None, tally=None):
        self.fn = fn
        self.graph = graph
        self.out = out
        self.tally = tally
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        self.tally.replayed()
        return self.out


# holders of _no_collection across every engine and thread of the process,
# and whether the collector ran before the first of them disabled it
_GC_LOCK = threading.Lock()
_GC_HOLDS = 0
_GC_WAS_ENABLED = False


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic collector off for the block. A collection that
    starts inside a graph capture runs the finalizers of whatever garbage
    it finds in the capturing thread, and a finalizer's CUDA call that a
    capture forbids invalidates the graph. The switch is process-wide and
    several engines capture at once (a spawner warming a new replica while
    another serves, a registry's engines), so the holds are counted: the
    first holder disables the collector and the last one out restores it,
    in whatever order the captures end."""
    global _GC_HOLDS, _GC_WAS_ENABLED
    with _GC_LOCK:
        if _GC_HOLDS == 0:
            _GC_WAS_ENABLED = gc.isenabled()
            gc.disable()
        _GC_HOLDS += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLDS -= 1
            if _GC_HOLDS == 0 and _GC_WAS_ENABLED:
                gc.enable()


def _diff_axes(spec1, spec2, what, fn):
    """Per entry of two specs of one model (at 1 and at 2 rows or pages),
    the one axis where their shapes differ; raises where it is not one."""
    axes = []
    for (s1, _), (s2, _) in zip(spec1, spec2):
        diffs = [i for i, (a, b) in enumerate(zip(s1, s2)) if a != b]
        if len(diffs) != 1:
            raise MXNetError(f"cannot infer {what} from {fn} shapes {s1} vs {s2}")
        axes.append(diffs[0])
    return axes


class InferenceEngine:
    """Continuous-batching serving engine for any model of the KV-cache
    protocol (``cache_spec``/``forward_cached_hidden``, and
    ``cache_spec_paged``/``forward_cached_paged_hidden`` for the paged
    pool: GPT and Llama, per-layer or stacked decoder) on the model's
    device. Each cache's batch axis (each pool's page axis) is the one
    axis where ``cache_spec(1, L)`` and ``cache_spec(2, L)`` differ: 0 for
    per-layer caches, 1 for the stacked decoder's [layers, B, ...].

    Parameters
    ----------
    model : GPTModel or LlamaForCausalLM, weights loaded (optionally
        ``quantize_net``-ed)
    max_batch_size : slot-pool size (concurrent in-flight requests)
    max_len : per-slot KV capacity; prompt + new tokens + (K - 1) must fit
    max_queue_depth : ``submit`` raises :class:`QueueFullError` beyond it
    min_prompt_bucket : smallest prompt-length bucket (power of two)
    lookahead : dispatch decode step N+1 before reading step N (module
        docstring); greedy output is that of ``lookahead=False``
    multi_token : K tokens per decode dispatch (module docstring)
    bucket_growth : growth factor of the prompt-bucket ladder
    fused : ``True`` requires fused block packs, ``False`` their absence,
        ``None`` follows the model
    paged : the paged KV pool; ``None`` turns it on when the model is on
        the card and ``max_len % page_size == 0``, as the JAX engine does
        on the TPU
    page_size : tokens per page (16, the JAX knob's default)
    num_pages : leasable pages (default ``S * max_len / page_size``, the
        contiguous layout's bytes); the pools carry one more, the sink
    prefix_cache : publish prompts and map shared prefixes
    prefill_chunk : tokens per prefill chunk (default ``page_size``)
    speculate : verify width K of self-speculative decoding (0 = off, else
        >= 2 and < ``max_len``; module docstring); prompt + new tokens +
        (K - 1) must fit ``max_len``
    spec_draft : drafts proposed per round (0, the default: ``speculate -
        1``); the rest of the row repeats the current token
    spec_lookup : longest n-gram the draft source matches
        (:data:`SPEC_LOOKUP`)
    grammar : serve grammar-constrained requests (module docstring)
    name : the model name this engine serves (``/generate``'s ``model``
        key, the ``model`` label of the weight-version metrics)
    tier : the disaggregated-fleet tier advertised in ``stats()`` and
        ``/healthz`` (``"prefill"``, ``"decode"``; None = mixed)
    prefix_advert : prefix-cache roots a paged engine advertises
        (:data:`PREFIX_ADVERT`; 0 = none)

    Diagnostic: ``engine._eager = True``, set before :meth:`start` and
    :meth:`warmup`, makes the card run every step's function eagerly
    instead of capturing and replaying it (the comparison of
    ``chip_smoke.py``); it is not a serving mode.
    """

    def __init__(self, model, max_batch_size: int = 8, max_len: int = 256,
                 max_queue_depth: int = 64, min_prompt_bucket: int = 8,
                 lookahead: bool = True,
                 multi_token: int = 1, bucket_growth: int = 2,
                 fused: Optional[bool] = None, paged: Optional[bool] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, prefill_chunk: Optional[int] = None,
                 speculate: int = 0, spec_draft: int = 0,
                 spec_lookup: int = SPEC_LOOKUP, grammar: bool = False,
                 name: str = "default", tier: Optional[str] = None,
                 prefix_advert: int = PREFIX_ADVERT):
        if max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        if max_len < 2:
            raise MXNetError("max_len must be >= 2")
        if multi_token < 1 or multi_token >= max_len:
            raise MXNetError("multi_token must be in [1, max_len)")
        if speculate < 0 or speculate == 1:
            raise MXNetError("speculate must be 0 (off) or >= 2 (the verify "
                             "width: current token + drafts)")
        if speculate >= max_len:
            raise MXNetError("speculate must be < max_len")
        if speculate and multi_token > 1:
            raise MXNetError(
                "speculate and multi_token > 1 are mutually exclusive: both "
                "own the decode dispatch (the verify step IS a multi-token "
                "dispatch — up to K tokens per round-trip)")
        if spec_draft < 0:
            raise MXNetError("spec_draft must be >= 0 (0 = full width)")
        if spec_lookup < 1:
            raise MXNetError("spec_lookup must be >= 1")
        if prefix_advert < 0:
            raise MXNetError("prefix_advert must be >= 0 (0 = no advert)")
        if grammar and getattr(model.cfg, "vocab_size", None) is None:
            raise MXNetError(
                "grammar=True requires a model config with vocab_size (the "
                "token-mask automaton is built over the vocabulary)")
        if grammar and multi_token > 1:
            raise MXNetError(
                "grammar=True and multi_token > 1 are mutually exclusive: the "
                "on-device multi-token loop cannot advance the automaton "
                "between substeps — use speculate=K for multi-token grammar "
                "decoding (the verify masks every draft position)")
        if bucket_growth < 2:
            raise MXNetError("bucket_growth must be >= 2")
        if min_prompt_bucket < 1 or min_prompt_bucket & (min_prompt_bucket - 1):
            raise MXNetError("min_prompt_bucket must be a power of two")
        if not _gen._can_cache(model):
            raise MXNetError(
                "InferenceEngine requires the KV-cache decode protocol "
                "(cache_spec/forward_cached) and a config that supports it")
        max_pos = getattr(getattr(model, "cfg", None), "max_position_embeddings", None)
        if max_pos is not None and max_len > max_pos:
            raise MXNetError(
                f"max_len ({max_len}) exceeds the model's "
                f"max_position_embeddings ({max_pos})")
        fused_blocks = any(getattr(blk, "_fused_pack", None) is not None
                           for blk in getattr(model, "blocks", ()) or ())
        if fused is True and not fused_blocks:
            raise MXNetError("fused=True but the model has no fused decode "
                             "packs — quantize_net(..., fused_decode=True) first")
        if fused is False and fused_blocks:
            raise MXNetError("fused=False but the model has fused decode "
                             "enabled; call model.disable_fused_decode()")
        self.model = model
        self.device = model.device
        self.name = str(name)
        self.tier = str(tier) if tier else None
        self._prefix_advert = int(prefix_advert)
        self._fused_blocks = fused_blocks
        # live weight swaps: the parameters by their publish names
        # (``named_parameters()``: the JAX package's collect_params names),
        # the served version, and staged swaps applied by the loop at a
        # tick boundary ({"params", "version", "evt", "ok"}); the weights
        # lock makes a score see all-old or all-new weights
        self._params: Dict[str, torch.Tensor] = dict(model.named_parameters())
        self.weight_version = 0
        self._weight_swaps = 0
        self._swaps: List[Dict[str, Any]] = []
        # staged page-migration operations ({"kind": "import"|"export",
        # ..., "evt", "result", "error"}), applied by the loop at a tick
        # boundary like a weight swap: the loop owns the pools and the ledger
        self._page_ops: List[Dict[str, Any]] = []
        # preemption rescue (serve/cachefleet installs it): called as
        # hook(engine, req, wire_doc) -> bool from _preempt; True = the hook
        # took the request (it resumes on another replica), False or a
        # raise = requeue here
        self._migrate_hook = None
        self._weights_lock = threading.Lock()
        self._weights_event = None
        #: checkpoint health tag of the served weights (WeightRefresher)
        self.weight_health = None
        self.S = int(max_batch_size)
        self.L = int(max_len)
        self.K = int(multi_token)
        # speculation: the verify width (0 = off), drafts per round, n-gram
        # window; _adv = cache rows a dispatch may write past a row's
        # position (the admission headroom and the page-lease horizon)
        self.spec = int(speculate)
        self._n_draft = (min(int(spec_draft) or self.spec - 1, self.spec - 1)
                         if self.spec else 0)
        self._spec_lookup = int(spec_lookup)
        self._adv = max(self.K, self.spec or 1)
        self._grammar = bool(grammar)
        self.max_queue_depth = int(max_queue_depth)
        self.min_prompt_bucket = min(int(min_prompt_bucket), self.L)
        self._growth = int(bucket_growth)
        # each cache's batch axis: per-layer caches 0, stacked [layers, B, ...] 1
        self._baxes = _diff_axes(model.cache_spec(1, self.L), model.cache_spec(2, self.L),
                                 "cache batch axis", "cache_spec")
        self._vocab = model.cfg.vocab_size
        self._head = model.head_weights() if self.K > 1 else None
        if paged is None:
            paged = self.device.type == "cuda" and self.L % int(page_size) == 0
        self._paged = bool(paged)
        self._pages: Optional[PagePool] = None
        if self._paged:
            self.page_size = int(page_size)
            if num_pages is None:
                num_pages = (self.S * self.L) // self.page_size
            self._pages = PagePool(num_pages, self.page_size, self.L, self.S,
                                   prefix_cache=prefix_cache)
            self.maxp = self.L // self.page_size
            # each pool's page axis, found as the batch axis is
            self._paxes = _diff_axes(model.cache_spec_paged(1, self.page_size),
                                     model.cache_spec_paged(2, self.page_size),
                                     "page axis", "cache_spec_paged")
            # the pools carry one extra SINK page (index num_pages)
            self._pools = model.new_pools(num_pages + 1, self.page_size)
            # KV bytes of one token across the pools (prefix bytes saved)
            self._tok_bytes = sum(p.numel() * p.element_size() for p in self._pools) \
                // ((num_pages + 1) * self.page_size)
            self._chunk = min(int(prefill_chunk or self.page_size), self.L)
            if self._chunk < 1:
                raise MXNetError("prefill_chunk must be >= 1")
            self._prefilling: Dict[int, _Prefill] = {}
            self._active = np.zeros(self.S, bool)
            self._preempted = 0
            self._resumed_tokens = 0
        else:
            self._pools = model.new_caches(self.S, self.L)

        # host-side per-slot state (mutated only by the engine thread)
        self._slots: List[Optional[_Slot]] = [None] * self.S
        self._tokens = np.zeros(self.S, np.int32)
        self._pos = np.zeros(self.S, np.int32)
        self._temps = np.zeros(self.S, np.float32)
        self._topks = np.zeros(self.S, np.int64)
        self._topps = np.ones(self.S, np.float32)
        self._seeds = np.zeros(self.S, np.int64)
        self._counters = np.zeros(self.S, np.int64)
        self._eos = np.full(self.S, -1, np.int64)
        self._remaining = np.zeros(self.S, np.int64)
        if self._grammar:
            # per-slot automaton tables on the host (identity rows for free
            # slots) and their device copy, which every step reads; the
            # copy is uploaded only when a slot's grammar changed (_gdirty)
            G = self._gmax = _grammar.GRAMMAR_MAX_STATES
            icls, inxt, iacc = _grammar.identity_tables(self._vocab, G, G)
            self._gcls = np.tile(icls[None], (self.S, 1))
            self._gnxt = np.tile(inxt[None], (self.S, 1, 1))
            self._gacc = np.tile(iacc[None], (self.S, 1))
            self._gstate = np.zeros(self.S, np.int32)
            self._gram: List[Optional[_grammar.TokenGrammar]] = [None] * self.S
            self._gtab = _Buffers(self.device, [
                ("gcls", (self.S, self._vocab), torch.int32),
                ("gnxt", (self.S, G, G), torch.int32),
                ("gacc", (self.S, G), torch.bool)])
            self._gdirty = True

        self._queue: "deque[RequestHandle]" = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = False
        self._closed = False
        self._draining = False
        self._abort_inflight = False
        self._thread: Optional[threading.Thread] = None
        # the stream the loop runs its steps on (set by the loop; page
        # migration reads and writes the pools on it)
        self._stream = None
        # test hook (the JAX engine's): a sleep after every decode tick, so
        # that deadlines, drains and backpressure are deterministic
        self._step_delay = 0.0

        # counters for stats()
        self._submitted = 0
        self._completed: Dict[str, int] = {}
        self._max_active = 0
        self._prefills = 0
        self._prefill_chunks = 0
        self._prefill_s = 0.0
        self._dispatches = 0
        self._substeps = 0
        self._decode_s = 0.0
        self._decode_tokens = 0
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0

        # lookahead, and the steps (captured graphs on the card) per bucket
        self._lookahead = bool(lookahead)
        self._pending: Optional[_PendingStep] = None
        self._eager = False
        self._tick_lock = threading.Lock()
        self._steps: Dict[Tuple[int, int, str], _Step] = {}
        self._spec_steps: Dict[Tuple[int, str], _Step] = {}
        self._chunks: Dict[int, _Step] = {}
        self._io: Dict[int, _Buffers] = {}
        self._spec_io: Dict[int, _Buffers] = {}
        self._chunk_io: Optional[_Buffers] = None
        self._captures = 0
        self._graph_pool = None
        self._cap_stream = None
        # scoring: one step per prompt bucket over its own fixed inputs,
        # with a memory pool and stream apart from the engine's (score runs
        # on caller threads, concurrently with the loop's replays) and a
        # lock per bucket around its staging buffers
        self._score_steps: Dict[int, _Step] = {}
        self._score_io: Dict[int, _Buffers] = {}
        self._score_locks: Dict[int, threading.Lock] = {}
        self._score_pool = None
        self._score_stream = None
        # prompt buckets whose eager contiguous prefill has had its launch
        # sites counted (mxnet_decode_launches_total)
        self._prefill_counted: set = set()
        self.last_warmup_s: Optional[float] = None
        cuda = self.device.type == "cuda"
        # a verify round's [sb, spec] tokens and [sb] acceptance, read at once
        width = self.spec + 1 if self.spec else self.K
        self._out_host = [torch.zeros(self.S, width, dtype=torch.int32, pin_memory=cuda)
                          for _ in range(2)]
        self._out_events = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._out_i = 1

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

    def begin_drain(self):
        """Start a graceful drain without blocking: submits raise
        :class:`EngineClosedError` from now on (a router fails over),
        in-flight slots decode to completion on the loop, and queued
        requests complete with status 'shutdown'. ``POST /drain`` calls
        this; ``shutdown(drain=True)`` is this plus a join."""
        _recorder.RECORDER.record("event", "engine_drain_begin")
        self.shutdown(drain=True, timeout=0.0)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the engine. ``drain=True`` finishes in-flight slots (queued
        requests complete with status 'shutdown'); ``drain=False`` also
        completes in-flight requests with their partial output, and turns a
        drain begun earlier into an abort. ``timeout=0.0`` returns without
        waiting for the loop (:meth:`begin_drain`)."""
        with self._cond:
            self._closed = True
            self._draining = drain
            was_running = self._running
            flushed = []
            if was_running:
                self._running = False
                self._abort_inflight = not drain
                self._cond.notify_all()
            else:
                flushed = list(self._queue)
                self._queue.clear()
        for req in flushed:
            self._finish_unstarted(req, STATUS_SHUTDOWN)
        thread = self._thread
        if thread is not None and thread.is_alive():
            if not was_running and not drain:
                # a begin_drain() stopped admissions already: abort the
                # slots it is still finishing
                with self._cond:
                    self._abort_inflight = True
                    self._cond.notify_all()
            thread.join(timeout)
            if thread.is_alive():
                return            # begin_drain: the loop finishes on its own
        self._apply_swaps()      # the loop is down: wake swap waiters
        self._apply_page_ops()   # and page-op waiters (applied here)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    # ------------------------------------------------------------ warm-up
    def warmup(self) -> "InferenceEngine":
        """Build every kernel (on the card) and every step of the bucket
        ladder, so that serving captures nothing: a decode step per batch
        bucket ``bucket_ladder(1, S)``, substep count 1..K and sampling
        branch (:meth:`_branches`), or with ``speculate`` a verify step per
        batch bucket and branch (``"greedy"``, ``"sampled"``), and in the
        paged layout a prefill chunk at the full chunk size and at each
        final-chunk bucket ``bucket_ladder(min_prompt_bucket,
        prefill_chunk)``. On the card
        each is a captured CUDA graph (JAX compiles one executable per
        bucket); elsewhere the same function, run eagerly at each call.
        Idempotent; call before taking traffic (a lookahead step in flight
        is read first). Sets ``last_warmup_s`` and returns the engine.

        Building a step runs it once before capturing it (lazy setup stays
        out of the capture) on safe inputs that leave live state alone:
        paged steps and chunks write only the sink page (all-sink tables);
        contiguous steps write positions ``max_len - K`` (verify steps
        ``max_len - speculate``) and on of every slot, which a live row
        only reaches after writing them itself (``prompt + max_new_tokens
        + K - 1 <= max_len``) and a new request's prefill clears. A grammar
        engine's tables read as identity-safe there (all-zero ``nxt``,
        accept everywhere, EOS -1), so no safe run samples through an empty
        mask. The step's input buffers (and the grammar tables) are
        restored afterwards."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from .. import _build
            _build.build_all()
        with self._tick_lock:
            pending, self._pending = self._pending, None
            if pending is not None:
                self._process_step(pending)
            if self._paged:
                for pb in bucket_ladder(self.min_prompt_bucket, self._chunk, self._growth):
                    self._get_chunk(pb)
            for sb in bucket_ladder(1, self.S):
                if self.spec:
                    for branch in ("greedy", "sampled"):
                        self._get_spec(sb, branch)
                    continue
                for steps in range(1, self.K + 1):
                    for branch in self._branches():
                        self._get_step(sb, steps, branch)
        self.last_warmup_s = time.perf_counter() - t0
        return self

    def _branches(self) -> Tuple[str, ...]:
        """The sampling branches a decode step takes, chosen on the host per
        dispatch: with the fused head (K8), ``"filtered"`` (a row at T > 0
        and a top-k/top-p row: head GEMV logits, then ``sample_tokens``)
        and ``"fused"`` (every other batch: K8 selects greedy and sampled
        rows; a greedy row's argmax is the filtered branch's, since top-k
        and top-p keep the largest logit); without it, ``"greedy"`` and
        ``"sampled"`` (``sample_tokens`` on the logits)."""
        if self._head is not None:
            return ("fused", "filtered")
        return ("greedy", "sampled")

    def _build(self, fn: Callable, io: _Buffers, safe: Callable, what: str,
               label: str, first: bool, score: bool = False) -> _Step:
        """One step of a bucket: ``fn`` run once on the ``safe`` inputs
        (its launches uncounted), then, on the card, captured into a CUDA
        graph on the engine's capture stream and memory pool (a ``score``
        step: the scoring stream and pool), with Python's cyclic collector
        off (:func:`_no_collection`). A failed capture raises, naming
        ``what``. The build counts in ``mxnet_serve_compiles_total{fn=
        label}`` and ``mxnet_recompilations_total{block=serve_<label>}``
        (``first``: the label's first build, kind ``initial``), and adds
        the step's launch sites to ``mxnet_decode_launches_total``."""
        dev = self.device
        cuda = dev.type == "cuda"
        stream = pool = None
        if cuda:
            if score:
                if self._score_stream is None:
                    self._score_stream = torch.cuda.Stream(dev)
                    self._score_pool = torch.cuda.graph_pool_handle()
                stream, pool = self._score_stream, self._score_pool
            else:
                if self._cap_stream is None:
                    self._cap_stream = torch.cuda.Stream(dev)
                    self._graph_pool = torch.cuda.graph_pool_handle()
                stream, pool = self._cap_stream, self._graph_pool
            stream.wait_stream(torch.cuda.current_stream(dev))
        grammar = self._grammar and not score
        bufs = [io, self._gtab] if grammar else [io]
        with torch.no_grad(), torch.cuda.stream(stream):
            saved = [b.dev.clone() for b in bufs]
            safe(io)
            if grammar:
                self._gtab.dev.zero_()
                self._gtab.gacc.fill_(True)
            with record_graph() as ran:
                fn()
            for b, v in zip(bufs, saved):
                b.dev.copy_(v)
            step = _Step(fn, tally=ran)
            tally = ran
            if cuda and not self._eager:
                graph = torch.cuda.CUDAGraph()
                try:
                    with _no_collection():
                        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                        try:
                            with record_graph() as tally:
                                out = fn()
                                tally.seal()
                        finally:
                            graph.capture_end()
                except Exception as e:
                    raise MXNetError(f"serve: CUDA-graph capture of {what} failed: "
                                     f"{e}") from e
                step = _Step(fn, graph, out, tally)
        if cuda:
            torch.cuda.current_stream(dev).wait_stream(stream)
        note_build(tally, ran)
        _metrics.SERVE_COMPILES.labels(fn=label).inc()
        _metrics.RECOMPILATIONS.labels(block=f"serve_{label}",
                                       kind="initial" if first else "retrace").inc()
        with self._lock:
            self._captures += 1
        return step

    def _step_io(self, sb: int) -> _Buffers:
        """The fixed inputs of decode bucket ``sb``, shared by its steps:
        tokens (and a grammar engine's automaton states) first (a lookahead
        dispatch feeds them on the device and uploads from ``pos`` on), keys
        last (uploaded only as far as the dispatch's substeps need them,
        and only with a row at T > 0)."""
        io = self._io.get(sb)
        if io is None:
            fields = [("tokens", (sb,), torch.int32)]
            if self._grammar:
                fields.append(("gstate", (sb,), torch.int32))
            fields += [("pos", (sb,), torch.int32),
                      ("temps", (sb,), torch.float32), ("topks", (sb,), torch.int32),
                      ("topps", (sb,), torch.float32), ("eos", (sb,), torch.int32),
                      ("rem", (sb,), torch.int32)]
            if self._paged:
                fields.append(("table", (sb, self.maxp), torch.int32))
            fields.append(("keys", (self.K, sb, 2), torch.int64))
            io = self._io[sb] = _Buffers(self.device, fields)
        return io

    def _slot_views(self, start: int, n: int):
        """Views of slots [start, start + n) of every contiguous cache, along
        each cache's batch axis."""
        return [pool.narrow(ax, start, n) for pool, ax in zip(self._pools, self._baxes)]

    def _get_step(self, sb: int, steps: int, branch: str) -> _Step:
        """The decode step of batch bucket ``sb``, ``steps`` substeps and
        sampling ``branch``, built at first use (the counterpart of the JAX
        engine's ``_get_compiled``). Its function runs
        ``decode_multi_tokens`` on the bucket's fixed inputs and writes the
        last tokens back into them (the next lookahead dispatch's input)."""
        key = (sb, steps, branch)
        step = self._steps.get(key)
        if step is not None:
            return step
        io = self._step_io(sb)
        model, K, head = self.model, self.K, self._head
        caches = self._pools if self._paged else self._slot_views(0, sb)
        table = io.table if self._paged else None
        filtered = branch == "filtered"
        greedy = branch == "greedy"

        if self._grammar:
            gcls, gnxt, gacc = (self._gtab.gcls[:sb], self._gtab.gnxt[:sb],
                                self._gtab.gacc[:sb])

            def fn():
                # K = 1 (JAX's grammar step): decode_multi_tokens' selection
                # under the automaton's mask; the advanced states go back
                # into the inputs with the tokens
                logits, _ = _gen.decode_step(model, io.tokens[:, None], io.pos, caches,
                                             table)
                mask = _grammar.grammar_mask(gcls, gnxt, gacc, io.gstate, io.eos)
                nxt = _gen.sample_tokens(logits[:, -1], io.keys[0], io.temps, io.topks,
                                         io.topps, mask=mask, greedy=greedy,
                                         check_mask=False)
                io.gstate.copy_(_grammar.grammar_advance(gcls, gnxt, io.gstate, nxt,
                                                         io.eos))
                io.tokens.copy_(nxt)
                return nxt[:, None]
        else:
            def fn():
                toks, last, _, _, _ = _gen.decode_multi_tokens(
                    model, io.tokens, io.pos, caches, K, io.temps, eos_ids=io.eos,
                    remaining=io.rem, head=head, block_table=table, topks=io.topks,
                    topps=io.topps, keys=io.keys, steps=steps, filtered=filtered,
                    greedy=greedy)
                io.tokens.copy_(last)
                return toks

        def safe(io):
            io.dev.zero_()
            io.eos.fill_(-1)
            io.rem.fill_(K)
            if self._paged:
                io.table.fill_(self._pages.sink)
            else:
                io.pos.fill_(self.L - K)

        step = self._build(fn, io, safe, f"decode bucket {sb} ({steps} substeps, {branch})",
                           "decode", not self._steps)
        with self._lock:
            self._steps[key] = step
        return step

    def _get_chunk(self, pb: int) -> _Step:
        """The paged prefill chunk of bucket ``pb`` tokens over the chunk
        inputs (ids, a [1] cursor, the slot's [1, max_pages] table),
        returning the chunk's hidden state [1, pb, D]."""
        step = self._chunks.get(pb)
        if step is not None:
            return step
        if self._chunk_io is None:
            self._chunk_io = _Buffers(self.device, [
                ("ids", (self._chunk,), torch.int32), ("pos", (1,), torch.int32),
                ("table", (1, self.maxp), torch.int32)])
        io = self._chunk_io
        ids = io.ids[:pb].reshape(1, pb)
        # the stored step holds no reference to the engine: a cycle through
        # self._chunks would keep the model's device memory until the
        # collector runs
        model, pools = self.model, self._pools

        def fn():
            hidden, _ = _gen.decode_step_hidden(model, ids, io.pos, pools, io.table)
            return hidden

        def safe(io):
            io.dev.zero_()
            io.table.fill_(self._pages.sink)

        step = self._build(fn, io, safe, f"prefill chunk bucket {pb}", "prefill",
                           not self._chunks)
        with self._lock:
            self._chunks[pb] = step
        return step

    def _verify_io(self, sb: int) -> _Buffers:
        """The fixed inputs of verify bucket ``sb``: the [sb, spec] inputs
        (current token, then the drafts), positions, sampling parameters, a
        grammar engine's per-column states and eos ids, the paged table,
        and the [sb, spec] keys last (uploaded only with a row at T > 0)."""
        io = self._spec_io.get(sb)
        if io is None:
            T = self.spec
            fields = [("inputs", (sb, T), torch.int32), ("pos", (sb,), torch.int32),
                      ("temps", (sb,), torch.float32), ("topks", (sb,), torch.int32),
                      ("topps", (sb,), torch.float32)]
            if self._grammar:
                fields += [("gstates", (sb, T), torch.int32), ("eos", (sb,), torch.int32)]
            if self._paged:
                fields.append(("table", (sb, self.maxp), torch.int32))
            fields.append(("keys", (sb, T, 2), torch.int64))
            io = self._spec_io[sb] = _Buffers(self.device, fields)
        return io

    def _get_spec(self, sb: int, branch: str) -> _Step:
        """The verify step of batch bucket ``sb`` and sampling ``branch``
        (``"greedy"``: every row at T 0; ``"sampled"``), built at first use
        (the JAX engine's ``_get_spec``): one forward over the bucket's
        [sb, spec] inputs at per-row positions, then
        ``spec_verify_tokens``, masked per column under a grammar. Returns
        [sb, spec + 1] int32: the tokens, then the accepted count."""
        key = (sb, branch)
        step = self._spec_steps.get(key)
        if step is not None:
            return step
        io = self._verify_io(sb)
        model, T = self.model, self.spec
        caches = self._pools if self._paged else self._slot_views(0, sb)
        table = io.table if self._paged else None
        greedy = branch == "greedy"
        grammar = self._grammar
        if grammar:
            gcls, gnxt, gacc = (self._gtab.gcls[:sb], self._gtab.gnxt[:sb],
                                self._gtab.gacc[:sb])

        def fn():
            logits, _ = _gen.decode_step(model, io.inputs, io.pos, caches, table)
            masks = (_grammar.grammar_mask_multi(gcls, gnxt, gacc, io.gstates, io.eos)
                     if grammar else None)
            toks, acc = _gen.spec_verify_tokens(
                logits, io.inputs, io.temps, io.topks, io.topps, masks=masks,
                keys=io.keys, greedy=greedy, check_mask=False)
            return torch.cat([toks, acc[:, None]], dim=1)

        def safe(io):
            io.dev.zero_()
            if grammar:
                io.eos.fill_(-1)
            if self._paged:
                io.table.fill_(self._pages.sink)
            else:
                io.pos.fill_(self.L - T)

        step = self._build(fn, io, safe, f"verify bucket {sb} ({branch})", "spec",
                           not self._spec_steps)
        with self._lock:
            self._spec_steps[key] = step
        return step

    # ------------------------------------------------------------ submission
    def submit(self, input_ids, max_new_tokens: int,
               eos_token_id: Optional[int] = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               timeout_s: Optional[float] = None, grammar=None,
               traceparent: Optional[str] = None, stream: bool = False,
               resume: Optional[List[int]] = None) -> RequestHandle:
        """Enqueue one request (one sequence of token ids). Returns a
        :class:`RequestHandle`; may raise :class:`QueueFullError` or
        :class:`EngineClosedError`.

        ``traceparent`` (a W3C header value) parents the request's span
        tree, so one trace id follows the request across processes; it is
        ignored while tracing is off. ``stream=True`` feeds
        ``handle._events``: ``("token", id)`` per emitted token, once the
        host knows it, then ``("done", ServeResult)`` (the SSE frontend's
        source).

        ``grammar`` constrains every generated token: a regex string, a
        JSON-schema dict or a compiled :class:`~mxnet_tpu_torch.serve.
        grammar.TokenGrammar`. It needs an engine built with
        ``grammar=True`` and an ``eos_token_id`` (an accept state with no
        continuation ends by EOS).

        ``resume`` (the migration path: preemption rescue) carries tokens
        this request already generated on another replica, so this engine
        continues the stream instead of starting it: admission prefills
        ``prompt + resume`` (mapping any migrated pages of it) and sampling
        picks up at counter ``len(resume)``, which the stateless ``fold_in(
        seed, counter)`` streams make the continuation of the original run,
        as a local preemption's resume is. The resumed tokens count against
        ``max_new_tokens`` and lead ``generated_ids``. Paged engines only
        (the contiguous prefill has no resume)."""
        prompt = self._as_prompt(input_ids)
        if any(t < 0 or t >= self._vocab for t in prompt):
            raise MXNetError(f"input_ids contain tokens outside [0, {self._vocab})")
        if max_new_tokens <= 0:
            raise MXNetError("max_new_tokens must be positive")
        _gen._validate_sampling(temperature, top_k, top_p)
        if len(prompt) + max_new_tokens + (self._adv - 1) > self.L:
            headroom = (f" + multi_token/speculate headroom ({self._adv - 1})"
                        if self._adv > 1 else "")
            raise MXNetError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f"{headroom} exceeds the engine's max_len ({self.L})")
        g = None
        if grammar is not None:
            if not self._grammar:
                raise MXNetError(
                    "this engine was built without grammar support — construct "
                    "it with grammar=True (the automaton tables are inputs of "
                    "every step, so the gate is construction-time)")
            if eos_token_id is None:
                raise MXNetError(
                    "grammar-constrained requests require eos_token_id: an "
                    "accept state with no continuation can only terminate by "
                    "emitting EOS")
            if isinstance(grammar, _grammar.TokenGrammar):
                g = grammar
                if g.vocab != self._vocab:
                    raise MXNetError(f"grammar was compiled for vocab={g.vocab}, "
                                     f"engine vocab is {self._vocab}")
                if g.n_states > self._gmax or g.n_classes > self._gmax:
                    raise MXNetError(
                        f"grammar ({g.n_states} states, {g.n_classes} classes) "
                        f"exceeds this engine's serve_grammar_max_states="
                        f"{self._gmax} tables")
            else:
                g = _grammar.compile_grammar(grammar, self._vocab,
                                             max_states=self._gmax)
            _metrics.GRAMMAR_SESSIONS.inc()
        deadline = (time.perf_counter() + timeout_s
                    if timeout_s is not None else None)
        req = RequestHandle(prompt, int(max_new_tokens), float(temperature),
                            eos_token_id, int(seed), deadline, int(top_k), float(top_p))
        req.grammar = g
        if stream:
            req._events = _qmod.Queue()
        if resume is not None:
            if not self._paged:
                raise MXNetError("submit(resume=) requires the paged engine (paged=True)")
            req._resume = [int(t) for t in resume]
        t_wall = time.time()
        with self._cond:
            if self._closed or not self._running:
                raise EngineClosedError("engine is not running (call start(), "
                                        "or it was shut down)")
            if len(self._queue) >= self.max_queue_depth:
                _metrics.SERVE_REQUESTS.labels(status="rejected").inc()
                raise QueueFullError(f"request queue full (max_queue_depth="
                                     f"{self.max_queue_depth}); retry with backoff")
            if _trace.ENABLED:
                # spans open only for admitted requests (t0 backdated to
                # the arrival)
                req._trace = _trace.start_span(
                    "serve.request", parent=traceparent, t0=t_wall,
                    prompt_tokens=len(prompt), max_new_tokens=int(max_new_tokens))
                req._span_queue = req._trace.child("serve.queue", t0=t_wall)
            self._queue.append(req)
            self._submitted += 1
            _metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
        return req

    def generate(self, input_ids, max_new_tokens: int, timeout: Optional[float] = None,
                 **kwargs) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(input_ids, max_new_tokens, **kwargs).result(timeout)

    @staticmethod
    def _as_prompt(input_ids) -> List[int]:
        """One token sequence of shape [P] or [1, P] as a list of ints."""
        arr = np.asarray(input_ids)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1 or arr.size == 0:
            raise MXNetError(
                "submit expects one non-empty token sequence (shape [P] "
                f"or [1, P]), got shape {arr.shape}")
        return [int(t) for t in arr]

    # ------------------------------------------------------------ scoring
    def warmup_score(self) -> "InferenceEngine":
        """Build the score step of every prompt bucket
        (``bucket_ladder(min_prompt_bucket, max_len)``): :meth:`score`'s
        :meth:`warmup`, kept apart so that engines that never score pay
        nothing. On the card each is a captured CUDA graph."""
        if self.device.type == "cuda":
            from .. import _build
            _build.build_all()
        for pb in bucket_ladder(self.min_prompt_bucket, self.L, self._growth):
            with self._score_lock(pb):
                self._get_score(pb)
        return self

    def _score_lock(self, pb: int) -> threading.Lock:
        with self._lock:
            return self._score_locks.setdefault(pb, threading.Lock())

    def _get_score(self, pb: int) -> _Step:
        """The score step of prompt bucket ``pb`` (caller holds its lock):
        one forward of the [1, pb] ids at position 0 over fresh contiguous
        caches of ``max_len`` rows, then the f32 ``log_softmax`` of each
        row's logits at the next id; rows at or past ``n - 1`` give exactly
        0 (the JAX engine's ``_build_score``). The serving pools are never
        touched."""
        step = self._score_steps.get(pb)
        if step is not None:
            return step
        io = self._score_io[pb] = _Buffers(self.device, [
            ("ids", (1, pb), torch.int32), ("pos", (1,), torch.int32),
            ("n", (1,), torch.int32)])
        model, L = self.model, self.L

        def fn():
            # position 0 as a [1] device vector: an int offset would copy
            # from the host, which a capture forbids
            caches = model.new_caches(1, L)
            logits, _ = _gen.decode_step(model, io.ids, io.pos, caches)
            lp = torch.log_softmax(logits[0].float(), dim=-1)           # [pb, V]
            tgt = torch.roll(io.ids[0], -1).long()
            tok_lp = lp.gather(1, tgt[:, None])[:, 0]
            idx = torch.arange(pb, device=tok_lp.device)
            return torch.where(idx < io.n - 1, tok_lp, torch.zeros_like(tok_lp))

        def safe(io):
            io.dev.zero_()
            io.n.fill_(2)

        step = self._build(fn, io, safe, f"score bucket {pb}", "score",
                           not self._score_steps, score=True)
        with self._lock:
            self._score_steps[pb] = step
        return step

    def score(self, input_ids) -> Dict[str, Any]:
        """Teacher-forced scoring: the log-probability of each of
        ``input_ids[1:]`` given its prefix, from one forward of the prompt
        bucket (no decode loop, no slot, no queue, no pool traffic), safe
        from any thread while the engine serves. The weights lock makes it
        read one whole weight set. Returns ``{"tokens", "logprob",
        "token_logprobs"}``."""
        prompt = self._as_prompt(input_ids)
        if len(prompt) < 2:
            raise MXNetError(
                "score requires at least 2 tokens (the first token has "
                "no conditional to score)")
        if any(t < 0 or t >= self._vocab for t in prompt):
            raise MXNetError(f"input_ids contain tokens outside [0, {self._vocab})")
        if len(prompt) > self.L:
            raise MXNetError(f"score sequence ({len(prompt)}) exceeds the engine's "
                             f"max_len ({self.L})")
        n = len(prompt)
        pb = bucket_for(n, self.min_prompt_bucket, self.L, self._growth)
        cuda = self.device.type == "cuda"
        with self._score_lock(pb):
            with torch.no_grad():
                step = self._get_score(pb)
                io = self._score_io[pb]
                stream = self._score_stream if cuda else None
                with torch.cuda.stream(stream):
                    h = io.host()
                    h["ids"][:] = 0
                    h["ids"][0, :n] = prompt
                    h["pos"][0] = 0
                    h["n"][0] = n
                    io.upload(0, io.nbytes)
                    with self._weights_lock:
                        if stream is not None and self._weights_event is not None:
                            stream.wait_event(self._weights_event)
                        lp = step()[:n - 1].cpu().numpy()
        _metrics.SERVE_ROUNDTRIPS.labels(path="score").inc()
        toklp = [float(x) for x in lp]
        return {"tokens": n - 1, "logprob": float(sum(toklp)),
                "token_logprobs": toklp}

    # ------------------------------------------------------- weight refresh
    def swap_weights(self, named_params: Dict[str, Any],
                     version: Optional[int] = None, timeout: float = 60.0) -> int:
        """Swap the served weights for a new set of the same shapes: no
        restart, nothing recaptured, and in-flight requests decode on
        across the swap (their cache rows were written by the old weights;
        tokens from the next tick on come from the new ones).

        ``named_params`` maps each parameter's publish name (the JAX
        package's ``collect_params`` names, which ``named_parameters()``
        carries) to an array or tensor, cast to the live dtype. Missing,
        extra and differently shaped names raise before anything is
        staged. The engine loop copies the set into the live parameters in
        place at the next tick boundary (inline when the loop is not
        running); a quantized model's tables are derived again from the
        new weights. Returns the version now serving (default: the current
        one + 1)."""
        if version is None:
            version = self.weight_version + 1
        version = int(version)
        if self._head is not None or self._fused_blocks:
            raise MXNetError(
                "swap_weights: this engine serves fused int8 decode "
                "(packed weights are baked into the executables); live "
                "refresh needs the unfused path — build a new engine "
                "for quantized fused-decode deploys")
        names = list(self._params)
        missing = [n for n in names if n not in named_params]
        if missing:
            raise MXNetError(
                f"swap_weights: missing {len(missing)} params (first: "
                f"{missing[:3]}); expected the publish naming "
                "(collect_params)")
        extra = set(named_params) - set(names)
        if extra:
            raise MXNetError(
                f"swap_weights: {len(extra)} unknown params (first: "
                f"{sorted(extra)[:3]}) — wrong model?")
        staged = {}
        for name in names:
            cur = self._params[name]
            arr = _host_tensor(named_params[name])
            if tuple(arr.shape) != tuple(cur.shape):
                raise MXNetError(
                    f"swap_weights: shape mismatch for {name!r}: "
                    f"{tuple(arr.shape)} vs live {tuple(cur.shape)} — "
                    "changed shapes need a new engine (and a recompile)")
            staged[name] = arr.to(cur.dtype)
        rec = {"params": staged, "version": version, "evt": threading.Event(),
               "ok": False}
        with self._cond:
            # the loop THREAD's life decides, not _running: a draining loop
            # still decodes, and an inline copy would land mid-tick
            alive = self._thread is not None and self._thread.is_alive()
            if alive:
                self._swaps.append(rec)
                self._cond.notify_all()
        if not alive:
            self._copy_weights(staged)
            self._note_swap(version)
            return version
        if not rec["evt"].wait(timeout):
            raise MXNetError(f"swap_weights: engine loop did not apply the swap "
                             f"within {timeout}s")
        if not rec["ok"]:
            raise MXNetError(
                "swap_weights: the engine loop went down before "
                f"applying v{version}; still serving v{self.weight_version}")
        return version

    def swap_weights_from(self, directory: str, version: Optional[int] = None) -> int:
        """Load a published weight version (``registry.publish_weights``
        layout; default the latest) and swap to it: the ``POST /weights``
        deploy path."""
        from .registry import read_weights
        version, params, _manifest = read_weights(directory, version)
        return self.swap_weights(params, version=version)

    def _copy_weights(self, staged: Dict[str, torch.Tensor]):
        """Copy a staged set into the live parameters on the current
        stream, after any score in flight, and derive a quantized model's
        tables from it; scores wait for the copy's event. The prefix cache
        is emptied: its pages hold rows the old weights computed, which a
        new request must not map (the JAX engine keeps them). Slots that
        hold such pages decode on with them, as in-flight requests do."""
        from ..contrib.quantization import requantize_
        cuda = self.device.type == "cuda"
        with self._weights_lock, torch.no_grad():
            if cuda and self._score_stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(self._score_stream)
            for name, src in staged.items():
                self._params[name].copy_(src, non_blocking=True)
            requantize_(self.model)
            if cuda:
                self._weights_event = torch.cuda.Event()
                self._weights_event.record()
        if self._paged:
            self._pages.clear_prefix_cache()

    def _note_swap(self, version: int):
        self.weight_version = version
        self._weight_swaps += 1
        _metrics.SERVE_WEIGHT_VERSION.labels(model=self.name).set(version)
        _metrics.SERVE_WEIGHT_SWAPS.labels(model=self.name).inc()
        _recorder.RECORDER.record("event", "serve.weight_swap",
                                  model=self.name, version=version)

    def _apply_swaps(self):
        """Adopt the newest staged weight set (engine loop, at a tick
        boundary; or the caller once the loop is down). Versions staged in
        the same window are superseded; their waiters succeed too."""
        with self._lock:
            swaps, self._swaps = self._swaps, []
        if not swaps:
            return
        self._copy_weights(swaps[-1]["params"])
        self._note_swap(swaps[-1]["version"])
        for rec in swaps:
            rec["ok"] = True
            rec["evt"].set()

    # ------------------------------------------------------------ page migration
    def _require_paged(self):
        if not self._paged:
            raise MXNetError("cross-replica page migration requires the paged "
                             "engine (paged=True)")

    def _page_payload_spec(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) every shipped page must have, per pool: the pool's
        shape with the page axis collapsed to 1 (JAX's layout: [1, H, page,
        hd] per GPT layer, [1, n_kv, page, hd] per Llama layer, [layers, 1,
        ...] for the stacked decoder). A page of another shape or dtype is a
        verify failure, never written."""
        return [(tuple(1 if i == ax else d for i, d in enumerate(p.shape)), p.dtype)
                for p, ax in zip(self._pools, self._paxes)]

    def _pool_stream(self):
        """The stream the loop writes the pools on (the caller's own before
        the loop first ran)."""
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    def _export_entries(self, toks: List[int], phys_pages: List[int]) -> dict:
        """Read the given physical pages (page ``i`` covering tokens ``[i *
        page_size, (i + 1) * page_size)`` of ``toks``) out of every pool,
        one ``index_select`` a pool on the loop's stream, so the read
        follows every step that wrote them, and wrap them as the wire doc:
        each page rides with the chain hash of the token prefix it ends."""
        ps = self.page_size
        entries = []
        if phys_pages:
            with self._pool_stream():
                idx = torch.tensor(phys_pages, dtype=torch.int64, device=self.device)
                # .cpu() waits for the read, which waits for the writes
                sel = [pool.index_select(ax, idx).cpu()
                       for pool, ax in zip(self._pools, self._paxes)]
            for i in range(len(phys_pages)):
                ln = (i + 1) * ps
                entries.append((ln, prefix_key(toks[:ln]),
                                [t.narrow(ax, i, 1) for t, ax in zip(sel, self._paxes)]))
            _metrics.MIGRATE_PAGES_SENT.inc(len(entries))
            _recorder.RECORDER.record("event", "serve.page_export", reason="page_migration",
                                      pages=len(entries), tokens=entries[-1][0])
        return encode_kv_pages(toks[:len(phys_pages) * ps], entries)

    def export_pages(self, input_ids) -> dict:
        """Export the full cached pages of the longest prefix-cache match of
        ``input_ids`` as a migration wire doc (``kvstore.comm.
        encode_kv_pages``): exact page payloads, each with its chain hash.
        The partial tail page never ships (the receiver prefills it). On a
        running engine the read happens on the loop at a tick boundary, on
        the stream that wrote the pages (safe from any thread, an HTTP
        handler's included), waiting at most ``EXPORT_TIMEOUT_S``; on a
        stopped one, here."""
        self._require_paged()
        toks = self._as_prompt(input_ids)
        return self._page_op({"kind": "export", "tokens": toks}, EXPORT_TIMEOUT_S)

    def _apply_page_export(self, rec: Dict[str, Any]):
        toks = rec["tokens"]
        pages, matched = self._pages.match_prefix(toks, count=False)
        full = min(matched // self.page_size, len(pages))
        rec["result"] = self._export_entries(toks, [int(p) for p in pages[:full]])

    def _export_slot_pages(self, s: int, toks: List[int]) -> dict:
        """Preempt-time capture (the loop): the victim slot's leased full
        pages straight off its block table, prompt and generated tokens
        alike, before ``release`` frees them. A lookahead step still in
        flight writes the victim's last rows on the loop's stream, and the
        read is queued behind it there."""
        table = self._pages.table(s)
        phys = []
        for i in range(len(toks) // self.page_size):
            p = int(table[i])
            if p == self._pages.sink:
                break
            phys.append(p)
        return self._export_entries(toks, phys)

    def import_pages(self, doc: dict, timeout: float = 60.0) -> dict:
        """Adopt migrated KV pages into this engine's prefix cache.

        Each shipped page is verified on receipt, in the JAX engine's
        order: its prefix length (positive, within the doc's tokens, a page
        multiple), the chain hash of the doc's tokens up to it, the number
        of pool payloads, then each payload's shape and dtype against the
        pool spec (:meth:`_page_payload_spec`). A page that fails is
        dropped and counted (``mxnet_migrate_verify_failures_total``),
        never written. Verified pages become prefix-cache entries on
        freshly leased physical pages and their payloads are copied in
        place into the pools (the captured graphs hold the pools by
        address: nothing is recaptured), so an admission of the prompt
        maps them instead of prefilling. Applied by the loop at a tick
        boundary; on a stopped engine, here. Returns ``{"received",
        "adopted", "verify_failures", "skipped_cached", "out_of_pages"}``."""
        self._require_paged()
        tokens, pages = decode_kv_pages(doc)
        return self._page_op({"kind": "import", "tokens": tokens, "pages": pages}, timeout)

    def _page_op(self, rec: Dict[str, Any], timeout: float):
        """Stage one page op for the loop and wait for it, or apply it here
        when the loop is not running."""
        rec.update(evt=threading.Event(), result=None, error=None)
        with self._cond:
            staged = self._running
            if staged:
                self._page_ops.append(rec)
                self._cond.notify_all()
        if not staged:
            self._apply_page_op(rec)
        elif not rec["evt"].wait(timeout):
            raise MXNetError(f"page {rec['kind']} timed out waiting for a tick boundary")
        if rec["error"]:
            raise MXNetError(rec["error"])
        return rec["result"]

    def _apply_page_op(self, rec: Dict[str, Any]):
        try:
            with self._tick_lock:
                if rec["kind"] == "export":
                    self._apply_page_export(rec)
                else:
                    self._apply_page_import(rec)
        except Exception as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            rec["evt"].set()

    def _apply_page_ops(self):
        """The loop's side: land staged page ops between ticks (or the
        caller's, once the loop is down)."""
        with self._lock:
            ops, self._page_ops = self._page_ops, []
        for rec in ops:
            self._apply_page_op(rec)

    def _fail_page_ops(self):
        """Crash path: wake page-op waiters with the failure."""
        with self._lock:
            ops, self._page_ops = self._page_ops, []
        for rec in ops:
            rec["error"] = rec["error"] or "engine stopped before the page op landed"
            rec["evt"].set()

    def _apply_page_import(self, rec: Dict[str, Any]):
        tokens = [int(t) for t in rec["tokens"]]
        spec = self._page_payload_spec()
        verified: Dict[int, List[torch.Tensor]] = {}
        failures = 0
        for ln, key, payload in rec["pages"]:
            ok = (0 < ln <= len(tokens) and ln % self.page_size == 0
                  and prefix_key(tokens[:ln]) == int(key)
                  and len(payload) == len(spec)
                  and all(tuple(a.shape) == shape and a.dtype == dtype
                          for a, (shape, dtype) in zip(payload, spec)))
            if ok:
                verified[int(ln)] = payload
            else:
                failures += 1
        if failures:
            _metrics.MIGRATE_VERIFY_FAILURES.inc(failures)
        if verified:
            _metrics.MIGRATE_PAGES_RECEIVED.inc(len(verified))
        adopted = 0
        reason = None
        if verified:
            try:
                fresh = self._pages.adopt_prefix(tokens, sorted(verified))
            except OutOfPages as e:
                fresh, reason = [], str(e)
            if fresh:
                with self._pool_stream():
                    for ln, page in fresh:
                        for pool, ax, a in zip(self._pools, self._paxes, verified[ln]):
                            pool.narrow(ax, page, 1).copy_(a)
                        adopted += 1
        if verified or failures:
            _recorder.RECORDER.record("event", "serve.page_import", reason="page_migration",
                                      received=len(verified), adopted=adopted,
                                      verify_failures=failures)
        rec["result"] = {"received": len(verified), "adopted": adopted,
                         "verify_failures": failures,
                         "skipped_cached": len(verified) - adopted, "out_of_pages": reason}

    # ------------------------------------------------------------ loop
    def _loop(self):
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
        try:
            with torch.no_grad():
                self._loop_inner()
                # a swap or a page op staged after the last tick's apply
                # still lands
                self._apply_swaps()
                self._apply_page_ops()
        except Exception as e:  # the engine thread's boundary: fail, never hang
            err = traceback.format_exc()
            # the flight-recorder moment: the ring with the crash, before
            # the cleanup below changes the engine's state
            _recorder.RECORDER.record(
                "error", "engine_loop_crash", error=repr(e),
                slots_active=sum(1 for s in self._slots if s is not None))
            _recorder.RECORDER.dump("engine_exception", force=True)
            with self._cond:
                self._running = False
                self._closed = True
                queued = list(self._queue)
                self._queue.clear()
                swaps, self._swaps = self._swaps, []
            for rec in swaps:
                rec["evt"].set()          # without "ok": the waiter learns
            self._fail_page_ops()
            pending, self._pending = self._pending, None
            if pending is not None:
                try:
                    # the computed lookahead tokens first: none is lost
                    self._process_step(pending)
                except Exception:
                    pass
            for req in queued:
                self._finish_unstarted(req, STATUS_ERROR, error=err)
            for s in range(self.S):
                if self._slots[s] is not None:
                    self._retire(s, STATUS_ERROR, error=err)

    def _loop_inner(self):
        while True:
            # a staged weight swap lands between ticks: everything below
            # sees one weight set per iteration
            self._apply_swaps()
            # migrated pages land (and exports read) at the same boundary
            self._apply_page_ops()
            admits = []
            dead = []
            with self._cond:
                while (self._running and not self._queue and not any(self._slots)
                       and not self._swaps and not self._page_ops):
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
                        if self._paged and not self._fits(self._queue[0]):
                            # not enough pages even after reclaiming the
                            # prefix cache: wait for retires (FIFO kept)
                            break
                        s = self._slots.index(None)
                        req = self._queue.popleft()
                        if req.admit_t is None:    # a resume keeps its wait
                            req.admit_t = now
                        req._status = "running"
                        self._slots[s] = _Slot(req, list(req._resume or ()), now)
                        admits.append((s, req))
                    _metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
            for req, status in dead:
                self._finish_unstarted(req, status)
            with self._tick_lock:
                if self._pending is not None and (stopping or (admits and not self._paged)):
                    # contiguous admits prefill into the pools and change the
                    # row set: read the lookahead step first. Paged admits
                    # only start prefills; the paged tick drains on a change
                    # of the decoding rows.
                    pending, self._pending = self._pending, None
                    self._process_step(pending)
                if stopping and self._abort_inflight:
                    for s in range(self.S):
                        if self._slots[s] is not None:
                            self._retire(s, STATUS_SHUTDOWN)
                for s, req in admits:
                    if self._paged:
                        self._admit_paged(s, req)
                    else:
                        self._prefill(s, req)
                if self._paged:
                    self._advance_prefills(stopping)
                active = sum(slot is not None for slot in self._slots)
                self._max_active = max(self._max_active, active)
                if self._paged and (self._active.any() or self._pending is not None):
                    self._step_tick_paged()
                elif active and not self._paged:
                    self._step_tick()
                elif stopping and not active:
                    break
                self._observe_occupancy()
            if active and self._step_delay:
                time.sleep(self._step_delay)

    def _observe_occupancy(self):
        n = sum(1 for s in self._slots if s is not None)
        self._max_active = max(self._max_active, n)
        _metrics.SERVE_SLOTS_IN_USE.set(n)
        _metrics.SERVE_SLOT_OCCUPANCY.set(n / self.S)

    # ------------------------------------------------------------ prefill
    def _prefill(self, s: int, req: RequestHandle):
        """Prefill one request into contiguous slot ``s`` and select its
        token 0."""
        t0 = time.perf_counter()
        _metrics.SERVE_QUEUE_WAIT.observe(t0 - req.submit_t)
        _recorder.RECORDER.record("event", "serve.admit", slot=s,
                                  prompt_tokens=len(req.prompt_ids))
        if req._trace is not None:
            req._span_queue.end()
            req._span_queue = None
            req._span_prefill = req._trace.child("serve.prefill", slot=s)
        P = len(req.prompt_ids)
        pb = bucket_for(P, self.min_prompt_bucket, self.L, self._growth)
        ids = np.zeros((1, pb), np.int32)
        ids[0, :P] = req.prompt_ids
        ids = torch.from_numpy(ids).to(self.device)
        caches = self._slot_views(s, 1)
        for c in caches:
            c.zero_()
        if self._grammar:
            self._install_grammar(s, req)
        # the eager prefill is the JAX engine's prefill executable of this
        # bucket: its launch sites count once, at the bucket's first run
        first = pb not in self._prefill_counted
        with (count_launches() if first else contextlib.nullcontext()) as sites:
            hidden, _ = _gen.decode_step_hidden(self.model, ids, 0, caches)
            tok0, sync_s = self._token0(s, hidden, P - 1, req, 0)
        if first:
            self._prefill_counted.add(pb)
            for kind, n in sites.items():
                _metrics.DECODE_LAUNCHES.labels(kind=kind).inc(n)
        self._start_decode(s, req, tok0, t0, P, 0, sync_s)

    def _token0(self, s: int, hidden, last: int, req: RequestHandle,
                counter: int) -> Tuple[int, float]:
        """Draw slot ``s``'s next token from row ``last`` of a prefill's
        hidden state [1, T, D]: that row's logits alone (see the module
        docstring), sampled with the stream at ``counter``, under the mask
        of the slot's automaton state when its request is constrained.
        Returns the token and the seconds its host read blocked."""
        logits = self.model._lm_head(hidden[:, last])
        keys = _prng.fold_keys([req.seed], [counter], self.device)
        mask = None
        if self._grammar and self._gram[s] is not None:
            self._sync_gtab()
            gt, dev = self._gtab, self.device
            mask = _grammar.grammar_mask(
                gt.gcls[s:s + 1], gt.gnxt[s:s + 1], gt.gacc[s:s + 1],
                torch.full((1,), int(self._gstate[s]), dtype=torch.int32, device=dev),
                torch.full((1,), req.eos_token_id, dtype=torch.int32, device=dev))
        tok0 = _gen.sample_tokens(logits, keys, [req.temperature], [req.top_k],
                                  [req.top_p], mask=mask)
        t_sync = time.perf_counter()
        tok = int(tok0[0])
        return tok, time.perf_counter() - t_sync

    def _start_decode(self, s: int, req: RequestHandle, tok0: int, t0: float,
                      n_ids: int, emitted: int, sync_s: float):
        """Activate slot ``s`` after its prefill of ``n_ids`` tokens, of
        which the last ``emitted`` were generated before a preemption
        (``sync_s``: the token-0 read's blocking seconds)."""
        now = time.perf_counter()
        self._prefills += 1
        self._prefill_s += now - t0
        _metrics.SERVE_HOST_SYNC.observe(sync_s)
        _metrics.SERVE_ROUNDTRIPS.labels(path="prefill").inc()
        _metrics.SERVE_PREFILL_SECONDS.observe(now - t0)
        if req.first_token_t is None:
            req.first_token_t = now
            _metrics.SERVE_TTFT.observe(now - req.submit_t)
        _metrics.SERVE_TOKENS.inc()
        if req._span_prefill is not None:
            req._span_prefill.set("ttft_s", round(now - req.submit_t, 6))
            req._span_prefill.end()
            req._span_prefill = None
        self._pos[s] = n_ids
        self._counters[s] = emitted + 1
        self._temps[s] = req.temperature
        self._topks[s] = req.top_k
        self._topps[s] = req.top_p
        self._seeds[s] = req.seed & 0xFFFFFFFF
        self._eos[s] = -1 if req.eos_token_id is None else req.eos_token_id
        self._remaining[s] = req.max_new_tokens - emitted - 1
        if self._paged:
            self._active[s] = True
        slot = self._slots[s]
        slot.generated.append(tok0)
        req._emit(tok0)
        slot.t_last = now
        self._tokens[s] = tok0
        self._advance_gstate(s, tok0)
        self._check_finished(s, now)
        self._observe_occupancy()

    # ------------------------------------------------------------ paged mode
    def _fits(self, req: RequestHandle) -> bool:
        """Admission gate: the free and reclaimable prefix-cache pages can
        hold the request's prompt (plus resumed tokens) and its first
        decode writes. Prefix hits only lower the real need."""
        tokens = min(len(req.prompt_ids) + len(req._resume or ()) + self._adv, self.L)
        need = pages_for(tokens, self.page_size)
        return self._pages.free_pages() + self._pages.cached_pages() >= need

    def _admit_paged(self, s: int, req: RequestHandle):
        """Start a paged prefill: map the longest cached prefix into the
        slot's table and register the chunk cursor past it."""
        first_admission = req._resume is None
        resume = list(req._resume or ())
        ids = list(req.prompt_ids) + resume
        t0 = time.perf_counter()
        if first_admission:
            # a preempted request does not observe its queue wait again
            _metrics.SERVE_QUEUE_WAIT.observe(t0 - req.submit_t)
        _recorder.RECORDER.record("event", "serve.admit", slot=s,
                                  prompt_tokens=len(ids),
                                  resumed=not first_admission)
        if req._trace is not None:
            if req._span_queue is not None:
                req._span_queue.end()
                req._span_queue = None
            req._span_prefill = req._trace.child(
                "serve.prefill", slot=s, resumed=not first_admission)
            if not first_admission:
                req._trace.event("resume", tokens=len(resume))
        pages, matched = self._pages.match_prefix(ids)
        if matched:
            self._pages.map_prefix(s, pages, matched)
            _metrics.SERVE_PREFIX_BYTES_SAVED.inc(matched * self._tok_bytes)
            if req._span_prefill is not None:
                req._span_prefill.event("prefix_cache_hit", tokens=matched)
        if self._grammar:
            self._install_grammar(s, req)
        self._prefilling[s] = _Prefill(ids=ids, cursor=matched,
                                       counter0=len(resume), t0=t0)

    def _advance_prefills(self, unlimited: bool):
        """One chunk for each prefilling slot, or only one chunk in all
        while other requests decode (a long prompt then costs every
        decoding request one chunk of latency per tick, never its whole
        prefill)."""
        budget = (len(self._prefilling)
                  if unlimited or not self._active.any() else 1)
        while budget > 0 and self._prefilling:
            for s in list(self._prefilling):
                if budget <= 0:
                    break
                self._prefill_step_paged(s)
                budget -= 1

    def _fork_range(self, s: int, start: int, end: int):
        """Copy-on-write: fork every shared page slot ``s`` is about to
        write in positions [start, end): the ledger swaps in a fresh page
        and every pool copies the page's rows."""
        n = 0
        for ti, _ in self._pages.writable(s, start, end):
            src, dst = self._pages.fork(s, ti)
            for pool, ax in zip(self._pools, self._paxes):
                pool.select(ax, dst).copy_(pool.select(ax, src))
            n += 1
        if n and self._slots[s] is not None:
            req = self._slots[s].req
            if req._trace is not None:
                req._trace.event("cow_fork", pages=n)

    def _prefill_step_paged(self, s: int):
        """Advance slot ``s``'s prefill by one chunk. A middle chunk only
        writes KV rows; the final chunk (the bucketed remainder) also
        publishes the prompt's pages and selects token 0. Pool exhaustion
        preempts the slot itself."""
        pf = self._prefilling[s]
        req = self._slots[s].req
        now = time.perf_counter()
        if req._cancelled:
            self._retire(s, STATUS_CANCELLED)
            return
        if req.deadline is not None and now > req.deadline:
            self._retire(s, STATUS_TIMEOUT)
            return
        P = len(pf.ids)
        end = min(pf.cursor + self._chunk, P)
        try:
            self._pages.lease(s, end)
            # a fork can exhaust the pool too: a shared tail page needs a
            # fresh page to fork into
            self._fork_range(s, pf.cursor, end)
        except OutOfPages:
            self._preempt(s)
            return
        n = end - pf.cursor
        pb = n if end < P else bucket_for(n, self.min_prompt_bucket, self._chunk,
                                          self._growth)
        step = self._get_chunk(pb)
        io = self._chunk_io
        t0w = time.time()
        h = io.host()
        h["ids"][:pb] = 0
        h["ids"][:n] = pf.ids[pf.cursor:pf.cursor + n]
        h["pos"][0] = pf.cursor
        h["table"][0] = self._pages.table(s)
        io.upload(0, io.nbytes)
        hidden = step()
        self._prefill_chunks += 1
        if req._span_prefill is not None:
            extra = {} if end < P else {"final": True}
            req._span_prefill.child("serve.prefill_chunk", t0=t0w, start=pf.cursor,
                                    end=end, **extra).end()
        if end < P:
            pf.cursor = end
            _metrics.SERVE_PREFILL_CHUNKS.inc()
            return
        tok0, sync_s = self._token0(s, hidden, n - 1, req, pf.counter0)
        # publish the prompt for prefix reuse before decode writes touch
        # its tail page (the slot's own next write forks it)
        self._pages.insert_prefix(s, pf.ids)
        del self._prefilling[s]
        self._start_decode(s, req, tok0, pf.t0, P, pf.counter0, sync_s)

    def _preempt(self, s: int):
        """Release slot ``s``'s pages and requeue its request at the front
        with its generated tokens kept for the resume, which re-prefills
        ``prompt + generated`` and continues the sampling stream at
        counter ``len(generated)``."""
        slot = self._slots[s]
        slot.req._resume = list(slot.generated)
        doc = None
        if self._migrate_hook is not None:
            # the victim's pages, before release() frees them
            try:
                doc = self._export_slot_pages(s, list(slot.req.prompt_ids)
                                              + slot.req._resume)
            except Exception as e:
                warnings.warn(f"serve: preempt-rescue export failed, requeueing "
                              f"locally: {e!r}")
        with self._lock:
            self._slots[s] = None
        self._active[s] = False
        self._prefilling.pop(s, None)
        self._pages.release(s)
        self._reset_slot_state(s)
        self._preempted += 1
        self._resumed_tokens += len(slot.generated)
        req = slot.req
        _metrics.SERVE_PAGE_PREEMPTIONS.inc()
        _recorder.RECORDER.record_preemption(slot=s, generated=len(req._resume))
        if req._trace is not None:
            if req._span_prefill is not None:
                req._span_prefill.end(status="preempted")
                req._span_prefill = None
            req._trace.event("preempt", generated=len(req._resume))
            # a fresh queue span covers the wait for re-admission
            req._span_queue = req._trace.child("serve.queue", requeued=True)
        if doc is not None:
            # preemption rescue: True = the hook resumes the request on
            # another replica and completes this handle; do not requeue
            try:
                if self._migrate_hook(self, req, doc):
                    return
            except Exception as e:
                warnings.warn(f"serve: preempt-rescue hook failed, requeueing "
                              f"locally: {e!r}")
        req._status = "queued"
        with self._cond:
            # may exceed max_queue_depth: a preemption never drops a request
            self._queue.appendleft(req)
            _metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))

    def _lease_decode(self):
        """Fork shared pages and lease growth for this tick's decode writes
        (each active row writes positions [pos, pos + K), or [pos, pos +
        speculate) in a verify round). Pool exhaustion preempts the youngest
        request (prefilling or decoding), by its first admission, and
        retries: the oldest work always progresses."""
        while True:
            try:
                for s in range(self.S):
                    if self._active[s]:
                        p = int(self._pos[s])
                        self._fork_range(s, p, p + self._adv)
                        self._pages.lease(s, min(p + self._adv, self.L))
                return
            except OutOfPages:
                victim = max((s for s in range(self.S)
                              if self._slots[s] is not None),
                             key=lambda s: self._slots[s].req.admit_t)
                self._preempt(victim)

    # ------------------------------------------------------------ decode
    def _step_tick(self):
        """Advance contiguous decode one tick. Without lookahead: dispatch
        one step over the occupied slot prefix and read it. With lookahead:
        dispatch step N+1, fed step N's device tokens, then read step N; a
        retire at that read drains the pipeline (step N+1 is read at once,
        its rows of retired slots discarded), so the next tick dispatches
        from the host's tokens for the new row set. A speculative engine
        runs a verify round instead."""
        if self.spec:
            self._step_tick_spec()
            return
        prev, self._pending = self._pending, None
        live = [(s, self._slots[s]) for s in range(self.S) if self._slots[s] is not None]
        sb = bucket_for(live[-1][0] + 1, 1, self.S)
        if prev is not None and prev.sb != sb:
            # the row set moved without a drain (not expected: admits and
            # retires drain): read prev first
            self._process_step(prev)
            prev = None
            live = [(s, self._slots[s]) for s in range(self.S)
                    if self._slots[s] is not None]
            if not live:
                return
            sb = bucket_for(live[-1][0] + 1, 1, self.S)
        self._tick(prev, sb, live, None)

    def _decoding(self) -> List[Tuple[int, _Slot]]:
        """(slot, _Slot) of every decoding slot in row order (mid-prefill
        slots are not decoding: their rows in a bucket are all-sink)."""
        return [(s, self._slots[s]) for s in range(self.S)
                if self._active[s] and self._slots[s] is not None]

    @staticmethod
    def _same_rows(a, b) -> bool:
        return len(a) == len(b) and all(x[0] == y[0] and x[1] is y[1] for x, y in zip(a, b))

    def _step_tick_paged(self):
        """The paged tick: one dispatch over the slot prefix up to the
        highest decoding slot. Rows of the prefix that do not decode (empty
        or mid-prefill) carry all-sink tables, position 0 and no budget:
        their writes land in the sink page and their tokens are discarded.
        The lookahead step feeds the next dispatch only while the decoding
        rows and the bucket are unchanged; activation, preemption and
        retires drain it first. A speculative engine runs a verify round
        instead."""
        if self.spec:
            self._step_tick_spec()
            return
        prev, self._pending = self._pending, None
        self._lease_decode()                 # may preempt (changes the rows)
        cur = self._decoding()
        if not cur:
            if prev is not None:
                self._process_step(prev)
            return
        sb = bucket_for(cur[-1][0] + 1, 1, self.S)
        if prev is not None and not (prev.sb == sb and self._same_rows(prev.slots, cur)):
            retired = self._process_step(prev)
            prev = None
            if retired:
                cur = self._decoding()
                if not cur:
                    return
                sb = bucket_for(cur[-1][0] + 1, 1, self.S)
        tables = np.full((sb, self.maxp), self._pages.sink, np.int32)
        for s, _ in cur:
            tables[s] = self._pages.table(s)
        self._tick(prev, sb, cur, tables)

    def _tick(self, prev: Optional[_PendingStep], sb: int, live, tables):
        """Dispatch over rows ``live`` of bucket ``sb`` (fed ``prev``'s
        tokens where given), then read ``prev``; keep the new step pending
        (lookahead) or read it now."""
        if int(self._remaining[:sb].max(initial=0)) <= 0:
            # every row ends within prev (the JAX loop's early exit)
            if prev is not None:
                self._process_step(prev)
            return
        rec = self._dispatch(prev, sb, live, tables)
        if rec is None:
            return                  # failed; prev was read and the rows retired
        if prev is not None and self._process_step(prev):
            self._process_step(rec)
            rec = None
        if self._lookahead:
            self._pending = rec
        elif rec is not None:
            self._process_step(rec)

    def _dispatch(self, prev: Optional[_PendingStep], sb: int, live,
                  tables) -> Optional[_PendingStep]:
        """Dispatch one decode step over slot rows [0, sb) without reading
        it: pick the step (substeps, sampling branch) on the host, fill the
        bucket's staging (tokens only when ``prev`` does not feed them;
        keys only with a row at T > 0) and upload it with one copy, replay,
        and start the copy of the [sb, K] tokens to pinned host memory. The
        host clocks advance by K for every row at once. On failure the
        pending ``prev`` is read first (its tokens exist), then every slot
        retires with an error; returns None."""
        t0 = time.perf_counter()
        steps = int(min(self.K, self._remaining[:sb].max(initial=0)))
        sampled = bool((self._temps[:sb] > 0).any())
        if self._head is not None:
            filtered = sampled and bool((self._topks[:sb] > 0).any()
                                        or (self._topps[:sb] < 1.0).any())
            branch = "filtered" if filtered else "fused"
        else:
            branch = "sampled" if sampled else "greedy"
        try:
            step = self._get_step(sb, steps, branch)
            io = self._io[sb]
            h = io.host()
            if prev is None:
                h["tokens"][:] = self._tokens[:sb]
                if self._grammar:
                    h["gstate"][:] = self._gstate[:sb]
            if self._grammar:
                self._sync_gtab()
            h["pos"][:] = self._pos[:sb]
            h["temps"][:] = self._temps[:sb]
            h["topks"][:] = self._topks[:sb]
            h["topps"][:] = self._topps[:sb]
            h["eos"][:] = self._eos[:sb]
            h["rem"][:] = self._remaining[:sb]
            if tables is not None:
                h["table"][:] = tables
            end = io.offset("keys")
            if sampled:
                _prng.step_keys(self._seeds[:sb], self._counters[:sb], steps,
                                out=h["keys"][:steps])
                end += steps * sb * 16
            io.upload(io.offset("pos") if prev is not None else 0, end)
            toks = step()
            self._out_i ^= 1
            host = self._out_host[self._out_i][:sb]
            host.copy_(toks, non_blocking=True)
            event = self._out_events[self._out_i]
            if event is not None:
                event.record()
        except Exception as e:
            warnings.warn(f"serve: decode step failed: {e!r}")
            if prev is not None:
                self._process_step(prev)
            for s in range(self.S):
                if self._slots[s] is not None:
                    self._retire(s, STATUS_ERROR, error=str(e))
            return None
        self._dispatches += 1
        self._substeps += steps
        # the dispatched step owns this tick's clocks; advance them by K for
        # every row now, so the next dispatch (possibly before this one is
        # read) sees them (a row finishing early retires at the read)
        for s, _ in live:
            self._pos[s] += self.K
            self._counters[s] += self.K
            self._remaining[s] -= self.K
        self._decode_s += time.perf_counter() - t0
        return _PendingStep(sb=sb, slots=list(live), t0=t0, steps=steps, toks=host,
                            event=event)

    def _process_step(self, rec: _PendingStep) -> bool:
        """Read one dispatched step and apply it: append each row's tokens
        in order, stopping at its EOS, budget, cancel or deadline (later
        columns are the discarded speculative tokens), and retire finished
        slots. Rows whose slot retired or was refilled since the dispatch
        are skipped. Returns True when any slot retired."""
        t0 = time.perf_counter()
        if rec.event is not None:
            rec.event.synchronize()
        toks = rec.toks.numpy()
        now = time.perf_counter()
        now_wall = time.time()
        # the dispatch stamp on the wall clock, for the spans
        chunk_t0w = now_wall - (now - rec.t0)
        _metrics.SERVE_HOST_SYNC.observe(now - t0)
        _metrics.SERVE_ROUNDTRIPS.labels(path="decode").inc()
        retired = False
        appended = 0
        for s, slot in rec.slots:
            if self._slots[s] is not slot:
                continue
            # the dispatch's wall time spread over its tokens
            per_tok = (now - slot.t_last) / rec.steps
            row_tokens = 0
            for j in range(rec.steps):
                tok = int(toks[s, j])
                slot.generated.append(tok)
                slot.req._emit(tok)
                _metrics.SERVE_INTERTOKEN.observe(per_tok)
                slot.t_last = now
                self._tokens[s] = tok
                self._advance_gstate(s, tok)
                self._decode_tokens += 1
                appended += 1
                row_tokens += 1
                self._check_finished(s, now)
                if self._slots[s] is not slot:
                    retired = True
                    break                  # rest of the K-vector: discard
            if slot.req._trace is not None and row_tokens:
                slot.req._trace.child("serve.decode_chunk", t0=chunk_t0w,
                                      tokens=row_tokens).end(t1=now_wall)
        self._decode_s += time.perf_counter() - t0
        dt = now - rec.t0
        _metrics.SERVE_STEP_SECONDS.observe(dt)
        _metrics.SERVE_TOKENS.inc(appended)
        if dt > 0:
            _metrics.SERVE_TOKENS_PER_SEC.set(appended / dt)
        return retired

    # ------------------------------------------------------------ speculation
    def _step_tick_spec(self):
        """One draft-verify round over every decoding slot, in both layouts
        (the JAX engine's ``_step_tick_spec``): each row drafts from its
        request's own history (``speculate.draft_from_history``), under a
        grammar rewritten legal with its per-column automaton states
        (``speculate.constrain_draft``); one verify step of the bucket runs
        them, and the round is read at once: the next round's drafts depend
        on the tokens this one accepts."""
        if self._paged:
            self._lease_decode()                 # may preempt (changes the rows)
            cur = self._decoding()
        else:
            cur = [(s, slot) for s, slot in enumerate(self._slots) if slot is not None]
        if not cur:
            return
        t0 = time.perf_counter()
        sb = bucket_for(cur[-1][0] + 1, 1, self.S)
        T = self.spec
        sampled = bool((self._temps[:sb] > 0).any())
        try:
            step = self._get_spec(sb, "sampled" if sampled else "greedy")
            io = self._spec_io[sb]
            h = io.host()
            h["inputs"][:] = 0
            if self._grammar:
                h["gstates"][:] = 0
                h["eos"][:] = self._eos[:sb]
                self._sync_gtab()
            for s, slot in cur:
                hist = list(slot.req.prompt_ids) + slot.generated
                draft = (_spec.draft_from_history(hist, self._n_draft, self._spec_lookup)
                         + [int(self._tokens[s])] * (T - 1 - self._n_draft))
                if self._grammar:
                    q0 = int(self._gstate[s])
                    h["gstates"][s] = q0
                    if self._gram[s] is not None:
                        draft, states, rej = _spec.constrain_draft(draft, self._gram[s], q0)
                        if rej:
                            _metrics.GRAMMAR_REJECTED.inc(rej)
                        h["gstates"][s] = states[:T]
                h["inputs"][s, 0] = self._tokens[s]
                h["inputs"][s, 1:] = draft
            h["pos"][:] = self._pos[:sb]
            h["temps"][:] = self._temps[:sb]
            h["topks"][:] = self._topks[:sb]
            h["topps"][:] = self._topps[:sb]
            if self._paged:
                h["table"][:] = self._pages.sink
                for s, _ in cur:
                    h["table"][s] = self._pages.table(s)
            end = io.offset("keys")
            if sampled:
                h["keys"][:] = _prng.step_keys(self._seeds[:sb], self._counters[:sb],
                                               T).transpose(1, 0, 2)
                end = io.nbytes
            io.upload(0, end)
            out = step()
            self._out_i ^= 1
            host = self._out_host[self._out_i][:sb]
            host.copy_(out, non_blocking=True)
            event = self._out_events[self._out_i]
            t_sync = time.perf_counter()
            if event is not None:
                event.record()
                event.synchronize()
        except Exception as e:
            warnings.warn(f"serve: speculative decode step failed: {e!r}")
            for s in range(self.S):
                if self._slots[s] is not None:
                    self._retire(s, STATUS_ERROR, error=str(e))
            return
        self._process_step_spec(cur, host.numpy(), t0, t_sync)

    def _process_step_spec(self, cur, out: np.ndarray, t0: float, t_sync: float):
        """Apply one verify round (``out`` [sb, spec + 1]: tokens, then the
        accepted count): append each row's valid tokens in order, advancing
        its position, counter and budget per appended token, and stop a row
        at its EOS, budget, cancel or deadline."""
        T = self.spec
        now = time.perf_counter()
        now_wall = time.time()
        chunk_t0w = now_wall - (now - t0)
        _metrics.SERVE_HOST_SYNC.observe(now - t_sync)
        _metrics.SERVE_ROUNDTRIPS.labels(path="decode").inc()
        drafted = rejected = appended = 0
        for s, slot in cur:
            if self._slots[s] is not slot:
                continue
            e = int(out[s, T])                   # 1..T valid tokens
            drafted += T - 1
            rejected += T - e
            per_tok = (now - slot.t_last) / e
            row_tokens = 0
            for j in range(e):
                tok = int(out[s, j])
                slot.generated.append(tok)
                slot.req._emit(tok)
                _metrics.SERVE_INTERTOKEN.observe(per_tok)
                slot.t_last = now
                self._tokens[s] = tok
                self._advance_gstate(s, tok)
                self._pos[s] += 1
                self._counters[s] += 1
                self._remaining[s] -= 1
                self._decode_tokens += 1
                appended += 1
                row_tokens += 1
                self._check_finished(s, now)
                if self._slots[s] is not slot:
                    break                        # the rest of the round: discard
            if slot.req._trace is not None and row_tokens:
                slot.req._trace.child("serve.decode_chunk", t0=chunk_t0w,
                                      tokens=row_tokens,
                                      speculative=True).end(t1=now_wall)
        self._spec_rounds += 1
        self._spec_drafted += drafted
        self._spec_accepted += drafted - rejected
        _metrics.SPEC_ROUNDS.inc()
        if drafted:
            _metrics.SPEC_DRAFTED.inc(drafted)
            _metrics.SPEC_REJECTED.inc(rejected)
            _metrics.SPEC_ACCEPTED.inc(drafted - rejected)
        if self._spec_drafted:
            _metrics.SPEC_ACCEPTANCE.set(self._spec_accepted / self._spec_drafted)
        self._dispatches += 1
        self._substeps += 1
        self._decode_s += time.perf_counter() - t0
        dt = now - t0
        _metrics.SERVE_STEP_SECONDS.observe(dt)
        _metrics.SERVE_TOKENS.inc(appended)
        if dt > 0:
            _metrics.SERVE_TOKENS_PER_SEC.set(appended / dt)

    # ------------------------------------------------------------ grammar
    def _install_grammar(self, s: int, req: RequestHandle):
        """Write the request's automaton into slot ``s``'s table rows
        (identity rows for a free request) and seed the slot's state,
        walking a resumed request's tokens so that a preempted request
        resumes in its state. The device tables are marked for upload only
        when the slot's grammar changes."""
        g = req.grammar
        if g is not None or self._gram[s] is not None:
            if g is None:
                rows = _grammar.identity_tables(self._vocab, self._gmax, self._gmax)
            else:
                rows = g.padded_tables(self._gmax, self._gmax)
            self._gcls[s], self._gnxt[s], self._gacc[s] = rows
            self._gram[s] = g
            self._gdirty = True
        q = 0
        if g is not None:
            for tok in req._resume or ():
                nq = g.advance(q, int(tok))
                if nq < 0:
                    break
                q = nq
        self._gstate[s] = q

    def _advance_gstate(self, s: int, tok: int):
        """Advance slot ``s``'s host automaton state past one emitted token:
        the authoritative ledger (a step's device states only feed the
        lookahead dispatch; every dispatch from the host re-syncs them). EOS
        parks the state; a token the automaton rejects (impossible under
        the mask) parks it with a warning."""
        if not self._grammar or self._gram[s] is None or tok == int(self._eos[s]):
            return
        nq = self._gram[s].advance(int(self._gstate[s]), int(tok))
        if nq >= 0:
            self._gstate[s] = nq
        else:
            warnings.warn(
                f"serve: grammar automaton rejected emitted token {tok} in state "
                f"{int(self._gstate[s])} (slot {s}) — the device mask and host "
                "ledger diverged; parking the state")

    def _sync_gtab(self):
        """Upload the [S, ...] grammar tables to their device buffer if a
        slot's grammar changed since the last upload (stream-ordered before
        the next step)."""
        if self._gdirty:
            h = self._gtab.host()
            h["gcls"][:] = self._gcls
            h["gnxt"][:] = self._gnxt
            h["gacc"][:] = self._gacc
            self._gtab.upload(0, self._gtab.nbytes)
            self._gdirty = False

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
        self._topks[s] = 0
        self._topps[s] = 1.0
        self._seeds[s] = 0
        self._counters[s] = 0
        self._eos[s] = -1
        self._remaining[s] = 0
        if self._grammar and self._gram[s] is not None:
            # back to identity, so that a stale constrained row can never
            # empty-mask a discarded bucket row
            icls, inxt, iacc = _grammar.identity_tables(self._vocab, self._gmax,
                                                        self._gmax)
            self._gcls[s], self._gnxt[s], self._gacc[s] = icls, inxt, iacc
            self._gram[s] = None
            self._gstate[s] = 0
            self._gdirty = True

    def _retire(self, s: int, status: str, error: Optional[str] = None):
        with self._lock:
            slot = self._slots[s]
            self._slots[s] = None
            self._completed[status] = self._completed.get(status, 0) + 1
        if self._paged:
            self._active[s] = False
            self._prefilling.pop(s, None)
            # shared pages survive under their prefix-cache / other refs
            self._pages.release(s)
        self._reset_slot_state(s)
        req = slot.req
        res = ServeResult(
            status=status, prompt_ids=req.prompt_ids,
            generated_ids=list(slot.generated),
            queue_wait_s=(req.admit_t - req.submit_t
                          if req.admit_t is not None else None),
            ttft_s=(req.first_token_t - req.submit_t
                    if req.first_token_t is not None else None),
            latency_s=time.perf_counter() - req.submit_t, error=error,
            trace_id=req.trace_id)
        _metrics.SERVE_REQUESTS.labels(status=status).inc()
        _metrics.SERVE_REQUEST_SECONDS.observe(res.latency_s)
        _recorder.RECORDER.record(
            "event", "serve.retire", slot=s, status=status,
            generated=len(res.generated_ids),
            **({"error": error or ""} if status == STATUS_ERROR else {}))
        if req._trace is not None:
            for open_span in (req._span_queue, req._span_prefill):
                if open_span is not None:
                    open_span.end(status=status)
            req._span_queue = req._span_prefill = None
            req._trace.event("retire", status=status, generated=len(res.generated_ids))
            req._trace.set("generated_tokens", len(res.generated_ids))
            req._trace.end(status=status)
        req._complete(res)

    def _finish_unstarted(self, req: RequestHandle, status: str,
                          error: Optional[str] = None):
        """Complete a queued request; one preempted and then expired keeps
        the tokens it generated before the preemption."""
        res = ServeResult(status=status, prompt_ids=req.prompt_ids,
                          generated_ids=list(req._resume or ()),
                          latency_s=time.perf_counter() - req.submit_t,
                          error=error, trace_id=req.trace_id)
        with self._lock:
            self._completed[status] = self._completed.get(status, 0) + 1
        _metrics.SERVE_REQUESTS.labels(status=status).inc()
        _metrics.SERVE_REQUEST_SECONDS.observe(res.latency_s)
        _recorder.RECORDER.record("event", "serve.retire", status=status,
                                  generated=len(res.generated_ids), admitted=False)
        if req._trace is not None:
            if req._span_queue is not None:
                req._span_queue.end(status=status)
                req._span_queue = None
            req._trace.event("retire", status=status, generated=len(res.generated_ids))
            req._trace.end(status=status)
        req._complete(res)

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        """Request, prefill and decode counters. ``decode_substeps`` counts
        incremental forwards (each runs every block once); ``decode_s`` is
        the host wall time of the decode dispatches and of their reads
        (with lookahead a read waits for the next step too); ``prefill_s`` spans
        each prefill from admission to its token 0. ``kv_bytes`` is the
        KV memory (the pools, sink page included); a paged engine adds
        ``page_size``, the page ledger's ``pages`` counters, the slots
        ``prefilling``, the ``preemptions`` and the ``resumed_tokens``
        (generated tokens that preempted requests prefill again).

        As in the JAX engine: ``lookahead``, ``multi_token``, ``speculate``,
        ``grammar`` (a bool), ``last_warmup_s`` and ``compiled_buckets``,
        whose ``"decode"`` lists the built decode steps as (batch bucket,
        substeps, branch), ``"spec"`` (speculative engines) the verify steps
        as (batch bucket, branch) and ``"prefill"`` the paged chunk buckets
        (the contiguous prefill runs eagerly). A speculative engine adds
        ``spec``: ``rounds``, ``drafted``, ``accepted`` and
        ``acceptance_rate`` (accepted / drafted, 4 places; None before a
        draft); a verify round counts as one decode dispatch and substep. ``captures`` counts the steps built (on the card: CUDA
        graphs captured); serving after :meth:`warmup` leaves it unchanged
        (the zero-recompile contract; the score graphs count too, and
        :meth:`warmup_score` builds them); ``compiled_buckets["score"]``
        lists the score buckets once one is built.

        The JAX engine's serving keys: ``running``, ``draining``, ``name``,
        ``weight_version``, ``weight_swaps``, ``slots``, ``slots_in_use``,
        ``max_len``, ``tier`` and ``load`` (the router's least-loaded
        signal: the worse of slot and page pressure plus the queue backlog
        over ``max_queue_depth``; cache-only pages count as free), and on
        a paged engine ``prefix_summary`` (``{"page_size", "roots"}``, the
        top ``prefix_advert`` prefix-cache roots)."""
        with self._lock:
            in_use = sum(1 for s in self._slots if s is not None)
            out = {
                "running": self._running,
                "draining": self._draining,
                "name": self.name,
                "weight_version": self.weight_version,
                "weight_swaps": self._weight_swaps,
                "slots": self.S,
                "slots_in_use": in_use,
                "max_len": self.L,
                "tier": self.tier,
                "submitted": self._submitted,
                "completed": dict(self._completed),
                "queue_depth": len(self._queue),
                "max_active": self._max_active,
                "prefills": self._prefills,
                "prefill_chunks": self._prefill_chunks,
                "prefill_s": self._prefill_s,
                "decode_dispatches": self._dispatches,
                "decode_substeps": self._substeps,
                "decode_tokens": self._decode_tokens,
                "decode_s": self._decode_s,
                "paged": self._paged,
                "kv_bytes": sum(p.numel() * p.element_size() for p in self._pools),
                "lookahead": self._lookahead,
                "multi_token": self.K,
                "speculate": self.spec,
                "grammar": self._grammar,
                "compiled_buckets": {"prefill": sorted(self._chunks),
                                     "decode": sorted(self._steps)},
                "captures": self._captures,
                "last_warmup_s": self.last_warmup_s,
            }
            if self.spec:
                out["compiled_buckets"]["spec"] = sorted(self._spec_steps)
                out["spec"] = {
                    "rounds": self._spec_rounds, "drafted": self._spec_drafted,
                    "accepted": self._spec_accepted,
                    "acceptance_rate": (round(self._spec_accepted / self._spec_drafted, 4)
                                        if self._spec_drafted else None)}
            if self._score_steps:
                out["compiled_buckets"]["score"] = sorted(self._score_steps)
        load = in_use / self.S
        if self._paged:
            pstats = self._pages.stats()
            roots = self._pages.prefix_summary(self._prefix_advert)
            out.update({"page_size": self.page_size, "pages": pstats,
                        "prefilling": len(self._prefilling),
                        "preemptions": self._preempted,
                        "resumed_tokens": self._resumed_tokens,
                        "prefix_summary": {"page_size": self.page_size,
                                           "roots": roots}})
            _metrics.CACHE_ADVERT_ROOTS.set(len(roots))
            held = pstats["pages_in_use"] - pstats["pages_cached_only"]
            load = max(load, held / pstats["pages"])
        out["load"] = round(load + out["queue_depth"] / max(self.max_queue_depth, 1), 4)
        return out
