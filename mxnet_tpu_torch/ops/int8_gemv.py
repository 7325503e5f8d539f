"""Weight-only int8 and int4 GEMV for decode-shaped matmuls (counterpart
of ``mxnet_tpu/ops/int8_gemv.py``), plus the launch counters of the decode
kernels.

:func:`int8_weight_matmul` and :func:`int4_weight_matmul` dispatch by the
tensor's device: a CPU tensor takes the plain PyTorch version
(:func:`_reference_int8_matmul`, :func:`_reference_int4_matmul`: the exact
op sequence of the JAX package's off-TPU fallback, dequantize, then an f32
matmul); a CUDA tensor launches the hand-written kernel
``csrc/int8_gemv.cu`` (K3) or ``csrc/int4_gemv.cu`` (K4), or raises.

On the card each kernel has two routes, chosen by the row count
(:func:`gemv_route`): the warp route (one warp per dot, f32 FMAs in the
dot order K8 shares; a persistent grid whose warps stream groups of
output channels through rings of TMA bulk copies, ``csrc/gemv_warp.cuh``;
decode rows, M <= 8, and rows past :func:`gemv_max_m`), and the tile route
(tensor cores over x written as three bf16 planes; prefill rows,
``GEMV_TILE_MIN_M`` <= M <= :func:`gemv_max_m`). :func:`gemv_routes`
counts the kernel launches per route.

``x`` is f32 or bf16 (block 0 of a bf16 model feeds its embedding sum);
the output is f32 either way, as in the JAX package. The bf16 lane of both
routes gives the f32 lane's result on ``x.float()`` bit for bit: the warp
route stages x as bf16 and widens it as it reads it, the tile route takes a
bf16 x as its own single plane (a third of the f32 lane's tensor-core
products).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from .. import metrics as _metrics
from ..base import MXNetError

__all__ = ["int8_weight_matmul", "int4_weight_matmul", "weight_matmul",
           "dequantize_int4_table", "count_launches",
           "record_launch", "reset_launches", "launches", "record_dma",
           "dma_ledger", "gemv_max_m", "GEMV_INT4_BLOCK", "GEMV_TILE_MIN_M",
           "GEMV_TILE_K", "gemv_route", "gemv_routes", "gemv_widths", "record_lane", "dtype_lanes",
           "record_graph", "GraphTally", "note_build"]

# row threshold of the GEMV route: at most this many rows stream int8
# weights through K3, more take the activation-quantized int8 product
# (contrib/quantization). The JAX package's tuned-config layer is not
# ported; this is its default.
_GEMV_MAX_M = 64


def gemv_max_m() -> int:
    return _GEMV_MAX_M


# fewest rows of the tile route: one more than the warp route's 8-row
# activation tile (csrc/gemv_common.cuh kRowTile), so decode batches of up
# to 8 rows keep the warp route and its bitwise agreement with K8
GEMV_TILE_MIN_M = 9
# codes per k-tile of the tile route (csrc/gemv_mma.cuh kBK): K, and an
# int4 table's block, must be multiples of it
GEMV_TILE_K = 32


def gemv_route(M: int) -> str:
    """The GEMV route of an M-row call on the card: ``"mma"`` (tensor
    cores) for ``GEMV_TILE_MIN_M`` <= M <= :func:`gemv_max_m`, else
    ``"warp"``."""
    return "mma" if GEMV_TILE_MIN_M <= M <= gemv_max_m() else "warp"


# codes per f32 scale of the int4 weight tables (contrib/quantization):
# the default of the JAX package's tuned ``gemv_int4_block`` knob, which
# is not ported
GEMV_INT4_BLOCK = 128


# ---------------------------------------------------------------------------
# Launch accounting. A launch is a real kernel launch (or, on the CPU, a
# call of its plain version under the same kind): a wrapper records one
# where its kernel launched, after the launch returned without error, or
# where its plain version ran. ``launches()`` reads the process-wide
# per-kind totals, ``reset_launches()`` zeroes them, and
# ``count_launches()`` additionally tallies one thread's launches inside a
# ``with`` block (the JAX package's trace-time tally). A CUDA-graph capture
# runs the wrappers once and launches nothing: inside ``record_graph()``
# their records go to the capture's :class:`GraphTally` instead, and each
# replay of the graph adds that tally (``GraphTally.replayed``).
# ---------------------------------------------------------------------------
_COUNTS: Dict[str, int] = {}
_ROUTES: Dict[str, int] = {"warp": 0, "mma": 0}
_WIDTHS: Dict[str, int] = {}
_LANES: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()
_TALLY = threading.local()
_CAPTURE = threading.local()


def _add(into: Dict[str, int], counts: Dict[str, int]):
    for key, n in counts.items():
        into[key] = into.get(key, 0) + n


class GraphTally:
    """The launch records of one CUDA-graph capture: launches per kind,
    lane, route and width, and the DMA ledger entries, whose 0-dim device
    values are graph tensors that every replay overwrites. :meth:`seal`,
    called inside the capture, sums those values into one captured [3]
    int64 vector; :meth:`replayed`, called after each replay, adds the
    counts and clones that vector on the replay's stream (no host sync)."""

    def __init__(self):
        self.kinds: Dict[str, int] = {}
        self.lanes: Dict[str, int] = {}
        self.routes: Dict[str, int] = {}
        self.widths: Dict[str, int] = {}
        self.dma: list = []
        self._dma_vec = None

    def seal(self):
        """Form the DMA totals inside the capture: ints stay host
        constants, device values are summed by captured ops."""
        if not self.dma:
            return
        fields = []
        for i in range(3):
            vals = [entry[i] for entry in self.dma]
            lazy = [v.reshape(()).long() for v in vals if torch.is_tensor(v)]
            const = sum(int(v) for v in vals if not torch.is_tensor(v))
            fields.append(torch.stack(lazy).sum() + const if lazy else const)
        if any(torch.is_tensor(f) for f in fields):
            dev = next(f.device for f in fields if torch.is_tensor(f))
            self._dma_vec = torch.stack([f if torch.is_tensor(f) else
                                         torch.full((), f, dtype=torch.int64, device=dev)
                                         for f in fields])
        else:
            self._dma_vec = tuple(fields)

    def replayed(self):
        """Count one replay of the captured graph."""
        with _COUNTS_LOCK:
            _add(_COUNTS, self.kinds)
            _add(_LANES, self.lanes)
            _add(_ROUTES, self.routes)
            _add(_WIDTHS, self.widths)
            if self._dma_vec is not None:
                _DMA_PENDING.append(self._dma_vec.clone() if torch.is_tensor(self._dma_vec)
                                    else self._dma_vec)
                if len(_DMA_PENDING) >= _DMA_FOLD_AT:
                    _fold_dma()
        d = getattr(_TALLY, "d", None)
        if d is not None:
            _add(d, self.kinds)


def note_build(tally: GraphTally, dma: Optional[GraphTally] = None):
    """Count one built step in ``mxnet_decode_launches_total`` (its launch
    sites per kind, ``tally.kinds``) and ``mxnet_decode_dma_*`` (the page
    copies of ``dma``'s records, default ``tally``'s): the JAX package
    counts both once per compiled step, when it traces it
    (``mxnet_tpu/ops/int8_gemv.py`` ``record_launch``/``record_dma``); the
    port counts once per built step, from its capture's tally, or from its
    first run's where nothing is captured. K7 starts copies by position, so
    its DMA program is read from a run that computed it (a capture's values
    exist only after a replay); reading device values syncs, which a build
    may. The runtime counts (:func:`launches`, :func:`dma_ledger`) are
    separate."""
    if not _metrics.ENABLED:
        return
    for kind, n in tally.kinds.items():
        _metrics.DECODE_LAUNCHES.labels(kind=kind).inc(n)
    entries = (tally if dma is None else dma).dma
    if entries:
        copies, nbytes, waits = (sum(int(e[i]) for e in entries) for i in range(3))
        _metrics.DECODE_DMA_COPIES.inc(copies)
        _metrics.DECODE_DMA_BYTES.inc(nbytes)
        _metrics.DECODE_DMA_WAITS.inc(waits)


@contextlib.contextmanager
def record_graph():
    """Send this thread's launch records to a fresh :class:`GraphTally`
    (yielded) instead of the counters, for the span of a CUDA-graph
    capture, or of a run whose launches are not counted."""
    prev = getattr(_CAPTURE, "t", None)
    tally = GraphTally()
    _CAPTURE.t = tally
    try:
        yield tally
    finally:
        _CAPTURE.t = prev


@contextlib.contextmanager
def count_launches():
    """Tally the launches recorded on this thread: yields {kind: count}."""
    prev = getattr(_TALLY, "d", None)
    d: dict = {}
    _TALLY.d = d
    try:
        yield d
    finally:
        _TALLY.d = prev


def record_launch(kind: str):
    """Record one launch of a decode kernel (or of its plain version)."""
    cap = getattr(_CAPTURE, "t", None)
    if cap is not None:
        _add(cap.kinds, {kind: 1})
        return
    with _COUNTS_LOCK:
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
    d = getattr(_TALLY, "d", None)
    if d is not None:
        d[kind] = d.get(kind, 0) + 1


def launches() -> Dict[str, int]:
    """Process-wide launches per kind since the last :func:`reset_launches`."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def record_lane(key: str):
    """Record one kernel launch on the card under its element-type lane,
    ``"<kind>:<route>:<x dtype>"`` for K3/K4 (e.g. ``"gemv:mma:bf16"``),
    ``"<kind>:x_<dtype>:kv_<dtype>"`` for the block kernels and
    ``"<kind>:h_<dtype>[:bf16_logits][:mask]"`` for K8."""
    cap = getattr(_CAPTURE, "t", None)
    if cap is not None:
        _add(cap.lanes, {key: 1})
        return
    with _COUNTS_LOCK:
        _LANES[key] = _LANES.get(key, 0) + 1


def dtype_lanes() -> Dict[str, int]:
    """Process-wide kernel launches per element-type lane (see
    :func:`record_lane`) since the last :func:`reset_launches`; only
    launches on the card count."""
    with _COUNTS_LOCK:
        return dict(_LANES)


def _record_gemv(kind: str, route: str, x_dtype: str = "f32", N: Optional[int] = None):
    """Record one K3 or K4 kernel launch under its kind, its route, its
    activation lane (``"f32"`` or ``"bf16"``) and, where given, its output
    width N."""
    record_launch(kind)
    record_lane(f"{kind}:{route}:{x_dtype}")
    widths = {f"{route}:{N}": 1} if N is not None else {}
    cap = getattr(_CAPTURE, "t", None)
    if cap is not None:
        _add(cap.routes, {route: 1})
        _add(cap.widths, widths)
        return
    with _COUNTS_LOCK:
        _ROUTES[route] += 1
        _add(_WIDTHS, widths)


def gemv_routes() -> Dict[str, int]:
    """Process-wide K3 + K4 kernel launches per route, ``{"warp": n,
    "mma": n}``, since the last :func:`reset_launches`. Only launches on
    the card count: a CPU call runs the plain version and takes no route."""
    with _COUNTS_LOCK:
        return dict(_ROUTES)


def gemv_widths() -> Dict[str, int]:
    """Process-wide K3 + K4 kernel launches per ``"<route>:<N>"`` (e.g.
    ``"warp:50304"``: the tied head of GPT-2 on the warp route) since the
    last :func:`reset_launches`; card launches only, as
    :func:`gemv_routes`."""
    with _COUNTS_LOCK:
        return dict(_WIDTHS)


def reset_launches():
    """Zero the launch counts, the route, width and lane counts and the DMA
    ledger."""
    with _COUNTS_LOCK:
        _COUNTS.clear()
        _LANES.clear()
        _WIDTHS.clear()
        for key in _ROUTES:
            _ROUTES[key] = 0
        _DMA_PENDING.clear()
        for key in _DMA:
            _DMA[key] = 0


# ---------------------------------------------------------------------------
# DMA ledger of the streamed paged block kernel (K7): the page copies a
# launch starts, their bytes, and the copies it waits for; the kernel waits
# for every copy it starts, so copies == waits is the invariant. The count
# depends on the rows' positions, which live on the device: a value may be
# a 0-dim tensor, summed only when the ledger is read, so recording costs
# the launch path no host sync. A graph replay records its capture's totals
# as one [3] int64 tensor (``GraphTally``).
# ---------------------------------------------------------------------------
_DMA: Dict[str, int] = {"copies": 0, "bytes": 0, "waits": 0}
_DMA_PENDING: list = []
_DMA_FOLD_AT = 1024


def record_dma(copies, nbytes, waits=None):
    """Record the async copies one launch starts (``waits`` defaults to
    ``copies``). Each value is an int or a 0-dim integer tensor."""
    entry = (copies, nbytes, copies if waits is None else waits)
    cap = getattr(_CAPTURE, "t", None)
    if cap is not None:
        cap.dma.append(entry)
        return
    with _COUNTS_LOCK:
        _DMA_PENDING.append(entry)
        if len(_DMA_PENDING) >= _DMA_FOLD_AT:
            _fold_dma()


def _fold_dma():
    rows = [e for e in _DMA_PENDING if not torch.is_tensor(e)]
    vecs: dict = {}
    for e in _DMA_PENDING:
        if torch.is_tensor(e):
            vecs.setdefault(e.device, []).append(e)
    for lazy in vecs.values():                        # one sync per device
        for key, n in zip(_DMA, torch.stack(lazy).sum(0).tolist()):
            _DMA[key] += int(n)
    for i, key in enumerate(_DMA):
        vals = [entry[i] for entry in rows]
        total = sum(int(v) for v in vals if not torch.is_tensor(v))
        by_device: dict = {}
        for v in vals:
            if torch.is_tensor(v):
                by_device.setdefault(v.device, []).append(v.reshape(()).long())
        for lazy in by_device.values():
            total += int(torch.stack(lazy).sum())    # one sync per device
        _DMA[key] += total
    _DMA_PENDING.clear()


def dma_ledger() -> Dict[str, int]:
    """Process-wide {copies, bytes, waits} since the last
    :func:`reset_launches` (reading it synchronises with the device)."""
    with _COUNTS_LOCK:
        _fold_dma()
        return dict(_DMA)


def _reference_int8_matmul(x, w_q, w_scale):
    """Plain version of K3: ``x.float() @ (w_q * w_scale).T`` in f32 (a
    bf16 x widened first, as the JAX package's fallback does)."""
    wf = w_q.float() * w_scale[:, None]
    return x.float() @ wf.T


def dequantize_int4_table(w_p, w_scale):
    """The (N, K) f32 weight a packed int4 table stands for, through the
    codec (``unpack_codes``, ``dequantize_blocks``). The JAX package runs
    this outside any kernel, both as K4's off-TPU fallback and in the int4
    layers' product of more than ``gemv_max_m()`` rows."""
    from ..kvstore.quant import dequantize_blocks, unpack_codes
    N, K2 = w_p.shape
    K = 2 * K2
    wf = dequantize_blocks(unpack_codes(w_p.reshape(-1), 4),
                           w_scale.reshape(-1), K // w_scale.shape[1])
    return wf.reshape(N, K)


def _reference_int4_matmul(x, w_p, w_scale):
    """Plain version of K4: the dequantized table, then ``x.float() @
    wf.T`` in f32."""
    return x.float() @ dequantize_int4_table(w_p, w_scale).T


def _deq_matmul(x, w_q, w_scale):
    """The plain GEMV of either weight lane, chosen by the table's dtype:
    uint8 is the packed int4 lane, int8 the int8 lane."""
    if w_q.dtype == torch.uint8:
        return _reference_int4_matmul(x, w_q, w_scale)
    return _reference_int8_matmul(x, w_q, w_scale)


def _check_gemv(x, w_q, w_scale):
    if x.dim() != 2 or w_q.dim() != 2 or w_scale.dim() != 1:
        raise MXNetError("int8_weight_matmul: x (M, K), w_q (N, K), w_scale (N,)")
    M, K = x.shape
    N = w_q.shape[0]
    if w_q.shape[1] != K or w_scale.shape[0] != N:
        raise MXNetError(f"int8_weight_matmul: shapes {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}, {tuple(w_scale.shape)} disagree")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise MXNetError("int8_weight_matmul: w_q must be int8, w_scale f32")
    if not (x.device == w_q.device == w_scale.device):
        raise MXNetError("int8_weight_matmul: operands on different devices")
    return M, N, K


def int8_weight_matmul(x, w_q, w_scale):
    """x: (M, K) f32 or bf16; w_q: (N, K) int8; w_scale: (N,) f32
    per-out-channel. Returns (M, N) f32 = x @ (w_q * w_scale).T, through
    the registered operator ``mxnet_tpu_torch::int8_gemv``."""
    _check_gemv(x, w_q, w_scale)
    return torch.ops.mxnet_tpu_torch.int8_gemv(x, w_q, w_scale)


def _int8_gemv_impl(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """The body of K3's operator: a CPU tensor takes
    :func:`_reference_int8_matmul`, a CUDA tensor launches
    ``csrc/int8_gemv.cu`` on the route of its row count or raises."""
    M, N, K = _check_gemv(x, w_q, w_scale)
    if x.device.type == "cpu":
        record_launch("gemv")
        return _reference_int8_matmul(x, w_q, w_scale)
    return _cuda_int8_matmul(x, w_q, w_scale, M, N, K)


# K3 and K4 as operators ``torch.export`` records by name (defined as K1's
# is, ``ops/attention.py``)
_LIB = torch.library.Library("mxnet_tpu_torch", "FRAGMENT")
_LIB.define("int8_gemv(Tensor x, Tensor w_q, Tensor w_scale) -> Tensor")
_LIB.define("int4_gemv(Tensor x, Tensor w_p, Tensor w_scale) -> Tensor")


@torch.library.register_fake("mxnet_tpu_torch::int8_gemv")
def _int8_gemv_fake(x, w_q, w_scale):
    return x.new_empty(x.shape[0], w_q.shape[0], dtype=torch.float32)


def _kernel_x(x, what):
    """x as the kernels take it: contiguous f32 or bf16 rows on a 16-byte
    boundary (their loads move 16 bytes), and the kernels' x_bf16 flag."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"{what}: the kernel takes f32 or bf16 activations "
                         f"(got {x.dtype})")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, int(x.dtype == torch.bfloat16)


def _cuda_int8_matmul(x, w_q, w_scale, M, N, K):
    from .. import _build
    if K % 16 or M < 1:
        raise MXNetError(f"int8_weight_matmul: the kernel needs K % 16 == 0 "
                         f"and M >= 1 (got M={M}, K={K})")
    x, xbf16 = _kernel_x(x, "int8_weight_matmul")
    w_q = w_q.contiguous()
    w_scale = w_scale.contiguous()
    _check_aligned((w_q,), "int8_weight_matmul")
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    lib = _build.library("int8_gemv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    route = gemv_route(M)
    if route == "mma":
        _check_tile(w_q, K, K, "int8_weight_matmul")
        rc = lib.mx_int8_gemv_mma(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                                  y.data_ptr(), M, N, K, xbf16, stream)
    else:
        rc = lib.mx_int8_gemv(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                              y.data_ptr(), M, N, K, xbf16, stream)
    _build.check(rc, "int8_gemv")
    _record_gemv("gemv", route, "bf16" if xbf16 else "f32", N)
    return y


def _check_aligned(tables, what):
    """Raise unless every weight table (int4: and its block scales) starts
    on a 16-byte boundary: both routes copy them in 16-byte units. No
    fallback to the plain version."""
    if any(t.data_ptr() % 16 for t in tables):
        raise MXNetError(f"{what}: the kernel needs its weight tables on a "
                         "16-byte boundary")


def _check_tile(w, K, block, what):
    """Raise on operands the tile route cannot take: K, and an int4
    table's block, whole k-tiles of ``GEMV_TILE_K`` codes. No fallback to
    the warp route or the plain version."""
    if K % GEMV_TILE_K or block % GEMV_TILE_K:
        raise MXNetError(f"{what}: the tile route (9-{gemv_max_m()} rows) needs K and "
                         f"the int4 block to be multiples of {GEMV_TILE_K} (got K={K}, "
                         f"block={block})")


def _check_int4(x, w_p, w_scale, what):
    """(M, N, K, block) of an int4 GEMV's operands, or raise: ``x`` (M, K),
    ``w_p`` (N, K/2) uint8, ``w_scale`` (N, K/block) f32."""
    if x.dim() != 2 or w_p.dim() != 2 or w_scale.dim() != 2:
        raise MXNetError(f"{what}: x (M, K), w_p (N, K/2), w_scale (N, K/block)")
    M, K = x.shape
    N, K2 = w_p.shape
    nsb = w_scale.shape[1]
    if K != 2 * K2 or w_scale.shape[0] != N or nsb < 1 or K % nsb:
        raise MXNetError(f"{what}: shapes {tuple(x.shape)}, {tuple(w_p.shape)}, "
                         f"{tuple(w_scale.shape)} disagree")
    if w_p.dtype != torch.uint8 or w_scale.dtype != torch.float32:
        raise MXNetError(f"{what}: w_p must be uint8 nibble pairs, w_scale f32")
    if not (x.device == w_p.device == w_scale.device):
        raise MXNetError(f"{what}: operands on different devices")
    return M, N, K, K // nsb


def weight_matmul(x, w_q, w_scale):
    """The GEMV of either weight lane, chosen by the table's dtype: a
    uint8 table goes through :func:`int4_weight_matmul` (K4), an int8 one
    through :func:`int8_weight_matmul` (K3)."""
    if w_q.dtype == torch.uint8:
        return int4_weight_matmul(x, w_q, w_scale)
    return int8_weight_matmul(x, w_q, w_scale)


def int4_chunks_fit(K: int, block: int) -> bool:
    """The int4 lane's tiling rule on the card: a lane reads 16 codes (8
    bytes) of a row at a time, so K % 16 == 0, and those 16 codes must lie
    in one scale block, so block % 16 == 0."""
    return K % 16 == 0 and block % 16 == 0 and K % block == 0


def int4_weight_matmul(x, w_p, w_scale):
    """int4 weight-only GEMV: ``x`` (M, K) f32 or bf16; ``w_p`` (N, K/2) uint8,
    two offset-binary nibbles per byte (the ``kvstore.quant.pack_codes``
    layout); ``w_scale`` (N, K/block) f32 block scales. Returns (M, N) f32
    = ``x @ dequant(w).T``."""
    _check_int4(x, w_p, w_scale, "int4_weight_matmul")
    return torch.ops.mxnet_tpu_torch.int4_gemv(x, w_p, w_scale)


def _int4_gemv_impl(x: torch.Tensor, w_p: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """The body of K4's operator: a CPU tensor takes
    :func:`_reference_int4_matmul`, a CUDA tensor launches
    ``csrc/int4_gemv.cu`` or raises."""
    M, N, K, block = _check_int4(x, w_p, w_scale, "int4_weight_matmul")
    if x.device.type == "cpu":
        record_launch("gemv_int4")
        return _reference_int4_matmul(x, w_p, w_scale)
    return _cuda_int4_matmul(x, w_p, w_scale, M, N, K, block)


@torch.library.register_fake("mxnet_tpu_torch::int4_gemv")
def _int4_gemv_fake(x, w_p, w_scale):
    return x.new_empty(x.shape[0], w_p.shape[0], dtype=torch.float32)


for _key in ("CPU", "CUDA"):
    _LIB.impl("int8_gemv", _int8_gemv_impl, _key)
    _LIB.impl("int4_gemv", _int4_gemv_impl, _key)


def _cuda_int4_matmul(x, w_p, w_scale, M, N, K, block):
    from .. import _build
    if not int4_chunks_fit(K, block) or M < 1:
        raise MXNetError(f"int4_weight_matmul: the kernel needs K % 16 == 0, "
                         f"block % 16 == 0 and M >= 1 (got M={M}, K={K}, "
                         f"block={block})")
    x, xbf16 = _kernel_x(x, "int4_weight_matmul")
    w_p = w_p.contiguous()
    w_scale = w_scale.contiguous()
    _check_aligned((w_p, w_scale), "int4_weight_matmul")
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    lib = _build.library("int4_gemv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    route = gemv_route(M)
    if route == "mma":
        _check_tile(w_p, K, block, "int4_weight_matmul")
        rc = lib.mx_int4_gemv_mma(x.data_ptr(), w_p.data_ptr(), w_scale.data_ptr(),
                                  y.data_ptr(), M, N, K, block, xbf16, stream)
    else:
        rc = lib.mx_int4_gemv(x.data_ptr(), w_p.data_ptr(), w_scale.data_ptr(),
                              y.data_ptr(), M, N, K, block, xbf16, stream)
    _build.check(rc, "int4_gemv")
    _record_gemv("gemv_int4", route, "bf16" if xbf16 else "f32", N)
    return y
