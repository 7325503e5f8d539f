"""Port parity of ``mxnet_tpu_torch.pipeline`` on the CPU: the
``DevicePrefetcher`` contract of ``mxnet_tpu.pipeline`` (order, structure,
single pass, close and context manager, a producer's error raised after
the batches staged before it, the depth check, an abandoned prefetcher's
thread exiting, the telemetry path label, the debug-guard ``ValueError``
on a producer that reuses a buffer it handed over), ``stage_batch``'s
per-leaf placement, ``TrainStep.input_shardings()``, a ``TrainStep`` fed
through the prefetcher bit for bit equal to the direct loop (the JAX
package's ``tests/test_async_pipeline.py`` parity) and within 1e-5 of the
JAX package's losses from the same weights, and the five input-path metric
families observed as often as the JAX package observes them.

Tolerance: batches and the port's two loops bit for bit; port losses
against JAX's within 1e-5 relative (XLA's and torch's f32 matmuls sum in
other orders); metric sample counts equal."""
import gc
import threading
import time
import weakref

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import metrics as jmetrics
from mxnet_tpu import np as jnp_
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.data import ArrayDataset as JArrayDataset
from mxnet_tpu.gluon.data import DataLoader as JDataLoader
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metrics, np, parallel
from mxnet_tpu_torch.analysis import guards
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.pipeline import DevicePrefetcher, stage_batch


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


@pytest.fixture
def fresh_metrics():
    """Both registries reset and collecting for the test, restored after."""
    was = (jmetrics.enabled(), metrics.enabled())
    for m in (jmetrics, metrics):
        m.reset()
        m.enable()
    yield
    for m, on in zip((jmetrics, metrics), was):
        m.reset()
        (m.enable if on else m.disable)()


def _data(n=4, batch=4, din=4, dout=2, seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.rand(n * batch, din).astype("float32"),
            rng.rand(n * batch, dout).astype("float32"))


def _loader(n=4, batch=4, **kw):
    X, Y = _data(n, batch)
    return DataLoader(ArrayDataset(X, Y), batch_size=batch, **kw), X, Y


# ----------------------------------------------------------- prefetcher
def test_prefetcher_order_structure_and_placement():
    loader, X, Y = _loader(n=4)
    batches = list(loader.as_device_iterator(depth=2))
    assert len(batches) == 4
    for i, (x, y) in enumerate(batches):
        assert isinstance(x, mx.NDArray) and isinstance(y, mx.NDArray)
        assert x._data.device.type == "cpu"
        onp.testing.assert_array_equal(x.asnumpy(), X[4 * i:4 * (i + 1)])
        onp.testing.assert_array_equal(y.asnumpy(), Y[4 * i:4 * (i + 1)])


def test_prefetcher_is_single_pass_and_closable():
    loader, _, _ = _loader(n=3)
    it = loader.as_device_iterator()
    assert next(iter(it)) is not None
    it.close()
    assert list(it) == []
    with loader.as_device_iterator() as it2:
        assert len(list(it2)) == 3
    assert it2.stream is None          # no CUDA stream on the CPU


def test_prefetcher_propagates_producer_error():
    def bad_source():
        yield onp.zeros((2, 2), onp.float32)
        yield onp.ones((2, 2), onp.float32)
        raise RuntimeError("boom in producer")

    it = DevicePrefetcher(bad_source(), depth=2)
    assert float(next(it).sum()) == 0.0
    assert float(next(it).sum()) == 4.0        # staged before the error
    with pytest.raises(RuntimeError, match="boom in producer"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetcher_depth_validation():
    with pytest.raises(MXNetError, match="depth"):
        DevicePrefetcher([], depth=0)


def test_abandoned_prefetcher_thread_exits():
    """The worker holds no reference to the prefetcher: an iterator
    abandoned mid-epoch is collected and its thread stops."""
    loader, _, _ = _loader(n=50)
    it = iter(loader.as_device_iterator(depth=2))
    next(it)
    thread = it._thread
    ref = weakref.ref(it)
    del it
    gc.collect()
    assert ref() is None
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_stage_batch_per_leaf_placement():
    x = onp.zeros((8, 4), onp.float32)
    y = onp.zeros((8,), onp.int32)
    sx, sy = stage_batch((x, y), (mx.cpu(), "cpu"))
    assert sx.device == torch.device("cpu") and sy.dtype == torch.int32
    x[0, 0] = 1.0                             # the staged copy is the producer's no more
    assert float(sx[0, 0]) == 0.0
    sx2, sy2 = stage_batch((sx, sy), (torch.device("cpu"), None))
    assert sx2 is sx and sy2 is sy            # already placed: no new tensor
    nd = mx.NDArray(x)
    (snd,) = stage_batch([nd], None)
    assert isinstance(snd, mx.NDArray) and snd._data is nd._data
    with pytest.raises(MXNetError, match="does not match"):
        stage_batch((x, y), (None,))
    with pytest.raises(MXNetError, match="Queue 1 item 8"):
        stage_batch(x, object())              # a mesh / sharding object
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            stage_batch(x, "cuda")            # no silent CPU path


def test_dataloader_device_prefetch_ctor_arg():
    loader, _, _ = _loader(n=2, device_prefetch=2)
    batches = list(loader)
    assert len(batches) == 2 and isinstance(batches[0][0], mx.NDArray)
    assert len(list(loader)) == 2             # a fresh prefetcher every __iter__


def test_debug_guard_catches_reused_buffer():
    """Under debug guards a producer that writes into a buffer it handed
    over raises ValueError at the write, surfaced at the consumer; a
    producer of fresh buffers runs through, and close() hands the sealed
    buffers back writable."""
    guards.enable_debug()
    try:
        buf = onp.zeros((4, 4), onp.float32)

        def reusing():
            for i in range(6):
                buf[...] = i                   # reuses the handed-over buffer
                yield buf

        it = DevicePrefetcher(reusing(), depth=2)
        assert float(next(it).sum()) == 0.0
        with pytest.raises(ValueError, match="read-only"):
            for _ in range(6):
                next(it)
        it.close()
        assert buf.flags.writeable

        fresh = [onp.full((2, 2), i, onp.float32) for i in range(8)]
        with DevicePrefetcher(iter(fresh), depth=2) as it2:
            got = [float(b[0, 0]) for b in it2]
        assert got == list(range(8))
        assert all(a.flags.writeable for a in fresh)
    finally:
        guards.disable_debug()


def test_guard_off_leaves_buffers_writable():
    buf = onp.zeros((2, 2), onp.float32)
    it = DevicePrefetcher(iter([buf, buf]), depth=2)
    next(it)
    assert buf.flags.writeable
    it.close()


def test_prefetcher_path_label(fresh_metrics):
    X, _ = _data(n=2)
    list(DataLoader(ArrayDataset(X), batch_size=4, device_prefetch=2,
                    device_prefetch_path="eval"))
    # 2 batches and the end read each observe a wait
    assert metrics.get_sample_value("mxnet_input_wait_seconds_count", {"path": "eval"}) >= 2
    assert not metrics.get_sample_value("mxnet_input_wait_seconds_count", {"path": "train"})


@pytest.mark.parametrize("kw", [dict(), dict(num_workers=2), dict(num_workers=2, thread_pool=False)],
                         ids=["inline", "threads", "processes"])
def test_input_path_metric_families_match_jax(fresh_metrics, kw):
    """The five families, observed where the JAX package observes them:
    the same sample counts for the same loader and prefetcher."""
    X, Y = _data(n=5)
    counts = []
    for m, DL, AD in ((metrics, DataLoader, ArrayDataset), (jmetrics, JDataLoader, JArrayDataset)):
        if m is jmetrics and kw.get("thread_pool") is False:
            kw_j = dict(kw)      # the JAX loader's process path forks a JAX process:
            kw_j["thread_pool"] = True    # its threads observe the same families
        else:
            kw_j = kw
        loader = DL(AD(X, Y), batch_size=4, **kw_j)
        list(loader)
        list(loader.as_device_iterator(depth=2, path="train"))
        counts.append((
            m.get_sample_value("mxnet_dataloader_batches_total"),
            m.get_sample_value("mxnet_dataloader_batch_seconds_count"),
            m.get_sample_value("mxnet_dataloader_wait_seconds_count") or 0,
            m.get_sample_value("mxnet_input_wait_seconds_count", {"path": "train"}),
            m.get_sample_value("mxnet_pipeline_depth", {"path": "prefetch_train"}) is not None))
    assert counts[0] == counts[1], counts
    assert counts[0][0] == 10 and counts[0][4]
    assert counts[0][2] == (0 if not kw else 10)


# ------------------------------------------------- pipelined train loop
def _mlp(nnm, mxm, din=4, dout=2, seed=7):
    mxm.random.seed(seed)
    net = nnm.HybridSequential()
    net.add(nnm.Dense(8, in_units=din), nnm.Dense(dout))
    net.initialize()
    return net


def _run_loop(pipelined, steps=6, block_every=2):
    rng = onp.random.RandomState(1)
    X = rng.rand(steps * 8, 4).astype("float32")
    Y = rng.randint(0, 2, steps * 8).astype("int32")
    net = _mlp(nn, mx)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              mx.optimizer.Adam(learning_rate=0.01),
                              example_inputs=[np.array(X[:8])],
                              block_every=block_every if pipelined else None)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=8)
    losses = []
    if pipelined:
        for x, y in loader.as_device_iterator(sharding=step.input_shardings(), depth=2):
            losses.append(step.step(x, y))
            assert len(step._inflight) <= block_every
        step.drain()
        assert not step._inflight
    else:
        for x, y in loader:
            losses.append(step(x, y))
    return ([loss.numpy() for loss in losses],
            [p.detach().numpy().copy() for _, p in step._params])


def test_input_shardings_is_the_step_device():
    net = _mlp(nn, mx)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                              example_inputs=[np.ones((2, 4))])
    assert step.input_shardings() == (torch.device("cpu"), torch.device("cpu"))


def test_pipelined_trainstep_bitwise_parity():
    """Prefetch + in-flight window against the direct loop: losses and
    parameters bit for bit; losses within 1e-5 of the JAX package's
    direct loop from the same initial weights."""
    sync_l, sync_p = _run_loop(False)
    pipe_l, pipe_p = _run_loop(True)
    for a, b in zip(sync_l, pipe_l):
        onp.testing.assert_array_equal(a, b)
    for a, b in zip(sync_p, pipe_p):
        onp.testing.assert_array_equal(a, b)

    rng = onp.random.RandomState(1)
    X = rng.rand(48, 4).astype("float32")
    Y = rng.randint(0, 2, 48).astype("int32")
    jnet = _mlp(jnn, jmx)
    jstep = jparallel.TrainStep(jnet, JSCE(), jmx.optimizer.Adam(learning_rate=0.01),
                                example_inputs=[jnp_.array(X[:8])])
    jl = [jstep(x, y).asnumpy() for x, y in
          JDataLoader(JArrayDataset(jnp_.array(X), jnp_.array(Y)), batch_size=8)]
    onp.testing.assert_allclose(onp.array(sync_l), onp.array(jl), rtol=1e-5)


def test_input_bound_overlap():
    """Producer and consumer both sleep d a batch: the prefetcher overlaps
    them (ideal 2x over serial), held at 1.3x."""
    N, d = 8, 0.02
    item = onp.zeros((4, 4), onp.float32)

    def producer():
        for _ in range(N):
            time.sleep(d)
            yield item

    t0 = time.perf_counter()
    for _ in producer():
        time.sleep(d)
    serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in DevicePrefetcher(producer(), depth=2):
        time.sleep(d)
    overlapped = time.perf_counter() - t0
    assert serial / overlapped > 1.3, (serial, overlapped)
    assert threading.active_count() < 50
