"""Port parity of the metrics registry: ``mxnet_tpu_torch.metrics`` against
``mxnet_tpu.metrics``. The serving families keep the JAX package's names,
help strings, labels and buckets, and for the same sequence of calls
``expose()`` and ``dumps()`` give the same text byte for byte."""
import json

import pytest

from mxnet_tpu import metrics as jm
from mxnet_tpu_torch import metrics as tm


def _families(mod):
    return [v for v in vars(mod).values() if isinstance(v, mod._MetricFamily)
            and mod.REGISTRY.get(v.name) is v]


@pytest.fixture
def enabled():
    """Both registries collecting for the test, restored after."""
    was = (jm.enabled(), tm.enabled())
    jm.enable()
    tm.enable()
    yield
    for mod, on in zip((jm, tm), was):
        (mod.enable if on else mod.disable)()


def test_families_match_jax():
    """Every family of the port is the JAX family of the same name: type,
    help, label names and buckets, registered in the same order."""
    ours = _families(tm)
    assert len(ours) == 50
    jax_order = [f.name for f in jm.REGISTRY.families()]
    for f in ours:
        ref = jm.REGISTRY.get(f.name)
        assert ref is not None, f.name
        assert (f.typ, f.help, f.labelnames) == (ref.typ, ref.help, ref.labelnames), f.name
        assert getattr(f, "buckets", None) == getattr(ref, "buckets", None), f.name
    idx = [jax_order.index(f.name) for f in tm.REGISTRY.families()]
    assert idx == sorted(idx)


def _drive(mod, defs):
    """Register ``defs`` (the port's families' definitions) in a fresh
    registry of ``mod`` and apply one fixed sequence of updates."""
    reg = mod.MetricsRegistry()
    fams = {}
    for kind, name, help_, labels, buckets in defs:
        cls = getattr(mod, kind)
        kw = {"buckets": buckets} if buckets is not None else {}
        fams[name] = cls(name, help_, labels, registry=reg, **kw)
    for i, (name, f) in enumerate(fams.items()):
        child = (f.labels(**{k: f'v{i % 3}"\\\n' if j == 0 else "x"
                             for j, k in enumerate(f.labelnames)})
                 if f.labelnames else f)
        if f.typ == "counter":
            child.inc(i + 0.5)
            child.inc()
        elif f.typ == "gauge":
            child.set(float("nan") if i % 7 == 0 else -i / 3)
            child.inc(2)
        else:
            for v in (0.0001, 0.003, 0.7 * i, 1e9, float("inf")):
                child.observe(v)
    return reg


@pytest.mark.parametrize("fmt", ["prometheus", "json", "table"])
def test_exposition_bytes_match_jax(enabled, fmt):
    """The same calls on the same families give the same text."""
    defs = [(type(f).__name__, f.name, f.help, f.labelnames, getattr(f, "buckets", None))
            for f in _families(tm)]
    rj, rt = _drive(jm, defs), _drive(tm, defs)
    if fmt == "prometheus":
        assert rt.expose() == rj.expose()
    else:
        assert rt.dumps(fmt) == rj.dumps(fmt)
    if fmt == "json":
        doc = json.loads(rt.dumps("json"))
        assert set(doc) == {d[1] for d in defs}


def test_module_functions_match_jax(enabled):
    """``expose``/``dumps``/``get_sample_value`` through the module-level
    functions on a serving family, after the same updates."""
    for mod in (jm, tm):
        mod.SERVE_REQUESTS.labels(status="ok").inc(3)
        mod.SERVE_TTFT.observe(0.02)
    for mod_name in ("mxnet_serve_requests_total", "mxnet_serve_ttft_seconds_count",
                     "mxnet_serve_ttft_seconds_sum"):
        assert tm.get_sample_value(mod_name) is not None
    assert "# TYPE mxnet_serve_ttft_seconds histogram" in tm.expose()
    assert json.loads(tm.dumps("json"))["mxnet_serve_requests_total"]["type"] == "counter"


def test_noop_path():
    """Disabled collection: ``labels()`` hands out the shared no-op child,
    updates record nothing, the text shows the untouched values."""
    was = tm.enabled()
    tm.disable()
    try:
        reg = tm.MetricsRegistry()
        c = tm.Counter("t_c", "c", ("k",), registry=reg)
        g = tm.Gauge("t_g", "g", registry=reg)
        h = tm.Histogram("t_h", "h", registry=reg)
        assert c.labels(k="a") is tm._NOOP
        c.labels(k="a").inc(5)
        g.set(3)
        h.observe(1.0)
        assert c.children() == []
        assert reg.get_sample_value("t_g") == 0.0
        assert reg.get_sample_value("t_h_count") == 0.0
        assert "t_g 0" in reg.expose()
    finally:
        (tm.enable if was else tm.disable)()


def test_get_sample_value(enabled):
    """Sums over children or filters by labels; ``_count``/``_sum`` read a
    histogram; an unknown name or unmatched labels give None, as in JAX."""
    out = []
    for mod in (jm, tm):
        reg = mod.MetricsRegistry()
        c = mod.Counter("t_c", "c", ("a", "b"), registry=reg)
        c.labels(a="1", b="x").inc(2)
        c.labels(a="2", b="x").inc(5)
        h = mod.Histogram("t_h", "h", ("p",), registry=reg, buckets=(0.1, 1.0))
        h.labels(p="q").observe(0.5)
        h.labels(p="r").observe(2.5)
        out.append([reg.get_sample_value("t_c"), reg.get_sample_value("t_c", {"a": "2"}),
                    reg.get_sample_value("t_c", {"a": "3"}), reg.get_sample_value("nope"),
                    reg.get_sample_value("t_h_count"),
                    reg.get_sample_value("t_h_sum", {"p": "r"})])
    assert out[1] == out[0] == [7.0, 5.0, None, None, 2.0, 2.5]


def test_reregistration_returns_live_family():
    """A family constructed again under its name is the registered one; a
    different type or label set raises, as in JAX."""
    reg = tm.MetricsRegistry()
    a = tm.Counter("t_x", "x", ("k",), registry=reg)
    assert tm.Counter("t_x", "x", ("k",), registry=reg) is a
    with pytest.raises(tm.MXNetError):
        tm.Gauge("t_x", "x", ("k",), registry=reg)
    h = tm.Histogram("t_y", "y", registry=reg, buckets=(1.0,))
    with pytest.raises(tm.MXNetError):
        tm.Histogram("t_y", "y", registry=reg, buckets=(2.0,))
    assert h.buckets == (1.0,)


def test_generate_recompilations_match_jax(enabled):
    """``generate()`` counts ``mxnet_recompilations_total{block="generate"}``
    where the JAX package compiles a decode loop: a model's first key
    ``initial``, a new key of the same model ``retrace``, a repeated key
    nothing, another model ``initial`` again."""
    import numpy as onp
    import mxnet_tpu as mx
    from mxnet_tpu import np as mnp
    from mxnet_tpu.models import GPTModel as JaxGPT
    from mxnet_tpu.models import generate as jax_generate
    from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
    cfg = dict(vocab_size=32, hidden_size=32, num_layers=1, num_heads=2,
               max_position_embeddings=32, dropout=0.0)

    def counts(mod):
        return [mod.get_sample_value("mxnet_recompilations_total",
                                     {"block": "generate", "kind": k}) or 0
                for k in ("initial", "retrace")]

    calls = [(0, 3, 4, 0.0), (0, 3, 4, 0.0), (0, 4, 4, 0.0), (0, 3, 4, 0.7), (1, 3, 4, 0.0)]
    deltas = []
    for pkg in ("jax", "port"):
        mx.random.seed(0)
        if pkg == "jax":
            nets = [JaxGPT(JaxGPTConfig(**cfg)) for _ in range(2)]
            for n in nets:
                n.initialize()
            run = lambda n, ids, new, t: jax_generate(n, mnp.array(ids), new, temperature=t)
            mod = jm
        else:
            nets = [GPTModel(GPTConfig(**cfg), device="cpu").init_weights(i) for i in range(2)]
            run = lambda n, ids, new, t: generate(n, ids, new, temperature=t)
            mod = tm
        before = counts(mod)
        for i, P, new, t in calls:
            run(nets[i], onp.ones((1, P), "int32"), new, t)
        deltas.append([a - b for a, b in zip(counts(mod), before)])
    assert deltas[1] == deltas[0] == [2, 2]
