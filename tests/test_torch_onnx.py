"""ONNX parity on the CPU: the port's ``onnx`` against the JAX package's.

- The layer-tree exporter writes byte-identical files to the JAX
  package's for the same layer tree and weights (MLP with dropout, CNN
  with BatchNorm and pooling and a symbolic batch, conv attributes,
  embedding).
- Traced files (the port's: ``torch.export`` decomposed to ATen; the JAX
  package's: a jaxpr) run in both importers: each file in both packages'
  ``import_model`` within 1e-5 of the live model's output scale
  (``BERT_TINY``'s encoder, ResNet-18 at 32 x 32 with 10 classes, a
  dynamic batch, the custom-forward fallback, a grouped ConvTranspose,
  gather patterns, fmod / isfinite semantics, and ViT at T 257 through
  K1's converter, port only: the JAX package takes no kernel there).

Both packages' models take the same numpy-drawn weights (``seeded``,
through ``interop.params_from_numpy`` on the port's side). The dynamic batch runs at a batch
size other than the export's.
"""
import dataclasses

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_
from mxnet_tpu import npx as jnpx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.model_zoo import get_model as jget_model
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.ndarray import apply as japply
from mxnet_tpu.onnx import _proto as JP
from mxnet_tpu.onnx import export_model as jexport
from mxnet_tpu.onnx import import_model as jimport

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import interop, np, npx
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import HybridBlock
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.models import BERT_TINY, VIT_TINY, BertModel, ViTModel
from mxnet_tpu_torch.ndarray import apply
from mxnet_tpu_torch.onnx import _import as TI
from mxnet_tpu_torch.onnx import export_model, import_model

TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    torch.set_num_threads(1)
    with mx.cpu():
        yield


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1.0))


def seeded(jnet, tnet, xs):
    """Zero-initialize the JAX net, settle its shapes with one hybridized
    forward, then give both packages the same weights drawn with numpy
    (random initializers cost the JAX package a compile per shape on the
    CPU): N(0, 0.1^2) everywhere, BatchNorm's gamma and variance in
    [0.5, 1.5)."""
    jnet.initialize(jmx.init.Zero())
    jnet.hybridize()
    jnet(*[jnp_.array(x) for x in xs])
    rng = onp.random.RandomState(1)
    named = {}
    for k, p in jnet.collect_params().items():
        shape = p.data().shape
        if k.endswith(("gamma", "running_var")):
            named[k] = rng.uniform(0.5, 1.5, shape).astype("float32")
        else:
            named[k] = (rng.randn(*shape) * 0.1).astype(p.data().asnumpy().dtype)
    jnet.load_dict(named)
    tnet.initialize()
    interop.params_from_numpy(tnet, named)
    return tnet


# ----------------------------------------------------------- layer tree
def _mlp(m):
    net = m.HybridSequential()
    net.add(m.Dense(16, activation="relu"), m.Dropout(0.5), m.Dense(4))
    return net


def _cnn(m):
    net = m.HybridSequential()
    net.add(m.Conv2D(8, 3, padding=1, in_channels=3), m.BatchNorm(in_channels=8),
            m.Activation("relu"), m.MaxPool2D(2), m.GlobalAvgPool2D(), m.Flatten(), m.Dense(10))
    return net


def _conv(m):
    net = m.HybridSequential()
    net.add(m.Conv2D(4, 3, strides=2, padding=1, in_channels=2))
    return net


def _embed(m):
    net = m.HybridSequential()
    net.add(m.Embedding(20, 6))
    return net


def _cnn_roundtrip(m):
    net = m.HybridSequential()
    net.add(m.Conv2D(4, 3, padding=1, activation="relu"), m.BatchNorm(), m.MaxPool2D(2, 2),
            m.Flatten(), m.Dense(5))
    return net


LAYER_TREE = {
    "mlp": (_mlp, (2, 8), "float32", {}),
    "cnn_bn_pool": (_cnn, (1, 3, 8, 8), "float32", dict(dynamic_batch=True)),
    "conv_attrs": (_conv, (1, 2, 8, 8), "float32", {}),
    "embedding": (_embed, (2, 5), "int32", {}),
    "cnn_roundtrip": (_cnn_roundtrip, (2, 3, 8, 8), "float32", {}),
}


@pytest.mark.parametrize("name", sorted(LAYER_TREE))
def test_layer_tree_bytes_equal_jax(name, tmp_path):
    """Same layer tree, same weights: the same bytes; the file runs in both
    importers to the live output."""
    build, shape, dtype, kw = LAYER_TREE[name]
    rng = onp.random.RandomState(0)
    x = (rng.randint(0, 20, shape) if dtype == "int32" else rng.rand(*shape)).astype(dtype)
    jnet = build(jnn)
    tnet = seeded(jnet, build(nn), [x])
    jpath = jexport(jnet, str(tmp_path / "j.onnx"), input_shapes=[shape], input_types=dtype,
                    **kw)
    tpath = export_model(tnet, str(tmp_path / "t.onnx"), input_shapes=[shape],
                         input_types=dtype, **kw)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert g.read() == f.read()
    live = tnet(np.array(x)).asnumpy()
    assert scaled_err(import_model(tpath)(np.array(x)).asnumpy(), live) <= TOL
    assert scaled_err(jimport(tpath)(jnp_.array(x)).asnumpy(), live) <= TOL


# --------------------------------------------------------------- traced
class _Custom:
    """A custom forward that no layer converter takes (the fallback)."""

    @staticmethod
    def build(m, npx_mod, base):
        class Custom(base):
            def __init__(self):
                super().__init__()
                self.proj = m.Dense(3, in_units=4)

            def forward(self, x):
                return npx_mod.softmax(self.proj(x * 2.0), axis=-1) + x.mean()
        return Custom()


class _Dynamic:
    @staticmethod
    def build(m, npx_mod, base):
        class Dyn(base):
            def __init__(self):
                super().__init__()
                self.d = m.Dense(6, in_units=12)

            def forward(self, x):
                return npx_mod.softmax(self.d(x.reshape(x.shape[0], -1)), axis=-1)
        return Dyn()


def _rem_finite(jax_side):
    if jax_side:
        class RemFinite(JHybridBlock):
            def forward(self, x, y):
                return japply(lambda a, b: jax.lax.rem(a, b)
                              + jnp.where(jnp.isfinite(a), 1.0, 0.0), x, y)
        return RemFinite()

    class RemFiniteT(HybridBlock):
        def forward(self, x, y):
            return apply(lambda a, b: torch.fmod(a, b)
                         + torch.where(torch.isfinite(a), 1.0, 0.0), x, y)
    return RemFiniteT()


def _gathers(jax_side):
    if jax_side:
        class G(JHybridBlock):
            def forward(self, x, ij, ta):
                return japply(lambda xv, ijv, tav: xv[ijv[:, 0], ijv[:, 1]].sum()
                              + jnp.take_along_axis(xv, tav, axis=1), x, ij, ta)
        return G()

    class GT(HybridBlock):
        def forward(self, x, ij, ta):
            return apply(lambda xv, ijv, tav: xv[ijv[:, 0].long(), ijv[:, 1].long()].sum()
                         + torch.gather(xv, 1, tav.long()), x, ij, ta)
    return GT()


def _bert(jax_side):
    cfg = {f.name: getattr(BERT_TINY, f.name) for f in dataclasses.fields(BERT_TINY)}
    return jbert.BertModel(jbert.BertConfig(**cfg)) if jax_side else BertModel(BERT_TINY)


def _resnet(jax_side):
    return (jget_model if jax_side else get_model)("resnet18_v1", classes=10)


def _convt(jax_side):
    m = jnn if jax_side else nn
    return m.Conv2DTranspose(6, 3, strides=2, padding=1, output_padding=1, groups=2,
                             in_channels=4, use_bias=False)


def _inputs(name):
    rng = onp.random.RandomState(0)
    if name == "bert":
        return [rng.randint(0, 1000, (2, 8)).astype("int32"), onp.zeros((2, 8), "int32")]
    if name == "resnet18":
        return [rng.rand(2, 3, 32, 32).astype("float32")]
    if name == "convtranspose_grouped":
        return [rng.randn(2, 4, 5, 5).astype("float32")]
    if name == "gathers":
        return [rng.randn(5, 7).astype("float32"),
                onp.stack([rng.randint(0, 5, 6), rng.randint(0, 7, 6)], 1).astype("int32"),
                rng.randint(0, 7, (5, 3)).astype("int32")]
    if name == "rem_isfinite":
        return [onp.array([5.5, -5.5, 7.0, onp.inf, -onp.inf, onp.nan, 3.25, -8.0], "f4"),
                onp.array([3.0, 3.0, -2.5, 2.0, 2.0, 2.0, -1.5, 3.0], "f4")]
    if name == "dynamic_batch":
        return [rng.rand(2, 3, 4).astype("float32")]
    return [rng.rand(2, 4).astype("float32")]


TRACED = {
    "bert": _bert, "resnet18": _resnet, "convtranspose_grouped": _convt,
    "gathers": _gathers, "rem_isfinite": _rem_finite,
    "custom_fallback": lambda j: _Custom.build(jnn if j else nn, jnpx if j else npx,
                                               JHybridBlock if j else HybridBlock),
    "dynamic_batch": lambda j: _Dynamic.build(jnn if j else nn, jnpx if j else npx,
                                              JHybridBlock if j else HybridBlock),
}


@pytest.fixture(scope="module", params=sorted(TRACED))
def traced(request, tmp_path_factory):
    """Both packages' traced files of one model with the same weights, and
    the live outputs (at batch 5 for the dynamic batch)."""
    name = request.param
    d = tmp_path_factory.mktemp(name)
    xs = _inputs(name)
    with mx.cpu():
        jnet = TRACED[name](True)
        tnet = seeded(jnet, TRACED[name](False), xs)
        kw = dict(input_shapes=[x.shape for x in xs], input_types=[x.dtype for x in xs],
                  dynamic_batch=name == "dynamic_batch")
        jpath = jexport(jnet, str(d / "j.onnx"), **kw)
        tpath = export_model(tnet, str(d / "t.onnx"), **kw)
        if name == "dynamic_batch":
            xs = [onp.random.RandomState(1).rand(5, 3, 4).astype("float32")]
        live = tnet(*[np.array(x) for x in xs])
    live = [o.asnumpy() for o in (live if isinstance(live, tuple) else (live,))]
    return dict(name=name, xs=xs, live=live, jpath=jpath, tpath=tpath)


def _outs(res):
    return [o.asnumpy() for o in (res if isinstance(res, (list, tuple)) else [res])]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        fin = onp.isfinite(w)
        assert (onp.isnan(g) == onp.isnan(w)).all()
        assert scaled_err(onp.where(fin, g, 0), onp.where(fin, w, 0)) <= TOL


@pytest.mark.parametrize("writer,importer", [("port", "port"), ("port", "jax"),
                                             ("jax", "port")])
def test_traced_files_cross_import(traced, writer, importer):
    """The port's traced file runs in both importers, and the JAX
    package's in the port's, to the live outputs."""
    path = traced["tpath" if writer == "port" else "jpath"]
    xs = traced["xs"]
    if importer == "port":
        got = _outs(import_model(path)(*[np.array(x) for x in xs]))
    else:
        got = _outs(jimport(path)(*[jnp_.array(x) for x in xs]))
    _close(got, traced["live"])


def test_traced_semantics_ops(traced):
    """The traced port file carries the semantics the JAX package's tests
    name: fmod as ``Mod(fmod=1)``; isfinite (which PyTorch decomposes while
    tracing into ``x == x`` and ``|x| != inf``) as Equal / Abs / Not, its
    inf and NaN results held by the cross-import test; gathers as
    ``GatherND`` / ``GatherElements``; a grouped ``ConvTranspose``; a
    symbolic batch dim 'N' on the dynamic batch's input."""
    ops = [n.op for n in TI.import_model(traced["tpath"]).nodes]
    attrs = {n.op: n.attrs for n in TI.import_model(traced["tpath"]).nodes}
    want = {"rem_isfinite": {"Mod", "Equal", "Abs", "Not"},
            "gathers": {"GatherND", "GatherElements"},
            "convtranspose_grouped": {"ConvTranspose"}}.get(traced["name"], set())
    assert want <= set(ops)
    if traced["name"] == "rem_isfinite":
        assert attrs["Mod"]["fmod"] == 1
    if traced["name"] == "convtranspose_grouped":
        assert attrs["ConvTranspose"]["group"] == 2
    if traced["name"] == "dynamic_batch":
        with open(traced["tpath"], "rb") as f:
            graph = JP.parse_message(JP.parse_message(f.read())[7][0])
        vi = JP.parse_message(graph[11][0])
        ttype = JP.parse_message(JP.parse_message(vi[2][0])[1][0])
        dims = [JP.parse_message(dm) for dm in JP.parse_message(ttype[2][0])[1]]
        assert dims[0][2] == [b"N"]



def test_vit_k1_converter(tmp_path):
    """ViT at T 257 (K1's registered operator in the program) exports with
    the attention math in place of the operator, and the file runs in both
    importers to the live output."""
    cfg = dataclasses.replace(VIT_TINY, image_size=128)
    net = ViTModel(cfg)
    net.initialize()
    x = onp.random.RandomState(0).rand(2, 3, 128, 128).astype("float32")
    live = net(np.array(x)).asnumpy()
    path = export_model(net, str(tmp_path / "vit.onnx"), input_shapes=[x.shape])
    ops = [n.op for n in TI.import_model(path).nodes]
    assert ops.count("Softmax") == cfg.num_layers
    assert scaled_err(import_model(path)(np.array(x)).asnumpy(), live) <= TOL
    assert scaled_err(jimport(path)(jnp_.array(x)).asnumpy(), live) <= TOL
