"""Deployment parity on the CPU: ``HybridBlock.export`` /
``SymbolBlock.imports`` over ``torch.export``, ``parallel.functionalize``
and ``optimize_for``, against the JAX package's (``jax.export``) with the
same weights, carried by ``interop.params_from_numpy``.

Models: an MLP, ``VIT_TINY`` at 128 x 128 with 8 x 8 patches (T 257: K1's
registered operator, the plain K1 on the CPU) and ``BERT_TINY``'s
classifier; each fixture is built once per module.

Tolerances: the port's import against the port's live block 1e-6 of the
output's max-abs scale (the same operators run; only their order in the
program may differ); against the JAX package's import 1e-4 (the f32
tolerance of ``tests/test_torch_vit.py`` / ``test_torch_bert.py``);
``optimize_for(backend="int8")`` against the CPU ``quantize_net`` path
1e-6 and against the JAX package's 1e-5 (K3's plain version is the JAX
package's off-TPU fallback: a dequantized f32 matmul).
"""
import dataclasses
import json
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.block import SymbolBlock as JSymbolBlock
from mxnet_tpu.models import BertForSequenceClassification as JBertCls
from mxnet_tpu.models import ViTModel as JViTModel
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.models import vit as jvit

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import interop, np
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import QuantizedBlockDense, quantize_net
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import HybridBlock, SymbolBlock, list_op_backends
from mxnet_tpu_torch.models import BERT_TINY, VIT_TINY, BertForSequenceClassification, ViTModel
from mxnet_tpu_torch.ops.int8_gemv import count_launches
from mxnet_tpu_torch.parallel.functional import functionalize

SELF_TOL, JAX_TOL, INT8_TOL, INT8_JAX_TOL = 1e-6, 1e-4, 1e-6, 1e-5
VIT_FLASH = dataclasses.replace(VIT_TINY, image_size=128)


@pytest.fixture(autouse=True)
def on_cpu():
    torch.set_num_threads(1)
    with mx.cpu():
        yield


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30))


def weights(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _mlp(pkg_nn):
    net = pkg_nn.HybridSequential()
    net.add(pkg_nn.Dense(16, activation="relu", in_units=8), pkg_nn.Dense(4, in_units=16))
    return net


def _pair(name):
    """(jax net, port net, inputs as numpy arrays) with the JAX weights."""
    rng = onp.random.RandomState(0)
    jmx.random.seed(0)
    if name == "mlp":
        jnet, tnet = _mlp(jnn), _mlp(nn)
        xs = [rng.randn(3, 8).astype("float32")]
    elif name == "vit":
        jnet = JViTModel(jvit.ViTConfig(**{f.name: getattr(VIT_FLASH, f.name)
                                           for f in dataclasses.fields(VIT_FLASH)}))
        tnet = ViTModel(VIT_FLASH)
        xs = [rng.rand(2, 3, 128, 128).astype("float32")]
    else:
        cfg = {f.name: getattr(BERT_TINY, f.name) for f in dataclasses.fields(BERT_TINY)}
        jnet = JBertCls(jbert.BertConfig(**cfg))
        tnet = BertForSequenceClassification(BERT_TINY)
        xs = [rng.randint(0, 1000, (2, 8)).astype("int32"), onp.zeros((2, 8), "int32")]
    jnet.initialize()
    jnet.hybridize()            # one XLA compile, not one an op
    jnet(*[jnp_.array(x) for x in xs])
    tnet.initialize()
    interop.params_from_numpy(tnet, weights(jnet))
    return jnet, tnet, xs


@pytest.fixture(scope="module", params=["mlp", "vit", "bert"])
def exported(request, tmp_path_factory):
    """Each model exported by both packages into one directory."""
    d = tmp_path_factory.mktemp(request.param)
    with mx.cpu():
        jnet, tnet, xs = _pair(request.param)
        want = jnet(*[jnp_.array(x) for x in xs]).asnumpy()
        live = tnet(*[np.array(x) for x in xs]).asnumpy()
        tsym, tparams = tnet.export(str(d / "port"))
        jsym, jparams = jnet.export(str(d / "jax"))
    return dict(name=request.param, xs=xs, want=want, live=live, tsym=tsym,
                tparams=tparams, jsym=jsym, jparams=jparams, tnet=tnet, jnet=jnet)


def test_imports_equals_live_and_jax(exported):
    """The port's ``export`` -> ``imports`` equals the port's live block and
    the JAX package's ``export`` -> ``imports`` of the same weights."""
    e = exported
    net = SymbolBlock.imports(e["tsym"])
    got = net(*[np.array(x) for x in e["xs"]]).asnumpy()
    assert scaled_err(got, e["live"]) <= SELF_TOL
    jgot = JSymbolBlock.imports(e["jsym"])(*[jnp_.array(x) for x in e["xs"]]).asnumpy()
    assert scaled_err(got, jgot) <= JAX_TOL
    assert scaled_err(got, e["want"]) <= JAX_TOL


def test_manifest_keys_and_params(exported):
    """The manifest has the JAX package's keys (and the same parameter
    order and input signature); the imported parameters are real
    ``Parameter``s under the dotted names, with no gradient."""
    e = exported
    with open(e["tsym"]) as f:
        ours = json.load(f)
    with open(e["jsym"]) as f:
        theirs = json.load(f)
    assert set(theirs) <= set(ours)
    for key in ("format", "version", "class", "inputs", "params", "output_tree"):
        assert ours[key] == theirs[key], key
    assert ours["artifacts"] == {"cpu": os.path.basename(e["tsym"])[:-len(".json")] + "-cpu.pt2"}
    net = SymbolBlock.imports(e["tsym"])
    params = net.collect_params()
    assert list(params) == theirs["params"]
    assert all(p.grad_req == "null" for p in params.values())


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_params_cross_load(exported, direction):
    """``.params`` files written by either package's export load into the
    other's model to the same outputs."""
    e = exported
    if direction == "port_to_jax":
        jnet = _pair(e["name"])[0]
        jnet.load_parameters(e["tparams"])
        got = jnet(*[jnp_.array(x) for x in e["xs"]]).asnumpy()
    else:
        tnet = {"mlp": lambda: _mlp(nn), "vit": lambda: ViTModel(VIT_FLASH),
                "bert": lambda: BertForSequenceClassification(BERT_TINY)}[e["name"]]()
        tnet.initialize()
        tnet.load_parameters(e["jparams"])
        got = tnet(*[np.array(x) for x in e["xs"]]).asnumpy()
    assert scaled_err(got, e["want"]) <= JAX_TOL


def test_jax_stablehlo_export_raises(exported):
    """A JAX package export (StableHLO) is named as the JAX package's."""
    with pytest.raises(MXNetError, match="JAX package"):
        SymbolBlock.imports(exported["jsym"])


def test_cpu_exported_graph_names_k1_op(tmp_path):
    """ViT at T 257 exports with K1 as the ``mxnet_tpu_torch::flash_fwd``
    operator, one a layer, and its import launches the plain K1."""
    _, tnet, xs = _pair("vit")
    sym, _ = tnet.export(str(tmp_path / "vit"), example_inputs=[np.array(xs[0])])
    program = torch.export.load(str(tmp_path / "vit-symbol-cpu.pt2"))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("mxnet_tpu_torch.flash_fwd.default") == VIT_FLASH.num_layers
    with count_launches() as tally:
        SymbolBlock.imports(sym)(np.array(xs[0]))
    assert tally.get("flash_fwd", 0) == VIT_FLASH.num_layers


def test_export_platform_checks(tmp_path):
    """A gpu trace needs a card; an import for a platform the export lacks
    raises (here first for the missing card)."""
    _, tnet, xs = _pair("mlp")
    tnet(np.array(xs[0]))
    sym, _ = tnet.export(str(tmp_path / "m"))
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="gpu"):
            tnet.export(str(tmp_path / "g"), platforms=["gpu"])
    with pytest.raises(MXNetError, match="no CUDA device|not for 'gpu'"):
        SymbolBlock.imports(sym, device="cuda")
    with pytest.raises(MXNetError, match="platform"):
        tnet.export(str(tmp_path / "t"), platforms=["tpu"])


# ------------------------------------------------ tests/test_export_import.py
def _build_net(pkg, pkg_nn):
    pkg.random.seed(0)
    net = pkg_nn.HybridSequential()
    net.add(pkg_nn.Dense(16, activation="relu"), pkg_nn.Dense(4))
    net.initialize()
    net.hybridize()
    return net


@pytest.mark.parametrize("case", ["last_signature", "epoch", "no_signature", "resave",
                                  "multi_output"])
def test_export_import_cases(case, tmp_path):
    """The cases of ``tests/test_export_import.py``: the last call's
    signature, an explicit signature and epoch, no signature (raises),
    parameters inspectable and saved again, and a two-output block."""
    base = str(tmp_path / "m")
    x = onp.random.RandomState(1).randn(2, 8).astype("float32")
    if case == "no_signature":
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=4))
        net.initialize()
        with pytest.raises(MXNetError, match="signature"):
            net.export(base)
        return
    if case == "multi_output":
        class TwoHead(HybridBlock):
            def __init__(self):
                super().__init__()
                self.a = nn.Dense(3, in_units=4)
                self.b = nn.Dense(2, in_units=4)

            def forward(self, v):
                return self.a(v), self.b(v)

        net = TwoHead()
        net.initialize()
        x = x[:, :4]
        refs = net(np.array(x))
        sym, _ = net.export(base, example_inputs=[np.array(x)])
        outs = SymbolBlock.imports(sym)(np.array(x))
        assert isinstance(outs, tuple) and len(outs) == 2
        for o, r in zip(outs, refs):
            assert scaled_err(o.asnumpy(), r.asnumpy()) <= SELF_TOL
        return
    net = _build_net(mx, nn)
    ref = net(np.array(x)).asnumpy()
    if case == "epoch":
        net.export(base, epoch=7, example_inputs=[np.array(x)])
        assert os.path.exists(base + "-0007.params")
        sym = base + "-symbol.json"
    else:
        sym, params = net.export(base)
        assert os.path.exists(params) and os.path.exists(base + "-symbol-cpu.pt2")
    net2 = SymbolBlock.imports(sym)
    assert scaled_err(net2(np.array(x)).asnumpy(), ref) <= SELF_TOL
    if case == "resave":
        assert len(net2.collect_params()) == len(net.collect_params())
        resaved = str(tmp_path / "resaved.params")
        net2.save_parameters(resaved)
        net3 = SymbolBlock.imports(sym, param_file=resaved)
        assert scaled_err(net3(np.array(x)).asnumpy(), ref) <= SELF_TOL


# ----------------------------------------------------------- functionalize
def test_functionalize_apply_and_aux_match_jax():
    """``functionalize(...).apply`` equals the live forward; in training
    mode BatchNorm's running statistics come back as aux updates equal to
    the JAX package's."""
    from mxnet_tpu.parallel.functional import functionalize as jfunctionalize

    def build(pkg_nn):
        net = pkg_nn.HybridSequential()
        net.add(pkg_nn.Dense(8, in_units=6), pkg_nn.BatchNorm(in_channels=8), pkg_nn.Dense(3))
        return net
    x = onp.random.RandomState(2).randn(5, 6).astype("float32")
    jnet = build(jnn)
    jnet.initialize()
    jnet(jnp_.array(x))
    tnet = build(nn)
    tnet.initialize()
    interop.params_from_numpy(tnet, weights(jnet))
    fm = functionalize(tnet, np.array(x), training=True)
    jfm = jfunctionalize(jnet, jnp_.array(x), training=True)
    assert fm.names == jfm.names
    out, aux = fm.apply(fm.values(), np.array(x), seed=0)
    jout, jaux = jfm.apply(jfm.values(), jnp_.array(x)._data, seed=0)
    assert scaled_err(out.detach().numpy(), onp.asarray(jout)) <= JAX_TOL
    assert sorted(aux) == sorted(jaux)
    for slot in aux:
        assert scaled_err(aux[slot].numpy(), onp.asarray(jaux[slot])) <= JAX_TOL
    live = tnet(np.array(x)).asnumpy()
    out, aux = fm.apply(fm.values(), np.array(x), training=False)
    assert aux == {} and scaled_err(out.detach().numpy(), live) <= SELF_TOL


# ------------------------------------------------------------ optimize_for
def test_optimize_for_int8_equals_quantize_net_and_jax(tmp_path):
    """``optimize_for(x, backend="int8")`` equals ``quantize_net`` on a
    copy of the same weights and the JAX package's ``optimize_for``; at 64
    rows or fewer every quantized Dense is one K3 call (plain K3 here). The
    optimized block exports with K3 as ``mxnet_tpu_torch::int8_gemv`` and
    its import gives the same output."""
    x = onp.random.RandomState(3).randn(4, 8).astype("float32")
    jnet = _mlp(jnn)
    jnet.initialize()
    jnet(jnp_.array(x))
    nets = []
    for _ in range(2):
        t = _mlp(nn)
        t.initialize()
        interop.params_from_numpy(t, weights(jnet))
        nets.append(t)
    assert "int8" in list_op_backends()
    with count_launches() as tally:
        got = nets[0].optimize_for(np.array(x), backend="int8").asnumpy()
    assert tally.get("gemv", 0) == 2
    assert all(isinstance(c, QuantizedBlockDense) for c in nets[0])
    plain = quantize_net(nets[1])(np.array(x)).asnumpy()
    assert scaled_err(got, plain) <= INT8_TOL
    want = jnet.optimize_for(jnp_.array(x), backend="int8").asnumpy()
    assert scaled_err(got, want) <= INT8_JAX_TOL
    sym, _ = nets[0].export(str(tmp_path / "q"))
    program = torch.export.load(str(tmp_path / "q-symbol-cpu.pt2"))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("mxnet_tpu_torch.int8_gemv.default") == 2
    with count_launches() as tally:
        again = SymbolBlock.imports(sym)(np.array(x)).asnumpy()
    assert tally.get("gemv", 0) == 2
    assert scaled_err(again, got) <= SELF_TOL


@pytest.mark.parametrize("calib_mode", ["none", "naive"])
def test_int8_backend_past_64_rows_matches_jax(calib_mode):
    """Past 64 rows the gluon int8 layers take the activation-quantized
    int8 product: with dynamic scales and with scales calibrated
    (``'naive'``) on one batch, equal to the JAX package's within 1e-5."""
    rng = onp.random.RandomState(4)
    calib = rng.randn(16, 8).astype("float32")
    x = rng.randn(70, 8).astype("float32")
    jnet = _mlp(jnn)
    jnet.initialize()
    jnet(jnp_.array(x))
    tnet = _mlp(nn)
    tnet.initialize()
    interop.params_from_numpy(tnet, weights(jnet))
    kw = {} if calib_mode == "none" else dict(calib_mode="naive", calib_data=[calib])
    from mxnet_tpu.contrib.quantization import quantize_net as jquantize_net
    want = jquantize_net(jnet, **{k: ([jnp_.array(calib)] if k == "calib_data" else v)
                                  for k, v in kw.items()})(jnp_.array(x)).asnumpy()
    got = quantize_net(tnet, **{k: ([np.array(calib)] if k == "calib_data" else v)
                                for k, v in kw.items()})(np.array(x)).asnumpy()
    assert scaled_err(got, want) <= INT8_JAX_TOL
    assert all(c._mode == ("dynamic" if calib_mode == "none" else "frozen") for c in tnet)


def test_imports_refuses_pickled_payloads(tmp_path):
    """An archive whose tensor constants (here a quantized layer's tables)
    are marked pickled is refused before ``torch.export.load`` reads it."""
    import zipfile
    net = _mlp(nn)
    net.initialize()
    x = np.array(onp.ones((2, 8), "float32"))
    net.optimize_for(x, backend="int8")
    sym, _ = net.export(str(tmp_path / "q"))
    SymbolBlock.imports(sym)
    path = str(tmp_path / "q-symbol-cpu.pt2")
    with zipfile.ZipFile(path) as z:
        items = {n: z.read(n) for n in z.namelist()}
    name = next(n for n in items if n.endswith("_constants_config.json"))
    doc = json.loads(items[name])
    assert doc["config"]
    for meta in doc["config"].values():
        meta["use_pickle"] = True
    items[name] = json.dumps(doc).encode()
    with zipfile.ZipFile(path, "w") as z:
        for n, data in items.items():
            z.writestr(n, data)
    with pytest.raises(MXNetError, match="never unpickles"):
        SymbolBlock.imports(sym)


def _rewrite_archive(path, edit):
    """Rewrite the zip at ``path`` with ``edit(items, root)`` applied to its
    {entry name: bytes}."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        items = {n: z.read(n) for n in z.namelist()}
    edit(items, next(iter(items)).split("/", 1)[0] + "/")
    with zipfile.ZipFile(path, "w") as z:
        for n, data in items.items():
            z.writestr(n, data)


def _strip_config(items, root):
    del items[root + "data/weights/model_weights_config.json"]


def _pickled_sample_inputs(items, root):
    import pickle
    items[root + "data/sample_inputs/model.pt"] = pickle.dumps(((), {}))


def _stray_entry(items, root):
    items[root + "extra/payload.pkl"] = b"not read"


def _custom_object(items, root):
    name = root + "data/constants/model_constants_config.json"
    doc = json.loads(items[name])
    doc["config"]["obj"] = {"path_name": "custom_obj_0", "use_pickle": False}
    items[name] = json.dumps(doc).encode()
    items[root + "data/constants/custom_obj_0"] = b"not read"


@pytest.mark.parametrize("edit", [_strip_config, _pickled_sample_inputs, _stray_entry,
                                  _custom_object], ids=lambda f: f.__name__.strip("_"))
def test_imports_refuses_archives_it_cannot_account_for(tmp_path, edit):
    """The archive check fails closed: a program without its weights
    config, pickled sample inputs, an entry no config names and a custom
    object are each refused before ``torch.export.load`` reads the file;
    the archive as exported loads."""
    net = _mlp(nn)
    net.initialize()
    net(np.array(onp.ones((2, 8), "float32")))
    sym, _ = net.export(str(tmp_path / "m"))
    SymbolBlock.imports(sym)
    _rewrite_archive(str(tmp_path / "m-symbol-cpu.pt2"), edit)
    with pytest.raises(MXNetError, match="never unpickles"):
        SymbolBlock.imports(sym)


class _TiedLM(HybridBlock):
    def __init__(self):
        super().__init__()
        self.wte = nn.Embedding(16, 8)
        self.proj = nn.Dense(8, in_units=8)

    def forward(self, ids):
        return self.proj(self.wte(ids))


@pytest.mark.parametrize("option", ["fused_decode", "tied_head"])
def test_quantize_net_of_a_gluon_block_refuses_torch_model_options(option):
    """Fused decode and the tied head are paths of the port's torch models:
    asked of a gluon block, ``quantize_net`` raises instead of ignoring
    them, and leaves the block unquantized."""
    net = _TiedLM() if option == "tied_head" else _mlp(nn)
    net.initialize()
    kw = {"fused_decode": True} if option == "fused_decode" else {}
    with pytest.raises(MXNetError, match="fused_decode" if kw else "quantize_tied_head=False"):
        quantize_net(net, **kw)
    assert not any(isinstance(b, QuantizedBlockDense) for b in net._children.values())
    if option == "tied_head":
        assert quantize_net(net, quantize_tied_head=False) is net
        assert isinstance(net.proj, QuantizedBlockDense)


def test_optimize_for_unknown_backend_raises():
    net = _mlp(nn)
    net.initialize()
    with pytest.raises(MXNetError, match="unknown backend"):
        net.optimize_for(np.array(onp.zeros((1, 8), "float32")), backend="nope")


def test_jax_manifest_of_port_keys_readable(exported):
    """Port manifests keep ``output_tree`` in the JAX package's pickle-free
    encoding, which the JAX package's decoder reads."""
    from mxnet_tpu.gluon.block import _treedef_from_json
    with open(exported["tsym"]) as f:
        tree = json.load(f)["output_tree"]
    assert _treedef_from_json(tree).num_leaves == 1
    assert JHybridBlock is not None
