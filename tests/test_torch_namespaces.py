"""The port's namespaces against the JAX package's: every name of
``mxnet_tpu``'s lazy-import table, of ``mxnet_tpu.serve``'s,
``mxnet_tpu.ops``'s and ``mxnet_tpu.models``' ``__all__`` and of the
optimizer registry, whose module the port has, resolves in the port
(``mx.kv``, ``mx.checkpoint``, ``mx.metric``, ``mx.serve.PagePool``,
``mx.ops.flash_attention``, ``mx.models.BertModel``, ``"lamb"``, ...).
Names whose module is not ported yet are listed by the test; each must
still be missing, so the lists stay true."""
import importlib
import importlib.util

import pytest

import mxnet_tpu
import mxnet_tpu.models
import mxnet_tpu.ops
import mxnet_tpu.optimizer
import mxnet_tpu.serve

import mxnet_tpu_torch

# JAX modules with no counterpart in the port yet (ROADMAP Queue 1 items 7-8)
_LAZY_NOT_PORTED = {"aot", "tune", "benchmark"}
_SERVE_NOT_PORTED: set = set()
# across devices: waits for the torch.distributed stack (ROADMAP Queue 1 item 8)
_MODELS_NOT_PORTED = {"llama_shardings"}


def _port_has(modname: str) -> bool:
    try:
        return importlib.util.find_spec(modname) is not None
    except ModuleNotFoundError:     # its parent package is missing too
        return False


@pytest.mark.parametrize("name", sorted(mxnet_tpu._LAZY))
def test_lazy_table(name):
    """``mx.<name>`` resolves to the port's counterpart of the JAX
    package's module wherever the port has that module."""
    target = "mxnet_tpu_torch" + mxnet_tpu._LAZY[name]
    if name in _LAZY_NOT_PORTED:
        assert not _port_has(target), f"{target} exists: take {name} off the list"
        return
    assert _port_has(target), f"{target} is missing"
    assert getattr(mxnet_tpu_torch, name) is importlib.import_module(target)


def _defining_module(pkg, name):
    """The submodule of ``pkg`` that a name of its ``__all__`` comes from."""
    obj = getattr(pkg, name)
    mod = getattr(obj, "__module__", None)
    if mod and mod.startswith(pkg.__name__ + "."):
        return mod[len(pkg.__name__) + 1:]
    for sub in sorted(n for n in dir(pkg) if not n.startswith("_")):
        m = getattr(pkg, sub)
        if getattr(m, "__name__", "").startswith(pkg.__name__ + ".") and \
                getattr(m, name, None) is obj:
            return m.__name__[len(pkg.__name__) + 1:]
    raise AssertionError(f"no submodule of {pkg.__name__} defines {name}")


@pytest.mark.parametrize("name", sorted(mxnet_tpu.serve.__all__))
def test_serve_names(name):
    """``mx.serve.<name>`` resolves wherever the port ported its module."""
    import mxnet_tpu_torch.serve as tserve
    if name in _SERVE_NOT_PORTED:
        assert not hasattr(tserve, name), f"{name} is exported: take it off the list"
        return
    sub = _defining_module(mxnet_tpu.serve, name).split(".")[0]
    assert _port_has("mxnet_tpu_torch.serve." + sub), f"serve.{sub} is missing"
    assert name in tserve.__all__ and hasattr(tserve, name)
    assert getattr(tserve, name) is getattr(
        importlib.import_module("mxnet_tpu_torch.serve." + sub), name)


@pytest.mark.parametrize("name", sorted(mxnet_tpu.ops.__all__))
def test_ops_names(name):
    """``mx.ops.<name>`` resolves (``flash_attention``, ``attention``)."""
    assert name in mxnet_tpu_torch.ops.__all__ and callable(getattr(mxnet_tpu_torch.ops, name))


@pytest.mark.parametrize("name", sorted(mxnet_tpu.models.__all__))
def test_models_names(name):
    """``mx.models.<name>`` resolves (BERT, T5, ViT, GPT, Llama and their
    configs); the names whose slice is not ported stay missing."""
    import mxnet_tpu_torch.models as tmodels
    if name in _MODELS_NOT_PORTED:
        assert not hasattr(tmodels, name), f"{name} is exported: take it off the list"
        return
    assert name in tmodels.__all__ and hasattr(tmodels, name)


@pytest.mark.parametrize("name", sorted(mxnet_tpu.optimizer._REGISTRY.list()))
def test_optimizer_registry(name):
    """Every registered optimizer name of the JAX package creates the
    port's optimizer of the same class name, also as ``mx.optimizer.<Class>``."""
    import mxnet_tpu_torch.optimizer as topt
    jcls = mxnet_tpu.optimizer._REGISTRY.get(name)
    opt = topt.create(name)
    assert type(opt).__name__ == jcls.__name__
    assert getattr(topt, jcls.__name__) is type(opt) and jcls.__name__ in topt.__all__
