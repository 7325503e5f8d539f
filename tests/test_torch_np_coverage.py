"""The gap to the JAX package's NumPy frontend, kept visible: every public
name of ``mxnet_tpu.numpy``, ``.numpy.linalg``, ``.numpy.random``,
``.numpy_extension`` and ``gluon.rnn.__all__`` (modules and the JAX-only
``invoke_jnp`` aside) resolves in the port. The rejection samplers of
``np.random`` (ROADMAP Queue 1 item 7 entry 4) draw with the JAX
package's dtype and shape (their values: ``test_torch_random_rejection.py``).

Also: no module of the port and not ``chip_smoke.py`` imports ``jax`` or
the JAX package (parsed with ``ast``, imports inside functions too).
"""
import ast
import pathlib
import types

import pytest

import mxnet_tpu.gluon.rnn
import mxnet_tpu.numpy
import mxnet_tpu.numpy.linalg
import mxnet_tpu.numpy.random
import mxnet_tpu.numpy_extension

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.gluon.rnn
import mxnet_tpu_torch.numpy
import mxnet_tpu_torch.numpy.linalg
import mxnet_tpu_torch.numpy.random
import mxnet_tpu_torch.numpy_extension

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ONLY = {"invoke_jnp"}
# np.random's rejection samplers, each called with small arguments
RANDOM_NOT_PORTED = {"gamma": (1.0,), "beta": (1.0, 2.0), "chisquare": (1.0,),
                     "f": (1.0, 2.0), "poisson": (1.0,), "binomial": (4, 0.5),
                     "multinomial": (4, [0.5, 0.5]), "multivariate_normal": None}
PAIRS = {"numpy": (mxnet_tpu.numpy, mxnet_tpu_torch.numpy),
         "numpy.linalg": (mxnet_tpu.numpy.linalg, mxnet_tpu_torch.numpy.linalg),
         "numpy.random": (mxnet_tpu.numpy.random, mxnet_tpu_torch.numpy.random),
         "numpy_extension": (mxnet_tpu.numpy_extension, mxnet_tpu_torch.numpy_extension)}


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_") and n not in JAX_ONLY
                  and not isinstance(getattr(mod, n), types.ModuleType))


@pytest.mark.parametrize("space", sorted(PAIRS))
def test_namespace_resolves(space):
    jmod, tmod = PAIRS[space]
    missing = [n for n in _public(jmod) if not hasattr(tmod, n)]
    assert not missing, f"{space}: {missing}"


def test_gluon_rnn_all():
    assert sorted(mxnet_tpu_torch.gluon.rnn.__all__) == sorted(mxnet_tpu.gluon.rnn.__all__)
    for n in mxnet_tpu.gluon.rnn.__all__:
        assert hasattr(mxnet_tpu_torch.gluon.rnn, n)
    assert mx.gluon.rnn is mxnet_tpu_torch.gluon.rnn


@pytest.mark.parametrize("name", sorted(RANDOM_NOT_PORTED))
def test_rejection_samplers_still_raise(name):
    """Each rejection sampler (ported since, the name kept) draws what the
    JAX package draws in dtype and shape."""
    assert name in _public(mxnet_tpu.numpy.random)
    outs = []
    for pkg in (mxnet_tpu_torch, mxnet_tpu):
        with mx.cpu():
            args = RANDOM_NOT_PORTED[name]
            if args is None:
                args = (pkg.numpy.array([0.0, 1.0]), pkg.numpy.array([[1.0, 0.0], [0.0, 1.0]]))
            outs.append(getattr(pkg.numpy.random, name)(*args, size=(2,)).asnumpy())
    assert outs[0].dtype == outs[1].dtype and outs[0].shape == outs[1].shape


def _jax_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} imports {m}")
    return bad


def test_port_imports_no_jax():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = [b for f in files for b in _jax_imports(f)]
    assert not bad, bad
