"""``model_zoo.vision`` (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ResNet V1/V2, AlexNet, VGG,
MobileNet V1/V2, DenseNet, SqueezeNet and Inception V3, by name through
:func:`get_model`. Pretrained weights are not shipped (``pretrained=True``
raises): load a local file with ``load_parameters``."""
from __future__ import annotations

from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403

_models = {}


def _register_models():
    from . import densenet as _d, inception as _i, mobilenet as _m, resnet as _r
    from . import squeezenet as _s, vgg as _v
    from .alexnet import alexnet as _alex
    for depth in (18, 34, 50, 101, 152):
        for ver in (1, 2):
            _models[f"resnet{depth}_v{ver}"] = getattr(_r, f"resnet{depth}_v{ver}")
    for n in (11, 13, 16, 19):
        _models[f"vgg{n}"] = getattr(_v, f"vgg{n}")
        _models[f"vgg{n}_bn"] = getattr(_v, f"vgg{n}_bn")
    _models["alexnet"] = _alex
    _models["mobilenet1.0"] = _m.mobilenet1_0
    _models["mobilenet0.75"] = _m.mobilenet0_75
    _models["mobilenet0.5"] = _m.mobilenet0_5
    _models["mobilenet0.25"] = _m.mobilenet0_25
    _models["mobilenetv2_1.0"] = _m.mobilenet_v2_1_0
    _models["mobilenetv2_0.75"] = _m.mobilenet_v2_0_75
    _models["mobilenetv2_0.5"] = _m.mobilenet_v2_0_5
    _models["mobilenetv2_0.25"] = _m.mobilenet_v2_0_25
    for depth in (121, 161, 169, 201):
        _models[f"densenet{depth}"] = getattr(_d, f"densenet{depth}")
    _models["squeezenet1.0"] = _s.squeezenet1_0
    _models["squeezenet1.1"] = _s.squeezenet1_1
    _models["inceptionv3"] = _i.inception_v3


def get_model(name: str, **kwargs):
    """The model registered under ``name`` (case-insensitive), built with
    ``kwargs``."""
    if not _models:
        _register_models()
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"unknown model {name!r}; options: {sorted(_models)}")
    return _models[name](**kwargs)
