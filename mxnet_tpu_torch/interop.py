"""Move parameters between the JAX package and a model of the port.

``named`` is what ``{n: p.data().asnumpy() for n, p in
net.collect_params().items()}`` gives for a JAX ``GPTModel`` or
``LlamaForCausalLM``: the port's modules carry the same names
(``wte.weight``, ``blocks.0.attn_qkv.weight`` (units, in),
``blocks.0.ln_1.gamma``; ``model.layers.0.self_attn.q_proj.weight``,
``model.layers.0.input_layernorm.gamma``, the stacked decoder's
``model.layers.wq`` [layers, out, in], ...), so the two packages then
hold the same weights and quantize them to the same int8 tables. bf16 goes both
ways: a bfloat16 numpy array (the JAX package's bf16 ``asnumpy()``) loads
into any parameter dtype, and :func:`params_to_numpy` gives bf16
parameters as f32 arrays (exact: bf16 widens to f32 without rounding).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(model, named: Dict[str, np.ndarray]):
    """Copy every array of ``named`` into the parameter of the same name,
    cast to the parameter's dtype. ``model`` is an ``nn.Module``, or a
    gluon block, which takes the JAX net's ``{n: p.data().asnumpy() for n,
    p in net.collect_params().items()}`` by its own ``collect_params()``
    names (deferred parameters take the loaded shapes). Raises on a
    missing, unexpected or differently shaped parameter. Load before
    ``quantize_net``: quantization reads the loaded weights."""
    from .gluon.block import Block
    if isinstance(model, Block):
        return model.load_dict(named, cast_dtype=True)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise MXNetError(f"params_from_numpy: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, arr in named.items():
            p = params[name]
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":    # numpy has no bf16 of its own
                arr = arr.astype(np.float32)
            src = torch.from_numpy(np.array(arr, copy=True))
            if tuple(src.shape) != tuple(p.shape):
                raise MXNetError(f"params_from_numpy: {name} has shape "
                                 f"{tuple(src.shape)}, the model wants "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def params_to_numpy(model) -> Dict[str, np.ndarray]:
    """{name: array} of every parameter (of an ``nn.Module`` or an
    initialized gluon block), on the host; bf16 and other low-precision
    floats as exact f32."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
