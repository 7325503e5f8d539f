"""The KV page wire of the serving fleet (counterpart of the page-wire half
of ``mxnet_tpu/kvstore/comm.py``; ``CollectiveComm`` waits for the
distributed slice).

Cross-replica page migration (serve/cachefleet: preemption rescue,
prefill -> decode tier streaming) ships exact KV pages between replicas as
JSON: each page carries the chain hash of the token prefix it completes
(``serve.paging.prefix_key``, the same sha1 chain as the prefix cache and
the router's affinity scoring), so the receiver verifies the payload names
the tokens the sender claims. Arrays travel as dtype- and shape-tagged
base64 of their raw bytes, so any pool dtype crosses bit for bit.

The doc is the JAX package's, field for field: a doc written by either
package decodes in the other to the same bits. bfloat16 travels as its raw
2-byte words under the dtype string ``"bfloat16"`` that the JAX package
writes (numpy has no bfloat16 of its own, and this package does not need
``ml_dtypes``): the port encodes a bf16 tensor through a ``view(torch.int16)``
and decodes it with ``torch.frombuffer``. Decoded payloads are CPU torch
tensors of the doc's dtype. Pure host serialization; the engines do the
device copies.
"""
from __future__ import annotations

import base64
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["encode_kv_pages", "decode_kv_pages"]

_BF16 = "bfloat16"

# the wire's dtype strings (numpy's names, as the JAX package writes them)
_TORCH_OF = {"float32": torch.float32, "float16": torch.float16, "float64": torch.float64,
             "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
             "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
             _BF16: torch.bfloat16}
_NAME_OF = {v: k for k, v in _TORCH_OF.items()}


def _raw(a) -> Tuple[str, List[int], bytes]:
    """(wire dtype, shape, raw little-endian bytes) of a tensor or array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        name = _NAME_OF.get(t.dtype)
        if name is None:
            raise TypeError(f"no wire dtype for {t.dtype}")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(a.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(a)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def encode_kv_pages(tokens: Sequence[int],
                    pages: Sequence[Tuple[int, int, Sequence]]) -> dict:
    """Serialize migrated KV pages for the HTTP wire.

    ``pages`` is ``[(prefix_len, chain_key, [per-pool tensors])]``: one
    entry per shipped page, carrying the page's slice of every cache pool
    (torch tensors on any device, or numpy arrays)."""
    def _arr(a):
        name, shape, raw = _raw(a)
        return {"dtype": name, "shape": shape,
                "data": base64.b64encode(raw).decode("ascii")}

    return {"tokens": [int(t) for t in tokens],
            "pages": [{"prefix_len": int(ln), "key": int(key),
                       "payload": [_arr(a) for a in payload]}
                      for ln, key, payload in pages]}


def _decode_array(d: dict) -> torch.Tensor:
    raw = bytearray(base64.b64decode(d["data"]))
    name = str(d["dtype"])
    shape = [int(s) for s in d["shape"]]
    dtype = _TORCH_OF.get(name)
    if dtype is None:
        raise ValueError(f"unknown wire dtype {name!r}")
    if not raw:
        return torch.empty(shape, dtype=dtype)
    if dtype == torch.bfloat16:
        return torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16).reshape(shape)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def decode_kv_pages(doc: dict) -> Tuple[List[int], List[Tuple[int, int, List[torch.Tensor]]]]:
    """Inverse of :func:`encode_kv_pages`: ``(tokens, [(prefix_len,
    chain_key, [CPU tensors])])``. The chain hashes are not verified here:
    the importing engine owns that (and the ``mxnet_migrate_*``
    accounting), so a receipt over any transport meets one verification
    path."""
    tokens = [int(t) for t in doc.get("tokens", ())]
    pages = [(int(p["prefix_len"]), int(p["key"]),
              [_decode_array(a) for a in p.get("payload", ())])
             for p in doc.get("pages", ())]
    return tokens, pages
