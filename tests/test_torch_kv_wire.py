"""Port parity of the serving fleet's KV page wire:
``mxnet_tpu_torch.kvstore.comm.encode_kv_pages`` / ``decode_kv_pages``
against ``mxnet_tpu.kvstore.comm``'s. A doc written by either package
decodes in the other to the same bits, for f32, bf16 and int8 payloads;
the port carries bf16 as its raw 2-byte words under JAX's dtype string and
decodes it to a torch bf16 tensor, with no ``ml_dtypes`` of its own."""
import json

import ml_dtypes
import numpy as onp
import pytest
import torch

from mxnet_tpu.kvstore import comm as jcomm

from mxnet_tpu_torch.kvstore import comm as tcomm

# one page of a GPT pool (per layer), of a Llama pool and of a stacked pool
SHAPES = [(1, 2, 8, 16), (1, 1, 8, 16), (3, 1, 2, 8, 16)]


def _pages(dtype, seed=0):
    """Seeded pages: [(prefix_len, key, [numpy arrays])] of ``dtype``
    ('float32', 'bfloat16' or 'int8'), with NaN, inf and -0.0 among the
    float values."""
    rng = onp.random.RandomState(seed)
    out = []
    for i in range(3):
        payload = []
        for shp in SHAPES:
            if dtype == "int8":
                a = rng.randint(-128, 128, shp).astype(onp.int8)
            else:
                a = rng.randn(*shp).astype(onp.float32)
                a.flat[:3] = [onp.nan, -onp.inf, -0.0]
                if dtype == "bfloat16":
                    a = a.astype(ml_dtypes.bfloat16)
            payload.append(a)
        out.append(((i + 1) * 8, int(rng.randint(0, 2 ** 62)), payload))
    return out


def _bits(a):
    """The raw bytes and the shape of an array or tensor."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), tuple(a.shape)
    return onp.ascontiguousarray(a).tobytes(), tuple(a.shape)


def _torch_pages(pages):
    def t(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(onp.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return [(ln, key, [t(a) for a in payload]) for ln, key, payload in pages]


TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_docs_decode_across_packages(dtype):
    """A JAX doc decodes in the port, and a port doc in JAX, to the same
    bits, shapes and prefix keys; both packages write the same doc (after a
    JSON round trip, as the HTTP wire carries it)."""
    tokens = list(range(1, 25))
    pages = _pages(dtype)
    jdoc = json.loads(json.dumps(jcomm.encode_kv_pages(tokens, pages)))
    tdoc = json.loads(json.dumps(tcomm.encode_kv_pages(tokens, _torch_pages(pages))))
    assert tdoc == jdoc
    for doc in (jdoc, tdoc):
        ttoks, tpages = tcomm.decode_kv_pages(doc)
        jtoks, jpages = jcomm.decode_kv_pages(doc)
        assert ttoks == jtoks == tokens
        assert [(ln, key) for ln, key, _ in tpages] == [(ln, key) for ln, key, _ in pages]
        for (_, _, tp), (_, _, jp), (_, _, ref) in zip(tpages, jpages, pages):
            for t, j, r in zip(tp, jp, ref):
                assert isinstance(t, torch.Tensor) and t.dtype == TORCH_DTYPE[dtype]
                assert str(j.dtype) == dtype
                assert _bits(t) == _bits(j) == _bits(r)


def test_numpy_payload_and_empty_doc():
    """The port encodes numpy payloads as JAX does, and an empty doc (no
    cached prefix) decodes to no pages in both packages."""
    pages = _pages("float32", seed=1)
    assert tcomm.encode_kv_pages([1, 2], pages) == jcomm.encode_kv_pages([1, 2], pages)
    empty = tcomm.encode_kv_pages([], [])
    assert empty == jcomm.encode_kv_pages([], []) == {"tokens": [], "pages": []}
    assert tcomm.decode_kv_pages(empty) == ([], [])
    with pytest.raises(ValueError, match="unknown wire dtype"):
        tcomm.decode_kv_pages({"tokens": [1], "pages": [{"prefix_len": 1, "key": 0,
                                                        "payload": [{"dtype": "complex64",
                                                                     "shape": [1],
                                                                     "data": ""}]}]})
