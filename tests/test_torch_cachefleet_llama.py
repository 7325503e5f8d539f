"""Port parity of KV page migration on Llama's GQA pools: pages carry the
JAX package's layouts, ``[1, n_kv, page, hd]`` per layer of the per-layer
decoder and ``[layers, 1, n_kv, page, hd]`` for the stacked decoder, so a
tiny Llama's pages exported by a JAX engine serve the JAX tokens on a port
engine and the reverse. One JAX paged engine at a time (a module fixture
per decoder layout)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.models import llama as JL
from mxnet_tpu.serve import InferenceEngine as JaxEngine

from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import llama as TL
from mxnet_tpu_torch.serve import InferenceEngine

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2)
PAGED = dict(max_batch_size=2, max_len=64, paged=True, page_size=8, num_pages=32)
DEADLINE = 120.0


@pytest.fixture(scope="module", params=[False, True], ids=["per_layer", "stacked"])
def engines(request):
    """A JAX and a port paged engine over a tiny GQA Llama (rep 2) with the
    same seeded weights, in one decoder layout."""
    kw = dict(TINY, stacked=request.param)
    mx.random.seed(0)
    jnet = JL.LlamaForCausalLM(JL.LlamaConfig(dtype=onp.float32, **kw))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(1)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith(("gamma", ".ln1", ".ln2")) else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    tnet = TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, **kw), device="cpu")
    params_from_numpy(tnet, {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    je = JaxEngine(jnet, **PAGED).start()
    te = InferenceEngine(tnet, **PAGED).start()
    yield request.param, je, te
    je.shutdown()
    te.shutdown()


def _run(eng, prompt, new):
    return list(eng.submit(prompt, new, seed=0).result(DEADLINE).generated_ids)


def test_llama_pages_cross_packages(engines):
    stacked, je, te = engines
    rng = onp.random.RandomState(7 + stacked)
    p1, p2 = (rng.randint(1, 256, n).tolist() for n in (21, 27))
    shape = [2, 1, 2, 8, 16] if stacked else [1, 2, 8, 16]
    n_pools = 2 if stacked else 4

    want = _run(je, p1, 6)
    jdoc = je.export_pages(p1)
    assert len(jdoc["pages"]) == 2
    assert all(len(p["payload"]) == n_pools and p["payload"][0]["shape"] == shape
               for p in jdoc["pages"])
    res = te.import_pages(jdoc)
    assert res["adopted"] == res["received"] == 2 and res["verify_failures"] == 0
    saved = te.stats()["pages"]["prefix_tokens_saved"]
    assert _run(te, p1, 6) == want
    assert te.stats()["pages"]["prefix_tokens_saved"] == saved + 16

    got = _run(te, p2, 6)
    tdoc = te.export_pages(p2)
    assert [p["payload"][0]["shape"] for p in tdoc["pages"]] == [shape] * 3
    res = je.import_pages(tdoc)
    assert res["adopted"] == res["received"] == 3 and res["verify_failures"] == 0
    assert _run(je, p2, 6) == got
