"""Port parity of live weight publishing and swapping:
``mxnet_tpu_torch.serve.registry`` and ``InferenceEngine.swap_weights``
against the JAX package's. Versions published by either package are read
by the other, a partial publish is invisible, checkpoints publish, swap
validation gives JAX's messages before anything is staged, and a live
swap serves what a fresh engine on the new weights serves (and what JAX's
engine serves after the same swap) without a new capture."""
import os
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import InferenceEngine as JaxEngine
from mxnet_tpu.serve import registry as jreg

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.serve import HTTPFrontend, InferenceEngine, ModelRegistry
from mxnet_tpu_torch.serve import registry as treg

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)
PROMPT = [5, 9, 2, 7, 7, 1]


def _pair(seed, quantize=None):
    """A JAX GPT and the port's GPT with the same N(0, 0.1) weights;
    ``quantize``: None, or the ``fused_decode`` of an int8 quantize_net."""
    mx.random.seed(seed)
    jnet = JaxGPT(JaxGPTConfig(**CFG))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(seed)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    tnet = GPTModel(GPTConfig(**CFG), device="cpu")
    params_from_numpy(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    if quantize is not None:
        jax_quantize_net(jnet, calib_mode="none", fused_decode=quantize)
        quantize_net(tnet, fused_decode=quantize)
    return jnet, tnet


@pytest.fixture(scope="module")
def net_a():
    return _pair(0)


@pytest.fixture(scope="module")
def net_b():
    return _pair(1)


def _jax_params(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


def test_publish_read_roundtrip(tmp_path, net_a):
    """Versions count up, ``keep_last`` prunes, a version reads back with
    its shapes, dtypes and values; version 0 is refused."""
    d = str(tmp_path / "w")
    params = treg.snapshot_params(net_a[1])
    assert treg.publish_weights(d, params) == 1 and treg.latest_weight_version(d) == 1
    assert treg.publish_weights(d, params, keep_last=1) == 2
    assert treg.weight_versions(d) == [2]
    v, got, manifest = treg.read_weights(d)
    assert v == 2 and manifest["version"] == 2
    for name, arr in params.items():
        assert got[name].dtype == arr.dtype and onp.array_equal(got[name], arr)
    with pytest.raises(MXNetError, match="version must be positive"):
        treg.publish_weights(d, params, version=0)
    with pytest.raises(MXNetError, match="no published weights"):
        treg.read_weights(str(tmp_path / "empty"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_versions_cross_packages(tmp_path, writer):
    """A version published by either package, f32 and bf16 arrays, is read
    by the other with the same values (bf16 bit for bit) and manifest."""
    import ml_dtypes
    rng = onp.random.RandomState(0)
    f32 = rng.randn(3, 5).astype("float32")
    b16 = rng.randn(4, 2).astype(ml_dtypes.bfloat16)
    d = str(tmp_path / "w")
    if writer == "jax":
        v = jreg.publish_weights(d, {"a.weight": f32, "b.gamma": b16}, meta={"k": 1})
        rv, got, manifest = treg.read_weights(d)
        assert treg._host_tensor(got["b.gamma"]).dtype == torch.bfloat16
        bits = treg._host_tensor(got["b.gamma"]).view(torch.int16).numpy()
    else:
        v = treg.publish_weights(d, {"a.weight": torch.from_numpy(f32),
                                     "b.gamma": torch.from_numpy(b16.view("int16"))
                                     .view(torch.bfloat16)}, meta={"k": 1})
        rv, got, manifest = jreg.read_weights(d)
        bits = onp.asarray(got["b.gamma"]).view("int16")
    assert v == rv == 1 and manifest["meta"] == {"k": 1}
    assert manifest["params"]["b.gamma"] == {"dtype": "bfloat16", "shape": [4, 2]}
    onp.testing.assert_array_equal(got["a.weight"], f32)
    onp.testing.assert_array_equal(bits, b16.view("int16"))


def test_partial_publish_invisible(tmp_path, net_a):
    """A version without its DONE sentinel, and a tmp directory, are not
    versions, to either package."""
    d = tmp_path / "w"
    treg.publish_weights(str(d), treg.snapshot_params(net_a[1]))
    partial = d / "weights-v0000000002"
    partial.mkdir()
    (partial / "manifest.json").write_text("{}")
    (d / "weights-v0000000003.tmp-1-2").mkdir()
    assert treg.weight_versions(str(d)) == jreg.weight_versions(str(d)) == [1]
    assert treg.read_weights(str(d))[0] == 1
    with pytest.raises(MXNetError, match="missing or incomplete"):
        treg.read_weights(str(d), 2)


@pytest.mark.parametrize("sharded", [False, True])
def test_publish_from_port_checkpoint(tmp_path, net_a, sharded):
    """A port checkpoint (either layout) publishes as a version whose
    params are the net's, with its source in the meta; the JAX package
    publishes the same directory to the same arrays."""
    tnet = net_a[1]
    mgr = CheckpointManager(str(tmp_path / "ckpt"), net=tnet, sharded=sharded)
    mgr.save(3, meta={"note": "x"})
    step_dir = mgr._step_dir(3)
    assert treg.publish_from_checkpoint(step_dir, str(tmp_path / "pub")) == 1
    assert jreg.publish_from_checkpoint(step_dir, str(tmp_path / "jpub")) == 1
    _, got, manifest = treg.read_weights(str(tmp_path / "pub"))
    _, jgot, jmanifest = jreg.read_weights(str(tmp_path / "jpub"))
    assert manifest["meta"] == jmanifest["meta"]
    assert manifest["meta"]["source_checkpoint"] == "step-0000000003"
    assert manifest["meta"]["source_step"] == 3
    want = {n: p.detach().numpy() for n, p in tnet.named_parameters()}
    assert set(got) == set(jgot) == set(want)
    for name in want:
        onp.testing.assert_array_equal(got[name], want[name])
        onp.testing.assert_array_equal(onp.asarray(jgot[name]), want[name])


def test_publish_from_checkpoint_healthy_only(tmp_path, net_a):
    """``healthy_only`` walks back past a checkpoint tagged unhealthy and
    raises when none is healthy."""
    import json
    mgr = CheckpointManager(str(tmp_path / "ckpt"), net=net_a[1], keep_last=5)
    for step in (1, 2):
        mgr.save(step)

    def taint(step):
        path = os.path.join(mgr._step_dir(step), "manifest.json")
        with open(path) as f:
            doc = json.load(f)
        doc["health"] = {"healthy": False}
        with open(path, "w") as f:
            json.dump(doc, f)

    taint(2)
    treg.publish_from_checkpoint(mgr._step_dir(2), str(tmp_path / "pub"), healthy_only=True)
    assert treg.read_weights(str(tmp_path / "pub"))[2]["meta"]["source_step"] == 1
    taint(1)
    with pytest.raises(MXNetError, match="no healthy checkpoint"):
        treg.publish_from_checkpoint(mgr._step_dir(2), str(tmp_path / "p2"), healthy_only=True)


def test_checkpoint_publish_bridges_to_engine(tmp_path, net_a, net_b):
    """CheckpointManager(publish_weights_dir=) mirrors a save into the
    publish layout and a WeightRefresher swaps a port engine to it."""
    pub = str(tmp_path / "pub")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), net=net_b[1], publish_weights_dir=pub)
    mgr.save(0)
    assert treg.latest_weight_version(pub) == 1
    eng = InferenceEngine(_pair(0)[1], max_batch_size=2, max_len=32)
    assert treg.WeightRefresher(eng, pub).check() == 1
    assert eng.weight_version == 1
    for name, p in net_b[1].named_parameters():
        torch.testing.assert_close(eng._params[name], p.detach(), rtol=0, atol=0)


def test_swap_validation_matches_jax(net_a, net_b):
    """Missing, extra and misshapen names raise JAX's messages before
    anything is staged; a fused engine refuses with JAX's message."""
    jeng = JaxEngine(net_a[0], max_batch_size=2, max_len=32)
    teng = InferenceEngine(_pair(0)[1], max_batch_size=2, max_len=32)
    good = _jax_params(net_b[0])
    missing = dict(good)
    missing.pop("wte.weight")
    extra = dict(good, **{"nope.weight": onp.zeros(3, "float32")})
    wrong = dict(good, **{"wpe.weight": onp.zeros((3, 3), "float32")})
    for bad in (missing, extra, wrong):
        msgs = []
        for eng in (jeng, teng):
            with pytest.raises(Exception) as ei:
                eng.swap_weights(bad)
            msgs.append(str(ei.value))
            assert eng.weight_version == 0
        assert msgs[1] == msgs[0]
    jf, tf = _pair(2, quantize=True)
    msgs = []
    for Eng, net in ((JaxEngine, jf), (InferenceEngine, tf)):
        with pytest.raises(Exception) as ei:
            Eng(net, max_batch_size=2, max_len=32, paged=False).swap_weights({})
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0] and "fused int8 decode" in msgs[0]


@pytest.mark.parametrize("paged", [False, True])
def test_live_swap_matches_fresh_engine_and_jax(tmp_path, net_a, net_b, paged):
    """After warm-up, a swap to net B (published, then loaded by
    ``swap_weights_from``) captures nothing, serves net B's tokens and
    scores (a fresh engine on B's), and JAX's engine after the same swap
    serves the same tokens."""
    kw = dict(max_batch_size=2, max_len=32)
    if paged:
        kw.update(paged=True, page_size=8)
    d = str(tmp_path / "w")
    treg.publish_weights(d, treg.snapshot_params(net_b[1]))
    teng = InferenceEngine(_pair(0)[1], name="gpt-main", **kw).start()
    jeng = JaxEngine(_pair(0)[0], **kw).start()
    ref = InferenceEngine(net_b[1], **kw).start()
    try:
        teng.warmup()
        teng.warmup_score()
        before = teng.generate(PROMPT, 8).generated_ids
        captures = teng.stats()["captures"]
        assert teng.swap_weights_from(d) == 1 == jeng.swap_weights_from(d)
        after = teng.generate(PROMPT, 8).generated_ids
        assert after != before
        assert after == ref.generate(PROMPT, 8).generated_ids
        assert after == jeng.generate(PROMPT, 8).generated_ids
        onp.testing.assert_array_equal(teng.score(PROMPT)["token_logprobs"],
                                       ref.score(PROMPT)["token_logprobs"])
        st = teng.stats()
        assert st["captures"] == captures
        assert st["weight_version"] == 1 and st["weight_swaps"] == 1
    finally:
        for eng in (teng, jeng, ref):
            eng.shutdown()


def test_swap_empties_the_prefix_cache(net_b):
    """A prompt served before a swap leaves pages in the prefix cache that
    the old weights computed; after the swap the same prompt prefills
    again and serves a fresh engine's tokens (the JAX engine keeps the
    cache, and would map the stale pages)."""
    prompt = list(range(3, 23))                    # two full pages of 8
    kw = dict(max_batch_size=2, max_len=48, paged=True, page_size=8)
    eng = InferenceEngine(_pair(0)[1], **kw).start()
    ref = InferenceEngine(net_b[1], **kw).start()
    try:
        eng.generate(prompt, 6)
        assert eng.stats()["pages"]["prefix_entries"] > 0
        eng.swap_weights(treg.snapshot_params(net_b[1]))
        assert eng.stats()["pages"]["prefix_entries"] == 0
        hits = eng.stats()["pages"]["prefix_hits"]
        assert eng.generate(prompt, 6).generated_ids == ref.generate(prompt, 6).generated_ids
        assert eng.stats()["pages"]["prefix_hits"] == hits
    finally:
        eng.shutdown()
        ref.shutdown()


def test_swap_quantized_unfused_matches_fresh_engine(net_b):
    """An int8 engine without fused packs swaps the float weights and
    derives its int8 tables again in place: it then serves what a fresh
    int8 engine over the new weights serves, tables bit for bit."""
    _, qa = _pair(0, quantize=False)
    _, qb = _pair(1, quantize=False)
    eng = InferenceEngine(qa, max_batch_size=2, max_len=32).start()
    ref = InferenceEngine(qb, max_batch_size=2, max_len=32).start()
    try:
        eng.warmup()
        tables = [m.w_q for m in qa.modules() if hasattr(m, "w_q")]
        eng.swap_weights(treg.snapshot_params(qb))
        assert [m.w_q for m in qa.modules() if hasattr(m, "w_q")][0] is tables[0]
        for ma, mb in zip(qa.modules(), qb.modules()):
            if hasattr(ma, "w_q"):
                assert torch.equal(ma.w_q, mb.w_q) and torch.equal(ma.w_scale, mb.w_scale)
        assert torch.equal(qa._q_lm_head[0], qb._q_lm_head[0])
        assert eng.generate(PROMPT, 8).generated_ids == ref.generate(PROMPT, 8).generated_ids
    finally:
        eng.shutdown()
        ref.shutdown()


@pytest.mark.parametrize("src_dtype", ["float16", "float32", "bfloat16"])
def test_swap_casts_to_the_live_dtype(net_b, src_dtype):
    """A set of another dtype is cast to each live parameter's dtype (a
    bf16 model keeps f32 layer norms), never reinterpreted: a float16 set
    is not viewed as bf16 bits. bf16 published as raw records comes back
    bit for bit. The engine then serves what a fresh engine on the cast
    weights serves."""
    import ml_dtypes
    cfg = GPTConfig(dtype=torch.bfloat16, **CFG)
    src = treg.snapshot_params(net_b[1])
    if src_dtype == "bfloat16":
        d = {n: a.astype(ml_dtypes.bfloat16) for n, a in src.items()}
        src = {n: treg._host_array(a)[0] for n, a in d.items()}          # raw records
        want = {n: torch.from_numpy(a.astype("float32")) for n, a in d.items()}
    else:
        src = {n: a.astype(src_dtype) for n, a in src.items()}
        want = {n: torch.from_numpy(a) for n, a in src.items()}
    live = GPTModel(cfg, device="cpu").init_weights(0)
    fresh = GPTModel(cfg, device="cpu").init_weights(0)
    with torch.no_grad():
        for n, p in fresh.named_parameters():
            p.copy_(want[n])
    eng = InferenceEngine(live, max_batch_size=2, max_len=32).start()
    ref = InferenceEngine(fresh, max_batch_size=2, max_len=32).start()
    try:
        before = eng.generate(PROMPT, 8).generated_ids
        eng.swap_weights(src)
        for (n, p), (_, q) in zip(live.named_parameters(), fresh.named_parameters()):
            assert p.dtype == q.dtype and torch.equal(p, q), n
        after = eng.generate(PROMPT, 8).generated_ids
        assert after != before
        assert after == ref.generate(PROMPT, 8).generated_ids
    finally:
        eng.shutdown()
        ref.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_swap_mid_flight_keeps_stream(net_b, paged):
    """A swap while a request decodes: the request completes its whole
    budget, and later requests serve the new weights."""
    kw = dict(max_batch_size=2, max_len=64)
    if paged:
        kw.update(paged=True, page_size=8)
    eng = InferenceEngine(_pair(0)[1], **kw).start()
    ref = InferenceEngine(net_b[1], **kw).start()
    eng._step_delay = 0.01
    try:
        h = eng.submit([1, 2, 3], 56, stream=True)
        while h.status == "queued":
            time.sleep(0.005)
        assert eng.swap_weights(treg.snapshot_params(net_b[1])) == 1
        res = h.result(120)
        assert res.status == "ok" and len(res.generated_ids) == 56
        assert eng.generate(PROMPT, 8).generated_ids == ref.generate(PROMPT, 8).generated_ids
    finally:
        eng.shutdown()
        ref.shutdown()


def test_swap_waiters_and_dead_loop(net_b):
    """Superseded staged versions still wake their waiters; a swap staged
    while the loop is down applies inline; a loop that died fails the
    waiter honestly."""
    eng = InferenceEngine(_pair(0)[1], max_batch_size=2, max_len=32)
    assert eng.swap_weights(treg.snapshot_params(net_b[1]), version=7) == 7
    assert eng.weight_version == 7
    eng.start()
    eng._swaps.append({"params": {}, "version": 8, "evt": __import__("threading").Event(),
                       "ok": False})
    assert eng.swap_weights(treg.snapshot_params(net_b[1]), version=9) == 9
    assert eng.weight_version == 9 and eng.stats()["weight_swaps"] == 2
    eng.shutdown()


def test_weight_refresher_pull(tmp_path, net_b):
    """The refresher does nothing until a version lands, then swaps once."""
    d = str(tmp_path / "w")
    eng = InferenceEngine(_pair(0)[1], max_batch_size=2, max_len=32)
    r = treg.WeightRefresher(eng, d, interval=None)
    assert r.check() is None
    treg.publish_weights(d, treg.snapshot_params(net_b[1]), meta={"health": {"healthy": True}})
    assert r.check() == 1 and eng.weight_version == 1
    assert eng.weight_health == {"healthy": True}
    assert r.check() is None
    treg.publish_weights(d, {"wte.weight": onp.zeros((2, 2), "float32")})
    assert r.check() is None and "missing" in r.last_error and eng.weight_version == 1


def test_registry_weights_endpoint(tmp_path, net_a, net_b):
    """POST /weights with a dir swaps the named model; without one the
    registry re-checks the model's weights directory."""
    import json
    import urllib.request
    d = str(tmp_path / "w")
    reg = ModelRegistry()
    alpha = InferenceEngine(_pair(0)[1], max_batch_size=2, max_len=32)
    beta = InferenceEngine(_pair(1)[1], max_batch_size=2, max_len=32)
    reg.add("alpha", alpha, weights_dir=d).add("beta", beta).start()
    fe = HTTPFrontend(reg, port=0).start()

    def post(path, doc):
        req = urllib.request.Request(fe.url + path, data=json.dumps(doc).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        treg.publish_weights(d, treg.snapshot_params(net_b[1]))
        assert post("/weights", {"dir": d, "model": "alpha"}) == \
            {"ok": True, "model": "alpha", "version": 1}
        treg.publish_weights(d, treg.snapshot_params(net_a[1]))
        assert post("/weights", {"model": "alpha"}) == {"ok": True, "refreshed": {"alpha": 2}}
        assert reg.versions() == {"alpha": 2, "beta": 0}
        with InferenceEngine(net_a[1], max_batch_size=1, max_len=32) as ref:
            want = ref.generate(PROMPT, 6).generated_ids
        assert post("/generate", {"input_ids": PROMPT, "max_new_tokens": 6,
                                  "model": "alpha"})["generated_ids"] == want
    finally:
        fe.stop()
        reg.shutdown()
