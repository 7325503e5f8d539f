"""Port parity of K5 (one-launch block decode) and K8 (fused LM-head
sampler), their plain versions against the JAX package's reference and
interpret-mode Pallas kernels, and the PRNG pieces the sampler hashes
(``_hash_uniform`` and threefry ``fold_in`` key bits)."""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.ops import fused_block_gemv as jfb

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops.int8_gemv import count_launches



@pytest.fixture(scope="module")
def nets():
    """The fusable-shape int8 pair: ``tests/test_fused_decode.py``'s net256
    (vocab 256, hidden 256, 4 heads, 2 layers) and the port's GPT with the
    same weights, both quantized."""
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                               num_heads=4, max_position_embeddings=64,
                               dropout=0.0))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jax_quantize_net(jnet, calib_mode="none")
    tnet = GPTModel(GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                              num_heads=4, max_position_embeddings=64,
                              dropout=0.0), device="cpu")
    params_from_numpy(tnet, named)
    quantize_net(tnet)
    return jnet, tnet


def _fixture_inputs():
    """test_pallas_kernels_interpret_parity's decode-step inputs."""
    rng = onp.random.RandomState(0)
    B, D, H, L = 3, 256, 4, 16
    hd = D // H
    x = rng.randn(B, 1, D).astype("float32")
    kc = (rng.randn(B, H, L, hd) * 0.1).astype("float32")
    vc = (rng.randn(B, H, L, hd) * 0.1).astype("float32")
    pos = onp.array([3, 5, 2], "int32")
    return x, kc, vc, pos, rng


@pytest.fixture
def pallas_load_store(monkeypatch):
    """jax 0.9 dropped ``pl.load``/``pl.store``, which the JAX block kernel
    still calls; alias them to the ref indexing they performed while a
    test runs the kernel in interpret mode."""
    from jax.experimental import pallas as pl

    def _store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)


def test_plain_block_decode_matches_jax_reference_and_kernel(
        nets, pallas_load_store):
    """The plain K5 against both ``_reference_block_decode`` and the real
    Pallas kernel in interpret mode. Every cache element but the new row
    at ``pos`` must be untouched bit for bit, the new rows must land
    exactly at ``pos`` and hold the qkv values (f32 sums in another order:
    1e-5), and the block output must agree to 1e-4 (the tolerance of the
    JAX package's own kernel parity test)."""
    jnet, tnet = nets
    x, kc, vc, pos, _ = _fixture_inputs()
    pack = jfb.pack_gpt_block(list(jnet.blocks)[0], eps=jnet.cfg.layer_norm_eps)
    consts = jfb._consts(pack)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kc), jnp.asarray(vc),
            consts, 4, pack["eps"])
    ref = [onp.asarray(a) for a in jfb._reference_block_decode(*args)]
    ker = [onp.asarray(a) for a in jfb._pallas_block_decode(*args,
                                                            interpret=True)]
    tpack = fb.pack_gpt_block(tnet.blocks[0], eps=tnet.cfg.layer_norm_eps)
    with torch.no_grad():       # parameters are trainable; this is inference
        out, tkc, tvc = fb._reference_block_decode(
            torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()), tpack)
    written = onp.zeros(kc.shape, bool)
    for b, p in enumerate(pos):
        written[b, :, p] = True
    for want in (ref, ker):
        assert onp.abs(out.numpy() - want[0]).max() < 1e-4
        for got, exp, old in ((tkc.numpy(), want[1], kc), (tvc.numpy(), want[2], vc)):
            assert (got[~written] == exp[~written]).all()
            assert (got[~written] == old[~written]).all()
            assert onp.abs(got[written] - exp[written]).max() < 1e-5


def test_fused_equals_unfused_on_cpu(nets):
    """On a CPU tensor the fused block step replays the unfused op
    sequence: output and caches bitwise equal to the unfused block."""
    _, tnet = nets
    x, kc, vc, pos, _ = _fixture_inputs()
    blk = tnet.blocks[0]
    pack = fb.pack_gpt_block(blk, eps=tnet.cfg.layer_norm_eps)
    with count_launches() as tally:
        f_out, f_kc, f_vc = fb.fused_block_decode(
            torch.from_numpy(x), torch.from_numpy(pos),
            torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pack)
    assert tally == {"fused_block": 1}
    u_out, u_kc, u_vc = blk.forward_cached(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()))
    assert torch.equal(f_out, u_out)
    assert torch.equal(f_kc, u_kc) and torch.equal(f_vc, u_vc)


def test_hopper_gate():
    """GPT-2 small is fusable at L = 1024 (the TPU VMEM gate rejected it);
    shapes the kernel cannot tile are not, and the wrapper refuses them."""
    assert fb.fusable(8, 768, 12, 1024)
    assert fb.fusable(3, 256, 4, 16)
    assert not fb.fusable(8, 48, 4, 64)        # 16-byte int8 rows
    assert not fb.fusable(8, 768, 10, 64)      # D % heads
    assert not fb.fusable(8, 768, 192, 64)     # hd % 8
    assert not fb.fusable(8, 16384, 16, 64)    # 8 x 4D f32 tile > 227 KB
    x, kc, vc, pos, _ = _fixture_inputs()
    with pytest.raises(MXNetError, match="not fusable"):
        fb.fused_block_decode(torch.zeros(3, 2, 256), pos, torch.from_numpy(kc),
                              torch.from_numpy(vc), {"heads": 4})


def test_hash_uniform_bitwise():
    rng = onp.random.RandomState(1)
    keys = rng.randint(0, 2 ** 32, (7, 1), dtype=onp.uint64).astype(onp.uint32)
    lanes = onp.arange(300, dtype=onp.int32)[None, :] * 173
    want = onp.asarray(jfb._hash_uniform(jnp.asarray(keys), jnp.asarray(lanes)))
    got = fb._hash_uniform(torch.from_numpy(keys.astype(onp.int64)),
                           torch.from_numpy(lanes)).numpy()
    assert got.dtype == onp.float32
    assert (got == want).all()


def test_fold_keys_bitwise():
    """The port's threefry ``fold_in(key(seed), counter)`` key data equals
    JAX's, and so do the key bits the fused head hashes."""
    rng = onp.random.RandomState(2)
    seeds = onp.concatenate([[0, 1, 0xFFFFFFFF],
                             rng.randint(0, 2 ** 32, 13, dtype=onp.uint64)
                             ]).astype(onp.uint32)
    counters = rng.randint(0, 2 ** 31 - 1, seeds.shape[0]).astype(onp.int32)
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.key(s), c))(
        jnp.asarray(seeds), jnp.asarray(counters))
    want = onp.asarray(jax.random.key_data(keys)).reshape(len(seeds), -1)
    got = gen._fold_keys(seeds, counters)
    assert got.dtype == onp.uint32
    assert (got == want).all()
    assert (gen._key_bits(seeds, counters)
            == (want[:, -2] ^ want[:, -1]).astype(onp.int64)).all()


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_plain_head_sampler_matches_jax_kernel(nets, temp):
    """The plain K8 against the real ``_head_kernel`` in interpret mode,
    given the same key bits: identical tokens for greedy rows and for
    T = 0.8 rows (same hash-Gumbel noise); greedy rows are also the exact
    argmax of the head logits."""
    jnet, tnet = nets
    w_q, scale, V = jnet._q_lm_head
    rng = onp.random.RandomState(4)
    B = 6
    h = rng.randn(B, 256).astype("float32")
    kb = gen._key_bits(onp.arange(B) + 11, onp.full(B, 3))
    temps = onp.full(B, temp, "float32")
    want = onp.asarray(jfb._head_kernel(
        jnp.asarray(h), w_q, scale, V, jnp.asarray(temps),
        jnp.asarray(kb.astype(onp.uint32)), interpret=True))
    tw, ts, tv = tnet.head_weights()
    with count_launches() as tally:
        got = fb.fused_lm_head_sample(torch.from_numpy(h), tw, ts, tv,
                                      torch.from_numpy(kb),
                                      torch.from_numpy(temps)).numpy()
    assert tally == {"fused_head": 1}
    assert (got == want).all()
    assert (got < V).all()
    if temp == 0.0:
        logits = torch.from_numpy(h) @ (tw.float() * ts[:, None]).T
        assert (got == logits[:, :V].argmax(-1).numpy()).all()


def test_filtered_sampling_and_masks_raise(nets):
    """A batch with a top-k/top-p row takes the reference's other branch:
    ``sample_tokens`` on the head GEMV's logits cut to the vocab, with the
    rows' keys (and no K8 launch); [B] key bits cannot drive it. A grammar
    mask goes with the logits to ``sample_tokens`` on that branch and is
    folded into K8's selection on the other."""
    from mxnet_tpu_torch import _prng
    _, tnet = nets
    tw, ts, tv = tnet.head_weights()
    rng = onp.random.RandomState(5)
    h = torch.from_numpy(rng.randn(3, 256).astype("float32"))
    keys = _prng.fold_keys([5, 6, 7], [2, 2, 2])
    temps = torch.tensor([0.9, 0.0, 1.2])
    topks, topps = onp.array([5, 0, 0]), onp.array([1.0, 1.0, 0.8], "float32")
    with count_launches() as tally:
        got = fb.fused_lm_head_sample(h, tw, ts, tv, keys, temps, topks, topps)
    assert "fused_head" not in tally and tally["gemv"] == 1
    logits = (h @ (tw.float() * ts[:, None]).T)[:, :tv]
    want = gen.sample_tokens(logits, keys, temps, topks, topps)
    assert (got == want).all()
    with pytest.raises(MXNetError, match="keys"):
        fb.fused_lm_head_sample(h, tw, ts, tv, keys[:, 0] ^ keys[:, 1], temps, topks=5)
    mask = torch.from_numpy(rng.rand(3, tv) < 0.3)
    got = fb.fused_lm_head_sample(h, tw, ts, tv, keys, temps, topks, topps, mask=mask)
    assert (got == gen.sample_tokens(logits, keys, temps, topks, topps, mask=mask)).all()
    assert mask[torch.arange(3), got.long()].all()
    greedy = fb.fused_lm_head_sample(h[:2], tw, ts, tv, keys[:2], torch.zeros(2), mask=mask[:2])
    assert (greedy.long() == logits[:2].masked_fill(~mask[:2], float("-inf")).argmax(-1)).all()
