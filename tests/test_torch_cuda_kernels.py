"""The port's hand-written CUDA kernels (K3, K5, K8) against their plain
PyTorch versions on an NVIDIA GPU. Imports neither jax nor the JAX package,
so it runs on a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Everywhere else every test skips: a CUDA kernel has no CPU interpret mode.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops import int8_gemv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """Skip where no card is present: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel, no CPU interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def net(cuda):
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2,
                    num_heads=4, max_position_embeddings=128, dropout=0.0)
    model = GPTModel(cfg, device="cuda").init_weights(0, std=0.1)
    return quantize_net(model, fused_decode=True)


def _gemv_operands(M, N, K, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, device="cuda", generator=g)
    w = torch.randint(-127, 128, (N, K), device="cuda", generator=g,
                      dtype=torch.int8)
    s = torch.rand(N, device="cuda", generator=g) * 0.02 + 1e-3
    return x, w, s


@pytest.mark.parametrize("M", [1, 8, 13, 64])
@pytest.mark.parametrize("N,K", [(2304, 768), (768, 3072), (50304, 768)])
def test_int8_gemv_matches_plain(cuda, M, N, K):
    """f32 sums in another order: 1e-4 of the output scale."""
    x, w, s = _gemv_operands(M, N, K)
    got = int8_gemv.int8_weight_matmul(x, w, s)
    want = int8_gemv._reference_int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_int8_gemv_rows_are_batch_invariant(cuda):
    """A row's output does not depend on the rows batched with it."""
    x, w, s = _gemv_operands(9, 768, 768)
    full = int8_gemv.int8_weight_matmul(x, w, s)
    for r in (0, 4, 8):
        assert torch.equal(int8_gemv.int8_weight_matmul(x[r:r + 1], w, s),
                           full[r:r + 1])


def test_block_decode_matches_plain(net):
    """K5 against the plain block step: untouched cache rows bitwise, new
    rows and output to 1e-4 of the output scale; per-row results do not
    depend on the batch."""
    pack = fb.pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, D, H, L = 5, 256, 4, 128
    x = torch.randn(B, 1, D, device="cuda", generator=g)
    kc = torch.randn(B, H, L, D // H, device="cuda", generator=g) * 0.1
    vc = torch.randn(B, H, L, D // H, device="cuda", generator=g) * 0.1
    pos = torch.tensor([0, 5, 127, 64, 33], dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, _, _ = fb.fused_block_decode(x, pos, k1, v1, pack)
    want, _, _ = fb._reference_block_decode(x, pos, k2, v2, pack)
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (out - want).abs().max() <= tol
    written = torch.zeros(B, H, L, dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), :, pos.long()] = True
    for new, ref, old in ((k1, k2, kc), (v1, v2, vc)):
        assert torch.equal(new[~written], old[~written])
        assert (new - ref).abs().max() <= tol
    one, _, _ = fb.fused_block_decode(x[2:3], pos[2:3], kc[2:3].clone(),
                                      vc[2:3].clone(), pack)
    assert torch.equal(one, out[2:3])


def test_head_sampler_matches_plain_and_gemv(net):
    """K8 tokens equal the plain version's for greedy and T = 0.8 rows, and
    greedy rows equal the argmax of the K3 head logits bit for bit."""
    w_q, scale, vocab = net.head_weights()
    g = torch.Generator(device="cuda").manual_seed(2)
    B = 6
    h = torch.randn(B, w_q.shape[1], device="cuda", generator=g)
    kb = torch.from_numpy(gen._key_bits(onp.arange(B), onp.arange(B))).cuda()
    for temp in (0.0, 0.8):
        temps = torch.full((B,), temp, device="cuda")
        got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)
        plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb)
        assert torch.equal(got, plain)
    greedy = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb,
                                     torch.zeros(B, device="cuda"))
    logits = int8_gemv.int8_weight_matmul(h, w_q, scale)[:, :vocab]
    assert torch.equal(greedy.long(), logits.argmax(-1))


def test_generate_on_card_matches_across_heads(net):
    """Greedy ``generate`` on the card: the K3 head (multi_token=1) and the
    fused K8 head (multi_token=4) give the same tokens."""
    prompt = torch.randint(0, 1000, (2, 9), generator=torch.Generator().manual_seed(3))
    a = _generate(net, prompt, 1)
    b = _generate(net, prompt, 4)
    assert torch.equal(a, b)


def _generate(net, prompt, multi_token):
    return gen.generate(net, prompt, 20, multi_token=multi_token).cpu()
