"""The port's hand-written CUDA kernels (K1, K2, K3, K5, K8) against their plain
PyTorch versions on an NVIDIA GPU. Imports neither jax nor the JAX package,
so it runs on a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Everywhere else every test skips: a CUDA kernel has no CPU interpret mode.
"""
import numpy as onp
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.ops import attention as fa
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


# (B, H, T, S, D, causal) of chip_smoke's kernel phase, at a smaller B
_FLASH_SHAPES = [(2, 3, 1024, 1024, 64, True), (1, 2, 1000, 1000, 64, True),
                 (1, 2, 256, 512, 64, True), (1, 2, 384, 384, 40, False),
                 (1, 2, 300, 300, 128, True), (1, 1, 256, 256, 256, False)]


def _flash_operands(B, H, T, S, D, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, H, T, D, device="cuda", generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dtype) for _ in range(2))
    return q, k, v, do


def _within(got, want, dtype):
    """``chip_smoke``'s rule: max abs error within 1e-4 (f32) or 2e-2
    (bf16) of max(1, max |want|), and every row within 3e-4 or 1e-2 of its
    own size (``chip_smoke.flash_errors``)."""
    return chip_smoke.flash_within(got, want, str(dtype).replace("torch.", ""))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,S,D,causal", _FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, B, H, T, S, D, causal, dtype):
    """K1 and K2 against their plain versions by ``chip_smoke``'s rule, the
    plain version run in f32 on the same inputs. Each output (o, lse, dq,
    dk, dv) separately."""
    q, k, v, do = _flash_operands(B, H, T, S, D, dtype)
    scale = D ** -0.5
    o, lse = fa.flash_forward(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    po, plse = fa._reference_flash_forward(f[0], f[1], f[2], causal, scale)
    # the backward's plain version from the kernel's own o and lse, so the
    # comparison isolates K2
    pdq, pdk, pdv = fa._reference_flash_backward(f[0], f[1], f[2], o.float(), lse, f[3],
                                                 causal, scale)
    for name, got, want in (("o", o, po), ("lse", lse, plse), ("dq", dq, pdq),
                            ("dk", dk, pdk), ("dv", dv, pdv)):
        assert got.dtype == (torch.float32 if name == "lse" else dtype), name
        assert torch.isfinite(got).all(), name
        assert _within(got, want, dtype), name


def test_flash_backward_repeats_bitwise(cuda):
    """No atomics: two backward runs give the same bits."""
    q, k, v, do = _flash_operands(1, 2, 512, 512, 64, torch.bfloat16, seed=3)
    o, lse = fa.flash_forward(q, k, v, True, 0.125)
    a = fa.flash_backward(q, k, v, o, lse, do, True, 0.125)
    b = fa.flash_backward(q, k, v, o, lse, do, True, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_autograd_launches_kernels(cuda):
    """``flash_attention`` on CUDA tensors of an eligible shape runs K1
    forward and K2 backward once each; its gradients match autograd of the
    plain attention in f32."""
    q, k, v, do = _flash_operands(1, 2, 256, 256, 64, torch.float32, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    int8_gemv.reset_launches()
    out = fa.flash_attention(*leaves, causal=True)
    out.backward(do)
    counts = int8_gemv.launches()
    assert counts.get("flash_fwd") == 1 and counts.get("flash_bwd") == 1
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want, _ = fa._reference_flash_forward(*ref, True, 0.125)
    want.backward(do)
    assert _within(out.detach(), want.detach(), torch.float32)
    for a, b in zip(leaves, ref):
        assert _within(a.grad, b.grad, torch.float32)
