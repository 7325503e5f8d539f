"""The port's hand-written CUDA kernels (K1, K2, K3, K4, K5, K6, K7, K8, the
int4 weight lanes of K5-K8, and the bf16 activation and cache lanes of
K3-K7) against their plain PyTorch versions on an NVIDIA GPU. Imports neither jax nor the JAX package, so it runs on a machine
with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Everywhere else every test skips: a CUDA kernel has no CPU interpret mode.
"""
import gc

import numpy as onp
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import _build
from mxnet_tpu_torch import numpy_extension as npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.ops import attention as fa
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops import int8_gemv
from mxnet_tpu_torch.serve import InferenceEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """Skip where no card is present: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel, no CPU interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(params=[8, 4], ids=["int8", "int4"])
def net(cuda, request):
    """A small GPT on the card, quantized to the int8 or the packed int4
    weight lane, with fused decode."""
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2,
                    num_heads=4, max_position_embeddings=128, dropout=0.0)
    model = GPTModel(cfg, device="cuda").init_weights(0, std=0.1)
    return quantize_net(model, fused_decode=True, bits=request.param)


def _gemv_operands(M, N, K, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, device="cuda", generator=g)
    w = torch.randint(-127, 128, (N, K), device="cuda", generator=g,
                      dtype=torch.int8)
    s = torch.rand(N, device="cuda", generator=g) * 0.02 + 1e-3
    return x, w, s


# row counts of both routes: the warp route up to 8 rows, the tile route
# (tensor cores, x as three bf16 planes) from 9 to gemv_max_m() = 64
_GEMV_ROWS = [1, 8, 9, 13, 16, 33, 64]


@pytest.mark.parametrize("M", _GEMV_ROWS)
@pytest.mark.parametrize("N,K", [(2304, 768), (768, 3072), (50304, 768)])
def test_int8_gemv_matches_plain(cuda, M, N, K):
    """f32 sums in another order (the tile route: exact products of bf16
    planes and codes, summed by the tensor cores in f32): 1e-4 of the
    output scale."""
    x, w, s = _gemv_operands(M, N, K)
    got = int8_gemv.int8_weight_matmul(x, w, s)
    want = int8_gemv._reference_int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _rows_case(fn, x, w, s, case):
    """The port's batch-invariance contract on one route. warp: rows of an
    8-row call equal 1-row calls bit for bit (the dot order K8 shares).
    tile: rows of 9- and 16-row calls equal the same rows of a 64-row call
    bit for bit. cross: the two routes agree to 1e-4 of the output scale
    (same products, summed in another order)."""
    if case == "warp":
        full = fn(x[:8], w, s)
        for r in (0, 4, 7):
            assert torch.equal(fn(x[r:r + 1], w, s), full[r:r + 1])
    elif case == "tile":
        full = fn(x, w, s)
        for M in (9, 16):
            assert torch.equal(fn(x[:M], w, s), full[:M])
    else:
        tile = fn(x[:9], w, s)
        warp = torch.cat([fn(x[r:r + 1], w, s) for r in range(9)])
        tol = 1e-4 * max(1.0, warp.abs().max().item())
        assert (tile - warp).abs().max() <= tol


@pytest.mark.parametrize("case", ["warp", "tile", "cross"])
def test_int8_gemv_rows_are_batch_invariant(cuda, case):
    """A row's output does not depend on the rows batched with it within a
    route (bitwise), and the two routes agree to rounding."""
    x, w, s = _gemv_operands(64, 768, 768)
    _rows_case(int8_gemv.int8_weight_matmul, x, w, s, case)


def _int4_operands(M, N, K, seed=0):
    """x and the packed int4 table of an N(0, 1) weight, as
    ``quantize_net(bits=4)`` stores it (block 128, or K)."""
    from mxnet_tpu_torch.contrib.quantization import _quantize_int4
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, device="cuda", generator=g)
    return (x, *_quantize_int4(torch.randn(N, K, device="cuda", generator=g)))


@pytest.mark.parametrize("M", _GEMV_ROWS)
@pytest.mark.parametrize("N,K", [(2304, 768), (768, 3072), (50304, 768), (384, 96)])
def test_int4_gemv_matches_plain(cuda, M, N, K):
    """K4 against its plain version (the codec's dequantized weights, then
    an f32 matmul): f32 sums in another order, 1e-4 of the output scale."""
    x, w, s = _int4_operands(M, N, K)
    got = int8_gemv.int4_weight_matmul(x, w, s)
    want = int8_gemv._reference_int4_matmul(x, w, s)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("case", ["warp", "tile", "cross"])
def test_int4_gemv_rows_are_batch_invariant_and_gated(cuda, case):
    """A row's K4 output does not depend on the rows batched with it within
    a route (bitwise), and the two routes agree to rounding; a block that
    would split a lane's 16 codes raises instead of running."""
    x, w, s = _int4_operands(64, 768, 768)
    _rows_case(int8_gemv.int4_weight_matmul, x, w, s, case)
    with pytest.raises(MXNetError, match="block % 16"):
        int8_gemv.int4_weight_matmul(x[:9], w, s.repeat_interleave(16, dim=1))    # block 8


@pytest.mark.parametrize("bits", [8, 4])
def test_gemv_tile_route_repeats_bitwise(cuda, bits):
    """No float atomics: two launches of the tile route give the same bits,
    at a shape whose K is split across a cluster (N 768) and at the head."""
    for N, K in ((768, 3072), (50304, 768)):
        x, w, s = (_gemv_operands if bits == 8 else _int4_operands)(64, N, K)
        fn = int8_gemv.weight_matmul
        assert torch.equal(fn(x, w, s), fn(x, w, s))


def test_gemv_tile_route_raises_on_shapes_it_cannot_take(cuda):
    """K not a whole number of 32-code k-tiles, or an int4 block that is
    not: 9 or more rows raise (no fallback to the warp route or the plain
    version), 8 rows take the warp route; the routes count launches only,
    so the two refused calls count nothing."""
    from mxnet_tpu_torch.contrib.quantization import _quantize_rows
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(9, 48, device="cuda", generator=g)
    w, s = _quantize_rows(torch.randn(64, 48, device="cuda", generator=g))
    int8_gemv.reset_launches()
    int8_gemv.int8_weight_matmul(x[:8], w, s)
    with pytest.raises(MXNetError, match="multiples of 32"):
        int8_gemv.int8_weight_matmul(x, w, s)
    x, w, s = _int4_operands(9, 64, 96)
    w48 = s.repeat_interleave(2, dim=1)       # block 48: whole 16-code chunks
    int8_gemv.int4_weight_matmul(x[:8], w, w48)
    with pytest.raises(MXNetError, match="multiples of 32"):
        int8_gemv.int4_weight_matmul(x, w, w48)
    int8_gemv.int4_weight_matmul(x, w, s)
    torch.cuda.synchronize()
    assert int8_gemv.gemv_routes() == {"warp": 2, "mma": 1}
    assert int8_gemv.launches() == {"gemv": 1, "gemv_int4": 2}


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
    greedy rows equal the argmax of the K3 (int8) or K4 (int4) head logits
    bit for bit."""
    w_q, scale, vocab = net.head_weights()
    g = torch.Generator(device="cuda").manual_seed(2)
    B = 6
    h = torch.randn(B, net.cfg.hidden_size, device="cuda", generator=g)
    kb = torch.from_numpy(gen._key_bits(onp.arange(B), onp.arange(B))).cuda()
    for temp in (0.0, 0.8):
        temps = torch.full((B,), temp, device="cuda")
        got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)
        plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb)
        assert torch.equal(got, plain)
    greedy = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb,
                                     torch.zeros(B, device="cuda"))
    logits = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab]
    assert torch.equal(greedy.long(), logits.argmax(-1))


def test_generate_on_card_matches_across_heads(net):
    """Greedy ``generate`` on the card: the K3 or K4 head (multi_token=1) and
    the fused K8 head (multi_token=4) give the same tokens."""
    prompt = torch.randint(0, 1000, (2, 9), generator=torch.Generator().manual_seed(3))
    a = _generate(net, prompt, 1)
    b = _generate(net, prompt, 4)
    assert torch.equal(a, b)


def _generate(net, prompt, multi_token):
    return gen.generate(net, prompt, 20, multi_token=multi_token).cpu()


@pytest.mark.parametrize("maxp,pos,streamed", [
    (8, [100, 127, 40, 9, 0], False),      # L 128: K6
    (32, [511, 300, 64, 17, 0], True),     # L 512: past K6's gate, K7
])
def test_paged_block_decode_matches_plain(net, maxp, pos, streamed):
    """K6 / K7 against the plain paged block step by ``chip_smoke``'s
    rule: untouched pool rows bitwise, new rows and output to 1e-4 of the
    output scale; K7's copies started == waited == the ``record_dma``
    ledger. Scattered tables, two rows sharing pages, an inactive row."""
    pack = fb.pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
    g = torch.Generator(device="cuda").manual_seed(5)
    inputs = chip_smoke.paged_inputs(torch, g, 256, 4, len(pos), 16, maxp, 80, pos)
    chip_smoke.check_paged(torch, fb, "K7" if streamed else "K6", inputs, pack,
                           streamed, 80, 16)


def test_paged_kernels_give_k5_bits(net):
    """K6 and K7 on one input give the same output and pools bit for bit,
    and K5 on the gathered contiguous view gives the same output."""
    pack = fb.pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
    g = torch.Generator(device="cuda").manual_seed(6)
    chip_smoke.same_bits_k5_k6_k7(torch, fb, g, pack, 80, 16, [100, 127, 40, 9, 0],
                                  maxp=8)


def test_paged_wrapper_raises_on_shapes_no_gate_takes(net):
    """No fallback on the card: f64 pools fail both gates, and f16 pools
    (itemsize 2, which the gates take for bf16) reach a kernel that takes
    f32 or bf16 only, so the wrappers raise instead of running the plain
    version; an f16 contiguous cache raises in K5's wrapper too."""
    pack = fb.pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
    g = torch.Generator(device="cuda").manual_seed(7)
    x, posv, table, kp, vp = chip_smoke.paged_inputs(torch, g, 256, 4, 3, 16, 8, 20,
                                                      [40, 33, 0])
    with pytest.raises(MXNetError, match="not fusable"):
        fb.fused_block_decode_paged(x, posv, table, kp.double(), vp.double(), pack)
    with pytest.raises(MXNetError, match="f32 or bf16"):
        fb.fused_block_decode_paged(x, posv, table, kp.half(), vp.half(), pack)
    kc = torch.zeros(3, 4, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(MXNetError, match="f32 or bf16"):
        fb.fused_block_decode(x, posv, kc, kc.clone(), pack)
    with pytest.raises(MXNetError, match="f32 or bf16"):
        int8_gemv.weight_matmul(x[:, 0].half(), *pack["qkv"][:2])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("max_len,kind", [(128, "fused_block_paged"),
                                          (512, "fused_block_paged_dma")])
def test_paged_engine_on_card(cuda, max_len, kind, bits):
    """The paged engine on the card (K6 at L 128, K7 at L 512, K8 head), in
    either weight lane: every decode substep launches the kernel once per
    block, and greedy tokens equal the engine's arithmetic on the
    contiguous layout (chunked prefill, K5 decode), bit for bit; the pool
    drains to zero."""
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=512, dropout=0.0)
    model = quantize_net(GPTModel(cfg, device="cuda").init_weights(0, std=0.1),
                         fused_decode=True, bits=bits)
    kind += "_int4" if bits == 4 else ""
    rng = onp.random.RandomState(8)
    prompts = [rng.randint(0, 1000, n).tolist() for n in (5, 37, 70, 12, 21)]
    int8_gemv.reset_launches()
    eng = InferenceEngine(model, max_batch_size=4, max_len=max_len, multi_token=4,
                          page_size=16).start()
    try:
        res = [h.result(timeout=300) for h in [eng.submit(p, 24) for p in prompts]]
    finally:
        eng.shutdown(timeout=300)
    stats = eng.stats()
    assert stats["paged"] and all(r.ok for r in res)
    assert int8_gemv.launches()[kind] == 2 * stats["decode_substeps"]
    for p, r in zip(prompts, res):
        assert r.generated_ids == chip_smoke.chunked_reference(torch, model, p, 24, 16,
                                                               max_len)
    eng._pages.clear_prefix_cache()
    assert eng._pages.pages_in_use() == 0


def test_paged_engine_preempts_and_resumes_on_card(cuda):
    """An 8-page pool (one max_len request) under four requests that need
    about 20 pages: decode growth preempts requests that have generated
    tokens, and their resume re-prefills prompt + generated. Tokens equal
    the uninterrupted contiguous arithmetic, or at a first divergence the
    top-2 gap is below 1e-3 (a resume recomputes the generated tokens' K/V
    rows by prefill instead of by K6)."""
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=128, dropout=0.0)
    model = quantize_net(GPTModel(cfg, device="cuda").init_weights(0, std=0.1),
                         fused_decode=True)
    rng = onp.random.RandomState(9)
    prompts = [rng.randint(0, 1000, n).tolist() for n in (10, 14, 7, 12)]
    eng = InferenceEngine(model, max_batch_size=4, max_len=64, multi_token=4, page_size=8,
                          num_pages=8, prefix_cache=False).start()
    try:
        res = [h.result(timeout=300) for h in [eng.submit(p, 30) for p in prompts]]
    finally:
        eng.shutdown(timeout=300)
    stats = eng.stats()
    assert all(r.ok for r in res)
    assert stats["preemptions"] > 0 and stats["resumed_tokens"] > 0
    for p, r in zip(prompts, res):
        ref = chip_smoke.chunked_reference(torch, model, p, 30, 8, 64)
        d = chip_smoke.first_divergence(ref, r.generated_ids)
        assert d is None or chip_smoke.chunked_gap(torch, model, p + ref[:d], 8, 64) < 1e-3


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("D,H,ps,maxp", [(768, 12, 16, 16), (768, 12, 16, 64),
                                         (256, 4, 8, 40), (1024, 8, 32, 8),
                                         (512, 4, 4, 100)])
def test_paged_smem_matches_python_gates(cuda, D, H, ps, maxp, B):
    """The kernels' own shared-memory arithmetic is the Python gates', for
    f32 and bf16 caches, at 8 rows and at 16 (the 16-row weight tile): K5's
    slot rows and bytes, K6's slots and bytes, K7's pages a slot and
    bytes."""
    k5 = _build.library("fused_block_decode")
    k6 = _build.library("fused_block_decode_paged")
    k7 = _build.library("fused_block_decode_paged_dma")
    L = ps * maxp
    for it in (4, 2):
        assert k5.mx_fused_block_slot_rows(D, H, L, it) == fb._slab_rows(D, H, L, it)
        assert k5.mx_fused_block_smem(B, D, H, L, it) == fb._block_smem(D, H, L, it, B)
        depth = fb._paged_depth(D, H, L, it, B)
        assert k6.mx_paged_depth(B, D, H, ps, maxp, it) == depth
        assert k6.mx_paged_smem(B, D, H, ps, maxp, it) == (
            fb._paged_smem(D, H, L, it, B) if depth else 0)
        assert (k7.mx_paged_dma_smem(B, D, H, ps, maxp, 2, it)
                == fb._paged_dma_smem(D, H, ps, L, 2, it, B))
        assert (k7.mx_paged_dma_tile_pages(D, H, ps, maxp, 2, it)
                == fb._dma_tile_pages(D, H, ps, L, 2, it))


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


# the wgmma bodies' shapes: the training shape, a ragged length, end-aligned
# causal, head dims 40 and 20 (zero-padded to a multiple of 8 by the
# wrappers) and 128, and B * H large enough to fill every SM several times
_FLASH_WGMMA_SHAPES = [(16, 12, 1024, 1024, 64, True), (2, 12, 1000, 1000, 64, True),
                       (2, 12, 256, 512, 64, True), (2, 12, 1024, 1024, 40, False),
                       (1, 2, 512, 512, 20, True), (2, 8, 1024, 1024, 128, True),
                       (64, 16, 512, 512, 64, False)]


@pytest.mark.parametrize("B,H,T,S,D,causal", _FLASH_WGMMA_SHAPES)
def test_flash_wgmma_bodies_match_plain_and_repeat(cuda, B, H, T, S, D, causal):
    """The bf16 wgmma bodies of K1 and K2 (TMA tiles, K2's ordered one
    sweep) against their plain versions by ``chip_smoke``'s rule (1e-2 per
    row), and K2 twice on the same inputs: the same bits."""
    q, k, v, do = _flash_operands(B, H, T, S, D, torch.bfloat16, seed=5)
    scale = D ** -0.5
    o, lse = fa.flash_forward(q, k, v, causal, scale)
    grads = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    again = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    f = [t.float() for t in (q, k, v, do)]
    po, plse = fa._reference_flash_forward(f[0], f[1], f[2], causal, scale)
    pdq, pdk, pdv = fa._reference_flash_backward(f[0], f[1], f[2], o.float(), lse, f[3],
                                                 causal, scale)
    for name, got, want in (("o", o, po), ("lse", lse, plse), ("dq", grads[0], pdq),
                            ("dk", grads[1], pdk), ("dv", grads[2], pdv)):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        assert _within(got, want, torch.bfloat16), name


def test_prng_on_card_matches_cpu(cuda):
    """JAX's sampling stream on the card: threefry bits bitwise equal to the
    CPU's, and ``sample_tokens`` (greedy, plain, top-k and top-p rows) and a
    split-chain ``categorical`` give the CPU's tokens on the same logits."""
    from mxnet_tpu_torch import _prng
    rng = onp.random.RandomState(3)
    B, V = 8, 50257
    logits = (rng.randn(B, V) * 3).astype("float32")
    temps = onp.array([0.0, 0.8, 1.0, 0.7, 1.3, 0.0, 0.9, 1.1], "float32")
    topks = onp.array([0, 0, 40, 0, 200, 5, 0, 1000])
    topps = chip_smoke.nucleus_away_from_edges(onp, logits, temps, topks, (3, 4, 7))
    seeds, counters = onp.arange(B) * 101, onp.arange(B) * 7
    kc = _prng.fold_keys(seeds, counters)
    kd = _prng.fold_keys(seeds, counters, "cuda")
    assert torch.equal(kd.cpu(), kc)
    for shape in ((V,), (3, 1000)):
        assert torch.equal(_prng.random_bits(kd, shape).cpu(), _prng.random_bits(kc, shape))
    assert torch.equal(_prng.uniform(kd, (V,)).cpu(), _prng.uniform(kc, (V,)))
    lc, ld = torch.from_numpy(logits), torch.from_numpy(logits).cuda()
    want = gen.sample_tokens(lc, kc, temps, topks, topps)
    assert torch.equal(gen.sample_tokens(ld, kd, temps, topks, topps).cpu(), want)
    key = _prng.split(_prng.key(9))[1]
    assert torch.equal(_prng.categorical(key.cuda(), ld).cpu(), _prng.categorical(key, lc))


def test_filtered_head_batch_on_card(net):
    """A fused-head batch with a top-k row takes ``sample_tokens`` on the
    head GEMV's logits on the card too (no K8 launch), and agrees with the
    same call on the CPU copies."""
    from mxnet_tpu_torch import _prng
    w_q, scale, vocab = net.head_weights()
    g = torch.Generator(device="cuda").manual_seed(6)
    B = 4
    h = torch.randn(B, net.cfg.hidden_size, device="cuda", generator=g)
    keys = _prng.fold_keys(onp.arange(B), onp.full(B, 5), "cuda")
    temps = torch.tensor([0.0, 0.9, 1.0, 0.7], device="cuda")
    int8_gemv.reset_launches()
    got = fb.fused_lm_head_sample(h, w_q, scale, vocab, keys, temps, [0, 20, 0, 3], 1.0)
    counts = int8_gemv.launches()
    assert not any(k.startswith("fused_head") for k in counts)
    logits = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab]
    want = gen.sample_tokens(logits.cpu(), keys.cpu(), temps.cpu(), [0, 20, 0, 3], 1.0)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# bf16 lanes (block 0 of a bf16 model: bf16 x; every block: bf16 caches)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 64])
def test_gemv_bf16_lane_is_the_f32_lane_on_widened_x(cuda, bits, M):
    """K3/K4 on bf16 x: the f32 lane's output on x.float() bit for bit, on
    the warp route (x widened as it is staged) and the tile route (x its
    own single plane), and within 1e-4 of the plain version's scale."""
    N, K = 2304, 768
    x, w, s = (_gemv_operands if bits == 8 else _int4_operands)(M, N, K, seed=M)
    xb = x.bfloat16()
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    plain = int8_gemv._reference_int8_matmul if bits == 8 else int8_gemv._reference_int4_matmul
    int8_gemv.reset_launches()
    got = fn(xb, w, s)
    wide = fn(xb.float(), w, s)
    want = plain(xb, w, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), wide.view(torch.int32))
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    kind = "gemv" if bits == 8 else "gemv_int4"
    assert int8_gemv.dtype_lanes()[f"{kind}:{int8_gemv.gemv_route(M)}:bf16"] == 1


@pytest.fixture(params=[8, 4], ids=["int8", "int4"])
def pack(cuda, request):
    """Block 0's pack of a small GPT on the card (hidden 256, hd 64),
    quantized to the int8 or the int4 weight lane."""
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=1,
                    num_heads=4, max_position_embeddings=128, dropout=0.0)
    model = GPTModel(cfg, device="cuda").init_weights(0, std=0.1)
    quantize_net(model, fused_decode=True, bits=request.param)
    return fb.pack_gpt_block(model.blocks[0], eps=cfg.layer_norm_eps)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["x_bf16", "x_f32"])
def test_block_decode_bf16_caches_match_plain(pack, x_dtype):
    """K5 with bf16 caches, at bf16 x (block 0) and f32 x (later blocks),
    against the plain version by ``chip_smoke.hold_block``'s bf16 rule:
    untouched rows bitwise, written rows within one bf16 ulp, the output
    within one bf16 rounding of its scale; a row alone gives its batched
    bits."""
    g = torch.Generator(device="cuda").manual_seed(11)
    B, D, H, L = 5, 256, 4, 128
    x = torch.randn(B, 1, D, device="cuda", generator=g).to(x_dtype)
    kc = (torch.randn(B, H, L, D // H, device="cuda", generator=g) * 0.1).bfloat16()
    vc = (torch.randn(B, H, L, D // H, device="cuda", generator=g) * 0.1).bfloat16()
    pos = torch.tensor([0, 5, 127, 64, 33], dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    int8_gemv.reset_launches()
    out, _, _ = fb.fused_block_decode(x, pos, k1, v1, pack)
    want, _, _ = fb._reference_block_decode(x, pos, k2, v2, pack)
    torch.cuda.synchronize()
    written = torch.zeros(B, H, L, dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), :, pos.long()] = True
    chip_smoke.hold_block(torch, "K5 bf16", out, want, (k1, v1), (k2, v2), (kc, vc), written)
    xl = "bf16" if x_dtype == torch.bfloat16 else "f32"
    kind = "fused_block" + fb._kind_suffix(pack)
    assert int8_gemv.dtype_lanes() == {f"{kind}:x_{xl}:kv_bf16": 1}
    one, _, _ = fb.fused_block_decode(x[2:3], pos[2:3], kc[2:3].clone(), vc[2:3].clone(), pack)
    assert torch.equal(one, out[2:3])


@pytest.mark.parametrize("maxp,pos,streamed", [
    (8, [100, 127, 40, 9, 0], False),      # L 128: K6
    (64, [1023, 300, 64, 17, 0], True),    # L 1024: past K6's bf16 gate (864), K7
])
def test_paged_block_decode_bf16_matches_plain(pack, maxp, pos, streamed):
    """K6 / K7 on bf16 x and bf16 pools against the plain paged step by
    ``chip_smoke.check_paged``'s rule (bf16: written rows within one ulp,
    the output within one bf16 rounding of its scale); K7's copies started
    == waited == the ledger at bf16 slabs (ps * hd * 2 bytes)."""
    g = torch.Generator(device="cuda").manual_seed(12)
    pool = 200                                # the rows' 90 pages, scattered
    inputs = chip_smoke.paged_inputs(torch, g, 256, 4, len(pos), 16, maxp, pool, pos,
                                     torch.bfloat16)
    row = chip_smoke.check_paged(torch, fb, "K7" if streamed else "K6", inputs, pack,
                                 streamed, pool, 16)
    if streamed:
        assert row["dma_ledger"]["bytes"] == row["dma_ledger"]["copies"] * 16 * 64 * 2


def test_paged_kernels_give_k5_bits_in_bf16(pack):
    """K5, K6 and K7 on one bf16 input (bf16 x, bf16 pools and the gathered
    bf16 caches) give the same output and pools bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(13)
    chip_smoke.same_bits_k5_k6_k7(torch, fb, g, pack, 80, 16, [100, 127, 40, 9, 0],
                                  maxp=8, dtype=torch.bfloat16)


def test_bf16_engine_on_card(cuda):
    """A bf16 GPT quantized int8 with naive calibration on the card: paged
    (bf16 pools, K6) and contiguous (bf16 caches, K5) engines give the
    greedy tokens of ``generate()``; the KV state is bf16, two bytes a
    value, and both x lanes of the block kernel run (block 0 bf16 x, block
    1 f32 x)."""
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=128, dropout=0.0, dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cuda").init_weights(0, std=0.1)
    calib = [onp.random.RandomState(i).randint(0, 1000, (4, 16)) for i in range(2)]
    quantize_net(model, calib_mode="naive", calib_data=calib, fused_decode=True)
    assert model.blocks[0].attn_qkv._act_scale is not None
    rng = onp.random.RandomState(14)
    prompts = [rng.randint(0, 1000, n).tolist() for n in (5, 14, 9, 12)]
    for paged in (True, False):
        int8_gemv.reset_launches()
        eng = InferenceEngine(model, max_batch_size=4, max_len=128, multi_token=4,
                              paged=paged, page_size=16).start()
        try:
            res = [h.result(timeout=300) for h in [eng.submit(p, 24) for p in prompts]]
        finally:
            eng.shutdown(timeout=300)
        assert all(r.ok for r in res)
        kind = "fused_block_paged" if paged else "fused_block"
        lanes = int8_gemv.dtype_lanes()
        assert lanes[f"{kind}:x_bf16:kv_bf16"] > 0 and lanes[f"{kind}:x_f32:kv_bf16"] > 0
        assert all(p.dtype == torch.bfloat16 for p in eng._pools)
        assert eng.stats()["kv_bytes"] == sum(p.numel() * 2 for p in eng._pools)
        for p, r in zip(prompts, res):
            ref = gen.generate(model, torch.tensor([p]), 24, multi_token=4)[0, len(p):]
            assert r.generated_ids == ref.tolist()


# ---------------------------------------------------------------------------
# the redesigned warp route of K3/K4 (decode rows) and K8's mask/bf16 lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("N,K", chip_smoke.GEMV_SHAPES)
def test_warp_route_every_decode_m(cuda, bits, x_dtype, N, K):
    """The warp route at every M from 1 to 8, at the serving path's shapes:
    within 1e-4 x max(1, |plain|) (f32 sums in another order); each row the
    same bits as in the 8-row call and on a second launch; a bf16 x the
    f32 lane's bits on x.float(); every call counted on the warp route."""
    x8, w, s = (_gemv_operands if bits == 8 else _int4_operands)(8, N, K, seed=N + K)
    x8 = x8.to(x_dtype)
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    plain = int8_gemv._reference_int8_matmul if bits == 8 else int8_gemv._reference_int4_matmul
    full = fn(x8, w, s)
    int8_gemv.reset_launches()
    for M in range(1, 9):
        x = x8[:M].contiguous()
        got, again, want = fn(x, w, s), fn(x, w, s), plain(x, w, s)
        wide = fn(x.float(), w, s)
        torch.cuda.synchronize()
        assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max().item()), M
        assert torch.equal(got.view(torch.int32), full[:M].view(torch.int32)), M
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), M
        assert torch.equal(got.view(torch.int32), wide.view(torch.int32)), M
    assert int8_gemv.gemv_routes() == {"warp": 24, "mma": 0}
    assert int8_gemv.gemv_widths() == {f"warp:{N}": 24}


@pytest.mark.parametrize("bits", [8, 4])
def test_warp_route_short_groups_and_long_rows(cuda, bits):
    """Widths that leave a short last channel group (N % 4 != 0) and row
    counts past gemv_max_m() (row tiles of 8) on the warp route: within
    1e-4 of the plain version, rows the same bits as alone."""
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    plain = int8_gemv._reference_int8_matmul if bits == 8 else int8_gemv._reference_int4_matmul
    for N, K, M in ((770, 768, 8), (1026, 3072, 3), (3, 256, 5), (384, 768, 70)):
        x, w, s = (_gemv_operands if bits == 8 else _int4_operands)(M, N, K, seed=M)
        got, want = fn(x, w, s), plain(x, w, s)
        one = fn(x[M - 1:M].contiguous(), w, s)
        torch.cuda.synchronize()
        assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max().item()), (N, K, M)
        assert torch.equal(one, got[M - 1:M]), (N, K, M)


@pytest.mark.parametrize("bits", [8, 4])
def test_head_sampler_greedy_equals_warp_head_at_every_m(cuda, bits):
    """K8's greedy rows (f32 and bf16 h) equal the argmax of the warp
    route's head logits at GPT-2's 50304 padded rows, at every M from 1 to
    8, bit for bit (one dot order)."""
    _, w, s = (_gemv_operands if bits == 8 else _int4_operands)(1, 50304, 768, seed=9)
    vocab = 50257
    g = torch.Generator(device="cuda").manual_seed(10)
    h8 = torch.randn(8, 768, device="cuda", generator=g)
    for M in range(1, 9):
        for hd in (torch.float32, torch.bfloat16):
            h = h8[:M].to(hd).contiguous()
            kb = torch.zeros(M, dtype=torch.int64, device="cuda")
            greedy = fb.fused_lm_head_sample(h, w, s, vocab, kb, torch.zeros(M, device="cuda"))
            logits = int8_gemv.weight_matmul(h, w, s)[:, :vocab]
            assert torch.equal(greedy.long(), logits.argmax(-1)), (M, hd)


def test_head_sampler_mask_and_bf16_lanes_match_plain(net):
    """K8's grammar-mask lane: tokens equal the plain version's (greedy and
    T = 0.8 rows), none on a forbidden lane, greedy rows the masked head
    GEMV + argmax. Its bf16 lane (bf16 h, logits rounded through bf16):
    the plain version's tokens, h.float()'s tokens, and greedy rows the
    argmax of the bf16-rounded head logits. Each lane counts its launch."""
    w_q, scale, vocab = net.head_weights()
    sfx = "_int4" if w_q.dtype == torch.uint8 else ""
    g = torch.Generator(device="cuda").manual_seed(12)
    B, Vp = 6, w_q.shape[0]
    h = torch.randn(B, net.cfg.hidden_size, device="cuda", generator=g)
    hb = h.bfloat16()
    kb = torch.from_numpy(gen._key_bits(onp.arange(B) + 7, onp.arange(B))).cuda()
    mask = torch.rand(B, vocab, device="cuda", generator=g) < 0.2
    mask_p = torch.zeros(B, Vp, dtype=torch.bool, device="cuda")
    mask_p[:, :vocab] = mask
    for temp in (0.0, 0.8):
        temps = torch.full((B,), temp, device="cuda")
        int8_gemv.reset_launches()
        got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=mask)
        gb = fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=torch.bfloat16)
        assert int8_gemv.dtype_lanes() == {f"fused_head{sfx}:h_f32:mask": 1,
                                           f"fused_head{sfx}:h_bf16:bf16_logits": 1}
        plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb, mask=mask_p)
        assert torch.equal(got, plain)
        assert bool(mask.gather(1, got.long()[:, None]).all())
        pb = fb._reference_head_sample(hb.float(), w_q, scale, vocab, temps, kb,
                                       out_dtype=torch.bfloat16)
        wide = fb.fused_lm_head_sample(hb.float(), w_q, scale, vocab, kb, temps,
                                       out_dtype=torch.bfloat16)
        assert torch.equal(gb, pb) and torch.equal(gb, wide)
        if temp == 0.0:
            logits = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab]
            assert torch.equal(got.long(), logits.masked_fill(~mask, float("-inf")).argmax(-1))
            lb = int8_gemv.weight_matmul(hb, w_q, scale)[:, :vocab].bfloat16().float()
            assert torch.equal(gb.long(), lb.argmax(-1))
    with pytest.raises(MXNetError, match="bf16 or not at all"):
        fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, torch.zeros(B, device="cuda"),
                                out_dtype=torch.float16)


def _head_case(net, B, seed):
    """h, [B, 2] int64 keys, temps (even rows greedy, odd rows T 0.8) and a
    bool [B, vocab] mask (30% allowed, the last vocab lane forbidden) on
    the card for ``net``'s head."""
    _, _, vocab = net.head_weights()
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(B, net.cfg.hidden_size, device="cuda", generator=g)
    keys = torch.from_numpy(gen._fold_keys(onp.arange(B) + seed, onp.arange(B))
                            .astype(onp.int64)).cuda()
    temps = torch.tensor([0.0 if r % 2 == 0 else 0.8 for r in range(B)], device="cuda")
    mask = torch.rand(B, vocab, device="cuda", generator=g) < 0.3
    mask[:, vocab - 1] = False
    return h, keys, temps, mask


def _padded(mask, Vp):
    B, vocab = mask.shape
    mp = torch.zeros(B, Vp, dtype=torch.bool, device=mask.device)
    mp[:, :vocab] = mask
    return mp


@pytest.mark.parametrize("B", [9, 16])
def test_head_sampler_two_row_tiles_match_plain(net, B):
    """K8 past 8 rows (two row tiles) with [B, 2] keys and an unpadded bool
    mask whose last vocab lane is forbidden: tokens equal the plain
    version's, none on a forbidden lane, and each row's token is the one
    it gets in a batch of at most 8 rows (one dot order)."""
    w_q, scale, vocab = net.head_weights()
    h, keys, temps, mask = _head_case(net, B, 20 + B)
    kb = keys[:, 0] ^ keys[:, 1]
    for m in (None, mask):
        got = fb.fused_lm_head_sample(h, w_q, scale, vocab, keys, temps, mask=m)
        plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb,
                                          mask=None if m is None else _padded(m, w_q.shape[0]))
        halves = torch.cat([fb.fused_lm_head_sample(h[:8], w_q, scale, vocab, keys[:8],
                                                    temps[:8], mask=None if m is None else m[:8]),
                            fb.fused_lm_head_sample(h[8:], w_q, scale, vocab, keys[8:],
                                                    temps[8:], mask=None if m is None else m[8:])])
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
        assert torch.equal(got, halves)
        if m is not None:
            assert bool(m.gather(1, got.long()[:, None]).all())


def test_head_sampler_forbidden_row_selects_lane_zero(net):
    """A card mask whose row forbids every lane is not checked on the host
    (no sync per step): K8 selects lane 0 for it, as the TPU kernel does,
    and the plain version's argmax over an all -inf row gives the same."""
    w_q, scale, vocab = net.head_weights()
    B = 5
    h, keys, temps, mask = _head_case(net, B, 31)
    mask[2] = False
    for t in (temps, torch.zeros(B, device="cuda")):
        got = fb.fused_lm_head_sample(h, w_q, scale, vocab, keys, t, mask=mask)
        plain = fb._reference_head_sample(h, w_q, scale, vocab, t, keys[:, 0] ^ keys[:, 1],
                                          mask=_padded(mask, w_q.shape[0]))
        torch.cuda.synchronize()
        assert int(got[2]) == 0
        assert torch.equal(got, plain)


def test_head_sampler_repeats_across_launches(net):
    """K8's cross-CTA reduction (the last CTA's ticket, reset for the next
    launch) gives the same tokens on every launch, at batch sizes that
    grow and shrink the per-stream workspace, with and without a mask."""
    w_q, scale, vocab = net.head_weights()
    cases = {B: _head_case(net, B, 40 + B) for B in (3, 16, 1)}
    first = {}
    for rep in range(6):
        for B, (h, keys, temps, mask) in cases.items():
            for m in (None, mask):
                tok = fb.fused_lm_head_sample(h, w_q, scale, vocab, keys, temps, mask=m)
                first.setdefault((B, m is None), tok)
                assert torch.equal(tok, first[(B, m is None)]), (rep, B)
    torch.cuda.synchronize()


# K7 at three page sizes: 256 f32 or 512 bf16 key rows a ring slot, so
# slot edges at 255 / 256 (f32) and 511 / 512
_SLOT_EDGES = [511, 512, 1023, 255, 256, 0]


@pytest.mark.parametrize("ps", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streamed_kernel_slot_edges(pack, ps, dtype):
    """K7 at L 1024 with positions on ring-slot edges (k * rows - 1 and k *
    rows, rows = 256 f32 or 512 bf16 key rows a slot) against the plain
    version by ``check_paged``'s rule, its copies started == waited == the
    ``record_dma`` ledger; then K5, K6 and K7 the same bits at L 384 (under
    K6's f32 gate) with slot-edge positions. bf16 key pages come by
    swizzled tensor copies at ps 8-32 and by bulk copies read lagged at ps
    4 (pages under one 1 KB swizzle pattern)."""
    D, H = 256, 4
    rows = fb._dma_tile_pages(D, H, ps, 1024, fb._DMA_DEPTH, dtype.itemsize) * ps
    assert rows == 1024 // dtype.itemsize
    pool = 3200 // ps                      # the rows' pages, scattered
    g = torch.Generator(device="cuda").manual_seed(50 + ps)
    inputs = chip_smoke.paged_inputs(torch, g, D, H, len(_SLOT_EDGES), ps, 1024 // ps, pool,
                                     _SLOT_EDGES, dtype)
    chip_smoke.check_paged(torch, fb, f"K7 ps {ps}", inputs, pack, True, pool, ps)
    chip_smoke.same_bits_k5_k6_k7(torch, fb, g, pack, pool, ps, [256, 255, 383, 128, 127, 0],
                                  maxp=384 // ps, dtype=dtype)


# ---------------------------------------------------------------------------
# K5 and K6 redesigned on the streamed attention: against their plain
# versions and against K7 on the same logical cache
# ---------------------------------------------------------------------------

def _contiguous_view(kp, vp, table, L):
    """The [B, H, L, hd] caches a block table's pages stand for."""
    B, maxp = table.shape
    ps = kp.shape[2]
    return [p[table.long()].transpose(1, 2).reshape(B, kp.shape[1], maxp * ps, -1)
            .contiguous() for p in (kp, vp)]


def _k5_against_k7(pack, pos, L, dtype, x_dtype=None, seed=20):
    """K5 on the contiguous view of a paged cache against its plain version
    (``hold_block``'s rule) and against K7 on the pages, bit for bit: the
    output, and K5's written cache rows against K7's written pool rows (rows
    0 and 1 share their first two pages, the last row is inactive:
    ``paged_inputs``). B 1 runs row 0 of a three-row paged case. Returns
    K5's output."""
    D, H = pack["ln1"][0].shape[0], pack["heads"]
    ps, maxp = 16, L // 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    case = list(pos) * 2 + [0] if len(pos) == 1 else list(pos)
    x, posv, table, kp, vp = chip_smoke.paged_inputs(torch, g, D, H, len(case), ps, maxp,
                                                     4 * len(case) * maxp, case, dtype)
    B = len(pos)
    x, posv, table = x[:B], posv[:B], table[:B].contiguous()
    if x_dtype is not None:
        x = x.to(x_dtype)
    kc, vc = _contiguous_view(kp, vp, table, L)
    k5, v5, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    k7, v7 = kp.clone(), vp.clone()
    int8_gemv.reset_launches()
    o5, _, _ = fb.fused_block_decode(x, posv, k5, v5, pack)
    o7, _, _ = fb._cuda_block_decode_paged(x, posv, table, k7, v7, pack, True, None)
    plain, _, _ = fb._reference_block_decode(x, posv, k2, v2, pack)
    torch.cuda.synchronize()
    assert int8_gemv.launches() == {"fused_block" + fb._kind_suffix(pack): 1}
    written = torch.zeros(B, H, L, dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), :, posv.long().clamp(0, L - 1)] = True
    chip_smoke.hold_block(torch, "K5", o5, plain, (k5, v5), (k2, v2), (kc, vc), written)
    assert torch.equal(o5, o7), (o5 - o7).abs().max().item()
    sink = kp.shape[0] - 1
    for b, p in enumerate(posv.clamp(0, L - 1).tolist()):
        page = int(table[b, p // ps])
        if page != sink:       # the inactive row writes the sink page
            assert torch.equal(k5[b, :, p], k7[page, :, p % ps])
            assert torch.equal(v5[b, :, p], v7[page, :, p % ps])
    return o5


# (positions): position 0 and L - 1, every row at one position, every row
# long, B 1, 9 and 16, and the pos-64 rows serving decodes at
_K5_CASES = {
    "edges": [1023, 1023, 0, 511, 512, 255, 256, 0],
    "one_position": [700] * 7 + [0],
    "all_long": [1023, 1000, 999, 960, 1023, 900, 1010, 0],
    "pos64": [64] * 7 + [0],
    "B1": [1023],
    "B9": [1000, 517, 3, 64, 999, 250, 1, 777, 0],
    "B16": [1000, 517, 3, 64, 999, 250, 1, 777, 1023, 40, 300, 64, 65, 128, 900, 0],
}


@pytest.mark.parametrize("case", sorted(_K5_CASES))
def test_contiguous_kernel_streams_k7s_bits(pack, case):
    """K5 (a (row, head)'s cache slab streamed slot by slot through the
    ring) holds its plain version and gives K7's bits at L 1024, f32."""
    _k5_against_k7(pack, _K5_CASES[case], 1024, torch.float32)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("case", ["edges", "all_long", "pos64", "B1", "B9", "B16"])
def test_contiguous_kernel_streams_k7s_bits_in_bf16(pack, case, x_dtype):
    """The same with bf16 caches (key rows by swizzled tensor copies of
    16-row boxes at hd 64), at bf16 x (block 0) and f32 x (later blocks)."""
    _k5_against_k7(pack, _K5_CASES[case], 1024, torch.bfloat16, x_dtype)


def test_contiguous_kernel_rows_are_batch_invariant(pack):
    """A row gives the same bits alone, in a batch of 8 (one row tile of 8),
    of 9 and of 16 (one tile of 16)."""
    g = torch.Generator(device="cuda").manual_seed(21)
    B, D, H, L = 16, 256, 4, 1024
    x = torch.randn(B, 1, D, device="cuda", generator=g)
    kc = torch.randn(B, H, L, D // H, device="cuda", generator=g) * 0.1
    vc = torch.randn(B, H, L, D // H, device="cuda", generator=g) * 0.1
    pos = torch.tensor(_K5_CASES["B16"], dtype=torch.int32, device="cuda")
    full, _, _ = fb.fused_block_decode(x, pos, kc.clone(), vc.clone(), pack)
    for lo, hi in ((0, 9), (0, 8), (5, 6), (15, 16)):
        part, _, _ = fb.fused_block_decode(x[lo:hi], pos[lo:hi], kc[lo:hi].clone(),
                                           vc[lo:hi].clone(), pack)
        torch.cuda.synchronize()
        assert torch.equal(part, full[lo:hi]), (lo, hi)


# (positions) of K6 at L 256: positions 0 and L - 1, B 1, 9 and 16
_K6_CASES = {
    "B16": [200, 255, 33, 138, 201, 227, 212, 106, 109, 79, 106, 80, 62, 25, 1, 0],
    "B9": [255, 254, 0, 128, 127, 64, 65, 17, 0],
    "B1": [255],
    "one_position": [255] * 15 + [0],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_K6_CASES))
def test_gathered_kernel_holds_plain_and_k7s_bits(pack, case, dtype):
    """K6 (each (row, head)'s pages gathered by TMA copies, items longest
    first, 16-row weight tiles past 8 rows) against its plain version by
    ``check_paged``'s rule, then K5, K6 and K7 on one input give the same
    bits (``same_bits_k5_k6_k7``)."""
    pos = _K6_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(30)
    if len(pos) > 1:
        inputs = chip_smoke.paged_inputs(torch, g, 256, 4, len(pos), 16, 16, 400, pos, dtype)
        chip_smoke.check_paged(torch, fb, "K6", inputs, pack, False, 400, 16)
        chip_smoke.same_bits_k5_k6_k7(torch, fb, g, pack, 400, 16, pos, dtype=dtype)
    else:
        x, posv, table, kp, vp = chip_smoke.paged_inputs(torch, g, 256, 4, 3, 16, 16, 400,
                                                         pos * 2 + [0], dtype)
        one = (x[:1], posv[:1], table[:1].contiguous())
        k6, v6, k7, v7 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        o6, _, _ = fb.fused_block_decode_paged(*one, k6, v6, pack)
        o7, _, _ = fb._cuda_block_decode_paged(*one, k7, v7, pack, True, None)
        torch.cuda.synchronize()
        assert torch.equal(o6, o7) and torch.equal(k6, k7) and torch.equal(v6, v7)


def test_gathered_kernel_at_gpt2_small_b16(cuda):
    """K6 at chip_smoke's paged A shape (GPT-2 small widths, B 16, L 256:
    one 16-row weight tile, 192 items over the grid, longest first) gives
    K7's bits and K5's on the gathered view, int8 and bf16 pools."""
    import dataclasses
    from mxnet_tpu_torch.models import GPT2_SMALL
    cfg = dataclasses.replace(GPT2_SMALL, num_layers=1, dropout=0.0, vocab_size=256)
    model = quantize_net(GPTModel(cfg, device="cuda").init_weights(0), fused_decode=True)
    pk = fb.pack_gpt_block(model.blocks[0], eps=cfg.layer_norm_eps)
    g = torch.Generator(device="cuda").manual_seed(31)
    for dtype in (torch.float32, torch.bfloat16):
        chip_smoke.same_bits_k5_k6_k7(torch, fb, g, pk, 600, 16, _K6_CASES["B16"], dtype=dtype)


def test_bitwise_check_catches_pv_partials_out_of_group_order(pack, tmp_path):
    """A planted fault: K5 built with the P.V group partials summed in
    reverse group order (a legal reordering, within the plain version's
    tolerance) must fail the bitwise check against K7."""
    import shutil
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "tools"))
    from nvcc_build import build
    src = tmp_path / "csrc"
    shutil.copytree(root / "mxnet_tpu_torch" / "csrc", src)
    common = src / "block_decode_common.cuh"
    text = common.read_text()
    order = ("    float c = red[tid];\n"
             "    for (int q = 1; q < groups; ++q) c += red[q * hd + tid];\n")
    assert order in text
    common.write_text(text.replace(order, "    float c = red[(groups - 1) * hd + tid];\n"
                                          "    for (int q = groups - 2; q >= 0; --q) "
                                          "c += red[q * hd + tid];\n"))
    (lib,) = build([(src, tmp_path / "build", "fused_block_decode")])
    _build._declare("fused_block_decode", lib)
    saved = _build.library
    _build.library = lambda name: lib if name == "fused_block_decode" else saved(name)
    try:
        with pytest.raises(AssertionError):
            _k5_against_k7(pack, _K5_CASES["all_long"], 1024, torch.float32)
    finally:
        _build.library = saved


# ---------------------------------------------------------------------------
# the engine's captured steps: CUDA-graph replay against eager dispatch
# ---------------------------------------------------------------------------
def _serving_model(dtype):
    """A small GPT on the card (hd 64, max_position 1024), int8 with fused
    decode; bf16 with naive calibration, as the serving headlines."""
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=1024, dropout=0.0, dtype=dtype)
    model = GPTModel(cfg, device="cuda").init_weights(0, std=0.1)
    calib = ([onp.random.RandomState(i).randint(0, 1000, (4, 16)) for i in range(2)]
             if dtype == torch.bfloat16 else None)
    return quantize_net(model, fused_decode=True,
                        **(dict(calib_mode="naive", calib_data=calib) if calib else {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout,max_len", [("contiguous", 128), ("paged", 128),
                                            ("paged", 1024)], ids=["K5", "K6", "K7"])
def test_replayed_dispatch_equals_eager(cuda, layout, max_len, dtype):
    """A replayed decode dispatch (fused head and filtered branch) and, in
    the paged layout, a replayed prefill chunk (full and final bucket) give
    the eager run's outputs, last tokens and whole pools bit for bit, from
    the same inputs and pool state (``chip_smoke.replay_equals_eager``)."""
    model = _serving_model(dtype)
    eng = InferenceEngine(model, max_batch_size=4, max_len=max_len, multi_token=4,
                          paged=layout == "paged", page_size=16)
    g = torch.Generator(device="cuda").manual_seed(3)
    for branch in ("fused", "filtered"):
        chip_smoke.replay_equals_eager(torch, eng, g, 4, sb=4, steps=4, branch=branch)
    chip_smoke.replay_equals_eager(torch, eng, g, 5, sb=2, steps=3, branch="fused")
    if layout == "paged":
        for pb in (16, 8):
            chip_smoke.replay_equals_eager(torch, eng, g, 6, pb=pb)
    # K7 past K6's gate (L 432 with f32 pools at hd 64, 864 with bf16)
    kind = {"contiguous": "fused_block", "paged": "fused_block_paged"}[layout]
    kind += "_dma" if max_len == 1024 else ""
    eng_kinds = {k for step in eng._steps.values() for k in step.tally.kinds}
    assert kind in eng_kinds


class _SyncsWhenCollected:
    """Cyclic garbage whose finalizer synchronizes the card (a call a graph
    capture forbids in its thread) and leaves one more such cycle behind
    while ``live``, so that every collection finds some."""
    live = True

    def __init__(self):
        self.cycle = self

    def __del__(self):
        torch.cuda.synchronize()
        if _SyncsWhenCollected.live:
            _SyncsWhenCollected()


def test_warmup_captures_while_garbage_syncs_when_collected(cuda):
    """With the collector running on every allocation and garbage whose
    finalizer synchronizes the card always present, the engine's warm-up
    captures every step: no collection starts inside a capture."""
    model = _serving_model(torch.float32)
    eng = InferenceEngine(model, max_batch_size=4, max_len=128, multi_token=2, paged=True,
                          page_size=16)
    threshold = gc.get_threshold()
    _SyncsWhenCollected.live = True
    _SyncsWhenCollected()
    gc.set_threshold(1)
    try:
        eng.warmup()
    finally:
        gc.set_threshold(*threshold)
        _SyncsWhenCollected.live = False
        gc.collect()
    st = eng.stats()
    assert st["captures"] > 0 and st["compiled_buckets"]["decode"]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_grammar_and_verify_steps_replay_equal_eager(cuda, layout):
    """A grammar engine's T = 1 step (greedy and sampled) and a
    grammar-speculative engine's verify step (4 rows: the warp route; 16
    rows: the tile route) replay their eager runs bit for bit, tokens,
    automaton states and pools, on a real automaton's tables; serving a
    constrained and free mix after ``warmup()`` captures nothing, and every
    constrained completion replays through the automaton."""
    from mxnet_tpu_torch.serve import compile_grammar
    model = _serving_model(torch.float32)
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "mode": {"enum": ["fast", "safe"]}}}
    gram = compile_grammar(schema, model.cfg.vocab_size)
    g = torch.Generator(device="cuda").manual_seed(8)
    rng = onp.random.RandomState(8)
    prompts = [rng.randint(1, 1000, 12).tolist() for _ in range(4)]
    for spec in (0, 4):
        eng = InferenceEngine(model, max_batch_size=4, max_len=128, paged=layout == "paged",
                              page_size=16, speculate=spec, grammar=True).start()
        try:
            warmed = chip_smoke.warm(eng)
            hs = [eng.submit(p, 40, eos_token_id=0, seed=i, temperature=0.7 * (i % 2),
                             **({"grammar": schema} if i < 2 else {}))
                  for i, p in enumerate(prompts)]
            res = [h.result(timeout=300) for h in hs]
            chip_smoke.no_capture_since(eng, warmed, f"grammar engine speculate={spec}")
        finally:
            eng.shutdown(drain=True, timeout=300)
        assert all(r.ok for r in res)
        assert all(gram.matches(r.generated_ids, eos_token_id=0) for r in res[:2])
        for branch in ("greedy", "sampled"):
            if spec:
                for sb in (1, 4):
                    chip_smoke.replay_equals_eager(torch, eng, g, 9 + sb, sb=sb,
                                                   branch=branch, verify=True)
            else:
                chip_smoke.replay_equals_eager(torch, eng, g, 9, sb=4, steps=1,
                                               branch=branch)


@pytest.mark.parametrize("branch", ["fused", "filtered"])
def test_replay_counts_launches_and_dma_like_eager(cuda, branch):
    """Launch counts per kind, route, width and lane, a thread's
    ``count_launches`` tally, and K7's DMA ledger read the same after two
    replays of a captured dispatch as after two eager runs of its function;
    the capture itself counts nothing."""
    model = _serving_model(torch.float32)
    eng = InferenceEngine(model, max_batch_size=4, max_len=512, multi_token=4,
                          paged=True, page_size=16)
    g = torch.Generator(device="cuda").manual_seed(4)
    chip_smoke.replay_equals_eager(torch, eng, g, 7, sb=4, steps=4, branch=branch)
    step = eng._get_step(4, 4, branch)

    def counted(run):
        int8_gemv.reset_launches()
        with int8_gemv.count_launches() as tally:
            run()
            run()
        torch.cuda.synchronize()
        return (int8_gemv.launches(), int8_gemv.gemv_routes(), int8_gemv.gemv_widths(),
                int8_gemv.dtype_lanes(), int8_gemv.dma_ledger(), dict(tally))

    int8_gemv.reset_launches()
    eng._get_step(2, 4, branch)                  # a capture: counts nothing
    assert int8_gemv.launches() == {} and int8_gemv.dma_ledger()["copies"] == 0
    eager = counted(step.fn)
    replay = counted(step)
    assert replay == eager
    assert eager[0]["fused_block_paged_dma"] == 2 * 4 * 2
    assert eager[4]["copies"] == eager[4]["waits"] > 0
    if branch == "filtered":
        assert eager[2] == {"warp:1024": 2 * 4}


def test_head_workspace_survives_a_wider_eager_call(cuda, net):
    """K8's workspace captured by a graph stays the one it replays: an
    eager call with more rows on the capture stream (a wider workspace)
    and fresh allocations between two replays leave its tokens those of
    the eager call."""
    w, s, vocab = net.head_weights()
    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn(4, w.shape[1] if w.dtype == torch.int8 else 2 * w.shape[1],
                    device="cuda", generator=g)
    keys = torch.randint(0, 2**31, (4, 2), device="cuda", generator=g)
    temps = torch.tensor([0.0, 0.8, 0.0, 1.1], device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = fb.fused_lm_head_sample(h, w, s, vocab, keys, temps, filtered=False)
    graph = torch.cuda.CUDAGraph()
    with int8_gemv.record_graph():
        with torch.cuda.graph(graph, stream=stream):
            out = fb.fused_lm_head_sample(h, w, s, vocab, keys, temps, filtered=False)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    wide = torch.randn(40, h.shape[1], device="cuda", generator=g)
    with torch.cuda.stream(stream):
        fb.fused_lm_head_sample(wide, w, s, vocab, torch.zeros(40, 2, dtype=torch.int64,
                                                               device="cuda"),
                                torch.zeros(40, device="cuda"), filtered=False)
    torch.cuda.synchronize()
    junk = [torch.full((1 << 16,), -1, dtype=torch.int32, device="cuda") for _ in range(8)]
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and len(junk) == 8


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that syncs with the host cannot be captured: the engine
    raises ``MXNetError`` naming the bucket, and serves nothing eagerly
    instead."""
    model = _serving_model(torch.float32)
    eng = InferenceEngine(model, max_batch_size=2, max_len=128, multi_token=4, paged=False)
    real = gen.decode_multi_tokens

    def syncing(*a, **kw):
        out = real(*a, **kw)
        out[0].cpu()                          # a host read: illegal under capture
        return out

    monkeypatch.setattr(gen, "decode_multi_tokens", syncing)
    with pytest.raises(MXNetError, match=r"decode bucket 2 \(1 substeps, fused\)"):
        eng._get_step(2, 1, "fused")
    assert (2, 1, "fused") not in eng._steps
    torch.cuda.synchronize()


def test_dropout_on_card_equals_cpu(cuda):
    """Dropout draws its keep mask on the card, the CPU's bits: a
    ``KeySupply`` over a device key, bf16 and f32 forwards and backwards
    bit for bit, and a small GPT's training steps at dropout 0.1 through
    ``TrainStep`` with the same losses on both devices to 1e-4 relative
    (the file chip_smoke.py's card/CPU loss gate)."""
    from mxnet_tpu_torch import _prng, _random, optimizer, parallel
    from mxnet_tpu_torch import numpy_extension as npx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    x = torch.randn(4, 300, 96, generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        outs = []
        for dev in ("cuda", "cpu"):
            t = x.to(dev, dtype, copy=True).requires_grad_(True)
            with _random.KeySupply(_prng.key(7, dev)):
                k = _random.next_key()
                assert k.device.type == dev
                y = npx.dropout(t, 0.1, axes=(1,), training=True)
            y.backward(torch.ones_like(y))
            outs.append((y.detach().cpu(), t.grad.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*outs))
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=256, dropout=0.1)
    ids = torch.randint(0, 1000, (2, 256), generator=torch.Generator().manual_seed(1))
    losses = []
    for dev in ("cuda", "cpu"):
        net = GPTModel(cfg, device=dev).init_weights(3)
        step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                                  optimizer.SGD(learning_rate=0.1), example_inputs=[ids])
        losses.append([float(step(ids, ids)) for _ in range(2)])
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(*losses))


# ---------------------------------------------------------------------------
# scoring graphs and live weight swaps
# ---------------------------------------------------------------------------
def _score_ids(n, seed):
    return onp.random.RandomState(seed).randint(0, 1000, n).tolist()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_score_graphs_replay_equal_eager(cuda, layout):
    """A captured score graph gives the eager score's bits at two buckets
    (8 rows on K3's warp route, 64 on the tile route), and again after the
    other bucket has replayed."""
    model = _serving_model(torch.float32)
    kw = dict(max_batch_size=2, max_len=128, multi_token=4, paged=layout == "paged",
              page_size=16)
    eng = InferenceEngine(model, **kw).warmup_score()
    ref = InferenceEngine(model, **kw)
    ref._eager = True
    assert eng.stats()["compiled_buckets"]["score"] == [8, 16, 32, 64, 128]
    routes0 = int8_gemv.gemv_routes()
    for n, seed in ((7, 0), (64, 1), (5, 2)):
        ids = _score_ids(n, seed)
        got, want = eng.score(ids), ref.score(ids)
        assert got == want
        assert len(got["token_logprobs"]) == n - 1
    routes = int8_gemv.gemv_routes()
    assert routes["warp"] > routes0["warp"] and routes["mma"] > routes0["mma"]
    assert eng.stats()["captures"] == 5


def test_score_concurrent_with_decode_replays(cuda):
    """Scores from a second thread while the engine's decode graphs replay
    give the bits of the same scores run alone."""
    import threading
    model = _serving_model(torch.float32)
    eng = InferenceEngine(model, max_batch_size=4, max_len=128, multi_token=4,
                          paged=True, page_size=16).start()
    try:
        eng.warmup()
        eng.warmup_score()
        seqs = [_score_ids(n, 10 + n) for n in (5, 9, 23, 64)]
        alone = [eng.score(s) for s in seqs]
        handles = [eng.submit(_score_ids(12, i), 96) for i in range(4)]
        during, errors = [], []

        def scorer():
            try:
                for _ in range(5):
                    during.append([eng.score(s) for s in seqs])
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=scorer) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        results = [h.result(300) for h in handles]
        assert not errors and all(r.ok for r in results)
        assert all(d == alone for d in during)
    finally:
        eng.shutdown()


def test_swap_seen_by_next_replay_without_capture(cuda):
    """An in-place swap on an unfused int8 engine: the next decode and
    score replays read the new weights (a fresh engine's tokens and
    score bits over them) and nothing is captured."""
    from mxnet_tpu_torch.serve.registry import snapshot_params
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=128, dropout=0.0)
    a = quantize_net(GPTModel(cfg, device="cuda").init_weights(0, std=0.1))
    b = quantize_net(GPTModel(cfg, device="cuda").init_weights(1, std=0.1))
    eng = InferenceEngine(a, max_batch_size=2, max_len=128).start()
    ref = InferenceEngine(b, max_batch_size=2, max_len=128).start()
    try:
        eng.warmup()
        eng.warmup_score()
        ref.warmup()
        ref.warmup_score()
        prompt = _score_ids(11, 3)
        before = eng.generate(prompt, 16).generated_ids
        captures = eng.stats()["captures"]
        assert eng.swap_weights(snapshot_params(b)) == 1
        after = eng.generate(prompt, 16).generated_ids
        assert after != before
        assert after == ref.generate(prompt, 16).generated_ids
        assert eng.score(prompt) == ref.score(prompt)
        assert eng.stats()["captures"] == captures
    finally:
        eng.shutdown()
        ref.shutdown()


# ------------------------------------------------ the gluon substrate's paths

def _replay_net():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16), nn.BatchNorm(), nn.Dropout(0.5),
            nn.Dense(8))
    with mx.gpu():
        mx.random.seed(0)
        net.initialize(mx.init.Xavier())
    return net


def test_hybridized_block_replays_cuda_graph(cuda):
    """A block hybridized with ``static_alloc=True`` replays one CUDA graph
    per cache entry from its second call outside ``record()``: the eager
    call's bits; in-place writes (``set_data``, ``Trainer.step``) are read
    by the next replay; BatchNorm's statistics update in a training-mode
    replay; dropout draws a fresh mask per replay from the per-call seed.
    (Calling ``net.forward`` directly runs the children's own CachedOps.)"""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer
    net = _replay_net()
    with mx.gpu():
        x = mx.np.array(onp.random.RandomState(1).rand(4, 16).astype("float32"))
        want = net(x).asnumpy()                 # not hybridized: eager
        net.hybridize(static_alloc=True)
        op_calls = [net(x).asnumpy() for _ in range(3)]
        op = net._cached_op
        assert op.replays == 2 and op.cache_size == 1
        assert all(onp.array_equal(o, want) for o in op_calls)
        w = net[0].weight
        w.set_data(w.data() * 2)
        eager = net.forward(x).asnumpy()
        assert onp.array_equal(net(x).asnumpy(), eager) and op.replays == 3
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(4)
        assert onp.array_equal(net(x).asnumpy(), net.forward(x).asnumpy())
        rm = net[1].running_mean.data().asnumpy().copy()
        with autograd.train_mode():
            a, b = (net(x).asnumpy() for _ in range(2))
            c = net(x).asnumpy()
        assert not onp.array_equal(net[1].running_mean.data().asnumpy(), rm)
        assert not onp.array_equal(b, c)     # a fresh mask per call


def test_attention_block_launches_k1_k2_from_the_tape(cuda):
    """``mx.ops.attention`` in a user HybridBlock inside ``record()``: K1
    forward and K2 backward launch from the tape, gradients within K1/K2's
    gates of the same block with the plain attention called directly."""
    import types
    args = types.SimpleNamespace(seed=0)
    for dtype in ("float32", "bfloat16"):
        got, counts, _, _ = chip_smoke.attention_step(torch, args, "cuda", dtype, 1)
        want = chip_smoke.attention_step(torch, args, "cuda", dtype, 1, plain=True)[0]
        assert counts.get("flash_fwd") == 1 and counts.get("flash_bwd") == 1
        for n in want:
            if dtype == "float32" or n != "x":
                assert chip_smoke.flash_within(got[n], want[n], dtype), n


# ---------------------------------------------------------------------------
# Llama-3-8B's widths (the Llama serving path)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("N,K", [(4096, 4096), (14336, 4096), (4096, 14336), (128256, 4096)])
def test_gemv_at_llama_widths(cuda, bits, M, N, K):
    """K3/K4 at Llama-3-8B's q/o, gate/up, down and head widths with bf16
    x, on the warp route (1 and 8 rows) and the tile route (64): within
    1e-4 of the plain version's scale, and the f32 lane's bits on
    x.float() (K 14336: x no longer fits the warp route's shared memory at
    8 rows, which takes fewer rows a tile)."""
    x, w, s = (_gemv_operands if bits == 8 else _int4_operands)(M, N, K, seed=N + M)
    xb = x.bfloat16()
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    plain = int8_gemv._reference_int8_matmul if bits == 8 else int8_gemv._reference_int4_matmul
    int8_gemv.reset_launches()
    got = fn(xb, w, s)
    wide = fn(xb.float(), w, s)
    want = plain(xb, w, s)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), wide.view(torch.int32))
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert int8_gemv.gemv_widths() == {f"{int8_gemv.gemv_route(M)}:{N}": 2}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("vocab", [128256, 128003], ids=["llama3", "pad_lanes"])
def test_head_sampler_at_llama_vocab(cuda, bits, vocab):
    """K8 over a Llama-3 tied head [pad_vocab(vocab), 4096] (128256 needs
    no pad lane; 128003 pads to 128128), both lanes (f32 h; bf16 h with
    bf16 logits): tokens equal the plain version's at 8 rows, greedy and T
    0.8, and greedy rows the argmax of the warp head's logits (bf16-rounded
    in the bf16 lane), never a pad lane."""
    head = chip_smoke.tied_head(torch, torch.Generator(device="cuda").manual_seed(vocab),
                                vocab, 4096, bits)
    w_q, scale, V = head
    assert V == vocab and w_q.shape[0] == fb.pad_vocab(vocab)
    g = torch.Generator(device="cuda").manual_seed(3)
    B = 8
    h = torch.randn(B, 4096, device="cuda", generator=g)
    kb = torch.from_numpy(gen._key_bits(onp.arange(B) + 5, onp.arange(B))).cuda()
    for hd in (torch.float32, torch.bfloat16):
        x = h.to(hd)
        out = torch.bfloat16 if hd == torch.bfloat16 else None
        for temp in (0.0, 0.8):
            temps = torch.full((B,), temp, device="cuda")
            got = fb.fused_lm_head_sample(x, w_q, scale, V, kb, temps, out_dtype=out)
            want = fb._reference_head_sample(x.float(), w_q, scale, V, temps, kb,
                                             out_dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (hd, temp)
            assert bool((got < V).all())
            if temp == 0.0:
                logits = int8_gemv.weight_matmul(x, w_q, scale)[:, :V]
                if out is not None:
                    logits = logits.to(out).float()
                assert torch.equal(got.long(), logits.argmax(-1)), hd


# ---------------------------------------------------------------------------
# Llama training (K1/K2 at head dim 128, LlamaMoE, the TrainStep window)
# ---------------------------------------------------------------------------
def _llama_train_cfg(dtype, **kw):
    from mxnet_tpu_torch.models import LlamaConfig
    kw = dict(dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                   num_heads=2, num_kv_heads=1), **kw)
    return LlamaConfig(dtype=dtype, **kw)


def test_moe_llama_train_step_on_card_equals_cpu(cuda):
    """A small MoE Llama (layer 0 routes over 4 experts, top 2; head dim
    128) trains 2 f32 SGD steps on the card and on the CPU port from the
    same weights: every (token, choice) pair's expert and slot equal, each
    step's gradients leaf by leaf and the parameters after within
    chip_smoke.py's card/CPU gates."""
    import types

    from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
    from mxnet_tpu_torch.models import LlamaForCausalLM
    args = types.SimpleNamespace(seed=0)
    cfg = _llama_train_cfg(torch.float32, num_experts=4, num_experts_per_tok=2, moe_every=2)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(1)
    card = params_from_numpy(LlamaForCausalLM(cfg, device="cuda"), params_to_numpy(cpu))
    lc, gc, rc, pc = chip_smoke.small_sgd_steps(torch, args, card, 2)
    lh, gh, rh, ph = chip_smoke.small_sgd_steps(torch, args, cpu, 2)
    bad, logit_diff, margin = chip_smoke.route_diffs(torch, rc, rh)
    assert bad == 0, (logit_diff, margin)
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lc, lh))
    for got, want in zip(gc, gh):
        err = chip_smoke.worst(chip_smoke.leaf_errors(got, want))
        assert err["rel_l2"] <= chip_smoke.CARD_CPU_GRAD_TOL, err
    assert max(float(abs(pc[n] - ph[n]).max()) for n in ph) <= chip_smoke.CARD_CPU_PARAM_TOL


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_llama_train_step_launches_k1_k2_at_head_dim_128(cuda, remat):
    """A bf16 Llama with heads of 128 at T 256: each TrainStep launches K1
    and K2 once per layer (K1 twice with ``remat=True``: the recomputed
    forward), and never the plain attention; the loss falls."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import LlamaForCausalLM
    net = LlamaForCausalLM(_llama_train_cfg(torch.bfloat16), device="cuda").init_weights(2)
    ids = torch.randint(0, 512, (2, 256), generator=torch.Generator().manual_seed(3))
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1),
                              optimizer.Adam(learning_rate=1e-3), [ids], remat=remat)
    losses = []
    for _ in range(3):
        int8_gemv.reset_launches()
        losses.append(float(step(ids, ids)))
        torch.cuda.synchronize()
        counts = int8_gemv.launches()
        assert counts.get("flash_fwd", 0) == (4 if remat else 2), counts
        assert counts.get("flash_bwd", 0) == 2, counts
    assert losses[-1] < losses[0]


def test_train_step_window_keeps_at_most_block_every_in_flight(cuda):
    """``step()`` with ``block_every=2``: after every call at most 2 steps
    are in flight (CUDA events not yet waited on), ``drain()`` empties the
    window, and the steps are ``__call__``'s, bit for bit."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import LlamaForCausalLM
    nets = [LlamaForCausalLM(_llama_train_cfg(torch.float32), device="cuda").init_weights(4)
            for _ in range(2)]
    ids = torch.randint(0, 512, (2, 256), generator=torch.Generator().manual_seed(5))
    steps = [parallel.TrainStep(n, SoftmaxCrossEntropyLoss(axis=-1), optimizer.SGD(
        learning_rate=0.1), [ids], block_every=w) for n, w in zip(nets, (None, 2))]
    depths, got, want = [], [], []
    for _ in range(6):
        want.append(steps[0](ids, ids))
        got.append(steps[1].step(ids, ids))
        depths.append(len(steps[1]._inflight))
    assert max(depths) <= 2 and depths[-1] >= 1, depths
    steps[1].drain()
    assert len(steps[1]._inflight) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for p, q in zip(*(n.parameters() for n in nets)):
        assert torch.equal(p, q)


def test_trained_tied_llama_serves_its_head_through_k3(cuda):
    """A tied bf16 Llama trained 2 Adam steps through ``TrainStep`` (which
    leaves it in train mode), then ``quantize_net``: ``generate`` launches
    K3 over the head's vocab-padded table at the prefill and at every
    decode step (vocab 640, a width no other matrix of the model has)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import LlamaForCausalLM
    net = LlamaForCausalLM(_llama_train_cfg(torch.bfloat16, vocab_size=640,
                                            tie_embeddings=True), device="cuda").init_weights(6)
    ids = torch.randint(0, 640, (2, 256), generator=torch.Generator().manual_seed(7))
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1),
                              optimizer.Adam(learning_rate=1e-3), [ids])
    for _ in range(2):
        step(ids, ids)
    assert net.training
    quantize_net(net, bits=8)
    int8_gemv.reset_launches()
    gen.generate(net, ids[:, :8], 4)
    torch.cuda.synchronize()
    head = sum(n for key, n in int8_gemv.gemv_widths().items()
               if key.endswith(f":{fb.pad_vocab(640)}"))
    assert head >= 4, int8_gemv.gemv_widths()


@pytest.fixture
def card(cuda):
    """The card with TF32 off (cuDNN's f32 convolutions in full f32): these
    cases hold cuDNN against the CPU."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


CONV_CARD_CASES = {
    "conv2d_nhwc": lambda v: npx.convolution(v[0], v[1], v[2], stride=2, pad=1,
                                             layout="NHWC"),
    "conv2d_grouped": lambda v: npx.convolution(v[3], v[4], stride=1, pad=1, num_group=2,
                                                dilate=2),
    "deconv2d_adj": lambda v: npx.deconvolution(v[3], v[5], stride=2, pad=1, adj=2),
    "pool_max_full_nhwc": lambda v: npx.pooling(v[0], kernel=3, stride=2, pad=1,
                                                pooling_convention="full", layout="NHWC"),
    "pool_avg_full": lambda v: npx.pooling(v[3], kernel=3, stride=2, pad=1, pool_type="avg",
                                           pooling_convention="full",
                                           count_include_pad=False),
    "fused_conv_bn_relu": lambda v: npx.fused_conv_bn_relu(
        v[0], v[1], v[6], v[7], v[8], v[9], stride=(2, 2), pad=(1, 1), training=True)[0],
}


@pytest.mark.parametrize("case", sorted(CONV_CARD_CASES))
def test_conv_path_card_matches_cpu(card, case):
    """The conv path's forward and input gradients on the card (cuDNN,
    channels-last views) against the CPU at small shapes, f32: outputs
    within 1e-4 of their max-abs scale, gradients 1e-4 relative L2."""
    rng = onp.random.RandomState(90)
    arrays = [rng.randn(2, 9, 9, 4), rng.randn(6, 3, 3, 4), rng.randn(6),
              rng.randn(2, 4, 9, 9), rng.randn(6, 2, 3, 3), rng.randn(4, 3, 3, 3),
              rng.rand(6) + 0.5, rng.randn(6), rng.randn(6), rng.rand(6) + 0.5]
    res = []
    for dev in ("cuda", "cpu"):
        ts = [torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True)
              for a in arrays]
        out = CONV_CARD_CASES[case](ts)
        ct = torch.from_numpy(onp.random.RandomState(91).randn(*out.shape).astype("float32"))
        grads = torch.autograd.grad((out * ct.to(dev)).sum(), ts, allow_unused=True)
        res.append((out.detach().cpu().numpy(),
                    [None if g is None else g.cpu().numpy() for g in grads]))
    (out_c, g_c), (out_h, g_h) = res
    assert onp.abs(out_c - out_h).max() <= 1e-4 * onp.abs(out_h).max()
    for a, b in zip(g_c, g_h):
        assert (a is None) == (b is None)
        if a is not None and onp.abs(b).max() > 0:
            assert onp.linalg.norm(a - b) <= 1e-4 * onp.linalg.norm(b)


def test_flash_bthd_kernel_route_at_bert_shape(cuda):
    """``flash_attention_bthd`` at BERT-base pretraining's attention shape
    (B 8, T 512, 12 heads of 64, not causal, bf16, no mask, no dropout):
    one K1 launch forward and one K2 launch backward, their outputs and
    gradients against the plain versions by ``chip_smoke``'s rule."""
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(8, 512, 12, 64, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    int8_gemv.reset_launches()
    out = fa.flash_attention_bthd(*leaves)
    out.backward(do)
    counts = int8_gemv.launches()
    assert counts.get("flash_fwd") == 1 and counts.get("flash_bwd") == 1
    f = [t.float().transpose(1, 2) for t in (q, k, v, do)]
    po, plse = fa._reference_flash_forward(f[0], f[1], f[2], False, 0.125)
    grads = fa._reference_flash_backward(f[0], f[1], f[2], po, plse, f[3], False, 0.125)
    assert _within(out.detach().transpose(1, 2), po, torch.bfloat16)
    for a, want in zip(leaves, grads):
        assert _within(a.grad.transpose(1, 2), want, torch.bfloat16)


def test_attention_dropout_bits_card_match_cpu(cuda):
    """The einsum route's keep multipliers over (B, H, T, S) and the chunked
    route's per-chunk keep bits (T 640, both chunks): the card's bits are
    the CPU's, from a host key and from the key on the card."""
    from mxnet_tpu_torch import _prng
    key = _prng.fold_in(_prng.key(7), 2)
    want = fa._dropout_keep(key, (2, 3, 96, 128), 0.1, "cpu")
    for kk in (key, key.cuda()):
        assert torch.equal(fa._dropout_keep(kk, (2, 3, 96, 128), 0.1, "cuda").cpu(), want)
        for lo, n in ((0, 512), (512, 128)):
            got = fa._chunk_keep(kk, 0.1, 2, 3, 640, lo, n, "cuda").cpu()
            assert torch.equal(got, fa._chunk_keep(key, 0.1, 2, 3, 640, lo, n, "cpu"))


@pytest.mark.parametrize("T,mask", [(96, True), (640, True), (640, False)])
def test_flash_bthd_routes_card_match_cpu(cuda, T, mask):
    """The einsum route (T 96) and the chunked route (T 640) with a key
    mask and attention dropout, and the chunked route with dropout only, in
    f32 on the card against the CPU: outputs and gradients within 1e-5 of
    their max-abs scale."""
    from mxnet_tpu_torch import _prng
    rng = onp.random.RandomState(T)
    arrays = [rng.randn(2, T, 2, 32).astype("float32") for _ in range(4)]
    key_mask = onp.ones((2, T), "float32")
    key_mask[1, T // 2:] = 0.0
    res = {}
    for dev in ("cuda", "cpu"):
        q, k, v, do = (torch.from_numpy(a).to(dev) for a in arrays)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        km = torch.from_numpy(key_mask).to(dev) if mask else None
        out = fa.flash_attention_bthd(*leaves, key_mask=km,
                                      dropout=(_prng.fold_in(_prng.key(3), 1), 0.1))
        out.backward(do)
        res[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, float(b.abs().max()))


def test_optimizers_card_match_cpu(cuda):
    """Every registered optimizer, 3 updates of an f32 and a bf16 tensor on
    the card against the CPU (``chip_smoke``'s phase 12 (e) gates), SGLD's
    noise bit for bit."""
    out = chip_smoke.optimizers_card_vs_cpu(torch)
    assert out["sgld_noise_bitwise"]


def test_load_dict_keeps_card_parameters_on_card(cuda):
    """Host arrays loaded into an initialized block on the card stay on the
    card (``Parameter._load_init`` copies them there), as the JAX
    package's loaded parameters stay on its default device."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    with mx.gpu(0):
        net = nn.Dense(3, in_units=4)
        net.initialize()
    named = {"weight": onp.ones((3, 4), "float32"), "bias": onp.zeros(3, "float32")}
    net.load_dict(named)
    for name, p in net.collect_params().items():
        assert p.data()._data.is_cuda, name
        assert onp.array_equal(p.data().asnumpy(), named[name])


# ------------------------------------------------ the fleet's page migration

def _paged_pages(eng, toks):
    """The engine's cached full pages of ``toks`` read off its pools, one
    [pages, ...] tensor a pool (page axis first)."""
    pages, matched = eng._pages.match_prefix(toks, count=False)
    idx = torch.tensor(pages[:matched // eng.page_size], device="cuda")
    return [p.index_select(ax, idx).movedim(ax, 0) for p, ax in zip(eng._pools, eng._paxes)]


@pytest.mark.parametrize("max_len,kind", [(128, "fused_block_paged"),
                                          (512, "fused_block_paged_dma")])
def test_page_import_between_ticks_keeps_captures(cuda, max_len, kind):
    """A migration into a warmed replica that is decoding another request:
    the import lands between its ticks, in place (the pools keep their
    addresses, which the captured graphs hold), captures nothing, writes
    the source's page bits, and the replica then serves the prompt from the
    imported pages (K6 at L 128, K7 at L 512) with the tokens of the
    replica that prefilled them itself."""
    import json
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=512, dropout=0.0)
    model = quantize_net(GPTModel(cfg, device="cuda").init_weights(0, std=0.1),
                         fused_decode=True)
    rng = onp.random.RandomState(21)
    prompt, other = rng.randint(0, 1000, 70).tolist(), rng.randint(0, 1000, 30).tolist()
    kw = dict(max_batch_size=4, max_len=max_len, multi_token=4, page_size=16)
    src, dst = (InferenceEngine(model, **kw).start() for _ in range(2))
    try:
        src.warmup()
        dst.warmup()
        want = src.generate(prompt, 24, timeout=300).generated_ids
        doc = json.loads(json.dumps(src.export_pages(prompt)))
        before = dst.stats()
        ptrs = [p.data_ptr() for p in dst._pools]
        busy = dst.submit(other, 64)                  # the replica is decoding
        res = dst.import_pages(doc)
        assert res["adopted"] == res["received"] == 4
        for a, b in zip(_paged_pages(src, prompt), _paged_pages(dst, prompt)):
            assert torch.equal(a, b)
        int8_gemv.reset_launches()
        got = dst.generate(prompt, 24, timeout=300).generated_ids
        assert busy.result(timeout=300).ok
        after = dst.stats()
        assert got == want
        assert int8_gemv.launches().get(kind, 0) > 0
        assert after["captures"] == before["captures"]
        assert after["pages"]["prefix_tokens_saved"] - before["pages"]["prefix_tokens_saved"] == 64
        assert [p.data_ptr() for p in dst._pools] == ptrs
    finally:
        src.shutdown(timeout=300)
        dst.shutdown(timeout=300)


def test_bf16_wire_through_card_pools(cuda):
    """bf16 pages off the card go over the wire as raw 2-byte words under
    the dtype string "bfloat16", decode to bf16 tensors and land in another
    replica's bf16 pools bit for bit; that replica then serves the
    source's tokens through K6's bf16 lane."""
    import json

    from mxnet_tpu_torch.kvstore.comm import decode_kv_pages
    cfg = GPTConfig(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
                    max_position_embeddings=128, dtype=torch.bfloat16, dropout=0.0)
    model = quantize_net(GPTModel(cfg, device="cuda").init_weights(0, std=0.1),
                         fused_decode=True)
    prompt = onp.random.RandomState(22).randint(0, 1000, 50).tolist()
    kw = dict(max_batch_size=2, max_len=128, multi_token=4, page_size=16)
    src, dst = (InferenceEngine(model, **kw).start() for _ in range(2))
    try:
        src.warmup()
        dst.warmup()
        want = src.generate(prompt, 16, timeout=300).generated_ids
        doc = json.loads(json.dumps(src.export_pages(prompt)))
        assert {a["dtype"] for p in doc["pages"] for a in p["payload"]} == {"bfloat16"}
        _, pages = decode_kv_pages(doc)
        assert all(t.dtype == torch.bfloat16 for _, _, payload in pages for t in payload)
        captures = dst.stats()["captures"]
        assert dst.import_pages(doc)["adopted"] == 3
        for a, b in zip(_paged_pages(src, prompt), _paged_pages(dst, prompt)):
            assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16),
                                                             b.view(torch.int16))
        int8_gemv.reset_launches()
        assert dst.generate(prompt, 16, timeout=300).generated_ids == want
        lanes = int8_gemv.dtype_lanes()
        assert sum(n for k, n in lanes.items()
                   if k.startswith("fused_block_paged:") and k.endswith("kv_bf16")) > 0
        assert dst.stats()["captures"] == captures
    finally:
        src.shutdown(timeout=300)
        dst.shutdown(timeout=300)


# ------------------------------------------------------ the input path
def _input_batches(n=6, seed=30):
    rng = onp.random.RandomState(seed)
    return [(rng.rand(8, 5).astype("float32"), rng.randint(0, 3, 8).astype("int64"))
            for _ in range(n)]


def test_prefetched_cuda_batches_equal_host_batches(cuda):
    """Batches staged on the card by the prefetcher's stream, and those a
    pinned forked-worker DataLoader uploads, equal the host batches; the
    staged copies ran on the prefetcher's own stream, not the consumer's."""
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.pipeline import DevicePrefetcher
    host = _input_batches()
    it = DevicePrefetcher(iter(host), sharding=("cuda", torch.device("cuda")), depth=2)
    assert it.stream is not None and it.stream != torch.cuda.current_stream()
    got = list(it)
    assert len(got) == len(host)
    for (x, y), (hx, hy) in zip(got, host):
        assert x.is_cuda and y.is_cuda
        assert torch.equal(x.cpu(), torch.from_numpy(hx)) and torch.equal(y.cpu(), torch.from_numpy(hy))
    X = onp.concatenate([b[0] for b in host])
    Y = onp.concatenate([b[1] for b in host])
    for kw in (dict(num_workers=2, thread_pool=False, pin_memory=True), dict(num_workers=2)):
        loader = DataLoader(ArrayDataset(X, Y), batch_size=8, **kw)
        for (x, y), (hx, hy) in zip(loader.as_device_iterator(depth=2), host):
            assert x._data.is_cuda
            assert onp.array_equal(x.asnumpy(), hx) and onp.array_equal(y.asnumpy(), hy)


def test_prefetcher_debug_guard_raises_on_the_card(cuda):
    """Under debug guards a producer that mutates a buffer it handed over
    to the card's prefetcher raises ValueError at the consumer."""
    from mxnet_tpu_torch.analysis import guards
    from mxnet_tpu_torch.pipeline import DevicePrefetcher
    guards.enable_debug()
    try:
        buf = onp.zeros((256, 256), onp.float32)

        def reusing():
            for i in range(8):
                buf[...] = i
                yield buf
        it = DevicePrefetcher(reusing(), sharding="cuda", depth=2)
        assert float(next(it).sum()) == 0.0
        with pytest.raises(ValueError, match="read-only"):
            for _ in range(8):
                next(it)
        it.close()
        assert buf.flags.writeable
    finally:
        guards.disable_debug()


def test_prefetched_trainstep_bitwise_on_the_card(cuda):
    """A TrainStep on the card fed through the prefetcher equals the same
    batches fed by hand as CUDA tensors, bit for bit: losses, parameters
    and Adam state."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    host = _input_batches(8)
    X = onp.concatenate([b[0] for b in host])
    Y = onp.concatenate([b[1] for b in host])

    def run(prefetched):
        mx.random.seed(4)
        net = nn.HybridSequential()
        net.add(nn.Dense(64, in_units=5, activation="relu"), nn.Dense(3))
        net.initialize()
        step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                                  mx.optimizer.Adam(learning_rate=0.01),
                                  example_inputs=[mx.np.array(X[:8])], block_every=2)
        if prefetched:
            loader = DataLoader(ArrayDataset(X, Y), batch_size=8, num_workers=2,
                                thread_pool=False, pin_memory=True)
            losses = [step.step(x, y) for x, y in
                      loader.as_device_iterator(sharding=step.input_shardings(), depth=2)]
        else:
            losses = [step.step(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
                      for x, y in host]
        step.drain()
        return ([torch.stack(losses).cpu()] + [p.detach().cpu() for _, p in step._params]
                + [s.cpu() for st in step._states for s in st])

    fed, hand = run(True), run(False)
    assert len(fed) == len(hand) and all(torch.equal(a, b) for a, b in zip(fed, hand))


def test_prefetcher_stream_contract_under_slow_copies(cuda):
    """With copies slow against the consumer, every batch the prefetcher
    stages equals its source: a spin on the prefetcher's stream before
    each copy (the consumer's wait on the copy's event) and a spin on the
    consumer's stream before each read of a dropped batch (record_stream
    keeps its block from a later batch). chip_smoke's phase 14 gate."""
    import types

    import chip_smoke as cs
    report = cs.stream_hold(torch, types.SimpleNamespace(seed=0))
    assert all(report["wait"]) and all(report["reuse"])
    assert len(report["wait"]) == len(report["reuse"]) == cs.DT_HOLD_BATCHES


# ------------------------------------------------------- the NMS sweep kernel
def _nms_case(case, B=3, n=200, seed=0):
    """Sorted boxes [B, n, 4] (corners), ids [B, n] and valid [B, n] of an
    adversarial set."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, n, 2, generator=g)
    wh = 0.05 + torch.rand(B, n, 2, generator=g) * 0.4
    if case == "all_overlapping":
        xy = torch.zeros(B, n, 2) + torch.rand(B, n, 2, generator=g) * 0.01
        wh = torch.ones(B, n, 2)
    elif case == "all_disjoint":
        xy = torch.stack([torch.arange(n).float() * 2, torch.zeros(n)], -1).expand(B, n, 2)
        wh = torch.ones(B, n, 2)
    boxes = torch.cat([xy, xy + wh], -1)
    ids = torch.randint(0, 3, (B, n), generator=g).float()
    score = torch.rand(B, n, generator=g)
    if case == "ties":
        score = (score * 4).round() / 4
    valid = score > 0.1
    return boxes, ids, valid


@pytest.mark.parametrize("case,n,rows", [("random", 200, None), ("all_overlapping", 130, None),
                                          ("all_disjoint", 96, None), ("ties", 200, 64),
                                          ("random", 8732, 400), ("random", 1000, 1000)])
def test_nms_sweep_kernel_matches_plain(cuda, case, n, rows):
    """Bit for bit the plain loop over the same decision matrix (the
    kernel's contract), n not a multiple of 64 in most cases, and a
    decision matrix cut to its top rows."""
    from mxnet_tpu_torch.ops import contrib
    boxes, ids, valid = _nms_case(case, B=3 if n < 5000 else 2, n=n)
    if rows is not None:
        valid[:, rows:] = False
    for use_ids in (True, False):
        dec = contrib.nms_decisions(boxes.cuda(), 0.45, ids.cuda() if use_ids else None, rows)
        before = int8_gemv.launches().get("nms_sweep", 0)
        got = contrib.nms_sweep(dec, valid.cuda())
        torch.cuda.synchronize()
        assert int8_gemv.launches().get("nms_sweep", 0) == before + 1
        want = contrib.nms_sweep_plain(dec, valid.cuda())
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), contrib.nms_sweep_plain(dec.cpu(), valid))


def test_nms_sweep_rejects_what_it_cannot_take(cuda):
    from mxnet_tpu_torch.ops import contrib
    dec = torch.zeros(2, 5, 5, dtype=torch.bool, device="cuda")
    with pytest.raises(MXNetError, match="bool"):
        contrib.nms_sweep(dec.to(torch.uint8), torch.ones(2, 5, dtype=torch.bool,
                                                          device="cuda"))
    with pytest.raises(MXNetError, match="tensors on"):
        contrib.nms_sweep(dec, torch.ones(2, 5, dtype=torch.bool))
    with pytest.raises(MXNetError):
        contrib.nms_sweep(torch.zeros(2, 6, 5, dtype=torch.bool, device="cuda"),
                          torch.ones(2, 5, dtype=torch.bool, device="cuda"))


def test_box_nms_and_detection_launch_the_sweep(cuda):
    from mxnet_tpu_torch import numpy_extension as npx2
    g = torch.Generator().manual_seed(3)
    data = torch.cat([torch.randint(0, 3, (300, 1), generator=g).float(),
                      torch.rand(300, 1, generator=g), torch.rand(300, 2, generator=g)], 1)
    data = torch.cat([data, data[:, 2:4] + 0.3], 1)
    before = int8_gemv.launches().get("nms_sweep", 0)
    got = npx2.box_nms(data.cuda(), overlap_thresh=0.5, valid_thresh=0.05, id_index=0)
    want = npx2.box_nms(data, overlap_thresh=0.5, valid_thresh=0.05, id_index=0)
    assert int8_gemv.launches().get("nms_sweep", 0) == before + 1
    assert torch.equal(got.cpu(), want)


# ------------------------------------------------------------ cuDNN RNNs
@pytest.mark.parametrize("cls,kw", [("LSTM", {"num_layers": 2}), ("GRU", {"bidirectional": True}),
                                    ("RNN", {"activation": "tanh"}),
                                    ("LSTM", {"num_layers": 2, "dropout": 0.5,
                                              "bidirectional": True})])
def test_cudnn_rnn_matches_cpu_port(cuda, cls, kw):
    """cuDNN's fused RNN a layer against the port's CPU loop: outputs,
    states and gradients (f32, TF32 off) within 1e-4, the dropout masks
    equal (the same outputs)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import rnn
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    x = torch.randn(7, 3, 24, generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        mx.random.seed(1)
        net = getattr(rnn, cls)(32, input_size=24, **kw)
        net.initialize(device=mx.Device(dev))
        xd = mx.np.array(x.numpy(), device=mx.Device(dev))
        xd.attach_grad()
        with autograd.record(train_mode=bool(kw.get("dropout"))):
            out = net(xd)
            (out * out).sum().backward()
        res[dev] = [out.asnumpy(), xd.grad.asnumpy()] + [
            p.grad().asnumpy() for p in net.collect_params().values()]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert onp.abs(a - b).max() <= 1e-4 * max(onp.abs(b).max(), 1e-3)


# ---------------------------------------------------------- row-sparse, samplers

def test_lazy_adam_on_the_one_billion_word_table(cuda):
    """Lazy Adam through gluon.Trainer on Embedding(793471, 512,
    sparse_grad=True): no sparse step peaks above table + moments + 0.5 GB
    over what was allocated before the table (a [V, D] f32 gradient alone
    is 1.62 GB), rows no batch touched keep weights and moments bit for
    bit, touched rows match the CPU port fed the same ids (1e-5)."""
    import types
    gc.collect()
    torch.cuda.empty_cache()
    out = chip_smoke.obw_table(torch, types.SimpleNamespace(seed=0), "cuda", steps=3)
    assert max(out["peak_gb_steps"]) < out["peak_limit_gb"]
    assert out["untouched_rows_equal"] and out["untouched_moments_zero"]
    assert out["touched_vs_cpu_rel"] <= chip_smoke.OBW_CPU_TOL


def test_rejection_samplers_on_the_card_equal_the_cpu(cuda):
    """Every rejection sampler with device='cuda' draws the CPU port's bits
    (both from the host stream) and passes its goodness-of-fit test."""
    import types
    out = chip_smoke.sampler_checks(torch, types.SimpleNamespace(seed=0), "cuda", draws=4000)
    assert all(r["same_bits_as_cpu"] for r in out.values())


def test_embedding_cut_allocates_no_table_gradient(cuda):
    """A row-sparse backward through the tape's embedding cut on the card
    allocates nothing table-sized; the same table with a dense gradient
    does."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    V, D = 200000, 256
    ids = mx.np.array(onp.random.RandomState(0).randint(0, V, (64, 8)).astype("int32"),
                      device=mx.gpu())
    peaks = {}
    for sparse in (True, False):
        emb = mx.gluon.nn.Embedding(V, D, sparse_grad=sparse, weight_initializer="zeros")
        emb.initialize(device=mx.gpu())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with autograd.record():
            (emb(ids) ** 2).sum().backward()
        torch.cuda.synchronize()
        peaks[sparse] = torch.cuda.max_memory_allocated() - base
        del emb
    table = V * D * 4
    assert peaks[True] < table / 10 and peaks[False] >= table
