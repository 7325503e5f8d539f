"""``chip_smoke.py``'s phase 13 (``fleet_serve``) rehearsed on the CPU
through its own functions and gates, at a small depth: a 2-layer, 128-wide
int8 GPT with fused decode (and its bf16 twin, calibrated 'naive') on
paged replicas behind HTTP frontends: the affinity router against a
reference engine, migrations onto K6 and K7 replicas (the plain versions
here) with a tampered doc, bf16 pages on the wire, a preemption rescue,
the prefill / decode pipeline, autoscaling 1 -> 2 -> 1 with drain-bounce
replays, and tenants, and the fleet's launch counts against the
process-wide ones. Only the card's lane counts are not checked here (the
CPU records launch kinds, not lanes)."""
import dataclasses
import types

import numpy as onp
import torch

import chip_smoke as cs
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.ops.int8_gemv import launches

SMALL = dict(FLEET_NEW=16, FLEET_MIGRATE=(112, 160), FLEET_BURST=6, FLEET_HOP_ROUNDS=1,
             HTTP_NEW=16, FLEET_RESCUE=dict(pages=24, prompts=4, prompt_len=80, new=32))


def test_fleet_phase_rehearsal(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(cs, name, value)
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                    max_position_embeddings=1024, dropout=0.0)
    rng = onp.random.RandomState(0)
    with torch.no_grad():
        net = quantize_net(GPTModel(cfg, device="cpu").init_weights(0), fused_decode=True)
        bf16 = GPTModel(dataclasses.replace(cfg, dtype=torch.bfloat16),
                        device="cpu").init_weights(1)
        bf16 = quantize_net(bf16, calib_mode="naive", fused_decode=True,
                            calib_data=[rng.randint(0, 512, (8, 32)).astype(onp.int32)] * 2)
    counts = cs.fleet_serve(torch, types.SimpleNamespace(seed=0), net, bf16)
    process = launches()
    for kind in ("gemv", "fused_block_paged", "fused_block_paged_dma", "fused_head"):
        assert counts.get(kind, 0) > 0, kind
        # the fleet's launches leave out the reference engine, the
        # migration sources, the timings and the warm-ups
        assert counts[kind] < process[kind], (kind, counts[kind], process[kind])
