"""``chip_smoke.py`` phase 14 (``data_train``) rehearsed on the CPU at small
sizes, through the same functions and gates the card runs: (a) GPT-2 fed
through a forked-worker ``DataLoader`` and the prefetcher, bit for bit its
hand-fed twin, the plain K1/K2 once a layer a step and the plain attention
never; (c) ResNet-50 from a ``.npy`` RecordIO through forked workers, the
transforms and ``Estimator.fit``; (d) the MNIST program with the CPU in
both places. The card-only measurements ((a)'s profiled step, (b) and the
H2D rates) print "not measured". A gate that fails raises
``SmokeFailure``."""
import types

import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import GPTConfig

ARGS = types.SimpleNamespace(seed=0)


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def test_gpt2_fed_from_the_loader(monkeypatch):
    monkeypatch.setattr(cs, "LAYERS", 2)
    monkeypatch.setattr(cs, "TRAIN_B", 2)
    monkeypatch.setattr(cs, "TRAIN_T", 256)       # the flash route needs T >= 256
    monkeypatch.setattr(cs, "DT_BATCHES", 3)
    monkeypatch.setattr(cs, "gpt2_train_config", lambda dtype, dropout: GPTConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, max_position_embeddings=256,
        dropout=dropout, dtype=dtype))
    counts = cs.gpt2_from_loader(torch, ARGS, device="cpu")
    assert counts["flash_fwd"] == counts["flash_bwd"] == 2 * 3


def test_resnet50_from_files(monkeypatch):
    monkeypatch.setattr(cs, "DT_RN_BATCHES", 4)
    monkeypatch.setattr(cs, "DT_RN_STEPS", 2)
    report = cs.resnet_from_files(torch, ARGS, device="cpu", hw=32, B=2, classes=10)
    assert report["running_means_moved"] == report["running_means"] > 0
    assert report["estimator"]["batches"] == cs.DT_RN_FIT_BATCHES


def test_mnist_program(monkeypatch):
    monkeypatch.setattr(cs, "DT_MNIST_N", 512)
    report = cs.mnist_card_vs_cpu(torch, ARGS, card="cpu")
    assert report["card_workers_2"]["max_rel_to_cpu"] == 0.0
