"""``chip_smoke.py`` phase 12 (``nlp_train``) rehearsed on the CPU at small
sizes, through the same functions and gates the card runs: (a) the
fine-tuning run with its profiled split (host times here) and the
metrics from tensors against host copies, (b) BERT pretraining at T 512
(the plain K1/K2 once a layer a step, the inference and key-mask checks),
(c) the card-against-CPU comparison with the CPU in both places, (d) T5
and (e) the optimizers. A gate that fails raises ``SmokeFailure``."""
import types

import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.models import T5_TINY, BertConfig

ARGS = types.SimpleNamespace(seed=0)
SMALL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)


def test_bert_ft_and_split(monkeypatch):
    monkeypatch.setattr(cs, "BERT_FT_B", 4)
    monkeypatch.setattr(cs, "BERT_FT_T", 32)
    report = cs.bert_ft(torch, ARGS, device="cpu", steps=2, trials=2, cfg=BertConfig(**SMALL))
    split = report["profiled_step"]
    assert set(split["ms"]) == set(cs.NLP_SPLIT)
    # every category is reached on BERT's step
    assert all(split["ms"][k] > 0 for k in cs.NLP_SPLIT)
    assert report["attention_mask_draws"] == SMALL["num_layers"] * 6


def test_bert_pretrain():
    cfg = BertConfig(**dict(SMALL, hidden_size=128, intermediate_size=256),
                     attention_dropout=0.0)
    _, n1, n2 = cs.bert_pretrain(torch, ARGS, None, None, device="cpu", cfg=cfg, B=2, T=512,
                                 valid=384)
    assert n1 == n2 == cfg.num_layers * cs.BERT_PT_STEPS


@pytest.mark.parametrize("part", ["card_vs_cpu", "t5", "optimizers"])
def test_other_parts(part):
    if part == "card_vs_cpu":
        out = cs.nlp_card_vs_cpu(torch, ARGS, card="cpu")
        assert out["bert_kernels_T288"]["card_launches"]["flash_fwd"] == 4
    elif part == "t5":
        cs.t5_train(torch, ARGS, device="cpu", cfg=T5_TINY, B=2, S=24, T=16)
    else:
        assert cs.optimizers_card_vs_cpu(torch, card="cpu")["sgld_noise_bitwise"]
