"""Transformer model families of the port (counterpart of
``mxnet_tpu/models``): the decoder-only GPT-2 and Llama, with ``generate``
attached to both causal LMs as a method, the encoder-only BERT, the
encoder-decoder T5 and the Vision Transformer."""
from .bert import (BERT_BASE, BERT_TINY, BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .generation import generate
from .gpt import GPT2_SMALL, GPT_TINY, GPTConfig, GPTModel
from .llama import (LLAMA3_8B, LLAMA_TINY, LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaStackedDecoder)
from .t5 import T5_SMALL, T5_TINY, T5Config, T5Model
from .vit import VIT_B16, VIT_TINY, ViTConfig, ViTModel


def _generate_method(self, input_ids, max_new_tokens, **kwargs):
    return generate(self, input_ids, max_new_tokens, **kwargs)


GPTModel.generate = _generate_method
LlamaForCausalLM.generate = _generate_method
del _generate_method

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "LlamaStackedDecoder",
           "LLAMA3_8B", "LLAMA_TINY",
           "BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining", "BERT_BASE", "BERT_TINY",
           "GPTConfig", "GPTModel", "GPT2_SMALL", "GPT_TINY",
           "ViTConfig", "ViTModel", "VIT_B16", "VIT_TINY",
           "T5Config", "T5Model", "T5_SMALL", "T5_TINY", "generate"]
