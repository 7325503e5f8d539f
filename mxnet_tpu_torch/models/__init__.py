"""Transformer model families of the port (counterpart of
``mxnet_tpu/models``): GPT-2 and Llama, with ``generate`` attached to both
causal LMs as a method, and the Vision Transformer. BERT and T5 are
ported in later slices (ROADMAP Queue 1 item 8)."""
from .generation import generate
from .gpt import GPT2_SMALL, GPT_TINY, GPTConfig, GPTModel
from .llama import (LLAMA3_8B, LLAMA_TINY, LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaStackedDecoder)
from .vit import VIT_B16, VIT_TINY, ViTConfig, ViTModel


def _generate_method(self, input_ids, max_new_tokens, **kwargs):
    return generate(self, input_ids, max_new_tokens, **kwargs)


GPTModel.generate = _generate_method
LlamaForCausalLM.generate = _generate_method
del _generate_method

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "LlamaStackedDecoder",
           "LLAMA3_8B", "LLAMA_TINY",
           "GPTConfig", "GPTModel", "GPT2_SMALL", "GPT_TINY", "generate",
           "ViTConfig", "ViTModel", "VIT_B16", "VIT_TINY"]
