from .generation import generate
from .gpt import GPT2_SMALL, GPT_TINY, GPTConfig, GPTModel

__all__ = ["GPTConfig", "GPTModel", "GPT2_SMALL", "GPT_TINY", "generate"]
