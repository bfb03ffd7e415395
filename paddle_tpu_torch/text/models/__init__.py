"""paddle_tpu_torch.text.models — GPT (``gpt``)."""
from .gpt import (GPTAttention, GPTBlock, GPTEmbeddings,  # noqa: F401
                  GPTForPretraining, GPTLMHead, GPTMLP, GPTModel, gpt_1p3b,
                  gpt_tiny)

__all__ = ["GPTAttention", "GPTBlock", "GPTEmbeddings", "GPTForPretraining",
           "GPTLMHead", "GPTMLP", "GPTModel", "gpt_1p3b", "gpt_tiny"]
