"""paddle_tpu_torch.text.models — GPT (``gpt``)."""
from .gpt import (GPTAttention, GPTBlock, GPTEmbeddings,  # noqa: F401
                  GPTForPretraining, GPTLMHead, GPTMLP, GPTModel, gpt_1p3b,
                  gpt_pipeline_descs, gpt_tiny, pipeline_state_from_dense)

__all__ = ["GPTAttention", "GPTBlock", "GPTEmbeddings", "GPTForPretraining",
           "GPTLMHead", "GPTMLP", "GPTModel", "gpt_1p3b", "gpt_pipeline_descs",
           "gpt_tiny", "pipeline_state_from_dense"]
