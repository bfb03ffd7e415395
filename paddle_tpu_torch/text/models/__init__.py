"""paddle_tpu_torch.text.models — GPT (``gpt``) and BERT/ERNIE
(``bert``)."""
from .gpt import (GPTAttention, GPTBlock, GPTEmbeddings,  # noqa: F401
                  GPTForPretraining, GPTLMHead, GPTMLP, GPTModel, gpt_1p3b,
                  gpt_pipeline_descs, gpt_tiny, pipeline_state_from_dense)
from .bert import (BertEmbeddings, BertEncoderLayer,  # noqa: F401
                   BertForPretraining, BertForSequenceClassification,
                   BertModel, BertPooler, BertPretrainingHeads,
                   ErnieForPretraining, ErnieModel, bert_base, bert_large)

__all__ = ["GPTAttention", "GPTBlock", "GPTEmbeddings", "GPTForPretraining",
           "GPTLMHead", "GPTMLP", "GPTModel", "gpt_1p3b", "gpt_pipeline_descs",
           "gpt_tiny", "pipeline_state_from_dense",
           "BertEmbeddings", "BertEncoderLayer", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "BertPooler",
           "BertPretrainingHeads", "ErnieForPretraining", "ErnieModel",
           "bert_base", "bert_large"]
