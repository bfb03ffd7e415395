"""BERT/ERNIE: the bidirectional encoder with the MLM + NSP pretraining
heads.

Port of ``paddle_tpu/text/models/bert.py``: ``BertEmbeddings`` (word,
position and token-type embeddings, LayerNorm, dropout),
``BertEncoderLayer`` (post-LN: residual then LayerNorm, with GPT's
attention and MLP blocks, attention bidirectional), ``BertPooler``,
``BertModel``, ``BertPretrainingHeads`` (the MLM transform and the vocab
projection tied to the word embedding, the NSP head),
``BertForPretraining`` with ``loss`` (masked-LM cross entropy through
``ParallelCrossEntropy`` plus the NSP cross entropy),
``BertForSequenceClassification``, the ``ErnieModel``/``ErnieForPretraining``
aliases and the ``bert_base``/``bert_large`` configs.

Attention goes through ``F.scaled_dot_product_attention`` with
``is_causal=False``, so on the card at S >= 512 it runs the flash kernels
(``csrc/flash_attention.cu``) non-causal; below that the gate refuses and
the plain attention runs, counted as a fallback, as in the reference.

The decoder weight IS the word embedding's parameter: the heads keep the
embedding module as a plain attribute and read its weight, so the weight
is registered (and named) once, under
``bert.embeddings.word_embeddings.weight``, as the reference's
``named_parameters`` dedupes it by identity, and its gradient sums the
lookup's and the projection's. The MLM logits are a plain ``matmul``
against it. ``tensor_parallel=True`` builds the vocab-parallel word
embedding and GPT's Megatron attention and MLP; the tied projection then
runs behind ``copy_to_model_parallel`` on this rank's vocab rows, the
decoder bias is split the same way (``("model",)``), and the loss is
``ParallelCrossEntropy`` on the vocab-split logits.
"""
from __future__ import annotations

import torch

from ... import nn
from ...distributed.meta_parallel.parallel_layers.mp_layers import (
    MODEL_AXIS, ParallelCrossEntropy, VocabParallelEmbedding, _split_param)
from ...nn import functional as F
from ...nn.initializer import Normal
from ...nn.layer import Layer
from .gpt import GPTAttention, GPTMLP, _head

__all__ = [
    "BertEmbeddings", "BertEncoderLayer", "BertModel", "BertPooler",
    "BertPretrainingHeads", "BertForPretraining",
    "BertForSequenceClassification", "ErnieModel", "ErnieForPretraining",
    "bert_base", "bert_large",
]


class BertEmbeddings(Layer):
    """word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 layer_norm_epsilon=1e-12, tensor_parallel=True):
        super().__init__()
        emb_cls = VocabParallelEmbedding if tensor_parallel else nn.Embedding
        self.word_embeddings = emb_cls(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size,
                                       epsilon=layer_norm_epsilon)
        self.dropout = nn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertEncoderLayer(Layer):
    """Post-LN encoder layer; attention is bidirectional."""

    def __init__(self, hidden_size, num_heads, intermediate_size=None,
                 attn_dropout=0.1, hidden_dropout=0.1,
                 layer_norm_epsilon=1e-12, tensor_parallel=True,
                 mp_degree=1):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.attn = GPTAttention(hidden_size, num_heads, attn_dropout,
                                 hidden_dropout, tensor_parallel, mp_degree,
                                 causal=False)
        self.ln_1 = nn.LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        self.mlp = GPTMLP(hidden_size, intermediate_size, hidden_dropout,
                          tensor_parallel)
        self.ln_2 = nn.LayerNorm(hidden_size, epsilon=layer_norm_epsilon)

    def forward(self, x, attn_mask=None):
        x = self.ln_1(x + self.attn(x, attn_mask))
        return self.ln_2(x + self.mlp(x))


class BertPooler(Layer):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, hidden_states):
        return torch.tanh(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    """Bidirectional encoder trunk + pooler; returns (sequence, pooled)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=512, type_vocab_size=2,
                 attn_dropout=0.1, hidden_dropout=0.1,
                 layer_norm_epsilon=1e-12, tensor_parallel=True,
                 mp_degree=1, with_pool=True):
        super().__init__()
        self.hidden_size = hidden_size
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, hidden_dropout, layer_norm_epsilon,
            tensor_parallel)
        self.encoder = nn.LayerList([
            BertEncoderLayer(hidden_size, num_heads, intermediate_size,
                             attn_dropout, hidden_dropout,
                             layer_norm_epsilon, tensor_parallel, mp_degree)
            for _ in range(num_layers)])
        self.pooler = BertPooler(hidden_size) if with_pool else None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attn_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask)
        pooled = self.pooler(x) if self.pooler is not None else None
        return x, pooled


class BertPretrainingHeads(Layer):
    """MLM transform + the (tied) vocab projection, and the NSP head.
    ``embedding``: the word-embedding module whose weight the projection
    reads (None: an untied ``(vocab, hidden)`` weight of its own)."""

    def __init__(self, hidden_size, vocab_size, embedding=None,
                 layer_norm_epsilon=1e-12, tensor_parallel=True):
        super().__init__()
        self.transform = nn.Linear(hidden_size, hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size,
                                       epsilon=layer_norm_epsilon)
        # a plain attribute, not a submodule: the tied weight is owned (and
        # named) by the trunk
        self.__dict__["_tied"] = embedding
        if embedding is not None:
            vocab_size = embedding.num_embeddings   # the whole vocab
        else:
            _split_param(self, "decoder_weight", (vocab_size, hidden_size),
                         0 if tensor_parallel else None, Normal(0.0, 0.02),
                         (MODEL_AXIS, None) if tensor_parallel else None)
        # the logits arrive vocab-split under tensor parallelism: the bias
        # splits the same way
        _split_param(self, "decoder_bias", (vocab_size,),
                     0 if tensor_parallel else None, None,
                     (MODEL_AXIS,) if tensor_parallel else None,
                     is_bias=True)
        self.seq_relationship = nn.Linear(hidden_size, 2)

    def __getattr__(self, name):
        tied = self.__dict__.get("_tied")
        if name == "decoder_weight" and tied is not None:
            return tied.weight                     # (vocab, hidden)
        return super().__getattr__(name)

    def forward(self, sequence_output, pooled_output):
        h = self.layer_norm(F.gelu(self.transform(sequence_output),
                                   approximate=True))
        mlm_logits = _head(h, self.decoder_weight) + self.decoder_bias
        nsp_logits = self.seq_relationship(pooled_output)
        return mlm_logits, nsp_logits


class BertForPretraining(Layer):
    """MLM + NSP pretraining objective."""

    def __init__(self, bert: BertModel = None, tensor_parallel=True,
                 **kwargs):
        super().__init__()
        self.bert = bert or BertModel(tensor_parallel=tensor_parallel,
                                      **kwargs)
        self.cls = BertPretrainingHeads(
            self.bert.hidden_size, 0,
            embedding=self.bert.embeddings.word_embeddings,
            tensor_parallel=tensor_parallel)
        self.parallel_loss = ParallelCrossEntropy()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attn_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attn_mask)
        return self.cls(seq, pooled)

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
             ignore_index=-100):
        """Masked-LM CE (the mean over the labelled positions) + NSP CE,
        float32."""
        mlm_labels = torch.as_tensor(mlm_labels, device=mlm_logits.device)
        nsp_labels = torch.as_tensor(nsp_labels, device=nsp_logits.device)
        per_tok = self.parallel_loss(mlm_logits, mlm_labels.clamp(min=0))
        mask = (mlm_labels != ignore_index).to(per_tok.dtype)
        mlm = (per_tok * mask).sum() / mask.sum().clamp(min=1.0)
        nsp = F.cross_entropy(nsp_logits, nsp_labels,
                              reduction="none").mean()
        return mlm + nsp


class BertForSequenceClassification(Layer):
    def __init__(self, bert: BertModel = None, num_classes=2, dropout=0.1,
                 tensor_parallel=False, **kwargs):
        super().__init__()
        self.bert = bert or BertModel(tensor_parallel=tensor_parallel,
                                      **kwargs)
        self.dropout = nn.Dropout(dropout)
        self.classifier = nn.Linear(self.bert.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attn_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attn_mask)
        return self.classifier(self.dropout(pooled))


# ERNIE is the BERT architecture with knowledge-masked pretraining data; the
# network classes are shared
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining


def bert_base(**kw):
    cfg = dict(vocab_size=30522, hidden_size=768, num_layers=12,
               num_heads=12, max_position_embeddings=512)
    cfg.update(kw)
    return cfg


def bert_large(**kw):
    cfg = dict(vocab_size=30522, hidden_size=1024, num_layers=24,
               num_heads=16, max_position_embeddings=512)
    cfg.update(kw)
    return cfg
