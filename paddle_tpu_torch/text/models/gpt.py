"""GPT for pretraining on one device.

Port of ``paddle_tpu/text/models/gpt.py`` for ``tensor_parallel=False``:
``GPTEmbeddings``, ``GPTAttention``, ``GPTMLP``, ``GPTBlock``, ``GPTModel``,
``GPTLMHead`` (tied to the word embedding), ``GPTForPretraining`` with
``forward`` and ``fused_head_loss``, and the ``gpt_tiny``/``gpt_1p3b``
configs. Attention goes through ``F.scaled_dot_product_attention``, so on
the card at S >= 512 it runs the flash kernels
(``csrc/flash_attention.cu``). ``fused_head_loss`` takes the chunked CE by
default, as the reference does, and the fused CE kernels
(``csrc/fused_ce.cu``) with ``ce_kernel="pallas"`` or, on the card,
``"auto"``. The dense path is ``forward`` (bf16 logits) and
``nn.functional.cross_entropy``.

The QKV projection is split per head, interleaved, as the reference splits
it: ``reshape(b, s, heads, 3*hd)`` then three ``hd`` slices, so that
``qkv_proj`` weights carry over unchanged. The slices are strided views;
the flash kernels read them in place.

``tensor_parallel=True`` (the vocab-parallel embedding, column/row
parallel linears and ``ParallelCrossEntropy``), the pipeline descriptors,
context parallelism and the dense-logits ``loss`` wait for the
hybrid-parallel queue of ``ROADMAP.md``; asking for them raises.
"""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from ...nn.initializer import Normal
from ...nn.layer import Layer

__all__ = ["GPTEmbeddings", "GPTAttention", "GPTMLP", "GPTBlock",
           "GPTModel", "GPTLMHead", "GPTForPretraining", "gpt_tiny",
           "gpt_1p3b"]


def _single_device(tensor_parallel):
    if tensor_parallel:
        raise NotImplementedError(
            "tensor_parallel=True needs the hybrid-parallel layers, which "
            "wait in ROADMAP.md (Queue 1, hybrid parallelism); pass "
            "tensor_parallel=False")


class GPTEmbeddings(Layer):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=1024,
                 hidden_dropout_prob=0.1, initializer_range=0.02,
                 tensor_parallel=True):
        super().__init__()
        _single_device(tensor_parallel)
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size)
        self.dropout = nn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            s = input_ids.shape[-1]
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        w = self.word_embeddings(input_ids)
        p = self.position_embeddings(position_ids)
        return self.dropout(w + p)


class GPTAttention(Layer):
    def __init__(self, hidden_size, num_heads, attn_dropout=0.1,
                 resid_dropout=0.1, tensor_parallel=True, mp_degree=1,
                 use_flash=True, causal=True):
        super().__init__()
        _single_device(tensor_parallel)
        self.num_heads = num_heads
        self.causal = causal
        self.head_dim = hidden_size // num_heads
        self.qkv_proj = nn.Linear(hidden_size, 3 * hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        self.attn_dropout = attn_dropout
        self.resid_dropout = nn.Dropout(resid_dropout)

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x)                     # (b, s, 3*h)
        local_h = qkv.shape[-1] // 3
        heads = local_h // self.head_dim
        qkv = qkv.reshape(b, s, heads, 3 * self.head_dim)
        q, k, v = torch.split(qkv, self.head_dim, dim=-1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout,
            is_causal=self.causal and attn_mask is None,
            training=self.training)
        out = out.reshape(b, s, local_h)
        return self.resid_dropout(self.out_proj(out))


class GPTMLP(Layer):
    def __init__(self, hidden_size, intermediate_size, dropout=0.1,
                 tensor_parallel=True):
        super().__init__()
        _single_device(tensor_parallel)
        self.fc_in = nn.Linear(hidden_size, intermediate_size)
        self.fc_out = nn.Linear(intermediate_size, hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate=True)))


class GPTBlock(Layer):
    def __init__(self, hidden_size, num_heads, intermediate_size=None,
                 attn_dropout=0.1, resid_dropout=0.1, layer_norm_epsilon=1e-5,
                 tensor_parallel=True, mp_degree=1):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.ln_1 = nn.LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        self.attn = GPTAttention(hidden_size, num_heads, attn_dropout,
                                 resid_dropout, tensor_parallel, mp_degree)
        self.ln_2 = nn.LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        self.mlp = GPTMLP(hidden_size, intermediate_size, resid_dropout,
                          tensor_parallel)

    def forward(self, x, attn_mask=None):
        x = x + self.attn(self.ln_1(x), attn_mask)
        x = x + self.mlp(self.ln_2(x))
        return x


class GPTModel(Layer):
    """Decoder-only transformer trunk."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, attn_dropout=0.1,
                 hidden_dropout=0.1, layer_norm_epsilon=1e-5,
                 tensor_parallel=True, mp_degree=1):
        super().__init__()
        self.hidden_size = hidden_size
        self.embeddings = GPTEmbeddings(vocab_size, hidden_size,
                                        max_position_embeddings,
                                        hidden_dropout,
                                        tensor_parallel=tensor_parallel)
        self.h = nn.LayerList([
            GPTBlock(hidden_size, num_heads, intermediate_size, attn_dropout,
                     hidden_dropout, layer_norm_epsilon, tensor_parallel,
                     mp_degree)
            for _ in range(num_layers)])
        self.ln_f = nn.LayerNorm(hidden_size, epsilon=layer_norm_epsilon)

    def forward(self, input_ids, attn_mask=None):
        x = self.embeddings(input_ids)
        for block in self.h:
            x = block(x, attn_mask)
        return self.ln_f(x)


class GPTLMHead(Layer):
    """Projection to vocab logits, optionally tied to the word embedding.
    A tied head keeps no parameter of its own: it reads the embedding
    module's weight, so the weight is registered (and named) once."""

    def __init__(self, hidden_size, vocab_size, embedding=None,
                 tensor_parallel=True):
        super().__init__()
        # a plain attribute, not a submodule: a tied embedding is owned (and
        # named) by the trunk
        self.__dict__["_tied"] = embedding
        if embedding is None:
            _single_device(tensor_parallel)
            self.weight = self.create_parameter(
                (vocab_size, hidden_size), initializer=Normal(0.0, 0.02))

    def __getattr__(self, name):
        tied = self.__dict__.get("_tied")
        if name == "weight" and tied is not None:
            return tied.weight                     # (vocab, hidden)
        return super().__getattr__(name)

    def forward(self, x):
        return torch.matmul(x, self.weight.T)


class GPTForPretraining(Layer):
    """Trunk + tied LM head."""

    def __init__(self, gpt: GPTModel = None, tensor_parallel=True, **kwargs):
        super().__init__()
        _single_device(tensor_parallel)
        self.gpt = gpt or GPTModel(tensor_parallel=tensor_parallel, **kwargs)
        self.lm_head = GPTLMHead(self.gpt.hidden_size, 0,
                                 embedding=self.gpt.embeddings.word_embeddings)
        self.tensor_parallel = tensor_parallel

    def forward(self, input_ids, attn_mask=None):
        return self.lm_head(self.gpt(input_ids, attn_mask))

    def fused_head_loss(self, input_ids, labels, chunk: int = 8192,
                        attn_mask=None, ce_kernel: str = "chunked"):
        """Trunk -> head + CE without materializing the (B, S, vocab)
        logits. ce_kernel: ``"chunked"`` (``ops/chunked_ce.py``, ``chunk``
        classes per step), ``"pallas"`` (the fused CE kernels,
        ``ops/fused_ce.py``; their plain versions on CPU tensors) or
        ``"auto"`` (the kernels on the card, else chunked, counted as a
        fallback). The head weight goes in as the tied embedding's
        ``(H, V)`` view; the kernels read it in place."""
        h = self.gpt(input_ids, attn_mask)
        w = self.lm_head.weight.T                      # (H, V)
        return F.fused_linear_cross_entropy(h, w, labels, chunk=chunk,
                                            kernel=ce_kernel)


def gpt_tiny(**kw):
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
               max_position_embeddings=256)
    cfg.update(kw)
    return cfg


def gpt_1p3b(**kw):
    """GPT-3 1.3B config."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, max_position_embeddings=1024)
    cfg.update(kw)
    return cfg
