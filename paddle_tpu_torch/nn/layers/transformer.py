"""The transformer layers (port of ``paddle_tpu/nn/layers/transformer.py``):
``MultiHeadAttention`` (with ``gen_cache``, ``Cache``/``StaticCache`` and
incremental decoding), ``TransformerEncoderLayer``/``TransformerEncoder``,
``TransformerDecoderLayer``/``TransformerDecoder`` (``normalize_before``
either way) and ``Transformer``.

Attention goes through ``F.scaled_dot_product_attention``: a dense mask
takes the plain route and counts a fallback, no mask at 512 or more
query positions (on the card, in float32 or bfloat16) takes the flash
kernels. A float mask is cast to the queries' dtype and a 3-D one is
broadcast over the heads, as the reference's ``_convert_attention_mask``
and its broadcast do. A stack's layers start as copies of the one given,
as the reference deep-copies it.
"""
from __future__ import annotations

import copy

import torch

from .. import functional as F
from ..layer import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    if attn_mask is None or attn_mask.dtype == torch.bool:
        return attn_mask
    return attn_mask.to(dtype)


class MultiHeadAttention(Layer):
    """Attention over ``num_heads`` heads of ``embed_dim / num_heads``;
    inputs (B, S, E). A cache is a ``(k, v)`` pair of (B, S, H, D)."""

    Cache = tuple
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} does not split into "
                             f"{num_heads} heads")
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """The projected ``(k, v)`` of ``key``/``value`` (``Cache`` and
        ``StaticCache`` are both ``tuple``, as in the reference, so either
        type projects), else an empty ``(k, v)`` to grow step by step."""
        if type == self.StaticCache or value is not None:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return (k, v)
        b = key.shape[0]
        empty = key.new_zeros((b, 0, self.num_heads, self.head_dim))
        return (empty, empty.clone())

    def _attend(self, q, k, v, attn_mask):
        mask = _convert_attention_mask(attn_mask, q.dtype)
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None] if mask.shape[0] == q.shape[0] else \
                mask[None]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.embed_dim))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if cache is not None and len(cache) == 2 and cache[0].shape[1] \
                and key is query:
            # incremental decode: this step's keys after the cached ones
            k = torch.cat([cache[0], self._shape(self.k_proj(key))], dim=1)
            v = torch.cat([cache[1], self._shape(self.v_proj(value))], dim=1)
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
        out = self._attend(q, k, v, attn_mask)
        return out if cache is None else (out, (k, v))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr_cache, static_cache = None, None
        else:
            incr_cache, static_cache = cache
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             incr_cache)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is not None:
            # the memory's keys and values were projected once
            attn = self.cross_attn
            q = attn._shape(attn.q_proj(tgt))
            mask = _convert_attention_mask(memory_mask, q.dtype)
            if mask is not None and mask.dim() == 3:
                mask = mask[:, None]
            out = F.scaled_dot_product_attention(
                q, *static_cache, attn_mask=mask, dropout_p=attn.dropout,
                training=self.training)
            tgt = attn.out_proj(out.reshape(out.shape[0], out.shape[1], -1))
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, static_cache))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return (incr, static)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args), num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args), num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """(length, length) float32: 0 on and below the diagonal, the
        float32 minimum above."""
        keep = torch.ones(length, length, dtype=torch.bool).tril()
        return torch.where(keep, torch.tensor(0.0),
                           torch.tensor(torch.finfo(torch.float32).min))
