"""GPT for pretraining: the flagship hybrid-parallel transformer.

Port of ``paddle_tpu/text/models/gpt.py``: ``GPTEmbeddings``,
``GPTAttention``, ``GPTMLP``, ``GPTBlock``, ``GPTModel``, ``GPTLMHead``
(tied to the word embedding), ``GPTForPretraining`` with ``forward``,
``loss`` and ``fused_head_loss``, the pipeline descriptors
(:func:`gpt_pipeline_descs`) and the ``gpt_tiny``/``gpt_1p3b`` configs.
Attention goes through ``F.scaled_dot_product_attention``, so on the card
at S >= 512 it runs the flash kernels (``csrc/flash_attention.cu``).
``fused_head_loss`` takes the chunked CE by default, as the reference
does, and the fused CE kernels (``csrc/fused_ce.cu``) with
``ce_kernel="pallas"`` or, on the card, ``"auto"``. The dense path is
``forward`` (logits) and ``loss`` (the mean of ``ParallelCrossEntropy``)
or ``nn.functional.cross_entropy``.

The QKV projection is split per head, interleaved, as the reference splits
it: ``reshape(b, s, heads, 3*hd)`` then three ``hd`` slices, so that
``qkv_proj`` weights carry over unchanged and a ``model`` chunk of its
columns holds whole heads. The slices are strided views; the flash
kernels read them in place.

``tensor_parallel=True`` builds the Megatron layers
(``distributed/meta_parallel/parallel_layers/mp_layers.py``): the
vocab-parallel word embedding, column/row QKV and MLP projections (each
rank ``heads / mp`` local heads), the tied head on the vocab-split weight
behind ``copy_to_model_parallel``, and the loss through
``ParallelCrossEntropy`` on the vocab-split logits; ``fused_head_loss``
raises there, as the reference's. Under a ``sep`` axis larger than 1
(context parallelism: the trainer splits the sequence over it) positions
are global and attention is :func:`~paddle_tpu_torch.ops.ring_attention.
ring_flash_attention`, which raises for a mask or for attention dropout
in training, as the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import nn
from ...distributed.mesh import get_mesh
from ...distributed.meta_parallel.parallel_layers.mp_layers import (
    MODEL_AXIS, ColumnParallelLinear, ParallelCrossEntropy,
    RowParallelLinear, VocabParallelEmbedding, _split_param,
    copy_to_model_parallel)
from ...distributed.meta_parallel.parallel_layers.pp_layers import (
    LayerDesc, SharedLayerDesc)
from ...nn import functional as F
from ...nn.initializer import Normal
from ...nn.layer import Layer

__all__ = ["GPTEmbeddings", "GPTAttention", "GPTMLP", "GPTBlock",
           "GPTModel", "GPTLMHead", "GPTForPretraining",
           "gpt_pipeline_descs", "pipeline_state_from_dense", "gpt_tiny",
           "gpt_1p3b"]


def _sep():
    """(degree, coordinate) of the current mesh's ``sep`` axis."""
    mesh = get_mesh()
    if mesh is None:
        return 1, 0
    return mesh.shape["sep"], mesh.coord["sep"]


class GPTEmbeddings(Layer):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=1024,
                 hidden_dropout_prob=0.1, initializer_range=0.02,
                 tensor_parallel=True):
        super().__init__()
        emb_cls = VocabParallelEmbedding if tensor_parallel else nn.Embedding
        self.word_embeddings = emb_cls(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size)
        self.dropout = nn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            s = input_ids.shape[-1]
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
            n_sep, i_sep = _sep()
            if n_sep > 1:
                # this rank holds sequence chunk [i*s, (i+1)*s): global
                # positions
                position_ids = position_ids + i_sep * s
        w = self.word_embeddings(input_ids)
        p = self.position_embeddings(position_ids)
        return self.dropout(w + p)


class GPTAttention(Layer):
    def __init__(self, hidden_size, num_heads, attn_dropout=0.1,
                 resid_dropout=0.1, tensor_parallel=True, mp_degree=1,
                 use_flash=True, causal=True):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.head_dim = hidden_size // num_heads
        self.mp_degree = mp_degree if tensor_parallel else 1
        self.local_heads = num_heads // max(self.mp_degree, 1)
        if tensor_parallel:
            self.qkv_proj = ColumnParallelLinear(hidden_size, 3 * hidden_size,
                                                 gather_output=False)
            self.out_proj = RowParallelLinear(hidden_size, hidden_size,
                                              input_is_parallel=True)
        else:
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
        if _sep()[0] > 1:
            # the sequence is split over "sep": attention within the local
            # chunk would be silently wrong, so what the ring lacks raises
            if attn_mask is not None or (self.attn_dropout != 0.0 and
                                         self.training):
                raise NotImplementedError(
                    "sequence ('sep') parallelism requires attn_mask=None "
                    "and attn_dropout=0.0: ring attention has no mask or "
                    "dropout, and local attention would be wrong")
            from ...ops.ring_attention import ring_flash_attention
            out = ring_flash_attention(q, k, v, causal=self.causal)
        else:
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
        if tensor_parallel:
            self.fc_in = ColumnParallelLinear(hidden_size, intermediate_size,
                                              gather_output=False)
            self.fc_out = RowParallelLinear(intermediate_size, hidden_size,
                                            input_is_parallel=True)
        else:
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


def _head(x, weight):
    """Logits ``x @ weight.T``. A vocab-split weight (its ``pspec`` names
    ``model``) goes behind ``copy_to_model_parallel``: the backward
    all-reduce over ``model`` makes the replicated upstream gradients
    whole."""
    if MODEL_AXIS in tuple(getattr(weight, "pspec", None) or ()):
        x = copy_to_model_parallel(x)
    return torch.matmul(x, weight.T)


class GPTLMHead(Layer):
    """Projection to (vocab-split, under tensor parallelism) logits,
    optionally tied to the word embedding. A tied head keeps no parameter
    of its own: it reads the embedding module's weight, so the weight is
    registered (and named) once."""

    def __init__(self, hidden_size, vocab_size, embedding=None,
                 tensor_parallel=True):
        super().__init__()
        # a plain attribute, not a submodule: a tied embedding is owned (and
        # named) by the trunk
        self.__dict__["_tied"] = embedding
        if embedding is None:
            _split_param(self, "weight", (vocab_size, hidden_size),
                         0 if tensor_parallel else None, Normal(0.0, 0.02),
                         (MODEL_AXIS, None) if tensor_parallel else None)

    def __getattr__(self, name):
        tied = self.__dict__.get("_tied")
        if name == "weight" and tied is not None:
            return tied.weight                     # (vocab, hidden)
        return super().__getattr__(name)

    def forward(self, x):
        return _head(x, self.weight)


class GPTForPretraining(Layer):
    """Trunk + tied LM head + the parallel CE loss."""

    def __init__(self, gpt: GPTModel = None, tensor_parallel=True, **kwargs):
        super().__init__()
        self.gpt = gpt or GPTModel(tensor_parallel=tensor_parallel, **kwargs)
        self.lm_head = GPTLMHead(self.gpt.hidden_size, 0,
                                 embedding=self.gpt.embeddings.word_embeddings)
        self.parallel_loss = ParallelCrossEntropy()
        self.tensor_parallel = tensor_parallel

    def forward(self, input_ids, attn_mask=None):
        return self.lm_head(self.gpt(input_ids, attn_mask))

    def loss(self, logits, labels):
        """The mean over tokens of ``ParallelCrossEntropy`` on the (split,
        under tensor parallelism) logits, float32."""
        return self.parallel_loss(logits, labels).mean()

    def fused_head_loss(self, input_ids, labels, chunk: int = 8192,
                        attn_mask=None, ce_kernel: str = "chunked"):
        """Trunk -> head + CE without materializing the (B, S, vocab)
        logits. ce_kernel: ``"chunked"`` (``ops/chunked_ce.py``, ``chunk``
        classes per step), ``"pallas"`` (the fused CE kernels,
        ``ops/fused_ce.py``; their plain versions on CPU tensors) or
        ``"auto"`` (the kernels on the card, else chunked, counted as a
        fallback). The head weight goes in as the tied embedding's
        ``(H, V)`` view; the kernels read it in place. Under tensor
        parallelism it raises: a rank's head covers V/mp columns, so the
        fused ops would miss every other rank's labels."""
        if self.tensor_parallel:
            raise RuntimeError(
                "fused_head_loss is the single-device/DP path; under "
                "tensor parallelism use forward() + the vocab-split "
                "ParallelCrossEntropy loss (GPTForPretraining.loss)")
        h = self.gpt(input_ids, attn_mask)
        w = self.lm_head.weight.T                      # (H, V)
        return F.fused_linear_cross_entropy(h, w, labels, chunk=chunk,
                                            kernel=ce_kernel)


# -- pipeline variant --------------------------------------------------------
class _EmbeddingPipe(GPTEmbeddings):
    def forward(self, input_ids):
        return super().forward(input_ids)


class _LNHeadPipe(Layer):
    """Final LN + untied head for the pipeline build (the tied variant
    shares the first stage's embedding weight through SharedLayerDesc)."""

    def __init__(self, hidden_size, vocab_size, epsilon=1e-5,
                 tensor_parallel=True):
        super().__init__()
        self.ln_f = nn.LayerNorm(hidden_size, epsilon=epsilon)
        self.head = GPTLMHead(hidden_size, vocab_size,
                              tensor_parallel=tensor_parallel)

    def forward(self, x):
        return self.head(self.ln_f(x))


def _tied_head_forward(x, weight):
    """The LM head against the embedding weight (the SharedLayerDesc
    ``forward_func``): held on every pipe rank, its gradient summed over
    ``pipe`` by the pipeline."""
    return _head(x, weight)


def gpt_pipeline_descs(vocab_size=50304, hidden_size=768, num_layers=12,
                       num_heads=12, max_position_embeddings=1024,
                       dropout=0.1, tensor_parallel=True,
                       tie_embeddings=True):
    """LayerDesc list for ``PipelineLayer`` (reference ``gpt.py``). With
    ``tie_embeddings`` (the reference's default) the LM head reuses the
    word embedding's weight through SharedLayerDesc; the final LayerNorm
    stays a plain last-stage layer."""
    emb = dict(vocab_size=vocab_size, hidden_size=hidden_size,
               max_position_embeddings=max_position_embeddings,
               hidden_dropout_prob=dropout, tensor_parallel=tensor_parallel)
    if tie_embeddings:
        descs = [SharedLayerDesc("embed", _EmbeddingPipe,
                                 shared_weight_attr="word_embeddings.weight",
                                 **emb)]
    else:
        descs = [LayerDesc(_EmbeddingPipe, vocab_size, hidden_size,
                           max_position_embeddings, dropout,
                           tensor_parallel=tensor_parallel)]
    for _ in range(num_layers):
        descs.append(LayerDesc(GPTBlock, hidden_size, num_heads,
                               attn_dropout=dropout, resid_dropout=dropout,
                               tensor_parallel=tensor_parallel))
    if tie_embeddings:
        descs.append(LayerDesc(nn.LayerNorm, hidden_size))
        descs.append(SharedLayerDesc(
            "embed", _EmbeddingPipe, forward_func=_tied_head_forward,
            shared_weight_attr="word_embeddings.weight", **emb))
    else:
        descs.append(LayerDesc(_LNHeadPipe, hidden_size, vocab_size,
                               tensor_parallel=tensor_parallel))
    return descs


def pipeline_state_from_dense(state, num_layers):
    """A dense ``GPTForPretraining``'s ``{name: array}`` (tensors or numpy)
    under the tied ``gpt_pipeline_descs`` plan's names: ``mod0`` the
    embeddings, ``stack0`` the blocks (one row a layer), ``mod{L + 1}``
    ``ln_f``."""
    out, rows = {}, {}
    for k, v in state.items():
        if k.startswith("gpt.embeddings."):
            out["mod0." + k[len("gpt.embeddings."):]] = v
        elif k.startswith("gpt.ln_f."):
            out[f"mod{num_layers + 1}." + k[len("gpt.ln_f."):]] = v
        elif k.startswith("gpt.h."):
            i, name = k[len("gpt.h."):].split(".", 1)
            rows.setdefault(name, {})[int(i)] = v
    for name, r in rows.items():
        members = [r[i] for i in range(num_layers)]
        out["stack0." + name.replace(".", "__")] = (
            torch.stack(members) if isinstance(members[0], torch.Tensor)
            else np.stack(members))
    return out


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
