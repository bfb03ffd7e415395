"""The machine-translation Transformer and its beam search (port of
``paddle_tpu/text/models/transformer.py``): ``position_encoding_init``,
``TransformerModel`` (``(src, trg) -> next-token logits``, pre-norm
encoder and decoder, ``bos_id`` doubling as the pad id) and
``InferTransformerModel`` (``src -> (ids, scores)``, best first).

The masks are the reference's dense ones: a ``(B, 1, 1, S)`` pad mask and
a causal ``(1, 1, T, T)`` mask of -1e9, so every attention call takes the
plain route and counts a flash fallback, as the reference's does. With
``weight_sharing`` the target embedding is the source one and the output
projection its transpose; the shared table is registered once, under
``src_emb``, as the reference names it.

The beam search is the reference's step for step: ``(b * beam)`` rows,
the whole prefix run again each step behind the causal mask, the flat
top-k over ``beam * V`` with ties to the lower index (a stable sort, as
``lax.top_k`` orders them), a finished beam continued by EOS only, and
the ``((5 + len) / 6) ** alpha`` rerank. ``last_margins`` keeps, for each
step of the last call, the smallest gap between neighbouring finite
candidates among the ``beam + 1`` best of any row: a near tie, where two
implementations may part, shows there as a small number.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import nn
from ...nn.decode import _top_k
from ...nn.layer import Layer

__all__ = ["TransformerModel", "InferTransformerModel",
           "position_encoding_init"]


def position_encoding_init(n_position: int, d_model: int) -> np.ndarray:
    """The sinusoidal position table, (n_position, d_model) float32."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_model)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    out = np.zeros((n_position, d_model), np.float32)
    out[:, 0::2] = np.sin(angle[:, 0::2])
    out[:, 1::2] = np.cos(angle[:, 1::2])
    return out


class TransformerModel(Layer):
    """Training-time MT transformer: (src, trg) -> next-token logits."""

    def __init__(self, src_vocab_size, trg_vocab_size, max_length=256,
                 num_encoder_layers=6, num_decoder_layers=6, n_head=8,
                 d_model=512, d_inner_hid=2048, dropout=0.1,
                 weight_sharing=False, bos_id=0, eos_id=1):
        super().__init__()
        self.d_model = d_model
        self.bos_id, self.eos_id = bos_id, eos_id
        self.trg_vocab_size = trg_vocab_size
        self.src_emb = nn.Embedding(src_vocab_size, d_model)
        if weight_sharing:
            if src_vocab_size != trg_vocab_size:
                raise ValueError("weight_sharing needs a joint vocabulary")
            # the one table, registered once (under src_emb)
            object.__setattr__(self, "trg_emb", self.src_emb)
        else:
            self.trg_emb = nn.Embedding(trg_vocab_size, d_model)
        self.register_buffer("pos_table", torch.from_numpy(
            position_encoding_init(max_length, d_model)), persistent=False)
        self.dropout = nn.Dropout(dropout)
        self.transformer = nn.Transformer(
            d_model=d_model, nhead=n_head,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=d_inner_hid, dropout=dropout,
            normalize_before=True)
        self._share_out = weight_sharing
        if not weight_sharing:
            self.out_proj = nn.Linear(d_model, trg_vocab_size,
                                      bias_attr=False)
        # sqrt(d_model) as the reference's float32 scalar
        self._emb_scale = float(np.sqrt(np.float32(d_model)))

    def _embed(self, ids, emb):
        x = emb(ids) * self._emb_scale
        return self.dropout(x + self.pos_table[None, :ids.shape[1]])

    def _masks(self, src, trg):
        neg = torch.tensor(-1e9, dtype=torch.float32, device=src.device)
        zero = torch.zeros((), dtype=torch.float32, device=src.device)
        src_mask = torch.where((src == self.bos_id)[:, None, None, :], neg,
                               zero)
        t = trg.shape[1]
        causal = torch.full((t, t), -1e9, dtype=torch.float32,
                            device=src.device).triu(1)[None, None]
        return src_mask, causal

    def _project(self, h):
        if self._share_out:
            return h @ self.trg_emb.weight.T
        return self.out_proj(h)

    def forward(self, src_word, trg_word):
        src, trg = torch.as_tensor(src_word), torch.as_tensor(trg_word)
        src_mask, trg_mask = self._masks(src, trg)
        enc = self.transformer.encoder(self._embed(src, self.src_emb),
                                       src_mask)
        dec = self.transformer.decoder(self._embed(trg, self.trg_emb), enc,
                                       trg_mask, src_mask)
        return self._project(dec)


def _min_gap(best):
    """The smallest gap between neighbouring finite values of each
    descending row -> its minimum over rows (inf when none)."""
    gap = best[..., :-1] - best[..., 1:]
    ok = torch.isfinite(best[..., :-1]) & torch.isfinite(best[..., 1:])
    return torch.where(ok, gap, torch.full_like(gap, float("inf"))).min()


class InferTransformerModel(TransformerModel):
    """Beam-search generation: forward(src) -> (ids (batch, beam,
    max_out_len), scores (batch, beam)), best first; ``beam_size=1`` is
    greedy."""

    def __init__(self, *args, beam_size=4, max_out_len=64, alpha=0.6,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.beam_size = beam_size
        self.max_out_len = max_out_len
        self.alpha = alpha
        self.last_margins = None

    def forward(self, src_word):
        src = torch.as_tensor(src_word)
        b, beam, v = src.shape[0], self.beam_size, self.trg_vocab_size
        dev = src.device
        src_mask, _ = self._masks(src, src[:, :1])
        enc = self.transformer.encoder(self._embed(src, self.src_emb),
                                       src_mask)
        enc = enc.repeat_interleave(beam, dim=0)           # (b * beam) rows
        src_mask = src_mask.repeat_interleave(beam, dim=0)
        t_len = self.max_out_len
        seqs = torch.full((b, beam, t_len + 1), self.bos_id,
                          dtype=torch.int32, device=dev)
        scores = torch.tensor([0.0] + [-1e9] * (beam - 1),
                              device=dev).repeat(b, 1)
        finished = torch.zeros((b, beam), dtype=torch.bool, device=dev)
        eos_only = torch.full((v,), float("-inf"), device=dev)
        eos_only[self.eos_id] = 0.0
        _, causal = self._masks(src[:1], seqs[0])
        margins = []
        for t in range(t_len):
            flat = seqs.reshape(b * beam, t_len + 1)
            dec = self.transformer.decoder(self._embed(flat, self.trg_emb),
                                           enc, causal, src_mask)
            logits = self._project(dec[:, t])               # (b * beam, V)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(
                b, beam, v)
            # a finished beam continues by EOS only, at no cost
            logp = torch.where(finished[..., None], eos_only, logp)
            total = scores[..., None] + logp
            best, idx = _top_k(total.reshape(b, beam * v), beam + 1)
            margins.append(_min_gap(best))
            scores, idx = best[:, :beam], idx[:, :beam]
            src_beam = idx // v
            token = (idx % v).to(torch.int32)
            seqs = seqs.gather(1, src_beam[..., None].expand(
                b, beam, t_len + 1))
            finished = finished.gather(1, src_beam)
            seqs[:, :, t + 1] = torch.where(
                finished, torch.full_like(token, self.eos_id), token)
            finished = finished | (token == self.eos_id)
        self.last_margins = torch.stack(margins)
        # length-penalty rerank, GNMT's ((5 + len) / 6) ** alpha
        lengths = (seqs[:, :, 1:] != self.eos_id).sum(-1) + 1
        penalty = torch.pow((5.0 + lengths.float()) / 6.0, self.alpha)
        norm = scores / penalty
        order = torch.sort(-norm, dim=1, stable=True)[1]
        seqs = seqs.gather(1, order[..., None].expand(b, beam, t_len + 1))
        return seqs[:, :, 1:], norm.gather(1, order)
